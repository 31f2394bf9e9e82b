"""faultinject — a seeded, schedule-driven chaos layer (the port's copy of
the JAX package's ``testing/faultinject.py``).

The proof harness for every recovery path the stack ships (errmgr
respawn / continue / notify, pml park-and-heal, ULFM revoke/shrink/agree
in mpi/ft.py): instead of hand-scripted ``os._exit`` calls sprinkled
through test apps, a *fault plan* — one string, replayable byte-for-byte
from its seed — declares which rank dies when and which messages the
transport loses, delays, or duplicates.

Plan grammar (entries separated by ``;``)::

    rank=2:kill@step=3        rank 2 exits when its step counter hits 3
    rank=2:kill@t=0.5         rank 2 exits ~0.5 s after arming
    rank=2:hang@step=3        rank 2 STALLS (alive pid, silent rank) at
                              step 3 — SIGSTOP by default, a cooperative
                              spin with faultinject_hang_mode=spin
    rank=2:crash@step=3       like kill, but fires in EVERY life — the
                              crash loop that proves the errmgr revive
                              budget/escalation ladder (kill and hang
                              are first-life-only by design)
    rank=2:kill@coll=5        rank 2 exits INSIDE its 5th top-level
                              collective dispatch (after the recorder
                              post, before the collective runs — so the
                              victim never publishes and the revive
                              lands mid-collective-loop; first-life-
                              only like every kill): the deterministic
                              mid-collective death behind the
                              selfheal-coll rejoin chaos class
    rank=2:stall@coll=5       rank 2 stalls INSIDE its 5th recorded
                              collective (counted by the flight
                              recorder's dispatch ordinal, 0-based):
                              SIGSTOP by default, a cooperative spin
                              with faultinject_hang_mode=spin — the
                              deterministic straggler the hang doctor
                              must name
    rank=1:mismatch@coll=5    rank 1 dispatches a DIVERGENT collective
                              kind at ordinal 5 (recorded at the same
                              (cid, op_seq) its peers run the real op),
                              then spin-parks so it stays capturable —
                              the deterministic collective mismatch
                              behind the doctor's mismatch verdict
    daemon=1:kill@t=1.0       orted vpid 1 SIGKILLs itself after 1 s
    daemon=1:kill@reg=4:after=1.5
                              orted vpid 1 SIGKILLs itself 1.5 s after
                              4 ranks have REGISTERED with the job's
                              PMIx server — a barrier-keyed schedule
                              that cannot land mid-init on a slow box
                              (``after`` defaults to 1.0 s)
    drop=0.01                 drop outgoing FT-control frames with p=0.01
    drop=0.05@all             drop ANY outgoing frame with p=0.05
    rank=1:drop=0.1           restrict the action to rank 1
    delay=0.02,5              delay frames 5 ms with p=0.02
    dup=0.01                  duplicate frames with p=0.01

Activation: ``OMPI_TPU_FAULT_PLAN`` / ``OMPI_TPU_FAULT_SEED`` in the
environment, or the registered MCA vars (``--mca faultinject_plan ...``
— tpurun exports --mca pairs into the job env, so the same plan reaches
every rank).

Determinism: a frame's verdict is a pure function of
``(seed, rank, peer, frame identity)`` where the identity is built from
the header's protocol fields (t/tag/cid/seq/op/attempt...) — no
wall-clock, no global RNG, no thread-timing or send-path dependence: the
same logical frame draws the same verdict whether it rides the inline
fast path, the send worker, or a heal retry (FT control frames carry an
attempt counter, so each *retransmission* is a fresh identity — a
dropped revoke cannot be dropped forever).  ``step``-triggered kills
fire at exactly the same application step on replay.  Every fired fault
is recorded (and mirrored onto the flight recorder when tracing is
armed); ``events()`` / the ``OMPI_TPU_FAULT_LOG_DIR`` dump let a driver
assert replay equality (tools/chaos_soak.py does).

The plan grammar, the MCA variables, the environment and the verdict hash
are the JAX package's, so one plan and seed fire the same faults in both
packages.  The port's orted arms ``daemon=`` entries as the JAX package's
does: :func:`arm_daemon` at daemon start (``kill@t=``) and
:func:`arm_daemon_launch` at app launch (the barrier-keyed
``kill@reg=N:after=S`` over ``pmix.query_regstate``).

Scope note on drops: the PML assumes a *reliable* transport — an
unconditionally dropped data frame is a hung collective, by design.
``drop`` therefore defaults to the FT control plane (``t: "ft"`` frames,
whose revoke/agree protocols carry their own retransmission) and must be
widened to ``@all`` explicitly by plans that want to prove timeout
behavior rather than completion.
"""

from __future__ import annotations

import atexit
import json
import os
import threading
import time
import zlib
from typing import Any, Optional

from ompi_tpu_torch.core import output
from ompi_tpu_torch.core.config import VarType, register_var, var_registry

__all__ = ["active", "plan_text", "injector_for", "step", "arm_daemon",
           "arm_daemon_launch", "events", "reset", "Injector"]

_log = output.get_stream("faultinject")

register_var("faultinject", "plan", VarType.STRING, "",
             "fault plan (see ompi_tpu_torch.testing.faultinject grammar); "
             "empty = chaos disabled.  OMPI_TPU_FAULT_PLAN is a synonym.")
register_var("faultinject", "seed", VarType.INT, 0,
             "seed for the deterministic fault decision streams")
register_var("faultinject", "exit_code", VarType.INT, 9,
             "exit code an injected rank kill dies with")
register_var("faultinject", "hang_mode", VarType.STRING, "stop",
             "how an injected hang stalls the rank: 'stop' = SIGSTOP the "
             "whole process (full-process freeze — the in-host hang the "
             "rank-plane gossip heartbeats exist to catch); 'spin' = park "
             "only the calling thread in a sleep loop (an app-thread "
             "deadlock; background threads keep running)",
             enumerator=("stop", "spin"))

ENV_PLAN = "OMPI_TPU_FAULT_PLAN"
ENV_SEED = "OMPI_TPU_FAULT_SEED"
ENV_LOG_DIR = "OMPI_TPU_FAULT_LOG_DIR"


def plan_text() -> str:
    """The active plan string ('' when chaos is disabled)."""
    return (os.environ.get(ENV_PLAN)
            or var_registry.get("faultinject_plan") or "")


def plan_seed() -> int:
    env = os.environ.get(ENV_SEED)
    if env is not None:
        return int(env)
    return int(var_registry.get("faultinject_seed") or 0)


def active() -> bool:
    return bool(plan_text())


class _Action:
    """One parsed plan entry."""

    __slots__ = ("kind", "rank", "prob", "scope", "delay_ms", "at_step",
                 "at_time", "at_reg", "at_coll", "after", "vpid")

    def __init__(self) -> None:
        self.kind = ""            # kill | daemon_kill | drop | delay | dup
        self.rank: Optional[int] = None   # None = every rank
        self.vpid: Optional[int] = None
        self.prob = 0.0
        self.scope = "ft"         # ft | all
        self.delay_ms = 0.0
        self.at_step: Optional[int] = None
        self.at_time: Optional[float] = None
        self.at_reg: Optional[int] = None   # ranks-registered barrier
        self.at_coll: Optional[int] = None  # flight-recorder dispatch
        # ordinal (stall/mismatch fire inside that collective)
        self.after = 1.0          # grace after the @reg barrier clears


def _parse_entry(entry: str) -> _Action:
    act = _Action()
    for part in entry.split(":"):
        part = part.strip()
        if not part:
            continue
        key, _, val = part.partition("=")
        key = key.strip()
        val = val.strip()
        if key == "rank":
            act.rank = int(val)
        elif key == "daemon":
            act.vpid = int(val)
        elif (key in ("kill", "hang", "crash", "stall", "mismatch")
              or key.startswith(("kill@", "hang@", "crash@", "stall@",
                                 "mismatch@"))):
            base = key.partition("@")[0]
            act.kind = ("daemon_kill" if act.vpid is not None
                        and base == "kill" else base)
            # kill@step=N / kill@t=SEC arrive as key "kill@step"/"kill@t"
            # (same for hang@ / crash@ / stall@ / mismatch@)
            trig = key.partition("@")[2]
            if trig == "step":
                act.at_step = int(val)
            elif trig == "t":
                act.at_time = float(val)
            elif trig == "reg":
                act.at_reg = int(val)
            elif trig == "coll":
                act.at_coll = int(val)
            else:
                raise ValueError(
                    f"{base} needs a trigger: {base}@step=N, "
                    f"{base}@t=SEC, {base}@reg=NRANKS or "
                    f"{base}@coll=N (got {part!r})")
        elif key == "after":
            act.after = float(val)
        elif key in ("drop", "dup"):
            act.kind = key
            prob, _, scope = val.partition("@")
            act.prob = float(prob)
            act.scope = scope or ("ft" if key == "drop" else "all")
        elif key == "delay":
            act.kind = "delay"
            prob, _, rest = val.partition(",")
            act.prob = float(prob)
            ms, _, scope = rest.partition("@")
            act.delay_ms = float(ms or 1.0)
            act.scope = scope or "all"
        else:
            raise ValueError(f"unknown fault-plan token {part!r} "
                             f"in entry {entry!r}")
    if not act.kind:
        raise ValueError(f"fault-plan entry {entry!r} names no action")
    if act.scope not in ("ft", "all"):
        raise ValueError(f"unknown fault scope {act.scope!r} (ft|all)")
    # whole-entry validation (field order within an entry is free, so
    # per-field checks can be sidestepped): hangs target ranks only —
    # a hung DAEMON is the heartbeat layer's job, and a daemon= field
    # anywhere in a hang entry is a contradiction, not a default
    if act.kind in ("hang", "crash", "stall", "mismatch") \
            and act.vpid is not None:
        raise ValueError(
            f"{act.kind} targets ranks, not daemons (entry {entry!r})")
    # the collective triggers fire from inside the coll dispatch choke
    # point — the @coll ordinal is their ONLY trigger (a wall-clock
    # stall would not be deterministic against the recorder's seq).
    # kill@coll=N rides the same ordinal (die at the Nth TOP-LEVEL
    # dispatch, never inside a nested/infrastructure phase); hang and
    # crash keep their step/t triggers — a hang inside the dispatch is
    # spelled stall, and crash must fire in every life, which the
    # first-life-only _colls arm cannot express
    if act.kind in ("stall", "mismatch") and act.at_coll is None:
        raise ValueError(
            f"{act.kind} needs an @coll=N trigger (entry {entry!r})")
    if act.at_coll is not None and act.kind not in ("stall", "mismatch",
                                                    "kill"):
        raise ValueError(
            f"@coll triggers are stall/mismatch/kill only "
            f"(entry {entry!r})")
    # a kill that saw daemon= before the kill key is a daemon_kill; one
    # that saw it after must settle to the same action
    if act.kind == "kill" and act.vpid is not None:
        act.kind = "daemon_kill"
    # ...and @coll is a RANK trigger (the ordinal lives in the rank's
    # coll dispatcher) — a daemon kill keyed on it could never fire
    if act.kind == "daemon_kill" and act.at_coll is not None:
        raise ValueError(
            f"@coll triggers target ranks, not daemons (entry {entry!r})")
    # the ranks-registered barrier is a DAEMON schedule: only an orted
    # can watch the PMIx regcount without being counted by it (a rank's
    # own registration is part of the barrier it would be waiting on)
    if act.at_reg is not None and act.kind != "daemon_kill":
        raise ValueError(
            f"@reg triggers are daemon-kill only (entry {entry!r})")
    if act.after < 0:
        raise ValueError(f"after= must be >= 0 (entry {entry!r})")
    return act


def parse_plan(text: str) -> list[_Action]:
    return [_parse_entry(e) for e in text.split(";") if e.strip()]


#: header fields that identify a logical frame (+ attempt counters) —
#: what the deterministic verdict hashes over
_IDENT_KEYS = ("t", "tag", "cid", "seq", "ep", "op", "aseq", "n", "sid",
               "rid", "off", "from")


def _frame_ident(header: dict) -> str:
    return ",".join(f"{k}={header[k]}" for k in _IDENT_KEYS if k in header)


def _u01(seed: int, rank: int, peer: int, ident: str, salt: str) -> float:
    """Deterministic uniform [0,1) per logical frame — a pure hash, so
    the verdict is independent of thread timing and send path."""
    key = f"{seed}:{rank}:{peer}:{ident}:{salt}".encode()
    return (zlib.crc32(key) & 0xFFFFFFFF) / 4294967296.0


class Injector:
    """Per-rank chaos engine: frame verdicts + kill triggers + event log."""

    def __init__(self, rank: int, actions: list[_Action], seed: int) -> None:
        self.rank = rank
        self.seed = seed
        self._acts = [a for a in actions
                      if a.rank is None or a.rank == rank]
        self._frame_acts = [a for a in self._acts
                            if a.kind in ("drop", "delay", "dup")]
        # kills AND hangs fire in a rank's FIRST life only: an
        # errmgr-respawned incarnation re-arms the injector and would
        # otherwise die again at the same step, looping until restarts
        # exhaust.  ``crash`` is that loop ON PURPOSE — it fires in
        # every life, proving the revive budget / escalation ladder.
        restarted = bool(os.environ.get("OMPI_TPU_RESTART"))
        self._kills = [a for a in self._acts
                       if a.kind == "crash"
                       or (a.kind in ("kill", "hang") and not restarted)]
        # collective-choke-point triggers (stall/mismatch/kill@coll=N),
        # first life only like kills/hangs — a revived victim must not
        # re-wedge/re-die at the same ordinal
        self._colls = [a for a in self._acts
                       if a.at_coll is not None
                       and a.kind in ("stall", "mismatch", "kill")
                       and not restarted]
        # the @coll ordinal: TOP-LEVEL dispatched collectives of this
        # life (the dispatcher skips nested composed sub-collectives —
        # firing inside e.g. the init barrier's internal allgather would
        # wedge peers mid-arena-build, outside every timeout)
        self._coll_n = 0
        self._step = 0
        self._lock = threading.Lock()
        self.events: list[dict] = []
        self._dead = False
        for k in self._kills:
            if k.at_time is not None:
                if k.kind == "hang":
                    t = threading.Timer(k.at_time, self._fire_hang,
                                        args=("t", k.at_time))
                else:
                    t = threading.Timer(k.at_time, self._fire_kill,
                                        args=("t", k.at_time, k.kind))
                t.daemon = True
                t.start()

    # -- kill triggers -----------------------------------------------------

    def step(self) -> int:
        """Advance the application step counter; fires any kill@step
        scheduled for the new step.  Returns the step just entered."""
        with self._lock:
            s = self._step
            self._step += 1
        for k in self._kills:
            if k.at_step == s:
                if k.kind == "hang":
                    self._fire_hang("step", s)
                else:
                    self._fire_kill("step", s, kind=k.kind)
        return s

    def _fire_kill(self, trigger: str, value, kind: str = "kill") -> None:
        if self._dead:
            return
        self._dead = True
        self._record(kind, trigger=trigger, value=value)
        _log.emit("faultinject: rank %d injected kill (%s=%s)",
                  self.rank, trigger, value)
        _dump_events_now()
        import sys

        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(int(var_registry.get("faultinject_exit_code")))

    def _fire_hang(self, trigger: str, value) -> None:
        """The injected in-host hang: the rank stalls WITHOUT exiting —
        the pid stays alive (invisible to the daemon heartbeat layer and
        the launcher reap loop), only its peers' gossip can tell."""
        if self._dead:
            return
        self._dead = True   # one terminal fault per life, like kills
        self._record("hang", trigger=trigger, value=value,
                     mode=var_registry.get("faultinject_hang_mode"))
        _log.emit("faultinject: rank %d injected hang (%s=%s)",
                  self.rank, trigger, value)
        _dump_events_now()
        import sys

        sys.stdout.flush()
        sys.stderr.flush()
        self._hang_impl()

    def _hang_impl(self) -> None:
        """Separated so tests can observe the trigger without actually
        freezing the test process."""
        if var_registry.get("faultinject_hang_mode") == "spin":
            while True:            # cooperative: only this thread parks
                time.sleep(3600)
        import signal

        os.kill(os.getpid(), signal.SIGSTOP)

    # -- collective triggers (coll dispatch choke-point hook) --------------

    def coll_faults(self) -> bool:
        """Any armed stall/mismatch@coll actions?  The coll dispatcher
        caches this so a plan without collective triggers costs one
        dict hit per dispatch."""
        return bool(self._colls)

    def coll_op(self) -> tuple[Optional[str], int]:
        """Advance the top-level collective ordinal (called once per
        top-level dispatch) → (armed action | None, the ordinal just
        entered).  :meth:`fire_coll` fires the returned action."""
        n = self._coll_n
        self._coll_n += 1
        if self._dead:
            return None, n
        for a in self._colls:
            if a.at_coll == n:
                return a.kind, n
        return None, n

    def fire_coll(self, kind: str, n: int, seq: int) -> None:
        """Fire a collective trigger from inside the dispatch: record
        the fault, then park (or die).  ``kill`` exits immediately —
        after the recorder post, before the collective body, so the
        victim never publishes into the arena and its revive lands
        mid-collective-loop.  ``stall`` follows faultinject_hang_mode
        (SIGSTOP / spin); ``mismatch`` ALWAYS spin-parks — the divergent
        rank must stay capturable so the doctor can read its recorder
        tail with the divergent (cid, op_seq) record."""
        if self._dead:
            return
        if kind == "kill":
            self._fire_kill("coll", n)
            return
        self._dead = True
        mode = ("spin" if kind == "mismatch"
                else var_registry.get("faultinject_hang_mode"))
        self._record(kind, trigger="coll", value=n, seq=seq, mode=mode)
        _log.emit("faultinject: rank %d injected %s (coll=%s, op_seq %s)",
                  self.rank, kind, n, seq)
        _dump_events_now()
        import sys

        sys.stdout.flush()
        sys.stderr.flush()
        if mode == "spin":
            while True:            # cooperative: only this thread parks
                time.sleep(3600)
        import signal

        os.kill(os.getpid(), signal.SIGSTOP)

    # -- frame verdicts (BtlEndpoint hook) ---------------------------------

    def on_frame(self, peer: int, header: dict) -> Any:
        """Verdict for one outgoing frame: "send" | "drop" | "dup" |
        ("delay", ms).  Called on the BTL send path; must stay cheap."""
        if not self._frame_acts:
            return "send"
        is_ft = header.get("t") == "ft"
        ident = None
        for a in self._frame_acts:
            if a.scope == "ft" and not is_ft:
                continue
            if ident is None:
                ident = _frame_ident(header)
            if _u01(self.seed, self.rank, peer, ident, a.kind) < a.prob:
                # p rides along so a replay checker recomputes the
                # verdict against the action's own threshold
                self._record(a.kind, peer=peer, frame=ident, p=a.prob)
                if a.kind == "delay":
                    return ("delay", a.delay_ms)
                return a.kind
        return "send"

    def _record(self, kind: str, **info) -> None:
        ev = {"kind": kind, "rank": self.rank, **info}
        with self._lock:
            self.events.append(ev)
        from ompi_tpu_torch.mpi import trace as trace_mod

        if trace_mod.active:
            trace_mod.instant("faultinject", kind, rank=self.rank, **info)


_lock = threading.Lock()
_injectors: dict[int, Injector] = {}
_parsed: Optional[list[_Action]] = None
_dump_armed = False


def injector_for(rank: int) -> Optional[Injector]:
    """The rank's injector, or None when no plan is armed.  Safe to call
    from transport constructors — parsing happens once per process."""
    text = plan_text()
    if not text:
        return None
    global _parsed, _dump_armed
    with _lock:
        inj = _injectors.get(rank)
        if inj is not None:
            return inj
        if _parsed is None:
            try:
                _parsed = parse_plan(text)
            except ValueError as e:
                _log.error("faultinject: bad plan %r: %s (chaos disabled)",
                           text, e)
                _parsed = []
        inj = Injector(rank, _parsed, plan_seed())
        _injectors[rank] = inj
        if not _dump_armed and os.environ.get(ENV_LOG_DIR):
            _dump_armed = True
            atexit.register(_dump_events_now)
        return inj


def step(rank: Optional[int] = None) -> None:
    """Application step marker (soak apps call this once per iteration);
    fires kill@step triggers.  With rank=None every installed injector
    in this process advances (single-rank processes have exactly one)."""
    with _lock:
        injs = (list(_injectors.values()) if rank is None
                else [i for i in (_injectors.get(rank),) if i is not None])
    for inj in injs:
        inj.step()


def _daemon_die(vpid: int) -> None:
    import signal

    _log.emit("faultinject: daemon %d injected SIGKILL", vpid)
    os.kill(os.getpid(), signal.SIGKILL)


def arm_daemon(vpid: int) -> None:
    """orted side: a plan entry ``daemon=<vpid>:kill@t=<sec>`` arms a
    self-SIGKILL — the injected silent host death."""
    text = plan_text()
    if not text:
        return
    try:
        actions = parse_plan(text)
    except ValueError:
        return
    for a in actions:
        if a.kind == "daemon_kill" and a.vpid == vpid \
                and a.at_time is not None:
            t = threading.Timer(a.at_time, _daemon_die, args=(vpid,))
            t.daemon = True
            t.start()


def arm_daemon_launch(vpid: int, env: dict) -> None:
    """orted side, at app launch: arm ``daemon=<vpid>:kill@reg=N`` —
    the barrier-keyed variant of the daemon kill.  A watcher thread
    polls the job's PMIx server (URI from the launch env) until N
    ranks' current lives have registered AND are READY (sent the
    init-complete notice — registration alone says the interpreters
    are up, but ranks can still be seconds deep in init's modex fence
    or first barrier on a loaded box), waits the entry's ``after``
    grace, then SIGKILLs the daemon.  Keyed on runtime barriers
    instead of wall-clock so the kill cannot land mid-init on a slow
    box (the midtree-kill chaos class's old t=6–8 s flake)."""
    text = plan_text()
    if not text:
        return
    try:
        actions = parse_plan(text)
    except ValueError:
        return
    from ompi_tpu_torch.runtime import pmix as pmix_mod

    uri = (env or {}).get(pmix_mod.ENV_URI)
    if not uri:
        return
    for a in actions:
        if a.kind != "daemon_kill" or a.vpid != vpid or a.at_reg is None:
            continue

        def watch(need: int = a.at_reg, grace: float = a.after) -> None:
            deadline = time.monotonic() + 120.0
            while time.monotonic() < deadline:
                state = pmix_mod.query_regstate(uri)
                if state is not None and state[0] >= need \
                        and state[2] >= need:
                    _log.emit("faultinject: daemon %d reg barrier "
                              "(%d ranks registered + ready) cleared; "
                              "killing in %.1fs", vpid, need, grace)
                    time.sleep(grace)
                    _daemon_die(vpid)
                    return
                time.sleep(0.2)

        t = threading.Thread(target=watch, daemon=True,
                             name=f"faultinject-reg-{vpid}")
        t.start()


def events(rank: Optional[int] = None) -> list[dict]:
    """Fired-fault log (for replay-determinism assertions)."""
    with _lock:
        if rank is not None:
            inj = _injectors.get(rank)
            return list(inj.events) if inj is not None else []
        out: list[dict] = []
        for inj in _injectors.values():
            out.extend(inj.events)
        return out


def _dump_events_now() -> None:
    """Write every injector's fired-event log to OMPI_TPU_FAULT_LOG_DIR
    (one JSON per rank) — called at exit AND right before an injected
    kill (atexit does not run under os._exit)."""
    log_dir = os.environ.get(ENV_LOG_DIR)
    if not log_dir:
        return
    with _lock:
        injs = list(_injectors.values())
    # a respawned incarnation gets its own file: overwriting the first
    # life's log would erase exactly the kill event a replay check needs
    life = int(os.environ.get("OMPI_TPU_RESTART") or 0)
    suffix = f"_life{life}" if life else ""
    for inj in injs:
        path = os.path.join(log_dir,
                            f"faults_rank{inj.rank}{suffix}.json")
        try:
            with open(path, "w") as fh:
                json.dump({"rank": inj.rank, "seed": inj.seed,
                           "plan": plan_text(), "events": inj.events,
                           "ts": time.time()}, fh)
        except OSError as e:
            _log.error("faultinject: event dump to %s failed: %r", path, e)


def reset() -> None:
    """Drop all per-process injector state (tests re-arm with new plans)."""
    global _parsed
    with _lock:
        _injectors.clear()
        _parsed = None
    # the coll dispatcher caches its per-rank injector resolution —
    # a re-armed plan must be re-resolved, not read through stale Nones
    try:
        from ompi_tpu_torch.mpi import coll as _coll

        _coll._fi_cache.clear()
    except Exception:  # noqa: BLE001 — tests without the coll layer
        pass
