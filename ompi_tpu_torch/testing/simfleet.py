"""simfleet — the thousand-rank control plane in one process (the port's
copy of the JAX package's ``testing/simfleet.py``, whole; it runs the
port's own ``rml``, ``plm`` and ``metrics`` and imports no torch).

Generalizes the fake-host machinery into a simulated fleet: hundreds of
in-process lightweight daemons — each a real :class:`rml.RmlNode` plus
the orted control-protocol subset (register / wire / heartbeat / orphan
/ reparent / adopt / doctor / metrics) — carrying thousands of STUB
ranks that never start an interpreter.  The HNP side is the real
:class:`MultiHostLauncher` with the real loss-epoch reparenter, the real
heartbeat sweep and the real metrics fan-in: only the daemon processes
and the rank interpreters are simulated, so a 100-daemon / 1000-rank
world exercises the genuine control-plane code paths inside a CI box.

Correlated-failure injectors:

- :meth:`SimFleet.rack_kill` — N daemons (mid-tree included) die in one
  tick: every node socket closes at once, racing link EOFs, orphan
  reports and heartbeat expiries into the HNP exactly like a rack
  losing power.
- :meth:`SimFleet.partition` — a subtree drops ALL frames for T seconds
  via the :attr:`RmlNode.frame_gate` seam.  Sockets stay alive (no EOF,
  no RST): a true network partition, which the heartbeat timeout — not
  the lifeline rule — must adjudicate.
- :meth:`SimFleet.metrics_storm` — every daemon pushes a full metrics
  snapshot in the same wave (deepest level first, so each hop folds its
  children's payloads), the HNP-uplink-overload case the
  ``metrics_agg_budget_rows`` shed-and-count valve bounds.

Accounting the tests assert on rides on the launcher itself
(``reparent_epochs_total`` / ``reparent_orphans_total`` /
``reparent_frames_total``, ``MetricsAggregate.stats()``,
``HeartbeatMonitor.scanned_total``) plus the fleet-side convergence
clock (:meth:`SimFleet.wait_adopted`) and the false-positive audit
(:meth:`SimFleet.false_positive_rank_deaths`).
"""

from __future__ import annotations

import contextlib
import random
import threading
import time
from typing import Any, Optional

from ompi_tpu_torch.core import output
from ompi_tpu_torch.core.config import var_registry
from ompi_tpu_torch.runtime import metrics as metrics_mod
from ompi_tpu_torch.runtime import rml
from ompi_tpu_torch.runtime.job import AppContext, Job, Node, Proc, ProcState

__all__ = ["SimDaemon", "SimFleet"]

_log = output.get_stream("simfleet")


def _depth(vpid: int) -> int:
    """Tree depth of a vpid (hops to the HNP) — storm waves push
    deepest-first so every hop's payload includes its children's."""
    d = 0
    v = vpid
    while v:
        parent = rml.tree_parent(v)
        v = 0 if parent is None else parent
        d += 1
    return d


class SimDaemon:
    """One simulated daemon: a real RmlNode speaking the orted control
    protocol, no subprocess and no rank interpreters.

    Mirrors orted's handshakes faithfully (register → wire → ready,
    heartbeats, ORPHANED → REPARENT/ADOPT → REPARENT_ACK, doctor
    captures pre-aggregated by ``doctor_rows_per_daemon``) with one
    deliberate difference: where a real orted calls ``os._exit`` (lost
    lifeline under a non-tolerant policy, adoption timeout) a SimDaemon
    records ``self.failed`` and closes its node — the harness must
    observe the death, not die with it.
    """

    def __init__(self, fleet: "SimFleet", vpid: int, hnp_uri: str,
                 ranks: list[tuple[int, int]]) -> None:
        self.fleet = fleet
        self.vpid = vpid
        self.ranks = list(ranks)          # [(jobid, rank), ...] stubs
        self.hostname = f"fleet{vpid:04d}"
        self.failed: Optional[str] = None  # why this daemon gave up
        self.killed = False                # harness-injected death
        self._stop = threading.Event()
        self._done = threading.Event()
        self._reparent_ok = False
        self._reparented = threading.Event()
        self.wired = threading.Event()
        self.adoptions_total = 0           # REPARENT orders taken
        self.orphan_reports_total = 0      # ORPHANED frames sent
        self._push_n = 0
        self._mlock = threading.Lock()
        self._pending: dict = {}           # children's TAG_METRICS hops
        self._rng = random.Random(fleet.seed * 100003 + vpid)
        node = self.node = rml.RmlNode(vpid)
        node.register_recv(rml.TAG_WIRE, self._on_wire)
        node.register_recv(rml.TAG_SHUTDOWN, self._on_shutdown)
        node.register_recv(rml.TAG_REPARENT, self._on_reparent)
        node.register_recv(rml.TAG_ADOPT, self._on_adopt)
        node.register_recv(rml.TAG_DOCTOR, self._on_doctor)
        node.register_recv(rml.TAG_METRICS, self._on_child_metrics)
        # control frames a stub world carries no ranks for: accept and
        # drop (the xcast relay to children happens below the handler,
        # so a mid-tree stub still forwards them)
        for tag in (rml.TAG_PROC_FAILED, rml.TAG_KILL, rml.TAG_LAUNCH,
                    rml.TAG_STDIN, rml.TAG_RESPAWN, rml.TAG_KILL_RANK,
                    rml.TAG_SIGNAL_RANK, rml.TAG_TIMELINE,
                    rml.TAG_STATS):
            node.register_recv(tag, self._on_noop)
        node.on_peer_lost = self._on_lifeline_lost
        self._boot = node.dial_bootstrap(hnp_uri)
        node.fallback_up = self._boot
        node.send_direct(self._boot, rml.TAG_REGISTER,
                         (vpid, node.uri, self.hostname))
        threading.Thread(target=self._start_beats,
                         name=f"fleet-hb-{vpid}", daemon=True).start()

    # -- liveness ---------------------------------------------------------

    @property
    def alive(self) -> bool:
        return (not self.killed and self.failed is None
                and not self._done.is_set())

    def _fail(self, why: str) -> None:
        """Where orted would os._exit: record the reason and go dark."""
        if self.failed is None and not self.killed:
            self.failed = why
            _log.verbose(1, "simdaemon %d failed: %s", self.vpid, why)
        self._stop.set()
        self._done.set()
        try:
            self.node.close()
        except OSError:
            pass

    def kill(self) -> None:
        """Harness-injected SIGKILL: every socket closes at once — the
        parent sees a child EOF, the children see the lifeline EOF, the
        HNP sees the boot link EOF.  No goodbye frames."""
        self.killed = True
        self._stop.set()
        self._done.set()
        try:
            self.node.close()
        except OSError:
            pass

    # -- boot / wire (mirrors orted._on_wire) -----------------------------

    def _start_beats(self) -> None:
        if self.node.wait_parent(60.0) and not self._stop.is_set():
            rml.start_heartbeats(self.node, self._stop)

    def _on_wire(self, origin: int, payload: Any) -> None:
        if isinstance(payload, dict):
            children = payload["children"]
            self._reparent_ok = bool(payload.get("reparent"))
        else:
            children = payload
        try:
            self.node.dial_children([tuple(c) for c in children])
        except OSError as e:
            self._fail(f"wiring children failed: {e!r}")
            return
        if not self.node.wait_parent(timeout=30.0):
            self._fail("parent never dialed in")
            return
        self.wired.set()
        self.node.send_up(rml.TAG_DAEMON_READY, self.vpid)

    def _on_shutdown(self, origin: int, payload: Any) -> None:
        self._done.set()
        self._stop.set()
        threading.Thread(target=self.node.close, daemon=True).start()

    def _on_noop(self, origin: int, payload: Any) -> None:
        return

    # -- lifeline / reparent (mirrors orted's orphan machinery) -----------

    def _on_lifeline_lost(self, peer: int) -> None:
        if peer not in (0, self.node.parent_vpid):
            return  # a child died; its own subtree reports it
        if self._done.is_set() or self._stop.is_set():
            return
        if peer != 0 and self._reparent_ok:
            self._reparented.clear()
            self.orphan_reports_total += 1
            try:
                self.node.send_direct(self._boot, rml.TAG_ORPHANED,
                                      (self.vpid, peer))
            except OSError:
                pass  # boot link also dead: the HNP's detectors take it
            threading.Thread(target=self._orphan_watch,
                             daemon=True).start()
            return
        self._fail(f"lifeline to vpid {peer} lost")

    def _orphan_watch(self) -> None:
        base = float(var_registry.get("rml_reparent_timeout") or 10.0)
        timeout = rml.scaled_timeout(base, self.fleet.world)
        if self._reparented.wait(timeout) or self._done.is_set():
            return
        self._fail(f"orphaned and no adoption within {timeout:.1f}s")

    def _on_reparent(self, origin: int, payload: Any) -> None:
        new_parent = int(payload)
        self.adoptions_total += 1
        self.node.retarget_parent(new_parent)

        def rewire() -> None:
            if not self.node.wait_parent(timeout=30.0):
                if not self._done.is_set():
                    self._fail(f"adopter {new_parent} never dialed in")
                return
            self._reparented.set()
            try:
                self.node.send_up(rml.TAG_REPARENT_ACK,
                                  (self.vpid, new_parent))
            except (ConnectionError, OSError):
                pass

        threading.Thread(target=rewire, daemon=True).start()

    def _on_adopt(self, origin: int, payload: Any) -> None:
        children = [tuple(c) for c in payload]

        def dial() -> None:
            try:
                self.node.dial_children(children)
            except OSError as e:
                _log.verbose(1, "simdaemon %d adopt dial failed: %r",
                             self.vpid, e)

        threading.Thread(target=dial, daemon=True).start()

    # -- doctor (hierarchical capture, O(hosts) at the HNP) ---------------

    def _on_doctor(self, origin: int, payload: Any) -> None:
        threading.Thread(target=self._doctor_reply, args=(payload,),
                         daemon=True).start()

    def _doctor_reply(self, epoch: Any) -> None:
        from ompi_tpu_torch.runtime import doctor

        limit = int(var_registry.get("doctor_rows_per_daemon") or 0)
        by_job: dict[int, list[int]] = {}
        for jobid, rank in self.ranks:
            by_job.setdefault(jobid, []).append(rank)
        rows: list[dict] = []
        for jobid, rks in by_job.items():
            job_rows = [self._stub_capture(jobid, r) for r in rks]
            kept, summary = doctor.summarize_rows(job_rows, limit)
            if summary is not None:
                summary["jobid"] = jobid
                summary["vpid"] = self.vpid
                kept.append(summary)
            rows.extend(kept)
        try:
            self.node.send_up(rml.TAG_DOCTOR_REPLY,
                              (self.vpid, epoch, rows))
        except (ConnectionError, OSError):
            pass

    def _stub_capture(self, jobid: int, rank: int) -> dict:
        """A synthetic per-rank capture: every stub is mid-allreduce at
        the fleet's shared op_seq — the all-healthy shape, so any
        no_response / stuck rows in a collected doc are real signal."""
        return {"jobid": jobid, "rank": rank, "pid": 0, "stuck": 0,
                "cur": {"cid": 0, "seq": self.fleet.op_seq,
                        "kind": "allreduce", "age_s": 0.01,
                        "done": False},
                "collrec": []}

    # -- metrics uplink ---------------------------------------------------

    def _on_child_metrics(self, origin: int, payload: Any) -> None:
        with self._mlock:
            metrics_mod.merge_hop(self._pending, payload)

    def push_metrics(self, full: bool = False) -> None:
        """One uplink push: this daemon's stub-rank counters merged over
        whatever its children pushed since the last wave (the per-hop
        aggregation a real orted's collector thread does).  ``full``
        fattens each row into a whole-snapshot push — the storm shape."""
        if not self.alive:
            return
        now = time.time()
        self._push_n += 1
        with self._mlock:
            payload, self._pending = self._pending, {}
        for jobid, rank in self.ranks:
            row: dict[str, float] = {
                "fleet_steps_total": float(self._push_n),
                "fleet_push_datagrams_total": float(self._push_n),
            }
            if full:
                row["fleet_bytes_total"] = float(
                    self._rng.randrange(1 << 20))
                for i in range(14):
                    row[f"fleet_snapshot_pad_{i}_total"] = float(i)
            payload.setdefault(jobid, {})[rank] = [now, row]
        try:
            self.node.send_hop(rml.TAG_METRICS, payload)
        except (ConnectionError, OSError):
            with self._mlock:  # like UDP loss: counters are cumulative
                metrics_mod.merge_hop(self._pending, payload)


class SimFleet:
    """A simulated N-daemon / M-stub-rank world around the REAL HNP.

    Usage::

        fleet = SimFleet(n_daemons=100, n_ranks=1000, seed=7)
        fleet.start()
        try:
            fleet.rack_kill(fleet.rack(16))
            dt = fleet.wait_adopted(timeout=30.0)
            assert fleet.false_positive_rank_deaths() == []
        finally:
            fleet.stop()
    """

    def __init__(self, n_daemons: int, n_ranks: int, *,
                 errmgr: str = "notify", seed: int = 0,
                 hb_period: float = 0.0, hb_timeout: float = 3.0,
                 loss_window: float = 0.25,
                 doctor_rows: Optional[int] = None,
                 agg_budget_rows: Optional[int] = None) -> None:
        if n_ranks % n_daemons:
            raise ValueError("n_ranks must divide evenly over n_daemons")
        self.n_daemons = n_daemons
        self.n_ranks = n_ranks
        self.world = n_daemons + 1       # + the HNP, for timeout scaling
        self.seed = seed
        self.op_seq = 1 + seed % 97      # shared stub collective seq
        self.daemons: dict[int, SimDaemon] = {}
        self.launcher = None
        self.job: Optional[Job] = None
        self._killed_vpids: set[int] = set()
        self._saved_vars: dict[str, Any] = {}
        self._want_vars = {
            "errmgr_": errmgr,
            "rml_heartbeat_period": hb_period,
            "rml_heartbeat_timeout": hb_timeout,
            "plm_loss_epoch_window": loss_window,
        }
        if doctor_rows is not None:
            self._want_vars["doctor_rows_per_daemon"] = doctor_rows
        if agg_budget_rows is not None:
            self._want_vars["metrics_agg_budget_rows"] = agg_budget_rows
        # fleet-side doctor collection (epoch-fenced, like DvmHnp's)
        self._doc_cv = threading.Condition()
        self._doc_epoch = 0
        self._doc_rows: list[dict] = []
        self._doc_seen: set[int] = set()

    # -- lifecycle --------------------------------------------------------

    def start(self, timeout: float = 60.0) -> None:
        from ompi_tpu_torch.runtime.plm import MultiHostLauncher

        for name, val in self._want_vars.items():
            self._saved_vars[name] = var_registry.get(name)
            var_registry.set(name, val)
        rpd = self.n_ranks // self.n_daemons
        nodes = [Node(name=f"fleet{i + 1:04d}", slots=rpd)
                 for i in range(self.n_daemons)]
        app = AppContext(argv=["<fleet-stub>"], np=self.n_ranks)
        job = self.job = Job([app])
        job.nodes = nodes
        job.procs = [Proc(rank=r, node=nodes[r // rpd],
                          state=ProcState.RUNNING, local_rank=r % rpd)
                     for r in range(self.n_ranks)]
        launcher = self.launcher = MultiHostLauncher(plm_name="sim")
        launcher.plm = _FleetPlm(self)
        launcher._persistent = True      # the VM outlives any one job
        # apps are never launched (the ranks are stubs), so register the
        # job for the exit/doctor/metrics routers by hand
        launcher._jobs_by_id[job.jobid] = job
        old_timeout = var_registry.get("plm_daemon_timeout")
        var_registry.set("plm_daemon_timeout",
                         max(float(old_timeout or 30.0), timeout))
        try:
            if not launcher._vm_up(job):
                raise RuntimeError(
                    f"fleet VM failed to come up: {job.abort_reason}")
        finally:
            var_registry.set("plm_daemon_timeout", old_timeout)
        launcher.rml.register_recv(rml.TAG_DOCTOR_REPLY,
                                   self._on_doctor_reply)

    def _spawn(self, job: Job, hnp_uri: str) -> None:
        """_FleetPlm's spawn hook: bring up every SimDaemon in-process
        (vpid = pool index + 1, exactly like the subprocess plms)."""
        for i, node in enumerate(job.nodes):
            vpid = i + 1
            ranks = [(job.jobid, p.rank) for p in job.procs_on(node)]
            self.daemons[vpid] = SimDaemon(self, vpid, hnp_uri, ranks)

    def stop(self) -> None:
        for d in self.daemons.values():
            d._done.set()   # teardown, not a failure to diagnose
        if self.launcher is not None and self.launcher.rml is not None:
            self.launcher._teardown_vm()
        for d in self.daemons.values():
            d._stop.set()
            try:
                d.node.close()
            except OSError:
                pass
        for name, val in self._saved_vars.items():
            var_registry.set(name, val)
        self._saved_vars.clear()

    # -- failure injectors ------------------------------------------------

    def rack(self, n: int, *, mid_tree: bool = True) -> list[int]:
        """Pick a deterministic 'rack' of n daemon vpids to kill: a
        contiguous vpid band starting mid-tree (so victims include
        interior daemons with live children — the reparent-storm case),
        never vpid 1 alone at the root of everything."""
        if n > self.n_daemons:
            raise ValueError("rack bigger than the fleet")
        start = max(2, self.n_daemons // 4) if mid_tree else 1
        start = min(start, self.n_daemons - n + 1)
        return list(range(start, start + n))

    def rack_kill(self, vpids: list[int]) -> None:
        """Correlated loss: every named daemon dies in the same tick.

        The HNP's loss detectors wait on the launcher's lock while the
        victims' sockets close: each close hands the GIL to the threads
        its EOFs wake, so on a loaded host a bare loop spread one rack's
        deaths over more than ``plm_loss_epoch_window`` (0.25 s for 12
        of 16 daemons in a 100-daemon world) and split one correlated
        loss into two epochs.  Held, the 16 closes take milliseconds and
        the detectors then see every death at once."""
        for v in vpids:
            self._killed_vpids.add(v)
        launcher = getattr(self, "launcher", None)
        with (launcher._cv if launcher is not None
              else contextlib.nullcontext()):
            for v in vpids:
                self.daemons[v].kill()

    def partition(self, vpids: list[int]) -> None:
        """Fence a set of daemons: ALL frames (both directions) drop,
        sockets stay alive.  Call :meth:`heal` to lift it."""
        for v in vpids:
            self.daemons[v].node.frame_gate = lambda _d, _t: False

    def heal(self, vpids: list[int]) -> None:
        for v in vpids:
            self.daemons[v].node.frame_gate = None

    def metrics_storm(self, full: bool = True,
                      settle: float = 0.05) -> None:
        """Every live daemon pushes in one wave, deepest tree level
        first so each hop's push folds its children's payloads — the
        worst-case HNP fan-in the shed-and-count budget must bound."""
        by_depth: dict[int, list[SimDaemon]] = {}
        for d in self.daemons.values():
            if d.alive:
                by_depth.setdefault(_depth(d.vpid), []).append(d)
        for depth in sorted(by_depth, reverse=True):
            for d in by_depth[depth]:
                d.push_metrics(full=full)
            time.sleep(settle)

    # -- doctor collection (epoch-fenced, O(hosts) fan-in) ----------------

    def _on_doctor_reply(self, origin: int, payload: Any) -> None:
        try:
            vpid, epoch, rows = payload
        except (TypeError, ValueError):
            return
        with self._doc_cv:
            if epoch != self._doc_epoch or vpid in self._doc_seen:
                return  # stale epoch or duplicate relay
            self._doc_seen.add(int(vpid))
            self._doc_rows.extend(rows)
            self._doc_cv.notify_all()

    def collect_doctor(self, timeout: float = 8.0) -> tuple[list[dict],
                                                            set[int]]:
        """One fleet-wide doctor capture: xcast the epoch, gather the
        per-daemon pre-aggregated rows.  Returns (rows, replied_vpids);
        rows is O(hosts × doctor_rows_per_daemon), not O(ranks)."""
        live = {v for v, d in self.daemons.items() if d.alive}
        with self._doc_cv:
            self._doc_epoch += 1
            epoch = self._doc_epoch
            self._doc_rows = []
            self._doc_seen = set()
        self.launcher.rml.xcast(rml.TAG_DOCTOR, epoch)
        with self._doc_cv:
            self._doc_cv.wait_for(lambda: self._doc_seen >= live,
                                  timeout=timeout)
            return list(self._doc_rows), set(self._doc_seen)

    # -- convergence / audit ----------------------------------------------

    def converged(self) -> bool:
        """Every injected death detected, every surviving daemon wired
        to a LIVE parent, nobody failed on its own."""
        dead = set(self.launcher._dead_daemons)
        if not self._killed_vpids <= dead:
            return False  # a corpse the HNP hasn't noticed yet
        for vpid, d in self.daemons.items():
            if not d.alive:
                if not d.killed:
                    return False  # died on its own — never converges
                continue
            if not d.node.parent_wired.is_set():
                return False
            parent = d.node.parent_vpid
            if parent is None or parent in dead:
                return False
            if parent != 0 and not self.daemons[parent].alive:
                return False
        return True

    def wait_adopted(self, timeout: float = 30.0) -> Optional[float]:
        """Block until the fleet converges; returns the elapsed seconds
        (the convergence clock fleet_bench records) or None on timeout."""
        t0 = time.monotonic()
        deadline = t0 + timeout
        while time.monotonic() < deadline:
            if self.converged():
                return time.monotonic() - t0
            time.sleep(0.02)
        return None

    def false_positive_rank_deaths(self) -> list[int]:
        """Ranks the control plane declared dead whose daemon the
        harness never killed — must be empty after any injected loss."""
        out = []
        for p in self.job.procs:
            if p.state is ProcState.ABORTED or p.daemon_lost:
                vpid = self.launcher._node_vpid(p.node)
                if vpid not in self._killed_vpids:
                    out.append(p.rank)
        return sorted(out)

    def live_daemons(self) -> int:
        return sum(1 for d in self.daemons.values() if d.alive)

    def self_failed(self) -> dict[int, str]:
        """Daemons that gave up on their own (adoption timeout, wire
        failure) — any entry here is a containment bug."""
        return {v: d.failed for v, d in self.daemons.items()
                if d.failed is not None}

    def stats(self) -> dict:
        """The control-plane cost counters fleet_bench records."""
        la = self.launcher
        agg = la.metrics_agg.stats()
        hb = la._hb_monitor
        return {
            "world": self.world,
            "n_ranks": self.n_ranks,
            "reparent_epochs_total": la.reparent_epochs_total,
            "reparent_orphans_total": la.reparent_orphans_total,
            "reparent_frames_total": la.reparent_frames_total,
            "agg_merges_total": agg.get("merges_total", 0),
            "agg_merge_ns_total": agg.get("merge_ns_total", 0),
            "agg_sheds_total": agg.get("sheds_total", 0),
            "agg_shed_rows_total": agg.get("shed_rows_total", 0),
            "hb_scanned_total": 0 if hb is None else hb.scanned_total,
            "hb_ticks_total": 0 if hb is None else hb.ticks_total,
            "live_daemons": self.live_daemons(),
        }


class _FleetPlm:
    """The plm seam: spawn_daemons brings up in-process SimDaemons and
    returns no Popen handles (every Popen consumer tolerates an empty
    list).  NAME is 'sim' so the launcher advertises a loopback HNP
    address, same as the subprocess sim plm."""

    NAME = "sim"

    def __init__(self, fleet: SimFleet) -> None:
        self.fleet = fleet

    def spawn_daemons(self, job: Job, hnp_uri: str) -> list:
        self.fleet._spawn(job, hnp_uri)
        return []
