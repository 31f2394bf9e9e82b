"""orted — the per-host runtime daemon (the port's copy of the JAX
package's ``runtime/orted.py``).

≈ orte/orted/orted_main.c:223: launched by the plm on every host of the
job, it phones home to the HNP, joins the routed tree, and runs the local
half of the runtime: fork/exec of its ranks (odls), IOF up-forwarding,
stdin down-delivery, exit reporting, and kill-on-command.

Run as ``python -m ompi_tpu_torch.runtime.orted --hnp <uri> --vpid <n> ...``.
``--fake-host`` gives the daemon a simulated host identity (exported as
``OMPI_TPU_FAKE_HOST``) so multi-host paths are testable on one machine —
the process-level analog of ras/simulator's fake nodes.

What it runs: phone-home and wire-up, heartbeats, the lifeline rule and
the orphan watch, re-parenting (``TAG_REPARENT``/``TAG_ADOPT``), the
kills (``TAG_KILL``, ``TAG_KILL_RANK``, ``TAG_SIGNAL_RANK``), launch and
revival (``TAG_LAUNCH``, ``TAG_RESPAWN``), IOF and stdin, the clock-sync
prober, the metrics collector with its ``TAG_METRICS`` hop, and the
three fan-outs a standing DVM (``runtime/dvm.py``) sends: ``TAG_STATS``
(per-rank rss and cpu time from ``/proc``), ``TAG_DOCTOR`` (the live
hang-doctor capture) and ``TAG_TIMELINE`` (the live flight-recorder
tails).  The two captures wait on their ranks' UDP responders, so they
run on a thread of their own, never on the RML reader.  An orted imports
no torch.

Two rules are the port's own:

- A ``--gpu`` rank gets its card (``OMPI_TPU_CHIP``).  Only a first life
  gets the rendezvous (``OMPI_TPU_COORD``, ``OMPI_TPU_NHOSTS``): a
  process group cannot take a member's new life, so a revived life keeps
  its card and runs alone, as the local launcher's does.
- A rank dies with its orted.  Every rank is started from the daemon's
  main thread through a small exec stub that arms the kernel's
  parent-death signal (``PR_SET_PDEATHSIG``, SIGKILL) before it execs
  the rank's program, so a daemon that is SIGKILLed (the host death the
  fault plans inject) cannot leave an orphan behind — one that would
  keep running, or keep its CUDA context, after the HNP has declared it
  dead.  The signal is tied to the thread that forked the child, hence
  the one long-lived spawning thread.
"""

from __future__ import annotations

import argparse
import os
import queue
import shutil
import signal
import subprocess
import sys
import threading
import time
from typing import Optional

from ompi_tpu_torch.core import output
from ompi_tpu_torch.runtime import pmix, rml
from ompi_tpu_torch.runtime.launcher import ENV_COORD, ENV_NHOSTS, \
    _pkg_root, _StdinWriter

_log = output.get_stream("orted")

#: exported to every rank: the pid of the daemon that started it
ENV_ORTED_PID = "OMPI_TPU_ORTED_PID"

#: resident bytes below which a rank's TAG_STATS row is left out: a
#: process this small has been exec'd and not yet run its program
_MIN_RSS = 64 << 10

#: ``python -S -c`` source run in place of a rank's program: arm
#: SIGKILL on the death of the daemon's spawning thread, leave at once if
#: the daemon is already gone, then exec the program (argv[1] is the
#: daemon's pid, argv[2:] the rank's argv; 127 if it cannot run)
_PDEATH_STUB = (
    "import ctypes, os, signal, sys\n"
    "ctypes.CDLL(None, use_errno=True).prctl(1, signal.SIGKILL)\n"
    "if os.getppid() != int(sys.argv[1]):\n"
    "    os._exit(1)\n"
    "try:\n"
    "    os.execvp(sys.argv[2], sys.argv[2:])\n"
    "except OSError as e:\n"
    "    sys.stderr.write(f'orted: cannot run {sys.argv[2]}: {e}\\n')\n"
    "    os._exit(127)\n")


class _LocalJob:
    """One tenant's local state on this daemon: the launch spec, the
    rows this daemon owns (rank → (local_rank, chip)), and the live
    Popen/stdin handles.  A multi-tenant DVM runs several jobs at once,
    so everything that used to be daemon-global lives here, keyed by
    jobid.  The full spec is stored on EVERY daemon (the launch xcast
    carries the whole map), which is what lets a TAG_RESPAWN retarget a
    rank to a daemon that never owned it (migration on revive)."""

    def __init__(self, jobid: int, spec: dict) -> None:
        self.jobid = jobid
        self.spec = spec
        self.rows: dict[int, tuple[int, Optional[str]]] = {}
        self.popen: dict[int, subprocess.Popen] = {}
        self.stdin_writers: dict[int, _StdinWriter] = {}


class Orted:
    def __init__(self, hnp_uri: str, vpid: int, ndaemons: int,
                 fake_host: Optional[str] = None) -> None:
        self.vpid = vpid
        self.ndaemons = ndaemons
        self.fake_host = fake_host
        self.hostname = fake_host or os.uname().nodename
        self.node = rml.RmlNode(vpid)
        self._jobs: dict[int, _LocalJob] = {}
        self._launched = False
        self._pending_stdin: list = []  # stdin xcasts that beat the launch
        self._lock = threading.Lock()
        self._done = threading.Event()
        self._wired = threading.Event()
        # re-parenting: armed by the WIRE payload when the errmgr policy
        # tolerates daemon loss (notify) — a lost tree parent then opens
        # a bounded adoption window instead of the lifeline teardown
        self._reparent_ok = False
        self._reparented = threading.Event()
        # spawn orders for the main thread (see the module docstring on
        # the parent-death signal); None wakes it to exit
        self._spawnq: queue.Queue = queue.Queue()
        self.node.register_recv(rml.TAG_WIRE, self._on_wire)
        self.node.register_recv(rml.TAG_LAUNCH, self._on_launch)
        self.node.register_recv(rml.TAG_KILL, self._on_kill)
        self.node.register_recv(rml.TAG_STDIN, self._on_stdin)
        self.node.register_recv(rml.TAG_RESPAWN, self._on_respawn)
        self.node.register_recv(rml.TAG_PROC_FAILED, self._on_proc_failed)
        self.node.register_recv(rml.TAG_REPARENT, self._on_reparent)
        self.node.register_recv(rml.TAG_ADOPT, self._on_adopt)
        self.node.register_recv(rml.TAG_KILL_RANK, self._on_kill_rank)
        self.node.register_recv(rml.TAG_SIGNAL_RANK, self._on_signal_rank)
        self.node.register_recv(rml.TAG_STATS, self._on_stats)
        self.node.register_recv(rml.TAG_DOCTOR, self._on_doctor)
        self.node.register_recv(rml.TAG_TIMELINE, self._on_timeline)
        # measured clock sync: pingpong my parent edge, compose the
        # offset to the root, and answer my own children's probes with
        # it (offsets compose down the tree; ranks share my kernel
        # clock, so my offset is theirs)
        from ompi_tpu_torch.runtime import clocksync

        self._clock = clocksync.ClockProber(self.node)
        clocksync.install_responder(self.node,
                                    self._clock.offset_to_root_ns)
        # metrics uplink: when trace_metrics_push_period > 0 this daemon
        # runs a UDP collector its local ranks push pvar snapshots to
        # (the URI is exported into every rank's env), merges them with
        # child daemons' TAG_METRICS payloads, and forwards one combined
        # delta per period ONE hop up — per-level aggregation, exactly
        # the HiCCL per-level-visibility argument applied to metrics
        self._metrics = None
        from ompi_tpu_torch.mpi import trace as trace_mod

        period = trace_mod.push_period()
        if period > 0:
            from ompi_tpu_torch.runtime.metrics import MetricsCollector

            self._metrics = MetricsCollector(
                period, lambda payload: self.node.send_hop(
                    rml.TAG_METRICS, payload))
            self.node.register_recv(
                rml.TAG_METRICS,
                lambda o, p: self._metrics.on_child_payload(p))
            # the measured offset rides the existing uplink: every rank
            # row this daemon forwards carries its host's composed
            # clock offset (None until the pingpong window fills —
            # drain() drops None values)
            # (the port adds the edge's min rtt, the bound on that
            # offset's error for a daemon one hop below the root)
            self._metrics.extra_values_fn = lambda: {
                "rank_clock_to_root_ns":
                    self._clock.offset_to_root_ns(),
                "rank_clock_rtt_ns": self._clock.est.rtt_ns()}
        self.node.register_recv(rml.TAG_SHUTDOWN, self._on_shutdown)
        # lifeline: if the HNP or my tree parent vanishes, my ranks'
        # reports have nowhere to go — kill them and die rather than leak
        # (≈ orted treating a lost lifeline as job abort, orted_main.c)
        self.node.on_peer_lost = self._on_lifeline_lost
        self._boot = self.node.dial_bootstrap(hnp_uri)
        # while orphaned (tree parent dead, adoption pending) up-traffic
        # — exit reports, heartbeats — rides the bootstrap link instead
        self.node.fallback_up = self._boot
        self.node.send_direct(self._boot, rml.TAG_REGISTER,
                              (vpid, self.node.uri, self.hostname))
        # liveness beats toward the HNP (no-op when the period var is 0);
        # beats start only once the tree up-link exists
        threading.Thread(target=self._start_heartbeats, daemon=True).start()
        # deterministic chaos: a fault plan naming this daemon arms a
        # self-SIGKILL (the injected 'host death' the heartbeat detector
        # and notify policy exist to survive)
        from ompi_tpu_torch.testing import faultinject

        faultinject.arm_daemon(vpid)

    def _start_heartbeats(self) -> None:
        if self.node.wait_parent(timeout=60.0) or self.vpid == 0:
            rml.start_heartbeats(self.node, self._done)
            self._clock.start()   # probes need the up-link to exist

    def _on_proc_failed(self, origin: int, payload) -> None:
        """errmgr notify propagation: a rank somewhere in the job died and
        the job is continuing — log it so every host's record shows which
        peer vanished (app ranks learn through the PMIx dead-set).  The
        rank slot carries a LIST for a batched correlated-daemon-loss
        propagation (one xcast for a whole rack's worth of ranks)."""
        rank, reason = payload
        ranks = list(rank) if isinstance(rank, (list, tuple)) else [rank]
        _log.verbose(1, "orted %d: peer rank(s) %s failed (%s); job "
                     "continues", self.vpid, ranks, reason)

    # -- tree wiring -------------------------------------------------------

    def _on_wire(self, origin: int, payload) -> None:
        if isinstance(payload, dict):
            children = payload["children"]   # [(vpid, uri), ...]
            self._reparent_ok = bool(payload.get("reparent"))
        else:
            children = payload  # legacy list form
        try:
            self.node.dial_children([tuple(c) for c in children])
        except OSError as e:
            _log.error("orted %d: wiring children failed: %r", self.vpid, e)
            os._exit(1)
        # WIRE arrives on the bootstrap link, but DAEMON_READY rides the
        # tree — the parent's dial may still be in flight.  Gate the reply
        # on the up-link actually existing (this runs on the bootstrap
        # reader thread; the parent's hello arrives on its own thread).
        if not self.node.wait_parent(timeout=30.0):
            _log.error("orted %d: parent never dialed in", self.vpid)
            os._exit(1)
        self._wired.set()
        self.node.send_up(rml.TAG_DAEMON_READY, self.vpid)

    def _on_lifeline_lost(self, peer: int) -> None:
        if peer not in (0, self.node.parent_vpid):
            return  # a child daemon died; the HNP handles that
        if self._done.is_set():
            return  # normal teardown: SHUTDOWN already processed
        if peer != 0 and self._reparent_ok:
            # mid-tree parent death under the notify policy: do NOT apply
            # the lifeline rule — report orphanhood on the bootstrap link
            # and wait (bounded) for the HNP-arbitrated adoption, so loss
            # stays confined to the dead host's ranks
            _log.error("orted %d: tree parent %d lost; requesting "
                       "re-parenting", self.vpid, peer)
            self._reparented.clear()
            try:
                self.node.send_direct(self._boot, rml.TAG_ORPHANED,
                                      (self.vpid, peer))
            except OSError:
                pass  # HNP unreachable too → the watch below tears down
            threading.Thread(target=self._orphan_watch,
                             daemon=True).start()
            return
        _log.error("orted %d: lifeline to %d lost; tearing down", self.vpid,
                   peer)
        self._on_kill(peer, None)
        os._exit(1)

    def _orphan_watch(self) -> None:
        """Bounded adoption window: no TAG_REPARENT handshake within
        ``rml_reparent_timeout`` seconds means the job really is coming
        down — fall back to the lifeline teardown rather than leak."""
        from ompi_tpu_torch.core.config import var_registry

        timeout = float(var_registry.get("rml_reparent_timeout") or 10.0)
        if self._reparented.wait(timeout) or self._done.is_set():
            return
        _log.error("orted %d: no adoption within %.1fs; tearing down",
                   self.vpid, timeout)
        self._on_kill(0, None)
        os._exit(1)

    def _on_reparent(self, origin: int, payload) -> None:
        """HNP arbitration reply (bootstrap link): expect ``payload``'s
        hello as my new tree parent, then ack up the re-wired tree."""
        new_parent = int(payload)
        _log.verbose(1, "orted %d: re-parenting to %d", self.vpid,
                     new_parent)
        self.node.retarget_parent(new_parent)

        def wire() -> None:
            if not self.node.wait_parent(timeout=30.0):
                return  # the orphan watch handles the teardown
            self._reparented.set()
            try:
                self.node.send_up(rml.TAG_REPARENT_ACK,
                                  (self.vpid, new_parent))
            except (ConnectionError, OSError):
                pass

        threading.Thread(target=wire, daemon=True).start()

    def _on_adopt(self, origin: int, payload) -> None:
        """HNP adoption order (bootstrap link): dial the orphans as my
        new tree children (the parent side always dials)."""
        orphans = [tuple(c) for c in payload]

        def dial() -> None:
            try:
                self.node.dial_children(orphans)
            except OSError as e:
                _log.error("orted %d: adopting %r failed: %r", self.vpid,
                           [v for v, _u in orphans], e)

        threading.Thread(target=dial, daemon=True).start()

    def _on_kill_rank(self, origin: int, payload) -> None:
        """Reap exactly one rank (a hung pid the rank-plane gossip
        detector reported): SIGKILL its process group; the exit report
        then flows through the normal waiter → errmgr path."""
        jobid, rank = int(payload[0]), int(payload[1])
        with self._lock:
            lj = self._jobs.get(jobid)
            p = lj.popen.get(rank) if lj is not None else None
        if p is None or p.poll() is not None:
            return
        _log.verbose(1, "orted %d: reaping reported-dead rank %d (pid %d)",
                     self.vpid, rank, p.pid)
        try:
            os.killpg(p.pid, signal.SIGKILL)
        except (ProcessLookupError, PermissionError):
            pass

    def _on_signal_rank(self, origin: int, payload) -> None:
        """Deliver one signal to one rank's process group — the DVM
        remediation actor's SIGCONT probe (a SIGSTOP'd straggler may
        just resume; only if it stays wedged does the actor pay a
        reap-and-revive)."""
        jobid, rank, signum = (int(payload[0]), int(payload[1]),
                               int(payload[2]))
        with self._lock:
            lj = self._jobs.get(jobid)
            p = lj.popen.get(rank) if lj is not None else None
        if p is None or p.poll() is not None:
            return
        _log.verbose(1, "orted %d: signal %d → rank %d (pid %d)",
                     self.vpid, signum, rank, p.pid)
        try:
            os.killpg(p.pid, signum)
        except (ProcessLookupError, PermissionError):
            pass

    # -- odls: local launch ------------------------------------------------

    def _on_launch(self, origin: int, payload) -> None:
        # payload: {"by_daemon": [(vpid, [(rank, local_rank, chip)...])...],
        #           "argv", "env", "cwd", "stdin_rank"} — the whole map is
        # xcast once; each daemon picks its own rows (≈ the launch msg
        # grpcomm floods down the tree)
        self._spawnq.put((self._launch_local, (payload,), {}))

    def _spawn_rank(self, lj: _LocalJob, rank: int, local_rank: int,
                    chip, restarts: int = 0) -> None:
        """Fork/exec one rank (first launch or TAG_RESPAWN revival)."""
        from ompi_tpu_torch.runtime.rtc import bind_child

        spec = lj.spec
        root = _pkg_root()
        env = dict(os.environ)
        env.update(spec["env"])
        pypath = env.get("PYTHONPATH", "")
        if root not in pypath.split(os.pathsep):
            env["PYTHONPATH"] = (
                root + (os.pathsep + pypath if pypath else ""))
        env[pmix.ENV_RANK] = str(rank)
        env[pmix.ENV_LOCAL_RANK] = str(local_rank)
        if chip is not None:
            env[pmix.ENV_CHIP] = str(chip)
        if self.fake_host:
            env["OMPI_TPU_FAKE_HOST"] = self.fake_host
        env[ENV_ORTED_PID] = str(os.getpid())
        if restarts:
            env["OMPI_TPU_RESTART"] = str(restarts)
            # a revived life never rejoins the process group (it cannot
            # take a new incarnation of a member): no rendezvous for it
            env.pop(ENV_COORD, None)
            env.pop(ENV_NHOSTS, None)
        else:
            env.pop("OMPI_TPU_RESTART", None)
        if self._metrics is not None:
            # ranks and their orted share a host, so loopback always
            # reaches the collector — no remote-address discovery needed
            from ompi_tpu_torch.mpi import trace as trace_mod

            env[trace_mod.ENV_METRICS_URI] = self._metrics.uri
        want_stdin = spec.get("stdin_rank") in ("all", rank)
        argv = list(spec["argv"])
        try:
            # the exec stub would report a missing program as exit 127;
            # find it here instead, so it fails to start as Popen's would
            if not argv or shutil.which(argv[0], path=env.get("PATH")) is None \
                    and not os.access(os.path.join(spec.get("cwd") or "",
                                                   argv[0]), os.X_OK):
                raise FileNotFoundError(
                    f"No such file or directory: {argv[:1]!r}")
            p = subprocess.Popen(
                [sys.executable, "-S", "-c", _PDEATH_STUB,
                 str(os.getpid()), *argv], env=env, cwd=spec.get("cwd"),
                stdin=subprocess.PIPE if want_stdin
                else subprocess.DEVNULL,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                start_new_session=True)
        except OSError as e:
            # ≈ odls error-pipe: report the exec failure as an exit
            self.node.send_up(rml.TAG_PROC_EXIT,
                              (lj.jobid, rank, 127, str(e)))
            return
        bind_child(p.pid, local_rank)
        with self._lock:
            lj.popen[rank] = p
            if want_stdin:
                old = lj.stdin_writers.pop(rank, None)
                if old is not None:
                    old.feed(None)
                lj.stdin_writers[rank] = _StdinWriter(rank, p.stdin)
        self._start_iof(lj.jobid, rank, p)
        threading.Thread(target=self._waiter, args=(lj.jobid, rank, p),
                         daemon=True).start()

    def _launch_local(self, spec: dict) -> None:
        jobid = int(spec.get("jobid") or 0)
        mine: list = []
        for vpid, rows in spec["by_daemon"]:
            if vpid == self.vpid:
                mine = rows
                break
        with self._lock:
            lj = self._jobs.get(jobid)
            if lj is None:
                lj = self._jobs[jobid] = _LocalJob(jobid, spec)
            else:
                lj.spec = spec
            lj.rows = {r: (lr, ch) for r, lr, ch in mine}
        # deterministic chaos, barrier-keyed: a plan entry
        # ``daemon=<vpid>:kill@reg=N`` arms a self-SIGKILL that fires
        # only once N ranks have registered with the job's PMIx server
        # (+ an ``after=`` grace) — the kill cannot land mid-init on a
        # slow box the way a fixed kill@t could
        from ompi_tpu_torch.testing import faultinject

        faultinject.arm_daemon_launch(self.vpid, spec.get("env") or {})
        for rank, local_rank, chip in mine:
            self._spawn_rank(lj, rank, local_rank, chip)
        # replay stdin that raced ahead of the launch xcast.  The replay
        # must happen under the lock that gates _launched: otherwise a
        # chunk arriving on the RML thread right after the flag flips
        # could be written before the buffered chunks (reordered stream).
        # feed() is non-blocking (bounded queue), so holding the lock
        # across it is safe.
        with self._lock:
            pending, self._pending_stdin = self._pending_stdin, []
            for rank, chunk in pending:
                for w in self._stdin_targets(rank):
                    w.feed(chunk)
            self._launched = True

    def _stdin_targets(self, rank) -> list[_StdinWriter]:
        """Writers a stdin chunk fans out to (caller holds _lock).
        stdin forwarding is a non-DVM, single-job feature, but routing
        across every job keeps it correct if a tenant ever asks."""
        if rank == "all":
            return [w for lj in self._jobs.values()
                    for w in lj.stdin_writers.values()]
        return [w for lj in self._jobs.values()
                for r, w in lj.stdin_writers.items() if r == rank]

    def _start_iof(self, jobid: int, rank: int,
                   p: subprocess.Popen) -> None:
        def reader(pipe, stream: str) -> None:
            for raw in iter(pipe.readline, b""):
                try:
                    self.node.send_up(rml.TAG_IOF,
                                      (jobid, rank, stream, raw))
                except ConnectionError:
                    return
            pipe.close()

        for pipe, stream in ((p.stdout, "out"), (p.stderr, "err")):
            threading.Thread(target=reader, args=(pipe, stream),
                             daemon=True).start()

    def _waiter(self, jobid: int, rank: int, p: subprocess.Popen) -> None:
        rc = p.wait()
        # let IOF readers drain the tail before the exit report races them
        time.sleep(0.05)
        try:
            self.node.send_up(rml.TAG_PROC_EXIT, (jobid, rank, rc, ""))
        except ConnectionError:
            pass

    # -- control -----------------------------------------------------------

    def _on_kill(self, origin: int, payload) -> None:
        """Tear one job down (payload = jobid: its state is dropped —
        the DVM sends this when a tenant leaves the pool) or every job
        (payload None: lifeline teardown / VM shutdown)."""
        with self._lock:
            if payload is None:
                doomed = list(self._jobs.values())
            else:
                lj = self._jobs.pop(int(payload), None)
                doomed = [lj] if lj is not None else []
            victims = [p for lj in doomed for p in lj.popen.values()]
            writers = [w for lj in doomed
                       for w in lj.stdin_writers.values()]
        for w in writers:
            w.feed(None)
        for p in victims:
            if p.poll() is None:
                try:
                    os.killpg(p.pid, signal.SIGTERM)
                except (ProcessLookupError, PermissionError):
                    pass
        deadline = time.monotonic() + 2.0
        for p in victims:
            try:
                p.wait(timeout=max(0.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                try:
                    os.killpg(p.pid, signal.SIGKILL)
                except (ProcessLookupError, PermissionError):
                    pass
                # reap it before the daemon may go on (and exit): the
                # kill must have landed, the rank's card context freed
                try:
                    p.wait(timeout=2.0)
                except subprocess.TimeoutExpired:
                    _log.error("orted %d: pid %d outlived SIGKILL",
                               self.vpid, p.pid)

    def _on_respawn(self, origin: int, payload) -> None:
        """errmgr/respawn xcast: the TARGET daemon revives the rank
        (≈ the odls relaunch arm of the errmgr restart path).  The
        payload names an explicit target vpid: normally the original
        owner, but the DVM remediation actor may retarget a straggler
        to a less-loaded host — every daemon holds the job spec, so the
        adopter just adds the row; the old owner drops it."""
        jobid = int(payload["jobid"])
        rank = int(payload["rank"])
        lives = int(payload["lives"])
        target = int(payload.get("target") or 0)
        with self._lock:
            lj = self._jobs.get(jobid)
            if lj is None:
                return  # this daemon never saw the job's launch
            if target != self.vpid:
                # migrated away (or another daemon's rank all along):
                # make sure no stale row revives it here later
                lj.rows.pop(rank, None)
                lj.popen.pop(rank, None)
                return
            row = lj.rows.get(rank)
            if row is None:
                # adoption: keep the rank's original local_rank/chip —
                # on a sim pool local_rank only feeds ENV/bind hints,
                # and a real placement would remap chips at rejoin
                row = (int(payload.get("local_rank") or 0),
                       payload.get("chip"))
                lj.rows[rank] = row
        local_rank, chip = row
        _log.verbose(1, "orted %d: respawning rank %d (restart %d)",
                     self.vpid, rank, lives)
        # spawn off the RML reader thread (fork/exec + iof setup), on the
        # daemon's spawning thread
        self._spawnq.put((self._spawn_rank, (lj, rank, local_rank, chip),
                          {"restarts": lives}))

    def _on_stats(self, origin: int, payload) -> None:
        """≈ the sensor/resusage sampling orte-top pulls: per-rank
        rss + cpu time from /proc for my live ranks, replied up the
        tree (runs on the RML reader thread — /proc reads don't block)."""
        page = os.sysconf("SC_PAGE_SIZE")
        tick = os.sysconf("SC_CLK_TCK")
        rows = []
        with self._lock:
            procs = [(lj.jobid, rank, p)
                     for lj in self._jobs.values()
                     for rank, p in lj.popen.items()]
        for jobid, rank, p in procs:
            if p.poll() is not None:
                continue
            try:
                with open(f"/proc/{p.pid}/statm") as f:
                    rss = int(f.read().split()[1]) * page
                with open(f"/proc/{p.pid}/stat") as f:
                    parts = f.read().rsplit(")", 1)[1].split()
                    cpu_s = (int(parts[11]) + int(parts[12])) / tick
            except (OSError, IndexError, ValueError):
                continue
            if rss < _MIN_RSS:
                # a rank just exec'd (through the port's stub, a second
                # exec after the daemon's fork) holds only its stack
                # pages: it has no usage to report yet
                continue
            rows.append((jobid, rank, p.pid, rss, cpu_s))
        try:
            # payload is the requester's epoch — echoed so a late reply
            # from an earlier round cannot satisfy a newer collection
            self.node.send_up(rml.TAG_STATS_REPLY,
                              (self.vpid, payload, rows))
        except ConnectionError:
            pass

    def _live_ranks(self) -> list:
        """(jobid, spec, [(rank, popen) of the live ranks]) a job."""
        with self._lock:
            return [(lj.jobid, lj.spec,
                     [(r, p) for r, p in lj.popen.items()
                      if p.poll() is None])
                    for lj in self._jobs.values()]

    def _on_doctor(self, origin: int, payload) -> None:
        """Hang-doctor capture fan-out: query each LIVE local rank's
        responder (UDP, loopback — ranks share this host), fall back to
        a /proc probe for a rank that stays silent (a SIGSTOP'd pid
        cannot answer; its frozen state IS the evidence), reply the
        captures up the tree.  The UDP waits block up to ~1s per silent
        rank — handed off a thread, never run on the RML reader."""
        threading.Thread(target=self._doctor_capture, args=(payload,),
                         name=f"orted-doctor-{self.vpid}",
                         daemon=True).start()

    def _doctor_capture(self, epoch) -> None:
        from ompi_tpu_torch.core.config import var_registry
        from ompi_tpu_torch.runtime import doctor

        limit = int(var_registry.get("doctor_rows_per_daemon") or 0)
        rows = []
        for jobid, spec, procs in self._live_ranks():
            ports: dict[int, int] = {}
            uri = ((spec or {}).get("env") or {}).get(pmix.ENV_URI)
            if uri and procs:
                ports = pmix.query_doctor_ports(uri) or {}
            job_rows = []
            for rank, p in sorted(procs):
                cap = None
                port = ports.get(rank)
                if port:
                    cap = doctor.query_rank(port)
                if cap is None:
                    cap = {"rank": rank, "no_response": True,
                           "proc": doctor.proc_probe(p.pid)}
                cap["pid"] = p.pid
                cap["jobid"] = jobid
                job_rows.append(cap)
            # hierarchical pre-aggregation: bound this daemon's reply to
            # doctor_rows_per_daemon full rows + one explicit summary
            # row per job, so the HNP's fan-in is O(hosts), not O(ranks)
            kept, summary = doctor.summarize_rows(job_rows, limit)
            if summary is not None:
                summary["jobid"] = jobid
                summary["vpid"] = self.vpid
                kept.append(summary)
            rows.extend(kept)
        try:
            self.node.send_up(rml.TAG_DOCTOR_REPLY,
                              (self.vpid, epoch, rows))
        except ConnectionError:
            pass

    def _on_timeline(self, origin: int, payload) -> None:
        """Live-timeline fan-out (the TAG_DOCTOR shape): query each
        live local rank's responder for a bounded flight-recorder tail,
        reply up.  Handed off a thread — the UDP waits block."""
        threading.Thread(target=self._timeline_capture, args=(payload,),
                         name=f"orted-timeline-{self.vpid}",
                         daemon=True).start()

    def _timeline_capture(self, payload) -> None:
        from ompi_tpu_torch.runtime import doctor

        try:
            epoch, tail = payload
            tail = int(tail)
        except (TypeError, ValueError):
            epoch, tail = payload, 2048
        off_root = self._clock.offset_to_root_ns()
        rows = []
        for jobid, spec, procs in self._live_ranks():
            ports: dict[int, int] = {}
            uri = ((spec or {}).get("env") or {}).get(pmix.ENV_URI)
            if uri and procs:
                ports = pmix.query_doctor_ports(uri) or {}
            for rank, p in sorted(procs):
                port = ports.get(rank)
                cap = doctor.query_timeline(port, tail) if port else None
                if cap is None:
                    cap = {"rank": rank, "no_response": True}
                # stamp the daemon-measured offset: ranks share this
                # host's kernel clock, so one offset corrects every
                # local rank
                cap["clock_to_root_ns"] = off_root
                cap["jobid"] = jobid
                rows.append(cap)
        try:
            self.node.send_up(rml.TAG_TIMELINE_REPLY,
                              (self.vpid, epoch, rows))
        except ConnectionError:
            pass

    def _on_stdin(self, origin: int, payload) -> None:
        # Runs on the RML link reader thread: never write the pipe here —
        # a rank that doesn't drain stdin would fill the OS pipe, block
        # this thread, and stall TAG_KILL/TAG_SHUTDOWN on the same link.
        # Hand the chunk to the per-rank writer thread instead.
        rank, chunk = payload
        with self._lock:
            if not self._launched:
                self._pending_stdin.append(payload)
                return
            writers = self._stdin_targets(rank)
        for w in writers:
            w.feed(chunk)

    def _on_shutdown(self, origin: int, payload) -> None:
        self._done.set()
        self._spawnq.put(None)

    def run(self) -> int:
        # the main thread is the spawning thread: it lives as long as the
        # daemon, so the ranks' parent-death signal fires only when the
        # daemon dies
        while not self._done.is_set():
            order = self._spawnq.get()
            if order is None:
                continue
            fn, args, kwargs = order
            try:
                fn(*args, **kwargs)
            except Exception as e:  # noqa: BLE001 — the daemon survives
                _log.error("orted %d: spawn failed: %r", self.vpid, e)
        self._on_kill(0, None)   # stragglers die with the daemon
        self._clock.stop()
        if self._metrics is not None:
            self._metrics.close()
        self.node.close()
        return 0


def main(argv: Optional[list[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="ompi-tpu-orted")
    ap.add_argument("--hnp", required=True, help="HNP rml uri host:port")
    ap.add_argument("--vpid", type=int, required=True)
    ap.add_argument("--ndaemons", type=int, required=True)
    ap.add_argument("--fake-host", default=None)
    args = ap.parse_args(argv)
    return Orted(args.hnp, args.vpid, args.ndaemons,
                 fake_host=args.fake_host).run()


if __name__ == "__main__":
    sys.exit(main())
