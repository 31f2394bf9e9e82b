"""Persistent distributed VM + live-job control plane (the port's copy
of the JAX package's ``runtime/dvm.py``, whole).

≈ orte/tools/orte-dvm/orte-dvm.c:1 (a standing daemon VM that runs many
jobs without re-launching), orte/mca/state/dvm/state_dvm.c:1 (the job
lifecycle on a persistent VM: jobs come and go, daemons stay wired), and
orte/tools/orte-ps/orte-ps.c:1 (query a live VM's job/proc table).

The DVM HNP brings the daemon tree up ONCE, writes its control URI to a
file, then serves job submissions over a line-JSON TCP control channel
(the JAX package's protocol: a client of either package speaks to a
pool of either):

    python -m ompi_tpu_torch.tools.tpurun --dvm-start --plm sim --hosts 2 --slots 8
    python -m ompi_tpu_torch.tools.tpurun --dvm-submit -np 4 -- python app.py
    python -m ompi_tpu_torch.tools.tpurun --dvm-ps
    python -m ompi_tpu_torch.tools.tpurun --dvm-stop

The pool is MULTI-TENANT: submissions enter a bounded admission queue
and a gang scheduler places each job atomically over the standing nodes
— all of a job's ranks get slots before any launch, least-loaded hosts
first (live ``slots_inuse`` + per-host activity from the ``ompi_tpu_job_*``
aggregates, heartbeat-dead hosts excluded) — so several jobs run
concurrently, each with its own PMIx rendezvous, jobid-tagged IOF
routing, and uuid-named shm namespace.  ``--dvm-submit`` gets a
machine-readable admission verdict (``queued`` with the depth, or
``rejected`` when the queue is full / the job can never fit) instead of
hanging at capacity.

The port's device plane: a pool started with ``want_gpu`` (``tpurun
--dvm-start --gpu``) counts this machine's cards once (the ``simulator``
RAS deals them out over the simulated hosts) and gives every tenant's
first lives their own ``torch.distributed`` rendezvous
(``OMPI_TPU_COORD``, ``OMPI_TPU_NHOSTS``), so two tenants join two
process groups; a revived life keeps its card and gets none (the
orted's rule), and a rank that remediation moves to another host binds
that host's card.  The HNP counts the cards and no standing process
touches one, so a pool holds no CUDA context; a pool started without
``want_gpu`` imports no torch at all.

Doctor-driven auto-remediation closes the loop on the watchdog: when a
pushed stuck event produces a straggler / deadlock / mismatch verdict
for a tenant, the remediation actor ACTS — a straggler gets a SIGCONT
probe (a SIGSTOP'd rank resumes and the job finishes) and, if it stays
wedged, a reap-and-revive onto a less-loaded host; a deadlock/mismatch
tenant is killed and requeued for a fresh placement with the doctor
capture attached; a bounded per-job budget (``dvm_remediation_max``)
degrades to a rejected verdict instead of livelocking.  Every action is
an ``ftevents`` entry and ticks ``ompi_tpu_dvm_remediations_total``.
Co-tenants are untouched throughout (kills are jobid-scoped).

Observability plane (``--metrics-port N``): a long-lived HTTP endpoint
on the DVM serving

- ``/metrics`` — Prometheus text: every rank's pvar snapshot (pushed up
  the orted tree via TAG_METRICS) labeled ``{job=,rank=}``, real
  histogram families for the latency plane (``_bucket{le=}``/``_sum``/
  ``_count``), per-job ``ompi_tpu_job_*`` sums, and the DVM's own
  process pvars (the metric names are the JAX package's, so one scrape
  config reads either);
- ``/status`` — JSON: the daemon table (heartbeat ages), the proc table
  (``lives``, restarts budget, last-metrics age, p99 collective
  latency, ``last_coll`` pushed recorder head), the per-job FT event
  timeline (detect / reap / revive / shrink / escalate / stuck /
  doctor) and the per-job straggler panel;
- ``/doctor`` — JSON: an on-demand cross-rank hang capture + verdict
  (TAG_DOCTOR fan-out → per-rank recorder tails, pending p2p, stacks,
  /proc probes → mismatch / deadlock / straggler analysis).  The same
  capture fires automatically when the watchdog sees a rank push a
  stuck event (``coll_stuck_timeout``);
- ``/timeline`` — JSON: a live merged, skew-corrected Chrome trace of
  the running tenant (TAG_TIMELINE fan-out).

``--metrics-port 0`` binds an ephemeral port; the bound address is
written next to the URI file as ``<uri>.metrics``.
"""

from __future__ import annotations

import collections
import json
import os
import queue
import signal
import socket
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Optional

from ompi_tpu_torch.core import output
from ompi_tpu_torch.core.config import VarType, register_var, var_registry
from ompi_tpu_torch.runtime import ftevents, rmaps, rml
from ompi_tpu_torch.runtime.clean import default_uri_path
from ompi_tpu_torch.runtime.job import AppContext, Job, ProcState
from ompi_tpu_torch.runtime.plm import MultiHostLauncher

__all__ = ["DvmHnp", "DvmRejected", "gang_place", "plan_remediation",
           "submit", "shrink", "ps", "stop", "default_uri_path"]

_log = output.get_stream("dvm")

register_var("dvm", "queue_max", VarType.SIZE, 8,
             "admission control: at most this many jobs may WAIT in the "
             "DVM queue; further submissions get a machine-readable "
             "rejected verdict instead of queueing without bound")
register_var("dvm", "max_concurrent", VarType.SIZE, 4,
             "at most this many jobs run on the pool at once (each still "
             "needs a full gang of free slots to start)")
register_var("dvm", "remediate", VarType.BOOL, True,
             "act on watchdog doctor verdicts (straggler → SIGCONT "
             "probe, then reap-and-revive elsewhere; deadlock/mismatch "
             "→ kill + requeue; budget exhausted → reject).  Off = the "
             "doctor only diagnoses, as before")
register_var("dvm", "remediation_max", VarType.SIZE, 2,
             "per-job remediation budget: after this many remediation "
             "actions the next actionable verdict rejects the job "
             "instead of retrying forever")
register_var("dvm", "remediate_grace_s", VarType.DOUBLE, 2.0,
             "seconds the remediation actor waits after a SIGCONT probe "
             "before re-capturing a verdict to decide recovered vs "
             "reap-and-revive")
register_var("dvm", "requeue_max", VarType.SIZE, 2,
             "how many times a remediated job may be requeued for a "
             "fresh placement before its next requeue becomes a reject")


def gang_place(nodes: list, np_: int, dead: frozenset = frozenset(),
               hb_ages: Optional[dict] = None, hb_timeout: float = 0.0,
               busy: Optional[dict] = None) -> Optional[list]:
    """Gang placement over a standing pool: pick an ordered subset of
    ``nodes`` whose free slots cover ``np_`` ranks, least-loaded host
    first — or None when the gang cannot be formed (the caller keeps the
    job queued).  All-or-nothing by construction: no slot is consumed
    here, so a partial fit never strands resources.

    - ``dead``: daemon vpids (node index + 1) already declared lost;
    - ``hb_ages``/``hb_timeout``: heartbeat ages — a host silent past
      the timeout is as good as dead for NEW placements even before the
      monitor formally declares it;
    - ``busy``: host name → activity weight from the live per-job
      metrics aggregates, so two equally-subscribed hosts tie-break
      toward the one whose tenants are idle.
    """
    hb_ages = hb_ages or {}
    busy = busy or {}
    candidates = []
    for i, n in enumerate(nodes):
        vpid = i + 1
        if vpid in dead:
            continue
        age = float(hb_ages.get(vpid, 0.0))
        if hb_timeout > 0 and age >= hb_timeout:
            continue
        if n.slots_available <= 0:
            continue
        candidates.append((n.slots_inuse + float(busy.get(n.name, 0.0)),
                           age, i, n))
    candidates.sort(key=lambda c: (c[0], c[1], c[2]))
    placed, have = [], 0
    for _load, _age, _i, n in candidates:
        placed.append(n)
        have += n.slots_available
        if have >= np_:
            return placed
    return None


def plan_remediation(kind: Optional[str], rank: int, used: int,
                     budget: int) -> str:
    """The remediation ladder, as a pure decision: doctor verdict kind +
    the job's burned budget → one of ``none`` (not actionable),
    ``sigcont_probe`` (straggler with a known rank: cheapest rung first
    — a SIGSTOP'd rank just resumes), ``requeue`` (deadlock/mismatch, or
    a straggler the doctor could not localize: this placement is
    poisoned, try a fresh one), ``reject`` (budget exhausted: degrade
    honestly instead of livelocking)."""
    if kind not in ("straggler", "deadlock", "mismatch"):
        return "none"
    if used >= budget:
        return "reject"
    if kind == "straggler" and rank >= 0:
        return "sigcont_probe"
    return "requeue"


class _Submission:
    """One queued/running job on the pool: the Job plus everything the
    scheduler, the IOF router, and the remediation actor need to know
    about it (state machine: queued → running ⇄ remediating →
    completed/rejected; a requeue goes back to queued)."""

    def __init__(self, job: Job, argv: list, np_: int, wfile) -> None:
        self.job = job
        self.argv = list(argv)
        self.np = np_
        self.wfile = wfile
        self.submitted_at = time.time()
        self.started_at: Optional[float] = None
        self.state = "queued"
        #: (node, nranks) pairs consumed from the pool — released (and
        #: possibly rebuilt by a migration) under the scheduler lock
        self.placed: list = []
        self.remediations = 0
        self.requeues = 0
        self.requeue = False           # set by the remediation actor
        self.doctor: Optional[dict] = None   # capture attached on requeue
        self.rejected_reason: Optional[str] = None
        self.done = threading.Event()


def _read_uri(path: str) -> str:
    with open(path, encoding="utf-8") as f:
        return f.read().strip()


class DvmHnp(MultiHostLauncher):
    """The standing-VM HNP: daemon tree up once, jobs on demand."""

    def __init__(self, plm_name: str = "sim", want_gpu: bool = False,
                 uri_path: Optional[str] = None,
                 metrics_port: Optional[int] = None, **select_ctx) -> None:
        super().__init__(plm_name=plm_name, want_gpu=want_gpu,
                         stdin_target="none", **select_ctx)
        self._persistent = True
        self.metrics_port = metrics_port
        self._http: Optional[ThreadingHTTPServer] = None
        self.metrics_uri: Optional[str] = None
        self._started_at = time.time()
        self.uri_path = uri_path or default_uri_path()
        self._stopped = threading.Event()
        # set once shutdown() has torn the tree down and removed the uri
        # files; serve_forever waits for it (the port's rule: the JAX
        # package's returns at the stop request, and its process can
        # exit before the files are gone)
        self._down = threading.Event()
        self._ctrl: Optional[socket.socket] = None
        self._ctrl_addr: Optional[str] = None
        # the multi-tenant scheduler plane: admission queue + live
        # submissions, all under one condition variable (NEVER nested
        # with the plm _cv — the lock-order lint enforces it)
        self._sched_cv = threading.Condition()
        self._pending: collections.deque = collections.deque()
        self._active: dict[int, _Submission] = {}   # jobid → running sub
        self._jobs_completed = 0     # counter (history is bounded)
        # jobid → the submitting client's stream: the IOF router fans a
        # tenant's output to ITS client only
        self._sinks: dict[int, Any] = {}
        # serializes writes to the client connections: IOF callbacks run
        # on per-daemon RML reader threads and would otherwise interleave
        # partial lines with each other and with the final exit reply
        self._sink_lock = threading.Lock()
        # doctor-verdict remediation: the watchdog (an RML-adjacent
        # thread) only ENQUEUES; the dedicated actor thread does the
        # blocking work (grace sleeps, re-captures) — the reader-thread
        # lint shape
        self._remed_q: queue.Queue = queue.Queue()
        self._remediations_total = 0
        self._stats: dict[int, list] = {}     # vpid → latest stat rows
        self._stats_cv = threading.Condition()
        self._stats_epoch = 0                 # fences late replies
        self._stats_lock = threading.Lock()   # one collection at a time
        # hang-doctor capture plumbing (mirrors the stats collection:
        # epoch-fenced TAG_DOCTOR_REPLY fan-in, one capture at a time)
        self._doctor: dict[int, list] = {}    # vpid → capture rows
        self._doctor_cv = threading.Condition()
        self._doctor_epoch = 0
        self._doctor_lock = threading.Lock()
        self._last_doctor: Optional[dict] = None
        # live-timeline capture plumbing (same epoch-fenced fan-in as
        # the doctor, answering TAG_TIMELINE_REPLY)
        self._timeline: dict[int, list] = {}  # vpid → capture rows
        self._timeline_cv = threading.Condition()
        self._timeline_epoch = 0
        self._timeline_lock = threading.Lock()
        self._last_timeline: Optional[dict] = None
        self._tl_captures = 0                 # self-metering: /timeline
        self._tl_merge_ns = 0                 # rounds + HNP merge cost
        #: (jobid, rank) → highest coll_stuck_events_total seen — the
        #: watchdog's new-stuck-event edge detector
        self._stuck_seen: dict[tuple, float] = {}
        self.vm_job: Optional[Job] = None
        self._history: list[dict] = []        # completed-job records

    # -- VM lifecycle ------------------------------------------------------

    def start(self, np_slots: int) -> None:
        """Allocate nodes, spawn + wire the daemon tree, open the control
        channel, write the URI file."""
        from ompi_tpu_torch.runtime import ras

        vm = Job([AppContext(argv=["-"], np=np_slots)])
        ras.allocate(vm, want_gpu=self.want_gpu, **self.select_ctx)
        rmaps.map_job(vm, **self.select_ctx)
        self.vm_job = vm
        if not self._vm_up(vm):
            raise RuntimeError(
                f"DVM bring-up failed: {vm.abort_reason}")
        # the VM "job" map above was only sizing the daemon tree — its
        # rank count must not read as tenant load on the standing pool
        for n in vm.nodes:
            n.slots_inuse = 0
        self.rml.register_recv(rml.TAG_STATS_REPLY, self._on_stats_reply)
        self.rml.register_recv(rml.TAG_DOCTOR_REPLY,
                               self._on_doctor_reply)
        self.rml.register_recv(rml.TAG_TIMELINE_REPLY,
                               self._on_timeline_reply)
        self._ctrl = socket.create_server(("127.0.0.1", 0))
        port = self._ctrl.getsockname()[1]
        self._ctrl_addr = f"127.0.0.1:{port}"
        # metrics endpoint BEFORE the uri file: clients poll for the uri
        # file to detect "DVM up", so everything it implies (including
        # the recorded <uri>.metrics address) must exist by then
        if self.metrics_port is not None:
            self._start_metrics_server(self.metrics_port)
        with open(self.uri_path, "w", encoding="utf-8") as f:
            f.write(f"127.0.0.1:{port}\n")
        threading.Thread(target=self._accept_loop, daemon=True).start()
        threading.Thread(target=self._scheduler_loop,
                         name="dvm-scheduler", daemon=True).start()
        threading.Thread(target=self._remediation_loop,
                         name="dvm-remediator", daemon=True).start()
        _log.verbose(1, "DVM up: %d daemons, ctrl 127.0.0.1:%d (uri %s)",
                     len(vm.nodes), port, self.uri_path)

    def serve_forever(self) -> int:
        self._stopped.wait()
        self._down.wait(timeout=60.0)
        return 0

    def shutdown(self) -> None:
        if self._stopped.is_set():
            return
        self._stopped.set()
        # queued tenants will never start — tell their clients so
        # instead of leaving them blocked on a dead socket
        with self._sched_cv:
            pending = list(self._pending)
            self._pending.clear()
            self._sched_cv.notify_all()
        for sub in pending:
            try:
                self._reply(sub.wfile, {"verdict": "rejected",
                                        "reason": "DVM shutting down"})
            except (OSError, ValueError):
                pass
            sub.done.set()
        try:
            self._teardown_vm()
        finally:
            if self._http is not None:
                http, self._http = self._http, None

                def _close() -> None:
                    http.shutdown()       # stop serve_forever ...
                    http.server_close()   # ... THEN release the socket

                threading.Thread(target=_close, daemon=True).start()
            if self._ctrl is not None:
                self._ctrl.close()
            for path in (self.uri_path, self.uri_path + ".metrics"):
                try:
                    os.unlink(path)
                except OSError:
                    pass
            self._down.set()

    # -- control channel ---------------------------------------------------

    def _accept_loop(self) -> None:
        while not self._stopped.is_set():
            try:
                conn, _addr = self._ctrl.accept()
            except OSError:
                return
            threading.Thread(target=self._serve_conn, args=(conn,),
                             daemon=True).start()

    def _serve_conn(self, conn: socket.socket) -> None:
        try:
            rfile = conn.makefile("r", encoding="utf-8")
            wfile = conn.makefile("w", encoding="utf-8")
            line = rfile.readline()
            if not line:
                return
            req = json.loads(line)
            cmd = req.get("cmd")
            if cmd == "run":
                self._cmd_run(req, wfile)
            elif cmd == "ps":
                self._reply(wfile, {"ps": self._ps_table()})
            elif cmd == "shrink":
                self._cmd_shrink(req, wfile)
            elif cmd == "stop":
                self._reply(wfile, {"ok": True})
                wfile.flush()
                self.shutdown()
            else:
                self._reply(wfile, {"error": f"unknown cmd {cmd!r}"})
        except (OSError, ValueError, json.JSONDecodeError) as e:
            _log.verbose(1, "control connection error: %r", e)
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def _reply(self, wfile, obj: dict) -> None:
        with self._sink_lock:
            wfile.write(json.dumps(obj) + "\n")
            wfile.flush()

    # -- admission + gang scheduling on the warm VM ------------------------

    def _cmd_run(self, req: dict, wfile) -> None:
        """Admit (or reject) one submission; the client gets a verdict
        line IMMEDIATELY — queued submissions then stream IOF and the
        final exit when the scheduler gets to them."""
        argv = req.get("argv") or []
        np_ = int(req.get("np") or 1)
        if not argv:
            self._reply(wfile, {"error": "no argv"})
            return
        env = dict(req.get("env") or {})
        # elastic jobs: a tenant's MPI_Comm_spawn rides the SAME pool
        # (dpm switches to --dvm-submit when it sees this)
        if self._ctrl_addr:
            env.setdefault("OMPI_TPU_DVM_URI", self._ctrl_addr)
        job = Job([AppContext(argv=list(argv), np=np_, env=env,
                              cwd=req.get("cwd"))])
        sub = _Submission(job, argv, np_, wfile)
        pool = sum(n.slots for n in self.vm_job.nodes) if self.vm_job \
            else 0
        qmax = int(var_registry.get("dvm_queue_max") or 0)
        with self._sched_cv:
            if np_ < 1 or np_ > pool:
                verdict = {"verdict": "rejected",
                           "reason": f"np {np_} can never fit the pool "
                                     f"({pool} slots)"}
            elif len(self._pending) >= qmax:
                verdict = {"verdict": "rejected",
                           "reason": f"admission queue full "
                                     f"({qmax} waiting)"}
            else:
                self._pending.append(sub)
                verdict = {"verdict": "queued", "jobid": job.jobid,
                           "queue_depth": len(self._pending)}
                self._sched_cv.notify_all()
        self._reply(wfile, verdict)
        if verdict["verdict"] == "rejected":
            return
        sub.done.wait()                   # worker sends IOF + final exit

    def _scheduler_loop(self) -> None:
        """Place queued gangs whenever slots free up or tenants arrive."""
        while not self._stopped.is_set():
            with self._sched_cv:
                self._sched_cv.wait(timeout=0.25)
                try:
                    self._schedule_locked()
                except Exception as e:  # noqa: BLE001 — keep scheduling
                    _log.error("scheduler pass failed: %r", e)

    def _busy_by_host(self) -> dict[str, float]:
        """Host → activity weight for placement tie-breaks: each running
        rank counts 1, +0.25 when its metrics uplink pushed within 10s
        (an actively-computing tenant beats an idle one)."""
        busy: dict[str, float] = {}
        now = time.time()
        for sub in self._active.values():
            ages = self.metrics_agg.ages(sub.job.jobid, now=now)
            for p in sub.job.procs:
                if p.node is None or p.state != ProcState.RUNNING:
                    continue
                w = 1.0 + (0.25 if ages.get(p.rank, 99.0) < 10.0 else 0.0)
                busy[p.node.name] = busy.get(p.node.name, 0.0) + w
        return busy

    def _gang_place(self, np_: int) -> Optional[list]:
        hb_on = float(var_registry.get("rml_heartbeat_period") or 0) > 0
        hb_ages = (self._hb_monitor.ages()
                   if hb_on and self._hb_monitor is not None else {})
        hb_timeout = (float(var_registry.get("rml_heartbeat_timeout")
                            or 0) if hb_on else 0.0)
        return gang_place(self.vm_job.nodes if self.vm_job else [], np_,
                          dead=frozenset(self._dead_daemons),
                          hb_ages=hb_ages, hb_timeout=hb_timeout,
                          busy=self._busy_by_host())

    def _schedule_locked(self) -> None:
        """With ``_sched_cv`` held: FIFO admission with backfill — a big
        gang waiting for slots does not block a small one behind it that
        fits NOW.  Mapping runs inside the lock so two placements cannot
        race for the same slots."""
        maxc = int(var_registry.get("dvm_max_concurrent") or 1)
        for sub in list(self._pending):
            if len(self._active) >= maxc:
                return
            nodes = self._gang_place(sub.np)
            if nodes is None:
                continue                       # keep queued; try the next
            self._pending.remove(sub)
            job = sub.job
            job.nodes = nodes
            try:
                rmaps.map_job(job, **self.select_ctx)
            except Exception as e:  # noqa: BLE001 — keep the VM alive
                sub.state = "rejected"
                sub.rejected_reason = f"map failed: {e}"
                try:
                    self._reply(sub.wfile, {"error": f"map failed: {e}"})
                except (OSError, ValueError):
                    pass
                sub.done.set()
                continue
            sub.placed = [(n, len(job.procs_on(n))) for n in nodes
                          if job.procs_on(n)]
            sub.state = "running"
            sub.started_at = time.time()
            self._active[job.jobid] = sub
            threading.Thread(target=self._job_worker, args=(sub,),
                             name=f"dvm-job-{job.jobid}",
                             daemon=True).start()

    def _job_worker(self, sub: _Submission) -> None:
        """One placement attempt of one tenant: launch, wait, retire —
        then either account the job (history + exit reply) or, when the
        remediation actor flagged a requeue, put it back on the queue
        for a fresh placement."""
        job = sub.job
        t0 = time.perf_counter()
        with self._sink_lock:
            self._sinks[job.jobid] = sub.wfile
        try:
            self._launch_apps(job)
            self._wait_ranks(job)
        finally:
            with self._sink_lock:
                self._sinks.pop(job.jobid, None)
            server, job.pmix_server = job.pmix_server, None
            if server is not None:
                try:
                    server.close()
                except Exception:  # noqa: BLE001
                    pass
                if self.server is server:
                    self.server = None
            with self._cv:
                self._jobs_by_id.pop(job.jobid, None)
            # the daemons drop this job's rows/pipes (and reap any
            # lingering pid) — co-tenants' state is untouched
            if not self._stopped.is_set():
                try:
                    self.rml.xcast(rml.TAG_KILL, job.jobid)
                except Exception:  # noqa: BLE001 — tree tearing down
                    pass
        rcs = [job.exited.get(p.rank, 1) for p in job.procs]
        # the first rank to fail sets the code, as on the launcher's and
        # the plm's paths: the ranks the errmgr then killed exit -15,
        # and in rank order one of them could come first
        first = job.aborted_proc.exit_code if job.aborted_proc else None
        rc = (job.abort_status if job.abort_status
              else first if first
              else next((r for r in rcs if r), 0))
        if rc < 0:
            rc = 128 - rc   # signal exit, same mapping as the non-DVM path
        with self._sched_cv:
            for node, k in sub.placed:
                node.slots_inuse = max(0, node.slots_inuse - k)
            sub.placed = []
            self._active.pop(job.jobid, None)
            requeue = (sub.requeue and not self._stopped.is_set()
                       and sub.requeues
                       < int(var_registry.get("dvm_requeue_max") or 0))
            if requeue:
                sub.requeue = False
                sub.requeues += 1
                self._reset_for_requeue(sub)
                self._pending.appendleft(sub)   # remediated jobs first
            self._sched_cv.notify_all()
        if requeue:
            ftevents.record("requeue", jobid=job.jobid,
                            attempt=sub.requeues,
                            verdict=(sub.doctor or {}).get(
                                "verdict", {}).get("kind"))
            return                 # the scheduler spawns the next worker
        sub.state = "rejected" if sub.rejected_reason else "completed"
        rec = {"jobid": job.jobid, "argv": sub.argv, "np": sub.np,
               "rc": rc, "finished": time.time()}
        if sub.remediations:
            rec["remediations"] = sub.remediations
        if sub.requeues:
            rec["requeues"] = sub.requeues
        if sub.rejected_reason:
            rec["verdict"] = "rejected"
            rec["reason"] = sub.rejected_reason
        with self._sched_cv:
            self._jobs_completed += 1
            self._history.append(rec)
            # the history ring is bounded: when a record rotates out, its
            # per-rank metrics tables go with it (not only at the
            # aggregate's MAX_JOBS age eviction)
            while len(self._history) > 50:
                old = self._history.pop(0)
                self.metrics_agg.prune_job(old["jobid"])
        reply = {"exit": rc, "wall_s": round(time.perf_counter() - t0, 3)}
        if sub.rejected_reason:
            reply["verdict"] = "rejected"
            reply["reason"] = sub.rejected_reason
        try:
            self._reply(sub.wfile, reply)
        except (OSError, ValueError):
            pass                               # client went away
        sub.done.set()

    def _reset_for_requeue(self, sub: _Submission) -> None:
        """With ``_sched_cv`` held: scrub one attempt's state so the next
        placement starts clean — fresh procs/map, fresh exit table, and
        CRUCIALLY a pruned metrics aggregate + cleared stuck-event
        high-water marks (stale marks would blind the watchdog's edge
        detector to the second attempt's stuck events)."""
        job = sub.job
        job.procs = []
        job.nodes = []
        job.exited = {}
        job.killed = False
        job.aborted_proc = None
        job.abort_reason = None
        job.abort_status = None
        sub.state = "queued"
        sub.submitted_at = time.time()
        self.metrics_agg.prune_job(job.jobid)
        for key in [k for k in self._stuck_seen if k[0] == job.jobid]:
            del self._stuck_seen[key]

    def _cmd_shrink(self, req: dict, wfile) -> None:
        """Planned elastic shrink: retire one rank of a running tenant
        on purpose — ``no_revive`` keeps a reviving errmgr policy from
        resurrecting it, the reap produces the exit report, and the
        survivors continue smaller (the ULFM recipe)."""
        jobid = int(req.get("jobid") or 0)
        rank = int(req.get("rank", -1))
        with self._cv:
            job = self._jobs_by_id.get(jobid)
        if job is None:
            self._reply(wfile, {"error": f"no running job {jobid}"})
            return
        if not 0 <= rank < len(job.procs):
            self._reply(wfile, {"error": f"job {jobid} has no rank "
                                         f"{rank}"})
            return
        job.procs[rank].no_revive = True
        ftevents.record("shrink", jobid=jobid, rank=rank, planned=True)
        self._reap_reported(job, rank, "planned-shrink")
        self._reply(wfile, {"ok": True, "jobid": jobid, "rank": rank})

    def _on_iof(self, origin: int, payload) -> None:
        """Route a tenant's output to ITS submitting client (keyed by
        the jobid riding the IOF frame); fall back to the DVM's own
        stdout when no client is attached."""
        jobid, rank, stream, raw = payload
        with self._sink_lock:
            sink = self._sinks.get(int(jobid))
        if sink is None:
            return super()._on_iof(origin, payload)
        try:
            self._reply(sink, {
                "iof": [rank, stream,
                        bytes(raw).decode(errors="replace")]})
        except (OSError, ValueError):
            with self._sink_lock:              # client went away; drop
                self._sinks.pop(int(jobid), None)

    # -- introspection (≈ orte-ps / orte-top) ------------------------------

    def _on_stats_reply(self, origin: int, payload) -> None:
        vpid, epoch, rows = payload
        with self._stats_cv:
            if epoch != self._stats_epoch:
                return                # late reply from an earlier round
            self._stats[vpid] = [tuple(r) for r in rows]
            self._stats_cv.notify_all()

    def _collect_stats(self, timeout: float = 1.0) -> dict[int, dict]:
        """Pull live per-rank resource usage from every daemon
        (≈ orte-top's resusage sample): xcast the request, wait briefly
        for the tree to reply; late/dead daemons just contribute
        nothing.  Rows come back jobid-tagged (a multi-tenant daemon
        hosts several jobs' ranks) — the merge keys by jobid, then
        rank.  Serialized + epoch-fenced: concurrent ps clients must
        not clear each other's reply set, and a straggler reply from a
        timed-out round must not pass as fresh."""
        with self._stats_lock:
            n = len(self.vm_job.nodes) if self.vm_job else 0
            with self._stats_cv:
                self._stats.clear()
                self._stats_epoch += 1
                epoch = self._stats_epoch
            try:
                self.rml.xcast(rml.TAG_STATS, epoch)
            except Exception:  # noqa: BLE001 — tree tearing down
                return {}
            deadline = time.monotonic() + timeout
            with self._stats_cv:
                self._stats_cv.wait_for(
                    lambda: len(self._stats) >= n,
                    timeout=max(0.0, deadline - time.monotonic()))
                merged: dict[int, dict] = {}
                for rows in self._stats.values():
                    for jobid, rank, pid, rss, cpu_s in rows:
                        merged.setdefault(int(jobid), {})[int(rank)] = (
                            int(pid), int(rss), float(cpu_s))
            return merged

    # -- the cross-rank hang doctor ----------------------------------------

    #: the pushed recorder-head gauges (see trace.py's coll_cur_* pvars)
    _CUR_NAMES = ("coll_cur_seq", "coll_cur_kind_id", "coll_cur_cid",
                  "coll_cur_done", "coll_cur_posted_ts")

    def _on_doctor_reply(self, origin: int, payload) -> None:
        vpid, epoch, rows = payload
        with self._doctor_cv:
            if epoch != self._doctor_epoch:
                return                # late reply from an earlier round
            self._doctor[vpid] = [dict(r) for r in rows]
            self._doctor_cv.notify_all()

    def _collect_doctor(self, timeout: float = 4.0) -> list[dict]:
        """One cross-rank state snapshot: xcast TAG_DOCTOR, gather every
        daemon's per-rank captures (a silent daemon contributes nothing
        — its ranks then read as no_response at the analyzer).
        Serialized + epoch-fenced like the stats collection."""
        with self._doctor_lock:
            n = len(self.vm_job.nodes) if self.vm_job else 0
            with self._doctor_cv:
                self._doctor.clear()
                self._doctor_epoch += 1
                epoch = self._doctor_epoch
            try:
                self.rml.xcast(rml.TAG_DOCTOR, epoch)
            except Exception:  # noqa: BLE001 — tree tearing down
                return []
            deadline = time.monotonic() + timeout
            with self._doctor_cv:
                self._doctor_cv.wait_for(
                    lambda: len(self._doctor) >= n,
                    timeout=max(0.0, deadline - time.monotonic()))
                captures: list[dict] = []
                for rows in self._doctor.values():
                    captures.extend(rows)
            return captures

    def _running_job(self) -> Optional[Job]:
        """The first tenant with live ranks (for job-less /doctor and
        /timeline scrapes on a multi-tenant pool)."""
        with self._sched_cv:
            for sub in self._active.values():
                if any(p.state == ProcState.RUNNING
                       for p in sub.job.procs):
                    return sub.job
        return None

    def _doctor_doc(self, trigger: str, job: Optional[Job] = None) -> dict:
        """The /doctor document: live capture + analyzer verdict while a
        job runs; the cached last verdict (or idle) otherwise.  On a
        multi-tenant pool the capture is scoped to ONE job (the caller's,
        or the first running tenant): daemons stamp every capture row
        with its jobid, and a co-tenant's rows must never leak into
        another tenant's verdict."""
        from ompi_tpu_torch.runtime import doctor

        if job is None:
            job = self._running_job()
        running = (job is not None
                   and any(p.state == ProcState.RUNNING
                           for p in job.procs))
        if not running:
            if self._last_doctor is not None:
                return dict(self._last_doctor, stale=True)
            return {"trigger": trigger, "ts": time.time(),
                    "verdict": {"kind": "idle",
                                "detail": "no job running and no "
                                          "cached verdict"}}
        rows = [c for c in self._collect_doctor()
                if int(c.get("jobid", job.jobid)) == job.jobid]
        # hierarchical capture: daemons over their doctor_rows_per_daemon
        # budget pre-aggregate the healthy middle into explicit summary
        # rows — split those out (the analyzer wants per-rank rows; the
        # document still reports what was compressed and says truncated)
        captures = [c for c in rows if not c.get("summary")]
        summaries = [c for c in rows if c.get("summary")]
        # a frozen rank's last uplink-pushed recorder head stands in for
        # the capture it can no longer give
        pushed = self.metrics_agg.rank_values(job.jobid, self._CUR_NAMES)
        for c in captures:
            if c.get("no_response") and int(c.get("rank", -1)) in pushed:
                c["pushed"] = pushed[int(c["rank"])]
        doc = doctor.analyze(captures, nranks=job.np)
        if summaries:
            doc["truncated"] = True
            doc["ranks_summarized"] = sum(
                int(s.get("ranks_omitted", 0)) for s in summaries)
            doc["host_summaries"] = summaries
        doc["trigger"] = trigger
        doc["jobid"] = job.jobid
        doc["ts"] = time.time()
        v = doc.get("verdict") or {}
        # only verdicts worth remembering reach the FT timeline: a
        # dashboard polling /doctor every few seconds against a healthy
        # job must not flush real failure history out of the bounded
        # event ring (watchdog-triggered captures always record)
        if trigger == "watchdog" or v.get("kind") not in (
                "healthy", "idle", "no_data"):
            ftevents.record(
                "doctor", jobid=job.jobid, rank=int(v.get("rank", -1)),
                verdict=v.get("kind"), trigger=trigger,
                detail=(v.get("detail") or "")[:300])
        self._last_doctor = doc
        return doc

    def _doctor_watch(self) -> None:
        """The watchdog: a rank whose coll_stuck_events_total rose since
        the last tick pushed a stuck event up the uplink — record it on
        the FT timeline, auto-capture a per-tenant verdict, and (when
        ``dvm_remediate`` is on) hand actionable verdicts to the
        remediation actor.  Every running tenant is watched each tick;
        captures are jobid-scoped so co-tenants never cross-trigger."""
        while not self._stopped.wait(1.0):
            with self._sched_cv:
                subs = [s for s in self._active.values()
                        if s.state in ("running", "remediating")]
            live = {s.job.jobid for s in subs}
            # a standing DVM serves many jobs: drop retired jobs'
            # edge-detector keys so the dict stays bounded
            for key in [k for k in self._stuck_seen if k[0] not in live]:
                del self._stuck_seen[key]
            for sub in subs:
                try:
                    self._watch_one(sub)
                except Exception as e:  # noqa: BLE001 — watchdog survives
                    _log.verbose(1, "doctor watchdog tick failed: %r", e)

    def _watch_one(self, sub: _Submission) -> None:
        jobid = sub.job.jobid
        rows = self.metrics_agg.rank_values(
            jobid, ("coll_stuck_events_total",))
        newly = []
        for rank, vals in sorted(rows.items()):
            v = float(vals.get("coll_stuck_events_total", 0))
            key = (jobid, rank)
            if v > self._stuck_seen.get(key, 0.0):
                self._stuck_seen[key] = v
                newly.append((rank, int(v)))
        if not newly:
            return
        for rank, n in newly:
            ftevents.record("stuck", jobid=jobid, rank=rank, events=n)
        doc = self._doctor_doc("watchdog", job=sub.job)
        v = doc.get("verdict") or {}
        if (bool(var_registry.get("dvm_remediate"))
                and v.get("kind") in ("straggler", "deadlock", "mismatch")
                and sub.state == "running"):
            # the actor does the blocking work (grace sleeps, kills,
            # re-captures) on its own thread; this path stays cheap
            self._remed_q.put((sub, doc))

    # -- doctor-driven auto-remediation ------------------------------------

    def _remediation_loop(self) -> None:
        while not self._stopped.is_set():
            try:
                sub, doc = self._remed_q.get(timeout=0.5)
            except queue.Empty:
                continue
            try:
                self._remediate(sub, doc)
            except Exception as e:  # noqa: BLE001 — actor survives
                _log.error("remediation of job %d failed: %r",
                           sub.job.jobid, e)
                with self._sched_cv:
                    if sub.state == "remediating":
                        sub.state = "running"

    def _remediate(self, sub: _Submission, doc: dict) -> None:
        """Act on one watchdog verdict, one rung at a time (see
        ``plan_remediation``).  The budget check and the state flip are
        atomic under the scheduler lock, so a burst of verdicts from
        consecutive ticks collapses into one action."""
        job = sub.job
        v = doc.get("verdict") or {}
        kind = v.get("kind")
        rank = int(v.get("rank", -1))
        budget = int(var_registry.get("dvm_remediation_max") or 0)
        with self._sched_cv:
            if sub.state != "running" or job.killed:
                return                 # already being handled / retired
            action = plan_remediation(kind, rank, sub.remediations,
                                      budget)
            if action == "none":
                return
            sub.state = "remediating"
            if action != "reject":
                sub.remediations += 1
            self._remediations_total += 1
        t0 = time.monotonic_ns()
        try:
            if action == "sigcont_probe":
                self._probe_straggler(sub, rank, kind, t0)
            elif action == "requeue":
                sub.doctor = doc
                sub.requeue = True
                ftevents.record("remediate", jobid=job.jobid, rank=rank,
                                action="requeue", verdict=kind,
                                attempt=sub.remediations)
                _log.verbose(0, "remediation: job %d verdict %s — kill "
                             "+ requeue (attempt %d/%d)", job.jobid,
                             kind, sub.remediations, budget)
                self.kill_job(job)
            elif action == "reject":
                sub.rejected_reason = (
                    f"remediation budget exhausted "
                    f"({sub.remediations}/{budget} used; last verdict "
                    f"{kind})")
                ftevents.record("remediate", jobid=job.jobid, rank=rank,
                                action="reject", verdict=kind)
                _log.verbose(0, "remediation: job %d verdict %s — budget "
                             "exhausted, rejecting", job.jobid, kind)
                self.kill_job(job)
        finally:
            with self._sched_cv:
                if sub.state == "remediating":
                    sub.state = "running"

    def _probe_straggler(self, sub: _Submission, rank: int, kind: str,
                         t0: int) -> None:
        """Straggler rung 1: SIGCONT the rank's process group via its
        owning daemon (a faultinjected stall@coll self-SIGSTOPs — the
        probe genuinely resumes it), wait the grace window, re-capture.
        Recovered → done; still wedged → reap-and-revive on a
        less-loaded host (rung 2)."""
        job = sub.job
        ftevents.record("remediate", jobid=job.jobid, rank=rank,
                        action="sigcont", verdict=kind,
                        attempt=sub.remediations)
        try:
            self.rml.xcast(rml.TAG_SIGNAL_RANK,
                           (job.jobid, rank, int(signal.SIGCONT)))
        except Exception as e:  # noqa: BLE001 — tree tearing down
            _log.error("SIGCONT probe xcast for job %d rank %d "
                       "failed: %r", job.jobid, rank, e)
            return
        self._stopped.wait(
            float(var_registry.get("dvm_remediate_grace_s") or 2.0))
        doc = self._doctor_doc("remediation", job=job)
        after = doc.get("verdict") or {}
        with self._cv:
            finished = len(job.exited) >= job.np
        # a job that finished during the grace window plainly recovered;
        # a stale doc (no live capture possible) can't testify that the
        # rank is still wedged — never reap ranks of a completed job
        still = (not finished and not doc.get("stale")
                 and after.get("kind") in ("straggler", "deadlock",
                                           "mismatch"))
        if not still:
            ftevents.record(
                "remediate", jobid=job.jobid, rank=rank,
                action="recovered", verdict=after.get("kind"),
                latency_ms=round((time.monotonic_ns() - t0) / 1e6, 1))
            _log.verbose(0, "remediation: job %d rank %d recovered after "
                         "SIGCONT probe", job.jobid, rank)
            return
        self._revive_elsewhere(sub, rank,
                               f"rank stayed {after.get('kind')} after "
                               f"the SIGCONT probe")

    def _revive_elsewhere(self, sub: _Submission, rank: int,
                          why: str) -> None:
        """Straggler rung 2: migrate the wedged rank — retarget its proc
        to the least-loaded OTHER live host (slot accounting moves with
        it), then reap it through the tree.  The exit report runs the
        errmgr; under a reviving policy (selfheal/respawn) the
        TAG_RESPAWN order carries the NEW placement, so the rank's next
        life boots on the new host.  Under a non-reviving policy this
        degrades to that policy's normal failure handling."""
        job = sub.job
        if not 0 <= rank < len(job.procs):
            return
        proc = job.procs[rank]
        with self._sched_cv:
            pool = self.vm_job.nodes if self.vm_job else []
            cands = [n for i, n in enumerate(pool)
                     if (i + 1) not in self._dead_daemons
                     and n is not proc.node and n.slots_available > 0]
            cands.sort(key=lambda n: n.slots_inuse)
            target = cands[0] if cands else None
            if target is not None:
                old = proc.node
                proc.node = target
                if target.chips:
                    # the new life binds the new host's card (the sim
                    # RAS dealt each host its share of the machine's)
                    proc.chip = target.chips[proc.local_rank
                                             % len(target.chips)]
                target.slots_inuse += 1
                if old is not None:
                    old.slots_inuse = max(0, old.slots_inuse - 1)
                placed, seen = [], False
                for n, k in sub.placed:
                    if n is old:
                        k -= 1
                    if n is target:
                        k += 1
                        seen = True
                    if k > 0:
                        placed.append((n, k))
                if not seen:
                    placed.append((target, 1))
                sub.placed = placed
        ftevents.record("remediate", jobid=job.jobid, rank=rank,
                        action="revive",
                        target=(proc.node.name if proc.node else "?"),
                        why=why)
        _log.verbose(0, "remediation: job %d rank %d — reap and revive "
                     "on %s (%s)", job.jobid, rank,
                     proc.node.name if proc.node else "?", why)
        self._reap_reported(job, rank, f"dvm-remediation: {why}")

    # -- the live cross-rank timeline --------------------------------------

    def _on_timeline_reply(self, origin: int, payload) -> None:
        vpid, epoch, rows = payload
        with self._timeline_cv:
            if epoch != self._timeline_epoch:
                return                # late reply from an earlier round
            self._timeline[vpid] = [dict(r) for r in rows]
            self._timeline_cv.notify_all()

    def _collect_timeline(self, tail: int,
                          timeout: float = 4.0) -> list[dict]:
        """One live trace capture: xcast TAG_TIMELINE, gather every
        daemon's per-rank recorder tails (each stamped with the
        daemon's measured clock offset-to-root).  Serialized +
        epoch-fenced like the doctor collection."""
        with self._timeline_lock:
            n = len(self.vm_job.nodes) if self.vm_job else 0
            with self._timeline_cv:
                self._timeline.clear()
                self._timeline_epoch += 1
                epoch = self._timeline_epoch
            try:
                self.rml.xcast(rml.TAG_TIMELINE, (epoch, int(tail)))
            except Exception:  # noqa: BLE001 — tree tearing down
                return []
            deadline = time.monotonic() + timeout
            with self._timeline_cv:
                self._timeline_cv.wait_for(
                    lambda: len(self._timeline) >= n,
                    timeout=max(0.0, deadline - time.monotonic()))
                captures: list[dict] = []
                for rows in self._timeline.values():
                    captures.extend(rows)
            return captures

    def _timeline_doc(self, tail: int = 2048) -> dict:
        """The /timeline document: a merged, skew-corrected Chrome
        trace of the RUNNING job (live TAG_TIMELINE round); the cached
        last capture (marked stale) otherwise."""
        from ompi_tpu_torch.runtime import timeline as timeline_mod

        job = self._running_job()
        if job is None:
            if self._last_timeline is not None:
                doc = dict(self._last_timeline)
                doc["otherData"] = dict(doc.get("otherData") or {},
                                        stale=True)
                return doc
            return {"displayTimeUnit": "ns", "traceEvents": [],
                    "otherData": {"idle": True,
                                  "detail": "no job running and no "
                                            "cached capture"}}
        captures = [c for c in self._collect_timeline(tail)
                    if int(c.get("jobid", job.jobid)) == job.jobid]
        t0 = time.monotonic_ns()    # merge cost alone, not the fan-in
        doc = timeline_mod.merge_captures(captures, jobid=job.jobid)
        merge_ns = time.monotonic_ns() - t0
        with self._timeline_cv:
            self._tl_captures += 1
            self._tl_merge_ns += merge_ns
        doc["otherData"]["ts"] = time.time()
        doc["otherData"]["merge_ms"] = round(merge_ns / 1e6, 2)
        self._last_timeline = doc
        return doc

    def _daemon_rows(self) -> list[dict]:
        vm = self.vm_job
        if vm is None:
            return []
        # only meaningful with the heartbeat layer armed: without beats
        # every watched daemon's age grows forever and the column reads
        # as a fleet of silent daemons
        hb_on = float(var_registry.get("rml_heartbeat_period") or 0) > 0
        hb_ages = (self._hb_monitor.ages()
                   if hb_on and self._hb_monitor is not None else {})
        rows = []
        for i, n in enumerate(vm.nodes):
            row = {"vpid": i + 1, "host": n.name, "slots": n.slots,
                   "slots_inuse": n.slots_inuse,
                   "chips": (len(n.chips) if n.chips else 0),
                   "pid": (self._daemon_popen[i].pid
                           if i < len(self._daemon_popen) else None)}
            if i + 1 in hb_ages:
                row["hb_age_s"] = round(hb_ages[i + 1], 2)
            rows.append(row)
        return rows

    def _proc_rows(self, job, usage: dict[int, tuple]) -> list[dict]:
        from ompi_tpu_torch.mpi import trace as trace_mod

        metrics_ages = self.metrics_agg.ages(job.jobid)
        p99s = self.metrics_agg.job_hist_quantiles(
            job.jobid, "coll_dispatch_ns", 0.99)
        heads = self.metrics_agg.rank_values(job.jobid, self._CUR_NAMES)
        rejoins = self.metrics_agg.rank_values(job.jobid,
                                               ("coll_rejoin_total",))
        traces = self.metrics_agg.rank_values(
            job.jobid, ("trace_dropped_total", "trace_ring_occupancy",
                        "trace_ring_capacity", "rank_clock_to_root_ns"))
        limit = int(var_registry.get("errmgr_max_restarts") or 0)
        procs = []
        for p in job.procs:
            row = {
                "rank": p.rank, "state": p.state.value,
                "host": p.node.name if p.node else "?",
                "local_rank": p.local_rank,
                # lives is the monotone revive count (the announced
                # incarnation); restarts is the governor's crash-loop
                # BUDGET counter, reset whenever a life earns its
                # uptime — it reads 0 for a rank revived many times
                "lives": p.lives,
                "restarts": p.restarts,
                "restarts_budget_left": max(0, limit - p.restarts),
                "exit_code": p.exit_code,
            }
            if p.rank in metrics_ages:
                # age of the rank's last pvar push through the uplink —
                # a live rank whose age keeps growing has a stalled
                # metrics plane (or a stalled rank)
                row["metrics_age_s"] = round(metrics_ages[p.rank], 2)
            if p.rank in p99s:
                # tail collective latency from the rank's pushed
                # histogram (the --dvm-ps p99 column)
                row["coll_p99_us"] = round(p99s[p.rank] / 1e3, 1)
            rj = rejoins.get(p.rank, {}).get("coll_rejoin_total")
            if rj:
                # epoch-fenced coll-hierarchy rebuilds this rank ran
                # after adopted revives (the rejoin half of selfheal) —
                # a rank whose lives grew without peers' rejoins
                # ticking is p2p-only recovered, not collective-capable
                row["rejoins"] = int(rj)
            tv = traces.get(p.rank)
            if tv is not None:
                # flight-recorder health from the pushed trace pvars: a
                # rank whose ring keeps dropping needs a bigger capacity
                # (or a narrower event set) before its captures lie
                cap = tv.get("trace_ring_capacity")
                if cap:
                    row["trace_ring"] = (
                        f"{int(tv.get('trace_ring_occupancy', 0))}"
                        f"/{int(cap)}")
                dropped = tv.get("trace_dropped_total")
                if dropped:
                    row["trace_dropped"] = int(dropped)
                # measured monotonic offset of the rank's host to the
                # HNP's clock domain (the skew /timeline corrects by)
                off = tv.get("rank_clock_to_root_ns")
                if off is not None:
                    row["clock_off_us"] = round(float(off) / 1e3, 1)
            hv = heads.get(p.rank)
            if hv is not None and hv.get("coll_cur_seq", -1) >= 0:
                # the pushed recorder head: the rank's last collective
                # as kind#seq ("!" = still in flight at push time) plus
                # its age — a wedged rank is visible here without a
                # full doctor capture
                kind = trace_mod.collrec_kind_name(
                    int(hv.get("coll_cur_kind_id", -1)))
                mark = "" if hv.get("coll_cur_done") else "!"
                row["last_coll"] = \
                    f'{kind}#{int(hv["coll_cur_seq"])}{mark}'
                ts = float(hv.get("coll_cur_posted_ts", 0.0))
                if ts > 0:
                    row["last_coll_age_s"] = round(
                        max(0.0, time.time() - ts), 2)
            if p.rank in usage:      # orte-top columns, live ranks
                pid, rss, cpu_s = usage[p.rank]
                row.update(pid=pid, rss_mb=round(rss / 2**20, 1),
                           cpu_s=round(cpu_s, 2))
            procs.append(row)
        return procs

    def _sub_row(self, sub: _Submission, now: float) -> dict:
        row = {"jobid": sub.job.jobid, "state": sub.state, "np": sub.np,
               "argv": sub.argv}
        if sub.state == "queued":
            row["queue_age_s"] = round(now - sub.submitted_at, 2)
        else:
            row["placement"] = sorted({p.node.name
                                       for p in sub.job.procs if p.node})
        if sub.remediations:
            row["remediations"] = sub.remediations
        if sub.requeues:
            row["requeues"] = sub.requeues
        return row

    def _ps_table(self) -> dict:
        now = time.time()
        with self._sched_cv:
            active = list(self._active.values())
            queued = list(self._pending)
        run_subs = [s for s in active
                    if s.state in ("running", "remediating")]
        usage = self._collect_stats() if run_subs else {}
        cur = run_subs[0] if run_subs else None
        jobs = ([self._sub_row(s, now) for s in queued]
                + [self._sub_row(s, now) for s in active])
        return {"daemons": self._daemon_rows(),
                "current_job": (None if cur is None else {
                    "jobid": cur.job.jobid,
                    "argv": cur.argv,
                    "np": cur.np,
                    "procs": self._proc_rows(
                        cur.job, usage.get(cur.job.jobid, {}))}),
                "jobs": jobs,
                "queue_depth": len(queued),
                "history": self._history[-20:]}

    # -- observability plane (≈ a standing Prometheus exporter) ------------

    def _start_metrics_server(self, port: int) -> None:
        """The long-lived scrape endpoint: /metrics + /status."""
        hnp = self

        class _Handler(BaseHTTPRequestHandler):
            def do_GET(self) -> None:  # noqa: N802 — BaseHTTPRequestHandler API
                path, _, query = self.path.partition("?")
                path = path.rstrip("/") or "/"
                if path == "/metrics":
                    body = hnp._metrics_text().encode()
                    ctype = "text/plain; version=0.0.4; charset=utf-8"
                elif path == "/status":
                    body = json.dumps(hnp._status_doc()).encode()
                    ctype = "application/json"
                elif path == "/doctor":
                    # on-demand cross-rank hang capture + verdict (a
                    # live TAG_DOCTOR round while a job runs; blocking
                    # a handler thread for the collection window is
                    # fine — the server is threading)
                    body = json.dumps(
                        hnp._doctor_doc("scrape")).encode()
                    ctype = "application/json"
                elif path == "/timeline":
                    # live merged cross-rank trace (TAG_TIMELINE round
                    # while a job runs); ?tail=N bounds the per-rank
                    # recorder tail pulled from each rank
                    tail = 2048
                    for part in query.split("&"):
                        if part.startswith("tail="):
                            try:
                                tail = max(1, int(part[5:]))
                            except ValueError:
                                pass
                    body = json.dumps(hnp._timeline_doc(tail)).encode()
                    ctype = "application/json"
                elif path == "/":
                    body = (b"ompi_tpu dvm: /metrics /status /doctor "
                            b"/timeline\n")
                    ctype = "text/plain"
                else:
                    self.send_error(404)
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args) -> None:
                pass  # scrapes every few seconds must not spam stderr

        self._http = ThreadingHTTPServer(("127.0.0.1", port), _Handler)
        self._http.daemon_threads = True
        bound = self._http.server_address[1]
        self.metrics_uri = f"http://127.0.0.1:{bound}"
        threading.Thread(target=self._http.serve_forever,
                         name="dvm-metrics-http", daemon=True).start()
        # the hang-doctor watchdog rides the observability plane: a
        # pushed stuck event auto-triggers a cross-rank capture
        threading.Thread(target=self._doctor_watch,
                         name="dvm-doctor-watch", daemon=True).start()
        # --metrics-port 0 binds an ephemeral port: record the actual
        # address where clients (tests, dashboards) can find it
        try:
            with open(self.uri_path + ".metrics", "w",
                      encoding="utf-8") as f:
                f.write(self.metrics_uri + "\n")
        except OSError:
            pass
        _log.verbose(0, "metrics endpoint: %s/metrics  %s/status",
                     self.metrics_uri, self.metrics_uri)

    def _metrics_text(self) -> str:
        """Prometheus text: the per-job/per-rank aggregate first, then
        DVM-level gauges, then this process's own pvars (unlabeled).

        The own-pvar section EXCLUDES any metric name the aggregate
        already emitted: the exposition format forbids a second # TYPE
        line (and a second, non-contiguous sample group) for a name —
        a real scraper would reject the whole page, and the HNP's own
        copies of rank counters are all-zero noise anyway."""
        from ompi_tpu_torch.mpi import trace as trace_mod

        agg_text = self.metrics_agg.prometheus()
        agg_names = {line.split("{", 1)[0]
                     for line in agg_text.splitlines()
                     if line and not line.startswith("#")}
        own_lines = []
        skip_until_next_metric = False
        for line in trace_mod.metrics_snapshot().splitlines():
            if line.startswith("#"):
                name = line.split()[2] if len(line.split()) > 2 else ""
                skip_until_next_metric = name in agg_names
            else:
                skip_until_next_metric = \
                    line.split("{", 1)[0].split(" ", 1)[0] in agg_names
            if not skip_until_next_metric:
                own_lines.append(line)
        own = "\n".join(own_lines) + ("\n" if own_lines else "")
        with self._sched_cv:
            completed = self._jobs_completed
            qdepth = len(self._pending)
            running = len(self._active)
            remediations = self._remediations_total
        dvm_lines = [
            "# TYPE ompi_tpu_dvm_jobs_completed_total counter",
            f"ompi_tpu_dvm_jobs_completed_total {completed}",
            "# TYPE ompi_tpu_dvm_queue_depth gauge",
            f"ompi_tpu_dvm_queue_depth {qdepth}",
            "# TYPE ompi_tpu_dvm_jobs_running gauge",
            f"ompi_tpu_dvm_jobs_running {running}",
            "# TYPE ompi_tpu_dvm_remediations_total counter",
            f"ompi_tpu_dvm_remediations_total {remediations}",
            "# TYPE ompi_tpu_dvm_daemons gauge",
            f"ompi_tpu_dvm_daemons "
            f"{len(self.vm_job.nodes) if self.vm_job else 0}",
            "# TYPE ompi_tpu_dvm_uptime_seconds gauge",
            f"ompi_tpu_dvm_uptime_seconds "
            f"{time.time() - self._started_at:.1f}",
            "# TYPE ompi_tpu_dvm_ft_events_total counter",
            f"ompi_tpu_dvm_ft_events_total {ftevents.log.total()}",
            "# TYPE ompi_tpu_dvm_metrics_sheds_total counter",
            f"ompi_tpu_dvm_metrics_sheds_total "
            f"{getattr(self.metrics_agg, 'sheds_total', 0)}",
            "# TYPE ompi_tpu_dvm_metrics_shed_rows_total counter",
            f"ompi_tpu_dvm_metrics_shed_rows_total "
            f"{getattr(self.metrics_agg, 'shed_rows_total', 0)}",
        ]
        return agg_text + "\n".join(dvm_lines) + "\n" + own

    def _uplink_stats(self) -> dict:
        """Telemetry about the telemetry: what the metrics uplink and
        the timeline plane themselves cost (the /status block that
        answers "is observability eating my run?")."""
        stats = getattr(self.metrics_agg, "stats", lambda: {})()
        doc: dict = {"hnp_merges_total": stats.get("merges_total", 0),
                     "hnp_merge_ms_total": round(
                         stats.get("merge_ns_total", 0) / 1e6, 2),
                     # the shed-and-count fan-in policy's ledger: how
                     # many payloads (and rank-rows) overload cost
                     "hnp_sheds_total": stats.get("sheds_total", 0),
                     "hnp_shed_rows_total": stats.get(
                         "shed_rows_total", 0)}
        # rank-side push cost, summed from the pushed self-metering
        # counters (the ranks meter their own uplink datagrams)
        dgrams = nbytes = 0.0
        for jobid in self.metrics_agg.jobids():
            for vals in self.metrics_agg.rank_values(
                    jobid, ("metrics_push_datagrams_total",
                            "metrics_push_bytes_total")).values():
                dgrams += float(
                    vals.get("metrics_push_datagrams_total", 0))
                nbytes += float(vals.get("metrics_push_bytes_total", 0))
        doc["rank_push_datagrams_total"] = int(dgrams)
        doc["rank_push_bytes_total"] = int(nbytes)
        up = max(1e-9, time.time() - self._started_at)
        doc["rank_push_bytes_per_s"] = round(nbytes / up, 1)
        with self._timeline_cv:
            doc["timeline_captures_total"] = self._tl_captures
            doc["timeline_merge_ms_total"] = round(
                self._tl_merge_ns / 1e6, 2)
        return doc

    def _status_doc(self) -> dict:
        """The /status JSON: daemon table (heartbeat ages), the queue
        (depth + per-job queue age), per-job proc/placement tables
        (lives, restarts budget, last-metrics age, remediations) and the
        FT event timeline per job."""
        now = time.time()
        with self._sched_cv:
            active = {s.job.jobid: s for s in self._active.values()}
            queued = {s.job.jobid: s for s in self._pending}
            qdepth = len(self._pending)
            remediations = self._remediations_total
        jobids = set(self.metrics_agg.jobids())
        jobids.update(h["jobid"] for h in self._history)
        jobids.update(active)
        jobids.update(queued)
        by_jobid = {h["jobid"]: h for h in self._history}
        jobs = []
        for jobid in sorted(jobids):
            entry: dict = {"jobid": jobid}
            # history wins over the live tables: a finished job must not
            # read as "running" from a stale submission record
            if jobid in by_jobid:
                h = by_jobid[jobid]
                entry["state"] = "completed"
                entry["rc"] = h["rc"]
                entry["np"] = h["np"]
                entry["argv"] = h["argv"]
                for k in ("remediations", "requeues", "verdict",
                          "reason"):
                    if k in h:
                        entry[k] = h[k]
            elif jobid in active or jobid in queued:
                sub = active.get(jobid) or queued[jobid]
                entry.update(self._sub_row(sub, now))
                if jobid in active:
                    entry["procs"] = self._proc_rows(sub.job, {})
            entry["metrics_age_s"] = {
                str(r): round(a, 2)
                for r, a in self.metrics_agg.ages(jobid, now=now).items()}
            # the cross-rank straggler panel: per-rank collective
            # wait-time share over the last window + the current
            # slowest rank (None until latency histograms arrive)
            panel = self.metrics_agg.straggler(jobid)
            if panel is not None:
                entry["straggler"] = panel
            entry["ft_events"] = ftevents.log.snapshot(jobid)
            jobs.append(entry)
        running_ids = sorted(j for j, s in active.items()
                             if s.state in ("running", "remediating"))
        return {
            "uptime_s": round(now - self._started_at, 1),
            "daemons": self._daemon_rows(),
            "current_jobid": (running_ids[0] if running_ids else None),
            "running": len(running_ids),
            "queue_depth": qdepth,
            "remediations_total": remediations,
            "jobs": jobs,
            "ft_events_total": ftevents.log.total(),
            "ft_events_dropped": ftevents.log.dropped(),
            "uplink": self._uplink_stats(),
        }


# -- client side -----------------------------------------------------------

class DvmRejected(RuntimeError):
    """The DVM's admission control (or its remediation governor) refused
    the job.  ``verdict`` holds the machine-readable reply — callers can
    distinguish a full queue from a never-fits np from an exhausted
    remediation budget and react (retry later, shrink, give up)."""

    def __init__(self, verdict: dict) -> None:
        super().__init__(verdict.get("reason") or "rejected by the DVM")
        self.verdict = dict(verdict)


def _connect(uri_or_path: Optional[str]) -> socket.socket:
    target = uri_or_path or default_uri_path()
    if os.path.exists(target):
        target = _read_uri(target)
    if ":" not in target:
        raise RuntimeError(
            f"no DVM running (uri file {target!r} not found — start one "
            f"with: tpurun --dvm-start)")
    host, port = target.rsplit(":", 1)
    try:
        return socket.create_connection((host, int(port)), timeout=30)
    except OSError as e:
        raise RuntimeError(
            f"cannot reach the DVM at {target} ({e}) — is it still "
            f"running?") from e


def submit(argv: list[str], np_: int = 1,
           env: Optional[dict] = None, cwd: Optional[str] = None,
           uri: Optional[str] = None, sink=None,
           on_verdict=None) -> int:
    """Run a job on a standing DVM; streams IOF to ``sink`` (default:
    this process's stdout/stderr).  Returns the job's exit code.

    The first reply line is the admission verdict: ``queued`` (keep
    streaming — ``on_verdict`` sees it, with the assigned jobid and the
    queue depth) or ``rejected``, which raises :class:`DvmRejected`
    immediately instead of blocking forever on a full pool."""
    import sys

    conn = _connect(uri)
    try:
        wfile = conn.makefile("w", encoding="utf-8")
        rfile = conn.makefile("r", encoding="utf-8")
        wfile.write(json.dumps({
            "cmd": "run", "argv": argv, "np": np_,
            "env": env or {}, "cwd": cwd or os.getcwd()}) + "\n")
        wfile.flush()
        conn.settimeout(None)                 # jobs may run long
        for line in rfile:
            msg = json.loads(line)
            if "iof" in msg:
                rank, stream, text = msg["iof"]
                if sink is not None:
                    sink(rank, stream, text)
                else:
                    out = sys.stdout if stream == "out" else sys.stderr
                    out.write(f"[dvm,{rank}]{text}")
                    out.flush()
            elif "verdict" in msg:
                if msg["verdict"] == "rejected":
                    raise DvmRejected(msg)
                if on_verdict is not None:
                    on_verdict(msg)
            elif "exit" in msg:
                return int(msg["exit"])
            elif "error" in msg:
                raise RuntimeError(f"dvm: {msg['error']}")
        raise RuntimeError("dvm: connection closed before job completion")
    finally:
        conn.close()


def shrink(jobid: int, rank: int, uri: Optional[str] = None) -> dict:
    """Planned elastic shrink: retire one rank of a running DVM job on
    purpose (no revive; survivors continue smaller per ULFM)."""
    conn = _connect(uri)
    try:
        wfile = conn.makefile("w", encoding="utf-8")
        rfile = conn.makefile("r", encoding="utf-8")
        wfile.write(json.dumps({"cmd": "shrink", "jobid": int(jobid),
                                "rank": int(rank)}) + "\n")
        wfile.flush()
        msg = json.loads(rfile.readline())
        if "error" in msg:
            raise RuntimeError(f"dvm: {msg['error']}")
        return msg
    finally:
        conn.close()


def ps(uri: Optional[str] = None) -> dict:
    """Live VM/job table (≈ orte-ps)."""
    conn = _connect(uri)
    try:
        wfile = conn.makefile("w", encoding="utf-8")
        rfile = conn.makefile("r", encoding="utf-8")
        wfile.write(json.dumps({"cmd": "ps"}) + "\n")
        wfile.flush()
        return json.loads(rfile.readline())["ps"]
    finally:
        conn.close()


def stop(uri: Optional[str] = None) -> None:
    conn = _connect(uri)
    try:
        wfile = conn.makefile("w", encoding="utf-8")
        wfile.write(json.dumps({"cmd": "stop"}) + "\n")
        wfile.flush()
        conn.makefile("r", encoding="utf-8").readline()
    finally:
        conn.close()
