"""Local process launcher: fork/exec + IOF forwarding + state machine (the
port's trimmed copy of the JAX package's ``runtime/launcher.py``).

The HNP role of the reference, collapsed to one host: orterun's event-driven
launch DAG (orte/mca/state/hnp/state_hnp.c:74-112:
INIT→ALLOCATE→MAP→LAUNCH_APPS→RUNNING→TERMINATED), odls's fork/exec with
error reporting (orte/mca/odls/default/odls_default_module.c:47-56,140),
iof's stdout/stderr forwarding with rank tagging (orte/mca/iof), and
mpirun's ``--timeout`` (the job killed, exit 124).

Device-per-rank: under ``want_gpu`` (``tpurun --gpu``) the ``gpu`` RAS
gives one slot per card, rmaps binds local rank r to card r (wrapping when
there are more ranks than cards), and every rank gets ``OMPI_TPU_CHIP``
(its card) plus ``OMPI_TPU_COORD`` (a free port on this host, where rank 0
hosts the ``torch.distributed`` rendezvous) and ``OMPI_TPU_NHOSTS=1``, as
the JAX package's multi-host plm exports them; ``init()`` then joins the
ranks into one process group (``parallel/multihost.py``).

Left out (ROADMAP.md Queue 1 item 6): every errmgr policy but the default
abort (respawn, continue, notify and selfheal wait, with the PMIx server's
failure reports), cpu binding of the children (rtc), the notifier, and
multi-host launch (plm sim/ssh, the DVM).
"""

from __future__ import annotations

import os
import queue
import signal
import socket
import subprocess
import sys
import threading
import time
from typing import Optional

from ompi_tpu_torch.core import output
from ompi_tpu_torch.core.config import VarType, register_var, var_registry
from ompi_tpu_torch.runtime import pmix, ras, rmaps
from ompi_tpu_torch.runtime.job import (AppContext, Job, JobState, Proc,
                                        ProcState)
from ompi_tpu_torch.runtime.state import StateMachine

__all__ = ["LocalLauncher", "launch", "ENV_COORD", "ENV_NHOSTS"]

_log = output.get_stream("launcher")

#: the rendezvous of the job-wide device view (``parallel/multihost.py``)
ENV_COORD = "OMPI_TPU_COORD"
ENV_NHOSTS = "OMPI_TPU_NHOSTS"

register_var("launcher", "tag_output", VarType.BOOL, True,
             "prefix forwarded stdout/stderr with [jobid,rank]")
register_var("launcher", "kill_grace_s", VarType.DOUBLE, 2.0,
             "seconds between SIGTERM and SIGKILL when aborting a job")


def _pkg_root() -> str:
    """Directory CONTAINING the ompi_tpu_torch package — what a child
    process needs on PYTHONPATH to import it (≈ plm_rsh prefixing its
    install dirs, plm_rsh_module.c)."""
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


def _free_port(host: str = "127.0.0.1") -> int:
    with socket.socket() as s:
        s.bind((host, 0))
        return s.getsockname()[1]


class _StdinWriter:
    """Per-rank stdin pump: a bounded queue + writer thread, so blocking
    pipe writes (rank not draining stdin) never stall the launcher."""

    def __init__(self, rank: int, pipe) -> None:
        self.rank = rank
        self._q: queue.Queue = queue.Queue(maxsize=64)
        self._eof = threading.Event()  # survives a full queue: EOF is a
        # flag the writer checks between chunks, never a droppable slot
        self._t = threading.Thread(target=self._run, args=(pipe,),
                                   daemon=True)
        self._t.start()

    def feed(self, chunk: Optional[bytes]) -> None:
        if chunk is None:
            self._eof.set()
            try:
                self._q.put_nowait(b"")   # wake the writer if it is idle
            except queue.Full:
                pass                      # writer is busy; it checks _eof
            return
        try:
            self._q.put(chunk, timeout=1.0)
        except queue.Full:
            _log.error("stdin to rank %d backed up; dropping %d bytes",
                       self.rank, len(chunk))

    def _run(self, pipe) -> None:
        while True:
            try:
                chunk = self._q.get(timeout=0.5)
            except queue.Empty:
                chunk = b""
            try:
                if chunk:
                    pipe.write(chunk)
                    pipe.flush()
                if self._eof.is_set() and self._q.empty():
                    pipe.close()
                    return
            except (BrokenPipeError, ValueError, OSError):
                return


class LocalLauncher:
    """Launches a job's ranks as local OS processes (device-per-rank aware)."""

    def __init__(self, want_gpu: bool = False,
                 stdin_target: Optional[str] = None,
                 timeout: Optional[float] = None, **select_ctx) -> None:
        self.want_gpu = want_gpu
        # mpirun --timeout: past it the job is killed and run() gives 124
        self.timeout = timeout
        self.timed_out = False
        # ≈ iof.h:27-43: launcher stdin goes to rank 0 by default;
        # "all" duplicates it to every rank, "none" gives ranks /dev/null.
        self.stdin_target = "0" if stdin_target is None else str(stdin_target)
        self.select_ctx = select_ctx
        self.sm = StateMachine()
        self.sm.add_state(JobState.INIT, self._st_init)
        self.sm.add_state(JobState.ALLOCATE, self._st_allocate)
        self.sm.add_state(JobState.MAP, self._st_map)
        self.sm.add_state(JobState.LAUNCH_APPS, self._st_launch)
        self.sm.add_state(JobState.RUNNING, self._st_running)
        self.server: Optional[pmix.PMIxServer] = None
        self.coord: Optional[str] = None
        self._popen: dict[int, subprocess.Popen] = {}
        self._iof_threads: list[threading.Thread] = []
        self._kill_lock = threading.Lock()
        self._stdin_sinks: dict[int, _StdinWriter] = {}

    # -- state handlers (the launch DAG) ---------------------------------

    def _st_init(self, sm: StateMachine, job: Job) -> JobState:
        return JobState.ALLOCATE

    def _st_allocate(self, sm: StateMachine, job: Job) -> JobState:
        ras.allocate(job, want_gpu=self.want_gpu, **self.select_ctx)
        return JobState.MAP

    def _st_map(self, sm: StateMachine, job: Job) -> JobState:
        rmaps.map_job(job, **self.select_ctx)
        return JobState.LAUNCH_APPS

    def _proc_env(self, job: Job, proc: Proc) -> dict:
        # make this package importable in children no matter their cwd
        root = _pkg_root()
        app = job.apps[proc.app_idx]
        env = dict(os.environ)
        env.update(app.env)
        pypath = env.get("PYTHONPATH", "")
        if root not in pypath.split(os.pathsep):
            env["PYTHONPATH"] = (
                root + (os.pathsep + pypath if pypath else ""))
        env[pmix.ENV_URI] = self.server.uri
        env[pmix.ENV_RANK] = str(proc.rank)
        env[pmix.ENV_SIZE] = str(job.np)
        env[pmix.ENV_JOBID] = str(job.jobid)
        env[pmix.ENV_LOCAL_RANK] = str(proc.local_rank)
        if proc.chip is not None:
            env[pmix.ENV_CHIP] = str(proc.chip)
        if self.coord is not None:
            env[ENV_COORD] = self.coord
            env[ENV_NHOSTS] = "1"
        return env

    def _launch_proc(self, job: Job, proc: Proc) -> bool:
        """Fork/exec one rank; False on failure to start (proc.state
        records why)."""
        app = job.apps[proc.app_idx]
        want_stdin = (self.stdin_target == "all"
                      or self.stdin_target == str(proc.rank))
        try:
            p = subprocess.Popen(
                app.argv, env=self._proc_env(job, proc), cwd=app.cwd,
                stdin=(subprocess.PIPE if want_stdin
                       else subprocess.DEVNULL),
                stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                start_new_session=True)
        except OSError as e:
            # ≈ odls error-pipe protocol: exec failure surfaces here.
            proc.state = ProcState.FAILED_TO_START
            proc.exit_code = 127
            output.show_help(
                "launcher", "failed-to-start",
                rank=proc.rank, argv0=app.argv[0], error=str(e))
            return False
        proc.pid = p.pid
        proc.state = ProcState.RUNNING
        with self._kill_lock:  # kill_job may iterate concurrently
            self._popen[proc.rank] = p
        if want_stdin:
            self._stdin_sinks[proc.rank] = _StdinWriter(proc.rank, p.stdin)
        self._start_iof(job, proc, p)
        return True

    def _st_launch(self, sm: StateMachine, job: Job) -> JobState:
        self.server = pmix.PMIxServer(
            size=job.np, on_abort=lambda r, s, m: self._on_abort(job, r, s, m))
        if self.want_gpu:
            # one rendezvous for the job's process group; rank 0 serves it
            self.coord = f"127.0.0.1:{_free_port()}"
        for proc in job.procs:
            if not self._launch_proc(job, proc):
                # Failure to start is fatal: the job never assembled.
                # Record the abort and reap what launched.
                if job.aborted_proc is None:
                    job.aborted_proc = proc
                    job.abort_reason = f"rank {proc.rank} failed to start"
                self.kill_job(job, exclude=proc)
                return JobState.RUNNING  # reap launched ranks, then ABORTED
        if self._stdin_sinks:
            self._start_stdin_pump()
        return JobState.RUNNING

    def _st_running(self, sm: StateMachine, job: Job) -> Optional[JobState]:
        # Reap children; the first abnormal exit aborts the job (the
        # default errmgr policy).
        with self._kill_lock:
            pending = dict(self._popen)
        deadline = (None if self.timeout is None
                    else time.monotonic() + self.timeout)
        while pending:
            if (deadline is not None and not self.timed_out
                    and time.monotonic() > deadline):
                self.timed_out = True
                print(f"tpurun: job timed out after {self.timeout:g}s — "
                      f"aborting (mpirun --timeout semantics)",
                      file=sys.stderr, flush=True)
                self.kill_job(job)
            for rank, p in list(pending.items()):
                rc = p.poll()
                if rc is None:
                    continue
                proc = job.procs[rank]
                proc.exit_code = rc
                if proc.state == ProcState.KILLED_BY_CMD:
                    pass  # we killed it during abort
                elif rc == 0:
                    proc.state = ProcState.TERMINATED
                else:
                    proc.state = ProcState.ABORTED
                    # wake fence/get waiters so surviving ranks don't hang
                    # on a dead peer
                    if self.server is not None:
                        self.server.proc_died(rank)
                    self._proc_failed(job, proc)
                del pending[rank]
            if pending:
                time.sleep(0.01)
        for t in self._iof_threads:
            t.join(timeout=2.0)
        if self.server is not None:
            self.server.close()
        return (JobState.ABORTED if job.aborted_proc is not None
                else JobState.TERMINATED)

    def _proc_failed(self, job: Job, proc: Proc) -> None:
        """The errmgr's default abort policy (≈ errmgr_default_hnp): the
        first failure aborts the job and takes the other ranks down."""
        if job.aborted_proc is None:
            job.aborted_proc = proc
            job.abort_reason = (
                f"rank {proc.rank} {proc.state.value} "
                f"(exit code {proc.exit_code})")
        _log.verbose(1, "aborting job %d: %s", job.jobid, job.abort_reason)
        self.kill_job(job, exclude=proc)

    # -- IOF --------------------------------------------------------------

    def _start_iof(self, job: Job, proc: Proc, p: subprocess.Popen) -> None:
        tag = var_registry.get("launcher_tag_output")

        def reader(pipe, sink):
            prefix = f"[{job.jobid},{proc.rank}]" if tag else ""
            for raw in iter(pipe.readline, b""):
                line = raw.decode(errors="replace")
                sink.write(f"{prefix}{line}" if prefix else line)
                sink.flush()
            pipe.close()

        for pipe, sink in ((p.stdout, sys.stdout), (p.stderr, sys.stderr)):
            t = threading.Thread(target=reader, args=(pipe, sink), daemon=True)
            t.start()
            self._iof_threads.append(t)

    def _start_stdin_pump(self) -> None:
        """Forward launcher stdin to the target rank(s) (≈ iof hnp stdin).
        Raw-fd reads, not sys.stdin.buffer: a daemon thread blocked in a
        buffered read holds the buffer lock, and interpreter shutdown
        aborts when it cannot reacquire it."""
        def pump() -> None:
            try:
                fd = sys.stdin.fileno()
            except (AttributeError, ValueError, OSError):
                fd = None   # stdin replaced (pytest capture) — nothing here
            try:
                while fd is not None:
                    chunk = os.read(fd, 1 << 16)
                    if not chunk:
                        break
                    for w in list(self._stdin_sinks.values()):
                        w.feed(chunk)
            except (OSError, ValueError):
                pass
            for w in list(self._stdin_sinks.values()):
                w.feed(None)  # EOF

        threading.Thread(target=pump, daemon=True).start()

    # -- abort path --------------------------------------------------------

    def _on_abort(self, job: Job, rank: int, status: int, msg: str) -> None:
        proc = job.procs[rank]
        if job.aborted_proc is None:
            job.aborted_proc = proc
            job.abort_reason = f"rank {rank} called abort: {msg}"
            job.abort_status = status
        # The aborting rank asked for job teardown; it gets killed too (its
        # requested status is preserved via job.abort_status).
        self.kill_job(job)

    def kill_job(self, job: Job, exclude: Optional[Proc] = None) -> None:
        """SIGTERM all live ranks, then SIGKILL stragglers after a grace."""
        with self._kill_lock:
            victims = []
            for rank, p in list(self._popen.items()):
                proc = job.procs[rank]
                if proc is exclude or p.poll() is not None:
                    continue
                proc.state = ProcState.KILLED_BY_CMD
                try:
                    os.killpg(p.pid, signal.SIGTERM)
                except (ProcessLookupError, PermissionError):
                    continue
                victims.append(p)
        if not victims:
            return
        deadline = time.monotonic() + var_registry.get("launcher_kill_grace_s")
        for p in victims:
            remaining = deadline - time.monotonic()
            try:
                p.wait(timeout=max(0.0, remaining))
            except subprocess.TimeoutExpired:
                try:
                    os.killpg(p.pid, signal.SIGKILL)
                except (ProcessLookupError, PermissionError):
                    pass

    # -- entry -------------------------------------------------------------

    def run(self, job: Job) -> int:
        """Drive the job to completion; return the job exit code."""
        self.sm.run_to_completion(job, JobState.INIT)
        if self.timed_out:
            return 124
        if job.aborted_proc is not None:
            output.show_help(
                "launcher", "job-aborted",
                jobid=job.jobid, reason=job.abort_reason or "unknown")
            if job.abort_status is not None:
                return job.abort_status or 1
            rc = job.aborted_proc.exit_code or 1
            # signal death: report the shell convention 128+signum, not a
            # negative value that the OS would truncate meaninglessly
            return 128 - rc if rc < 0 else rc
        return 0


def launch(argv: list[str], np: int, want_gpu: bool = False,
           env: Optional[dict[str, str]] = None,
           stdin_target: Optional[str] = None,
           timeout: Optional[float] = None, **select_ctx) -> int:
    """One-call launch: build the job, run it, return exit code."""
    job = Job([AppContext(argv=argv, np=np, env=env or {})])
    return LocalLauncher(want_gpu=want_gpu, stdin_target=stdin_target,
                         timeout=timeout, **select_ctx).run(job)
