"""Event-driven job state machine — the launch DAG as data (the port's
copy of the JAX package's ``runtime/state.py``, whole).

The reference's defining runtime idea (orte/mca/state/state.h;
orte/mca/state/hnp/state_hnp.c:74-112): each job state maps to a callback;
``activate(job, state)`` enqueues an event; handlers run on the event loop and
activate the next state.  Errors activate error states handled by the errmgr.

Here the machine is synchronous-by-default (``run_to_completion``) with an
optional queue-driven mode; the *table of (state → handler)* is still data, so
launch flows are introspectable and components (tests, errmgr) can splice in
handlers — the property the reference gets from its state framework.
"""

from __future__ import annotations

import collections
import threading
from typing import Callable, Optional

from ompi_tpu_torch.core import output
from ompi_tpu_torch.runtime.job import Job, JobState

__all__ = ["StateMachine", "StateMachineError"]

_log = output.get_stream("state")

Handler = Callable[["StateMachine", Job], Optional[JobState]]


class StateMachineError(RuntimeError):
    pass


class StateMachine:
    """A per-job state machine with a data-driven transition table.

    Handlers return the next state to activate (or None to pause, e.g. while
    waiting for external events such as child exits; external code then calls
    ``activate``).
    """

    def __init__(self) -> None:
        self._table: dict[JobState, Handler] = {}
        self._queue: collections.deque[tuple[Job, JobState]] = collections.deque()
        self._lock = threading.Lock()
        self._trace: list[JobState] = []

    # -- table management (≈ orte_state.add_job_state) -------------------

    def add_state(self, state: JobState, handler: Handler) -> None:
        self._table[state] = handler

    def remove_state(self, state: JobState) -> None:
        self._table.pop(state, None)

    def states(self) -> dict[JobState, Handler]:
        return dict(self._table)

    @property
    def trace(self) -> list[JobState]:
        """States activated so far (for tests and diagnostics)."""
        return list(self._trace)

    # -- activation ------------------------------------------------------

    def activate(self, job: Job, state: JobState) -> None:
        with self._lock:
            self._queue.append((job, state))

    def run_pending(self) -> bool:
        """Process queued activations until quiescent. Returns True if any ran."""
        ran = False
        while True:
            with self._lock:
                if not self._queue:
                    return ran
                job, state = self._queue.popleft()
            ran = True
            self._dispatch(job, state)

    def _dispatch(self, job: Job, state: JobState) -> None:
        handler = self._table.get(state)
        self._trace.append(state)
        job.state = state
        _log.verbose(1, "job %d: activating state %s", job.jobid, state.value)
        if handler is None:
            if state in (JobState.TERMINATED, JobState.ABORTED):
                return  # terminal states need no handler by default
            raise StateMachineError(f"no handler for state {state.value}")
        nxt = handler(self, job)
        if nxt is not None:
            self.activate(job, nxt)

    def run_to_completion(self, job: Job, start: JobState = JobState.INIT) -> Job:
        """Drive the job from ``start`` until the queue drains."""
        self.activate(job, start)
        self.run_pending()
        return job
