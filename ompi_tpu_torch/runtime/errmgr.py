"""Errmgr — failure response policy (the port's copy of the JAX package's
``runtime/errmgr.py``).

≈ orte/mca/errmgr (errmgr.h:87-136; default_hnp behavior at
errmgr_default_hnp.c:351-470: on proc abort / comm failure, terminate the
job).  Components decide what a proc-failure event does:

- ``abort``    — default: first failure kills every remaining proc and the
  job exits with the failed proc's status (mpirun's default).  The
  teardown is SIGTERM → ``launcher_kill_grace_s`` → SIGKILL; ranks
  running with the flight recorder armed (``tpurun --trace`` /
  ``OMPI_TPU_TRACE=1``) flush their trace ring from that SIGTERM.
- ``continue`` — log and keep going.
- ``notify``   — keep going AND propagate the failure to the survivors
  (PMIx dead-set reason + TAG_PROC_FAILED xcast + notifier event) so
  they can run user-level recovery: ``Comm.revoke()/shrink()/agree()``
  from ``ompi_tpu_torch.mpi.ft`` — the ULFM shrink-and-continue recipe.
  On the daemon tree, notify additionally arms mid-tree re-parenting: a
  non-leaf orted's death no longer tears down its subtree via the
  lifeline rule — the orphaned child daemons re-wire to the nearest
  live ancestor (TAG_REPARENT handshake, HNP arbitrating), confining
  the loss to the dead host's ranks.
- ``respawn``  — revive the failed rank in place up to
  ``errmgr_max_restarts`` times (≈ rmaps/resilient + the errmgr restart
  paths): same rank and env plus ``OMPI_TPU_RESTART=<n>`` so the app can
  restore from its last ``ckpt`` snapshot (+ msglog replay for in-flight
  p2p) instead of recomputing from step 0.  Select with
  ``--mca errmgr respawn``.  Works in both launchers (local fork/exec and
  the orted daemon tree via TAG_RESPAWN).

  Scope: respawn is a HOST-plane recovery.  A ``--gpu`` job's process
  group cannot take a member's new life (the rendezvous store's rank
  slot and NCCL's communicator are fixed at the join), so a reviving
  policy launches the ranks with ``multihost_auto_init`` 0
  (:func:`apply_host_plane_policy`): each rank binds its card and runs
  the one-process mesh on it, and a revived life restores its training
  state from the ``ckpt`` snapshots (``ckpt.snapc.auto_restore``).  A
  job that needs the group across ranks recovers by a full-job restart
  from the snapshots.

- ``selfheal`` — the fused self-healing policy: respawn's revival and
  notify's propagation stop being separate worlds.  Every detection
  source the runtime has — the launcher exit reap, the daemon heartbeat
  monitor, rank-plane gossip (``report_failed`` → the hung pid is
  SIGKILLed), the coll/shm arena writer probe — lands here and runs the
  full cycle: the death is propagated to the survivors FIRST (dead-set
  reason + ``TAG_PROC_FAILED`` xcast, so their detectors fail pending
  ops fast instead of stalling), then the rank
  is revived in place through ``respawn_proc`` with
  ``OMPI_TPU_RESTART`` (snapshot restore via ``ckpt.snapc.auto_restore``
  + msglog replay for the in-flight gap), survivors' detectors flip the
  peer back alive (the revive listeners), and **incarnation numbers**
  carried in PML data frames (``ep``/``si``) and FT control frames
  (``de``/``si``) fence stale traffic from the dead life out of the new
  one.

  Failure response is a LADDER, not a cliff — the policy degrades in
  order::

      revive  →  notify/shrink  →  abort

  The revive arm is crash-loop gated (shared with plain respawn): a
  revive only counts as successful once the rank stays up
  ``errmgr_min_uptime_s``, measured from the life's PMIx registration
  (boot excluded) — an instant re-death, or a death before the life
  ever registered, burns one ``errmgr_max_restarts`` slot *with
  exponential backoff* (the budget cannot drain in milliseconds),
  while a later death resets the budget (the revive worked).  The
  budget reset never touches the incarnation: ``proc.lives`` — the
  number survivors adopt and the fence compares — is monotone across
  resets.  A revived life that wedges *during* boot (never registers)
  is re-reapable: the PMIx server accepts failure reports about it
  regardless of their incarnation stamp after
  ``pmix_register_grace_s``.  When the budget is exhausted, the rank is
  unrevivable (no ``respawn_proc`` hook, its daemon died with its host,
  or a planned shrink retired it), or a revive fails to start, the policy degrades to the notify
  rung: the already-propagated death stands, survivors continue
  smaller (the ULFM shrink recipe applies).  Only when shrink is
  impossible — no survivors left to carry the job, or no control plane
  to propagate through — does it fall to the last rung and abort.
  ``errmgr_selfheal_{revives,escalations}_total`` count the cycle in
  the flight recorder.  Select with ``--mca errmgr selfheal``.

  The rejoin covers COLLECTIVES, not just the p2p plane: survivors
  fence every cached collective artifact (coll/shm node splits +
  arena, pinned persistent slots) on the per-communicator coll epoch
  (``mpi.ft.comm_coll_epoch`` — the sum of adopted incarnations), so
  the first dispatch after adopting the revived life tears the old
  hierarchy down and rebuilds it with the new life included, and
  persistent plans auto-``rebind()`` on their next Start.  The revived
  rank's ``coll_rejoin`` FT-timeline events (PMIx ``coll_rejoin`` RPC)
  make the rejoin half observable.

Thread-context rules: errmgr hooks fire from the local launcher's reap
loop, rml ``register_recv`` callbacks (the daemon tree's link reader
threads) and the PMIx server's ``on_failed_report``/``on_client_contact``
(server connection threads).  Keep detection→reaction paths non-blocking
there (queue + drain from a worker, the way ``PmlFT._adopt_notify``
defers its RPC to the gossip loop); the one sleep on such a path, the
respawn backoff, is clamped below the daemon heartbeat timeout
(:meth:`ErrmgrRespawn._max_reader_stall`).  A correlated daemon loss
reaches notify and selfheal as one batch (``daemon_ranks_failed``: one
``TAG_PROC_FAILED`` xcast for all the dead host's ranks).
"""

from __future__ import annotations

import time
from typing import TYPE_CHECKING

from ompi_tpu_torch.core import output
from ompi_tpu_torch.core.config import VarType, register_var, var_registry
from ompi_tpu_torch.core.mca import Component, Framework
from ompi_tpu_torch.runtime.job import Job, Proc, ProcState

if TYPE_CHECKING:
    from ompi_tpu_torch.runtime.launcher import LocalLauncher

__all__ = ["errmgr_framework", "ErrmgrAbort", "ErrmgrRespawn",
           "ErrmgrContinue", "ErrmgrNotify", "ErrmgrSelfheal"]

_log = output.get_stream("errmgr")

errmgr_framework = Framework("errmgr", "failure response policy")

register_var("errmgr", "max_restarts", VarType.SIZE, 2,
             "errmgr respawn/selfheal: revive a failed rank at most this "
             "many times before degrading (respawn: job abort; selfheal: "
             "the notify/shrink rung).  The budget counts CRASH-LOOP "
             "revivals: a rank that stays up errmgr_min_uptime_s earns "
             "its budget back")
register_var("errmgr", "min_uptime_s", VarType.DOUBLE, 5.0,
             "crash-loop gate for the reviving policies (respawn, "
             "selfheal): a revive only counts as successful once the "
             "rank stays up this long, measured from the life's PMIx "
             "registration (interpreter and framework boot do not count — a "
             "rank that crashes deterministically right after boot "
             "cannot earn its budget back).  An earlier re-death — or a "
             "death before the life ever registered — burns one "
             "errmgr_max_restarts slot with exponential backoff before "
             "the next revive (instant-death loops cannot drain the "
             "budget in milliseconds); a later death resets the budget. "
             "0 disables the gate: classic budget semantics — every "
             "revive counts against errmgr_max_restarts, no reset, no "
             "backoff")


def apply_host_plane_policy(errmgr, env: dict, *base_envs: dict) -> None:
    """Any REVIVING errmgr policy (``REVIVES`` — respawn, selfheal) is
    HOST-plane recovery: a revived rank cannot rejoin the job's process
    group (its store slot and NCCL's communicator cannot take a new
    life), and survivors holding a group with a dead member block in its
    teardown.  The policy implies the plane — when a reviving policy is
    selected, launch app processes without the group's join (each still
    binds its card) unless the user set the var explicitly (in ``env``
    or any of ``base_envs``)."""
    from ompi_tpu_torch.core.config import var_registry

    if not getattr(errmgr, "REVIVES", False):
        return
    key = var_registry.ENV_PREFIX + "multihost_auto_init"
    if any(key in e for e in (env, *base_envs)):
        return
    env[key] = "0"


def _propagate_failure(launcher, job: Job, proc: Proc,
                       reason: str) -> None:
    """The notify rung shared by ErrmgrNotify and ErrmgrSelfheal: put the
    human-readable reason on the runtime dead-set (idempotent — the reap
    loop already called ``proc_died``) and flood a TAG_PROC_FAILED xcast
    down the daemon tree so every host's record shows which rank died.
    The dead-set lives on the JOB's rendezvous when the launcher runs
    per-job PMIx servers (multi-tenant DVM); ``launcher.server`` remains
    the fallback for single-job and custom launchers."""
    server = (getattr(job, "pmix_server", None)
              or getattr(launcher, "server", None))
    if server is not None:
        server.proc_died(proc.rank, reason=reason)
    node = getattr(launcher, "rml", None)
    if node is not None:
        from ompi_tpu_torch.runtime import rml as rml_mod

        try:
            node.xcast(rml_mod.TAG_PROC_FAILED, (proc.rank, reason))
        except Exception as e:  # noqa: BLE001 — tree may be tearing down
            _log.error("failure propagation: TAG_PROC_FAILED xcast "
                       "failed: %r", e)


def _rank_span(ranks: list, head: int = 16) -> str:
    """A bounded textual rank list for batch events — a 160-rank rack
    loss must not inline 160 numbers into every log/notifier line."""
    ranks = sorted(int(r) for r in ranks)
    if len(ranks) <= head:
        return ",".join(map(str, ranks))
    return (",".join(map(str, ranks[:head]))
            + f",...(+{len(ranks) - head} more)")


def _propagate_failure_batch(launcher, job: Job, procs: list,
                             reason: str) -> None:
    """The batched twin of :func:`_propagate_failure` for correlated
    daemon loss: a rack death takes tens of ranks in one tick, and
    per-rank propagation turns that into N full-tree xcasts — its own
    control-plane storm.  The dead-set is already updated per rank (the
    PLM's _fail_daemon_ranks called ``proc_died`` before any policy
    ran), so ONE xcast carrying the whole rank batch suffices; the
    orted handler accepts a rank list in the rank slot."""
    node = getattr(launcher, "rml", None)
    if node is None or not procs:
        return
    from ompi_tpu_torch.runtime import rml as rml_mod

    try:
        node.xcast(rml_mod.TAG_PROC_FAILED,
                   ([p.rank for p in procs], reason))
    except Exception as e:  # noqa: BLE001 — tree may be tearing down
        _log.error("failure propagation: batched TAG_PROC_FAILED xcast "
                   "failed: %r", e)


#: test seam: the backoff sleep (patched by unit tests).  The sleep runs
#: INSIDE proc_failed — on the local launcher's reap loop, or the
#: daemon link's RML reader thread — deliberately: deferring the revive
#: to a timer would race the reap loop's exit (a job whose last pending
#: rank is mid-backoff would be accounted done with the revive dropped).
#: The stall is bounded by _BACKOFF_CAP and only ever paid by a rank
#: that is actively crash-looping.
_sleep = time.sleep

#: first crash-loop revive backoff; doubles per instant re-death
_BACKOFF_BASE = 0.5
#: cap — a rank stuck in a crash loop is probed at most this often
_BACKOFF_CAP = 5.0


class _RestartGovernor:
    """Crash-loop gating shared by the reviving policies (respawn,
    selfheal): min-uptime success accounting + exponential revive
    backoff.  A revive counts as successful only once the rank stayed up
    ``errmgr_min_uptime_s`` — then the ``errmgr_max_restarts`` budget
    resets.  An instant re-death keeps the budget burn and returns a
    (doubling, capped) delay the policy sleeps before the next revive,
    so a crash loop drains the budget over seconds, not milliseconds."""

    def __init__(self) -> None:
        self._backoff: dict[tuple[int, int], float] = {}

    def pre_revive_delay(self, job: Job, proc: Proc) -> float:
        """Classify this death; returns the backoff (seconds) to sleep
        before reviving — 0.0 for a first death or an earned-uptime one
        (which also resets ``proc.restarts``).  Uptime is measured from
        the life's PMIx registration (``launched_at`` is stamped by the
        server's ``reg`` hook, not at fork), so a slow interpreter boot
        cannot earn the budget back; a life that died *before* ever
        registering (``launched_at is None``) is the crash-loopiest case
        of all and always burns a slot.  Only the budget counter resets
        here — ``proc.lives`` (the incarnation survivors adopted) is
        monotone and untouched."""
        key = (job.jobid, proc.rank)
        min_up = float(var_registry.get("errmgr_min_uptime_s") or 0)
        if min_up <= 0.0:
            # gate disabled: CLASSIC budget semantics — every revive
            # counts against errmgr_max_restarts, no reset, no backoff.
            # (Treating every death as "earned" instead would reset the
            # budget forever and revive a deterministic crasher in a
            # tight loop that never reaches the degrade rung.)
            self._backoff.pop(key, None)
            return 0.0
        up = (None if proc.launched_at is None
              else time.monotonic() - proc.launched_at)
        earned = up is not None and up >= min_up
        if proc.restarts == 0 or earned:
            if proc.restarts:
                _log.verbose(1, "rank %d ran %.1fs (>= min_uptime %.1fs); "
                             "restart budget reset", proc.rank,
                             up if up is not None else -1.0, min_up)
                proc.restarts = 0
            self._backoff.pop(key, None)
            return 0.0
        delay = self._backoff.get(key, _BACKOFF_BASE)
        self._backoff[key] = min(delay * 2, _BACKOFF_CAP)
        return min(delay, self._max_reader_stall())

    @staticmethod
    def _max_reader_stall() -> float:
        """On a daemon tree the backoff sleep runs on the RML link
        reader thread (see the ``_sleep`` note): a stall at or above
        ``rml_heartbeat_timeout`` would starve TAG_HEARTBEAT delivery
        queued behind it and the HNP would declare the healthy daemon
        hosting the crash-looping rank lost — failing every rank on
        that host.  With heartbeats armed, cap the sleep well below the
        declare timeout.  ``lookup`` rather than ``get``: a purely
        local run may never import rml, so the vars may be
        unregistered."""
        period = var_registry.lookup("rml_heartbeat_period")
        if period is None or float(period.value or 0) <= 0:
            return _BACKOFF_CAP
        timeout = var_registry.lookup("rml_heartbeat_timeout")
        if timeout is None or float(timeout.value or 0) <= 0:
            return _BACKOFF_CAP
        return min(_BACKOFF_CAP, 0.4 * float(timeout.value))


@errmgr_framework.component
class ErrmgrAbort(Component):
    NAME = "abort"
    PRIORITY = 10

    def proc_failed(self, launcher: "LocalLauncher", job: Job, proc: Proc) -> None:
        from ompi_tpu_torch.runtime import ftevents

        if job.aborted_proc is None:
            job.aborted_proc = proc
            job.abort_reason = (
                f"rank {proc.rank} {proc.state.value} "
                f"(exit code {proc.exit_code})")
        ftevents.record("abort", jobid=job.jobid, rank=proc.rank,
                        lives=proc.lives, exit_code=proc.exit_code)
        _log.verbose(1, "aborting job %d: %s", job.jobid, job.abort_reason)
        launcher.kill_job(job, exclude=proc)


@errmgr_framework.component
class ErrmgrRespawn(Component):
    """Revive failed ranks in place (≈ errmgr restart + rmaps/resilient,
    errmgr_default_hnp.c:351-470's ORTE_PROC_STATE_RESTART arm).  Crash
    loops are gated by the shared governor: instant re-deaths burn the
    ``errmgr_max_restarts`` budget with exponential backoff, and a rank
    that stayed up ``errmgr_min_uptime_s`` earns its budget back."""

    NAME = "respawn"
    PRIORITY = 0    # opt-in via --mca errmgr respawn
    REVIVES = True

    def __init__(self) -> None:
        self._governor = _RestartGovernor()

    def proc_failed(self, launcher: "LocalLauncher", job: Job,
                    proc: Proc) -> None:
        from ompi_tpu_torch.runtime import ftevents
        from ompi_tpu_torch.runtime.notifier import Severity, notify

        ftevents.record("detect", jobid=job.jobid, rank=proc.rank,
                        lives=proc.lives, rung="respawn",
                        exit_code=proc.exit_code)
        limit = var_registry.get("errmgr_max_restarts")
        # both shipped launchers revive (local fork/exec + daemon tree via
        # TAG_RESPAWN); a custom launcher without the hook degrades to
        # abort instead of raising into its event dispatch
        respawn = getattr(launcher, "respawn_proc", None)
        if respawn is None:
            _log.error("errmgr/respawn: %s cannot revive ranks; aborting",
                       type(launcher).__name__)
        else:
            # may RESET proc.restarts (the previous revive earned its
            # min-uptime) — classify before the budget check
            delay = self._governor.pre_revive_delay(job, proc)
            if proc.restarts < limit:
                if delay:
                    _log.verbose(1, "rank %d re-died within "
                                 "errmgr_min_uptime_s; %.1fs backoff "
                                 "before revive %d/%d", proc.rank, delay,
                                 proc.restarts + 1, limit)
                    _sleep(delay)
                _log.verbose(1, "rank %d failed (exit %s); respawn %d/%d",
                             proc.rank, proc.exit_code, proc.restarts + 1,
                             limit)
                notify(Severity.WARN, "rank-respawn",
                       f"job {job.jobid} rank {proc.rank} exit "
                       f"{proc.exit_code}; restart "
                       f"{proc.restarts + 1}/{limit}")
                if respawn(job, proc):
                    return
                _log.error("rank %d respawn failed to start", proc.rank)
            else:
                _log.verbose(1, "rank %d exhausted %d restarts; aborting "
                             "job", proc.rank, limit)
        if job.aborted_proc is None:
            job.aborted_proc = proc
            job.abort_reason = (
                f"rank {proc.rank} {proc.state.value} after "
                f"{proc.restarts} restart(s) (exit code {proc.exit_code})")
        launcher.kill_job(job, exclude=proc)


@errmgr_framework.component
class ErrmgrContinue(Component):
    NAME = "continue"
    PRIORITY = 0

    def proc_failed(self, launcher: "LocalLauncher", job: Job, proc: Proc) -> None:
        _log.verbose(1, "rank %d failed (%s); continuing per policy",
                     proc.rank, proc.state.value)


@errmgr_framework.component
class ErrmgrNotify(Component):
    """ULFM-enabling policy: a rank death neither kills the job (abort)
    nor revives the rank (respawn) — it is *propagated* to the survivors
    so they can run user-level recovery (``Comm.revoke`` / ``shrink`` /
    ``agree``, mpi/ft.py):

    - the PMIx server's dead-set already holds the rank (the launcher
      calls ``proc_died`` before any policy runs), so survivors' failure
      detectors see it on their next poll and pending operations against
      the dead peer fail fast with MPI_ERR_PROC_FAILED;
    - on a daemon tree the failure additionally rides a TAG_PROC_FAILED
      xcast so every orted logs which rank died and why;
    - an admin notifier event records the death.

    Select with ``--mca errmgr notify``.  This is the policy behind the
    shrink-and-continue recipe (README "Fault tolerance").
    """

    NAME = "notify"
    PRIORITY = 0    # opt-in via --mca errmgr notify
    TOLERATES_DAEMON_LOSS = True

    def proc_failed(self, launcher: "LocalLauncher", job: Job,
                    proc: Proc) -> None:
        from ompi_tpu_torch.runtime import ftevents
        from ompi_tpu_torch.runtime.notifier import Severity, notify

        reason = (f"rank {proc.rank} {proc.state.value} "
                  f"(exit code {proc.exit_code})")
        _log.verbose(1, "notify policy: %s; propagating to survivors",
                     reason)
        ftevents.record("detect", jobid=job.jobid, rank=proc.rank,
                        lives=proc.lives, rung="notify", reason=reason)
        _propagate_failure(launcher, job, proc, reason)
        notify(Severity.WARN, "rank-failed",
               f"job {job.jobid} {reason}; survivors notified "
               f"(job continues)")

    def daemon_ranks_failed(self, launcher: "LocalLauncher", job: Job,
                            procs: list) -> None:
        """Correlated daemon loss, batched: ONE xcast / FT event /
        notifier event for the whole rack's worth of ranks — per-rank
        propagation would turn a 16-daemon loss into hundreds of
        full-tree control frames, a reparent-window storm of our own
        making.  The per-rank dead-set entries are already in place
        (the PLM recorded them before any policy ran)."""
        if not procs:
            return
        from ompi_tpu_torch.runtime import ftevents
        from ompi_tpu_torch.runtime.notifier import Severity, notify

        ranks = [p.rank for p in procs]
        reason = (f"{len(ranks)} rank(s) lost with their daemon(s): "
                  f"{_rank_span(ranks)}")
        _log.verbose(1, "notify policy: %s; propagating to survivors "
                     "(batched)", reason)
        ftevents.record("detect", jobid=job.jobid, rank=ranks[0],
                        rung="notify", reason=reason, count=len(ranks))
        _propagate_failure_batch(launcher, job, procs, reason)
        notify(Severity.WARN, "rank-failed",
               f"job {job.jobid} {reason}; survivors notified "
               f"(job continues)")


@errmgr_framework.component
class ErrmgrSelfheal(Component):
    """The fused self-healing policy: every failure runs the full
    detect → reap → revive → rejoin cycle, degrading down the ladder
    (revive → notify/shrink → abort) instead of falling off a cliff.
    See the module docstring for the full contract."""

    NAME = "selfheal"
    PRIORITY = 0    # opt-in via --mca errmgr selfheal
    REVIVES = True
    TOLERATES_DAEMON_LOSS = True

    def __init__(self) -> None:
        self._governor = _RestartGovernor()

    def proc_failed(self, launcher: "LocalLauncher", job: Job,
                    proc: Proc) -> None:
        from ompi_tpu_torch.mpi import trace as trace_mod
        from ompi_tpu_torch.runtime.notifier import Severity, notify

        reason = (f"rank {proc.rank} {proc.state.value} "
                  f"(exit code {proc.exit_code})")
        from ompi_tpu_torch.runtime import ftevents

        ftevents.record("detect", jobid=job.jobid, rank=proc.rank,
                        lives=proc.lives, rung="selfheal", reason=reason)
        # rung 1 preamble is ALWAYS the notify propagation: survivors'
        # detectors learn the death now (pending ops toward the corpse
        # fail fast instead of stalling for the revive), and flip the
        # peer back alive when the revive lands (the revive listeners)
        _propagate_failure(launcher, job, proc, reason)
        limit = var_registry.get("errmgr_max_restarts")
        respawn = getattr(launcher, "respawn_proc", None)
        if proc.daemon_lost or proc.no_revive or respawn is None:
            why = ("its daemon died with its host" if proc.daemon_lost
                   else "a planned shrink retired it" if proc.no_revive
                   else f"{type(launcher).__name__} cannot revive ranks")
            self._escalate(launcher, job, proc,
                           f"rank {proc.rank} is not revivable ({why})")
            return
        # may RESET proc.restarts (min-uptime earned) — before the check
        delay = self._governor.pre_revive_delay(job, proc)
        if proc.restarts >= limit:
            self._escalate(launcher, job, proc,
                           f"rank {proc.rank} exhausted {limit} revive(s) "
                           f"within errmgr_min_uptime_s")
            return
        if delay:
            _log.verbose(1, "rank %d crash-looping; %.1fs backoff before "
                         "revive %d/%d", proc.rank, delay,
                         proc.restarts + 1, limit)
            _sleep(delay)
        t0 = trace_mod.begin() if trace_mod.active else 0
        notify(Severity.WARN, "rank-respawn",
               f"job {job.jobid} {reason}; selfheal revive "
               f"{proc.restarts + 1}/{limit}")
        if respawn(job, proc):
            trace_mod.count("errmgr_selfheal_revives_total")
            if t0 and trace_mod.active:
                # reap→revive half of the cycle; the revived rank's
                # runtime/init instant closes the rejoin half
                trace_mod.complete("errmgr", "selfheal_revive", t0,
                                   rank=proc.rank, restarts=proc.restarts,
                                   backoff=delay)
            return
        self._escalate(launcher, job, proc,
                       f"rank {proc.rank} revive failed to start")

    def daemon_ranks_failed(self, launcher: "LocalLauncher", job: Job,
                            procs: list) -> None:
        """Correlated daemon loss, batched.  Every victim is unrevivable
        (its daemon died with its host), so the whole batch takes the
        escalate-to-shrink rung in ONE decision: one propagation xcast,
        one FT event, one notifier event — not a per-rank storm of
        escalations during the exact window the tree is re-wiring."""
        if not procs:
            return
        from ompi_tpu_torch.mpi import trace as trace_mod
        from ompi_tpu_torch.runtime import ftevents
        from ompi_tpu_torch.runtime.notifier import Severity, notify

        ranks = [p.rank for p in procs]
        reason = (f"{len(ranks)} rank(s) lost with their daemon(s): "
                  f"{_rank_span(ranks)}")
        ftevents.record("detect", jobid=job.jobid, rank=ranks[0],
                        rung="selfheal", reason=reason, count=len(ranks))
        _propagate_failure_batch(launcher, job, procs, reason)
        trace_mod.count("errmgr_selfheal_escalations_total")
        # victims are already ABORTED, so the carrier scan naturally
        # excludes the whole batch
        carriers = [p for p in job.procs if p.state
                    in (ProcState.RUNNING, ProcState.TERMINATED)]
        can_shrink = (bool(carriers)
                      and (getattr(job, "pmix_server", None)
                           or getattr(launcher, "server", None))
                      is not None)
        why = (f"{len(ranks)} rank(s) are not revivable (their daemon "
               f"died with its host)")
        ftevents.record("escalate", jobid=job.jobid, rank=ranks[0],
                        to="shrink" if can_shrink else "abort", why=why,
                        count=len(ranks))
        if trace_mod.active:
            trace_mod.instant("errmgr", "selfheal_escalate", rank=-1,
                              to="shrink" if can_shrink else "abort",
                              count=len(ranks))
        if can_shrink:
            notify(Severity.ERROR, "selfheal-escalate",
                   f"job {job.jobid}: {why}; degrading to shrink — "
                   f"survivors continue without ranks {_rank_span(ranks)}")
            return
        notify(Severity.CRITICAL, "selfheal-escalate",
               f"job {job.jobid}: {why} and no shrinkable survivors; "
               f"aborting")
        if job.aborted_proc is None:
            job.aborted_proc = procs[0]
            job.abort_reason = f"{reason}; selfheal ladder exhausted"
        launcher.kill_job(job, exclude=procs[0])

    def _escalate(self, launcher, job: Job, proc: Proc, why: str) -> None:
        """The revive arm is out — degrade to the notify/shrink rung (the
        propagated death stands, the job continues smaller) whenever any
        other rank can still carry the job; abort only when shrink is
        impossible (every other rank also failed, or there is no control
        plane to propagate through)."""
        from ompi_tpu_torch.mpi import trace as trace_mod
        from ompi_tpu_torch.runtime import ftevents
        from ompi_tpu_torch.runtime.notifier import Severity, notify

        trace_mod.count("errmgr_selfheal_escalations_total")
        carriers = [p for p in job.procs if p is not proc and p.state
                    in (ProcState.RUNNING, ProcState.TERMINATED)]
        can_shrink = (bool(carriers)
                      and (getattr(job, "pmix_server", None)
                           or getattr(launcher, "server", None))
                      is not None)
        ftevents.record("escalate", jobid=job.jobid, rank=proc.rank,
                        lives=proc.lives,
                        to="shrink" if can_shrink else "abort", why=why)
        if trace_mod.active:
            trace_mod.instant("errmgr", "selfheal_escalate", rank=proc.rank,
                              to="shrink" if can_shrink else "abort")
        if can_shrink:
            notify(Severity.ERROR, "selfheal-escalate",
                   f"job {job.jobid}: {why}; degrading to shrink — "
                   f"survivors continue without rank {proc.rank}")
            return
        notify(Severity.CRITICAL, "selfheal-escalate",
               f"job {job.jobid}: {why} and no shrinkable survivors; "
               f"aborting")
        if job.aborted_proc is None:
            job.aborted_proc = proc
            job.abort_reason = (
                f"rank {proc.rank} {proc.state.value} after "
                f"{proc.restarts} revive(s); selfheal ladder exhausted "
                f"(exit code {proc.exit_code})")
        launcher.kill_job(job, exclude=proc)
