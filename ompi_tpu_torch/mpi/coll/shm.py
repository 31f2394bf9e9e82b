"""coll/shm — single-copy on-node collectives over a shared-memory arena
(the port's copy of the JAX package's ``mpi/coll/shm.py``).

≈ ompi/mca/coll/sm (and the HiCCL intra/inter decomposition from
PAPERS.md): every other component moves collective payloads as
2(p-1)-ish framed point-to-point messages through the PML matching
engine — header encode/decode, matching, and a scheduler wakeup per
hop, the measured ~58 µs/hop floor compounding linearly in p.  Ranks
that share a host do not need any of that: this component maps ONE
per-communicator arena (built on ``core.shmseg``, the same framework
the btl/shm rings ride) and turns barrier/bcast/reduce/allreduce/
allgather into single-copy fan-in/fan-out through it — zero PML
frames, zero matching, zero per-hop headers.

Arena layout (one file in ``shmseg.backing_dir()``, unlinked right
after the attach agreement so crash cleanup is free)::

    [ arrive u64 ×p (cacheline-padded) | depart u64 ×p (padded) ]
    [ desc 128B ×p ]  [ slot ×(p+1) ]          # slot p = result slot

``arrive[r]``/``depart[r]`` are **monotonic sequence counters** with a
single writer each (rank r), read by everyone — the sequence-numbered
generalisation of a sense-reversing barrier (a monotonic seq never
needs its sense flipped, and one pair of counters serialises every
collective kind on the communicator).  All counter accesses go through
``memoryview.cast("Q")`` so each is one native aligned 8-byte memory
op — the same store-ordering discipline (x86 TSO) the btl/shm ring
counters use, and the same reason ``struct.pack_into`` must not be
used here.

Data moves by **one copy per side**: writers publish straight into
their slot (``np.copyto`` walks strided sources directly into the
mapped segment — the PR-1 convertor-plan idea with numpy as the run
engine, no staging buffer), readers copy straight out; the fold rank
reduces *views of the mapped slots* in rank order without copying them
at all.  Payloads larger than a slot pipeline through the slot halves
(double-buffered: ranks publish segment k+1 while the fold rank is
still folding segment k — the ``allreduce_segmented_ring`` overlap
idea, fan-in form).

Dispatch ladder per collective:

- all ranks on one host → the flat arena;
- mixed hosts → hierarchical composition (HiCCL-style): the cached
  ``split_type(COMM_TYPE_SHARED)`` node communicator runs the intra
  phases through its arena, the cached leader communicator runs the
  inter phase through coll/host's tuned algorithms;
- fall back to coll/host per-collective when the op is non-commutative,
  the payload exceeds ``coll_shm_arena_size``, an explicit
  ``coll_host_*_algorithm``/rules-file directive names a host
  algorithm (user tuning outranks the shortcut), or no usable shm
  backing dir exists.

For bcast only the root knows the payload, so the root *communicates*
its arena-vs-host verdict through the descriptor round — every rank
takes the same branch without a pre-exchange.

The trace plane's sites are the JAX package's: the ``coll_shm_*_total``
counters (fan-in, fan-out, fallback, native waits, publishes and folds,
dead writers), a ``decision:<coll>`` instant for every fallback to
coll/host, the ``shm_setup`` span, the ``coll_arena_wait_ns``
histogram, the flight recorder's ``wait`` edge naming the rank a wait
outlived a park slice on, and the stuck watchdog (``coll_stuck_timeout``:
a ``stuck`` record, ``coll_stuck_events_total`` and an immediate metrics
push).  ``arena_states`` gives the hang doctor every live arena's
arrive/depart counters.

What the port does in place of a plane it has not ported yet, fault
tolerance (ROADMAP.md Queue 1 item 6.10): the coll epoch every cached
artifact is stamped with is the constant 0 (``_coll_epoch``), since no
member can be revived yet; the stale-state check that compares a cached
state's epoch with the communicator's, and the arena wait's epoch fence
(``StaleCollEpoch``), stay in the code for that item to drive.  An arena
wait still fails fast when the expected writer's process is gone (the
shm BTL's pid probe) and at ``coll_shm_timeout``.

The persistent collectives' bound plans (``mpi/coll/persistent.py``) pin
a ``PersistentSlots`` segment of their own (``make_persistent_slots``),
parity double-buffered; ``decide_allreduce_algo`` is their fold strategy.
Left out with fault tolerance (item 6.10): the eager recompile of a
communicator's stale bound plans when a revived member rejoins.
"""

from __future__ import annotations

import ctypes
import os
import time
import uuid
import weakref
from typing import Optional

import numpy as np

from ompi_tpu_torch import _native
from ompi_tpu_torch.core import output, shmseg
from ompi_tpu_torch.core.config import VarType, register_var, var_registry
from ompi_tpu_torch.core.mca import Component
from ompi_tpu_torch.mpi import op as op_mod
from ompi_tpu_torch.mpi import trace as trace_mod
from ompi_tpu_torch.mpi.coll import base, coll_framework, rules
from ompi_tpu_torch.mpi.constants import (
    COMM_TYPE_SHARED, ERR_PROC_FAILED, UNDEFINED, MPIException,
)
from ompi_tpu_torch.mpi.op import Op

__all__ = ["ShmColl", "Arena", "StaleCollEpoch", "decide_allreduce_algo",
           "PersistentSlots", "make_persistent_slots"]

_log = output.get_stream("coll")

_CACHELINE = 64
_DESC = 128                     # per-rank op-descriptor bytes
_DESC_DATA, _DESC_HOST = 1, 2   # descriptor verdicts (bcast root decides)
_MAX_DIMS = 8                   # descriptor shape capacity
_TOKEN = np.zeros(0, np.uint8)  # gate payload for the arena-less intra path


def _arena_dtype_ok(dtype: np.dtype) -> bool:
    """Raw-byte publishable: fixed-size, no python object indirection."""
    return not dtype.hasobject and dtype.itemsize > 0


def _coll_epoch(comm) -> int:
    """The communicator's collective epoch: the monotone generation every
    cached collective artifact is fenced on.  Constant 0 until fault
    tolerance (ROADMAP.md Queue 1 item 6.10) can revive a member."""
    return 0


class StaleCollEpoch(MPIException):
    """A cached collective artifact (arena, hierarchy split) was built at
    an older coll epoch than the communicator's current one — a member
    was revived since, and its new life never mapped the old segment (the
    name was unlinked at build).  Raised out of arena waits; carries
    ``ERR_PROC_FAILED``.  Never raised while the epoch is constant (no
    revive exists before ROADMAP.md Queue 1 item 6.10)."""

    def __init__(self, msg: str) -> None:
        super().__init__(msg, error_class=ERR_PROC_FAILED)


#: live arenas of this process — the hang doctor's capture walks them
#: for the arrive/depart counter snapshots (the "who hasn't arrived"
#: signal); weak so a closed/garbage-collected arena just disappears
_live_arenas: "weakref.WeakSet" = weakref.WeakSet()


def arena_states() -> list[dict]:
    """Each live arena's counter block as a plain dict — what a doctor
    capture embeds.  Best-effort: a concurrently-detached segment
    contributes nothing rather than raising on a reader thread."""
    out = []
    for a in list(_live_arenas):
        try:
            f = a._flags
            out.append({
                "size": a.size,
                "rank": a.rank,
                "world": list(a.world) if a.world is not None else None,
                "arrive": [int(f[r * 8]) for r in range(a.size)],
                "depart": [int(f[(a.size + r) * 8])
                           for r in range(a.size)],
            })
        except (ValueError, IndexError, OSError):
            continue
    return out


# ---------------------------------------------------------------------------
# the native executor (_native/arena.c via ctypes — every call runs with
# the GIL RELEASED, which is the entire point: a rank parked in a flag
# wait or moving a 64 KiB slot no longer serializes the other in-process
# threads.  Python keeps every policy decision: the epoch fence, the
# writer probe and the deadline run between bounded native slices)
# ---------------------------------------------------------------------------

#: spin burst inside one native slice (shared across the native data
#: plane — see _native.PARK_SPINS for the small-host rationale and the
#: measured spin sweep)
_NATIVE_SPINS = _native.PARK_SPINS
#: one park slice: the cadence at which the Python checks (epoch
#: fence, writer pid probe, deadline) re-run
_NATIVE_SLICE_NS = 2_000_000
#: below this a ctypes call costs more than the GIL-held numpy copy
_NATIVE_PUBLISH_MIN = 512

#: a wait this old records its flight-recorder wait-for edge (one park
#: slice: younger waits are normal publish races, and an entry-time
#: edge could name a laggard that long since arrived)
_WAIT_REC_AFTER_S = _NATIVE_SLICE_NS / 1e9

#: physical parallelism available to cooperative folds (tests patch it)
_NCORES = os.cpu_count() or 1


def _exec():
    """The loaded native arena executor, or None (python data plane).
    The var read is per-call by design: benchmarks flip
    ``coll_shm_native`` mid-world for shared-fate comparisons."""
    if not var_registry.get("coll_shm_native"):
        return None
    return _native.arena()


#: segment-base address helper, shared with the btl ring park
_addr_of = _native.addr_of


def _strided_desc(arr: np.ndarray) -> Optional[tuple[int, int, int]]:
    """Describe ``arr``'s memory as ONE strided progression in C order
    — ``(nblocks, bl, stride)``, the convertor plan ABI's vector-class
    shape — or None when the layout needs a full run walk (the numpy
    path handles those)."""
    if arr.nbytes == 0:
        return None
    if arr.flags.c_contiguous:
        return 1, arr.nbytes, arr.nbytes
    dims = [(s, st) for s, st in zip(arr.shape, arr.strides) if s != 1]
    if not dims:
        return 1, arr.itemsize, arr.itemsize
    bl = arr.itemsize
    while dims and dims[-1][1] == bl:     # collapse the contiguous tail
        bl *= dims[-1][0]
        dims.pop()
    if not dims:
        return 1, bl, bl
    if len(dims) == 1 and dims[0][1] > 0:
        return dims[0][0], bl, dims[0][1]
    return None


#: (dtype.kind, itemsize) → arena.c dtype code (native-endian only)
_FOLD_DTYPE_CODES = {
    ("i", 1): 0, ("i", 2): 1, ("i", 4): 2, ("i", 8): 3,
    ("u", 1): 4, ("u", 2): 5, ("u", 4): 6, ("u", 8): 7,
    ("f", 4): 8, ("f", 8): 9,
}

#: the exact builtin Op OBJECTS the native fold reproduces bit-for-bit
#: (identity keyed: a user create_op named "sum" must NOT match)
_NATIVE_OP_CODES = {op_mod.SUM: 0, op_mod.PROD: 1,
                    op_mod.MIN: 2, op_mod.MAX: 3}


def _fold_code(dtype: np.dtype) -> Optional[int]:
    if not dtype.isnative:
        return None
    return _FOLD_DTYPE_CODES.get((dtype.kind, dtype.itemsize))


def _native_fold(ex, dst_addr: int, src_addrs: list, nelems: int,
                 dtype_code: int, op_code: int) -> None:
    """One GIL-released rank-ordered elementwise fold; raises on a
    contract violation (caller pre-validated the codes)."""
    srcs = (ctypes.c_void_p * len(src_addrs))(*src_addrs)
    rc = ex.ompi_tpu_arena_fold(dst_addr, ctypes.addressof(srcs),
                                len(src_addrs), nelems, dtype_code,
                                op_code)
    if rc != 0:
        raise MPIException(
            f"coll/shm: native fold rejected pre-validated plan "
            f"(dtype code {dtype_code}, op code {op_code})")
    trace_mod.count("coll_shm_native_folds_total")


def decide_allreduce_algo(comm, nbytes: int) -> tuple[str, str]:
    """The arena-allreduce fold strategy, resolved by the standard
    selection ladder (forced var > rules file > fixed crossover):

    - ``root_fold``         — one rank folds every slot (the historic
      path; optimal while the fold is cheaper than a second rendezvous)
    - ``segment_parallel``  — every rank reduce-scatters its 1/p
      segment across all slots, then allgathers through the result
      slot: O(n) fold work per rank instead of O(p·n) on one rank.
      The AGGREGATE fold work is unchanged (p·n reads either way), so
      spreading it only pays when the ranks can actually fold
      concurrently — the fixed crossover therefore requires BOTH a
      payload above ``coll_shm_segpar_min`` AND cores >= ranks (a 1-2
      core box has no spare core to fold on).  A rules-file hit or the
      forced var overrides the core gate: the operator knows their box.

    Returns ``(algorithm, source)``.
    """
    forced = str(var_registry.get("coll_shm_allreduce_algorithm") or "")
    path = str(var_registry.get("coll_host_dynamic_rules") or "")
    alg, src = rules.decide(rules.SHM_ALLREDUCE, comm.size, nbytes,
                            forced=forced, path=path,
                            valid=rules.SHM_ALLREDUCE_ALGORITHMS)
    if alg is None:
        crossover = int(var_registry.get("coll_shm_segpar_min") or 0)
        alg = ("segment_parallel"
               if crossover and nbytes >= crossover
               and 2 <= comm.size <= _NCORES
               else "root_fold")
        src = (f"fixed crossover (coll_shm_segpar_min={crossover}, "
               f"{comm.size} ranks on {_NCORES} cores)")
    return alg, src


_grace_warned = False


def _probe_grace(timeout: float) -> float:
    """Validated writer-probe grace: must sit strictly inside the
    coll_shm_timeout fallback deadline (a grace at or past the timeout
    would disable the probe exactly when it matters) — clamped to half
    the timeout with a one-time warning, the same hygiene rule the
    heartbeat/gossip windows apply."""
    global _grace_warned
    grace = float(var_registry.get("coll_shm_probe_grace") or 0)
    if grace <= 0:
        return 0.0
    if grace >= timeout:
        if not _grace_warned:
            _grace_warned = True
            _log.verbose(0, "coll/shm: probe grace %.1fs >= timeout "
                         "%.1fs; clamping to %.1fs", grace, timeout,
                         timeout / 2)
        grace = timeout / 2
    return grace


def _desc_dtype_ok(dtype: np.dtype) -> bool:
    """Reconstructible from the 32-byte descriptor field: extension
    dtypes (bfloat16 & co.) stringify to a raw void ('<V2') that would
    NOT round-trip — bcast must ship those via coll/host, whose wire
    headers carry the real dtype."""
    try:
        return len(dtype.str) <= 32 and np.dtype(dtype.str) == dtype
    except Exception:  # noqa: BLE001 — unparseable str: not shippable
        return False


class Arena:
    """One mapped per-communicator arena; ranks are arena slot indices.

    Every wait is ``flags[i] >= v`` on monotonic counters, so the
    protocol is ABA-free by construction; each collective advances
    every rank's arrive (and depart, where used) by the same amount,
    keeping the counters equal at op boundaries — the invariant all
    thresholds are computed from.
    """

    def __init__(self, seg: shmseg.SharedSegment, size: int, rank: int,
                 slot_bytes: int, world=None, pml=None,
                 fence=None) -> None:
        self.seg = seg
        self.size = size
        self.rank = rank
        self.slot_bytes = slot_bytes
        # coll-epoch fence: (epoch this arena was built/bound at, weakref
        # to the comm the epoch is scoped to — the PARENT comm for hier
        # node arenas, so a revive anywhere in the hierarchy breaks the
        # wait).  None ⇒ unfenced (bare test arenas).
        self._fence = fence
        # this rank's WORLD rank (the flight recorder / doctor key; the
        # arena index is node-local)
        self._wr = (pml.rank if pml is not None
                    else (list(world)[rank] if world is not None
                          else rank))
        # arena rank → world rank, plus the pml whose btl owns the
        # pid-liveness probe: a writer dying between flag stores leaves
        # peers nothing to observe but its pid, so the wait loop probes
        # the expected writer after a short grace instead of spinning out
        # the full coll_shm_timeout
        self.world = list(world) if world is not None else None
        self._pml = pml
        self.half = (slot_bytes // 2) & ~7
        self._flags = seg.buf[:2 * size * _CACHELINE].cast("Q")
        self._desc_base = 2 * size * _CACHELINE
        self._slot_base = self._desc_base + size * _DESC
        self._arr = 0   # my arrive counter (mirror of the mapped value)
        self._dep = 0   # my depart counter
        # segment base address for the native executor (flag word i of
        # the mapped u64 view is base + i*8, slot offsets are relative
        # to the same base); None ⇒ python data plane only
        self._base_addr = _addr_of(seg.buf)
        _live_arenas.add(self)   # doctor capture reads arrive/depart

    @staticmethod
    def nbytes_for(size: int, slot_bytes: int) -> int:
        return (2 * size * _CACHELINE + size * _DESC
                + (size + 1) * slot_bytes)

    def close(self) -> None:
        try:
            self._flags.release()
        except (BufferError, ValueError):
            pass
        self.seg.detach()

    # -- flags -------------------------------------------------------------

    def _set_arrive(self, v: int) -> None:
        self._flags[self.rank * 8] = v
        self._arr = v
        self._wake(self.rank * 8)

    def _set_depart(self, v: int) -> None:
        self._flags[(self.size + self.rank) * 8] = v
        self._dep = v
        self._wake((self.size + self.rank) * 8)

    def _wake(self, idx: int) -> None:
        """Futex-wake any native waiter parked on flag ``idx`` — every
        python-side flag store pairs with one so the futex park wakes
        at store time, not at its bounded-timeout backstop.  (Native
        publishes fuse the wake into the same GIL-released call.)"""
        if self._base_addr is None:
            return
        ex = _exec()
        if ex is not None:
            ex.ompi_tpu_arena_wake(self._base_addr, idx)

    # on a 1-2 core host every spin iteration steals the flag-writer's
    # quantum (the btl/shm poller disables its spin window there for the
    # same reason) — escalate to micro-sleeps almost immediately
    _SPIN_MASK = 0xFF if (os.cpu_count() or 1) > 2 else 0xF

    def _wait(self, idx: int, v: int, comm) -> None:
        f = self._flags
        if f[idx] >= v:
            return
        # the straggler signal: every ns burnt in here is this rank
        # waiting on a PEER's flag store — recorded into the arena-wait
        # histogram on completed waits (an already-satisfied flag never
        # reaches this point, so the fast path stays one compare).  The
        # slow paths below additionally record a flight-recorder
        # ``wait`` event naming the world rank whose store the wait is
        # parked on (the hang doctor's wait-for edge) — AFTER the wait
        # has survived ~one park slice, so transient publish races
        # cannot fabricate stale mutual edges (a fake deadlock cycle)
        _h_t0 = time.monotonic_ns() if trace_mod.hist_active else 0
        ex = _exec() if self._base_addr is not None else None
        if ex is not None:
            self._park_native(ex, v, comm, idx=idx)
        else:
            self._wait_py(idx, v, comm)
        if _h_t0 and trace_mod.hist_active:
            trace_mod.record_hist("coll_arena_wait_ns",
                                  time.monotonic_ns() - _h_t0)

    def _wait_py(self, idx: int, v: int, comm) -> None:
        """The pure-python park (native executor off/unavailable)."""
        f = self._flags
        timeout = float(var_registry.get("coll_shm_timeout") or 60)
        grace = _probe_grace(timeout) if (self.world is not None
                                          and self._pml is not None) else 0.0
        now = time.monotonic()
        deadline = now + timeout
        probe_at = now + grace if grace > 0 else None
        stuck_at = self._stuck_at(now)
        rec_at: Optional[float] = now + _WAIT_REC_AFTER_S
        spins = 0
        delay = 2e-5
        while f[idx] < v:
            spins += 1
            if spins & self._SPIN_MASK:
                time.sleep(0)       # yield (in-process ranks share the GIL)
                continue
            time.sleep(delay)       # escalate once the burst window passed
            delay = min(delay * 2, 1e-3)
            if rec_at is not None and time.monotonic() > rec_at:
                rec_at = self._record_wait(comm, idx // 8,
                                           (idx // 8) % self.size, v)
            if comm is not None:
                self._check_ft(comm)
            if probe_at is not None and time.monotonic() > probe_at:
                # the probe itself is rate-limited (shared btl cache), so
                # asking every escalated iteration stays cheap
                self._probe_writer((idx // 8) % self.size, grace, timeout)
            if stuck_at is not None and time.monotonic() > stuck_at:
                stuck_at = self._report_stuck(
                    comm, time.monotonic() - (deadline - timeout),
                    (idx // 8) % self.size)
            if time.monotonic() > deadline:
                raise MPIException(
                    f"coll/shm: arena wait (flag {idx // 8}, want {v}, "
                    f"have {int(f[idx])}) stuck for {timeout:.0f}s on "
                    f"{getattr(comm, 'name', '?')} — peer dead or "
                    f"collective-order mismatch (coll_shm_timeout)")

    def _park_native(self, ex, v: int, comm, idx: Optional[int] = None,
                     all_base: Optional[int] = None) -> None:
        """GIL-released park: bounded native slices (spin burst +
        escalating naps in C, no interpreter involvement) with the
        python loop's checks re-run between slices — the epoch fence,
        the dead-writer pid probe after the grace, and the
        coll_shm_timeout deadline, all at the same ~slice cadence the
        escalated python loop reached them."""
        trace_mod.count("coll_shm_native_waits_total")
        timeout = float(var_registry.get("coll_shm_timeout") or 60)
        grace = _probe_grace(timeout) if (self.world is not None
                                          and self._pml is not None) else 0.0
        now = time.monotonic()
        deadline = now + timeout
        probe_at = now + grace if grace > 0 else None
        stuck_at = self._stuck_at(now)
        recorded = False
        base = self._base_addr
        while True:
            if all_base is None:
                done = ex.ompi_tpu_arena_wait(
                    base, idx, v, _NATIVE_SPINS, _NATIVE_SLICE_NS)
            else:
                done = ex.ompi_tpu_arena_wait_all(
                    base, all_base, 8, self.size, v, _NATIVE_SPINS,
                    _NATIVE_SLICE_NS)
            if done:
                return
            if comm is not None:
                self._check_ft(comm)
            lag = self._laggard(v, idx=idx, all_base=all_base)
            if not recorded:
                # the wait outlived a whole park slice: record the edge
                # with the laggard as of NOW (not wait entry — the
                # entry-time laggard may have long since arrived)
                recorded = True
                flag = (idx if all_base is None
                        else all_base + lag * 8) // 8
                self._record_wait(comm, flag, lag % self.size, v)
            if probe_at is not None and time.monotonic() > probe_at:
                self._probe_writer(lag % self.size, grace, timeout)
            if stuck_at is not None and time.monotonic() > stuck_at:
                stuck_at = self._report_stuck(
                    comm, time.monotonic() - (deadline - timeout),
                    lag % self.size)
            if time.monotonic() > deadline:
                f = self._flags
                flag = idx if all_base is None else all_base + lag * 8
                raise MPIException(
                    f"coll/shm: arena wait (flag {flag // 8}, want {v}, "
                    f"have {int(f[flag])}) stuck for {timeout:.0f}s on "
                    f"{getattr(comm, 'name', '?')} — peer dead or "
                    f"collective-order mismatch (coll_shm_timeout)")

    def _laggard(self, v: int, idx: Optional[int] = None,
                 all_base: Optional[int] = None) -> int:
        """Arena rank whose flag a stalled wait is parked on (the pid
        the probe should ask about)."""
        if all_base is None:
            return (idx // 8) % self.size
        f = self._flags
        for r in range(self.size):
            if f[all_base + r * 8] < v:
                return r
        return 0

    def _record_wait(self, comm, flag: int, lag: int, v: int) -> None:
        """One flight-recorder ``wait`` edge naming the current laggard
        (called once per wait, after it survived ~a park slice).
        Returns None — the caller's record-once sentinel."""
        trace_mod.coll_event(
            self._wr, comm.cid if comm is not None else -1, "wait",
            {"flag": flag, "want": v,
             "on": self.world[lag] if self.world is not None else lag})
        return None

    def _stuck_at(self, now: float) -> Optional[float]:
        """When this wait should push a stuck event up the uplink
        (None = watchdog disabled via coll_stuck_timeout 0)."""
        stuck = float(var_registry.get("coll_stuck_timeout") or 0)
        return now + stuck if stuck > 0 else None

    def _report_stuck(self, comm, waited_s: float,
                      lag: int) -> Optional[float]:
        """The watchdog fired: record a stuck event naming the laggard
        and force a metrics push (once per wait — returns the cleared
        re-arm sentinel)."""
        trace_mod.coll_stuck(
            self._wr, comm.cid if comm is not None else -1, waited_s,
            self.world[lag] if self.world is not None else lag)
        return None

    def _wait_many(self, all_base: int, v: int, comm) -> None:
        """Wait flag[all_base + r*8] >= v for every arena rank — ONE
        native call when the executor is live, the per-flag python
        loop otherwise."""
        f = self._flags
        r0 = 0
        while r0 < self.size and f[all_base + r0 * 8] >= v:
            r0 += 1
        if r0 >= self.size:
            return
        ex = _exec() if self._base_addr is not None else None
        if ex is None:
            for r in range(r0, self.size):
                self._wait(all_base + r * 8, v, comm)
            return
        _h_t0 = time.monotonic_ns() if trace_mod.hist_active else 0
        self._park_native(ex, v, comm, all_base=all_base)
        if _h_t0 and trace_mod.hist_active:
            trace_mod.record_hist("coll_arena_wait_ns",
                                  time.monotonic_ns() - _h_t0)

    def _probe_writer(self, writer: int, grace: float,
                      timeout: float) -> None:
        """The expected writer's flag has not moved past the grace: ask
        the btl pid-liveness probe (cache shared with the send path —
        one kill(2) per peer per 50ms across all layers) whether the pid
        still exists, and fail the collective in ~the grace window
        instead of the full coll_shm_timeout when it does not."""
        if writer == self.rank:
            return
        w = self.world[writer]
        ep = getattr(self._pml, "endpoint", None)
        if ep is None or ep.peer_alive(w) is not False:
            return
        trace_mod.count("coll_shm_writer_dead_total")
        raise MPIException(
            f"coll/shm: rank {w} (arena writer) died mid-collective — "
            f"pid probe after {grace:.1f}s grace, not the "
            f"{timeout:.0f}s coll_shm_timeout", error_class=ERR_PROC_FAILED)

    def _check_ft(self, comm) -> None:
        """The coll-epoch fence, run between wait slices: a wait parked
        against a peer that was revived since this arena was built can
        never be satisfied (the new life never mapped the unlinked
        segment), so it raises StaleCollEpoch instead of spinning out
        the timeout.  (The revocation and detector-death checks of the
        JAX package's wait come with fault tolerance, ROADMAP.md Queue 1
        item 6.10.)"""
        fence = self._fence
        if fence is not None:
            epoch, cref = fence
            fc = cref()
            if fc is not None and _coll_epoch(fc) > epoch:
                raise StaleCollEpoch(
                    f"coll/shm: arena wait on "
                    f"{getattr(comm, 'name', '?')} fenced — a member "
                    f"was revived since the arena was built (coll "
                    f"epoch {_coll_epoch(fc)} > built {epoch})")

    def _wait_arrive(self, r: int, v: int, comm) -> None:
        self._wait(r * 8, v, comm)

    def _wait_depart(self, r: int, v: int, comm) -> None:
        self._wait((self.size + r) * 8, v, comm)

    def _wait_all_arrive(self, v: int, comm) -> None:
        self._wait_many(0, v, comm)

    def _wait_all_depart(self, v: int, comm) -> None:
        self._wait_many(self.size * 8, v, comm)

    # -- slots / descriptors ------------------------------------------------

    def _slot_off(self, i: int) -> int:
        return self._slot_base + i * self.slot_bytes

    def _slot(self, i: int) -> memoryview:
        off = self._slot_off(i)
        return self.seg.buf[off:off + self.slot_bytes]

    # -- native data movement ------------------------------------------------

    def _publish_native(self, dst_off: int, arr: np.ndarray, fidx: int,
                        fval: int) -> bool:
        """Slot copy + release flag store fused into ONE GIL-released
        call (strided sources ride the convertor plan ABI's vector
        shape).  False ⇒ the caller runs the numpy copy + python flag
        store — exotic layouts and sub-threshold payloads, where the
        ctypes call would cost more than it frees."""
        if arr.nbytes < _NATIVE_PUBLISH_MIN or self._base_addr is None:
            return False
        ex = _exec()
        if ex is None:
            return False
        desc = _strided_desc(arr)
        if desc is None:
            return False
        nblocks, bl, stride = desc
        dst = self._base_addr + dst_off
        if nblocks == 1:
            ex.ompi_tpu_arena_publish(dst, arr.ctypes.data, arr.nbytes,
                                      self._base_addr, fidx, fval)
        else:
            ex.ompi_tpu_arena_publish_strided(
                dst, arr.ctypes.data, nblocks, bl, stride,
                self._base_addr, fidx, fval)
        trace_mod.count("coll_shm_native_publishes_total")
        return True

    def _publish_arrive(self, dst_off: int, arr: np.ndarray,
                        v: int) -> bool:
        """Native publish stamped with MY arrive counter (mirror kept
        in sync); False ⇒ caller copies + ``_set_arrive`` itself."""
        if self._publish_native(dst_off, arr, self.rank * 8, v):
            self._arr = v
            return True
        return False

    def _copy_out_native(self, src_off: int, dst: np.ndarray) -> bool:
        """Mapped slot → caller buffer as one GIL-released copy (the
        drain-side mirror of ``_publish_native``, no flag store)."""
        if (dst.nbytes < _NATIVE_PUBLISH_MIN or self._base_addr is None
                or not dst.flags.c_contiguous):
            return False
        ex = _exec()
        if ex is None:
            return False
        ex.ompi_tpu_arena_publish(dst.ctypes.data,
                                  self._base_addr + src_off, dst.nbytes,
                                  None, 0, 0)
        return True

    def _write_desc(self, code: int, arr: Optional[np.ndarray],
                    nseg: int) -> None:
        off = self._desc_base + self.rank * _DESC
        head = np.zeros(12, np.uint64)
        head[0] = code
        dts = b""
        if arr is not None:
            head[1] = arr.nbytes
            head[2] = nseg
            head[3] = arr.ndim
            head[4:4 + arr.ndim] = np.array(arr.shape, np.uint64)
            dts = arr.dtype.str.encode()
        self.seg.buf[off:off + 96] = head.tobytes()
        self.seg.buf[off + 96:off + _DESC] = dts.ljust(32, b"\0")

    def _read_desc(self, r: int):
        off = self._desc_base + r * _DESC
        head = np.frombuffer(self.seg.buf[off:off + 96], np.uint64)
        code, nbytes, nseg, ndim = (int(head[0]), int(head[1]),
                                    int(head[2]), int(head[3]))
        shape = tuple(int(x) for x in head[4:4 + ndim])
        raw = bytes(self.seg.buf[off + 96:off + _DESC]).rstrip(b"\0")
        dtype = np.dtype(raw.decode()) if raw else np.dtype(np.uint8)
        return code, nbytes, nseg, shape, dtype

    @staticmethod
    def _copy_in(dst_mv: memoryview, arr: np.ndarray) -> None:
        """THE send-side copy: user buffer → mapped slot.  Strided
        sources walk directly (numpy is the run engine — no staging)."""
        if arr.nbytes == 0:
            return
        dst = np.frombuffer(dst_mv, dtype=arr.dtype, count=arr.size)
        np.copyto(dst.reshape(arr.shape), arr, casting="no")

    # -- barrier -------------------------------------------------------------

    def barrier(self, comm) -> None:
        s = self._arr + 1
        self._set_arrive(s)
        self._wait_all_arrive(s, comm)

    def gate_in(self, comm, nroot: int = 0) -> None:
        """Fan-in half of a hierarchical barrier: everyone signals
        arrival, only the gate root waits for all of them."""
        s = self._arr + 1
        self._set_arrive(s)
        if self.rank == nroot:
            self._wait_all_arrive(s, comm)

    def gate_out(self, comm, nroot: int = 0) -> None:
        """Release half: the gate root signals, everyone else waits."""
        s = self._dep + 1
        if self.rank == nroot:
            self._set_depart(s)
        else:
            self._wait_depart(nroot, s, comm)
            self._set_depart(s)

    # -- bcast ---------------------------------------------------------------

    def bcast(self, comm, nroot: int, buf, cap: int) -> Optional[np.ndarray]:
        """Single-copy fan-out, pipelined through the root slot's halves.
        Returns None on every rank when the root judged the payload
        host-bound (oversized/unsupported) — the verdict travels in the
        descriptor, so non-roots (who cannot see the payload) take the
        same branch with no extra exchange."""
        if self.rank == nroot:
            arr = np.asarray(buf)
            ok = (_arena_dtype_ok(arr.dtype) and arr.ndim <= _MAX_DIMS
                  and _desc_dtype_ok(arr.dtype) and arr.nbytes <= cap)
            nseg = max(1, -(-arr.nbytes // self.half)) if ok else 1
            self._write_desc(_DESC_DATA if ok else _DESC_HOST,
                             arr if ok else None, nseg)
            s0 = self._arr
            if not ok:
                self._set_arrive(s0 + 1)
                self._wait_all_arrive(s0 + 1, comm)
                return None
            u8 = (arr if arr.flags.c_contiguous
                  else np.ascontiguousarray(arr)).reshape(-1).view(np.uint8)
            slot = self._slot(nroot)
            for k in range(nseg):
                if k >= 2:   # readers done with the previous half occupant
                    self._wait_all_arrive(s0 + k - 1, comm)
                lo = k * self.half
                hi = min(lo + self.half, arr.nbytes)
                hoff = (k % 2) * self.half
                if not self._publish_arrive(self._slot_off(nroot) + hoff,
                                            u8[lo:hi], s0 + k + 1):
                    slot[hoff:hoff + hi - lo] = u8[lo:hi].data
                    self._set_arrive(s0 + k + 1)
            self._wait_all_arrive(s0 + nseg, comm)
            return arr
        s0 = self._arr
        self._wait_arrive(nroot, s0 + 1, comm)
        code, nbytes, nseg, shape, dtype = self._read_desc(nroot)
        if code == _DESC_HOST:
            self._set_arrive(s0 + 1)
            return None
        out = np.empty(nbytes, np.uint8)
        slot = self._slot(nroot)
        for k in range(nseg):
            self._wait_arrive(nroot, s0 + k + 1, comm)
            lo = k * self.half
            hi = min(lo + self.half, nbytes)
            hoff = (k % 2) * self.half
            if not self._copy_out_native(self._slot_off(nroot) + hoff,
                                         out[lo:hi]):
                out[lo:hi] = np.frombuffer(slot[hoff:hoff + hi - lo],
                                           np.uint8)
            self._set_arrive(s0 + k + 1)
        return out.view(dtype).reshape(shape)

    # -- reduce / allreduce --------------------------------------------------

    def reduce(self, comm, nroot: int, arr: np.ndarray, op: Op,
               bcast_result: bool) -> Optional[np.ndarray]:
        """Rank-ordered fan-in at ``nroot`` folding *views of the mapped
        slots* (zero read copies), pipelined through slot halves;
        ``bcast_result`` adds the fan-out phase (allreduce).  The caller
        pre-validated op commutativity, dtype, and the arena cap — those
        checks use globally-agreed inputs, so every rank gets here (or
        not) together."""
        arr = np.asarray(arr)
        dtype, itemsize = arr.dtype, arr.dtype.itemsize
        n = arr.size
        seg_elems = max(1, self.half // itemsize)
        nseg = max(1, -(-n // seg_elems))
        s0a, s0d = self._arr, self._dep
        me = self.rank
        myslot = self._slot(me)
        res = self._slot(self.size)
        flat = None
        if nseg > 1:
            flat = (arr if arr.flags.c_contiguous
                    else np.ascontiguousarray(arr)).reshape(-1)

        # native fold eligibility, resolved once per op: builtin op
        # (identity match) + native-endian fixed width + a payload the
        # ctypes call amortizes over
        ex = _exec() if self._base_addr is not None else None
        dc = _fold_code(dtype) if ex is not None else None
        oc = _NATIVE_OP_CODES.get(op) if ex is not None else None
        nat_fold = (dc is not None and oc is not None
                    and arr.nbytes >= _NATIVE_PUBLISH_MIN)

        def seg_bounds(k: int):
            lo = k * seg_elems
            hi = min(lo + seg_elems, n)
            return lo, hi, (k % 2) * self.half

        def publish_my_seg(k: int, v: int) -> None:
            lo, hi, hoff = seg_bounds(k)
            src = arr if nseg == 1 else flat[lo:hi]
            if self._publish_arrive(self._slot_off(me) + hoff, src, v):
                return
            dst = myslot[hoff:hoff + (hi - lo) * itemsize]
            if nseg == 1:
                self._copy_in(dst, arr)   # strided sources walk directly
            else:
                np.copyto(np.frombuffer(dst, dtype, count=hi - lo),
                          flat[lo:hi], casting="no")
            self._set_arrive(v)

        if me == nroot:
            out = np.empty(n, dtype)
            for k in range(nseg):
                lo, hi, hoff = seg_bounds(k)
                publish_my_seg(k, s0a + k + 1)
                self._wait_all_arrive(s0a + k + 1, comm)
                if bcast_result and k >= 2:
                    # readers finished with this result half's previous
                    # occupant (segment k-2) — must precede the result
                    # write, which the native fold lands directly
                    self._wait_all_depart(s0d + k - 1, comm)
                count = hi - lo
                if nat_fold:
                    # rank-ordered fold straight over the mapped slots,
                    # GIL released — into the result slot (allreduce) or
                    # the root's output buffer
                    if bcast_result:
                        dst_addr = (self._base_addr
                                    + self._slot_off(self.size) + hoff)
                    else:
                        dst_addr = out.ctypes.data + lo * itemsize
                    _native_fold(
                        ex, dst_addr,
                        [self._base_addr + self._slot_off(i) + hoff
                         for i in range(self.size)], count, dc, oc)
                    if bcast_result:
                        # read the root's own copy back GIL-released
                        # too (same helper as every other drain site)
                        if not self._copy_out_native(
                                self._slot_off(self.size) + hoff,
                                out[lo:hi]):
                            out[lo:hi] = np.frombuffer(
                                res[hoff:hoff + count * itemsize],
                                dtype)
                else:
                    # fold straight from the mapped slots, in rank order
                    acc = np.frombuffer(self._slot(0)[hoff:], dtype,
                                        count=count)
                    for i in range(1, self.size):
                        acc = op.host(acc, np.frombuffer(
                            self._slot(i)[hoff:], dtype, count=count))
                    acc = np.asarray(acc)
                    out[lo:hi] = acc.reshape(-1)
                    if bcast_result:
                        np.copyto(np.frombuffer(res[hoff:], dtype,
                                                count=count), acc,
                                  casting="no")
                self._set_depart(s0d + k + 1)
            if bcast_result:
                self._wait_all_depart(s0d + nseg, comm)
            return out.reshape(arr.shape).astype(dtype, copy=False)
        # non-root: publish segments one ahead of the root's fold, and
        # (for allreduce) drain result segments one behind it
        out = np.empty(n, dtype) if bcast_result else None
        res_off = self._slot_off(self.size)
        for k in range(nseg):
            if not bcast_result and k >= 2:
                self._wait_depart(nroot, s0d + k - 1, comm)
            publish_my_seg(k, s0a + k + 1)
            if bcast_result and k >= 1:
                lo, hi, hoff = seg_bounds(k - 1)
                self._wait_depart(nroot, s0d + k, comm)
                if not self._copy_out_native(res_off + hoff, out[lo:hi]):
                    out[lo:hi] = np.frombuffer(res[hoff:], dtype,
                                               count=hi - lo)
                self._set_depart(s0d + k)
        self._wait_depart(nroot, s0d + nseg, comm)
        if bcast_result:
            lo, hi, hoff = seg_bounds(nseg - 1)
            if not self._copy_out_native(res_off + hoff, out[lo:hi]):
                out[lo:hi] = np.frombuffer(res[hoff:], dtype,
                                           count=hi - lo)
        self._set_depart(s0d + nseg)
        return out.reshape(arr.shape) if bcast_result else None

    # -- allgather -----------------------------------------------------------

    def allgather(self, comm, arr: np.ndarray) -> np.ndarray:
        """Everyone publishes a slot, everyone copies all slots; result
        indexed by arena rank.  Caller checked nbytes <= slot_bytes."""
        arr = np.asarray(arr)
        s0a, s0d = self._arr, self._dep
        if not self._publish_arrive(self._slot_off(self.rank), arr,
                                    s0a + 1):
            self._copy_in(self._slot(self.rank)[:max(arr.nbytes, 1)], arr)
            self._set_arrive(s0a + 1)
        self._wait_all_arrive(s0a + 1, comm)
        out = np.empty((self.size,) + arr.shape, arr.dtype)
        rows = out.reshape(self.size, -1)
        for i in range(self.size):
            if not self._copy_out_native(self._slot_off(i), rows[i]):
                src = np.frombuffer(self._slot(i), arr.dtype,
                                    count=arr.size)
                out[i] = src.reshape(arr.shape)
        self._set_depart(s0d + 1)
        self._wait_all_depart(s0d + 1, comm)
        return out

    # -- dense exchange ------------------------------------------------------
    #
    # alltoall/v, reduce_scatter and scan/exscan share ONE protocol
    # round: every rank publishes its whole payload into its own slot
    # (one copy), waits for all arrivals, then reads/folds exactly the
    # bytes addressed to it straight out of the mapped peer slots — the
    # p² small PML frames of the pairwise loops collapse into p slot
    # publishes plus per-rank strided reads, all through the same
    # arrive/depart counters (and the same FT fail-fast waits) the
    # fan-out collectives ride.

    def _publish_slot(self, comm, arr: np.ndarray, v: int) -> None:
        """Whole-payload publish into MY slot stamped arrive=v — the
        fused native publish when eligible, numpy copy + python flag
        store otherwise (the allgather discipline, factored out for the
        dense family)."""
        if not self._publish_arrive(self._slot_off(self.rank), arr, v):
            self._copy_in(self._slot(self.rank), arr)
            self._set_arrive(v)

    def _copy_blocks_native(self, dsts: list, srcs: list, lens: list,
                            fidx: Optional[int] = None,
                            fval: int = 0) -> bool:
        """N scattered (dst, src, len) copies as ONE GIL-released call,
        optionally fused with a release arrive store + wake.  False ⇒
        the caller runs the per-block numpy path (executor off, or a
        total payload the ctypes crossing would not amortize).  Callers
        pass absolute addresses (``_base_addr`` pre-checked)."""
        ex = _exec()
        if ex is None or sum(lens) < _NATIVE_PUBLISH_MIN:
            return False
        n = len(dsts)
        da = (ctypes.c_void_p * n)(*dsts)
        sa = (ctypes.c_void_p * n)(*srcs)
        ln = (ctypes.c_int64 * n)(*lens)
        ex.ompi_tpu_arena_copy_blocks(
            ctypes.addressof(da), ctypes.addressof(sa),
            ctypes.addressof(ln), n,
            self._base_addr if fidx is not None else None,
            fidx if fidx is not None else 0, fval)
        trace_mod.count("coll_shm_native_publishes_total")
        return True

    def _fold_slots(self, dtype: np.dtype, op: Op, lo: int, hi: int,
                    order: list) -> np.ndarray:
        """Chain-fold elements [lo, hi) of the listed slots, in list
        order — native when eligible (bit-identical chain, GIL
        released), the rank-ordered numpy chain otherwise.  The order
        list is the CALLER's (comm-rank chain for reduce_scatter, the
        0..r prefix for scan), so non-commutative prefix folds stay
        order-correct."""
        count = hi - lo
        if count <= 0:
            return np.empty(0, dtype)
        boff = lo * dtype.itemsize
        ex = _exec() if self._base_addr is not None else None
        dc = _fold_code(dtype) if ex is not None else None
        oc = _NATIVE_OP_CODES.get(op) if ex is not None else None
        if (dc is not None and oc is not None
                and count * dtype.itemsize >= _NATIVE_PUBLISH_MIN):
            out = np.empty(count, dtype)
            _native_fold(ex, out.ctypes.data,
                         [self._base_addr + self._slot_off(j) + boff
                          for j in order], count, dc, oc)
            return out
        acc = np.frombuffer(self._slot(order[0])[boff:], dtype,
                            count=count)
        for j in order[1:]:
            acc = np.asarray(op.host(acc, np.frombuffer(
                self._slot(j)[boff:], dtype, count=count)))
        # a single-source chain aliases the mapped slot — copy before
        # the depart barrier releases it for reuse
        return np.array(acc, copy=True).reshape(-1)

    def alltoall(self, comm, arr: np.ndarray) -> np.ndarray:
        """``arr`` = p equal blocks (C order) keyed by DEST arena rank;
        returns ``(p, block)`` rows keyed by SRC arena rank.  One
        publish per rank; the gather side reads its column out of every
        peer slot as one native block plan.  Caller checked
        divisibility, dtype and nbytes <= slot_bytes."""
        arr = np.asarray(arr)
        p = self.size
        blk = arr.size // p
        bb = blk * arr.dtype.itemsize
        s0a, s0d = self._arr, self._dep
        self._publish_slot(comm, arr, s0a + 1)
        self._wait_all_arrive(s0a + 1, comm)
        out = np.empty((p, blk), arr.dtype)
        moff = self.rank * bb
        rows = out.reshape(p, -1)
        done = False
        if self._base_addr is not None and bb:
            done = self._copy_blocks_native(
                [out.ctypes.data + i * bb for i in range(p)],
                [self._base_addr + self._slot_off(i) + moff
                 for i in range(p)], [bb] * p)
        if not done:
            for i in range(p):
                rows[i] = np.frombuffer(self._slot(i)[moff:moff + bb],
                                        arr.dtype, count=blk)
        self._set_depart(s0d + 1)
        self._wait_all_depart(s0d + 1, comm)
        return out

    def alltoallv(self, comm, parts: list) -> Optional[list]:
        """``parts``: one array per DEST arena rank (None ⇒ empty).
        Per-dest header entries (length, offset, shape, dtype) lead the
        packed blocks in each slot, so readers address exactly their
        block.  The fits/describable verdict travels in the descriptor
        round — ANY host verdict makes every rank return None together
        (the bcast communicated-verdict discipline, generalized to all
        writers: v-counts are per-rank knowledge, so no local gate is
        collectively safe).  Returns received arrays keyed by SRC arena
        rank, dtype/shape preserved like the pairwise wire."""
        p = self.size
        parts = [np.empty(0, np.uint8) if a is None else np.asarray(a)
                 for a in parts]
        hdr = p * _VHDR
        offs, off = [], hdr
        for a in parts:
            offs.append(off)
            off += (a.nbytes + 7) & ~7
        ok = (off <= self.slot_bytes
              and all(_arena_dtype_ok(a.dtype) and _desc_dtype_ok(a.dtype)
                      and a.ndim <= _MAX_DIMS for a in parts))
        s0a, s0d = self._arr, self._dep
        self._write_desc(_DESC_DATA if ok else _DESC_HOST, None, 0)
        if not ok:
            self._set_arrive(s0a + 1)
        else:
            head = np.zeros(hdr, np.uint8)
            hu = head.view(np.uint64).reshape(p, _VHDR // 8)
            for i, a in enumerate(parts):
                hu[i, 0] = a.nbytes
                hu[i, 1] = offs[i]
                hu[i, 2] = a.ndim
                if a.ndim:
                    hu[i, 3:3 + a.ndim] = np.asarray(a.shape, np.uint64)
                ds = a.dtype.str.encode()
                head[i * _VHDR + 88:i * _VHDR + 88 + len(ds)] = \
                    np.frombuffer(ds, np.uint8)
            srcs = [head] + [np.ascontiguousarray(a) for a in parts]
            done = False
            if self._base_addr is not None:
                dst0 = self._base_addr + self._slot_off(self.rank)
                done = self._copy_blocks_native(
                    [dst0] + [dst0 + o for o in offs],
                    [a.ctypes.data for a in srcs],
                    [a.nbytes for a in srcs],
                    fidx=self.rank * 8, fval=s0a + 1)
                if done:
                    self._arr = s0a + 1
            if not done:
                slot = self._slot(self.rank)
                self._copy_in(slot[:hdr], head)
                for a, o in zip(parts, offs):
                    if a.nbytes:
                        self._copy_in(slot[o:o + a.nbytes], a)
                self._set_arrive(s0a + 1)
        self._wait_all_arrive(s0a + 1, comm)
        verdict_host = any(self._read_desc(i)[0] == _DESC_HOST
                           for i in range(p))
        out: Optional[list] = None
        if not verdict_host:
            me = self.rank
            out = []
            natd, nats, natl = [], [], []
            py = []   # (arr, abs slot offset, nbytes) for the numpy path
            for i in range(p):
                eoff = self._slot_off(i) + me * _VHDR
                ent = np.frombuffer(self.seg.buf[eoff:eoff + 88],
                                    np.uint64)
                nb, boff, nd = int(ent[0]), int(ent[1]), int(ent[2])
                shape = tuple(int(x) for x in ent[3:3 + nd])
                raw = bytes(
                    self.seg.buf[eoff + 88:eoff + 120]).rstrip(b"\0")
                dt = np.dtype(raw.decode()) if raw else np.dtype(np.uint8)
                a = np.empty(shape, dt)
                out.append(a)
                if nb:
                    natd.append(a.ctypes.data)
                    nats.append(self._base_addr + self._slot_off(i) + boff
                                if self._base_addr is not None else 0)
                    natl.append(nb)
                    py.append((a, self._slot_off(i) + boff, nb))
            if not (self._base_addr is not None and natl
                    and self._copy_blocks_native(natd, nats, natl)):
                for a, aoff, nb in py:
                    a.reshape(-1)[...] = np.frombuffer(
                        self.seg.buf[aoff:aoff + nb], a.dtype,
                        count=a.size)
        self._set_depart(s0d + 1)
        self._wait_all_depart(s0d + 1, comm)
        return out

    def reduce_scatter(self, comm, arr: np.ndarray, op: Op, lo: int,
                       hi: int, order: list) -> np.ndarray:
        """Publish the whole payload, fold elements [lo, hi) of every
        slot in the caller's slot order (its comm-rank chain — native
        and numpy folds are bit-identical on it); returns the folded
        1-D segment.  Caller checked dtype and nbytes <= slot_bytes."""
        arr = np.asarray(arr)
        s0a, s0d = self._arr, self._dep
        self._publish_slot(comm, arr, s0a + 1)
        self._wait_all_arrive(s0a + 1, comm)
        out = self._fold_slots(arr.dtype, op, lo, hi, order)
        self._set_depart(s0d + 1)
        self._wait_all_depart(s0d + 1, comm)
        return out

    def scan(self, comm, arr: np.ndarray, op: Op,
             order: list) -> Optional[np.ndarray]:
        """Prefix fold: publish the whole payload, fold the listed
        slots (the caller's 0..r comm-rank prefix, so non-commutative
        ops stay order-correct) over the full element range.  An empty
        order participates in the round and returns None (exscan rank
        0's MPI-undefined result)."""
        arr = np.asarray(arr)
        s0a, s0d = self._arr, self._dep
        self._publish_slot(comm, arr, s0a + 1)
        self._wait_all_arrive(s0a + 1, comm)
        out = None
        if order:
            out = self._fold_slots(arr.dtype, op, 0, arr.size, order)
            out = out.reshape(arr.shape)
        self._set_depart(s0d + 1)
        self._wait_all_depart(s0d + 1, comm)
        return out


#: per-dest header entry bytes in an alltoallv slot: u64 nbytes, u64
#: offset, u64 ndim, u64 shape[_MAX_DIMS], 32B dtype str, pad to 128
_VHDR = 128


class PersistentSlots(Arena):
    """Pinned, parity-double-buffered slots for ONE bound persistent
    plan (coll/persistent).

    Layout: the Arena counter block (arrive/depart u64 ×p, cacheline
    padded) followed by TWO full slot sets — no descriptor region (the
    descriptor's job, shipping shape/dtype/verdict, was done once at
    bind time).  Parity q = op-sequence mod 2 indexes the slot set, so
    op k+1's publish lands in the slots op k is NOT draining: a rank
    that finished waiting op k may immediately Start op k+1 while
    slower ranks still read op k's parity — the double-buffered
    overlap the btl rings and ``allreduce_segmented_ring`` use, lifted
    to whole-operation granularity.  Slot reuse is guarded by the
    depart counters two ops back (same-parity predecessor), never by a
    per-op full barrier.

    The counters keep the Arena semantics (monotonic u64, single
    writer, ``memoryview.cast("Q")`` aligned stores), so every
    inherited wait — including the dead-writer pid probe — applies
    unchanged.
    """

    def __init__(self, seg: shmseg.SharedSegment, size: int, rank: int,
                 slot_bytes: int, nslots: int, world=None,
                 pml=None, fence=None) -> None:
        super().__init__(seg, size, rank, slot_bytes, world=world, pml=pml,
                         fence=fence)
        self.nslots = nslots              # slots per parity set
        self._slot_base = 2 * size * _CACHELINE   # no desc region

    @staticmethod
    def pnbytes_for(size: int, slot_bytes: int, nslots: int) -> int:
        return 2 * size * _CACHELINE + 2 * nslots * slot_bytes

    def pslot_off(self, parity: int, i: int) -> int:
        return self._slot_base + (parity * self.nslots + i) * self.slot_bytes

    def pslot(self, parity: int, i: int) -> memoryview:
        off = self.pslot_off(parity, i)
        return self.seg.buf[off:off + self.slot_bytes]

    # non-blocking peeks (the poll half of a persistent op's test())
    def arrive_at(self, r: int) -> int:
        return int(self._flags[r * 8])

    def depart_at(self, r: int) -> int:
        return int(self._flags[(self.size + r) * 8])


def make_persistent_slots(comm, slot_bytes: int,
                          nslots: int) -> Optional["PersistentSlots"]:
    """Collectively map a dedicated parity-slot segment for one bound
    plan (the pinned-slot half of a persistent-collective bind).  None
    ⇒ mapping failed somewhere — every rank falls back together.  The
    slots are epoch-fenced on the bound comm (the local epoch here; the
    bind's incarnation agreement re-stamps it with the agreed value)."""
    slot_bytes = max(0, (slot_bytes + 63) & ~63)
    seg = _map_shared(
        comm, max(PersistentSlots.pnbytes_for(comm.size, slot_bytes,
                                              nslots), 1))
    if seg is None:
        return None
    return PersistentSlots(seg, comm.size, comm.rank, slot_bytes, nslots,
                           world=list(comm.group.ranks), pml=comm.pml,
                           fence=(_coll_epoch(comm), weakref.ref(comm)))


# ---------------------------------------------------------------------------
# bootstrap + per-communicator state
# ---------------------------------------------------------------------------

def _slot_bytes(size: int) -> int:
    slot = min(int(var_registry.get("coll_shm_slot_size")),
               int(var_registry.get("coll_shm_arena_size")) // (size + 1))
    return max(slot & ~15, 256)


def _map_shared(comm, nbytes: int) -> Optional[shmseg.SharedSegment]:
    """Collective over ``comm`` (whose ranks all share a host): rank 0
    creates a segment of ``nbytes``, the path rides a base-algorithm
    bcast (plain p2p — the arena cannot carry its own bootstrap),
    everyone attaches, and a MIN-allreduce agrees the mapping is usable
    everywhere before the creator unlinks the name (mappings survive;
    crash cleanup is free, like the btl/shm rings).  None ⇒ some rank
    could not map — every rank gets None together."""
    seg = None
    path = ""
    if comm.rank == 0:
        try:
            name = (f"otpu-torch-collshm-{os.getpid()}-"
                    f"{uuid.uuid4().hex[:10]}")
            seg = shmseg.create(name, nbytes)
            path = seg.path
        except OSError as e:
            _log.verbose(1, "coll/shm: segment create failed (%s)", e)
    got = base.bcast_binomial(
        comm, np.frombuffer(path.encode(), np.uint8)
        if comm.rank == 0 else None, 0)
    path = bytes(bytearray(np.asarray(got, np.uint8))).decode()
    mine: Optional[shmseg.SharedSegment] = None
    ok = 0
    if comm.rank == 0:
        if seg is not None:
            mine, ok = seg, 1
    elif path:
        try:
            mine = shmseg.attach_retry(path, timeout=10.0)
            ok = 1
        except OSError as e:
            _log.verbose(1, "coll/shm: segment attach failed (%s)", e)
    allok = base.allreduce_recursive_doubling(
        comm, np.array([ok], np.int64), op_mod.MIN)
    if comm.rank == 0 and seg is not None:
        seg.unlink()   # attach agreement passed (or failed): name done
    if int(allok[0]) != 1:
        if mine is not None:
            mine.detach()
        return None
    return mine


def _make_arena(comm, fence=None) -> Optional[Arena]:
    """The one-shot dispatch arena: one ``_map_shared`` bootstrap with
    the classic flags+desc+slots layout."""
    p = comm.size
    slot = _slot_bytes(p)
    seg = _map_shared(comm, Arena.nbytes_for(p, slot))
    if seg is None:
        return None
    return Arena(seg, p, comm.rank, slot,
                 world=list(comm.group.ranks), pml=comm.pml, fence=fence)


class _HostFallback:
    """Per-communicator fallback marker (no co-located ranks, no usable
    shm dir, or arena bootstrap failed) — epoch-stamped like ``_State``,
    so a comm that settled on host re-runs the split once its epoch
    advances."""

    mode = "host"

    def __init__(self, epoch: int = 0) -> None:
        self.epoch = epoch

    def close(self) -> None:
        pass


_SETUP = object()   # reentrancy sentinel: setup's own collectives → host


class _State:
    """Cached per-communicator dispatch state (rides ``comm._coll_shm_state``;
    ``Communicator.free`` closes it; a coll-epoch advance past ``epoch``
    invalidates it)."""

    def __init__(self, mode: str, node, leader, arena,
                 c2n=None, node_blocks=None, node_idx_of=None,
                 epoch: int = 0) -> None:
        self.mode = mode              # "arena" (flat) | "hier"
        self.node = node              # split_type(COMM_TYPE_SHARED) cache
        self.leader = leader          # node-rank-0 communicator (or None)
        self.arena = arena            # this node's Arena (or None)
        self.c2n = c2n                # flat: comm rank → arena rank
        self.node_blocks = node_blocks  # hier: per node, comm ranks by node rank
        self.node_idx_of = node_idx_of  # hier: comm rank → node index
        self.epoch = epoch            # coll epoch at build

    def close(self) -> None:
        if self.arena is not None:
            self.arena.close()
            self.arena = None


# ---------------------------------------------------------------------------
# the component
# ---------------------------------------------------------------------------

@coll_framework.component
class ShmColl(Component):
    NAME = "shm"
    PRIORITY = 50    # above host (40): same-host ranks take the arena

    def register_params(self) -> None:
        register_var("coll", "shm_enable", VarType.BOOL, True,
                     "use the on-node shared-memory collective arena "
                     "when ranks share a host (0 = coll/host everywhere)")
        register_var("coll", "shm_arena_size", VarType.SIZE, 4 << 20,
                     "max payload routed through the arena; larger "
                     "collectives fall back to coll/host (whose ring/"
                     "pipeline algorithms are bandwidth-optimal there)")
        register_var("coll", "shm_slot_size", VarType.SIZE, 256 << 10,
                     "per-rank arena slot; payloads above half a slot "
                     "pipeline through the slot halves (double-buffered)")
        register_var("coll", "shm_timeout", VarType.SIZE, 60,
                     "seconds an arena flag wait may stall before raising "
                     "(a dead peer or collective-order mismatch leaves "
                     "flags behind forever)")
        register_var("coll", "stuck_timeout", VarType.DOUBLE, 5.0,
                     "seconds an arena flag wait may stall before the "
                     "rank records a 'stuck' event on the collective "
                     "flight recorder and forces an out-of-cadence "
                     "metrics push (the hang doctor's watchdog trigger).  "
                     "0 disables the watchdog; the wait itself still "
                     "fails at coll_shm_timeout")
        register_var("coll", "shm_probe_grace", VarType.DOUBLE, 1.0,
                     "seconds an arena wait stalls before probing the "
                     "expected writer's pid via the btl liveness probe "
                     "(0 = disabled); a SIGKILLed writer then fails its "
                     "peers in ~this window instead of coll_shm_timeout. "
                     "Validated to stay below coll_shm_timeout")
        register_var("coll", "shm_native", VarType.BOOL, True,
                     "run the arena steady state (flag waits, slot "
                     "publishes, segment folds) through the native "
                     "GIL-released executor (_native/arena.c). Off, a "
                     "failed build, or OMPI_TPU_NO_NATIVE=1 -> the "
                     "pure-python data plane (bit-identical results)")
        register_var("coll", "shm_allreduce_algorithm", VarType.STRING,
                     "", "force the persistent arena allreduce fold "
                     "strategy: root_fold | segment_parallel (empty = "
                     "rules file / payload crossover)")
        register_var("coll", "shm_segpar_min", VarType.SIZE, 1 << 20,
                     "payload crossover above which a persistent arena "
                     "allreduce binds the cooperative segment-parallel "
                     "reduce-scatter+allgather instead of the "
                     "single-rank root fold (0 = never)")

    def query(self, comm=None, **ctx) -> Optional[int]:
        if not var_registry.get("coll_shm_enable"):
            return None
        if comm is None or comm.size <= 1 or comm.test_inter():
            return None
        d = shmseg.backing_dir()
        if not (os.path.isdir(d) and os.access(d, os.W_OK)):
            return None
        return self.PRIORITY

    # -- state -------------------------------------------------------------

    def _host(self):
        return coll_framework.components()["host"]

    def _state(self, comm):
        st = getattr(comm, "_coll_shm_state", None)
        if st is _SETUP:
            return None          # setup's own collectives ride coll/host
        epoch = _coll_epoch(comm)
        if st is not None:
            if getattr(st, "epoch", 0) >= epoch:
                return st
            # a member was revived since the build: the cached splits
            # and arena are survivors-only artifacts — rebuild them
            st.close()
            comm._coll_shm_state = st = None
        comm._coll_shm_state = _SETUP
        built = None
        try:
            t0 = trace_mod.begin() if trace_mod.active else 0
            built = self._build_state(comm, epoch)
            if t0:
                trace_mod.complete("coll", "shm_setup", t0,
                                   rank=comm.pml.rank, cid=comm.cid,
                                   mode=built.mode, size=comm.size)
        except MPIException as e:
            # the raise is deterministic (every rank computes the same
            # partition), so settling on coll/host is collectively
            # consistent
            _log.verbose(1, "coll/shm: setup on %s fell back to host "
                         "(%s)", comm.name, e)
        finally:
            # the freed check and the cache assignment must be ONE
            # atomic step against Comm.free() (which sets the flag and
            # clears the cache under the same comm lock): a check-then-
            # assign window would let a racing free() run to completion
            # between them and the freshly-built arena would be cached
            # onto the freed comm
            with comm._lock:
                freed = getattr(comm, "_coll_freed", False)
                if not freed:
                    comm._coll_shm_state = (built if built is not None
                                            else _HostFallback(epoch))
            if freed:
                # Comm.free() ran while this build was in flight (it
                # saw the _SETUP sentinel and had nothing to close):
                # close the half-built state instead of caching it
                if built is not None:
                    built.close()
                comm._coll_shm_state = None
        return comm._coll_shm_state

    def _build_state(self, comm, epoch: int = 0):
        node = comm.split_type(COMM_TYPE_SHARED,
                               name=f"{comm.name}.shmnode")
        leader = comm.split(0 if node.rank == 0 else UNDEFINED,
                            key=comm.rank, name=f"{comm.name}.shmldr")
        # the fence comm is the PARENT: a revive anywhere in the
        # hierarchy must break node-arena waits, not just node-local ones
        fence = (epoch, weakref.ref(comm))
        arena = _make_arena(node, fence=fence) if node.size > 1 else None
        if node.size == comm.size:                      # one host: flat
            if arena is None:
                return _HostFallback(epoch)
            c2n = np.array([node.group.rank_of(comm.world_rank(r))
                            for r in range(comm.size)], np.int64)
            return _State("arena", node, leader, arena, c2n=c2n,
                          epoch=epoch)
        # mixed hosts: leaders exchange their node's comm-rank blocks
        # (ordered by node rank — i.e. by leader-comm rank across nodes),
        # then fan the table out intra-node; base algorithms only (the
        # arena protocol must not bootstrap itself)
        if leader is not None:
            my_block = np.array([comm.group.rank_of(w)
                                 for w in node.group.ranks], np.int64)
            blocks = base.allgatherv_ring(leader, my_block)
            lens = np.array([len(b) for b in blocks], np.int64)
            meta = np.concatenate(
                [[len(blocks)], lens] + [np.asarray(b, np.int64)
                                         for b in blocks])
        else:
            meta = None
        if node.size > 1:
            meta = base.bcast_binomial(
                node, meta if node.rank == 0 else None, 0)
        meta = np.asarray(meta, np.int64)
        nnodes = int(meta[0])
        lens = meta[1:1 + nnodes]
        node_blocks, off = [], 1 + nnodes
        for ln in lens:
            node_blocks.append([int(x) for x in meta[off:off + int(ln)]])
            off += int(ln)
        if all(len(b) == 1 for b in node_blocks):
            if arena is not None:
                arena.close()
            # nobody shares a host: pure coll/host ground (epoch-stamped
            # so a later revive still re-evaluates the partition)
            return _HostFallback(epoch)
        node_idx_of = {r: i for i, blk in enumerate(node_blocks)
                       for r in blk}
        return _State("hier", node, leader, arena,
                      node_blocks=node_blocks, node_idx_of=node_idx_of,
                      epoch=epoch)

    # -- decision helpers ----------------------------------------------------

    def _cap(self) -> int:
        return int(var_registry.get("coll_shm_arena_size"))

    def _host_directive(self, coll: str, comm, nbytes: int) -> Optional[str]:
        """An explicit host-algorithm force or a rules-file hit is user
        tuning the on-node shortcut must not override."""
        if coll in ("bcast", "allreduce", "allgather", "alltoall",
                    "reduce_scatter"):
            if var_registry.get(f"coll_host_{coll}_algorithm"):
                return f"forced coll_host_{coll}_algorithm"
            path = var_registry.get("coll_host_dynamic_rules")
            if path:
                try:
                    hit = self._host()._load_rules(path).lookup(
                        coll, comm.size, nbytes)
                except Exception:  # noqa: BLE001 — let host surface the error
                    return f"unreadable rules file {path}"
                if hit:
                    return f"rules file {path}"
        return None

    def _fallback(self, comm, coll: str, reason: str, nbytes: int = 0):
        """coll/host for this call, counted and recorded as a
        ``decision:<coll>`` instant naming the reason."""
        trace_mod.count("coll_shm_fallback_total")
        if trace_mod.active:
            trace_mod.instant(
                "coll", f"decision:{coll}", rank=comm.pml.rank,
                algorithm="fallback:host", source=f"coll/shm: {reason}",
                nbytes=nbytes, size=comm.size)
        return self._host()

    def _route(self, comm, coll: str, nbytes: int = 0):
        """(state, None) to run the arena/hier path, or (None, host
        component) to fall back — every branch driven by inputs all
        ranks agree on."""
        st = self._state(comm)
        if st is None:
            return None, self._host()   # setup reentry: silent host
        if st.mode == "host":
            return None, self._fallback(comm, coll, "no arena (single-rank "
                                        "hosts or bootstrap failed)", nbytes)
        src = self._host_directive(coll, comm, nbytes)
        if src is not None:
            return None, self._fallback(comm, coll, src, nbytes)
        return st, None

    # -- intra-node phase helpers (hier mode) --------------------------------

    def _intra_gate_in(self, st) -> None:
        if st.node.size == 1:
            return
        if st.arena is not None:
            trace_mod.count("coll_shm_fanin_total")
            st.arena.gate_in(st.node, 0)
        else:
            base.gather_linear(st.node, _TOKEN, 0)

    def _intra_gate_out(self, st) -> None:
        if st.node.size == 1:
            return
        if st.arena is not None:
            trace_mod.count("coll_shm_fanout_total")
            st.arena.gate_out(st.node, 0)
        else:
            base.bcast_binomial(st.node,
                                _TOKEN if st.node.rank == 0 else None, 0)

    def _intra_bcast(self, st, buf, nroot: int):
        node = st.node
        if node.size == 1:
            return np.asarray(buf)
        if st.arena is not None:
            out = st.arena.bcast(node, nroot, buf, self._cap())
            if out is not None:
                trace_mod.count("coll_shm_fanout_total")
                return out
            trace_mod.count("coll_shm_fallback_total")
        return self._host().coll_bcast(node, buf, nroot)

    def _intra_reduce(self, st, arr, op: Op):
        """Fold to node rank 0; returns the partial there, None elsewhere."""
        node = st.node
        if node.size == 1:
            return np.asarray(arr)
        if st.arena is not None and self._reducible(arr, op, st.arena):
            trace_mod.count("coll_shm_fanin_total")
            return st.arena.reduce(node, 0, arr, op, bcast_result=False)
        trace_mod.count("coll_shm_fallback_total")
        return self._host().coll_reduce(node, arr, op, 0)

    def _reducible(self, arr: np.ndarray, op: Op, arena: Arena) -> bool:
        return (op.commutative and _arena_dtype_ok(arr.dtype)
                and arr.dtype.itemsize <= arena.half
                and arr.nbytes <= self._cap())

    # -- table slots ---------------------------------------------------------

    def coll_barrier(self, comm) -> None:
        st, host = self._route(comm, "barrier")
        if host is not None:
            return host.coll_barrier(comm)
        if st.mode == "arena":
            trace_mod.count("coll_shm_fanin_total")
            return st.arena.barrier(comm)
        self._intra_gate_in(st)
        if st.leader is not None:
            self._host().coll_barrier(st.leader)
        self._intra_gate_out(st)

    def coll_bcast(self, comm, buf, root: int):
        st, host = self._route(comm, "bcast")
        if host is not None:
            return host.coll_bcast(comm, buf, root)
        if st.mode == "arena":
            out = st.arena.bcast(comm, int(st.c2n[root]), buf, self._cap())
            if out is None:   # the root's verdict, learned via the desc
                return self._fallback(
                    comm, "bcast", "payload above coll_shm_arena_size or "
                    "unsupported dtype (root's descriptor verdict)"
                ).coll_bcast(comm, buf, root)
            trace_mod.count("coll_shm_fanout_total")
            return out
        my_idx = st.node_idx_of[comm.rank]
        root_idx = st.node_idx_of[root]
        data = buf
        if my_idx == root_idx and st.node.size > 1:
            nroot = st.node.group.rank_of(comm.world_rank(root))
            data = self._intra_bcast(st, data, nroot)
        if st.leader is not None:
            data = self._host().coll_bcast(
                st.leader, data if my_idx == root_idx else None, root_idx)
        if my_idx != root_idx:
            data = self._intra_bcast(st, data, 0)
        return np.asarray(data)

    def coll_reduce(self, comm, sendbuf, op: Op, root: int):
        arr = np.asarray(sendbuf)
        st, host = self._route(comm, "reduce", arr.nbytes)
        if host is not None:
            return host.coll_reduce(comm, arr, op, root)
        if not op.commutative:
            return self._fallback(comm, "reduce", "non-commutative op",
                                  arr.nbytes).coll_reduce(comm, arr, op,
                                                          root)
        if st.mode == "arena":
            if not self._reducible(arr, op, st.arena):
                return self._fallback(
                    comm, "reduce", "payload above coll_shm_arena_size or "
                    "unsupported dtype", arr.nbytes
                ).coll_reduce(comm, arr, op, root)
            trace_mod.count("coll_shm_fanin_total")
            return st.arena.reduce(comm, int(st.c2n[root]), arr, op,
                                   bcast_result=False)
        root_idx = st.node_idx_of[root]
        partial = self._intra_reduce(st, arr, op)
        out = None
        if st.leader is not None:
            out = self._host().coll_reduce(st.leader, partial, op, root_idx)
        root_leader = st.node_blocks[root_idx][0]
        if root_leader != root:   # root is not its node's leader: one hop
            if comm.rank == root_leader:
                comm._coll_isend(out, root, base.TAG_REDUCE).wait()
                out = None
            elif comm.rank == root:
                out = comm._coll_irecv(None, root_leader,
                                       base.TAG_REDUCE).wait()
                out = out.reshape(arr.shape).astype(arr.dtype, copy=False)
        return out if comm.rank == root else None

    def coll_allreduce(self, comm, sendbuf, op: Op):
        arr = np.asarray(sendbuf)
        st, host = self._route(comm, "allreduce", arr.nbytes)
        if host is not None:
            return host.coll_allreduce(comm, arr, op)
        if not op.commutative:
            return self._fallback(comm, "allreduce", "non-commutative op",
                                  arr.nbytes).coll_allreduce(comm, arr, op)
        if st.mode == "arena":
            if not self._reducible(arr, op, st.arena):
                return self._fallback(
                    comm, "allreduce", "payload above coll_shm_arena_size "
                    "or unsupported dtype", arr.nbytes
                ).coll_allreduce(comm, arr, op)
            trace_mod.count("coll_shm_fanin_total")
            trace_mod.count("coll_shm_fanout_total")
            return st.arena.reduce(comm, 0, arr, op, bcast_result=True)
        partial = self._intra_reduce(st, arr, op)
        total = partial
        if st.leader is not None:
            total = self._host().coll_allreduce(st.leader, partial, op)
        out = self._intra_bcast(st, total, 0)
        return np.asarray(out).reshape(arr.shape).astype(arr.dtype,
                                                         copy=False)

    def coll_allgather(self, comm, sendbuf):
        arr = np.asarray(sendbuf)
        st, host = self._route(comm, "allgather", arr.nbytes)
        if host is not None:
            return host.coll_allgather(comm, arr)
        if st.mode == "arena":
            if not (_arena_dtype_ok(arr.dtype)
                    and arr.nbytes <= st.arena.slot_bytes
                    and arr.nbytes * comm.size <= self._cap()):
                return self._fallback(
                    comm, "allgather", "payload above the slot/arena cap "
                    "or unsupported dtype", arr.nbytes
                ).coll_allgather(comm, arr)
            trace_mod.count("coll_shm_fanin_total")
            trace_mod.count("coll_shm_fanout_total")
            out = st.arena.allgather(comm, arr)
            c2n = st.c2n
            if not np.array_equal(c2n, np.arange(comm.size)):
                out = out[c2n]
            return out
        # hier: node gather → leader allgatherv → reorder → node bcast
        node = st.node
        if node.size > 1:
            if (st.arena is not None and _arena_dtype_ok(arr.dtype)
                    and arr.nbytes <= st.arena.slot_bytes):
                trace_mod.count("coll_shm_fanin_total")
                block = st.arena.allgather(node, arr)
            else:
                block = self._host().coll_allgather(node, arr)
        else:
            block = arr[None]
        full = None
        if st.leader is not None:
            rows = self._host().coll_allgatherv(
                st.leader, np.ascontiguousarray(block).reshape(
                    block.shape[0], -1))
            full = np.empty((comm.size, max(arr.size, 0)), arr.dtype)
            for bi, blk in enumerate(rows):
                full[np.asarray(st.node_blocks[bi])] = np.asarray(
                    blk, arr.dtype).reshape(len(st.node_blocks[bi]), -1)
        full = self._intra_bcast(st, full, 0)
        return np.asarray(full, arr.dtype).reshape(
            (comm.size,) + arr.shape)

    # -- dense exchange slots ------------------------------------------------
    #
    # alltoall/v/w, reduce_scatter and scan/exscan — the last collective
    # class still PML-bound.  Flat comms run the one-round arena
    # protocols; hier comms run the MPI-Advance locality split (node
    # leaders aggregate per-node blocks, exchange O(nodes) large frames
    # over the btl rings, scatter intra-node over the arena) for the
    # patterns whose counts every rank can derive (alltoall,
    # reduce_scatter, contiguous-block scan).  v/w counts are rank-local
    # knowledge, so multi-node v/w falls back to host rather than guess
    # a split no rank can verify collectively.

    def coll_alltoall(self, comm, sendbuf):
        arr = np.asarray(sendbuf)
        st, host = self._route(comm, "alltoall", arr.nbytes)
        if host is not None:
            return host.coll_alltoall(comm, arr)
        p = comm.size
        if arr.ndim == 0 or arr.shape[0] % p:
            return self._host().coll_alltoall(comm, arr)  # host's error
        if st.mode == "arena":
            if not (_arena_dtype_ok(arr.dtype)
                    and arr.nbytes <= st.arena.slot_bytes
                    and arr.nbytes <= self._cap()):
                return self._fallback(
                    comm, "alltoall", "payload above the slot/arena cap "
                    "or unsupported dtype", arr.nbytes
                ).coll_alltoall(comm, arr)
            trace_mod.count("coll_shm_fanin_total")
            trace_mod.count("coll_shm_fanout_total")
            c2n = st.c2n
            ident = bool(np.array_equal(c2n, np.arange(p)))
            a = np.ascontiguousarray(arr)
            if not ident:
                inv = np.empty(p, np.int64)
                inv[c2n] = np.arange(p)
                a = np.ascontiguousarray(a.reshape(p, -1)[inv])
            out = st.arena.alltoall(comm, a)
            if not ident:
                out = out[c2n]
            return np.ascontiguousarray(out).reshape(arr.shape)
        if arr.nbytes > self._cap():
            return self._fallback(
                comm, "alltoall", "payload above coll_shm_arena_size",
                arr.nbytes).coll_alltoall(comm, arr)
        # locality-aware aggregation: everyone shares its full sendbuf
        # intra-node, leaders exchange ONE frame per peer node carrying
        # every (src member, dst member) block for that node pair, then
        # one intra bcast fans the reassembled table out — O(nodes)
        # large btl frames instead of O(p²) small ones
        node = st.node
        bb = arr.size // p
        a = np.ascontiguousarray(arr)
        if node.size > 1:
            trace_mod.count("coll_shm_fanin_total")
            if (st.arena is not None and _arena_dtype_ok(a.dtype)
                    and a.nbytes <= st.arena.slot_bytes):
                gathered = st.arena.allgather(node, a)
            else:
                gathered = self._host().coll_allgather(node, a)
        else:
            gathered = a[None]
        full = None
        if st.leader is not None:
            mat = np.ascontiguousarray(gathered).reshape(node.size, p, bb)
            frames = [np.ascontiguousarray(
                mat[:, np.asarray(blk)]).reshape(-1)
                for blk in st.node_blocks]
            got = self._host().coll_alltoallv(st.leader, frames)
            full = np.empty((p, node.size, bb), arr.dtype)
            for i, blk in enumerate(st.node_blocks):
                full[np.asarray(blk)] = np.asarray(
                    got[i], arr.dtype).reshape(len(blk), node.size, bb)
        full = self._intra_bcast(st, full, 0)
        mine = np.asarray(full, arr.dtype).reshape(
            p, node.size, bb)[:, st.node.rank]
        return np.ascontiguousarray(mine).reshape(arr.shape)

    def coll_alltoallv(self, comm, sendparts):
        st, host = self._route(comm, "alltoallv")
        if host is not None:
            return host.coll_alltoallv(comm, sendparts)
        if st.mode != "arena":
            return self._fallback(
                comm, "alltoallv", "multi-node: v-counts are rank-local "
                "(no collectively-derivable aggregation split)"
            ).coll_alltoallv(comm, sendparts)
        p = comm.size
        if len(sendparts) != p:
            return self._host().coll_alltoallv(comm, sendparts)
        c2n = st.c2n
        ident = bool(np.array_equal(c2n, np.arange(p)))
        send = list(sendparts)
        if not ident:
            inv = np.empty(p, np.int64)
            inv[c2n] = np.arange(p)
            send = [sendparts[int(inv[j])] for j in range(p)]
        got = st.arena.alltoallv(comm, send)
        if got is None:
            return self._fallback(
                comm, "alltoallv", "peer verdict: part above the slot "
                "cap or undescribable dtype (descriptor round)"
            ).coll_alltoallv(comm, sendparts)
        trace_mod.count("coll_shm_fanin_total")
        trace_mod.count("coll_shm_fanout_total")
        return got if ident else [got[int(c2n[r])] for r in range(p)]

    def coll_alltoallw(self, comm, sendspecs, recvspecs):
        st, host = self._route(comm, "alltoallw")
        if host is not None:
            return host.coll_alltoallw(comm, sendspecs, recvspecs)
        if st.mode != "arena":
            return self._fallback(
                comm, "alltoallw", "multi-node: w-specs are rank-local "
                "(no collectively-derivable aggregation split)"
            ).coll_alltoallw(comm, sendspecs, recvspecs)
        p = comm.size
        if len(sendspecs) != p or len(recvspecs) != p:
            return self._host().coll_alltoallw(comm, sendspecs, recvspecs)
        # pack with the send datatypes, ride the byte alltoallv, unpack
        # with the receive datatypes — the pairwise wire, minus the PML
        packed = [base.pack_spec(s) for s in sendspecs]
        c2n = st.c2n
        ident = bool(np.array_equal(c2n, np.arange(p)))
        send = packed
        if not ident:
            inv = np.empty(p, np.int64)
            inv[c2n] = np.arange(p)
            send = [packed[int(inv[j])] for j in range(p)]
        got = st.arena.alltoallv(comm, send)
        if got is None:
            return self._fallback(
                comm, "alltoallw", "peer verdict: packed part above the "
                "slot cap (descriptor round)"
            ).coll_alltoallw(comm, sendspecs, recvspecs)
        trace_mod.count("coll_shm_fanin_total")
        trace_mod.count("coll_shm_fanout_total")
        for r in range(p):
            base.unpack_spec(recvspecs[r],
                             got[r] if ident else got[int(c2n[r])])
        return None

    @staticmethod
    def _rs_bounds(n: int, p: int) -> list:
        """np.array_split boundaries over a flat n-element payload —
        the reduce_scatter chunk contract shared with coll/host."""
        q, rmd = divmod(n, p)
        return [r * q + min(r, rmd) for r in range(p + 1)]

    def coll_reduce_scatter(self, comm, sendbuf, op: Op):
        arr = np.asarray(sendbuf)
        st, host = self._route(comm, "reduce_scatter", arr.nbytes)
        if host is not None:
            return host.coll_reduce_scatter(comm, arr, op)
        p = comm.size
        if st.mode == "arena":
            if not (_arena_dtype_ok(arr.dtype)
                    and arr.nbytes <= st.arena.slot_bytes
                    and arr.nbytes <= self._cap()):
                return self._fallback(
                    comm, "reduce_scatter", "payload above the slot/arena "
                    "cap or unsupported dtype", arr.nbytes
                ).coll_reduce_scatter(comm, arr, op)
            trace_mod.count("coll_shm_fanin_total")
            trace_mod.count("coll_shm_fanout_total")
            # comm-rank fold order: canonical for non-commutative ops
            # too, unlike the host ring
            bnds = self._rs_bounds(arr.size, p)
            order = [int(st.c2n[r]) for r in range(p)]
            return st.arena.reduce_scatter(
                comm, arr, op, bnds[comm.rank], bnds[comm.rank + 1], order)
        if not op.commutative:
            return self._fallback(
                comm, "reduce_scatter", "non-commutative op (cross-node "
                "folds reorder)", arr.nbytes
            ).coll_reduce_scatter(comm, arr, op)
        # locality split: fold intra-node first, then leaders exchange
        # ONE frame per peer node (that node's members' chunks,
        # concatenated), fold across nodes, and one intra bcast + local
        # slice scatters the result
        partial = self._intra_reduce(st, arr, op)
        bnds = self._rs_bounds(arr.size, p)
        stack = None
        if st.leader is not None:
            flatp = np.ascontiguousarray(partial).reshape(-1)
            frames = [np.concatenate([flatp[bnds[r]:bnds[r + 1]]
                                      for r in blk])
                      for blk in st.node_blocks]
            got = self._host().coll_alltoallv(st.leader, frames)
            acc = np.asarray(got[0], arr.dtype)
            for fr in got[1:]:
                acc = np.asarray(op.host(
                    acc, np.asarray(fr).astype(acc.dtype, copy=False)))
            stack = acc
        stack = self._intra_bcast(st, stack, 0)
        blk = st.node_blocks[st.node_idx_of[comm.rank]]
        off = sum(bnds[r + 1] - bnds[r] for r in blk[:st.node.rank])
        ln = bnds[comm.rank + 1] - bnds[comm.rank]
        out = np.asarray(stack, arr.dtype).reshape(-1)[off:off + ln]
        return np.ascontiguousarray(out)

    def coll_reduce_scatter_block(self, comm, sendbuf, op: Op):
        arr = np.asarray(sendbuf)
        if arr.ndim == 0 or arr.shape[0] % comm.size:
            return self._host().coll_reduce_scatter_block(comm, arr, op)
        rows = arr.shape[0] // comm.size
        out = self.coll_reduce_scatter(
            comm, arr.reshape(arr.shape[0], -1), op)
        return np.asarray(out).reshape((rows,) + arr.shape[1:])

    def coll_scan(self, comm, sendbuf, op: Op):
        arr = np.asarray(sendbuf)
        st, host = self._route(comm, "scan", arr.nbytes)
        if host is not None:
            return host.coll_scan(comm, arr, op)
        if st.mode == "arena":
            if not (_arena_dtype_ok(arr.dtype)
                    and arr.nbytes <= st.arena.slot_bytes
                    and arr.nbytes <= self._cap()):
                return self._fallback(
                    comm, "scan", "payload above the slot/arena cap or "
                    "unsupported dtype", arr.nbytes
                ).coll_scan(comm, arr, op)
            trace_mod.count("coll_shm_fanin_total")
            order = [int(st.c2n[r]) for r in range(comm.rank + 1)]
            return st.arena.scan(comm, arr, op, order)
        return self._scan_hier(comm, st, arr, op, exclusive=False)

    def coll_exscan(self, comm, sendbuf, op: Op):
        arr = np.asarray(sendbuf)
        st, host = self._route(comm, "exscan", arr.nbytes)
        if host is not None:
            return host.coll_exscan(comm, arr, op)
        if st.mode == "arena":
            if not (_arena_dtype_ok(arr.dtype)
                    and arr.nbytes <= st.arena.slot_bytes
                    and arr.nbytes <= self._cap()):
                return self._fallback(
                    comm, "exscan", "payload above the slot/arena cap or "
                    "unsupported dtype", arr.nbytes
                ).coll_exscan(comm, arr, op)
            trace_mod.count("coll_shm_fanin_total")
            order = [int(st.c2n[r]) for r in range(comm.rank)]
            return st.arena.scan(comm, arr, op, order)
        return self._scan_hier(comm, st, arr, op, exclusive=True)

    def _scan_hier(self, comm, st, arr: np.ndarray, op: Op,
                   exclusive: bool):
        """Hierarchical prefix: intra-node prefixes + the node TOTAL at
        each leader (one arena round — the leader just folds a longer
        slot order), an exscan of node totals across the leader chain,
        one intra bcast of the node base, one local combine.  Valid only
        when the node blocks tile the comm contiguously (the prefix
        order must not cross hosts); gates are all derived from inputs
        every rank agrees on."""
        kind = "exscan" if exclusive else "scan"

        def _host_run(reason):
            h = self._fallback(comm, kind, reason, arr.nbytes)
            return (h.coll_exscan(comm, arr, op) if exclusive
                    else h.coll_scan(comm, arr, op))

        flat = [r for blk in st.node_blocks for r in blk]
        if flat != list(range(comm.size)):
            return _host_run("non-contiguous node blocks (prefix order "
                            "crosses hosts)")
        # _slot_bytes is non-increasing in size, so the comm-size floor
        # bounds every node arena's slot: one globally-uniform gate
        if not (_arena_dtype_ok(arr.dtype)
                and arr.nbytes <= _slot_bytes(comm.size)
                and arr.nbytes <= self._cap()):
            return _host_run("payload above the slot/arena cap or "
                            "unsupported dtype")
        node = st.node
        nr = node.rank
        intra = None
        if node.size > 1:
            trace_mod.count("coll_shm_fanin_total")
            if st.arena is not None:
                # one round, per-rank fold orders: the leader folds ALL
                # slots (the node total); members fold their prefix
                order = (list(range(node.size)) if nr == 0 else
                         list(range(nr + 1) if not exclusive
                              else range(nr)))
                intra = st.arena.scan(node, arr, op, order)
            else:
                if exclusive:
                    ex = base.exscan_linear(node, arr, op)
                    intra = ex
                    if nr == node.size - 1:
                        tot = np.asarray(op.host(ex, arr))
                        node._coll_isend(tot, 0, base.TAG_SCAN).wait()
                else:
                    intra = base.scan_linear(node, arr, op)
                    if nr == node.size - 1:
                        node._coll_isend(intra, 0, base.TAG_SCAN).wait()
                if nr == 0:
                    intra = node._coll_irecv(
                        None, node.size - 1, base.TAG_SCAN).wait().reshape(
                            arr.shape).astype(arr.dtype, copy=False)
        # own intra prefix: leaders carried the node TOTAL in ``intra``,
        # but their own prefix is trivial (first member of the block)
        own = ((None if exclusive else np.asarray(arr)) if nr == 0
               else intra)
        my_idx = st.node_idx_of[comm.rank]
        base_pref = None
        if st.leader is not None:
            total = intra if node.size > 1 else np.asarray(arr)
            base_pref = base.exscan_linear(
                st.leader, np.ascontiguousarray(total), op)
        if my_idx == 0:
            return own
        bp = self._intra_bcast(st, base_pref if nr == 0 else None, 0)
        bp = np.asarray(bp, arr.dtype).reshape(arr.shape)
        if own is None:
            return bp
        return np.asarray(op.host(bp, own)).reshape(arr.shape)
