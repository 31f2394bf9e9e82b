"""Flight recorder — per-rank time-resolved tracing + metrics export (the
port's copy of the JAX package's ``mpi/trace.py``, whole: the same
counter, histogram and pvar names, environment variables, dump file names
and wire shapes, so either package's tools read the other's dumps).

The port differs in one place: :func:`collrec_sig` signs a torch dtype
(the device route's tensors) with the numpy type code and itemsize of
the numpy dtype it stands for (``_TORCH_DTYPE_NUM``), read from the
dtype's name, so a bf16 or f32 collective signs the same in both
packages; this module imports neither torch nor numpy.  MPI-IO's four
``io`` spans (``mpi.io``: read_at, write_at, read_at_all, write_at_all)
and the host windows' ``osc`` events (``mpi.osc``: the fence, lock,
unlock, pscw_complete and pscw_wait spans and the post instant) emit as
in the JAX package.  A rank launched by an orted pushes its metrics to
the orted's collector (``ENV_METRICS_URI``), which hops them up the
daemon tree (``runtime/orted.py``).

≈ the reference's PERUSE event hooks and the MPI_T pvar discipline, but
with the time axis the counters lack: a fixed-size, lock-cheap ring
buffer of timestamped spans/instants (monotonic ns, category, rank, peer,
tag/cid, nbytes, plan class) that every transport layer feeds —
PML matching/rendezvous, btl/shm ring publish+drain, coll algorithm
selection, osc epochs, io read/write, ckpt snapshot/replay, and the
datatype convertor's pack-plan classes.

Cost discipline:

- disabled (the default): every emit site is ONE module-attribute check
  (``if trace.active:``) — no recorder object, no clock read, no dict.
- counters (``trace.count``) are always on, like ``datatype.stats``: a
  plain dict increment, no lock — they make the zero-copy/pack-plan fast
  paths observable even when the timeline is off.
- enabled: one ``monotonic_ns`` read per instant, two per span, and a
  slot store into a preallocated ring (``itertools.count`` hands out
  indices atomically under the GIL; the ring wraps, oldest events lost
  first — a flight recorder, not a log).

Export, three ways:

- :func:`flush` / ``tools/trace_export.py`` — Chrome/Perfetto trace JSON
  (one pid per rank, one tid per category).
- :func:`metrics_snapshot` — the whole ``pvar_registry`` as a
  Prometheus-style text block.
- crash dump — ``runtime.abort()`` and the SIGTERM the errmgr's abort
  path fans out both land in :func:`crash_dump`, flushing the buffer to
  ``${TMPDIR}/ompi_tpu_trace_<jobid>_rank<r>.json`` before teardown, so
  failed runs are debuggable after the fact.

Enable with ``tpurun --trace`` or ``OMPI_TPU_TRACE=1`` (read at
``ompi_tpu_torch.init()``), or programmatically via :func:`enable`.
"""

from __future__ import annotations

import itertools
import json
import os
import re
import tempfile
import threading
import time
from contextlib import contextmanager
from types import FrameType
from typing import Any, Callable, Iterator, Optional

from ompi_tpu_torch.core.config import VarType, register_var, var_registry
from ompi_tpu_torch.mpi.mpit import Pvar, PvarClass, pvar_registry

__all__ = [
    "FlightRecorder", "enable", "disable", "enabled", "env_enabled",
    "instant", "begin", "complete", "span", "count", "counters",
    "counters_snapshot", "attach_pml", "flush", "crash_dump",
    "default_path", "metrics_snapshot", "metrics_values",
    "chrome_events", "ENV_FLAG", "push_period", "start_metrics_push",
    "stop_metrics_push", "record_hist", "hists", "hists_snapshot",
    "hist_values", "hist_bucket_index", "hist_quantile_ns",
    "refresh_hist_enable", "HIST_NBUCKETS", "HIST_VLEN", "HIST_MIN_EXP",
    "CollRecorder", "collrec", "coll_post", "coll_done", "coll_err",
    "coll_event", "coll_stuck", "collrec_tail", "collrec_sig",
    "collrec_kind_id", "collrec_kind_name", "COLLREC_KINDS",
    "COLLREC_TAIL", "push_now", "trace_id", "next_span_id",
    "drain_native_spans", "timeline_capture",
]

ENV_FLAG = "OMPI_TPU_TRACE"
#: external knob: ring capacity in events (default 65536)
ENV_EVENTS = "OMPI_TPU_TRACE_EVENTS"
#: set by the owning orted when the metrics uplink is armed: the UDP
#: ``host:port`` of the daemon's local collector — each rank's pvar
#: snapshot rides there, then TAG_METRICS up the orted tree
ENV_METRICS_URI = "OMPI_TPU_METRICS_URI"
#: external knob: minimum duration (ns) a native-plane park/batch span
#: must reach before the C side records it into its span ring (bounds
#: the drain volume; 0 records everything once the timeline is armed)
ENV_NATIVE_SPAN_MIN = "OMPI_TPU_TRACE_NATIVE_MIN_NS"

#: the timeline categories (→ one Chrome tid per category at export)
CATEGORIES = ("pml", "btl", "coll", "osc", "io", "ckpt", "datatype",
              "runtime", "errmgr")

register_var("trace", "metrics_push_period", VarType.DOUBLE, 0.0,
             "seconds between pvar-snapshot pushes from each rank to its "
             "owning orted's metrics collector (rides TAG_METRICS up the "
             "daemon tree to the HNP/DVM aggregate).  0 disables the "
             "uplink; values below 0.25 s are clamped to 0.25 s — a "
             "sub-quarter-second period would make the observability "
             "plane a measurable data-plane tax")

#: floor for trace_metrics_push_period (see the var description)
PUSH_PERIOD_FLOOR = 0.25


def push_period() -> float:
    """The effective metrics-push period: 0.0 when the uplink is off,
    else the var clamped to ``PUSH_PERIOD_FLOOR``."""
    try:
        period = float(var_registry.get("trace_metrics_push_period") or 0)
    except (TypeError, ValueError):
        return 0.0
    if period <= 0:
        return 0.0
    return max(PUSH_PERIOD_FLOOR, period)

# ---------------------------------------------------------------------------
# always-on counters (the pvar-backed fast-path observability)
# ---------------------------------------------------------------------------

_COUNTER_SPECS = (
    # pack-plan classes, bumped once per committed derived/struct datatype
    ("convertor_plan_single_total", "datatypes",
     "committed datatypes whose pack plan collapsed to one memcpy"),
    ("convertor_plan_strided_total", "datatypes",
     "committed datatypes compiling to a strided block walk"),
    ("convertor_plan_runs_total", "datatypes",
     "committed datatypes compiling to coalesced absolute runs"),
    ("convertor_plan_items_total", "datatypes",
     "committed datatypes too large to expand (per-item walk)"),
    # PML payload-path split: buffer views vs staged packs
    ("pml_zero_copy_sends_total", "messages",
     "sends whose payload rode a zero-copy view of the user buffer"),
    ("pml_packed_sends_total", "messages",
     "sends staged through the convertor pack path"),
    # shm data plane
    ("btl_shm_publish_total", "frames",
     "frames published into shared-memory rings"),
    ("btl_shm_drained_total", "frames",
     "frames drained from shared-memory rings"),
    # on-node collective arena (coll/shm)
    ("coll_shm_fanin_total", "phases",
     "arena fan-in phases run by coll/shm (reduce/allreduce/allgather "
     "slot publishes + barrier arrivals)"),
    ("coll_shm_fanout_total", "phases",
     "arena fan-out phases run by coll/shm (bcast/allreduce result "
     "distribution + hierarchical releases)"),
    ("coll_shm_fallback_total", "collectives",
     "coll/shm invocations delegated to coll/host (non-commutative op, "
     "payload above the arena cap, host-algorithm directive, or no "
     "usable arena)"),
    # ULFM fault-tolerance plane (mpi/ft.py)
    ("ft_rank_deaths_total", "ranks",
     "world ranks this process's failure detector declared dead"),
    ("ft_revokes_total", "communicators",
     "communicator cids poisoned by revocation (local or remote)"),
    ("ft_agrees_total", "agreements",
     "fault-tolerant agreements completed (Comm.agree / shrink)"),
    ("ft_shrinks_total", "communicators",
     "survivor communicators built by Comm.shrink"),
    # failure containment v2 (gossip heartbeats, agree GC, arena probes)
    ("ft_gossip_beats_total", "frames",
     "rank-plane gossip liveness beats sent (epoch + peer-view frames "
     "on the FT control plane; catches in-host hangs)"),
    ("ft_agree_gc_reclaimed_total", "states",
     "per-(cid, seq) agreement states reclaimed once every live "
     "member's acked-decision watermark passed them"),
    ("coll_shm_writer_dead_total", "ranks",
     "arena waits that detected a dead writer pid via the shared btl "
     "liveness probe (failure surfaced in ~coll_shm_probe_grace "
     "seconds instead of coll_shm_timeout)"),
    # self-healing ranks (errmgr selfheal + the rejoin fence)
    ("errmgr_selfheal_revives_total", "ranks",
     "ranks the errmgr selfheal policy reaped and revived in place "
     "(counted on the launcher/HNP process)"),
    ("errmgr_selfheal_escalations_total", "ranks",
     "selfheal ladder escalations: the revive arm gave up (budget "
     "exhausted, unrevivable rank, failed start) and the policy "
     "degraded to the notify/shrink rung — or to abort when no "
     "survivors could carry the job"),
    ("ft_fenced_frames_total", "frames",
     "stale-incarnation FT control frames dropped by the rejoin fence "
     "(sent by, or stamped for, a dead life of a revived rank)"),
    # persistent collectives (coll/persistent: bind-once plans)
    ("coll_persistent_binds_total", "plans",
     "persistent-collective plans compiled by *_init — rules decision, "
     "arena slots, hierarchy splits, and nbc rounds all frozen once"),
    ("coll_persistent_starts_total", "operations",
     "Start publishes of bound persistent-collective plans (the "
     "steady-state path that skips per-op dispatch entirely)"),
    ("coll_persistent_rebinds_total", "plans",
     "persistent plans re-compiled by rebind() after invalidation (a "
     "selfheal-revived member's slot pin went stale)"),
    # MPI-4 partitioned point-to-point (pml)
    ("pml_partitioned_starts_total", "operations",
     "partitioned send/recv activations (Start on a psend_init/"
     "precv_init request)"),
    ("pml_partitioned_pready_total", "partitions",
     "partitions published by Pready on active partitioned sends"),
    # GIL-free native data plane (_native/arena.c via ctypes)
    ("coll_shm_native_waits_total", "waits",
     "arena flag waits parked in the native GIL-released executor "
     "(bounded slices; the python FT contract re-runs between them)"),
    ("coll_shm_native_publishes_total", "publishes",
     "arena slot publishes (copy + release flag store, strided sources "
     "via the convertor plan shape) fused into one native call"),
    ("coll_shm_native_folds_total", "folds",
     "width-specialized native segment folds (reduce/allreduce root "
     "folds and segment-parallel reduce-scatter segments)"),
    ("btl_shm_native_drains_total", "sweeps",
     "btl/shm poller drain sweeps woken by the native GIL-released "
     "ring park instead of the python spin window"),
    # collective flight recorder + cross-rank hang doctor
    ("coll_stuck_events_total", "waits",
     "collective waits that exceeded coll_stuck_timeout and pushed a "
     "stuck event up the metrics uplink (the HNP doctor's watchdog "
     "trigger)"),
    ("coll_doctor_captures_total", "captures",
     "rank-side doctor state captures served (recorder tail + pending "
     "p2p + thread stacks, replied to the owning orted's TAG_DOCTOR "
     "query)"),
    # collective-capable rejoin (epoch-fenced rebuild after selfheal)
    ("coll_rejoin_total", "rebuilds",
     "epoch-fenced rebuilds of the coll/shm hierarchy (node/leader "
     "splits + arena) after a member's selfheal revive was adopted — "
     "the rejoin half that makes revives transparent to collective "
     "apps (persistent-plan auto-rebinds count separately under "
     "coll_persistent_rebinds_total)"),
    # GIL-free inter-node transport (btl/tcp native plane)
    ("btl_tcp_native_writes_total", "writes",
     "GIL-released sendmsg drain calls of the btl/tcp submission-ring "
     "writer (each pushes a whole per-peer backlog; compare against "
     "batched_frames for the coalescing ratio)"),
    ("btl_tcp_native_batched_frames_total", "frames",
     "frames drained through native submission-ring writes — divided "
     "by btl_tcp_native_writes_total this is the frames-per-syscall "
     "batching ratio the msgrate bench asserts on"),
    ("btl_tcp_native_parks_total", "parks",
     "GIL-released idle parks of the btl/tcp native plane (writer "
     "doorbell waits, receive-poller slices that expired empty, and "
     "sender ring-full backpressure waits — FT checks re-run between "
     "each)"),
    # telemetry self-metering: the observability plane measured by
    # itself (the ROADMAP item-6 fan-in data — what does the uplink
    # cost, and is the recorder silently losing evidence?)
    ("metrics_push_datagrams_total", "datagrams",
     "pvar-snapshot datagrams this rank pushed to its owning orted's "
     "UDP metrics collector (periodic cadence + out-of-cadence "
     "push_now triggers)"),
    ("metrics_push_bytes_total", "bytes",
     "serialized bytes of this rank's metrics-uplink datagrams — with "
     "metrics_push_datagrams_total this is the rank→orted hop's "
     "bytes/s, the first rung of the per-hop uplink cost ladder"),
    ("trace_native_spans_total", "spans",
     "native-plane park/batch spans drained from the arena/net span "
     "rings into the flight recorder (GIL-released sections made "
     "visible; gated on the timeline being armed)"),
)

#: plain-int counter store: dict increments, no lock — losses under
#: pathological thread races are acceptable for metrics (like the
#: reference's unlocked monitoring counters)
counters: dict[str, int] = {name: 0 for name, _u, _d in _COUNTER_SPECS}


def count(name: str, delta: int = 1) -> None:
    """Bump an always-on counter (must be a registered name)."""
    counters[name] += delta


def counters_snapshot() -> dict[str, int]:
    """Point-in-time copy of every always-on counter plus the convertor
    call stats — the provenance block bench.py embeds per record."""
    snap = dict(counters)
    from ompi_tpu_torch.mpi import datatype as _dt

    snap["convertor_pack_calls_total"] = _dt.stats.pack_calls
    snap["convertor_unpack_calls_total"] = _dt.stats.unpack_calls
    snap["convertor_pack_bytes_total"] = _dt.stats.pack_bytes
    snap["convertor_unpack_bytes_total"] = _dt.stats.unpack_bytes
    return snap


for _name, _unit, _desc in _COUNTER_SPECS:
    pvar_registry.register_or_get(Pvar(
        _name, PvarClass.COUNTER, unit=_unit, description=_desc,
        read_fn=lambda _b, n=_name: counters[n]))


# ---------------------------------------------------------------------------
# latency histograms (the pvar family the counters lack a time axis for)
# ---------------------------------------------------------------------------
#
# Fixed log2 bucketing, HDR-style: bucket i holds durations whose
# nanosecond bit_length is MIN_EXP + i, i.e. dur < 2**(MIN_EXP+i) — the
# finite rungs span ~1 µs (2**10 ns) to ~16 s (2**34 ns), bucket 0
# absorbs the sub-µs underflow and the last bucket the overflow.  One
# plain-int vector per series (counts + a trailing observation sum, so
# the Prometheus render can emit honest ``_sum`` series and the
# straggler panel real wait-time shares, not midpoint estimates); the
# record path is one bit_length, one clamp, two list increments under
# the GIL — same unlocked-loss tolerance as the counters.
#
# Labeled series: ``record_hist(name, dur, labels='provider="shm"')``
# opens the sub-series ``name{provider="shm"}`` — the pvar NAME stays a
# declared ``_HIST_SPECS`` literal (the pvar-spec lint checker enforces
# both directions), only the label string is dynamic, and the DVM's
# scrape render folds the labels into the Prometheus series verbatim.

#: bucket 0 upper bound exponent: 2**10 ns ≈ 1 µs
HIST_MIN_EXP = 10
#: counts per series: 25 finite log2 rungs (le 2**10 … 2**34 ns) + overflow
HIST_NBUCKETS = 26
#: vector length: the counts plus the trailing observation sum (ns)
HIST_VLEN = HIST_NBUCKETS + 1

_HIST_SPECS = (
    ("coll_dispatch_ns", "nanoseconds",
     "blocking-collective latency at the coll dispatch choke point "
     "(labels: slot, provider, szb = log2 payload-size bucket)"),
    ("coll_host_algo_ns", "nanoseconds",
     "coll/host algorithm-body latency, labeled by collective and the "
     "algorithm the decision layer picked (the per-rung distribution "
     "the coll_xla_algorithm ladder wants)"),
    ("coll_nbc_ns", "nanoseconds",
     "nonblocking-collective schedule latency: NbcRequest post to "
     "completion (labels: kind)"),
    ("coll_pstart_ns", "nanoseconds",
     "persistent-collective Start-to-completion latency over a bound "
     "plan (labels: kind, provider)"),
    ("coll_ppublish_ns", "nanoseconds",
     "persistent arena publish time: bound-buffer copy into the pinned "
     "slot plus the arrive flag store (the straggler panel's 'work' "
     "half)"),
    ("coll_arena_wait_ns", "nanoseconds",
     "coll/shm arena flag-wait time (arrive/depart spins, one-shot and "
     "persistent) — the cross-rank straggler signal: a rank whose wait "
     "share is LOW is the one everyone else waits for"),
    ("pml_eager_send_ns", "nanoseconds",
     "eager-protocol isend latency: entry to local completion/handoff"),
    ("pml_rndv_send_ns", "nanoseconds",
     "rendezvous data push latency on the send worker: CTS-released "
     "fragment stream start to last fragment delivered"),
    ("btl_shm_drain_ns", "nanoseconds",
     "btl/shm poller drain-batch latency: one sweep over a peer ring "
     "that yielded frames"),
    ("btl_tcp_write_ns", "nanoseconds",
     "btl/tcp submission-ring drain-batch latency: one writer sweep "
     "over a peer backlog, enqueue-visible to kernel-accepted (the "
     "straggler panel's inter-node stall signal, the tcp twin of "
     "btl_shm_drain_ns)"),
    ("coll_rejoin_ns", "nanoseconds",
     "epoch-fenced coll-hierarchy rebuild latency after a selfheal "
     "revive: stale-state teardown through the re-agreed epoch, "
     "node/leader re-split and arena re-bootstrap (the rejoin half of "
     "kill -> first-successful-full-world-collective)"),
)

_HIST_NAMES = frozenset(n for n, _u, _d in _HIST_SPECS)

#: series key → [count_0 … count_25, sum_ns]; keys are either a bare
#: declared name or ``name{label="v",…}`` for labeled sub-series
hists: dict[str, list[int]] = {}

register_var("trace", "hist_enable", VarType.BOOL, True,
             "arm the always-on latency histogram plane (coll dispatch, "
             "persistent Start, arena waits, pml eager/rndv, btl drain "
             "batches).  Independent of the span timeline; the record "
             "path costs ~one dict hit + two int increments (measured "
             "in PERF.md).  Re-read by trace.refresh_hist_enable()")

#: THE flag every record site checks first (mirrors ``active`` for the
#: timeline) — refreshed from the ``trace_hist_enable`` var, not read
#: through the registry per event
hist_active = True


def refresh_hist_enable() -> bool:
    """Re-read ``trace_hist_enable`` into the module flag (called at
    init(); tests and tools call it after flipping the var)."""
    global hist_active
    try:
        hist_active = bool(var_registry.get("trace_hist_enable"))
    except Exception:  # noqa: BLE001 — a broken knob must not disarm init
        hist_active = True
    return hist_active


def _new_hist_series(name: str, key: str) -> list[int]:
    """Open a series vector; an undeclared base name is a KeyError, the
    same hot-path discipline as an undeclared counter bump."""
    if name not in _HIST_NAMES:
        raise KeyError(name)
    return hists.setdefault(key, [0] * HIST_VLEN)


def record_hist(name: str, dur_ns: int, labels: str = "") -> None:
    """Record one duration into a declared histogram (``labels`` is a
    preformatted Prometheus label-pair fragment opening a sub-series)."""
    key = f"{name}{{{labels}}}" if labels else name
    vec = hists.get(key)
    if vec is None:
        vec = _new_hist_series(name, key)
    i = dur_ns.bit_length() - HIST_MIN_EXP
    if i < 0:
        i = 0
    elif i >= HIST_NBUCKETS:
        i = HIST_NBUCKETS - 1
    vec[i] += 1
    vec[HIST_NBUCKETS] += dur_ns


def hist_bucket_index(dur_ns: int) -> int:
    """The bucket a duration lands in (exposed for tests/tools)."""
    i = int(dur_ns).bit_length() - HIST_MIN_EXP
    return 0 if i < 0 else min(i, HIST_NBUCKETS - 1)


def hist_quantile_ns(counts: list[int], q: float) -> float:
    """Estimate the q-quantile (0..1) from a bucket-count vector (the
    counts only — pass ``vec[:HIST_NBUCKETS]``).  Uses the geometric
    midpoint of the landing bucket's range; log2 buckets bound the
    estimate within ~sqrt(2) of the true value."""
    total = sum(counts[:HIST_NBUCKETS])
    if total <= 0:
        return 0.0
    target = q * total
    seen = 0
    for i, c in enumerate(counts[:HIST_NBUCKETS]):
        seen += c
        if seen >= target and c:
            hi = 1 << (HIST_MIN_EXP + i)
            return float(hi) / 1.4142135623730951   # hi / sqrt(2)
    return float(1 << (HIST_MIN_EXP + HIST_NBUCKETS - 1))


def hist_values() -> dict[str, list[int]]:
    """Every series vector by key, copied — the vector payload of the
    metrics uplink (scalar pvars ride :func:`metrics_values`)."""
    return {k: list(v) for k, v in hists.items()}


def hists_snapshot() -> dict[str, list[int]]:
    """Alias of :func:`hist_values` for symmetry with
    :func:`counters_snapshot` (benchmarks diff two snapshots)."""
    return hist_values()


for _name, _unit, _desc in _HIST_SPECS:
    pvar_registry.register_or_get(Pvar(
        _name, PvarClass.AGGREGATE, unit=_unit, description=_desc,
        # the read is the series map for this base (bare + labeled) —
        # a dict, so the scalar metrics walk skips it by design
        read_fn=lambda _b, n=_name: {
            k: list(v) for k, v in hists.items()
            if k == n or k.startswith(n + "{")}))


# ---------------------------------------------------------------------------
# collective flight recorder (always-on, beside the span ring)
# ---------------------------------------------------------------------------
#
# The "which collective is this rank in, and since when" record the hang
# doctor reads: a bounded ring of fixed-shape tuples fed by the coll
# dispatch choke point, nbc round advances, persistent Start/completion
# and the shm arena's slow-path waits.  Unlike the span ring it is NOT
# gated on ``active`` — it must already hold the evidence when a job
# wedges (target <1µs/record; measured in PERF.md).  Cross-rank matching
# key: (cid, op_seq) where op_seq is a per-(rank, cid) dispatch ordinal —
# ranks of one communicator issue matching collectives in the same order,
# so divergent kind/signature at one (cid, op_seq) IS the MPI-illegal
# collective mismatch the doctor's verdict names.

#: external knob: collective-recorder ring capacity in records
ENV_COLLREC_EVENTS = "OMPI_TPU_COLLREC_EVENTS"

#: how many trailing records ride a doctor capture / crash dump
COLLREC_TAIL = 256

_COLLREC_BASE = (
    "barrier", "bcast", "reduce", "allreduce", "gather", "allgather",
    "scatter", "alltoall", "reduce_scatter", "reduce_scatter_block",
    "scan", "exscan", "gatherv", "scatterv", "allgatherv", "alltoallv",
    "alltoallw")

#: the kind vocabulary: blocking dispatch slots, nbc schedules ("i"),
#: persistent Starts ("p") — indexed so the pushed recorder head can
#: ride the scalar metrics uplink as ``coll_cur_kind_id``
COLLREC_KINDS = (_COLLREC_BASE
                 + tuple("i" + k for k in _COLLREC_BASE)
                 + tuple("p" + k for k in _COLLREC_BASE))

_KIND_IDS = {k: i for i, k in enumerate(COLLREC_KINDS)}


def collrec_kind_id(kind: str) -> int:
    """The wire id of a collective kind (-1 for an unknown name)."""
    return _KIND_IDS.get(kind, -1)


def collrec_kind_name(kind_id: int) -> str:
    """Inverse of :func:`collrec_kind_id` ("?" for out-of-range)."""
    if 0 <= kind_id < len(COLLREC_KINDS):
        return COLLREC_KINDS[kind_id]
    return "?"


#: per-kind crc32 cache for the signature mix (one encode per kind ever)
_SIG_KIND: dict[str, int] = {}

#: a torch dtype's name → (numpy type code, itemsize) of the numpy dtype
#: the JAX package signs for the same collective.  bfloat16 and the
#: float8 types are ml_dtypes' registrations (256, 260, 262 where they
#: are registered first, as the JAX package's process does); the parity
#: test holds every entry against ``np.dtype(jnp.<t>)``
_TORCH_DTYPE_NUM = {
    "torch.bool": (0, 1), "torch.int8": (1, 1), "torch.uint8": (2, 1),
    "torch.int16": (3, 2), "torch.uint16": (4, 2),
    "torch.int32": (5, 4), "torch.uint32": (6, 4),
    "torch.int64": (7, 8), "torch.uint64": (8, 8),
    "torch.float32": (11, 4), "torch.float64": (12, 8),
    "torch.complex64": (14, 8), "torch.complex128": (15, 16),
    "torch.float16": (23, 2), "torch.bfloat16": (256, 2),
    "torch.float8_e4m3fn": (260, 1), "torch.float8_e5m2": (262, 1),
}


def collrec_sig(kind: str, dtype: Any, nbytes: int, root: int = -1) -> int:
    """Deterministic cross-process signature of a collective's shape —
    crc32-seeded integer mix, NOT hash(): PYTHONHASHSEED randomization
    would make equal signatures diverge across ranks and every op read
    as a mismatch.  Pure int math on the dispatch hot path (~0.3 µs);
    the dtype contributes its stable numpy type code + itemsize (a torch
    dtype: those of its numpy counterpart, ``_TORCH_DTYPE_NUM``)."""
    import zlib

    kc = _SIG_KIND.get(kind)
    if kc is None:
        kc = _SIG_KIND[kind] = zlib.crc32(kind.encode())
    dn = 0
    if dtype is not None:
        num = getattr(dtype, "num", None)
        if num is not None:
            dn = (int(num) << 8) | int(getattr(dtype, "itemsize", 0))
        else:
            name = str(dtype)
            ni = _TORCH_DTYPE_NUM.get(name)
            dn = ((ni[0] << 8) | ni[1] if ni is not None
                  else zlib.crc32(name.encode()))
    return (kc ^ (nbytes * 2654435761) ^ ((root + 3) * 2246822519)
            ^ (dn * 3266489917)) & 0xFFFFFFFF


#: one record: (ts_ns, rank, cid, op_seq, kind, phase, sig, info|None);
#: phases: post / done / err (dispatch), wait / stuck (arena slow path),
#: pub (persistent slot publish), round (nbc round advance), start
#: (persistent Start), fold (arena fold), fault (injected chaos)
_CollRecord = tuple[int, int, int, int, str, str, int,
                    Optional[dict[str, Any]]]


class CollRecorder:
    """The per-rank collective flight recorder ring (always-on).

    Keyed by (rank, cid) so the in-process multi-rank test harness —
    several PMLs in one interpreter — keeps each rank's op_seq stream
    intact; a launched rank process has exactly one rank key."""

    def __init__(self, capacity: int = 1024) -> None:
        self.capacity = max(64, int(capacity))
        self._buf: list[Optional[_CollRecord]] = [None] * self.capacity
        self._n = itertools.count()
        self._hwm = 0
        self._seq: dict[tuple[int, int], int] = {}
        #: (rank, cid) → STACK of (op_seq, kind, sig, t_post_ns,
        #: wall_post_s) between post and done — a stack because composed
        #: collectives nest (the shm barrier dispatches host allgathers
        #: through the same choke point); events attribute to the
        #: innermost in-flight op and a nested done re-exposes its parent
        self.current: dict[tuple[int, int],
                           list[tuple[int, str, int, int, float]]] = {}
        #: dispatch ordinal across all comms of this process (what
        #: faultinject's @coll=N triggers count)
        self.ops_total = 0
        #: the pushed head: [rank, cid, op_seq, kind_id, t_post_ns,
        #: done, wall_post_s] — wall_post_s (NOT an age) rides the
        #: uplink: a stable per-op value keeps the delta compression
        #: intact, and the DVM computes the age itself
        self.head: Optional[list[float]] = None

    def _add(self, rec: _CollRecord) -> None:
        i = next(self._n)
        self._buf[i % self.capacity] = rec
        self._hwm = i + 1

    def post(self, rank: int, cid: int, kind: str, sig: int,
             provider: Optional[str], nbytes: int) -> int:
        key = (rank, cid)
        seq = self._seq.get(key, -1) + 1
        self._seq[key] = seq
        now = time.monotonic_ns()
        wall = time.time()
        self.ops_total += 1
        self.current.setdefault(key, []).append(
            (seq, kind, sig, now, wall))
        self.head = [rank, cid, seq, _KIND_IDS.get(kind, -1), now, 0,
                     wall]
        self._add((now, rank, cid, seq, kind, "post", sig,
                   {"prov": provider, "nb": nbytes}))
        return seq

    def _pop_current(self, rank: int, cid: int, seq: int) -> None:
        key = (rank, cid)
        stack = self.current.get(key)
        if stack:
            for i in range(len(stack) - 1, -1, -1):
                if stack[i][0] == seq:
                    del stack[i]
                    break
        if stack:
            # a nested op closed: the head goes back to its still-open
            # parent (a wedged outer collective must not read as done)
            top = stack[-1]
            self.head = [rank, cid, top[0],
                         _KIND_IDS.get(top[1], -1), top[3], 0, top[4]]
        else:
            self.current.pop(key, None)
            h = self.head
            if h is not None and h[0] == rank and h[1] == cid \
                    and h[2] == seq:
                h[5] = 1

    def done(self, rank: int, cid: int, seq: int, kind: str) -> None:
        self._pop_current(rank, cid, seq)
        self._add((time.monotonic_ns(), rank, cid, seq, kind, "done",
                   0, None))

    def err(self, rank: int, cid: int, seq: int, kind: str,
            exc: str) -> None:
        self._pop_current(rank, cid, seq)
        self._add((time.monotonic_ns(), rank, cid, seq, kind, "err",
                   0, {"exc": exc}))

    def event(self, rank: int, cid: int, phase: str,
              info: Optional[dict[str, Any]] = None,
              seq: Optional[int] = None,
              kind: Optional[str] = None) -> tuple[int, str]:
        """A phase record attributed to the in-flight op on (rank, cid)
        (or to an explicit seq/kind for nbc/persistent callers)."""
        if seq is None or kind is None:
            stack = self.current.get((rank, cid))
            if stack:
                top = stack[-1]
                seq = top[0] if seq is None else seq
                kind = top[1] if kind is None else kind
            else:
                seq = -1 if seq is None else seq
                kind = "?" if kind is None else kind
        self._add((time.monotonic_ns(), rank, cid, seq, kind, phase,
                   0, info))
        return seq, kind

    @property
    def records_total(self) -> int:
        return self._hwm

    def snapshot(self) -> list[_CollRecord]:
        n = self._hwm
        if n <= self.capacity:
            out = self._buf[:n]
        else:
            cut = n % self.capacity
            out = self._buf[cut:] + self._buf[:cut]
        return [r for r in out if r is not None]

    def tail(self, limit: int = COLLREC_TAIL) -> list[list[Any]]:
        """The newest ``limit`` records as JSON/DSS-safe lists — the
        payload of doctor captures and crash dumps."""
        snap = self.snapshot()[-max(0, int(limit)):]
        return [list(r) for r in snap]

    def reset(self) -> None:
        """Tests only: forget every record, seq counter and head."""
        self._buf = [None] * self.capacity
        self._n = itertools.count()
        self._hwm = 0
        self._seq.clear()
        self.current.clear()
        self.ops_total = 0
        self.head = None


def _collrec_capacity() -> int:
    try:
        return int(os.environ.get(ENV_COLLREC_EVENTS, "") or 1024)
    except ValueError:
        return 1024      # a bad sizing knob must not kill import


#: THE process-global recorder (always armed; ~100 KiB at the default
#: 1024-record capacity)
collrec = CollRecorder(_collrec_capacity())


def coll_post(rank: int, cid: int, kind: str, sig: int,
              provider: Optional[str], nbytes: int) -> int:
    """Record a collective dispatch; returns its per-(rank, cid) op_seq."""
    return collrec.post(rank, cid, kind, sig, provider, nbytes)


def coll_done(rank: int, cid: int, seq: int, kind: str) -> None:
    collrec.done(rank, cid, seq, kind)


def coll_err(rank: int, cid: int, seq: int, kind: str, exc: str) -> None:
    collrec.err(rank, cid, seq, kind, exc)


def coll_event(rank: int, cid: int, phase: str,
               info: Optional[dict[str, Any]] = None,
               seq: Optional[int] = None,
               kind: Optional[str] = None) -> tuple[int, str]:
    return collrec.event(rank, cid, phase, info, seq=seq, kind=kind)


def coll_stuck(rank: int, cid: int, waited_s: float,
               on: Optional[int]) -> None:
    """An arena wait crossed ``coll_stuck_timeout``: record it, bump the
    watchdog counter and force an immediate metrics push so the HNP's
    doctor learns within one uplink hop instead of a push period."""
    count("coll_stuck_events_total")
    info: dict[str, Any] = {"s": round(waited_s, 2)}
    if on is not None:
        info["on"] = on
    collrec.event(rank, cid, "stuck", info)
    push_now()


def push_now() -> None:
    """One out-of-cadence metrics push (no-op when the uplink is off) —
    how a stuck event beats the push period to the HNP."""
    pusher = _pusher
    if pusher is not None:
        pusher.push()


def collrec_tail(limit: int = COLLREC_TAIL) -> list[list[Any]]:
    return collrec.tail(limit)


def _collrec_head(i: int, default: float = -1) -> float:
    h = collrec.head
    return float(h[i]) if h is not None else default


for _name, _klass, _unit, _desc, _read in (
    ("coll_recorder_ops", PvarClass.COUNTER, "operations",
     "collectives recorded by this process's flight recorder (posts "
     "across blocking dispatch, nbc launches and persistent Starts)",
     lambda _b: collrec.ops_total),
    ("coll_cur_seq", PvarClass.LEVEL, "operations",
     "op_seq of the recorder head (the last collective posted; -1 "
     "before the first) — with coll_cur_kind_id/cid/done/age_s this is "
     "the pushed head the --dvm-ps last_coll column and the doctor's "
     "no-response fallback read",
     lambda _b: _collrec_head(2)),
    ("coll_cur_kind_id", PvarClass.LEVEL, "kind",
     "COLLREC_KINDS index of the recorder head's kind (-1 = none)",
     lambda _b: _collrec_head(3)),
    ("coll_cur_cid", PvarClass.LEVEL, "communicator",
     "cid of the recorder head (-1 = none)",
     lambda _b: _collrec_head(1)),
    ("coll_cur_done", PvarClass.LEVEL, "flag",
     "1 when the recorder head completed, 0 while it is in flight "
     "(a rank whose head stays 0 with a growing age is wedged)",
     lambda _b: _collrec_head(5, default=1)),
    ("coll_cur_posted_ts", PvarClass.LEVEL, "seconds",
     "wall-clock time the recorder head was posted (0 before the "
     "first).  A stable per-op value — NOT an age, which would change "
     "every read and defeat the uplink's delta compression; the DVM "
     "computes ages against its own clock",
     lambda _b: _collrec_head(6, default=0.0)),
):
    pvar_registry.register_or_get(Pvar(
        _name, _klass, unit=_unit, description=_desc, read_fn=_read))


def _recorder_stat(attr: str) -> float:
    # late-bound: `recorder` is defined below this registration block
    rec = globals().get("recorder")
    return float(getattr(rec, attr)) if rec is not None else 0.0


# flight-recorder loss accounting as pushed pvars: silent trace loss
# (a wrapped ring overwriting evidence) becomes visible on /status and
# --dvm-ps instead of only inside a postmortem dump's otherData
for _name, _klass, _unit, _desc, _read in (
    ("trace_events_total", PvarClass.COUNTER, "events",
     "events ever emitted into this rank's flight-recorder ring "
     "(0 while the timeline is disarmed)",
     lambda _b: _recorder_stat("events_total")),
    ("trace_dropped_total", PvarClass.COUNTER, "events",
     "flight-recorder events lost to ring wrap (events_total beyond "
     "capacity) — a nonzero value means the merged timeline has holes "
     "and OMPI_TPU_TRACE_EVENTS should grow",
     lambda _b: _recorder_stat("dropped")),
    ("trace_ring_occupancy", PvarClass.LEVEL, "events",
     "events currently held in the flight-recorder ring "
     "(min(events_total, capacity))",
     lambda _b: min(_recorder_stat("events_total"),
                    _recorder_stat("capacity"))),
    ("trace_ring_capacity", PvarClass.LEVEL, "events",
     "flight-recorder ring capacity (OMPI_TPU_TRACE_EVENTS; 0 while "
     "disarmed)",
     lambda _b: _recorder_stat("capacity")),
):
    pvar_registry.register_or_get(Pvar(
        _name, _klass, unit=_unit, description=_desc, read_fn=_read))


# ---------------------------------------------------------------------------
# the ring buffer
# ---------------------------------------------------------------------------

#: one ring slot: (ts_ns, dur_ns|None, category, name, rank, args|None)
_Event = tuple[int, Optional[int], str, str, int,
               Optional[dict[str, Any]]]


class FlightRecorder:
    """Fixed-size ring of trace events.

    An event is the tuple ``(ts_ns, dur_ns|None, category, name, rank,
    args|None)``; ``dur_ns is None`` ⇒ instant, else a complete span that
    STARTED at ``ts_ns``.  ``itertools.count`` hands out slot indices
    atomically (CPython GIL), so concurrent emitters never fight over a
    lock on the hot path; a wrapped ring simply forgets the oldest
    events.
    """

    def __init__(self, capacity: int = 65536, rank: int = -1,
                 jobid: int = 0) -> None:
        self.capacity = max(16, int(capacity))
        self.rank = rank
        self.jobid = jobid
        self._buf: list[Optional[_Event]] = [None] * self.capacity
        self._n = itertools.count()
        self._hwm = 0           # highest index handed out + 1 (approx.)

    def add(self, ts_ns: int, dur_ns: Optional[int], cat: str, name: str,
            rank: int, args: Optional[dict[str, Any]]) -> None:
        i = next(self._n)
        self._buf[i % self.capacity] = (ts_ns, dur_ns, cat, name, rank,
                                        args)
        self._hwm = i + 1

    @property
    def events_total(self) -> int:
        return self._hwm

    @property
    def dropped(self) -> int:
        return max(0, self._hwm - self.capacity)

    def snapshot(self) -> list[_Event]:
        """Events in (approximate) emission order, oldest first."""
        n = self._hwm
        if n <= self.capacity:
            out = self._buf[:n]
        else:
            cut = n % self.capacity
            out = self._buf[cut:] + self._buf[:cut]
        return [e for e in out if e is not None]


# module state: `active` is THE flag every emit site checks
active = False
recorder: Optional[FlightRecorder] = None
_lock = threading.Lock()
_old_sigterm: Any = None
_sigterm_installed = False
#: (pml, cb) pairs attach_pml registered
_pml_listeners: list[tuple[Any, Callable[[str, Any], None]]] = []

# ---------------------------------------------------------------------------
# trace context (trace_id, span_id): the causal-flow pair carried in PML
# match headers and control-plane envelopes so the exporter can stitch
# send→recv, collective rounds and capture fan-outs across ranks
# ---------------------------------------------------------------------------

#: span-id namespace stride (mirrors pml._FLOW_STRIDE): ids are
#: ``rank * stride + local counter`` — globally unique without any
#: cross-rank coordination
SPAN_ID_STRIDE = 1 << 40

_trace_id = 0
_span_ids = itertools.count(1)


def trace_id() -> int:
    """The job-wide trace id (crc32 of the jobid — DETERMINISTIC across
    ranks and processes, never hash(): PYTHONHASHSEED randomization
    would split one job's flow edges into disjoint traces).  0 until
    :func:`enable` learns a jobid."""
    return _trace_id


def _compute_trace_id(jobid: int) -> int:
    import zlib

    return zlib.crc32(b"ompi_tpu_trace_%d" % int(jobid)) or 1


def next_span_id(rank: int = -1) -> int:
    """A fresh globally-unique span id for flow correlation (the
    span_id half of the (trace_id, span_id) context pair)."""
    r = rank if rank >= 0 else (recorder.rank if recorder is not None
                                else 0)
    return max(0, r) * SPAN_ID_STRIDE + next(_span_ids)


def env_enabled() -> bool:
    return os.environ.get(ENV_FLAG, "") not in ("", "0")


def enabled() -> bool:
    return active


def enable(capacity: Optional[int] = None, rank: int = -1,
           jobid: int = 0, install_signal: bool = False) -> FlightRecorder:
    """Arm the flight recorder (idempotent).  ``install_signal`` chains a
    SIGTERM handler that flushes the buffer before dying — the errmgr
    abort path kills ranks with SIGTERM (then a grace, then SIGKILL), so
    every rank's trace survives a job teardown."""
    global active, recorder, _trace_id
    with _lock:
        if recorder is None:
            if capacity is None:
                try:
                    capacity = int(os.environ.get(ENV_EVENTS, "")
                                   or 65536)
                except ValueError:
                    # a bad sizing knob must not kill the job at init
                    capacity = 65536
            recorder = FlightRecorder(capacity, rank=rank, jobid=jobid)
        else:
            # idempotent re-enable must still adopt a LATER-learned
            # identity (an app that armed tracing before init() would
            # otherwise flush every rank to the shared rank--1 path,
            # ranks clobbering each other's dumps)
            if rank != -1:
                recorder.rank = rank
            if jobid:
                recorder.jobid = jobid
        active = True
        _trace_id = _compute_trace_id(recorder.jobid)
    _native_spans_arm(True)
    if install_signal:
        _install_sigterm_flush()
    return recorder


def disable() -> Optional[FlightRecorder]:
    """Disarm; returns the recorder (snapshot/flush still work on it).
    Also detaches every PML listener :func:`attach_pml` registered —
    leaving one behind would keep the PML's eager fast lane bypassed
    (it gates on having no listeners) long after tracing stopped."""
    global active, recorder
    with _lock:
        active = False
        rec, recorder = recorder, None
        listeners, _pml_listeners[:] = list(_pml_listeners), []
    _native_spans_arm(False)
    for pml, cb in listeners:
        try:
            pml.remove_listener(cb)
        except ValueError:
            pass
    return rec


def _install_sigterm_flush() -> None:
    """Best-effort: only the main thread may install handlers, and a
    launcher (tpurun --timeout) may own SIGTERM already — chain it.
    Idempotent: a second enable() must NOT chain the handler onto
    itself (the self-referential _old_sigterm would recurse forever
    inside the signal handler)."""
    global _old_sigterm, _sigterm_installed
    if _sigterm_installed:
        return
    import signal

    def _flush_and_die(signum: int, frame: Optional[FrameType]) -> None:
        try:
            crash_dump(reason="sigterm")
        except Exception:  # noqa: BLE001 — dying anyway
            pass
        if callable(_old_sigterm):
            _old_sigterm(signum, frame)
        elif _old_sigterm is signal.SIG_IGN:
            return   # the process was ignoring SIGTERM; keep ignoring
        else:
            signal.signal(signal.SIGTERM, signal.SIG_DFL)
            os.kill(os.getpid(), signal.SIGTERM)

    try:
        _old_sigterm = signal.signal(signal.SIGTERM, _flush_and_die)
        _sigterm_installed = True
    except (ValueError, OSError):   # not the main thread
        pass


# ---------------------------------------------------------------------------
# emit API (call sites gate on `trace.active` FIRST — see module doc)
# ---------------------------------------------------------------------------

def instant(cat: str, name: str, rank: int = -1, **args: Any) -> None:
    r = recorder
    if r is not None:
        r.add(time.monotonic_ns(), None, cat, name, rank,
              args or None)


def begin() -> int:
    """Span start timestamp (pair with :func:`complete`)."""
    return time.monotonic_ns()


def complete(cat: str, name: str, t0_ns: int, rank: int = -1,
             **args: Any) -> None:
    r = recorder
    if r is not None:
        now = time.monotonic_ns()
        r.add(t0_ns, now - t0_ns, cat, name, rank, args or None)


@contextmanager
def span(cat: str, name: str, rank: int = -1,
         **args: Any) -> Iterator[None]:
    t0 = time.monotonic_ns()
    try:
        yield
    finally:
        complete(cat, name, t0, rank=rank, **args)


def attach_pml(pml: Any) -> Any:
    """Bridge the PML's PERUSE-style EVT_* hooks into the timeline: every
    request-lifecycle event becomes a ``pml`` instant.  Returns the
    listener so a caller can ``pml.remove_listener`` it.

    Observer effect (same as attaching a monitoring.Monitor): a PML with
    listeners bypasses its compiled eager fast lane (_isend_fast gates on
    ``not self._listeners`` — the lane emits no events), so a TIMELINE
    run routes eligible eager sends down the header path.  The always-on
    counters (``pml_zero_copy_sends_total`` etc.) need no listener and
    observe the fast lane undisturbed — use them, not an enabled
    timeline, when measuring the fast path itself."""
    prank = pml.rank

    def _on_event(event: str, info: dict[str, Any]) -> None:
        if active:
            instant("pml", event, rank=prank, **info)

    pml.add_listener(_on_event)
    _pml_listeners.append((pml, _on_event))   # detached by disable()
    return _on_event


def detach_pml(pml: Any) -> None:
    """Remove the listener(s) attach_pml registered on ``pml`` — called
    from finalize() so a later init() epoch re-arms a FRESH bridge
    instead of keeping a closed PML in the listener table."""
    for pair in [p for p in _pml_listeners if p[0] is pml]:
        _pml_listeners.remove(pair)
        try:
            pml.remove_listener(pair[1])
        except ValueError:
            pass


# ---------------------------------------------------------------------------
# native-plane spans: arena.c / net.c park+batch begin–end pairs drained
# from the C-side span rings into the flight recorder, so GIL-released
# sections stop being invisible gaps in the timeline
# ---------------------------------------------------------------------------

#: below this duration the C side skips the ring store entirely (the
#: drain must not become its own hot-path tax); overridable via
#: OMPI_TPU_TRACE_NATIVE_MIN_NS
_NATIVE_SPAN_MIN_DEFAULT = 10_000


def _native_span_min_ns() -> int:
    try:
        return int(os.environ.get(ENV_NATIVE_SPAN_MIN, "")
                   or _NATIVE_SPAN_MIN_DEFAULT)
    except ValueError:
        return _NATIVE_SPAN_MIN_DEFAULT


def _native_spans_arm(on: bool) -> None:
    """Best-effort arm/disarm of the C span rings (no-op when the
    native plane never built — the timeline works without it)."""
    try:
        from ompi_tpu_torch import _native

        _native.spans_enable(_native_span_min_ns() if on else -1)
    except Exception:  # noqa: BLE001 — observability must not break init
        pass


def drain_native_spans(limit: int = 4096) -> int:
    """Pull completed park/batch spans out of the native rings into the
    flight recorder (called on the uplink cadence, at flush, and by the
    live timeline capture).  Returns the number of spans drained."""
    rec = recorder
    if rec is None:
        return 0
    try:
        from ompi_tpu_torch import _native

        spans = _native.spans_drain(limit)
    except Exception:  # noqa: BLE001 — native plane absent: nothing to do
        return 0
    for name, t0_ns, t1_ns in spans:
        rec.add(t0_ns, t1_ns - t0_ns, "runtime", f"native_{name}",
                rec.rank, None)
    if spans:
        count("trace_native_spans_total", len(spans))
    return len(spans)


def timeline_capture(tail: int = 2048) -> dict[str, Any]:
    """The bounded live-capture payload a TAG_TIMELINE doctor query
    pulls from a RUNNING rank: the newest ``tail`` chrome events plus
    the clock anchor and loss accounting the HNP merge needs.  Safe
    with tracing off (events empty, anchors still valid)."""
    drain_native_spans()
    rec = recorder
    events = chrome_events(rec)[-max(0, int(tail)):] if rec else []
    return {
        "rank": rec.rank if rec else -1,
        "jobid": rec.jobid if rec else 0,
        "trace_id": _trace_id,
        "events": events,
        "events_total": rec.events_total if rec else 0,
        "dropped": rec.dropped if rec else 0,
        "capacity": rec.capacity if rec else 0,
        "clock_offset_ns": time.time_ns() - time.monotonic_ns(),
        "counters": counters_snapshot(),
        "collrec": collrec_tail(64),
    }


# ---------------------------------------------------------------------------
# export
# ---------------------------------------------------------------------------

def chrome_events(rec: Optional[FlightRecorder] = None,
                  pid: Optional[int] = None) -> list[dict[str, Any]]:
    """The recorder's events as Chrome trace-event dicts (ts/dur in µs,
    one pid per rank, one tid per category)."""
    rec = rec if rec is not None else recorder
    if rec is None:
        return []
    tids = {c: i for i, c in enumerate(CATEGORIES)}
    out: list[dict[str, Any]] = []
    for ts_ns, dur_ns, cat, name, rank, args in rec.snapshot():
        ev_pid = pid if pid is not None else (
            rank if rank >= 0 else rec.rank)
        ev: dict[str, Any] = {
            "name": name, "cat": cat,
            "ph": "X" if dur_ns is not None else "i",
            "ts": ts_ns / 1000.0,
            "pid": ev_pid,
            "tid": tids.get(cat, len(CATEGORIES)),
        }
        if dur_ns is not None:
            ev["dur"] = dur_ns / 1000.0
        else:
            ev["s"] = "t"          # instant scope: thread
        if args:
            ev["args"] = args
        out.append(ev)
    out.sort(key=lambda e: e["ts"])
    return out


def default_path(jobid: Optional[int] = None,
                 rank: Optional[int] = None) -> str:
    rec = recorder
    if jobid is None:
        jobid = rec.jobid if rec is not None else 0
    if rank is None:
        rank = rec.rank if rec is not None else -1
    tmp = os.environ.get("TMPDIR") or tempfile.gettempdir()
    return os.path.join(tmp, f"ompi_tpu_trace_{jobid}_rank{rank}.json")


def flush(path: Optional[str] = None,
          rec: Optional[FlightRecorder] = None) -> Optional[str]:
    """Write this rank's buffer as a standalone Chrome trace JSON file;
    returns the path (None when there is nothing to flush)."""
    rec = rec if rec is not None else recorder
    if rec is None:
        return None
    if rec is recorder:
        drain_native_spans()     # GIL-released sections land in the dump
    if path is None:
        path = default_path(rec.jobid, rec.rank)
    doc = {
        "displayTimeUnit": "ns",
        "otherData": {
            "rank": rec.rank, "jobid": rec.jobid,
            "trace_id": _trace_id,
            "events_total": rec.events_total, "dropped": rec.dropped,
            # wall-vs-monotonic anchor: event ts are CLOCK_MONOTONIC
            # (boot-relative, per machine); the exporter uses this
            # offset to detect dumps whose clocks share no base
            # (ranks on different hosts)
            "clock_offset_ns": time.time_ns() - time.monotonic_ns(),
            "counters": counters_snapshot(),
            # latency-histogram vectors ([counts…, sum_ns] per series):
            # tools/straggler_report.py's offline mode reads these from
            # merged per-rank dumps when no live aggregate is reachable
            "hists": hist_values(),
            # collective-recorder tail: the postmortem hang doctor
            # (tools/hang_doctor.py --dir) reads these from crash dumps
            # when no live control plane is left to capture
            "collrec": collrec_tail(),
            "collrec_total": collrec.records_total,
        },
        "traceEvents": chrome_events(rec),
    }
    tmp_path = f"{path}.tmp.{os.getpid()}"
    with open(tmp_path, "w", encoding="utf-8") as f:
        # span args are recorded verbatim — apps pass numpy scalars and
        # other non-JSON types; a dump that raised here would break
        # finalize/abort under tracing, so coerce instead
        json.dump(doc, f, default=_json_coerce)
    os.replace(tmp_path, path)     # readers never see a partial dump
    return path


def _json_coerce(obj: Any) -> Any:
    """Last-resort encoder for event args (numpy scalars → numbers,
    everything else → its repr)."""
    for cast in (int, float):
        try:
            return cast(obj)
        except (TypeError, ValueError):
            continue
    return repr(obj)


def crash_dump(reason: str = "abort") -> Optional[str]:
    """The teardown flush: called from ``runtime.abort()`` and the
    SIGTERM handler the errmgr abort path triggers.  Stamps the reason as
    a final runtime instant so the timeline shows WHY it ends."""
    rec = recorder
    if rec is None:
        return None
    rec.add(time.monotonic_ns(), None, "runtime", f"crash_dump:{reason}",
            rec.rank, None)
    try:
        return flush(rec=rec)
    except Exception:  # noqa: BLE001 — teardown path must not raise
        return None


_METRIC_RE = re.compile(r"[^a-zA-Z0-9_]")


def metrics_values() -> dict[str, float]:
    """Every scalar pvar's current value by name — the numeric walk
    behind :func:`metrics_snapshot` and the payload of the metrics
    uplink (non-numeric and binding-required pvars are skipped — a
    scraper wants scalars)."""
    out: dict[str, float] = {}
    for name in pvar_registry.names():
        pv = pvar_registry.lookup(name)
        if pv.requires_binding:
            continue
        try:
            v = pv.read()
        except Exception:  # noqa: BLE001 — unreadable pvar: skip
            continue
        if isinstance(v, bool) or not isinstance(v, (int, float)):
            continue
        out[name] = v
    return out


def metrics_snapshot() -> str:
    """Walk ``pvar_registry`` into a Prometheus-style text block
    (COUNTER → counter, everything else → gauge)."""
    lines: list[str] = []
    for name, v in metrics_values().items():
        pv = pvar_registry.lookup(name)
        metric = "ompi_tpu_" + _METRIC_RE.sub("_", name)
        kind = "counter" if pv.klass is PvarClass.COUNTER else "gauge"
        if pv.description:
            lines.append(f"# HELP {metric} {pv.description}")
        lines.append(f"# TYPE {metric} {kind}")
        lines.append(f"{metric} {v}")
    return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# metrics uplink (rank side): periodic pvar-snapshot pushes to the
# owning orted's UDP collector — delta-compressed (only changed values
# ride; every FULL_EVERY-th push resends the whole snapshot so a lost
# datagram heals), merged at each tree hop, aggregated at the HNP/DVM
#
# Histogram vectors ride the same datagrams with two wire forms, tagged
# by a leading marker element (runtime/metrics.py's merge_hop speaks
# both): ``["d", …ints]`` is the element-wise INCREMENT since the last
# push (merged by vector add at every hop — including the collector's
# failed-send re-merge, where add is the only correct fold), and
# ``["a", …ints]`` is the absolute cumulative vector (every FULL_EVERY-th
# push and the final flush), which subsumes any pending deltas so UDP
# loss heals for vectors exactly as it does for scalars.
# ---------------------------------------------------------------------------

#: every Nth push is a full snapshot (UDP loss self-heals within N pushes)
FULL_EVERY = 8

#: vector wire markers (see merge_hop): delta-increment / absolute
VEC_DELTA = "d"
VEC_ABS = "a"


class _MetricsPusher:
    """Background uplink thread: one small UDP datagram per period."""

    def __init__(self, jobid: int, rank: int, uri: str,
                 period: float) -> None:
        import socket

        host, port = uri.rsplit(":", 1)
        self._addr = (host, int(port))
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.jobid = jobid
        self.rank = rank
        self.period = period
        self._last: dict[str, float] = {}
        self._last_h: dict[str, list[int]] = {}
        self._n = 0
        # push() is entered by the periodic thread AND by push_now()
        # (a stuck wait's out-of-cadence push): without the lock, two
        # concurrent delta computations against one _last_h baseline
        # would double-count histogram increments at the aggregate
        self._push_lock = threading.Lock()
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, name=f"trace-metrics-{rank}", daemon=True)
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.wait(self.period):
            self.push()

    def push(self) -> None:
        """One uplink datagram now (delta vs the last push, or a full
        snapshot on the FULL_EVERY cadence).  Best-effort: metrics must
        never take a rank down."""
        from ompi_tpu_torch.core import dss

        try:
            with self._push_lock:
                self._push_locked(dss)
        except Exception:  # noqa: BLE001 — uplink is best-effort
            pass

    def _push_locked(self, dss: Any) -> None:
        if active:
            # the uplink cadence doubles as the native span-ring drain
            # beat: parks complete between pushes, so the rings stay
            # small and a live timeline capture sees fresh spans
            drain_native_spans()
        cur = metrics_values()
        cur_h = hist_values()
        full = self._n % FULL_EVERY == 0
        vals: dict[str, Any] = (
            dict(cur) if full else
            {k: v for k, v in cur.items()
             if self._last.get(k) != v})
        for key, vec in cur_h.items():
            if full:
                vals[key] = [VEC_ABS, *vec]
                continue
            last = self._last_h.get(key)
            if last is None:
                # a series born between full pushes: its whole
                # vector IS the increment since the last push
                vals[key] = [VEC_DELTA, *vec]
            elif last != vec:
                vals[key] = [VEC_DELTA,
                             *(a - b for a, b in zip(vec, last))]
        self._n += 1
        if not vals and not full:
            return
        pkt = dss.pack(("m1", self.jobid, self.rank, self._n, vals))
        self._sock.sendto(pkt, self._addr)
        # self-metering AFTER the send: the datagram that carried these
        # counters doesn't count itself (the next push reports it)
        count("metrics_push_datagrams_total")
        count("metrics_push_bytes_total", len(pkt))
        self._last = cur
        self._last_h = cur_h

    def stop(self, flush: bool = True) -> None:
        self._stop.set()
        if flush:
            self._n = 0          # final push is always a full snapshot
            self.push()
        try:
            self._sock.close()
        except OSError:
            pass


_pusher: Optional[_MetricsPusher] = None


def start_metrics_push(jobid: int, rank: int,
                       uri: Optional[str] = None) -> Optional[_MetricsPusher]:
    """Arm the metrics uplink (idempotent): no-op unless a collector URI
    is known (``OMPI_TPU_METRICS_URI``, exported by the owning orted)
    and ``trace_metrics_push_period`` > 0.  Independent of the timeline
    (:data:`active`): the always-on counters are worth scraping even
    when span recording is off."""
    global _pusher
    uri = uri if uri is not None else os.environ.get(ENV_METRICS_URI)
    period = push_period()
    if not uri or ":" not in uri or period <= 0:
        return None
    with _lock:
        if _pusher is None:
            _pusher = _MetricsPusher(jobid, rank, uri, period)
        return _pusher


def stop_metrics_push(flush: bool = True) -> None:
    """Disarm the uplink; ``flush`` sends one last full snapshot so a
    short job's final counter state still reaches the aggregate."""
    global _pusher
    with _lock:
        pusher, _pusher = _pusher, None
    if pusher is not None:
        pusher.stop(flush=flush)
