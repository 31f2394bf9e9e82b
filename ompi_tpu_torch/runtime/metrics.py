"""Metrics uplink — the control-plane half of the live observability
plane (the port's copy of the JAX package's ``runtime/metrics.py``,
whole: ``merge_hop``, the UDP :class:`MetricsCollector`, which runs on
its own, ``straggler_panel`` and :class:`MetricsAggregate` with its
Prometheus rendering).  The orted runs the collector and carries the
``TAG_METRICS`` hop, the HNP of a daemon-tree launch folds the stream
into its ``MetricsAggregate`` (``runtime/orted.py``, ``runtime/plm.py``),
and a standing DVM serves it on ``/metrics`` and ``/status``, weighs its
gang placements by it and watches it for stuck collectives
(``runtime/dvm.py``).

Each app rank pushes its pvar snapshot (``trace.metrics_values()``,
delta-compressed) over UDP to its owning orted's :class:`MetricsCollector`
every ``trace_metrics_push_period`` seconds.  Each orted merges its local
ranks with whatever its tree children pushed up (``TAG_METRICS`` is a
one-hop message delivered at every level, not an HNP-only ``send_up``)
and forwards ONE merged delta per period toward the root.  The HNP/DVM
folds the stream into a :class:`MetricsAggregate` keyed by jobid and
rank — what the DVM's ``/metrics`` scrape endpoint and ``tpurun
--dvm-ps``'s last-metrics-age column read.

Wire shapes:

- rank → orted (UDP datagram): ``("m1", jobid, rank, push_n, {name: value})``
  — ``push_n`` fences reordered/stale datagrams; every
  ``trace.FULL_EVERY``-th push is a full snapshot so UDP loss heals.
- orted → parent (``TAG_METRICS``, one hop):
  ``{jobid: {rank: [wall_ts, {name: value}]}}`` — scalar values are
  cumulative counter readings (NOT increments), so a per-hop merge is a
  plain ``dict.update`` per rank and double-delivery cannot double-count.
- histogram vectors (the latency plane) ride the same value dicts as
  marker-tagged int lists: ``["d", …]`` is an element-wise INCREMENT
  since the sender's last push, ``["a", …]`` the absolute cumulative
  vector (full pushes + final flush).  :func:`merge_hop` folds them
  element-wise — delta∘delta adds, absolute subsumes older deltas,
  absolute∘absolute takes the element-wise max (vectors are monotone,
  so max is reorder-safe) — and the terminal aggregate row converges to
  an ``"a"``-tagged cumulative vector per (rank, series).

Thread-context rules: the TAG_METRICS handler runs on an RML link
reader thread — :func:`merge_hop` is dict surgery under one lock, no
RPC/sleep/subprocess (see the ``reader-thread`` lint checker).
"""

from __future__ import annotations

import socket
import threading
import time
from typing import Any, Callable, Optional

from ompi_tpu_torch.core import dss, output
from ompi_tpu_torch.core.config import VarType, register_var, var_registry

__all__ = ["merge_hop", "MetricsCollector", "MetricsAggregate",
           "AGG_METRICS", "AGG_HISTS", "vec_merge", "hist_counts",
           "straggler_panel"]

_log = output.get_stream("metrics")

register_var("metrics", "agg_budget_rows", VarType.INT, 200000,
             "HNP metrics fan-in budget: rank-rows the terminal "
             "aggregate accepts per second (token bucket, 1s burst). "
             "Payloads beyond the budget are SHED WHOLE and counted "
             "(sheds_total / shed_rows_total in /status uplink stats) "
             "instead of queueing unboundedly when every daemon pushes "
             "a full snapshot at once — counters are cumulative and "
             "vector deltas heal on the next full push, so a shed "
             "costs staleness, never corruption.  0 = unlimited")

#: the per-job aggregated-metric name family: counters the DVM scrape
#: endpoint ADDITIONALLY exports summed across a job's ranks as
#: ``ompi_tpu_job_<name>{job="<jobid>"}``.  Every entry must name a
#: ``trace._COUNTER_SPECS`` counter — the ompi-lint ``pvar-spec``
#: checker cross-checks both directions so a renamed counter cannot
#: silently vanish from the scrape surface.
AGG_METRICS = (
    "pml_zero_copy_sends_total",
    "pml_packed_sends_total",
    "btl_shm_publish_total",
    "btl_shm_drained_total",
    "coll_shm_fanin_total",
    "coll_shm_fanout_total",
    "coll_shm_fallback_total",
    "ft_rank_deaths_total",
    "ft_gossip_beats_total",
    "ft_fenced_frames_total",
    "errmgr_selfheal_revives_total",
    "errmgr_selfheal_escalations_total",
    "coll_stuck_events_total",
    "coll_rejoin_total",
    "btl_tcp_native_writes_total",
    "btl_tcp_native_batched_frames_total",
    "btl_tcp_native_parks_total",
)

#: the per-job aggregated-HISTOGRAM name family: latency histograms the
#: DVM scrape endpoint ADDITIONALLY exports summed element-wise across
#: a job's ranks as ``ompi_tpu_job_<name>`` histogram series.  Every
#: entry must name a ``trace._HIST_SPECS`` histogram — the pvar-spec
#: lint checker cross-checks (the AGG_METRICS discipline, vector form).
AGG_HISTS = (
    "coll_dispatch_ns",
    "coll_pstart_ns",
    "btl_tcp_write_ns",
)

#: jobs kept in the aggregate before the oldest (by last update) fall off
MAX_JOBS = 64

#: straggler panel: the delta window the per-rank wait shares are
#: computed over (the baseline snapshot rotates at this age)
STRAGGLER_WINDOW_S = 30.0

#: vector wire markers (mirrors trace.VEC_DELTA/VEC_ABS — no trace
#: import: the runtime layer must not pull the MPI surface at import)
_VEC_DELTA = "d"
_VEC_ABS = "a"


def _is_vec(v: Any) -> bool:
    """A marker-tagged histogram vector value on the wire/in a row."""
    return (isinstance(v, list) and bool(v)
            and v[0] in (_VEC_DELTA, _VEC_ABS))


def hist_counts(v: Any) -> list:
    """A tagged vector's ints (counts + trailing sum), marker stripped;
    [] for anything that is not a vector value."""
    return list(v[1:]) if _is_vec(v) else []


def vec_merge(old: Any, new: Any) -> list:
    """Fold two tagged vectors (see the module doc for the algebra).
    Length mismatches (a version-skewed peer) resolve to the newer
    vector rather than corrupting the element-wise fold."""
    if not _is_vec(old) or len(old) != len(new):
        return list(new)
    if new[0] == _VEC_ABS:
        if old[0] != _VEC_ABS:
            return list(new)       # absolute subsumes pending deltas
        return [_VEC_ABS] + [max(a, b)
                             for a, b in zip(old[1:], new[1:])]
    # new is a delta: increments stack onto whatever came before,
    # keeping the older marker (cumulative + increments stays absolute)
    return [old[0]] + [a + b for a, b in zip(old[1:], new[1:])]

#: a per-(job, rank) stale-datagram fence older than this is itself
#: stale: accept the "regressed" sequence (a revived rank whose first
#: low-numbered pushes were lost would otherwise be fenced until its
#: push counter climbed past the dead life's)
_FENCE_EXPIRE_S = 10.0

#: TAG_METRICS payload / aggregate row: {jobid: {rank: [ts, {name: val}]}}
HopPayload = dict[int, dict[int, list]]


def merge_hop(pending: HopPayload, payload: Any) -> None:
    """Fold one TAG_METRICS payload (or one rank datagram already in hop
    shape) into ``pending`` in place — the per-hop merge.  Scalar values
    are cumulative readings, so their merge is last-writer-wins per
    counter with the freshest wall timestamp kept per rank; histogram
    vectors fold element-wise through :func:`vec_merge` (delta adds,
    absolute subsumes — losing a pending delta to ``dict.update`` would
    silently drop bucket increments)."""
    if not isinstance(payload, dict):
        return
    for jobid, ranks in payload.items():
        if not isinstance(ranks, dict):
            continue
        for rank, row in ranks.items():
            try:
                key, rkey = int(jobid), int(rank)
                ts, vals = float(row[0]), dict(row[1])
            except (TypeError, ValueError, IndexError):
                continue
            cur = pending.setdefault(key, {}).setdefault(rkey, [0.0, {}])
            cur[0] = max(cur[0], ts)
            for name, v in vals.items():
                if _is_vec(v):
                    cur[1][name] = vec_merge(cur[1].get(name), v)
                else:
                    cur[1][name] = v


class MetricsCollector:
    """orted-side uplink stage: local ranks' UDP datagrams + child
    daemons' TAG_METRICS payloads, merged and drained one hop up per
    period.

    The caller owns the cadence (``send_fn`` is invoked from an internal
    timer thread every ``period`` seconds with the drained pending
    payload) and wires :meth:`on_child_payload` to the TAG_METRICS
    handler.
    """

    def __init__(self, period: float,
                 send_fn: Callable[[HopPayload], None],
                 host: str = "127.0.0.1") -> None:
        self.period = period
        self._send_fn = send_fn
        self._lock = threading.Lock()
        self._pending: HopPayload = {}
        # uplink self-metering (the first real data for ROADMAP item
        # 6's fan-in sizing): plain counters under the merge lock,
        # read by /status via stats().  Cumulative, like everything
        # else on this plane.
        self.rx_datagrams = 0
        self.rx_bytes = 0
        self.child_payloads = 0
        self.merge_ns_total = 0
        self.pushes_up = 0
        self.up_bytes = 0
        #: optional {name: value} injected into every local rank row at
        #: drain time — how the measured clock offsets ride the
        #: existing uplink instead of needing their own message shape
        self.extra_values_fn: Optional[Callable[[], dict]] = None
        #: per (jobid, rank): (last accepted datagram seq, monotonic
        #: accept time) — the reorder fence and its expiry clock
        self._seq: dict[tuple[int, int], tuple[int, float]] = {}
        self._stop = threading.Event()
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self._sock.bind((host, 0))
        self._sock.settimeout(0.5)
        self.uri = f"{host}:{self._sock.getsockname()[1]}"
        threading.Thread(target=self._recv_datagrams,
                         name="metrics-recv", daemon=True).start()
        threading.Thread(target=self._push_up,
                         name="metrics-push", daemon=True).start()

    # -- inputs -----------------------------------------------------------

    def _recv_datagrams(self) -> None:
        while not self._stop.is_set():
            try:
                blob, _addr = self._sock.recvfrom(1 << 16)
            except socket.timeout:
                continue
            except OSError:
                return
            try:
                msg = dss.unpack(blob, n=1)[0]
                tag, jobid, rank, push_n, vals = msg
                if tag != "m1":
                    continue
                key = (int(jobid), int(rank))
                push_n = int(push_n)
                vals = dict(vals)
            except Exception:  # noqa: BLE001 — garbage datagram: drop
                # anything may write to a reused ephemeral UDP port; a
                # bad-typed field must not kill the collector thread
                continue
            now = time.monotonic()
            with self._lock:
                last, t_last = self._seq.get(key, (0, 0.0))
                # reordered/stale datagrams regress cumulative counters —
                # fence them, EXCEPT: a restarted life's seq starts over
                # (push_n <= 2), and a fence older than _FENCE_EXPIRE_S
                # is stale itself (a revived rank whose first datagrams
                # were lost must not be blacked out until its push_n
                # climbs past the dead life's)
                if (push_n <= last and push_n > 2
                        and now - t_last < _FENCE_EXPIRE_S):
                    continue
                self._seq[key] = (push_n, now)
                t0 = time.monotonic_ns()
                merge_hop(self._pending,
                          {key[0]: {key[1]: [time.time(), vals]}})
                self.rx_datagrams += 1
                self.rx_bytes += len(blob)
                self.merge_ns_total += time.monotonic_ns() - t0

    def on_child_payload(self, payload: Any) -> None:
        """TAG_METRICS from a tree child (RML reader thread — merge
        only, no blocking work)."""
        t0 = time.monotonic_ns()
        with self._lock:
            merge_hop(self._pending, payload)
            self.child_payloads += 1
            self.merge_ns_total += time.monotonic_ns() - t0

    # -- drain ------------------------------------------------------------

    def _push_up(self) -> None:
        while not self._stop.wait(self.period):
            payload = self.drain()
            if not payload:
                continue
            try:
                # one extra pack per period buys the actual per-hop
                # byte rate the fan-in sizing needs (payloads are a few
                # KiB; the RML frame adds a constant it doesn't count)
                nbytes = len(dss.pack(payload))
                self._send_fn(payload)
                with self._lock:
                    self.pushes_up += 1
                    self.up_bytes += nbytes
            except Exception:  # noqa: BLE001 — keep the merged delta:
                # an orphaned-window send failure must not lose it
                with self._lock:
                    merged = self._pending
                    self._pending = payload
                    merge_hop(self._pending, merged)

    def drain(self) -> HopPayload:
        """Take the pending merged delta (callers push it one hop up),
        stamping any ``extra_values_fn`` values into every rank row —
        scalars are last-writer-wins downstream, so re-stamping each
        period is idempotent."""
        with self._lock:
            payload, self._pending = self._pending, {}
        fn = self.extra_values_fn
        if fn is not None and payload:
            try:
                extras = {k: v for k, v in dict(fn()).items()
                          if v is not None}
            except Exception:  # noqa: BLE001 — metering must not lose
                extras = {}    # the real payload to a stats callback
            if extras:
                for ranks in payload.values():
                    for row in ranks.values():
                        row[1].update(extras)
        return payload

    def stats(self) -> dict:
        """Uplink self-metrics for /status (cumulative counters)."""
        with self._lock:
            return {"rx_datagrams": self.rx_datagrams,
                    "rx_bytes": self.rx_bytes,
                    "child_payloads": self.child_payloads,
                    "merge_ns_total": self.merge_ns_total,
                    "pushes_up": self.pushes_up,
                    "up_bytes": self.up_bytes}

    def close(self) -> None:
        self._stop.set()
        try:
            self._sock.close()
        except OSError:
            pass


#: log2 bucket layout (mirrors trace.HIST_MIN_EXP — same no-import rule
#: as the vector markers): bucket i's upper bound is 2**(_HIST_MIN_EXP+i)
_HIST_MIN_EXP = 10


def _series_base(key: str) -> str:
    """A vector series key's declared base name (label suffix stripped)."""
    return key.split("{", 1)[0]


def _series_labels(key: str) -> str:
    """The label-pair fragment of a series key ('' when unlabeled)."""
    if "{" not in key:
        return ""
    return key.split("{", 1)[1].rstrip("}")


def _quantile_from_counts(counts: list, q: float) -> float:
    """q-quantile estimate in ns from a bucket-count vector (geometric
    midpoint of the landing bucket; the last bucket is the overflow)."""
    total = sum(counts)
    if total <= 0:
        return 0.0
    target = q * total
    seen = 0
    for i, c in enumerate(counts):
        seen += c
        if seen >= target and c:
            hi = 1 << (_HIST_MIN_EXP + i)
            return float(hi) / 1.4142135623730951
    return float(1 << (_HIST_MIN_EXP + len(counts) - 1))


def _hist_series_lines(metric: str, label_prefix: str,
                       ints: list) -> list[str]:
    """One histogram series (counts + trailing sum) as exposition
    lines: CUMULATIVE ``_bucket{le=}`` samples ending at +Inf, then
    ``_sum`` and ``_count``."""
    counts, total_sum = ints[:-1], ints[-1]
    lines = []
    cum = 0
    for i, c in enumerate(counts):
        cum += c
        le = ("+Inf" if i == len(counts) - 1
              else str(1 << (_HIST_MIN_EXP + i)))
        lines.append(
            f'{metric}_bucket{{{label_prefix},le="{le}"}} {cum}')
    lines.append(f'{metric}_sum{{{label_prefix}}} {total_sum}')
    lines.append(f'{metric}_count{{{label_prefix}}} {cum}')
    return lines


def straggler_panel(waits: dict[int, float], publishes: dict[int, float],
                    signal: str, window_s: float) -> Optional[dict]:
    """The cross-rank straggler verdict from per-rank wait/publish sums
    (ns) over one window.  Pure math, shared by the live /status panel
    and tools/straggler_report.py's offline mode.

    The inversion that makes this a straggler detector: a rank whose
    share of the job's total collective WAIT time is lowest is the rank
    everyone else spent their wait time waiting FOR — the last arriver
    barely waits.  ``suspect`` therefore names the min-share rank (the
    job's current slowest), and the max/median skew of the wait
    distribution says how lopsided the window was (≈1 ⇒ balanced)."""
    if not waits:
        return None
    total = float(sum(waits.values()))
    ranks = {}
    for r in sorted(waits):
        share = (waits[r] / total) if total > 0 else 0.0
        ranks[str(r)] = {
            "wait_ms": round(waits[r] / 1e6, 3),
            "publish_ms": round(publishes.get(r, 0.0) / 1e6, 3),
            "wait_share": round(share, 4),
        }
    vals = sorted(waits.values())
    median = vals[len(vals) // 2] if len(vals) % 2 else (
        (vals[len(vals) // 2 - 1] + vals[len(vals) // 2]) / 2.0)
    suspect = None
    if len(waits) >= 2 and total > 0:
        suspect = min(waits, key=lambda r: waits[r])
    return {
        "signal": signal,
        "window_s": round(window_s, 1),
        "ranks": ranks,
        "suspect": suspect,
        "max_wait_ms": round(max(vals) / 1e6, 3),
        "median_wait_ms": round(median / 1e6, 3),
        "skew": (round(max(vals) / median, 2) if median > 0 else None),
    }


class MetricsAggregate:
    """HNP/DVM-side terminal stage: the cumulative per-job, per-rank
    counter table the scrape endpoint and ``--dvm-ps`` read."""

    def __init__(self, max_jobs: int = MAX_JOBS) -> None:
        self._lock = threading.Lock()
        self._jobs: HopPayload = {}
        self._max_jobs = max_jobs
        # terminal-stage self-metering: what one merge costs the HNP
        # and how often the stream arrives (ROADMAP item 6's numbers)
        self.merges_total = 0
        self.merge_ns_total = 0
        #: the explicit shed-and-count policy: payloads refused by the
        #: fan-in budget (metrics_agg_budget_rows), and the rank-rows
        #: they carried — "how much telemetry did overload cost" is
        #: itself telemetry
        self.sheds_total = 0
        self.shed_rows_total = 0
        # None = bucket not yet primed; the first budgeted merge starts
        # with the FULL burst, so boot-time pushes are never shed by an
        # accident of how soon after construction they arrive
        self._budget_tokens: Optional[float] = None
        self._budget_ts = time.monotonic()
        #: jobid → last-merge monotonic ts — the incremental eviction
        #: index (age eviction picks min() here instead of re-scanning
        #: every job's every rank row on each overflow)
        self._job_ts: dict[int, float] = {}
        #: straggler baselines: jobid → (monotonic ts, signal, {rank:
        #: (wait, publish)}); rotated once older than the panel window,
        #: discarded on a signal flip (sums from different histograms
        #: must never be subtracted) and pruned with job eviction
        self._strag_base: dict[int, tuple[float, str,
                                          dict[int, tuple[float,
                                                          float]]]] = {}

    def merge(self, payload: Any) -> None:
        """Fold one TAG_METRICS payload in (RML reader thread safe).

        Admission first: the token bucket (``metrics_agg_budget_rows``
        rank-rows/s, one-second burst) is the uplink-overload valve.
        When every daemon pushes a full snapshot at once the excess
        payloads are dropped WHOLE and counted — bounded merge cost and
        an honest ``sheds_total``, never an unbounded queue.  Rows are
        counted before the lock; a shed costs O(payload keys)."""
        try:
            rows = sum(len(ranks) for ranks in payload.values()
                       if isinstance(ranks, dict))
        except AttributeError:
            rows = 1   # malformed payload: let merge_hop reject it
        t0 = time.monotonic_ns()
        with self._lock:
            rate = float(var_registry.get("metrics_agg_budget_rows") or 0)
            if rate > 0:
                now = time.monotonic()
                if self._budget_tokens is None:
                    self._budget_tokens = rate
                else:
                    self._budget_tokens = min(
                        rate, self._budget_tokens
                        + (now - self._budget_ts) * rate)
                self._budget_ts = now
                if rows > self._budget_tokens:
                    self.sheds_total += 1
                    self.shed_rows_total += rows
                    return
                self._budget_tokens -= rows
            merge_hop(self._jobs, payload)
            now_ts = time.monotonic()
            for jobid in payload:
                self._job_ts[jobid] = now_ts
            self.merges_total += 1
            self.merge_ns_total += time.monotonic_ns() - t0
            while len(self._jobs) > self._max_jobs:
                # incremental age eviction: min() over the per-job
                # last-merge index — O(jobs), not O(total rank rows)
                oldest = min(self._jobs,
                             key=lambda j: self._job_ts.get(j, 0.0))
                del self._jobs[oldest]
                # evicted jobs take their straggler baseline along
                # (a long-lived DVM must not leak one per dead job)
                self._strag_base.pop(oldest, None)
                self._job_ts.pop(oldest, None)

    def prune_job(self, jobid: int) -> None:
        """Drop one job's per-rank counter tables and straggler baseline
        NOW instead of waiting for the MAX_JOBS age eviction: the DVM
        scheduler calls this when a job's record rotates out of its
        bounded history (and on requeue, so a fresh attempt's counters
        don't stack on the killed attempt's) — a standing pool serving
        thousands of short jobs must not hold 64 dead tables between
        evictions."""
        with self._lock:
            self._jobs.pop(int(jobid), None)
            self._strag_base.pop(int(jobid), None)
            self._job_ts.pop(int(jobid), None)

    def stats(self) -> dict:
        """Terminal-stage self-metrics for /status."""
        with self._lock:
            return {"merges_total": self.merges_total,
                    "merge_ns_total": self.merge_ns_total,
                    "sheds_total": self.sheds_total,
                    "shed_rows_total": self.shed_rows_total}

    def snapshot(self) -> HopPayload:
        with self._lock:
            return {j: {r: [row[0], dict(row[1])]
                        for r, row in ranks.items()}
                    for j, ranks in self._jobs.items()}

    def jobids(self) -> list[int]:
        """Known jobids without copying the counter tables (what a
        /status render wants — snapshot() deep-copies everything)."""
        with self._lock:
            return list(self._jobs)

    def rank_values(self, jobid: int,
                    names: tuple) -> dict[int, dict[str, float]]:
        """Per-rank current values of the named scalar metrics for one
        job — the pushed recorder head (``coll_cur_*``) the --dvm-ps
        last_coll column and the doctor's no-response fallback read.
        One table scan under the lock; vectors are skipped."""
        out: dict[int, dict[str, float]] = {}
        with self._lock:
            ranks = self._jobs.get(int(jobid), {})
            for rank, row in ranks.items():
                vals = {n: row[1][n] for n in names
                        if n in row[1] and not _is_vec(row[1][n])}
                if vals:
                    out[int(rank)] = vals
        return out

    def ages(self, jobid: int,
             now: Optional[float] = None) -> dict[int, float]:
        """Per-rank seconds since the last metrics update for ``jobid``
        (the --dvm-ps last-metrics-age column)."""
        now = time.time() if now is None else now
        with self._lock:
            ranks = self._jobs.get(int(jobid), {})
            return {r: max(0.0, now - row[0]) for r, row in ranks.items()}

    def prometheus(self) -> str:
        """The aggregate as Prometheus text: one per-rank series per
        counter (``ompi_tpu_<name>{job=,rank=}``), real histogram
        families for the latency plane (``_bucket{le=}``/``_sum``/
        ``_count``, cumulative le buckets), the per-job ``AGG_METRICS``
        sums (``ompi_tpu_job_<name>{job=}``) and the per-job
        ``AGG_HISTS`` bucket sums.  All samples of one metric name are
        emitted contiguously under a single # TYPE line — the grouping
        the exposition format demands."""
        snap = self.snapshot()
        lines: list[str] = []

        # -- per-rank scalars, grouped by metric name ---------------------
        scalar_names = sorted({
            name for ranks in snap.values() for row in ranks.values()
            for name, v in row[1].items() if not _is_vec(v)})
        for name in scalar_names:
            metric = f"ompi_tpu_{name}"
            kind = "counter" if name.endswith("_total") else "gauge"
            lines.append(f"# TYPE {metric} {kind}")
            for jobid in sorted(snap):
                for rank in sorted(snap[jobid]):
                    v = snap[jobid][rank][1].get(name)
                    if v is not None and not _is_vec(v):
                        lines.append(
                            f'{metric}{{job="{jobid}",rank="{rank}"}} '
                            f"{v}")

        # -- per-rank histograms, grouped by base name --------------------
        hist_bases = sorted({
            _series_base(key)
            for ranks in snap.values() for row in ranks.values()
            for key, v in row[1].items() if _is_vec(v)})
        for base in hist_bases:
            metric = f"ompi_tpu_{base}"
            lines.append(f"# TYPE {metric} histogram")
            for jobid in sorted(snap):
                for rank in sorted(snap[jobid]):
                    vals = snap[jobid][rank][1]
                    for key in sorted(k for k, v in vals.items()
                                      if _is_vec(v)
                                      and _series_base(k) == base):
                        ints = hist_counts(vals[key])
                        if len(ints) < 2:
                            # a version-skewed/corrupt peer's stub
                            # vector must not 500 the whole scrape
                            continue
                        labels = _series_labels(key)
                        pre = (f'job="{jobid}",rank="{rank}"'
                               + ("," + labels if labels else ""))
                        lines += _hist_series_lines(metric, pre, ints)

        # -- per-job scalar sums ------------------------------------------
        for name in AGG_METRICS:
            metric = f"ompi_tpu_job_{name}"
            kind = "counter" if name.endswith("_total") else "gauge"
            job_lines = []
            for jobid in sorted(snap):
                total = sum(row[1].get(name, 0)
                            for row in snap[jobid].values()
                            if not _is_vec(row[1].get(name)))
                job_lines.append(f'{metric}{{job="{jobid}"}} {total}')
            if job_lines:
                lines.append(f"# TYPE {metric} {kind}")
                lines += job_lines

        # -- per-job histogram sums (element-wise across ranks, labels
        #    preserved) ----------------------------------------------------
        for base in AGG_HISTS:
            metric = f"ompi_tpu_job_{base}"
            job_lines = []
            for jobid in sorted(snap):
                by_labels: dict[str, list] = {}
                for row in snap[jobid].values():
                    for key, v in row[1].items():
                        if not _is_vec(v) or _series_base(key) != base:
                            continue
                        ints = hist_counts(v)
                        if len(ints) < 2:
                            continue
                        cur = by_labels.get(_series_labels(key))
                        if cur is None or len(cur) != len(ints):
                            by_labels[_series_labels(key)] = list(ints)
                        else:
                            by_labels[_series_labels(key)] = [
                                a + b for a, b in zip(cur, ints)]
                for labels in sorted(by_labels):
                    pre = (f'job="{jobid}"'
                           + ("," + labels if labels else ""))
                    job_lines += _hist_series_lines(
                        metric, pre, by_labels[labels])
            if job_lines:
                lines.append(f"# TYPE {metric} histogram")
                lines += job_lines
        return "\n".join(lines) + ("\n" if lines else "")

    # -- the latency plane: per-rank quantiles + the straggler panel -------

    def _rank_hist_rows(self, jobid: int, base: str
                        ) -> dict[int, tuple[list, float, float]]:
        """Per rank: (bucket counts summed over the base's label
        variants, observation-sum ns, count) — lock held briefly."""
        out: dict[int, tuple[list, float, float]] = {}
        with self._lock:
            ranks = self._jobs.get(int(jobid), {})
            for rank, row in ranks.items():
                counts: list = []
                total_sum = 0.0
                n = 0.0
                for key, v in row[1].items():
                    if not _is_vec(v) or _series_base(key) != base:
                        continue
                    ints = hist_counts(v)
                    if len(ints) < 2:
                        continue
                    c, s = ints[:-1], ints[-1]
                    if len(counts) != len(c):
                        counts = list(c)
                    else:
                        counts = [a + b for a, b in zip(counts, c)]
                    total_sum += s
                    n += sum(c)
                if counts:
                    out[rank] = (counts, total_sum, n)
        return out

    def job_hist_quantiles(self, jobid: int, base: str,
                           q: float) -> dict[int, float]:
        """Estimated q-quantile in ns of ``base`` for every rank that
        pushed one — ONE table scan per render (the --dvm-ps p99
        column; per-rank calls would rescan under the merge lock)."""
        return {r: _quantile_from_counts(counts, q)
                for r, (counts, _s, n)
                in self._rank_hist_rows(jobid, base).items() if n > 0}

    def rank_hist_quantile(self, jobid: int, rank: int, base: str,
                           q: float) -> Optional[float]:
        """One rank's q-quantile (None when the rank pushed no such
        histogram) — convenience over :meth:`job_hist_quantiles`."""
        return self.job_hist_quantiles(jobid, base, q).get(rank)

    def straggler(self, jobid: int,
                  window_s: float = STRAGGLER_WINDOW_S,
                  now: Optional[float] = None) -> Optional[dict]:
        """The per-job straggler panel over the last window: per-rank
        collective wait-time share, max/median skew, and the current
        slowest rank.  Prefers the arena wait histogram (the direct
        signal); falls back to total coll dispatch time when no arena
        series exists (cross-host jobs), where the same min-share
        inversion holds — the last arriver spends the least time inside
        the collective.  None when no rank pushed latency data."""
        now = time.monotonic() if now is None else now
        wait_rows = self._rank_hist_rows(jobid, "coll_arena_wait_ns")
        signal = "arena_wait"
        if not any(n > 0 for _c, _s, n in wait_rows.values()):
            wait_rows = self._rank_hist_rows(jobid, "coll_dispatch_ns")
            signal = "coll_dispatch"
        if not wait_rows:
            return None
        pub_rows = self._rank_hist_rows(jobid, "coll_ppublish_ns")
        cur = {r: (s, pub_rows.get(r, ([], 0.0, 0.0))[1])
               for r, (_c, s, _n) in wait_rows.items()}
        with self._lock:
            base = self._strag_base.get(int(jobid))
            # a baseline from the OTHER signal is poison: subtracting
            # dispatch sums from arena-wait sums (a job whose first
            # arena series appeared after a cross-host phase) yields
            # garbage shares — start a fresh window instead
            if base is not None and base[1] != signal:
                base = None
            if base is None:
                base_t, base_sums = now, {}
                self._strag_base[int(jobid)] = (now, signal, dict(cur))
            else:
                base_t, _sig, base_sums = base
                if now - base_t > window_s:
                    self._strag_base[int(jobid)] = (now, signal,
                                                    dict(cur))
        waits = {r: max(0.0, s - base_sums.get(r, (0.0, 0.0))[0])
                 for r, (s, _p) in cur.items()}
        pubs = {r: max(0.0, p - base_sums.get(r, (0.0, 0.0))[1])
                for r, (_s, p) in cur.items()}
        window = max(0.0, now - base_t)
        if not any(waits.values()):
            # an empty delta window (baseline just rotated, or an idle
            # job): fall back to the cumulative sums so the panel never
            # goes blank; window_s 0.0 marks a whole-history verdict
            waits = {r: s for r, (s, _p) in cur.items()}
            pubs = {r: p for r, (_s, p) in cur.items()}
            window = 0.0
        return straggler_panel(waits, pubs, signal, window_s=window)
