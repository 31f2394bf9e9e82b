"""The port's latency-histogram plane (``ompi_tpu_torch.mpi.trace``'s
``record_hist`` family) against the JAX package's.

Each case mirrors one of ``tests/mpi/test_trace_hist.py``: the same
durations go to both packages' record paths and the bucket vectors,
quantile estimates, pvar reads and flushed vectors must be equal.  The
record sites are held too: a host-plane job records the same series
(names and labels) with the same observation counts in both packages,
the durations themselves being this machine's.
"""

from __future__ import annotations

import json
import types

import numpy as np
import pytest

from ompi_tpu.core.config import var_registry as jvars
from ompi_tpu.mpi import trace as jtrace
from ompi_tpu.mpi.mpit import pvar_registry as jpvars
from ompi_tpu_torch.core.config import var_registry as pvars
from ompi_tpu_torch.mpi import trace as ptrace
from ompi_tpu_torch.mpi.mpit import pvar_registry as ppvars
from tests.mpi.harness import run_ranks as jrun
from tests.torch_host_harness import run_ranks as prun

J = types.SimpleNamespace(trace=jtrace, vars=jvars, pvars=jpvars, run=jrun)
P = types.SimpleNamespace(trace=ptrace, vars=pvars, pvars=ppvars, run=prun)
BOTH = (J, P)


@pytest.fixture(autouse=True)
def _clean_series(monkeypatch):
    """Each test owns both packages' series stores."""
    for M in BOTH:
        monkeypatch.setattr(M.trace, "hists", {})


_DURATIONS = [0, 1, 100, 1023, 1024, 2047, 2048, 5000, 5001, 10_000,
              65_537, 1_000_000, (1 << 34) - 1, 1 << 34, 1 << 60]


def test_bucket_index_log2_boundaries():
    for M in BOTH:
        t = M.trace
        assert t.hist_bucket_index((1 << t.HIST_MIN_EXP) - 1) == 0
        assert t.hist_bucket_index(1 << t.HIST_MIN_EXP) == 1
        assert t.hist_bucket_index(1 << (t.HIST_MIN_EXP + 1)) == 2
        assert t.hist_bucket_index((1 << 34) - 1) == t.HIST_NBUCKETS - 2
        assert t.hist_bucket_index(1 << 60) == t.HIST_NBUCKETS - 1
    assert [ptrace.hist_bucket_index(d) for d in _DURATIONS] == \
        [jtrace.hist_bucket_index(d) for d in _DURATIONS]
    assert (ptrace.HIST_MIN_EXP, ptrace.HIST_NBUCKETS, ptrace.HIST_VLEN) \
        == (jtrace.HIST_MIN_EXP, jtrace.HIST_NBUCKETS, jtrace.HIST_VLEN)


def test_record_accumulates_counts_and_sum():
    vecs = []
    for M in BOTH:
        for d in _DURATIONS:
            M.trace.record_hist("coll_arena_wait_ns", d)
        vecs.append(M.trace.hist_values())
    assert vecs[1] == vecs[0]
    vec = vecs[1]["coll_arena_wait_ns"]
    assert len(vec) == ptrace.HIST_VLEN
    assert sum(vec[:ptrace.HIST_NBUCKETS]) == len(_DURATIONS)
    assert vec[ptrace.HIST_NBUCKETS] == sum(_DURATIONS)


def test_undeclared_histogram_name_raises():
    with pytest.raises(KeyError):
        ptrace.record_hist("made_up_latency_ns", 1000)
    assert ptrace._HIST_SPECS == jtrace._HIST_SPECS


def test_labels_open_distinct_subseries():
    reads = []
    for M in BOTH:
        M.trace.record_hist("coll_dispatch_ns", 2000,
                            labels='slot="bcast",provider="shm",szb="10"')
        M.trace.record_hist("coll_dispatch_ns", 4000,
                            labels='slot="bcast",provider="host",szb="10"')
        keys = [k for k in M.trace.hists
                if k.startswith("coll_dispatch_ns{")]
        assert len(keys) == 2
        read = M.pvars.lookup("coll_dispatch_ns").read()
        assert set(read) == set(keys)
        reads.append(read)
    assert reads[1] == reads[0]


def test_hist_enable_gate_follows_var():
    old = pvars.get("trace_hist_enable")
    try:
        pvars.set("trace_hist_enable", False)
        assert ptrace.refresh_hist_enable() is False
        assert ptrace.hist_active is False
        pvars.set("trace_hist_enable", True)
        assert ptrace.refresh_hist_enable() is True
        assert ptrace.hist_active is True
    finally:
        pvars.set("trace_hist_enable", old)
        ptrace.refresh_hist_enable()


@pytest.mark.parametrize("dur", [10_000, 3_000_000, 700])
def test_quantile_estimate_within_bucket_factor(dur):
    est = []
    for M in BOTH:
        for _ in range(100):
            M.trace.record_hist("coll_arena_wait_ns", dur)
        counts = M.trace.hists["coll_arena_wait_ns"][:M.trace.HIST_NBUCKETS]
        est.append([M.trace.hist_quantile_ns(counts, q)
                    for q in (0.5, 0.9, 0.99)])
    assert est[1] == est[0]
    if dur >= 1 << ptrace.HIST_MIN_EXP:
        for e in est[1]:
            assert dur / 1.5 <= e <= dur * 1.5
    assert ptrace.hist_quantile_ns([0] * ptrace.HIST_NBUCKETS, 0.5) == 0.0


def test_mixed_quantiles_equal_the_jax_package():
    rng = np.random.default_rng(7)
    durs = [int(x) for x in rng.lognormal(10, 2, size=500)]
    est = []
    for M in BOTH:
        for d in durs:
            M.trace.record_hist("pml_eager_send_ns", d)
        counts = M.trace.hists["pml_eager_send_ns"][:M.trace.HIST_NBUCKETS]
        est.append([M.trace.hist_quantile_ns(counts, q)
                    for q in (0.1, 0.5, 0.9, 0.99, 1.0)])
    assert est[1] == est[0]


def test_flush_dump_carries_hist_vectors(tmp_path):
    docs = []
    for i, M in enumerate(BOTH):
        M.trace.record_hist("coll_arena_wait_ns", 3000)
        M.trace.record_hist("coll_dispatch_ns", 9000,
                            labels='slot="allreduce",provider="xla",szb="13"')
        rec = M.trace.FlightRecorder(capacity=64, rank=5, jobid=9)
        path = str(tmp_path / f"dump{i}.json")
        assert M.trace.flush(path=path, rec=rec) == path
        with open(path, encoding="utf-8") as f:
            docs.append(json.load(f)["otherData"]["hists"])
    assert docs[1] == docs[0]
    assert len(docs[1]["coll_arena_wait_ns"]) == ptrace.HIST_VLEN


def test_record_sites_open_the_same_series():
    """A host-plane job (p2p eager and rendezvous, coll/shm and coll/host
    collectives, an nbc schedule, a persistent plan) opens the same
    labelled series in both packages, with the same observation counts
    where the count does not depend on thread timing."""
    import ompi_tpu.mpi.coll.host  # noqa: F401 — registers its vars
    import ompi_tpu_torch.mpi.coll.host  # noqa: F401

    def body(c):
        r, n = c.rank, c.size
        req = c.irecv(source=(r - 1) % n, tag=1)
        c.send(np.arange(16.0), dest=(r + 1) % n, tag=1)
        req.wait()
        big = np.ones(40_000)
        req = c.irecv(np.empty_like(big), source=(r - 1) % n, tag=2)
        c.send(big, dest=(r + 1) % n, tag=2)
        req.wait()
        c.allreduce(np.ones(8))
        c.allgather(np.ones(3))
        c.allreduce(np.ones(600_000))          # past the arena: coll/host
        c.iallreduce(np.ones(4)).wait()
        p = c.allreduce_init(np.ones(4))
        for _ in range(3):
            p.start()
            p.wait()
        p.free()
        return True

    got = []
    for M in BOTH:
        M.run(3, body)
        got.append({k: sum(v[:M.trace.HIST_NBUCKETS])
                    for k, v in M.trace.hists.items()})
    jser, pser = got
    assert set(pser) == set(jser)
    timing = ("coll_arena_wait_ns", "btl_shm_drain_ns", "btl_tcp_write_ns")
    for key in pser:
        if not key.startswith(timing):
            assert pser[key] == jser[key], key
    assert pser['coll_dispatch_ns{slot="allreduce",provider="shm",'
                'szb="7"}'] == 3
    assert pser['coll_pstart_ns{kind="allreduce",provider="shm"}'] == 9
    assert pser['coll_nbc_ns{kind="iallreduce"}'] == 3
    assert any(k.startswith('coll_host_algo_ns{coll="allreduce"')
               for k in pser)
