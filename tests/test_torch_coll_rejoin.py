"""The port's collective-capable rejoin (the epoch-fenced rebuild of the
coll/shm hierarchy and of persistent plans after a selfheal revive) and
the FT poison semantics of the persistent and partitioned starts, held
against the JAX package's.

Each case mirrors one of ``tests/mpi/test_coll_rejoin.py`` (10), or one
of the six FT cases of ``tests/mpi/test_coll_persistent.py`` and
``tests/mpi/test_partitioned.py`` (the partitioned
``test_start_after_revoke_raises`` is named
``test_partitioned_start_after_revoke_raises`` here), with every
assertion kept, and runs once per package (``pkg``) on that package's
in-process harness.  Revives are SIMULATED the way the transport would
adopt them: the revived rank's ``pml.incarnation`` advances
(``OMPI_TPU_RESTART`` in a real revive) and each survivor's
``pml._peer_epoch`` gains the new life.  The last case runs one
scenario through both packages and requires equal results and rejoin
counts.
"""

from __future__ import annotations

import importlib
import threading
import time
import types

import numpy as np
import pytest

from tests.mpi.harness import run_ranks as jrun
from tests.torch_host_harness import run_ranks as prun

N = 4


def _package(name: str, run) -> types.SimpleNamespace:
    mod = lambda m: importlib.import_module(f"{name}.{m}")  # noqa: E731
    return types.SimpleNamespace(
        name=name, run=run, ft=mod("mpi.ft"), shm=mod("mpi.coll.shm"),
        trace=mod("mpi.trace"), const=mod("mpi.constants"),
        native=mod("_native"), vars=mod("core.config").var_registry)


JAX, TORCH = _package("ompi_tpu", jrun), _package("ompi_tpu_torch", prun)


@pytest.fixture(params=[JAX, TORCH], ids=["ompi_tpu", "ompi_tpu_torch"])
def pkg(request):
    return request.param


def _simulate_revive(comm, victim: int, bar=None) -> None:
    """Adopt a (simulated) new life of ``victim`` on this rank — the
    revived rank itself advances its own incarnation (OMPI_TPU_RESTART
    in a real revive), survivors adopt it.  ``_peer_inc`` is pre-marked
    adopted and ``bar`` (a threading.Barrier) orders the marks before
    any si-stamped frame flows: in a REAL revive the new life's wire
    seqs start fresh, but this in-process victim keeps its old send
    seqs — letting the si-stamp adoption machinery fire against live
    counters would wipe recv-seq gates mid-stream, a seam artifact no
    real revive has."""
    if comm.rank == victim:
        comm.pml.incarnation = 1
    else:
        w = comm.world_rank(victim)
        comm.pml._peer_epoch[w] = 1
        comm.pml._peer_inc[w] = 1
    if bar is not None:
        bar.wait(timeout=30)


# ---------------------------------------------------------------------------
# flat arena: stale-epoch dispatch rebuilds, survivors and revived side
# ---------------------------------------------------------------------------

def test_stale_epoch_dispatch_rebuilds_flat_arena(pkg):
    bar = threading.Barrier(N)

    def body(comm):
        out0 = comm.allreduce(np.arange(4.0) + comm.rank)
        st0 = comm._coll_shm_state
        assert st0.mode == "arena" and st0.epoch == 0
        old_arena = st0.arena
        _simulate_revive(comm, victim=1, bar=bar)
        out1 = comm.allreduce(np.arange(4.0) + comm.rank)
        st1 = comm._coll_shm_state
        assert st1 is not st0 and st1.mode == "arena"
        assert st1.epoch == 1
        assert st1.arena is not old_arena
        # the old arena was closed at teardown (views dropped)
        assert st0.arena is None
        # steady state again: the third dispatch must NOT rebuild
        comm.allreduce(np.ones(1))
        assert comm._coll_shm_state is st1
        return out0, out1

    before = pkg.trace.counters["coll_rejoin_total"]
    res = pkg.run(N, body)
    want = np.arange(4.0) * N + sum(range(N))
    for out0, out1 in res:
        np.testing.assert_allclose(out0, want)
        np.testing.assert_allclose(out1, want)
    # every rank with a cached state rebuilt exactly once (in-process
    # simulation: the "revived" rank kept a stale state too, so all N
    # count; a real revived life builds fresh and counts zero — the
    # chaos selfheal-coll driver asserts that split)
    assert pkg.trace.counters["coll_rejoin_total"] == before + N


def test_stale_epoch_dispatch_from_the_revived_side(pkg):
    """The revived life has NO cached state (fresh process): its first
    dispatch runs a fresh build whose epoch-agreement prologue must
    pair with the survivors' rebuilds — and it records no rejoin."""
    bar = threading.Barrier(N)

    def body(comm):
        comm.allreduce(np.ones(2))
        _simulate_revive(comm, victim=1, bar=bar)
        if comm.rank == 1:
            # the revived life never had the old mapping
            comm._coll_shm_state.close()
            comm._coll_shm_state = None
        out = comm.allreduce(np.full(3, float(comm.rank)))
        st = comm._coll_shm_state
        assert st.mode == "arena" and st.epoch == 1
        return out

    before = pkg.trace.counters["coll_rejoin_total"]
    res = pkg.run(N, body)
    for out in res:
        np.testing.assert_allclose(out, np.full(3, float(sum(range(N)))))
    # rank 1 built fresh — no rejoin; the N-1 survivors rebuilt
    assert pkg.trace.counters["coll_rejoin_total"] == before + (N - 1)


def test_mid_wait_adoption_breaks_the_park_and_rebuilds(pkg):
    """A survivor already parked in an old-arena wait when the adoption
    lands must break out via the epoch fence (StaleCollEpoch) and
    transparently retry on the rebuilt arena — the un-adopted-survivor
    window of a real revive."""
    def body(comm):
        comm.barrier()                      # build the arena at epoch 0
        if comm.rank == 0:
            # dispatch immediately: parks waiting rank 1's publish,
            # which never comes into THIS arena.  Rank 1 pokes our
            # epoch view mid-park (the reader-thread adoption seam),
            # the fence fires, and the retried op lands on the rebuilt
            # arena.
            return comm.allreduce(np.full(2, 1.0 + comm.rank))
        # rank 1: let rank 0 park, then adopt the revive everywhere
        time_parked = 0.4
        threading.Event().wait(time_parked)
        for c in _comms:
            _simulate_revive(c, victim=1)
        return comm.allreduce(np.full(2, 1.0 + comm.rank))

    # the bodies need every rank's comm to poke peers' epoch views;
    # collect them via a shared list the harness fn closes over
    _comms = []

    def wrapped(comm):
        _comms.append(comm)
        while len(_comms) < 2:
            threading.Event().wait(0.01)
        return body(comm)

    before = pkg.trace.counters["coll_rejoin_total"]
    res = pkg.run(2, wrapped, timeout=90)
    for out in res:
        np.testing.assert_allclose(out, np.full(2, 3.0))
    assert pkg.trace.counters["coll_rejoin_total"] >= before + 1


# ---------------------------------------------------------------------------
# hierarchy rebuild on fake hosts
# ---------------------------------------------------------------------------

def test_hierarchy_rebuild_on_2plus2_fake_hosts(pkg):
    hosts = ["h0", "h0", "h1", "h1"]
    bar = threading.Barrier(N)

    def body(comm):
        comm._io_host_override = hosts[comm.rank]
        out0 = comm.allreduce(np.arange(3.0) + comm.rank)
        st0 = comm._coll_shm_state
        assert st0.mode == "hier" and st0.epoch == 0
        old_node = st0.node
        _simulate_revive(comm, victim=3, bar=bar)
        out1 = comm.allreduce(np.arange(3.0) + comm.rank)
        st1 = comm._coll_shm_state
        assert st1 is not st0 and st1.mode == "hier"
        assert st1.epoch == 1
        # the node split re-ran: a fresh node communicator (the revived
        # rank re-enters the on-node block tables)
        assert st1.node is not old_node
        return out0, out1

    before = pkg.trace.counters["coll_rejoin_total"]
    res = pkg.run(N, body)
    want = np.arange(3.0) * N + sum(range(N))
    for out0, out1 in res:
        np.testing.assert_allclose(out0, want)
        np.testing.assert_allclose(out1, want)
    assert pkg.trace.counters["coll_rejoin_total"] == before + N


# ---------------------------------------------------------------------------
# shrink-then-revive interleave
# ---------------------------------------------------------------------------

def test_shrink_then_revive_interleave(pkg):
    """A shrunk communicator built while the victim was dead must NOT
    rebuild when the (non-member) victim revives; the parent comm must
    rebuild and produce full-world answers again."""
    pml_ft = pkg.ft.pml_ft

    victim = 3
    gate = threading.Barrier(N)

    def body(comm):
        comm.allreduce(np.ones(1))          # parent state at epoch 0
        shrunk_state = []
        if comm.rank != victim:
            pml_ft(comm.pml).detector.mark_failed(victim, "test kill")
            shrunk = comm.shrink()
            s1 = shrunk.allreduce(np.full(2, 1.0))
            np.testing.assert_allclose(s1, np.full(2, float(N - 1)))
            shrunk_state.append((shrunk, shrunk._coll_shm_state))
        gate.wait(timeout=30)
        # the revive lands: survivors adopt, the victim's life advances
        if comm.rank == victim:
            comm.pml.incarnation = 1
            comm._coll_shm_state.close()    # new life: no old mapping
            comm._coll_shm_state = None
        else:
            pml_ft(comm.pml).detector.revive(victim)
            w = comm.world_rank(victim)
            comm.pml._peer_epoch[w] = 1
            comm.pml._peer_inc[w] = 1   # pre-adopted (see _simulate_revive)
        gate.wait(timeout=30)
        out = comm.allreduce(np.full(2, float(comm.rank)))
        np.testing.assert_allclose(out, np.full(2, float(sum(range(N)))))
        if shrunk_state:
            shrunk, st = shrunk_state[0]
            # non-member revive: the shrunk comm's epoch is unchanged,
            # its arena survives untouched
            s2 = shrunk.allreduce(np.full(2, 2.0))
            np.testing.assert_allclose(s2, np.full(2, 2.0 * (N - 1)))
            assert shrunk._coll_shm_state is st
        return True

    assert all(pkg.run(N, body, timeout=120))


# ---------------------------------------------------------------------------
# native on/off parametrized teardown-rebuild
# ---------------------------------------------------------------------------

def _native_available(pkg) -> bool:
    return pkg.native.arena() is not None


@pytest.mark.parametrize("native", [False, True])
def test_rebuild_native_on_off(pkg, native):
    if native and not _native_available(pkg):
        pytest.skip("native arena executor unavailable")
    old = pkg.vars.get("coll_shm_native")
    pkg.vars.set("coll_shm_native", 1 if native else 0)
    try:
        bar = threading.Barrier(2)

        def body(comm):
            out0 = comm.allreduce(np.arange(8.0) * (comm.rank + 1))
            _simulate_revive(comm, victim=0, bar=bar)
            out1 = comm.allreduce(np.arange(8.0) * (comm.rank + 1))
            assert comm._coll_shm_state.epoch == 1
            return out0, out1

        res = pkg.run(2, body)
        want = np.arange(8.0) * 3
        for out0, out1 in res:
            np.testing.assert_allclose(out0, want)
            np.testing.assert_allclose(out1, want)
    finally:
        pkg.vars.set("coll_shm_native", old)


# ---------------------------------------------------------------------------
# persistent plans: Start-time auto-rebind
# ---------------------------------------------------------------------------

def test_persistent_auto_rebind_bit_parity_vs_fresh_oneshot(pkg):
    """After a simulated revive the next Start auto-rebinds with no
    user-visible error; the result is bit-identical to a fresh one-shot
    allreduce of the same buffers (same rank-ordered fold)."""
    rng = np.random.default_rng(7)
    data = [rng.standard_normal(33) for _ in range(3)]
    bar = threading.Barrier(3)

    def body(comm):
        buf = data[comm.rank].copy()
        req = comm.allreduce_init(buf)
        assert req.provider == "shm"
        req.start()
        r1 = req.wait()
        comm.barrier()
        _simulate_revive(comm, victim=2, bar=bar)
        req.start()                 # auto-rebind: no raise
        r2 = req.wait()
        assert req.provider == "shm"
        oneshot = comm.allreduce(buf)
        return r1, r2, oneshot

    binds = pkg.trace.counters["coll_persistent_binds_total"]
    rebinds = pkg.trace.counters["coll_persistent_rebinds_total"]
    res = pkg.run(3, body)
    for r1, r2, oneshot in res:
        np.testing.assert_array_equal(r1, r2)     # same fold, same bits
        np.testing.assert_array_equal(r2, oneshot)
    # one fresh bind + exactly one auto-rebind per rank
    assert pkg.trace.counters["coll_persistent_binds_total"] == binds + 6
    assert pkg.trace.counters["coll_persistent_rebinds_total"] == rebinds + 3


def test_persistent_start_not_stale_when_behind_agreed_snapshot(pkg):
    """A rank whose local adoption is BEHIND the bind's agreed snapshot
    (bound after everyone else adopted) must not auto-rebind alone:
    stale means an advance PAST the snapshot, never a lag behind it."""
    bar = threading.Barrier(2)

    def body(comm):
        _simulate_revive(comm, victim=1, bar=bar)
        req = comm.allreduce_init(np.ones(4))
        req.start()
        req.wait()
        if comm.rank == 0:
            # lag: forget the adoption locally (cur < agreed snapshot)
            comm.pml._peer_epoch[comm.world_rank(1)] = 0
        req.start()
        out = req.wait()
        return float(out[0])

    rebinds = pkg.trace.counters["coll_persistent_rebinds_total"]
    assert all(v == 2.0 for v in pkg.run(2, body))
    assert pkg.trace.counters["coll_persistent_rebinds_total"] == rebinds


# ---------------------------------------------------------------------------
# Comm.free() racing an in-flight (re)build — the _SETUP leak regression
# ---------------------------------------------------------------------------

def test_free_during_inflight_build_does_not_leak(pkg, monkeypatch):
    """free() while the state build is mid-flight (the _SETUP sentinel
    window, e.g. a concurrent epoch-fenced rebuild) must close the
    freshly-built arena instead of caching it into the freed comm."""
    orig = pkg.shm.ShmColl._build_state
    built = []

    def slow_build(self, comm, epoch=0):
        st = orig(self, comm, epoch)
        gates = getattr(comm, "_test_gates", None)
        if gates is not None:
            built.append(st)
            gates[0].set()              # built — let the body free()
            assert gates[1].wait(timeout=20)
        return st

    monkeypatch.setattr(pkg.shm.ShmColl, "_build_state", slow_build)

    def body(comm):
        g0, g1 = threading.Event(), threading.Event()
        comm._test_gates = (g0, g1)
        res = []
        t = threading.Thread(
            target=lambda: res.append(comm.allreduce(np.ones(4))))
        t.start()
        assert g0.wait(timeout=20)
        comm.free()                     # sees _SETUP: nothing to close
        g1.set()
        t.join(timeout=60)
        assert not t.is_alive()
        return res[0]

    res = pkg.run(2, body, timeout=120)
    for out in res:
        np.testing.assert_allclose(out, np.full(4, 2.0))
    # every rank's half-built state was closed, not cached/leaked
    assert len(built) == 2
    for st in built:
        assert st.arena is None         # _State.close() ran


def test_rejoin_eagerly_rebinds_plans_in_bind_order(pkg):
    """Mixed one-shot + persistent apps: the revived life re-executes
    its prologue ``*_init`` BEFORE its first loop collective, so the
    survivors' rejoin must recompile their stale plans AS PART OF the
    rejoin (bind order), not at each plan's next Start — deferring
    them interleaves the bind collectives after one-shot ops the
    revived life has not issued yet and deadlocks (found driving the
    installed surface end-to-end)."""
    bar = threading.Barrier(2)

    def body(comm):
        req = comm.allreduce_init(np.ones(5))
        req.start()
        req.wait()
        comm.barrier()
        _simulate_revive(comm, victim=1, bar=bar)
        if comm.rank == 1:
            # the revived life: fresh state, fresh plan re-created by
            # its re-executed prologue BEFORE the loop's one-shot
            comm._coll_shm_state.close()
            comm._coll_shm_state = None
            req.free()
            req = comm.allreduce_init(np.ones(5))
        rb0 = pkg.trace.counters["coll_persistent_rebinds_total"]
        # the one-shot triggers the survivor's rejoin, whose tail must
        # pair the plan rebind with rank 1's fresh bind above
        out = comm.allreduce(np.full(2, float(comm.rank)))
        if comm.rank == 0:
            assert pkg.trace.counters["coll_persistent_rebinds_total"] > rb0
        req.start()
        pout = req.wait()
        return float(np.asarray(out)[0]), float(np.asarray(pout)[0])

    res = pkg.run(2, body, timeout=90)
    for o, p in res:
        assert o == 1.0 and p == 2.0


# ---------------------------------------------------------------------------
# FT poison semantics of the persistent and partitioned starts
# ---------------------------------------------------------------------------

def test_start_after_revoke_raises_err_revoked(pkg):
    def body(comm):
        req = comm.allreduce_init(np.ones(4))
        req.start()
        req.wait()
        comm.barrier()
        comm.revoke()
        try:
            req.start()
            return None
        except pkg.const.MPIException as e:
            return e.error_class

    assert all(c == pkg.const.ERR_REVOKED for c in pkg.run(2, body))


def test_init_on_revoked_comm_raises(pkg):
    def body(comm):
        comm.barrier()
        comm.revoke()
        try:
            comm.barrier_init()
            return None
        except pkg.const.MPIException as e:
            return e.error_class

    assert all(c == pkg.const.ERR_REVOKED for c in pkg.run(2, body))


def test_revived_member_invalidates_then_start_auto_rebinds(pkg):
    """A member revived since bind invalidates the pinned slots — the
    next Start AUTO-rebinds (collective: every rank's snapshot is the
    bind-agreed one, so every rank reaches the same verdict) with no
    user-visible error; rebinds_total ticks exactly once per rank."""
    def body(comm):
        req = comm.allreduce_init(np.ones(3))
        req.start()
        req.wait()
        comm.barrier()
        # simulate a selfheal revive of my neighbor: its epoch advances
        comm.pml._peer_epoch[(comm.rank + 1) % comm.size] = 3
        req.start()            # auto-rebind, not a raise
        out = req.wait()
        first = float(out[0])
        req.start()            # steady state again: no second rebind
        out2 = req.wait()
        return first, float(out2[0]), req.provider

    before = pkg.trace.counters["coll_persistent_rebinds_total"]
    res = pkg.run(2, body)
    assert all(a == 2.0 and b == 2.0 for a, b, _p in res)
    assert pkg.trace.counters["coll_persistent_rebinds_total"] == before + 2


def test_member_death_fails_start_fast(pkg):
    """A detector-declared-dead member (the rank-kill detection path:
    launcher reap / gossip / arena probe all feed the same dead-set)
    fails the next Start immediately with ERR_PROC_FAILED — no spin
    into the coll_shm_timeout."""
    ft_mod = pkg.ft
    ERR_PROC_FAILED = pkg.const.ERR_PROC_FAILED

    def body(comm):
        req = comm.allreduce_init(np.ones(4))
        req.start()
        req.wait()
        comm.barrier()
        ft = ft_mod.pml_ft(comm.pml)
        ft.detector.mark_failed((comm.rank + 1) % comm.size,
                                "seeded kill (test)")
        t0 = time.monotonic()
        try:
            req.start()
            return None
        except pkg.const.MPIException as e:
            return e.error_class, time.monotonic() - t0 < 5.0

    assert all(r == (ERR_PROC_FAILED, True) for r in pkg.run(2, body))


def test_post_shrink_reinit_converges(pkg):
    """The documented recovery: after a shrink, *_init on the survivor
    communicator compiles a fresh working plan."""
    def body(comm):
        comm.barrier()
        comm.revoke()
        new = comm.shrink()
        req = new.allreduce_init(np.full(4, new.rank + 1.0))
        req.start()
        return req.wait()

    for out in pkg.run(3, body):
        assert np.array_equal(out, np.full(4, 6.0))


def test_partitioned_start_after_revoke_raises(pkg):
    def body(comm):
        s = comm.psend_init(np.ones(4), dest=(comm.rank + 1) % 2,
                            tag=3, partitions=2)
        comm.barrier()
        comm.revoke()
        try:
            s.start()
            return None
        except pkg.const.MPIException as e:
            return e.error_class

    assert all(c == pkg.const.ERR_REVOKED for c in pkg.run(2, body))


# ---------------------------------------------------------------------------
# parity: one rejoin scenario through both packages
# ---------------------------------------------------------------------------

def test_rejoin_results_and_counts_equal_the_jax_package():
    """Bind a persistent allreduce, revive rank 2, run one-shot and
    persistent ops on the rebuilt hierarchy: the results, the agreed
    epoch, the providers, the rejoin/rebind counts and the flight
    recorder's rejoin records are the JAX package's."""
    def scenario(M):
        bar = threading.Barrier(3)

        def body(comm):
            req = comm.allreduce_init(np.arange(6.0) * (comm.rank + 1))
            req.start()
            r1 = req.wait()
            _simulate_revive(comm, victim=2, bar=bar)
            out = comm.allreduce(np.full(3, float(comm.rank) + 0.5))
            req.start()
            r2 = req.wait()
            st = comm._coll_shm_state
            return (r1.tolist(), out.tolist(), r2.tolist(), st.epoch,
                    st.mode, req.provider, comm.cid)

        keys = ("coll_rejoin_total", "coll_persistent_rebinds_total",
                "coll_persistent_binds_total")
        before = {k: M.trace.counters[k] for k in keys}
        M.trace.collrec.reset()
        res = M.run(3, body)
        # the flight recorder's rejoin records, without their timestamps
        rejoins = sorted(tuple(r[1:]) for r in M.trace.collrec.snapshot()
                         if r[5] == "rejoin")
        M.trace.collrec.reset()
        return (res, {k: M.trace.counters[k] - before[k] for k in keys},
                rejoins)

    jax_out, torch_out = scenario(JAX), scenario(TORCH)
    assert torch_out == jax_out
    res, counts, rejoins = torch_out
    assert all(r[3] == 1 for r in res)
    assert counts["coll_rejoin_total"] == 3
    assert len(rejoins) == 3
