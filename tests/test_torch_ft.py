"""The port's ULFM plane (``ompi_tpu_torch/mpi/ft.py``): revoke, shrink,
agree, get_failed and ack_failed, the failure detector's fail-fast paths,
the agreement's state GC, the rank-plane gossip, and the PML's
park-and-heal chain, held against the JAX package's.

Each case mirrors one of ``tests/mpi/test_ft.py`` (17) or
``tests/mpi/test_heal_chain.py``, with every assertion kept, and runs once
per package (``pkg``) on its own in-process world (threads as ranks, real
sockets and the proc BTL).  The heal chain runs on both PML matching
paths (``native``: the compiled engine and the Python matcher).  The
parity cases run one scenario through both packages and require equal
results: agree verdicts, shrunk groups and their cids, error classes and
strings, and the ``ft_*`` counters after one workload.
"""

from __future__ import annotations

import importlib
import threading
import time
import types

import numpy as np
import pytest


def _package(name: str) -> types.SimpleNamespace:
    mod = lambda m: importlib.import_module(f"{name}.{m}")  # noqa: E731
    return types.SimpleNamespace(
        name=name, ft=mod("mpi.ft"), pml=mod("mpi.pml"),
        comm=mod("mpi.comm"), group=mod("mpi.group"),
        const=mod("mpi.constants"), trace=mod("mpi.trace"),
        faultinject=mod("testing.faultinject"),
        vars=mod("core.config").var_registry)


@pytest.fixture(params=["ompi_tpu", "ompi_tpu_torch"])
def pkg(request):
    return _package(request.param)


@pytest.fixture(params=[True, False], ids=["native", "python"])
def native(request, pkg):
    """The PML's matching path: the compiled engine or the Python one."""
    old = pkg.vars.get("pml_native_match")
    pkg.vars.set("pml_native_match", request.param)
    yield request.param
    pkg.vars.set("pml_native_match", old)


def make_world(pkg, n):
    pmls = [pkg.pml.PmlOb1(r) for r in range(n)]
    addrs = {r: p.address for r, p in enumerate(pmls)}
    for p in pmls:
        p.set_peers(addrs)
    comms = [pkg.comm.Communicator(pkg.group.Group(range(n)), cid=0,
                                   pml=pmls[r], my_world_rank=r,
                                   name=f"ftw{n}")
             for r in range(n)]
    return pmls, comms


def run_on(ranks, fn, timeout=20.0):
    out, errs = {}, {}

    def runner(r):
        try:
            out[r] = fn(r)
        except BaseException as e:  # noqa: BLE001
            errs[r] = e

    ts = [threading.Thread(target=runner, args=(r,), daemon=True)
          for r in ranks]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout)
    assert not any(t.is_alive() for t in ts), \
        f"ranks hung (errors so far: {errs})"
    if errs:
        r, e = next(iter(errs.items()))
        raise AssertionError(f"rank {r} failed: {e!r}") from e
    return out


def test_error_classes_have_strings(pkg):
    assert "failed" in pkg.const.error_string(pkg.const.ERR_PROC_FAILED)
    assert "revoked" in pkg.const.error_string(pkg.const.ERR_REVOKED)


def test_agree_all_alive_is_and_of_flags(pkg):
    pmls, comms = make_world(pkg, 3)
    try:
        out = run_on(range(3), lambda r: comms[r].agree(r != 1))
        assert out == {0: False, 1: False, 2: False}
        out = run_on(range(3), lambda r: comms[r].agree(True))
        assert out == {0: True, 1: True, 2: True}
    finally:
        for p in pmls:
            p.close()


def test_agree_and_shrink_exclude_dead_rank(pkg):
    pmls, comms = make_world(pkg, 4)
    try:
        for r in (0, 1, 2):
            pkg.ft.pml_ft(pmls[r]).detector.mark_failed(3, "unit kill")
        shrunk = run_on((0, 1, 2), lambda r: comms[r].shrink())
        assert {c.cid for c in shrunk.values()} == \
            {shrunk[0].cid}, "survivors derived different cids"
        assert all(c.size == 3 for c in shrunk.values())
        # the survivor communicator is fully functional
        out = run_on((0, 1, 2),
                     lambda r: float(shrunk[r].allreduce(
                         np.array([float(r)]))[0]))
        assert set(out.values()) == {3.0}
    finally:
        for p in pmls:
            p.close()


def test_agree_survives_coordinator_death(pkg):
    """Rank 0 (the would-be coordinator) is dead: the next live rank
    takes over and the survivors still converge."""
    pmls, comms = make_world(pkg, 3)
    try:
        for r in (1, 2):
            pkg.ft.pml_ft(pmls[r]).detector.mark_failed(0, "unit kill")
        out = run_on((1, 2), lambda r: comms[r].agree(True))
        assert out == {1: True, 2: True}
    finally:
        for p in pmls:
            p.close()


def test_send_to_dead_peer_fails_fast(pkg):
    pmls, comms = make_world(pkg, 2)
    try:
        pkg.ft.pml_ft(pmls[0]).detector.mark_failed(1, "unit kill")
        t0 = time.monotonic()
        with pytest.raises(pkg.const.MPIException) as ei:
            comms[0].send(np.array([1.0]), dest=1)
        assert ei.value.error_class == pkg.const.ERR_PROC_FAILED
        # the whole point: nowhere near the 30 s pml_retry_window
        assert time.monotonic() - t0 < 2.0
    finally:
        for p in pmls:
            p.close()


def test_posted_recv_fails_when_peer_declared_dead(pkg):
    pmls, comms = make_world(pkg, 2)
    try:
        pkg.ft.pml_ft(pmls[0])   # install the sidecar so recvs are tracked
        req = comms[0].irecv(source=1, tag=5)
        pkg.ft.pml_ft(pmls[0]).detector.mark_failed(1, "unit kill")
        with pytest.raises(pkg.const.MPIException) as ei:
            req.wait(timeout=5.0)
        assert ei.value.error_class == pkg.const.ERR_PROC_FAILED
        # and a recv posted AFTER the death fails too
        with pytest.raises(pkg.const.MPIException) as ei:
            comms[0].recv(source=1, tag=6)
        assert ei.value.error_class == pkg.const.ERR_PROC_FAILED
    finally:
        for p in pmls:
            p.close()


def test_revoke_poisons_all_members_and_unblocks_recvs(pkg):
    pmls, comms = make_world(pkg, 3)
    try:
        pkg.ft.pml_ft(pmls[1])   # rank 1 tracks its posted recvs
        blocked = comms[1].irecv(source=2, tag=9)  # never matched
        comms[0].revoke()
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline and not all(
                comms[r].is_revoked() for r in range(3)):
            time.sleep(0.01)
        assert all(comms[r].is_revoked() for r in range(3))
        with pytest.raises(pkg.const.MPIException) as ei:
            blocked.wait(timeout=5.0)
        assert ei.value.error_class == pkg.const.ERR_REVOKED
        for r in range(3):
            with pytest.raises(pkg.const.MPIException) as ei:
                comms[r].send(np.array([1.0]), dest=(r + 1) % 3)
            assert ei.value.error_class == pkg.const.ERR_REVOKED
            with pytest.raises(pkg.const.MPIException):
                comms[r].irecv(source=(r + 1) % 3)
        # agree still works on the revoked communicator (ULFM contract)
        out = run_on(range(3), lambda r: comms[r].agree(True))
        assert set(out.values()) == {True}
    finally:
        for p in pmls:
            p.close()


def test_revoke_does_not_leak_into_other_comms(pkg):
    pmls, comms = make_world(pkg, 2)
    try:
        dups = run_on(range(2), lambda r: comms[r].dup())
        comms[0].revoke()
        time.sleep(0.2)
        # the dup has its own cid: traffic on it still flows
        out = run_on(range(2), lambda r: (
            dups[r].send(np.array([float(r)]), dest=1 - r),
            float(dups[r].recv(source=1 - r)[0]))[1])
        assert out == {0: 1.0, 1: 0.0}
    finally:
        for p in pmls:
            p.close()


def test_get_failed_and_ack_failed(pkg):
    pmls, comms = make_world(pkg, 3)
    try:
        assert comms[0].get_failed().ranks == ()
        assert comms[0].ack_failed() == 0
        pkg.ft.pml_ft(pmls[0]).detector.mark_failed(2, "unit kill")
        assert comms[0].get_failed().ranks == (2,)
        assert comms[0].ack_failed() == 1
    finally:
        for p in pmls:
            p.close()


def test_agree_consistent_under_injected_ft_drops(pkg):
    """The acceptance scenario: shrink + agree converge to identical
    results on every survivor while the fault injector drops 25% of the
    FT control frames (the protocols' retransmission absorbs it)."""
    var_registry = pkg.vars
    faultinject = pkg.faultinject

    faultinject.reset()
    var_registry.set("faultinject_plan", "drop=0.25")
    var_registry.set("faultinject_seed", 3)
    try:
        pmls, comms = make_world(pkg, 4)
        try:
            assert all(p.endpoint._fault is not None for p in pmls)
            for r in (0, 2, 3):
                pkg.ft.pml_ft(pmls[r]).detector.mark_failed(1, "injected")
            shrunk = run_on((0, 2, 3), lambda r: comms[r].shrink(),
                            timeout=30.0)
            assert len({c.cid for c in shrunk.values()}) == 1
            out = run_on((0, 2, 3), lambda r: shrunk[r].agree(True),
                         timeout=30.0)
            assert set(out.values()) == {True}
            drops = [e for e in faultinject.events()
                     if e["kind"] == "drop"]
            assert drops, "plan armed but no drops fired"
        finally:
            for p in pmls:
                p.close()
    finally:
        var_registry.set("faultinject_plan", "")
        faultinject.reset()


def test_shrink_twice_handles_sequential_failures(pkg):
    pmls, comms = make_world(pkg, 4)
    try:
        for r in (0, 1, 2):
            pkg.ft.pml_ft(pmls[r]).detector.mark_failed(3, "kill 1")
        first = run_on((0, 1, 2), lambda r: comms[r].shrink())
        for r in (0, 1):
            pkg.ft.pml_ft(pmls[r]).detector.mark_failed(2, "kill 2")
        second = run_on((0, 1), lambda r: first[r].shrink())
        assert all(c.size == 2 for c in second.values())
        assert len({c.cid for c in second.values()}) == 1
        out = run_on((0, 1), lambda r: float(second[r].allreduce(
            np.array([1.0]))[0]))
        assert set(out.values()) == {2.0}
    finally:
        for p in pmls:
            p.close()


# ---------------------------------------------------------------------------
# early-deciding agreement: acked-decision watermarks + state GC
# ---------------------------------------------------------------------------

def test_agree_state_gc_is_memory_bounded(pkg):
    """1000 sequential agrees must not accumulate 1000 _AgreeState
    entries: watermark acks let every fully-returned round be reclaimed
    (the per-(cid, seq) leak this PR closes)."""
    import time as _time

    trace_mod = pkg.trace

    rounds = 1000
    before = trace_mod.counters["ft_agree_gc_reclaimed_total"]
    pmls, comms = make_world(pkg, 3)
    try:
        def body(r):
            for _ in range(rounds):
                assert comms[r].agree(True) is True

        run_on(range(3), body, timeout=240.0)
        # let the last round's acks + floor broadcast land
        deadline = _time.monotonic() + 5.0
        while _time.monotonic() < deadline:
            sizes = [len(pkg.ft.pml_ft(p)._comms[0].states) for p in pmls]
            if max(sizes) <= 4:
                break
            _time.sleep(0.05)
        for p in pmls:
            cft = pkg.ft.pml_ft(p)._comms[0]
            assert len(cft.states) <= 4, \
                (p.rank, len(cft.states), "agree states leaked")
            assert cft.gc_floor >= rounds - 4, (p.rank, cft.gc_floor)
        assert trace_mod.counters["ft_agree_gc_reclaimed_total"] > before
    finally:
        for p in pmls:
            p.close()


def test_agree_gc_floor_ignores_stale_frames(pkg):
    """A straggler's retransmission for a reclaimed seq must not
    resurrect state (unbounded re-creation would undo the GC)."""
    pmls, comms = make_world(pkg, 2)
    try:
        run_on(range(2), lambda r: comms[r].agree(True))
        sidecar = pkg.ft.pml_ft(pmls[0])
        cft = sidecar._comms[0]
        sidecar._apply_gc_floor(cft, 0)   # force: seq 0 reclaimed
        assert 0 not in cft.states
        sidecar._recv_agree_contrib(1, {
            "cid": 0, "aseq": 0, "from": 1, "flag": 1, "failed": [],
            "n": 9})
        assert 0 not in cft.states, "stale contrib resurrected GC'd state"
    finally:
        for p in pmls:
            p.close()


def test_agree_gc_excludes_dead_members(pkg):
    """A dead rank never acks — the floor must advance over it (its
    unacked seqs would otherwise pin memory forever)."""
    pmls, comms = make_world(pkg, 3)
    try:
        for r in (0, 1):
            pkg.ft.pml_ft(pmls[r]).detector.mark_failed(2, "unit kill")
        run_on((0, 1), lambda r: [comms[r].agree(True) for _ in range(5)])
        import time as _time

        deadline = _time.monotonic() + 5.0
        while _time.monotonic() < deadline:
            if all(pkg.ft.pml_ft(pmls[r])._comms[0].gc_floor >= 3
                   for r in (0, 1)):
                break
            _time.sleep(0.05)
        for r in (0, 1):
            assert pkg.ft.pml_ft(pmls[r])._comms[0].gc_floor >= 3, \
                (r, pkg.ft.pml_ft(pmls[r])._comms[0].gc_floor)
    finally:
        for p in pmls:
            p.close()


# ---------------------------------------------------------------------------
# rank-plane gossip heartbeats
# ---------------------------------------------------------------------------

def test_gossip_window_clamps_to_twice_period(pkg):
    var_registry = pkg.vars

    var_registry.set("ft_gossip_period", 1.0)
    var_registry.set("ft_gossip_timeout", 0.5)
    try:
        assert pkg.ft.gossip_window() == 2.0
        var_registry.set("ft_gossip_timeout", 5.0)
        assert pkg.ft.gossip_window() == 5.0
    finally:
        var_registry.set("ft_gossip_period", 0.0)
        var_registry.set("ft_gossip_timeout", 2.0)


def test_gossip_declares_silent_rank(pkg):
    """An in-host hang: rank 2's pid is alive (same process, even) but
    it never beats — the beating ranks must declare it suspect within
    the gossip window and fail operations against it fast."""
    var_registry = pkg.vars

    var_registry.set("ft_gossip_period", 0.1)
    var_registry.set("ft_gossip_timeout", 0.5)
    pmls, comms = make_world(pkg, 3)
    try:
        for r in (0, 1):
            pkg.ft.pml_ft(pmls[r]).arm_gossip([0, 1, 2])
        # rank 2 exists and receives, but never arms → its epoch stalls
        deadline = time.monotonic() + 6.0
        while time.monotonic() < deadline:
            if all(pkg.ft.pml_ft(pmls[r]).detector.is_dead(2, poll=False)
                   for r in (0, 1)):
                break
            time.sleep(0.05)
        for r in (0, 1):
            det = pkg.ft.pml_ft(pmls[r]).detector
            assert det.is_dead(2, poll=False), f"rank {r} never declared 2"
            assert "gossip" in det.reason(2)
        # and ranks 0/1 kept each OTHER alive through their beats
        assert not pkg.ft.pml_ft(pmls[0]).detector.is_dead(1, poll=False)
        assert not pkg.ft.pml_ft(pmls[1]).detector.is_dead(0, poll=False)
        with pytest.raises(pkg.const.MPIException) as ei:
            comms[0].send(np.array([1.0]), dest=2)
        assert ei.value.error_class == pkg.const.ERR_PROC_FAILED
    finally:
        for p in pmls:
            p.close()
        var_registry.set("ft_gossip_period", 0.0)
        var_registry.set("ft_gossip_timeout", 2.0)


def test_gossip_beats_tick_the_pvar_and_spread_views(pkg):
    var_registry = pkg.vars
    trace_mod = pkg.trace

    var_registry.set("ft_gossip_period", 0.05)
    before = trace_mod.counters["ft_gossip_beats_total"]
    pmls, comms = make_world(pkg, 2)
    try:
        for r in (0, 1):
            pkg.ft.pml_ft(pmls[r]).arm_gossip([0, 1])
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline:
            if (trace_mod.counters["ft_gossip_beats_total"] > before
                    and pkg.ft.pml_ft(pmls[0])._beats.get(1, [0])[0] > 0):
                break
            time.sleep(0.05)
        assert trace_mod.counters["ft_gossip_beats_total"] > before
        # rank 0 learned rank 1's advancing epoch from the beat frames
        assert pkg.ft.pml_ft(pmls[0])._beats[1][0] > 0
    finally:
        for p in pmls:
            p.close()
        var_registry.set("ft_gossip_period", 0.0)


# ---------------------------------------------------------------------------
# park-and-heal: single healer chain, exactly-once delivery
# ---------------------------------------------------------------------------

def test_heal_chain_exactly_once_in_order(pkg, native):
    var_registry = pkg.vars
    old_window = var_registry.get("pml_retry_window")
    var_registry.set("pml_retry_window", 20)
    pmls = [pkg.pml.PmlOb1(r) for r in range(2)]
    try:
        addrs = {r: p.address for r, p in enumerate(pmls)}
        for p in pmls:
            p.set_peers(addrs)
        comms = [pkg.comm.Communicator(pkg.group.Group(range(2)), cid=0,
                                       pml=pmls[r], my_world_rank=r)
                 for r in range(2)]
        sender = pmls[0]

        # force every frame through the send worker + heal machinery
        # (the engine fast lane and inline sendi are both same-thread
        # shortcuts that would bypass the flaky route below)
        sender.endpoint.try_send_inline = lambda *a, **k: False
        if sender.endpoint.proc_btl is not None:
            sender.endpoint.proc_btl.send_fast = lambda *a, **k: False
        orig_send = sender.endpoint.send
        flaky = {"fails": 0}
        lock = threading.Lock()

        def send(peer, hdr, payload=b""):
            with lock:
                if flaky["fails"] > 0:
                    flaky["fails"] -= 1
                    raise ConnectionError("synthetic route outage")
            return orig_send(peer, hdr, payload)

        sender.endpoint.send = send

        # instrument the healer: count concurrently-alive chains
        orig_run = sender._run_heal
        alive = []
        peak = [0]

        def run_heal(peer, deadline):
            with lock:
                alive.append(peer)
                peak[0] = max(peak[0], alive.count(peer))
            try:
                orig_run(peer, deadline)
            finally:
                with lock:
                    alive.remove(peer)

        sender._run_heal = run_heal

        # outage spans the initial delivery AND several heal ticks — the
        # chained-retry path (where the double-schedule lived) must run
        with lock:
            flaky["fails"] = 6
        n_msgs = 8
        reqs = [comms[0].isend(np.array([i], np.int64), dest=1, tag=4)
                for i in range(n_msgs)]

        got = [comms[1].recv(source=0, tag=4)
               for _ in range(n_msgs)]
        values = [int(np.asarray(g)[0]) for g in got]
        assert values == list(range(n_msgs)), values   # in order, no dup/loss
        for r in reqs:
            r.wait(timeout=30)

        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            with sender._lock:
                parked = dict(sender._parked)
            with sender._qlock:
                healing = set(sender._healing)
            if not parked and not healing:
                break
            time.sleep(0.05)
        assert not parked and not healing, (parked, healing)
        assert peak[0] <= 1, f"{peak[0]} concurrent healer chains for one peer"
        # sanity: the outage actually exercised the heal path
        assert sender.pvar_healed._value > 0
    finally:
        var_registry.set("pml_retry_window", old_window)
        for p in pmls:
            p.close()


# ---------------------------------------------------------------------------
# parity: the same scenario through both packages, equal results
# ---------------------------------------------------------------------------

JAX, TORCH = _package("ompi_tpu"), _package("ompi_tpu_torch")

_FT_COUNTERS = ("ft_rank_deaths_total", "ft_revokes_total",
                "ft_agrees_total", "ft_shrinks_total")


def _shrink_scenario(pkg):
    """Rank 3 dies; the survivors agree (with a dissent), shrink, agree
    and allreduce on the shrunk world, then rank 2 dies and they shrink
    again — every verdict, group and cid, and the FT counters' deltas."""
    before = {k: pkg.trace.counters[k] for k in _FT_COUNTERS}
    pmls, comms = make_world(pkg, 4)
    try:
        for r in (0, 1, 2):
            pkg.ft.pml_ft(pmls[r]).detector.mark_failed(3, "unit kill")
        votes = run_on((0, 1, 2), lambda r: comms[r].agree(r != 2))
        first = run_on((0, 1, 2), lambda r: comms[r].shrink())
        sums = run_on((0, 1, 2), lambda r: float(first[r].allreduce(
            np.array([float(r + 1)]))[0]))
        failed = {r: comms[r].get_failed().ranks for r in (0, 1, 2)}
        acked = {r: comms[r].ack_failed() for r in (0, 1, 2)}
        comms[0].revoke()
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline and not all(
                comms[r].is_revoked() for r in (0, 1, 2)):
            time.sleep(0.01)
        for r in (0, 1):
            pkg.ft.pml_ft(pmls[r]).detector.mark_failed(2, "kill 2")
        second = run_on((0, 1), lambda r: first[r].shrink())
        try:
            comms[1].send(np.array([1.0]), dest=0)
            err = None
        except pkg.const.MPIException as e:
            err = (e.error_class, pkg.const.error_string(e.error_class))
        out = {
            "votes": votes, "failed": failed, "acked": acked,
            "first": {r: (c.cid, c.group.ranks, c.rank, c.name)
                      for r, c in first.items()},
            "sums": sums,
            "second": {r: (c.cid, c.group.ranks, c.rank)
                       for r, c in second.items()},
            "revoked_send": err,
        }
    finally:
        for p in pmls:
            p.close()
    out["counters"] = {k: pkg.trace.counters[k] - v
                       for k, v in before.items()}
    return out


def test_agree_and_shrink_results_equal_the_jax_package():
    jax_out, torch_out = _shrink_scenario(JAX), _shrink_scenario(TORCH)
    assert torch_out == jax_out
    assert torch_out["votes"] == {0: False, 1: False, 2: False}
    assert torch_out["revoked_send"] == (77, "communicator has been "
                                             "revoked")
    assert torch_out["counters"]["ft_shrinks_total"] == 5


@pytest.mark.parametrize("cls", ["ERR_PROC_FAILED",
                                 "ERR_PROC_FAILED_PENDING", "ERR_REVOKED",
                                 "ERR_TRUNCATE", "ERR_IO", "SUCCESS"])
def test_error_classes_and_strings_equal_the_jax_package(cls):
    j, t = getattr(JAX.const, cls), getattr(TORCH.const, cls)
    assert t == j
    assert TORCH.const.error_string(t) == JAX.const.error_string(j)


# ---------------------------------------------------------------------------
# the ULFM recipe launched: shrink_allreduce prints the JAX package's lines
# ---------------------------------------------------------------------------

def _expected_shrink_acc(np_, steps, victim, kill_step):
    """Full-world sums for the steps agreed before the kill, survivor
    sums from it on (the step of the kill is redone on the shrunk
    world, from the last agreed snapshot)."""
    acc = 0
    for s in range(steps):
        ids = [i for i in range(np_) if s < kill_step or i != victim]
        acc += sum(i * 10 + s for i in ids)
    return acc


def test_shrink_allreduce_prints_the_jax_package_lines(tmp_path):
    import os
    import pathlib
    import subprocess
    import sys

    root = pathlib.Path(__file__).resolve().parents[1]
    plan = ["--mca", "errmgr", "notify",
            "--mca", "faultinject_plan", "rank=2:kill@step=3"]
    runs = {}
    for name, app in (("ompi_tpu", [sys.executable,
                                    "examples/shrink_allreduce.py"]),
                      ("ompi_tpu_torch", [
                          sys.executable, "-m",
                          "ompi_tpu_torch.examples.shrink_allreduce"])):
        env = {**os.environ, "JAX_PLATFORMS": "cpu",
               "CKPT_DIR": str(tmp_path / name)}
        env.pop("OMPI_TPU_RANK", None)
        runs[name] = subprocess.run(
            [sys.executable, "-m", f"{name}.tools.tpurun", "-np", "4",
             *plan, "--", *app], cwd=root, capture_output=True,
            text=True, timeout=120, env=env)
    lines = {}
    for name, r in runs.items():
        assert r.returncode == 0, (name, r.stdout, r.stderr)
        # the detect lines carry a measured time: compare their prefix
        lines[name] = sorted(
            ln.split(" detect_dt=")[0] for ln in r.stdout.splitlines()
            if ln.strip())
    assert lines["ompi_tpu_torch"] == lines["ompi_tpu"]
    want = _expected_shrink_acc(4, 6, victim=2, kill_step=3)
    for rank in (0, 1, 3):
        assert (f"[1,{rank}]id {rank} final acc={want} size=3 shrinks=1"
                in lines["ompi_tpu_torch"])
