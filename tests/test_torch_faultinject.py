"""The port's fault injector (``ompi_tpu_torch/testing/faultinject.py``),
held against the JAX package's.

Each case mirrors one of ``tests/testing/test_faultinject.py``, with
every assertion kept, and runs once per package (``fi``):
the plan grammar (``daemon=`` entries included), the verdict hash, the
rank, step, time and ``@coll`` triggers and the endpoint's arming.  The
daemon hooks the orted arms (``arm_daemon``'s ``kill@t=`` and
``arm_daemon_launch``'s barrier-keyed ``kill@reg=N:after=S`` over PMIx's
``query_regstate``) run on each package too.  The parity cases fire one plan and seed over one
workload in both packages (the verdicts over a fixed frame list, and a
4-rank job of eager p2p and host collectives over the proc BTL, the shm
rings and the tcp plane, native on and off) and require equal fired-fault
logs, and the ``mismatch@coll`` trigger records the same divergent kind
in both flight recorders.
"""

from __future__ import annotations

import importlib
import types

import numpy as np
import pytest

from tests.mpi.harness import run_ranks as jrun
from tests.torch_host_harness import run_ranks as prun


def _package(name: str) -> types.SimpleNamespace:
    mod = lambda m: importlib.import_module(f"{name}.{m}")  # noqa: E731
    mod("mpi.btl_shm")   # registers the btl and coll/shm variables
    mod("mpi.coll.shm")
    return types.SimpleNamespace(
        name=name, fi=mod("testing.faultinject"), pml=mod("mpi.pml"),
        trace=mod("mpi.trace"), vars=mod("core.config").var_registry)


JAX, TORCH = _package("ompi_tpu"), _package("ompi_tpu_torch")


@pytest.fixture(params=[JAX, TORCH], ids=["ompi_tpu", "ompi_tpu_torch"])
def pkg(request):
    return request.param


@pytest.fixture
def fi(pkg):
    pkg.fi.reset()
    yield pkg.fi
    pkg.fi.reset()


def test_plan_grammar_parses_every_action(fi):
    acts = fi.parse_plan(
        "rank=2:kill@step=3;rank=1:kill@t=0.5;daemon=1:kill@t=1.0;"
        "drop=0.01;drop=0.05@all;rank=1:drop=0.1;delay=0.02,5;dup=0.01")
    kinds = [a.kind for a in acts]
    assert kinds == ["kill", "kill", "daemon_kill", "drop", "drop",
                     "drop", "delay", "dup"]
    assert acts[0].rank == 2 and acts[0].at_step == 3
    assert acts[1].at_time == 0.5
    assert acts[2].vpid == 1 and acts[2].at_time == 1.0
    assert acts[3].scope == "ft" and acts[3].prob == 0.01
    assert acts[4].scope == "all"
    assert acts[5].rank == 1
    assert acts[6].delay_ms == 5.0
    assert acts[7].scope == "all"


@pytest.mark.parametrize("bad", [
    "kill",                      # no trigger
    "rank=1:kill@never=3",       # unknown trigger
    "drop=0.1@sometimes",        # unknown scope
    "frobnicate=1",              # unknown token
])
def test_plan_grammar_rejects_garbage(fi, bad):
    with pytest.raises(ValueError):
        fi.parse_plan(bad)


def test_empty_plan_means_inactive(fi):
    assert fi.parse_plan("") == []
    assert not fi.active() or fi.plan_text()  # env may arm it externally


def test_reg_trigger_parses_with_after_grace(fi):
    """daemon=V:kill@reg=N[:after=S] — the ranks-registered barrier
    schedule (the midtree-kill de-flake)."""
    a = fi.parse_plan("daemon=1:kill@reg=4:after=1.5")[0]
    assert (a.kind, a.vpid, a.at_reg, a.after) == \
        ("daemon_kill", 1, 4, 1.5)
    assert a.at_time is None and a.at_step is None
    # field order within the entry is free; after defaults to 1.0
    b = fi.parse_plan("kill@reg=3:daemon=2")[0]
    assert (b.kind, b.vpid, b.at_reg, b.after) == \
        ("daemon_kill", 2, 3, 1.0)


@pytest.mark.parametrize("bad", [
    "rank=1:kill@reg=2",          # @reg is daemon-kill only
    "rank=0:hang@reg=2",          # hangs target ranks, no reg barrier
    "daemon=1:kill@reg=4:after=-1",   # negative grace
])
def test_reg_trigger_rejects_non_daemon_targets(fi, bad):
    with pytest.raises(ValueError):
        fi.parse_plan(bad)


def test_verdict_is_pure_function_of_frame_identity(fi):
    hdr = {"t": "ft", "op": "agree_c", "cid": 0, "aseq": 1, "n": 2}
    ident = fi._frame_ident(hdr)
    u1 = fi._u01(7, 0, 3, ident, "drop")
    u2 = fi._u01(7, 0, 3, ident, "drop")
    assert u1 == u2
    # a different attempt (retransmission) draws a fresh verdict
    hdr2 = dict(hdr, n=3)
    assert fi._frame_ident(hdr2) != ident
    # and a different seed moves the whole stream
    assert fi._u01(8, 0, 3, ident, "drop") != u1


def test_injector_respects_rank_scoping(fi):
    acts = fi.parse_plan("rank=1:drop=1.0")
    inj0 = fi.Injector(0, acts, seed=0)
    inj1 = fi.Injector(1, acts, seed=0)
    hdr = {"t": "ft", "op": "revoke", "cid": 5, "n": 0}
    assert inj0.on_frame(2, hdr) == "send"     # action scoped to rank 1
    assert inj1.on_frame(2, hdr) == "drop"     # p=1.0 always drops
    assert inj1.events and inj1.events[0]["kind"] == "drop"


def test_drop_scope_ft_spares_data_frames(fi):
    acts = fi.parse_plan("drop=1.0")           # default scope: ft only
    inj = fi.Injector(0, acts, seed=0)
    assert inj.on_frame(1, {"t": "eager", "tag": 3, "cid": 0,
                            "seq": 0}) == "send"
    assert inj.on_frame(1, {"t": "ft", "op": "revoke", "cid": 0,
                            "n": 0}) == "drop"


def test_drop_scope_all_hits_data_frames(fi):
    acts = fi.parse_plan("drop=1.0@all")
    inj = fi.Injector(0, acts, seed=0)
    assert inj.on_frame(1, {"t": "eager", "tag": 3, "cid": 0,
                            "seq": 0}) == "drop"


def test_delay_verdict_carries_milliseconds(fi):
    acts = fi.parse_plan("delay=1.0,7")
    inj = fi.Injector(0, acts, seed=0)
    verdict = inj.on_frame(1, {"t": "eager", "tag": 0, "cid": 0, "seq": 0})
    assert verdict == ("delay", 7.0)


def test_step_counter_advances_without_kills(fi):
    inj = fi.Injector(0, fi.parse_plan("rank=5:kill@step=1"), seed=0)
    assert inj.step() == 0
    assert inj.step() == 1   # rank-scoped elsewhere: we survive
    assert inj.step() == 2


def test_kills_disabled_for_respawned_incarnations(fi, monkeypatch):
    monkeypatch.setenv("OMPI_TPU_RESTART", "1")
    inj = fi.Injector(0, fi.parse_plan("rank=0:kill@step=0"), seed=0)
    inj.step()   # would os._exit(9) if the first-life gate were missing
    assert inj.events == []


def test_btl_endpoint_arms_injector_under_plan(fi, pkg):
    var_registry = pkg.vars
    PmlOb1 = pkg.pml.PmlOb1

    fi.reset()
    var_registry.set("faultinject_plan", "drop=0.5")
    try:
        pml = PmlOb1(0)
        try:
            assert pml.endpoint._fault is not None
            assert pml.endpoint._fault.rank == 0
        finally:
            pml.close()
    finally:
        var_registry.set("faultinject_plan", "")
        fi.reset()


def test_hang_grammar_parses_step_and_time_triggers(fi):
    acts = fi.parse_plan("rank=2:hang@step=3;rank=1:hang@t=0.5")
    assert [(a.kind, a.rank, a.at_step, a.at_time) for a in acts] == \
        [("hang", 2, 3, None), ("hang", 1, None, 0.5)]


def test_hang_rejects_daemons_and_missing_trigger(fi):
    with pytest.raises(ValueError):
        fi.parse_plan("daemon=1:hang@t=1.0")   # daemons hang via heartbeats
    with pytest.raises(ValueError):
        fi.parse_plan("rank=1:hang")           # no trigger


def test_hang_fires_at_step_and_records_event(fi, monkeypatch):
    hung = []
    monkeypatch.setattr(fi.Injector, "_hang_impl",
                        lambda self: hung.append(self.rank))
    acts = fi.parse_plan("rank=0:hang@step=2")
    inj = fi.Injector(0, acts, seed=0)
    inj.step(); inj.step()
    assert hung == []
    inj.step()                                 # entering step 2
    assert hung == [0]
    evs = [e for e in inj.events if e["kind"] == "hang"]
    assert evs and evs[0]["trigger"] == "step" and evs[0]["value"] == 2
    assert evs[0]["mode"] in ("stop", "spin")
    # one terminal fault per life: the next step must not re-fire
    inj.step()
    assert hung == [0]


def test_hang_first_life_only(fi, monkeypatch):
    monkeypatch.setenv("OMPI_TPU_RESTART", "1")
    acts = fi.parse_plan("rank=0:hang@step=0")
    inj = fi.Injector(0, acts, seed=0)
    inj.step()                                 # would fire in life 0
    assert not [e for e in inj.events if e["kind"] == "hang"]


def test_crash_grammar_parses_step_and_time_triggers(fi):
    acts = fi.parse_plan("rank=2:crash@step=3;rank=1:crash@t=0.5")
    assert [(a.kind, a.rank, a.at_step, a.at_time) for a in acts] == \
        [("crash", 2, 3, None), ("crash", 1, None, 0.5)]


def test_crash_rejects_daemons_and_missing_trigger(fi):
    with pytest.raises(ValueError):
        fi.parse_plan("daemon=1:crash@t=1.0")  # daemon revival doesn't exist
    with pytest.raises(ValueError):
        fi.parse_plan("rank=1:crash")          # no trigger


def test_crash_fires_in_every_life(fi, monkeypatch):
    """Unlike kill/hang (first-life-only by design), crash re-arms in a
    respawned incarnation — the crash loop that proves the errmgr revive
    budget and the selfheal escalation ladder."""
    died = []
    monkeypatch.setattr(
        fi.Injector, "_fire_kill",
        lambda self, trigger, value, kind="kill":
            (died.append((self.rank, kind, trigger, value)),
             self._record(kind, trigger=trigger, value=value))[0])
    monkeypatch.setenv("OMPI_TPU_RESTART", "2")   # third life
    acts = fi.parse_plan("rank=0:crash@step=1;rank=0:kill@step=1")
    inj = fi.Injector(0, acts, seed=0)
    assert [a.kind for a in inj._kills] == ["crash"]  # kill stays gated
    inj.step(); inj.step()
    assert died == [(0, "crash", "step", 1)]
    evs = [e["kind"] for e in inj.events]
    assert evs == ["crash"]                     # distinct kind in the log


# ---------------------------------------------------------------------------
# collective triggers (stall/mismatch@coll — the hang-doctor chaos arm)
# ---------------------------------------------------------------------------

def test_stall_mismatch_grammar_parses_coll_trigger(fi):
    acts = fi.parse_plan("rank=2:stall@coll=5;rank=1:mismatch@coll=3")
    assert [(a.kind, a.rank, a.at_coll) for a in acts] == \
        [("stall", 2, 5), ("mismatch", 1, 3)]


@pytest.mark.parametrize("bad", [
    "daemon=1:stall@coll=2",     # collective triggers target ranks
    "rank=1:stall",              # no trigger
    "rank=1:stall@step=2",       # @coll is the only stall trigger
    "rank=1:mismatch@t=1.0",     # same for mismatch
    "rank=1:hang@coll=2",        # a hang inside dispatch is spelled stall
    "rank=1:crash@coll=2",       # crash is every-life; @coll is first-only
    "kill@coll=2:daemon=1",      # daemon seen after the kill key: still
    #                              a daemon kill, and @coll targets ranks
])
def test_stall_mismatch_reject_bad_entries(fi, bad):
    with pytest.raises(ValueError):
        fi.parse_plan(bad)


def test_kill_at_coll_grammar_and_first_life_only(fi, monkeypatch):
    """kill@coll=N parses (the selfheal-coll mid-collective death) and
    arms the collective choke point in the FIRST life only — a revived
    victim must not re-die at the same ordinal."""
    acts = fi.parse_plan("rank=2:kill@coll=5")
    assert [(a.kind, a.rank, a.at_coll) for a in acts] == [("kill", 2, 5)]
    inj = fi.Injector(2, acts, seed=0)
    assert inj.coll_faults()
    for n in range(5):
        assert inj.coll_op() == (None, n)
    assert inj.coll_op() == ("kill", 5)
    # the revived life (OMPI_TPU_RESTART set) never arms it
    monkeypatch.setenv("OMPI_TPU_RESTART", "1")
    revived = fi.Injector(2, acts, seed=0)
    assert not revived.coll_faults()


def test_fire_coll_kill_exits_via_fire_kill(fi, monkeypatch):
    """fire_coll('kill', ...) routes through _fire_kill (records the
    fault with trigger=coll, then os._exit in production)."""
    fired = []
    monkeypatch.setattr(
        fi.Injector, "_fire_kill",
        lambda self, trigger, value, kind="kill":
        fired.append((kind, trigger, value)))
    inj = fi.Injector(1, fi.parse_plan("rank=1:kill@coll=2"), seed=0)
    assert inj.coll_op() == (None, 0)
    assert inj.coll_op() == (None, 1)
    kind, n = inj.coll_op()
    assert (kind, n) == ("kill", 2)
    inj.fire_coll(kind, n, seq=7)
    assert fired == [("kill", "coll", 2)]


def test_coll_op_advances_ordinal_and_fires_by_position(fi):
    inj = fi.Injector(1, fi.parse_plan("rank=1:stall@coll=2"), seed=0)
    assert inj.coll_faults()
    assert inj.coll_op() == (None, 0)
    assert inj.coll_op() == (None, 1)
    assert inj.coll_op() == ("stall", 2)
    other = fi.Injector(2, fi.parse_plan("rank=1:stall@coll=0"), seed=0)
    assert not other.coll_faults()


def test_coll_triggers_first_life_only(fi, monkeypatch):
    monkeypatch.setenv("OMPI_TPU_RESTART", "2")
    inj = fi.Injector(1, fi.parse_plan("rank=1:mismatch@coll=0"), seed=0)
    assert not inj.coll_faults() and inj.coll_op() == (None, 0)


def test_fire_coll_records_then_spin_parks(fi, monkeypatch):
    """mismatch ALWAYS spin-parks (the divergent rank must stay
    capturable); the event carries the ordinal + op_seq so replay
    checks reproduce the schedule."""
    class _Break(Exception):
        pass

    def no_sleep(_s):
        raise _Break()

    monkeypatch.setattr(fi.time, "sleep", no_sleep)
    inj = fi.Injector(1, fi.parse_plan("rank=1:mismatch@coll=4"), seed=0)
    with pytest.raises(_Break):
        inj.fire_coll("mismatch", 4, 7)
    ev = inj.events[0]
    assert (ev["kind"], ev["trigger"], ev["value"], ev["seq"],
            ev["mode"]) == ("mismatch", "coll", 4, 7, "spin")
    # one terminal fault per life, like kills
    assert inj.coll_op()[0] is None
    inj.fire_coll("mismatch", 4, 7)   # dead: no second park, no event
    assert len(inj.events) == 1


# ---------------------------------------------------------------------------
# the daemon hooks the orted arms
# ---------------------------------------------------------------------------

def test_arm_daemon_launch_waits_for_reg_and_ready_barrier(fi, pkg,
                                                            monkeypatch):
    """``tests/testing/test_faultinject.py``'s case on each package: the
    reg watcher fires the kill only once every rank registered AND sent
    its init-complete notice."""
    import time as _time

    pmix = importlib.import_module(f"{pkg.name}.runtime.pmix")
    server = pmix.PMIxServer(size=2)
    killed = []
    monkeypatch.setattr(fi, "_daemon_die", lambda vpid: killed.append(vpid))
    monkeypatch.setenv(fi.ENV_PLAN, "daemon=1:kill@reg=2:after=0.0")
    try:
        fi.arm_daemon_launch(1, {pmix.ENV_URI: server.uri})
        _time.sleep(0.6)
        assert killed == [], "kill fired before anyone registered"
        c0 = pmix.PMIxClient(uri=server.uri, rank=0, size=2)
        c1 = pmix.PMIxClient(uri=server.uri, rank=1, size=2)
        assert pmix.query_regstate(server.uri) == (2, 0, 0)
        _time.sleep(0.6)
        assert killed == [], \
            "kill fired between registration and init completion"
        c0.ready()
        _time.sleep(0.4)
        assert killed == [], "kill fired with only 1/2 ranks ready"
        c1.ready()
        assert pmix.query_regstate(server.uri)[2] == 2
        deadline = _time.monotonic() + 10.0
        while not killed and _time.monotonic() < deadline:
            _time.sleep(0.05)
        assert killed == [1], "kill never fired after both barriers"
        c0.finalize()
        c1.finalize()
    finally:
        server.close()


def test_arm_daemon_launch_ignores_other_vpids_and_triggers(fi,
                                                             monkeypatch):
    monkeypatch.setattr(fi, "_daemon_die",
                        lambda vpid: pytest.fail("must not fire"))
    monkeypatch.setenv(fi.ENV_PLAN, "daemon=1:kill@reg=2")
    # wrong vpid: nothing armed; missing URI: nothing armed
    fi.arm_daemon_launch(2, {"OMPI_TPU_HNP_URI": "tcp://127.0.0.1:1"})
    fi.arm_daemon_launch(1, {})
    # legacy @t entries are arm_daemon's job, not the launch hook's
    monkeypatch.setenv(fi.ENV_PLAN, "daemon=1:kill@t=0.01")
    fi.arm_daemon_launch(1, {"OMPI_TPU_HNP_URI": "tcp://127.0.0.1:1"})
    import time as _time

    _time.sleep(0.3)


def test_arm_daemon_fires_the_timed_kill(fi, monkeypatch):
    """``arm_daemon`` (daemon start) arms ``kill@t=`` for its own vpid
    only, on each package; a plan without daemon entries arms nothing."""
    import time as _time

    killed = []
    monkeypatch.setattr(fi, "_daemon_die", lambda vpid: killed.append(vpid))
    monkeypatch.setenv(fi.ENV_PLAN, "daemon=1:kill@t=0.2;rank=0:kill@step=9")
    fi.arm_daemon(2)
    fi.arm_daemon(1)
    monkeypatch.setenv(fi.ENV_PLAN, "rank=0:kill@step=9")
    fi.arm_daemon(1)
    deadline = _time.monotonic() + 5.0
    while not killed and _time.monotonic() < deadline:
        _time.sleep(0.02)
    _time.sleep(0.3)
    assert killed == [1]


# ---------------------------------------------------------------------------
# parity: one plan and seed, equal fired-fault logs
# ---------------------------------------------------------------------------

_FRAMES = (
    [{"t": "eager", "tag": t, "cid": c, "seq": s}
     for t in (0, 3) for c in (0, 1025) for s in range(6)]
    + [{"t": "rndv", "tag": 1, "cid": 0, "seq": s, "sid": 40 + s}
       for s in range(4)]
    + [{"t": "cts", "sid": 40 + s, "rid": 7 + s} for s in range(4)]
    + [{"t": "data", "rid": 7, "off": o} for o in (0, 65536, 131072)]
    + [{"t": "ft", "op": op, "cid": 0, "aseq": a, "n": n, "from": 2}
       for op in ("agree_c", "agree_d", "revoke") for a in range(3)
       for n in range(3)]
    + [{"t": "rebind", "card": "x", "inc": 1}])

_PLAN = "drop=0.3;rank=1:drop=0.2@all;delay=0.25,3;dup=0.2"


@pytest.mark.parametrize("seed", [0, 7, 2026])
def test_verdicts_over_a_frame_list_equal_the_jax_package(seed):
    logs = []
    for M in (JAX, TORCH):
        acts = M.fi.parse_plan(_PLAN)
        out = []
        for rank in range(3):
            inj = M.fi.Injector(rank, acts, seed=seed)
            verdicts = [inj.on_frame(peer, dict(h)) for peer in range(3)
                        if peer != rank for h in _FRAMES]
            out.append((verdicts, inj.events))
        logs.append(out)
    assert logs[1] == logs[0]
    assert any(ev for _v, evs in logs[1] for ev in evs)


def _workload(comm):
    """Eager point-to-point around a ring and host collectives (every
    frame under the eager limit)."""
    n, r = comm.size, comm.rank
    out = []
    for step in range(6):
        req = comm.isend(np.full(8, float(r * 10 + step)),
                         dest=(r + 1) % n, tag=step)
        out.append(comm.recv(source=(r - 1) % n, tag=step).tolist())
        req.wait()
    out.append(comm.allreduce(np.arange(16.0) + r).tolist())
    out.append(comm.bcast(np.arange(32.0) if r == 0 else None,
                          root=0).tolist())
    out.append([a.tolist() for a in comm.allgather(np.full(4, float(r)))])
    comm.barrier()
    return out


def _events_after(M, run, btl, native, plan, seed):
    M.fi.reset()
    old = {k: M.vars.get(k) for k in ("faultinject_plan",
                                      "faultinject_seed",
                                      "pml_native_match", "btl_tcp_native",
                                      "coll_shm_enable")}
    M.vars.set("faultinject_plan", plan)
    M.vars.set("faultinject_seed", seed)
    M.vars.set("pml_native_match", native)
    M.vars.set("btl_tcp_native", native)
    M.vars.set("coll_shm_enable", False)
    try:
        res = run(4, _workload) if btl is None else run(4, _workload,
                                                        btl=btl)
        evs = M.fi.events()
    finally:
        for k, v in old.items():
            M.vars.set(k, v)
        M.fi.reset()
    return res, sorted(evs, key=lambda e: (e["rank"], e["peer"],
                                           e["frame"], e["kind"]))


@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
@pytest.mark.parametrize("btl", [None, "^proc", "^proc,shm"],
                         ids=["proc", "shm", "tcp"])
def test_fired_faults_after_one_workload_equal_the_jax_package(btl,
                                                                native):
    """``dup`` and ``delay`` of every frame (``@all`` by grammar) over the
    same workload: the duplicates are held back by the wire-sequence gate
    and the delays only reorder, so both jobs finish with the same
    results, and each frame draws its verdict by identity, whatever
    transport carries it.  With the native engine on, a same-host peer's
    plain eager frames ride the compiled fast lane, which passes beside
    the endpoint's hook in both packages: there both logs are empty."""
    plan = "dup=0.25;delay=0.2,2"
    j_res, j_evs = _events_after(JAX, _jax_run, btl, native, plan, 11)
    t_res, t_evs = _events_after(TORCH, prun, btl, native, plan, 11)
    assert t_res == j_res
    assert t_evs == j_evs
    fast_lane = native and btl != "^proc,shm"
    assert {e["kind"] for e in t_evs} == (set() if fast_lane
                                          else {"dup", "delay"})


def _jax_run(n, fn, btl=None):
    """The JAX package's harness on the same transport: its btl
    directive (``btl_``) set around the run, as the port's harness does
    with its ``btl`` argument."""
    if btl is None:
        return jrun(n, fn)
    old = JAX.vars.get("btl_")
    JAX.vars.set("btl_", btl)
    try:
        return jrun(n, fn)
    finally:
        JAX.vars.set("btl_", old)


def test_mismatch_trigger_records_the_same_divergent_kind(monkeypatch):
    """``rank=0:mismatch@coll=0``: the app asks for a barrier and the
    dispatch choke point records a bcast instead, in both packages'
    flight recorders, with the same fired-fault event."""
    class _Fired(BaseException):
        pass

    def no_park(self, kind, n, seq):
        self._record(kind, trigger="coll", value=n, seq=seq)
        raise _Fired()

    got = []
    for M, run in ((JAX, jrun), (TORCH, prun)):
        M.trace.collrec.reset()
        M.vars.set("faultinject_plan", "rank=0:mismatch@coll=0")
        M.fi.reset()
        monkeypatch.setattr(M.fi.Injector, "fire_coll", no_park)
        try:
            def body(comm):
                comm.barrier()
                return comm.rank

            with pytest.raises(AssertionError):
                run(1, body)   # the harness surfaces the rank's park
            evs = M.fi.events(0)   # read BEFORE reset clears them
        finally:
            M.vars.set("faultinject_plan", "")
            M.fi.reset()
        posts = [r for r in M.trace.collrec.snapshot() if r[5] == "post"]
        M.trace.collrec.reset()
        # the app asked for barrier; the injected divergence recorded bcast
        assert posts and posts[0][4] == "bcast"
        assert evs and evs[0]["kind"] == "mismatch" \
            and evs[0]["trigger"] == "coll"
        got.append(([p[4] for p in posts], evs))
    assert got[1] == got[0]
