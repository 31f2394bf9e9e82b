"""The port's communicator management (``mpi/comm.py``: split, split_type,
create, create_group, dup, idup, dup_with_info, attributes, errhandlers;
``mpi/info.py``, ``mpi/errhandler.py``) against the JAX package's.

Each body runs on n = 2, 3 and 4 in-process ranks twice, through the JAX
package's harness (``tests.mpi.harness.run_ranks``) and the port's
(``tests.torch_host_harness.run_ranks``), and gets its package's modules
as ``M``; the per-rank results must be equal, cids included (both derive
them deterministically, ``create_group``'s from the same crc32).  The
attribute and errhandler cases are those of tests/mpi/test_objects.py:21-153.
"""

from __future__ import annotations

import types

import numpy as np
import pytest

from ompi_tpu.core.config import var_registry as jvars
from ompi_tpu.mpi import constants as jconst
from ompi_tpu.mpi import errhandler as jeh
from ompi_tpu.mpi import group as jgroup
from ompi_tpu.mpi import info as jinfo
from ompi_tpu_torch.core.config import var_registry as pvars
from ompi_tpu_torch.mpi import constants as pconst
from ompi_tpu_torch.mpi import errhandler as peh
from ompi_tpu_torch.mpi import group as pgroup
from ompi_tpu_torch.mpi import info as pinfo
from tests.mpi.harness import run_ranks as jrun
from tests.torch_host_harness import run_ranks as prun

J = types.SimpleNamespace(C=jconst, eh=jeh, info=jinfo, Group=jgroup.Group)
P = types.SimpleNamespace(C=pconst, eh=peh, info=pinfo, Group=pgroup.Group)

SIZES = (2, 3, 4)


@pytest.fixture(autouse=True)
def shm_off():
    """coll/shm's arena off in both packages, so both run coll/host
    (``test_construction_with_the_arena_matches`` turns it on in both:
    each package's first collective then builds its node and leader
    communicators, burning the same cids)."""
    import ompi_tpu.mpi.coll.shm  # noqa: F401 — registers coll_shm_enable
    import ompi_tpu_torch.mpi.coll.shm  # noqa: F401 — the port's

    old = [(reg, reg.get("coll_shm_enable")) for reg in (jvars, pvars)]
    for reg, _ in old:
        reg.set("coll_shm_enable", False)
    yield
    for reg, value in old:
        reg.set("coll_shm_enable", value)


def both(n, body):
    """(JAX package's per-rank results, port's)."""
    return jrun(n, lambda c: body(c, J)), prun(n, lambda c: body(c, P))


def _desc(c):
    """What identifies a communicator: None, or (rank, size, cid, world
    ranks of its group)."""
    if c is None:
        return None
    return (c.rank, c.size, c.cid, c.group.ranks)


def _sum(c):
    """A host allreduce on the communicator: proves its context works."""
    return np.asarray(c.allreduce(np.array([c.rank + 1.0]))).tolist()


def _split(c, M):
    colors = {"parity": c.rank % 2, "undef": (M.C.UNDEFINED if c.rank == 0
                                              else 5)}
    out = {}
    for label, color in colors.items():
        s = c.split(color, key=-c.rank)      # keys reverse the order
        out[label] = (_desc(s), _sum(s) if s is not None else None)
    s2 = c.split(0, key=0)                   # equal keys: world-rank order
    out["one"] = (_desc(s2), _sum(s2), s2.device is None)
    out["next_dup"] = _desc(c.dup())         # counters stayed aligned
    return out


def _split_type(c, M):
    c._io_host_override = "hostA" if c.rank < c.size // 2 else "hostB"
    s = c.split_type(M.C.COMM_TYPE_SHARED, key=c.rank)
    u = c.split_type(M.C.UNDEFINED)
    try:
        c.split_type(99)
        bad = None
    except M.C.MPIException as e:
        bad = e.error_class
    return _desc(s), _sum(s), u, bad


def _create(c, M):
    evens = c.get_group().incl(list(range(0, c.size, 2)))
    s = c.create(evens)
    g = c.create_group(evens, tag=3) if c.rank % 2 == 0 else None
    g2 = c.create_group(evens, tag=3) if c.rank % 2 == 0 else None
    return (_desc(s), _sum(s) if s else None, _desc(g),
            _sum(g) if g else None, _desc(g2),
            None if g is None else (g.cid < 0, g.cid != g2.cid))


def _dup_idup_info(c, M):
    info = M.info.Info({"hint": "1"})
    c.set_info(info)
    d = c.dup()
    req, i = c.idup(name="idup")
    got = req.wait()
    w = c.dup_with_info(M.info.Info({"other": "x"}))
    return (_desc(d), d.get_info().nkeys, got is i, _desc(i), i.name,
            _sum(i), _desc(w), w.get_info().items(), c.get_info().items(),
            c.test_inter(), M.info.Info().nkeys)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("body", [_split, _split_type, _create,
                                  _dup_idup_info],
                         ids=["split", "split_type", "create", "dup"])
def test_construction_matches_the_jax_package(n, body):
    want, got = both(n, body)
    assert got == want


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("body", [_split, _split_type, _create,
                                  _dup_idup_info],
                         ids=["split", "split_type", "create", "dup"])
def test_construction_with_the_arena_matches(n, body):
    for reg in (jvars, pvars):
        reg.set("coll_shm_enable", True)
    want, got = both(n, body)
    assert got == want


def test_split_colors_and_keys():
    res = prun(4, lambda c: _split(c, P))
    # parity: ranks {0, 2} and {1, 3}, keys -rank reverse each group
    assert res[0]["parity"][0][3] == (2, 0)
    assert res[1]["parity"][0][3] == (3, 1)
    assert res[0]["undef"] == (None, None)
    assert res[1]["undef"][0][1] == 3
    assert res[0]["one"][0][3] == (0, 1, 2, 3) and res[0]["one"][2]


def test_split_of_a_device_bound_communicator_has_no_binding():
    def body(c, M):
        c.device = object()              # stands for a bound mesh
        d, s = c.dup(), c.split(0)
        g = c.create_group(c.get_group())
        return d.device is c.device, s.device, g.device, c.create(
            c.get_group()).device

    for r in prun(2, lambda c: body(c, P)):
        assert r == (True, None, None, None)


# ---------------------------------------------------------------------------
# Info, attributes, errhandlers (tests/mpi/test_objects.py:21-153)
# ---------------------------------------------------------------------------

def _info_semantics(M):
    i = M.info.Info({"cb_buffer_size": "1048576"})
    i.set("striping_factor", "4")
    out = [i.nkeys, i.get("cb_buffer_size"), i.get("missing"),
           i.get("missing", "dflt"), i.nthkey(0), "striping_factor" in i]
    d = i.dup()
    d.set("extra", "1")
    out += [i.nkeys, d.nkeys]
    i.delete("striping_factor")
    out.append(i.nkeys)
    for bad in (lambda: i.delete("striping_factor"), lambda: i.set("", "x"),
                lambda: i.set("k" * 256, "x"), lambda: i.nthkey(5),
                lambda: i.set("k", "v" * 4097)):
        try:
            bad()
            out.append(None)
        except M.C.MPIException as e:
            out.append(e.error_class)
    return out


def test_info_semantics_match():
    got = _info_semantics(P)
    assert got == _info_semantics(J)
    assert got[:9] == [2, "1048576", None, "dflt", "cb_buffer_size", True,
                       2, 3, 1]


def _attrs(M):
    deleted = []
    kv_copy = M.info.keyval_create(
        copy_fn=lambda comm, v: (True, v + 1),
        delete_fn=lambda comm, v: deleted.append(v))
    kv_nocopy = M.info.keyval_create()
    kv_drop = M.info.keyval_create(copy_fn=lambda comm, v: (False, v))

    def body(comm):
        comm.set_attr(kv_copy, 10)
        comm.set_attr(kv_nocopy, 99)
        comm.set_attr(kv_drop, 5)
        d = comm.dup()
        got = (d.get_attr(kv_copy), d.get_attr(kv_nocopy),
               d.get_attr(kv_drop))
        comm.delete_attr(kv_copy)
        return got, comm.get_attr(kv_copy)

    return body, deleted


def test_attrs_copy_and_delete_callbacks():
    for M, run in ((J, jrun), (P, prun)):
        body, deleted = _attrs(M)
        for (copied, nocopied, dropped), after in run(2, body):
            assert (copied, nocopied, dropped, after) == (11, None, None,
                                                          None)
        assert deleted == [10, 10]


def test_attr_free_runs_delete_fns():
    for M, run in ((J, jrun), (P, prun)):
        deleted = []
        kv = M.info.keyval_create(delete_fn=lambda c, v: deleted.append(v))

        def body(comm):
            sub = comm.dup()
            sub.set_attr(kv, comm.rank)
            sub.free()
            return sub.get_attr(kv)

        assert run(2, body) == [None, None]
        assert sorted(deleted) == [0, 1]


def _errh(c, M):
    out = {}
    try:                                       # default: ERRORS_RETURN
        c.send(np.zeros(1), dest=99)
        out["default"] = None
    except M.C.MPIException as e:
        out["default"] = e.error_class
    out["is_return"] = c.get_errhandler() is M.eh.ERRORS_RETURN
    seen = []
    c.set_errhandler(M.eh.create_errhandler(
        lambda holder, exc: seen.append((holder.name, exc.error_class))))
    try:                                       # hook runs, error propagates
        c.send(np.zeros(1), dest=99)
    except M.C.MPIException:
        pass
    out["hook"] = seen
    custom = c.get_errhandler()
    out["dup_keeps"] = c.dup().get_errhandler() is custom
    # a swallowing handler makes bad calls no-ops
    c.set_errhandler(M.eh.create_errhandler(lambda h, e: True))
    c.isend(np.array([1.0]), dest=-2).wait()
    c.isend(np.zeros(1), dest=0, tag=-5).wait()
    out["bad_recv"] = len(c.irecv(source=-2).wait())
    out["bad_src"] = len(c.irecv(source=99).wait())
    c.barrier()
    out["nothing_delivered"] = c.iprobe() is None
    return out


@pytest.mark.parametrize("n", SIZES)
def test_errhandlers_match(n):
    want, got = both(n, _errh)
    assert got == want
    assert got[0]["default"] == 6 and got[0]["hook"] == [(f"test{n}", 6)]
    assert got[0]["nothing_delivered"] and got[0]["dup_keeps"]


def test_errors_are_fatal_exits():
    def body(c):
        c.set_errhandler(peh.ERRORS_ARE_FATAL)
        try:
            c.send(np.zeros(1), dest=99)
        except SystemExit as e:
            return e.code
        return None

    assert prun(2, body) == [1, 1]
