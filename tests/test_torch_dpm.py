"""The port's dynamic process management (``ompi_tpu_torch.mpi.dpm``)
against the JAX package's.

The mirrored cases run the JAX package's own test bodies —
``tests/mpi/test_dpm.py`` (all ten), the name-service cases of
``tests/mpi/test_api_introspection.py`` and the ``intercomm_create`` /
``join`` cases of ``tests/mpi/test_api_parity3.py`` — once on each
package (``tests/torch_mirror.py``: the same bytecode, every assertion
kept, over each package's in-process two-worlds fixture and harness; the
spawn case launches each package's own ``tpurun``).  Every rank's
results of the two runs must be equal.

The port's own cases follow: the translated ids' BTL aliasing over each
transport (proc, the shm rings, tcp) with the compiled matching engine
on and off; ``spawn_multiple``'s command blocks; a CPU tensor over an
intercommunicator; the planes that key by peer id (monitoring, the FT
plane's revoke) seeing translated ids; a spawn from a tenant of a
standing pool, which goes through the pool's ``--dvm-submit``; and a
numpy-only job under the port's launcher that spawns through the facade
without importing torch.
"""

from __future__ import annotations

import os
import pathlib
import subprocess
import sys
import threading
import time
import types

import numpy as np
import pytest
import torch

import tests.mpi.test_api_introspection as ref_intro
import tests.mpi.test_api_parity3 as ref_parity3
import tests.mpi.test_dpm as ref_dpm
from ompi_tpu.core.config import var_registry as jvars
from ompi_tpu.mpi import constants as jconst
from ompi_tpu.mpi import dpm as jdpm
from ompi_tpu.mpi import monitoring as jmon
from ompi_tpu.mpi.comm import Communicator as JComm
from ompi_tpu.mpi.group import Group as JGroup
from ompi_tpu.mpi.pml import PmlOb1 as JPml
from ompi_tpu_torch.core.config import var_registry as pvars
from ompi_tpu_torch.mpi import constants as pconst
from ompi_tpu_torch.mpi import dpm as pdpm
from ompi_tpu_torch.mpi import monitoring as pmon
from ompi_tpu_torch.mpi.comm import Communicator as PComm
from ompi_tpu_torch.mpi.group import Group as PGroup
from ompi_tpu_torch.mpi.pml import PmlOb1 as PPml
from tests.test_torch_host_p2p import _same
from tests.torch_mirror import mirror

ROOT = pathlib.Path(__file__).resolve().parents[1]

J = types.SimpleNamespace(name="jax", pkg="ompi_tpu", dpm=jdpm, mon=jmon,
                          const=jconst, vars=jvars, Comm=JComm,
                          Group=JGroup, Pml=JPml)
P = types.SimpleNamespace(name="port", pkg="ompi_tpu_torch", dpm=pdpm,
                          mon=pmon, const=pconst, vars=pvars, Comm=PComm,
                          Group=PGroup, Pml=PPml)


def both(fn, **fixtures):
    """Run the JAX package's test body ``fn`` on each package; the
    results its harness calls returned must be equal (compared in repr
    order: a body may run two harnesses on threads, which finish in
    either order).  A ``tmp_path`` fixture gives each run a directory of
    its own."""
    outs = []
    for port in (False, True):
        kw = dict(fixtures)
        if "tmp_path" in kw:
            kw["tmp_path"] = kw["tmp_path"] / ("port" if port else "jax")
            kw["tmp_path"].mkdir()
        out: list = []
        mirror(fn, port, out)(**kw)
        outs.append(sorted(out, key=repr))
    _same(outs[0], outs[1])
    return outs[1]


# ---------------------------------------------------------------------------
# tests/mpi/test_dpm.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", [
    "test_connect_accept_p2p", "test_intercomm_bcast_rooted",
    "test_intercomm_merge_allreduce",
    "test_intercomm_barrier_and_repeated_connects",
    "test_unknown_port_raises", "test_intercomm_allreduce_swap",
    "test_intercomm_reduce_rooted", "test_intercomm_allgather",
    "test_intercomm_gather_scatter_rooted"])
def test_dpm_case_equals_the_jax_package(name):
    both(getattr(ref_dpm, name))


def test_spawn_parent_child(tmp_path):
    both(ref_dpm.test_spawn_parent_child, tmp_path=tmp_path)


# ---------------------------------------------------------------------------
# tests/mpi/test_api_introspection.py, tests/mpi/test_api_parity3.py
# ---------------------------------------------------------------------------

def test_publish_lookup_unpublish(tmp_path, monkeypatch):
    both(ref_intro.test_publish_lookup_unpublish, tmp_path=tmp_path,
         monkeypatch=monkeypatch)


def test_name_service_bridges_connect_accept(tmp_path, monkeypatch):
    assert both(ref_intro.test_name_service_bridges_connect_accept,
                tmp_path=tmp_path, monkeypatch=monkeypatch) == [[42], [None]]


@pytest.mark.parametrize("name", [
    "test_intercomm_create_from_split",
    "test_intercomm_create_distinct_cids_shared_members",
    "test_comm_join_over_socketpair"])
def test_intercomm_create_and_join_equal_the_jax_package(name):
    both(getattr(ref_parity3, name))


# ---------------------------------------------------------------------------
# the port's own cases
# ---------------------------------------------------------------------------

def _two_jobs(M, na, nb, job_a, job_b, btl=None, timeout=30.0):
    """``tests/mpi/test_dpm.py``'s two-worlds fixture for package ``M``,
    with the btl framework's selection ``btl`` applied while the PMLs
    are built and a port opened for the pair."""
    old = M.vars.get("btl_")
    if btl is not None:
        M.vars.set("btl_", btl)
    try:
        worlds = []
        for n, name in ((na, "A"), (nb, "B")):
            pmls = [M.Pml(r) for r in range(n)]
            addrs = {r: p.address for r, p in enumerate(pmls)}
            for p in pmls:
                p.set_peers(addrs)
            worlds.append([M.Comm(M.Group(range(n)), cid=0, pml=pmls[r],
                                  my_world_rank=r, name=name)
                           for r in range(n)])
    finally:
        M.vars.set("btl_", old)
    port = M.dpm.open_port()
    res = [[None] * na, [None] * nb]
    errors: list = []

    def runner(fn, side, rank):
        try:
            res[side][rank] = fn(worlds[side][rank], port)
        except BaseException as e:  # noqa: BLE001 — reported below
            errors.append((side, rank, e))

    threads = [threading.Thread(target=runner, args=(fn, side, r),
                                daemon=True)
               for side, (fn, n) in enumerate(((job_a, na), (job_b, nb)))
               for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=timeout)
    M.dpm.close_port(port)
    assert not any(t.is_alive() for t in threads), errors
    for c in worlds[0] + worlds[1]:
        c.pml.close()
    if errors:
        raise errors[0][2]
    return res


def _exchange(M, low: bool):
    """One side of a connect/accept: p2p both ways with rank r ↔ remote
    rank r, a rooted bcast from the accepting side's rank 0, the swap
    allreduce, then a merge and an allreduce over all four ranks.
    Returns the results and the transport that carried the remote
    frames (``route``, the port's only)."""
    def fn(comm, port):
        ic = (M.dpm.accept(comm, port if comm.rank == 0 else None) if low
              else M.dpm.connect(comm, port))
        base = 100 if low else 200
        sreq = ic.isend(np.arange(4, dtype=np.int64) + base + comm.rank,
                        dest=comm.rank, tag=3)
        got = ic.recv(source=comm.rank, tag=3)
        sreq.wait()
        if low:
            b = (ic.bcast(np.arange(3.0) * 7, root="root")
                 if comm.rank == 0 else ic.bcast(root=M.const.PROC_NULL))
        else:
            b = ic.bcast(root=0)
        s = ic.allreduce(np.array([1.5 * (base + comm.rank)]))
        merged = ic.merge()
        tot = merged.allreduce(np.array([merged.rank], np.int64))
        route = (comm.pml.endpoint.route(ic.remote_ids[comm.rank])
                 if M is P else None)
        ic.disconnect()
        return (np.asarray(got), None if b is None else np.asarray(b),
                np.asarray(s), merged.rank, np.asarray(tot)), route

    return fn


@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
@pytest.mark.parametrize("btl,route", [(None, "proc"), ("^proc", "shm"),
                                       ("^proc,shm", "tcp")],
                         ids=["proc", "shm", "tcp"])
def test_translated_ids_over_each_transport(btl, route, native):
    """Aliased frames (translated ids at and above the world size) match
    over every transport, in the compiled matching engine and in the
    Python one, as the JAX package's do."""
    old = [(reg, reg.get("pml_native_match")) for reg in (jvars, pvars)]
    for reg, _ in old:
        reg.set("pml_native_match", native)
    try:
        out = [_two_jobs(M, 2, 2, _exchange(M, True), _exchange(M, False),
                         btl=btl) for M in (J, P)]
    finally:
        for reg, v in old:
            reg.set("pml_native_match", v)
    strip = [[[r[0] for r in side] for side in res] for res in out]
    _same(strip[0], strip[1])
    assert [r[1] for side in out[1] for r in side] == [route] * 4
    a0, b0 = out[1][0][0][0], out[1][1][0][0]
    np.testing.assert_array_equal(a0[0], np.arange(4) + 200)
    np.testing.assert_array_equal(b0[0], np.arange(4) + 100)
    np.testing.assert_array_equal(b0[1], np.arange(3.0) * 7)
    assert a0[2][0] == 1.5 * 401 and b0[2][0] == 1.5 * 201
    assert sorted(r[0][3] for side in out[1] for r in side) == [0, 1, 2, 3]
    assert all(r[0][4][0] == 6 for side in out[1] for r in side)


def test_translated_ids_in_monitoring_and_revoke():
    """Monitoring keys its matrix by peer id and drops ids outside the
    world, the JAX package's rule; the FT plane's revoke floods a merged
    communicator across both jobs through the translated ids."""
    def job(M, low):
        def fn(comm, port):
            ic = (M.dpm.accept(comm, port if comm.rank == 0 else None)
                  if low else M.dpm.connect(comm, port))
            with M.mon.Monitor(comm.pml, comm.size) as m:
                if low:
                    ic.send(np.arange(10.0), dest=comm.rank, tag=1)
                else:
                    ic.recv(source=comm.rank, tag=1)
                merged = ic.merge()
                merged.allreduce(np.ones(3))
                merged.barrier()
                tot = m.totals()
            # every rank is out of the merged barrier before the revoke
            # (it would poison a rank still in the barrier's last round)
            ic.barrier()
            if merged.rank == 0:
                merged.revoke()
            deadline = time.time() + 10
            while not merged.is_revoked() and time.time() < deadline:
                time.sleep(0.01)
            timing = ("unexpected", "matched")
            return ({k: v for k, v in tot.items() if k not in timing},
                    merged.is_revoked())

        return fn

    out = [_two_jobs(M, 2, 2, job(M, True), job(M, False)) for M in (J, P)]
    _same(out[0], out[1])
    for side in out[1]:
        for tot, revoked in side:
            assert revoked
            assert tot["sent_count"]["pt2pt"] == 0   # translated: dropped


def _spawn_multiple_case(M, tmp: pathlib.Path):
    child = tmp / f"child_{M.name}.py"
    child.write_text(
        "import os, sys\n"
        "import numpy as np\n"
        f"import {M.pkg}\n"
        f"from {M.pkg}.mpi import dpm\n"
        f"comm = {M.pkg}.init()\n"
        "parent = dpm.get_parent(comm)\n"
        "parent.send(np.frombuffer(repr((sys.argv[1], os.environ['BLOCK'],\n"
        "    comm.rank, comm.size)).encode(), np.uint8), dest=0, tag=4)\n"
        "parent.disconnect()\n"
        f"{M.pkg}.finalize()\n")

    def fn(comm, port):
        ic = M.dpm.spawn_multiple(
            comm, [[sys.executable, str(child), "a"],
                   [sys.executable, str(child), "b"]], [2, 1],
            envs=[{"BLOCK": "x"}, {"BLOCK": "y"}])
        n = ic.remote_size
        got = [bytes(np.asarray(ic.recv(source=r, tag=4))).decode()
               for r in range(n)]
        ic.disconnect()
        return n, got

    return _two_jobs(M, 1, 0, fn, None)[0][0]


def test_spawn_multiple_runs_each_blocks_argv_and_env(tmp_path):
    out = [_spawn_multiple_case(M, tmp_path) for M in (J, P)]
    _same(out[0], out[1])
    assert out[1] == (3, [repr(("a", "x", 0, 3)), repr(("a", "x", 1, 3)),
                          repr(("b", "y", 2, 3))])


def test_cpu_tensor_over_an_intercomm_equals_numpy():
    """A CPU tensor as send data (p2p, the rooted bcast, allreduce,
    gather) gives what the JAX package gives for the same numpy data;
    received data is numpy."""
    rng = np.random.default_rng(18)
    data = [rng.normal(size=(3, 5)).astype(np.float32) for _ in range(2)]

    def job(M, low):
        def fn(comm, port):
            ic = (M.dpm.accept(comm, port if comm.rank == 0 else None)
                  if low else M.dpm.connect(comm, port))
            mine = data[comm.rank]
            if low:
                buf = torch.from_numpy(mine.copy()) if M is P else mine
                ic.send(buf, dest=comm.rank, tag=5)
                b = (ic.bcast(buf, root="root") if comm.rank == 0
                     else ic.bcast(root=M.const.PROC_NULL))
                s = ic.allreduce(buf)
                g = ic.gather(buf, root=0)
                return b, s, g
            got = ic.recv(source=comm.rank, tag=5)
            b = ic.bcast(root=0)
            s = ic.allreduce(np.zeros((3, 5), np.float32))
            g = ic.gather(root="root" if comm.rank == 0
                          else M.const.PROC_NULL)
            return got, b, s, g

        return fn

    out = [_two_jobs(M, 2, 2, job(M, True), job(M, False)) for M in (J, P)]
    _same(out[0], out[1])
    got, b, s, g = out[1][1][0]
    assert type(got) is np.ndarray
    np.testing.assert_array_equal(got, data[0])
    np.testing.assert_array_equal(b, data[0])
    np.testing.assert_array_equal(g[1], data[1])
    np.testing.assert_array_equal(s, data[0] + data[1])   # the swap
    np.testing.assert_array_equal(out[1][0][1][1], np.zeros((3, 5)))


def test_spawn_under_a_dvm_goes_through_the_pool(tmp_path):
    """A 2-rank tenant of a standing port pool (its env carries the
    pool's ``OMPI_TPU_DVM_URI``) spawns 2 children: the spawn goes
    through the pool's ``tpurun --dvm-submit`` (the children are a
    tenant of their own, in the pool's history), returns an intercomm,
    and the merged 4-rank allreduce equals numpy's sum."""
    import json

    import tests.runtime.test_dvm as ref_dvm
    from tests.torch_mirror import mirror

    child = tmp_path / "child.py"
    child.write_text(
        "import os\n"
        "import numpy as np\n"
        "import ompi_tpu_torch\n"
        "from ompi_tpu_torch.mpi import dpm\n"
        "comm = ompi_tpu_torch.init()\n"
        "parent = dpm.get_parent(comm)\n"
        "m = parent.merge(high=True)\n"
        "out = m.allreduce(np.full(3, float(m.rank)))\n"
        f"open({str(tmp_path)!r} + f'/child{{m.rank}}', 'w').write(repr(\n"
        "    (m.rank, np.asarray(out).tolist(),\n"
        "     bool(os.environ.get('OMPI_TPU_DVM_URI')))))\n"
        "ompi_tpu_torch.finalize()\n")
    parent = (
        "import sys\n"
        "import numpy as np\n"
        "import ompi_tpu_torch\n"
        "from ompi_tpu_torch.mpi import dpm\n"
        "comm = ompi_tpu_torch.init()\n"
        f"ic = dpm.spawn(comm, [sys.executable, {str(child)!r}], 2)\n"
        "m = ic.merge(high=False)\n"
        "out = m.allreduce(np.full(3, float(m.rank)))\n"
        "print('PARENT', type(ic).__name__, ic.remote_size, m.rank,\n"
        "      np.asarray(out).tolist(), flush=True)\n"
        "ompi_tpu_torch.finalize()\n")
    env = dict(os.environ)
    env.pop("OMPI_TPU_RANK", None)
    tpurun = [sys.executable, "-m", "ompi_tpu_torch.tools.tpurun"]
    with mirror(ref_dvm._standing_vm, True, [])(tmp_path) as uri:
        p = subprocess.run(
            # coll/host: the arena's first allreduce over a communicator
            # merged across two simulated hosts hangs, in the JAX
            # package's pool too (ROADMAP.md, notes for porters)
            tpurun + ["--dvm-submit", "-np", "2", "--dvm-uri", uri,
                      "--mca", "coll_shm_enable", "0", "--",
                      sys.executable, "-c", parent], cwd=ROOT, env=env,
            capture_output=True, text=True, timeout=120)
        ps = json.loads(subprocess.run(
            tpurun + ["--dvm-ps", "--dvm-uri", uri], cwd=ROOT, env=env,
            capture_output=True, text=True, timeout=60).stdout)
    assert p.returncode == 0, p.stderr[-3000:]
    rows = sorted(ln.split("PARENT ", 1)[1] for ln in p.stdout.splitlines()
                  if "PARENT " in ln)
    assert rows == [f"Intercomm 2 {r} [6.0, 6.0, 6.0]" for r in (0, 1)], \
        p.stdout
    for r in (2, 3):
        assert (tmp_path / f"child{r}").read_text() == repr(
            (r, [6.0, 6.0, 6.0], True))
    hist = {h["jobid"]: h for h in ps["history"]}
    assert len(hist) == 2 and all(h["rc"] == 0 for h in hist.values())
    assert sorted(h["np"] for h in hist.values()) == [2, 2]
    assert any(str(child) in h["argv"] for h in hist.values())


def test_facade_spawn_job_does_not_import_torch(tmp_path):
    """A numpy-only 2-rank job under the port's tpurun spawns 2 children
    through ``MPI.COMM_WORLD.Spawn``, merges and allreduces over the 4
    ranks, and neither a parent nor a child imports torch (nor JAX or
    the JAX package)."""
    child = tmp_path / "child.py"
    check = ("sorted(k for k in sys.modules if k.split('.')[0] in "
             "('torch', 'jax', 'ompi_tpu'))")
    child.write_text(
        "import sys\n"
        "import numpy as np\n"
        "from ompi_tpu_torch.compat import MPI\n"
        "parent = MPI.Comm.Get_parent()\n"
        "m = parent.Merge(high=True)\n"
        "out = np.zeros(3)\n"
        "m.Allreduce(np.full(3, float(m.Get_rank())), out)\n"
        # a file of its own: the children's launcher shares the parent
        # rank's stdout, where lines of the two jobs could interleave
        f"open({str(tmp_path)!r} + f'/child{{m.Get_rank()}}', 'w').write(\n"
        f"    repr((m.Get_rank(), out.tolist(), {check})))\n"
        "parent.Disconnect()\n"
        "MPI.Finalize()\n")
    parent = (
        "import sys\n"
        "import numpy as np\n"
        "from ompi_tpu_torch.compat import MPI\n"
        f"ic = MPI.COMM_WORLD.Spawn(sys.executable, args=[{str(child)!r}],\n"
        "                          maxprocs=2)\n"
        "m = ic.Merge(high=False)\n"
        "out = np.zeros(3)\n"
        "m.Allreduce(np.full(3, float(m.Get_rank())), out)\n"
        f"print('parent', m.Get_rank(), out.tolist(), {check})\n"
        "ic.Disconnect()\n"
        "MPI.Finalize()\n")
    p = subprocess.run(
        [sys.executable, "-m", "ompi_tpu_torch.tools.tpurun", "-np", "2",
         "--no-tag-output", "--", sys.executable, "-c", parent], cwd=ROOT,
        capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stderr[-3000:]
    assert sorted(p.stdout.splitlines()) == [
        f"parent {r} [6.0, 6.0, 6.0] []" for r in (0, 1)], p.stdout
    for r in (2, 3):
        assert (tmp_path / f"child{r}").read_text() == repr(
            (r, [6.0, 6.0, 6.0], []))
