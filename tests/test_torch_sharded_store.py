"""The port's ``ShardedSnapshotStore`` (``ompi_tpu_torch.ckpt.store``:
one file per array through collective MPI-IO) against the JAX package's,
and the snapshot loads of a host-plane rank that import no torch.

Each case mirrors one of ``tests/ckpt/test_sharded_store.py`` with every
assertion kept; it runs once through each package (its store, snapc,
``io`` and in-process harness) on the same numpy inputs in its own
directory, and the ranks' results and the snapshot files (the ``.bin``
per array, ``metadata.json`` without its time) must be equal byte for
byte.  The JAX package's bf16 leaves (ml_dtypes) come back from the port
as CPU tensors of ``torch.bfloat16`` with the same bits.

Then each package reads the other's sharded snapshot — f32, int64 and
bf16 leaves of ragged shapes, bf16 written from a torch tensor on the
port's side — bit for bit, and a ``tpurun -np 2`` job of the port saves,
commits and loads a numpy-only snapshot through ``SnapshotStore``,
``ShardedSnapshotStore`` and ``snapc`` with torch never imported.
"""

from __future__ import annotations

import glob
import json
import os
import subprocess
import sys
import types

import ml_dtypes
import numpy as np
import pytest
import torch

from ompi_tpu.ckpt import ShardedSnapshotStore as JStore
from ompi_tpu.ckpt import checkpoint as jcheckpoint
from ompi_tpu.ckpt import restart as jrestart
from ompi_tpu.mpi import io as jio
from ompi_tpu.mpi.constants import MPIException as JMPIException
from ompi_tpu_torch.ckpt import ShardedSnapshotStore as PStore
from ompi_tpu_torch.ckpt import checkpoint as pcheckpoint
from ompi_tpu_torch.ckpt import restart as prestart
from ompi_tpu_torch.mpi import io as pio
from ompi_tpu_torch.mpi.constants import MPIException as PMPIException
from tests.mpi.harness import run_ranks as jrun
from tests.test_torch_host_p2p import _same
from tests.torch_host_harness import run_ranks as prun

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

J = types.SimpleNamespace(name="jax", Store=JStore, checkpoint=jcheckpoint,
                          restart=jrestart, mio=jio,
                          MPIException=JMPIException, run=jrun)
P = types.SimpleNamespace(name="port", Store=PStore, checkpoint=pcheckpoint,
                          restart=prestart, mio=pio,
                          MPIException=PMPIException, run=prun)


def _bits(a) -> np.ndarray:
    """The bytes of a loaded leaf: a numpy array, an ml_dtypes array or a
    torch tensor (bf16 and float8 as their bits)."""
    if isinstance(a, torch.Tensor):
        if a.dtype in (torch.bfloat16, torch.float8_e4m3fn):
            a = a.view({2: torch.int16, 1: torch.uint8}[a.element_size()])
        a = a.numpy()
    return np.frombuffer(np.ascontiguousarray(a).tobytes(), np.uint8)


def _snapshot_files(d) -> dict:
    """{relative path: bytes} of a case's snapshot files, metadata.json
    without its wall-clock ``time``."""
    out = {}
    for p in sorted(glob.glob(os.path.join(str(d), "**", "*"),
                              recursive=True)):
        if not os.path.isfile(p):
            continue
        rel = os.path.relpath(p, d)
        if p.endswith("metadata.json"):
            meta = json.load(open(p))
            meta.pop("time", None)
            out[rel] = meta
        else:
            out[rel] = open(p, "rb").read()
    return out


def both(case, tmp_path, *args):
    out = []
    for M in (J, P):
        d = tmp_path / M.name
        d.mkdir()
        res = case(M, d, *args)
        out.append((res, _snapshot_files(d)))
    _same(out[0], out[1])
    return out[1][0]


# ---------------------------------------------------------------------------
# tests/ckpt/test_sharded_store.py
# ---------------------------------------------------------------------------

def _save_load_roundtrip(M, d):
    def body(comm):
        st = M.Store(str(d), comm, job="j1")
        state = {
            "w": np.arange(8, dtype=np.float32) + 10 * comm.rank,
            "step": np.array([comm.rank], np.int64),
        }
        st.save(3, state)
        back = st.load(3)
        np.testing.assert_array_equal(back["w"], state["w"])
        np.testing.assert_array_equal(back["step"], state["step"])
        assert isinstance(back["w"], np.ndarray)
        return back

    res = M.run(4, body)
    sd = str(d / "j1" / "snapshot_3")
    assert sorted(os.listdir(sd)) == ["metadata.json", "step.bin", "w.bin"]
    w = np.fromfile(os.path.join(sd, "w.bin"), np.float32)
    np.testing.assert_array_equal(
        w, np.concatenate([np.arange(8, dtype=np.float32) + 10 * r
                           for r in range(4)]))
    return res


def test_save_load_roundtrip(tmp_path):
    both(_save_load_roundtrip, tmp_path)


def _ragged_blocks(M, d):
    def body(comm):
        st = M.Store(str(d), comm, job="rag")
        mine = np.full((comm.rank + 1, 3), comm.rank, np.int32)
        st.save(0, {"x": mine})
        back = st.load(0)
        np.testing.assert_array_equal(back["x"], mine)
        other = st.load(0, rank=(comm.rank + 1) % comm.size)
        assert other["x"].shape == ((comm.rank + 1) % comm.size + 1, 3)
        return back, other

    return M.run(3, body)


def test_ragged_blocks(tmp_path):
    both(_ragged_blocks, tmp_path)


def _commit_record_and_discovery(M, d):
    def body(comm):
        st = M.Store(str(d), comm, job="disc")
        st.save(1, {"a": np.zeros(2, np.float64)})
        st.save(5, {"a": np.ones(2, np.float64)})
        assert st.snapshots() == [1, 5]
        assert st.latest() == 5
        meta = st.metadata(5)
        assert meta["layout"] == "sharded-file"
        assert meta["arrays"]["a"][comm.rank]["nbytes"] == 16
        return meta["arrays"]

    return M.run(2, body)


def test_commit_record_and_discovery(tmp_path):
    both(_commit_record_and_discovery, tmp_path)


def _snapc_checkpoint_restart_with_sharded_store(M, d):
    def body(comm):
        st = M.Store(str(d), comm, job="snapc")
        state = {"w": np.arange(6, dtype=np.float32) * (comm.rank + 1)}
        seq = M.checkpoint(comm, st, state)
        got_seq, got = M.restart(comm, st)
        assert got_seq == seq
        np.testing.assert_array_equal(got["w"], state["w"])
        return seq, got

    return M.run(3, body)


def test_snapc_checkpoint_restart_with_sharded_store(tmp_path):
    both(_snapc_checkpoint_restart_with_sharded_store, tmp_path)


def _write_rank_rejected(M, d):
    def body(comm):
        st = M.Store(str(d), comm, job="rej")
        with pytest.raises(M.MPIException, match="collective"):
            st.write_rank(0, comm.rank, {"x": np.zeros(1)})
        with pytest.raises(M.MPIException, match="inside save"):
            st.commit(0, 1)
        return None

    return M.run(1, body)


def test_write_rank_rejected(tmp_path):
    both(_write_rank_rejected, tmp_path)


def _sharded_save_uses_collective_component(M, d):
    seen = []
    orig = M.mio.File._fcoll_component

    def spy(self, nbytes, runs):
        comp = orig(self, nbytes, runs)
        seen.append(comp)
        return comp

    M.mio.File._fcoll_component = spy
    try:
        def body(comm):
            st = M.Store(str(d), comm, job="comp")
            st.save(0, {"x": np.zeros(64, np.float32)})
            return None

        M.run(2, body)
    finally:
        M.mio.File._fcoll_component = orig
    assert seen and set(seen) == {"two_phase"}
    return sorted(set(seen)), len(seen)


def test_sharded_save_uses_collective_component(tmp_path):
    both(_sharded_save_uses_collective_component, tmp_path)


def _dtype_mismatch_raises(M, d):
    def body(comm):
        st = M.Store(str(d), comm, job="dt")
        bad = np.zeros(4, np.float32 if comm.rank == 0 else np.int64)
        with pytest.raises(M.MPIException, match="dtype differs"):
            st.save(0, {"x": bad})
        return None

    return M.run(2, body)


def test_dtype_mismatch_raises(tmp_path):
    both(_dtype_mismatch_raises, tmp_path)


def _load_rank_compat_and_bf16(M, d):
    def body(comm):
        st = M.Store(str(d), comm, job="bf")
        mine = (np.arange(4) + comm.rank).astype(ml_dtypes.bfloat16)
        st.save(0, {"p": mine})
        got = st.load_rank(0, comm.rank)
        if M is P:   # bf16 comes back as a torch.bfloat16 CPU tensor
            assert got["p"].dtype == torch.bfloat16
            val = got["p"].float().numpy()
        else:
            val = got["p"].astype(np.float32)
        np.testing.assert_array_equal(val, mine.astype(np.float32))
        return _bits(got["p"]), tuple(got["p"].shape)

    return M.run(2, body)


def test_load_rank_compat_and_bf16(tmp_path):
    both(_load_rank_compat_and_bf16, tmp_path)


# ---------------------------------------------------------------------------
# each package reads the other's sharded snapshot
# ---------------------------------------------------------------------------

def _leaves(rank: int) -> dict:
    """Rank ``rank``'s ragged blocks: f32 and int64 of (rank+1, 3) and
    (2*rank+1,), bf16 bits of (rank+2, 2), from one seed."""
    rng = np.random.default_rng(40 + rank)
    f32 = rng.normal(size=(rank + 1, 3)).astype(np.float32)
    return {"f32": f32,
            "i64": rng.integers(-2**40, 2**40, size=2 * rank + 1),
            "bf16": rng.normal(size=(rank + 2, 2)).astype(np.float32)
            .astype(ml_dtypes.bfloat16)}


def _as_torch(leaves: dict) -> dict:
    out = {k: torch.from_numpy(v.copy()) for k, v in leaves.items()
           if k != "bf16"}
    out["bf16"] = torch.from_numpy(
        leaves["bf16"].view(np.int16).copy()).view(torch.bfloat16)
    return out


def _save_with(M, d, tensors: bool):
    def body(comm):
        st = M.Store(str(d), comm, job="x")
        leaves = _leaves(comm.rank)
        st.save(0, _as_torch(leaves) if tensors else leaves,
                extra={"step": 7})
        return None

    M.run(3, body)


def _load_with(M, d):
    def body(comm):
        st = M.Store(str(d), comm, job="x")
        own = st.load(0)
        nxt = st.load(0, rank=(comm.rank + 1) % comm.size)
        return own, nxt

    return M.run(3, body)


def _check_loaded(M, results):
    for r, (own, nxt) in enumerate(results):
        for got, rank in ((own, r), (nxt, (r + 1) % 3)):
            want = _leaves(rank)
            for k, v in want.items():
                assert tuple(got[k].shape) == v.shape, (k, rank)
                assert _bits(got[k]).tobytes() == v.tobytes(), (k, rank)
            if M is P:
                assert got["bf16"].dtype == torch.bfloat16
                assert isinstance(got["f32"], np.ndarray)
                assert got["i64"].dtype == np.int64
            else:
                assert got["bf16"].dtype == ml_dtypes.bfloat16


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_each_package_reads_the_others_sharded_snapshot(tmp_path, writer):
    """One package saves (the port from torch tensors, bf16 included),
    the other loads every rank's own block and its neighbour's: the same
    shapes and bits; the two packages' files are the same files."""
    W, R = (J, P) if writer == "jax" else (P, J)
    d = tmp_path / "shared"
    d.mkdir()
    _save_with(W, d, tensors=W is P)
    _check_loaded(R, _load_with(R, d))
    _check_loaded(W, _load_with(W, d))
    # the same snapshot written by the other package: identical files
    d2 = tmp_path / "other"
    d2.mkdir()
    _save_with(R, d2, tensors=R is P)
    assert _snapshot_files(d) == _snapshot_files(d2)
    meta = json.load(open(d / "x" / "snapshot_0" / "metadata.json"))
    assert meta["layout"] == "sharded-file" and meta["step"] == 7
    assert [s["dtype"] for s in meta["arrays"]["bf16"]] == ["bfloat16"] * 3
    assert [s["shape"] for s in meta["arrays"]["f32"]] == [
        [1, 3], [2, 3], [3, 3]]


# ---------------------------------------------------------------------------
# a host-plane rank loads numpy snapshots without torch
# ---------------------------------------------------------------------------

_NUMPY_ONLY_APP = r"""
import json, os, sys
import numpy as np
import ompi_tpu_torch
from ompi_tpu_torch.ckpt import (ShardedSnapshotStore, SnapshotStore,
                                 checkpoint, restart)

comm = ompi_tpu_torch.init()
r = comm.rank
base = os.environ["SNAP_DIR"]
state = {"w": np.arange(6, dtype=np.float32) * (r + 1),
         "ids": np.arange(3, dtype=np.int64) + 10 * r,
         "step": np.int64(5)}
npz = SnapshotStore(base, job=f"npz{r}")
npz.write_rank(0, 0, state)
npz.commit(0, nranks=1)
a = npz.load_rank(0, 0)
sh = ShardedSnapshotStore(base, comm, job="sharded")
sh.save(0, state)
b = sh.load(0)
seq = checkpoint(comm, SnapshotStore(base, job="snapc"), state)
_, c = restart(comm, SnapshotStore(base, job="snapc"), seq=seq)
out = {name: {k: [str(v.dtype), list(np.shape(v)), np.asarray(v).tolist()]
              for k, v in got.items()}
       for name, got in (("npz", a), ("sharded", b), ("snapc", c))}
print("SNAP " + json.dumps({"rank": r, "torch": "torch" in sys.modules,
                            "loaded": out}), flush=True)
ompi_tpu_torch.finalize()
"""


def test_numpy_snapshot_loads_import_no_torch(tmp_path):
    """A ``tpurun -np 2`` job saves, commits and loads a numpy-only
    snapshot through SnapshotStore, ShardedSnapshotStore and snapc; no
    rank imports torch, and the loaded values are the JAX package's."""
    p = subprocess.run(
        [sys.executable, "-m", "ompi_tpu_torch.tools.tpurun", "-np", "2",
         "--timeout", "120", "-x", f"SNAP_DIR={tmp_path / 'port'}", "--",
         sys.executable, "-c", _NUMPY_ONLY_APP],
        capture_output=True, text=True, cwd=ROOT, timeout=180)
    assert p.returncode == 0, p.stdout + p.stderr
    rows = {}
    for line in p.stdout.splitlines():
        line = line.split("]", 1)[1] if line.startswith("[") else line
        if line.startswith("SNAP "):
            d = json.loads(line[5:])
            rows[d["rank"]] = d
    assert sorted(rows) == [0, 1]
    assert not any(d["torch"] for d in rows.values())

    def jax_body(comm):
        from ompi_tpu.ckpt import SnapshotStore

        base = str(tmp_path / "jax")
        r = comm.rank
        state = {"w": np.arange(6, dtype=np.float32) * (r + 1),
                 "ids": np.arange(3, dtype=np.int64) + 10 * r,
                 "step": np.int64(5)}
        npz = SnapshotStore(base, job=f"npz{r}")
        npz.write_rank(0, 0, state)
        npz.commit(0, nranks=1)
        a = npz.load_rank(0, 0)
        sh = JStore(base, comm, job="sharded")
        sh.save(0, state)
        b = sh.load(0)
        seq = jcheckpoint(comm, SnapshotStore(base, job="snapc"), state)
        _, c = jrestart(comm, SnapshotStore(base, job="snapc"), seq=seq)
        return {name: {k: [str(v.dtype), list(np.shape(v)),
                           np.asarray(v).tolist()]
                       for k, v in got.items()}
                for name, got in (("npz", a), ("sharded", b),
                                  ("snapc", c))}

    want = jrun(2, jax_body)
    for r in range(2):
        assert rows[r]["loaded"] == want[r], r
