"""The port's checkpoint stores (``ompi_tpu_torch.ckpt``) against the JAX
package's, and resuming training from them.

- ``SnapshotStore``/``StagedStore`` files are the JAX package's files:
  each package reads the other's snapshots bit for bit (f32, int, bool,
  bf16 and float8_e4m3fn leaves; the manifest; ``metadata.json``), the
  port without ml_dtypes.  Both load numpy arrays for numpy dtypes; the
  port loads CPU tensors for bf16 and float8, which numpy cannot name.  The reserved key, a corrupt or unknown-dtype
  manifest, a commit with a missing rank and an uncommitted load raise
  ERR_IO, as the reference's.
- Resume: the config of tests/ckpt/test_full_stack_resume.py (ZeRO-1
  over dp, bf16 storage with f32 master, bf16 Adam moments, 2-microbatch
  accumulation) on one CPU rank is bitwise equal to the uninterrupted run
  and equal to the JAX package's trajectory at test_torch_train.py's
  STEP_TOL; ZeRO-1 at {dp 2, tp 2} on 4 gloo ranks resumes bitwise; a
  snapshot the JAX package wrote, carried across by
  ``weights.from_train_state``, continues the JAX trajectory at STEP_TOL.
- ``DcpStore`` (the counterpart of ``OrbaxStore``): the pytree round trip
  and ``latest()``, the sharded restore of an (8, 4) array on 4 ranks (two
  rows each, tests/ckpt/test_orbax_store.py:31), distinct per-rank parts
  surviving as DTensors where a plain tensor keeps one rank's copy, and
  an uncommitted snapshot invisible to ``latest()``.
"""

from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

from ompi_tpu.ckpt import store as jstore  # noqa: E402
from ompi_tpu.models import transformer as J  # noqa: E402
from ompi_tpu.parallel.mesh import make_mesh as jax_mesh  # noqa: E402
from ompi_tpu_torch.ckpt import (DcpStore, SnapshotStore,  # noqa: E402
                                 StagedStore)
from ompi_tpu_torch.models import transformer as T  # noqa: E402
from ompi_tpu_torch.models.weights import (from_jax_params,  # noqa: E402
                                           from_train_state,
                                           to_numpy_opt_state, train_state)
from ompi_tpu_torch.mpi.constants import ERR_IO, MPIException  # noqa: E402
from ompi_tpu_torch.parallel.mesh import make_mesh  # noqa: E402
from tests import torch_ranks as TR  # noqa: E402

STEP_TOL = 1e-4                  # test_torch_train.py
FIELDS = dict(vocab=128, d_model=64, n_heads=4, n_layers=2, d_ff=128,
              seq=32, attention="xla", compute_dtype="float32")
#: tests/ckpt/test_full_stack_resume.py:27-31, every feature on
FULL = dict(FIELDS, zero1_axis="dp", param_dtype="bfloat16",
            adam_mu_dtype="bfloat16", grad_accum=2)
BATCH, SNAP_AT, MORE = 4, 3, 2


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    p = TR.RankPool(tmp_path_factory.mktemp("ranks"))
    yield p
    p.close()


def _toks(n=SNAP_AT + MORE, seed=7):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, FIELDS["vocab"], size=(BATCH, FIELDS["seq"]))
            .astype(np.int32) for _ in range(n)]


def _bits(a) -> bytes:
    if isinstance(a, torch.Tensor):
        a = a.contiguous()
        size = a.element_size()
        a = a.view({1: torch.uint8, 2: torch.int16, 4: torch.int32,
                    8: torch.int64}[size]).numpy() if a.dtype in (
            torch.bfloat16, torch.float8_e4m3fn) else a.numpy()
    return np.ascontiguousarray(a).tobytes()


# ---------------------------------------------------------------------------
# the format: each package reads the other's files
# ---------------------------------------------------------------------------

def _np_state():
    rng = np.random.default_rng(3)
    f32 = rng.normal(size=(3, 5)).astype(np.float32)
    return {"w": f32, "ids": np.arange(6, dtype=np.int64).reshape(2, 3),
            "i32": np.array([-1, 7], np.int32), "mask": np.array([True,
                                                                  False]),
            "bf": f32.astype(ml_dtypes.bfloat16),
            "f8": (f32[0] / 4).astype(ml_dtypes.float8_e4m3fn),
            "step": np.int64(7)}


def _torch_state(state):
    out = {}
    for k, v in state.items():
        v = np.asarray(v)
        if v.dtype.name == "bfloat16":
            out[k] = torch.from_numpy(v.view(np.int16)).view(torch.bfloat16)
        elif v.dtype.name == "float8_e4m3fn":
            out[k] = torch.from_numpy(v.view(np.uint8)).view(
                torch.float8_e4m3fn)
        else:
            out[k] = torch.from_numpy(v.copy())
    return out


def _raw(path):
    """Every npz member's dtype string and bytes."""
    with np.load(path) as z:
        return {k: (z[k].dtype.str, z[k].tobytes()) for k in z.files}


def test_each_package_reads_the_others_snapshot(tmp_path):
    state = _np_state()
    j = jstore.SnapshotStore(str(tmp_path), job="jax")
    j.write_rank(0, 0, state)
    j.commit(0, nranks=1, extra={"step": 3})
    p = SnapshotStore(str(tmp_path), job="port")
    p.write_rank(0, 0, _torch_state(state))
    p.commit(0, nranks=1, extra={"step": 3})
    # the files hold the same members, dtypes, bytes and manifest
    jraw = _raw(os.path.join(j.snapshot_dir(0), "rank_0.npz"))
    praw = _raw(os.path.join(p.snapshot_dir(0), "rank_0.npz"))
    assert jraw == praw
    assert json.loads(np.load(os.path.join(
        p.snapshot_dir(0), "rank_0.npz"))[jstore._DTYPE_MANIFEST][()]) == {
            "bf": "bfloat16", "f8": "float8_e4m3fn"}
    jm, pm = j.metadata(0), p.metadata(0)
    assert set(jm) == set(pm) == {"seq", "nranks", "time", "status", "step"}
    assert {k: jm[k] for k in jm if k != "time"} == {
        k: pm[k] for k in pm if k != "time"}
    # the JAX package loads the port's file: ml_dtypes arrays, same bits
    back = jstore.SnapshotStore(str(tmp_path), job="port").load_rank(0, 0)
    for k, v in state.items():
        assert back[k].dtype == np.asarray(v).dtype, k
        assert back[k].shape == np.shape(v) and _bits(back[k]) == _bits(v), k
    # the port loads the JAX package's file: numpy arrays as the JAX
    # package's load gives them, CPU tensors for bf16/f8; same bits
    got = SnapshotStore(str(tmp_path), job="jax").load_rank(0, 0)
    jgot = jstore.SnapshotStore(str(tmp_path), job="jax").load_rank(0, 0)
    want = _torch_state(state)
    for k in state:
        if k in ("bf", "f8"):
            assert isinstance(got[k], torch.Tensor) and \
                got[k].device.type == "cpu", k
            assert got[k].dtype == want[k].dtype, k
        else:
            assert isinstance(got[k], np.ndarray), k
            assert got[k].dtype == jgot[k].dtype, k
        assert _bits(got[k]) == _bits(want[k]) == _bits(jgot[k]), k
        assert tuple(got[k].shape) == tuple(want[k].shape), k
    assert SnapshotStore(str(tmp_path), job="jax").metadata(0)["step"] == 3


def test_write_rank_takes_tensors_on_any_device_and_numpy(tmp_path):
    st = SnapshotStore(str(tmp_path))
    t = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    st.write_rank(0, 0, {"t": t, "view": t.t(), "n": np.ones(2),
                         "leaf": t.clone().requires_grad_(True),
                         "empty": torch.zeros(0, 3), "s": 3.5})
    st.commit(0, nranks=1)
    out = st.load_rank(0, 0)
    assert torch.equal(torch.from_numpy(out["t"]), t)
    assert torch.equal(torch.from_numpy(out["view"]), t.t())
    assert torch.equal(torch.from_numpy(out["leaf"]), t)
    assert out["empty"].shape == (0, 3)
    assert out["n"].dtype == np.float64 and float(out["s"]) == 3.5


def test_staged_store_roundtrips_bf16_and_is_read_by_the_jax_package(
        tmp_path):
    vals = torch.tensor([1.5, -2.25, 0.125], dtype=torch.bfloat16)
    store = StagedStore(str(tmp_path / "c"), str(tmp_path / "local"))
    store.write_rank(0, 0, {"w": vals, "f32": torch.arange(2.0)})
    store.commit(0, nranks=1)
    out = store.load_rank(0, 0)
    assert out["w"].dtype == torch.bfloat16 and torch.equal(out["w"], vals)
    assert out["f32"].dtype == np.float32
    assert os.listdir(tmp_path / "local") == []
    j = jstore.SnapshotStore(str(tmp_path / "c")).load_rank(0, 0)
    assert j["w"].dtype == ml_dtypes.bfloat16
    np.testing.assert_array_equal(j["w"].astype(np.float32),
                                  vals.float().numpy())


def test_store_exotic_dtype_edge_cases(tmp_path):
    """The reference's edge cases (tests/ckpt/test_ckpt.py): plain void
    stays raw, records pass through, keys that look like old tag suffixes
    are never reinterpreted, and the reserved manifest key raises."""
    st = SnapshotStore(str(tmp_path))
    rec = np.zeros(2, dtype=[("a", "f4"), ("b", "i4")])
    st.write_rank(0, 0, {
        "bf": torch.tensor([1.5, -2.0], dtype=torch.bfloat16),
        "raw": np.zeros(3, dtype="V4"),
        "rec__dtype_tbl": rec,
        "x": np.arange(3.0),
        "x__dtype_float32": np.zeros(3, "V4"),
    })
    st.commit(0, nranks=1)
    out = st.load_rank(0, 0)
    assert out["bf"].dtype == torch.bfloat16
    assert isinstance(out["raw"], np.ndarray) and out["raw"].dtype == "V4"
    assert out["rec__dtype_tbl"].dtype.names == ("a", "b")
    assert out["x"].dtype == np.float64
    assert out["x__dtype_float32"].dtype.kind == "V"
    with pytest.raises(MPIException) as e:
        st.write_rank(1, 0, {jstore._DTYPE_MANIFEST: np.zeros(1)})
    assert e.value.error_class == ERR_IO


@pytest.mark.parametrize("manifest", ["{not json", '{"w": "float99"}'])
def test_bad_manifest_raises_err_io(tmp_path, manifest):
    st = SnapshotStore(str(tmp_path))
    os.makedirs(st.snapshot_dir(0))
    np.savez(os.path.join(st.snapshot_dir(0), "rank_0.npz"),
             w=np.zeros(2, "V2"),
             **{jstore._DTYPE_MANIFEST: np.array(manifest)})
    st.commit(0, nranks=1)
    with pytest.raises(MPIException) as e:
        st.load_rank(0, 0)
    assert e.value.error_class == ERR_IO


def test_commit_gate_missing_rank_and_gc(tmp_path):
    st = SnapshotStore(str(tmp_path))
    st.write_rank(0, 0, {"w": torch.arange(4.0)})
    assert st.snapshots() == [] and st.latest() is None
    with pytest.raises(MPIException) as e:     # uncommitted: unloadable
        st.load_rank(0, 0)
    assert e.value.error_class == ERR_IO
    with pytest.raises(MPIException) as e:     # rank 1 never wrote
        st.commit(0, nranks=2)
    assert e.value.error_class == ERR_IO
    st.commit(0, nranks=1)
    for seq in (1, 2, 3):
        st.write_rank(seq, 0, {"w": torch.full((2,), float(seq))})
        if seq != 2:                           # 2 stays debris
            st.commit(seq, nranks=1)
    assert st.snapshots() == [0, 1, 3]
    assert sorted(st.gc(keep_last=1)) == [0, 1, 2]
    assert st.snapshots() == [3] and st.latest() == 3
    assert float(st.load_rank(3, 0)["w"][0]) == 3.0
    assert sorted(os.listdir(st.base)) == ["snapshot_3"]


# ---------------------------------------------------------------------------
# resuming training
# ---------------------------------------------------------------------------

def _port_run(cfg, params_np, toks, store_dir):
    """Port on one CPU rank: SNAP_AT steps, snapshot, MORE steps; then a
    restore into fresh tensors and the same MORE steps."""
    mesh = make_mesh({"dp": 1, "sp": 1, "tp": 1}, device="cpu")
    step, init = T.make_train_step(cfg, mesh, lr=1e-2)
    params = from_jax_params(params_np, cfg, "cpu", train=True)
    state = init(params)
    losses = []
    for t in toks[:SNAP_AT]:
        params, state, loss = step(params, state, t)
        losses.append(loss.item())
    store = SnapshotStore(store_dir, job="full")
    store.write_rank(0, 0, train_state(params, state, cfg, mesh=mesh))
    store.commit(0, nranks=1, extra={"step": SNAP_AT})

    def more(params, state):
        out = []
        for t in toks[SNAP_AT:]:
            params, state, loss = step(params, state, t)
            out.append(loss.item())
        return out, params, state

    ref = more(params, state)
    blobs = store.load_rank(store.latest(), 0)
    assert store.metadata(0)["step"] == SNAP_AT
    got = more(*from_train_state(blobs, cfg, "cpu", mesh=mesh))
    return losses, ref, got, mesh


def _jax_run(cfg, params_np, toks):
    mesh = jax_mesh({"dp": 1, "sp": 1, "tp": 1}, devices=jax.devices()[:1])
    step, init = J.make_train_step(cfg, mesh, lr=1e-2)
    # in the storage dtype, as the JAX package's init_params gives them
    # (an f32 master cast from f32 params would alias their buffers)
    params = jax.tree_util.tree_map(
        lambda a: jnp.asarray(a).astype(cfg.param_dtype or jnp.float32),
        params_np)
    state = init(params)
    losses = []
    for t in toks:
        params, state, loss = step(params, state, t)
        losses.append(float(loss))
    return losses, params, state


def _assert_same_state(a, b, cfg, like, mesh):
    (_, pa, sa), (_, pb, sb) = a, b
    for k in pa:
        assert torch.equal(pa[k], pb[k]), k
        assert pa[k].dtype == pb[k].dtype
    for x, y in zip(to_numpy_opt_state(sa, cfg, like, mesh=mesh),
                    to_numpy_opt_state(sb, cfg, like, mesh=mesh)):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("fields", [FULL, FIELDS], ids=["full", "f32"])
def test_resume_is_bitwise_and_follows_the_jax_package(tmp_path, fields):
    cfg = T.TransformerConfig(**fields)
    params_np = T.init_params(cfg, seed=5)
    toks = _toks()
    before, ref, got, mesh = _port_run(cfg, params_np, toks, str(tmp_path))
    assert got[0] == ref[0]
    _assert_same_state(ref, got, cfg, params_np, mesh)
    want, _, _ = _jax_run(J.TransformerConfig(**fields), params_np, toks)
    np.testing.assert_allclose(before + ref[0], want, rtol=STEP_TOL)


def test_a_jax_snapshot_resumes_in_the_port(tmp_path):
    """The JAX package trains SNAP_AT steps and snapshots (its own store,
    its own layout); the port loads it and continues the JAX
    trajectory."""
    jc = J.TransformerConfig(**FULL)
    params_np = J.init_params(jc, seed=6)
    toks = _toks(seed=8)
    mesh = jax_mesh({"dp": 1, "sp": 1, "tp": 1}, devices=jax.devices()[:1])
    step, init = J.make_train_step(jc, mesh, lr=1e-2)
    params = jax.tree_util.tree_map(jnp.asarray, params_np)
    state = init(params)
    for t in toks[:SNAP_AT]:
        params, state, _ = step(params, state, t)
    js = jstore.SnapshotStore(str(tmp_path), job="fromjax")
    js.write_rank(0, 0, {**{f"p_{k}": v for k, v in params.items()},
                         **{f"k{i}": np.asarray(leaf) for i, leaf in
                            enumerate(jax.tree_util.tree_leaves(state))}})
    js.commit(0, nranks=1, extra={"step": SNAP_AT})
    snap = {k: np.asarray(v) for k, v in params.items()}
    snap_leaves = [np.asarray(v) for v in jax.tree_util.tree_leaves(state)]
    want = []
    for t in toks[SNAP_AT:]:
        params, state, loss = step(params, state, t)
        want.append(float(loss))

    cfg = T.TransformerConfig(**FULL)
    tmesh = make_mesh({"dp": 1, "sp": 1, "tp": 1}, device="cpu")
    blobs = SnapshotStore(str(tmp_path), job="fromjax").load_rank(0, 0)
    p, s = from_train_state(blobs, cfg, "cpu", mesh=tmesh)
    for k, v in snap.items():
        np.testing.assert_array_equal(p[k].detach().float().numpy(),
                                      v.astype(np.float32), err_msg=k)
    assert int(s["opt"].count) == SNAP_AT
    assert s["opt"].mu["w1"].dtype == torch.bfloat16
    # and back: the port's leaves are the snapshot's, bit for bit (bf16
    # moments come back as f32, exactly)
    back = to_numpy_opt_state(s, cfg, snap, mesh=tmesh)
    assert len(back) == len(snap_leaves)
    for a, b in zip(back, snap_leaves):
        np.testing.assert_array_equal(a, b.astype(a.dtype))
    tstep, _ = T.make_train_step(cfg, tmesh, lr=1e-2)
    got = []
    for t in toks[SNAP_AT:]:
        p, s, loss = tstep(p, s, t)
        got.append(loss.item())
    np.testing.assert_allclose(got, want, rtol=STEP_TOL)


def test_zero1_on_a_dp2_tp2_mesh_resumes_bitwise(pool, tmp_path):
    fields = dict(FIELDS, zero1_axis="dp", adam_mu_dtype="bfloat16")
    params_np = T.init_params(T.TransformerConfig(**fields), seed=9)
    toks = _toks(seed=10)
    res = pool.run(TR.resume_steps, fields=fields,
                   axes={"dp": 2, "sp": 1, "tp": 2}, params=params_np,
                   toks=toks, snap_at=SNAP_AT, more=MORE,
                   store_dir=str(tmp_path))
    for ref, got, same, shapes in res:
        assert got == ref and same
        assert got == res[0][0]
    # the snapshot's optimizer leaves have the JAX package's ZeRO-1
    # layout: (dp, padded size / dp) of every whole leaf
    n, nk = params_np["w1"].size, len(params_np)
    i = sorted(params_np).index("w1")
    assert res[0][3][i] == res[0][3][nk + 1 + i] == (2, n // 2)


# ---------------------------------------------------------------------------
# DcpStore (the OrbaxStore counterpart)
# ---------------------------------------------------------------------------

def test_dcp_pytree_roundtrip_and_latest(tmp_path):
    store = DcpStore(str(tmp_path), job="t")
    state = {"step": np.int64(7),
             "params": {"w": np.arange(12, dtype=np.float32).reshape(3, 4)},
             "mu": torch.ones(5, dtype=torch.bfloat16)}
    store.save(0, state)
    store.save(3, {**state, "step": np.int64(9)})
    assert store.latest() == 3
    back = store.restore(3)
    assert int(back["step"]) == 9
    np.testing.assert_array_equal(back["params"]["w"].numpy(),
                                  state["params"]["w"])
    assert back["mu"].dtype == torch.bfloat16
    into = {"step": torch.tensor(0), "params": {"w": torch.zeros(3, 4)},
            "mu": torch.zeros(5, dtype=torch.bfloat16)}
    again = store.restore(0, into)
    assert int(again["step"]) == 7 and torch.equal(again["mu"], state["mu"])
    with pytest.raises(FileExistsError):
        store.save(3, state, force=False)
    with pytest.raises(ValueError, match="separator"):
        store.save(4, {"a/b": np.zeros(1)})


def test_dcp_uncommitted_snapshot_is_invisible(tmp_path, monkeypatch):
    store = DcpStore(str(tmp_path), job="u")
    store.save(1, {"w": np.ones(2, np.float32)})

    def crash(src, dst):
        raise OSError("killed before the commit")

    monkeypatch.setattr(os, "replace", crash)
    with pytest.raises(OSError, match="killed"):
        store.save(2, {"w": np.zeros(2, np.float32)})
    monkeypatch.undo()
    assert os.path.isdir(store.snapshot_dir(2) + ".partial")
    assert store.latest() == 1


def test_dcp_sharded_restore_and_distinct_parts_on_four_ranks(pool,
                                                              tmp_path):
    res = pool.run(TR.dcp_cases, base=str(tmp_path))
    x = np.arange(32, dtype=np.float32).reshape(8, 4)
    plains = set()
    for r, (block, placements, whole, parts, plain, latest) in enumerate(
            res):
        np.testing.assert_array_equal(block, x[2 * r:2 * r + 2])
        assert placements == [("Shard", 0)]
        np.testing.assert_array_equal(whole, x)
        np.testing.assert_array_equal(
            parts, np.repeat(np.arange(4.0, dtype=np.float32)[:, None], 3, 1))
        plains.add(plain.tobytes())
        assert latest == 1
    # a plain tensor is taken as replicated: one rank's copy is kept
    assert len(plains) == 1
