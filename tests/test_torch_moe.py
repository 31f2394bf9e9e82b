"""The port's switch MoE layer (ompi_tpu_torch.parallel.moe) against the
JAX package's (ompi_tpu.parallel.moe), on the CPU.

Counterpart of ``tests/parallel/test_moe.py``: the same shapes, numpy
seeds and capacities.  The JAX side runs ``switch_moe`` in ``shard_map``
on the suite's virtual CPU devices (one for ep = 1, four ep-sharded for
ep = 4), the port on one process or on 4 gloo rank processes
(``tests/torch_ranks.py``).  Routing is compared first, token by token:
a flipped top-1 choice would move a whole token, so a mismatch reports
the top-2 gate margin instead of widening a tolerance.  Tolerances (f32):
output 2e-5 relative and absolute (``test_moe.py``), aux 1e-6 relative,
gradients 1e-5 relative L2; the index dispatch and combine equal the
one-hot einsum form bit for bit, in f32 and in bf16.
"""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh as JMesh  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from ompi_tpu.mpi.device_comm import DeviceCommunicator as JComm  # noqa: E402
from ompi_tpu.parallel import moe as JM  # noqa: E402
from ompi_tpu_torch.mpi.device_comm import DeviceCommunicator  # noqa: E402
from ompi_tpu_torch.parallel import moe as M  # noqa: E402
from ompi_tpu_torch.parallel.mesh import make_mesh  # noqa: E402
from tests import torch_ranks as TR  # noqa: E402

OUT_TOL = 2e-5
AUX_RTOL = 1e-6
GRAD_RL2 = 1e-5

#: (B, T, D, F, E, capacity, seed) — the four cases of test_moe.py, and
#: the reference's default capacity (None: factor 1.25) at two sizes
CASES = {
    "oracle-cap8": (2, 16, 32, 64, 8, 8, 0),
    "drops-cap1": (1, 16, 8, 16, 2, 1, 1),
    "grad-cap4": (1, 8, 16, 32, 8, 4, 2),
    "aux-capT": (1, 16, 16, 32, 8, 16, 3),
    "default-cap": (2, 24, 16, 32, 4, None, 4),
    "default-cap-wide": (4, 32, 32, 64, 8, None, 5),
}


def _case(name):
    B, T, D, F, E, cap, seed = CASES[name]
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, T, D)).astype(np.float32)
    params = JM.moe_params(rng, D, F, E)
    g = rng.normal(size=(B, T, D)).astype(np.float32)
    return x, params, g, cap


def _jax_layer(x, params, g, cap, ep=1):
    """The JAX layer's (y, aux, grads of x, wg, w1, w2) on a mesh of
    ``ep`` devices along "ep", the experts sharded over it."""
    mesh = JMesh(np.array(jax.devices()[:ep]), axis_names=("ep",))
    comm = JComm(mesh, ("ep",))
    fn = jax.shard_map(
        lambda a, wg, w1, w2: JM.switch_moe(
            comm, a, {"wg": wg, "w1": w1, "w2": w2}, axis="ep",
            capacity=cap, with_aux=True),
        mesh=mesh, in_specs=(P(), P(), P("ep"), P("ep")),
        out_specs=(P(), P()), check_vma=False)

    @jax.jit
    def run(*args):
        (y, aux), vjp = jax.vjp(fn, *args[:4])
        return y, aux, vjp((args[4], jnp.zeros_like(aux)))

    y, aux, grads = run(x, params["wg"], params["w1"], params["w2"], g)
    return (np.asarray(y), float(aux),
            dict(zip(("x", "wg", "w1", "w2"), map(np.asarray, grads))))


def _comm(ep_axis="ep"):
    return DeviceCommunicator(make_mesh({ep_axis: 1}, device="cpu"),
                              (ep_axis,))


def _port_layer(x, params, g, cap, onehot=False, dtype=torch.float32):
    xt = torch.from_numpy(x).to(dtype).requires_grad_(True)
    p = {k: torch.from_numpy(v).requires_grad_(True)
         for k, v in params.items()}
    y, aux = M.switch_moe(_comm(), xt, p, capacity=cap, with_aux=True,
                          onehot=onehot)
    grads = torch.autograd.grad((y * torch.from_numpy(g).to(dtype)).sum(),
                                [xt, p["wg"], p["w1"], p["w2"]])
    return y.detach(), aux.detach(), dict(zip(("x", "wg", "w1", "w2"),
                                              grads))


def _rel_l2(a, b) -> float:
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _jax_routing(x, wg):
    """The JAX layer's expert per token and its top-2 gate margin."""
    logits = np.asarray(jnp.einsum("td,de->te", x.reshape(-1, x.shape[-1]),
                                   wg, preferred_element_type=jnp.float32))
    probs = np.asarray(jax.nn.softmax(jnp.asarray(logits), axis=-1))
    top2 = np.sort(probs, axis=-1)[:, -2:]
    return probs.argmax(-1), top2[:, 1] - top2[:, 0]


def _assert_same_routing(x, wg, cap):
    want, margin = _jax_routing(x, wg)
    xf = torch.from_numpy(x.reshape(-1, x.shape[-1]))
    got = M.route(xf, torch.from_numpy(wg), cap or 1).expert.numpy()
    bad = np.nonzero(got != want)[0]
    assert bad.size == 0, (f"expert differs for tokens {bad.tolist()}, "
                           f"top-2 margins {margin[bad].tolist()}")


def test_moe_params_bit_identical():
    for seed in (0, 7):
        jp = JM.moe_params(np.random.default_rng(seed), 32, 64, 8)
        tp = M.moe_params(np.random.default_rng(seed), 32, 64, 8)
        assert sorted(jp) == sorted(tp)
        for k in jp:
            assert jp[k].dtype == tp[k].dtype
            np.testing.assert_array_equal(jp[k], tp[k])


@pytest.mark.parametrize("n_tok,experts,factor", [
    (32, 8, 1.25), (16, 2, 1.25), (16384, 8, 1.25), (16, 8, 4.0),
    (3, 8, 1.25), (100, 3, 0.7), (1, 4, 0.01)])
def test_capacity_is_the_reference_float_expression(n_tok, experts, factor):
    want = max(1, math.ceil((n_tok / experts) * factor))
    assert M.capacity_for(n_tok, experts, factor) == want


@pytest.mark.parametrize("case", sorted(CASES))
def test_switch_moe_matches_jax(case):
    """Output, routing, drops, aux and the gradients of x and of every
    leaf, at ep = 1."""
    x, params, g, cap = _case(case)
    _assert_same_routing(x, params["wg"], cap)
    jy, jaux, jg = _jax_layer(x, params, g, cap)
    y, aux, grads = _port_layer(x, params, g, cap)
    np.testing.assert_allclose(y.numpy(), jy, rtol=OUT_TOL, atol=OUT_TOL)
    # dropped tokens are exactly zero on both sides
    np.testing.assert_array_equal(
        np.abs(y.numpy()).sum(-1) == 0, np.abs(jy).sum(-1) == 0)
    assert abs(aux.item() - jaux) <= AUX_RTOL * abs(jaux), (aux, jaux)
    for k, want in jg.items():
        assert grads[k].shape == want.shape, k
        assert _rel_l2(grads[k].numpy(), want) <= GRAD_RL2, (
            k, _rel_l2(grads[k].numpy(), want))


def test_switch_moe_capacity_drops_tokens():
    """With capacity 1 and many tokens an expert, at most E tokens keep a
    contribution; the dropped ones are exactly zero and get no gradient
    from the layer."""
    x, params, g, _ = _case("drops-cap1")
    E, D = params["wg"].shape[1], x.shape[-1]
    tight, _, grads = _port_layer(x, params, g, 1)
    loose, _, _ = _port_layer(x, params, g, x.shape[1])
    nz_tight = int((tight.reshape(-1, D).abs().sum(1) > 1e-9).sum())
    nz_loose = int((loose.reshape(-1, D).abs().sum(1) > 1e-9).sum())
    assert nz_tight <= E < nz_loose
    r = M.route(torch.from_numpy(x.reshape(-1, D)),
                torch.from_numpy(params["wg"]), 1)
    dropped = ~r.keep
    assert int(dropped.sum()) == x.shape[1] - nz_tight
    assert torch.equal(r.slot[dropped], torch.full_like(r.slot[dropped],
                                                        E * 1))
    gx = grads["x"].reshape(-1, D)[dropped]
    assert torch.equal(gx, torch.zeros_like(gx))


def test_switch_moe_aux_loss():
    """Balance loss: ≥ 1 (1 at perfect balance), larger under a skewed
    gate, differentiable in the gate weights, equal to the JAX layer's."""
    x, params, g, cap = _case("aux-capT")
    _, aux, grads = _port_layer(x, params, g, cap)
    assert aux.item() >= 0.99
    skew = {**params, "wg": params["wg"].copy()}
    skew["wg"][:, 0] += 100.0
    _, aux_skew, _ = _port_layer(x, skew, g, cap)
    _, jaux_skew, _ = _jax_layer(x, skew, g, cap)
    assert aux_skew.item() > aux.item()
    assert abs(aux_skew.item() - jaux_skew) <= AUX_RTOL * jaux_skew
    wg = torch.from_numpy(params["wg"]).requires_grad_(True)
    p = {"wg": wg, "w1": torch.from_numpy(params["w1"]),
         "w2": torch.from_numpy(params["w2"])}
    _, a = M.switch_moe(_comm(), torch.from_numpy(x), p, capacity=cap,
                        with_aux=True)
    (gw,) = torch.autograd.grad(a, [wg])
    assert torch.isfinite(gw).all() and gw.abs().sum() > 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["oracle-cap8", "drops-cap1",
                                  "default-cap-wide"])
def test_index_form_equals_onehot_form_bitwise(case, dtype):
    """The index dispatch and combine against the reference's one-hot
    einsums: the same output, aux and gradients, bit for bit."""
    x, params, g, cap = _case(case)
    dt = getattr(torch, dtype)
    y, aux, grads = _port_layer(x, params, g, cap, dtype=dt)
    y1, aux1, grads1 = _port_layer(x, params, g, cap, onehot=True, dtype=dt)
    assert y.dtype == dt
    assert torch.equal(y, y1)
    assert torch.equal(aux, aux1)
    for k in grads:
        assert torch.equal(grads[k], grads1[k]), k


def test_dispatch_and_combine_match_the_onehot_einsums():
    """The two forms alone, on random rows, with drops and empty slots."""
    rng = np.random.default_rng(6)
    n, D, E, C = 40, 12, 4, 6
    xf = torch.from_numpy(rng.normal(size=(n, D)).astype(np.float32))
    wg = torch.from_numpy(rng.normal(size=(D, E)).astype(np.float32))
    r = M.route(xf, wg, C)
    assert int((~r.keep).sum()) > 0          # the capacity binds
    send = M.dispatch(xf, r)
    assert send.shape == (E, C, D)
    assert torch.equal(send, M.dispatch_onehot(xf, r))
    out = torch.from_numpy(rng.normal(size=(E, C, D)).astype(np.float32))
    assert torch.equal(M.combine(out, r), M.combine_onehot(out, r))
    kept = r.keep.nonzero()[:, 0]
    assert torch.equal(send.reshape(E * C, D)[r.slot[kept]], xf[kept])


def test_recording_gives_the_routing():
    x, params, g, cap = _case("drops-cap1")
    p = {k: torch.from_numpy(v) for k, v in params.items()}
    with M.recording() as rec:
        M.switch_moe(_comm(), torch.from_numpy(x), p, capacity=cap)
    M.switch_moe(_comm(), torch.from_numpy(x), p, capacity=cap)
    assert len(rec) == 1
    want, _ = _jax_routing(x, params["wg"])
    E = params["wg"].shape[1]
    np.testing.assert_array_equal(rec[0]["load"].numpy(),
                                  np.bincount(want, minlength=E))
    kept = np.minimum(np.bincount(want, minlength=E), cap).sum()
    assert int(rec[0]["dropped"]) == x.shape[1] - kept
    assert rec[0]["tokens"] == x.shape[0] * x.shape[1]


def test_replaying_routes_as_recorded():
    """A replay sends every token to the recorded expert: a perturbed
    input that routes tokens elsewhere when free routes them as recorded;
    the recorded input gives the recorded output bit for bit; a call the
    records do not hold raises."""
    x, params, g, cap = _case("default-cap-wide")
    p = {k: torch.from_numpy(v) for k, v in params.items()}
    xt = torch.from_numpy(x)
    x2 = xt + 0.5 * torch.from_numpy(
        np.random.default_rng(9).normal(size=x.shape).astype(np.float32))
    with M.recording() as rec:
        y = M.switch_moe(_comm(), xt, p, capacity=cap)
    with M.recording() as free:
        M.switch_moe(_comm(), x2, p, capacity=cap)
    assert (free[0]["expert"] != rec[0]["expert"]).any()
    with M.replaying(rec), M.recording() as again:
        M.switch_moe(_comm(), x2, p, capacity=cap)
        y_same = M.switch_moe(_comm(), xt, p, capacity=cap)
        with pytest.raises(RuntimeError, match="no recorded routing"):
            M.switch_moe(_comm(), xt[:1], p, capacity=cap)
    assert torch.equal(again[0]["expert"], rec[0]["expert"])
    assert torch.equal(y_same, y)


def test_replaying_finds_the_remat_recompute_calls():
    """Under remat "dots" the backward recomputes each layer's switch; a
    replay of the recorded routing serves those calls too and gives the
    same loss and gradients."""
    from ompi_tpu_torch.models import transformer as T
    from ompi_tpu_torch.models.weights import from_jax_params

    cfg = T.TransformerConfig(vocab=64, d_model=32, n_heads=4, n_layers=2,
                              d_ff=64, seq=16, attention="xla",
                              compute_dtype="float32", moe_experts=4,
                              remat="dots")
    params = from_jax_params(T.init_params(cfg, seed=1), cfg, "cpu",
                             train=True)
    toks = np.random.default_rng(2).integers(0, 64, size=(2, 16))
    loss_fn = T.make_loss_fn(cfg, make_mesh({"dp": 1, "sp": 1, "tp": 1},
                                            device="cpu"))

    def run():
        loss = loss_fn(params, toks)
        return loss, torch.autograd.grad(loss, list(params.values()))

    with M.recording() as rec:
        want, want_g = run()
    assert len(rec) == 2 * cfg.n_layers      # the forward and the recompute
    with M.replaying(rec):
        got, got_g = run()
    assert torch.equal(got, want)
    for a, b in zip(got_g, want_g):
        assert torch.equal(a, b)


def test_switch_moe_rejects_an_unbound_axis_and_a_wrong_gate():
    x, params, _, cap = _case("grad-cap4")
    p = {k: torch.from_numpy(v) for k, v in params.items()}
    mesh = make_mesh({"dp": 1, "ep": 1}, device="cpu")
    with pytest.raises(ValueError, match="not bound"):
        M.switch_moe(DeviceCommunicator(mesh, ("dp",)), torch.from_numpy(x),
                     p, capacity=cap)
    with pytest.raises(ValueError, match="routes to"):
        M.switch_moe(_comm(), torch.from_numpy(x),
                     {**p, "w1": p["w1"][:4], "w2": p["w2"][:4]},
                     capacity=cap)


# ---------------------------------------------------------------------------
# ep = 4 on 4 gloo ranks
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    p = TR.RankPool(tmp_path_factory.mktemp("ranks"))
    yield p
    p.close()


@pytest.mark.parametrize("case", ["oracle-cap8", "default-cap-wide"])
def test_switch_moe_ep4_matches_jax_ep_sharded(pool, case):
    """8 experts over ep = 4 (2 a rank), the tokens replicated: every
    rank's output and aux equal the JAX layer's on 4 ep-sharded devices;
    its x and gate gradients equal the JAX ep = 1 layer's, and the expert
    owner's w1/w2 gradient is ep = 4 times its block of them: every rank
    sends the owner the same cotangent (the model divides it out,
    ``transformer._count_experts_once``)."""
    x, params, g, cap = _case(case)
    jy, jaux, _ = _jax_layer(x, params, g, cap, ep=4)
    _, _, jg1 = _jax_layer(x, params, g, cap, ep=1)
    res = pool.run(TR.moe_layer, x=x, params=params, g=g,
                   axes={"ep": 4}, capacity=cap)
    E = params["wg"].shape[1]
    for r, (y, aux, grads) in enumerate(res):
        np.testing.assert_allclose(y, jy, rtol=OUT_TOL, atol=OUT_TOL,
                                   err_msg=f"rank {r}")
        assert abs(aux - jaux) <= AUX_RTOL * abs(jaux), (r, aux, jaux)
        for k in ("x", "wg"):
            assert _rel_l2(grads[k], jg1[k]) <= GRAD_RL2, (r, k)
        block = slice(r * E // 4, (r + 1) * E // 4)
        for k in ("w1", "w2"):
            assert grads[k].shape == jg1[k][block].shape
            assert _rel_l2(grads[k] / 4, jg1[k][block]) <= GRAD_RL2, (r, k)
