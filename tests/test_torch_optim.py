"""The port's AdamW (ompi_tpu_torch.models.optim) against ``optax.adamw``
with the JAX package's settings (b1 0.9, b2 0.95, weight decay 0.01), on
identical numpy parameters and gradients over 5 updates.

Tolerance 1e-6 relative (f32): the two compute the same elementwise
formulas, but the jitted optax fuses them into FMAs and its f32 powers
may differ in the last bit, so an element is held at 1e-6 of itself or
of its leaf's largest value (an update where the Adam term and the
weight decay nearly cancel has no relative precision of its own).
A bf16 first moment is compared after both round it (one bf16 step of
slack).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ompi_tpu_torch.models.optim import AdamWState, adamw

RTOL = 1e-6
SHAPES = {"w": (6, 5), "ln": (5,), "emb": (7, 5)}


def _params_and_grads(seed=0, steps=5):
    rng = np.random.default_rng(seed)
    params = {k: rng.normal(size=s).astype(np.float32)
              for k, s in SHAPES.items()}
    grads = [{k: (rng.normal(size=s) * 10.0 ** rng.integers(-4, 1))
              .astype(np.float32) for k, s in SHAPES.items()}
             for _ in range(steps)]
    return params, grads


def _run_both(lr, mu_dtype):
    params, grads = _params_and_grads()
    jopt = optax.adamw(lr, b1=0.9, b2=0.95, weight_decay=0.01,
                       mu_dtype=mu_dtype)
    topt = adamw(lr, b1=0.9, b2=0.95, weight_decay=0.01, mu_dtype=mu_dtype)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    js, ts = jopt.init(jp), topt.init(tp)
    # jitted, as the JAX package's train step runs it (eager JAX would
    # round the bf16 ``b1 * mu`` product that the jitted fusion keeps)
    jupdate = jax.jit(jopt.update)
    out = []
    for g in grads:
        ju, js = jupdate({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        jp = optax.apply_updates(jp, ju)
        tu, ts = topt.update({k: torch.from_numpy(v) for k, v in g.items()},
                             ts, tp)
        tp = {k: tp[k] + tu[k] for k in tp}
        out.append((ju, js, jp, tu, ts, tp))
    return out


def _np(x):
    return np.asarray(x.float().numpy() if isinstance(x, torch.Tensor)
                      else np.asarray(x, np.float32))


def _close(got, want, name):
    """RTOL relative, with RTOL of the leaf's largest value as the floor
    (XLA fuses the moment updates into FMAs: one-ulp differences)."""
    ref = _np(want)
    np.testing.assert_allclose(_np(got), ref, rtol=RTOL,
                               atol=RTOL * np.abs(ref).max(), err_msg=name)


@pytest.mark.parametrize("mu_dtype", [None, "bfloat16"])
@pytest.mark.parametrize("lr", [1e-3, "schedule"])
def test_adamw_matches_optax(lr, mu_dtype):
    if lr == "schedule":
        lr = optax.warmup_cosine_decay_schedule(
            init_value=0.0, peak_value=1e-2, warmup_steps=2, decay_steps=10)
    for ju, js, jp, tu, ts, tp in _run_both(lr, mu_dtype):
        adam = js[0]
        assert int(ts.count) == int(adam.count)
        for k in SHAPES:
            _close(tu[k], ju[k], k)
            _close(tp[k], jp[k], k)
            _close(ts.nu[k], adam.nu[k], k)
            if mu_dtype is None:
                _close(ts.mu[k], adam.mu[k], k)
            else:
                assert ts.mu[k].dtype == torch.bfloat16
                assert adam.mu[k].dtype == jnp.bfloat16
                np.testing.assert_allclose(_np(ts.mu[k]), _np(adam.mu[k]),
                                           rtol=2 ** -7, err_msg=k)


def test_state_layout():
    opt = adamw(1e-3, mu_dtype="bfloat16")
    st = opt.init({"w": torch.zeros(3, 2)})
    assert isinstance(st, AdamWState)
    assert st.count.dtype == torch.int32 and int(st.count) == 0
    assert st.count.device == torch.device("cpu")
    assert st.mu["w"].dtype == torch.bfloat16
    assert st.nu["w"].dtype == torch.float32


def test_schedule_sees_the_count_before_the_increment():
    seen = []

    def sched(count):
        seen.append(count)
        return 1e-3

    opt = adamw(sched)
    p = {"w": torch.ones(2)}
    st = opt.init(p)
    for _ in range(3):
        _, st = opt.update({"w": torch.ones(2)}, st, p)
    assert seen == [0, 1, 2]


def test_weight_decay_reaches_every_leaf():
    """No mask: a zero gradient still decays ln and emb leaves."""
    opt = adamw(1.0, weight_decay=0.5)
    p = {"ln1": torch.ones(3), "emb": torch.full((2, 2), 2.0)}
    u, _ = opt.update({k: torch.zeros_like(v) for k, v in p.items()},
                      opt.init(p), p)
    assert torch.equal(u["ln1"], torch.full((3,), -0.5))
    assert torch.equal(u["emb"], torch.full((2, 2), -1.0))


@pytest.mark.parametrize("mu_dtype", [None, "bfloat16"])
def test_update_in_place_equals_update_bit_for_bit(mu_dtype):
    """``update_`` (the train step's: the moments written into the
    state's own tensors) gives the bits of ``update`` (a new state, the
    old one untouched) over 5 updates, and returns the state passed."""
    params, grads = _params_and_grads(seed=1)
    opt = adamw(1e-3, b1=0.9, b2=0.95, weight_decay=0.01,
                mu_dtype=mu_dtype)
    p = {k: torch.from_numpy(v) for k, v in params.items()}
    fresh, own = opt.init(p), opt.init(p)
    for g in grads:
        g = {k: torch.from_numpy(v) for k, v in g.items()}
        before = {k: t.clone() for k, t in fresh.mu.items()}
        u, fresh_next = opt.update(g, fresh, p)
        for k in before:
            assert torch.equal(fresh.mu[k], before[k])   # untouched
        u_, own_next = opt.update_(g, own, p)
        assert own_next is own
        fresh = fresh_next
        for k in u:
            assert torch.equal(u_[k], u[k])
            assert torch.equal(own.mu[k], fresh.mu[k])
            assert torch.equal(own.nu[k], fresh.nu[k])
        assert int(own.count) == int(fresh.count)
