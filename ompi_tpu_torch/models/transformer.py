"""Flagship model: the dense transformer LM of the JAX package.

The port of ``ompi_tpu.models.transformer``: the same config, the same
parameter dict (layers stacked along a leading L axis) made by the same
numpy draws, and the same layer math, run eagerly in PyTorch as a Python
loop over the L stacked layers.  Compute dtype is bfloat16 by default,
with float32 accumulation; norms and rotary angles run in float32.

Serving: ``make_forward`` and ``models.decode``.  Training, on one
device (dp = sp = tp = 1): ``make_loss_fn``, ``make_train_step`` and
``make_train_loop`` with their options ``remat``, ``ce_chunk``,
``grad_accum``, ``param_dtype`` and ``adam_mu_dtype``.  ``zero1_axis``,
the multi-rank layouts and the MoE family come in later slices
(ROADMAP.md).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ompi_tpu_torch.parallel.layers import column_parallel, row_parallel

__all__ = ["TransformerConfig", "init_params", "make_forward",
           "make_loss_fn", "make_train_step", "make_train_loop"]

LAYER_KEYS = ("wq", "wk", "wv", "wo", "w1", "w2", "ln1", "ln2")


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab: int = 32_000
    d_model: int = 512
    n_heads: int = 8
    n_layers: int = 4
    d_ff: int = 2048
    seq: int = 512
    attention: str = "ring"  # ring | ulysses | flash | xla | gathered
    # ("flash" = the flash kernel for the local attention, "xla" = the
    # materialized plain attention — the kernel-vs-plain ablation pair)
    moe_experts: int = 0
    moe_capacity_factor: float = 1.25
    moe_aux_weight: float = 0.01
    ce_chunk: int = 0
    compute_dtype: Any = "bfloat16"
    remat: Any = "dots"
    adam_mu_dtype: Any = None
    param_dtype: Any = None
    grad_accum: int = 1
    zero1_axis: Any = None

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


def torch_dtype(name) -> torch.dtype:
    """A config dtype ("bfloat16", "float32" or a torch dtype) as torch's."""
    return name if isinstance(name, torch.dtype) else getattr(torch, name)


def init_params(cfg: TransformerConfig, seed: int = 0) -> dict:
    """Global parameter dict of float32 numpy arrays, layers stacked; the
    same draws in the same order as the JAX package, so one seed gives
    bit-identical arrays (load them with ``models.weights``).

    With ``cfg.param_dtype = "bfloat16"`` the arrays stay float32 here:
    the rounding to the storage dtype (nearest even, as the JAX package's
    ``astype``) happens in ``from_jax_params(..., train=True)``, because
    numpy has no bfloat16 without ml_dtypes."""
    rng = np.random.default_rng(seed)
    L, D, F_, V = cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.vocab

    def w(*shape, scale=None):
        scale = scale if scale is not None else (shape[-2] ** -0.5)
        return rng.normal(0, scale, size=shape).astype(np.float32)

    params = {
        "emb": w(V, D, scale=0.02),
        "wq": w(L, D, D), "wk": w(L, D, D), "wv": w(L, D, D),
        "wo": w(L, D, D, scale=(D ** -0.5) / max(1, 2 * L) ** 0.5),
        "ln1": np.ones((L, D), np.float32),
        "ln2": np.ones((L, D), np.float32),
        "lnf": np.ones((D,), np.float32),
    }
    if cfg.moe_experts:
        E = cfg.moe_experts
        params["wg"] = w(L, D, E, scale=0.02)
        params["w1"] = w(L, E, D, F_)
        params["w2"] = w(L, E, F_, D,
                         scale=(F_ ** -0.5) / max(1, 2 * L) ** 0.5)
    else:
        params["w1"] = w(L, D, F_)
        params["w2"] = w(L, F_, D, scale=(F_ ** -0.5) / max(1, 2 * L) ** 0.5)
    return params


def check_supported(cfg: TransformerConfig) -> None:
    if cfg.moe_experts:
        raise NotImplementedError(
            "MoE configs need the ep all_to_all; they come with the MoE "
            "slice (ROADMAP.md queue 1 item 4)")


def full_f32_matmuls() -> None:
    """f32 matmuls and convolutions in full f32, not TF32: float32 parity
    with the JAX package depends on it (TF32 keeps ~3 decimal digits)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _rmsnorm(x, scale):
    xf = x.to(torch.float32)
    norm = xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + 1e-6)
    return (norm * scale).to(x.dtype)


def _rope(x, positions):
    """Rotary embeddings with *global* positions; the bf16×f32 products
    promote to f32 and the result casts back, as in the JAX package."""
    B, T, H, D = x.shape
    half = D // 2
    freqs = 1.0 / (10_000 ** (torch.arange(half, dtype=torch.float32,
                                           device=x.device) / half))
    ang = positions[:, None].to(torch.float32) * freqs[None, :]  # (T, half)
    cos, sin = torch.cos(ang)[None, :, None], torch.sin(ang)[None, :, None]
    x1, x2 = x[..., :half], x[..., half:]
    rot = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return rot.to(x.dtype)


def _dense_ffn_tail(h, lp, comm, cdt):
    """Post-attention half of the dense layer: ln2 → gelu MLP → residual
    (shared by the backbone and the cached decode step).  jax.nn.gelu is
    the tanh approximation; torch's default is erf."""
    x = _rmsnorm(h, lp["ln2"])
    y = F.gelu(column_parallel(x, lp["w1"].to(cdt)), approximate="tanh")
    return h + row_parallel(y, lp["w2"].to(cdt), comm, axis="tp")


def _attend(cfg, comm, q, k, v):
    from ompi_tpu_torch.parallel import attention as attn

    if cfg.attention == "ring":
        return attn.ring_attention(comm, q, k, v, axis="sp")
    if cfg.attention == "ulysses":
        return attn.ulysses_attention(comm, q, k, v, axis="sp")
    if cfg.attention == "flash":
        return attn.ulysses_attention(comm, q, k, v, axis="sp", impl="flash")
    if cfg.attention == "xla":
        return attn.ulysses_attention(comm, q, k, v, axis="sp", impl="jnp")
    return attn.gathered_attention(comm, q, k, v, axis="sp")


#: ops whose outputs the "dots" remat policy saves: the matmuls without
#: batch dims (projections, FFN, unembed), as the JAX package's
#: ``dots_with_no_batch_dims_saveable``; everything else is recomputed
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(cfg: TransformerConfig, fn):
    """``fn`` under the config's activation-checkpoint policy, the
    counterpart of the JAX package's ``jax.checkpoint`` per layer:
    True/"full" recomputes the whole layer in the backward, "dots" saves
    the matmul outputs and recomputes the rest, anything else saves all.
    All three give the same numbers.  The recompute reruns the layer's
    Python forward, kernels included, so they must be pure."""
    if cfg.remat in (True, "full"):
        return functools.partial(checkpoint, fn, use_reentrant=False)
    if cfg.remat == "dots":
        return functools.partial(
            checkpoint, fn, use_reentrant=False,
            context_fn=functools.partial(create_selective_checkpoint_contexts,
                                         _dots_policy))
    return fn


def _local_backbone(cfg: TransformerConfig, comm, params, tokens,
                    collect_kv: bool = False):
    """Forward through the final rmsnorm (everything but the unembed).

    tokens: (B, S) int64.  Returns (h (B, S, D) compute dtype, aux), aux
    the (zero) MoE balance loss.  With ``collect_kv`` returns
    (h, (aux, k, v)) where k/v are the post-rope per-layer attention
    inputs stacked (L, B, S, H, hd), the KV-cache prefill.  Under autograd
    each layer runs under ``cfg.remat``.
    """
    check_supported(cfg)
    cdt = torch_dtype(cfg.compute_dtype)
    tp = int(comm.mesh.shape["tp"])
    h_local = cfg.n_heads // tp
    hd = cfg.head_dim
    T = tokens.shape[1]
    positions = torch.arange(T, device=tokens.device)  # sp == 1: offset 0

    def layer(h, lp):
        x = _rmsnorm(h, lp["ln1"])
        B, t = x.shape[0], x.shape[1]
        q = column_parallel(x, lp["wq"].to(cdt)).reshape(B, t, h_local, hd)
        k = column_parallel(x, lp["wk"].to(cdt)).reshape(B, t, h_local, hd)
        v = column_parallel(x, lp["wv"].to(cdt)).reshape(B, t, h_local, hd)
        q = _rope(q, positions)
        k = _rope(k, positions)
        o = _attend(cfg, comm, q, k, v).reshape(B, t, h_local * hd)
        h = h + row_parallel(o, lp["wo"].to(cdt), comm, axis="tp")
        return _dense_ffn_tail(h, lp, comm, cdt), k, v

    if torch.is_grad_enabled() and not collect_kv:
        layer_fn = _remat(cfg, layer)
    else:
        layer_fn = layer
    h = params["emb"][tokens].to(cdt)  # (b, t, D)
    # one unbind per stacked leaf: its backward stacks the L layers'
    # gradients at once (indexing would add L full-size zero-padded ones)
    stacked = {key: params[key].unbind(0) for key in LAYER_KEYS}
    ks, vs = [], []
    for i in range(cfg.n_layers):
        lp = {key: stacked[key][i] for key in LAYER_KEYS}
        h, k, v = layer_fn(h, lp)
        if collect_kv:
            ks.append(k)
            vs.append(v)
    h = _rmsnorm(h, params["lnf"])
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    if collect_kv:
        return h, (aux, torch.stack(ks), torch.stack(vs))
    return h, aux


def _mm_f32(a, b):
    """a @ b with f32 accumulation and an f32 result.  bf16 operands on the
    card go to the tensor cores (``aten::mm.dtype``: bf16 products are
    exact in the f32 accumulator); anywhere else the operands are upcast
    and multiplied in full f32 (TF32 stays off), which is the same
    arithmetic up to the order of the sums."""
    if a.is_cuda and a.dtype == torch.bfloat16:
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.mm(a.to(torch.float32), b.to(torch.float32))


class _Unembed(torch.autograd.Function):
    """logits (N, V) f32 = h (N, D) @ emb (V, D)ᵀ, both in the compute
    dtype, f32 accumulation: the JAX package's ``einsum(...,
    preferred_element_type=f32)``.

    The backward rounds the f32 cotangent to the compute dtype and
    accumulates in f32 (the reference's arithmetic at default precision
    on its TPU), so on the card both gradient products run on the tensor
    cores too; the gradients come back in h's and emb's dtype.  In an f32
    config the rounding is the identity and every product is full f32.
    A Function, not a scoped flag around a matmul: the autograd of a
    plain matmul would run after any context manager had exited."""

    @staticmethod
    def forward(ctx, h, emb):
        ctx.save_for_backward(h, emb)
        return _mm_f32(h, emb.t())

    @staticmethod
    def backward(ctx, g):
        h, emb = ctx.saved_tensors
        g = g.to(emb.dtype)
        grad_h = grad_emb = None
        if ctx.needs_input_grad[0]:
            grad_h = _mm_f32(g, emb).to(h.dtype)
        if ctx.needs_input_grad[1]:
            grad_emb = _mm_f32(g.t(), h).to(emb.dtype)
        return grad_h, grad_emb


def unembed(h, emb, cdt):
    """Logits (..., V) in f32 from compute-dtype operands: h and emb
    rounded to ``cdt``, exact products, f32 accumulation, as the JAX
    package's preferred_element_type=f32 einsum (bf16 logits would change
    argmax tokens).  On the card a bf16 config runs it, forward and
    backward, on the tensor cores (``_Unembed``)."""
    d = h.shape[-1]
    logits = _Unembed.apply(h.to(cdt).reshape(-1, d), emb.to(cdt))
    return logits.reshape(*h.shape[:-1], emb.shape[0])


def unembed_reference(h, emb, cdt):
    """The plain version of :func:`unembed`: the cdt-rounded operands
    upcast and multiplied in full f32, differentiated by autograd (an f32
    cotangent), on any device."""
    return torch.matmul(h.to(cdt).to(torch.float32),
                        emb.to(cdt).to(torch.float32).t())


def _local_forward(cfg: TransformerConfig, comm, params, tokens):
    """tokens (B, S) → (logits (B, S, V) float32, aux)."""
    h, aux = _local_backbone(cfg, comm, params, tokens)
    return unembed(h, params["emb"], torch_dtype(cfg.compute_dtype)), aux


def as_tokens(tokens, device: torch.device) -> torch.Tensor:
    """An int token array (numpy or torch) as int64 on ``device``."""
    if not isinstance(tokens, torch.Tensor):
        tokens = torch.from_numpy(np.asarray(tokens))
    return tokens.to(device=device, dtype=torch.long)


def make_forward(cfg: TransformerConfig, mesh):
    """(params, tokens (B, S)) → logits (B, S, V) float32, for serving.
    ``params`` come from ``models.weights.from_jax_params``."""
    from ompi_tpu_torch.parallel.mesh import resolve_device

    dev = resolve_device(mesh.device)
    comm = _comm_for(cfg, mesh)

    def forward(params, tokens):
        with torch.no_grad():
            return _local_forward(cfg, comm, params,
                                  as_tokens(tokens, dev))[0]

    return forward


# ---------------------------------------------------------------------------
# training (one device: dp = sp = tp = 1)
# ---------------------------------------------------------------------------

_MULTI_RANK = ("the multi-rank training slice (ROADMAP.md queue 1 "
               "item 3)")


def _nll_chunk(h_c, emb_c, lab_c, w_c):
    """Σ weight·nll of one sequence chunk; its (B, c, V) logits live only
    inside this call (recomputed in the backward)."""
    logits = unembed(h_c, emb_c, emb_c.dtype)
    lse = torch.logsumexp(logits, dim=-1)
    lab_logit = logits.gather(-1, lab_c[..., None])[..., 0]
    return ((lse - lab_logit) * w_c).sum()


def _chunked_nll_sum(cfg: TransformerConfig, h, emb, labels, weight):
    """Σ weight·nll WITHOUT materializing the full (B, T, V) logits: a loop
    over sequence chunks of ``cfg.ce_chunk``, each chunk's logits
    recomputed in the backward (``torch.utils.checkpoint``), as the JAX
    package's ``jax.checkpoint`` around its scanned chunk body.

    h: (B, T, D) compute dtype; emb: (V, D) f32; labels: (B, T) int64;
    weight: (B, T) f32.  Returns a f32 scalar.
    """
    T = h.shape[1]
    c = cfg.ce_chunk
    emb_c = emb.to(h.dtype)
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(T // c):
        sl = slice(i * c, (i + 1) * c)
        total = total + checkpoint(_nll_chunk, h[:, sl], emb_c, labels[:, sl],
                                   weight[:, sl], use_reentrant=False)
    return total


def _local_loss(cfg: TransformerConfig, comm, params, tokens):
    """Next-token cross entropy at sp = 1: labels are the tokens shifted
    left by one, the first token wrapping round to label the last
    position, whose weight is 0 (the weight mask is built from
    ``cfg.seq``, not T, as in the JAX package)."""
    check_supported(cfg)
    B, T = tokens.shape
    labels = torch.cat([tokens[:, 1:], tokens[:, :1]], dim=1)
    positions = torch.arange(T, device=tokens.device)
    weight = (positions < cfg.seq - 1).to(torch.float32)[None, :]
    if cfg.ce_chunk and T % cfg.ce_chunk == 0:
        h, _aux = _local_backbone(cfg, comm, params, tokens)
        local_sum = _chunked_nll_sum(cfg, h, params["emb"], labels,
                                     weight.expand(B, T))
    else:
        logits, _aux = _local_forward(cfg, comm, params, tokens)
        logprobs = torch.log_softmax(logits, dim=-1)
        nll = -logprobs.gather(-1, labels[..., None])[..., 0]
        local_sum = (nll * weight).sum()
    return local_sum / (weight.sum() * B)


def _comm_for(cfg: TransformerConfig, mesh):
    from ompi_tpu_torch.mpi.device_comm import DeviceCommunicator

    check_supported(cfg)
    full_f32_matmuls()
    axes = tuple(a for a in ("dp", "sp", "tp", "ep")
                 if a in mesh.axis_names)
    return DeviceCommunicator(mesh, axes)


def make_loss_fn(cfg: TransformerConfig, mesh):
    """(params, tokens (B, S)) → scalar f32 loss, differentiable in the
    params (leaf tensors from ``from_jax_params(..., train=True)``)."""
    from ompi_tpu_torch.parallel.mesh import resolve_device

    dev = resolve_device(mesh.device)
    comm = _comm_for(cfg, mesh)

    def loss_fn(params, tokens):
        return _local_loss(cfg, comm, params, as_tokens(tokens, dev))

    return loss_fn


def _store_dtype(cfg: TransformerConfig):
    if cfg.param_dtype in (None, "float32", torch.float32):
        return None
    return torch_dtype(cfg.param_dtype)


def _make_step_body(cfg: TransformerConfig, mesh, lr):
    """The optimizer-step body both entry points run: (params, opt_state,
    tokens) → (params, opt_state, loss).  AdamW as the JAX package's
    ``optax.adamw(lr, b1=0.9, b2=0.95, weight_decay=0.01,
    mu_dtype=cfg.adam_mu_dtype)``; with ``param_dtype="bfloat16"`` the
    optimizer runs on an f32 master copy and the live params are
    re-derived from it each step.

    The params are updated in place (the counterpart of the JAX package's
    donated buffers: no second copy of the model) and returned."""
    from ompi_tpu_torch.models.optim import adamw

    if cfg.zero1_axis:
        raise NotImplementedError(f"zero1_axis (a ZeRO-1 sharded optimizer "
                                  f"state) comes with {_MULTI_RANK}")
    loss_fn = make_loss_fn(cfg, mesh)
    opt = adamw(lr, b1=0.9, b2=0.95, weight_decay=0.01,
                mu_dtype=cfg.adam_mu_dtype)
    accum = int(cfg.grad_accum)
    if accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {cfg.grad_accum}")
    store = _store_dtype(cfg)
    f32 = torch.float32

    def value_and_grad(params, tokens):
        loss = loss_fn(params, tokens)
        keys = list(params)
        grads = torch.autograd.grad(loss, [params[k] for k in keys])
        return loss.detach(), dict(zip(keys, grads))

    def loss_and_grads(params, tokens):
        """(mean loss, mean grads): one pass, or ``grad_accum``
        microbatches in turn, grads summed in f32."""
        if accum == 1:
            return value_and_grad(params, tokens)
        B = tokens.shape[0]
        if B % accum:
            raise ValueError(f"batch {B} not divisible by "
                             f"grad_accum {accum}")
        micro = tokens.reshape(accum, B // accum, *tokens.shape[1:])
        total = torch.zeros((), dtype=f32, device=mesh.device)
        g_sum = {k: torch.zeros(p.shape, dtype=f32, device=p.device)
                 for k, p in params.items()}
        for toks in micro:
            loss, g = value_and_grad(params, toks)
            total = total + loss
            for k in g_sum:
                g_sum[k] += g[k].to(f32)
            del g
        inv = 1.0 / accum
        return total * inv, {k: g * inv for k, g in g_sum.items()}

    if store is None:
        def body(params, opt_state, tokens):
            loss, grads = loss_and_grads(params, tokens)
            updates, opt_state = opt.update(grads, opt_state, params)
            with torch.no_grad():
                for k, u in updates.items():
                    params[k].add_(u)
            return params, opt_state, loss

        return body, opt.init

    def master_init(params):
        master = {k: p.detach().to(f32).clone() for k, p in params.items()}
        return {"opt": opt.init(master), "master": master}

    def body(params, opt_state, tokens):
        loss, grads = loss_and_grads(params, tokens)
        g32 = {k: g.to(f32) for k, g in grads.items()}
        del grads
        master = opt_state["master"]
        updates, inner = opt.update(g32, opt_state["opt"], master)
        with torch.no_grad():
            for k, u in updates.items():
                master[k].add_(u)
                params[k].copy_(master[k])      # rounds to the storage dtype
        return params, {"opt": inner, "master": master}, loss

    return body, master_init


def make_train_step(cfg: TransformerConfig, mesh, lr=3e-4):
    """(params, opt_state, tokens) → (params, opt_state, loss), and the
    optimizer-state initializer: ``step, init_opt = make_train_step(...)``.

    ``params`` come from ``models.weights.from_jax_params(..., train=True)``
    on ``mesh.device`` and are updated in place; ``tokens`` is a (B, S)
    int array (numpy or tensor).  ``lr`` is a float or a callable of the
    step count."""
    body, init = _make_step_body(cfg, mesh, lr)
    dev = mesh.device

    def step(params, opt_state, tokens):
        return body(params, opt_state, as_tokens(tokens, dev))

    return step, init


def make_train_loop(cfg: TransformerConfig, mesh, lr=3e-4, steps: int = 8):
    """(params, opt_state, tokens) → (params, opt_state, losses): ``steps``
    optimizer steps on the same tokens, losses a (steps,) f32 tensor."""
    body, init = _make_step_body(cfg, mesh, lr)
    dev = mesh.device

    def run(params, opt_state, tokens):
        tokens = as_tokens(tokens, dev)
        losses = []
        for _ in range(steps):
            params, opt_state, loss = body(params, opt_state, tokens)
            losses.append(loss)
        return params, opt_state, torch.stack(losses).to(torch.float32)

    return run, init
