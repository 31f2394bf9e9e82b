"""Flagship model: the dense transformer LM of the JAX package.

The port of ``ompi_tpu.models.transformer``: the same config, the same
parameter dict (layers stacked along a leading L axis) made by the same
numpy draws, and the same layer math, run eagerly in PyTorch as a Python
loop over the L stacked layers.  Compute dtype is bfloat16 by default,
with float32 accumulation; norms and rotary angles run in float32.

Serving: ``make_forward`` and ``models.decode``.  Training:
``make_loss_fn``, ``make_train_step`` and ``make_train_loop`` with their
options ``remat``, ``ce_chunk``, ``grad_accum``, ``param_dtype``,
``adam_mu_dtype`` and ``zero1_axis``, on one rank or on a dp × sp × tp
mesh of ranks, one process each: a rank passes its (B/dp, S/sp) token
shard (``shard_tokens``) and its tp blocks of the parameters
(``param_specs``; ``models.weights.from_jax_params(..., mesh=)``).
Sequence parallelism runs ring, Ulysses or gathered attention, tensor
parallelism Megatron's column/row pair, and the gradients are summed
over dp × sp in the step, so the loss, the gradients and the step equal
the one-device run's.

The MoE family (``moe_experts > 0``) replaces every layer's dense FFN
with the switch MoE of ``parallel.moe``, its experts sharded over the
mesh's ``ep`` axis (replicated when there is none; tp ranks replicate
the expert compute), and adds ``moe_aux_weight`` times the mean balance
loss to the training loss.
"""

from __future__ import annotations

import dataclasses
import functools
import itertools
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ompi_tpu_torch.mpi import trace
from ompi_tpu_torch.parallel.collectives import group_size, sum_forward
from ompi_tpu_torch.parallel.layers import (column_parallel, row_parallel,
                                            tp_input)
from ompi_tpu_torch.parallel.mesh import local_block
from ompi_tpu_torch.parallel.moe import EXPERT_KEYS, switch_moe

__all__ = ["TransformerConfig", "init_params", "param_specs",
           "shard_tokens", "make_forward", "make_loss_fn",
           "make_train_step", "make_train_loop"]

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


def layer_keys(cfg: TransformerConfig) -> tuple:
    """The stacked per-layer leaves: the MoE family adds its gate."""
    return LAYER_KEYS + ("wg",) if cfg.moe_experts else LAYER_KEYS


def param_specs(cfg: TransformerConfig = None, mesh=None) -> dict:
    """Each leaf's ``PartitionSpec``-like tuple, as the JAX package's
    ``param_specs``: the attention weights tp-sharded Megatron style
    (wq/wk/wv along their last dimension, wo along the middle one), the
    dense FFN likewise (w1 as wq, w2 as wo), the MoE experts (w1/w2 of
    shape (L, E, ., .)) sharded over ``ep`` along E when the mesh has an
    ``ep`` axis and replicated otherwise (never over tp), everything else
    replicated (``()``).  A rank holds the block of each leaf at its
    coordinates (``parallel.mesh.local_block``)."""
    col, row = (None, None, "tp"), (None, "tp", None)
    specs = {"emb": (), "lnf": (), "ln1": (), "ln2": (),
             "wq": col, "wk": col, "wv": col, "wo": row}
    if cfg is not None and cfg.moe_experts:
        has_ep = mesh is not None and "ep" in mesh.axis_names
        experts = (None, "ep", None, None) if has_ep else ()
        specs.update(wg=(), w1=experts, w2=experts)
    else:
        specs.update(w1=col, w2=row)
    return specs


def shard_tokens(tokens, mesh):
    """This rank's (B/dp, S/sp) block of a global (B, S) token batch: the
    JAX package's ``P("dp", "sp")`` shard at this rank's coordinates,
    what each rank passes to the training and loss entry points."""
    return local_block(tokens, mesh, ("dp", "sp"))


def check_mesh(cfg: TransformerConfig, mesh) -> None:
    """An MoE config's experts must split evenly over the ``ep`` axis."""
    ep = int(mesh.shape.get("ep", 1))
    if cfg.moe_experts and cfg.moe_experts % ep:
        raise ValueError(f"moe_experts {cfg.moe_experts} is not divisible "
                         f"by the mesh's ep axis ({ep})")


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
    x = tp_input(_rmsnorm(h, lp["ln2"]), comm, axis="tp")
    y = F.gelu(column_parallel(x, lp["w1"].to(cdt)), approximate="tanh")
    return h + row_parallel(y, lp["w2"].to(cdt), comm, axis="tp")


def _moe_ffn_tail(cfg, h, lp, comm):
    """Post-attention half of the MoE layer: ln2 → the ep-sharded switch
    → residual (shared by the backbone and the cached decode step).
    Returns (h, aux).  h is replicated over tp after the row-parallel
    sum and every tp rank runs the whole switch on it, so no tp_input:
    each rank's gradient of h is already the whole one."""
    x = _rmsnorm(h, lp["ln2"])
    mo, aux = switch_moe(comm, x, {k: lp[k] for k in ("wg", "w1", "w2")},
                         axis="ep", capacity_factor=cfg.moe_capacity_factor,
                         with_aux=True)
    return h + mo, aux


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

    tokens: (B/dp, S/sp) int64, this rank's shard.  Returns (h (B/dp,
    S/sp, D) compute dtype, aux), aux the MoE balance loss summed over
    the layers (zero for a dense config).  With ``collect_kv`` returns
    (h, (aux, k, v)) where k/v are the post-rope per-layer attention
    inputs stacked (L, B, T, H/tp, hd), the KV-cache prefill.  Rope takes
    the global positions sp_idx·T + t.  Under autograd each layer runs
    under ``cfg.remat``; its recompute reruns the layer's collectives, in
    the same order on every rank.
    """
    cdt = torch_dtype(cfg.compute_dtype)
    tp = int(comm.mesh.shape["tp"])
    h_local = cfg.n_heads // tp
    hd = cfg.head_dim
    T = tokens.shape[1]
    positions = comm.mesh.coord("sp") * T + torch.arange(
        T, device=tokens.device)

    def layer(h, lp):
        x = tp_input(_rmsnorm(h, lp["ln1"]), comm, axis="tp")
        B, t = x.shape[0], x.shape[1]
        q = column_parallel(x, lp["wq"].to(cdt)).reshape(B, t, h_local, hd)
        k = column_parallel(x, lp["wk"].to(cdt)).reshape(B, t, h_local, hd)
        v = column_parallel(x, lp["wv"].to(cdt)).reshape(B, t, h_local, hd)
        q = _rope(q, positions)
        k = _rope(k, positions)
        o = _attend(cfg, comm, q, k, v).reshape(B, t, h_local * hd)
        h = h + row_parallel(o, lp["wo"].to(cdt), comm, axis="tp")
        if cfg.moe_experts:
            h, aux = _moe_ffn_tail(cfg, h, lp, comm)
            return h, k, v, aux
        return _dense_ffn_tail(h, lp, comm, cdt), k, v, None

    if torch.is_grad_enabled() and not collect_kv:
        layer_fn = _remat(cfg, layer)
    else:
        layer_fn = layer
    h = params["emb"][tokens].to(cdt)  # (b, t, D)
    keys = layer_keys(cfg)
    # one unbind per stacked leaf: its backward stacks the L layers'
    # gradients at once (indexing would add L full-size zero-padded ones)
    stacked = {key: params[key].unbind(0) for key in keys}
    ks, vs = [], []
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(cfg.n_layers):
        lp = {key: stacked[key][i] for key in keys}
        h, k, v, layer_aux = layer_fn(h, lp)
        if layer_aux is not None:
            aux = aux + layer_aux
        if collect_kv:
            ks.append(k)
            vs.append(v)
    h = _rmsnorm(h, params["lnf"])
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
# training
# ---------------------------------------------------------------------------


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
    """Next-token cross entropy of the global batch, from this rank's
    (B/dp, S/sp) shard.  Labels are the tokens shifted left by one
    global position: my last position's label is my right neighbour's
    first token (r receives from r+1 round the sp ring; at sp = 1 my own
    first token), and the final global position has weight 0 (the mask
    is built from ``cfg.seq``, not the length, as in the JAX package).

    loss = Σ_{dp,sp} local_sum / Σ_{dp,sp} count.  The numerator's sum
    is the identity in the backward, so each rank differentiates its own
    contribution and the step sums the gradients over dp × sp; the count
    is known on the host (every shard has the same shape).

    An MoE config adds ``moe_aux_weight`` times the balance loss averaged
    over the ranks, as the JAX package's ``psum(aux, axes) / size``.  The
    tp and ep ranks of a (dp, sp) coordinate hold the same tokens and so
    the same aux, so that mean is the mean over dp × sp, whose sum is the
    identity in the backward as the numerator's: summed over dp × sp,
    each rank's share of the gradient gives the mean's."""
    B, T = tokens.shape
    sp, dp = int(comm.mesh.shape["sp"]), int(comm.mesh.shape["dp"])
    first = tokens[:, :1]
    from_right = first if sp == 1 else comm.shift(first, -1, "sp")
    labels = torch.cat([tokens[:, 1:], from_right], dim=1)
    positions = comm.mesh.coord("sp") * T + torch.arange(
        T, device=tokens.device)
    weight = (positions < cfg.seq - 1).to(torch.float32)[None, :]
    if cfg.ce_chunk and T % cfg.ce_chunk == 0:
        h, aux = _local_backbone(cfg, comm, params, tokens)
        local_sum = _chunked_nll_sum(cfg, h, params["emb"], labels,
                                     weight.expand(B, T))
    else:
        logits, aux = _local_forward(cfg, comm, params, tokens)
        logprobs = torch.log_softmax(logits, dim=-1)
        nll = -logprobs.gather(-1, labels[..., None])[..., 0]
        local_sum = (nll * weight).sum()
    count = B * dp * max(0, min(sp * T, cfg.seq - 1))
    if not cfg.moe_experts:
        return sum_forward(comm, local_sum, ("dp", "sp")) / count
    both = sum_forward(comm, torch.stack([local_sum, aux]), ("dp", "sp"))
    return both[0] / count + cfg.moe_aux_weight * (both[1] / (dp * sp))


def _comm_for(cfg: TransformerConfig, mesh):
    from ompi_tpu_torch.mpi.device_comm import DeviceCommunicator

    check_mesh(cfg, mesh)
    full_f32_matmuls()
    axes = tuple(a for a in ("dp", "sp", "tp", "ep")
                 if a in mesh.axis_names)
    return DeviceCommunicator(mesh, axes)


def make_loss_fn(cfg: TransformerConfig, mesh):
    """(params, tokens) → the global batch's scalar f32 loss (equal on
    every rank), differentiable in this rank's params (leaf tensors from
    ``from_jax_params(..., train=True, mesh=)``).  ``tokens`` is this
    rank's (B/dp, S/sp) shard (:func:`shard_tokens`); every rank of the
    mesh makes the call.  Each rank's gradient is its own contribution:
    the step sums them over dp × sp."""
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


def _make_loss_and_grads(cfg: TransformerConfig, mesh):
    """(params, tokens) → (mean loss, grads) as the step takes them: one
    pass, or ``grad_accum`` microbatches in turn with the grads summed in
    f32, then every leaf's gradient summed over dp × sp once
    (:func:`_sum_grads`, the counterpart of the JAX package's AD
    transpose of the replicated in_specs); tp- and ep-sharded leaves keep
    their local block."""
    loss_fn = make_loss_fn(cfg, mesh)
    comm = _comm_for(cfg, mesh)
    accum = int(cfg.grad_accum)
    if accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {cfg.grad_accum}")
    f32 = torch.float32
    dp = int(mesh.shape["dp"])

    def value_and_grad(params, tokens):
        with trace.model_span("train.forward"):
            loss = loss_fn(params, tokens)
        keys = list(params)
        # the backward's kernels launch from the autograd engine's thread
        with trace.model_span("train.backward"):
            grads = torch.autograd.grad(loss, [params[k] for k in keys])
        return loss.detach(), dict(zip(keys, grads))

    def local_loss_and_grads(params, tokens):
        """(mean loss, this rank's mean grads)."""
        if accum == 1:
            return value_and_grad(params, tokens)
        B = tokens.shape[0]
        if B % accum:
            # the global batch B·dp: each of its microbatches must still
            # split over dp, (B·dp / accum) % dp == 0
            raise ValueError(f"batch {B * dp} not divisible by "
                             f"grad_accum {accum} with dp {dp}")
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

    def loss_and_grads(params, tokens):
        loss, grads = local_loss_and_grads(params, tokens)
        return loss, _sum_grads(comm, _count_experts_once(cfg, comm, grads))

    return loss_and_grads


def _make_step_body(cfg: TransformerConfig, mesh, lr):
    """The optimizer-step body both entry points run: (params, opt_state,
    tokens) → (params, opt_state, loss).  AdamW as the JAX package's
    ``optax.adamw(lr, b1=0.9, b2=0.95, weight_decay=0.01,
    mu_dtype=cfg.adam_mu_dtype)``; with ``param_dtype="bfloat16"`` the
    optimizer runs on an f32 master copy and the live params are
    re-derived from it each step.

    The gradients are those of :func:`_make_loss_and_grads`, summed over
    dp × sp once a step after any accumulation.  With ``zero1_axis`` the
    optimizer state is sharded over that axis (``parallel.zero``).

    The params and the optimizer's moments are updated in place (the
    counterpart of the JAX package's donated buffers: no second copy of
    the model or of its Adam state) and returned."""
    from ompi_tpu_torch.models.optim import adamw

    loss_and_grads = _make_loss_and_grads(cfg, mesh)
    opt = adamw(lr, b1=0.9, b2=0.95, weight_decay=0.01,
                mu_dtype=cfg.adam_mu_dtype)
    store = _store_dtype(cfg)
    f32 = torch.float32

    if cfg.zero1_axis:
        from ompi_tpu_torch.parallel.zero import zero1_wrap

        z_init, z_update = zero1_wrap(opt, mesh, cfg.zero1_axis,
                                      param_specs(cfg, mesh))

        def body(params, opt_state, tokens):
            loss, grads = loss_and_grads(params, tokens)
            with trace.model_span("train.optimizer"):
                opt_state = z_update(grads, opt_state, params)
            return params, opt_state, loss

        return body, z_init

    if store is None:
        def body(params, opt_state, tokens):
            loss, grads = loss_and_grads(params, tokens)
            with trace.model_span("train.optimizer"), \
                    torch.no_grad():
                updates, opt_state = opt.update_(grads, opt_state, params)
                for k, u in updates.items():
                    params[k].add_(u)
            return params, opt_state, loss

        return body, opt.init

    def master_init(params):
        master = {k: p.detach().to(f32).clone() for k, p in params.items()}
        return {"opt": opt.init(master), "master": master}

    def body(params, opt_state, tokens):
        loss, grads = loss_and_grads(params, tokens)
        with trace.model_span("train.optimizer"), \
                torch.no_grad():
            g32 = {k: g.to(f32) for k, g in grads.items()}
            del grads
            master = opt_state["master"]
            updates, inner = opt.update_(g32, opt_state["opt"], master)
            for k, u in updates.items():
                master[k].add_(u)
                params[k].copy_(master[k])      # rounds to the storage dtype
        return params, {"opt": inner, "master": master}, loss

    return body, master_init


def _count_experts_once(cfg: TransformerConfig, comm, grads: dict) -> dict:
    """The expert leaves' gradients divided by the ep size.  The ep ranks
    of a (dp, sp) coordinate hold the same tokens and each differentiates
    the whole loss, so in the backward every rank sends each expert's
    owner the same cotangent block: the owner's w1/w2 gradient sums ep
    equal copies.  The other leaves see their tokens once on every rank."""
    ep = group_size(comm, ("ep",))
    if not cfg.moe_experts or ep == 1:
        return grads
    return {k: g / ep if k in EXPERT_KEYS else g for k, g in grads.items()}


def _sum_grads(comm, grads: dict) -> dict:
    """Every leaf's gradient summed over dp × sp: one all-reduce a dtype
    over the leaves flattened into one buffer, none on a one-rank
    group."""
    from torch._utils import (_flatten_dense_tensors,
                              _unflatten_dense_tensors)

    if group_size(comm, ("dp", "sp")) == 1:
        return grads
    out = dict(grads)
    by_dtype: dict = {}
    for k, g in grads.items():
        by_dtype.setdefault(g.dtype, []).append(k)
    for keys in by_dtype.values():
        flat = sum_forward(comm, _flatten_dense_tensors(
            [grads[k] for k in keys]), ("dp", "sp"))
        out.update(zip(keys, _unflatten_dense_tensors(
            flat, [grads[k] for k in keys])))
    return out


def make_train_step(cfg: TransformerConfig, mesh, lr=3e-4):
    """(params, opt_state, tokens) → (params, opt_state, loss), and the
    optimizer-state initializer: ``step, init_opt = make_train_step(...)``.

    ``params`` come from ``models.weights.from_jax_params(..., train=True,
    mesh=)`` on ``mesh.device`` and are updated in place; ``tokens`` is
    this rank's (B/dp, S/sp) shard of the global batch, an int array
    (numpy or tensor; :func:`shard_tokens`).  Every rank of the mesh
    makes the call.  ``lr`` is a float or a callable of the step
    count."""
    body, init = _make_step_body(cfg, mesh, lr)
    dev = mesh.device
    count = itertools.count()

    def step(params, opt_state, tokens):
        n = next(count)
        with trace.model_span("train.step", step=n):
            return body(params, opt_state, as_tokens(tokens, dev))

    return step, init


def make_train_loop(cfg: TransformerConfig, mesh, lr=3e-4, steps: int = 8):
    """(params, opt_state, tokens) → (params, opt_state, losses): ``steps``
    optimizer steps on the same tokens, losses a (steps,) f32 tensor."""
    body, init = _make_step_body(cfg, mesh, lr)
    dev = mesh.device
    count = itertools.count()

    def run(params, opt_state, tokens):
        tokens = as_tokens(tokens, dev)
        losses = []
        for _ in range(steps):
            n = next(count)
            with trace.model_span("train.step", step=n):
                params, opt_state, loss = body(params, opt_state, tokens)
            losses.append(loss)
        return params, opt_state, torch.stack(losses).to(torch.float32)

    return run, init
