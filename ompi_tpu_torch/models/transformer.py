"""Flagship model: the dense transformer LM of the JAX package, forward only.

The port of ``ompi_tpu.models.transformer``: the same config, the same
parameter dict (layers stacked along a leading L axis) made by the same
numpy draws, and the same layer math, run eagerly in PyTorch as a Python
loop over the L stacked layers.  Compute dtype is bfloat16 by default,
with float32 accumulation; norms and rotary angles run in float32.

This slice serves (``make_forward`` and ``models.decode``); training, its
options (``remat``, ``ce_chunk``, ``grad_accum``, ``zero1_axis``,
``adam_mu_dtype``, carried on the config and not read by the forward) and
the MoE family come in later slices (ROADMAP.md).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from ompi_tpu_torch.parallel.layers import column_parallel, row_parallel

__all__ = ["TransformerConfig", "init_params", "make_forward"]

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
    bit-identical arrays (load them with ``models.weights``)."""
    if cfg.param_dtype not in (None, "float32"):
        raise NotImplementedError(
            "param_dtype (bf16 storage with an f32 master) is a training "
            "option; it comes with the training slice (ROADMAP.md, port "
            "slice 1)")
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
            "slice (ROADMAP.md, port slice 3)")


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


def _local_backbone(cfg: TransformerConfig, comm, params, tokens,
                    collect_kv: bool = False):
    """Forward through the final rmsnorm (everything but the unembed).

    tokens: (B, S) int64.  Returns (h (B, S, D) compute dtype, aux), aux
    the (zero) MoE balance loss.  With ``collect_kv`` returns
    (h, (aux, k, v)) where k/v are the post-rope per-layer attention
    inputs stacked (L, B, S, H, hd), the KV-cache prefill.
    """
    check_supported(cfg)
    cdt = torch_dtype(cfg.compute_dtype)
    tp = int(comm.mesh.shape["tp"])
    h_local = cfg.n_heads // tp
    hd = cfg.head_dim
    T = tokens.shape[1]
    positions = torch.arange(T, device=tokens.device)  # sp == 1: offset 0

    h = params["emb"][tokens].to(cdt)  # (b, t, D)
    ks, vs = [], []
    for i in range(cfg.n_layers):
        lp = {key: params[key][i] for key in LAYER_KEYS}
        x = _rmsnorm(h, lp["ln1"])
        B, t = x.shape[0], x.shape[1]
        q = column_parallel(x, lp["wq"].to(cdt)).reshape(B, t, h_local, hd)
        k = column_parallel(x, lp["wk"].to(cdt)).reshape(B, t, h_local, hd)
        v = column_parallel(x, lp["wv"].to(cdt)).reshape(B, t, h_local, hd)
        q = _rope(q, positions)
        k = _rope(k, positions)
        o = _attend(cfg, comm, q, k, v).reshape(B, t, h_local * hd)
        h = h + row_parallel(o, lp["wo"].to(cdt), comm, axis="tp")
        h = _dense_ffn_tail(h, lp, comm, cdt)
        if collect_kv:
            ks.append(k)
            vs.append(v)
    h = _rmsnorm(h, params["lnf"])
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    if collect_kv:
        return h, (aux, torch.stack(ks), torch.stack(vs))
    return h, aux


def unembed(h, emb, cdt):
    """Logits in f32 from compute-dtype operands: the bf16-rounded h and
    emb are upcast and multiplied in full f32 (exact products, f32
    accumulation), as the JAX package's preferred_element_type=f32
    einsum; bf16 logits would change argmax tokens."""
    return torch.matmul(h.to(torch.float32),
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
    from ompi_tpu_torch.mpi.device_comm import DeviceCommunicator
    from ompi_tpu_torch.parallel.mesh import resolve_device

    check_supported(cfg)
    dev = resolve_device(mesh.device)
    full_f32_matmuls()
    axes = tuple(a for a in ("dp", "sp", "tp", "ep")
                 if a in mesh.axis_names)
    comm = DeviceCommunicator(mesh, axes)

    def forward(params, tokens):
        with torch.no_grad():
            return _local_forward(cfg, comm, params,
                                  as_tokens(tokens, dev))[0]

    return forward
