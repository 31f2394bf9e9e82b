"""Autoregressive decoding with a KV cache — the serving path.

The port of ``ompi_tpu.models.decode``: prefill runs the backbone once
with ``collect_kv`` (each layer's attention through the flash kernel on
the card), the first new token comes from the prefill logits, then
``max_new - 1`` single-token steps run against the cache.  Greedy argmax
over the full vocab by default; ``temperature > 0`` samples, optionally
truncated to the ``top_k`` highest logits.  Decode requires sp == 1.

MoE configs route each generated token through the same ep-sharded
switch as training.  The switch's capacity is computed per call, so a
cached step computes it from its B tokens: under a binding capacity the
drop pattern can differ from a full forward's, as in the JAX package;
the two agree exactly when capacity does not bind.

A call's model spans (``mpi.trace.model_span``): ``decode.prefill``
through the first token, one ``decode.step`` a cached step (one token
for every request), and in it one ``decode.attend`` a layer (the cache
write, its f32 cast, the mask, softmax and both einsums).
"""

from __future__ import annotations

import itertools

import torch

from ompi_tpu_torch.models import transformer as tfm
from ompi_tpu_torch.models.transformer import (TransformerConfig,
                                               _dense_ffn_tail,
                                               _moe_ffn_tail, _rmsnorm,
                                               _rope)
from ompi_tpu_torch.mpi import trace
from ompi_tpu_torch.parallel.layers import column_parallel, row_parallel

__all__ = ["make_decoder"]


def _step_layer(cfg: TransformerConfig, comm, lp, h, kc, vc, pos: int,
                positions):
    """One layer for ONE new token at ``pos``: writes the token's k/v into
    this layer's cache in place and attends over the whole cache.

    h: (B, 1, D); kc/vc: (B, Tmax, H, hd) views of the cache.  The
    attention runs in f32 over all Tmax slots with the slots after
    ``pos`` masked to -1e30, as in the JAX package.
    """
    cdt = h.dtype
    B = h.shape[0]
    Tmax, hl, hd = kc.shape[1], kc.shape[2], kc.shape[3]
    f32 = torch.float32

    x = _rmsnorm(h, lp["ln1"])
    q = column_parallel(x, lp["wq"].to(cdt)).reshape(B, 1, hl, hd)
    k = column_parallel(x, lp["wk"].to(cdt)).reshape(B, 1, hl, hd)
    v = column_parallel(x, lp["wv"].to(cdt)).reshape(B, 1, hl, hd)
    q = _rope(q, positions[pos:pos + 1])
    k = _rope(k, positions[pos:pos + 1])
    with trace.model_span("decode.attend", pos=pos):
        kc[:, pos] = k[:, 0].to(kc.dtype)
        vc[:, pos] = v[:, 0].to(vc.dtype)
        s = torch.einsum("bqhd,bkhd->bhqk", q.to(f32),
                         kc.to(f32)) * (hd ** -0.5)
        s = torch.where(positions <= pos, s, -1e30)
        w = torch.softmax(s, dim=-1)
        o = torch.einsum("bhqk,bkhd->bqhd", w, vc.to(f32))
    o = o.to(cdt).reshape(B, 1, hl * hd)
    h = h + row_parallel(o, lp["wo"].to(cdt), comm, axis="tp")
    if cfg.moe_experts:
        return _moe_ffn_tail(cfg, h, lp, comm)[0]  # aux: training only
    return _dense_ffn_tail(h, lp, comm, cdt)


def make_decoder(cfg: TransformerConfig, mesh, max_new: int,
                 temperature: float = 0.0, top_k: int = 0):
    """(params, prompt (B, Tp)[, seed]) → (B, Tp+max_new) int32 tokens.

    ``params`` come from ``models.weights.from_jax_params`` on
    ``mesh.device``.  Greedy decoding keeps the two-argument signature;
    with ``temperature > 0`` the callable takes a third argument ``seed``
    that seeds the ``torch.Generator`` all draws of the call come from.
    """
    from ompi_tpu_torch.mpi.device_comm import DeviceCommunicator
    from ompi_tpu_torch.parallel.mesh import resolve_device

    for ax in ("dp", "sp", "tp"):
        if ax not in mesh.shape:
            raise ValueError(f"decode needs a mesh with dp/sp/tp axes "
                             f"(missing {ax!r}; have {tuple(mesh.shape)})")
    if int(mesh.shape["sp"]) != 1:
        raise ValueError("decode requires sp == 1 (sequence parallelism "
                         "is a training-time layout)")
    if temperature < 0:
        raise ValueError(f"temperature must be >= 0, got {temperature}")
    if top_k and not temperature:
        raise ValueError("top_k needs temperature > 0")
    if top_k < 0 or top_k > cfg.vocab:
        raise ValueError(f"top_k must be in [0, vocab={cfg.vocab}], "
                         f"got {top_k}")
    if max_new < 1:
        raise ValueError(f"max_new must be >= 1, got {max_new}")
    tfm.check_mesh(cfg, mesh)
    dev = resolve_device(mesh.device)
    tfm.full_f32_matmuls()
    axes = tuple(a for a in ("dp", "sp", "tp", "ep")
                 if a in mesh.axis_names)
    comm = DeviceCommunicator(mesh, axes)
    cdt = tfm.torch_dtype(cfg.compute_dtype)
    keys = tfm.layer_keys(cfg)

    def pick(logits, gen):
        """Next token from (B, V) f32 logits."""
        if not temperature:
            return logits.argmax(dim=-1)
        scaled = logits / temperature
        if top_k:
            kth = torch.topk(scaled, top_k, dim=-1).values[..., -1:]
            scaled = torch.where(scaled < kth, float("-inf"), scaled)
        # Gumbel-max: argmax(logits/T + Gumbel noise) is a categorical draw
        u = torch.rand(scaled.shape, generator=gen, device=dev)
        return (scaled - torch.log(-torch.log(u.clamp_min(1e-20)))).argmax(
            dim=-1)

    calls = itertools.count()

    @torch.no_grad()
    def run(params, prompt, seed):
        call = next(calls)
        with trace.model_span("decode.prefill", call=call):
            prompt = tfm.as_tokens(prompt, dev)
            B, Tp = prompt.shape
            Tmax = Tp + max_new
            gen = torch.Generator(device=dev)
            gen.manual_seed(int(seed))
            positions = torch.arange(Tmax, device=dev)

            # ---- prefill: one backbone pass, K/V collected ----
            h, (_aux, ks, vs) = tfm._local_backbone(cfg, comm, params,
                                                    prompt, collect_kv=True)
            # The cache is preallocated once as (L, B, Tmax, H, hd) in
            # compute dtype; each cached step writes its token's k/v in
            # place at `pos` (the JAX package pads and carries immutable
            # caches).
            kc = torch.zeros((ks.shape[0], B, Tmax) + ks.shape[3:],
                             dtype=cdt, device=dev)
            vc = torch.zeros_like(kc)
            kc[:, :, :Tp] = ks
            vc[:, :, :Tp] = vs
            del ks, vs
            # the unembed matrix in the compute dtype, made once per call
            emb_c = params["emb"].to(cdt)
            tok = pick(tfm.unembed(h[:, -1, :], emb_c, cdt), gen)
        out = [tok]

        # emit the PRODUCED token and run max_new-1 steps: tok0 is known
        # from prefill, so the last single-token pass is not computed
        for pos in range(Tp, Tmax - 1):
            with trace.model_span("decode.step", call=call, pos=pos):
                h = params["emb"][tok].to(cdt)[:, None, :]    # (B, 1, D)
                for i in range(cfg.n_layers):
                    lp = {key: params[key][i] for key in keys}
                    h = _step_layer(cfg, comm, lp, h, kc[i], vc[i], pos,
                                    positions)
                h = _rmsnorm(h, params["lnf"])
                tok = pick(tfm.unembed(h[:, 0, :], emb_c, cdt), gen)
            out.append(tok)
        return torch.cat([prompt, torch.stack(out, dim=1)],
                         dim=1).to(torch.int32)

    if temperature:
        return run
    # greedy keeps its two-argument signature; seed is inert
    return lambda params, prompt: run(params, prompt, 0)
