#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``ompi_tpu_torch``) on one NVIDIA H100.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure exits non-zero:

1. device — the card's name, count, and its name and power limit as
   nvidia-smi gives them (also printed alone on a line);
2. build — nvcc builds every kernel from ``ompi_tpu_torch/ops/csrc`` for
   sm_90a, one nvcc per source, all started together; prints the
   ``-Xptxas -v`` register and shared-memory lines;
3. kernel — the flash-attention forward kernel against its plain
   PyTorch version (O and lse) over causal/full, offsets, f32/bf16, head
   dims and lengths, and at the decode prefill shape (B=16, T=512, H=16,
   D=128, bf16, causal), where it is timed beside the plain version, the
   byte/FLOP bound and ``scaled_dot_product_attention`` (a yardstick the
   port never calls);
4. decode — the flagship 468M dense model (bench.py's decode widths) with
   ``attention="flash"``: a greedy KV-cache decode of 16 prompts of 512
   tokens, the launch counts of that one call, the same prompt through the
   plain attention path, the prefill time (max_new=1), the per-token time
   by the two-max_new slope, tokens/s and peak memory; then torch.profiler
   windows over the prefill and a 16-token decode: device busy and idle
   share, and the kernels that take the time;
5. cache — on the small f32 config of the decode tests, the cached greedy
   decode through the kernel equals a token-by-token full-forward greedy
   exactly;
6. the ``kernels`` line, then the card's nvidia-smi line, then the result
   line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import importlib
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
BF16_FLOPS = 989e12            # H100 SXM dense bf16 tensor-core peak
F32_TOL = 2e-5                 # tests/parallel/test_flash.py f32 tolerance
BF16_TOL = 3e-2                # tests/parallel/test_flash.py bf16 tolerance
LOGIT_TOL = 0.1                # flash vs plain prefill logits, bf16 model


def check(ok: bool, what: str) -> None:
    """Fail the run (an assert would vanish under python -O)."""
    if not ok:
        raise AssertionError(what)


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` in ms, from CUDA events over ``iters``
    back-to-back calls after ``warmup`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters


def attention_bound_ms(b, h, t_q, t_k, d, itemsize, causal, q_off, k_off):
    """Least time for the attention forward on this card: the larger of
    bytes (q, k, v read once, o and lse written once) over HBM rate and
    the FLOPs of the live (query, key) pairs over the bf16 peak."""
    nbytes = (2 * t_q + 2 * t_k) * b * h * d * itemsize + b * h * t_q * 4
    if causal:
        qpos = q_off + np.arange(t_q)[:, None]
        kpos = k_off + np.arange(t_k)[None, :]
        pairs = int((qpos >= kpos).sum())
    else:
        pairs = t_q * t_k
    flops = 4 * b * h * d * pairs
    t_bytes, t_flops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS
    return (max(t_bytes, t_flops) * 1e3,
            "bytes" if t_bytes >= t_flops else "operations", nbytes, flops)


def phase_device():
    import torch

    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    emit("device", name=name, count=count, nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda)
    return name, count, smi


def phase_build():
    from ompi_tpu_torch.ops import _build

    sources = sorted(p.name for p in _build.CSRC.glob("*.cu"))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(sources)) as pool:
        libs = list(pool.map(_build.load, sources))
    secs = time.perf_counter() - t0
    emit("build", sources=sources, seconds=round(secs, 3),
         arch="sm_90a", libs=[str(lib._name) for lib in libs],
         ptxas={s: [ln for ln in _build.ptxas_info.get(s, [])
                    if "Used" in ln or "spill" in ln]
                for s in sources})


def phase_kernel(fa):
    import torch

    g = torch.Generator(device="cuda").manual_seed(0)
    worst = {"float32": 0.0, "bfloat16": 0.0}
    n_cases = 0
    for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
        for d in (16, 64, 128):
            for t in (96, 256, 512):
                shape = (2, t, 2, d)
                q, k, v = (torch.randn(shape, generator=g, device="cuda")
                           .to(dtype) for _ in range(3))
                for causal in (True, False):
                    for q_off, k_off in ((0, 0), (128, 0), (0, 128)):
                        o, lse = fa.flash_attention_lse(
                            q, k, v, causal=causal, q_offset=q_off,
                            k_offset=k_off)
                        ro, rlse = fa.flash_attention_lse_reference(
                            q, k, v, causal=causal, q_offset=q_off,
                            k_offset=k_off)
                        torch.cuda.synchronize()
                        check(o.dtype == dtype and o.shape == q.shape,
                              f"output {o.dtype} {tuple(o.shape)}")
                        check(lse.shape == (2, 2, t),
                              f"lse shape {tuple(lse.shape)}")
                        for got, want in ((o.float(), ro.float()),
                                          (lse, rlse)):
                            check(torch.allclose(got, want, atol=tol,
                                                 rtol=tol),
                                  f"flash kernel disagrees: {dtype} d={d} "
                                  f"t={t} causal={causal} offsets="
                                  f"({q_off},{k_off}) max err "
                                  f"{(got - want).abs().max().item()}")
                        key = str(dtype).split(".")[-1]
                        worst[key] = max(worst[key],
                                         (o.float() - ro.float()).abs()
                                         .max().item())
                        n_cases += 1

    # the decode prefill shape: B=16, T=512, H=16, D=128, bf16, causal
    B, T, H, D = 16, 512, 16, 128
    q, k, v = (torch.randn((B, T, H, D), generator=g, device="cuda")
               .to(torch.bfloat16) for _ in range(3))
    o, lse = fa.flash_attention_lse(q, k, v, causal=True)
    ro, rlse = fa.flash_attention_lse_reference(q, k, v, causal=True)
    torch.cuda.synchronize()
    err_o = (o.float() - ro.float()).abs().max().item()
    err_lse = (lse - rlse).abs().max().item()
    check(torch.allclose(o.float(), ro.float(), atol=BF16_TOL,
                         rtol=BF16_TOL), f"prefill-shape O err {err_o}")
    check(torch.allclose(lse, rlse, atol=BF16_TOL, rtol=BF16_TOL),
          f"prefill-shape lse err {err_lse}")

    scale = D ** -0.5
    q3, k3, v3 = (fa._to3(x) for x in (q, k, v))       # (B·H, T, D)
    ms = cuda_ms(lambda: fa.flash_fwd_3d(q3, k3, v3, 0, 0, scale, True))
    q4, k4, v4 = (x.unsqueeze(2) for x in (q3, k3, v3))
    plain_ms = cuda_ms(lambda: fa.flash_attention_lse_reference(
        q4, k4, v4, causal=True, scale=scale))
    qs, ks, vs = (x.view(B, H, T, D) for x in (q3, k3, v3))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library_ms = cuda_ms(lambda: sdpa(qs, ks, vs, is_causal=True))
    bound_ms, bound_by, nbytes, flops = attention_bound_ms(
        B, H, T, T, D, 2, True, 0, 0)
    # the same shape in float32 (the CUDA-core kernel)
    q3f, k3f, v3f = (x.float() for x in (q3, k3, v3))
    f32 = {"ms": cuda_ms(lambda: fa.flash_fwd_3d(q3f, k3f, v3f, 0, 0, scale,
                                                 True)),
           "plain_ms": cuda_ms(lambda: fa.flash_attention_lse_reference(
               *(x.unsqueeze(2) for x in (q3f, k3f, v3f)), causal=True,
               scale=scale)),
           "bound_ms": attention_bound_ms(B, H, T, T, D, 4, True, 0, 0)[0]}
    emit("kernel", cases=n_cases, max_abs_err_o=worst, float32=f32,
         prefill_shape=[B, T, H, D], prefill_dtype="bfloat16",
         prefill_max_abs_err_o=err_o, prefill_max_abs_err_lse=err_lse,
         ms=ms, plain_ms=plain_ms, library_ms=library_ms,
         bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes, flops=flops,
         tflops=flops / ms / 1e9)
    return {"max_abs_err": err_o, "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bound_ms,
            "bound_by": bound_by}


def phase_decode(fa, card):
    import torch

    from ompi_tpu_torch.models.decode import make_decoder
    from ompi_tpu_torch.models.transformer import (TransformerConfig,
                                                   init_params, make_forward)
    from ompi_tpu_torch.models.weights import from_jax_params
    from ompi_tpu_torch.parallel.mesh import make_mesh

    # bench.py matrix_decode_throughput flagship widths (468M params)
    cfg = TransformerConfig(
        vocab=32_000, d_model=2048, n_heads=16, n_layers=8, d_ff=8192,
        seq=512 + 256, attention="flash", compute_dtype="bfloat16")
    cfg_x = dataclasses.replace(cfg, attention="xla")
    batch, prompt_len, lo, hi = 16, 512, 32, 96
    mesh = make_mesh({"dp": 1, "sp": 1, "tp": 1})
    t0 = time.perf_counter()
    params = from_jax_params(init_params(cfg, seed=0), cfg, "cuda")
    load_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in params.values())
    prompt = np.random.default_rng(0).integers(
        0, cfg.vocab, size=(batch, prompt_len)).astype(np.int32)
    dec = make_decoder(cfg, mesh, max_new=lo)

    # ---- the main path: one decode call, launch counts read around it ----
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.launch_count = 0
    out = dec(params, prompt)
    torch.cuda.synchronize()
    launches = fa.launch_count
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    check(launches == cfg.n_layers,
          f"{launches} flash launches in one decode call, want "
          f"{cfg.n_layers}")
    out = out.cpu().numpy()
    check(out.shape == (batch, prompt_len + lo) and out.dtype == np.int32,
          f"tokens {out.dtype} {out.shape}")
    np.testing.assert_array_equal(out[:, :prompt_len], prompt)
    check(out.min() >= 0 and out.max() < cfg.vocab, "token out of range")

    # the same prompt through the plain attention path
    out_x = make_decoder(cfg_x, mesh, max_new=lo)(params, prompt)
    out_x = out_x.cpu().numpy()
    agree = float((out[:, prompt_len:] == out_x[:, prompt_len:]).mean())
    first_agree = float((out[:, prompt_len] == out_x[:, prompt_len]).mean())
    logits = make_forward(cfg, mesh)(params, prompt)
    logits_x = make_forward(cfg_x, mesh)(params, prompt)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(logits).all()), "non-finite logits")
    logit_err = (logits - logits_x).abs().max().item()
    logit_scale = logits_x.abs().max().item()
    check(logit_err <= LOGIT_TOL,
          f"flash vs plain prefill logits differ by {logit_err}")
    del logits, logits_x

    def timed(max_new: int) -> float:
        """Best host wall time of 5 decode calls (after a warm call), each
        ending in a synchronize; the host loop shares its cores, so single
        calls vary."""
        d = make_decoder(cfg, mesh, max_new=max_new)
        d(params, prompt)
        torch.cuda.synchronize()
        best = float("inf")
        for _ in range(5):
            t1 = time.perf_counter()
            d(params, prompt)
            torch.cuda.synchronize()
            best = min(best, time.perf_counter() - t1)
        return best

    # max_new=1 is the prefill alone (one backbone pass, the first token
    # from its logits); the slope between two longer runs is the cached
    # step, with the prefill and the call overhead cancelled
    t_1, t_lo, t_hi = timed(1), timed(lo), timed(hi)
    step_s = (t_hi - t_lo) / (hi - lo)
    emit("decode", config="flagship 468M dense (bench.py decode widths)",
         n_params=n_params, batch=batch, prompt=prompt_len,
         max_new=[lo, hi], load_s=load_s, flash_launches=launches,
         generated_agree_with_plain=agree,
         first_token_agree_with_plain=first_agree,
         prefill_logits_max_abs_diff=logit_err,
         prefill_logits_max_abs=logit_scale, logits_tol=LOGIT_TOL,
         wall_1_s=t_1, wall_lo_s=t_lo, wall_hi_s=t_hi,
         prefill_ms=t_1 * 1e3, ms_per_token=step_s * 1e3,
         ms_per_token_from_prefill=(t_hi - t_1) / (hi - 1) * 1e3,
         tokens_per_s=batch / step_s, peak_mem_gib=peak_gib, card=card)
    phase_profile(make_decoder, cfg, mesh, params, prompt, card)
    return launches


def phase_profile(make_decoder, cfg, mesh, params, prompt, card):
    """Device busy time and the kernels that take it, from torch.profiler,
    for the prefill alone (max_new=1) and for a decode of 16 tokens."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    for max_new in (1, 16):
        d = make_decoder(cfg, mesh, max_new=max_new)
        d(params, prompt)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            d(params, prompt)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        kernels = [e for e in prof.key_averages()
                   if e.device_type.name == "CUDA" and dev_us(e) > 0]
        busy_ms = sum(dev_us(e) for e in kernels) / 1e3
        top = sorted(kernels, key=dev_us, reverse=True)[:6]
        flash_ms = sum(dev_us(e) for e in kernels
                       if "flash_fwd_" in e.key) / 1e3
        emit("profile", max_new=max_new, wall_ms_profiled=wall_ms,
             device_busy_ms=busy_ms,
             device_idle_share=(1 - busy_ms / wall_ms) if busy_ms else None,
             flash_kernel_ms=flash_ms,
             top_kernels=[{"name": e.key[:80], "ms": dev_us(e) / 1e3,
                           "calls": e.count} for e in top],
             card=card)


def _greedy_reference(fwd, params, prompt, max_new):
    """Grow the sequence one token at a time via full forwards."""
    cur = prompt
    for _ in range(max_new):
        logits = fwd(params, cur).cpu().numpy()
        nxt = logits[:, -1, :].argmax(-1).astype(np.int32)[:, None]
        cur = np.concatenate([cur, nxt], axis=1)
    return cur


def phase_cache(fa):
    from ompi_tpu_torch.models.decode import make_decoder
    from ompi_tpu_torch.models.transformer import (TransformerConfig,
                                                   init_params, make_forward)
    from ompi_tpu_torch.models.weights import from_jax_params
    from ompi_tpu_torch.parallel.mesh import make_mesh

    cfg = TransformerConfig(vocab=97, d_model=64, n_heads=4, n_layers=2,
                            d_ff=128, seq=64, attention="flash",
                            compute_dtype="float32")
    mesh = make_mesh({"dp": 1, "sp": 1, "tp": 1})
    params = from_jax_params(init_params(cfg), cfg, "cuda")
    fwd = make_forward(cfg, mesh)
    before = fa.launch_count
    for seed, prompt_len, max_new in ((0, 8, 5), (4, 7, 3)):
        prompt = np.random.default_rng(seed).integers(
            0, cfg.vocab, size=(4, prompt_len)).astype(np.int32)
        got = make_decoder(cfg, mesh, max_new=max_new)(params, prompt)
        np.testing.assert_array_equal(
            got.cpu().numpy(),
            _greedy_reference(fwd, params, prompt, max_new))
    emit("cache", config="tests/parallel/test_decode.py CFG, flash, f32",
         prompts=[8, 7], exact=True,
         kernel_launches=fa.launch_count - before)


def main() -> int:
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    import torch

    import ompi_tpu_torch  # fails outside a checkout

    if not os.path.abspath(ompi_tpu_torch.__file__).startswith(
            os.path.join(here, "")):
        print(f"chip_smoke: ompi_tpu_torch was imported from "
              f"{ompi_tpu_torch.__file__}, not from this checkout",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on the "
              "card only", file=sys.stderr)
        return 2
    fa = importlib.import_module("ompi_tpu_torch.ops.flash_attention")
    torch.backends.cuda.matmul.allow_tf32 = False   # f32 parity
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    name, count, smi = phase_device()
    card = f"{name}, power limit {smi.split(',')[-1].strip()}"
    phase_build()
    kern = phase_kernel(fa)
    launches = phase_decode(fa, card)
    phase_cache(fa)
    kernels = [{
        "name": "flash_fwd", "route": "cuda",
        "source": "ompi_tpu_torch/ops/csrc/flash_fwd.cu",
        "replaces": "ompi_tpu/ops/flash_attention.py:61 (_fwd_kernel)",
        "launches": launches, **kern, "ok": True,
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    emit("done", seconds=time.perf_counter() - t_start, card=card)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
