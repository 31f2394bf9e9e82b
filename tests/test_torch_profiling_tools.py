"""The port's profiling tools (``ompi_tpu_torch/tools/{flagship,
xprof_capture,step_breakdown,cost_analysis}.py``) on the CPU, against
the JAX package where it has a number to compare.

- ``xprof_capture``: the reference's two cases of
  ``tests/runtime/test_xprof_capture.py``, structural for a Chrome trace
  (a real capture of tiny train steps with ``--cpu 1 --small``, its
  ``summary.json`` beside the trace; the reference's keyword asserts on
  ``categorize``), plus the card's kernel names (cuBLAS/CUTLASS GEMMs and
  the port's flash kernels as tensor-core work, NCCL as collectives,
  memcpy/memset as copies) and a device trace's summary.
- ``step_breakdown``: the ``fwd`` phase's loss at the small config
  equals the JAX package's ``make_loss_fn`` on the same parameters
  (``init_params`` seed 0, through ``from_jax_params``) and tokens,
  within 1e-3 relative (bf16 products with f32 accumulation in both;
  measured 3.5e-5).
- ``cost_analysis``: the dispatcher's FLOPs of a train step at
  ``--small`` are at least the analytic (6N + 12·L·D·S) a token (on the
  CPU the plain attention computes every (query, key) pair, and the
  loss chunks' logits are recomputed in the backward: 1.10×), and at
  the small widths with one layer and no loss chunks, where the JAX
  step's compiled program has no loop (XLA's cost analysis counts a
  loop body once: the JAX step scans its layers and its loss chunks),
  they are 0.90–1.0× ``compiled.cost_analysis()``'s (measured 0.967:
  XLA counts elementwise FLOPs too).  The flash kernels' shape-derived
  costs equal ``chip_smoke.py``'s bound helpers'.
"""

from __future__ import annotations

import json
import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest

from ompi_tpu.models import transformer as J
from ompi_tpu.parallel.mesh import make_mesh as jax_mesh
from ompi_tpu_torch.core.config import var_registry
from ompi_tpu_torch.tools import cost_analysis as CA
from ompi_tpu_torch.tools import flagship
from ompi_tpu_torch.tools import step_breakdown as SB
from ompi_tpu_torch.tools import xprof_capture as xc

ROOT = pathlib.Path(__file__).resolve().parents[1]
FWD_LOSS_RTOL = 1e-3
XLA_RATIO = (0.90, 1.0)


@pytest.fixture
def bwd_var():
    """The tools switch the flash backward kernels on in this process's
    registry: put the variable back."""
    import ompi_tpu_torch.ops.flash_attention  # noqa: F401 — its var

    before = var_registry.get("ops_flash_bwd_kernel")
    yield
    var_registry.set("ops_flash_bwd_kernel", before)


def test_capture_cpu_smoke(tmp_path):
    out = tmp_path / "trace"
    r = subprocess.run(
        [sys.executable, "-m", "ompi_tpu_torch.tools.xprof_capture",
         "--cpu", "1", "--small", "--steps", "2", "--out", str(out)],
        capture_output=True, text=True, timeout=420, cwd=ROOT)
    assert r.returncode == 0, r.stderr[-2000:]
    summary = json.loads(r.stdout.strip().splitlines()[-1])
    # the Chrome trace is loadable and referenced
    assert os.path.exists(summary["trace"])
    assert summary["trace"].endswith(".json")
    assert json.load(open(summary["trace"]))["traceEvents"]
    assert summary["events"] > 0
    assert summary["steps"] == 2
    assert summary["backend"] == "cpu"
    fr = summary["fractions"]
    assert fr and abs(sum(fr.values()) - 1.0) < 0.01
    assert set(fr) <= {"mxu", "copy", "collective", "other"}
    assert fr["mxu"] > 0
    # summary.json lands next to the trace for the artifact chain
    side = os.path.join(os.path.dirname(summary["trace"]), "summary.json")
    assert json.load(open(side))["events"] == summary["events"]
    # on the CPU the wrappers run their plain versions: no launch
    assert summary["flash_launches"] == {"flash_fwd": 0, "flash_bwd_dq": 0,
                                         "flash_bwd_dkv": 0}


def test_categorize_keywords():
    assert xc.categorize("dot_general.7") == "mxu"
    assert xc.categorize("convolution.1") == "mxu"
    # dtype converts are data movement, NOT matmuls ("conv" prefix trap)
    assert xc.categorize("convert_convert_fusion") == "copy"
    assert xc.categorize("all-reduce.3") == "collective"
    assert xc.categorize("collective-permute-start") == "collective"
    assert xc.categorize("copy.5") == "copy"
    assert xc.categorize("exponential_subtract_fusion") == "other"


@pytest.mark.parametrize("name,cat", [
    ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64_"
     "warpgroupsize1x1x1_execute_segment_k_off_kernel__5x_cublas", "mxu"),
    ("nvjet_tst_128x256_64x4_1x2_h_bz_coopA_TNT", "mxu"),
    ("cutlass::Kernel2<cutlass_80_tensorop_bf16_s16816gemm_relu_bf16_"
     "64x64_64x4_tn_align8>(cutlass_80_tensorop_bf16_s16816gemm_relu_bf16_"
     "64x64_64x4_tn_align8::Params)", "mxu"),
    ("void gemv2T_kernel_val<int, int, float, float, float, float, 128, "
     "16, 4, 4, false, false>", "mxu"),
    ("flash_fwd_bf16_kernel", "mxu"),
    ("bwd_dq_bf16_kernel", "mxu"),
    ("bwd_dkv_bf16_kernel", "mxu"),
    ("ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevKernelArgsStorage"
     "<4096ul>)", "collective"),
    ("Memcpy DtoH (Device -> Pageable)", "copy"),
    ("Memset (Device)", "copy"),
    ("void at::native::unrolled_elementwise_kernel<at::native::"
     "direct_copy_kernel_cuda(at::TensorIteratorBase&)::{lambda()#3}",
     "copy"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::"
     "CUDAFunctor_add<float>, at::detail::Array<char*, 3> >", "other"),
    ("aten::mm", "mxu"), ("aten::addmm", "mxu"), ("aten::mul", "other"),
])
def test_categorize_card_kernel_names(name, cat):
    assert xc.categorize(name) == cat


def _trace(tmp_path, events) -> str:
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return str(path)


def test_summarize_device_trace(tmp_path):
    ev = [
        {"ph": "X", "cat": "kernel", "name": "flash_fwd_bf16_kernel",
         "ts": 0, "dur": 100, "pid": 0, "tid": 7},
        {"ph": "X", "cat": "kernel", "name": "bwd_dkv_bf16_kernel",
         "ts": 100, "dur": 100, "pid": 0, "tid": 7},
        {"ph": "X", "cat": "kernel", "name": "nvjet_tst_128x256", "ts": 200,
         "dur": 200, "pid": 0, "tid": 7},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoD (Device -> "
         "Device)", "ts": 400, "dur": 100, "pid": 0, "tid": 7},
        {"ph": "X", "cat": "kernel", "name": "ncclDevKernel_AllGather",
         "ts": 500, "dur": 100, "pid": 0, "tid": 7},
        {"ph": "X", "cat": "kernel", "name": "reduce_kernel", "ts": 600,
         "dur": 400, "pid": 0, "tid": 7},
        # host events do not count on the card
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 0,
         "dur": 5000, "pid": 1, "tid": 1},
    ]
    s = xc.summarize_trace(_trace(tmp_path, ev), device=True)
    assert s["events"] == 6 and s["total_op_ms"] == pytest.approx(1.0)
    assert s["fractions"] == pytest.approx({"mxu": 0.4, "copy": 0.1,
                                            "collective": 0.1,
                                            "other": 0.4})
    assert s["flash_events"] == {"flash_fwd": 1, "flash_bwd_dq": 0,
                                 "flash_bwd_dkv": 1}
    with pytest.raises(RuntimeError, match="no device event"):
        xc.summarize_trace(_trace(tmp_path, ev[-1:]), device=True)


def test_host_self_times_do_not_count_twice(tmp_path):
    ev = [{"ph": "X", "cat": "cpu_op", "name": "aten::linear", "ts": 0,
           "dur": 100, "pid": 0, "tid": 1},
          {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 10,
           "dur": 80, "pid": 0, "tid": 1},
          {"ph": "X", "cat": "cpu_op", "name": "aten::copy_", "ts": 100,
           "dur": 50, "pid": 0, "tid": 1}]
    s = xc.summarize_trace(_trace(tmp_path, ev), device=False)
    assert s["total_op_ms"] == pytest.approx(0.15)
    assert s["top_ops_ms"] == pytest.approx(
        {"aten::mm": 0.08, "aten::copy_": 0.05, "aten::linear": 0.02})


def test_peaks_by_card_name():
    assert flagship.peak_flops("NVIDIA H100 80GB HBM3") == 989e12
    assert flagship.hbm_bw("NVIDIA H100 80GB HBM3") == 3.35e12
    assert flagship.peak_flops("cpu") is None
    assert flagship.hbm_bw("NVIDIA A100-SXM4-80GB") is None
    cfg, batch = flagship.config()
    assert (cfg.vocab, cfg.d_model, cfg.n_heads, cfg.n_layers, cfg.d_ff,
            cfg.seq, cfg.ce_chunk, batch) == (32000, 2048, 16, 8, 8192, 1024,
                                              256, 16)
    assert (cfg.attention, cfg.remat, cfg.compute_dtype) == (
        "flash", "dots", "bfloat16")


def test_breakdown_fwd_loss_equals_the_jax_loss(bwd_var):
    rec = SB.run_phase("fwd", cpu=True, small=True, chain=2)
    cfg = J.TransformerConfig(**flagship.SMALL, attention="xla",
                              compute_dtype="bfloat16", remat="dots")
    params = J.init_params(cfg)
    toks = np.random.default_rng(0).integers(
        0, cfg.vocab, size=(2, cfg.seq)).astype(np.int32)
    mesh = jax_mesh({"dp": 1, "sp": 1, "tp": 1}, devices=jax.devices()[:1])
    want = float(jax.jit(J.make_loss_fn(cfg, mesh))(params, toks))
    assert rec["phase"] == "fwd" and rec["backend"] == "cpu"
    assert rec["mfu_pct"] is None and rec["step_ms"] > 0
    np.testing.assert_allclose(rec["loss"], want, rtol=FWD_LOSS_RTOL)


def _xla_flops(fields: dict) -> float:
    cfg = J.TransformerConfig(**fields, attention="xla",
                              compute_dtype="bfloat16")
    mesh = jax_mesh({"dp": 1, "sp": 1, "tp": 1}, devices=jax.devices()[:1])
    step, init_opt = J.make_train_step(cfg, mesh, lr=1e-3)
    params = J.init_params(cfg)
    toks = np.random.default_rng(0).integers(
        0, cfg.vocab, size=(2, cfg.seq)).astype(np.int32)
    ca = step.lower(params, init_opt(params), toks).compile().cost_analysis()
    return float((ca[0] if isinstance(ca, list) else ca)["flops"])


def test_cost_analysis_against_analytic_and_xla(bwd_var, monkeypatch):
    rec = CA.analyze(cpu=True, small=True)
    assert rec["flops"] >= rec["analytic_flops"]
    assert rec["bytes_accessed"] > 0 and rec["dispatch_ops"] > 0
    assert rec["flops_bound_ms"] is None and rec["bytes_bound_ms"] is None
    flat = dict(CA.SMALL, n_layers=1, ce_chunk=0)
    monkeypatch.setattr(CA, "SMALL", flat)
    port = CA.analyze(cpu=True, small=True)["flops"]
    ratio = port / _xla_flops(flat)
    assert XLA_RATIO[0] <= ratio <= XLA_RATIO[1], ratio


@pytest.mark.parametrize("shape", [(256, 1024, 1024, 128, 2),
                                   (4, 96, 96, 64, 4)])
def test_flash_costs_equal_chip_smoke_bounds(shape):
    sys.path.insert(0, str(ROOT))
    import chip_smoke as C

    bh, t_q, t_k, d, item = shape
    got = CA.flash_costs(bh, t_q, t_k, d, item)
    fwd = C.attention_bound_ms(1, bh, t_q, t_k, d, item, True, 0, 0)
    assert got["flash_fwd"] == (fwd[3], fwd[2])
    for part, key in (("dq", "flash_bwd_dq"), ("dkv", "flash_bwd_dkv")):
        b = C.bwd_bound_ms(part, bh, t_q, t_k, d, item, True, 0, 0)
        assert got[key] == (b[3], b[2])


def _params(widths: dict) -> int:
    from ompi_tpu_torch.models.transformer import TransformerConfig
    from ompi_tpu_torch.models.transformer import init_params

    return flagship.count_params(init_params(TransformerConfig(**widths)))


def test_cut_keeps_the_widths():
    assert flagship.cut(None, None) is None
    assert flagship.cut(flagship.SMALL, None) is flagship.SMALL
    cfg, batch = flagship.config(flagship.cut(None, 1))
    assert (cfg.vocab, cfg.d_model, cfg.n_heads, cfg.n_layers, cfg.d_ff,
            cfg.seq, batch) == (32000, 2048, 16, 1, 8192, 1024, 16)
    assert flagship.cut(flagship.SMALL, 1) == dict(flagship.SMALL,
                                                   n_layers=1)
    with pytest.raises(ValueError, match="--layers"):
        flagship.cut(None, 0)


@pytest.mark.parametrize("tool", ["xprof_capture", "step_breakdown",
                                  "cost_analysis"])
def test_layers_cuts_each_tools_depth(tool, tmp_path, monkeypatch, bwd_var):
    """``--layers 1`` through each tool's command line: one layer of
    ``--small``'s widths (cost_analysis's own small widths), the records
    saying so."""
    monkeypatch.setattr(flagship, "SWEEP", str(tmp_path / "sweep.jsonl"))
    widths = flagship.SMALL
    if tool == "xprof_capture":
        assert xc.main(["--cpu", "1", "--small", "--layers", "1", "--steps",
                        "1", "--out", str(tmp_path / "trace")]) == 0
        rec = json.load(open(tmp_path / "trace" / "summary.json"))
    elif tool == "step_breakdown":
        (rec,) = SB.main(["--cpu", "--small", "--layers", "1", "fwd"])
    else:
        rec = CA.main(["--cpu", "--small", "--layers", "1"])
        widths = CA.SMALL
    assert "error" not in rec, rec
    assert rec["n_layers"] == 1
    assert rec["params"] == _params(flagship.cut(widths, 1)) < _params(widths)
