"""The yardstick's arithmetic against hand counts: parameters, FLOPs,
bytes, rooflines, the interval union, and the trace reader."""

from __future__ import annotations

import json
import types

import pytest

from benchmark import core, roofline, trace, weights

from .conftest import REAL

FLAGSHIP = {"vocab": 32000, "d_model": 2048, "n_heads": 16, "n_layers": 8,
            "d_ff": 8192, "moe_experts": 0}
MOE = dict(FLAGSHIP, moe_experts=8, moe_capacity_factor=1.25,
           moe_aux_weight=0.01)


def test_parameter_counts_by_hand():
    V, D, F, L, E = 32000, 2048, 8192, 8, 8
    layer = 4 * D * D + 2 * D * F + 2 * D
    assert weights.count(FLAGSHIP) == V * D + L * layer + D == 468_224_000
    moe_layer = 4 * D * D + E * 2 * D * F + 2 * D + D * E
    assert weights.count(MOE) == V * D + L * moe_layer + D
    assert weights.active_count(MOE) == weights.count(MOE) - L * 7 * 2 * D * F


def test_configs_state_their_counts():
    bench = core.Bench(REAL)
    for c in bench.manifest["configs"]:
        with open(f"{REAL}/configs/{c['name']}.json") as f:
            config = json.load(f)
        assert weights.count(config["model"]) == config["parameters"]


def test_train_flops_per_token():
    assert roofline.train_flops_per_token(FLAGSHIP, 1024) == (
        6 * 468_224_000 + 12 * 8 * 2048 * 1024)
    assert roofline.train_flops_per_token(MOE, 4096) == (
        6 * weights.active_count(MOE) + 12 * 8 * 2048 * 4096)


def test_attention_forward_by_hand():
    # 2 positions, causal: pairs (0,0), (1,0), (1,1); one head of 2
    flops, nbytes = roofline.attention_fwd(1, 1, 2, 2, 2)
    assert flops == 4 * 2 * 3
    assert nbytes == (2 * 2 + 2 * 2) * 2 * 2 + 2 * 4
    flops, _ = roofline.attention_fwd(1, 1, 2, 2, 2, causal=False)
    assert flops == 4 * 2 * 4
    # a query block at the end of a longer key range: query i sees 3 + i
    flops, _ = roofline.attention_fwd(1, 1, 2, 4, 1)
    assert flops == 4 * (3 + 4)


def test_least_seconds_takes_the_larger_bound():
    peak = (1e12, 1e9)
    assert roofline.least_seconds(2e12, 1e9, peak) == 2.0
    assert roofline.least_seconds(1e12, 3e9, peak) == 3.0
    assert roofline.peaks("NVIDIA H100 80GB HBM3") == (989e12, 3.35e12)
    assert roofline.peaks("cpu") is None


def test_decode_flops_by_hand():
    model = {"vocab": 10, "d_model": 2, "n_heads": 1, "n_layers": 1,
             "d_ff": 4, "moe_experts": 0}
    n = weights.count(model)
    layers = n - 10 * 2
    # batch 1, prompt 2, 2 new tokens: prefill + one cached step at pos 2
    prefill = 2 * layers * 2 + 2 * 10 * 2 + 4 * 1 * 2 * 3
    step = 2 * n + 4 * 1 * 2 * 3
    assert roofline.decode_flops(model, 1, 2, 2) == prefill + step


def test_union_and_clip():
    assert trace.union([(5, 6), (0, 2), (1, 3), (3, 4), (7, 7)]) == [
        (0, 4), (5, 6)]
    assert trace.clip([(0, 4), (5, 6)], 1, 5.5) == [(1, 4), (5, 5.5)]


def _events():
    """Host thread (1, 1) opens the window [0, 100] and an attention span
    [10, 20]; the autograd thread (1, 2) another span [50, 60].  Kernels:
    A launched in the first span, B outside, C in the second."""
    x = []

    def ev(cat, name, ts, dur, tid=1, pid=1, corr=None):
        e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
             "pid": pid, "tid": tid}
        if corr is not None:
            e["args"] = {"correlation": corr}
        x.append(e)

    ev("user_annotation", "bench.window", 0, 100)
    ev("user_annotation", "bench.attention", 10, 10)
    ev("user_annotation", "bench.attention", 50, 10, tid=2)
    ev("cpu_op", "aten::mm", 30, 20)
    ev("cuda_runtime", "cudaLaunchKernel", 12, 1, corr=1)
    ev("cuda_runtime", "cudaLaunchKernel", 30, 1, corr=2)
    ev("cuda_runtime", "cudaLaunchKernel", 55, 1, tid=2, corr=3)
    ev("kernel", "A", 15, 10, pid=0, tid=7, corr=1)
    ev("kernel", "B", 20, 20, pid=0, tid=7, corr=2)
    ev("kernel", "C", 70, 10, pid=0, tid=7, corr=3)
    ev("gpu_memcpy", "copy", 90, 20, pid=0, tid=8)
    return x


def test_trace_reader_on_a_synthetic_trace():
    t = trace.Trace(_events())
    assert t.window()[:2] == (0, 100)
    assert t.busy_intervals() == [(15, 40), (70, 80), (90, 100)]
    assert t.busy_seconds() == pytest.approx(45e-6)
    assert sorted(k[2] for k in t.kernels_under("bench.attention")) == [
        "A", "C"]
    assert t.device_seconds_under("bench.attention") == pytest.approx(20e-6)
    assert t.span_count("bench.attention") == 2
    assert t.kernels_launched_between((1, 1), 0, 100) == 2
    assert t.top_device_ops(1) == [["B", pytest.approx(20e-6)]]
    assert sorted(n for n, _ in t.top_device_ops()) == ["A", "B", "C",
                                                        "copy"]
    # gaps [0,15] (window), [40,70] (mid 55: aten::mm ended at 50),
    # [80,90] (window)
    gaps = dict((k, v) for k, v in t.idle_gaps())
    assert gaps == {"bench.window": pytest.approx(55e-6)}


def test_readers_on_a_synthetic_context():
    bench = core.Bench(REAL)
    t = trace.Trace(_events())
    peak = (989e12, 3.35e12)
    ctx = types.SimpleNamespace(
        trace=t, kind="train", model=FLAGSHIP, mix={"seq": 1024},
        work={"steps": 2, "tokens": 10}, peak=peak,
        records={"attention": [{"shapes": [(1, 2, 1, 2), (1, 2, 1, 2)],
                                "causal": True, "itemsize": 2}]})
    mfu = bench.reader("mfu.train")(ctx)
    assert mfu == pytest.approx(100 * 10 * roofline.train_flops_per_token(
        FLAGSHIP, 1024) / (100e-6 * 989e12))
    assert bench.reader("device_idle_share.train")(ctx) == pytest.approx(55)
    least = roofline.least_seconds(*roofline.attention_fwd(1, 1, 2, 2, 2),
                                   peak)
    assert bench.reader("attn_fwd_roofline.train")(ctx) == pytest.approx(
        100 * least / 20e-6)
    assert bench.reader("optimizer_ms_per_step.train")(ctx) is None
    assert bench.reader("moe_fwd_ms_per_step.train")(ctx) is None
    assert bench.reader("mfu.decode")(ctx) is None
    ctx.kind = "decode"
    assert bench.reader("mfu.train")(ctx) is None
    assert bench.reader("launches_per_token.decode")(ctx) is None
