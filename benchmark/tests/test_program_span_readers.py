"""The readers of the program's own spans and counters
(``metrics/_program_spans.py`` and the metrics that use it) on Chrome
traces built by hand: which device work counts under which span, the
idle time inside the input pipeline's wait, and nothing where the span
is missing or the cell is of the other kind."""

from __future__ import annotations

import types

import pytest

from benchmark import core
from benchmark.trace import Trace

from .conftest import REAL

MAIN, AUTOGRAD, PREFETCH = (1, 1), (1, 2), (1, 3)
TRAIN = ("fwd_ms_per_step.train", "bwd_ms_per_step.train",
         "optimizer_phase_ms_per_step.train", "input_stall_ms_per_step.train")
DECODE = ("prefill_ms_per_call.decode", "cached_step_ms.decode",
          "cached_attn_ms_per_step.decode")


def _span(name, thread, ts, dur):
    return {"ph": "X", "cat": "user_annotation", "name": name,
            "pid": thread[0], "tid": thread[1], "ts": ts, "dur": dur}


def _launch(corr, thread, ts, name="cudaLaunchKernel"):
    return {"ph": "X", "cat": "cuda_runtime", "name": name, "pid": thread[0],
            "tid": thread[1], "ts": ts, "dur": 1, "args": {"correlation": corr}}


def _device(corr, ts, dur, name="kernel_x", cat="kernel"):
    return {"ph": "X", "cat": cat, "name": name, "pid": 0, "tid": 7,
            "ts": ts, "dur": dur, "args": {"correlation": corr}}


def _work(corr, thread, launch_ts, ts, dur, **kw):
    return [_launch(corr, thread, launch_ts), _device(corr, ts, dur, **kw)]


def _ctx(events, kind="train", **work):
    return types.SimpleNamespace(trace=Trace(events), kind=kind,
                                 work=dict(steps=2, **work))


def _read(metric, ctx):
    return core.Bench(REAL).reader(metric)(ctx)


def _train_trace():
    """A 1000 µs window on the main thread: the forward's kernel, the
    backward's kernel from the autograd thread and an HtoD copy from the
    prefetch thread meanwhile, the optimizer's kernel, and two waits for
    a batch, one crossing the window's start."""
    return [
        _span("bench.window", MAIN, 0, 1000),
        _span("ompi.data.wait", MAIN, -50, 70),           # 0..20 inside
        _span("ompi.train.forward", MAIN, 100, 100),
        *_work(1, MAIN, 150, 160, 30),
        _span("ompi.train.backward", MAIN, 200, 400),
        *_work(2, AUTOGRAD, 300, 310, 100),
        *_work(3, PREFETCH, 350, 420, 20, name="Memcpy HtoD (Pinned -> "
               "Device)", cat="gpu_memcpy"),
        _span("ompi.data.wait", MAIN, 620, 80),           # busy 640..660
        *_work(4, MAIN, 610, 640, 20),
        _span("ompi.train.optimizer", MAIN, 700, 100),
        *_work(5, MAIN, 710, 720, 50),
    ]


def test_train_readers_by_hand():
    ctx = _ctx(_train_trace())
    # the forward's own kernel; not the autograd thread's
    assert _read("fwd_ms_per_step.train", ctx) == pytest.approx(30e-3 / 2)
    # the autograd thread's kernel counts; the HtoD copy launched
    # meanwhile does not
    assert _read("bwd_ms_per_step.train", ctx) == pytest.approx(100e-3 / 2)
    assert _read("optimizer_phase_ms_per_step.train", ctx) == pytest.approx(
        50e-3 / 2)
    # idle inside the waits only: 20 µs before the first kernel, and 60
    # of the second wait's 80 µs
    assert _read("input_stall_ms_per_step.train", ctx) == pytest.approx(
        (20 + 60) * 1e-3 / 2)


def test_backward_span_on_another_thread_only_counts_its_span():
    # a kernel the autograd thread launches after the backward closed is
    # not the backward's
    events = _train_trace() + _work(6, AUTOGRAD, 650, 660, 5)
    assert _read("bwd_ms_per_step.train", _ctx(events)) == pytest.approx(
        100e-3 / 2)


def test_idle_outside_the_wait_is_no_stall():
    events = [_span("bench.window", MAIN, 0, 1000),
              _span("ompi.data.wait", MAIN, 100, 100),
              *_work(1, MAIN, 90, 50, 200)]       # busy over the whole wait
    assert _read("input_stall_ms_per_step.train", _ctx(events)) == 0


def _decode_trace():
    ev = [_span("bench.window", MAIN, 0, 1000),
          _span("ompi.decode.prefill", MAIN, 0, 100),
          *_work(1, MAIN, 10, 20, 40)]
    corr = 2
    for i, start in enumerate((200, 500)):
        ev.append(_span("ompi.decode.step", MAIN, start, 200))
        for layer in range(2):
            at = start + 10 + 90 * layer
            ev.append(_span("ompi.decode.attend", MAIN, at, 50))
            ev += _work(corr, MAIN, at + 5, at + 10, 7)
            ev += _work(corr + 1, MAIN, at + 60, at + 70, 3)  # after attend
            corr += 2
    return ev


def test_decode_readers_by_hand():
    ctx = _ctx(_decode_trace(), kind="decode", calls=1, cached_steps=2)
    assert _read("prefill_ms_per_call.decode", ctx) == pytest.approx(40e-3)
    assert _read("cached_step_ms.decode", ctx) == pytest.approx(
        2 * (7 + 3) * 1e-3)
    assert _read("cached_attn_ms_per_step.decode", ctx) == pytest.approx(
        2 * 7e-3)


@pytest.mark.parametrize("metric", TRAIN + DECODE)
def test_no_span_no_number(metric):
    bare = [_span("bench.window", MAIN, 0, 1000), *_work(1, MAIN, 5, 10, 50)]
    kind = "decode" if metric.endswith(".decode") else "train"
    assert _read(metric, _ctx(bare, kind=kind)) is None
    # and the other kind's cells, whose trace has the other kind's spans
    other = _decode_trace() if kind == "train" else _train_trace()
    assert _read(metric, _ctx(other, kind={"train": "decode",
                                           "decode": "train"}[kind])) is None


def test_drop_share_reads_the_programs_counters(monkeypatch):
    from ompi_tpu_torch.mpi import trace

    ctx = _ctx(_train_trace())
    monkeypatch.setitem(trace.counters, "moe_tokens_routed_total", 0)
    monkeypatch.setitem(trace.counters, "moe_tokens_dropped_total", 0)
    assert _read("moe_drop_share.train", ctx) is None      # a dense cell
    monkeypatch.setitem(trace.counters, "moe_tokens_routed_total", 4000)
    monkeypatch.setitem(trace.counters, "moe_tokens_dropped_total", 100)
    assert _read("moe_drop_share.train", ctx) == pytest.approx(2.5)
    assert _read("moe_drop_share.train", _ctx([], kind="decode")) is None


def test_drop_share_without_the_programs_counters(monkeypatch):
    """A program whose flight recorder lacks the counters reads nothing."""
    from ompi_tpu_torch.mpi import trace

    monkeypatch.setattr(trace, "counters_snapshot", lambda: {
        "pml_zero_copy_sends_total": 3})
    assert _read("moe_drop_share.train", _ctx(_train_trace())) is None
