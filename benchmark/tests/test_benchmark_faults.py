"""The timed path broken underneath the harness: each fault a cell can
have makes ``correct`` come out false, and the control (the reference
in float8 in the program's place) reads above the program at a size the
CPU holds."""

from __future__ import annotations

import pytest

from benchmark import checks, faults

from .test_benchmark_result import run_cell


@pytest.mark.parametrize("cell", ["tiny-train", "tiny-moe-train"])
@pytest.mark.parametrize("fault", faults.TRAIN)
def test_training_faults_fail(tiny, cell, fault):
    with faults.planted("train", fault):
        line = run_cell(tiny, cell)
    assert line["correct"] is False, line["checks"]


@pytest.mark.parametrize("fault", faults.DECODE)
def test_serving_faults_fail(tiny, fault):
    with faults.planted("decode", fault):
        line = run_cell(tiny, "tiny-decode")
    assert line["correct"] is False, line["checks"]


@pytest.mark.parametrize("seed", [11, 12, 13])
def test_training_control_reads_above_the_program(tiny, seed):
    import torch

    sess = tiny.kind("train").Session(tiny.cell("tiny-train"), seed,
                                      torch.device("cpu"))
    sess.setup()
    sess.free()
    ref = sess.reference()
    sound = checks.train_numbers(sess.program, ref)
    control = checks.train_numbers(sess.reference("fp8"), ref)
    assert any(control[k] > 2 * sound[k] for k in sound), (sound, control)


@pytest.mark.parametrize("seed", [11, 12, 13])
def test_serving_control_reads_above_the_program(tiny, seed):
    import time

    import torch

    sess = tiny.kind("decode").Session(tiny.cell("tiny-decode"), seed,
                                       torch.device("cpu"))
    sess.setup(warm=False)
    sess.window(0.0, time.perf_counter())
    sess.outcome()
    sess.free()
    sound = sess.check()["served_logit_gap"]
    tokens, _ = sess.judged()
    ref = sess.reference_logits(tokens)
    first = sess.reference_logits(tokens, "fp8").argmax(dim=-1)
    assert checks.served_gap(ref, first) > 2 * sound
