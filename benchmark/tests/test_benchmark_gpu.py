"""The tiny cells through the harness on the card: the port's kernels
run, ``correct`` holds, and a traced run's readers find device work."""

from __future__ import annotations

import pytest

from .test_benchmark_result import _run_module

pytestmark = pytest.mark.gpu


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


@pytest.mark.parametrize("cell", ["tiny-train", "tiny-moe-train",
                                  "tiny-decode"])
def test_tiny_cells_on_the_card(tiny, card, cell):
    run = _run_module().run
    argv = ["--workload", cell, "--seed", "3000000019", "--seconds", "1"]
    line = run(argv + ["--trace", "0"], device=card, bench=tiny)
    assert line["correct"] is True, line["checks"]
    assert line["device"]["platform"] == "gpu"
    traced = run(argv + ["--trace", "1"], device=card, bench=tiny)
    assert traced["correct"] is True, traced["checks"]
    assert 0 < traced["device"]["busy_s"] <= traced["device"]["window_s"]
    for name, m in traced["metrics"].items():
        assert m["value"] > 0, name
        if name.startswith(("mfu", "attn_fwd_roofline")):
            assert m["value"] <= 105, name
    assert "device_idle_share." + ("decode" if "decode" in cell
                                   else "train") in traced["metrics"]
