"""A whole run at a size the CPU holds, with the look for a card skipped:
the last line's keys, both kinds of run, and the refusals."""

from __future__ import annotations

import importlib.util
import json
import os
import shutil
import subprocess
import sys

import pytest

from .conftest import REAL, ROOT

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def _run_module():
    spec = importlib.util.spec_from_file_location(
        "benchmark_run_under_test", os.path.join(REAL, "run.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_cell(bench, cell: str, seed: int = 2 ** 31 + 11, trace: int = 0,
             seconds: float = 0.5) -> dict:
    return _run_module().run(
        ["--workload", cell, "--seed", str(seed), "--seconds", str(seconds),
         "--trace", str(trace)], device="cpu", bench=bench)


@pytest.mark.parametrize("cell", ["tiny-train", "tiny-moe-train",
                                  "tiny-decode"])
def test_untraced_line(tiny, cell):
    line = run_cell(tiny, cell)
    assert list(line)[:5] == KEYS and list(line)[-1] == "checks"
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] >= 1 and line["failed"] == 0
    rate = ("decode_tokens_per_s" if "decode" in cell
            else "train_tokens_per_s")
    assert set(line["metrics"]) == {"setup_s", "peak_mem_gib", rate}
    assert line["metrics"][rate]["value"] > 0
    assert set(line["device"]) == {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]
    json.dumps(line, allow_nan=False)


@pytest.mark.parametrize("cell", ["tiny-train", "tiny-decode"])
def test_traced_line(tiny, cell):
    line = run_cell(tiny, cell, trace=1)
    assert line["correct"] is True
    assert {"busy_s", "window_s"} <= set(line["device"])
    assert line["device"]["window_s"] > 0
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert len(line["breakdown"]["idle_gaps"]) <= 10
    # on the CPU no reader finds device work: nothing is reported as 0
    for m in line["metrics"].values():
        assert m["value"] != 0
    assert list(line)[-1] == "checks"


def test_the_same_seed_gives_the_same_check(tiny):
    a = run_cell(tiny, "tiny-train", seed=7)
    b = run_cell(tiny, "tiny-train", seed=7)
    assert a["checks"] == b["checks"]


def _cli(cwd: str) -> subprocess.CompletedProcess:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "dense-train-b32s1024", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=cwd, env=env, capture_output=True, text=True,
        timeout=300)


def test_no_card_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal is for a machine "
                    "without one")
    proc = _cli(ROOT)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
    assert "no CUDA device" in proc.stderr


def test_no_program_no_result(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(REAL, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns(".pycache", ".cache",
                                                  "__pycache__"))
    proc = _cli(str(tmp_path))
    assert proc.returncode != 0 and proc.stdout.strip() == ""
