"""The manifest, and finding each cell's files by name: the committed
ones, and ones dropped in beside them."""

from __future__ import annotations

import json
import os
import re

import pytest

from benchmark import core

from .conftest import REAL, ROOT
from .test_benchmark_result import run_cell

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}


def _manifest():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_manifest_keys_and_names():
    m = _manifest()
    assert set(m) == TOP
    assert m["paths"] == ["benchmark"]
    assert m["command"] == ["python3", "benchmark/run.py"]
    names = [x["name"] for sec in ("configs", "workloads", "end_to_end",
                                   "per_layer") for x in m[sec]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for w in m["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and 0 < len(w["why"]) <= 200
    pairs = [(w["config"], w["traffic"]) for w in m["workloads"]]
    assert len(pairs) == len(set(pairs))
    for c in m["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"] == f"benchmark/configs/{c['name']}.json"
        assert any(w["config"] == c["name"] for w in m["workloads"])


def test_metrics_follow_the_manifest_rules():
    m = _manifest()
    cells = {w["name"] for w in m["workloads"]}
    e2e = {x["name"]: x for x in m["end_to_end"]}
    assert set(e2e) == {"setup_s", "train_tokens_per_s",
                        "decode_tokens_per_s", "peak_mem_gib"}
    for x in m["end_to_end"]:
        assert 0.01 <= x["bound"] <= 0.25 and UNIT.match(x["unit"])
        assert x["source"] in ("host_clock", "device_trace")
    for x in m["per_layer"]:
        assert set(x) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert x["moves"] in e2e and UNIT.match(x["unit"])
        for cell in x["workloads"]:
            assert cell in cells
            assert cell in e2e[x["moves"]].get("workloads", [cell])
    for cell in cells:
        reported = [x for x in m["end_to_end"]
                    if cell in x.get("workloads", [cell])]
        assert "setup_s" in [x["name"] for x in reported]
        assert len(reported) >= 2
        assert any(cell in x["workloads"] for x in m["per_layer"])


def test_run_seconds_fit_the_full_check():
    m = _manifest()
    runs = 2 + 14 * 24
    assert runs * (m["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_every_cell_finds_its_files():
    bench = core.Bench(REAL)
    for w in bench.manifest["workloads"]:
        cell = bench.cell(w["name"])
        assert cell.config["name"] == w["config"]
        assert cell.limits["limits"]
        gen = bench.kind(cell.mix["kind"])
        assert gen.Session.RATE in {x["name"] for x in bench.metrics(
            "end_to_end", cell.name)}
    for x in bench.manifest["per_layer"]:
        assert callable(bench.reader(x["name"]))


def test_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        core.Bench(REAL).cell("no-such-cell")


def test_a_dropped_in_config_mix_cell_and_metric_are_found(tiny):
    here = tiny.here
    with open(os.path.join(here, "configs", "tiny-dense.json")) as f:
        config = json.load(f)
    config["name"] = "tiny-wide"
    config["model"]["d_ff"] = 256
    for sub, name, obj in (
            ("configs", "tiny-wide", config),
            ("traffic", "tiny-train-b2", {"kind": "train", "batch": 2,
                                          "seq": 64, "corpus_tokens": 1024,
                                          "checked_steps": 3,
                                          "traced_steps": 1}),
            ("workloads", "tiny-wide-train", {"limits": {
                "loss_gap": 1, "grad_norm_gap": 1, "change_norm_gap": 1,
                "grad_diff": 1}})):
        with open(os.path.join(here, sub, name + ".json"), "w") as f:
            json.dump(obj, f)
    with open(os.path.join(here, "metrics", "tokens.dropped.py"), "w") as f:
        f.write("def read(ctx):\n    return float(ctx.work[\"tokens\"]) / "
                "ctx.work[\"steps\"]\n")
    path = os.path.join(os.path.dirname(here), "BENCHMARK.json")
    with open(path) as f:
        manifest = json.load(f)
    manifest["workloads"].append({"name": "tiny-wide-train",
                                  "config": "tiny-wide",
                                  "traffic": "tiny-train-b2", "chips": 1,
                                  "why": "dropped in"})
    manifest["per_layer"].append({"name": "tokens.dropped", "unit": "tokens",
                                  "better": "higher",
                                  "source": "program_counter",
                                  "layer": "device",
                                  "moves": "train_tokens_per_s",
                                  "workloads": ["tiny-wide-train"]})
    with open(path, "w") as f:
        json.dump(manifest, f)
    bench = core.Bench(here)
    cell = bench.cell("tiny-wide-train")
    assert cell.config["model"]["d_ff"] == 256 and cell.mix["batch"] == 2
    assert [x["name"] for x in bench.metrics("per_layer", cell.name)] == [
        "tokens.dropped"]
    line = run_cell(bench, "tiny-wide-train", trace=1)
    assert line["correct"] is True
    assert line["metrics"]["tokens.dropped"]["value"] == 2 * 64


def test_limits_lie_between_their_readings():
    bench = core.Bench(REAL)
    for w in bench.manifest["workloads"]:
        lim = bench.cell(w["name"]).limits
        assert lim["limits"], w["name"]
        for name, limit in lim["limits"].items():
            r = lim["readings"][name]
            assert r["lower"] < limit < r["upper"], (w["name"], name)
            assert limit / r["lower"] > r["upper"] / limit, (w["name"], name)
            assert len(r["program_seeds"]) >= 12, (w["name"], name)
