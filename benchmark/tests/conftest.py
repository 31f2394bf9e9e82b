"""A benchmark folder at a size the CPU holds: the harness's own code
(the traffic generators and metric readers) beside tiny configurations,
mixes and limits, with a manifest of their own."""

from __future__ import annotations

import json
import os
import shutil
import sys

import pytest

REAL = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(REAL)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

OPT = {"name": "adamw", "lr": 1e-3, "b1": 0.9, "b2": 0.95, "eps": 1e-8,
       "weight_decay": 0.01}


def tiny_model(moe: int = 0) -> dict:
    model = {"vocab": 512, "d_model": 64, "n_heads": 4, "head_dim": 16,
             "n_layers": 2, "d_ff": 128, "moe_experts": moe}
    if moe:
        model.update(moe_capacity_factor=1.25, moe_aux_weight=0.01)
    return model


def tiny_config(name: str, moe: int = 0, dtype: str = "bfloat16") -> dict:
    return {"name": name, "model": tiny_model(moe),
            "train": {"compute_dtype": dtype, "param_dtype": "float32",
                      "attention": "flash", "remat": "dots",
                      "ce_chunk": 32, "optimizer": OPT},
            "serve": {"compute_dtype": dtype, "attention": "flash"},
            "reduced": [], "assumed": []}


TRAIN_MIX = {"kind": "train", "batch": 4, "seq": 64, "corpus_tokens": 4096,
             "checked_steps": 3, "traced_steps": 2}
DECODE_MIX = {"kind": "decode", "batch": 4, "prompt": 16, "new_tokens": 8,
              "checked_requests": 4}
#: limits at this size (bf16 against the f32 reference on the CPU)
TRAIN_LIMITS = {"loss_gap": 1e-2, "grad_norm_gap": 0.05,
                "change_norm_gap": 0.05, "grad_diff": 0.06,
                "route_gap": 0.01}
DECODE_LIMITS = {"served_logit_gap": 0.01}

#: the committed cell each tiny one stands for in the metrics' lists
STANDS_FOR = {"dense-train-b32s1024": "tiny-train",
              "dense-train-b4s4096": "tiny-train",
              "moe-train-b16s1024": "tiny-moe-train",
              "dense-decode-b256": "tiny-decode"}

CELLS = {
    "tiny-train": ("tiny-dense", "tiny-train", TRAIN_LIMITS),
    "tiny-moe-train": ("tiny-moe", "tiny-train", TRAIN_LIMITS),
    "tiny-decode": ("tiny-dense", "tiny-decode", DECODE_LIMITS),
}


def _dump(path: str, obj) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)


def make_tree(root: str) -> str:
    """The tiny folder at ``root``/benchmark; → its path."""
    from benchmark import core

    here = os.path.join(root, "benchmark")
    for sub in ("traffic", "metrics"):
        os.makedirs(os.path.join(here, sub), exist_ok=True)
        for f in os.listdir(os.path.join(REAL, sub)):
            if f.endswith(".py"):
                shutil.copy(os.path.join(REAL, sub, f),
                            os.path.join(here, sub, f))
    _dump(os.path.join(here, "configs", "tiny-dense.json"),
          tiny_config("tiny-dense"))
    _dump(os.path.join(here, "configs", "tiny-moe.json"),
          tiny_config("tiny-moe", moe=4))
    _dump(os.path.join(here, "traffic", "tiny-train.json"), TRAIN_MIX)
    _dump(os.path.join(here, "traffic", "tiny-decode.json"), DECODE_MIX)
    real = core.Bench(REAL).manifest
    workloads = []
    for cell, (config, mix, limits) in CELLS.items():
        _dump(os.path.join(here, "workloads", cell + ".json"),
              {"limits": limits})
        workloads.append({"name": cell, "config": config, "traffic": mix,
                          "chips": 1, "why": "a CPU test"})

    def retarget(metric):
        m = dict(metric)
        if "workloads" in m:
            m["workloads"] = sorted({STANDS_FOR[w] for w in m["workloads"]})
        return m

    manifest = dict(real, workloads=workloads,
                    end_to_end=[retarget(m) for m in real["end_to_end"]],
                    per_layer=[retarget(m) for m in real["per_layer"]])
    _dump(os.path.join(root, "BENCHMARK.json"), manifest)
    return here


@pytest.fixture
def tiny(tmp_path):
    from benchmark import core

    return core.Bench(make_tree(str(tmp_path)))
