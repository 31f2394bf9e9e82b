"""The port's MFU sweep (``ompi_tpu_torch/tools/mfu_sweep.py``) on the CPU,
against the repo's ``tools/mfu_sweep.py`` and ``bench._time_train_loop``.

- ``GRID`` and ``QUICK`` are the reference's, row for row (labels,
  configs, budgets), read with ``ast``: importing the reference runs
  ``bench._enable_compile_cache()``.
- The timing loop at ``flagship.SMALL``'s widths with f32 compute, chain
  2, outer 1, gives ``bench._time_train_loop``'s parameter count and
  last loss on JAX's CPU within 1e-4 relative (measured: equal).
- A row's child (``--cpu --small``) prints the reference's record keys
  and the flash kernels' launches, with no MFU off the card, and
  ``--layers`` cuts its depth; a timed-out
  child and a child without a card give the reference's ``error``
  records; an unknown label exits non-zero with the reference's message.
- At small f32 widths, configs that differ only in attention (flash,
  xla), remat (dots, none, full), ``ce_chunk`` or
  ``ops_flash_bwd_kernel`` give the same last loss within
  ``SAME_LOSS_RTOL`` (measured: equal): they compute one function.
- ``chip_smoke.py``'s ``SWEEP_LOSS_RTOL`` (1e-2), both ways, on the rows
  phase ``sweep`` compares (``SWEEP_SAME``) at ``--small`` in bf16, 24
  steps each: the three rows' losses spread by less (measured 1.7e-3),
  and a ``-pbwd`` row whose dq is zero, scaled by the softmax scale a
  second time or negated moves its loss by more (measured 2.0e-2,
  1.5e-2, 0.33).  On the card (``gpu``) a zero dq at the flagship's
  widths must move the row's loss past the limit as well.
- A row runs the flash backward kernels only where its ``_mca`` asks.
"""

from __future__ import annotations

import ast
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from ompi_tpu_torch.core.config import var_registry
from ompi_tpu_torch.parallel.mesh import make_mesh
from ompi_tpu_torch.tools import flagship
from ompi_tpu_torch.tools import mfu_sweep as M

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as C  # noqa: E402  (its sweep limits; imports no JAX)

LOOP_RTOL = 1e-4
SAME_LOSS_RTOL = 1e-5
#: the reference child's record keys (tools/mfu_sweep.py CHILD, run_one)
ROW_KEYS = {"label", "batch", "backend", "mfu_pct", "step_ms",
            "tokens_per_s", "loss", "params", "import_s", "wall_s"}
#: matmul_peak's (tools/mfu_sweep.py MATMUL_PEAK)
PEAK_KEYS = {"label", "n", "iters", "ms", "dispatch_rt_ms", "wall_lo_s",
             "wall_hi_s", "tflops", "pct_of_peak", "peak_tflops", "backend"}


def _reference_literals() -> dict:
    tree = ast.parse((ROOT / "tools" / "mfu_sweep.py").read_text())
    out = {}
    for node in tree.body:
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and node.targets[0].id in ("GRID", "_QUICK_LABELS")):
            out[node.targets[0].id] = ast.literal_eval(node.value)
    return out


REF = _reference_literals()


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The small models on one CPU thread, here and in the children:
    beside other test workers more threads only wait on each other (the
    losses are the same)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def registry():
    """Rows set MCA variables in this process's registry: put them back."""
    flagship.flash_module()             # registers the ops_* variables
    names = ("ops_flash_bwd_kernel", "ops_flash_block_q",
             "ops_flash_block_k")
    before = {n: var_registry.get(n) for n in names}
    yield
    for n, v in before.items():
        var_registry.set(n, v)


def test_grid_has_the_references_rows_in_its_order():
    assert len(REF["GRID"]) == 30
    assert [r[0] for r in M.GRID] == [r[0] for r in REF["GRID"]]
    assert M._QUICK_LABELS == REF["_QUICK_LABELS"]
    assert M.QUICK == [r for r in REF["GRID"]
                       if r[0] in REF["_QUICK_LABELS"]]


@pytest.mark.parametrize("row", REF["GRID"], ids=[r[0] for r in REF["GRID"]])
def test_row_equals_the_references(row):
    mine = {label: (cfg, budget) for label, cfg, budget in M.GRID}
    assert mine[row[0]] == (row[1], row[2])
    assert json.dumps(mine[row[0]]) == json.dumps((row[1], row[2]))


def _small_f32(attention: str = "flash", **fields):
    from ompi_tpu_torch.models.transformer import TransformerConfig

    return TransformerConfig(**{**flagship.SMALL, "remat": "dots",
                                **fields}, attention=attention,
                             compute_dtype="float32")


def _tokens(cfg) -> np.ndarray:
    return np.random.default_rng(0).integers(
        0, cfg.vocab, size=(flagship.SMALL_BATCH, cfg.seq)).astype(np.int32)


@pytest.mark.parametrize("attention", ["flash", "xla"])
def test_timing_loop_matches_bench(attention):
    import jax
    from bench import _time_train_loop
    from ompi_tpu.models.transformer import TransformerConfig as JaxConfig
    from ompi_tpu.parallel.mesh import make_mesh as jax_mesh

    cfg = _small_f32(attention)
    toks = _tokens(cfg)
    jcfg = JaxConfig(**{f: getattr(cfg, f) for f in (
        "vocab", "d_model", "n_heads", "n_layers", "d_ff", "seq",
        "attention", "ce_chunk", "compute_dtype", "remat")})
    _, n_ref, loss_ref = _time_train_loop(
        jcfg, jax_mesh({"dp": 1, "sp": 1, "tp": 1},
                       devices=jax.devices()[:1]), toks, 2, 1)
    dt, n, loss = M.time_train_loop(
        cfg, make_mesh({"dp": 1, "sp": 1, "tp": 1}, device="cpu"), toks,
        2, 1)
    assert n == n_ref
    assert dt > 0
    assert abs(loss - loss_ref) <= LOOP_RTOL * abs(loss_ref)


@pytest.fixture(scope="module")
def base_loss():
    cfg = _small_f32(ce_chunk=16)
    mesh = make_mesh({"dp": 1, "sp": 1, "tp": 1}, device="cpu")
    return M.time_train_loop(cfg, mesh, _tokens(cfg), 2, 1)[2]


@pytest.mark.parametrize("fields,bwd_kernel", [
    (dict(attention="xla", ce_chunk=16), False),
    (dict(remat=None, ce_chunk=16), False),
    (dict(remat="full", ce_chunk=16), False),
    (dict(ce_chunk=0), False),
    (dict(ce_chunk=32), False),
    (dict(ce_chunk=16), True),
], ids=["xla", "noremat", "full", "chunk0", "chunk32", "bwd-kernel"])
def test_paths_give_the_same_loss(fields, bwd_kernel, base_loss, registry):
    var_registry.set("ops_flash_bwd_kernel", bwd_kernel)
    cfg = _small_f32(**fields)
    mesh = make_mesh({"dp": 1, "sp": 1, "tp": 1}, device="cpu")
    loss = M.time_train_loop(cfg, mesh, _tokens(cfg), 2, 1)[2]
    assert abs(loss - base_loss) <= SAME_LOSS_RTOL * abs(base_loss)


def _sweep(*args, timeout=300):
    return subprocess.run([sys.executable, "-m",
                           "ompi_tpu_torch.tools.mfu_sweep", *args],
                          capture_output=True, text=True, timeout=timeout,
                          cwd=ROOT, env=dict(os.environ, OMP_NUM_THREADS="1"))


def _records(out: str) -> list:
    return [json.loads(ln.split(": ", 1)[1]) for ln in out.splitlines()
            if ln.startswith("[sweep] ") and ": {" in ln]


def test_child_prints_the_reference_record(tmp_path):
    out = tmp_path / "sweep.jsonl"
    r = _sweep("--cpu", "--small", "--out", str(out), "b16-chunk128-dots")
    assert r.returncode == 0, r.stderr[-2000:]
    (rec,) = _records(r.stdout)
    assert ROW_KEYS | {"ce_chunk", "remat", "attention"} <= set(rec)
    assert rec["label"] == "b16-chunk128-dots"
    assert (rec["ce_chunk"], rec["remat"], rec["attention"]) == (
        128, "dots", "flash")
    assert rec["backend"] == "cpu" and rec["mfu_pct"] is None
    assert rec["batch"] == flagship.SMALL_BATCH
    assert rec["params"] > 0 and np.isfinite(rec["loss"])
    assert rec["step_ms"] > 0 and rec["tokens_per_s"] > 0
    # on the CPU the wrappers run their plain versions
    assert rec["flash_launches"] == {"flash_fwd": 0, "flash_bwd_dq": 0,
                                     "flash_bwd_dkv": 0}
    assert [json.loads(ln) for ln in out.read_text().splitlines()] == [rec]


def test_rows_run_one_after_another_and_append(tmp_path):
    """Two rows, the second's child started while the first runs: both
    records, in order, in the output file; the calibration row has the
    reference's keys."""
    out = tmp_path / "sweep.jsonl"
    r = _sweep("--cpu", "--small", "--out", str(out), "matmul_peak",
               "b16-flash-bq256")
    assert r.returncode == 0, r.stderr[-2000:]
    peak, block = _records(r.stdout)
    assert PEAK_KEYS <= set(peak)
    assert peak["n"] == M.MATMUL_SMALL_N and peak["iters"] == [8, 72]
    assert peak["tflops"] > 0 and peak["pct_of_peak"] is None
    assert block["note"] == M.BLOCK_NOTE
    assert block["mca"] == {"ops_flash_block_q": 256,
                            "ops_flash_block_k": 256}
    assert [json.loads(ln)["label"] for ln in
            out.read_text().splitlines()] == ["matmul_peak",
                                              "b16-flash-bq256"]


def test_block_rows_time_the_same_function(registry):
    """The block variables are a tiling rule in the port: the row's loss
    is the one without them."""
    row = dict(next(cfg for label, cfg, _ in M.GRID
                    if label == "b16-flash-bk512"), chain=2)
    plain = M.run_row({k: v for k, v in row.items() if k != "_mca"},
                      cpu=True, small=True)
    rec = M.run_row(row, cpu=True, small=True)
    assert var_registry.get("ops_flash_block_k") == 512
    assert rec["note"] == M.BLOCK_NOTE and "note" not in plain
    assert rec["loss"] == plain["loss"]


def test_timed_out_child_gives_the_error_record():
    rec = M.run_one("b16-chunk128-dots", dict(M.GRID[1][1]), 0.5, cpu=True,
                    small=True)
    assert rec["error"] == "timeout after 0.5s"
    assert set(rec) == {"label", "error", "wall_s"}


def test_unknown_label_exits_non_zero():
    r = _sweep("no-such-row")
    assert r.returncode != 0
    assert "unknown row(s) ['no-such-row']; known: [" in r.stderr


def test_without_cpu_a_row_fails_where_there_is_no_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks a machine without CUDA")
    out = tmp_path / "sweep.jsonl"
    r = _sweep("--small", "--out", str(out), "b16-chunk128-dots")
    assert r.returncode == 1
    (rec,) = _records(r.stdout)
    assert rec["error"] == "no result" and rec["rc"] != 0
    assert "CUDA is not available" in rec["stderr_tail"]
    assert "loss" not in rec


def test_config_takes_a_rows_fields():
    cfg, batch = flagship.config(None, 8, seq=2048, ce_chunk=512,
                                 remat=None, attention="xla",
                                 adam_mu_dtype="bfloat16",
                                 param_dtype="bfloat16", grad_accum=2)
    assert (cfg.seq, cfg.ce_chunk, cfg.remat, cfg.attention) == (
        2048, 512, None, "xla")
    assert (cfg.adam_mu_dtype, cfg.param_dtype, cfg.grad_accum) == (
        "bfloat16", "bfloat16", 2)
    assert (cfg.d_model, cfg.n_layers, batch) == (2048, 8, 8)
    # the tools' step is unchanged
    cfg, batch = flagship.config()
    assert (cfg.attention, cfg.remat, cfg.compute_dtype, cfg.seq,
            cfg.ce_chunk, batch) == ("flash", "dots", "bfloat16", 1024, 256,
                                     16)
    # a small run keeps its sequence; a depth cut keeps the row's
    assert flagship.config(flagship.SMALL, 2, seq=4096)[0].seq == 64
    cut, _ = flagship.config(flagship.cut(None, 1), 4, seq=4096)
    assert (cut.seq, cut.n_layers, cut.d_model, cut.d_ff) == (
        4096, 1, 2048, 8192)
    with pytest.raises(ValueError, match="not a row field"):
        flagship.config(None, 8, d_model=64)


def test_layers_cut_a_rows_depth(tmp_path):
    """``--layers 1`` reaches the child: one layer of flagship.SMALL's
    two, one layer's parameters fewer, the widths and batch kept."""
    out = tmp_path / "sweep.jsonl"
    r = _sweep("--cpu", "--small", "--layers", "1", "--out", str(out),
               "b16-chunk128-dots")
    assert r.returncode == 0, r.stderr[-2000:]
    (rec,) = _records(r.stdout)
    assert rec["n_layers"] == 1 and flagship.SMALL["n_layers"] == 2
    d, f = flagship.SMALL["d_model"], flagship.SMALL["d_ff"]
    full = M.run_row(dict(M.GRID[1][1], chain=1, outer=1), cpu=True,
                     small=True)
    assert full["n_layers"] == 2
    assert full["params"] - rec["params"] == 4 * d * d + 2 * d * f + 2 * d
    assert (rec["batch"], rec["seq"]) == (full["batch"], full["seq"])
    assert np.isfinite(rec["loss"])


def test_row_runs_the_backward_kernels_only_where_its_mca_asks(registry):
    """build() switches the backward kernels on for the profiling tools;
    a row leaves them off unless its ``_mca`` turns them on."""
    grid = {label: cfg for label, cfg, _ in M.GRID}
    var_registry.set("ops_flash_bwd_kernel", True)
    M.run_row(dict(grid["b16-chunk128-dots"], chain=1, outer=1), cpu=True,
              small=True)
    assert var_registry.get("ops_flash_bwd_kernel") is False
    M.run_row(dict(grid["b16-chunk128-dots-pbwd"], chain=1, outer=1),
              cpu=True, small=True)
    assert var_registry.get("ops_flash_bwd_kernel") is True


def _spread(losses) -> float:
    return (max(losses) - min(losses)) / min(losses)


@pytest.fixture(scope="module")
def bf16_losses():
    """The last loss of each ``SWEEP_SAME`` row at ``--small`` in bf16,
    each row's own chain and outer (24 steps)."""
    flagship.flash_module()
    before = var_registry.get("ops_flash_bwd_kernel")
    grid = {label: cfg for label, cfg, _ in M.GRID}
    try:
        return {label: M.run_row(dict(grid[label]), cpu=True,
                                 small=True)["loss"]
                for label in C.SWEEP_SAME}
    finally:
        var_registry.set("ops_flash_bwd_kernel", before)


def test_bf16_rows_of_one_function_spread_within_the_sweep_limit(
        bf16_losses):
    assert C.SWEEP_LOSS_RTOL == 1e-2
    assert _spread(list(bf16_losses.values())) <= C.SWEEP_LOSS_RTOL


def _wrong_dq(kind: str, reference):
    def run(q3, k3, v3, g3, lse, dm, q_offset, k_offset, scale, causal):
        dq, dk, dv = reference(q3, k3, v3, g3, lse, dm, q_offset, k_offset,
                               scale, causal)
        dq = {"zero": torch.zeros_like(dq), "scaled-twice": dq * scale,
              "negated": -dq}[kind]
        return dq, dk, dv
    return run


@pytest.mark.parametrize("kind", ["zero", "scaled-twice", "negated"])
def test_a_wrong_dq_falls_outside_the_sweep_limit(kind, bf16_losses,
                                                  registry, monkeypatch):
    """The -pbwd row with a faulty dq (on the CPU the backward's plain
    version stands in for the kernels) leaves the limit the honest rows
    keep."""
    fa = flagship.flash_module()
    monkeypatch.setattr(fa, "flash_bwd_reference",
                        _wrong_dq(kind, fa.flash_bwd_reference))
    row = next(cfg for label, cfg, _ in M.GRID
               if label == "b16-chunk128-dots-pbwd")
    loss = M.run_row(dict(row), cpu=True, small=True)["loss"]
    assert _spread([loss, *bf16_losses.values()]) > C.SWEEP_LOSS_RTOL


@pytest.mark.gpu
def test_a_wrong_dq_falls_outside_the_sweep_limit_on_the_card(registry,
                                                              monkeypatch):
    """The -pbwd row at the flagship's widths on the card, then again
    with the dq kernel's output zeroed: the two losses differ by more
    than ``SWEEP_LOSS_RTOL``.  Prints both."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    fa = flagship.flash_module()
    row = next(cfg for label, cfg, _ in M.GRID
               if label == "b16-chunk128-dots-pbwd")
    honest = M.run_row(dict(row), cpu=False, small=False)
    real = fa.flash_bwd_3d

    def zero_dq(*args):
        dq, dk, dv = real(*args)
        return torch.zeros_like(dq), dk, dv

    monkeypatch.setattr(fa, "flash_bwd_3d", zero_dq)
    wrong = M.run_row(dict(row), cpu=False, small=False)
    print("sweep-limit control on the card:", json.dumps(
        {"honest_loss": honest["loss"], "zero_dq_loss": wrong["loss"],
         "spread": _spread([honest["loss"], wrong["loss"]]),
         "limit": C.SWEEP_LOSS_RTOL, "backend": honest["backend"]}))
    assert honest["flash_launches"]["flash_bwd_dq"] > 0
    assert _spread([honest["loss"], wrong["loss"]]) > C.SWEEP_LOSS_RTOL
