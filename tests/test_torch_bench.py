"""The port's benchmark tool (``ompi_tpu_torch/tools/bench.py``) on the
CPU, against the repo's ``bench.py``.

- The CPU cases of ``tests/test_bench_probe.py``: the decode row, the HBM
  copy row and the counter snapshot (the six keys that test names, as
  ints, and every key of ``bench._counters_snapshot()``).
- The headline's configuration is the reference's: with both packages'
  timing loops replaced by one that records its arguments and returns a
  fixed (dt, n, loss), the CPU branches pass the same config fields, the
  same tokens, chain and outer, and give the same record fields (the
  metric string aside); the card's branch passes the reference's
  non-CPU configuration.
- ``run_matrix`` runs the reference's 12 rows in its order; a raising row
  lands as an ``error`` row, and ``main()`` prints exactly one JSON line.
- The decode row's greedy tokens at the CPU config are the reference
  row's (JAX's ``make_decoder``), exactly, in f32.
- ``remote_dma`` is ``correct``; ``flash_bwd_kernel`` restores
  ``ops_flash_bwd_kernel`` and gives finite gradients.
- The device-plane rows run once over 2 gloo ranks (``tpurun``) and give
  numbers, not the one-card note.
- Without ``--cpu`` and without a card the tool prints one error record
  and runs no row; the tuner's row writes no rules file at one rank.
"""

from __future__ import annotations

import hashlib
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from ompi_tpu_torch.core.config import var_registry
from ompi_tpu_torch.tools import bench as P
from ompi_tpu_torch.tools import mfu_sweep

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import bench  # noqa: E402  (the reference's bench.py)

CPU = P.Devices(n=1, platform="cpu", kind="cpu")
ROWS = ["ring_latency", "shm_pingpong", "shm_msgrate", "hbm_copy",
        "allreduce_sweep", "mesh_bcast_allgather", "grad_reduce_scatter",
        "oshmem_device", "remote_dma", "decode_throughput",
        "flash_bwd_kernel", "tuned_crossovers"]
CFG_FIELDS = ("vocab", "d_model", "n_heads", "n_layers", "d_ff", "seq",
              "attention", "ce_chunk", "compute_dtype", "remat")
#: what both packages' timing loops return in the headline tests
FIXED = (0.25, 123_456, 7.5)


def test_decode_throughput_row_cpu():
    row = P.matrix_decode_throughput(CPU)
    assert row["unit"] == "tokens/s"
    assert row["value"] > 0
    assert "decode" in row["metric"]
    assert ("ms_per_token" in row) or ("suspect" in row)
    assert len(row["reps_lo_s"]) == len(row["reps_hi_s"]) == 2


def test_hbm_copy_row_cpu():
    row = P.matrix_hbm_copy(CPU)
    assert row["unit"] == "GiB/s"
    assert row["value"] > 0
    assert row["iters"] == [2, 10]


def test_counter_snapshot_serializes_one_line():
    snap = P._counters_snapshot()
    assert "error" not in snap, snap
    for key in ("pml_zero_copy_sends_total", "pml_packed_sends_total",
                "convertor_plan_single_total", "convertor_plan_runs_total",
                "btl_shm_publish_total", "convertor_pack_calls_total"):
        assert isinstance(snap[key], int)
    assert set(bench._counters_snapshot()) <= set(snap)
    line = json.dumps(snap)
    assert "\n" not in line
    assert json.loads(line) == snap


def _capture(into: list):
    def loop(cfg, mesh, tokens, chain, outer, *rest):
        into.append((cfg, np.asarray(tokens), chain, outer))
        return FIXED
    return loop


def _headlines(monkeypatch):
    """(reference record, port record, reference call, port call) of the
    CPU branches."""
    import jax

    ref, mine = [], []
    monkeypatch.setattr(bench, "_time_train_loop", _capture(ref))
    monkeypatch.setattr(mfu_sweep, "time_train_loop", _capture(mine))
    assert jax.devices()[0].platform == "cpu"
    rec_ref = bench.bench_flagship_mfu("cpu")
    rec = P.bench_flagship_mfu("cpu", cpu=True)
    return rec_ref, rec, ref[0], mine[0]


def test_headline_cpu_branch_is_the_references(monkeypatch):
    rec_ref, rec, (jcfg, jtok, jchain, jouter), (cfg, tok, chain, outer) = (
        _headlines(monkeypatch))
    assert {f: getattr(cfg, f) for f in CFG_FIELDS} == {
        f: getattr(jcfg, f) for f in CFG_FIELDS}
    assert tok.dtype == jtok.dtype == np.int32
    np.testing.assert_array_equal(tok, jtok)
    assert (chain, outer) == (jchain, jouter) == (2, 1)
    assert {k: v for k, v in rec_ref.items() if k != "metric"} == {
        k: rec[k] for k in rec_ref if k != "metric"}
    assert rec["params"] == FIXED[1] and rec["value"] == 0.0


def test_headline_card_branch_is_the_references(monkeypatch):
    """The reference's non-CPU branch (its platform faked, its mesh and
    loop stubbed) passes the port's card configuration."""
    import jax

    import ompi_tpu.parallel.mesh as jmesh

    class Tpu:
        platform = "tpu"

    calls = []
    monkeypatch.setattr(bench, "_time_train_loop", _capture(calls))
    monkeypatch.setattr(jax, "devices", lambda: [Tpu()])
    monkeypatch.setattr(jmesh, "make_mesh", lambda *a, **k: None)
    bench.bench_flagship_mfu("TPU v5 lite")
    jcfg, jtok, jchain, jouter = calls[0]
    base, batch, chain, outer = P._flagship_config(on_cpu=False)
    assert base == {f: getattr(jcfg, f) for f in base}
    assert (jcfg.compute_dtype, jcfg.remat) == ("bfloat16", "dots")
    assert (batch, base["seq"]) == jtok.shape == (16, 1024)
    assert (chain, outer) == (jchain, jouter) == (32, 1)
    np.testing.assert_array_equal(np.random.default_rng(0).integers(
        0, base["vocab"], size=(batch, base["seq"])).astype(np.int32), jtok)


def _stub(name):
    def row(*_a, **_k):
        if name == "shm_msgrate":
            raise ValueError("planted")
        return {"metric": name, "value": 1.0, "unit": "x",
                "vs_baseline": 1.0}
    return row


def _stub_matrix(monkeypatch, module, tmp_path):
    for name in ROWS:
        monkeypatch.setattr(module, f"matrix_{name}", _stub(name))
    monkeypatch.setattr(module, "_MATRIX_PATH", str(tmp_path / "m.json"))


def test_matrix_lists_the_references_rows_in_order(monkeypatch, tmp_path):
    import jax

    _stub_matrix(monkeypatch, bench, tmp_path / "ref")
    (tmp_path / "ref").mkdir()
    ref = bench.run_matrix(jax.devices(), "cpu")
    _stub_matrix(monkeypatch, P, tmp_path)
    mine = P.run_matrix(CPU, "cpu")
    assert [r["config"] for r in mine] == [r["config"] for r in ref] == ROWS
    bad = mine[ROWS.index("shm_msgrate")]
    assert bad["unit"] == "error" and "planted" in bad["error"]
    assert json.loads((tmp_path / "m.json").read_text()) == mine


def test_main_prints_one_json_line(monkeypatch, tmp_path, capsys):
    _stub_matrix(monkeypatch, P, tmp_path)
    monkeypatch.setattr(P, "_flagship_guarded", lambda kind, cpu: {
        "metric": "flagship", "value": 0.0, "unit": "% MFU",
        "vs_baseline": 0.0})
    monkeypatch.setattr(P, "_arm_signal_record", lambda: None)
    monkeypatch.setattr(P, "_disarm_signal_record", lambda: None)
    assert P.main(["--cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 1
    rec = json.loads(out[0])
    assert rec["backend"] == "cpu" and rec["n_devices"] == 1
    assert [r["config"] for r in rec["matrix"]] == ROWS
    assert [r["config"] for r in rec["matrix"] if "error" in r] == [
        "shm_msgrate"]
    assert "pml_zero_copy_sends_total" in rec["counters"]


def test_decode_tokens_equal_the_reference_rows(monkeypatch):
    """The reference row's decoders (JAX's ``make_decoder``) are wrapped
    to keep their last output; its ``hi`` tokens digest to the port
    row's ``tokens_sha256``."""
    import jax

    import ompi_tpu.models.decode as jdecode

    made, outs = [], {}
    real = jdecode.make_decoder

    def keep(cfg, mesh, max_new, **kw):
        made.append((cfg, max_new))
        dec = real(cfg, mesh, max_new=max_new, **kw)

        def run(params, prompt):
            out = dec(params, prompt)
            outs[max_new] = (np.asarray(prompt), np.asarray(out))
            return out
        return run

    monkeypatch.setattr(jdecode, "make_decoder", keep)
    bench.matrix_decode_throughput(jax.devices())
    cfg, batch, prompt_len, lo, hi = P._decode_case(on_card=False)
    assert [m for _, m in made] == [lo, hi]
    assert {f: getattr(made[0][0], f) for f in CFG_FIELDS} == {
        f: getattr(cfg, f) for f in CFG_FIELDS}
    prompt, want = outs[hi]
    np.testing.assert_array_equal(prompt,
                                  P._decode_prompt(cfg, batch, prompt_len))
    row = P.matrix_decode_throughput(CPU)
    assert row["tokens_sha256"] == hashlib.sha256(
        want.astype(np.int32).tobytes()).hexdigest()


def test_remote_dma_row_is_correct_on_the_cpu():
    row = P.matrix_remote_dma(CPU)
    assert row["correct"] is True
    assert row["shape"] == [1 << 13] and row["value"] > 0


@pytest.mark.parametrize("before", [False, True])
def test_flash_bwd_row_restores_the_variable(before):
    P.flagship.flash_module()
    var_registry.set("ops_flash_bwd_kernel", before)
    try:
        row = P.matrix_flash_bwd_kernel(CPU)
        assert var_registry.get("ops_flash_bwd_kernel") is before
    finally:
        var_registry.set("ops_flash_bwd_kernel", False)
    assert row["grads_finite"] is True
    assert row["shape"] == [2, 512, 4, 128] and row["unit"] == "ms"
    # on the CPU the wrappers run their plain versions: no launch
    assert row["launches"] == {"flash_fwd": 0, "flash_bwd_dq": 0,
                               "flash_bwd_dkv": 0}


def test_device_plane_rows_run_over_two_gloo_ranks():
    devices = P.Devices(n=2, platform="cpu", kind="cpu")
    devices.plane = P._device_plane_job(devices)
    busbw = P.bench_allreduce_busbw(devices)
    assert "2 ranks" in busbw["metric"] and busbw["value"] > 0
    rows = {"allreduce_sweep": P.matrix_allreduce_sweep(devices),
            "mesh_bcast_allgather": P.matrix_mesh_bcast_allgather(devices),
            "grad_reduce_scatter": P.matrix_grad_reduce_scatter(devices),
            "oshmem_device": P.matrix_oshmem_device(devices)}
    for name, row in rows.items():
        assert "note" not in row, name
        assert row["value"] > 0, (name, row)
        assert row["unit"] == "GiB/s"
    sweep = rows["allreduce_sweep"]["device_path"]
    assert set(sweep) == {"4KiB", "1MiB", "64MiB"}
    assert all(r["us"] > 0 for r in sweep.values())
    assert set(rows["allreduce_sweep"]["host_path_4rank"]) == {
        "4B", "4KiB", "1MiB"}
    assert rows["mesh_bcast_allgather"]["metric"].startswith(
        "Bcast+Allgather 2D mesh (1, 2)")
    tuned = P.matrix_tuned_crossovers(devices, "cpu")
    assert tuned["meta"]["n_devices"] == "2"
    assert tuned["shipped"] == "no (cpu)"


def test_one_card_rows_carry_the_note():
    for fn in (P.matrix_mesh_bcast_allgather, P.matrix_grad_reduce_scatter,
               P.matrix_oshmem_device):
        row = fn(CPU)
        assert row["value"] == 0.0 and row["note"] == P._ONE_CHIP_NOTE


def test_without_a_card_one_error_record_and_no_row():
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("OMPI_TPU_BENCH_")}
    r = subprocess.run([sys.executable, "-m", "ompi_tpu_torch.tools.bench"],
                       capture_output=True, text=True, timeout=240, cwd=ROOT,
                       env={**env, "OMPI_TPU_BENCH_PROBE_PAUSE": "0"})
    assert r.returncode == 1, r.stderr[-2000:]
    lines = r.stdout.splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert rec["unit"] == "error" and "no CUDA card" in rec["error"]
    assert "matrix" not in rec
    assert [a["outcome"][:7] for a in rec["probe_attempts"]] == ["no CUDA"]
    assert "matrix[" not in r.stderr


def test_tuner_row_writes_no_file_at_one_rank(monkeypatch, tmp_path):
    from ompi_tpu_torch.parallel.mesh import make_mesh
    from ompi_tpu_torch.tools import tune

    coll = ROOT / "ompi_tpu_torch" / "mpi" / "coll"
    before = sorted(p.name for p in coll.iterdir())
    out = tmp_path / "rules.conf"
    monkeypatch.setattr(tune, "DEFAULT_OUT", str(out))
    monkeypatch.setattr(tune, "DEFAULT_SIZES", (1 << 10,))
    for platform in ("gpu", "cpu"):
        row = P._tune_row(make_mesh(device="cpu"), 1, platform)
        assert row["shipped"].startswith("no"), row["shipped"]
        assert row["value"] == 0 and row["rules"] == []
        assert row["meta"]["n_devices"] == "1"
    assert not out.exists()
    assert sorted(p.name for p in coll.iterdir()) == before
    row = P.matrix_tuned_crossovers(CPU, "cpu")
    assert row["shipped"] == "no (cpu)" and not out.exists()


def test_timing_keeps_every_repeat_and_the_collapse_rule():
    x = torch.zeros(4)
    dt, extra = P._slope_or_bound(P._loop_maker(lambda y: y), x, 2, 6)
    assert extra["iters"] == [2, 6]
    assert len(extra["reps_lo_s"]) == len(extra["reps_hi_s"]) == 2
    assert P._slope_fields(1.0, 1.01, 2, 6) == bench._slope_fields(
        1.0, 1.01, 2, 6)
    assert P._slope_fields(1.0, 3.0, 2, 6) == bench._slope_fields(
        1.0, 3.0, 2, 6)
    assert P._loop_iters("gpu") == (4, 20) and P._loop_iters("cpu") == (2, 6)
    row = {"unit": "GiB/s", "value": 1.0}
    assert "suspect" in P._flag_suspect(dict(row), "gpu")
    assert "suspect" not in P._flag_suspect(dict(row), "cpu")
