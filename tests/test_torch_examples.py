"""The port's copies of the repo's four device- and coll-demo examples
(``ompi_tpu_torch/examples/{shm_coll_demo,osc_device_window,generate,
train}.py``) under the port's ``tpurun``, against the repo's examples.

The reference examples run at one device (``JAX_PLATFORMS=cpu``) with
``PYTHONPATH`` set to the checkout (the reference's own test of its
examples runs them by path without it), under the JAX package's
``tpurun`` where the reference does.  Every run prints the reference's
marker lines:

- ``shm_coll_demo`` (-np 4): each rank's ``coll ok`` line equals the
  JAX package's, word for word, with coll/shm and with coll/host;
- ``osc_device_window`` (3 gloo CPU ranks, the rendezvous passed by
  hand): the window, put and get lines in the reference's words (its
  run has 8 virtual devices, so the device numbers differ), and each
  rank's part as the reference's asserts say;
- ``generate``: the mesh line and both generated rows equal the
  reference's, exactly;
- ``train``: every step's loss equal to the reference's within
  ``tests/test_torch_ckpt.py``'s STEP_TOL (1e-4, relative), the
  checkpoint line, and the resume line.
"""

from __future__ import annotations

import json
import os
import pathlib
import re
import socket
import subprocess
import sys

import numpy as np
import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
STEP_TOL = 1e-4                  # tests/test_torch_ckpt.py
#: one CPU device for the reference (tests/conftest.py exports a
#: virtual 8-device platform in XLA_FLAGS)
ENV = {**{k: v for k, v in os.environ.items() if k != "XLA_FLAGS"},
       "PYTHONPATH": str(ROOT), "JAX_PLATFORMS": "cpu"}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _start(args):
    return subprocess.Popen(args, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, cwd=ROOT,
                            env=ENV)


def _wait(proc, timeout=240) -> list[str]:
    out, err = proc.communicate(timeout=timeout)
    assert proc.returncode == 0, (out + err)[-3000:]
    return [ln.rstrip() for ln in out.splitlines()
            if ln.strip() and "socket.cpp" not in ln]


def _port_job(np_: int, module: str, *args, extra=()):
    return _start([sys.executable, "-m", "ompi_tpu_torch.tools.tpurun",
                   "-np", str(np_), "--no-tag-output", *extra, "--",
                   sys.executable, "-m", f"ompi_tpu_torch.examples.{module}",
                   *args])


def _gloo() -> list:
    return ["-x", f"OMPI_TPU_COORD=127.0.0.1:{_free_port()}",
            "-x", "OMPI_TPU_NHOSTS=1"]


@pytest.mark.parametrize("mca", [(), ("--mca", "coll_shm_enable", "0")],
                         ids=["shm", "host"])
def test_shm_coll_demo_lines_equal_the_reference(mca):
    want = sorted(_wait(_start(
        [sys.executable, "-m", "ompi_tpu.tools.tpurun", "-np", "4",
         "--no-tag-output", *mca, "--", sys.executable,
         str(ROOT / "examples" / "shm_coll_demo.py")])))
    got = sorted(_wait(_port_job(4, "shm_coll_demo", extra=mca)))
    assert got == want
    assert len(got) == 4 and all("coll ok sum=160" in ln for ln in got)
    provider = "host" if mca else "shm"
    assert all(f"provider={provider}" in ln for ln in got)


def test_osc_device_window_lines():
    want = _wait(_start([sys.executable,
                         str(ROOT / "examples" / "osc_device_window.py")]))
    got = _wait(_port_job(3, "osc_device_window", "--device", "cpu",
                          extra=_gloo()))
    shape = [re.sub(r"\d+-device window over \w+", "N-device window",
                    re.sub(r"device \d+;", "device T;", ln)) for ln in want]
    lines = [ln for ln in got if not ln.startswith("osc_device_window ")]
    assert sorted(re.sub(r"\d+-device window over \w+", "N-device window",
                         re.sub(r"device \d+;", "device T;", ln))
                  for ln in lines) == sorted(shape)
    assert "3-device window over cpu" in lines
    assert ("one-sided put landed on device 2; one-sided get fetched it "
            "back: 42.0") in lines
    rows = {r["rank"]: r for r in (
        json.loads(ln.split(" ", 1)[1]) for ln in got
        if ln.startswith("osc_device_window "))}
    assert sorted(rows) == [0, 1, 2]
    assert [rows[r]["local"] for r in range(3)] == [0.0, 0.0, 42.0]
    assert rows[1]["fetched"] == rows[2]["fetched"] == 42.0
    # the CPU runs the copies' plain versions: no kernel launch
    assert all(r["put_launches"] == r["get_launches"] == 0
               for r in rows.values())


def test_generate_rows_equal_the_reference():
    want = _wait(_start([sys.executable,
                         str(ROOT / "examples" / "generate.py")]))
    got = _wait(_port_job(1, "generate", "--device", "cpu"))
    assert got == want
    assert got[0] == "mesh {'dp': 1, 'sp': 1, 'tp': 1}; prompt (2, 8) -> " \
                     "(2, 20)"
    rows = [json.loads(ln.strip()) for ln in got[1:]]
    assert len(rows) == 2 and all(len(r) == 20 for r in rows)


def _losses(lines) -> list[float]:
    return [float(m.group(1)) for m in
            (re.match(r"step \d+: loss ([-\d.]+)$", ln) for ln in lines) if m]


def test_train_losses_equal_the_reference(tmp_path):
    want = _wait(_start([sys.executable, str(ROOT / "examples" / "train.py"),
                         "--ckpt-dir", str(tmp_path / "jax")]))
    *got, last = _wait(_port_job(1, "train", "--device", "cpu",
                                 "--ckpt-dir", str(tmp_path / "port")))
    np.testing.assert_allclose(_losses(got), _losses(want), rtol=STEP_TOL)
    assert len(_losses(got)) == 6
    rec = json.loads(last.split("train ", 1)[1])
    assert rec["device"] == "cpu" and len(rec["losses"]) == 6
    np.testing.assert_allclose(rec["losses"], _losses(want), rtol=STEP_TOL)
    snap = str(tmp_path / "port" / "demo" / "snapshot_0")
    assert f"checkpoint at step 3 -> {snap}" in got
    assert os.path.exists(os.path.join(snap, "rank_0.npz"))
    assert got[-1] == want[-1] == ("resume: batch stream reproduced from "
                                   "checkpointed step — ok")
