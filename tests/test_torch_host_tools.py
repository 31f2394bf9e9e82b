"""The port's host-plane microbenches (``ompi_tpu_torch/tools/pack_bench.py``,
``coll_bench.py``, ``net_bench.py``, ``fleet_bench.py``) against the
reference tools of the same name (``tools/*.py``).

Each tool runs at a tiny size on the CPU with ``--out`` under
``tmp_path``, in a process that must not import torch, JAX or the JAX
package, and its rows must carry the same keys, in the same order, as
the reference tool's rows at the same flags, with the same row
identities (layout and plan kind, collective and component, bench and
mode).  The numbers themselves are timings and are not compared.
net_bench's default world, two ranks on two simulated hosts of the
port's own launcher, runs once on the port; fleet_bench's ``--assert``
must exit 0 on a 25-daemon world of the port's simulated fleet.
"""

from __future__ import annotations

import json
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]

#: runs a port tool as ``__main__`` and fails if it loaded torch, JAX or
#: the JAX package
_PORT = (
    "import runpy, sys\n"
    "sys.argv = [{name!r}] + {args!r}\n"
    "try:\n"
    "    runpy.run_module('ompi_tpu_torch.tools.{name}', "
    "run_name='__main__')\n"
    "finally:\n"
    "    bad = sorted(m for m in sys.modules if m in ('torch', 'jax', "
    "'ompi_tpu') or m.startswith(('torch.', 'jax.', 'ompi_tpu.')))\n"
    "    assert not bad, bad\n"
)


def _rows(path: pathlib.Path) -> list[dict]:
    return [json.loads(line) for line in path.read_text().splitlines()]


def _run(name: str, args: list[str], tmp: pathlib.Path, port: bool,
         timeout: float = 240.0) -> tuple[subprocess.CompletedProcess,
                                          list[dict]]:
    out = tmp / f"{name}-{'port' if port else 'ref'}.jsonl"
    argv = args + ["--out", str(out)]
    if port:
        cmd = [sys.executable, "-c", _PORT.format(name=name, args=argv)]
    else:
        cmd = [sys.executable, f"tools/{name}.py", *argv]
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("OMPI_TPU_RANK", None)
    proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=timeout)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return proc, _rows(out)


def _same_shape(ref: list[dict], port: list[dict], ident: tuple):
    assert [list(r) for r in port] == [list(r) for r in ref]
    assert [tuple(r[k] for k in ident) for r in port] == \
        [tuple(r[k] for k in ident) for r in ref]


def test_default_out_is_under_build_never_the_repo_jsonl():
    from ompi_tpu_torch.tools import (coll_bench, fleet_bench, net_bench,
                                      pack_bench)

    for mod, base in ((pack_bench, "PACK_BENCH.jsonl"),
                      (coll_bench, "COLL_BENCH.jsonl"),
                      (net_bench, "NET_BENCH.jsonl"),
                      (fleet_bench, "FLEET_BENCH.jsonl")):
        assert mod._OUT == str(ROOT / "build" / "ompi_tpu_torch" / "bench"
                               / base)


def test_pack_bench_rows_match_the_reference(tmp_path):
    args = ["--runs", "1,1000", "--layouts", "vector,hindexed,ragged"]
    _p, ref = _run("pack_bench", args, tmp_path, port=False)
    _p, port = _run("pack_bench", args, tmp_path, port=True)
    assert len(port) == 6
    _same_shape(ref, port, ("bench", "layout", "runs", "payload_bytes",
                            "plan", "native"))
    assert all(r["pack_into_ms"] > 0 for r in port)


@pytest.mark.parametrize("flags", [["--quick", "--ranks", "2"],
                                   ["--quick", "--ranks", "2", "--native"]],
                         ids=["classic", "native"])
def test_coll_bench_rows_match_the_reference(tmp_path, flags):
    _p, ref = _run("coll_bench", flags, tmp_path, port=False)
    proc, port = _run("coll_bench", flags, tmp_path, port=True)
    _same_shape(ref, port, ("bench", "coll", "ranks", "payload_bytes",
                            "component"))
    assert f"{len(port)} rows -> " in proc.stdout


def test_net_bench_rows_match_the_reference(tmp_path):
    """The port's default world, two ranks on two simulated hosts of its
    own ``tpurun``, against the reference's in-process world at the same
    sizes (``--inproc``, which launches nothing): the same rows but for
    the world's name."""
    _p, ref = _run("net_bench", ["--quick", "--inproc"], tmp_path,
                   port=False)
    proc, port = _run("net_bench", ["--quick"], tmp_path, port=True)
    assert {r["world"] for r in ref} == {"inproc"}
    assert {r["world"] for r in port} == {"fakehost"}
    _same_shape(ref, port, ("bench", "mode", "payload_bytes"))
    assert "acceptance (fakehost)" in proc.stdout


def test_fleet_bench_assert_holds_on_25_daemons(tmp_path):
    flags = ["--worlds", "25", "--assert"]
    _p, ref = _run("fleet_bench", flags, tmp_path, port=False)
    proc, port = _run("fleet_bench", flags, tmp_path, port=True)
    _same_shape(ref, port, ("bench", "n_daemons", "n_ranks",
                            "killed_daemons"))
    (row,) = port
    assert row["ok"] and row["failures"] == [], row
    assert row["reparent_epochs"] == 1 and row["false_positive_ranks"] == 0
    assert "25 daemons / 250 ranks" in proc.stdout
