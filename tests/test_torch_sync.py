"""The port's clock-sync tool (``tools/sync.py``, ≈ mpisync), held
against the JAX package's.

Both cases of ``tests/runtime/test_sync.py`` run the JAX package's own
bodies on the port through ``tests/torch_mirror.py``: offsets near zero
on in-process ranks, and the tool's table under the port's ``tpurun``.
The port's own cases: the table under a standing pool's
``--dvm-submit`` (every sim host is this machine, so each offset lies
within its rtt of 0), and the tool loads no torch.
"""

from __future__ import annotations

import os
import pathlib
import subprocess
import sys

import pytest

import tests.runtime.test_sync as ref_sync
from tests.torch_mirror import mirror

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("name", ["test_clock_offsets_in_process",
                                  "test_sync_tool_under_tpurun"])
def test_sync_case_on_the_port(name):
    mirror(getattr(ref_sync, name), True, [])()


def _rows(out: str) -> dict:
    rows = {}
    for ln in out.splitlines():
        parts = ln.replace("]", "] ").split()
        if len(parts) >= 4 and parts[-3].isdigit():
            rows[int(parts[-3])] = (float(parts[-2]), float(parts[-1]))
    return rows


def test_sync_under_a_standing_pool(tmp_path):
    import tests.runtime.test_dvm as ref_dvm

    standing = mirror(ref_dvm._standing_vm, True, [])
    env = dict(os.environ)
    env.pop("OMPI_TPU_RANK", None)
    with standing(tmp_path) as uri:
        r = subprocess.run(
            [sys.executable, "-m", "ompi_tpu_torch.tools.tpurun",
             "--dvm-submit", "-np", "4", "--dvm-uri", uri, "--",
             sys.executable, "-c",
             "import sys; from ompi_tpu_torch.tools import sync\n"
             "sync.main(['-n', '8'])\n"
             "assert 'torch' not in sys.modules\n"],
            capture_output=True, text=True, timeout=120, env=env, cwd=ROOT)
    assert r.returncode == 0, (r.stdout, r.stderr)
    assert "clock offsets vs rank 0 (4 ranks" in r.stdout
    rows = _rows(r.stdout)
    assert sorted(rows) == [0, 1, 2, 3], r.stdout
    assert rows[0] == (0.0, 0.0)
    for rank in (1, 2, 3):
        off_us, rtt_us = rows[rank]
        assert rtt_us > 0 and abs(off_us) <= rtt_us, r.stdout
