"""The port's chaos driver (``ompi_tpu_torch/tools/chaos_soak.py``, the
repo's ``tools/chaos_soak.py`` over the port's launcher and DVM) and its
``--guard`` preflight (``tools/killorphans.py``).

The plan generator, the shrink arithmetic, the canary rotation and the
orphan scan are held against the repo's own driver; the replay check
runs on synthetic fault logs, one good and two diverged; one canary
cycle runs live on a standing port pool (a kill@step victim healed in
place beside a fault-free ring tenant, both exact).
"""

from __future__ import annotations

import os
import pathlib
import subprocess
import sys

import pytest

import tools.chaos_soak as ref_soak
import tools.killorphans as ref_orphans
from ompi_tpu_torch.tools import chaos_soak, killorphans

ROOT = pathlib.Path(__file__).resolve().parents[1]


def test_plans_equal_the_repo_drivers():
    assert chaos_soak.POLICIES == ref_soak.POLICIES
    for seed in (0, 3, 17):
        for idx in range(2 * len(chaos_soak.POLICIES)):
            for np_, steps in ((4, 6), (3, 9)):
                assert chaos_soak.gen_plan(seed, idx, np_, steps) == \
                    ref_soak.gen_plan(seed, idx, np_, steps)
        for cycle in range(6):
            assert chaos_soak._canary_plan(seed, cycle, 4, 6) == \
                ref_soak._canary_plan(seed, cycle, 4, 6)
    for victim in range(4):
        for kill in range(1, 5):
            assert chaos_soak.expected_shrink_acc(4, 6, victim, kill) == \
                ref_soak.expected_shrink_acc(4, 6, victim, kill)


def _logs(kind="drop", frame="f1", step=3):
    return {0: {"rank": 0, "events": [
        {"kind": "kill", "trigger": "step", "value": step},
        {"kind": kind, "peer": 1, "frame": frame, "p": 1.0}]}}


def test_replay_check_accepts_a_replay_and_names_a_divergence():
    plan = {"idx": 0, "seed": 0, "drop": 1.0}
    chaos_soak.check_replay(plan, _logs(), _logs())
    with pytest.raises(AssertionError, match="kill schedule diverged"):
        chaos_soak.check_replay(plan, _logs(), _logs(step=4))
    with pytest.raises(AssertionError, match="not a pure function"):
        chaos_soak.check_replay(plan, _logs(), _logs(kind="dup"))


def test_fault_logs_merge_lives(tmp_path):
    import json

    for life, n in ((0, 1), (1, 2)):
        (tmp_path / f"faults_rank2_life{life}.json").write_text(json.dumps(
            {"rank": 2, "events": [{"kind": "kill", "n": k}
                                   for k in range(n)]}))
    got = chaos_soak.read_fault_logs(str(tmp_path))
    assert got == ref_soak.read_fault_logs(str(tmp_path))
    assert len(got[2]["events"]) == 3


def test_orphan_scan_equals_the_repo_tool(monkeypatch):
    """The same ``ps`` listing through both scans: the same suspects (a
    PPID-1 rank and orted, old enough), and neither the standing DVM
    nor a young or parented process."""
    import types

    ps = "\n".join([
        "  101 1 7200 python -m ompi_tpu_torch.runtime.orted --vpid 1",
        "  102 1 7200 python -m ompi_tpu_torch.tools.tpurun --dvm-start",
        "  103 1 30 python -m ompi_tpu_torch.tools.tpurun -np 2",
        "  104 55 7200 python -m ompi_tpu.tools.tpurun -np 2",
        "  105 1 9000 python -c import ompi_tpu; ompi_tpu.init()",
        "  106 1 9000 /bin/sleep 100"])
    monkeypatch.setattr(subprocess, "run", lambda *a, **k:
                        types.SimpleNamespace(stdout=ps, returncode=0))
    got = killorphans.find_orphans()
    assert got == ref_orphans.find_orphans()
    assert [o["pid"] for o in got] == [105, 101]
    import io

    out = io.StringIO()
    assert killorphans.preflight("soak", out=out) is False
    assert "2 orphaned ompi_tpu process(es)" in out.getvalue()


def test_one_canary_cycle_on_a_port_pool():
    env = dict(os.environ)
    env.pop("OMPI_TPU_RANK", None)
    r = subprocess.run([sys.executable, "-m",
                        "ompi_tpu_torch.tools.chaos_soak", "--canary",
                        "--plans", "1", "--seed", "0", "-v"],
                       capture_output=True, text=True, timeout=300,
                       env=env, cwd=ROOT)
    assert r.returncode == 0, (r.stdout[-2000:], r.stderr[-3000:])
    assert "canary cycle 0 [kill]" in r.stdout
    assert "1/1 cycles ok" in r.stdout
