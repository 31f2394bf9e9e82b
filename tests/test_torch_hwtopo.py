"""The port's host topology discovery (``ompi_tpu_torch.core.hwtopo``)
against the JAX package's on this host, its accelerator probe (CUDA
cards, 0 without CUDA), and the ras localhost component's slots, which
come from it."""

from __future__ import annotations

import dataclasses
import subprocess
import sys

import pytest
import torch

from ompi_tpu.core import hwtopo as jhwtopo
from ompi_tpu_torch.core import hwtopo
from ompi_tpu_torch.runtime import ras
from ompi_tpu_torch.runtime.job import AppContext, Job


def test_fields_equal_the_jax_packages():
    mine, theirs = hwtopo.discover(), jhwtopo.discover()
    assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
    assert mine.smt == theirs.smt >= 1
    assert [f.name for f in dataclasses.fields(hwtopo.Topology)] == [
        f.name for f in dataclasses.fields(jhwtopo.Topology)]


def test_sysfs_fallback_matches(monkeypatch):
    """Off Linux (no /sys) both fall back to os.cpu_count."""
    for mod in (hwtopo, jhwtopo):
        monkeypatch.setattr(mod, "_sysfs_topology", lambda: None)
    mine, theirs = hwtopo.discover(), jhwtopo.discover()
    assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
    assert mine.physical_cores == mine.logical_cpus and mine.packages == 1


def test_probe_counts_cuda_cards(monkeypatch):
    if not torch.cuda.is_available():
        assert hwtopo.discover(probe_accelerators=True).accelerators == 0
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert hwtopo.discover(probe_accelerators=True).accelerators == 4
    assert hwtopo.discover().accelerators == 0      # no probe, no count


def test_discover_without_the_probe_imports_no_torch():
    out = subprocess.run(
        [sys.executable, "-c",
         "import sys; from ompi_tpu_torch.core.hwtopo import discover; "
         "t = discover(); print(t.allowed_cpus > 0, 'torch' in sys.modules)"],
        capture_output=True, text=True, timeout=60, check=True)
    assert out.stdout.split() == ["True", "False"]


@pytest.mark.parametrize("np_", [1, 10_000])
def test_ras_localhost_slots_come_from_discover(monkeypatch, np_):
    monkeypatch.setattr(hwtopo, "discover", lambda **kw: hwtopo.Topology(
        logical_cpus=64, physical_cores=32, packages=2, allowed_cpus=12,
        accelerators=0))
    job = Job([AppContext(argv=["true"], np=np_)])
    nodes = ras.LocalhostRAS().allocate(job)
    assert [n.name for n in nodes] == ["localhost"]
    assert nodes[0].slots == max(12, np_)    # oversubscription: ≥ np
