"""The JAX package's own runtime test bodies run on the port
(``tests/torch_mirror.py``: the same bytecode, every assertion kept).

- ``tests/runtime/test_pmix.py``: the module's ``server`` fixture runs
  rebuilt over the port's globals, so every body talks to the port's
  ``PMIxServer`` with the port's ``PMIxClient``.
- ``tests/runtime/test_ras_rmaps.py`` and ``test_state.py``: the
  allocators, the mappers and the job state machine (the module's
  autouse fixture resets the port's variables).  ``test_chip_binding``
  expects the JAX package's fake chip names (``sim001/chip1``); the
  port's simulated nodes carry card indices on purpose
  (``ompi_tpu_torch/runtime/ras.py``: a PyTorch rank binds a real card),
  so its port body below asserts the card index each rank binds.
- ``tests/runtime/test_launcher.py`` and ``tests/mpi/test_integration.py``:
  real jobs of the port's ``tpurun`` on this host (the examples the
  reference launches are the port's of the same name).
"""

from __future__ import annotations

import pytest

import tests.mpi.test_integration as ref_integration
import tests.runtime.test_launcher as ref_launcher
import tests.runtime.test_pmix as ref_pmix
import tests.runtime.test_ras_rmaps as ref_ras
import tests.runtime.test_state as ref_state
from ompi_tpu_torch.core.config import var_registry
from ompi_tpu_torch.runtime import ras, rmaps
from ompi_tpu_torch.runtime.job import AppContext, Job
from tests.torch_mirror import cases, run_case


@pytest.mark.parametrize("name,params", cases(ref_pmix))
def test_pmix_case_on_the_port(name, params, request):
    run_case(ref_pmix, name, params, True, request, [])


@pytest.mark.parametrize("name,params",
                         cases(ref_ras, skip=("test_chip_binding",)))
def test_ras_rmaps_case_on_the_port(name, params, request):
    run_case(ref_ras, name, params, True, request, [])


def test_chip_binding(monkeypatch):
    """``tests/runtime/test_ras_rmaps.py::test_chip_binding`` with card
    indices: 2 simulated nodes of 4 slots on a 4-card machine own cards
    0, 1 and 2, 3 (``count // nodes`` each); rank 0 (node 0, local rank
    0) binds card 0 and rank 5 (node 1, local rank 1) card 3."""
    monkeypatch.setattr(ras, "_card_count", lambda: 4)
    var_registry.set("ras_", "simulator")
    var_registry.set("ras_sim_num_nodes", 2)
    var_registry.set("ras_sim_slots_per_node", 4)
    try:
        job = Job([AppContext(argv=["true"], np=8)])
        job = rmaps.map_job(ras.allocate(job, want_gpu=True))
        assert [p.node.name for p in job.procs] == ["sim000"] * 4 + \
            ["sim001"] * 4
        assert job.procs[0].chip == 0
        assert job.procs[5].chip == 3
        assert [p.chip for p in job.procs] == [0, 1, 0, 1, 2, 3, 2, 3]
    finally:
        var_registry.set("ras_", "")
        var_registry.set("rmaps_", "")


@pytest.mark.parametrize("name,params", cases(ref_state))
def test_state_case_on_the_port(name, params, request):
    run_case(ref_state, name, params, True, request, [])


@pytest.mark.parametrize("name,params", cases(ref_launcher))
def test_launcher_case_on_the_port(name, params, request):
    run_case(ref_launcher, name, params, True, request, [])


@pytest.mark.parametrize("name,params", cases(ref_integration))
def test_integration_case_on_the_port(name, params, request):
    run_case(ref_integration, name, params, True, request, [])
