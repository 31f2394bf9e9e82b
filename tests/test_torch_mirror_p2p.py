"""The JAX package's own point-to-point test bodies run on the port
(``tests/torch_mirror.py``: the same bytecode, every assertion kept).

- ``tests/mpi/test_p2p.py``, ``test_mprobe.py``, ``test_p2p_soak.py`` and
  ``test_shm_soak_mixed.py`` run once on each package over each one's
  in-process harness; every rank's results of the two runs must be equal
  bit for bit.
- ``tests/mpi/test_group_request_op.py`` (groups, requests, the op table)
  and ``test_spin_multicore_branch.py`` (two spawned processes under the
  forced multicore spin) run on the port.  ``test_device_op`` feeds
  ``jax.numpy`` arrays to ``Op.device``; its port body below feeds torch
  tensors and asserts the same sum.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import tests.mpi.test_group_request_op as ref_gro
import tests.mpi.test_mprobe as ref_mprobe
import tests.mpi.test_p2p as ref_p2p
import tests.mpi.test_p2p_soak as ref_soak
import tests.mpi.test_shm_soak_mixed as ref_shm_soak
import tests.mpi.test_spin_multicore_branch as ref_spin
from tests.torch_mirror import both_case, cases, run_case

from ompi_tpu_torch.mpi import op as op_mod


@pytest.mark.parametrize("name,params", cases(ref_p2p))
def test_p2p_case_equals_the_jax_package(name, params, request):
    both_case(ref_p2p, name, params, request)


@pytest.mark.parametrize("name,params", cases(ref_mprobe))
def test_mprobe_case_equals_the_jax_package(name, params, request):
    both_case(ref_mprobe, name, params, request)


@pytest.mark.parametrize("name,params", cases(ref_soak))
def test_p2p_soak_case_equals_the_jax_package(name, params, request):
    both_case(ref_soak, name, params, request)


@pytest.mark.parametrize("name,params", cases(ref_shm_soak))
def test_shm_soak_mixed_case_equals_the_jax_package(name, params, request):
    both_case(ref_shm_soak, name, params, request)


@pytest.mark.parametrize("name,params",
                         cases(ref_gro, skip=("test_device_op",)))
def test_group_request_op_case_on_the_port(name, params, request):
    run_case(ref_gro, name, params, True, request, [])


def test_device_op():
    """``tests/mpi/test_group_request_op.py::test_device_op`` with torch
    tensors: the reference feeds ``jax.numpy`` arrays, which the port's
    ``Op.device`` does not take."""
    out = op_mod.SUM.device(torch.ones(3), torch.ones(3))
    assert isinstance(out, torch.Tensor)
    np.testing.assert_array_equal(out.numpy(), [2, 2, 2])


@pytest.mark.parametrize("name,params", cases(ref_spin))
def test_spin_multicore_branch_case_on_the_port(name, params, request):
    run_case(ref_spin, name, params, True, request, [])
