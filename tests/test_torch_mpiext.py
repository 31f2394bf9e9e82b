"""The port's MPIX extension registry (``ompi_tpu_torch.mpi.mpiext``)
beside the JAX package's: the same registry contract, and the reference's
own ``MPIX_Query_cuda_support`` in place of ``query_tpu_support``."""

from __future__ import annotations

import pytest
import torch

from ompi_tpu_torch.mpi import mpiext


def test_registry_and_probes():
    assert {"cuda", "device_heap", "sequence_parallel"} <= mpiext.extensions()
    assert mpiext.has_extension("no_such_extension") is False
    assert mpiext.query_device_heap_support() is True
    assert mpiext.query_sequence_parallel_support() is True
    assert not hasattr(mpiext, "query_tpu_support")


def test_cuda_support_is_false_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("checks a machine without CUDA")
    assert mpiext.query_cuda_support() is False


def test_probes_never_raise():
    def boom():
        raise RuntimeError("probe failed")

    mpiext.register_extension("_broken", boom)
    try:
        assert "_broken" in mpiext.extensions()
        assert mpiext.has_extension("_broken") is False
    finally:
        mpiext._registry.pop("_broken")


def test_same_registry_contract_as_the_jax_package():
    pytest.importorskip("jax")
    from ompi_tpu.mpi import mpiext as jmpiext

    shared = {"extensions", "has_extension", "register_extension",
              "query_device_heap_support",
              "query_sequence_parallel_support"}
    assert shared <= set(jmpiext.__all__) and shared <= set(mpiext.__all__)
    assert set(mpiext.__all__) - shared == {"query_cuda_support"}
    assert set(jmpiext.__all__) - shared == {"query_tpu_support"}
    # the registrations each module makes at its own import: other tests
    # in the same process may register more names in either registry
    # (tests/core/test_sysinfo_notifier.py adds "always" to the JAX
    # package's), so the probes defined elsewhere are left out
    assert (_own_extensions(mpiext) - {"cuda"}
            == _own_extensions(jmpiext) - {"tpu"})
    assert _own_extensions(mpiext) <= mpiext.extensions()
    assert _own_extensions(jmpiext) <= jmpiext.extensions()


def _own_extensions(module) -> set:
    """Names whose probe is a function of ``module`` itself."""
    return {name for name, probe in module._registry.items()
            if getattr(probe, "__module__", None) == module.__name__}


def test_registry_contract_holds_after_the_jax_notifier_tests(tmp_path):
    """Regression: the JAX package's notifier tests register "always" and
    never remove it; the contract test must pass after them in one
    process."""
    pytest.importorskip("jax")
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
         "-p", "no:xdist", "-p", "no:randomly",
         "tests/core/test_sysinfo_notifier.py::test_mpiext_registry",
         "tests/test_torch_mpiext.py::"
         "test_same_registry_contract_as_the_jax_package"],
        cwd=root, capture_output=True, text=True, timeout=300,
        env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-2000:]
    assert "2 passed" in proc.stdout
