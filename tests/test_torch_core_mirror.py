"""The JAX package's own test bodies of the config registry, the MCA base,
the output streams, DSS, coll/self and the collective decision layer,
run on the port through ``tests/torch_mirror.py``.

- ``tests/core/test_config.py`` (16), ``test_output.py`` (5) and
  ``test_dss.py`` (14) run once on each package: the same bytecode,
  every assertion kept.
- ``tests/core/test_mca.py`` (9) runs on the port only: its bodies make
  frameworks under fixed names in the package's global registry, which
  refuses a second framework of one name, and the reference's own module
  makes them in the JAX package's registry (in whichever worker process
  runs it).
- ``tests/mpi/test_selfcoll.py`` (3) and ``test_coll_decision.py`` (8)
  run once on each package over each one's in-process harness, and every
  rank's results of the two runs must be equal bit for bit.
"""

from __future__ import annotations

import inspect

import pytest

import tests.core.test_config as ref_config
import tests.core.test_dss as ref_dss
import tests.core.test_mca as ref_mca
import tests.core.test_output as ref_output
import tests.mpi.test_coll_decision as ref_decision
import tests.mpi.test_selfcoll as ref_selfcoll
from tests.test_torch_host_p2p import _same
from tests.torch_mirror import mirror


def _cases(mod) -> list[str]:
    return [n for n, f in vars(mod).items()
            if n.startswith("test_") and inspect.isfunction(f)
            and f.__module__ == mod.__name__]


def _call(fn, port: bool, request, out: list):
    """``fn`` mirrored onto one package, called with the pytest fixtures
    its signature names."""
    kw = {p: request.getfixturevalue(p)
          for p in inspect.signature(fn).parameters}
    return mirror(fn, port, out)(**kw)


def test_every_reference_case_is_mirrored():
    """The counts ROADMAP names for these modules: a case added to a
    reference module shows up here."""
    got = {m.__name__: len(_cases(m)) for m in (
        ref_config, ref_mca, ref_output, ref_dss, ref_selfcoll,
        ref_decision)}
    assert got == {"tests.core.test_config": 16, "tests.core.test_mca": 9,
                   "tests.core.test_output": 5, "tests.core.test_dss": 14,
                   "tests.mpi.test_selfcoll": 3,
                   "tests.mpi.test_coll_decision": 8}, got


@pytest.mark.parametrize("port", [False, True], ids=["jax", "port"])
@pytest.mark.parametrize("name", _cases(ref_config))
def test_config_case(name, port, request):
    _call(getattr(ref_config, name), port, request, [])


@pytest.mark.parametrize("name", _cases(ref_mca))
def test_mca_case_on_the_port(name, request):
    _call(getattr(ref_mca, name), True, request, [])


@pytest.fixture
def stream_verbosity():
    """``test_stream_verbosity_gating`` leaves its stream's verbosity at 5
    in the package it ran on, and the reference's own module, run later
    in the same worker, then finds the stream loud: put it back."""
    import ompi_tpu.core.config as jax_config
    import ompi_tpu_torch.core.config as port_config

    yield
    for registry in (jax_config.var_registry, port_config.var_registry):
        if registry.lookup("output_tst_stream_verbose") is not None:
            registry.set("output_tst_stream_verbose", 0)


@pytest.mark.parametrize("port", [False, True], ids=["jax", "port"])
@pytest.mark.parametrize("name", _cases(ref_output))
def test_output_case(name, port, request, stream_verbosity):
    _call(getattr(ref_output, name), port, request, [])


@pytest.mark.parametrize("port", [False, True], ids=["jax", "port"])
@pytest.mark.parametrize("name", _cases(ref_dss))
def test_dss_case(name, port, request):
    _call(getattr(ref_dss, name), port, request, [])


def _both(fn, request):
    """``fn`` on each package; the results its harness calls returned
    (none for a body that runs no ranks) must be equal."""
    outs = []
    for port in (False, True):
        out: list = []
        _call(fn, port, request, out)
        outs.append(out)
    _same(outs[0], outs[1])


@pytest.mark.parametrize("name", _cases(ref_selfcoll))
def test_selfcoll_case_equals_the_jax_package(name, request):
    _both(getattr(ref_selfcoll, name), request)


@pytest.mark.parametrize("name", _cases(ref_decision))
def test_coll_decision_case_equals_the_jax_package(name, request):
    _both(getattr(ref_decision, name), request)
