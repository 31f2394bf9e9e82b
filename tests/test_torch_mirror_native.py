"""The JAX package's own test bodies of the native executors run on the
port's (``tests/torch_mirror.py``: the same bytecode, every assertion
kept, over the port's ``_native`` loader and its own C sources).

- ``tests/mpi/test_native_arena.py``: the arena library's waits, fused
  publishes, folds and ring parks, each body calling the port's
  ``_native.arena()`` library (the module's ``lib``).
- ``tests/mpi/test_native_match.py``: the compiled matching engine and
  the Python matcher (the module's ``native`` fixture, both of its
  parameters), once on each package over each one's harness; every
  rank's results must be equal.
- ``tests/mpi/test_native_net.py``: the tcp plane's framing scan,
  writev, the writer and poller, the FT hooks and backpressure, each
  body calling the port's ``_native.net()``, on the port only (its
  bodies make sockets and threads and its one harness case records no
  results).
"""

from __future__ import annotations

import pytest

import tests.mpi.test_native_arena as ref_arena
import tests.mpi.test_native_match as ref_match
import tests.mpi.test_native_net as ref_net
from ompi_tpu_torch import _native
from tests.torch_mirror import both_case, cases, run_case


def test_the_port_builds_its_own_libraries():
    """The libraries the mirrored bodies call are the port's: built
    from ``ompi_tpu_torch/_native`` sources, not the JAX package's."""
    arena, net = _native.arena(), _native.net()
    assert arena is not None and net is not None
    assert arena is not ref_arena.lib and net is not ref_net.lib
    assert "ompi_tpu_torch" in arena._name and "ompi_tpu_torch" in net._name


@pytest.mark.parametrize("name,params", cases(ref_arena))
def test_native_arena_case_on_the_port(name, params, request):
    run_case(ref_arena, name, params, True, request, [],
             extra={"lib": _native.arena()})


@pytest.mark.parametrize("name,params", cases(ref_match))
def test_native_match_case_equals_the_jax_package(name, params, request):
    both_case(ref_match, name, params, request)


@pytest.mark.parametrize("name,params", cases(ref_net))
def test_native_net_case_on_the_port(name, params, request):
    run_case(ref_net, name, params, True, request, [],
             extra={"lib": _native.net()})
