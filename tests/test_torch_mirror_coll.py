"""The JAX package's own host-collective test bodies run on the port
(``tests/torch_mirror.py``: the same bytecode, every assertion kept):
``tests/mpi/test_coll.py``, ``test_coll_extra.py`` and
``test_coll_dense.py`` run once on each package over each one's
in-process harness, and every rank's results of the two runs must be
equal bit for bit.
"""

from __future__ import annotations

import pytest

import tests.mpi.test_coll as ref_coll
import tests.mpi.test_coll_dense as ref_dense
import tests.mpi.test_coll_extra as ref_extra
from tests.torch_mirror import both_case, cases


@pytest.mark.parametrize("name,params", cases(ref_coll))
def test_coll_case_equals_the_jax_package(name, params, request):
    both_case(ref_coll, name, params, request)


@pytest.mark.parametrize("name,params", cases(ref_extra))
def test_coll_extra_case_equals_the_jax_package(name, params, request):
    both_case(ref_extra, name, params, request)


@pytest.mark.parametrize("name,params", cases(ref_dense))
def test_coll_dense_case_equals_the_jax_package(name, params, request):
    both_case(ref_dense, name, params, request)
