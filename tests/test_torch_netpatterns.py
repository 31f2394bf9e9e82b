"""The port's communication-pattern helpers
(``ompi_tpu_torch/core/netpatterns.py``) against the JAX package's.

Every case of ``tests/core/test_netpatterns.py`` runs once on each
package through ``tests/torch_mirror.py`` (the reference's bytecode,
every assertion kept), and the two packages' trees agree point by point
on a sweep of sizes and fan-outs.
"""

from __future__ import annotations

import pytest

import tests.core.test_netpatterns as ref
from ompi_tpu.core import netpatterns as jnp_
from ompi_tpu_torch.core import netpatterns as pnp_
from tests.torch_mirror import mirror


@pytest.mark.parametrize("port", [False, True], ids=["jax", "port"])
@pytest.mark.parametrize("k", [1, 2, 3, 4])
@pytest.mark.parametrize("n", [1, 2, 5, 16, 33])
def test_kary_tree_consistent(n, k, port):
    mirror(ref.test_kary_tree_consistent, port, [])(n=n, k=k)


@pytest.mark.parametrize("port", [False, True], ids=["jax", "port"])
@pytest.mark.parametrize("n", [1, 2, 7, 8, 20])
def test_binomial_tree_consistent(n, port):
    mirror(ref.test_binomial_tree_consistent, port, [])(n=n)


@pytest.mark.parametrize("name", ["test_binomial_known_shape",
                                  "test_recursive_doubling_and_bruck",
                                  "test_tree_depth",
                                  "test_rml_tree_rides_netpatterns"])
@pytest.mark.parametrize("port", [False, True], ids=["jax", "port"])
def test_case_on_each_package(name, port):
    mirror(getattr(ref, name), port, [])()


@pytest.mark.parametrize("n", [1, 2, 3, 9, 31, 100])
def test_every_helper_equals_the_jax_package(n):
    for k in (1, 2, 3, 8):
        for r in range(n):
            assert pnp_.kary_parent(r, k) == jnp_.kary_parent(r, k)
            assert pnp_.kary_children(r, n, k) == jnp_.kary_children(r, n, k)
        assert pnp_.tree_depth(n, k) == jnp_.tree_depth(n, k)
    for r in range(n):
        assert pnp_.binomial_parent(r) == jnp_.binomial_parent(r)
        assert pnp_.binomial_children(r, n) == jnp_.binomial_children(r, n)
        assert (pnp_.recursive_doubling_peers(r, n)
                == jnp_.recursive_doubling_peers(r, n))
        assert pnp_.bruck_peers(r, n) == jnp_.bruck_peers(r, n)
    with pytest.raises(ValueError, match="k must be >= 1"):
        pnp_.kary_parent(1, 0)
