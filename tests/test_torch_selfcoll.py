"""coll/self's ``alltoallw`` on the port against the JAX package's.

On a one-rank communicator the component packs the send spec through
its datatype and unpacks the bytes into the receive spec in place
(``mpi/coll/base.pack_spec``/``unpack_spec``).  The same send buffer,
datatypes and receive buffer go through each package's
``comm.alltoallw`` on its in-process harness; the receive buffers must
be equal byte for byte, the provider must be coll/self in both, and a
``None`` send spec must leave the receive buffer as it was.
"""

from __future__ import annotations

import numpy as np
import pytest

from ompi_tpu.mpi import datatype as jdt
from ompi_tpu_torch.mpi import datatype as pdt
from tests.mpi.harness import run_ranks as jrun
from tests.torch_host_harness import run_ranks as prun

SEED = 21


def _specs(dt, kind: str):
    """(send spec, receive spec) of one kind; the send side is built
    from a seeded numpy draw, the receive side starts at -1."""
    rng = np.random.default_rng(SEED)
    if kind == "vector":
        # 5 blocks of 3 float64, stride 7: 15 of a 35-element buffer
        send = rng.normal(size=35)
        styp = dt.FLOAT64.vector(5, 3, 7).commit()
        recv = np.full(15, -1.0)
        return (send, styp, 1), (recv, dt.FLOAT64, 15)
    if kind == "indexed":
        # int64 blocks of lengths 2, 4, 1 at 0, 5, 11 in; a vector out
        send = rng.integers(-1000, 1000, size=16).astype(np.int64)
        styp = dt.INT64.indexed([2, 4, 1], [0, 5, 11]).commit()
        recv = np.full(14, -1, np.int64)
        rtyp = dt.INT64.vector(7, 1, 2).commit()
        return (send, styp, 1), (recv, rtyp, 1)
    raise ValueError(kind)


def _alltoallw(run, dt, kind: str, empty: bool = False):
    sspec, rspec = _specs(dt, kind)

    def body(comm):
        comm.alltoallw([None if empty else sspec], [rspec])
        return rspec[0].copy(), comm.coll.providers.get("alltoallw")

    return run(1, body)[0]


@pytest.mark.parametrize("kind", ["vector", "indexed"])
def test_alltoallw_on_comm_self_equals_the_jax_package(kind):
    want, jprov = _alltoallw(jrun, jdt, kind)
    got, pprov = _alltoallw(prun, pdt, kind)
    assert jprov == pprov == "self"
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()
    assert not np.all(got == -1)


@pytest.mark.parametrize("kind", ["vector", "indexed"])
def test_alltoallw_none_send_leaves_the_receive_buffer(kind):
    want, _ = _alltoallw(jrun, jdt, kind, empty=True)
    got, _ = _alltoallw(prun, pdt, kind, empty=True)
    assert got.tobytes() == want.tobytes()
    assert np.all(got == -1)
