"""The port's datatype device pack (``ompi_tpu_torch.mpi.datatype``
``pack_device``/``unpack_device``) against the JAX package's.

The same numpy input goes through the JAX package's ``jnp.take`` /
``.at[idx].set`` lowering and the port's ``index_select`` /
``index_put_``; both are gathers and scatters of the same elements, so
the results must be equal exactly.  Covers the case of
``tests/mpi/test_datatype_ext.py::test_device_gather_lowering``
(``vector(3, 1, 2)`` at counts 1 and 2), the other constructors the
device path reads, the refusals (an extent that is not a multiple of the
element, a struct), and the index cache.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from ompi_tpu.mpi import datatype as jdt  # noqa: E402
from ompi_tpu.mpi.constants import MPIException as JMPIException  # noqa: E402
from ompi_tpu_torch.mpi import datatype as dt  # noqa: E402
from ompi_tpu_torch.mpi.constants import MPIException  # noqa: E402

_TYPES = {
    "vector": lambda m, b: b(m).vector(3, 1, 2),
    "vector_blocks": lambda m, b: b(m).vector(4, 2, 3),
    "contiguous": lambda m, b: b(m).contiguous(5),
    "indexed": lambda m, b: b(m).indexed([2, 1, 3], [5, 0, 10]),
    "indexed_block": lambda m, b: b(m).indexed_block(2, [6, 1, 3]),
    "hvector": lambda m, b: b(m).hvector(3, 2, 20),
    "hindexed": lambda m, b: b(m).hindexed([2, 1], [24, 4]),
    "hindexed_block": lambda m, b: b(m).hindexed_block(1, [8, 0, 12]),
    "subarray": lambda m, b: b(m).subarray([4, 6], [2, 3], [1, 2]),
    "subarray_f": lambda m, b: b(m).subarray([4, 6], [2, 3], [1, 2],
                                             order="F"),
    "resized": lambda m, b: b(m).vector(2, 2, 3).resized(40),
    "nested": lambda m, b: b(m).vector(2, 2, 3).vector(2, 1, 3),
}
_BASES = {"float32": lambda m: m.FLOAT32, "int32": lambda m: m.INT32}


def _both(name, dtype):
    make, base = _TYPES[name], _BASES[dtype]
    return make(jdt, base).commit(), make(dt, base).commit()


@pytest.mark.parametrize("count", [1, 2])
@pytest.mark.parametrize("dtype", sorted(_BASES))
@pytest.mark.parametrize("name", sorted(_TYPES))
def test_pack_unpack_match_jax(name, dtype, count):
    jt, t = _both(name, dtype)
    assert (t.size, t.extent, t.get_extent()) == (jt.size, jt.extent,
                                                  jt.get_extent())
    np.testing.assert_array_equal(t.element_indices(), jt.element_indices())
    x = (np.arange(t.extent // 4 * count + 7) * 3 - 11).astype(dtype)
    want = np.asarray(jt.pack_device(jnp.asarray(x), count=count))
    got = t.pack_device(torch.from_numpy(x), count=count)
    assert got.numpy().dtype == want.dtype
    np.testing.assert_array_equal(got.numpy(), want)
    want_u = np.asarray(jt.unpack_device(jnp.asarray(want), count=count))
    got_u = t.unpack_device(got, count=count)
    np.testing.assert_array_equal(got_u.numpy(), want_u)
    n = x.size
    want_n = np.asarray(jt.unpack_device(jnp.asarray(want), count=count,
                                         total_elems=n))
    np.testing.assert_array_equal(
        t.unpack_device(got, count=count, total_elems=n).numpy(), want_n)


def test_device_gather_lowering():
    t = dt.FLOAT32.vector(3, 1, 2).commit()   # every other element, 3x
    x = torch.arange(12, dtype=torch.float32)
    # MPI vector extent = (count-1)*stride+blocklength = 5 elems, so item 2
    # starts at element 5
    packed = t.pack_device(x, count=2)
    np.testing.assert_array_equal(packed.numpy(), [0, 2, 4, 5, 7, 9])
    out = t.unpack_device(packed, count=2)
    np.testing.assert_array_equal(out.numpy(),
                                  [0, 0, 2, 0, 4, 5, 0, 7, 0, 9])


def test_misaligned_extent_refused_as_in_jax():
    jt = jdt.FLOAT32.resized(6).commit()
    with pytest.raises(JMPIException, match="not a multiple"):
        jt.pack_device(jnp.zeros(8, jnp.float32))
    t = dt.FLOAT32.resized(6).commit()
    for call in (lambda: t.pack_device(torch.zeros(8)),
                 lambda: t.unpack_device(torch.zeros(1))):
        with pytest.raises(MPIException, match="not a multiple"):
            call()


def test_struct_has_no_device_gather():
    t = dt.create_struct([1, 2], [0, 8], [dt.FLOAT64, dt.INT32]).commit()
    jt = jdt.create_struct([1, 2], [0, 8], [jdt.FLOAT64, jdt.INT32]).commit()
    assert (t.size, t.extent) == (jt.size, jt.extent) == (16, 16)
    for got, want in zip(t.segment_arrays(), jt.segment_arrays()):
        np.testing.assert_array_equal(got, want)
    with pytest.raises(MPIException, match="struct"):
        t.pack_device(torch.zeros(4, dtype=torch.float64))


def test_index_is_cached_per_count_and_device(monkeypatch):
    t = dt.FLOAT32.vector(4, 2, 3).commit()
    x = torch.arange(40, dtype=torch.float32)
    first = t.pack_device(x, count=2)
    made = []
    orig = torch.as_tensor
    monkeypatch.setattr(torch, "as_tensor",
                        lambda *a, **k: made.append(1) or orig(*a, **k))
    again = t.pack_device(x, count=2)
    assert made == [] and torch.equal(first, again)
    t.pack_device(x, count=1)
    assert made == [1]


def test_bfloat16_tensor_keeps_its_dtype():
    t = dt.BFLOAT16.vector(2, 1, 2).commit()
    x = torch.arange(6, dtype=torch.bfloat16)
    out = t.pack_device(x, count=2)
    assert out.dtype == torch.bfloat16
    np.testing.assert_array_equal(out.float().numpy(), [0, 2, 3, 5])
