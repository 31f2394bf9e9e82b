"""The port's datatype surface beyond the device pack (``ompi_tpu_torch.
mpi.datatype``: hvector, hindexed, struct, subarray, darray, external32,
the envelope, the helpers) against the JAX package's.

Each case mirrors one of ``tests/mpi/test_datatype_ext.py`` (the host
cases; the device gather is ``test_torch_datatype.py``'s),
``tests/mpi/test_api_parity3.py``'s ``test_pack_size_and_address_helpers``
and ``test_type_extents_and_names``, or the three envelope cases of
``tests/mpi/test_api_introspection.py``, with every assertion kept.  The
case runs once through each package (``M``) on the same numpy inputs, and
what it returns — packed bytes, unpacked buffers, segments, envelopes —
must be equal byte for byte.  The port's ``create_darray`` builds its
runs with array math where the JAX package walks every item; the darray
cases also compare the two on grids that the reference's examples do not
reach.  bf16 (the port's 2-byte bits, ml_dtypes' bfloat16 in the JAX
package) packs to the same external32 words.
"""

from __future__ import annotations

import itertools
import types

import numpy as np
import pytest

from ompi_tpu.mpi import datatype as jdt
from ompi_tpu.mpi.constants import MPIException as JMPIException
from ompi_tpu_torch.mpi import datatype as pdt
from ompi_tpu_torch.mpi.constants import MPIException as PMPIException
from tests.mpi.harness import run_ranks as jrun
from tests.test_torch_host_p2p import _same
from tests.torch_host_harness import run_ranks as prun

J = types.SimpleNamespace(name="jax", dt=jdt, MPIException=JMPIException,
                          run=jrun)
P = types.SimpleNamespace(name="port", dt=pdt, MPIException=PMPIException,
                          run=prun)


def both(case, *args):
    """Run ``case(M, *args)`` through both packages; the results must be
    equal byte for byte."""
    jres, pres = case(J, *args), case(P, *args)
    _same(jres, pres)
    return pres


def _np(b) -> np.ndarray:
    return np.frombuffer(bytes(b), np.uint8)


# ---------------------------------------------------------------------------
# constructors (tests/mpi/test_datatype_ext.py)
# ---------------------------------------------------------------------------

def _hvector_byte_stride(M):
    t = M.dt.FLOAT32.hvector(3, 2, 20).commit()
    assert t.size == 3 * 2 * 4
    buf = np.arange(16, dtype=np.float32)
    packed = t.pack(buf, 1)
    got = np.frombuffer(packed, np.float32)
    np.testing.assert_array_equal(got, [0, 1, 5, 6, 10, 11])
    return _np(packed), t.segments(), (t.size, t.extent)


def test_hvector_byte_stride():
    both(_hvector_byte_stride)


def _hindexed_and_block_roundtrip(M):
    t = M.dt.INT32.hindexed([2, 3], [24, 4]).commit()
    buf = np.arange(12, dtype=np.int32)
    packed = t.pack(buf, 1)
    np.testing.assert_array_equal(np.frombuffer(packed, np.int32),
                                  [6, 7, 1, 2, 3])
    out = np.zeros(12, np.int32)
    t.unpack(packed, out, 1)
    np.testing.assert_array_equal(out[[6, 7, 1, 2, 3]], [6, 7, 1, 2, 3])
    tb = M.dt.INT32.hindexed_block(2, [16, 0]).commit()
    packed_b = tb.pack(buf, 1)
    np.testing.assert_array_equal(np.frombuffer(packed_b, np.int32),
                                  [4, 5, 0, 1])
    return _np(packed), out, _np(packed_b)


def test_hindexed_and_block_roundtrip():
    both(_hindexed_and_block_roundtrip)


def _indexed_declaration_order_preserved(M):
    t = M.dt.INT32.indexed([1, 1, 1], [8, 4, 0]).commit()
    buf = np.arange(10, dtype=np.int32)
    packed = t.pack(buf, 1)
    np.testing.assert_array_equal(np.frombuffer(packed, np.int32), [8, 4, 0])
    out = np.zeros(10, np.int32)
    t.unpack(np.array([80, 40, 0], np.int32).tobytes(), out, 1)
    assert out[8] == 80 and out[4] == 40 and out[0] == 0
    return _np(packed), out


def test_indexed_declaration_order_preserved():
    both(_indexed_declaration_order_preserved)


def _struct_mixed_base_types(M):
    t = M.dt.create_struct([1, 2, 1], [0, 8, 16],
                           [M.dt.FLOAT64, M.dt.INT32, M.dt.INT8]).commit()
    assert t.size == 8 + 8 + 1
    assert t.extent == 17
    raw = bytearray(24)
    raw[0:8] = np.array([3.5]).tobytes()
    raw[8:16] = np.array([7, 9], np.int32).tobytes()
    raw[16:17] = np.array([5], np.int8).tobytes()
    buf = np.frombuffer(bytes(raw), np.uint8)
    packed = t.pack(buf, 1)
    assert np.frombuffer(packed[:8], np.float64)[0] == 3.5
    np.testing.assert_array_equal(np.frombuffer(packed[8:16], np.int32),
                                  [7, 9])
    assert np.frombuffer(packed[16:17], np.int8)[0] == 5
    out = np.zeros(24, np.uint8)
    t.unpack(packed, out, 1)
    np.testing.assert_array_equal(out[:17], buf[:17])
    return _np(packed), out


def test_struct_mixed_base_types():
    both(_struct_mixed_base_types)


def _struct_count_gt_one_and_resized(M):
    t = M.dt.create_struct([1, 1], [0, 4], [M.dt.INT32, M.dt.FLOAT32])
    r = t.resized(16).commit()
    assert r.extent == 16 and r.size == 8
    buf = np.zeros(8, np.int32)
    buf[0], buf[4] = 1, 2
    view = buf.view(np.uint8)
    packed = r.pack(view, 2)
    assert np.frombuffer(packed, np.int32)[0] == 1
    assert np.frombuffer(packed, np.int32)[2] == 2
    return _np(packed), r.get_envelope()


def test_struct_count_gt_one_and_resized():
    both(_struct_count_gt_one_and_resized)


def _struct_rejects_device_gather(M):
    t = M.dt.create_struct([1], [0], [M.dt.INT32])
    with pytest.raises(M.MPIException, match="uniform element type"):
        t.element_indices()
    return t.get_envelope()


def test_struct_rejects_device_gather():
    both(_struct_rejects_device_gather)


def _subarray_2d_c_order(M):
    t = M.dt.create_subarray([4, 6], [2, 3], [1, 2], M.dt.INT32).commit()
    a = np.arange(24, dtype=np.int32).reshape(4, 6)
    packed = t.pack(a.ravel(), 1)
    np.testing.assert_array_equal(
        np.frombuffer(packed, np.int32).reshape(2, 3), a[1:3, 2:5])
    assert t.extent == 24 * 4
    return _np(packed), t.segments()


def test_subarray_2d_c_order():
    both(_subarray_2d_c_order)


def _subarray_3d_and_f_order(M):
    a = np.arange(60, dtype=np.float64).reshape(3, 4, 5)
    t = M.dt.create_subarray([3, 4, 5], [2, 2, 2], [1, 1, 1],
                             M.dt.FLOAT64).commit()
    p3 = t.pack(a.ravel(), 1)
    np.testing.assert_array_equal(
        np.frombuffer(p3, np.float64).reshape(2, 2, 2), a[1:3, 1:3, 1:3])
    af = np.asfortranarray(np.arange(12, dtype=np.int32).reshape(3, 4))
    tf = M.dt.create_subarray([3, 4], [2, 2], [1, 1], M.dt.INT32,
                              order="F").commit()
    flat_f = af.ravel(order="F")
    pf = tf.pack(flat_f, 1)
    np.testing.assert_array_equal(
        np.frombuffer(pf, np.int32).reshape(2, 2, order="F"), af[1:3, 1:3])
    return _np(p3), _np(pf)


def test_subarray_3d_and_f_order():
    both(_subarray_3d_and_f_order)


def _subarray_bounds_check(M):
    with pytest.raises(M.MPIException, match="out of bounds"):
        M.dt.create_subarray([4], [3], [2], M.dt.INT32)
    return True


def test_subarray_bounds_check():
    both(_subarray_bounds_check)


def _darray_block_covers_and_partitions(M):
    gsizes, psizes = [4, 6], [2, 2]
    seen = np.zeros(24, np.int32)
    a = np.arange(24, dtype=np.int32)
    per_rank = {}
    for rank in range(4):
        t = M.dt.create_darray(4, rank, gsizes,
                               [M.dt.DISTRIBUTE_BLOCK, M.dt.DISTRIBUTE_BLOCK],
                               [M.dt.DISTRIBUTE_DFLT_DARG] * 2, psizes,
                               M.dt.INT32).commit()
        got = np.frombuffer(t.pack(a, 1), np.int32)
        per_rank[rank] = got
        seen[got] += 1
    np.testing.assert_array_equal(seen, np.ones(24, np.int32))
    np.testing.assert_array_equal(
        per_rank[0], a.reshape(4, 6)[:2, :3].ravel())
    return per_rank


def test_darray_block_covers_and_partitions():
    both(_darray_block_covers_and_partitions)


def _darray_cyclic(M):
    a = np.arange(8, dtype=np.float32)
    t0 = M.dt.create_darray(2, 0, [8], [M.dt.DISTRIBUTE_CYCLIC], [1], [2],
                            M.dt.FLOAT32).commit()
    t1 = M.dt.create_darray(2, 1, [8], [M.dt.DISTRIBUTE_CYCLIC], [1], [2],
                            M.dt.FLOAT32).commit()
    p0, p1 = t0.pack(a, 1), t1.pack(a, 1)
    np.testing.assert_array_equal(np.frombuffer(p0, np.float32),
                                  [0, 2, 4, 6])
    np.testing.assert_array_equal(np.frombuffer(p1, np.float32),
                                  [1, 3, 5, 7])
    return _np(p0), _np(p1), t0.segments(), t1.segments()


def test_darray_cyclic():
    both(_darray_cyclic)


def _darray_cyclic_block2_with_none_dim(M):
    a = np.arange(24, dtype=np.int32)
    t = M.dt.create_darray(2, 1, [6, 4],
                           [M.dt.DISTRIBUTE_CYCLIC, M.dt.DISTRIBUTE_NONE],
                           [2, M.dt.DISTRIBUTE_DFLT_DARG], [2, 1],
                           M.dt.INT32).commit()
    got = np.frombuffer(t.pack(a, 1), np.int32)
    np.testing.assert_array_equal(got, a.reshape(6, 4)[[2, 3]].ravel())
    return got, t.segments()


def test_darray_cyclic_block2_with_none_dim():
    both(_darray_cyclic_block2_with_none_dim)


_GRIDS = [
    (4, [8, 6], ["block", "block"], [-1, -1], [2, 2]),
    (4, [9, 7], ["cyclic", "block"], [2, -1], [2, 2]),
    (2, [5, 4, 3], ["none", "cyclic", "block"], [-1, 1, -1], [1, 2, 1]),
    (4, [8, 8], ["block", "cyclic"], [-1, 3], [2, 2]),
    (2, [6, 4], ["block", "none"], [-1, -1], [2, 1]),
    (8, [3, 5, 7], ["cyclic", "block", "cyclic"], [1, -1, 2], [2, 2, 2]),
    (4, [2, 9], ["block", "block"], [-1, -1], [4, 1]),
]


def _darray_grid(M, size, gsizes, distribs, dargs, psizes, order):
    out = []
    for rank in range(size):
        t = M.dt.create_darray(size, rank, gsizes, distribs, dargs, psizes,
                               M.dt.FLOAT32, order=order).commit()
        out.append((t.segments(), t.size, t.extent, t.get_envelope()))
    return out


@pytest.mark.parametrize("order", ["C", "F"])
@pytest.mark.parametrize("grid", range(len(_GRIDS)))
def test_darray_runs_match_the_item_walk(grid, order):
    """The port's array-built runs equal the JAX package's per-item walk
    on every rank of grids with block, cyclic and none dimensions."""
    both(_darray_grid, *_GRIDS[grid], order)


def _external32_roundtrip_and_endianness(M):
    t = M.dt.FLOAT64.vector(2, 2, 3).commit()
    buf = np.arange(6, dtype=np.float64)
    ext = M.dt.pack_external(t, buf, 1)
    np.testing.assert_array_equal(np.frombuffer(ext, ">f8"), [0, 1, 3, 4])
    out = np.zeros(6, np.float64)
    M.dt.unpack_external(t, ext, out, 1)
    np.testing.assert_array_equal(out[[0, 1, 3, 4]], [0, 1, 3, 4])
    return _np(ext), out


def test_external32_roundtrip_and_endianness():
    both(_external32_roundtrip_and_endianness)


def _external32_struct_mixed_widths(M):
    t = M.dt.create_struct([1, 2], [0, 8],
                           [M.dt.FLOAT64, M.dt.INT16]).commit()
    raw = bytearray(12)
    raw[0:8] = np.array([2.25]).tobytes()
    raw[8:12] = np.array([258, -3], np.int16).tobytes()
    buf = np.frombuffer(bytes(raw), np.uint8)
    ext = M.dt.pack_external(t, buf, 1)
    assert np.frombuffer(ext[:8], ">f8")[0] == 2.25
    np.testing.assert_array_equal(np.frombuffer(ext[8:12], ">i2"),
                                  [258, -3])
    out = np.zeros(12, np.uint8)
    M.dt.unpack_external(t, ext, out, 1)
    np.testing.assert_array_equal(out, buf)
    return _np(ext), out


def test_external32_struct_mixed_widths():
    both(_external32_struct_mixed_widths)


def test_external32_bfloat16_swaps_two_byte_words():
    """A bf16 vector's external32 stream: 2-byte words swapped, the same
    bytes from ml_dtypes' bf16 (JAX package) and the port's uint16 bits."""
    bits = np.arange(0x3F80, 0x3F80 + 12, dtype=np.uint16)
    jt = jdt.BFLOAT16.vector(3, 2, 4).commit()
    pt = pdt.BFLOAT16.vector(3, 2, 4).commit()
    jext = jdt.pack_external(jt, bits.view(jdt.BFLOAT16.base_np), 1)
    pext = pdt.pack_external(pt, bits, 1)
    assert jext == pext
    np.testing.assert_array_equal(np.frombuffer(pext, ">u2"),
                                  bits[[0, 1, 4, 5, 8, 9]])
    out = np.zeros(12, np.uint16)
    pdt.unpack_external(pt, pext, out, 1)
    np.testing.assert_array_equal(out[[0, 1, 4, 5, 8, 9]],
                                  bits[[0, 1, 4, 5, 8, 9]])


def _struct_over_the_wire(M):
    t = M.dt.create_struct([1, 2], [0, 8], [M.dt.FLOAT64, M.dt.INT32]).commit()

    def body(comm):
        raw = bytearray(16)
        raw[0:8] = np.array([6.5]).tobytes()
        raw[8:16] = np.array([11, 13], np.int32).tobytes()
        if comm.rank == 0:
            comm.send(np.frombuffer(bytes(raw), np.uint8), dest=1, tag=1,
                      datatype=t, count=1)
            return True
        out = np.zeros(16, np.uint8)
        comm.recv(buf=out, source=0, tag=1, datatype=t, count=1)
        assert np.frombuffer(bytes(out[0:8]), np.float64)[0] == 6.5
        np.testing.assert_array_equal(
            np.frombuffer(bytes(out[8:16]), np.int32), [11, 13])
        return out

    res = M.run(2, body)
    assert res[0] is True
    return res[1]


def test_struct_over_the_wire():
    both(_struct_over_the_wire)


# ---------------------------------------------------------------------------
# helpers and names (tests/mpi/test_api_parity3.py)
# ---------------------------------------------------------------------------

def _pack_size_and_address_helpers(M):
    dt = M.dt
    v = dt.FLOAT32.vector(3, 2, 4)
    assert dt.pack_size(2, v) == 2 * v.size
    assert dt.pack_external_size(v, 2) == 2 * v.size
    assert dt.type_match_size("real", 8) is dt.FLOAT64
    assert dt.type_match_size("integer", 2) is dt.INT16
    with pytest.raises(M.MPIException):
        dt.type_match_size("real", 3)
    buf = dt.alloc_mem(64)
    assert buf.nbytes == 64
    a = np.arange(4, dtype=np.float64)
    assert dt.get_address(a[2:]) - dt.get_address(a) == 16
    dt.free_mem(buf)
    return (dt.pack_size(2, v), dt.pack_external_size(v, 2), buf,
            dt.type_match_size("complex", 16).name,
            dt.min_span(v, 2))


def test_pack_size_and_address_helpers():
    both(_pack_size_and_address_helpers)


def test_get_address_of_a_tensor():
    torch = pytest.importorskip("torch")
    t = torch.arange(4, dtype=torch.float64)
    assert pdt.get_address(t[2:]) - pdt.get_address(t) == 16
    assert pdt.get_address(t) == t.data_ptr()


def _type_extents_and_names(M):
    v = M.dt.INT32.vector(2, 1, 4)
    assert v.get_extent() == (0, v.extent)
    true_lb, true_ext = v.get_true_extent()
    assert true_lb == 0 and true_ext == 20
    v.set_name("stripes")
    assert v.get_name() == "stripes"
    return v.get_extent(), v.get_true_extent(), v.get_name()


def test_type_extents_and_names():
    both(_type_extents_and_names)


# ---------------------------------------------------------------------------
# envelopes (tests/mpi/test_api_introspection.py)
# ---------------------------------------------------------------------------

def _contents(t):
    """get_contents with the datatype-valued entries named."""
    out = {}
    for k, v in t.get_contents().items():
        if isinstance(v, list) and v and hasattr(v[0], "get_envelope"):
            v = [x.get_name() for x in v]
        elif hasattr(v, "get_envelope"):
            v = v.get_name()
        out[k] = v
    return out


def _envelope_named_and_vector(M):
    env = M.dt.INT32.get_envelope()
    assert env["combiner"] == "named"
    with pytest.raises(M.MPIException):
        M.dt.INT32.get_contents()
    v = M.dt.FLOAT32.vector(3, 2, 4)
    env2 = v.get_envelope()
    assert env2["combiner"] == "vector"
    assert env2["n_integers"] == 3 and env2["n_datatypes"] == 1
    cont = v.get_contents()
    assert (cont["count"], cont["blocklength"], cont["stride"]) == (3, 2, 4)
    assert cont["datatype"] is M.dt.FLOAT32
    return env, env2, _contents(v)


def test_envelope_named_and_vector():
    both(_envelope_named_and_vector)


def _envelope_struct_and_hindexed_addresses(M):
    s = M.dt.create_struct([1, 2], [0, 8], [M.dt.INT32, M.dt.FLOAT64])
    env = s.get_envelope()
    assert env["combiner"] == "struct"
    assert env["n_addresses"] == 2 and env["n_datatypes"] == 2
    assert s.get_contents()["datatypes"][1] is M.dt.FLOAT64
    h = M.dt.INT32.hindexed([1, 1], [0, 16])
    assert h.get_envelope()["combiner"] == "hindexed"
    assert h.get_envelope()["n_addresses"] == 2
    return env, _contents(s), h.get_envelope(), _contents(h)


def test_envelope_struct_and_hindexed_addresses():
    both(_envelope_struct_and_hindexed_addresses)


def _envelope_subarray_darray_reconstructible(M):
    sub = M.dt.FLOAT32.subarray([4, 6], [2, 3], [1, 2], order="F")
    cont = sub.get_contents()
    rebuilt = cont["datatype"].subarray(
        cont["sizes"], cont["subsizes"], cont["starts"], cont["order"])
    assert rebuilt.segments() == sub.segments()
    da = M.dt.create_darray(4, 2, [8], [M.dt.DISTRIBUTE_BLOCK], [-1], [4],
                            M.dt.INT32)
    dcont = da.get_contents()
    assert dcont["rank"] == 2
    rebuilt_d = M.dt.create_darray(
        dcont["size"], dcont["rank"], dcont["gsizes"], dcont["distribs"],
        dcont["dargs"], dcont["psizes"], dcont["datatype"], dcont["order"])
    assert rebuilt_d.segments() == da.segments()
    return (_contents(sub), sub.segments(), _contents(da), da.segments(),
            da.get_envelope())


def test_envelope_subarray_darray_reconstructible():
    both(_envelope_subarray_darray_reconstructible)


_CONSTRUCTORS = {
    "contiguous": lambda dt: dt.INT32.contiguous(3),
    "vector": lambda dt: dt.INT32.vector(2, 2, 3),
    "hvector": lambda dt: dt.INT32.hvector(2, 1, 12),
    "indexed": lambda dt: dt.INT32.indexed([1, 2], [4, 0]),
    "indexed_block": lambda dt: dt.INT32.indexed_block(2, [3, 0]),
    "hindexed": lambda dt: dt.INT32.hindexed([1, 1], [8, 0]),
    "hindexed_block": lambda dt: dt.INT32.hindexed_block(1, [4, 12]),
    "resized": lambda dt: dt.INT32.vector(2, 1, 2).resized(32),
    "struct": lambda dt: dt.create_struct([1, 1], [0, 8],
                                          [dt.INT32, dt.FLOAT64]),
    "struct_resized": lambda dt: dt.create_struct(
        [1], [0], [dt.INT32]).resized(8),
    "subarray": lambda dt: dt.create_subarray([4, 4], [2, 2], [1, 1],
                                              dt.INT32),
    "darray": lambda dt: dt.create_darray(
        4, 3, [6, 6], [dt.DISTRIBUTE_CYCLIC, dt.DISTRIBUTE_BLOCK],
        [2, dt.DISTRIBUTE_DFLT_DARG], [2, 2], dt.INT32),
}


def _stamped(M, name):
    t = _CONSTRUCTORS[name](M.dt)
    env = t.get_envelope()
    cont = _contents(t) if env["combiner"] != "named" else None
    return env, cont, t.get_name(), t.get_true_extent(), t.segments()


@pytest.mark.parametrize("name", sorted(_CONSTRUCTORS))
def test_every_constructor_stamps_as_the_jax_package(name):
    both(_stamped, name)


def test_darray_of_a_large_grid_is_cheap():
    """A 16384 × 16384 block darray (one rank's 8192 rows) builds its
    8192 runs without a per-item walk."""
    t = pdt.create_darray(4, 3, [16384, 16384],
                          [pdt.DISTRIBUTE_BLOCK] * 2,
                          [pdt.DISTRIBUTE_DFLT_DARG] * 2, [2, 2],
                          pdt.FLOAT32).commit()
    offs, lens = t.segment_arrays()
    assert len(offs) == 8192 and bool((lens == 8192 * 4).all())
    rows = np.arange(8192, 16384, dtype=np.int64)
    np.testing.assert_array_equal(offs, (rows * 16384 + 8192) * 4)
    # the same rule on a small grid, against the JAX package's walk
    small = [jdt.create_darray(4, r, [16, 16], [jdt.DISTRIBUTE_BLOCK] * 2,
                               [jdt.DISTRIBUTE_DFLT_DARG] * 2, [2, 2],
                               jdt.FLOAT32).segments() for r in range(4)]
    assert small == [pdt.create_darray(
        4, r, [16, 16], [pdt.DISTRIBUTE_BLOCK] * 2,
        [pdt.DISTRIBUTE_DFLT_DARG] * 2, [2, 2], pdt.FLOAT32).segments()
        for r in range(4)]
    assert list(itertools.chain(*small))
