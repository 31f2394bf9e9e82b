"""Datatype engine: typed memory layouts and their device pack (the port's
trimmed copy of the JAX package's ``mpi/datatype.py``).

≈ the reference's two-level datatype system — opal/datatype (the compiled
dt_elem_desc descriptors, opal_datatype.h:104) + ompi/datatype (MPI
metadata and constructors, ompi_datatype.h:178-189).  A derived datatype
compiles to byte (offset, length) runs per item and to ``element_indices``,
the flat element positions one item covers.  The device path packs with
one ``torch.index_select`` over those positions and unpacks with one
``index_put_`` into a zeroed tensor (the JAX package's ``jnp.take`` and
``.at[idx].set``), so a noncontiguous send becomes one gather on the
device instead of a host byte loop.  The index tensor is made once per
``(datatype, count, device)``; a repeated pack makes no host-to-device
copy.

The host convertor (pack/unpack into bytes, the native pack, ``PackPlan``)
is host plane and not ported yet (ROADMAP.md Queue 1 item 6).
"""

from __future__ import annotations

import itertools
import threading
from typing import Optional, Sequence

import numpy as np
import torch

from ompi_tpu_torch.mpi.constants import MPIException

__all__ = [
    "Datatype", "PredefinedDatatype", "DerivedDatatype", "StructDatatype",
    "create_struct", "create_subarray",
    "BYTE", "INT8", "UINT8", "INT16", "UINT16", "INT32",
    "UINT32", "INT64", "UINT64", "FLOAT16", "BFLOAT16", "FLOAT32", "FLOAT64",
    "COMPLEX64", "COMPLEX128", "BOOL", "FLOAT", "DOUBLE", "INT", "LONG",
    "CHAR", "FLOAT_INT", "DOUBLE_INT", "LONG_INT",
]


class Datatype:
    """Base: a typed memory layout. ``size`` = payload bytes per item,
    ``extent`` = bytes spanned per item (≥ size for strided layouts)."""

    size: int
    extent: int
    base_np: np.dtype  # element dtype (its itemsize is the element unit)

    def commit(self) -> "Datatype":
        """Compile the layout (≈ MPI_Type_commit → opal_datatype_commit)."""
        return self

    def get_extent(self) -> tuple[int, int]:
        """≈ MPI_Type_get_extent → (lb, extent).  This layout model has no
        negative lower bounds; lb is always 0 and resized() adjusts only
        the extent."""
        return 0, self.extent

    # -- layout queries ---------------------------------------------------

    def segment_arrays(self) -> tuple[np.ndarray, np.ndarray]:
        """Byte (offsets, lengths) runs for ONE item, offsets within
        extent, as int64 arrays."""
        raise NotImplementedError

    def element_indices(self) -> np.ndarray:
        """Flat element positions (in units of base_np) for one item, within
        extent/base_np.itemsize positions — the gather map for device packs."""
        raise NotImplementedError

    # -- device path (index_select / index_put_) ---------------------------

    def _device_index(self, count: int, device: torch.device) -> torch.Tensor:
        """The int64 gather map of ``count`` items on ``device``, made once
        per (count, device)."""
        cache = self.__dict__.setdefault("_dev_idx", {})
        key = (int(count), device)
        idx = cache.get(key)
        if idx is None:
            idx1 = self.element_indices()
            stride = self._elem_stride()
            if count == 1:
                host = idx1
            else:
                host = (np.arange(count, dtype=np.int64)[:, None] * stride
                        + idx1[None, :]).ravel()
            idx = torch.as_tensor(host, dtype=torch.int64, device=device)
            cache[key] = idx
        return idx

    def pack_device(self, arr: torch.Tensor, count: int = 1) -> torch.Tensor:
        """Device-side pack: gather this layout's elements from a tensor
        with ONE ``torch.index_select``.  Returns a flat tensor of
        ``count * size / itemsize`` elements on the tensor's device."""
        idx = self._device_index(count, arr.device)
        return torch.index_select(arr.reshape(-1), 0, idx)

    def _elem_stride(self) -> int:
        isz = self.base_np.itemsize
        if self.extent % isz:
            raise MPIException(
                f"datatype {getattr(self, 'name', '?')}: extent "
                f"{self.extent}B is not a multiple of the base dtype "
                f"({self.base_np}, {isz}B); the device gather cannot "
                f"stride it — use the host pack/unpack path")
        return self.extent // isz

    def unpack_device(self, data: torch.Tensor, count: int = 1,
                      total_elems: Optional[int] = None) -> torch.Tensor:
        """Device-side unpack: scatter a flat element stream into a new
        zeroed tensor of ``total_elems`` elements (default: count*extent
        worth) with ONE ``index_put_``."""
        idx = self._device_index(count, data.device)
        n = (total_elems if total_elems is not None
             else count * self._elem_stride())
        out = torch.zeros((n,), dtype=data.dtype, device=data.device)
        return out.index_put_((idx,), data.reshape(-1))

    # -- constructors (≈ ompi_datatype.h:178-197) -------------------------

    def contiguous(self, count: int) -> "DerivedDatatype":
        return DerivedDatatype(self, [(0, count)], name=f"contig({count})")

    def vector(self, count: int, blocklength: int,
               stride: int) -> "DerivedDatatype":
        count, blocklength, stride = int(count), int(blocklength), int(stride)
        natural = 0 if count == 0 else (
            ((count - 1) * stride if stride >= 0 else 0)
            + blocklength) * self.extent
        return DerivedDatatype(
            self, (np.arange(count, dtype=np.int64) * (stride * self.extent),
                   np.full(count, blocklength, np.int64)),
            extent=natural, pattern_unit="bytes",
            name=f"vector({count},{blocklength},{stride})")

    def hvector(self, count: int, blocklength: int,
                byte_stride: int) -> "DerivedDatatype":
        """≈ MPI_Type_create_hvector: stride in BYTES."""
        count, blocklength = int(count), int(blocklength)
        byte_stride = int(byte_stride)
        natural = 0 if count == 0 else (
            ((count - 1) * byte_stride if byte_stride >= 0 else 0)
            + blocklength * self.extent)
        return DerivedDatatype(
            self, (np.arange(count, dtype=np.int64) * byte_stride,
                   np.full(count, blocklength, np.int64)),
            extent=natural, pattern_unit="bytes",
            name=f"hvector({count},{blocklength},{byte_stride}B)")

    def indexed(self, blocklengths: Sequence[int],
                displacements: Sequence[int]) -> "DerivedDatatype":
        if len(blocklengths) != len(displacements):
            raise MPIException("indexed: blocklengths/displacements mismatch")
        return DerivedDatatype(
            self, [(d, b) for d, b in zip(displacements, blocklengths)],
            name=f"indexed({len(blocklengths)})")

    def indexed_block(self, blocklength: int,
                      displacements: Sequence[int]) -> "DerivedDatatype":
        """≈ MPI_Type_create_indexed_block: one blocklength for all."""
        return DerivedDatatype(
            self, [(d, blocklength) for d in displacements],
            name=f"indexed_block({blocklength},{len(displacements)})")

    def hindexed(self, blocklengths: Sequence[int],
                 byte_displacements: Sequence[int]) -> "DerivedDatatype":
        """≈ MPI_Type_create_hindexed: displacements in BYTES."""
        if len(blocklengths) != len(byte_displacements):
            raise MPIException(
                "hindexed: blocklengths/displacements mismatch")
        return DerivedDatatype(
            self, list(zip(byte_displacements, blocklengths)),
            pattern_unit="bytes", name=f"hindexed({len(blocklengths)})")

    def hindexed_block(self, blocklength: int,
                       byte_displacements: Sequence[int]) -> "DerivedDatatype":
        """≈ MPI_Type_create_hindexed_block."""
        return DerivedDatatype(
            self, [(d, blocklength) for d in byte_displacements],
            pattern_unit="bytes",
            name=f"hindexed_block({blocklength},{len(byte_displacements)})")

    def resized(self, extent: int) -> "DerivedDatatype":
        """≈ MPI_Type_create_resized: the base's layout, a new extent."""
        dt = DerivedDatatype(self, [(0, 1)], extent=extent,
                             name=f"resized({extent})")
        dt.size = self.size
        dt._seg_arrs = self.segment_arrays()
        return dt

    def subarray(self, sizes: Sequence[int], subsizes: Sequence[int],
                 starts: Sequence[int], order: str = "C") -> "DerivedDatatype":
        """≈ MPI_Type_create_subarray (C or Fortran order)."""
        return create_subarray(sizes, subsizes, starts, self, order)


def _concat_aranges(offsets: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """``concatenate([arange(o, o + l) for o, l in zip(...)])`` without a
    python loop (the convertor's flattened gather map)."""
    total = int(lengths.sum())
    cum = np.concatenate([[0], np.cumsum(lengths)[:-1]]).astype(np.int64)
    return (np.arange(total, dtype=np.int64)
            - np.repeat(cum, lengths) + np.repeat(offsets, lengths))


def _merge_adjacent(starts: np.ndarray, lens: np.ndarray
                    ) -> tuple[np.ndarray, np.ndarray]:
    """Coalesce abutting byte runs in declaration order: a run starting
    exactly where the previous one ended merges into it."""
    if len(starts) == 0:
        return (np.empty(0, np.int64), np.empty(0, np.int64))
    brk = np.empty(len(starts), bool)
    brk[0] = True
    np.not_equal(starts[1:], starts[:-1] + lens[:-1], out=brk[1:])
    gi = np.flatnonzero(brk)
    return (np.ascontiguousarray(starts[gi]),
            np.ascontiguousarray(np.add.reduceat(lens, gi)))


class PredefinedDatatype(Datatype):
    """A basic type wrapping a numpy dtype (≈ the 25 predefined opal types)."""

    def __init__(self, np_dtype, name: str) -> None:
        self.base_np = np.dtype(np_dtype)
        self.size = self.base_np.itemsize
        self.extent = self.base_np.itemsize
        self.name = name

    def segment_arrays(self) -> tuple[np.ndarray, np.ndarray]:
        return np.zeros(1, np.int64), np.full(1, self.size, np.int64)

    def element_indices(self) -> np.ndarray:
        return np.zeros(1, dtype=np.int64)

    def __repr__(self) -> str:
        return f"Datatype({self.name})"


class DerivedDatatype(Datatype):
    """A constructed layout, compiled to byte segments at commit.

    The pattern is held as (byte_offset, item_count) runs — byte granular
    so the h-constructors (hvector/hindexed, ompi_datatype.h:181-197) fall
    out of the same machinery as the element-offset ones.
    """

    def __init__(self, base: Datatype, pattern,
                 extent: Optional[int] = None, name: str = "derived",
                 pattern_unit: str = "items") -> None:
        # pattern: (offset, item_count) runs — a list of tuples, or an
        # (offsets, counts) array pair; offset is in base items ("items")
        # or raw bytes ("bytes", the MPI h* constructors)
        self.base = base
        if isinstance(pattern, tuple) and len(pattern) == 2 and \
                isinstance(pattern[0], np.ndarray):
            offs = np.ascontiguousarray(pattern[0], np.int64)
            cnts = np.ascontiguousarray(pattern[1], np.int64)
        else:
            pat = np.asarray(pattern, np.int64).reshape(-1, 2)
            offs = np.ascontiguousarray(pat[:, 0])
            cnts = np.ascontiguousarray(pat[:, 1])
        if pattern_unit == "items":
            offs = offs * base.extent
        elif pattern_unit != "bytes":
            raise MPIException(f"bad pattern_unit {pattern_unit!r}")
        self._pat_off, self._pat_cnt = offs, cnts
        self.base_np = base.base_np
        self.name = name
        self.size = int(cnts.sum()) * base.size
        if extent is not None:
            self.extent = extent
        else:
            self.extent = (int((offs + cnts * base.extent).max())
                           if len(offs) else 0)
        self._lock = threading.Lock()
        self._seg_arrs: Optional[tuple[np.ndarray, np.ndarray]] = None
        self._elem_idx: Optional[np.ndarray] = None

    def commit(self) -> "DerivedDatatype":
        self.segment_arrays()
        return self

    def segment_arrays(self) -> tuple[np.ndarray, np.ndarray]:
        with self._lock:
            if self._seg_arrs is None:
                self._seg_arrs = self._build_segments()
            return self._seg_arrs

    def _build_segments(self) -> tuple[np.ndarray, np.ndarray]:
        boffs, blens = self.base.segment_arrays()
        # zero-count runs are legal MPI (indexed blocklength 0) and
        # contribute nothing
        pos = self._pat_cnt > 0
        poffs, pcnts = self._pat_off[pos], self._pat_cnt[pos]
        bext = self.base.extent
        if len(boffs) == 1 and boffs[0] == 0 and blens[0] == bext:
            # contiguous base (every predefined type): a pattern run of
            # cnt items IS one segment
            starts, lens = poffs, pcnts * bext
        else:
            # expand items × base segments: item origins, then an outer
            # sum with the base's segment offsets
            origins = (_concat_aranges(np.zeros(len(poffs), np.int64),
                                       pcnts) * bext
                       + np.repeat(poffs, pcnts))
            starts = (origins[:, None] + boffs[None, :]).reshape(-1)
            lens = np.broadcast_to(
                blens[None, :], (len(origins), len(boffs))).reshape(-1)
        # merge adjacent-in-declaration-order runs; NOT sorted: MPI pack
        # order is declaration order
        return _merge_adjacent(starts, lens)

    def element_indices(self) -> np.ndarray:
        if self._elem_idx is None:
            isz = self.base_np.itemsize
            offs, lens = self.segment_arrays()
            if len(offs) == 0:
                self._elem_idx = np.empty(0, np.int64)
                return self._elem_idx
            if (offs % isz).any() or (lens % isz).any():
                raise MPIException(
                    f"datatype {self.name}: segments not aligned to "
                    f"base dtype {self.base_np}")
            self._elem_idx = _concat_aranges(offs // isz, lens // isz)
        return self._elem_idx

    def __repr__(self) -> str:
        return f"Datatype({self.name}, size={self.size}, extent={self.extent})"


class StructDatatype(Datatype):
    """≈ MPI_Type_create_struct (ompi_datatype.h:187): blocks of DIFFERENT
    base datatypes at byte displacements.

    Heterogeneous layouts have no single element dtype, so the typing
    granularity is the byte (``base_np = uint8``) and the device gather
    (element_indices) is undefined: struct stays a host-path type.
    """

    def __init__(self, blocklengths: Sequence[int],
                 byte_displacements: Sequence[int],
                 datatypes: Sequence[Datatype],
                 name: Optional[str] = None) -> None:
        if not (len(blocklengths) == len(byte_displacements)
                == len(datatypes)):
            raise MPIException(
                "struct: blocklengths/displacements/datatypes length "
                "mismatch")
        self.fields = [(int(d), int(b), t) for d, b, t in
                       zip(byte_displacements, blocklengths, datatypes)]
        self.base_np = np.dtype(np.uint8)
        self.size = sum(b * t.size for _, b, t in self.fields)
        self.extent = max((d + b * t.extent for d, b, t in self.fields),
                          default=0)
        self.name = name or f"struct({len(self.fields)})"

    def segment_arrays(self) -> tuple[np.ndarray, np.ndarray]:
        starts, lens = [], []
        for disp, cnt, t in self.fields:
            for i in range(cnt):
                boffs, blens = t.segment_arrays()
                starts.append(disp + i * t.extent + boffs)
                lens.append(blens)
        if not starts:
            return np.empty(0, np.int64), np.empty(0, np.int64)
        return _merge_adjacent(np.concatenate(starts), np.concatenate(lens))

    def element_indices(self) -> np.ndarray:
        raise MPIException(
            f"{self.name}: struct datatypes mix base dtypes; the device "
            f"gather path needs a uniform element type (host path only)")

    def __repr__(self) -> str:
        return f"Datatype({self.name}, size={self.size}, extent={self.extent})"


def create_struct(blocklengths: Sequence[int],
                  byte_displacements: Sequence[int],
                  datatypes: Sequence[Datatype]) -> StructDatatype:
    """≈ MPI_Type_create_struct."""
    return StructDatatype(blocklengths, byte_displacements, datatypes)


def create_subarray(sizes: Sequence[int], subsizes: Sequence[int],
                    starts: Sequence[int], base: Datatype,
                    order: str = "C") -> DerivedDatatype:
    """≈ MPI_Type_create_subarray: an n-d sub-block of an n-d array.
    Extent spans the WHOLE array (MPI semantics), so count>1 tiles whole
    arrays."""
    nd = len(sizes)
    if not (len(subsizes) == len(starts) == nd):
        raise MPIException("subarray: sizes/subsizes/starts rank mismatch")
    for d in range(nd):
        if subsizes[d] < 0 or starts[d] < 0 or \
                starts[d] + subsizes[d] > sizes[d]:
            raise MPIException(
                f"subarray: dim {d} out of bounds "
                f"(start {starts[d]} + sub {subsizes[d]} > {sizes[d]})")
    if order.upper() not in ("C", "F"):
        raise MPIException(f"subarray: order must be C or F, got {order!r}")
    if order.upper() == "F":  # mirror: first dimension varies fastest
        sizes, subsizes, starts = sizes[::-1], subsizes[::-1], starts[::-1]
    # item strides, last dim fastest
    strides = [1] * nd
    for d in range(nd - 2, -1, -1):
        strides[d] = strides[d + 1] * sizes[d + 1]
    run = subsizes[-1]  # innermost contiguous run, in items
    pattern: list[tuple[int, int]] = []
    for idx in itertools.product(*(range(s) for s in subsizes[:-1])):
        off = starts[-1]
        for d, i in enumerate(idx):
            off += (starts[d] + i) * strides[d]
        pattern.append((off, run))
    return DerivedDatatype(
        base, pattern, extent=int(np.prod(sizes)) * base.extent,
        name=f"subarray({tuple(subsizes)}/{tuple(sizes)})")


# Predefined types (≈ opal_datatype.h:51-52's 25 predefined + MPI aliases)
BYTE = PredefinedDatatype(np.uint8, "byte")
INT8 = PredefinedDatatype(np.int8, "int8")
UINT8 = PredefinedDatatype(np.uint8, "uint8")
INT16 = PredefinedDatatype(np.int16, "int16")
UINT16 = PredefinedDatatype(np.uint16, "uint16")
INT32 = PredefinedDatatype(np.int32, "int32")
UINT32 = PredefinedDatatype(np.uint32, "uint32")
INT64 = PredefinedDatatype(np.int64, "int64")
UINT64 = PredefinedDatatype(np.uint64, "uint64")
FLOAT16 = PredefinedDatatype(np.float16, "float16")
# numpy has no bfloat16 (the JAX package takes ml_dtypes'): its 2-byte
# element is what the layout needs, and the device pack keeps the
# tensor's own dtype
BFLOAT16 = PredefinedDatatype(np.uint16, "bfloat16")
FLOAT32 = PredefinedDatatype(np.float32, "float32")
FLOAT64 = PredefinedDatatype(np.float64, "float64")
COMPLEX64 = PredefinedDatatype(np.complex64, "complex64")
COMPLEX128 = PredefinedDatatype(np.complex128, "complex128")
BOOL = PredefinedDatatype(np.bool_, "bool")

# MPI-spelling aliases
FLOAT = FLOAT32
DOUBLE = FLOAT64
INT = INT32
LONG = INT64
CHAR = INT8

# Pair types for MAXLOC/MINLOC (value, index) — structured dtypes
FLOAT_INT = PredefinedDatatype(
    np.dtype([("val", np.float32), ("loc", np.int32)]), "float_int")
DOUBLE_INT = PredefinedDatatype(
    np.dtype([("val", np.float64), ("loc", np.int32)]), "double_int")
LONG_INT = PredefinedDatatype(
    np.dtype([("val", np.int64), ("loc", np.int32)]), "long_int")
