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

The host convertor packs into bytes for the PML's send/recv
(``datatype=``): ``pack_plan`` compiles a ``(datatype, count)`` pair to
one of four executors (one memcpy, a strided block copy, one gather
over the coalesced runs, or, past ``_PLAN_EXPAND_CAP`` runs, a walk of
one item's runs ``count`` times).  A plan other than the memcpy of at least
``_NATIVE_MIN_BYTES`` runs through the compiled walk of
``_native/convertor.cpp`` (its ``uniform`` hint specialises the inner
copy), and through numpy when the library did not build or
``OMPI_TPU_NO_NATIVE=1``; both move the same bytes.  ``stats`` counts
every pack and unpack (the copy-counting hook the transport tests read).
The trace plane's sites are the JAX package's: a committed derived or
struct datatype bumps ``convertor_plan_<kind>_total`` once (with a
``commit:<kind>`` instant when the timeline is armed), and every pack
and unpack that moves bytes records a ``pack:<kind>``/``unpack:<kind>``
span.

Every constructor stamps its combiner and arguments (``get_envelope``/
``get_contents``, as MPI_Type_get_envelope/contents), so a type rebuilds
from its envelope.  ``create_darray`` cuts a block/cyclic distributed
n-d array (the file views of MPI-IO read it), and ``pack_external``/
``unpack_external`` write the canonical big-endian external32 stream:
each element of the packed stream is byte-swapped at its own width,
bfloat16 (held as its 2-byte bits) included.
"""

from __future__ import annotations

import ctypes
import itertools
import sys
import threading
from typing import Optional, Sequence

import numpy as np

from ompi_tpu_torch.core.buffer import is_tensor
from ompi_tpu_torch.mpi import trace as trace_mod
from ompi_tpu_torch.mpi.constants import MPIException

__all__ = [
    "Datatype", "PredefinedDatatype", "DerivedDatatype", "StructDatatype",
    "create_struct", "create_subarray",
    "BYTE", "INT8", "UINT8", "INT16", "UINT16", "INT32",
    "UINT32", "INT64", "UINT64", "FLOAT16", "BFLOAT16", "FLOAT32", "FLOAT64",
    "COMPLEX64", "COMPLEX128", "BOOL", "FLOAT", "DOUBLE", "INT", "LONG",
    "CHAR", "FLOAT_INT", "DOUBLE_INT", "LONG_INT", "PackPlan",
    "ConvertorStats", "stats", "from_numpy", "create_darray",
    "DISTRIBUTE_NONE", "DISTRIBUTE_BLOCK", "DISTRIBUTE_CYCLIC",
    "DISTRIBUTE_DFLT_DARG", "pack_external", "unpack_external",
    "pack_external_size", "pack_size", "type_match_size", "get_address",
    "alloc_mem", "free_mem", "min_span",
]

# native convertor (_native/convertor.cpp): used above this payload size;
# below it, ctypes call overhead beats the numpy gather it would replace
_NATIVE_MIN_BYTES = 256

# expanded pack plans above this run count keep the per-item walk instead
# (a count × nruns materialization must not cost more memory than the
# payload it moves)
_PLAN_EXPAND_CAP = 1 << 22

_U8P = ctypes.POINTER(ctypes.c_uint8)
_I64P = ctypes.POINTER(ctypes.c_int64)


def _native_convertor(nbytes: int):
    if nbytes < _NATIVE_MIN_BYTES:
        return None
    from ompi_tpu_torch import _native  # cheap after first import

    return _native.lib()


class ConvertorStats:
    """Pack/unpack call counters — the copy-counting hook transport tests
    use to assert a zero-copy path really took no pack round-trip.

    The counters are process-wide, so a *delta* measured against them is
    only meaningful while nothing else in the process converts.  Tests
    that need attribution register a *listener* instead:
    ``add_listener(cb)`` gets ``cb(kind, nbytes)`` per pack/unpack
    ("pack"/"unpack", plan.total).  ``reset()`` leaves listeners alone."""

    __slots__ = ("pack_calls", "unpack_calls", "pack_bytes",
                 "unpack_bytes", "_listeners")

    def __init__(self) -> None:
        self._listeners: list = []
        self.reset()

    def reset(self) -> None:
        self.pack_calls = 0
        self.unpack_calls = 0
        self.pack_bytes = 0
        self.unpack_bytes = 0

    def add_listener(self, cb) -> None:
        """Register ``cb(kind, nbytes)``; fired per pack/unpack call."""
        self._listeners.append(cb)

    def remove_listener(self, cb) -> None:
        try:
            self._listeners.remove(cb)
        except ValueError:
            pass

    def note(self, kind: str, nbytes: int) -> None:
        """Count one conversion (call sites; one branch when silent)."""
        if kind == "pack":
            self.pack_calls += 1
            self.pack_bytes += nbytes
        else:
            self.unpack_calls += 1
            self.unpack_bytes += nbytes
        if self._listeners:
            for cb in list(self._listeners):
                cb(kind, nbytes)


#: process-wide convertor counters (observability hook, not a hot metric)
stats = ConvertorStats()

#: plan kinds exported as commit-time counters
#: (``convertor_plan_<kind>_total`` pvars — see ompi_tpu_torch.mpi.trace)
_PLAN_COUNTED = frozenset(("single", "strided", "runs", "items"))


def _count_commit_plan(dt: "Datatype", first: bool) -> None:
    """Bump the pack-plan-class counter for a freshly committed datatype
    (once per datatype: re-commits are MPI-legal no-ops)."""
    if not first:
        return
    kind = dt.pack_plan(1).kind
    if kind in _PLAN_COUNTED:
        trace_mod.count(f"convertor_plan_{kind}_total")
        if trace_mod.active:
            trace_mod.instant(
                "datatype", f"commit:{kind}",
                dtname=getattr(dt, "name", type(dt).__name__),
                size=dt.size, extent=dt.extent)


def _u8p(arr: np.ndarray):
    return arr.ctypes.data_as(_U8P)


def _i64p(arr: np.ndarray):
    return arr.ctypes.data_as(_I64P)


class PackPlan:
    """A compiled pack program for one ``(datatype, count)`` pair —
    ≈ the reference's optimized dt_elem_desc chain (opal_datatype_optimize).

    ``kind`` selects the executor:

    - ``"empty"``    nothing to move.
    - ``"single"``   ONE memcpy: ``[start, start + total)`` — the plan
                     collapsed (contiguous layout, any count).
    - ``"strided"``  ``nblocks`` blocks of ``blocklen`` bytes, block i at
                     ``start + i*stride`` — vector-class layouts need no
                     per-run metadata at all.
    - ``"runs"``     absolute coalesced ``(offsets, lengths)`` runs
                     covering ALL count items (abutting runs merged, across
                     item boundaries when the extent makes items abut),
                     moved with one numpy fancy-index copy.
    - ``"items"``    per-item runs walked ``count`` times at ``extent``
                     stride (plans too large to expand, > _PLAN_EXPAND_CAP).

    ``uniform`` is the shared run length when every run is equal (0
    otherwise) — the native walk specializes its inner copy on it.
    ``span`` is the user-buffer bytes the plan touches (validation bound).
    """

    __slots__ = ("kind", "total", "span", "start", "nblocks", "blocklen",
                 "stride", "offsets", "lengths", "uniform", "count",
                 "extent", "item_size")

    def __init__(self, kind: str, total: int, span: int) -> None:
        self.kind = kind
        self.total = total
        self.span = span
        self.start = 0
        self.nblocks = 0
        self.blocklen = 0
        self.stride = 0
        self.offsets: Optional[np.ndarray] = None
        self.lengths: Optional[np.ndarray] = None
        self.uniform = 0
        self.count = 0
        self.extent = 0
        self.item_size = 0

    @property
    def single_run(self) -> bool:
        """Plan collapsed to one memcpy (the zero-copy gate consumers
        check before sending a buffer view instead of packing)."""
        return self.kind == "single"

    def __repr__(self) -> str:  # debugging aid
        return (f"PackPlan({self.kind}, total={self.total}, "
                f"span={self.span})")


def _plan_empty() -> PackPlan:
    return PackPlan("empty", 0, 0)


def _plan_single(start: int, total: int) -> PackPlan:
    p = PackPlan("single", total, start + total)
    p.start = start
    return p


def _plan_strided(start: int, nblocks: int, blocklen: int,
                  stride: int) -> PackPlan:
    if blocklen == stride and nblocks > 1:  # blocks abut: collapse
        return _plan_single(start, nblocks * blocklen)
    if nblocks == 1:
        return _plan_single(start, blocklen)
    p = PackPlan("strided", nblocks * blocklen,
                 start + (nblocks - 1) * stride + blocklen)
    p.start = start
    p.nblocks = nblocks
    p.blocklen = blocklen
    p.stride = stride
    p.uniform = blocklen
    return p


def _plan_runs(offsets: np.ndarray, lengths: np.ndarray) -> PackPlan:
    if len(offsets) == 1:
        return _plan_single(int(offsets[0]), int(lengths[0]))
    p = PackPlan("runs", int(lengths.sum()),
                 int((offsets + lengths).max()))
    p.offsets = np.ascontiguousarray(offsets, np.int64)
    p.lengths = np.ascontiguousarray(lengths, np.int64)
    p.uniform = _uniform_of(lengths)
    return p


def _uniform_of(lengths: np.ndarray) -> int:
    if len(lengths) == 0:
        return 0
    first = int(lengths[0])
    return first if bool((lengths == first).all()) else 0


def _plan_items(offsets: np.ndarray, lengths: np.ndarray, count: int,
                extent: int, item_size: int) -> PackPlan:
    item_end = int((offsets + lengths).max())
    p = PackPlan("items", count * item_size,
                 (count - 1) * extent + item_end)
    p.offsets = np.ascontiguousarray(offsets, np.int64)
    p.lengths = np.ascontiguousarray(lengths, np.int64)
    p.uniform = _uniform_of(lengths)
    p.count = count
    p.extent = extent
    p.item_size = item_size
    return p


class Datatype:
    """Base: a typed memory layout. ``size`` = payload bytes per item,
    ``extent`` = bytes spanned per item (≥ size for strided layouts)."""

    size: int
    extent: int
    base_np: np.dtype  # element dtype (its itemsize is the element unit)

    _committed = False
    combiner: str = "named"          # ≈ MPI_COMBINER_* (envelope)
    _contents: Optional[dict] = None  # constructor args (get_contents)

    def commit(self) -> "Datatype":
        """Compile the layout (≈ MPI_Type_commit → opal_datatype_commit)."""
        self._committed = True
        return self

    @property
    def committed(self) -> bool:
        return self._committed

    # -- introspection (≈ type_get_envelope.c / type_get_contents.c) ------

    def get_envelope(self) -> dict:
        """≈ MPI_Type_get_envelope: the combiner this type was built with
        plus argument counts (integers / byte-addresses / datatypes)."""
        if self._contents is None:
            return {"combiner": "named", "n_integers": 0, "n_addresses": 0,
                    "n_datatypes": 0}
        ni = na = nd = 0
        for k, v in self._contents.items():
            addr = k in _ADDRESS_KEYS
            if isinstance(v, Datatype):
                nd += 1
            elif isinstance(v, (list, tuple)):
                if v and all(isinstance(x, Datatype) for x in v):
                    nd += len(v)
                elif addr:
                    na += len(v)
                else:
                    ni += len(v)
            elif addr:
                na += 1
            else:
                ni += 1
        return {"combiner": self.combiner, "n_integers": ni,
                "n_addresses": na, "n_datatypes": nd}

    def get_contents(self) -> dict:
        """≈ MPI_Type_get_contents: the constructor arguments, by name
        (datatype-valued entries are the live input type objects).
        Erroneous on predefined types, as in MPI."""
        if self._contents is None:
            raise MPIException(
                "get_contents on a predefined (named) datatype",
                error_class=3)
        return dict(self._contents)

    def get_extent(self) -> tuple[int, int]:
        """≈ MPI_Type_get_extent → (lb, extent).  This layout model has no
        negative lower bounds; lb is always 0 and resized() adjusts only
        the extent."""
        return 0, self.extent

    def get_true_extent(self) -> tuple[int, int]:
        """≈ MPI_Type_get_true_extent → (true_lb, true_extent): the span
        actually touched by the data, ignoring the declared extent."""
        offs, lens = self.segment_arrays()
        if len(offs) == 0:
            return 0, 0
        lo = int(offs.min())
        return lo, int((offs + lens).max()) - lo

    def get_name(self) -> str:
        """≈ MPI_Type_get_name."""
        return getattr(self, "name", type(self).__name__)

    def set_name(self, name: str) -> None:
        """≈ MPI_Type_set_name."""
        self.name = str(name)

    # -- layout queries ---------------------------------------------------

    def segment_arrays(self) -> tuple[np.ndarray, np.ndarray]:
        """Byte (offsets, lengths) runs for ONE item, offsets within
        extent, as int64 arrays."""
        raise NotImplementedError

    def segments(self) -> list[tuple[int, int]]:
        """``segment_arrays()`` as a list of (offset, length) tuples."""
        offs, lens = self.segment_arrays()
        return list(zip(offs.tolist(), lens.tolist()))

    def _byte_index(self, count: int) -> np.ndarray:
        """The byte positions ``count`` items cover, item after item at
        ``extent`` stride (the gather map of the numpy per-item walk)."""
        offs, lens = self.segment_arrays()
        if len(offs) == 0:
            return np.empty(0, np.int64)
        idx1 = _concat_aranges(offs, lens)
        if count == 1:
            return idx1
        base = np.arange(count, dtype=np.int64)[:, None] * self.extent
        return (base + idx1[None, :]).ravel()

    def element_indices(self) -> np.ndarray:
        """Flat element positions (in units of base_np) for one item, within
        extent/base_np.itemsize positions — the gather map for device packs."""
        raise NotImplementedError

    @property
    def elements_per_item(self) -> int:
        return self.size // self.base_np.itemsize

    # -- pack/unpack (host path; ≈ opal_convertor_pack/unpack) ------------

    @property
    def is_contiguous(self) -> bool:
        """One gap-free run per item, items abutting — memcpy territory."""
        offs, lens = self.segment_arrays()
        return (len(offs) == 1 and int(offs[0]) == 0
                and int(lens[0]) == self.size
                and self.extent == self.size)

    # -- pack plans (the run-coalescing compiled convertor) ---------------

    def pack_plan(self, count: int) -> PackPlan:
        """The compiled pack program for ``count`` items — cached per
        ``(datatype, count)`` on this object (benign-race cache: a lost
        race rebuilds an identical plan)."""
        count = int(count)
        cache = self.__dict__.setdefault("_plan_cache", {})
        plan = cache.get(count)
        if plan is None:
            plan = self._build_plan(count)
            if len(cache) >= 16:   # bound: plans are per-count.  Evict
                # ONE entry, never the commit-warmed count=1 plan — a
                # full clear would make every 17th distinct count repay
                # the whole expansion (the cliff commit() exists to
                # avoid).  Predefined types are process-wide singletons
                # hit from app AND reader threads, so the lockless
                # eviction must tolerate concurrent mutation: pop() with
                # a default, and a racing resize aborts this round's
                # eviction instead of raising out of send/recv.
                try:
                    cache.pop(next(k for k in cache if k != 1), None)
                except (StopIteration, RuntimeError):
                    pass
            cache[count] = plan
        return plan

    def _build_plan(self, count: int) -> PackPlan:
        if count <= 0 or self.size == 0:
            return _plan_empty()
        ext = self.extent
        # affine layouts (vector/hvector over a dense base) plan as one
        # strided walk
        aff = getattr(self, "_affine", None)
        if aff is not None:
            start, nblocks, bl, stride = aff
            per_item = _plan_strided(start, nblocks, bl, stride)
            if count == 1:
                return per_item
            if per_item.kind == "single":
                return self._plan_repeat_single(per_item, count, ext)
            if start == 0 and ext == nblocks * stride:
                # items continue the arithmetic progression seamlessly
                return _plan_strided(0, count * nblocks, bl, stride)
            # fall through to the general expansion on the runs
        offs, lens = self.segment_arrays()
        n = len(offs)
        if n == 0:
            return _plan_empty()
        if n == 1:
            one = _plan_single(int(offs[0]), int(lens[0]))
            return (one if count == 1
                    else self._plan_repeat_single(one, count, ext))
        if count == 1:
            return _plan_runs(offs, lens)
        if count * n <= _PLAN_EXPAND_CAP:
            base = np.arange(count, dtype=np.int64)[:, None] * ext
            all_offs = (base + offs[None, :]).reshape(-1)
            all_lens = np.broadcast_to(lens[None, :], (count, n)).reshape(-1)
            return _plan_runs(*_merge_adjacent(all_offs, all_lens))
        return _plan_items(offs, lens, count, ext, self.size)

    @staticmethod
    def _plan_repeat_single(one: PackPlan, count: int,
                            extent: int) -> PackPlan:
        """count repetitions of a one-run item at ``extent`` stride."""
        if one.start == 0 and one.total == extent:
            return _plan_single(0, count * one.total)  # items abut
        return _plan_strided(one.start, count, one.total, extent)

    def _validate_packing(self, count: int, what: str) -> None:
        """Shared pack/unpack argument validation — count sign, then
        commit state (buffer-size checks follow in the caller, in the
        same order on both paths)."""
        if count < 0:
            raise MPIException(
                f"{what}: negative count {count}", error_class=2)
        if not self._committed:
            raise MPIException(
                f"{what} on an uncommitted datatype "
                f"{getattr(self, 'name', type(self).__name__)!r} "
                f"(MPI_Type_commit first)", error_class=3)

    def pack(self, buf: np.ndarray, count: int) -> bytes:
        """Gather `count` items from `buf` into contiguous bytes."""
        self._validate_packing(count, "pack")
        raw = np.ascontiguousarray(buf).view(np.uint8).ravel()
        plan = self.pack_plan(count)
        if raw.nbytes < plan.span:
            raise MPIException(
                f"pack: buffer has {raw.nbytes}B, datatype needs "
                f"{plan.span}B for count={count}")
        stats.note("pack", plan.total)
        if plan.kind == "empty":   # no bytes move: no span (all 3 paths)
            return b""
        _t0 = trace_mod.begin() if trace_mod.active else 0
        if plan.kind == "single":   # single-memcpy fast path
            blob = raw[plan.start:plan.start + plan.total].tobytes()
        else:
            out = np.empty(plan.total, np.uint8)
            self._execute_pack(raw, plan, out)
            blob = out.tobytes()
        if _t0 and trace_mod.active:
            trace_mod.complete("datatype", f"pack:{plan.kind}", _t0,
                               nbytes=plan.total)
        return blob

    def pack_into(self, buf: np.ndarray, count: int, out) -> int:
        """Pack ``count`` items from ``buf`` into a caller-provided
        writable buffer (ndarray / memoryview / bytearray) and return the
        packed byte count — the memoryview-based variant that skips the
        intermediate ``bytes`` object ``pack()`` materializes."""
        self._validate_packing(count, "pack")
        raw = np.ascontiguousarray(buf).view(np.uint8).ravel()
        plan = self.pack_plan(count)
        if raw.nbytes < plan.span:
            raise MPIException(
                f"pack: buffer has {raw.nbytes}B, datatype needs "
                f"{plan.span}B for count={count}")
        out_arr = np.frombuffer(out, np.uint8)
        if not out_arr.flags.writeable:
            raise MPIException(
                "pack_into: output buffer is read-only (bytes? pass a "
                "bytearray/memoryview/ndarray)", error_class=2)
        if out_arr.nbytes < plan.total:
            raise MPIException(
                f"pack_into: output buffer has {out_arr.nbytes}B, plan "
                f"packs {plan.total}B")
        stats.note("pack", plan.total)
        if plan.kind == "empty":
            return 0
        _t0 = trace_mod.begin() if trace_mod.active else 0
        if plan.kind == "single":
            out_arr[:plan.total] = raw[plan.start:plan.start + plan.total]
        else:
            self._execute_pack(raw, plan, out_arr[:plan.total])
        if _t0 and trace_mod.active:
            trace_mod.complete("datatype", f"pack:{plan.kind}", _t0,
                               nbytes=plan.total)
        return plan.total

    def _execute_pack(self, raw: np.ndarray, plan: PackPlan,
                      out: np.ndarray) -> None:
        """Run a non-trivial plan: the native walk when available,
        vectorized numpy otherwise."""
        native = _native_convertor(plan.total)
        if plan.kind == "strided":
            if native is not None:
                native.ompi_tpu_pack_strided(
                    _u8p(out), _u8p(raw[plan.start:]), plan.nblocks,
                    plan.blocklen, plan.stride)
                return
            view = np.lib.stride_tricks.as_strided(
                raw[plan.start:], (plan.nblocks, plan.blocklen),
                (plan.stride, 1))
            out.reshape(plan.nblocks, plan.blocklen)[:] = view
            return
        if plan.kind == "runs":
            if native is not None:
                native.ompi_tpu_pack_runs(
                    _u8p(out), _u8p(raw), _i64p(plan.offsets),
                    _i64p(plan.lengths), len(plan.offsets), plan.uniform)
                return
            out[:] = raw[_concat_aranges(plan.offsets, plan.lengths)]
            return
        # per-item walk (plan too large to expand)
        if native is not None:
            native.ompi_tpu_pack(
                _u8p(out), _u8p(raw), plan.count, plan.extent,
                _i64p(plan.offsets), _i64p(plan.lengths),
                len(plan.offsets), plan.uniform, plan.item_size)
            return
        out[:] = raw[self._byte_index(plan.count)]

    def unpack(self, data, buf: np.ndarray, count: int) -> None:
        """Scatter contiguous bytes (any buffer object: bytes, bytearray,
        memoryview, uint8 ndarray) into `buf` according to the layout."""
        self._validate_packing(count, "unpack")
        if buf.flags["C_CONTIGUOUS"] is False:
            raise MPIException("unpack requires a C-contiguous target buffer")
        raw = buf.view(np.uint8).reshape(-1)
        src = np.frombuffer(data, dtype=np.uint8)
        plan = self.pack_plan(count)
        if len(src) < plan.total:
            raise MPIException(
                f"unpack: got {len(src)}B, layout expects "
                f"{plan.total}B", error_class=15)
        if raw.nbytes < plan.span:
            raise MPIException(
                f"unpack: target buffer has {raw.nbytes}B, layout spans "
                f"{plan.span}B for count={count}", error_class=15)
        stats.note("unpack", plan.total)
        if plan.kind == "empty":
            return
        _t0 = trace_mod.begin() if trace_mod.active else 0
        if plan.kind == "single":
            raw[plan.start:plan.start + plan.total] = src[:plan.total]
        else:
            self._execute_unpack(src[:plan.total], plan, raw)
        if _t0 and trace_mod.active:
            trace_mod.complete("datatype", f"unpack:{plan.kind}", _t0,
                               nbytes=plan.total)

    def _execute_unpack(self, src: np.ndarray, plan: PackPlan,
                        raw: np.ndarray) -> None:
        native = _native_convertor(plan.total)
        if plan.kind == "strided":
            if native is not None:
                native.ompi_tpu_unpack_strided(
                    _u8p(src), _u8p(raw[plan.start:]), plan.nblocks,
                    plan.blocklen, plan.stride)
                return
            view = np.lib.stride_tricks.as_strided(
                raw[plan.start:], (plan.nblocks, plan.blocklen),
                (plan.stride, 1))
            view[:] = src.reshape(plan.nblocks, plan.blocklen)
            return
        if plan.kind == "runs":
            if native is not None:
                native.ompi_tpu_unpack_runs(
                    _u8p(src), _u8p(raw), _i64p(plan.offsets),
                    _i64p(plan.lengths), len(plan.offsets), plan.uniform)
                return
            raw[_concat_aranges(plan.offsets, plan.lengths)] = src
            return
        if native is not None:
            native.ompi_tpu_unpack(
                _u8p(src), _u8p(raw), plan.count, plan.extent,
                _i64p(plan.offsets), _i64p(plan.lengths),
                len(plan.offsets), plan.uniform, plan.item_size)
            return
        raw[self._byte_index(plan.count)] = src

    # -- device path (index_select / index_put_) ---------------------------

    def _device_index(self, count: int, device: torch.device) -> torch.Tensor:
        """The int64 gather map of ``count`` items on ``device``, made once
        per (count, device)."""
        cache = self.__dict__.setdefault("_dev_idx", {})
        key = (int(count), device)
        idx = cache.get(key)
        if idx is None:
            import torch

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
        import torch

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
        import torch

        idx = self._device_index(count, data.device)
        n = (total_elems if total_elems is not None
             else count * self._elem_stride())
        out = torch.zeros((n,), dtype=data.dtype, device=data.device)
        return out.index_put_((idx,), data.reshape(-1))

    # -- constructors (≈ ompi_datatype.h:178-197) -------------------------

    def contiguous(self, count: int) -> "DerivedDatatype":
        return _stamp(DerivedDatatype(self, [(0, count)],
                                      name=f"contig({count})"),
                      "contiguous", count=count, datatype=self)

    def vector(self, count: int, blocklength: int,
               stride: int) -> "DerivedDatatype":
        count, blocklength, stride = int(count), int(blocklength), int(stride)
        natural = 0 if count == 0 else (
            ((count - 1) * stride if stride >= 0 else 0)
            + blocklength) * self.extent
        dt = DerivedDatatype(
            self, (np.arange(count, dtype=np.int64) * (stride * self.extent),
                   np.full(count, blocklength, np.int64)),
            extent=natural, pattern_unit="bytes",
            name=f"vector({count},{blocklength},{stride})")
        if count > 0 and blocklength > 0 and stride > 0 \
                and self.is_contiguous:
            # affine layout: the plan is one strided walk, as in the JAX
            # package (whose plan class the trace counters name)
            dt._affine = (0, count, blocklength * self.size,
                          stride * self.extent)
        return _stamp(dt, "vector", count=count, blocklength=blocklength,
                      stride=stride, datatype=self)

    def hvector(self, count: int, blocklength: int,
                byte_stride: int) -> "DerivedDatatype":
        """≈ MPI_Type_create_hvector: stride in BYTES."""
        count, blocklength = int(count), int(blocklength)
        byte_stride = int(byte_stride)
        natural = 0 if count == 0 else (
            ((count - 1) * byte_stride if byte_stride >= 0 else 0)
            + blocklength * self.extent)
        dt = DerivedDatatype(
            self, (np.arange(count, dtype=np.int64) * byte_stride,
                   np.full(count, blocklength, np.int64)),
            extent=natural, pattern_unit="bytes",
            name=f"hvector({count},{blocklength},{byte_stride}B)")
        if count > 0 and blocklength > 0 and byte_stride > 0 \
                and self.is_contiguous:
            dt._affine = (0, count, blocklength * self.size, byte_stride)
        return _stamp(dt, "hvector", count=count, blocklength=blocklength,
                      byte_stride=byte_stride, datatype=self)

    def indexed(self, blocklengths: Sequence[int],
                displacements: Sequence[int]) -> "DerivedDatatype":
        if len(blocklengths) != len(displacements):
            raise MPIException("indexed: blocklengths/displacements mismatch")
        return _stamp(DerivedDatatype(
            self, [(d, b) for d, b in zip(displacements, blocklengths)],
            name=f"indexed({len(blocklengths)})"),
            "indexed", blocklengths=list(blocklengths),
            displacements=list(displacements), datatype=self)

    def indexed_block(self, blocklength: int,
                      displacements: Sequence[int]) -> "DerivedDatatype":
        """≈ MPI_Type_create_indexed_block: one blocklength for all."""
        return _stamp(DerivedDatatype(
            self, [(d, blocklength) for d in displacements],
            name=f"indexed_block({blocklength},{len(displacements)})"),
            "indexed_block", blocklength=blocklength,
            displacements=list(displacements), datatype=self)

    def hindexed(self, blocklengths: Sequence[int],
                 byte_displacements: Sequence[int]) -> "DerivedDatatype":
        """≈ MPI_Type_create_hindexed: displacements in BYTES."""
        if len(blocklengths) != len(byte_displacements):
            raise MPIException(
                "hindexed: blocklengths/displacements mismatch")
        return _stamp(DerivedDatatype(
            self, list(zip(byte_displacements, blocklengths)),
            pattern_unit="bytes", name=f"hindexed({len(blocklengths)})"),
            "hindexed", blocklengths=list(blocklengths),
            byte_displacements=list(byte_displacements), datatype=self)

    def hindexed_block(self, blocklength: int,
                       byte_displacements: Sequence[int]) -> "DerivedDatatype":
        """≈ MPI_Type_create_hindexed_block."""
        return _stamp(DerivedDatatype(
            self, [(d, blocklength) for d in byte_displacements],
            pattern_unit="bytes",
            name=f"hindexed_block({blocklength},{len(byte_displacements)})"),
            "hindexed_block", blocklength=blocklength,
            byte_displacements=list(byte_displacements), datatype=self)

    def resized(self, extent: int) -> "DerivedDatatype":
        """≈ MPI_Type_create_resized: the base's layout, a new extent."""
        return _stamp(self._resized(extent), "resized", extent=extent,
                      datatype=self)

    def _resized(self, extent: int) -> "DerivedDatatype":
        dt = DerivedDatatype(self, [(0, 1)], extent=extent,
                             name=f"resized({extent})")
        dt.size = self.size
        dt._seg_arrs = self.segment_arrays()
        return dt

    def subarray(self, sizes: Sequence[int], subsizes: Sequence[int],
                 starts: Sequence[int], order: str = "C") -> "DerivedDatatype":
        """≈ MPI_Type_create_subarray (C or Fortran order)."""
        return create_subarray(sizes, subsizes, starts, self, order)


# arg names whose values are byte addresses/extents (envelope "addresses")
_ADDRESS_KEYS = {"byte_displacements", "byte_stride", "extent"}


def _stamp(dt: "Datatype", combiner: str, **contents) -> "Datatype":
    """Record envelope/contents metadata on a freshly built datatype."""
    dt.combiner = combiner
    dt._contents = contents
    return dt


def min_span(dt: Datatype, count: int) -> int:
    """Min buffer bytes to hold `count` items (last item needs only size)."""
    if count <= 0:
        return 0
    offs, lens = dt.segment_arrays()
    last_end = int((offs + lens).max()) if len(offs) else 0
    return (count - 1) * dt.extent + last_end


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
        self._committed = True

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
        # compile the pack plan (≈ opal_datatype_commit running the
        # descriptor optimizer)
        first = not self._committed
        self._committed = True
        self.pack_plan(1)
        _count_commit_plan(self, first)
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

    def commit(self) -> "StructDatatype":
        first = not self._committed
        self._committed = True
        self.pack_plan(1)
        _count_commit_plan(self, first)
        return self

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

    def resized(self, extent: int) -> "DerivedDatatype":
        # unstamped, as in the JAX package: the envelope stays the base's
        return self._resized(extent)

    def __repr__(self) -> str:
        return f"Datatype({self.name}, size={self.size}, extent={self.extent})"


def create_struct(blocklengths: Sequence[int],
                  byte_displacements: Sequence[int],
                  datatypes: Sequence[Datatype]) -> StructDatatype:
    """≈ MPI_Type_create_struct."""
    return _stamp(StructDatatype(blocklengths, byte_displacements, datatypes),
                  "struct", blocklengths=list(blocklengths),
                  byte_displacements=list(byte_displacements),
                  datatypes=list(datatypes))


def create_subarray(sizes: Sequence[int], subsizes: Sequence[int],
                    starts: Sequence[int], base: Datatype,
                    order: str = "C") -> DerivedDatatype:
    """≈ MPI_Type_create_subarray: an n-d sub-block of an n-d array.
    Extent spans the WHOLE array (MPI semantics), so count>1 tiles whole
    arrays."""
    nd = len(sizes)
    orig_args = dict(sizes=list(sizes), subsizes=list(subsizes),
                     starts=list(starts), order=order, datatype=base)
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
    return _stamp(DerivedDatatype(
        base, pattern, extent=int(np.prod(sizes)) * base.extent,
        name=f"subarray({tuple(subsizes)}/{tuple(sizes)})"),
        "subarray", **orig_args)


# distribution constants (≈ mpi.h MPI_DISTRIBUTE_*)
DISTRIBUTE_NONE = "none"
DISTRIBUTE_BLOCK = "block"
DISTRIBUTE_CYCLIC = "cyclic"
DISTRIBUTE_DFLT_DARG = -1


def _darray_dim_indices(gsize: int, distrib: str, darg: int, psize: int,
                        coord: int) -> list[int]:
    """Global indices along one dimension owned by process `coord`."""
    if distrib == DISTRIBUTE_NONE:
        if psize != 1:
            raise MPIException("darray: DISTRIBUTE_NONE needs psize 1")
        return list(range(gsize))
    if distrib == DISTRIBUTE_BLOCK:
        if darg == DISTRIBUTE_DFLT_DARG:
            darg = (gsize + psize - 1) // psize
        if darg * psize < gsize:
            raise MPIException(
                f"darray: block size {darg} × {psize} procs < {gsize}")
        start = coord * darg
        return list(range(start, min(start + darg, gsize)))
    if distrib == DISTRIBUTE_CYCLIC:
        if darg == DISTRIBUTE_DFLT_DARG:
            darg = 1
        out: list[int] = []
        for blk in range(coord * darg, gsize, psize * darg):
            out.extend(range(blk, min(blk + darg, gsize)))
        return out
    raise MPIException(f"darray: unknown distribution {distrib!r}")


def create_darray(size: int, rank: int, gsizes: Sequence[int],
                  distribs: Sequence[str], dargs: Sequence[int],
                  psizes: Sequence[int], base: Datatype,
                  order: str = "C") -> DerivedDatatype:
    """≈ MPI_Type_create_darray: this process's piece of a block/cyclic
    distributed n-d array (HPF rules).  Process grid is row-major over
    psizes (MPI order)."""
    nd = len(gsizes)
    orig_args = dict(size=size, rank=rank, gsizes=list(gsizes),
                     distribs=list(distribs), dargs=list(dargs),
                     psizes=list(psizes), order=order, datatype=base)
    if not (len(distribs) == len(dargs) == len(psizes) == nd):
        raise MPIException("darray: argument rank mismatch")
    if int(np.prod(psizes)) != size:
        raise MPIException(
            f"darray: psizes {tuple(psizes)} ≠ comm size {size}")
    # my coordinates in the process grid: ALWAYS row-major over psizes as
    # given (MPI mandates this regardless of array storage order)
    coords = []
    rem = rank
    for d in range(nd):
        below = int(np.prod(psizes[d + 1:])) if d + 1 < nd else 1
        coords.append(rem // below)
        rem %= below
    if order.upper() == "F":  # mirror ONLY the array/dim description
        gsizes, distribs = gsizes[::-1], distribs[::-1]
        dargs, psizes = dargs[::-1], psizes[::-1]
        coords = coords[::-1]
    elif order.upper() != "C":
        raise MPIException(f"darray: order must be C or F, got {order!r}")
    dim_idx = [np.asarray(_darray_dim_indices(gsizes[d], distribs[d],
                                              dargs[d], psizes[d],
                                              coords[d]), np.int64)
               for d in range(nd)]
    strides = [1] * nd
    for d in range(nd - 2, -1, -1):
        strides[d] = strides[d + 1] * gsizes[d + 1]
    # run-length compressed item offsets in local (canonical) order, last
    # dim fastest: the last dimension's runs, placed at every row origin
    # of the outer dimensions (an outer sum), then merged where one run
    # ends at the next one's start (the JAX package compresses the flat
    # per-item walk; this is the same pattern without the per-item list)
    last = dim_idx[-1]
    if len(last):
        brk = np.empty(len(last), bool)
        brk[0] = True
        np.not_equal(last[1:], last[:-1] + 1, out=brk[1:])
        gi = np.flatnonzero(brk)
        run_s, run_l = last[gi], np.diff(np.append(gi, len(last)))
    else:
        run_s = run_l = np.empty(0, np.int64)
    origins = np.zeros(1, np.int64)
    for d in range(nd - 1):
        origins = (origins[:, None]
                   + dim_idx[d][None, :] * strides[d]).reshape(-1)
    starts = (origins[:, None] + run_s[None, :]).reshape(-1)
    lens = np.broadcast_to(run_l[None, :],
                           (len(origins), len(run_l))).reshape(-1)
    pattern = _merge_adjacent(starts, lens)
    return _stamp(DerivedDatatype(
        base, pattern, extent=int(np.prod(gsizes)) * base.extent,
        name=f"darray(rank {rank}/{size}, {tuple(gsizes)})"),
        "darray", **orig_args)


# -- external32: the canonical big-endian interchange format ---------------
# ≈ ompi external32 (opal_convertor heterogeneous path + test/datatype/
# external32.c): pack to a byte-order-independent stream so heterogeneous
# peers (or files) interoperate.


def _packed_elem_dtypes(dt: Datatype) -> list[tuple[np.dtype, int]]:
    """The packed stream of ONE item as (element dtype, n_elements) runs,
    in pack order — the byteswap map for external32."""
    if isinstance(dt, StructDatatype):
        out: list[tuple[np.dtype, int]] = []
        for _disp, cnt, t in dt.fields:
            out.extend(_packed_elem_dtypes(t) * cnt)
        return out
    if isinstance(dt, DerivedDatatype):
        # recurse: the base may itself be heterogeneous (resized/contiguous
        # struct) — its byteswap map must survive the wrapper
        n_items = dt.size // dt.base.size if dt.base.size else 0
        return _packed_elem_dtypes(dt.base) * n_items
    return [(dt.base_np, dt.size // dt.base_np.itemsize)]


def _swap_stream(dt: Datatype, data: bytes, count: int) -> bytes:
    runs = _packed_elem_dtypes(dt) * count
    out = bytearray(len(data))
    pos = 0
    src = np.frombuffer(data, np.uint8)
    for elem_dt, n in runs:
        nb = elem_dt.itemsize * n
        out[pos:pos + nb] = src[pos:pos + nb].view(elem_dt).byteswap(
            ).tobytes()
        pos += nb
    return bytes(out)


def pack_size(count: int, dt: Datatype) -> int:
    """≈ MPI_Pack_size: an upper bound on the packed bytes for ``count``
    items (exact here — this convertor adds no envelope)."""
    return int(count) * dt.size


def pack_external_size(dt: Datatype, count: int = 1) -> int:
    """≈ MPI_Pack_external_size ("external32"): same payload bytes — the
    canonical stream only byte-swaps, never pads."""
    return int(count) * dt.size


def type_match_size(typeclass: str, size: int) -> Datatype:
    """≈ MPI_Type_match_size: the predefined type of ``typeclass``
    ("integer" | "real" | "complex") with exactly ``size`` bytes."""
    table = {
        "integer": {1: "INT8", 2: "INT16", 4: "INT32", 8: "INT64"},
        "real": {2: "FLOAT16", 4: "FLOAT32", 8: "FLOAT64"},
        "complex": {8: "COMPLEX64", 16: "COMPLEX128"},
    }
    try:
        return globals()[table[typeclass.lower()][int(size)]]
    except KeyError:
        raise MPIException(
            f"type_match_size: no {typeclass} type of {size} bytes",
            error_class=3) from None


def get_address(buf) -> int:
    """≈ MPI_Get_address: the base address of a buffer (useful for
    computing struct byte displacements between fields); a tensor's is
    its ``data_ptr()``."""
    if is_tensor(buf):
        return int(buf.data_ptr())
    return np.asarray(buf).__array_interface__["data"][0]


def alloc_mem(nbytes: int) -> np.ndarray:
    """≈ MPI_Alloc_mem: an ordinary byte buffer (no registered-memory
    fast path on the host transports)."""
    return np.zeros(int(nbytes), np.uint8)


def free_mem(buf: np.ndarray) -> None:
    """≈ MPI_Free_mem (allocation is GC-managed; provided for parity)."""


def pack_external(dt: Datatype, buf, count: int = 1) -> bytes:
    """≈ MPI_Pack_external("external32"): pack then canonicalize to
    big-endian."""
    data = dt.pack(np.asarray(buf), count)
    if sys.byteorder == "little":
        data = _swap_stream(dt, data, count)
    return data


def unpack_external(dt: Datatype, data: bytes, buf: np.ndarray,
                    count: int = 1) -> None:
    """≈ MPI_Unpack_external: big-endian stream → native layout."""
    if sys.byteorder == "little":
        data = _swap_stream(dt, data, count)
    dt.unpack(data, buf, count)


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

_BY_NP: dict = {}
for _t in (INT8, UINT8, INT16, UINT16, INT32, UINT32, INT64, UINT64,
           FLOAT16, BFLOAT16, FLOAT32, FLOAT64, COMPLEX64, COMPLEX128, BOOL,
           FLOAT_INT, DOUBLE_INT, LONG_INT):
    _BY_NP.setdefault(_t.base_np, _t)


def from_numpy(dtype) -> PredefinedDatatype:
    """Map a numpy dtype to the predefined Datatype (auto-typing for arrays)."""
    dt = np.dtype(dtype)
    try:
        return _BY_NP[dt]
    except KeyError:
        raise MPIException(f"no predefined datatype for numpy dtype {dt}") from None
