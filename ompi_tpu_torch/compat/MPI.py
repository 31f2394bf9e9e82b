"""mpi4py-compatible facade over ompi_tpu_torch (the port's copy of the
JAX package's ``compat/MPI.py``, whole).

The reference's Python users overwhelmingly reach it through mpi4py
(``from mpi4py import MPI``); this module lets those scripts run on this
framework with one changed import::

    from ompi_tpu_torch.compat import MPI

    comm = MPI.COMM_WORLD
    rank = comm.Get_rank()
    comm.Send(buf, dest=1, tag=7)          # uppercase = buffer API
    obj = comm.bcast(obj, root=0)          # lowercase = pickled objects

Covered surface (the part real scripts use): Comm point-to-point (both
case conventions, all send modes, persistent requests, matched probe),
blocking + nonblocking collectives, communicator management
(Dup/Split/Split_type/Create/Create_group/Free/group ops), Status,
Request families (Wait*/Test*), Op including Op.Create, Datatype-as-
numpy-dtype buffer specs ``[buf, count, MPI.DOUBLE]``, and the
environment calls (Wtime, Get_processor_name, Init/Finalize).

RMA windows (``MPI.Win``: Create/Allocate, Put/Get/Accumulate/
Get_accumulate/Fetch_and_op/Compare_and_swap, fence / lock / PSCW),
MPI-IO (``MPI.File``: explicit-offset, individual, collective, shared
and ordered reads/writes over file views), Cartesian topologies
(``Comm.Create_cart`` → ``Cartcomm``, ``Compute_dims``) and dynamic
processes (``Comm.Spawn`` / ``Comm.Get_parent`` / ``Intercomm``) are
covered too, as are graph topologies (``Comm.Create_graph`` →
``Graphcomm``).  MIGRATION.md maps every remaining native-only call.

Naming follows mpi4py exactly, hence the non-PEP8 method names.  The
module references the reference's C API only through the names mpi4py
derives from it; everything executes on this framework's PML/coll stack.

Buffers.  A numpy buffer behaves as in the JAX package.  A torch tensor
may stand wherever a buffer does:

- as send, origin or file-write data it reaches the host through
  ``core.buffer.tensor_to_host``: a CPU tensor is viewed in place, a CUDA
  tensor is made contiguous on the card and comes over in ONE
  device-to-host copy (the JAX facade's ``np.asarray`` of a
  ``jax.Array``).  bf16 and float8 tensors move as their bits, as the
  JAX facade moves an ``ml_dtypes`` array's bytes; in a reduction they
  are converted to float32 on their own device, reduced, and the result
  rounded once to the tensor's dtype (the JAX facade rounds after every
  step, so past two operands a sum may differ from its by an ulp);
- as a receive, landing or window buffer a CPU tensor is viewed in
  place (a bf16/float8 one through its bits; a reduction's float result
  is converted into it), so the result lands in the tensor's memory;
- as a receive, landing or window buffer a CUDA tensor raises
  ``MPIException`` with ``ERR_BUFFER``: the host facade cannot land into
  the card's memory (nor can the JAX facade into a ``jax.Array``, whose
  ``np.asarray`` is a read-only host copy).  A ``Communicator`` bound to
  a ``DeviceCommunicator`` (``Communicator.bind_device``) runs its
  collectives on such tensors on the card.

The module imports torch only for a tensor the caller passed, so a
numpy-only facade rank never imports it.
"""

from __future__ import annotations

import pickle
from typing import Any, Optional, Sequence

import numpy as np

from ompi_tpu_torch.core.buffer import (BITS_DTYPE as _BITS_DTYPE,
                                        host_array as _staged,
                                        is_tensor as _is_tensor,
                                        torch_dtype_name as _torch_dtype_name)
from ompi_tpu_torch.mpi import constants as _const
from ompi_tpu_torch.mpi import op as _op_mod
from ompi_tpu_torch.mpi.request import Status as _NativeStatus
from ompi_tpu_torch.mpi import request as _req_mod

# ---------------------------------------------------------------------------
# constants
# ---------------------------------------------------------------------------

ANY_SOURCE = _const.ANY_SOURCE
ANY_TAG = _const.ANY_TAG
PROC_NULL = _const.PROC_NULL
ORDER_C = 0
ORDER_FORTRAN = 1
DISTRIBUTE_NONE = 100
DISTRIBUTE_BLOCK = 101
DISTRIBUTE_CYCLIC = 102
DISTRIBUTE_DFLT_DARG = -1
UNDEFINED = _const.UNDEFINED
IN_PLACE = _const.IN_PLACE
COMM_TYPE_SHARED = _const.COMM_TYPE_SHARED
SUCCESS = 0

THREAD_SINGLE, THREAD_FUNNELED, THREAD_SERIALIZED, THREAD_MULTIPLE = range(4)

ERRORS_ARE_FATAL = "errors_are_fatal"
ERRORS_RETURN = "errors_return"
ROOT = _const.ROOT              # intercomm collective root marker
BOTTOM = 0                      # address-0 buffer sentinel (unused here)
KEYVAL_INVALID = -1
MODE_NOCHECK = 1024             # win assertion hint (accepted, advisory)
# comparison results (≈ MPI_Comm_compare / MPI_Group_compare)
IDENT, CONGRUENT, SIMILAR, UNEQUAL = 0, 1, 2, 3
# topology kinds for Get_topology (no topology → the UNDEFINED constant,
# mpi4py/MPI_Topo_test semantics)
CART, GRAPH, DIST_GRAPH = 1, 2, 3

from ompi_tpu_torch.mpi.errhandler import (  # noqa: E402
    Errhandler, create_errhandler,
)
from ompi_tpu_torch.mpi.info import (  # noqa: E402
    Keyval as _Keyval, keyval_create as _keyval_create,
    keyval_free as _keyval_free,
)
from ompi_tpu_torch.mpi.info import Info as _NativeInfo  # noqa: E402


class Info(_NativeInfo):
    """mpi4py-cased Info over the native hint dictionary (the native
    lowercase API stays available; File/Win/native layers consume it
    directly)."""

    @classmethod
    def Create(cls, items=None) -> "Info":
        return cls(dict(items) if items else None)

    def Set(self, key: str, value: str) -> None:
        self.set(key, value)

    def Get(self, key: str, default=None):
        return self.get(key, default)

    def Delete(self, key: str) -> None:
        self.delete(key)

    def Get_nkeys(self) -> int:
        return self.nkeys          # native exposes it as a property

    def Get_nthkey(self, n: int) -> str:
        return self.nthkey(n)

    def Dup(self) -> "Info":
        return Info(dict(self.items()))

    def Free(self) -> None:
        pass


INFO_NULL = None
# well-known attribute keyvals (≈ MPI_TAG_UB etc.); queried via
# comm.Get_attr — the facade answers them itself
TAG_UB = _keyval_create(extra="TAG_UB")
WIN_BASE = _keyval_create(extra="WIN_BASE")
WIN_SIZE = _keyval_create(extra="WIN_SIZE")
WIN_DISP_UNIT = _keyval_create(extra="WIN_DISP_UNIT")
_MAX_TAG = (1 << 30) - 1        # user tags below the reserved ranges


class Exception(RuntimeError):  # noqa: A001 — mpi4py exports MPI.Exception
    """mpi4py-shaped MPI exception (wraps the native MPIException)."""

    def __init__(self, native):
        super().__init__(str(native))
        self._native = native

    def Get_error_class(self) -> int:
        return getattr(self._native, "error_class", -1)

    def Get_error_string(self) -> str:
        return str(self._native)


# ---------------------------------------------------------------------------
# Datatype: numpy dtype in mpi4py clothing
# ---------------------------------------------------------------------------

class Datatype:
    """A named numpy dtype — enough for ``[buf, count, MPI.DOUBLE]``
    specs, ``Status.Get_count``, dtype checks, and (via the
    ``Create_*`` family) derived types for file views."""

    def __init__(self, np_dtype, name: str):
        self.np_dtype = np.dtype(np_dtype)
        self._name = name

    def Get_size(self) -> int:
        return self.np_dtype.itemsize

    @property
    def size(self) -> int:
        return self.np_dtype.itemsize

    def Get_name(self) -> str:
        return self._name

    def __repr__(self) -> str:
        return f"<MPI.Datatype {self._name}>"

    def __eq__(self, other) -> bool:
        # plain (predefined) types compare by element dtype, so a
        # Get_view round-trip satisfies `etype == MPI.DOUBLE`; derived
        # types keep identity semantics
        if self is other:
            return True
        return (type(self) is Datatype and type(other) is Datatype
                and self.np_dtype == other.np_dtype)

    def __hash__(self) -> int:
        if type(self) is Datatype:
            return hash(("mpi-dt", str(self.np_dtype)))
        return id(self)

    # -- derived-type constructors (mpi4py spelling over the native
    #    datatype engine; the results drive File.Set_view) --------------
    def _to_native(self):
        from ompi_tpu_torch.mpi.datatype import from_numpy

        return from_numpy(self.np_dtype)

    def Create_contiguous(self, count: int) -> "Datatype":
        return _Derived(self._to_native().contiguous(count), self)

    def Create_vector(self, count: int, blocklength: int,
                      stride: int) -> "Datatype":
        return _Derived(
            self._to_native().vector(count, blocklength, stride), self)

    def Create_hvector(self, count: int, blocklength: int,
                       stride: int) -> "Datatype":
        return _Derived(
            self._to_native().hvector(count, blocklength, stride), self)

    def Create_indexed(self, blocklengths, displacements) -> "Datatype":
        return _Derived(
            self._to_native().indexed(list(blocklengths),
                                      list(displacements)), self)

    def Create_indexed_block(self, blocklength: int,
                             displacements) -> "Datatype":
        return _Derived(
            self._to_native().indexed_block(blocklength,
                                            list(displacements)), self)

    def Create_hindexed(self, blocklengths, displacements) -> "Datatype":
        return _Derived(
            self._to_native().hindexed(list(blocklengths),
                                       list(displacements)), self)

    def Create_subarray(self, sizes, subsizes, starts,
                        order=None) -> "Datatype":
        return _Derived(
            self._to_native().subarray(list(sizes), list(subsizes),
                                       list(starts),
                                       "F" if order == ORDER_FORTRAN
                                       else "C"), self)

    def Create_hindexed_block(self, blocklength: int,
                              displacements) -> "Datatype":
        return _Derived(
            self._to_native().hindexed_block(blocklength,
                                             list(displacements)), self)

    def Create_darray(self, size: int, rank: int, gsizes, distribs,
                      dargs, psizes, order=None) -> "Datatype":
        from ompi_tpu_torch.mpi import datatype as _dt
        from ompi_tpu_torch.mpi.datatype import create_darray

        name_of = {DISTRIBUTE_NONE: _dt.DISTRIBUTE_NONE,
                   DISTRIBUTE_BLOCK: _dt.DISTRIBUTE_BLOCK,
                   DISTRIBUTE_CYCLIC: _dt.DISTRIBUTE_CYCLIC}
        return _Derived(create_darray(
            size, rank, list(gsizes),
            [name_of.get(d, d) for d in distribs], list(dargs),
            list(psizes), self._to_native(),
            "F" if order == ORDER_FORTRAN else "C"), self)

    def Create_resized(self, lb: int, extent: int) -> "Datatype":
        if lb:
            raise Exception(
                "Create_resized: nonzero lower bounds are not "
                "supported (the native engine keeps lb == 0)")
        return _Derived(self._to_native().resized(extent), self)

    @staticmethod
    def Create_struct(blocklengths, displacements,
                      datatypes) -> "Datatype":
        from ompi_tpu_torch.mpi.datatype import create_struct

        native = create_struct(
            list(blocklengths), list(displacements),
            [d._nat if isinstance(d, _Derived) else d._to_native()
             for d in datatypes])
        return _Derived(native, datatypes[0])

    def Commit(self) -> "Datatype":
        return self            # native types are always ready

    def Free(self) -> None:
        pass

    def Get_extent(self) -> tuple:
        return 0, self.size    # scalar: lb 0, extent == size


class _Derived(Datatype):
    """A committed derived type: wraps a native DerivedDatatype (passed
    through to ``File.Set_view``); the element dtype of the BASE type is
    kept so count conversions still work."""

    def __init__(self, native, base: "Datatype") -> None:
        self._nat = native
        self.np_dtype = base.np_dtype
        self._name = native.name

    def Get_size(self) -> int:
        return self._nat.size

    @property
    def size(self) -> int:
        return self._nat.size

    def Get_extent(self) -> tuple:
        return 0, self._nat.extent

    @property
    def extent(self) -> int:
        return self._nat.extent

    def _to_native(self):
        return self._nat


BYTE = Datatype(np.uint8, "MPI_BYTE")
CHAR = Datatype(np.int8, "MPI_CHAR")
SHORT = Datatype(np.int16, "MPI_SHORT")
INT = Datatype(np.int32, "MPI_INT")
LONG = Datatype(np.int64, "MPI_LONG")
LONG_LONG = Datatype(np.int64, "MPI_LONG_LONG")
UNSIGNED_CHAR = Datatype(np.uint8, "MPI_UNSIGNED_CHAR")
UNSIGNED_SHORT = Datatype(np.uint16, "MPI_UNSIGNED_SHORT")
UNSIGNED = Datatype(np.uint32, "MPI_UNSIGNED")
UNSIGNED_LONG = Datatype(np.uint64, "MPI_UNSIGNED_LONG")
FLOAT = Datatype(np.float32, "MPI_FLOAT")
DOUBLE = Datatype(np.float64, "MPI_DOUBLE")
C_BOOL = Datatype(np.bool_, "MPI_C_BOOL")
BOOL = C_BOOL
INT8_T = Datatype(np.int8, "MPI_INT8_T")
INT16_T = Datatype(np.int16, "MPI_INT16_T")
INT32_T = Datatype(np.int32, "MPI_INT32_T")
INT64_T = Datatype(np.int64, "MPI_INT64_T")
UINT8_T = Datatype(np.uint8, "MPI_UINT8_T")
UINT16_T = Datatype(np.uint16, "MPI_UINT16_T")
UINT32_T = Datatype(np.uint32, "MPI_UINT32_T")
UINT64_T = Datatype(np.uint64, "MPI_UINT64_T")
COMPLEX = Datatype(np.complex64, "MPI_COMPLEX")
DOUBLE_COMPLEX = Datatype(np.complex128, "MPI_DOUBLE_COMPLEX")
# (value, location) pair types for MAXLOC/MINLOC reductions — the same
# structured dtypes the native op layer folds
FLOAT_INT = Datatype(np.dtype([("val", np.float32), ("loc", np.int32)]),
                     "MPI_FLOAT_INT")
DOUBLE_INT = Datatype(np.dtype([("val", np.float64), ("loc", np.int32)]),
                      "MPI_DOUBLE_INT")
LONG_INT = Datatype(np.dtype([("val", np.int64), ("loc", np.int32)]),
                    "MPI_LONG_INT")
TWOINT = Datatype(np.dtype([("val", np.int32), ("loc", np.int32)]),
                  "MPI_2INT")


# ---------------------------------------------------------------------------
# Op
# ---------------------------------------------------------------------------

class Op:
    """Wraps a native reduction op; callable like mpi4py's, and carries
    the Python-object fold used by the lowercase collectives."""

    def __init__(self, native, pyfold=None, name: str = "user"):
        self._native = native
        self._py = pyfold
        self._name = name

    @classmethod
    def Create(cls, function, commute: bool = False) -> "Op":
        native = _op_mod.create_op(
            lambda a, b: function(a, b), commutative=commute)
        return cls(native, pyfold=function)

    def Free(self) -> None:
        pass

    def Reduce_local(self, inbuf, inoutbuf) -> None:
        """≈ MPI_Reduce_local: inoutbuf = op(inbuf, inoutbuf), purely
        local — delegates to the native helper, which enforces the
        equal-counts contract (a silent broadcast/truncate would give
        wrong reductions)."""
        land = _as_landing(inoutbuf, "Reduce_local")
        arr, _ = _values(inbuf)
        if _bits_tensor(_spec_buf(inoutbuf)) is None:
            _op_mod.reduce_local(arr, land, self._native)
            return
        # a bf16/float8 inout tensor: reduce its float32 values, and
        # round once as the result lands
        inout = np.array(_values(inoutbuf)[0], dtype=np.float32)
        _op_mod.reduce_local(np.asarray(arr, np.float32), inout,
                             self._native)
        _copy_into(inoutbuf, inout)

    def Is_commutative(self) -> bool:
        return _op_mod.op_commutative(self._native)

    def __call__(self, a, b):
        if self._py is not None:
            return self._py(a, b)
        return self._native(a, b)

    def __repr__(self) -> str:
        return f"<MPI.Op {self._name}>"


SUM = Op(_op_mod.SUM, lambda a, b: a + b, "MPI_SUM")
PROD = Op(_op_mod.PROD, lambda a, b: a * b, "MPI_PROD")
MAX = Op(_op_mod.MAX, lambda a, b: max(a, b), "MPI_MAX")
MIN = Op(_op_mod.MIN, lambda a, b: min(a, b), "MPI_MIN")
LAND = Op(_op_mod.LAND, lambda a, b: bool(a) and bool(b), "MPI_LAND")
LOR = Op(_op_mod.LOR, lambda a, b: bool(a) or bool(b), "MPI_LOR")
LXOR = Op(_op_mod.LXOR, lambda a, b: bool(a) != bool(b), "MPI_LXOR")
BAND = Op(_op_mod.BAND, lambda a, b: a & b, "MPI_BAND")
BOR = Op(_op_mod.BOR, lambda a, b: a | b, "MPI_BOR")
BXOR = Op(_op_mod.BXOR, lambda a, b: a ^ b, "MPI_BXOR")
MAXLOC = Op(_op_mod.MAXLOC, None, "MPI_MAXLOC")
MINLOC = Op(_op_mod.MINLOC, None, "MPI_MINLOC")
REPLACE = Op(_op_mod.REPLACE, lambda a, b: b, "MPI_REPLACE")
NO_OP = Op(_op_mod.NO_OP, lambda a, b: a, "MPI_NO_OP")


def _native_op(op) -> Any:
    return op._native if isinstance(op, Op) else op


# ---------------------------------------------------------------------------
# Status
# ---------------------------------------------------------------------------

class Status(_NativeStatus):
    """Native Status + the mpi4py accessor spelling."""

    def Get_source(self) -> int:
        return self.source

    def Get_tag(self) -> int:
        return self.tag

    def Get_error(self) -> int:
        return getattr(self, "error", 0)

    def Get_count(self, datatype: Datatype = BYTE) -> int:
        """Count in items of ``datatype`` (mpi4py semantics: converted
        from the received byte count when the PML recorded it)."""
        nbytes = getattr(self, "count_bytes", None)
        if nbytes is None:
            return self.count
        item = datatype.Get_size()
        if item <= 0:
            return 0
        if nbytes % item:
            return UNDEFINED
        return nbytes // item

    def Get_elements(self, datatype: Datatype = BYTE) -> int:
        return self.Get_count(datatype)

    def Is_cancelled(self) -> bool:
        # the native Status records cancellation as ``_cancelled``
        # (absorbed via __dict__.update in _fill_status)
        return bool(getattr(self, "cancelled",
                            getattr(self, "_cancelled", False)))

    def _absorb(self, native: Optional[_NativeStatus]) -> None:
        if native is not None:
            self.__dict__.update(native.__dict__)


def _fill_status(status: Optional[Status], native) -> None:
    if status is not None and native is not None:
        status.__dict__.update(native.__dict__)


# ---------------------------------------------------------------------------
# pickle framing for the lowercase API (≈ mpi4py's MPI.pickle hook:
# swap dumps/loads — e.g. for dill or a protocol pin — and every
# lowercase send/recv/bcast uses it)
# ---------------------------------------------------------------------------

_STDPICKLE = pickle   # stable stdlib alias: the name `pickle` is
# re-bound to the serializer INSTANCE at module end (mpi4py spelling)


class Pickle:
    def __init__(self, dumps=None, loads=None, protocol=None):
        self.PROTOCOL = (_STDPICKLE.HIGHEST_PROTOCOL
                         if protocol is None else protocol)
        self._dumps = dumps or (lambda o, p: _STDPICKLE.dumps(o, p))
        self._loads = loads or _STDPICKLE.loads

    def dumps(self, obj) -> bytes:
        return self._dumps(obj, self.PROTOCOL)

    def loads(self, data) -> Any:
        return self._loads(bytes(data))


pickle_impl = Pickle()


def _serializer() -> "Pickle":
    """The LIVE serializer: read through the module global so
    ``MPI.pickle = MPI.Pickle(dumps=..., loads=...)`` (the mpi4py idiom)
    swaps serialization for the whole lowercase API."""
    p = globals().get("pickle")
    return p if isinstance(p, Pickle) else pickle_impl


def _dumps(obj) -> np.ndarray:
    return np.frombuffer(_serializer().dumps(obj), dtype=np.uint8).copy()


def _loads(arr) -> Any:
    return _serializer().loads(
        np.ascontiguousarray(arr).view(np.uint8).tobytes())


# ---------------------------------------------------------------------------
# buffer specs: ndarray | [buf] | [buf, type] | [buf, count] |
#               [buf, count, type] | [buf, (counts, displs), type]
# ---------------------------------------------------------------------------

def _landing(buf, what: str = "receive buffer") -> np.ndarray:
    """The host memory a result lands in: the array itself, or a CPU
    tensor's own memory (a bf16/float8 tensor's bits).  A CUDA tensor
    raises ERR_BUFFER."""
    if not _is_tensor(buf):
        return np.asarray(buf)
    if buf.device.type != "cpu":
        raise _const.MPIException(
            f"{what}: a {buf.device.type} tensor lives in the card's "
            f"memory, which the host facade cannot land data in; pass a "
            f"numpy array or a CPU tensor, or run the collective on the "
            f"card through a Communicator bound to a DeviceCommunicator "
            f"(Communicator.bind_device)", error_class=_const.ERR_BUFFER)
    if not buf.is_contiguous():
        raise _const.MPIException(
            f"{what}: the tensor must be contiguous to land data in its "
            f"memory", error_class=_const.ERR_BUFFER)
    name = _torch_dtype_name(buf)
    if name in _BITS_DTYPE:
        import torch

        buf = buf.view(getattr(torch, _BITS_DTYPE[name]))
    return buf.detach().numpy()


def _bits_tensor(buf) -> Optional[str]:
    """The dtype name of a bf16/float8 tensor, else None."""
    if not _is_tensor(buf):
        return None
    name = _torch_dtype_name(buf)
    return name if name in _BITS_DTYPE else None


def _spec_buf(spec):
    return spec[0] if isinstance(spec, (list, tuple)) else spec


def _values(spec):
    """Send data of a reduction → (array, dtype name to round to).  A
    bf16/float8 tensor is converted to float32 on its own device (its
    values, not its bits); the result is rounded back by ``_rounded``."""
    name = _bits_tensor(_spec_buf(spec))
    if name is None:
        return _as_array(spec), None
    return _as_array(spec, bits_to=np.float32), name


def _rounded(out, name: Optional[str]):
    """A reduction's float32 result rounded to ``name``'s dtype (through
    torch, as the tensor's own dtype rounds), as float32 values."""
    if name is None or out is None:
        return out
    return _from_bits(_to_bits(out, name), name)


def _from_bits(bits: np.ndarray, name: str) -> np.ndarray:
    """The float32 values of a bf16/float8 tensor's bits."""
    import torch

    return torch.from_numpy(np.ascontiguousarray(bits)).view(
        getattr(torch, name)).float().numpy()


def _to_bits(values, name: str) -> np.ndarray:
    """float32 values rounded to ``name``'s dtype, as its bits."""
    import torch

    return torch.from_numpy(np.ascontiguousarray(
        values, dtype=np.float32)).to(getattr(torch, name)).view(
            getattr(torch, _BITS_DTYPE[name])).numpy()


def _as_array(spec, bits_to=None) -> np.ndarray:
    """A send spec's host array (a tensor staged in one copy at most)."""
    return _from_spec(spec, lambda buf: _staged(buf, bits_to))


def _as_landing(spec, what: str = "receive buffer") -> np.ndarray:
    """A receive/landing spec's array: the caller's own memory."""
    return _from_spec(spec, lambda buf: _landing(buf, what))


def _from_spec(spec, host) -> np.ndarray:
    """``host(buf)`` of the spec's buffer, viewed as its datatype and cut
    to its count."""
    if isinstance(spec, (list, tuple)):
        arr = host(spec[0])
        count = None
        dtype = None
        for extra in spec[1:]:
            if isinstance(extra, Datatype):
                dtype = extra
            elif isinstance(extra, (int, np.integer)):
                count = int(extra)
        if dtype is not None and arr.dtype != dtype.np_dtype:
            arr = arr.view(dtype.np_dtype)
        if count is not None:
            arr = arr.reshape(-1)[:count]
        return arr
    return host(spec)


def _to_native_dt(dt):
    """Facade (or native) datatype → native datatype — the ONE coercion."""
    return dt._to_native() if isinstance(dt, Datatype) else dt


def _wrap_info(native) -> "Info":
    """Native Info → facade Info (identity when already wrapped)."""
    return native if isinstance(native, Info) \
        else Info(dict(native.items()))


def _copy_into(dst_spec, src) -> None:
    """Write a collective/receive result into the caller's buffer."""
    dst = _as_landing(dst_spec)
    src = np.asarray(src)
    flat = src.reshape(-1)
    if dst.dtype != flat.dtype:
        name = _bits_tensor(_spec_buf(dst_spec))
        if name is not None and flat.dtype.kind in "fc":
            # a float result into a bf16/float8 tensor: its values
            flat = _to_bits(flat, name)
        else:
            flat = flat.astype(dst.dtype)
    dst.reshape(-1)[: flat.size] = flat


# ---------------------------------------------------------------------------
# Request / Prequest
# ---------------------------------------------------------------------------

class Request:
    """Wraps a native request.  ``wait``/``test`` (lowercase) return the
    payload (unpickled for object receives); ``Wait``/``Test`` follow the
    buffer-API convention."""

    def __init__(self, native, transform=None):
        self._r = native
        self._transform = transform

    def _finish(self, out):
        """Apply the landing transform exactly once.  For the uppercase
        buffer API the transform is what copies collective results into
        the caller's receive buffer (Ibcast/Iallreduce), so EVERY
        completion path — Wait/Test and the families, not just the
        lowercase object API — must run it."""
        if self._transform is not None:
            t, self._transform = self._transform, None
            return t(out)
        return out

    # -- buffer convention -------------------------------------------------
    def Wait(self, status: Optional[Status] = None) -> bool:
        self._finish(self._r.wait())
        _fill_status(status, getattr(self._r, "status", None))
        return True

    def Test(self, status: Optional[Status] = None) -> bool:
        done = self._r.test()
        if done:
            self._finish(self._r.wait())  # complete: returns the payload
            _fill_status(status, getattr(self._r, "status", None))
        return bool(done)

    def Cancel(self) -> None:
        self._r.cancel()

    def Free(self) -> None:
        pass

    # -- object convention -------------------------------------------------
    def wait(self, status: Optional[Status] = None) -> Any:
        out = self._r.wait()
        _fill_status(status, getattr(self._r, "status", None))
        return self._finish(out)

    def test(self, status: Optional[Status] = None):
        done = self._r.test()
        if not done:
            return (False, None)
        _fill_status(status, getattr(self._r, "status", None))
        out = self._r.wait()  # already complete: returns the payload
        return (True, self._finish(out))

    # -- families ----------------------------------------------------------
    @staticmethod
    def Waitall(requests: Sequence["Request"], statuses=None) -> bool:
        _req_mod.wait_all([r._r for r in requests])
        for i, req in enumerate(requests):
            req._finish(req._r.wait())  # complete: landing transforms run
            if statuses is not None and i < len(statuses):
                _fill_status(statuses[i], getattr(req._r, "status", None))
        return True

    @staticmethod
    def waitall(requests: Sequence["Request"]) -> list:
        _req_mod.wait_all([r._r for r in requests])
        return [r._finish(r._r.wait()) for r in requests]

    @staticmethod
    def Waitany(requests: Sequence["Request"],
                status: Optional[Status] = None) -> int:
        idx, _ = _req_mod.wait_any([r._r for r in requests])
        if idx is not None and idx >= 0:
            req = requests[idx]
            req._finish(req._r.wait())
            _fill_status(status, getattr(req._r, "status", None))
        return UNDEFINED if idx is None else idx

    @staticmethod
    def Testall(requests: Sequence["Request"], statuses=None) -> bool:
        if not all(r._r.test() for r in requests):
            return False
        for i, req in enumerate(requests):
            req._finish(req._r.wait())
            if statuses is not None and i < len(statuses):
                _fill_status(statuses[i], getattr(req._r, "status", None))
        return True

    @staticmethod
    def Startall(requests: Sequence["Prequest"]) -> None:
        """Passthrough so loops written against ``MPI.Request.Startall``
        port unchanged (all-or-nothing, like the native start_all)."""
        _req_mod.start_all([r._r for r in requests])


class Prequest(Request):
    """Persistent request (MPI_Send_init/Recv_init → Start; also the
    handle type the persistent-collective and partitioned ``*_init``
    families return)."""

    def _finish(self, out):
        # persistent: the landing transform re-runs after EVERY
        # start/wait cycle (the base class clears it after one shot —
        # a persistent Allreduce_init must refill recvbuf each time)
        if self._transform is not None:
            return self._transform(out)
        return out

    def Start(self) -> None:
        self._r.start()

    # Startall is inherited from Request (the all-or-nothing native
    # start_all), reachable as both MPI.Request.Startall and the
    # mpi4py-canonical MPI.Prequest.Startall.

    # -- partitioned operations (MPI-4; valid on Psend/Precv handles) ------

    def Pready(self, partition: int) -> None:
        self._r.pready(partition)

    def Pready_range(self, partition_low: int,
                     partition_high: int) -> None:
        self._r.pready_range(partition_low, partition_high)

    def Pready_list(self, partitions) -> None:
        self._r.pready_list(partitions)

    def Parrived(self, partition: int) -> bool:
        return self._r.parrived(partition)


class Message:
    """Matched-probe handle (MPI_Mprobe → MPI_Mrecv)."""

    def __init__(self, comm, native_msg):
        self._comm = comm
        self._m = native_msg

    def Recv(self, buf=None, status: Optional[Status] = None):
        arr = None if buf is None else _as_landing(buf, "Message.Recv")
        st = _NativeStatus()
        out = self._comm.mrecv(arr, self._m, status=st)
        _fill_status(status, st)
        if buf is not None and out is not None and not np.shares_memory(
                arr, np.asarray(out)):
            _copy_into(buf, out)
        return out

    def Irecv(self, buf=None) -> Request:
        arr = None if buf is None else _as_landing(buf, "Message.Irecv")
        return Request(self._comm.imrecv(arr, self._m))

    def recv(self, status: Optional[Status] = None) -> Any:
        st = _NativeStatus()
        out = self._comm.mrecv(None, self._m, status=st)
        _fill_status(status, st)
        return _loads(out)


# ---------------------------------------------------------------------------
# Group
# ---------------------------------------------------------------------------

class Group:
    def __init__(self, native, my_world_rank: Optional[int] = None):
        self._g = native
        self._my_world = my_world_rank

    def Get_size(self) -> int:
        return self._g.size

    def Get_rank(self) -> int:
        if self._my_world is None:
            return UNDEFINED
        r = self._g.rank_of(self._my_world)
        return UNDEFINED if r is None or r < 0 else r

    def Compare(self, other: "Group") -> int:
        """≈ MPI_Group_compare."""
        mine, theirs = list(self._g.ranks), list(other._g.ranks)
        if mine == theirs:
            return IDENT
        if sorted(mine) == sorted(theirs):
            return SIMILAR
        return UNEQUAL

    def Incl(self, ranks) -> "Group":
        return Group(self._g.incl(ranks), self._my_world)

    def Excl(self, ranks) -> "Group":
        return Group(self._g.excl(ranks), self._my_world)

    def Range_incl(self, ranges) -> "Group":
        return Group(self._g.range_incl(ranges), self._my_world)

    def Range_excl(self, ranges) -> "Group":
        return Group(self._g.range_excl(ranges), self._my_world)

    def Union(self, other: "Group") -> "Group":
        return Group(self._g.union(other._g), self._my_world)

    def Intersection(self, other: "Group") -> "Group":
        return Group(self._g.intersection(other._g), self._my_world)

    def Difference(self, other: "Group") -> "Group":
        return Group(self._g.difference(other._g), self._my_world)

    def Translate_ranks(self, ranks, other: "Group"):
        return self._g.translate_ranks(ranks, other._g)

    def Free(self) -> None:
        pass

    @property
    def size(self) -> int:
        return self.Get_size()

    @property
    def rank(self) -> int:
        return self.Get_rank()


# ---------------------------------------------------------------------------
# Comm
# ---------------------------------------------------------------------------

class Comm:
    """mpi4py-shaped communicator over a native :class:`Communicator`.

    Uppercase methods take buffers (numpy arrays or ``[buf, count, type]``
    specs) and write results into caller-provided receive buffers;
    lowercase methods move arbitrary pickled Python objects.
    """

    def __init__(self, native):
        self._comm = native

    @property
    def _c(self):
        return self._comm

    # -- identity ----------------------------------------------------------

    def Get_rank(self) -> int:
        return self._c.rank

    def Get_size(self) -> int:
        return self._c.size

    def Get_name(self) -> str:
        return self._c.get_name()

    def Set_name(self, name: str) -> None:
        self._c.set_name(name)

    def Get_group(self) -> Group:
        g = self._c.get_group()
        return Group(g, g.world_rank(self._c.rank))

    def Is_inter(self) -> bool:
        return self._c.test_inter()

    def Is_intra(self) -> bool:
        return not self._c.test_inter()

    # -- nonblocking collectives (remaining family) ------------------------
    def Igather(self, sendbuf, recvbuf, root: int = 0) -> Request:
        me = self._c.rank

        def land(out):
            if me == root and recvbuf is not None:
                _copy_into(recvbuf, self._stacked(out))

        return Request(self._c.igather(_as_array(sendbuf), root),
                       transform=land)

    def Iscatter(self, sendbuf, recvbuf, root: int = 0) -> Request:
        send = None
        if self._c.rank == root:
            send = _as_array(sendbuf).reshape(self._c.size, -1)

        def land(out):
            if recvbuf is not None:
                _copy_into(recvbuf, out)

        return Request(self._c.iscatter(send, root), transform=land)

    def Iallgather(self, sendbuf, recvbuf) -> Request:
        return Request(
            self._c.iallgather(_as_array(sendbuf)),
            transform=lambda out: _copy_into(recvbuf,
                                             self._stacked(out)))

    def Ialltoall(self, sendbuf, recvbuf) -> Request:
        arr = _as_array(sendbuf).reshape(self._c.size, -1)
        return Request(
            self._c.ialltoall(arr),
            transform=lambda out: _copy_into(recvbuf,
                                             self._stacked(out)))

    def Iscan(self, sendbuf, recvbuf, op: "Op" = None) -> Request:
        send, rnd = _values(sendbuf)
        return Request(
            self._c.iscan(send, _native_op(op or SUM)),
            transform=lambda out: _copy_into(recvbuf, _rounded(out, rnd)))

    def Iexscan(self, sendbuf, recvbuf, op: "Op" = None) -> Request:
        me = self._c.rank

        send, rnd = _values(sendbuf)

        def land(out):
            if me != 0 and out is not None:
                _copy_into(recvbuf, _rounded(out, rnd))

        return Request(self._c.iexscan(send, _native_op(op or SUM)),
                       transform=land)

    # -- v-collectives (remaining uppercase forms) -------------------------
    def Alltoallv(self, sendbuf, recvbuf) -> None:
        arr, counts, displs, _dt = _vspec(sendbuf)
        flat = arr.reshape(-1)
        parts = [flat[d:d + c] for c, d in zip(counts, displs)]
        out = self._c.alltoallv(parts)
        _place_v(recvbuf, out)

    def Alltoallw(self, sendmsg, recvmsg) -> None:
        """mpi4py message format: ``[buf, counts, displs, datatypes]``
        (displacements in BYTES, one datatype per peer).  Converted to
        the native per-peer (buf-view, datatype, count) triples; recv
        views alias the caller's buffer so the fill is in place."""
        def conv(msg, landing: bool):
            buf, counts, displs, dts = msg
            raw = (_landing(buf, "Alltoallw") if landing
                   else _staged(buf)).view(np.uint8).reshape(-1)
            out = []
            for r in range(self._c.size):
                cnt = int(counts[r])
                if cnt == 0:
                    out.append(None)
                    continue
                nat = _to_native_dt(dts[r] if isinstance(dts, (list,
                                                              tuple))
                                    else dts)
                lo = int(displs[r])
                view = raw[lo:lo + cnt * nat.size].view(nat.base_np)
                out.append((view, nat, cnt))
            return out

        self._c.alltoallw(conv(sendmsg, False), conv(recvmsg, True))

    # -- attributes (≈ MPI_Comm_{set,get,delete}_attr) ---------------------
    @staticmethod
    def Create_keyval(copy_fn=None, delete_fn=None) -> "_Keyval":
        return _keyval_create(copy_fn, delete_fn)

    @staticmethod
    def Free_keyval(keyval) -> int:
        _keyval_free(keyval)
        return KEYVAL_INVALID

    def Set_attr(self, keyval, value) -> None:
        self._c.set_attr(keyval, value)

    def Get_attr(self, keyval):
        if keyval is TAG_UB:
            return _MAX_TAG
        return self._c.get_attr(keyval)

    def Delete_attr(self, keyval) -> None:
        self._c.delete_attr(keyval)

    # -- info / errhandler -------------------------------------------------
    def Set_info(self, info) -> None:
        self._c.set_info(info)

    def Get_info(self) -> "Info":
        return _wrap_info(self._c.get_info())

    def Set_errhandler(self, errhandler) -> None:
        from ompi_tpu_torch.mpi import errhandler as _eh

        named = {ERRORS_RETURN: _eh.ERRORS_RETURN,
                 ERRORS_ARE_FATAL: _eh.ERRORS_ARE_FATAL}
        self._c.errhandler = named.get(errhandler, errhandler)

    def Get_errhandler(self):
        return self._c.errhandler

    # -- structure queries -------------------------------------------------
    def Compare(self, other: "Comm") -> int:
        """≈ MPI_Comm_compare (classic group-based definition)."""
        if self._c is other._c:
            return IDENT
        mine = list(self._c.group.ranks)
        theirs = list(other._c.group.ranks)
        if mine == theirs:
            return CONGRUENT
        if sorted(mine) == sorted(theirs):
            return SIMILAR
        return UNEQUAL

    def Get_topology(self) -> int:
        t = getattr(self._c, "topo", None)
        if t is None:
            return UNDEFINED
        return {"cart": CART, "graph": GRAPH,
                "dist_graph": DIST_GRAPH}[t.kind]

    def Idup(self) -> tuple["Comm", "Request"]:
        """mpi4py order: (newcomm, request) — use the comm only after
        the request completes."""
        req, new = self._c.idup()
        return Comm(new), Request(req)

    def Clone(self) -> "Comm":
        return self.Dup()

    def Create_dist_graph_adjacent(self, sources, destinations,
                                   sourceweights=None,
                                   destweights=None,
                                   info=None,
                                   reorder: bool = False
                                   ) -> "Distgraphcomm":
        new = self._c.dist_graph_create_adjacent(
            list(sources), list(destinations),
            list(sourceweights) if sourceweights is not None else None,
            list(destweights) if destweights is not None else None)
        return Distgraphcomm(new) if new is not None else None

    def Create_dist_graph(self, sources, degrees, destinations,
                          weights=None, info=None,
                          reorder: bool = False) -> "Distgraphcomm":
        new = self._c.dist_graph_create(
            list(sources), list(degrees), list(destinations),
            list(weights) if weights is not None else None)
        return Distgraphcomm(new) if new is not None else None

    # -- buffered sends (object forms; uppercase Bsend/Ibsend exist) ------
    def bsend(self, obj, dest: int, tag: int = 0) -> None:
        self._c.bsend(_dumps(obj), dest, tag)

    def ibsend(self, obj, dest: int, tag: int = 0) -> Request:
        return Request(self._c.ibsend(_dumps(obj), dest, tag))

    @property
    def rank(self) -> int:
        return self._c.rank

    @property
    def size(self) -> int:
        return self._c.size

    @property
    def name(self) -> str:
        return self._c.get_name()

    # -- management --------------------------------------------------------

    def Spawn(self, command: str, args=None, maxprocs: int = 1,
              info=None, root: int = 0) -> "Intercomm":
        """≈ MPI_Comm_spawn through the real launcher (root semantics:
        every rank calls; the native layer launches from rank 0)."""
        from ompi_tpu_torch.mpi import dpm as _dpm

        argv = [command] + list(args or [])
        return Intercomm(_dpm.spawn(self._c, argv, maxprocs=maxprocs))

    @staticmethod
    def Get_parent() -> Optional["Intercomm"]:
        from ompi_tpu_torch.mpi import dpm as _dpm

        native = _dpm.get_parent(COMM_WORLD._c)
        return Intercomm(native) if native is not None else None

    def Create_graph(self, index, edges,
                     reorder: bool = False) -> "Graphcomm":
        """≈ MPI_Graph_create (collective; None on excluded ranks)."""
        new = self._c.graph_create(index, edges, reorder=reorder)
        return Graphcomm(new) if new is not None else None

    def Create_cart(self, dims, periods=None,
                    reorder: bool = False) -> "Cartcomm":
        """≈ MPI_Cart_create (collective; None on excluded ranks).

        mpi4py defaults periods to all-False — the native layer's
        default is all-True (TPU torus), so the facade must pin it."""
        if periods is None:
            periods = [False] * len(list(dims))
        new = self._c.cart_create(dims, periods=periods, reorder=reorder)
        return Cartcomm(new) if new is not None else None

    def Dup(self) -> "Comm":
        return Comm(self._c.dup())

    def Split(self, color: int = 0, key: int = 0) -> Optional["Comm"]:
        sub = self._c.split(color, key)
        return None if sub is None else Comm(sub)

    def Split_type(self, split_type: int = COMM_TYPE_SHARED, key: int = 0,
                   info=None) -> Optional["Comm"]:
        sub = self._c.split_type(split_type, key)
        return None if sub is None else Comm(sub)

    def Create(self, group: Group) -> Optional["Comm"]:
        sub = self._c.create(group._g)
        return None if sub is None else Comm(sub)

    def Create_group(self, group: Group, tag: int = 0) -> Optional["Comm"]:
        sub = self._c.create_group(group._g, tag)
        return None if sub is None else Comm(sub)

    def Free(self) -> None:
        self._c.free()

    def Abort(self, errorcode: int = 1):
        import ompi_tpu_torch

        ompi_tpu_torch.abort(errorcode)

    # -- point-to-point: buffer convention ---------------------------------

    def Send(self, buf, dest: int, tag: int = 0) -> None:
        self._c.send(_as_array(buf), dest, tag)

    def Ssend(self, buf, dest: int, tag: int = 0) -> None:
        self._c.ssend(_as_array(buf), dest, tag)

    def Bsend(self, buf, dest: int, tag: int = 0) -> None:
        self._c.bsend(_as_array(buf), dest, tag)

    def Rsend(self, buf, dest: int, tag: int = 0) -> None:
        self._c.rsend(_as_array(buf), dest, tag)

    def Recv(self, buf, source: int = ANY_SOURCE, tag: int = ANY_TAG,
             status: Optional[Status] = None) -> None:
        arr = _as_landing(buf, "Recv")
        st = _NativeStatus()
        out = self._c.recv(arr, source, tag, status=st)
        _fill_status(status, st)
        if out is not None and not np.shares_memory(arr, np.asarray(out)):
            _copy_into(buf, out)

    def Isend(self, buf, dest: int, tag: int = 0) -> Request:
        return Request(self._c.isend(_as_array(buf), dest, tag))

    def Issend(self, buf, dest: int, tag: int = 0) -> Request:
        return Request(self._c.issend(_as_array(buf), dest, tag))

    def Ibsend(self, buf, dest: int, tag: int = 0) -> Request:
        return Request(self._c.ibsend(_as_array(buf), dest, tag))

    def Irsend(self, buf, dest: int, tag: int = 0) -> Request:
        return Request(self._c.irsend(_as_array(buf), dest, tag))

    def Irecv(self, buf, source: int = ANY_SOURCE,
              tag: int = ANY_TAG) -> Request:
        return Request(self._c.irecv(_as_landing(buf, "Irecv"), source,
                                     tag))

    def Sendrecv(self, sendbuf, dest: int, sendtag: int = 0, recvbuf=None,
                 source: int = ANY_SOURCE, recvtag: int = ANY_TAG,
                 status: Optional[Status] = None) -> None:
        st = _NativeStatus()
        land = (None if recvbuf is None
                else _as_landing(recvbuf, "Sendrecv"))
        out = self._c.sendrecv(
            _as_array(sendbuf), dest, land,
            source, sendtag, recvtag, status=st)
        _fill_status(status, st)
        if recvbuf is not None and out is not None and not np.shares_memory(
                land, np.asarray(out)):
            _copy_into(recvbuf, out)

    def Sendrecv_replace(self, buf, dest: int, sendtag: int = 0,
                         source: int = ANY_SOURCE, recvtag: int = ANY_TAG,
                         status: Optional[Status] = None) -> None:
        st = _NativeStatus()
        self._c.sendrecv_replace(_as_landing(buf, "Sendrecv_replace"), dest,
                                 source, sendtag, recvtag, status=st)
        _fill_status(status, st)

    def Send_init(self, buf, dest: int, tag: int = 0) -> Prequest:
        return Prequest(self._c.send_init(_as_array(buf), dest, tag))

    def Recv_init(self, buf, source: int = ANY_SOURCE,
                  tag: int = ANY_TAG) -> Prequest:
        return Prequest(self._c.recv_init(_as_landing(buf, "Recv_init"),
                                          source, tag))

    # -- persistent collectives + partitioned p2p (MPI-4 *_init) -----------

    def Barrier_init(self) -> Prequest:
        return Prequest(self._c.barrier_init())

    def Bcast_init(self, buf, root: int = 0) -> Prequest:
        # one buffer, both roles (the mpi4py shape): the root's payload
        # is re-read per start, a non-root's is the landing buffer the
        # native layer fills in place at each wait
        arr = (_as_array(buf) if self._c.rank == root
               else _as_landing(buf, "Bcast_init"))
        return Prequest(self._c.bcast_init(arr, root=root))

    def Allreduce_init(self, sendbuf, recvbuf, op: "Op" = None
                       ) -> Prequest:
        send, rnd = _values(sendbuf)
        return Prequest(
            self._c.allreduce_init(send, op=_native_op(op or SUM)),
            transform=lambda out: _copy_into(recvbuf, _rounded(out, rnd)))

    def Psend_init(self, buf, partitions: int, dest: int,
                   tag: int = 0) -> Prequest:
        return Prequest(self._c.psend_init(
            _as_array(buf), dest, tag=tag, partitions=partitions))

    def Precv_init(self, buf, partitions: int, source: int,
                   tag: int = 0) -> Prequest:
        return Prequest(self._c.precv_init(
            _as_landing(buf, "Precv_init"), source, tag=tag,
            partitions=partitions))

    # -- probes ------------------------------------------------------------

    def Probe(self, source: int = ANY_SOURCE, tag: int = ANY_TAG,
              status: Optional[Status] = None) -> bool:
        st = self._c.probe(source, tag)
        _fill_status(status, st)
        return True

    def Iprobe(self, source: int = ANY_SOURCE, tag: int = ANY_TAG,
               status: Optional[Status] = None) -> bool:
        st = self._c.iprobe(source, tag)
        if st is None:
            return False
        _fill_status(status, st)
        return True

    def Mprobe(self, source: int = ANY_SOURCE, tag: int = ANY_TAG,
               status: Optional[Status] = None) -> Message:
        msg, st = self._c.mprobe(source, tag)
        _fill_status(status, st)
        return Message(self._c, msg)

    def Improbe(self, source: int = ANY_SOURCE, tag: int = ANY_TAG,
                status: Optional[Status] = None) -> Optional[Message]:
        out = self._c.improbe(source, tag)
        if out is None:
            return None
        msg, st = out
        _fill_status(status, st)
        return Message(self._c, msg)

    # -- collectives: buffer convention ------------------------------------

    def Barrier(self) -> None:
        self._c.barrier()

    def Bcast(self, buf, root: int = 0) -> None:
        arr = _as_array(buf) if self._c.rank == root else None
        out = self._c.bcast(arr, root)
        if self._c.rank != root:
            _copy_into(buf, out)

    def Reduce(self, sendbuf, recvbuf, op: Op = SUM, root: int = 0) -> None:
        send, rnd = _values(recvbuf if sendbuf is IN_PLACE else sendbuf)
        out = self._c.reduce(send, op=_native_op(op), root=root)
        if self._c.rank == root and recvbuf is not None:
            _copy_into(recvbuf, _rounded(out, rnd))

    def Allreduce(self, sendbuf, recvbuf, op: Op = SUM) -> None:
        send, rnd = _values(recvbuf if sendbuf is IN_PLACE else sendbuf)
        out = self._c.allreduce(send, op=_native_op(op))
        _copy_into(recvbuf, _rounded(out, rnd))

    @staticmethod
    def _stacked(out):
        """Uniform-count collectives return a stacked ndarray from the
        native path — pass it straight through (uppercase = zero extra
        copies); only a non-array per-rank list pays the concatenate."""
        if isinstance(out, np.ndarray):
            return out
        return np.concatenate([np.asarray(p).reshape(-1) for p in out])

    def Gather(self, sendbuf, recvbuf, root: int = 0) -> None:
        out = self._c.gather(_as_array(sendbuf), root)
        if self._c.rank == root and recvbuf is not None:
            _copy_into(recvbuf, self._stacked(out))

    def Gatherv(self, sendbuf, recvbuf, root: int = 0) -> None:
        out = self._c.gatherv(_as_array(sendbuf), root)
        if self._c.rank == root and recvbuf is not None:
            _place_v(recvbuf, out)

    def Allgather(self, sendbuf, recvbuf) -> None:
        out = self._c.allgather(_as_array(sendbuf))
        _copy_into(recvbuf, self._stacked(out))

    def Allgatherv(self, sendbuf, recvbuf) -> None:
        out = self._c.allgatherv(_as_array(sendbuf))
        _place_v(recvbuf, out)

    def Scatter(self, sendbuf, recvbuf, root: int = 0) -> None:
        send = None
        if self._c.rank == root:
            arr = _as_array(sendbuf)
            send = arr.reshape(self._c.size, -1)
        out = self._c.scatter(send, root)
        if recvbuf is not None:
            _copy_into(recvbuf, out)

    def Scatterv(self, sendbuf, recvbuf, root: int = 0) -> None:
        parts = None
        if self._c.rank == root:
            arr, counts, displs, dtype = _vspec(sendbuf)
            parts = [arr.reshape(-1)[d:d + c]
                     for c, d in zip(counts, displs)]
        out = self._c.scatterv(parts, root)
        if recvbuf is not None:
            _copy_into(recvbuf, out)

    def Alltoall(self, sendbuf, recvbuf) -> None:
        arr = _as_array(sendbuf).reshape(self._c.size, -1)
        out = self._c.alltoall(arr)
        _copy_into(recvbuf, self._stacked(out))

    def Reduce_scatter_block(self, sendbuf, recvbuf, op: Op = SUM) -> None:
        send, rnd = _values(sendbuf)
        out = self._c.reduce_scatter_block(send, op=_native_op(op))
        _copy_into(recvbuf, _rounded(out, rnd))

    def Reduce_scatter(self, sendbuf, recvbuf, recvcounts=None,
                       op: Op = SUM) -> None:
        arr, rnd = _values(sendbuf)
        if recvcounts is not None:
            # explicit counts: reduce everywhere, keep my segment (the
            # native reduce_scatter contract is the equal array_split)
            me = self._c.rank
            displs = np.concatenate([[0], np.cumsum(recvcounts)[:-1]])
            reduced = np.asarray(
                self._c.allreduce(arr, op=_native_op(op))).reshape(-1)
            out = reduced[displs[me]:displs[me] + recvcounts[me]]
        else:
            out = self._c.reduce_scatter(arr, op=_native_op(op))
        _copy_into(recvbuf, _rounded(out, rnd))

    def Scan(self, sendbuf, recvbuf, op: Op = SUM) -> None:
        send, rnd = _values(sendbuf)
        out = self._c.scan(send, op=_native_op(op))
        _copy_into(recvbuf, _rounded(out, rnd))

    def Exscan(self, sendbuf, recvbuf, op: Op = SUM) -> None:
        send, rnd = _values(sendbuf)
        out = self._c.exscan(send, op=_native_op(op))
        if self._c.rank != 0 and out is not None:
            _copy_into(recvbuf, _rounded(out, rnd))

    # nonblocking collectives (the libnbc twins)
    def Ibarrier(self) -> Request:
        return Request(self._c.ibarrier())

    def Ibcast(self, buf, root: int = 0) -> Request:
        me = self._c.rank
        arr = _as_array(buf) if me == root else None
        req = self._c.ibcast(arr if me == root else None, root)
        if me == root:
            return Request(req)

        def land(out, _buf=buf):
            if out is not None:
                _copy_into(_buf, out)
            return out

        return Request(req, transform=land)

    def Iallreduce(self, sendbuf, recvbuf, op: Op = SUM) -> Request:
        send, rnd = _values(recvbuf if sendbuf is IN_PLACE else sendbuf)
        req = self._c.iallreduce(send, op=_native_op(op))

        def land(out, _buf=recvbuf):
            out = _rounded(out, rnd)
            _copy_into(_buf, out)
            return out

        return Request(req, transform=land)

    # -- point-to-point: object convention ---------------------------------

    def send(self, obj, dest: int, tag: int = 0) -> None:
        self._c.send(_dumps(obj), dest, tag)

    def ssend(self, obj, dest: int, tag: int = 0) -> None:
        self._c.ssend(_dumps(obj), dest, tag)

    def recv(self, buf=None, source: int = ANY_SOURCE, tag: int = ANY_TAG,
             status: Optional[Status] = None) -> Any:
        st = _NativeStatus()
        out = self._c.recv(None, source, tag, status=st)
        _fill_status(status, st)
        return _loads(out)

    def isend(self, obj, dest: int, tag: int = 0) -> Request:
        return Request(self._c.isend(_dumps(obj), dest, tag))

    def issend(self, obj, dest: int, tag: int = 0) -> Request:
        return Request(self._c.issend(_dumps(obj), dest, tag))

    def irecv(self, buf=None, source: int = ANY_SOURCE,
              tag: int = ANY_TAG) -> Request:
        return Request(self._c.irecv(None, source, tag), transform=_loads)

    def sendrecv(self, sendobj, dest: int, sendtag: int = 0, recvbuf=None,
                 source: int = ANY_SOURCE, recvtag: int = ANY_TAG,
                 status: Optional[Status] = None) -> Any:
        st = _NativeStatus()
        out = self._c.sendrecv(_dumps(sendobj), dest, None, source,
                               sendtag, recvtag, status=st)
        _fill_status(status, st)
        return _loads(out)

    def probe(self, source: int = ANY_SOURCE, tag: int = ANY_TAG,
              status: Optional[Status] = None) -> bool:
        return self.Probe(source, tag, status)

    def iprobe(self, source: int = ANY_SOURCE, tag: int = ANY_TAG,
               status: Optional[Status] = None) -> bool:
        return self.Iprobe(source, tag, status)

    def mprobe(self, source: int = ANY_SOURCE, tag: int = ANY_TAG,
               status: Optional[Status] = None) -> Message:
        return self.Mprobe(source, tag, status)

    def improbe(self, source: int = ANY_SOURCE, tag: int = ANY_TAG,
                status: Optional[Status] = None) -> Optional[Message]:
        return self.Improbe(source, tag, status)

    # -- collectives: object convention ------------------------------------

    def barrier(self) -> None:
        self._c.barrier()

    def bcast(self, obj, root: int = 0) -> Any:
        me = self._c.rank
        out = self._c.bcast(_dumps(obj) if me == root else None, root)
        return _loads(out)

    def gather(self, sendobj, root: int = 0) -> Optional[list]:
        out = self._c.gatherv(_dumps(sendobj), root)
        if self._c.rank != root:
            return None
        return [_loads(p) for p in out]

    def allgather(self, sendobj) -> list:
        out = self._c.allgatherv(_dumps(sendobj))
        return [_loads(p) for p in out]

    def scatter(self, sendobj, root: int = 0) -> Any:
        parts = None
        if self._c.rank == root:
            if len(sendobj) != self._c.size:
                raise ValueError(
                    f"scatter list has {len(sendobj)} entries for "
                    f"{self._c.size} ranks")
            parts = [_dumps(o) for o in sendobj]
        out = self._c.scatterv(parts, root)
        return _loads(out)

    def alltoall(self, sendobjs) -> list:
        parts = [_dumps(o) for o in sendobjs]
        out = self._c.alltoallv(parts)
        return [_loads(p) for p in out]

    def reduce(self, sendobj, op: Op = SUM, root: int = 0) -> Any:
        vals = self.allgather(sendobj)
        if self._c.rank != root:
            return None
        return _pyfold(op, vals)

    def allreduce(self, sendobj, op: Op = SUM) -> Any:
        return _pyfold(op, self.allgather(sendobj))

    def scan(self, sendobj, op: Op = SUM) -> Any:
        vals = self.allgather(sendobj)
        return _pyfold(op, vals[: self._c.rank + 1])

    def exscan(self, sendobj, op: Op = SUM) -> Any:
        vals = self.allgather(sendobj)
        if self._c.rank == 0:
            return None
        return _pyfold(op, vals[: self._c.rank])

    def __repr__(self) -> str:
        return f"<MPI.Comm {self._c!r}>"


Intracomm = Comm  # mpi4py exposes COMM_WORLD as an Intracomm


def _pyfold(op: Op, vals: list) -> Any:
    fold = op._py if isinstance(op, Op) and op._py is not None else op
    acc = vals[0]
    for v in vals[1:]:
        acc = fold(acc, v)
    return acc


def _place_v(recv_spec, parts) -> None:
    """Write gathered per-rank pieces into the receive buffer.  With a
    [buf, counts, displs?, type?] spec each rank's piece lands at its
    displacement (displs may reorder or leave gaps — MPI Gatherv
    semantics); a bare buffer packs the pieces contiguously."""
    parts = [np.asarray(p).reshape(-1) for p in parts]
    has_layout = (isinstance(recv_spec, (list, tuple))
                  and any(not isinstance(e, Datatype)
                          for e in recv_spec[1:]))
    if not has_layout:
        _copy_into(recv_spec, np.concatenate(parts))
        return
    buf, counts, displs, _ = _vspec(recv_spec, landing=True)
    flat = buf.reshape(-1)
    for p, c, d in zip(parts, counts, displs):
        seg = p[:c]
        if flat.dtype != seg.dtype:
            seg = seg.astype(flat.dtype)
        flat[d:d + seg.size] = seg


def _vspec(spec, landing: bool = False):
    """[buf, counts, displs?, datatype?] → (arr, counts, displs, dtype);
    ``landing``: the buffer receives (the caller's own memory)."""
    if not isinstance(spec, (list, tuple)):
        raise ValueError("Scatterv/Gatherv need [buf, counts, ...] specs")
    buf = _landing(spec[0]) if landing else _staged(spec[0])
    counts = None
    displs = None
    dtype = None
    seq = []
    for extra in spec[1:]:
        if isinstance(extra, Datatype):
            dtype = extra
        else:
            seq.append(extra)
    if len(seq) == 1:
        item = seq[0]
        if (isinstance(item, (list, tuple)) and len(item) == 2
                and isinstance(item[0], (list, tuple, np.ndarray))):
            counts, displs = item
        else:
            counts = item
    elif len(seq) >= 2:
        counts, displs = seq[0], seq[1]
    counts = [int(c) for c in np.asarray(counts).reshape(-1)]
    if displs is None:
        displs = list(np.concatenate([[0], np.cumsum(counts)[:-1]]))
    else:
        displs = [int(d) for d in np.asarray(displs).reshape(-1)]
    if dtype is not None and buf.dtype != dtype.np_dtype:
        buf = buf.view(dtype.np_dtype)
    return buf, counts, displs, dtype




# ---------------------------------------------------------------------------
# Intercomm / spawn facade (dynamic process management)
# ---------------------------------------------------------------------------

class Intercomm:
    """mpi4py-style intercommunicator over the native DPM intercomm:
    p2p ranks address the REMOTE group; Merge folds both groups into
    one intracommunicator."""

    def __init__(self, native) -> None:
        self._i = native

    def Get_rank(self) -> int:
        return self._i.rank

    def Get_size(self) -> int:
        return self._i.size

    def Get_remote_size(self) -> int:
        return self._i.remote_size

    @property
    def rank(self) -> int:
        return self._i.rank

    @property
    def size(self) -> int:
        return self._i.size

    @property
    def remote_size(self) -> int:
        return self._i.remote_size

    # -- buffer p2p against the remote group -------------------------------
    def Send(self, buf, dest: int, tag: int = 0) -> None:
        self._i.send(_as_array(buf), dest, tag)

    def Recv(self, buf, source: int = ANY_SOURCE, tag: int = ANY_TAG,
             status: Optional[Status] = None) -> None:
        _as_landing(buf, "Intercomm.Recv")   # refuse before receiving
        st = _NativeStatus()
        out = self._i.recv(source=source, tag=tag, status=st)
        _fill_status(status, st)
        _copy_into(buf, out)

    # -- object p2p --------------------------------------------------------
    def send(self, obj, dest: int, tag: int = 0) -> None:
        self._i.send(_dumps(obj), dest, tag)

    def recv(self, source: int = ANY_SOURCE, tag: int = ANY_TAG,
             status: Optional[Status] = None):
        st = _NativeStatus()
        out = self._i.recv(source=source, tag=tag, status=st)
        _fill_status(status, st)
        return _loads(out)

    def Merge(self, high: bool = False) -> "Comm":
        return Comm(self._i.merge(high=high))

    def Disconnect(self) -> None:
        self._i.disconnect()

    def Free(self) -> None:
        self.Disconnect()


# ---------------------------------------------------------------------------
# Cartesian topology facade
# ---------------------------------------------------------------------------

class Cartcomm(Comm):
    """Communicator with a Cartesian topology (mpi4py surface over the
    native topo framework — everything reads the attached CartTopology
    at ``self._c.topo``; Sendrecv etc. inherit from Comm)."""

    def Get_topo(self):
        t = self._c.topo
        return (list(t.dims), [bool(p) for p in t.periods],
                t.coords(self._c.rank))

    def Get_dim(self) -> int:
        return self._c.topo.ndims

    @property
    def dims(self):
        return list(self._c.topo.dims)

    @property
    def periods(self):
        return [bool(p) for p in self._c.topo.periods]

    @property
    def coords(self):
        return self._c.topo.coords(self._c.rank)

    @property
    def dim(self) -> int:
        return self._c.topo.ndims

    @property
    def topo(self):
        return self.Get_topo()

    def Get_coords(self, rank: int):
        return self._c.topo.coords(rank)

    def Get_cart_rank(self, coords):
        return self._c.topo.rank(coords)

    def Shift(self, direction: int, disp: int = 1):
        """→ (source, dest) with PROC_NULL at non-periodic edges."""
        return self._c.topo.shift(self._c.rank, direction, disp)

    def Sub(self, remain_dims) -> "Cartcomm":
        sub = self._c.cart_sub(remain_dims)
        return Cartcomm(sub) if sub is not None else None


class Graphcomm(Comm):
    """Communicator with a general graph topology (mpi4py surface over
    the native topo framework)."""

    def Get_topo(self):
        from ompi_tpu_torch.mpi import topo as _topo

        return _topo.graph_get(self._c)

    def Get_dims(self):
        from ompi_tpu_torch.mpi import topo as _topo

        return _topo.graphdims_get(self._c)

    def Get_neighbors(self, rank: int):
        return self._c.topo.neighbors_of(rank)

    def Get_neighbors_count(self, rank: int) -> int:
        return len(self._c.topo.neighbors_of(rank))

    @property
    def nnodes(self) -> int:
        return self.Get_dims()[0]

    @property
    def nedges(self) -> int:
        return self.Get_dims()[1]


class Distgraphcomm(Comm):
    """Communicator with a distributed-graph topology (mpi4py surface
    over the native topo framework)."""

    def Get_dist_neighbors_count(self) -> tuple:
        from ompi_tpu_torch.mpi.topo import dist_graph_neighbors_count

        return dist_graph_neighbors_count(self._c)

    def Get_dist_neighbors(self) -> tuple:
        from ompi_tpu_torch.mpi.topo import dist_graph_neighbors

        return dist_graph_neighbors(self._c)


def Compute_dims(nnodes: int, dims) -> list:
    """≈ mpi4py MPI.Compute_dims / MPI_Dims_create."""
    from ompi_tpu_torch.mpi.topo import dims_create

    if isinstance(dims, int):
        dims = [0] * dims
    return dims_create(nnodes, len(dims), dims)


def Get_address(buf) -> int:
    """≈ MPI_Get_address."""
    from ompi_tpu_torch.mpi.datatype import get_address

    return get_address(_landing(buf, "Get_address"))


def Alloc_mem(size: int, info=None):
    """≈ MPI_Alloc_mem → a uint8 buffer."""
    from ompi_tpu_torch.mpi.datatype import alloc_mem

    return alloc_mem(int(size))


def Free_mem(buf) -> None:
    from ompi_tpu_torch.mpi.datatype import free_mem

    free_mem(buf)


def Attach_buffer(buf) -> None:
    """≈ MPI_Buffer_attach: back buffered-mode sends.  mpi4py passes a
    bytearray/array; the pool only needs its SIZE."""
    from ompi_tpu_torch.mpi.pml import buffer_attach

    # memoryview.nbytes counts BYTES for every buffer protocol object
    # (array.array's len() would count elements)
    buffer_attach(int(memoryview(buf).nbytes))


def Detach_buffer():
    """≈ MPI_Buffer_detach (drains pending buffered sends)."""
    from ompi_tpu_torch.mpi.pml import buffer_detach

    return buffer_detach()


# ---------------------------------------------------------------------------
# Win (one-sided) / File (MPI-IO) facades
# ---------------------------------------------------------------------------

LOCK_EXCLUSIVE = 1
LOCK_SHARED = 2

# file amodes re-exported under mpi4py's names
from ompi_tpu_torch.mpi import io as _io_mod  # noqa: E402

MODE_RDONLY = _io_mod.MODE_RDONLY
MODE_RDWR = _io_mod.MODE_RDWR
MODE_WRONLY = _io_mod.MODE_WRONLY
MODE_CREATE = _io_mod.MODE_CREATE
MODE_EXCL = _io_mod.MODE_EXCL
MODE_APPEND = _io_mod.MODE_APPEND
MODE_DELETE_ON_CLOSE = _io_mod.MODE_DELETE_ON_CLOSE
SEEK_SET = _io_mod.SEEK_SET
SEEK_CUR = _io_mod.SEEK_CUR
SEEK_END = _io_mod.SEEK_END


def _target_spec(target, origin_size: int, *, need: str):
    """mpi4py target spec: None | disp | [disp, count(, datatype)] →
    (disp, count); the explicit count must fit the origin buffer
    (``need`` = "origin holds at least count" direction)."""
    if target is None:
        return 0, origin_size
    if isinstance(target, (int, np.integer)):
        return int(target), origin_size
    seq = list(target)
    disp = int(seq[0]) if seq else 0
    count = origin_size
    for extra in seq[1:]:
        if isinstance(extra, (int, np.integer)):
            count = int(extra)
    if count > origin_size:
        raise Exception(
            f"target count {count} exceeds the {need} buffer size "
            f"{origin_size}")
    return disp, count


class Win:
    """mpi4py-style window over the native active-message osc window.

    Displacements count WINDOW ELEMENTS (create with
    ``disp_unit=memory.itemsize``, mpi4py's common idiom; byte
    displacements with ``disp_unit=1`` are converted and must align)."""

    def __init__(self, native, disp_unit: int) -> None:
        self._w = native
        self._du = disp_unit

    # -- constructors ------------------------------------------------------
    @classmethod
    def Create(cls, memory, disp_unit: int = 1, info=None,
               comm: "Comm" = None) -> "Win":
        arr = _landing(memory, "Win.Create")
        from ompi_tpu_torch.mpi.osc import Window as _NativeWin

        if comm is None:
            comm = COMM_SELF     # mpi4py's default
        native = _NativeWin(comm._c, buffer=arr, info=info)
        return cls(native, disp_unit)

    @classmethod
    def Allocate(cls, size: int, disp_unit: int = 1, info=None,
                 comm: "Comm" = None) -> "Win":
        arr = np.zeros(size, np.uint8)
        return cls.Create(arr, disp_unit, info, comm)

    @classmethod
    def Allocate_shared(cls, size: int, disp_unit: int = 1, info=None,
                        comm: "Comm" = None) -> "_SharedWin":
        """≈ MPI_Win_allocate_shared (osc/sm model): one shm segment,
        every rank owns a slice; ``Shared_query`` returns zero-copy
        views and data moves by direct load/store + ``Sync`` — the
        message-window RMA verbs raise with that explanation.  Requires
        a single-host communicator (Split_type(COMM_TYPE_SHARED)
        first).  ``info`` is accepted for parity (osc/sm has no lock
        service to hint)."""
        from ompi_tpu_torch.mpi.osc import SharedWindow as _SW

        if comm is None:
            comm = COMM_SELF
        return _SharedWin(_SW(comm._c, local_size=int(size)), disp_unit)

    def Shared_query(self, rank: int) -> tuple:
        raise Exception(
            "Shared_query is only valid on a Win.Allocate_shared window")

    @classmethod
    def Create_dynamic(cls, info=None, comm: "Comm" = None) -> "Win":
        from ompi_tpu_torch.mpi.osc import Window as _NativeWin

        if comm is None:
            comm = COMM_SELF
        native = _NativeWin.create_dynamic(comm._c, info=info)
        return cls(native, 1)

    def Attach(self, memory) -> int:
        """≈ MPI_Win_attach; returns the region's base WINDOW OFFSET —
        the value peers use as the target displacement (this facade
        addresses dynamic windows by offset, not virtual address)."""
        return self._w.attach(_landing(memory, "Win.Attach"))

    def Detach(self, memory_or_base) -> None:
        """Accepts the buffer passed to Attach (mpi4py convention) or
        the base offset Attach returned."""
        if isinstance(memory_or_base, (int, np.integer)):
            self._w.detach(int(memory_or_base))
            return
        arr = _landing(memory_or_base, "Win.Detach").reshape(-1)
        want = arr.__array_interface__["data"][0]
        for base, region in list(self._w._regions.items()):
            if region.__array_interface__["data"][0] == want:
                self._w.detach(base)
                return
        raise Exception(
            "Detach: this buffer is not attached to the window")

    def Set_name(self, name: str) -> None:
        self._w.name = str(name)

    def Get_name(self) -> str:
        return getattr(self._w, "name", "win")

    def _disp(self, disp: int, itemsize: int) -> int:
        nbytes = disp * self._du
        if nbytes % itemsize:
            raise Exception(  # noqa: B904 — MPI.Exception
                f"target displacement {disp} (disp_unit {self._du}) is "
                f"not aligned to the window element size {itemsize}")
        return nbytes // itemsize

    # -- data movement -----------------------------------------------------
    def _reinterprets(self, operand_dtype) -> bool:
        """True when an operand of this dtype crosses a byte
        (``Win.Allocate``) window and must be handled bitwise — the ONE
        place the reinterpretation rule lives."""
        return (self._w.buf.dtype == np.uint8
                and np.dtype(operand_dtype) != np.uint8)

    def _origin(self, spec) -> np.ndarray:
        """Origin data on the host: a bf16/float8 tensor moves as its
        bits through a byte (``Win.Allocate``) window, and as values of
        the window's element type through a typed one (converted on its
        own device; the JAX facade's remote put of an ``ml_dtypes``
        array fails at the target, ROADMAP.md "Notes for porters")."""
        if self._w.buf.dtype == np.uint8 or \
                _bits_tensor(_spec_buf(spec)) is None:
            return _as_array(spec)
        return _as_array(spec, bits_to=self._w.buf.dtype)

    def _wire(self, data: np.ndarray, what: str, op: Op = None):
        """Origin data as the window's element type.

        ``Win.Allocate`` windows are raw bytes (uint8); the mpi4py idiom
        Puts/Gets TYPED buffers through them, which must be a bitwise
        copy — a value-cast would wrap a float64 into 0..255.  Arithmetic
        accumulate ops on reinterpreted bytes are meaningless, so those
        raise instead of corrupting silently."""
        if not self._reinterprets(data.dtype):
            return data
        if op is not None and op not in (REPLACE, NO_OP, BAND, BOR, BXOR):
            raise Exception(
                f"{what} with {op._name} on a byte (Win.Allocate) window "
                f"requires a uint8 origin; arithmetic on reinterpreted "
                f"bytes would corrupt — use Win.Create with a typed "
                f"buffer instead")
        return np.ascontiguousarray(data).view(np.uint8)

    def Put(self, origin, target_rank: int, target=None) -> None:
        arr = self._origin(origin)
        disp, count = _target_spec(target, arr.size, need="origin")
        off = self._disp(disp, self._w.buf.itemsize)
        self._w.put(target_rank,
                    self._wire(arr.reshape(-1)[:count], "Put"), offset=off)

    def Get(self, origin, target_rank: int, target=None) -> None:
        # one definition of the byte-window read path: Rget's (the
        # native layer defines get() as rget().wait() the same way)
        self.Rget(origin, target_rank, target).Wait()

    def Accumulate(self, origin, target_rank: int, target=None,
                   op: Op = SUM) -> None:
        arr = self._origin(origin)
        disp, count = _target_spec(target, arr.size, need="origin")
        off = self._disp(disp, self._w.buf.itemsize)
        self._w.accumulate(target_rank,
                           self._wire(arr.reshape(-1)[:count],
                                      "Accumulate", op),
                           op=_native_op(op), offset=off)

    def Get_accumulate(self, origin, result, target_rank: int,
                       target=None, op: Op = SUM) -> None:
        arr = self._origin(origin)
        disp, count = _target_spec(target, arr.size, need="origin")
        off = self._disp(disp, self._w.buf.itemsize)
        data = self._wire(arr.reshape(-1)[:count], "Get_accumulate", op)
        old = self._w.get_accumulate(target_rank, data,
                                     op=_native_op(op), offset=off)
        if self._reinterprets(arr.dtype):
            old = np.ascontiguousarray(old).view(arr.dtype)
        _copy_into(result, old)

    def _scalar_guard(self, arr: np.ndarray, what: str,
                      operand: str = "origin") -> None:
        """Single-element atomics target ONE window element; on a byte
        (Win.Allocate) window a typed operand cannot be reinterpreted
        into one uint8 — refuse rather than value-cast into 0..255."""
        if self._reinterprets(arr.dtype):
            raise Exception(
                f"{what} on a byte (Win.Allocate) window requires a "
                f"uint8 {operand}: the target element is a single byte — "
                f"use Win.Create over a typed buffer for typed atomics")

    def Fetch_and_op(self, origin, result, target_rank: int,
                     target_disp: int = 0, op: Op = SUM) -> None:
        arr = self._origin(origin)
        self._scalar_guard(arr, "Fetch_and_op")
        val = arr.reshape(-1)[0]
        off = self._disp(int(target_disp), self._w.buf.itemsize)
        old = self._w.fetch_op(target_rank, val, op=_native_op(op),
                               offset=off)
        _copy_into(result, np.asarray(old).reshape(1))

    def Compare_and_swap(self, origin, compare, result,
                         target_rank: int, target_disp: int = 0) -> None:
        val = self._origin(origin)
        self._scalar_guard(val, "Compare_and_swap")
        cmp_arr = self._origin(compare)
        self._scalar_guard(cmp_arr, "Compare_and_swap", operand="compare")
        cmp_ = cmp_arr.reshape(-1)[0]
        off = self._disp(int(target_disp), self._w.buf.itemsize)
        old = self._w.compare_swap(target_rank, cmp_,
                                   val.reshape(-1)[0], offset=off)
        _copy_into(result, np.asarray(old).reshape(1))

    # -- request-based RMA (results/completion via Request) ----------------
    def Rput(self, origin, target_rank: int, target=None) -> "Request":
        arr = self._origin(origin)
        disp, count = _target_spec(target, arr.size, need="origin")
        off = self._disp(disp, self._w.buf.itemsize)
        return Request(self._w.rput(
            target_rank, self._wire(arr.reshape(-1)[:count], "Rput"),
            offset=off))

    def Rget(self, origin, target_rank: int, target=None) -> "Request":
        dst = _as_landing(origin, "Win.Rget")
        disp, count = _target_spec(target, dst.size, need="receive")
        off = self._disp(disp, self._w.buf.itemsize)
        if self._reinterprets(dst.dtype):
            req = self._w.rget(target_rank, count * dst.itemsize,
                               offset=off)

            def land(out):
                _copy_into(origin,
                           np.ascontiguousarray(out).view(dst.dtype))
        else:
            req = self._w.rget(target_rank, count, offset=off)

            def land(out):
                _copy_into(origin, out)

        return Request(req, transform=land)

    def Raccumulate(self, origin, target_rank: int, target=None,
                    op: Op = SUM) -> "Request":
        arr = self._origin(origin)
        disp, count = _target_spec(target, arr.size, need="origin")
        off = self._disp(disp, self._w.buf.itemsize)
        return Request(self._w.raccumulate(
            target_rank,
            self._wire(arr.reshape(-1)[:count], "Raccumulate", op),
            op=_native_op(op), offset=off))

    def Flush_local(self, rank: int) -> None:
        self._w.flush_local(rank)

    def Flush_local_all(self) -> None:
        self._w.flush_local_all()

    def Test(self) -> bool:
        """≈ MPI_Win_test (PSCW exposure-epoch poll)."""
        return bool(self._w.test_epoch())

    def Get_group(self) -> "Group":
        g = self._w.get_group()
        return Group(g, g.world_rank(self._w.comm.rank))

    # -- attributes --------------------------------------------------------
    def Get_attr(self, keyval):
        if keyval is WIN_BASE:
            from ompi_tpu_torch.mpi.datatype import get_address

            return get_address(np.asarray(self._w.buf))
        if keyval is WIN_SIZE:
            return self._w.buf.nbytes
        if keyval is WIN_DISP_UNIT:
            return self._du
        return None

    # -- synchronization ---------------------------------------------------
    def Fence(self, assertion: int = 0) -> None:
        self._w.fence()

    def Sync(self) -> None:
        """≈ MPI_Win_sync (message windows: no-op — delivery orders
        stores; the shared-window subclass overrides with the real
        memory barrier)."""

    def Lock(self, rank: int, lock_type: int = LOCK_EXCLUSIVE,
             assertion: int = 0) -> None:
        self._w.lock(rank, exclusive=lock_type == LOCK_EXCLUSIVE)

    def Unlock(self, rank: int) -> None:
        self._w.unlock(rank)

    def Lock_all(self, assertion: int = 0) -> None:
        self._w.lock_all()

    def Unlock_all(self) -> None:
        self._w.unlock_all()

    def Flush(self, rank: int) -> None:
        self._w.flush(rank)

    def Flush_all(self) -> None:
        self._w.flush_all()

    def _group_ranks(self, group: Group) -> list:
        g = self._w.comm.group
        out = []
        for w in group._g._ranks:
            r = g.rank_of(w)
            if r is None or r < 0:
                raise Exception(f"group rank {w} not in window comm")
            out.append(r)
        return out

    def Start(self, group: Group, assertion: int = 0) -> None:
        self._w.start(self._group_ranks(group))

    def Complete(self) -> None:
        self._w.complete()

    def Post(self, group: Group, assertion: int = 0) -> None:
        self._w.post(self._group_ranks(group))

    def Wait(self) -> None:
        self._w.wait()

    def Free(self) -> None:
        self._w.free()

    @property
    def memory(self):
        return self._w.buf


class _SharedWin(Win):
    """A Win over the osc/sm SharedWindow: the RMA verbs are served by
    direct memcpy/load-store on the shared mapping (the osc/sm model —
    the memory IS the window).  Lock epochs are consistency points only
    (the mapping is cache-coherent; there is no lock service), and
    accumulates are NOT hardware-atomic per element — concurrent
    conflicting accumulates from different origins may interleave (use
    ``fetch_add`` for lock-free counters).  PSCW epochs are not defined
    on this component and raise."""

    def Shared_query(self, rank: int) -> tuple:
        """(size_bytes, disp_unit, zero-copy buf-view) of rank's slice."""
        view = self._w.shared_query(rank)
        return view.nbytes, self._du, view

    # -- data movement: memcpy on the mapping -----------------------------
    def _bytes_of(self, rank: int) -> np.ndarray:
        return self._w.shared_query(rank).view(np.uint8)

    def Put(self, origin, target_rank: int, target=None) -> None:
        arr = _as_array(origin)
        disp, count = _target_spec(target, arr.size, need="origin")
        raw = np.ascontiguousarray(
            arr.reshape(-1)[:count]).view(np.uint8).reshape(-1)
        dst = self._bytes_of(target_rank)
        off = disp * self._du
        dst[off:off + raw.size] = raw

    def Get(self, origin, target_rank: int, target=None) -> None:
        dst = _as_landing(origin, "Win.Get")
        disp, count = _target_spec(target, dst.size, need="receive")
        src = self._bytes_of(target_rank)
        off = disp * self._du
        nbytes = count * dst.itemsize
        _copy_into(origin, np.ascontiguousarray(
            src[off:off + nbytes]).view(dst.dtype))

    def _seg(self, target_rank: int, disp: int, count: int, dtype):
        raw = self._bytes_of(target_rank)
        off = disp * self._du
        return raw[off:off + count * dtype.itemsize].view(dtype)

    @staticmethod
    def _fold(op, old: np.ndarray, src: np.ndarray, name: Optional[str]):
        """op(old, src) as the segment's new contents.  For a bf16/float8
        origin tensor (``name``) both are bits: the fold runs on their
        float32 values and rounds once, as ``ml_dtypes`` arithmetic does
        in the JAX facade."""
        if name is None:
            return _native_op(op).host(old.copy(), src)
        folded = _native_op(op).host(_from_bits(old, name),
                                     _from_bits(src, name))
        return _to_bits(folded, name)

    @staticmethod
    def _old(old: np.ndarray, name: Optional[str]) -> np.ndarray:
        """The fetched segment as values (bits become float32 values)."""
        return old if name is None else _from_bits(old, name)

    def Accumulate(self, origin, target_rank: int, target=None,
                   op: Op = SUM) -> None:
        arr = _as_array(origin)
        disp, count = _target_spec(target, arr.size, need="origin")
        src = arr.reshape(-1)[:count]
        seg = self._seg(target_rank, disp, count, arr.dtype)
        seg[:] = self._fold(op, seg, src, _bits_tensor(_spec_buf(origin)))

    def Get_accumulate(self, origin, result, target_rank: int,
                       target=None, op: Op = SUM) -> None:
        arr = _as_array(origin)
        disp, count = _target_spec(target, arr.size, need="origin")
        src = arr.reshape(-1)[:count]
        seg = self._seg(target_rank, disp, count, arr.dtype)
        old = seg.copy()
        name = _bits_tensor(_spec_buf(origin))
        seg[:] = self._fold(op, old, src, name)
        _copy_into(result, self._old(old, name))

    def Fetch_and_op(self, origin, result, target_rank: int,
                     target_disp: int = 0, op: Op = SUM) -> None:
        arr = _as_array(origin)
        seg = self._seg(target_rank, int(target_disp), 1, arr.dtype)
        old = seg.copy()
        name = _bits_tensor(_spec_buf(origin))
        seg[:] = self._fold(op, old, arr.reshape(-1)[:1], name)
        _copy_into(result, self._old(old, name))

    def Compare_and_swap(self, origin, compare, result,
                         target_rank: int, target_disp: int = 0) -> None:
        arr = _as_array(origin)
        cmp_ = _as_array(compare).reshape(-1)[0]
        seg = self._seg(target_rank, int(target_disp), 1, arr.dtype)
        old = seg.copy()
        if old[0] == cmp_:
            seg[0] = arr.reshape(-1)[0]
        _copy_into(result, self._old(old, _bits_tensor(_spec_buf(origin))))

    def Rput(self, origin, target_rank: int, target=None) -> "Request":
        from ompi_tpu_torch.mpi.request import CompletedRequest

        self.Put(origin, target_rank, target)
        return Request(CompletedRequest())

    def Rget(self, origin, target_rank: int, target=None) -> "Request":
        from ompi_tpu_torch.mpi.request import CompletedRequest

        self.Get(origin, target_rank, target)
        return Request(CompletedRequest())

    def Raccumulate(self, origin, target_rank: int, target=None,
                    op: Op = SUM) -> "Request":
        from ompi_tpu_torch.mpi.request import CompletedRequest

        self.Accumulate(origin, target_rank, target, op)
        return Request(CompletedRequest())

    # -- synchronization: coherence points, no lock service ---------------
    def Fence(self, assertion: int = 0) -> None:
        self._w.sync()              # memory barrier + comm barrier

    def Sync(self) -> None:
        self._w.sync()

    def Lock(self, rank: int, lock_type: int = LOCK_EXCLUSIVE,
             assertion: int = 0) -> None:
        pass                        # coherence only; see class docstring

    def Unlock(self, rank: int) -> None:
        pass

    def Lock_all(self, assertion: int = 0) -> None:
        pass

    def Unlock_all(self) -> None:
        pass

    def Flush(self, rank: int) -> None:
        pass

    def Flush_all(self) -> None:
        pass

    def Flush_local(self, rank: int) -> None:
        pass

    def Flush_local_all(self) -> None:
        pass

    def _no_pscw(self, what: str):
        raise Exception(
            f"{what} is not defined on a Win.Allocate_shared window "
            f"(osc/sm has no PSCW epochs) — use Fence()/Sync()")

    def Start(self, group, assertion: int = 0) -> None:
        self._no_pscw("Start")

    def Complete(self) -> None:
        self._no_pscw("Complete")

    def Post(self, group, assertion: int = 0) -> None:
        self._no_pscw("Post")

    def Wait(self) -> None:
        self._no_pscw("Wait")

    def Test(self) -> bool:
        self._no_pscw("Test")

    def Get_group(self) -> "Group":
        g = self._w.comm.group
        return Group(g, g.world_rank(self._w.comm.rank))

    def Get_attr(self, keyval):
        if keyval is WIN_SIZE:
            return self._w.shared_query(self._w.comm.rank).nbytes
        if keyval is WIN_DISP_UNIT:
            return self._du
        if keyval is WIN_BASE:
            from ompi_tpu_torch.mpi.datatype import get_address

            return get_address(self._w.shared_query(self._w.comm.rank))
        return None

    @property
    def memory(self):
        return self._w.shared_query(self._w.comm.rank)

    def fetch_add(self, rank: int, offset8: int, delta: int) -> int:
        """The osc/sm lock-free counter (native u64 atomics)."""
        return self._w.fetch_add(rank, offset8, delta)


class File:
    """mpi4py-style handle over the native MPI-IO file (fcoll/sharedfp
    engines included)."""

    def __init__(self, native) -> None:
        self._f = native

    @classmethod
    def Open(cls, comm: "Comm", filename: str,
             amode: int = MODE_RDONLY, info=None) -> "File":
        return cls(_io_mod.File.open(comm._c, filename, amode,
                                     info=info))

    # -- views / pointers --------------------------------------------------
    def Set_view(self, disp: int = 0, etype: Datatype = BYTE,
                 filetype=None, datarep: str = "native",
                 info=None) -> None:
        from ompi_tpu_torch.mpi.datatype import from_numpy as _from_np

        native_et = (_from_np(etype.np_dtype)
                     if isinstance(etype, Datatype) else etype)
        if isinstance(filetype, _Derived):
            # a Create_vector/indexed/… facade type: its wrapped native
            # derived datatype IS the view
            filetype = filetype._nat
        elif isinstance(filetype, Datatype):
            # a scalar compat Datatype as the filetype = contiguous
            # elements of that type (native derived types pass through
            # for strided/vector views)
            filetype = _from_np(filetype.np_dtype)
        self._f.set_view(disp=disp, etype=native_et,
                         filetype=filetype, datarep=datarep)

    def Seek(self, offset: int, whence: int = SEEK_SET) -> None:
        self._f.seek(offset, whence)

    def Get_position(self) -> int:
        return self._f.get_position()

    # mpi4py semantics: the BUFFER's numpy dtype is the memory datatype;
    # the view's etype only sets file offsets/units.  The native layer
    # instead value-casts data to the etype, so the facade reinterprets
    # bitwise both ways (a float64 buffer through the default BYTE view
    # moves its raw bytes, not uint8-casted values).

    def _etype_np(self):
        return self._f.view.etype.base_np

    def _to_file(self, buf) -> np.ndarray:
        # write data: a CUDA tensor comes to the host in one copy
        a = np.ascontiguousarray(_as_array(buf)).reshape(-1)
        et = self._etype_np()
        if a.dtype == et:
            return a
        if a.nbytes % et.itemsize:
            raise Exception(
                f"buffer of {a.nbytes} bytes is not a whole number of "
                f"file etype elements ({et})")
        return a.view(et)

    def _count(self, buf) -> int:
        dst = _as_landing(buf, "File read")
        et = self._etype_np()
        if dst.nbytes % et.itemsize:
            raise Exception(
                f"receive buffer of {dst.nbytes} bytes is not a whole "
                f"number of file etype elements ({et})")
        return dst.nbytes // et.itemsize

    def _land(self, buf, out) -> None:
        dst = _as_landing(buf, "File read")
        raw = np.ascontiguousarray(np.asarray(out)).reshape(-1)
        if raw.dtype != dst.dtype:
            if raw.nbytes % dst.dtype.itemsize:
                raise Exception(
                    f"read of {raw.nbytes} bytes does not fill whole "
                    f"{dst.dtype} elements")
            raw = raw.view(dst.dtype)
        _copy_into(buf, raw)

    # -- explicit-offset / individual / shared / ordered -------------------
    def Read_at(self, offset: int, buf) -> None:
        self._land(buf, self._f.read_at(offset, self._count(buf)))

    def Write_at(self, offset: int, buf) -> None:
        self._f.write_at(offset, self._to_file(buf))

    def Read_at_all(self, offset: int, buf) -> None:
        self._land(buf, self._f.read_at_all(offset, self._count(buf)))

    def Write_at_all(self, offset: int, buf) -> None:
        self._f.write_at_all(offset, self._to_file(buf))

    def Read(self, buf) -> None:
        self._land(buf, self._f.read(self._count(buf)))

    def Write(self, buf) -> None:
        self._f.write(self._to_file(buf))

    def Read_all(self, buf) -> None:
        self._land(buf, self._f.read_all(self._count(buf)))

    def Write_all(self, buf) -> None:
        self._f.write_all(self._to_file(buf))

    def Read_shared(self, buf) -> None:
        self._land(buf, self._f.read_shared(self._count(buf)))

    def Write_shared(self, buf) -> None:
        self._f.write_shared(self._to_file(buf))

    def Read_ordered(self, buf) -> None:
        self._land(buf, self._f.read_ordered(self._count(buf)))

    def Write_ordered(self, buf) -> None:
        self._f.write_ordered(self._to_file(buf))

    # -- nonblocking IO (requests land into the caller's buffer on
    #    Wait/Test, the mpi4py convention) ---------------------------------
    def _iread(self, native_req, buf) -> Request:
        return Request(native_req,
                       transform=lambda out: self._land(buf, out))

    def Iread_at(self, offset: int, buf) -> Request:
        return self._iread(self._f.iread_at(offset, self._count(buf)), buf)

    def Iwrite_at(self, offset: int, buf) -> Request:
        return Request(self._f.iwrite_at(offset, self._to_file(buf)))

    def Iread(self, buf) -> Request:
        return self._iread(self._f.iread(self._count(buf)), buf)

    def Iwrite(self, buf) -> Request:
        return Request(self._f.iwrite(self._to_file(buf)))

    def Iread_all(self, buf) -> Request:
        return self._iread(self._f.iread_all(self._count(buf)), buf)

    def Iwrite_all(self, buf) -> Request:
        return Request(self._f.iwrite_all(self._to_file(buf)))

    def Iread_at_all(self, offset: int, buf) -> Request:
        return self._iread(
            self._f.iread_at_all(offset, self._count(buf)), buf)

    def Iwrite_at_all(self, offset: int, buf) -> Request:
        return Request(self._f.iwrite_at_all(offset, self._to_file(buf)))

    def Iread_shared(self, buf) -> Request:
        return self._iread(self._f.iread_shared(self._count(buf)), buf)

    def Iwrite_shared(self, buf) -> Request:
        return Request(self._f.iwrite_shared(self._to_file(buf)))

    # -- split collectives (one outstanding per handle, ends must match) --
    def Read_all_begin(self, buf) -> None:
        self._f.read_all_begin(self._count(buf))

    def Read_all_end(self, buf) -> None:
        self._land(buf, self._f.read_all_end())

    def Write_all_begin(self, buf) -> None:
        self._f.write_all_begin(self._to_file(buf))

    def Write_all_end(self, buf) -> None:
        self._f.write_all_end()

    def Read_at_all_begin(self, offset: int, buf) -> None:
        self._f.read_at_all_begin(offset, self._count(buf))

    def Read_at_all_end(self, buf) -> None:
        self._land(buf, self._f.read_at_all_end())

    def Write_at_all_begin(self, offset: int, buf) -> None:
        self._f.write_at_all_begin(offset, self._to_file(buf))

    def Write_at_all_end(self, buf) -> None:
        self._f.write_at_all_end()

    def Read_ordered_begin(self, buf) -> None:
        self._f.read_ordered_begin(self._count(buf))

    def Read_ordered_end(self, buf) -> None:
        self._land(buf, self._f.read_ordered_end())

    def Write_ordered_begin(self, buf) -> None:
        self._f.write_ordered_begin(self._to_file(buf))

    def Write_ordered_end(self, buf) -> None:
        self._f.write_ordered_end()

    # -- management --------------------------------------------------------
    def Get_view(self) -> tuple:
        disp, etype, ftype = self._f.get_view()

        def wrap(nat):
            if getattr(nat, "base_np", None) is not None \
                    and nat.is_contiguous and nat.size == nat.base_np.itemsize:
                return Datatype(nat.base_np, nat.get_name())
            base = Datatype(nat.base_np, str(nat.base_np))
            return _Derived(nat, base)

        return disp, wrap(etype), wrap(ftype)

    def Get_byte_offset(self, offset: int) -> int:
        return self._f.get_byte_offset(offset)

    def Get_type_extent(self, datatype) -> int:
        return self._f.get_type_extent(_to_native_dt(datatype))

    def Set_size(self, size: int) -> None:
        self._f.set_size(size)

    def Get_amode(self) -> int:
        return self._f.get_amode()

    def Set_info(self, info) -> None:
        self._f.set_info(info)

    def Get_info(self) -> "Info":
        return _wrap_info(self._f.get_info())

    def Seek_shared(self, offset: int, whence: int = SEEK_SET) -> None:
        self._f.seek_shared(offset, whence)

    def Get_position_shared(self) -> int:
        return self._f.get_position_shared()

    def Sync(self) -> None:
        self._f.sync()

    def Preallocate(self, size: int) -> None:
        self._f.preallocate(size)

    def Get_size(self) -> int:
        return self._f.get_size()

    def Set_atomicity(self, flag: bool) -> None:
        self._f.set_atomicity(bool(flag))

    def Get_atomicity(self) -> bool:
        return self._f.get_atomicity()

    def Close(self) -> None:
        self._f.close()

    @staticmethod
    def Delete(filename: str, info=None) -> None:
        _io_mod.File.delete(filename)


# ---------------------------------------------------------------------------
# world / environment
# ---------------------------------------------------------------------------

class _LazyComm(Comm):
    """COMM_WORLD/COMM_SELF resolved (and the runtime initialized) on
    first use — mpi4py initializes at import; deferring to first touch
    keeps ``import ompi_tpu.compat`` side-effect-free."""

    def __init__(self, which: str):
        self._which = which

    @property
    def _c(self):
        import ompi_tpu_torch

        if not ompi_tpu_torch.initialized():
            from ompi_tpu_torch.mpi import runtime as _rt

            _rt.init()
        return getattr(ompi_tpu_torch, self._which)


COMM_WORLD = _LazyComm("COMM_WORLD")
COMM_SELF = _LazyComm("COMM_SELF")
COMM_NULL = None


def Init() -> None:
    import ompi_tpu_torch

    if not ompi_tpu_torch.initialized():
        from ompi_tpu_torch.mpi import runtime as _rt

        _rt.init()


def Init_thread(required: int = THREAD_MULTIPLE) -> int:
    Init()
    return THREAD_MULTIPLE


def Finalize() -> None:
    import ompi_tpu_torch

    if ompi_tpu_torch.initialized():
        from ompi_tpu_torch.mpi import runtime as _rt

        _rt.finalize()


def Is_initialized() -> bool:
    import ompi_tpu_torch

    return ompi_tpu_torch.initialized()


def Is_finalized() -> bool:
    from ompi_tpu_torch.mpi import runtime as _rt

    return _rt.finalized()


def Query_thread() -> int:
    return THREAD_MULTIPLE


def Get_processor_name() -> str:
    import ompi_tpu_torch

    return ompi_tpu_torch.get_processor_name()


def Wtime() -> float:
    import ompi_tpu_torch

    return ompi_tpu_torch.wtime()


def Wtick() -> float:
    import ompi_tpu_torch

    return ompi_tpu_torch.wtick()


def Get_version() -> tuple:
    import ompi_tpu_torch

    return ompi_tpu_torch.get_version()


def Get_library_version() -> str:
    import ompi_tpu_torch

    return ompi_tpu_torch.get_library_version()


def pickle_dumps(obj) -> bytes:  # legacy helpers; MPI.pickle is the hook
    return _serializer().dumps(obj)


def pickle_loads(data: bytes) -> Any:
    return _serializer().loads(data)


# mpi4py spells the serializer instance MPI.pickle (the stdlib module is
# aliased away above) — assigning .dumps/.loads or a new Pickle swaps
# serialization for the whole lowercase API
globals()["pickle"] = pickle_impl
