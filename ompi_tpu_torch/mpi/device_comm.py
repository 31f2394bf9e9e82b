"""DeviceCommunicator — the port's device plane: collectives and one-sided
RMA over the ranks of a multi-process :class:`~ompi_tpu_torch.parallel.mesh.Mesh`.

The JAX package's communicator is a set of mesh axes driven from one
process, its methods traced inside ``shard_map`` (``device_comm.py:14-20``
there).  Here a rank is a process that owns one device, and each method
is exactly the body of the reference's ``shard_map``: it takes this
rank's shard and returns this rank's result.  A communicator is still a
set of mesh axes; its rank is the row-major flat index over them, and its
collectives run on the mesh's device group for those axes (NCCL on the
card, gloo on the CPU):

  allreduce SUM/MAX/MIN        → all_reduce (psum/pmax/pmin there)
  other ops, scan, exscan      → all_gather + rank-ordered fold, or the
                                 O(shard) Hillis-Steele prefix over p2p
                                 hops past ``coll_device_generic_large_bytes``
  reduce_scatter / allgather   → reduce_scatter / all_gather
  alltoall                     → all_to_all
  shift / permute / sendrecv   → batched isend/irecv (ppermute there)
  put / get                    → the one-sided kernels of ops/remote_dma

The reference's SPMD conventions are kept where ``torch.distributed``'s
defaults differ: reduce and gather give zeros on non-roots, permute
zero-fills ranks that receive nothing, exscan gives zeros on rank 0,
generic ops fold in rank order (non-commutative ops keep MPI's contract),
and the v-variants pad to max(counts) and mask past the counts.

Ranks that share one card have no device group (NCCL refuses two ranks
of one communicator on one card): there a device collective over more
than one rank raises, and never stages CUDA tensors through gloo, while
``barrier`` and the one-sided ops run.

Driver mode is plain: every rank calls ``run``/``run_method`` with its
own shards; nothing is traced or cached.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ompi_tpu_torch.core.config import VarType, register_var, var_registry
from ompi_tpu_torch.mpi.constants import MPIException
from ompi_tpu_torch.mpi.op import SUM, Op

__all__ = ["DeviceCommunicator", "device_world", "torch_dtype"]

register_var("coll", "device_generic_large_bytes", VarType.SIZE, 1 << 20,
             "per-shard byte size at/above which generic-op device "
             "collectives (allreduce with exotic ops, scan, exscan) use "
             "the O(shard)-memory p2p prefix forms instead of the "
             "allgather+fold forms (which allocate n x shard on every "
             "rank)")

_SHARED_CARD = (
    "device collectives over more than one rank need one card per rank "
    "(NCCL refuses two ranks of one communicator on the same card), and "
    "ranks of {name} share a card: start one process per card. barrier "
    "and the one-sided put/get, DeviceWindow and DeviceSymmetricHeap."
    "put/get run here")


def torch_dtype(dtype) -> torch.dtype:
    """A torch dtype from a torch dtype, a numpy dtype or its name."""
    if isinstance(dtype, torch.dtype):
        return dtype
    name = np.dtype(dtype).name
    return {"bool": torch.bool}.get(name) or getattr(torch, name)


class DeviceCommunicator:
    """A communicator over one or more mesh axes.

    ``axes`` is an ordered tuple of axis names; the rank is the row-major
    flat index over those axes (matching MPI rank order for a cartesian
    communicator, ≈ MPI_Cart_create semantics).
    """

    def __init__(self, mesh, axes: Optional[Sequence[str]] = None,
                 name: str = "device") -> None:
        self.mesh = mesh
        self.axes: tuple[str, ...] = tuple(axes if axes is not None
                                           else mesh.axis_names)
        for ax in self.axes:
            if ax not in mesh.axis_names:
                raise ValueError(f"axis {ax!r} not in mesh {mesh.axis_names}")
        self.name = name

    # -- shape -------------------------------------------------------------

    @property
    def size(self) -> int:
        return math.prod(int(self.mesh.shape[a]) for a in self.axes)

    @property
    def axis_sizes(self) -> tuple[int, ...]:
        return tuple(int(self.mesh.shape[a]) for a in self.axes)

    def coords(self) -> tuple[int, ...]:
        """My coordinates along each axis (≈ MPI_Cart_coords)."""
        mine = dict(zip(self.mesh.axis_names, self.mesh.coords()))
        return tuple(mine[a] for a in self.axes)

    def rank(self) -> int:
        """My flat rank over the axes (row-major)."""
        r = 0
        for c, n in zip(self.coords(), self.axis_sizes):
            r = r * n + c
        return r

    def sub(self, axes: Sequence[str], name: Optional[str] = None
            ) -> "DeviceCommunicator":
        """Sub-communicator over a subset of my axes (≈ MPI_Cart_sub); its
        group was made with the mesh."""
        return DeviceCommunicator(self.mesh, axes,
                                  name or f"{self.name}.sub{tuple(axes)}")

    # -- transport (this rank's part of each exchange) ----------------------

    def _group(self, axes: Optional[Sequence[str]] = None):
        """The device group over ``axes`` (default: mine); None for a lone
        rank with no process group."""
        axes = self.axes if axes is None else tuple(axes)
        g = self.mesh.device_group(axes)
        if g is None and math.prod(self.mesh.shape[a] for a in axes) > 1:
            raise NotImplementedError(_SHARED_CARD.format(name=self.name))
        return g

    def _own(self, x: torch.Tensor) -> torch.Tensor:
        if x.device.type != self.mesh.device.type:
            raise ValueError(f"{self.name}: a {x.device} tensor on a mesh of "
                             f"{self.mesh.device} ranks")
        return x.contiguous()

    def _members(self, axes: Optional[Sequence[str]] = None) -> list[int]:
        return self.mesh.members(self.axes if axes is None else axes)

    def _gather(self, x) -> list[torch.Tensor]:
        """Every rank's ``x``, in communicator rank order."""
        g, x = self._group(), self._own(x)
        if g is None:
            return [x]
        members = self._members()
        outs = [torch.empty_like(x) for _ in members]
        dist.all_gather(outs, x, group=g)
        pos = {m: i for i, m in enumerate(sorted(members))}
        return [outs[pos[m]] for m in members]

    def _all_to_all(self, chunks, axes=None) -> list[torch.Tensor]:
        """chunks[j] goes to rank j; entry j of the result came from rank
        j (both in communicator rank order; equal shapes).  Batched p2p,
        which every backend has (gloo's all_to_all is missing from some
        PyTorch releases)."""
        self._group(axes)
        chunks = [self._own(c) for c in chunks]
        me = self.mesh.members(self.axes if axes is None else axes).index(
            self.mesh.rank)
        outs = [torch.empty_like(c) for c in chunks]
        outs[me].copy_(chunks[me])
        peers = [j for j in range(len(chunks)) if j != me]
        self._p2p([(chunks[j], j) for j in peers],
                  [(outs[j], j) for j in peers], axes)
        return outs

    def _p2p(self, sends, recvs, axes=None) -> None:
        """Post every (tensor, peer) send and (buffer, peer) receive, peers
        as ranks of the group over ``axes``, and wait for all."""
        g = self._group(axes)
        members = self._members(axes)
        ops = ([dist.P2POp(dist.isend, self._own(t), members[p], group=g)
                for t, p in sends]
               + [dist.P2POp(dist.irecv, b, members[p], group=g)
                  for b, p in recvs])
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()

    def _permute_axis(self, x, perm, ax: str):
        """lax.ppermute over one mesh axis: (src, dst) index pairs along
        ``ax``; ranks that receive nothing get zeros."""
        n = int(self.mesh.shape[ax])
        perm = [(int(s), int(d)) for s, d in perm]
        srcs, dsts = [s for s, _ in perm], [d for _, d in perm]
        if (len(set(srcs)) != len(srcs) or len(set(dsts)) != len(dsts)
                or not all(0 <= i < n for i in srcs + dsts)):
            raise MPIException(f"permute: {perm} is not a permutation of "
                               f"axis {ax!r} (size {n})")
        self._group((ax,))
        me = self.mesh.coord(ax)
        x = self._own(x)
        out = torch.zeros_like(x)
        sends = [(x, d) for s, d in perm if s == me and d != me]
        recvs = [(out, s) for s, d in perm if d == me and s != me]
        if (me, me) in perm:
            out.copy_(x)
        self._p2p(sends, recvs, (ax,))
        return out

    # -- collectives ---------------------------------------------------------

    def allreduce(self, x, op: Op = SUM):
        """≈ MPI_Allreduce → all_reduce for SUM/MAX/MIN, else all_gather +
        rank-ordered fold (or its O(shard) prefix form when large)."""
        if op.dist_op is None:
            return self._allreduce_generic(x, op)
        g, y = self._group(), self._own(x).clone()
        if g is not None:
            dist.all_reduce(y, op=op.dist_op, group=g)
        return y

    def _large(self, x) -> bool:
        """Large enough that n×shard materialization is the wrong plan."""
        return (len(self.axes) == 1
                and x.numel() * x.element_size() >= int(
                    var_registry.get("coll_device_generic_large_bytes")))

    def _hillis_scan(self, x, op: Op):
        """Inclusive rank-ordered prefix fold in O(shard) memory:
        ⌈log2 n⌉ p2p hops (Hillis-Steele).  Every combine joins two
        rank-contiguous segments left-to-right, so non-commutative ops
        keep MPI's rank-order contract."""
        n, ax, me = self.size, self.axes[0], self.rank()
        acc = x
        d = 1
        while d < n:
            shifted = self._permute_axis(
                acc, [(i, i + d) for i in range(n - d)], ax)
            if me >= d:
                acc = op.device(shifted, acc)
            d <<= 1
        return acc

    def _allreduce_generic(self, x, op: Op):
        """Any associative op.  Small payloads: all_gather + rank-ordered
        fold.  Large: rank n-1's inclusive prefix IS the full ordered fold,
        broadcast from there."""
        if self._large(x):
            return self.bcast(self._hillis_scan(x, op), root=self.size - 1)
        stacked = self._gather(x)
        acc = stacked[0]
        for r in range(1, self.size):
            acc = op.device(acc, stacked[r])
        return acc

    def reduce(self, x, op: Op = SUM, root: int = 0):
        """≈ MPI_Reduce: every rank computes the value; non-roots return
        zeros (the reference's SPMD shape contract)."""
        full = self.allreduce(x, op)
        return full if self.rank() == root else torch.zeros_like(full)

    def bcast(self, x, root: int = 0):
        """≈ MPI_Bcast → broadcast from ``root``."""
        g, y = self._group(), self._own(x).clone()
        if g is not None:
            dist.broadcast(y, src=self._members()[root], group=g)
        return y

    def reduce_scatter(self, x, op: Op = SUM, axis: int = 0):
        """≈ MPI_Reduce_scatter: rank r gets block r (along ``axis``) of
        the reduction; SUM → reduce_scatter, other ops reduce then
        slice."""
        if op is not SUM:
            return _my_block(self, self.allreduce(x, op), axis)
        chunks = _blocks(self, self._own(x), axis)
        g = self._group()
        if g is None:
            return chunks[0].clone()
        members = self._members()
        idx = {m: i for i, m in enumerate(members)}
        out = torch.empty_like(chunks[0])
        dist.reduce_scatter(out, [chunks[idx[m]] for m in sorted(members)],
                            op=dist.ReduceOp.SUM, group=g)
        return out

    def allgather(self, x, axis: int = 0):
        """≈ MPI_Allgather: every rank's block concatenated along
        ``axis``."""
        return torch.cat(self._gather(x), dim=axis)

    def alltoall(self, x, split_axis: int = 0, concat_axis: int = 0):
        """≈ MPI_Alltoall: block j of ``x`` (along ``split_axis``) goes to
        rank j; the received blocks are concatenated along
        ``concat_axis``."""
        return torch.cat(self._all_to_all(_blocks(self, x, split_axis)),
                         dim=concat_axis)

    def alltoall_stacked(self, x, axis: Optional[str] = None):
        """Leading-dim exchange over one mesh axis: x's axis 0 must equal
        the axis size; entry j of the result is what rank j sent me."""
        ax = axis or self.axes[-1]
        n = int(self.mesh.shape[ax])
        if x.shape[0] != n:
            raise MPIException(f"alltoall_stacked: leading dim {x.shape[0]} "
                               f"must equal axis {ax!r} size {n}")
        return torch.stack(self._all_to_all(list(x.unbind(0)), (ax,)))

    def gather(self, x, root: int = 0, axis: int = 0):
        """≈ MPI_Gather: allgather, zeros on non-roots (the output is
        n×shard on every rank, as the reference's SPMD contract)."""
        full = self.allgather(x, axis=axis)
        return full if self.rank() == root else torch.zeros_like(full)

    def scatter(self, x, root: int = 0, axis: int = 0):
        """≈ MPI_Scatter: bcast root's buffer, slice my block."""
        return _my_block(self, self.bcast(x, root), axis)

    def scan(self, x, op: Op = SUM):
        """≈ MPI_Scan (inclusive prefix).  Small: allgather + ordered
        fold.  Large: O(shard)-memory Hillis-Steele."""
        if self._large(x):
            return self._hillis_scan(x, op)
        stacked = self._gather(x)
        if op is SUM:
            # dtype: an integer cumsum would widen to int64
            return torch.cumsum(torch.stack(stacked), dim=0,
                                dtype=x.dtype)[self.rank()]
        acc = stacked[0]
        for r in range(1, self.rank() + 1):
            acc = op.device(acc, stacked[r])
        return acc

    def exscan(self, x, op: Op = SUM):
        """≈ MPI_Exscan (exclusive prefix): rank r gets the fold of ranks
        < r; rank 0 gets zeros.  Large: the inclusive Hillis-Steele prefix
        shifted right one rank."""
        if self._large(x):
            incl = self._hillis_scan(x, op)
            n = self.size
            shifted = self._permute_axis(
                incl, [(i, i + 1) for i in range(n - 1)], self.axes[0])
            return torch.zeros_like(x) if self.rank() == 0 else shifted
        stacked = self._gather(x)
        me = self.rank()
        if op is SUM:
            incl = torch.cumsum(torch.stack(stacked), dim=0,
                                dtype=x.dtype)[me]
            return incl - x       # exclusive = inclusive − own contribution
        if me == 0:
            return torch.zeros_like(stacked[0])
        run = stacked[0]
        for r in range(1, me):
            run = op.device(run, stacked[r])
        return run

    # -- alternative algorithm implementations (the decision layer's menu) -

    def allreduce_rs_ag(self, x, op: Op = SUM, axis: Optional[int] = None):
        """Bandwidth-optimal 2-phase allreduce: reduce_scatter then
        all_gather along ``axis`` (default: the first n-divisible dim;
        plain allreduce when none divides)."""
        if op is not SUM:
            return self.allreduce(x, op)
        n = self.size
        if axis is None:
            axis = next((i for i, d in enumerate(x.shape) if d % n == 0),
                        None)
            if axis is None:
                return self.allreduce(x, op)
        return self.allgather(self.reduce_scatter(x, op, axis), axis)

    def allreduce_qint8(self, x, op: Op = SUM, block: int = 256):
        """Quantized 2-phase allreduce (≈ EQuARX): int8 payloads with
        per-block f32 scales.  Phase 1 sends quantized chunks to their
        owners (all_to_all), which dequantize and sum in f32; phase 2
        re-quantizes the reduced chunk and all_gathers it.  LOSSY; never
        auto-selected.  Rounds half to even and maps scale 0 to 1, as the
        reference."""
        if op is not SUM:
            return self.allreduce(x, op)
        n = self.size
        flat = x.reshape(-1)
        unit = n * block
        padded = -(-flat.shape[0] // unit) * unit
        if padded != flat.shape[0]:
            flat = torch.nn.functional.pad(flat, (0, padded - flat.shape[0]))
        chunk = padded // n

        def quant(v):
            b32 = v.reshape(*v.shape[:-1], v.shape[-1] // block,
                            block).to(torch.float32)
            scale = b32.abs().amax(dim=-1, keepdim=True) / 127.0
            scale = torch.where(scale == 0, 1.0, scale)
            q = torch.clamp(torch.round(b32 / scale), -127, 127).to(
                torch.int8)
            return q, scale

        def dequant(q, scale):
            return (q.to(torch.float32) * scale).reshape(
                *q.shape[:-2], q.shape[-2] * block)

        q, s = quant(flat.reshape(n, chunk))
        q = torch.stack(self._all_to_all(list(q.unbind(0))))
        s = torch.stack(self._all_to_all(list(s.unbind(0))))
        reduced = dequant(q, s).sum(dim=0)
        q2, s2 = quant(reduced)
        q2 = torch.stack(self._gather(q2))
        s2 = torch.stack(self._gather(s2))
        out = dequant(q2, s2).reshape(-1)[: x.numel()]
        return out.reshape(x.shape).to(x.dtype)

    def allreduce_segmented(self, x, op: Op = SUM,
                            segment_elems: int = 1 << 20):
        """Segmented 2-phase allreduce: the flat buffer in fixed
        n-divisible segments, each reduce_scatter + all_gather, the ragged
        tail by one allreduce."""
        if op is not SUM:
            return self.allreduce(x, op)
        n = self.size
        flat = x.reshape(-1)
        seg = max(n, min(segment_elems, flat.shape[0]))
        seg -= seg % n
        if seg <= 0 or flat.shape[0] <= seg:
            return self.allreduce_rs_ag(x, op)
        nseg = flat.shape[0] // seg
        parts = [self.allgather(self.reduce_scatter(c, SUM, 0), 0)
                 for c in flat[: nseg * seg].reshape(nseg, seg).unbind(0)]
        if flat.shape[0] > nseg * seg:
            parts.append(self.allreduce(flat[nseg * seg:]))
        return torch.cat(parts).reshape(x.shape)

    def allgather_ring(self, x, axis: int = 0):
        """Ring allgather over n-1 neighbour hops (≈
        coll_base_allgather.c:364); a multi-axis communicator uses the
        native all_gather."""
        if len(self.axes) > 1:
            return self.allgather(x, axis=axis)
        n, ax, my = self.size, self.axes[0], self.rank()
        ring = [(i, (i + 1) % n) for i in range(n)]
        blocks = [self._own(x)]
        for _ in range(n - 1):
            blocks.append(self._permute_axis(blocks[-1], ring, ax))
        # blocks[j] is the block of rank (my - j) mod n
        return torch.cat([blocks[(my - p) % n] for p in range(n)], dim=axis)

    def bcast_ring(self, x, root: int = 0):
        """Chain broadcast via n-1 ring hops (≈ coll_base_bcast.c:257):
        root's buffer, zeros elsewhere, summed along the ring (so -0.0
        arrives as +0.0, as in the reference)."""
        if len(self.axes) > 1:
            return self.bcast(x, root)
        n, ax = self.size, self.axes[0]
        ring = [(i, (i + 1) % n) for i in range(n)]
        x = self._own(x)
        cur = x if self.rank() == root else torch.zeros_like(x)
        acc = cur
        for _ in range(n - 1):
            cur = self._permute_axis(cur, ring, ax)
            acc = acc + cur
        return acc.to(x.dtype)

    # -- v-collectives (ragged → pad + counts) ------------------------------

    def _counts(self, counts, x, axis: int) -> tuple[int, ...]:
        if counts is None:
            return (x.shape[axis],) * self.size
        counts = tuple(int(c) for c in counts)
        if len(counts) != self.size:
            raise MPIException(
                f"counts {counts} must have one entry per rank ({self.size})")
        return counts

    def allgatherv(self, x, counts=None, axis: int = 0):
        """≈ MPI_Allgatherv: x is my block padded to max(counts) along
        ``axis`` (counts[r] valid rows on rank r); returns the
        concatenation of every rank's valid rows."""
        counts = self._counts(counts, x, axis)
        if len(set(counts)) == 1 and counts[0] == x.shape[axis]:
            return self.allgather(x, axis=axis)
        stacked = self._gather(x)
        return torch.cat([stacked[r].narrow(axis, 0, c)
                          for r, c in enumerate(counts)], dim=axis)

    def gatherv(self, x, counts=None, root: int = 0, axis: int = 0):
        """≈ MPI_Gatherv: allgatherv + zeros on non-roots."""
        full = self.allgatherv(x, counts, axis=axis)
        return full if self.rank() == root else torch.zeros_like(full)

    def scatterv(self, x, counts=None, root: int = 0, axis: int = 0):
        """≈ MPI_Scatterv: x holds sum(counts) rows along ``axis`` (root's
        is broadcast); returns my block padded with zeros to
        max(counts)."""
        if counts is None:
            return self.scatter(x, root, axis=axis)
        counts = tuple(int(c) for c in counts)
        if len(counts) != self.size:
            raise MPIException(
                f"counts {counts} must have one entry per rank ({self.size})")
        full = self.bcast(x, root)
        maxc = max(counts)
        me = self.rank()
        start, cnt = sum(counts[:me]), counts[me]
        pad = [0, 0] * full.ndim
        pad[2 * (full.ndim - 1 - axis) + 1] = maxc
        blk = torch.nn.functional.pad(full, pad).narrow(axis, start, maxc)
        shape = [1] * full.ndim
        shape[axis] = maxc
        mask = (torch.arange(maxc, device=full.device) < cnt).reshape(shape)
        return torch.where(mask, blk, torch.zeros_like(blk))

    def alltoallv(self, x, send_counts=None, axis: int = 0):
        """≈ MPI_Alltoallv: x is (n, maxc, ...) — one padded segment per
        destination; returns one padded segment per source, zeros beyond
        each valid prefix (send_counts[s][me] rows from source s)."""
        n = self.size
        if x.shape[0] != n:
            raise MPIException(
                f"alltoallv: leading dim {x.shape[0]} must equal "
                f"communicator size {n}")
        if send_counts is None:
            return self.alltoall(x, split_axis=0, concat_axis=0)
        m = np.asarray(send_counts, np.int64)
        if m.shape != (n, n):
            raise MPIException(
                f"alltoallv: send_counts must be {n}x{n}, got {m.shape}")
        out = self.alltoall(x, split_axis=0, concat_axis=0)
        recv = torch.as_tensor(m.T[self.rank()], device=out.device)
        idx = torch.arange(x.shape[1], device=out.device)
        shape = [n] + [1] * (x.ndim - 1)
        shape[1] = x.shape[1]
        mask = (idx[None, :] < recv[:, None]).reshape(shape)
        return torch.where(mask, out, torch.zeros_like(out))

    def barrier(self, token=None):
        """Device barrier: this rank's stream drains, then the host group
        of my axes meets.  Returns ``token`` (the reference threads one
        through data dependencies; eager PyTorch needs none)."""
        if self.mesh.device.type == "cuda":
            torch.cuda.current_stream(self.mesh.device).synchronize()
        self.mesh.host_barrier(self.axes)
        return token

    # -- point-to-point as permutation --------------------------------------

    def shift(self, x, displacement: int = 1, axis: Optional[str] = None):
        """Cyclic ring shift (≈ MPI_Cart_shift + Sendrecv): every rank
        sends to (i+displacement) mod n along ``axis``."""
        ax = axis or self.axes[-1]
        n = int(self.mesh.shape[ax])
        return self._permute_axis(
            x, [(i, (i + displacement) % n) for i in range(n)], ax)

    def permute(self, x, perm: Sequence[tuple[int, int]],
                axis: Optional[str] = None):
        """General (src, dst) permutation along ``axis``; ranks not
        covered receive zeros (ppermute's semantics)."""
        return self._permute_axis(x, perm, axis or self.axes[-1])

    def sendrecv(self, x, dest_disp: int, source_disp: Optional[int] = None,
                 axis: Optional[str] = None):
        """Cyclic exchange by displacement (every rank passes the same
        arguments; MPI_Cart_shift + MPI_Sendrecv).  ``source_disp``, if
        given, must be the matching -dest_disp pattern."""
        ax = axis or self.axes[-1]
        n = int(self.mesh.shape[ax])
        if source_disp is not None and (source_disp % n) != (-dest_disp) % n:
            raise MPIException(
                f"sendrecv: source_disp {source_disp} does not match "
                f"dest_disp {dest_disp} (need source ≡ -dest mod {n} for a "
                f"cyclic pattern; use permute() for general patterns)")
        return self.shift(x, dest_disp % n, ax)

    # -- one-sided (≈ btl.h:970/1007 put/get) ------------------------------
    #
    # Not collectives: bytes move only src→dst, by the copy kernels of
    # ops/remote_dma through the peers' mapped windows.  Every rank makes
    # the call (the sequence numbers of the flag protocol count calls).

    def _flat_axis(self, what: str) -> str:
        if len(self.axes) != 1 or len(self.mesh.axis_names) != 1:
            raise MPIException(
                f"{what}: one-sided remote DMA addresses devices by their "
                f"logical index, which requires a flat single-axis mesh "
                f"(got axes {self.axes} of mesh {self.mesh.axis_names}); "
                f"use device_world(make_mesh(devices=...))")
        return self.axes[0]

    def window(self, local_shape: Sequence[int], dtype=torch.float32,
               fill=0) -> torch.Tensor:
        """Collective: this rank's part of a new symmetric window (≈
        MPI_Win_allocate), the memory put/get address on the card."""
        from ompi_tpu_torch.ops import symmetric

        return symmetric.allocate(self.mesh, local_shape, torch_dtype(dtype),
                                  fill)

    def put(self, win, value, src: int, dst: int):
        """One-sided put: rank ``src`` writes ``value`` into ``dst``'s
        window.  Updates the window in place and returns it (the
        reference returns the new window).  Complete when the call returns
        on dst (implicit quiet per op)."""
        from ompi_tpu_torch.ops.remote_dma import window_put

        self._flat_axis("put")
        return window_put(win, value, src, dst, self)

    def get(self, win, src: int, dst: int):
        """One-sided get: rank ``dst`` fetches ``src``'s window (everyone
        else gets its own window back)."""
        from ompi_tpu_torch.ops.remote_dma import window_get

        self._flat_axis("get")
        return window_get(win, src, dst, self)

    # -- driver mode ---------------------------------------------------------

    def run(self, fn: Callable, *shards, out_specs: Any = None):
        """``fn(self, *shards)`` on this rank (the body the reference runs
        under shard_map); ``out_specs`` is accepted and unused."""
        return fn(self, *shards)

    def run_method(self, method: str, *shards, margs: tuple = (),
                   mkw: tuple = (), out_specs: Any = None,
                   donate: tuple = ()):
        """One named method on this rank's shards; there is no program to
        cache, and ``donate`` is ignored (the one-sided ops already work in
        place)."""
        return getattr(self, method)(*shards, *margs, **dict(mkw))

    def __repr__(self) -> str:
        return (f"DeviceCommunicator({self.name}, axes={self.axes}, "
                f"size={self.size})")


def _blocks(comm: DeviceCommunicator, x, axis: int) -> list:
    """x split into comm.size equal blocks along ``axis``."""
    n = comm.size
    if x.shape[axis] % n:
        raise MPIException(
            f"dimension {axis} ({x.shape[axis]}) not divisible by "
            f"communicator size {n}")
    return list(x.split(x.shape[axis] // n, dim=axis))


def _my_block(comm: DeviceCommunicator, full, axis: int):
    """This rank's equal block of ``full`` along ``axis``."""
    return _blocks(comm, full, axis)[comm.rank()].contiguous()


def device_world(mesh=None, axes=None) -> DeviceCommunicator:
    """The device-side COMM_WORLD: every rank of the mesh (default:
    ``make_mesh()`` over the initialised process group, or one
    process)."""
    if mesh is None:
        from ompi_tpu_torch.parallel.mesh import make_mesh

        mesh = make_mesh()
    return DeviceCommunicator(mesh, axes, name="DEVICE_WORLD")
