"""The port's host RMA windows (``ompi_tpu_torch.mpi.osc``: ``Window``,
``SharedWindow``) against the JAX package's.

Each case mirrors one of ``tests/mpi/test_osc.py``,
``tests/mpi/test_osc_ext.py`` or the window cases of
``tests/mpi/test_api_parity.py`` with every assertion kept.  The case
runs once through each package (``M``: its ``osc``, ``op``, constants and
in-process harness) on the same numpy inputs and returns every rank's
results; the port's must equal the JAX package's exactly.  Where thread
timing decides which rank gets which ticket (fetch_add, compare_swap,
get_accumulate from every rank at once), the case returns what the
reference's assertions hold: the sorted tickets and the final value.

The port's own cases follow: revoking the parent communicator makes
every member's fence raise ERR_REVOKED in both packages; torch tensors as
origin data and as a window's buffer (a CPU tensor's memory sees a remote
put; bf16 tensors are converted to the window's dtype, as the JAX
package's self-put converts); the osc spans of a traced epoch and the osc
class of a communication monitor; the shared window's segment names;
and a traced ``examples/trace_demo`` job under the port's launcher.
"""

from __future__ import annotations

import json
import os
import pathlib
import subprocess
import sys
import time
import types

import ml_dtypes
import numpy as np
import pytest
import torch

from ompi_tpu import _native as jnative
from ompi_tpu.core.config import var_registry as jvars
from ompi_tpu.mpi import constants as jconst
from ompi_tpu.mpi import ft as jft
from ompi_tpu.mpi import monitoring as jmon
from ompi_tpu.mpi import op as jop
from ompi_tpu.mpi import osc as josc
from ompi_tpu.mpi import trace as jtrace
from ompi_tpu.mpi.info import Info as JInfo
from ompi_tpu_torch import _native as pnative
from ompi_tpu_torch.core.config import var_registry as pvars
from ompi_tpu_torch.mpi import constants as pconst
from ompi_tpu_torch.mpi import ft as pft
from ompi_tpu_torch.mpi import monitoring as pmon
from ompi_tpu_torch.mpi import op as pop
from ompi_tpu_torch.mpi import osc as posc
from ompi_tpu_torch.mpi import trace as ptrace
from ompi_tpu_torch.mpi.info import Info as PInfo
from tests.mpi.harness import run_ranks as jrun
from tests.test_torch_host_p2p import _same
from tests.torch_host_harness import run_ranks as prun

ROOT = pathlib.Path(__file__).resolve().parents[1]

J = types.SimpleNamespace(name="jax", osc=josc, op=jop, const=jconst,
                          MPIException=jconst.MPIException, Info=JInfo,
                          ft=jft, trace=jtrace, mon=jmon, vars=jvars,
                          native=jnative, run=jrun)
P = types.SimpleNamespace(name="port", osc=posc, op=pop, const=pconst,
                          MPIException=pconst.MPIException, Info=PInfo,
                          ft=pft, trace=ptrace, mon=pmon, vars=pvars,
                          native=pnative, run=prun)
BOTH = (J, P)


def both(case, *args):
    """Run ``case(M, *args)`` through both packages; the results must be
    equal bit for bit.  Returns the port's."""
    out = [case(M, *args) for M in BOTH]
    _same(out[0], out[1])
    return out[1]


# ---------------------------------------------------------------------------
# tests/mpi/test_osc.py
# ---------------------------------------------------------------------------

def _put_fence_get(M):
    def fn(comm):
        win = M.osc.Window(comm, size=8, dtype=np.float64)
        # everyone puts its rank into slot `rank` of the right neighbor
        right = (comm.rank + 1) % comm.size
        win.put(right, np.array([comm.rank + 1.0]), offset=comm.rank)
        win.fence()
        left = (comm.rank - 1) % comm.size
        val = win.buf[left]
        win.free()
        return float(val)

    res = M.run(3, fn)
    assert res == [3.0, 1.0, 2.0]
    return res


def test_put_fence_get():
    both(_put_fence_get)


def _get_remote(M):
    def fn(comm):
        win = M.osc.Window(comm, buffer=np.full(4, comm.rank, dtype=np.int64))
        win.fence()
        peer = (comm.rank + 1) % comm.size
        out = win.get(peer, count=4)
        win.fence()
        win.free()
        return out.tolist()

    res = M.run(3, fn)
    assert res[0] == [1, 1, 1, 1] and res[2] == [0, 0, 0, 0]
    return res


def test_get_remote():
    both(_get_remote)


def _accumulate_concurrent(M):
    def fn(comm):
        win = M.osc.Window(comm, size=1, dtype=np.int64)
        win.fence()
        for _ in range(10):
            win.accumulate(0, np.array([1]), M.op.SUM)
        win.fence()
        total = int(win.buf[0])
        win.free()
        return total

    res = M.run(4, fn)
    assert res[0] == 40
    return res


def test_accumulate_concurrent():
    both(_accumulate_concurrent)


def _fetch_add_is_atomic(M):
    def fn(comm):
        win = M.osc.Window(comm, size=1, dtype=np.int64)
        win.fence()
        olds = [int(win.fetch_op(0, np.array([1]), M.op.SUM)[0])
                for _ in range(5)]
        win.fence()
        final = int(win.buf[0])
        win.free()
        return olds, final

    res = M.run(3, fn)
    all_olds = sorted(sum((r[0] for r in res), []))
    assert all_olds == list(range(15))  # every ticket unique → atomic
    assert res[0][1] == 15
    return all_olds, [r[1] for r in res]


def test_fetch_add_is_atomic():
    both(_fetch_add_is_atomic)


def _compare_swap(M):
    def fn(comm):
        win = M.osc.Window(comm, size=1, dtype=np.int64)
        win.fence()
        old = win.compare_swap(0, compare=0, value=comm.rank + 1)
        win.fence()
        final = int(win.buf[0])
        win.free()
        return int(old[0]), final

    res = M.run(3, fn)
    winners = [r for r in res if r[0] == 0]
    assert len(winners) == 1  # exactly one CAS succeeded
    assert res[0][1] in (1, 2, 3)
    # the winner's value is the one that stayed; every loser saw it
    won = [i for i, r in enumerate(res) if r[0] == 0][0]
    return (len(winners), res[0][1] == won + 1,
            sorted(r[0] for r in res).count(won + 1))


def test_compare_swap():
    both(_compare_swap)


def _lock_unlock_mutual_exclusion(M):
    def fn(comm):
        win = M.osc.Window(comm, size=2, dtype=np.int64)
        win.fence()
        for _ in range(5):
            win.lock(0, exclusive=True)
            # read-modify-write that would race without the lock
            cur = int(win.get(0, count=1)[0])
            win.put(0, np.array([cur + 1]), offset=0)
            win.unlock(0)
        win.fence()
        total = int(win.buf[0])
        win.free()
        return total

    res = M.run(3, fn)
    assert res[0] == 15
    return res


def test_lock_unlock_mutual_exclusion():
    both(_lock_unlock_mutual_exclusion)


def _local_window_ops(M):
    def fn(comm):
        win = M.osc.Window(comm, size=4, dtype=np.float32)
        win.put(comm.rank, np.array([7.0, 8.0]), offset=1)
        got = win.get(comm.rank, count=2, offset=1)
        old = win.fetch_op(comm.rank, np.array([1.0]), M.op.SUM, offset=1)
        win.fence()
        win.free()
        return got.tolist(), float(old[0]), float(win.buf[1])

    res = M.run(2, fn)
    got, old, after = res[0]
    assert got == [7.0, 8.0] and old == 7.0 and after == 8.0
    return res


def test_local_window_ops():
    both(_local_window_ops)


def _noncontiguous_buffer_rejected(M):
    def fn(comm):
        arr = np.zeros(16, dtype=np.int64)
        with pytest.raises(M.MPIException, match="contiguous") as e:
            M.osc.Window(comm, buffer=arr[::2])
        return str(e.value)

    res = M.run(1, fn)
    assert all(res)
    return res


def test_noncontiguous_buffer_rejected():
    both(_noncontiguous_buffer_rejected)


def _get_out_of_range_raises(M):
    def fn(comm):
        win = M.osc.Window(comm, size=4, dtype=np.int64)
        win.fence()
        peer = (comm.rank + 1) % comm.size
        msgs = []
        try:
            with pytest.raises(M.MPIException, match="outside window") as e:
                win.get(peer, count=4, offset=2)      # remote over-read
            msgs.append(str(e.value))
            with pytest.raises(M.MPIException, match="outside window") as e:
                win.get(comm.rank, count=9, offset=0)  # local over-read
            msgs.append(str(e.value))
        finally:
            win.fence()
            win.free()
        return msgs

    res = M.run(2, fn)
    assert all(len(m) == 2 for m in res)
    return res


def test_get_out_of_range_raises():
    both(_get_out_of_range_raises)


def _bad_put_surfaces_at_fence_without_hanging(M):
    def fn(comm):
        win = M.osc.Window(comm, size=4, dtype=np.int64)
        win.fence()
        failed = False
        if comm.rank == 1:
            win.put(0, np.arange(4), offset=3)  # overruns target window
        try:
            win.fence()  # must terminate; rank 0 sees the error
        except M.MPIException as e:
            failed = "outside window" in str(e)
        win.free()
        return comm.rank, failed

    res = dict(M.run(2, fn))
    assert res[0] is True      # target rank observed the failure
    assert res[1] is False     # origin's fence completed cleanly
    return res


def test_bad_put_surfaces_at_fence_without_hanging():
    both(_bad_put_surfaces_at_fence_without_hanging)


# ---------------------------------------------------------------------------
# tests/mpi/test_osc_ext.py
# ---------------------------------------------------------------------------

def _pscw_put_ordering(M):
    def fn(comm):
        win = M.osc.Window(comm, size=comm.size, dtype=np.int64)
        half = comm.size // 2
        if comm.rank < half:            # targets: expose to the top half
            origins = list(range(half, comm.size))
            win.post(origins)
            win.wait()
            out = win.buf.copy()
        else:                           # origins: access the bottom half
            targets = list(range(half))
            win.start(targets)
            for t in targets:
                win.put(t, np.array([comm.rank + 100]),
                        offset=comm.rank % half)
            win.complete()
            out = None
        win.comm.barrier()
        win.free()
        return None if out is None else out.tolist()

    res = M.run(4, fn)
    assert res[0] == [102, 103, 0, 0]
    assert res[1] == [102, 103, 0, 0]
    assert res[2] is None and res[3] is None
    return res


def test_pscw_put_ordering():
    both(_pscw_put_ordering)


def _pscw_two_epochs_and_test(M):
    def fn(comm):
        win = M.osc.Window(comm, size=1, dtype=np.int64)
        vals = []
        for epoch in range(2):
            if comm.rank == 0:
                win.post([1])
                while not win.test_epoch():
                    pass
                vals.append(int(win.buf[0]))
            else:
                win.start([0])
                win.put(0, np.array([epoch + 7]))
                win.complete()
        win.comm.barrier()
        win.free()
        return vals

    res = M.run(2, fn)
    assert res[0] == [7, 8]
    return res


def test_pscw_two_epochs_and_test():
    both(_pscw_two_epochs_and_test)


def _pscw_misuse_raises(M):
    def fn(comm):
        win = M.osc.Window(comm, size=1)
        msgs = []
        for call in (win.complete, win.wait):
            try:
                call()
            except M.MPIException as e:
                msgs.append(str(e))
        win.free()
        return msgs

    res = M.run(2, fn)
    assert all(len(m) == 2 for m in res)
    return res


def test_pscw_misuse_raises():
    both(_pscw_misuse_raises)


def _get_accumulate_sum_and_noop(M):
    def fn(comm):
        win = M.osc.Window(comm, buffer=np.arange(4, dtype=np.int64) * 0 + 10)
        win.fence()
        old = None
        if comm.rank == 1:
            old = win.get_accumulate(0, np.array([5, 5]), M.op.SUM)
            # NO_OP = atomic get: must see the accumulated values
            now = win.get_accumulate(0, np.zeros(2, np.int64), M.op.NO_OP)
        win.fence()
        buf = win.buf.copy()
        win.free()
        if comm.rank == 1:
            return old.tolist(), now.tolist()
        return buf.tolist()

    res = M.run(2, fn)
    assert res[1] == ([10, 10], [15, 15])
    assert res[0][:2] == [15, 15]
    return res


def test_get_accumulate_sum_and_noop():
    both(_get_accumulate_sum_and_noop)


def _get_accumulate_concurrent_atomic(M):
    def fn(comm):
        win = M.osc.Window(comm, size=1, dtype=np.int64)
        win.fence()
        old = int(win.get_accumulate(0, np.array([1]), M.op.SUM)[0])
        win.fence()
        final = int(win.buf[0])
        win.free()
        return old, final

    res = M.run(4, fn)
    olds = sorted(r[0] for r in res)
    assert olds == [0, 1, 2, 3]
    assert res[0][1] == 4
    return olds, [r[1] for r in res]


def test_get_accumulate_concurrent_atomic():
    both(_get_accumulate_concurrent_atomic)


def _rput_rget_outstanding(M):
    def fn(comm):
        win = M.osc.Window(comm, buffer=np.full(8, comm.rank, dtype=np.int64))
        win.fence()
        reqs = []
        if comm.rank == 0:
            r1 = win.rput(1, np.array([42, 43]), offset=0)
            r2 = win.rget(1, count=4, offset=4)
            r3 = win.rget(1, count=2, offset=4)   # two rgets outstanding
            reqs = [r1]
            got4 = r2.wait().tolist()
            got2 = r3.wait().tolist()
        for r in reqs:
            r.wait()
        win.fence()
        buf = win.buf.copy()
        win.free()
        if comm.rank == 0:
            return got4, got2
        return buf.tolist()

    res = M.run(2, fn)
    assert res[0] == ([1, 1, 1, 1], [1, 1])
    assert res[1][:2] == [42, 43]
    return res


def test_rput_rget_outstanding():
    both(_rput_rget_outstanding)


def _raccumulate_and_flush(M):
    def fn(comm):
        win = M.osc.Window(comm, size=1, dtype=np.int64)
        win.fence()
        if comm.rank != 0:
            win.lock(0, exclusive=False)
            win.raccumulate(0, np.array([comm.rank]), M.op.SUM).wait()
            win.unlock(0)
        win.fence()
        total = int(win.buf[0])
        win.free()
        return total

    res = M.run(4, fn)
    assert res[0] == 1 + 2 + 3
    return res


def test_raccumulate_and_flush():
    both(_raccumulate_and_flush)


def _lock_all_flush_all(M):
    def fn(comm):
        win = M.osc.Window(comm, size=comm.size, dtype=np.int64)
        win.fence()
        win.lock_all()
        for t in range(comm.size):
            win.put(t, np.array([comm.rank + 1]), offset=comm.rank)
        win.flush_all()
        win.unlock_all()
        win.fence()
        buf = win.buf.copy()
        win.free()
        return buf.tolist()

    res = M.run(3, fn)
    assert res[0] == [1, 2, 3] and res[2] == [1, 2, 3]
    return res


def test_lock_all_flush_all():
    both(_lock_all_flush_all)


def _dynamic_window_attach_put_get(M):
    def fn(comm):
        win = M.osc.Window.create_dynamic(comm, dtype=np.int64)
        region = np.zeros(4, dtype=np.int64)
        base = win.attach(region)
        # exchange bases (the MPI idiom: addresses travel out-of-band)
        bases = comm.allgather(np.array([base], np.int64))
        win.fence()
        peer = (comm.rank + 1) % comm.size
        win.put(peer, np.array([comm.rank + 1] * 4),
                offset=int(np.asarray(bases[peer])[0]))
        win.fence()
        got = win.get(peer, count=4, offset=int(np.asarray(bases[peer])[0]))
        win.fence()
        local = region.copy()
        win.detach(base)
        win.free()
        return local.tolist(), got.tolist()

    res = M.run(3, fn)
    # rank r's region was written by its left neighbor (r-1)+1 = r
    assert res[0][0] == [3, 3, 3, 3]
    assert res[1][0] == [1, 1, 1, 1]
    # got = what the right neighbor's region holds = (rank+1)'s writer value
    assert res[0][1] == [1, 1, 1, 1]
    return res


def test_dynamic_window_attach_put_get():
    both(_dynamic_window_attach_put_get)


def _dynamic_window_unattached_access_fails(M):
    def fn(comm):
        win = M.osc.Window.create_dynamic(comm)
        region = np.zeros(2, dtype=np.uint8)
        base = win.attach(region)
        win.fence()
        err = None
        if comm.rank == 0:
            try:
                win.get(1, count=64, offset=base)  # spans past the region
            except M.MPIException as e:
                err = str(e)
        win.fence()
        win.free()
        return err

    res = M.run(2, fn)
    assert res[0] is not None and "region" in res[0]
    return res


def test_dynamic_window_unattached_access_fails():
    both(_dynamic_window_unattached_access_fails)


def _dynamic_detach_then_access_fails(M):
    def fn(comm):
        win = M.osc.Window.create_dynamic(comm, dtype=np.int64)
        region = np.zeros(2, dtype=np.int64)
        base = win.attach(region)
        win.fence()
        win.detach(base)
        err = None
        try:
            win.get(comm.rank, count=1, offset=base)  # local resolve fails
        except M.MPIException as e:
            err = str(e)
        win.fence()
        win.free()
        return err

    res = M.run(2, fn)
    assert all(r is not None for r in res)
    return res


def test_dynamic_detach_then_access_fails():
    both(_dynamic_detach_then_access_fails)


# ---------------------------------------------------------------------------
# tests/mpi/test_api_parity.py: the window cases
# ---------------------------------------------------------------------------

def _window_no_locks_hint(M):
    def body(comm):
        win = M.osc.Window(comm, size=8, info=M.Info({"no_locks": "true"}))
        comm.barrier()
        with pytest.raises(M.MPIException, match="no_locks") as e:
            win.lock(0)
        comm.barrier()
        # active-target sync still works fine
        win.fence()
        win.put(1 - comm.rank, np.array([7], np.uint8), offset=0)
        win.fence()
        assert int(win.buf[0]) == 7
        out = win.buf.copy(), e.value.error_class
        win.free()
        return out

    return M.run(2, body)


def test_window_no_locks_hint():
    both(_window_no_locks_hint)


def _win_allocate_shared(M):
    def body(comm):
        node = comm.split_type(M.const.COMM_TYPE_SHARED)
        win = M.osc.SharedWindow(node, local_size=16, dtype=np.int32)
        win.local[:] = node.rank + 1         # direct store to my slice
        win.sync()
        # direct load from every peer's slice — no messages
        seen = []
        for r in range(node.size):
            view = win.shared_query(r)
            assert view.shape == (16,)
            assert (view == r + 1).all(), (node.rank, r, view[:4])
            seen.append(view.copy())
        assert M.native.fastdss() is not None
        # lock-free cross-rank counter on rank 0's first slot
        win.sync()
        if node.rank == 0:
            win.local[:] = 0
        win.sync()
        win.fetch_add(0, 0, 1)           # every rank increments
        win.sync()
        cnt = int(np.frombuffer(win.shared_query(0).tobytes(),
                                np.int64)[0])
        assert cnt == node.size, cnt
        win.free()
        return seen, cnt

    return M.run(4, body)


def test_win_allocate_shared():
    both(_win_allocate_shared)


def _win_allocate_shared_heterogeneous(M):
    def body(comm):
        node = comm.split_type(M.const.COMM_TYPE_SHARED)
        mine = 32 if node.rank == 0 else 0
        win = M.osc.SharedWindow(node, local_size=mine, dtype=np.int32)
        if node.rank == 0:
            win.local[:] = np.arange(32, dtype=np.int32)
        win.sync()
        owner = win.shared_query(0)
        assert owner.shape == (32,)
        assert (owner == np.arange(32, dtype=np.int32)).all()
        for r in range(1, node.size):
            assert win.shared_query(r).size == 0
        out = owner.copy(), [win.shared_query(r).shape
                             for r in range(node.size)]
        win.free()
        return out

    return M.run(3, body)


def test_win_allocate_shared_heterogeneous():
    both(_win_allocate_shared_heterogeneous)


# ---------------------------------------------------------------------------
# the port's own cases
# ---------------------------------------------------------------------------

def _revoked_parent_fails_every_fence(M):
    def fn(comm):
        win = M.osc.Window(comm, size=4, dtype=np.int64)
        win.fence()
        comm.barrier()
        # revoke only once every rank has left the barrier: a rank still
        # parked in it when the revocation lands fails the barrier itself
        if comm.rank == 0:
            for peer in range(1, comm.size):
                comm.recv(source=peer, tag=7)
            comm.revoke()
        else:
            comm.send(np.zeros(1, np.int64), dest=0, tag=7)
        deadline = time.monotonic() + 20
        while not M.ft.comm_is_revoked(comm):
            assert time.monotonic() < deadline, "revocation never arrived"
            time.sleep(0.005)
        try:
            win.fence()
        except M.MPIException as e:
            return e.error_class, str(e)
        return None

    res = M.run(3, fn)
    assert res == [(M.const.ERR_REVOKED,
                    "window 'win': fence on a revoked communicator")] * 3
    return res


def test_revoked_parent_fails_every_fence():
    """Revoking the parent communicator poisons its windows: every
    member's next fence raises ERR_REVOKED, in both packages."""
    both(_revoked_parent_fails_every_fence)


def _origin(M, x):
    """The case's origin data: numpy for the JAX package, the same
    values as a CPU tensor for the port."""
    return torch.from_numpy(np.array(x)) if M is P else np.array(x)


def _tensor_origin_ops(M):
    rng = np.random.default_rng(17)
    data = rng.normal(size=(3, 8)).astype(np.float32)

    def fn(comm):
        win = M.osc.Window(comm, size=32, dtype=np.float32)
        win.fence()
        right = (comm.rank + 1) % comm.size
        win.put(right, _origin(M, data[comm.rank]), offset=0)
        win.put_strided(right, _origin(M, data[comm.rank][:4]), offset=8,
                        stride=2)
        win.accumulate(right, _origin(M, data[comm.rank]), M.op.SUM,
                       offset=16)
        win.fence()
        old = win.fetch_op(right, _origin(M, data[comm.rank][:1]),
                           M.op.MAX, offset=24)
        got = win.get_accumulate(right, _origin(M, data[comm.rank][:2]),
                                 M.op.SUM, offset=25)
        win.rput(right, _origin(M, data[comm.rank][2:4]), offset=27).wait()
        win.raccumulate(right, _origin(M, data[comm.rank][4:6]), M.op.PROD,
                        offset=29).wait()
        sw = win.compare_swap(right, _origin(M, np.float32(0.0)),
                              _origin(M, data[comm.rank][6]), offset=31)
        win.fence()
        out = win.buf.copy(), old, got, sw
        win.free()
        return out

    return M.run(3, fn)


def test_tensor_origin_data_matches_numpy():
    """Every op that takes origin data gives, for a CPU tensor, the
    result the JAX package gives for the same numpy values."""
    res = both(_tensor_origin_ops)
    assert all(r[0].dtype == np.float32 for r in res)


def test_cpu_tensor_buffer_sees_remote_puts():
    """A CPU tensor as a window's buffer: the window exposes its memory,
    so the puts of every peer land in the caller's tensor — as they land
    in a numpy buffer in the JAX package."""
    def run(M):
        def fn(comm):
            buf = (torch.zeros(3, 4, dtype=torch.float64) if M is P
                   else np.zeros((3, 4), np.float64))
            win = M.osc.Window(comm, buffer=buf)
            win.fence()
            for t in range(comm.size):
                if t != comm.rank:
                    win.put(t, np.full(4, comm.rank + 0.5),
                            offset=4 * comm.rank)
            win.fence()
            out = np.asarray(buf).copy(), win.buf.copy()
            win.free()
            return out

        return M.run(3, fn)

    res = both(run)
    for r, (seen, flat) in enumerate(res):
        want = np.repeat(np.arange(3.0) + 0.5, 4).reshape(3, 4)
        want[r] = 0.0
        assert (seen == want).all() and (flat == want.ravel()).all()


def test_tensor_buffers_the_window_cannot_expose_raise():
    """A non-contiguous or bf16 CPU tensor as a buffer raises, as the JAX
    package's non-contiguous array does; so does attaching one."""
    def fn(comm):
        msgs = []
        for bad in (torch.zeros(16, dtype=torch.int64)[::2],
                    torch.zeros(4, dtype=torch.bfloat16)):
            with pytest.raises(pconst.MPIException) as e:
                posc.Window(comm, buffer=bad)
            msgs.append(str(e.value))
        win = posc.Window.create_dynamic(comm)
        with pytest.raises(pconst.MPIException, match="contiguous"):
            win.attach(torch.zeros(8)[::2])
        win.free()
        return msgs

    (msgs,) = prun(1, fn)
    assert "contiguous" in msgs[0]
    assert "bfloat16" in msgs[1]


def _bf16_ref(M, vals):
    """The JAX package's self-put of an ml_dtypes bf16 array into an f32
    window (``astype`` converts it)."""
    def fn(comm):
        win = M.osc.Window(comm, size=len(vals), dtype=np.float32)
        win.put(comm.rank, np.asarray(vals, ml_dtypes.bfloat16))
        win.fence()
        out = win.buf.copy()
        win.free()
        return out

    return M.run(1, fn)[0]


def test_bf16_tensor_put_equals_the_jax_self_put():
    """A bf16 tensor put into an f32 window, into this rank's own part
    and into a peer's, holds what the JAX package's self-put of the same
    bf16 values holds (its remote put does not convert: ROADMAP.md,
    "Note for porters")."""
    vals = np.random.default_rng(3).normal(size=64).astype(np.float32)
    want = _bf16_ref(J, vals)

    def fn(comm):
        win = posc.Window(comm, size=2 * len(vals), dtype=np.float32)
        t = torch.from_numpy(vals).to(torch.bfloat16)
        win.put(comm.rank, t)                                 # self
        win.put((comm.rank + 1) % comm.size, t, offset=len(vals))  # remote
        win.fence()
        out = win.buf.copy()
        win.free()
        return out

    for r in prun(2, fn):
        _same(r[:len(vals)], want)
        _same(r[len(vals):], want)
    assert not np.array_equal(want, vals)     # bf16 rounding happened


def _traced_epochs(M):
    M.trace.disable()
    M.trace.enable(capacity=65536)
    try:
        def fn(comm):
            win = M.osc.Window(comm, size=4, dtype=np.int64, name="tw")
            win.fence()
            win.put((comm.rank + 1) % comm.size, np.array([comm.rank]))
            win.fence()
            win.lock(0, exclusive=comm.rank == 0)
            win.unlock(0)
            if comm.rank == 0:
                win.post([1])
                win.wait()
            else:
                win.start([0])
                win.put(0, np.array([9]), offset=1)
                win.complete()
            win.free()
            return None

        M.run(2, fn)
        events = M.trace.recorder.snapshot()
    finally:
        M.trace.disable()
    return sorted((cat, name, rank, json.dumps(args, sort_keys=True))
                  for _ts, _dur, cat, name, rank, args in events
                  if cat == "osc")


def test_traced_epochs_record_the_jax_packages_osc_events():
    """fence spans, the post instant, pscw_complete/pscw_wait and
    lock/unlock spans: the same osc events, ranks and arguments as the
    JAX package's."""
    osc = both(_traced_epochs)
    names = sorted({e[1] for e in osc})
    assert names == ["fence", "lock", "post", "pscw_complete", "pscw_wait",
                     "unlock"]
    assert sum(e[1] == "fence" for e in osc) == 4


def _monitored_osc(M):
    M.run(2, lambda c: c.barrier())       # coll/shm opened: its vars exist
    old = M.vars.get("coll_shm_enable")
    M.vars.set("coll_shm_enable", False)
    try:
        def fn(comm):
            with M.mon.Monitor(comm.pml, comm.size) as m:
                win = M.osc.Window(comm, size=64, dtype=np.float64)
                peer = (comm.rank + 1) % comm.size
                win.fence()
                win.put(peer, np.arange(16.0))
                win.accumulate(peer, np.ones(8), M.op.SUM, offset=16)
                win.fence()
                got = win.get(peer, count=8)
                win.lock(peer)
                win.fetch_op(peer, np.array([2.0]), M.op.SUM, offset=40)
                win.unlock(peer)
                win.fence()
                win.free()
                t = m.totals()
                return ({k: v["osc"] for k, v in t.items()
                         if isinstance(v, dict) and "osc" in v},
                        m.row("sent_bytes", cls="osc"),
                        m.row("sent_count", cls="osc"), got)
        return M.run(3, fn)
    finally:
        M.vars.set("coll_shm_enable", old)


def test_monitor_counts_window_traffic_in_the_osc_class():
    res = both(_monitored_osc)
    for counts, _row, _n, _got in res:
        assert counts["sent_count"] > 0 and counts["sent_bytes"] > 16 * 8


def test_shared_window_segments_are_the_ports_and_go_at_free():
    """The port names its segments ``otpu-shwin-<name>-<uid>-t<nonce>``
    (the JAX package's carry no ``t``, and its nonce counter runs beside
    the port's in one process): a window of each package, open at once
    under the same name, keep apart, and ``free`` removes both."""
    def fn(jc, pc):
        jw = josc.SharedWindow(jc, 4, np.int64, name="pair")
        pw = posc.SharedWindow(pc, 4, np.int64, name="pair")
        pw.local[:] = 7
        jw.local[:] = 9
        pw.sync()
        jw.sync()
        paths = jw._seg.path, pw._seg.path
        vals = jw.shared_query(0).tolist(), pw.shared_query(0).tolist()
        jw.free()
        pw.free()
        return paths, vals

    # a one-rank job of each package, the JAX package's inside the port's
    (((jpath, ppath), (jv, pv)),) = prun(
        1, lambda pc: jrun(1, lambda jc: fn(jc, pc))[0])
    uid = os.getuid()
    assert os.path.basename(ppath).startswith(f"otpu-shwin-pair-{uid}-t")
    assert os.path.basename(jpath).startswith(f"otpu-shwin-pair-{uid}-")
    assert "-t" not in os.path.basename(jpath)
    assert jv == [9] * 4 and pv == [7] * 4
    assert not os.path.exists(jpath) and not os.path.exists(ppath)


def test_trace_demo_job_records_the_osc_category(tmp_path):
    """A traced 4-rank job of the port's ``examples/trace_demo`` now runs
    a fence epoch with a put: its merged dumps carry osc spans beside
    pml, btl, coll, datatype and io."""
    env = {**os.environ, "TMPDIR": str(tmp_path)}
    p = subprocess.run(
        [sys.executable, "-m", "ompi_tpu_torch.tools.tpurun", "-np", "4",
         "--trace", "--no-tag-output", "--", sys.executable, "-m",
         "ompi_tpu_torch.examples.trace_demo"], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.count("demo done") == 4
    merged = tmp_path / "merged.json"
    x = subprocess.run(
        [sys.executable, "-m", "ompi_tpu_torch.tools.trace_export", "--dir",
         str(tmp_path), "-o", str(merged)], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120)
    assert x.returncode == 0, x.stderr[-2000:]
    evs = json.loads(merged.read_text())["traceEvents"]
    cats = {e.get("cat") for e in evs if e.get("ph") in ("X", "i")}
    assert {"pml", "btl", "coll", "datatype", "io", "osc"} <= cats, cats
    fences = [e for e in evs if e.get("cat") == "osc"
              and e.get("name") == "fence"]
    assert len(fences) == 8    # two fences on each of four ranks
