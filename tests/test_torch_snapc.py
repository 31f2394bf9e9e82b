"""The port's coordinated checkpoint/restart (``ompi_tpu_torch/ckpt/
snapc.py``) and message logging (``ckpt/msglog.py``), held against the JAX
package's.

Each case mirrors one of the snapc and msglog tests of
``tests/ckpt/test_ckpt.py`` with every assertion kept, and runs once per
package (``pkg``) on that package's in-process harness.  The port's store
loads CPU tensors where the JAX package's loads numpy arrays, so a
``restore_fn`` that casts takes each package's leaf type (``to_f64``).
``test_checkpoint_jax_device_arrays`` becomes the torch-tensor cases: CPU
tensors here, and CUDA tensors in a case marked ``gpu``; the async save's
host copy is held to its contract (a leaf updated in place right after
``save`` returns does not reach the snapshot) for numpy arrays, CPU
tensors and, on the card, CUDA tensors.  The last cases write a snapshot
with one package and restart it with the other.
"""

from __future__ import annotations

import importlib
import os
import types

import numpy as np
import pytest

from tests.mpi.harness import run_ranks as jrun
from tests.torch_host_harness import run_ranks as prun


def _torch_f64(t):
    import torch

    return t.to(torch.float64)


def _package(name: str, run, to_f64) -> types.SimpleNamespace:
    mod = lambda m: importlib.import_module(f"{name}.{m}")  # noqa: E731
    ck = mod("ckpt")
    ns = types.SimpleNamespace(
        name=name, run=run, to_f64=to_f64, snapc=mod("ckpt.snapc"),
        const=mod("mpi.constants"),
        ckpt=types.SimpleNamespace(
            SnapshotStore=ck.SnapshotStore, checkpoint=ck.checkpoint,
            restart=ck.restart, CheckpointManager=ck.CheckpointManager,
            MessageLog=ck.MessageLog,
            EventLog=mod("ckpt.msglog").EventLog))
    return ns


JAX = _package("ompi_tpu", jrun, lambda a: a.astype(np.float64))
TORCH = _package("ompi_tpu_torch", prun, _torch_f64)


@pytest.fixture(params=[JAX, TORCH], ids=["ompi_tpu", "ompi_tpu_torch"])
def pkg(request):
    return request.param


# ---------------------------------------------------------------------------
# coordinated checkpoint/restart (multi-rank)
# ---------------------------------------------------------------------------

def test_checkpoint_restart_roundtrip(pkg, tmp_path):
    base = str(tmp_path)

    def body(comm):
        st = pkg.ckpt.SnapshotStore(base)
        state = {"w": np.arange(8.0) + comm.rank * 10,
                 "step": np.int64(3)}
        seq = pkg.ckpt.checkpoint(comm, st, state)
        got_seq, got = pkg.ckpt.restart(comm, st)
        return seq, got_seq, got

    for r, (seq, got_seq, got) in enumerate(pkg.run(3, body)):
        assert seq == got_seq == 0
        np.testing.assert_array_equal(got["w"], np.arange(8.0) + r * 10)
        assert int(got["step"]) == 3


def test_checkpoint_seq_advances_and_keep_last(pkg, tmp_path):
    base = str(tmp_path)

    def body(comm):
        st = pkg.ckpt.SnapshotStore(base)
        for i in range(3):
            pkg.ckpt.checkpoint(comm, st, {"x": np.full(2, i)},
                            keep_last=2)
        comm.barrier()
        return st.snapshots()

    for snaps in pkg.run(2, body):
        assert snaps == [1, 2]


def test_checkpoint_failure_is_collective(pkg, tmp_path):
    """If one rank can't write, NO rank commits (all-or-nothing)."""
    base = str(tmp_path)

    class BrokenStore(pkg.ckpt.SnapshotStore):
        def write_rank(self, seq, rank, state):
            if rank == 1:
                raise OSError("disk full")
            return super().write_rank(seq, rank, state)

    def body(comm):
        st = BrokenStore(base)
        try:
            pkg.ckpt.checkpoint(comm, st, {"x": np.zeros(1)})
        except pkg.const.MPIException:
            return st.latest()
        return "no-raise"

    assert pkg.run(2, body) == [None, None]


def test_commit_failure_raises_on_all_ranks(pkg, tmp_path):
    """rank 0's commit throwing must not strand peers in a barrier —
    everyone gets the pkg.const.MPIException (regression)."""
    base = str(tmp_path)

    class CommitBroken(pkg.ckpt.SnapshotStore):
        def commit(self, seq, nranks, extra=None):
            raise OSError("metadata write failed")

    def body(comm):
        st = CommitBroken(base)
        try:
            pkg.ckpt.checkpoint(comm, st, {"x": np.zeros(1)})
        except pkg.const.MPIException as e:
            return "commit failed" in str(e)
        return False

    assert all(pkg.run(3, body, timeout=20.0))


def test_restart_with_restore_fn(pkg, tmp_path):
    base = str(tmp_path)

    def body(comm):
        st = pkg.ckpt.SnapshotStore(base)
        pkg.ckpt.checkpoint(comm, st, {"w": np.arange(4, dtype=np.float32)})
        _, got = pkg.ckpt.restart(
            comm, st,
            restore_fn=lambda name, arr: pkg.to_f64(arr) * 2)
        return np.asarray(got["w"])

    for w in pkg.run(2, body):
        assert w.dtype == np.float64
        np.testing.assert_array_equal(w, np.arange(4.0) * 2)


def test_restart_no_snapshot_raises(pkg, tmp_path):
    base = str(tmp_path)

    def body(comm):
        st = pkg.ckpt.SnapshotStore(base)
        try:
            pkg.ckpt.restart(comm, st)
        except pkg.const.MPIException:
            return True
        return False

    assert all(pkg.run(2, body))


# ---------------------------------------------------------------------------
# manager (interval policy + async)
# ---------------------------------------------------------------------------

def test_manager_interval_policy(pkg, tmp_path):
    base = str(tmp_path)

    def body(comm):
        st = pkg.ckpt.SnapshotStore(base)
        mgr = pkg.ckpt.CheckpointManager(comm, st, interval=2, keep_last=10)
        taken = []
        for step in range(5):
            seq = mgr.maybe_checkpoint(step, {"s": np.int64(step)})
            if seq is not None:
                taken.append(seq)
        mgr.wait()
        return taken, st.snapshots()

    for taken, snaps in pkg.run(2, body):
        assert taken == [0, 2, 4]
        assert snaps == [0, 2, 4]


def test_manager_async_save_and_restore(pkg, tmp_path):
    base = str(tmp_path)

    def body(comm):
        st = pkg.ckpt.SnapshotStore(base)
        mgr = pkg.ckpt.CheckpointManager(comm, st, interval=1, keep_last=5,
                                     async_save=True)
        state = {"w": np.arange(6.0) + comm.rank}
        mgr.save(0, state)
        state["w"] += 100          # mutate right after: snapshot is a copy
        # application traffic while the save is in flight must not
        # cross-match the checkpoint collectives (private dup'd comm)
        comm.allreduce(np.ones(4))
        mgr.wait()
        _, got = mgr.restore()
        return got["w"]

    for r, w in enumerate(pkg.run(2, body)):
        np.testing.assert_array_equal(w, np.arange(6.0) + r)


def test_manager_auto_restore_rank_override(pkg, tmp_path, monkeypatch):
    """The manager wrapper forwards ``auto_restore``'s per-rank-store
    rank override: apps keying one store PER rank write their shard
    under rank key 0 (the selfheal/chaos recipe), so the wrapper must
    not hard-code ``comm.rank`` for the lookup."""
    snapc = pkg.snapc

    base = str(tmp_path)
    monkeypatch.setattr(snapc, "restart_incarnation", lambda: 1)

    def body(comm):
        st = pkg.ckpt.SnapshotStore(os.path.join(base, f"rank{comm.rank}"))
        mgr = pkg.ckpt.CheckpointManager(comm, st, interval=1)
        st.write_rank(5, 0, {"acc": np.float64(comm.rank + 41.0)})
        st.commit(5, nranks=1)
        seq, state = mgr.auto_restore(rank=0)
        return seq, float(state["acc"])

    for r, (seq, acc) in enumerate(pkg.run(2, body)):
        assert seq == 5
        assert acc == r + 41.0


# ---------------------------------------------------------------------------
# message logging (vprotocol building block)
# ---------------------------------------------------------------------------

def test_msglog_records_and_marks(pkg):
    def body(comm):
        with pkg.ckpt.MessageLog(comm) as log:
            peer = (comm.rank + 1) % comm.size
            rr = comm.irecv(source=(comm.rank - 1) % comm.size, tag=5)
            comm.send(np.full(3, comm.rank), dest=peer, tag=5)
            rr.wait()
            n_before = len(log.pending())
            log.mark()
            n_after = len(log.pending())
            comm.barrier()             # internal tags: never logged
            return n_before, n_after, len(log.pending())

    for before, after, coll in pkg.run(2, body):
        assert before == 1 and after == 0 and coll == 0


def test_msglog_replay_redelivers(pkg):
    def body(comm):
        log = pkg.ckpt.MessageLog(comm).attach()
        try:
            if comm.rank == 0:
                comm.send(np.array([1.0, 2.0]), dest=1, tag=9)
                comm.send(np.array([3.0]), dest=1, tag=9)
                comm.barrier()
                # "rank 1 restarted and lost them" → replay
                n = log.replay(to_rank=1)
                comm.barrier()
                return n
            first = comm.recv(source=0, tag=9)
            second = comm.recv(source=0, tag=9)
            comm.barrier()
            re1 = comm.recv(source=0, tag=9)
            re2 = comm.recv(source=0, tag=9)
            comm.barrier()
            np.testing.assert_array_equal(first, re1)
            np.testing.assert_array_equal(second, re2)
            return (first, second)
        finally:
            log.detach()

    res = pkg.run(2, body)
    assert res[0] == 2


def test_msglog_byte_cap_evicts_oldest_and_blocks_replay(pkg):
    def body(comm):
        if comm.rank == 0:
            log = pkg.ckpt.MessageLog(comm, max_bytes=100).attach()
            try:
                for i in range(5):
                    comm.send(np.full(5, i), dest=1, tag=2)  # 40 B each
                pend = log.pending()
                try:
                    log.replay(to_rank=1)   # incomplete → must refuse
                except pkg.const.MPIException:
                    refused = True
                else:
                    refused = False
                vals = [int(p[2][0]) for p in pend]
                nbytes = log.nbytes
                log.mark()
                return (vals, nbytes, True, refused, log.complete)
            finally:
                log.detach()
        for _ in range(5):
            comm.recv(source=0, tag=2)
        return None

    vals, nbytes, _, refused, marked = pkg.run(2, body)[0]
    assert vals == [3, 4] and nbytes == 80
    assert refused            # partial replay is an error, not silence
    assert marked             # mark() resets completeness


def test_msglog_failed_send_not_logged(pkg):
    def body(comm):
        if comm.rank != 0:
            return None
        log = pkg.ckpt.MessageLog(comm).attach()
        try:
            try:
                comm.isend(np.zeros(1), dest=99, tag=1)   # bad dest
            except pkg.const.MPIException:
                pass
            return len(log.pending())
        finally:
            log.detach()

    assert pkg.run(2, body)[0] == 0


def test_event_log_records_wildcard_order(pkg):
    EventLog = pkg.ckpt.EventLog
    ANY_SOURCE, ANY_TAG = pkg.const.ANY_SOURCE, pkg.const.ANY_TAG

    def body(comm):
        if comm.rank == 0:
            with EventLog(comm) as ev:
                a = comm.recv(source=ANY_SOURCE, tag=ANY_TAG)   # ANY_SOURCE/ANY_TAG
                b = comm.recv(source=ANY_SOURCE, tag=ANY_TAG)
                order = ev.events()
            assert len(order) == 2
            assert {o[0] for o in order} == {1, 2}
            # recorded order matches payload arrival order
            assert int(a[0]) == order[0][0] and int(b[0]) == order[1][0]
            return order
        else:
            import time
            time.sleep(0.02 * comm.rank)           # stagger arrivals
            comm.send(np.array([comm.rank]), dest=0, tag=comm.rank)
        return None

    order = pkg.run(3, body)[0]
    assert order is not None


def test_event_log_replay_forces_recorded_order(pkg):
    EventLog = pkg.ckpt.EventLog
    ANY_SOURCE, ANY_TAG = pkg.const.ANY_SOURCE, pkg.const.ANY_TAG

    recorded = [(2, 7), (1, 7)]                    # 2 first, then 1

    def body(comm):
        if comm.rank == 0:
            with EventLog(comm, replay=recorded) as ev:
                assert ev.replaying
                a = comm.recv(source=ANY_SOURCE, tag=ANY_TAG)   # rewritten → (2, 7)
                b = comm.recv(source=ANY_SOURCE, tag=ANY_TAG)   # rewritten → (1, 7)
                assert not ev.replaying
            # forced order 2-then-1 even though rank 1 sent FIRST
            return int(a[0]), int(b[0])
        else:
            import time
            if comm.rank == 2:
                time.sleep(0.05)                   # 1 races ahead of 2
            comm.send(np.array([comm.rank]), dest=0, tag=7)
        return None

    assert pkg.run(3, body)[0] == (2, 1)


def test_event_log_incomplete_history_raises(pkg):
    EventLog = pkg.ckpt.EventLog
    ANY_SOURCE, ANY_TAG = pkg.const.ANY_SOURCE, pkg.const.ANY_TAG
    MPIException = pkg.const.MPIException

    def body(comm):
        if comm.rank == 0:
            ev = EventLog(comm).attach()
            req = comm.irecv(source=ANY_SOURCE, tag=ANY_TAG)    # never completes yet
            try:
                with pytest.raises(pkg.const.MPIException):
                    ev.events()
            finally:
                comm.send(np.array([0.0]), dest=0, tag=3)  # self-satisfy
                req.wait()
                ev.detach()
        comm.barrier()
        return True

    assert all(pkg.run(2, body))


# ---------------------------------------------------------------------------
# torch tensors (the port's counterpart of the JAX device-array case)
# ---------------------------------------------------------------------------

def _tensor_roundtrip(base, device):
    import torch

    from ompi_tpu_torch import ckpt as pckpt

    def body(comm):
        st = pckpt.SnapshotStore(base)
        w = torch.arange(8.0, device=device) * (comm.rank + 1)
        bf = (torch.arange(4.0, device=device) / 3).to(torch.bfloat16)
        pckpt.checkpoint(comm, st, {"w": w, "bf": bf})
        _, got = pckpt.restart(
            comm, st, restore_fn=lambda name, t: t.to(device))
        assert got["w"].device.type == torch.device(device).type
        assert got["bf"].dtype == torch.bfloat16
        assert torch.equal(got["bf"].view(torch.int16),
                           bf.view(torch.int16))
        return got["w"].cpu().numpy()

    for r, w in enumerate(prun(2, body)):
        np.testing.assert_array_equal(w, np.arange(8.0) * (r + 1))


def test_checkpoint_torch_cpu_tensors(tmp_path):
    """Tensors are pulled to host on save and re-placed on restore."""
    _tensor_roundtrip(str(tmp_path), "cpu")


@pytest.mark.gpu
def test_checkpoint_torch_cuda_tensors(tmp_path):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    _tensor_roundtrip(str(tmp_path), "cuda")


def _async_copy_is_taken_at_save(base, make, bump):
    from ompi_tpu_torch import ckpt as pckpt

    def body(comm):
        st = pckpt.SnapshotStore(base)
        mgr = pckpt.CheckpointManager(comm, st, interval=1, keep_last=3,
                                      async_save=True)
        leaf = make(comm.rank)
        mgr.save(0, {"w": leaf})
        bump(leaf)             # an in-place update right after save
        mgr.save(1, {"w": leaf})
        bump(leaf)
        mgr.wait()
        _, s0 = pckpt.restart(comm, st, seq=0)
        _, s1 = pckpt.restart(comm, st, seq=1)
        return np.asarray(s0["w"]), np.asarray(s1["w"])

    for r, (w0, w1) in enumerate(prun(2, body)):
        np.testing.assert_array_equal(w0, np.arange(6.0) + r)
        np.testing.assert_array_equal(w1, np.arange(6.0) + r + 100)


def _numpy_leaf(rank):
    return np.arange(6.0) + rank


def _bump(leaf):
    leaf += 100


@pytest.mark.parametrize("kind", ["numpy", "cpu_tensor"])
def test_async_save_copies_every_leaf_before_returning(tmp_path, kind):
    def tensor(rank):
        import torch

        return torch.arange(6.0, dtype=torch.float64) + rank

    make = _numpy_leaf if kind == "numpy" else tensor
    _async_copy_is_taken_at_save(str(tmp_path), make, _bump)


@pytest.mark.gpu
def test_async_save_copies_cuda_leaves_before_returning(tmp_path):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")

    def make(rank):
        return torch.arange(6.0, dtype=torch.float64,
                            device="cuda") + rank

    def bump(leaf):
        leaf.add_(100)   # on the card, as AdamW's update_ is

    _async_copy_is_taken_at_save(str(tmp_path), make, bump)


# ---------------------------------------------------------------------------
# across packages: a snapshot written by one restarts in the other
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("writer,reader", [(JAX, TORCH), (TORCH, JAX)],
                         ids=["jax_to_torch", "torch_to_jax"])
def test_snapshot_restarts_in_the_other_package(tmp_path, writer, reader):
    base = str(tmp_path)

    def save(comm):
        st = writer.ckpt.SnapshotStore(base)
        return writer.ckpt.checkpoint(
            comm, st, {"w": np.arange(5.0) * (comm.rank + 2),
                       "step": np.int64(9)})

    def load(comm):
        st = reader.ckpt.SnapshotStore(base)
        seq, got = reader.ckpt.restart(comm, st)
        return seq, np.asarray(got["w"]).tolist(), int(got["step"])

    assert writer.run(2, save) == [0, 0]
    assert reader.run(2, load) == [
        (0, (np.arange(5.0) * (r + 2)).tolist(), 9) for r in range(2)]


# ---------------------------------------------------------------------------
# a revived life's training state, restored onto its device
# ---------------------------------------------------------------------------

def _revived_training_resume(tmp_path, monkeypatch, device):
    """Two steps, an async snapshot through the manager, two more steps
    (the uninterrupted reference); then, as a revived life, the manager's
    ``auto_restore`` with a ``restore_fn`` that places each leaf on
    ``device``, ``from_train_state`` of those leaves, and the same two
    steps: every param and moment equal the reference's bit for bit."""
    import torch

    from ompi_tpu_torch import ckpt as pckpt
    from ompi_tpu_torch.ckpt import snapc
    from ompi_tpu_torch.models import transformer as T
    from ompi_tpu_torch.models.weights import (from_jax_params,
                                               from_train_state, train_state)
    from ompi_tpu_torch.parallel.mesh import make_mesh

    cfg = T.TransformerConfig(vocab=64, d_model=32, n_heads=4, n_layers=2,
                              d_ff=64, seq=16)
    rng = np.random.default_rng(3)
    toks = [rng.integers(0, 64, size=(2, 16)).astype(np.int32)
            for _ in range(4)]

    def body(comm):
        mesh = make_mesh({"dp": 1, "sp": 1, "tp": 1}, device=device)
        step, init = T.make_train_step(cfg, mesh, lr=1e-2)
        params = from_jax_params(T.init_params(cfg, seed=1), cfg, device,
                                 train=True, mesh=mesh)
        state = init(params)
        st = pckpt.SnapshotStore(str(tmp_path))
        mgr = pckpt.CheckpointManager(comm, st, interval=2,
                                      async_save=True)
        for t in toks[:2]:
            params, state, _ = step(params, state, t)
        mgr.save(2, train_state(params, state, cfg, mesh=mesh))
        for t in toks[2:]:
            params, state, _ = step(params, state, t)
        mgr.wait()
        monkeypatch.setattr(snapc, "restart_incarnation", lambda: 1)
        seq, blobs = mgr.auto_restore(restore_fn=lambda k, t: t.to(device))
        assert seq == 2
        assert all(v.device.type == torch.device(device).type
                   for v in blobs.values())
        p2, s2 = from_train_state(blobs, cfg, device, mesh=mesh)
        assert int(s2.count) == 2
        for t in toks[2:]:
            p2, s2, _ = step(p2, s2, t)
        for k in params:
            assert torch.equal(p2[k], params[k]), k
            assert torch.equal(s2.mu[k], state.mu[k]), k
            assert torch.equal(s2.nu[k], state.nu[k]), k
        return True

    assert prun(1, body) == [True]


def test_revived_training_resumes_bitwise_from_cpu_leaves(tmp_path,
                                                          monkeypatch):
    _revived_training_resume(tmp_path, monkeypatch, "cpu")


@pytest.mark.gpu
def test_revived_training_resumes_bitwise_from_card_leaves(tmp_path,
                                                           monkeypatch):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    _revived_training_resume(tmp_path, monkeypatch, "cuda")
