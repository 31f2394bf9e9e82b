"""Input pipeline: token batches onto the device, prefetched.

The port of ``ompi_tpu.models.data``:

- :class:`TokenSource` readers: an in-memory array, or a memory-mapped
  token file (the flat uint16/int32 next-token-prediction corpus layout),
  sliced into (batch, seq) windows deterministically by (seed, step), so
  the batches are bit-equal to the JAX package's and resuming from a
  checkpoint's step counter reproduces the exact stream;
- :func:`prefetch`: a daemon thread that copies the NEXT batch to the
  device (pinned host memory, ``non_blocking``) while the current step
  computes, keeping up to ``depth`` batches in flight; a source error is
  raised at the consumer, and ``close`` (also before the first ``next``)
  releases the thread and drops the buffered batches.  The consumer's
  wait for a batch is the model span ``data.wait``.

Over a mesh of ranks every rank slices the same deterministic global
batch and keeps its block, with no coordination: rank (d, s) takes rows
[d·b/dp, (d+1)·b/dp) and columns [s·S/sp, (s+1)·S/sp), the (B/dp, S/sp)
token shard the training entry points take (``transformer.shard_tokens``,
the JAX package's ``P("dp", "sp")`` block).
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Iterator

import numpy as np
import torch

from ompi_tpu_torch.models.transformer import shard_tokens
from ompi_tpu_torch.mpi import trace

__all__ = ["TokenSource", "ArraySource", "MemmapSource", "prefetch",
           "batches", "train_stream"]


class TokenSource:
    """Deterministic (seed, step) → (batch, seq) int32 token windows."""

    def batch(self, step: int, batch: int, seq: int) -> np.ndarray:
        raise NotImplementedError


class ArraySource(TokenSource):
    """Windows over an in-memory 1-D token array (wraps around)."""

    def __init__(self, tokens: np.ndarray, seed: int = 0):
        self.tokens = np.ascontiguousarray(tokens.reshape(-1))
        if self.tokens.size < 2:
            raise ValueError("need at least 2 tokens")
        self.seed = seed

    def batch(self, step: int, batch: int, seq: int) -> np.ndarray:
        n = self.tokens.size
        rng = np.random.default_rng((self.seed, step))
        starts = rng.integers(0, n, size=batch)
        idx = (starts[:, None] + np.arange(seq)[None, :]) % n
        return self.tokens[idx].astype(np.int32)


class MemmapSource(ArraySource):
    """Windows over a flat binary token file via np.memmap: the corpus
    never loads into RAM; the page cache serves the hot windows."""

    def __init__(self, path: str, dtype=np.uint16, seed: int = 0):
        size = os.path.getsize(path) // np.dtype(dtype).itemsize
        if size < 2:
            raise ValueError(f"{path}: too few tokens ({size})")
        self.tokens = np.memmap(path, dtype=dtype, mode="r", shape=(size,))
        self.seed = seed


def batches(source: TokenSource, batch: int, seq: int,
            start_step: int = 0) -> Iterator[np.ndarray]:
    """Endless deterministic batch stream from ``start_step``."""
    step = start_step
    while True:
        yield source.batch(step, batch, seq)
        step += 1


def prefetch(it: Iterator[np.ndarray], mesh=None, depth: int = 2):
    """Double-buffered device prefetch onto ``mesh.device`` (the card
    when no mesh is given): yields int32 tensors in order."""
    from ompi_tpu_torch.parallel.mesh import resolve_device

    dev = resolve_device(mesh.device if mesh is not None else "cuda")
    q: queue.Queue = queue.Queue(maxsize=depth)
    stop = object()
    closed = threading.Event()

    def put(item) -> bool:
        # a consumer that abandons the stream stops draining; poll against
        # the closed flag so the worker exits instead of blocking forever
        # with ``depth`` device batches pinned
        while not closed.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def to_device(host_batch: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(host_batch))
        if dev.type == "cuda":
            return t.pin_memory().to(dev, non_blocking=True)
        return t.to(dev)

    def worker() -> None:
        try:
            for host_batch in it:
                if not put(to_device(host_batch)):
                    return
            put(stop)
        except BaseException as e:  # noqa: BLE001 — must reach consumer
            # a swallowed source/transfer error would read as a clean end
            # of stream; re-raise it on the consumer thread instead
            put(e)

    t = threading.Thread(target=worker, daemon=True,
                         name="ompi-tpu-torch-prefetch")
    t.start()

    class _PrefetchIter:
        """An iterator, not a generator: ``close`` must release the worker
        even before the first ``next`` or via GC (a generator's finally
        never runs if it was never started)."""

        def __iter__(self):
            return self

        def __next__(self):
            if closed.is_set():
                raise StopIteration
            # the consumer's wait, on its own thread: a profiler sees no
            # span the worker opens (it started before the profiler)
            with trace.model_span("data.wait"):
                item = q.get()
            if item is stop:
                self.close()
                raise StopIteration
            if isinstance(item, BaseException):
                self.close()
                raise item
            return item

        def close(self, _empty=queue.Empty) -> None:
            # queue.Empty is bound at definition time: __del__ may run at
            # interpreter shutdown after module globals are cleared
            closed.set()

            def drain() -> None:
                try:
                    while True:
                        q.get_nowait()
                except _empty:
                    pass

            drain()
            # a worker mid-put slips one item past the first drain; wait
            # for it to see `closed` and drain again
            t.join(timeout=2.0)
            drain()

        __del__ = close

    return _PrefetchIter()


def train_stream(source: TokenSource, mesh, batch: int, seq: int,
                 start_step: int = 0, depth: int = 2):
    """Deterministic global batches → this rank's (batch/dp, seq/sp)
    shard → device prefetch, in one call (resume by passing the
    checkpointed step)."""
    shards = (shard_tokens(b, mesh)
              for b in batches(source, batch, seq, start_step))
    return prefetch(shards, mesh, depth=depth)
