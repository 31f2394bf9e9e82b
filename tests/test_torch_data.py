"""The port's input pipeline (ompi_tpu_torch.models.data) against the JAX
package's (ompi_tpu.models.data), on the CPU.

Batches are compared bit for bit: both packages slice the same (seed,
step) windows out of the same corpus.  The prefetch tests mirror
tests/parallel/test_data.py: order, error forwarding, and release of
the worker thread on an early close or a close before the first next.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import pytest
import torch

from ompi_tpu.models import data as J
from ompi_tpu_torch.models import data as D
from ompi_tpu_torch.parallel.mesh import make_mesh


def _corpus(n=5000, vocab=251):
    # the corpus examples/train.py trains on
    return (np.arange(n) * 2654435761 % vocab).astype(np.int32)


def _tmesh():
    return make_mesh({"dp": 1, "sp": 1, "tp": 1}, device="cpu")


@pytest.mark.parametrize("seed,step,batch,seq", [(0, 0, 4, 16),
                                                 (3, 5, 2, 33),
                                                 (9, 123, 8, 64)])
def test_array_source_bit_equal_to_jax(seed, step, batch, seq):
    toks = _corpus()
    got = D.ArraySource(toks, seed=seed).batch(step, batch, seq)
    want = J.ArraySource(toks, seed=seed).batch(step, batch, seq)
    assert got.dtype == np.int32 and got.shape == (batch, seq)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", [np.uint16, np.int32])
def test_memmap_source_bit_equal_to_jax(tmp_path, dtype):
    toks = _corpus().astype(dtype)
    path = tmp_path / "corpus.bin"
    toks.tofile(path)
    got = D.MemmapSource(str(path), dtype=dtype, seed=1)
    want = J.MemmapSource(str(path), dtype=dtype, seed=1)
    assert isinstance(got.tokens, np.memmap)
    for step in (0, 7):
        np.testing.assert_array_equal(got.batch(step, 3, 32),
                                      want.batch(step, 3, 32))
    np.testing.assert_array_equal(
        got.batch(7, 3, 32), D.ArraySource(toks, seed=1).batch(7, 3, 32))


def test_sources_refuse_too_few_tokens(tmp_path):
    with pytest.raises(ValueError, match="at least 2"):
        D.ArraySource(np.zeros(1, np.int32))
    path = tmp_path / "one.bin"
    np.zeros(1, np.uint16).tofile(path)
    with pytest.raises(ValueError, match="too few tokens"):
        D.MemmapSource(str(path))


def test_batches_equal_jax_stream():
    toks = _corpus()
    got = D.batches(D.ArraySource(toks, seed=2), 2, 8, start_step=4)
    want = J.batches(J.ArraySource(toks, seed=2), 2, 8, start_step=4)
    for _ in range(5):
        np.testing.assert_array_equal(next(got), next(want))


def test_resume_reproduces_stream():
    """examples/train.py:59-66: a stream restarted at the checkpointed
    step gives the batch the live stream gives at that step."""
    src = D.ArraySource(_corpus(), seed=0)
    half = 3
    resumed = D.train_stream(src, _tmesh(), 4, 32, start_step=half)
    live = D.train_stream(src, _tmesh(), 4, 32)
    for _ in range(half + 1):
        ref = next(live)
    torch.testing.assert_close(next(resumed), ref, rtol=0, atol=0)
    resumed.close()
    live.close()


def test_train_stream_order_dtype_and_device():
    src = D.ArraySource(_corpus(), seed=0)
    stream = D.train_stream(src, _tmesh(), batch=8, seq=32)
    for step in range(3):
        got = next(stream)
        assert isinstance(got, torch.Tensor)
        assert got.dtype == torch.int32 and got.device.type == "cpu"
        np.testing.assert_array_equal(got.numpy(),
                                      J.ArraySource(_corpus(), seed=0)
                                      .batch(step, 8, 32))
    stream.close()


def test_prefetch_ends_cleanly_on_a_finite_source():
    items = [np.full((2, 4), i, np.int32) for i in range(3)]
    got = list(D.prefetch(iter(items), _tmesh()))
    assert [int(t[0, 0]) for t in got] == [0, 1, 2]


def test_prefetch_propagates_source_errors():
    """A failing source must raise at the consumer, not end the stream."""
    def bad():
        yield np.zeros((2, 4), np.int32)
        raise RuntimeError("corpus went away")

    stream = D.prefetch(bad(), _tmesh())
    next(stream)
    with pytest.raises(RuntimeError, match="corpus went away"):
        next(stream)


def _wait_for_threads(before, timeout=5.0):
    deadline = time.time() + timeout
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.05)
    return threading.active_count() <= before


def test_prefetch_releases_worker_on_early_abandon():
    produced = []

    def endless():
        i = 0
        while True:
            produced.append(i)
            yield np.full((2, 4), i, np.int32)
            i += 1

    before = threading.active_count()
    stream = D.prefetch(endless(), _tmesh(), depth=2)
    next(stream)
    stream.close()
    assert _wait_for_threads(before), "prefetch worker still alive"
    n = len(produced)
    time.sleep(0.3)
    assert len(produced) == n


def test_prefetch_close_before_first_next_releases_worker():
    def endless():
        while True:
            yield np.zeros((2, 4), np.int32)

    before = threading.active_count()
    stream = D.prefetch(endless(), _tmesh(), depth=2)
    stream.close()
    assert _wait_for_threads(before)
    with pytest.raises(StopIteration):
        next(stream)

