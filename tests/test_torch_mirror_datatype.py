"""The JAX package's own datatype test bodies run on the port
(``tests/torch_mirror.py``: the same bytecode, every assertion kept).

``tests/mpi/test_datatype.py`` (the constructors, pack/unpack, the
descriptor), ``test_pack_plan.py`` (the run-coalescing plans, their
cache, the native convertor and the numpy fallback) and
``test_datatype_fuzz.py`` (random types packed and unpacked, and sent
packed through the PML) run once on each package; the cases that run
ranks must give equal results on both, bit for bit.
``test_plan_cache_keeps_commit_warmed_plan`` holds the port's plan cache
to the reference's eviction: one entry at a time, never the ``count = 1``
plan ``commit()`` compiled.
"""

from __future__ import annotations

import pytest

import tests.mpi.test_datatype as ref_datatype
import tests.mpi.test_datatype_fuzz as ref_fuzz
import tests.mpi.test_pack_plan as ref_plan
from tests.torch_mirror import both_case, cases


@pytest.mark.parametrize("name,params", cases(ref_datatype))
def test_datatype_case_equals_the_jax_package(name, params, request):
    both_case(ref_datatype, name, params, request)


@pytest.mark.parametrize("name,params", cases(ref_plan))
def test_pack_plan_case_equals_the_jax_package(name, params, request):
    both_case(ref_plan, name, params, request)


@pytest.mark.parametrize("name,params", cases(ref_fuzz))
def test_datatype_fuzz_case_equals_the_jax_package(name, params, request):
    both_case(ref_fuzz, name, params, request)


@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
def test_items_plan_moves_the_jax_packages_bytes(native, monkeypatch):
    """A plan past the expansion cap walks one item's runs ``count``
    times (the ``"items"`` kind the port lacked), through the compiled
    walk at a payload above ``_NATIVE_MIN_BYTES`` and through numpy; the
    packed bytes and the unpacked buffer are the JAX package's."""
    import numpy as np

    from ompi_tpu.mpi import datatype as jdt
    from ompi_tpu_torch.mpi import datatype as pdt

    monkeypatch.setattr(jdt, "_PLAN_EXPAND_CAP", 4)
    monkeypatch.setattr(pdt, "_PLAN_EXPAND_CAP", 4)
    if not native:
        monkeypatch.setattr(pdt, "_native_convertor", lambda n: None)
    count = 64
    j = jdt.INT32.indexed([1, 2, 1], [6, 0, 3]).commit()
    p = pdt.INT32.indexed([1, 2, 1], [6, 0, 3]).commit()
    plan = p.pack_plan(count)
    assert plan.kind == j.pack_plan(count).kind == "items"
    assert plan.total >= pdt._NATIVE_MIN_BYTES
    assert (pdt._native_convertor(plan.total) is not None) == (
        native and pdt._native_convertor(1 << 20) is not None)
    rng = np.random.default_rng(5)
    src = rng.integers(0, 256, pdt.min_span(p, count)).astype(np.uint8)
    packed = p.pack(src, count)
    assert packed == j.pack(src, count)
    dst_p = rng.integers(0, 256, len(src)).astype(np.uint8)
    dst_j = dst_p.copy()
    p.unpack(packed, dst_p, count)
    j.unpack(packed, dst_j, count)
    np.testing.assert_array_equal(dst_p, dst_j)
