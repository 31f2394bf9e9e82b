"""Checker registry.

Each checker is ``run(index) -> list[Finding]`` plus a stable exit-code
bit.  The driver ORs the bits of every checker that produced
non-grandfathered findings, so a CI log's exit status names the broken
invariant family.
"""

from __future__ import annotations

from typing import Callable

from ompi_tpu_torch.tools.lint.finding import Finding
from ompi_tpu_torch.tools.lint.index import ProjectIndex

from ompi_tpu_torch.tools.lint.checkers import (frame_op, lock_order, pmix_rpc,
                                 pvar_spec, reader_thread, rml_tag,
                                 span_pairing, var_registry)

#: name → (exit-code bit, run function)
ALL: dict[str, tuple[int, Callable[[ProjectIndex], list[Finding]]]] = {
    "var-registry": (1, var_registry.run),
    "pvar-spec": (2, pvar_spec.run),
    "rml-tag": (4, rml_tag.run),
    "frame-op": (8, frame_op.run),
    "pmix-rpc": (16, pmix_rpc.run),
    "reader-thread": (32, reader_thread.run),
    "lock-order": (64, lock_order.run),
    "span-pairing": (256, span_pairing.run),
}

#: the mypy gate owns the remaining bit (see ompi_tpu_torch.tools.lint.driver)
MYPY_BIT = 128
