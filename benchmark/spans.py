"""Spans that the harness opens around the program's entry functions, in
a traced run only: ``record_function("bench.<span>")`` around the
function, installed in the module that calls it and removed afterwards.
No file of the program changes.  Each call also appends its arguments'
shapes to ``records[<span>]``, from which the readers count the work.
"""

from __future__ import annotations

import contextlib
import functools
import importlib

import torch

#: span → (module whose attribute the callers look up, attribute path)
TARGETS = {
    "attention": ("ompi_tpu_torch.parallel.attention", "local_attention"),
    "optimizer": ("ompi_tpu_torch.models.optim", "AdamW.update_"),
    "moe": ("ompi_tpu_torch.models.transformer", "switch_moe"),
    "prefill": ("ompi_tpu_torch.models.transformer", "_local_backbone"),
    "step_layer": ("ompi_tpu_torch.models.decode", "_step_layer"),
}


def _shapes(args) -> list:
    return [tuple(a.shape) if isinstance(a, torch.Tensor) else None
            for a in args]


def _wrap(span: str, fn, records: dict):
    name = "bench." + span
    calls = records.setdefault(span, [])

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        first = next((a for a in args if isinstance(a, torch.Tensor)), None)
        calls.append({"shapes": _shapes(args),
                      "causal": bool(kwargs.get("causal", True)),
                      "itemsize": first.element_size() if first is not None
                      else None})
        with torch.profiler.record_function(name):
            return fn(*args, **kwargs)

    return wrapper


@contextlib.contextmanager
def installed(spans, records: dict):
    """Within the block each named span wraps its target; ``records``
    gathers the calls."""
    undo = []
    try:
        for span in spans:
            module, path = TARGETS[span]
            owner = importlib.import_module(module)
            *outer, attr = path.split(".")
            for part in outer:
                owner = getattr(owner, part)
            fn = owner.__dict__[attr] if isinstance(owner, type) else getattr(
                owner, attr)
            setattr(owner, attr, _wrap(span, fn, records))
            undo.append((owner, attr, fn))
        yield records
    finally:
        for owner, attr, fn in reversed(undo):
            setattr(owner, attr, fn)
