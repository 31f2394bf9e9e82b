"""Faults planted in the program underneath the harness, each a context
manager that patches one function of the port for the block's length.
They show that ``correct`` comes out false when the timed path is
broken (``tests/test_benchmark_faults.py``), and give the readings that
bound a training cell's limits from above (``calibrate.py``).

Training:
- ``state_unchanged``: the optimizer returns zero updates and leaves its
  state as it was, so the step leaves the parameters unchanged;
- ``half_batch``: the step sees only the first half of the batch's rows,
  and the loss is the mean over those;
- ``altered_update``: one leaf's update is doubled where it is made.

Serving:
- ``cache_unchanged``: a cached step's writes to the KV cache are lost;
- ``half_batch``: half of the prompts are not served (their rows come
  back with the prompt and zeros);
- ``altered_token``: the last token of every answer is changed.
"""

from __future__ import annotations

import contextlib

import torch

TRAIN = ("state_unchanged", "half_batch", "altered_update")
DECODE = ("cache_unchanged", "half_batch", "altered_token")


@contextlib.contextmanager
def _patched(owner, attr: str, make):
    orig = getattr(owner, attr) if not isinstance(owner, type) else \
        owner.__dict__[attr]
    setattr(owner, attr, make(orig))
    try:
        yield
    finally:
        setattr(owner, attr, orig)


def planted(kind: str, fault: str):
    """The context manager of ``fault`` for a cell of ``kind``."""
    from ompi_tpu_torch.models import decode, optim, transformer

    if kind == "train" and fault == "state_unchanged":
        def make(orig):
            def update_(self, grads, state, params):
                return {k: torch.zeros_like(p) for k, p in params.items()}, \
                    state
            return update_
        return _patched(optim.AdamW, "update_", make)
    if kind == "train" and fault == "half_batch":
        def make(orig):
            def as_tokens(tokens, device):
                t = orig(tokens, device)
                return t[:max(1, t.shape[0] // 2)]
            return as_tokens
        return _patched(transformer, "as_tokens", make)
    if kind == "train" and fault == "altered_update":
        def make(orig):
            def update_(self, grads, state, params):
                updates, state = orig(self, grads, state, params)
                first = sorted(updates)[0]
                updates[first] = updates[first] * 2
                return updates, state
            return update_
        return _patched(optim.AdamW, "update_", make)
    if kind == "decode" and fault == "cache_unchanged":
        def make(orig):
            def step_layer(cfg, comm, lp, h, kc, vc, pos, positions):
                return orig(cfg, comm, lp, h, kc.clone(), vc.clone(), pos,
                            positions)
            return step_layer
        return _patched(decode, "_step_layer", make)
    if kind == "decode" and fault in ("half_batch", "altered_token"):
        def make(orig):
            def make_decoder(cfg, mesh, max_new, *a, **kw):
                run = orig(cfg, mesh, max_new, *a, **kw)

                def broken(params, prompt):
                    if fault == "altered_token":
                        out = run(params, prompt)
                        out[:, -1] = (out[:, -1] + 1) % cfg.vocab
                        return out
                    half = prompt.shape[0] // 2
                    out = torch.zeros(prompt.shape[0],
                                      prompt.shape[1] + max_new,
                                      dtype=torch.int32, device=prompt.device)
                    out[:, :prompt.shape[1]] = prompt
                    out[:half] = run(params, prompt[:half])
                    return out
                return broken
            return make_decoder
        return _patched(decode, "make_decoder", make)
    raise ValueError(f"no fault {fault!r} for a {kind} cell")
