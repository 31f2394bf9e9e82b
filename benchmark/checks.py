"""The numbers that decide ``correct``, each against its limit.

Training (the first checked steps of the program against the reference
from the same weights and batches): each step's loss, the norm of each
leaf's first gradient, and the norm of each leaf's change over the
checked steps, taken by the worst leaf as the gap between the two sides'
norms over the reference's norm of that leaf or of the median leaf,
whichever is larger.  A leaf whose reference gradient is under a
thousandth of the median leaf's moves under AdamW by rounding alone and
is left out of the change.

Serving: the widest gap by which a served token's logit lies below the
reference's best logit at that position.
"""

from __future__ import annotations

import math
import statistics

#: a leaf with a reference gradient under this share of the median
#: leaf's is left out of the change
STILL_LEAF = 1e-3


def norm_gap(prog: dict, ref: dict, keys) -> float:
    keys = list(keys)
    med = statistics.median(ref[k] for k in keys)
    worst = 0.0
    for k in keys:
        gap = abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30)
        if not math.isfinite(gap):
            return math.inf
        worst = max(worst, gap)
    return worst


def train_numbers(prog: dict, ref: dict) -> dict:
    """prog, ref: {"losses": [..], "grad_norms": {leaf: ..},
    "change_norms": {leaf: ..}} → the three numbers compared."""
    if len(prog["losses"]) != len(ref["losses"]):
        raise ValueError("the two sides ran different numbers of steps")
    loss = 0.0
    for lp, lr in zip(prog["losses"], ref["losses"]):
        gap = abs(lp - lr) / abs(lr)
        loss = max(loss, gap if math.isfinite(gap) else math.inf)
    grads = ref["grad_norms"]
    med = statistics.median(grads.values())
    moving = [k for k in grads if grads[k] >= STILL_LEAF * med]
    return {"loss_gap": loss,
            "grad_norm_gap": norm_gap(prog["grad_norms"], grads, grads),
            "change_norm_gap": norm_gap(prog["change_norms"],
                                        ref["change_norms"], moving)}


def grad_diff(prog: dict, ref: dict, sizes: dict) -> float:
    """Worst leaf's norm of the difference of the two step-1 gradients,
    over the reference's norm of that leaf or of the median leaf, from
    the same sampled elements of each leaf (``sizes``: each leaf's
    element count, to scale a sample's norms to the whole leaf's)."""
    ps, rs = prog["grad_samples"], ref["grad_samples"]
    diff, norm = {}, {}
    for k, g in rs.items():
        scale = (sizes[k] / g.numel()) ** 0.5
        diff[k] = float((ps[k].to(g.device) - g).norm()) * scale
        norm[k] = float(g.norm()) * scale
    med = statistics.median(norm.values())
    worst = max(diff[k] / max(norm[k], med, 1e-30) for k in rs)
    return worst if math.isfinite(worst) else math.inf


def served_gap(ref_logits, served) -> float:
    """Widest (best − served) reference logit: ref_logits (N, P, V) f32,
    served (N, P) the tokens chosen at those positions."""
    best = ref_logits.max(dim=-1).values
    got = ref_logits.gather(-1, served[..., None].long())[..., 0]
    gap = float((best - got).max())
    return gap if math.isfinite(gap) else math.inf


def verdict(numbers: dict, limits: dict) -> tuple:
    """(correct, {name: {"value", "limit"}}): every number at or under its
    limit; a number without a limit fails."""
    out, ok = {}, True
    for name, value in numbers.items():
        limit = limits.get(name)
        good = (limit is not None and math.isfinite(value)
                and value <= limit)
        ok = ok and good
        out[name] = {"value": value, "limit": limit}
    return ok, out
