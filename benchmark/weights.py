"""The cell's weights, drawn on the device from ``--seed``.

One ``torch.Generator`` a leaf, seeded from (seed, the leaf's place), so
a leaf can be drawn again alone and gives the same values: the harness
hands the same float32 leaves to the program and to the reference, and
draws a leaf again to take a parameter's change after the checked steps.
The scales are those the flagship's published initialisation uses:
embedding and gate N(0, 0.02), a matrix N(0, fan_in^-1/2), the two
residual outputs (``wo``, ``w2``) shrunk by (2L)^-1/2, norm scales one.
"""

from __future__ import annotations

import torch

#: leaf order: a leaf's generator seed depends on its place here
DENSE = ("emb", "wq", "wk", "wv", "wo", "w1", "w2", "ln1", "ln2", "lnf")
MOE = DENSE + ("wg",)


def names(model: dict) -> tuple:
    return MOE if model.get("moe_experts") else DENSE


def shape_and_std(model: dict, name: str):
    """(shape, std) of one leaf; std None for a norm scale (ones)."""
    V, D, L = model["vocab"], model["d_model"], model["n_layers"]
    F, E = model["d_ff"], model.get("moe_experts", 0)
    out_scale = (2 * L) ** -0.5
    table = {
        "emb": ((V, D), 0.02),
        "wq": ((L, D, D), D ** -0.5),
        "wk": ((L, D, D), D ** -0.5),
        "wv": ((L, D, D), D ** -0.5),
        "wo": ((L, D, D), D ** -0.5 * out_scale),
        "ln1": ((L, D), None),
        "ln2": ((L, D), None),
        "lnf": ((D,), None),
    }
    if E:
        table.update(wg=((L, D, E), 0.02), w1=((L, E, D, F), D ** -0.5),
                     w2=((L, E, F, D), F ** -0.5 * out_scale))
    else:
        table.update(w1=((L, D, F), D ** -0.5),
                     w2=((L, F, D), F ** -0.5 * out_scale))
    return table[name]


def leaf_seed(seed: int, name: str, model: dict) -> int:
    return (int(seed) * 1_000_003 + names(model).index(name)) % (2 ** 63)


def leaf(model: dict, seed: int, name: str, device) -> torch.Tensor:
    """One float32 leaf on ``device``, the same for the same seed."""
    shape, std = shape_and_std(model, name)
    if std is None:
        return torch.ones(shape, dtype=torch.float32, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(leaf_seed(seed, name, model))
    out = torch.empty(shape, dtype=torch.float32, device=device)
    return out.normal_(0.0, std, generator=gen)


def make(model: dict, seed: int, device) -> dict:
    """Every leaf, float32, on ``device``."""
    return {n: leaf(model, seed, n, device) for n in names(model)}


def numel(model: dict, name: str) -> int:
    size = 1
    for s in shape_and_std(model, name)[0]:
        size *= s
    return size


def count(model: dict) -> int:
    """Parameters in all the leaves."""
    return sum(numel(model, n) for n in names(model))


def active_count(model: dict) -> int:
    """Parameters a token uses: with top-1 experts, one expert's FFN."""
    E = model.get("moe_experts", 0)
    if not E:
        return count(model)
    L, D, F = model["n_layers"], model["d_model"], model["d_ff"]
    return count(model) - (E - 1) * L * 2 * D * F
