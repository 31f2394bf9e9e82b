"""The yardstick's arithmetic: the chips' peaks, and the operations and
bytes of the work, counted from shapes.

Peaks are NVIDIA's data sheet for the H100 SXM part at its 700 W limit:
989e12 dense bf16 FLOP/s on the tensor cores, 3.35e12 HBM bytes/s.  A
card of another name has no peak here, and a share of a peak is then
not reported.
"""

from __future__ import annotations

from typing import Optional

from benchmark import weights

#: (fragment of the card's name, dense bf16 FLOP/s, HBM bytes/s)
PEAKS = (("H100", 989e12, 3.35e12),)


def peaks(kind: str) -> Optional[tuple]:
    """(FLOP/s, bytes/s) of the card named ``kind``, or None."""
    for frag, flops, bw in PEAKS:
        if frag.lower() in kind.lower():
            return flops, bw
    return None


def train_flops_per_token(model: dict, seq: int) -> float:
    """Model FLOPs of one trained token: 6·N for the parameters' products
    forward and backward (N the parameters a token uses: one expert's
    FFN under top-1), 12·L·D·S for attention's; recomputation is not
    counted."""
    return (6 * weights.active_count(model)
            + 12 * model["n_layers"] * model["d_model"] * seq)


def causal_pairs(t: int) -> int:
    """(query, key) pairs of causal attention over t positions."""
    return t * (t + 1) // 2


def attention_fwd(batch: int, heads: int, t_q: int, t_k: int, head_dim: int,
                  causal: bool = True, itemsize: int = 2) -> tuple:
    """(FLOPs, bytes) of one attention forward: q·kᵀ and p·v over the
    pairs that count (causal: each query against the keys at or before
    it, q and k aligned at the end), q, k, v read and o written once in
    ``itemsize`` bytes, and the f32 logsumexp written."""
    if causal:
        pairs = causal_pairs(t_k) - causal_pairs(t_k - t_q)
    else:
        pairs = t_q * t_k
    flops = 4 * batch * heads * head_dim * pairs
    nbytes = (2 * t_q + 2 * t_k) * batch * heads * head_dim * itemsize
    nbytes += batch * heads * t_q * 4
    return float(flops), float(nbytes)


def least_seconds(flops: float, nbytes: float, peak: tuple) -> float:
    """The least time the chip could take: the larger of the two
    bounds."""
    return max(flops / peak[0], nbytes / peak[1])


def decode_flops(model: dict, batch: int, prompt: int, new: int) -> float:
    """Model FLOPs of one greedy call: the prefill (the layers' products
    over every prompt token, causal attention, the unembedding of the
    last position) and the new−1 cached steps (2·N a token and attention
    over the keys cached so far)."""
    L, D, V = model["n_layers"], model["d_model"], model["vocab"]
    n = weights.active_count(model)
    layers = n - V * D
    prefill = batch * (2 * layers * prompt + 2 * V * D)
    prefill += 4 * batch * L * D * causal_pairs(prompt)
    steps = 0
    for pos in range(prompt, prompt + new - 1):
        steps += batch * (2 * n + 4 * L * D * (pos + 1))
    return float(prefill + steps)
