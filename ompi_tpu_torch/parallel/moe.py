"""Expert parallelism: a switch-style MoE layer over an ``ep`` mesh axis.

The port of ``ompi_tpu.parallel.moe``.  Experts shard over ``ep`` and
tokens travel to their expert's rank through ``all_to_all``
(``parallel.collectives``, whose backward is the inverse exchange):

1. gate: ``logits = x @ wg`` (f32 accumulation), an f32 softmax, the
   top-1 expert per token (ties to the first index) and its gate prob;
2. capacity ``C = max(1, ceil(n_tok / E · capacity_factor))``; the
   first C tokens routed to an expert, in row-major token order, are
   kept, the rest DROPPED (their residual path carries them);
3. dispatch into an (E, C, D) block, the ``ep`` all_to_all of the
   (ep · e_local, C, D) blocks, each rank's local experts' FFN batched
   over the source ranks, the inverse all_to_all;
4. combine back to token positions, scaled by the gate prob.

The JAX package dispatches and combines with a dense one-hot (n_tok, E,
C) tensor and two einsums, a form that suits the TPU's matrix unit.
Here the dispatch and combine index rows instead: a kept token's slot is
``e·C + pos`` in a zero-initialised (E·C + 1, D) buffer, a dropped
token's the dump slot E·C.  Each one-hot product sums one nonzero term,
so the two forms give the same bits, forward and backward, and each slot
and token receives one contribution, so the backward is deterministic.
No shape depends on the data and nothing syncs with the host.  The
one-hot form stays as the plain version (``onehot=True``), which the
tests and chip_smoke hold the index form against.
"""

from __future__ import annotations

import contextlib
import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import _disable_current_modes

from ompi_tpu_torch.mpi import trace
from ompi_tpu_torch.parallel.collectives import all_to_all

__all__ = ["switch_moe", "moe_params", "route", "dispatch", "combine",
           "dispatch_onehot", "combine_onehot", "expert_ffn", "recording",
           "replaying"]

#: the leaves of an MoE layer that ``ep`` shards (experts on axis 0)
EXPERT_KEYS = ("w1", "w2")

#: while :func:`recording` is active, the list each switch_moe call
#: appends its routing to; while :func:`replaying` is, the experts to
#: route to by call key; None otherwise (the off path is one test each)
_records: Optional[list] = None
_replay: Optional[dict] = None


def moe_params(rng, d_model: int, d_ff: int, n_experts: int,
               dtype="float32"):
    """Gate + per-expert FFN weights (experts stacked on axis 0) as numpy
    arrays: the JAX package's draws in its order, so one generator state
    gives bit-identical arrays."""
    def w(*shape, scale=None):
        scale = scale if scale is not None else (shape[-2] ** -0.5)
        return rng.normal(0, scale, size=shape).astype(dtype)

    return {
        "wg": w(d_model, n_experts, scale=0.02),
        "w1": w(n_experts, d_model, d_ff),
        "w2": w(n_experts, d_ff, d_model),
    }


class Route(NamedTuple):
    """Top-1 routing of n_tok tokens over E experts of capacity C."""
    probs: torch.Tensor     # (n_tok, E) f32 softmax of the gate logits
    expert: torch.Tensor    # (n_tok,) int64, argmax (first on a tie)
    gate: torch.Tensor      # (n_tok,) f32, the chosen expert's prob
    onehot: torch.Tensor    # (n_tok, E) int64, one-hot of expert
    pos: torch.Tensor       # (n_tok,) int64, place in the expert's queue
    keep: torch.Tensor      # (n_tok,) bool, pos < C
    slot: torch.Tensor      # (n_tok,) int64, e·C + pos, or E·C if dropped
    capacity: int


def capacity_for(n_tok: int, n_experts: int, capacity_factor: float) -> int:
    """The reference's per-call capacity, a float expression."""
    return max(1, math.ceil((n_tok / n_experts) * capacity_factor))


def route(xf: torch.Tensor, wg: torch.Tensor, capacity: int,
          expert: Optional[torch.Tensor] = None) -> Route:
    """Gate and queue positions of the tokens ``xf`` (n_tok, D), compute
    dtype.  The logits are the compute-dtype operands' exact products
    summed in f32 (the JAX package's preferred_element_type=f32 einsum);
    the queue position is a cumulative count over the tokens in order.
    ``expert`` (n_tok,), if given, replaces the argmax (a replay); the
    gate probs are still this call's."""
    E = wg.shape[-1]
    logits = torch.matmul(xf.to(torch.float32),
                          wg.to(xf.dtype).to(torch.float32))
    probs = torch.softmax(logits, dim=-1)
    if expert is None:
        expert = probs.argmax(dim=-1)
    gate = probs.gather(1, expert[:, None])[:, 0]
    # one-hot built expert-major, (E, n_tok), so the running count scans
    # the contiguous token axis (a scan down a strided axis runs a column
    # per thread on the card)
    onehot_t = (expert[None, :] == torch.arange(
        E, device=expert.device)[:, None]).long()
    pos = torch.cumsum(onehot_t, dim=1).gather(0, expert[None, :])[0] - 1
    onehot = onehot_t.t()
    keep = pos < capacity
    slot = torch.where(keep, expert * capacity + pos, E * capacity)
    return Route(probs, expert, gate, onehot, pos, keep, slot, capacity)


def dispatch(xf: torch.Tensor, r: Route) -> torch.Tensor:
    """(n_tok, D) → the (E, C, D) expert block: each kept token copied to
    its slot, empty slots zero; dropped tokens land in the dump row,
    which is cut off (so their gradient from here is zero)."""
    E, C, D = r.onehot.shape[1], r.capacity, xf.shape[1]
    buf = xf.new_zeros(E * C + 1, D).index_copy(0, r.slot, xf)
    return buf[:E * C].reshape(E, C, D)


def combine(out: torch.Tensor, r: Route) -> torch.Tensor:
    """(E, C, D) expert outputs → (n_tok, D): each kept token's slot row,
    a dropped token's zero (the appended dump row)."""
    E, C, D = out.shape
    rows = torch.cat([out.reshape(E * C, D), out.new_zeros(1, D)])
    return rows.index_select(0, r.slot)


def _dispatch_tensor(r: Route, dtype) -> torch.Tensor:
    """The JAX package's (n_tok, E, C) one-hot dispatch tensor."""
    C = r.capacity
    at = F.one_hot(torch.where(r.keep, r.pos, C), C + 1)[:, :-1]
    return r.onehot.to(dtype)[:, :, None] * at.to(dtype)[:, None, :]


def dispatch_onehot(xf: torch.Tensor, r: Route) -> torch.Tensor:
    """The plain version of :func:`dispatch`: ``einsum("tec,td->ecd")``
    with the one-hot dispatch tensor."""
    return torch.einsum("tec,td->ecd", _dispatch_tensor(r, xf.dtype), xf)


def combine_onehot(out: torch.Tensor, r: Route) -> torch.Tensor:
    """The plain version of :func:`combine`: ``einsum("tec,ecd->td")``."""
    return torch.einsum("tec,ecd->td", _dispatch_tensor(r, out.dtype), out)


def expert_ffn(recv: torch.Tensor, w1: torch.Tensor,
               w2: torch.Tensor) -> torch.Tensor:
    """recv (ep, e_local, C, D) → the same shape: gelu(recv @ w1) @ w2 per
    local expert, batched over the source ranks.  Each product is one
    ``bmm`` in the compute dtype (f32 accumulation on the card's tensor
    cores), cast to it before and after the tanh gelu, as the JAX
    package's f32-accumulating einsums; batched products are what the
    "dots" remat policy recomputes, as the JAX package's."""
    s, e, C, D = recv.shape
    a = recv.transpose(0, 1).reshape(e, s * C, D)
    h = F.gelu(torch.bmm(a, w1), approximate="tanh")
    out = torch.bmm(h, w2)
    return out.reshape(e, s, C, D).transpose(0, 1)


@contextlib.contextmanager
def recording():
    """Within the block every switch_moe call appends its routing to the
    list yielded, as device tensors (no sync per call): ``{"load": (E,)
    tokens routed to each expert, "dropped": tokens over capacity,
    "tokens": n_tok, "expert": (n_tok,) each token's expert, "keep":
    (n_tok,) kept, "margin": (n_tok,) the gap between its top two gate
    probs, "key": the call's key (see :func:`replaying`)}``.  A remat
    recompute is a call too.  Recording costs a top-2 and two small
    reductions a call; outside the block nothing is recorded."""
    global _records
    prev, _records = _records, []
    try:
        yield _records
    finally:
        _records = prev


@contextlib.contextmanager
def replaying(records: list):
    """Within the block every switch_moe call routes its tokens to the
    experts that ``records`` (from :func:`recording`) hold for the same
    call key: the address of the layer's gate weights and the token
    count, so a layer of one model and its remat recompute find their
    routing, whatever the order of the calls.  The gate probs and
    everything after the choice are this call's own; a call with no
    record raises.

    For holding two numerics of one model against each other (the flash
    and the plain attention, say): a top-1 switch is discrete, and a
    token whose top two gate probs sit within the two paths' difference
    of a tie would go to another expert on each, moving its output and
    gradient by O(1)."""
    global _replay
    prev, _replay = _replay, {r["key"]: r["expert"] for r in records}
    try:
        yield
    finally:
        _replay = prev


def switch_moe(comm, x: torch.Tensor, params: dict, axis: str = "ep",
               capacity_factor: float = 1.25,
               capacity: Optional[int] = None, with_aux: bool = False,
               onehot: bool = False):
    """Top-1 MoE layer: x (B, T, D) this rank's tokens → (B, T, D).

    ``params['w1']``/``['w2']`` hold this rank's LOCAL experts (E / ep of
    them, the block at its ``axis`` coordinate); ``wg`` (D, E) is
    replicated.  ``with_aux=True`` also returns the switch balance loss
    ``E · Σ_e f_e · p_e`` over this rank's tokens, f_e the routed fraction
    (dropped tokens included, no gradient) and p_e the mean gate prob.
    An axis the mesh lacks, or of size 1, makes the exchange vanish.
    ``onehot=True`` dispatches and combines with the plain one-hot form.
    The call is the model span ``moe``; while the model path's gate
    holds (``mpi.trace.model_on``) it counts its tokens and their drops.
    """
    with trace.model_span("moe"):
        return _switch_moe(comm, x, params, axis, capacity_factor, capacity,
                           with_aux, onehot)


def _switch_moe(comm, x, params, axis, capacity_factor, capacity, with_aux,
                onehot):
    B, T, D = x.shape
    names = comm.mesh.axis_names
    if axis in names and axis not in comm.axes:
        raise ValueError(f"axis {axis!r} not bound to this communicator "
                         f"(axes {comm.axes})")
    ep = int(comm.mesh.shape[axis]) if axis in names else 1
    e_local = params["w1"].shape[0]
    E = e_local * ep
    if params["wg"].shape[-1] != E:
        raise ValueError(f"wg routes to {params['wg'].shape[-1]} experts, "
                         f"the ranks hold {e_local} × ep {ep}")
    n_tok = B * T
    C = capacity if capacity is not None else capacity_for(
        n_tok, E, capacity_factor)

    xf = x.reshape(n_tok, D)
    key = (params["wg"].data_ptr(), n_tok)
    fixed = None
    if _replay is not None:
        fixed = _replay.get(key)
        if fixed is None:
            raise RuntimeError(f"replaying: no recorded routing for the "
                               f"switch call {key}")
    r = route(xf, params["wg"], C, expert=fixed)
    send = (dispatch_onehot if onehot else dispatch)(xf, r)  # (E, C, D)
    # block j of the experts' axis goes to rank j: every rank receives
    # (ep · e_local, C, D), source-rank-major blocks of its own experts
    recv = all_to_all(comm, send, axis, 0, 0).reshape(ep, e_local, C, D)
    out = expert_ffn(recv, params["w1"].to(x.dtype),
                     params["w2"].to(x.dtype))
    # the inverse exchange gives every source rank back its tokens
    out = all_to_all(comm, out.reshape(E, C, D), axis, 0, 0)
    y = (combine_onehot if onehot else combine)(out, r)
    y = (y * r.gate[:, None].to(x.dtype)).reshape(B, T, D)
    if trace.model_on():
        trace.count("moe_tokens_routed_total", n_tok)
        # a device sum, no sync (a read takes the newest total the device
        # has finished), made outside the dispatch modes: a selective
        # checkpoint's recompute must not have to find a sum whose
        # running total is global state
        with _disable_current_modes():
            trace.count("moe_tokens_dropped_total", (~r.keep).sum())
    if _records is not None:
        top2 = r.probs.detach().topk(2, dim=-1).values
        _records.append({"load": r.onehot.sum(dim=0),
                         "dropped": (~r.keep).sum(), "tokens": n_tok,
                         "expert": r.expert, "keep": r.keep,
                         "margin": top2[:, 0] - top2[:, 1], "key": key})
    if not with_aux:
        return y
    frac = r.onehot.to(torch.float32).mean(dim=0)
    aux = E * (frac * r.probs.mean(dim=0)).sum()
    return y, aux
