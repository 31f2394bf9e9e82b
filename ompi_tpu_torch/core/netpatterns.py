"""Communication-pattern topology helpers (the port's copy of the JAX
package's ``core/netpatterns.py``, whole).

≈ ompi/patterns/net (netpatterns k-ary/binomial trees) + the peer
schedules hard-wired into the reference's collective algorithms: pure
functions from (rank, size, …) to parents/children/peer lists, shared by
anything that fans out over ranks — the RML routed overlay uses the k-ary
tree, the collective library's round structures correspond to the
recursive-doubling/Bruck schedules.

Everything is rooted-at-0 in a *virtual* rank space; callers with a
different root rotate ranks ((rank - root) % size) before and after, the
same shift the reference's coll_base_topo does.
"""

from __future__ import annotations

from typing import Optional

__all__ = ["kary_parent", "kary_children", "binomial_parent",
           "binomial_children", "recursive_doubling_peers", "bruck_peers",
           "tree_depth"]


def kary_parent(rank: int, k: int = 2) -> Optional[int]:
    """Parent in the k-ary tree over 0..n-1 (None for the root)."""
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    return None if rank == 0 else (rank - 1) // k


def kary_children(rank: int, n: int, k: int = 2) -> list[int]:
    """Children of ``rank`` in the k-ary tree over 0..n-1."""
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    first = k * rank + 1
    return [c for c in range(first, first + k) if c < n]


def binomial_parent(rank: int) -> Optional[int]:
    """Parent in the binomial tree (clear the lowest set bit) — the shape
    of the reference's bcast/reduce binomial (coll_base_bcast.c:313)."""
    return None if rank == 0 else rank & (rank - 1)


def binomial_children(rank: int, n: int) -> list[int]:
    """Children of ``rank`` in the binomial tree over 0..n-1: rank + 2^j
    for every bit below rank's lowest set bit (all bits for the root),
    ascending."""
    children = []
    lsb = rank & -rank if rank else None
    bit = 1
    while (lsb is None or bit < lsb) and rank + bit < n:
        children.append(rank + bit)
        bit <<= 1
    return children


def recursive_doubling_peers(rank: int, size: int) -> list[int]:
    """Peer per round of recursive doubling (round r: rank XOR 2^r) for
    the power-of-two prefix; callers handle the non-power-of-two fold the
    way coll_base_allreduce.c:128 does."""
    peers = []
    bit = 1
    while bit < size:
        peer = rank ^ bit
        if peer < size:
            peers.append(peer)
        bit <<= 1
    return peers


def bruck_peers(rank: int, size: int) -> list[tuple[int, int]]:
    """(send_to, recv_from) per Bruck round (round r: distance 2^r) —
    the allgather/alltoall Bruck schedule (coll_base_allgather.c:85)."""
    out = []
    dist = 1
    while dist < size:
        out.append(((rank - dist) % size, (rank + dist) % size))
        dist <<= 1
    return out


def tree_depth(n: int, k: int = 2) -> int:
    """Depth of the k-ary tree over n ranks (0 for a single rank)."""
    depth, reach, level = 0, 1, 1
    while reach < n:
        level *= k
        reach += level
        depth += 1
    return depth
