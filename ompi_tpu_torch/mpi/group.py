"""Groups: ordered sets of ranks with MPI set operations (the port's copy
of the JAX package's ``mpi/group.py``).

≈ ompi/group: a Group is an ordered list of world ranks; communicators are a
group + a context id.  Set ops (union/intersection/difference), incl/excl,
and rank translation follow MPI semantics (order preserved from the first
group, UNDEFINED for absent ranks).
"""

from __future__ import annotations

from typing import Sequence

from ompi_tpu_torch.mpi.constants import UNDEFINED, MPIException

__all__ = ["Group"]


class Group:
    """An ordered set of global (world) ranks."""

    def __init__(self, world_ranks: Sequence[int]) -> None:
        self._ranks = tuple(int(r) for r in world_ranks)
        if len(set(self._ranks)) != len(self._ranks):
            raise MPIException(f"group has duplicate ranks: {self._ranks}")

    @property
    def size(self) -> int:
        return len(self._ranks)

    @property
    def ranks(self) -> tuple[int, ...]:
        return self._ranks

    def rank_of(self, world_rank: int) -> int:
        """This group's rank for a world rank (UNDEFINED if absent)."""
        try:
            return self._ranks.index(world_rank)
        except ValueError:
            return UNDEFINED

    def world_rank(self, group_rank: int) -> int:
        return self._ranks[group_rank]

    # -- set operations (≈ MPI_Group_union/intersection/difference) -------

    def union(self, other: "Group") -> "Group":
        seen = set(self._ranks)
        return Group(self._ranks +
                     tuple(r for r in other._ranks if r not in seen))

    def intersection(self, other: "Group") -> "Group":
        o = set(other._ranks)
        return Group(tuple(r for r in self._ranks if r in o))

    def difference(self, other: "Group") -> "Group":
        o = set(other._ranks)
        return Group(tuple(r for r in self._ranks if r not in o))

    def incl(self, ranks: Sequence[int]) -> "Group":
        """Subset by *group* ranks, in the given order (≈ MPI_Group_incl)."""
        return Group(tuple(self._ranks[r] for r in ranks))

    def excl(self, ranks: Sequence[int]) -> "Group":
        drop = set(ranks)
        bad = [r for r in drop if not 0 <= r < self.size]
        if bad:
            raise MPIException(f"excl: invalid group ranks {bad}")
        return Group(tuple(r for i, r in enumerate(self._ranks)
                           if i not in drop))

    def _expand_ranges(self, ranges: Sequence[Sequence[int]]) -> list[int]:
        out: list[int] = []
        for first, last, stride in ranges:
            if stride == 0:
                raise MPIException("range stride may not be 0")
            stop = last + (1 if stride > 0 else -1)
            for r in range(first, stop, stride):
                if not 0 <= r < self.size:
                    raise MPIException(
                        f"range rank {r} outside group of {self.size}")
                out.append(r)
        return out

    def range_incl(self, ranges: Sequence[Sequence[int]]) -> "Group":
        """≈ MPI_Group_range_incl: ranges are (first, last, stride)
        triples, expanded inclusively in order."""
        return self.incl(self._expand_ranges(ranges))

    def range_excl(self, ranges: Sequence[Sequence[int]]) -> "Group":
        """≈ MPI_Group_range_excl."""
        return self.excl(self._expand_ranges(ranges))

    def translate_ranks(self, ranks: Sequence[int],
                        other: "Group") -> list[int]:
        """≈ MPI_Group_translate_ranks: my group ranks → other's group ranks."""
        return [other.rank_of(self._ranks[r]) for r in ranks]

    def compare(self, other: "Group") -> str:
        """≈ MPI_Group_compare: 'ident' | 'similar' | 'unequal'."""
        if self._ranks == other._ranks:
            return "ident"
        if set(self._ranks) == set(other._ranks):
            return "similar"
        return "unequal"

    def __eq__(self, other) -> bool:
        return isinstance(other, Group) and self._ranks == other._ranks

    def __hash__(self) -> int:
        return hash(self._ranks)

    def __repr__(self) -> str:
        return f"Group({list(self._ranks)})"
