"""coll/host — the tuned host collective component (the port's copy of the
JAX package's ``mpi/coll/host.py``).

≈ ompi/mca/coll/tuned: wraps the base algorithm library with a size×commsize
decision layer whose crossover points mirror coll_tuned_decision_fixed.c:
44-87 (allreduce: recursive doubling under the small-message threshold, ring
for large commutative payloads, segmented ring with 1MB segments for very
large ones), overridable per-collective via config vars (the reference's
coll_tuned_*_algorithm MCA params, here ``coll_host_<coll>_algorithm``) or a
dynamic rules file (``coll_host_dynamic_rules``, coll_tuned_dynamic_file.c →
``ompi_tpu_torch.mpi.coll.rules``).

The variables, their defaults and every decision are the JAX package's;
:meth:`HostColl.decision` names the algorithm a call will run, and
:meth:`HostColl.freeze_decision` resolves it once for a persistent plan.
Left out: the trace plane's decision instants and per-algorithm histograms
(ROADMAP.md Queue 1 item 6.9).
"""

from __future__ import annotations

import os
import threading
from typing import Optional

import numpy as np

from ompi_tpu_torch.core.config import VarType, register_var, var_registry
from ompi_tpu_torch.core.mca import Component
from ompi_tpu_torch.mpi.coll import base, coll_framework, rules
from ompi_tpu_torch.mpi.constants import MPIException
from ompi_tpu_torch.mpi.op import Op

__all__ = ["HostColl", "HostCollBase"]


def _nbytes(buf) -> int:
    return np.asarray(buf).nbytes


class HostCollBase(Component):
    """Decision plumbing shared by host-collective components."""

    ALGORITHMS: dict[str, tuple[str, ...]] = {}

    def _load_rules(self, path: str) -> rules.RuleSet:
        """The dynamic-rules RuleSet, parsed once per (path, mtime):
        repeated collectives pay one stat + dict hit, never a re-parse.
        A miss takes a lock so concurrent in-process ranks touching a
        fresh file parse it exactly once."""
        cache = self.__dict__.setdefault("_rules_cache", {})
        mtime = os.stat(path).st_mtime
        hit = cache.get(path)
        if hit is not None and hit[0] == mtime:
            return hit[1]
        lock = self.__dict__.setdefault("_rules_lock", threading.Lock())
        with lock:
            hit = cache.get(path)
            if hit is None or hit[0] != mtime:
                cache[path] = (mtime, rules.load_rules(path))
            return cache[path][1]

    def _decide(self, coll: str, comm, nbytes: int) -> Optional[str]:
        """forced config var > dynamic rules file > None (fixed
        decision) — the shared :func:`rules.decide` ladder, fed by the
        component's lock-guarded RuleSet cache."""
        alg, _src = rules.decide(
            coll, comm.size, nbytes,
            forced=var_registry.get(f"coll_host_{coll}_algorithm") or "",
            path=var_registry.get("coll_host_dynamic_rules") or "",
            valid=self.ALGORITHMS.get(coll, ()),
            forced_src=f"config var coll_host_{coll}_algorithm",
            load=self._load_rules)
        return alg


#: algorithm name → base-library function, per collective
_FUNCS = {
    "bcast": {"binomial": base.bcast_binomial,
              "linear": base.bcast_linear,
              "pipeline": base.bcast_pipeline},
    "allreduce": {"recursive_doubling": base.allreduce_recursive_doubling,
                  "ring": base.allreduce_ring,
                  "segmented_ring": base.allreduce_segmented_ring,
                  "linear": base.allreduce_linear},
    "allgather": {"bruck": base.allgather_bruck, "ring": base.allgather_ring},
    "alltoall": {"pairwise": base.alltoall_pairwise,
                 "bruck": base.alltoall_bruck},
    "reduce_scatter": {"ring": base.reduce_scatter_ring,
                       "basic": base.reduce_scatter_basic},
}


@coll_framework.component
class HostColl(HostCollBase):
    NAME = "host"
    PRIORITY = 40

    # what _decide may name, per collective (also validation + introspection)
    ALGORITHMS = {
        "bcast": ("binomial", "linear", "pipeline"),
        "allreduce": ("recursive_doubling", "ring", "segmented_ring",
                      "linear"),
        "allgather": ("bruck", "ring"),
        "alltoall": ("pairwise", "bruck"),
        "reduce_scatter": ("ring", "basic"),
    }

    def register_params(self) -> None:
        register_var("coll", "host_allreduce_small", VarType.SIZE, 10 * 1024,
                     "allreduce: below this use recursive doubling "
                     "(tuned's 10KB crossover)")
        register_var("coll", "host_allreduce_segment", VarType.SIZE,
                     1 << 20,
                     "allreduce: above this pipeline the ring in 1MB "
                     "segments (tuned's segmented-ring crossover)")
        register_var("coll", "host_bcast_segment", VarType.SIZE, 128 * 1024,
                     "bcast: pipeline segment size for the chain "
                     "algorithm (tuned's coll_tuned_bcast_segmentsize)")
        register_var("coll", "host_allgather_small", VarType.SIZE, 64 * 1024,
                     "allgather: below this use bruck, above ring")
        register_var("coll", "host_alltoall_small", VarType.SIZE, 4 * 1024,
                     "alltoall: below this use bruck (lg p rounds), "
                     "above pairwise")
        register_var("coll", "host_alltoall_bruck_ranks", VarType.SIZE, 8,
                     "alltoall: bruck also needs at least this many "
                     "ranks (its lg p round count only beats pairwise's "
                     "p-1 when p is large; tuned's comm-size gate)")
        register_var("coll", "host_dynamic_rules", VarType.STRING, "",
                     "path to a dynamic collective-selection rules file "
                     "(see ompi_tpu_torch.mpi.coll.rules)")
        for name in self.ALGORITHMS:
            register_var("coll", f"host_{name}_algorithm", VarType.STRING, "",
                         f"force a {name} algorithm (empty = decide by size)")

    def query(self, comm=None, **ctx) -> Optional[int]:
        if comm is not None and comm.size == 1:
            return None  # coll/self owns size-1
        return self.PRIORITY

    # -- the decision layer -----------------------------------------------

    def decision(self, coll: str, comm, nbytes: int,
                 op: Optional[Op] = None) -> str:
        """The algorithm ``coll`` runs on ``comm`` for ``nbytes`` of
        payload (per rank) with ``op``: forced var, then the rules file,
        then the tuned fixed ladder."""
        commutative = op is None or op.commutative
        if coll == "bcast":
            # the algorithm choice must agree on every rank, but only the
            # root knows the message size — so unlike the reference
            # (whose receivers learn sizes from fragment headers) the
            # decision here uses only globally-visible config: forced var
            # or a rules entry at msg size 0
            return self._decide("bcast", comm, 0) or "binomial"
        alg = self._decide(coll, comm, nbytes)
        if coll == "allreduce":
            if alg is None:
                # tuned fixed decision (coll_tuned_decision_fixed.c:65-87)
                if (nbytes < var_registry.get("coll_host_allreduce_small")
                        or not commutative):
                    alg = "recursive_doubling"
                elif nbytes >= var_registry.get(
                        "coll_host_allreduce_segment"):
                    alg = "segmented_ring"
                else:
                    alg = "ring"
            if not commutative and alg != "linear":
                alg = "recursive_doubling"
            return alg
        if coll == "allgather":
            return alg or ("bruck" if nbytes < var_registry.get(
                "coll_host_allgather_small") else "ring")
        if coll == "alltoall":
            return alg or self._alltoall_fixed(comm, nbytes)
        if coll == "reduce_scatter":
            return ("basic" if alg == "basic" or not commutative
                    else "ring")
        raise MPIException(f"coll/host: no decision layer for {coll!r}")

    @staticmethod
    def _alltoall_fixed(comm, nbytes: int) -> str:
        """The fixed rung: bruck is the small-message AND
        high-rank-count pick — lg p rounds moving p/2 blocks each only
        beat pairwise's p-1 single-block rounds when latency dominates
        (small payloads) and p is large enough for lg p << p."""
        return ("bruck"
                if (nbytes < var_registry.get("coll_host_alltoall_small")
                    and comm.size
                    >= var_registry.get("coll_host_alltoall_bruck_ranks"))
                else "pairwise")

    # -- bind-time freezing (coll/persistent) ------------------------------

    def freeze_decision(self, coll: str, comm, nbytes: int, op=None):
        """Resolve the selection layer ONCE and return ``(fn, label)`` —
        the algorithm callable with its tuning (segment sizes, forced
        var, rules-file hit) baked in, so a persistent plan's Start
        never re-pays the per-op decision walk.  ``fn`` keeps the
        per-collective call shape of the ``coll_*`` table slot it
        freezes (bcast: ``fn(comm, buf, root)``; reduce adds ``op``
        before ``root``; allreduce: ``fn(comm, sendbuf, op)``)."""
        fixed = {"barrier": (base.barrier_dissemination, "dissemination"),
                 "reduce": (base.reduce_binomial, "binomial"),
                 "alltoallv": (base.alltoallv_pairwise, "pairwise"),
                 "scan": (base.scan_linear, "linear"),
                 "exscan": (base.exscan_linear, "linear")}
        if coll in fixed:
            return fixed[coll]
        if coll not in _FUNCS:
            raise MPIException(f"freeze_decision: no persistent plan for "
                               f"{coll!r}")
        alg = self.decision(coll, comm, nbytes, op)
        if alg == "pipeline":
            seg = var_registry.get("coll_host_bcast_segment")
            return (lambda c, buf, root: base.bcast_pipeline(
                c, buf, root, segsize=seg)), f"pipeline(seg={seg})"
        if alg == "segmented_ring":
            seg = var_registry.get("coll_host_allreduce_segment")
            return (lambda c, sb, o: base.allreduce_segmented_ring(
                c, sb, o, segsize=seg)), f"segmented_ring(seg={seg})"
        return _FUNCS[coll][alg], alg

    # -- table slots ------------------------------------------------------

    def coll_barrier(self, comm) -> None:
        base.barrier_dissemination(comm)

    def coll_bcast(self, comm, buf, root: int):
        alg = self.decision("bcast", comm, 0)
        if alg == "pipeline":
            return base.bcast_pipeline(
                comm, buf, root,
                segsize=var_registry.get("coll_host_bcast_segment"))
        return _FUNCS["bcast"][alg](comm, buf, root)

    def coll_reduce(self, comm, sendbuf, op: Op, root: int):
        return base.reduce_binomial(comm, sendbuf, op, root)

    def coll_allreduce(self, comm, sendbuf, op: Op):
        alg = self.decision("allreduce", comm, _nbytes(sendbuf), op)
        if alg == "segmented_ring":
            return base.allreduce_segmented_ring(
                comm, sendbuf, op,
                segsize=var_registry.get("coll_host_allreduce_segment"))
        return _FUNCS["allreduce"][alg](comm, sendbuf, op)

    def coll_gather(self, comm, sendbuf, root: int):
        return base.gather_linear(comm, sendbuf, root)

    def coll_allgather(self, comm, sendbuf):
        alg = self.decision("allgather", comm, _nbytes(sendbuf))
        return _FUNCS["allgather"][alg](comm, sendbuf)

    def coll_scatter(self, comm, sendbuf, root: int):
        return base.scatter_linear(comm, sendbuf, root)

    def coll_alltoall(self, comm, sendbuf):
        alg = self.decision("alltoall", comm, _nbytes(sendbuf))
        return _FUNCS["alltoall"][alg](comm, sendbuf)

    def coll_reduce_scatter(self, comm, sendbuf, op: Op):
        alg = self.decision("reduce_scatter", comm, _nbytes(sendbuf), op)
        return _FUNCS["reduce_scatter"][alg](comm, sendbuf, op)

    def coll_reduce_scatter_block(self, comm, sendbuf, op: Op):
        arr = np.asarray(sendbuf)
        if arr.shape[0] % comm.size:
            raise MPIException(
                f"reduce_scatter_block: axis 0 ({arr.shape[0]}) not "
                f"divisible by {comm.size}")
        block = arr.shape[0] // comm.size
        out = self.coll_reduce_scatter(comm, arr.reshape(arr.shape[0], -1),
                                       op)
        return out.reshape((block,) + arr.shape[1:])

    def coll_scan(self, comm, sendbuf, op: Op):
        return base.scan_linear(comm, sendbuf, op)

    def coll_exscan(self, comm, sendbuf, op: Op):
        return base.exscan_linear(comm, sendbuf, op)

    def coll_gatherv(self, comm, sendbuf, root: int):
        return base.gatherv_linear(comm, sendbuf, root)

    def coll_scatterv(self, comm, sendparts, root: int):
        return base.scatterv_linear(comm, sendparts, root)

    def coll_allgatherv(self, comm, sendbuf):
        return base.allgatherv_ring(comm, sendbuf)

    def coll_alltoallv(self, comm, sendparts):
        return base.alltoallv_pairwise(comm, sendparts)

    def coll_alltoallw(self, comm, sendspecs, recvspecs):
        return base.alltoallw_pairwise(comm, sendspecs, recvspecs)
