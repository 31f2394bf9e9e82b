"""The port's multi-tenant pool: gang scheduling, admission control and
doctor-driven remediation (``runtime/dvm.py``), held against the JAX
package's.

Every case of ``tests/runtime/test_dvm_sched.py`` runs the JAX
package's own body through ``tests/torch_mirror.py``: the pure decision
functions (``gang_place``, ``plan_remediation``) on both packages, the
live cases (a never-fitting submission, a full admission queue and its
FIFO drain, two tenants without output or exit-code bleed) on a port
pool, whose helpers (``_standing_vm``, ``_tpurun``, ``_tpurun_bg`` of
``tests/runtime/test_dvm.py``) are mirrored too.  The two live
remediation cycles keep the reference's ``slow`` mark.
"""

from __future__ import annotations

import pytest

import tests.runtime.test_dvm_sched as ref_sched
from tests.torch_mirror import mirror

PORTS = pytest.mark.parametrize("port", [False, True],
                                ids=["jax", "torch"])
FOLLOW = ("tests.runtime.test_dvm",)


@PORTS
@pytest.mark.parametrize("name", [
    "test_gang_place_spans_two_hosts",
    "test_gang_place_prefers_least_loaded",
    "test_gang_place_skips_dead_and_silent_hosts",
    "test_gang_place_all_or_nothing",
    "test_gang_place_busy_tiebreak",
    "test_plan_remediation_ladder"])
def test_decision_case(name, port):
    mirror(getattr(ref_sched, name), port, [], follow=FOLLOW)()


@pytest.mark.parametrize("name", [
    "test_submit_over_pool_capacity_rejected",
    "test_admission_queue_full_then_fifo_drain",
    "test_two_tenants_no_output_or_exit_bleed"])
def test_live_case_on_the_port(name, tmp_path):
    mirror(getattr(ref_sched, name), True, [], follow=FOLLOW)(tmp_path)


@pytest.mark.slow
@pytest.mark.parametrize("name", [
    "test_straggler_sigcont_probe_recovers",
    "test_mismatch_requeue_then_budget_reject"])
def test_remediation_case_on_the_port(name, tmp_path):
    mirror(getattr(ref_sched, name), True, [], follow=FOLLOW)(tmp_path)


def test_decisions_agree_over_a_grid():
    """Both packages' ``gang_place`` and ``plan_remediation`` give the
    same answer over a grid of pools, loads and verdicts."""
    import itertools

    from ompi_tpu.runtime import dvm as jdvm
    from ompi_tpu.runtime.job import Node as JNode
    from ompi_tpu_torch.runtime import dvm as pdvm
    from ompi_tpu_torch.runtime.job import Node as PNode

    for inuse, np_, dead in itertools.product(
            [(0, 0, 0), (1, 3, 0), (2, 2, 2), (3, 0, 1)], range(1, 8),
            [frozenset(), frozenset({2})]):
        picks = []
        for Node, d in ((JNode, jdvm), (PNode, pdvm)):
            nodes = [Node(f"h{i}", slots=3, slots_inuse=u)
                     for i, u in enumerate(inuse)]
            got = d.gang_place(nodes, np_, dead=dead, hb_ages={3: 9.0},
                               hb_timeout=5.0, busy={"h0": 0.5})
            picks.append(None if got is None else [n.name for n in got])
        assert picks[0] == picks[1], (inuse, np_, dead, picks)
    for kind, rank, used, budget in itertools.product(
            ["straggler", "deadlock", "mismatch", "healthy", None],
            [-1, 0, 3], range(4), range(3)):
        assert pdvm.plan_remediation(kind, rank, used, budget) == \
            jdvm.plan_remediation(kind, rank, used, budget)
