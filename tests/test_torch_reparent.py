"""The port's failure containment on the daemon tree: mid-tree orted
re-parenting (``TAG_REPARENT``/``TAG_ADOPT``, the HNP arbitrating), the
orphan's bootstrap fallback up-path, and the ``report_failed`` feedback
loop — ``tests/runtime/test_reparent.py``, every case.

The unit cases run once on each package and the acceptance scenario (a
non-leaf orted SIGKILLed under notify, ranks 1–3 finishing) on the port,
all through ``tests/torch_mirror.py``: the reference's bytecode, every
assertion kept, its ``tpurun`` helper and rank program naming the port's
package.  The port's own cases drive the HNP's loss epochs directly: a
correlated loss is one batched adoption round, and an adopter's death
re-homes its adoptees.
"""

from __future__ import annotations

import types

import pytest

import tests.runtime.test_reparent as ref
from tests.torch_mirror import mirror

PORTS = pytest.mark.parametrize("port", [False, True], ids=["jax", "port"])


@PORTS
@pytest.mark.parametrize("name", [
    "test_nearest_live_ancestor_walks_over_corpses",
    "test_retarget_parent_accepts_new_parent_hello",
    "test_send_up_falls_back_to_bootstrap_link",
    "test_reparent_timeout_var_registered",
    "test_report_failed_reaches_dead_set_and_hook"])
def test_unit_case_on_each_package(name, port):
    mirror(getattr(ref, name), port, [])()


def test_midtree_daemon_kill_orphan_ranks_survive():
    mirror(ref.test_midtree_daemon_kill_orphan_ranks_survive, True, [])()


class _Rml:
    """Records the HNP's adoption orders instead of sending them."""

    def __init__(self, vpids):
        self.sent = []
        self.boot_links = {v: f"boot{v}" for v in vpids}

    def send_direct(self, link, tag, payload):
        self.sent.append((link, tag, payload))

    def dial_children(self, children):
        self.sent.append(("hnp", "dial", sorted(children)))


def _launcher(n_daemons: int):
    from ompi_tpu_torch.runtime import rml
    from ompi_tpu_torch.runtime.plm import MultiHostLauncher

    mh = MultiHostLauncher(plm_name="sim")
    total = n_daemons + 1
    mh.rml = _Rml(range(1, total))
    mh._registered = {v: (f"uri{v}", f"sim{v - 1:03d}")
                      for v in range(1, total)}
    mh._eff_parent = {v: rml.tree_parent(v) or 0 for v in range(1, total)}
    return mh


def test_a_correlated_loss_is_one_batched_round():
    """Daemons 1 and 2 die in one epoch: their live children (3, 4 under
    1; 5, 6 under 2) each get one TAG_REPARENT to the HNP, and the HNP
    dials all four in one round — orphans + adopter groups frames."""
    from ompi_tpu_torch.runtime import rml

    mh = _launcher(6)
    mh._dead_daemons = {1, 2}
    mh._reparent_epoch({1, 2})
    orders = [(link, payload) for link, tag, payload in mh.rml.sent
              if tag == rml.TAG_REPARENT]
    assert sorted(orders) == [("boot3", 0), ("boot4", 0), ("boot5", 0),
                              ("boot6", 0)]
    assert ("hnp", "dial", [(3, "uri3"), (4, "uri4"), (5, "uri5"),
                            (6, "uri6")]) in mh.rml.sent
    assert mh.reparent_epochs_total == 1
    assert mh.reparent_orphans_total == 4
    assert mh.reparent_frames_total == 4
    assert {v: mh._eff_parent[v] for v in (3, 4, 5, 6)} == dict.fromkeys(
        (3, 4, 5, 6), 0)


def test_an_adopters_death_rehomes_its_adoptees():
    """Daemon 3 (a child of 1) dies: 7 and 8 go to 1 by TAG_ADOPT.  Then
    1 dies: 4, and the adoptees 7 and 8, go to the HNP — nobody is left
    holding a link to a corpse, nobody is adopted twice."""
    from ompi_tpu_torch.runtime import rml

    mh = _launcher(8)
    mh._dead_daemons = {3}
    mh._reparent_epoch({3})
    assert ("boot1", rml.TAG_ADOPT, [(7, "uri7"), (8, "uri8")]) \
        in mh.rml.sent
    assert mh._eff_parent[7] == mh._eff_parent[8] == 1
    mh.rml.sent.clear()
    mh._dead_daemons.add(1)
    mh._reparent_epoch({1})
    orders = sorted((link, payload) for link, tag, payload in mh.rml.sent
                    if tag == rml.TAG_REPARENT)
    assert orders == [("boot4", 0), ("boot7", 0), ("boot8", 0)]
    assert mh.reparent_epochs_total == 2


def test_daemon_loss_under_notify_fails_only_its_ranks():
    """``_fail_daemon_ranks``: a lost daemon's ranks get synthetic exits
    (-9, ``daemon_lost``) and reach notify's batched arm once."""
    from ompi_tpu_torch.runtime.job import AppContext, Job, Node, Proc

    mh = _launcher(2)
    nodes = [Node(name="sim000", slots=2), Node(name="sim001", slots=2)]
    mh._pool_nodes = nodes
    job = Job([AppContext(argv=["x"], np=4)])
    job.procs = [Proc(rank=r, node=nodes[r // 2]) for r in range(4)]
    job.exited = {}
    seen = []
    mh._errmgr = types.SimpleNamespace(
        daemon_ranks_failed=lambda launcher, j, procs: seen.append(
            [p.rank for p in procs]))
    with mh._cv:
        mh._fail_daemon_ranks(job, 2)
    assert seen == [[2, 3]]
    assert job.exited == {2: -9, 3: -9}
    assert all(job.procs[r].daemon_lost for r in (2, 3))
