"""The port's runtime messaging bus (``ompi_tpu_torch/runtime/rml.py``)
against the JAX package's, and the PMIx readiness probes the daemon
kill reads.

The JAX package's own cases run once on each package through
``tests/torch_mirror.py`` (the reference's bytecode, every assertion
kept): the heartbeat monitor's incremental sweep, grace and world-scaled
timeouts (``tests/runtime/test_fleet_bounds.py``), the heartbeats riding
the tree (``test_errmgr_policies.py``), ``send_hop`` and the PMIx
``regcount`` probes (``test_obs_plane.py``).  The port's own cases hold
the wire: both packages frame an envelope to the same bytes, and every
kind of frame (hello, direct, xcast, up, hop, a child send) crosses
between a port node and a JAX package node in both directions.
"""

from __future__ import annotations

import queue
import time

import pytest

import tests.runtime.test_errmgr_policies as ref_policies
import tests.runtime.test_fleet_bounds as ref_fleet
import tests.runtime.test_obs_plane as ref_obs
from ompi_tpu.core.config import var_registry as jvars
from ompi_tpu.runtime import rml as jrml
from ompi_tpu_torch.core.config import var_registry as pvars
from ompi_tpu_torch.runtime import rml as prml
from tests.torch_mirror import mirror

PORTS = pytest.mark.parametrize("port", [False, True], ids=["jax", "port"])


@pytest.fixture
def hb_vars():
    """The reference's ``hb_vars`` on both packages' registries."""
    saved = []
    for reg in (jvars, pvars):
        saved.append((reg, reg.get("rml_heartbeat_period"),
                      reg.get("rml_heartbeat_timeout")))
        reg.set("rml_heartbeat_period", 1.0)
        reg.set("rml_heartbeat_timeout", 10.0)
    yield
    for reg, period, timeout in saved:
        reg.set("rml_heartbeat_period", period)
        reg.set("rml_heartbeat_timeout", timeout)


# -- the JAX package's cases ---------------------------------------------------

@PORTS
@pytest.mark.parametrize("name", [
    "test_heartbeat_sweep_examines_nothing_when_nothing_expired",
    "test_heartbeat_sweep_declares_each_silent_vpid_once",
    "test_heartbeat_fresh_beat_invalidates_stale_entry",
    "test_heartbeat_grace_defers_then_declares"])
def test_heartbeat_sweep(name, port, hb_vars):
    mirror(getattr(ref_fleet, name), port, [])(hb_vars=None)


@PORTS
def test_scaled_timeout_grows_with_tree_depth(port):
    mirror(ref_fleet.test_scaled_timeout_grows_with_tree_depth, port, [])()


@PORTS
@pytest.mark.parametrize("name", ["test_heartbeat_monitor_declares_silent_vpid",
                                  "test_daemon_heartbeats_ride_the_tree"])
def test_heartbeats(name, port, monkeypatch):
    fn = mirror(getattr(ref_policies, name), port, [])
    fn(monkeypatch) if "monitor" in name else fn()


@PORTS
@pytest.mark.parametrize("name", ["test_send_hop_delivers_at_parent_hop",
                                  "test_send_hop_at_root_delivers_locally",
                                  "test_regcount_counts_registered_lives",
                                  "test_query_regcount_unreachable_is_none"])
def test_obs_plane_case(name, port):
    mirror(getattr(ref_obs, name), port, [])()


# -- the wire ------------------------------------------------------------------

def test_every_tag_and_variable_matches_the_jax_package():
    jtags = {k: v for k, v in vars(jrml).items() if k.startswith("TAG_")}
    ptags = {k: v for k, v in vars(prml).items() if k.startswith("TAG_")}
    assert ptags == jtags and len(ptags) == 27
    for name in ("rml_heartbeat_period", "rml_heartbeat_timeout",
                 "rml_reparent_timeout"):
        assert pvars.get(name) == jvars.get(name), name
    assert prml._SCALE_BASE_DEPTH == jrml._SCALE_BASE_DEPTH


PAYLOADS = [None, 7, -3, 2.5, "x", b"\x00raw", [1, 2, 3], (4, "five"),
            {"children": [(3, "127.0.0.1:1"), (4, "127.0.0.1:2")],
             "reparent": True},
            {7: {0: [1.25, {"pml_sends_total": 3}]}}]


@pytest.mark.parametrize("kind", ["up", "hop", "xcast", "direct"])
def test_envelopes_pack_to_the_same_bytes(kind):
    for i, payload in enumerate(PAYLOADS):
        tag = prml.TAG_PROC_EXIT if i % 2 else prml.TAG_METRICS
        assert (prml._pack_env(kind, tag, i, payload)
                == jrml._pack_env(kind, tag, i, payload)), payload


def _expect(q, timeout=5.0):
    try:
        return q.get(timeout=timeout)
    except queue.Empty:
        raise AssertionError("frame never delivered") from None


@pytest.mark.parametrize("hnp_mod,daemon_mod", [(prml, jrml), (jrml, prml)],
                         ids=["port_hnp-jax_daemon", "jax_hnp-port_daemon"])
def test_frames_cross_between_the_packages(hnp_mod, daemon_mod):
    """A three-node tree (HNP 0, daemons 1 and 3, 3 under 1) of mixed
    packages: registration over the bootstrap link, the tree's hellos,
    xcast down two levels, send_up relayed through a mid-tree daemon of
    the other package, a hop, and a child send."""
    hnp = hnp_mod.RmlNode(0)
    mid = daemon_mod.RmlNode(1)
    leaf = hnp_mod.RmlNode(3)
    got: dict = {name: queue.Queue() for name in
                 ("reg", "up", "hop", "down_mid", "down_leaf", "child")}
    hnp.register_recv(prml.TAG_REGISTER, lambda o, p: got["reg"].put((o, p)))
    hnp.register_recv(prml.TAG_PROC_EXIT, lambda o, p: got["up"].put((o, p)))
    mid.register_recv(prml.TAG_METRICS, lambda o, p: got["hop"].put((o, p)))
    mid.register_recv(prml.TAG_LAUNCH,
                      lambda o, p: got["down_mid"].put((o, p)))
    leaf.register_recv(prml.TAG_LAUNCH,
                       lambda o, p: got["down_leaf"].put((o, p)))
    leaf.register_recv(prml.TAG_CLOCK_REPLY,
                       lambda o, p: got["child"].put((o, p)))
    try:
        boot = mid.dial_bootstrap(hnp.uri)
        mid.fallback_up = boot
        mid.send_direct(boot, prml.TAG_REGISTER, (1, mid.uri, "sim000"))
        assert _expect(got["reg"]) == (1, (1, mid.uri, "sim000"))
        hnp.dial_children([(1, mid.uri)])
        assert mid.wait_parent(5.0)
        mid.dial_children([(3, leaf.uri)])
        assert leaf.wait_parent(5.0)
        spec = {"jobid": 9, "argv": ["python", "-c", "pass"],
                "by_daemon": [(1, [(0, 0, None)]), (3, [(1, 0, "0")])]}
        hnp.xcast(prml.TAG_LAUNCH, spec)
        for q in ("down_mid", "down_leaf"):
            origin, payload = _expect(got[q])
            assert origin == 0 and payload["jobid"] == 9
            assert payload["by_daemon"][1] == (3, [(1, 0, "0")])
        leaf.send_up(prml.TAG_PROC_EXIT, (9, 1, -9, ""))
        assert _expect(got["up"]) == (3, (9, 1, -9, ""))
        leaf.send_hop(prml.TAG_METRICS, {9: {1: [1.5, {"x_total": 2}]}})
        assert _expect(got["hop"]) == (3, {9: {1: [1.5, {"x_total": 2}]}})
        assert mid.send_child(3, prml.TAG_CLOCK_REPLY, (5, 10, 20, 0))
        assert _expect(got["child"]) == (1, (5, 10, 20, 0))
    finally:
        for node in (leaf, mid, hnp):
            node.close()


def test_peer_lost_fires_when_a_mixed_link_dies():
    """The lifeline signal: a JAX package daemon's close reaches the
    port's HNP as on_peer_lost, and the dead child link is pruned."""
    hnp, daemon = prml.RmlNode(0), jrml.RmlNode(1)
    lost = queue.Queue()
    hnp.on_peer_lost = lost.put
    try:
        hnp.dial_children([(1, daemon.uri)])
        assert daemon.wait_parent(5.0)
        daemon.close()
        assert lost.get(timeout=5.0) == 1
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline and 1 in hnp._child_links:
            time.sleep(0.01)
        assert 1 not in hnp._child_links
    finally:
        hnp.close()
