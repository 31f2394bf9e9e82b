"""The port's simulated fleet (``testing/simfleet.py``): hundreds of
in-process daemons against the port's real ``MultiHostLauncher``.

Every case of ``tests/testing/test_simfleet.py`` runs the JAX package's
own body on the port through ``tests/torch_mirror.py`` (the reference's
bytecode, every assertion kept): boot and teardown of 32 stub ranks,
correlated rack kills converging in one bounded reparent epoch,
simultaneous mid-tree kills coalesced, a partition healing without a
kill storm, an uplink storm shed and counted, the doctor fan-in bounded
per daemon.  The port's own case: the fleet imports no torch.
"""

from __future__ import annotations

import subprocess
import sys

import pytest

import tests.testing.test_simfleet as ref_fleet
from tests.torch_mirror import mirror


@pytest.mark.parametrize("name", [
    "test_fleet_boots_and_tears_down_32_ranks",
    "test_three_simultaneous_midtree_kills_are_idempotent",
    "test_partition_heals_without_kill_storm",
    "test_uplink_storm_sheds_whole_payloads_and_counts_them",
    "test_doctor_fan_in_is_bounded_per_daemon"])
def test_fleet_case_on_the_port(name):
    mirror(getattr(ref_fleet, name), True, [])()


@pytest.mark.parametrize("n_daemons,n_ranks,victims", [
    (4, 32, [1]),
    (16, 128, [4, 5, 6]),
    (64, 512, [16, 17, 18, 19, 20, 21, 22, 23]),
])
def test_rack_kill_on_the_port(n_daemons, n_ranks, victims):
    mirror(ref_fleet.test_rack_kill_converges_in_one_bounded_epoch, True,
           [])(n_daemons, n_ranks, victims)


def test_fleet_imports_no_torch():
    prog = ("import sys\n"
            "from ompi_tpu_torch.testing.simfleet import SimFleet\n"
            "f = SimFleet(n_daemons=4, n_ranks=8, seed=3)\n"
            "f.start(timeout=30.0)\n"
            "try:\n"
            "    assert f.live_daemons() == 4 and f.converged()\n"
            "    rows, seen = f.collect_doctor(timeout=8.0)\n"
            "    assert seen == {1, 2, 3, 4} and len(rows) == 8\n"
            "    assert f.stats()['live_daemons'] == 4\n"
            "finally:\n"
            "    f.stop()\n"
            "print('torch' in sys.modules)\n")
    r = subprocess.run([sys.executable, "-c", prog], capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().splitlines()[-1] == "False"
