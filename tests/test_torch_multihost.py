"""The port's job-wide device view (``parallel/multihost.py``): launched
ranks join one ``torch.distributed`` group at ``init()``, ``make_mesh()``
spans the job, and a communicator bound to it runs both routes.

A 4-rank job of ``examples/device_allreduce.py --device cpu`` on this
machine's CPU gets the rendezvous the launcher exports under ``--gpu``
(``OMPI_TPU_COORD``, ``OMPI_TPU_NHOSTS``) by hand through ``-x``; each
rank's device-route allreduce of a CPU tensor (coll/xla over gloo) must
equal the direct call and the host-route allreduce (coll/host over the
ob1 PML) of the same data, bit for bit (small integers: every order of
summation is exact), with no tensor copied to the host in the call.  The card binding of ``make_mesh`` must agree with
the launcher's ``OMPI_TPU_CHIP``.
"""

from __future__ import annotations

import json
import pathlib
import socket
import subprocess
import sys

import pytest
import torch

from ompi_tpu_torch.parallel import mesh as mesh_mod
from ompi_tpu_torch.parallel import multihost

ROOT = pathlib.Path(__file__).resolve().parents[1]

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_four_ranks_join_one_group_and_both_routes_agree():
    coord = f"127.0.0.1:{_free_port()}"
    p = subprocess.run(
        [sys.executable, "-m", "ompi_tpu_torch.tools.tpurun", "-np", "4",
         "--no-tag-output", "-x", f"OMPI_TPU_COORD={coord}", "-x",
         "OMPI_TPU_NHOSTS=1", "--", sys.executable, "-m",
         "ompi_tpu_torch.examples.device_allreduce", "--device", "cpu",
         "--mib", "0.0625"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stderr
    ranks = [json.loads(line.split(" ", 1)[1])
             for line in p.stdout.splitlines()
             if line.startswith("device_allreduce ")]
    assert sorted(r["rank"] for r in ranks) == [0, 1, 2, 3]
    for r in ranks:
        assert r["group_size"] == 4 and r["mesh"] == {"world": 4}
        assert r["provider"] == "xla" and r["device_error"] is None
        assert r["device_equal"] and r["routes_equal"] and r["host_equal"]
        assert r["device_host_copies"] == 0 and r["bytes"] == 65536
    assert len({r["device_checksum"] for r in ranks}) == 1


def test_no_rendezvous_in_the_env_joins_nothing(monkeypatch):
    monkeypatch.delenv(multihost.ENV_COORD, raising=False)
    assert not multihost.is_multihost_env()
    assert multihost.initialize_from_env() is False
    assert not multihost.is_initialized()


@pytest.mark.parametrize("cards,rank,chip,ok", [
    (4, 2, "2", True), (2, 3, "1", True), (1, 1, "0", True),
    (4, 1, None, True), (4, 1, "3", False)])
def test_mesh_card_binding_agrees_with_the_launcher(monkeypatch, cards,
                                                    rank, chip, ok):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    if chip is None:
        monkeypatch.delenv("OMPI_TPU_CHIP", raising=False)
    else:
        monkeypatch.setenv("OMPI_TPU_CHIP", chip)
    if ok:
        assert mesh_mod.card_index(rank) == rank % cards
    else:
        with pytest.raises(RuntimeError, match="OMPI_TPU_CHIP"):
            mesh_mod.card_index(rank)
