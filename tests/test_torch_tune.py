"""The port's measured collective-crossover tuner
(``ompi_tpu_torch.tools.tune``) and coll/xla's use of its file: the seven
cases of tests/mpi/test_tune.py, on 4 gloo rank processes and on one
rank.

On 4 ranks every rank derives the same text (each cell's time is the MAX
over the ranks) and only rank 0 writes; the file has the JAX package's
provenance keys and rules for the same collectives as the JAX package's
tuner on 4 virtual CPU devices.  At one rank the rules are withheld.
"""

from __future__ import annotations

import os

import pytest

jax = pytest.importorskip("jax")

from ompi_tpu.mpi.coll import rules as jrules  # noqa: E402
from ompi_tpu.tools.tune import tune_device_colls as jtune  # noqa: E402
from ompi_tpu_torch.mpi.coll import rules, xla  # noqa: E402
from ompi_tpu_torch.mpi.device_comm import device_world  # noqa: E402
from ompi_tpu_torch.parallel.mesh import Mesh  # noqa: E402
from ompi_tpu_torch.tools.tune import (DEFAULT_OUT,  # noqa: E402
                                       DEFAULT_SIZES, tune_device_colls)
from tests import torch_ranks as TR  # noqa: E402


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    p = TR.RankPool(tmp_path_factory.mktemp("ranks"))
    yield p
    p.close()


@pytest.fixture(scope="module")
def four(pool, tmp_path_factory):
    """One 4-rank tuning run at two sizes (shared by the cases that read
    it): (per-rank results, output directory)."""
    out = tmp_path_factory.mktemp("tune4")
    return pool.run(TR.tune, sizes=(1 << 10, 1 << 14), iters=2,
                    out_dir=str(out)), out


def _solo():
    return device_world(Mesh({"world": 1}, device="cpu"))


def test_tune_emits_rules_with_provenance(four):
    res, out = four
    rs = rules.load_rules(str(out / "out_0.conf"))
    assert rs.meta["platform"] == "cpu" and rs.meta["device_kind"] == "cpu"
    assert int(rs.meta["n_devices"]) == 4
    assert len(rs) >= 3
    text, table, _ = res[0]
    for coll in ("allreduce", "allgather", "bcast"):
        assert rs.lookup(coll, 4, 4096) in xla.XlaColl.ALGORITHMS[coll]
        assert table[coll], f"no measurements for {coll}"
        assert set(table[coll]) == {"4KiB", "64KiB"}


def test_every_rank_derives_the_same_text_and_only_rank_0_writes(four):
    res, out = four
    texts = {r[0] for r in res}
    assert len(texts) == 1
    assert [r[2] for r in res] == [["out_0.conf"]] * 4
    assert (out / "out_0.conf").read_text() == res[0][0]


def test_the_file_matches_the_jax_package_tuners(four, tmp_path):
    res, _ = four
    jtext, _ = jtune(jax.devices()[:4], sizes=(1 << 10, 1 << 14),
                     out_path=str(tmp_path / "j.conf"), iters=2)
    mine, theirs = rules.parse(res[0][0]), jrules.parse(jtext)
    assert set(mine.meta) == set(theirs.meta)
    assert mine.meta["n_devices"] == theirs.meta["n_devices"] == "4"
    assert set(mine._by_coll) == set(theirs._by_coll) == {
        "allreduce", "allgather", "bcast"}


def test_tune_single_device_withholds_rules(tmp_path):
    out = tmp_path / "solo.conf"
    text, table = tune_device_colls(_solo().mesh, sizes=(1 << 10,),
                                    out_path=str(out), iters=1)
    rs = rules.load_rules(str(out))
    assert len(rs) == 0                   # provenance only, no rules
    assert rs.meta == {"platform": "cpu", "device_kind": "cpu",
                       "n_devices": "1"}
    assert out.read_text() == text
    assert set(table["allreduce"]["4KiB"]) == set(
        xla.XlaColl.ALGORITHMS["allreduce"])


def test_provenance_lines_parse():
    rs = rules.parse("#! platform=cuda\n#! n_devices=8\n"
                     "allreduce 0 0 psum\n")
    assert rs.meta == {"platform": "cuda", "n_devices": "8"}
    assert rs.lookup("allreduce", 4, 1) == "psum"


def test_measured_rules_platform_gate(tmp_path, monkeypatch):
    """A file measured on another platform than the mesh's is ignored."""
    dc = _solo()
    monkeypatch.setattr(xla, "_measured_cache", [])
    foreign = tmp_path / "foreign.conf"
    foreign.write_text("#! platform=cuda\nallreduce 0 0 rs_ag\n")
    monkeypatch.setattr(xla, "_MEASURED_PATH", str(foreign))
    assert xla._measured_rules(dc) is None
    native = tmp_path / "native.conf"
    native.write_text("#! platform=cpu\nallreduce 0 0 segmented\n")
    monkeypatch.setattr(xla, "_MEASURED_PATH", str(native))
    rs = xla._measured_rules(dc)
    assert rs is not None and rs.lookup("allreduce", 8, 123) == "segmented"


def test_decide_consults_measured_rules(tmp_path, monkeypatch):
    """_decide: forced var > user rules > measured rules > fixed."""
    dc = _solo()
    comp = xla.XlaColl()
    native = tmp_path / "m.conf"
    native.write_text(f"#! platform=cpu\n#! n_devices={dc.size}\n"
                      "allreduce 0 0 psum\n"
                      "allreduce 0 8192 segmented\n")
    monkeypatch.setattr(xla, "_MEASURED_PATH", str(native))
    monkeypatch.setattr(xla, "_measured_cache", [])
    assert comp._decide("allreduce", None, dc, 1024) == "psum"
    assert comp._decide("allreduce", None, dc, 1 << 20) == "segmented"


def test_measured_rules_size_gate(tmp_path, monkeypatch):
    """Crossovers measured on an 8× larger mesh do not steer a small
    communicator (> 2× size mismatch falls back to the fixed decision)."""
    dc = _solo()
    comp = xla.XlaColl()
    big = tmp_path / "big.conf"
    big.write_text(f"#! platform=cpu\n#! n_devices={dc.size * 8}\n"
                   "allreduce 0 0 segmented\n")
    monkeypatch.setattr(xla, "_MEASURED_PATH", str(big))
    monkeypatch.setattr(xla, "_measured_cache", [])
    assert comp._decide("allreduce", None, dc, 1024) == "psum"


def test_tune_never_ships_lossy_rules(four):
    text, table, _ = four[0][0]
    assert any("qint8" in row for row in table["allreduce"].values())
    for ln in text.splitlines():
        if ln.startswith("allreduce"):
            assert "qint8" not in ln, ln


def test_default_out_is_the_ports_and_absent():
    """The rules file coll/xla reads is the port's own; one card's file
    holds no rules, so none is shipped until a multi-card run writes it."""
    assert DEFAULT_OUT == xla._MEASURED_PATH
    assert not os.path.exists(DEFAULT_OUT)
    assert DEFAULT_SIZES[0] * 4 == 4 << 10 and DEFAULT_SIZES[-1] * 4 == 64 << 20
