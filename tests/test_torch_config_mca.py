"""The port's config registry, MCA base and info tool against the JAX
package's.

- ``tools.info --level N`` (N = 1..9) lists the same variables with the
  same sources as ``ompi_tpu.tools.info --level N`` when both load the
  same modules (the JAX tool's list, mapped to the port's names), and
  with an environment and a params-file setting in force.
- Each source (file, environment, command line, ``set``) set once on a
  fresh registry of each package reads back the same value and the same
  ``VarSource`` name, and the precedence between them is the same.
- A line of ``~/.ompi_tpu/params.conf`` reads the same value and
  ``VarSource.FILE`` in fresh registries of both packages, and a
  ``./ompi-tpu-params.conf`` line still wins over it.
- Read-only, deprecated, synonym and info-level variables behave as the
  JAX package's; a deprecated variable set from outside warns once.
- The framework lifecycle: ``add_instance`` on an open framework opens
  the component, ``close_all`` closes every opened one, as the JAX
  package's.
"""

from __future__ import annotations

import json
import os
import pathlib
import subprocess
import sys

import pytest

from ompi_tpu.core import config as jcfg
from ompi_tpu.core import mca as jmca
from ompi_tpu.tools import info as jinfo
from ompi_tpu_torch.core import config as pcfg
from ompi_tpu_torch.core import mca as pmca

ROOT = pathlib.Path(__file__).resolve().parents[1]

#: prints {level: [[name, source], ...]} for levels 1..9; argv[1] is the
#: package, argv[2] the JSON list of modules its info tool loads
_LEVELS = r"""
import contextlib, importlib, io, json, re, sys
pkg, mods = sys.argv[1], json.loads(sys.argv[2])
info = importlib.import_module(pkg + ".tools.info")
info._REGISTERING_MODULES[:] = mods
rows = {}
for level in range(1, 10):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        info.main(["--level", str(level)])
    on, got = False, []
    for ln in buf.getvalue().splitlines():
        if ln.startswith("Configuration variables"):
            on = True
        elif ln.startswith("Performance variables"):
            on = False
        elif on and ln.startswith("  "):
            m = re.match(r"  (\S+) = .* \[(\w+), (\w+)\]", ln)
            got.append([m.group(1), m.group(3)])
    rows[level] = got
print("LEVELS " + json.dumps(rows))
"""


def _levels(pkg: str, env: dict) -> dict:
    mods = [m.replace("ompi_tpu.", pkg + ".", 1)
            for m in jinfo._REGISTERING_MODULES]
    r = subprocess.run([sys.executable, "-c", _LEVELS, pkg,
                        json.dumps(mods)], capture_output=True, text=True,
                       timeout=240, cwd=ROOT,
                       env={**os.environ, "PYTHONPATH": str(ROOT),
                            "JAX_PLATFORMS": "cpu", **env})
    assert r.returncode == 0, r.stderr[-3000:]
    line = [ln for ln in r.stdout.splitlines() if ln.startswith("LEVELS ")]
    return json.loads(line[-1][len("LEVELS "):])


def test_info_levels_list_the_same_variables_and_sources(tmp_path):
    conf = tmp_path / "params.conf"
    conf.write_text("pml_eager_limit = 8192\n")
    env = {"OMPI_TPU_PARAM_FILE": str(conf),
           "OMPI_TPU_MCA_coll_host_allreduce_algorithm": "ring"}
    jax_rows = _levels("ompi_tpu", env)
    port_rows = _levels("ompi_tpu_torch", env)
    assert jax_rows == port_rows
    # every registration leaves the default level, USER_ALL (3)
    assert jax_rows["1"] == jax_rows["2"] == []
    assert all(jax_rows[str(n)] == jax_rows["3"] for n in range(3, 10))
    sources = dict(map(tuple, port_rows["9"]))
    assert sources["pml_eager_limit"] == "file"
    assert sources["coll_host_allreduce_algorithm"] == "env"
    assert len(sources) > 100
    assert set(sources.values()) == {"default", "file", "env"}


@pytest.mark.parametrize("cfg", [jcfg, pcfg], ids=["jax", "port"])
def test_each_source_reads_back(cfg, tmp_path, monkeypatch):
    conf = tmp_path / "p.conf"
    conf.write_text("fw_from_file = 11\nfw_all = 1\n")
    monkeypatch.setenv("OMPI_TPU_PARAM_FILE", str(conf))
    monkeypatch.setenv("OMPI_TPU_MCA_fw_from_env", "12")
    monkeypatch.setenv("OMPI_TPU_MCA_fw_all", "2")
    reg = cfg.VarRegistry()
    reg.load_cli([("fw_from_cli", "13"), ("fw_all", "3")])
    got = {}
    for name in ("from_file", "from_env", "from_cli", "from_set", "all"):
        v = reg.register(cfg.Var("fw", name, cfg.VarType.INT, 0))
        got[name] = (v.value, v.source.name)
    reg.set("fw_from_set", 14)
    got["from_set"] = (reg.get("fw_from_set"),
                       reg.lookup("fw_from_set").source.name)
    assert got == {"from_file": (11, "FILE"), "from_env": (12, "ENV"),
                   "from_cli": (13, "COMMAND_LINE"), "from_set": (14, "SET"),
                   "all": (3, "COMMAND_LINE")}
    reg.set("fw_all", 4)
    assert (reg.get("fw_all"), reg.lookup("fw_all").source) == (
        4, cfg.VarSource.SET)
    assert [s.name for s in cfg.VarSource] == [
        "DEFAULT", "FILE", "ENV", "COMMAND_LINE", "SET"]
    assert [int(x) for x in cfg.InfoLevel] == list(range(1, 10))



def test_home_params_file_reads_as_the_jax_packages(tmp_path, monkeypatch):
    home = tmp_path / "home"
    (home / ".ompi_tpu").mkdir(parents=True)
    (home / ".ompi_tpu" / "params.conf").write_text(
        "fw_home = 21\nfw_both = 22\n")
    work = tmp_path / "work"
    work.mkdir()
    (work / "ompi-tpu-params.conf").write_text("fw_both = 23\n")
    monkeypatch.setenv("HOME", str(home))
    monkeypatch.delenv("OMPI_TPU_PARAM_FILE", raising=False)
    monkeypatch.chdir(work)
    got = {}
    for label, cfg in (("jax", jcfg), ("port", pcfg)):
        reg = cfg.VarRegistry()
        got[label] = {
            name: (v.value, v.source.name) for name, v in (
                (n, reg.register(cfg.Var("fw", n, cfg.VarType.INT, 0)))
                for n in ("home", "both"))}
    assert got["port"] == got["jax"] == {"home": (21, "FILE"),
                                         "both": (23, "FILE")}

def _flags(cfg, monkeypatch, capsys) -> dict:
    monkeypatch.setenv("OMPI_TPU_MCA_fw_ro", "9")
    monkeypatch.setenv("OMPI_TPU_MCA_fw_old", "5")
    reg = cfg.VarRegistry()
    ro = reg.register(cfg.Var("fw", "ro", cfg.VarType.INT, 1,
                              read_only=True))
    dep = reg.register(cfg.Var("fw", "dep", cfg.VarType.INT, 1,
                               deprecated=True, synonyms=("fw_old",)))
    lvl = reg.register(cfg.Var("fw", "dev", cfg.VarType.INT, 1,
                               info_level=cfg.InfoLevel.DEV_BASIC))
    out = {"ro": (ro.value, ro.source.name), "dep": (dep.value,
                                                     dep.source.name),
           "syn": reg.get("fw_old"), "lvl": int(lvl.info_level)}
    try:
        reg.set("fw_ro", 2)
        out["ro_set"] = "accepted"
    except ValueError as e:
        out["ro_set"] = str(e)
    reg.set("fw_old", 6)
    out["dep_set"] = (dep.value, dep.source.name)
    out["dump_user"] = reg.dump(cfg.InfoLevel.USER_ALL).splitlines()
    out["dump_dev"] = reg.dump(cfg.InfoLevel.DEV_BASIC).splitlines()
    out["stderr"] = capsys.readouterr().err
    return out


def test_flags_behave_as_the_jax_package(monkeypatch, capsys):
    j = _flags(jcfg, monkeypatch, capsys)
    p = _flags(pcfg, monkeypatch, capsys)
    j_err, p_err = j.pop("stderr"), p.pop("stderr")
    assert j == p
    assert p["ro"] == (1, "DEFAULT") and p["ro_set"].endswith("read-only")
    assert p["dep"] == (5, "ENV") and p["dep_set"] == (6, "SET")
    assert not any("fw_dev" in ln for ln in p["dump_user"])
    assert any("fw_dev" in ln for ln in p["dump_dev"])
    # both ignore the read-only override out loud; the port (as Open
    # MPI's mca_base_var) also warns, once, on the deprecated variable
    assert "read-only variable fw_ro" in j_err
    assert "read-only variable fw_ro" in p_err
    assert p_err.count("fw_dep is deprecated") == 1
    assert "deprecated" not in j_err


@pytest.mark.parametrize("pkg", [(jmca, jcfg), (pmca, pcfg)],
                         ids=["jax", "port"])
def test_framework_lifecycle(pkg, request):
    mca, cfg = pkg
    name = f"tfw_life_{request.node.callspec.id}_x"
    fw = mca.Framework(name)
    events = []

    class C(mca.Component):
        NAME = "c"

        def open(self):
            events.append(("open", self.full_name))

        def close(self):
            events.append(("close", self.full_name))

    class D(C):
        NAME = "d"

    fw.add_instance(C())
    fw.open()
    fw.add_instance(D())      # the framework is open: d opens at once
    cfg.set_var(f"{name}_", "^d")
    fw.open()
    mca.framework_registry.close_all()
    fw.close()                # idempotent
    assert events[:2] == [("open", f"{name}/c"), ("open", f"{name}/d")]
    assert sorted(events[2:]) == [("close", f"{name}/c"),
                                  ("close", f"{name}/d")]
    assert [c.NAME for c in fw.select_all()] == ["c"]
    assert events[-1] == ("open", f"{name}/c")
    with pytest.raises(mca.ComponentError):
        fw.add_instance(C())
