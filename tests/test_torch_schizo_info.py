"""The port's small always-built pieces: pstat and the backtrace handlers
(``core/sysinfo.py``), the mpirun personality (``tools/schizo.py``), the
info tool (``tools/info.py``) over the framework directory
(``core/mca.framework_registry``), and the thread-level queries and
``pcontrol`` (``mpi/runtime.py``), held against the JAX package's.

The pstat, backtrace and schizo cases of
``tests/core/test_sysinfo_notifier.py`` run the JAX package's own bodies
on the port through ``tests/torch_mirror.py`` (the end-to-end case
launches the port's ``tpurun`` through the port's ``schizo``).
"""

from __future__ import annotations

import subprocess
import sys
import threading

import pytest

import tests.core.test_sysinfo_notifier as ref_sys
from tests.torch_mirror import mirror


@pytest.mark.parametrize("name", [
    "test_proc_stats_self", "test_proc_stats_other_pid",
    "test_backtrace_handlers_idempotent",
    "test_schizo_translates_mpirun_cli", "test_schizo_rejects_unknown_option",
    "test_schizo_end_to_end_mpirun"])
def test_sysinfo_case_on_the_port(name):
    mirror(getattr(ref_sys, name), True, [])()


@pytest.mark.parametrize("argv", [
    ["-np", "4", "--mca", "coll", "host", "-x", "FOO=bar",
     "--machinefile", "hf", "--map-by", "node", "--bind-to", "core",
     "--timeout", "30", "--report-bindings", "./a.out", "arg1"],
    ["-n", "2", "--map-by", "socket:PE=2", "--oversubscribe", "--", "x"],
    ["--np", "3", "-mca", "btl", "self,tcp", "--stdin", "all",
     "--tag-output", "-wdir", "/tmp", "prog"],
    ["-c", "1", "-x", "UNSET_SCHIZO_VAR", "--map-by", "numa", "a"],
])
def test_schizo_translations_equal_the_jax_package(argv, monkeypatch):
    from ompi_tpu.tools import schizo as jschizo
    from ompi_tpu_torch.tools import schizo as pschizo

    monkeypatch.delenv("UNSET_SCHIZO_VAR", raising=False)
    assert pschizo.translate_mpirun(argv) == jschizo.translate_mpirun(argv)


def test_schizo_translation_is_a_port_tpurun_command_line():
    from ompi_tpu_torch.tools import schizo, tpurun

    targv, _env = schizo.translate_mpirun(
        ["-np", "2", "--hostfile", "hf", "--map-by", "node", "./a.out"])
    args = tpurun.build_parser().parse_args(targv)
    assert (args.np, args.hostfile, args.map_by) == (2, "hf", "bynode")
    assert args.command == ["--", "./a.out"]


def test_info_lists_frameworks_components_and_vars():
    r = subprocess.run([sys.executable, "-m", "ompi_tpu_torch.tools.info"],
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    out = r.stdout
    assert out.startswith("ompi_tpu_torch version: ")
    for fw in ("btl", "coll", "errmgr", "plm", "pml", "ras", "rmaps"):
        assert f"\n  {fw} " in out, fw
    assert "components: ob1(pri=50)" in out
    for var in ("dvm_queue_max = 8", "doctor_rows_per_daemon = 8",
                "pml_eager_limit = "):
        assert var in out, var
    assert "Performance variables (MPI_T pvars):" in out
    assert "modules not loaded" not in r.stderr


def test_info_param_filter(capsys):
    from ompi_tpu_torch.tools import info

    assert info.main(["--param", "dvm_"]) == 0
    out = capsys.readouterr().out
    section = out.split("Configuration variables")[1].split(
        "Performance variables")[0]
    names = {ln.split()[0] for ln in section.splitlines()[1:] if " = " in ln}
    assert names == {"dvm_queue_max", "dvm_max_concurrent", "dvm_remediate",
                     "dvm_remediation_max", "dvm_remediate_grace_s",
                     "dvm_requeue_max", "output_dvm_verbose"}


def test_framework_registry_equals_the_jax_packages():
    """The frameworks both packages have carry the same components (the
    JAX package's ``tpu`` RAS and the port's ``gpu`` stand for each
    other; the port has no ``osc`` framework)."""
    from ompi_tpu.tools import info as jinfo
    from ompi_tpu_torch.tools import info as pinfo

    assert pinfo.load_all() == []
    jinfo.load_all()
    from ompi_tpu.core.mca import framework_registry as jreg
    from ompi_tpu_torch.core.mca import framework_registry as preg

    port = preg.all()
    for name, fw in jreg.all().items():
        if name not in port:
            continue
        want = {c for c in fw.components()} - {"tpu"}
        got = {c for c in port[name].components()} - {"gpu"}
        assert got == want, name
    with pytest.raises(Exception, match="duplicate framework"):
        from ompi_tpu_torch.core.mca import Framework

        Framework("btl")


def test_thread_queries_and_pcontrol():
    from ompi_tpu.mpi import runtime as jrt
    from ompi_tpu_torch.mpi import runtime as prt
    from tests.torch_host_harness import run_ranks

    for name in ("THREAD_SINGLE", "THREAD_FUNNELED", "THREAD_SERIALIZED",
                 "THREAD_MULTIPLE"):
        assert getattr(prt, name) == getattr(jrt, name)
    assert prt.query_thread() == prt.THREAD_MULTIPLE
    prt.pcontrol(2)
    assert prt._state["pcontrol_level"] == 2
    import ompi_tpu_torch

    for name in ("framework_registry", "Framework", "Component"):
        assert getattr(ompi_tpu_torch, name) is getattr(
            sys.modules["ompi_tpu_torch.core.mca"], name)
    # is_thread_main: false on a thread that never called init()
    seen = []
    t = threading.Thread(target=lambda: seen.append(prt.is_thread_main()))
    t.start()
    t.join()
    assert seen == [False]
    assert run_ranks(2, lambda comm: comm.size) == [2, 2]
