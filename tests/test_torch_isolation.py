"""The port stands alone: importing ompi_tpu_torch loads neither JAX, nor
the JAX package, nor what the JAX package trains with (optax,
ml_dtypes); its sources import none of them, and its entry points refuse
to drop quietly to the CPU when no CUDA is present."""

from __future__ import annotations

import ast
import json
import os
import pathlib
import re
import shutil
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "ompi_tpu_torch"

_PROBE = """
import importlib, json, pkgutil, sys
import ompi_tpu_torch
names = ["ompi_tpu_torch"]
for m in pkgutil.walk_packages(ompi_tpu_torch.__path__, "ompi_tpu_torch."):
    importlib.import_module(m.name)
    names.append(m.name)
for n in ompi_tpu_torch.__all__:
    getattr(ompi_tpu_torch, n)
bad = sorted(k for k in sys.modules
             if k == "jax" or k.startswith(("jax.", "jaxlib"))
             or k in ("optax", "ml_dtypes")
             or k.startswith(("optax.", "ml_dtypes."))
             or k == "ompi_tpu" or k.startswith("ompi_tpu."))
print(json.dumps({"imported": names, "bad": bad}))
"""


def test_import_loads_no_jax_and_no_jax_package():
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["bad"] == []
    for mod in ("ompi_tpu_torch.ops.flash_attention",
                "ompi_tpu_torch.ops.remote_dma",
                "ompi_tpu_torch.ops.symmetric",
                "ompi_tpu_torch.mpi.constants",
                "ompi_tpu_torch.mpi.op",
                "ompi_tpu_torch.mpi.device_comm",
                "ompi_tpu_torch.mpi.osc",
                "ompi_tpu_torch.shmem.device",
                "ompi_tpu_torch.parallel.mesh",
                "ompi_tpu_torch.parallel.collectives",
                "ompi_tpu_torch.parallel.zero",
                "ompi_tpu_torch.parallel.moe",
                "ompi_tpu_torch.models.decode",
                "ompi_tpu_torch.models.weights",
                "ompi_tpu_torch.models.transformer",
                "ompi_tpu_torch.models.optim",
                "ompi_tpu_torch.models.data",
                "ompi_tpu_torch.core.config",
                "ompi_tpu_torch.core.buffer",
                "ompi_tpu_torch.core.mca",
                "ompi_tpu_torch.mpi.group",
                "ompi_tpu_torch.mpi.comm",
                "ompi_tpu_torch.mpi.coll",
                "ompi_tpu_torch.mpi.coll.rules",
                "ompi_tpu_torch.mpi.coll.selfcoll",
                "ompi_tpu_torch.mpi.coll.xla",
                "ompi_tpu_torch.mpi.mpiext",
                "ompi_tpu_torch.mpi.datatype",
                "ompi_tpu_torch.core.output",
                "ompi_tpu_torch.core.dss",
                "ompi_tpu_torch.core.sysinfo",
                "ompi_tpu_torch.mpi.request",
                "ompi_tpu_torch.mpi.btl",
                "ompi_tpu_torch.mpi.pml",
                "ompi_tpu_torch.mpi.coll.base",
                "ompi_tpu_torch.mpi.coll.host",
                "ompi_tpu_torch.mpi.runtime",
                "ompi_tpu_torch.runtime.pmix",
                "ompi_tpu_torch.runtime.job",
                "ompi_tpu_torch.runtime.state",
                "ompi_tpu_torch.runtime.rmaps",
                "ompi_tpu_torch.runtime.ras",
                "ompi_tpu_torch.runtime.launcher",
                "ompi_tpu_torch.tools.tpurun",
                "ompi_tpu_torch.parallel.multihost",
                "ompi_tpu_torch.examples.hello",
                "ompi_tpu_torch.examples.ring",
                "ompi_tpu_torch.examples.device_allreduce",
                "ompi_tpu_torch.core.hwtopo",
                "ompi_tpu_torch.tools.tune",
                "ompi_tpu_torch.parallel.pipeline",
                "ompi_tpu_torch.ckpt",
                "ompi_tpu_torch.ckpt.store",
                "ompi_tpu_torch.ckpt.dcp_store",
                "ompi_tpu_torch.mpi.info",
                "ompi_tpu_torch.mpi.errhandler",
                "ompi_tpu_torch.examples.pipeline",
                "ompi_tpu_torch._native",
                "ompi_tpu_torch.core.shmseg",
                "ompi_tpu_torch.mpi.btl_shm",
                "ompi_tpu_torch.mpi.coll.shm",
                "ompi_tpu_torch.mpi.coll.nbc",
                "ompi_tpu_torch.mpi.coll.persistent",
                "ompi_tpu_torch.mpi.topo",
                "ompi_tpu_torch.tools.host_bench",
                "ompi_tpu_torch.examples.persistent_coll",
                "ompi_tpu_torch.examples.cart_halo",
                *_TRACE_PLANE, *_FT_PLANE):
        assert mod in res["imported"]


#: the trace plane's modules, tools and example: none imports torch
_TRACE_PLANE = ("ompi_tpu_torch.mpi.mpit", "ompi_tpu_torch.mpi.trace",
                "ompi_tpu_torch.mpi.monitoring",
                "ompi_tpu_torch.core.memchecker",
                "ompi_tpu_torch.runtime.doctor",
                "ompi_tpu_torch.runtime.metrics",
                "ompi_tpu_torch.runtime.timeline",
                "ompi_tpu_torch.runtime.clocksync",
                "ompi_tpu_torch.tools.trace_export",
                "ompi_tpu_torch.tools.hang_doctor",
                "ompi_tpu_torch.tools.timeline",
                "ompi_tpu_torch.tools.straggler_report",
                "ompi_tpu_torch.examples.trace_demo")


#: the fault-tolerance plane's modules and example: none imports torch
#: (the snapshot store's restore path imports it only to load tensors)
_FT_PLANE = ("ompi_tpu_torch.mpi.ft", "ompi_tpu_torch.runtime.errmgr",
             "ompi_tpu_torch.runtime.notifier",
             "ompi_tpu_torch.runtime.ftevents",
             "ompi_tpu_torch.testing.faultinject",
             "ompi_tpu_torch.ckpt.snapc", "ompi_tpu_torch.ckpt.msglog",
             "ompi_tpu_torch.examples.shrink_allreduce")


def test_host_plane_loads_neither_torch_nor_jax():
    """The same-host data plane (shm rings, the coll/shm arena, the four
    native executors) runs a 3-rank in-process job without importing
    torch, JAX or the JAX package, and so do the trace plane's and the
    fault-tolerance plane's modules, tools and examples (imported here,
    with the timeline armed over the job)."""
    probe = (
        "import importlib, sys, numpy as np\n"
        f"for m in {_TRACE_PLANE + _FT_PLANE!r}:\n"
        "    importlib.import_module(m)\n"
        "from ompi_tpu_torch.mpi import trace\n"
        "trace.enable(rank=0)\n"
        "from tests.torch_host_harness import run_ranks\n"
        "from ompi_tpu_torch import _native\n"
        "assert _native.available() and _native.arena_available()\n"
        "assert _native.net_available() and _native.fastdss()\n"
        "def body(c):\n"
        "    s = c.allreduce(np.arange(4.0) + c.rank)\n"
        "    c.send(s, dest=(c.rank + 1) % c.size, tag=1)\n"
        "    r = c.recv(source=(c.rank - 1) % c.size, tag=1)\n"
        "    return (c.coll.providers['allreduce'],\n"
        "            c._coll_shm_state.mode,\n"
        "            c.pml.endpoint.route((c.rank + 1) % c.size),\n"
        "            c.pml._eng is not None, r.tolist())\n"
        "print(run_ranks(3, body, btl='^proc'))\n"
        "assert trace.disable().events_total > 0\n"
        "print(sorted(k for k in sys.modules if k.split('.')[0] in "
        "('torch', 'jax', 'jaxlib', 'ompi_tpu')))")
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    runs, mods = out.stdout.strip().splitlines()[-2:]
    assert runs == str([("shm", "arena", "shm", True,
                         [3.0, 6.0, 9.0, 12.0])] * 3)
    assert mods == "[]"


_BUILD_PROBE = """
import json, os, sys
from ompi_tpu_torch import _native
_native.BUILD_DIR = sys.argv[1]
events = []
def hook(event, args):
    if event in ("open", "os.rename", "os.remove", "os.mkdir",
                 "subprocess.Popen"):
        events.append((event, [str(a) for a in args]))
sys.addaudithook(hook)
ok = [_native.lib() is not None, _native.arena() is not None,
      _native.net() is not None, _native.fastdss() is not None]
print(json.dumps({"ok": ok, "events": events}))
"""


def test_native_build_reads_the_ports_sources_and_writes_its_build_dir():
    """A fresh build of the four libraries (into a new directory under
    the port's build directory): g++ compiles only sources under
    ``ompi_tpu_torch/_native/``, every file the loader writes, renames or
    removes lies in that build directory, which git ignores, and every
    source it reads is the port's."""
    from ompi_tpu_torch import _native

    build = pathlib.Path(_native.BUILD_DIR) / f"isolation-{os.getpid()}"
    src_dir = str(PKG / "_native")
    try:
        out = subprocess.run([sys.executable, "-c", _BUILD_PROBE,
                              str(build)], cwd=ROOT, capture_output=True,
                             text=True, timeout=600, check=True)
        res = json.loads(out.stdout.strip().splitlines()[-1])
        assert res["ok"] == [True] * 4
        compiles = [a for e, a in res["events"] if e == "subprocess.Popen"]
        assert len(compiles) == 4
        for args in compiles:
            argv = ast.literal_eval(args[1])   # the argv list, repr'd
            assert argv[0] == "g++"
            assert argv[-1].startswith(src_dir + os.sep), argv
            out_path = argv[argv.index("-o") + 1]
            assert out_path.startswith(str(build) + os.sep), argv
        for event, args in res["events"]:
            if event == "open":
                path, mode, flags = args[0], args[1], int(args[2])
                writing = ("w" in mode or "a" in mode or "+" in mode
                           or flags & (os.O_WRONLY | os.O_RDWR))
                if writing:
                    assert path.startswith(str(build) + os.sep), args
                elif path.endswith((".c", ".cpp")):
                    assert path.startswith(src_dir + os.sep), args
            elif event in ("os.rename", "os.remove", "os.mkdir"):
                for path in args[:2 if event == "os.rename" else 1]:
                    assert path.startswith(str(build)), (event, args)
        rel = build.relative_to(ROOT) / "x.so"
        assert subprocess.run(["git", "check-ignore", "-q", str(rel)],
                              cwd=ROOT).returncode == 0
    finally:
        shutil.rmtree(build, ignore_errors=True)


def test_ckpt_loads_no_ml_dtypes_and_no_jax():
    """The stores write and read bf16 and float8 leaves through their
    integer bits: importing them and round-tripping a bf16 tensor loads
    neither ml_dtypes nor JAX."""
    probe = (
        "import sys, tempfile, torch\n"
        "from ompi_tpu_torch.ckpt import SnapshotStore\n"
        "st = SnapshotStore(tempfile.mkdtemp())\n"
        "st.write_rank(0, 0, {'w': torch.ones(2, dtype=torch.bfloat16)})\n"
        "st.commit(0, nranks=1)\n"
        "assert st.load_rank(0, 0)['w'].dtype == torch.bfloat16\n"
        "print(sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'ml_dtypes', 'optax', 'ompi_tpu')))")
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    assert out.stdout.strip().splitlines()[-1] == "[]"


_IMPORT = re.compile(r"^\s*(?:import|from)\s+(jax\b|jaxlib\b|optax\b|"
                     r"ml_dtypes\b|ompi_tpu\b(?!_))", re.M)


@pytest.mark.parametrize("path", sorted(
    [str(p.relative_to(ROOT)) for p in PKG.rglob("*.py")]
    + ["chip_smoke.py", "tests/torch_ranks.py",
       "tests/torch_host_harness.py"]))
def test_sources_import_no_jax(path):
    src = (ROOT / path).read_text()
    assert not _IMPORT.search(src), path
    assert "importlib.import_module(\"ompi_tpu." not in src
    assert "importlib.import_module('ompi_tpu." not in src


def test_entry_points_refuse_the_cpu_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks a machine without CUDA")
    from ompi_tpu_torch.models.data import prefetch
    from ompi_tpu_torch.models.decode import make_decoder
    from ompi_tpu_torch.models.transformer import (TransformerConfig,
                                                   init_params, make_forward,
                                                   make_loss_fn,
                                                   make_train_loop,
                                                   make_train_step)
    from ompi_tpu_torch.models.weights import from_jax_params
    from ompi_tpu_torch.parallel.mesh import Mesh, make_mesh

    cfg = TransformerConfig(vocab=97, d_model=64, n_heads=4, n_layers=2,
                            d_ff=128, seq=64)
    from ompi_tpu_torch.mpi.device_comm import device_world

    for call in (lambda: make_mesh(),
                 lambda: make_mesh({"dp": 1, "sp": 1, "tp": 1}),
                 lambda: make_mesh(rank=0, world_size=1,
                                   init_method="tcp://127.0.0.1:1"),
                 lambda: device_world(),
                 lambda: make_decoder(cfg, Mesh({"dp": 1, "sp": 1, "tp": 1}),
                                      max_new=2),
                 lambda: from_jax_params(init_params(cfg), cfg),
                 lambda: from_jax_params(init_params(cfg), cfg, train=True),
                 lambda: prefetch(iter([]))):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()

    class _CudaMesh:  # a mesh that claims the card, bypassing Mesh's check
        shape = {"dp": 1, "sp": 1, "tp": 1}
        axis_names = ("dp", "sp", "tp")
        device = torch.device("cuda")

    for call in (lambda: make_decoder(cfg, _CudaMesh(), max_new=2),
                 lambda: make_forward(cfg, _CudaMesh()),
                 lambda: make_loss_fn(cfg, _CudaMesh()),
                 lambda: make_train_step(cfg, _CudaMesh()),
                 lambda: make_train_loop(cfg, _CudaMesh())):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


def _run_smoke(cwd):
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          capture_output=True, text=True, timeout=120)


def test_chip_smoke_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("checks a machine without CUDA")
    out = _run_smoke(ROOT)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = _run_smoke(tmp_path)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
