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
                "ompi_tpu_torch.examples.generate",
                "ompi_tpu_torch.examples.train",
                "ompi_tpu_torch.examples.osc_device_window",
                "ompi_tpu_torch.tools.flagship",
                "ompi_tpu_torch.tools.xprof_capture",
                "ompi_tpu_torch.tools.step_breakdown",
                "ompi_tpu_torch.tools.cost_analysis",
                "ompi_tpu_torch.tools.mfu_sweep",
                *_TRACE_PLANE, *_FT_PLANE, *_IO_PLANE, *_OSC_PLANE,
                *_DPM_PLANE, *_TREE_PLANE, *_DVM_PLANE, *_COLL_DEMO):
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


#: MPI-IO's module and example: neither imports torch (the sharded
#: store, ``ckpt.store``, imports it only to load bf16/float8 leaves)
_IO_PLANE = ("ompi_tpu_torch.mpi.io", "ompi_tpu_torch.examples.mpiio_darray")


#: the host windows, OpenSHMEM and their examples: none imports torch
#: (``DeviceWindow`` and ``shmem.device`` load it when they are used)
_OSC_PLANE = ("ompi_tpu_torch.mpi.osc", "ompi_tpu_torch.shmem",
              "ompi_tpu_torch.shmem.api",
              "ompi_tpu_torch.examples.ring_oshmem",
              "ompi_tpu_torch.examples.oshmem_shmalloc",
              "ompi_tpu_torch.examples.oshmem_circular_shift",
              "ompi_tpu_torch.examples.oshmem_symmetric_data",
              "ompi_tpu_torch.examples.oshmem_max_reduction",
              "ompi_tpu_torch.examples.oshmem_strided_puts",
              "ompi_tpu_torch.examples.rma_pscw",
              "ompi_tpu_torch.examples.connectivity",
              "ompi_tpu_torch.examples.mprobe_task_queue")


#: dynamic process management, the mpi4py facade and its examples: none
#: imports torch (the facade loads it only for a tensor the caller passed)
_DPM_PLANE = ("ompi_tpu_torch.mpi.dpm", "ompi_tpu_torch.mpi._mpmd_dispatch",
              "ompi_tpu_torch.compat", "ompi_tpu_torch.compat.MPI",
              "ompi_tpu_torch.examples.mpi4py_ring",
              "ompi_tpu_torch.examples.mpi4py_cart_halo",
              "ompi_tpu_torch.examples.facade_collectives_bench")

#: the daemon tree's modules (an orted and a host job's HNP load them)
_TREE_PLANE = ("ompi_tpu_torch.core.netpatterns", "ompi_tpu_torch.runtime.rml",
               "ompi_tpu_torch.runtime.orted", "ompi_tpu_torch.runtime.plm",
               "ompi_tpu_torch.runtime.rtc", "ompi_tpu_torch.runtime.clean",
               "ompi_tpu_torch.runtime.clocksync",
               "ompi_tpu_torch.tools.tpurun")

#: the standing DVM and the fleet tools (a host pool's HNP loads dvm;
#: ``info`` imports its torch modules only when it runs)
_DVM_PLANE = ("ompi_tpu_torch.runtime.dvm", "ompi_tpu_torch.testing.simfleet",
              "ompi_tpu_torch.tools.sync", "ompi_tpu_torch.tools.schizo",
              "ompi_tpu_torch.tools.info", "ompi_tpu_torch.tools.chaos_soak",
              "ompi_tpu_torch.tools.killorphans")

#: the on-node collective demo (a host job's ranks import it)
_COLL_DEMO = ("ompi_tpu_torch.examples.shm_coll_demo",)


def test_host_plane_loads_neither_torch_nor_jax():
    """The same-host data plane (shm rings, the coll/shm arena, the four
    native executors) runs a 3-rank in-process job without importing
    torch, JAX or the JAX package, and so do the trace plane's and the
    fault-tolerance plane's modules, tools and examples (imported here,
    with the timeline armed over the job); so does a numpy write and read
    through MPI-IO's ``File`` and a save and load of ``ShardedSnapshotStore``
    on the same ranks, a window put and fence, a ``SharedWindow``
    fetch_add, a SHMEM ``atomic_fetch_add`` on a one-PE world, and a
    facade ``Allreduce`` and a connect/accept between two in-process
    jobs; the daemon tree's modules (rml, orted, plm, rtc, clean,
    clocksync, tpurun) are imported too, and so are the standing DVM's
    and the fleet tools' (dvm, simfleet, sync, schizo, info, chaos_soak,
    killorphans) and the on-node collective demo."""
    probe = (
        "import importlib, shutil, sys, tempfile, numpy as np\n"
        f"for m in {_TRACE_PLANE + _FT_PLANE + _IO_PLANE + _OSC_PLANE + _DPM_PLANE + _TREE_PLANE + _DVM_PLANE + _COLL_DEMO!r}:\n"
        "    importlib.import_module(m)\n"
        "from ompi_tpu_torch.mpi import io\n"
        "from ompi_tpu_torch.ckpt import ShardedSnapshotStore\n"
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
        "tmp = tempfile.mkdtemp()\n"
        "def iobody(c):\n"
        "    f = io.File.open(c, tmp + '/f.bin', io.MODE_RDWR | io.MODE_CREATE)\n"
        "    f.write_at_all(c.rank * 2, np.full(2, c.rank, np.uint8))\n"
        "    back = f.read_at_all(0, 6)\n"
        "    f.close()\n"
        "    st = ShardedSnapshotStore(tmp, c, job='iso')\n"
        "    st.save(0, {'w': np.arange(2.0) + c.rank})\n"
        "    got = st.load(0)['w']\n"
        "    return back.tolist(), got.tolist(), type(got).__name__\n"
        "print(run_ranks(3, iobody, btl='^proc'))\n"
        "shutil.rmtree(tmp)\n"
        "from ompi_tpu_torch.mpi import osc\n"
        "from ompi_tpu_torch.mpi.constants import COMM_TYPE_SHARED\n"
        "def oscbody(c):\n"
        "    w = osc.Window(c, size=4, dtype=np.int64)\n"
        "    w.fence()\n"
        "    w.put((c.rank + 1) % c.size, np.array([c.rank + 1]))\n"
        "    w.fence()\n"
        "    got = int(w.buf[0])\n"
        "    w.free()\n"
        "    sw = osc.SharedWindow(c.split_type(COMM_TYPE_SHARED), 1,\n"
        "                          np.int64)\n"
        "    sw.fetch_add(0, 0, 1)\n"
        "    sw.sync()\n"
        "    n = int(sw.shared_query(0)[0])\n"
        "    sw.free()\n"
        "    return got, n\n"
        "print(run_ranks(3, oscbody, btl='^proc'))\n"
        "from ompi_tpu_torch import shmem\n"
        "shmem.init()\n"
        "a = shmem.array((1,), np.int64)\n"
        "t = [int(shmem.atomic_fetch_add(a, 0, 1)) for _ in range(3)]\n"
        "shmem.finalize()\n"
        "print(t)\n"
        "from ompi_tpu_torch.compat import MPI\n"
        "from ompi_tpu_torch.mpi import dpm\n"
        "def facade(c):\n"
        "    out = np.zeros(2)\n"
        "    MPI.Comm(c).Allreduce(np.ones(2), out)\n"
        "    return out.tolist()\n"
        "port = dpm.open_port()\n"
        "import threading\n"
        "res = []\n"
        "th = threading.Thread(target=lambda: res.append(run_ranks(\n"
        "    1, lambda c: dpm.accept(c, port).recv(source=0, tag=1)\n"
        "    .tolist())))\n"
        "th.start()\n"
        "run_ranks(1, lambda c: dpm.connect(c, port).send(\n"
        "    np.arange(3), dest=0, tag=1))\n"
        "th.join()\n"
        "print(run_ranks(2, facade, btl='^proc'), res)\n"
        "assert trace.disable().events_total > 0\n"
        "print(sorted(k for k in sys.modules if k.split('.')[0] in "
        "('torch', 'jax', 'jaxlib', 'ompi_tpu')))")
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    runs, io_runs, osc_runs, tickets, dpm_runs, mods = \
        out.stdout.strip().splitlines()[-6:]
    assert runs == str([("shm", "arena", "shm", True,
                         [3.0, 6.0, 9.0, 12.0])] * 3)
    assert io_runs == str([([0, 0, 1, 1, 2, 2], [r + 0.0, r + 1.0],
                            "ndarray") for r in range(3)])
    assert osc_runs == str([(3, 3), (1, 3), (2, 3)])
    assert tickets == "[0, 1, 2]"
    assert dpm_runs == "[[2.0, 2.0], [2.0, 2.0]] [[[0, 1, 2]]]"
    assert mods == "[]"


def test_window_and_shmem_job_loads_neither_torch_nor_jax():
    """A 3-rank host job under the port's launcher that puts into a
    window, adds to a ``SharedWindow``'s counter and draws SHMEM
    fetch_add tickets imports neither torch, nor JAX, nor the JAX
    package."""
    prog = (
        "import sys, numpy as np\n"
        "from ompi_tpu_torch import shmem\n"
        "from ompi_tpu_torch.mpi import osc\n"
        "c = shmem.init()\n"
        "w = osc.Window(c, size=1, dtype=np.int64)\n"
        "w.fence()\n"
        "w.accumulate(0, np.array([1]))\n"
        "w.fence()\n"
        "acc = int(w.get(0, 1)[0])\n"
        "w.free()\n"
        "sw = osc.SharedWindow(c, 1, np.int64)\n"
        "sw.fetch_add(0, 0, 2)\n"
        "sw.sync()\n"
        "n = int(sw.shared_query(0)[0])\n"
        "sw.free()\n"
        "a = shmem.array((1,), np.int64)\n"
        "t = int(shmem.atomic_fetch_add(a, 0, 1))\n"
        "shmem.barrier_all()\n"
        "shmem.finalize()\n"
        "print(acc, n, 0 <= t < 3, sorted(k for k in sys.modules\n"
        "      if k.split('.')[0] in ('torch', 'jax', 'jaxlib', 'ompi_tpu')))")
    p = subprocess.run(
        [sys.executable, "-m", "ompi_tpu_torch.tools.tpurun", "-np", "3",
         "--no-tag-output", "--", sys.executable, "-c", prog], cwd=ROOT,
        capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.splitlines() == ["3 6 True []"] * 3


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
    + ["chip_smoke.py", "ompi_tpu_torch/tools/asan_native.sh",
       "tests/torch_ranks.py",
       "tests/torch_host_harness.py", "tests/torch_shmem_atomic_prog.py",
       "tests/torch_shmem_ext_prog.py", "tests/test_torch_osc_card.py"]))
def test_sources_import_no_jax(path):
    src = (ROOT / path).read_text()
    assert not _IMPORT.search(src), path
    assert "importlib.import_module(\"ompi_tpu." not in src
    assert "importlib.import_module('ompi_tpu." not in src


#: the port's linter and the host-plane microbenches: none imports torch
_HOST_TOOLS = ("ompi_tpu_torch.tools.lint", "ompi_tpu_torch.tools.lint.driver",
               "ompi_tpu_torch.tools.lint.__main__",
               "ompi_tpu_torch.tools.lint.checkers",
               "ompi_tpu_torch.tools.pack_bench",
               "ompi_tpu_torch.tools.coll_bench",
               "ompi_tpu_torch.tools.net_bench",
               "ompi_tpu_torch.tools.fleet_bench")

_REPO_LINT = re.compile(r"^\s*(?:import|from)\s+tools\b", re.M)


def test_lint_and_host_benches_load_neither_torch_nor_jax():
    """The port's ompi-lint and the four microbenches load no torch, no
    JAX, no JAX package and not the repo's own ``tools.lint``; the lint
    runs its checker catalogue in that process."""
    probe = (
        "import importlib, io, contextlib, json, sys\n"
        f"for m in {_HOST_TOOLS!r}:\n"
        "    importlib.import_module(m)\n"
        "from ompi_tpu_torch.tools.lint import main\n"
        "with contextlib.redirect_stdout(io.StringIO()) as out:\n"
        "    assert main(['--list']) == 0\n"
        "assert 'reader-thread' in out.getvalue()\n"
        "bad = sorted(k for k in sys.modules if k in ('torch', 'jax', "
        "'jaxlib', 'ompi_tpu', 'tools') or k.startswith(('torch.', 'jax.', "
        "'jaxlib.', 'ompi_tpu.', 'tools.')))\n"
        "print(json.dumps(bad))\n")
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_sources_import_not_the_repo_tools():
    """The port keeps its own copies of the repo's tools (the linter and
    the benches among them): no source imports ``tools``."""
    bad = sorted(str(p.relative_to(ROOT)) for p in PKG.rglob("*.py")
                 if _REPO_LINT.search(p.read_text()))
    assert bad == []


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


def test_chip_smoke_caches_bytecode_for_its_children(tmp_path):
    """``cache_bytecode`` turns the cache on where the environment turned
    it off, and a process started after it writes its bytecode under
    the checkout's ``build/pycache``, nowhere else."""
    code = (
        "import subprocess, sys\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "import chip_smoke as C\n"
        f"print(C.cache_bytecode({str(tmp_path)!r}))\n"
        "subprocess.run([sys.executable, '-c', 'import json.tool'],"
        " check=True)\n")
    env = dict(os.environ, PYTHONDONTWRITEBYTECODE="1")
    env.pop("PYTHONPYCACHEPREFIX", None)
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    prefix = tmp_path / "build" / "pycache"
    assert out.stdout.strip() == str(prefix)
    written = [p.name for p in prefix.rglob("*.pyc")]
    assert any(n.startswith("tool.") for n in written), written
