"""The port's launcher (``python -m ompi_tpu_torch.tools.tpurun``), PMIx
and ``init()`` end to end: rank processes on this machine's CPU.

The ring's lines must equal the JAX package's ``tpurun`` ring's (sorted:
the ranks' output interleaves), hello prints the reference program's
line on every rank; a rank's nonzero exit becomes the job's, ``abort``
takes the whole job down with its code, the modex runs through the PMIx
server, ``--mca`` reaches the children, ``-x`` exports a variable,
stdin goes to rank 0, ``--timeout`` exits 124, ``--gpu`` with no card
fails with a message, and a rank that touches no tensor never imports
torch.  The jobs are few and small.
"""

from __future__ import annotations

import os
import pathlib
import subprocess
import sys
import threading
import time

import pytest

from ompi_tpu_torch.runtime import pmix
from ompi_tpu_torch.runtime.job import AppContext, Job
from ompi_tpu_torch.runtime.launcher import LocalLauncher

ROOT = pathlib.Path(__file__).resolve().parents[1]
TPURUN = [sys.executable, "-m", "ompi_tpu_torch.tools.tpurun"]


def _run(args, timeout=90, **kw):
    return subprocess.run(TPURUN + args, cwd=ROOT, capture_output=True,
                          text=True, timeout=timeout, **kw)


def _lines(out: str) -> list[str]:
    return sorted(line for line in out.splitlines() if line.strip())


def test_hello_on_three_ranks():
    p = _run(["-np", "3", "--", sys.executable, "-m",
              "ompi_tpu_torch.examples.hello"])
    assert p.returncode == 0, p.stderr
    assert _lines(p.stdout) == [
        f"[1,{r}]Hello, world, I am {r} of 3" for r in range(3)]


def test_ring_on_four_ranks_prints_the_jax_package_lines():
    p = _run(["-np", "4", "--", sys.executable, "-m",
              "ompi_tpu_torch.examples.ring"])
    ref = subprocess.run(
        [sys.executable, "-m", "ompi_tpu.tools.tpurun", "-np", "4", "--",
         sys.executable, "examples/ring.py"], cwd=ROOT,
        capture_output=True, text=True, timeout=90,
        env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert p.returncode == 0 and ref.returncode == 0, (p.stderr, ref.stderr)
    assert _lines(p.stdout) == _lines(ref.stdout)
    assert "[1,0]Process 0 decremented value: 0" in p.stdout
    assert len(_lines(p.stdout)) == 16


def test_host_ranks_do_not_import_torch():
    """init(), a host allreduce, a send/recv and finalize: the host plane
    runs without torch, which is most of a rank's start-up."""
    p = _run(["-np", "2", "--", sys.executable, "-c",
              "import sys, numpy as np, ompi_tpu_torch as m\n"
              "c = m.init()\n"
              "s = c.allreduce(np.arange(3.0))\n"
              "if c.rank == 0: c.send(s, dest=1, tag=2)\n"
              "else: assert (c.recv(source=0, tag=2) == s).all()\n"
              "m.finalize()\n"
              "print(c.rank, s.tolist(), 'torch' in sys.modules)"])
    assert p.returncode == 0, p.stderr
    assert _lines(p.stdout) == ["[1,0]0 [0.0, 2.0, 4.0] False",
                                "[1,1]1 [0.0, 2.0, 4.0] False"]


def test_same_host_ranks_take_the_shm_rings_and_the_arena():
    """A launched job's ranks share the host: by default their frames
    ride the shm rings, their collectives the coll/shm arena, and
    matching runs in the compiled engine — the JAX package's default
    path; ``--mca btl self,tcp`` and ``OMPI_TPU_NO_NATIVE=1`` select the
    others."""
    code = ("import sys, numpy as np, ompi_tpu_torch as m\n"
            "c = m.init()\n"
            "s = c.allreduce(np.arange(3.0) + c.rank)\n"
            "peer = 1 - c.rank\n"
            "c.send(s, dest=peer, tag=2)\n"
            "assert (c.recv(source=peer, tag=2) == s).all()\n"
            "print(c.rank, c.pml.endpoint.route(peer),\n"
            "      c.coll.providers['allreduce'], c._coll_shm_state.mode,\n"
            "      c.pml._eng is not None, s.tolist())\n"
            "m.finalize()\n")
    for extra, env, want in (
            ([], None, "shm shm arena True [1.0, 3.0, 5.0]"),
            (["--mca", "btl", "self,tcp"], None,
             "tcp shm arena True [1.0, 3.0, 5.0]"),
            ([], {"OMPI_TPU_NO_NATIVE": "1"},
             "shm shm arena False [1.0, 3.0, 5.0]")):
        p = _run(["-np", "2", *extra, "--", sys.executable, "-c", code],
                 env={**os.environ, **env} if env else None)
        assert p.returncode == 0, p.stderr
        assert _lines(p.stdout) == [f"[1,0]0 {want}", f"[1,1]1 {want}"]


def test_stdin_reaches_rank_0_and_x_exports():
    p = _run(["-np", "2", "-x", "RING_X=41", "--", sys.executable, "-c",
              "import os, sys; r = os.environ['OMPI_TPU_RANK']; "
              "print(r, repr(sys.stdin.read()), os.environ['RING_X'])"],
             input="hello\n")
    assert p.returncode == 0, p.stderr
    assert "[1,0]0 'hello\\n' 41" in p.stdout
    assert "[1,1]1 '' 41" in p.stdout


def test_nonzero_exit_propagates():
    # rank 0 outlives rank 1, so the abort errmgr has a rank to take down
    p = _run(["-np", "2", "--", sys.executable, "-c",
              "import os, sys, time\n"
              "if os.environ['OMPI_TPU_RANK'] == '1': sys.exit(3)\n"
              "time.sleep(30)"])
    assert p.returncode == 3
    assert "rank 1 aborted (exit code 3)" in p.stderr


def test_abort_kills_the_job_with_its_code():
    t0 = time.monotonic()
    p = _run(["-np", "3", "--", sys.executable, "-c",
              "import time, ompi_tpu_torch as m\n"
              "c = m.init()\n"
              "if c.rank == 1: m.abort(7, 'stop here')\n"
              "time.sleep(60)"])
    assert p.returncode == 7
    assert time.monotonic() - t0 < 45
    assert "rank 1 called abort: stop here" in p.stderr


def test_mca_reaches_the_children_and_rendezvous_sends():
    # a 4 KiB message crosses the 1 KiB eager limit: rendezvous frames
    # between the two rank processes, over tcp
    p = _run(["-np", "2", "--mca", "pml_eager_limit", "1024", "--mca",
              "btl", "self,tcp", "--", sys.executable, "-c",
              "import numpy as np, ompi_tpu_torch as m\n"
              "from ompi_tpu_torch.core.config import var_registry as v\n"
              "c = m.init()\n"
              "x = np.arange(1024, dtype=np.float32)\n"
              "if c.rank == 0: c.send(x, dest=1)\n"
              "else: print('got', float(c.recv(source=0).sum()))\n"
              "print('limit', v.get('pml_eager_limit'), v.get('btl_'),"
              " c.pml.endpoint.proc_btl is None)\n"
              "m.finalize()"])
    assert p.returncode == 0, p.stderr
    assert "[1,1]got 523776.0" in p.stdout
    for r in range(2):
        assert f"[{1},{r}]limit 1024 self,tcp True" in p.stdout


def test_timeout_exits_124_and_leaves_nothing_running():
    marker = f"tpurun-timeout-{os.getpid()}"
    p = _run(["-np", "2", "--timeout", "2", "--", sys.executable, "-c",
              f"import time; time.sleep(60)  # {marker}"], timeout=60)
    assert p.returncode == 124
    assert "timed out after 2s" in p.stderr
    time.sleep(0.5)
    ps = subprocess.run(["ps", "-eo", "args"], capture_output=True,
                        text=True).stdout
    assert marker not in ps


def test_gpu_without_a_card_fails_with_a_message():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    p = _run(["-np", "1", "--gpu", "--", sys.executable, "-c",
              "print('ran')"])
    assert p.returncode == 1
    assert "no CUDA card" in p.stderr and "ran" not in p.stdout


def test_modex_through_pmix_put_fence_get():
    """Two clients of one server: each puts its business card, fences
    with collect, and reads the other's; get blocks until the put."""
    server = pmix.PMIxServer(size=2)
    try:
        out = {}

        def rank(r):
            c = pmix.PMIxClient(uri=server.uri, rank=r, size=2)
            c.put("btl.addr", f"card-{r}")
            cards = c.fence(collect=True)
            out[r] = (cards["btl.addr@0"], cards["btl.addr@1"],
                      c.get("btl.addr", rank=1 - r))
            if r == 0:
                time.sleep(0.2)
                c.put("late", 42)
            else:   # blocks in the server until rank 0's put lands
                out["late"] = c.get("late", rank=0, timeout=10)
            c.finalize()

        ts = [threading.Thread(target=rank, args=(r,), daemon=True)
              for r in range(2)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=30)
        assert out[0] == ("card-0", "card-1", "card-1")
        assert out[1] == ("card-0", "card-1", "card-0")
        assert out["late"] == 42
        assert server.lookup("btl.addr", rank=0) == "card-0"
    finally:
        server.close()


def test_launcher_state_machine_and_card_binding(monkeypatch):
    """INIT→ALLOCATE→MAP→LAUNCH_APPS→RUNNING→TERMINATED, and under the
    gpu component more ranks than cards wrap onto the cards."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    job = Job([AppContext(argv=[sys.executable, "-c",
                                "import os; print(os.environ"
                                "['OMPI_TPU_CHIP'], os.environ"
                                "['OMPI_TPU_NHOSTS'])"], np=3)])
    launcher = LocalLauncher(want_gpu=True, stdin_target="none")
    assert launcher.run(job) == 0
    assert [s.value for s in launcher.sm.trace] == [
        "init", "allocate", "map", "launch_apps", "running", "terminated"]
    assert [p.chip for p in job.procs] == [0, 1, 0]
    assert launcher.coord.startswith("127.0.0.1:")
