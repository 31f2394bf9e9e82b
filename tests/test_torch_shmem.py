"""The port's OpenSHMEM host API (``ompi_tpu_torch.shmem``) and its
one-sided examples, run through the port's launcher
(``python -m ompi_tpu_torch.tools.tpurun``) on this machine's CPU.

The cases mirror ``tests/shmem/test_shmem.py`` (its four examples, the
atomics program and the extensions program, whose port copies are
``tests/torch_shmem_{atomic,ext}_prog.py``) and the cases of
``tests/runtime/test_examples.py`` whose programs the port has:
``ring_oshmem``, ``oshmem_shmalloc``, ``oshmem_circular_shift``,
``oshmem_symmetric_data``, ``rma_pscw``, ``connectivity`` and
``mprobe_task_queue``, each at the reference's rank count and with its
marker.  Where a program's lines do not depend on thread timing, the
port's lines (sorted: the ranks interleave) must equal those of the JAX
package's program under the JAX package's launcher.
"""

from __future__ import annotations

import os
import pathlib
import re
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _port(np_: int, module: str, timeout: float = 120):
    return subprocess.run(
        [sys.executable, "-m", "ompi_tpu_torch.tools.tpurun", "-np",
         str(np_), "--", sys.executable, "-m", module], cwd=ROOT,
        capture_output=True, text=True, timeout=timeout)


def _jax(np_: int, script: str, timeout: float = 120):
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    env.pop("OMPI_TPU_RANK", None)
    return subprocess.run(
        [sys.executable, "-m", "ompi_tpu.tools.tpurun", "-np", str(np_),
         "--", sys.executable, script], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=timeout)


def _lines(out: str, drop: str = "") -> list[str]:
    """The job's lines, sorted; ``drop`` is a pattern whose matches are
    blanked (values thread timing decides)."""
    return sorted(re.sub(drop, "", line) if drop else line
                  for line in out.splitlines() if line.strip())


def _same_lines(np_, module, script, drop=""):
    p = _port(np_, module)
    assert p.returncode == 0, f"{module}:\n{p.stdout}\n{p.stderr}"
    ref = _jax(np_, script)
    assert ref.returncode == 0, ref.stderr[-2000:]
    assert _lines(p.stdout, drop) == _lines(ref.stdout, drop)
    return p.stdout


# ---------------------------------------------------------------------------
# tests/shmem/test_shmem.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,np_,needle", [
    ("oshmem_max_reduction", 4, "max reduction ok"),
    ("oshmem_circular_shift", 4, "circular shift ok"),
    ("oshmem_strided_puts", 2, "strided put ok"),
    ("oshmem_symmetric_data", 4, "verified symmetric data"),
])
def test_oshmem_examples(name, np_, needle):
    out = _same_lines(np_, f"ompi_tpu_torch.examples.{name}",
                      f"examples/{name}.py")
    assert needle in out


def test_atomics_across_pes():
    out = _same_lines(4, "tests.torch_shmem_atomic_prog",
                      "tests/shmem/_atomic_prog.py")
    assert "fetch_add tickets unique: 20" in out


def test_shmem_extensions():
    """Locks, wait_until, strided iput/iget, active-set collectives
    (≈ oshmem/shmem/c/shmem_lock.c + scoll active-set signatures)."""
    out = _same_lines(4, "tests.torch_shmem_ext_prog",
                      "tests/shmem/_ext_prog.py")
    for needle in ("wait_until ok", "lock mutual exclusion ok",
                   "test_lock single winner ok", "iput/iget strided ok",
                   "active-set collectives ok"):
        assert needle in out, (needle, out)


# ---------------------------------------------------------------------------
# tests/runtime/test_examples.py: the programs the port has
# ---------------------------------------------------------------------------

#: (program, marker, ranks, pattern of timing-decided values or None: the
#: lines are then not compared with the JAX package's)
CASES = [
    ("ring_oshmem", "exiting", 3, ""),
    ("oshmem_shmalloc", "shmalloc/shfree ok", 3, ""),
    ("oshmem_circular_shift", "circular shift ok", 3, ""),
    ("oshmem_symmetric_data", "verified symmetric data", 3, ""),
    ("rma_pscw", "dynamic window ok", 3, r"ticket=\d+ "),
    ("connectivity", "Connectivity test on 3 processes PASSED", 3, ""),
    ("mprobe_task_queue", "no duplicates, no losses", 3, None),
]


@pytest.mark.parametrize("name,marker,np_,drop", CASES,
                         ids=[c[0] for c in CASES])
def test_example_runs_under_tpurun(name, marker, np_, drop):
    module = f"ompi_tpu_torch.examples.{name}"
    if drop is None:
        p = _port(np_, module)
        assert p.returncode == 0, (p.stdout + p.stderr)[-2000:]
        out = p.stdout
    else:
        out = _same_lines(np_, module, f"examples/{name}.py", drop)
    assert marker in out, out[-2000:]


def test_shmem_loads_no_torch_until_the_device_heap_is_asked_for():
    """``from ompi_tpu_torch import shmem`` imports the host API and no
    torch; ``shmem.DeviceSymmetricHeap`` loads the device module."""
    probe = ("import sys\n"
             "from ompi_tpu_torch import shmem\n"
             "before = 'torch' in sys.modules\n"
             "heap = shmem.DeviceSymmetricHeap\n"
             "print(before, 'torch' in sys.modules, heap.__module__,\n"
             "      sorted(n for n in ('init', 'array', 'Lock', 'to_all',\n"
             "             'broadcast_active') if hasattr(shmem, n)))")
    p = subprocess.run([sys.executable, "-c", probe], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stderr
    assert p.stdout.split("\n")[0] == (
        "False True ompi_tpu_torch.shmem.device "
        "['Lock', 'array', 'broadcast_active', 'init', 'to_all']")


def test_shmem_exports_the_jax_packages_names():
    import ompi_tpu.shmem as jshmem

    import ompi_tpu_torch.shmem as pshmem

    names = [n for n in dir(jshmem) if not n.startswith("_")
             and not isinstance(getattr(jshmem, n), type(os))]
    assert names and all(hasattr(pshmem, n) for n in names), names
