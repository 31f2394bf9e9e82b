"""schizo — CLI personality adapters (the port's copy of the JAX
package's ``tools/schizo.py``: it translates to the port's ``tpurun``).

≈ orte/mca/schizo: the reference accepts several launcher dialects
(OMPI mpirun, Slurm srun, ...) by translating each personality's argument
conventions into its own canonical form.  Here the shipped personality is
``ompi``: classic ``mpirun`` invocations translate to ``tpurun``'s CLI so
an Open MPI user's muscle memory (and scripts) keep working::

    mpirun -np 4 -x FOO=bar --machinefile hf ./a.out
      → tpurun -np 4 --hostfile hf -- ./a.out     (FOO exported)

Install the console entry as ``mpirun``/``mpiexec`` or invoke
``python -m ompi_tpu_torch.tools.schizo`` directly.
"""

from __future__ import annotations

import os
import sys
from typing import Optional

__all__ = ["translate_mpirun", "main"]

# mpirun flags that take a value and have no tpurun meaning: swallow them
_IGNORED_WITH_VALUE = {
    "--bind-to", "--map-by-socket", "--rank-by", "--report-bindings-to",
    "--prefix", "--wdir", "-wdir", "--path", "--tmpdir",
}
# valueless mpirun flags to swallow
_IGNORED_FLAGS = {
    "--bind-to-core", "--bind-to-socket", "--report-bindings",
    "--oversubscribe", "--nooversubscribe", "--display-map",
    "--display-allocation", "--verbose", "-v", "--quiet", "-q",
    "--enable-recovery",
}


def translate_mpirun(argv: list[str]) -> tuple[list[str], dict[str, str]]:
    """mpirun argv → (tpurun argv, extra env).

    Handles: -np/-n/-c N, --mca A B, --hostfile/--machinefile F,
    -x VAR[=VAL] (env export), --map-by slot|node|..., --tag-output,
    --stdin, and the ``--`` command separator.  Unknown launcher flags
    before the command raise ValueError (matching mpirun's own strictness)
    except for the known-ignorable binding/reporting flags above.
    """
    out: list[str] = []
    env: dict[str, str] = {}
    i = 0
    n = len(argv)

    def take_value(flag: str) -> str:
        nonlocal i
        i += 1
        if i >= n:
            raise ValueError(f"{flag} requires a value")
        return argv[i]

    while i < n:
        a = argv[i]
        if a == "--":
            out.append("--")
            out.extend(argv[i + 1:])
            return out, env
        if a in ("-np", "-n", "-c", "--np", "--n"):
            out += ["-np", take_value(a)]
        elif a == "--mca" or a == "-mca" or a == "--gmca" or a == "-gmca":
            i += 2
            if i >= n:
                raise ValueError(f"{a} requires PARAM VALUE")
            out += ["--mca", argv[i - 1], argv[i]]
        elif a in ("--hostfile", "-hostfile", "--machinefile",
                   "-machinefile", "--default-hostfile"):
            out += ["--hostfile", take_value(a)]
        elif a in ("-x", "--x"):
            spec = take_value(a)
            if "=" in spec:
                k, _, v = spec.partition("=")
            else:
                k, v = spec, os.environ.get(spec, "")
            env[k] = v
        elif a in ("--map-by", "-map-by"):
            v = take_value(a)
            base = v.split(":", 1)[0].lower()
            mapping = {"slot": "byslot", "core": "byslot",
                       "node": "bynode", "socket": "bynode"}
            if base in mapping:
                out += ["--map-by", mapping[base]]
            # unknown policies: mpirun-specific NUMA talk — ignore
        elif a in ("--tag-output", "-tag-output"):
            out.append("--tag-output")
        elif a in ("--stdin", "-stdin"):
            out += ["--stdin", take_value(a)]
        elif a in ("--timeout", "-timeout"):
            out += ["--timeout", take_value(a)]
        elif a in _IGNORED_WITH_VALUE:
            take_value(a)
        elif a in _IGNORED_FLAGS:
            pass
        elif a.startswith("-") and len(a) > 1:
            raise ValueError(
                f"mpirun personality: unsupported option {a!r} "
                f"(use tpurun directly for native options)")
        else:
            # first non-flag token starts the command
            out.append("--")
            out.extend(argv[i:])
            return out, env
        i += 1
    return out, env


def main(argv: Optional[list[str]] = None) -> int:
    """Entry point for the mpirun/mpiexec personality."""
    argv = sys.argv[1:] if argv is None else argv
    try:
        targv, env = translate_mpirun(argv)
    except ValueError as e:
        print(f"mpirun: {e}", file=sys.stderr)
        return 2
    os.environ.update(env)
    from ompi_tpu_torch.tools.tpurun import main as tpurun_main

    return tpurun_main(targv)


if __name__ == "__main__":
    raise SystemExit(main())
