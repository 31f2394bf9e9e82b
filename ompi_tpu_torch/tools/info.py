"""ompi-tpu-info — dump frameworks, components, and config variables (the
port's copy of the JAX package's ``tools/info.py``).

≈ ompi/tools/ompi_info: the introspection tool that lists every registered
framework, its components (with priorities), and every config variable with
its current value.

    python -m ompi_tpu_torch.tools.info [--param pml_]

The port's config variables carry no info level and no record of their
source: every variable shows (the JAX package's ``--level`` filter has
nothing to filter), and its source reads ``default`` or ``set``.
"""

from __future__ import annotations

import argparse
import importlib
import sys

from ompi_tpu_torch.core.config import var_registry
from ompi_tpu_torch.core.mca import framework_registry

# Modules whose import registers frameworks/components/vars.  Import errors
# are tolerated (e.g. torch-dependent modules on a host without torch).
_REGISTERING_MODULES = [
    "ompi_tpu_torch.runtime.ras",
    "ompi_tpu_torch.runtime.rmaps",
    "ompi_tpu_torch.runtime.errmgr",
    "ompi_tpu_torch.runtime.launcher",
    "ompi_tpu_torch.runtime.notifier",
    "ompi_tpu_torch.runtime.rtc",
    "ompi_tpu_torch.runtime.plm",
    "ompi_tpu_torch.runtime.metrics",     # metrics_agg_* fan-in valve vars
    "ompi_tpu_torch.runtime.doctor",      # doctor_* capture-budget vars
    "ompi_tpu_torch.runtime.dvm",         # dvm_* scheduler/remediation vars
    "ompi_tpu_torch.mpi.coll",
    "ompi_tpu_torch.mpi.coll.host",
    "ompi_tpu_torch.mpi.coll.selfcoll",
    "ompi_tpu_torch.mpi.coll.shm",
    "ompi_tpu_torch.mpi.coll.xla",
    "ompi_tpu_torch.mpi.pml",
    "ompi_tpu_torch.mpi.op",
    "ompi_tpu_torch.mpi.io",
    "ompi_tpu_torch.mpi.btl_shm",
    "ompi_tpu_torch.core.memchecker",
    "ompi_tpu_torch.parallel.multihost",
    "ompi_tpu_torch.shmem.api",
    "ompi_tpu_torch.ops.flash_attention",  # ops_flash_* kernel vars (torch)
]


def load_all() -> list[str]:
    failures = []
    for mod in _REGISTERING_MODULES:
        try:
            importlib.import_module(mod)
        except Exception as e:
            failures.append(f"{mod}: {type(e).__name__}: {e}")
    return failures


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="ompi-tpu-info")
    p.add_argument("--param", default=None,
                   help="show only variables whose name contains this string")
    args = p.parse_args(argv)

    failures = load_all()
    import ompi_tpu_torch

    print(f"ompi_tpu_torch version: {ompi_tpu_torch.__version__}")
    print()
    print("Frameworks and components:")
    for name, fw in sorted(framework_registry.all().items()):
        comps = ", ".join(
            f"{c.NAME}(pri={c.PRIORITY})"
            for c in sorted(fw.components().values(), key=lambda c: -c.PRIORITY))
        print(f"  {name:<12} {fw.description or ''}")
        print(f"  {'':<12}   components: {comps or '(none)'}")
    print()
    print("Configuration variables (name = value [type, source]):")
    for var in var_registry.all_vars():
        if args.param and args.param not in var.full_name:
            continue
        source = "default" if var.value == var.default else "set"
        print(f"  {var.full_name} = {var.value!r} "
              f"[{var.vtype.value}, {source}]"
              + (f"  # {var.description}" if var.description else ""))
    from ompi_tpu_torch.mpi.mpit import pvar_registry

    names = pvar_registry.names()
    if names:
        print()
        print("Performance variables (MPI_T pvars):")
        for n in names:
            pv = pvar_registry.lookup(n)
            print(f"  {n} [{pv.klass.value}"
                  + (f", {pv.unit}" if pv.unit else "") + "]"
                  + (f"  # {pv.description}" if pv.description else ""))
    if failures:
        print("\nmodules not loaded:", file=sys.stderr)
        for f in failures:
            print(f"  {f}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
