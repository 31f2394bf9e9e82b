"""tpurun — the mpirun equivalent (the port's trimmed copy of the JAX
package's ``tools/tpurun.py``).

≈ orte/tools/orterun (orterun.c:131-236): parse the command line, apply
--mca directives, build the job, drive the launch state machine, forward
output, propagate the first failure's exit code.

    python -m ompi_tpu_torch.tools.tpurun -np 4 -- python -m ompi_tpu_torch.examples.ring
    python -m ompi_tpu_torch.tools.tpurun -np 2 --mca pml_eager_limit 1024 -- python app.py
    python -m ompi_tpu_torch.tools.tpurun -np 4 --gpu -- python train.py

``--gpu`` maps ranks 1:1 onto the local CUDA cards (the counterpart of the
JAX package's ``--tpu``) and joins them into one ``torch.distributed``
process group at ``init()``.  ``--trace`` arms every rank's flight
recorder; each rank flushes ``$TMPDIR/ompi_tpu_trace_<jobid>_rank<r>.json``
at finalize or abort (merge them with ``python -m
ompi_tpu_torch.tools.trace_export``).  Left out (ROADMAP.md Queue 1 item
6.15): multi-host launch (``--plm sim|ssh``, ``--hosts``, ``--hostfile``,
``--map-by``), the persistent DVM (``--dvm-*``, with ``--metrics-port``)
and ``--clean``.
"""

from __future__ import annotations

import argparse
import os
import sys

from ompi_tpu_torch.core.config import var_registry


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="tpurun",
        description="Launch an ompi_tpu_torch job (mpirun equivalent).")
    p.add_argument("-np", "-n", type=int, default=1, dest="np",
                   help="number of ranks to launch")
    p.add_argument("--mca", nargs=2, action="append", default=[],
                   metavar=("PARAM", "VALUE"),
                   help="set a config variable (repeatable)")
    p.add_argument("-x", action="append", default=[], dest="export",
                   metavar="NAME[=VALUE]",
                   help="export an environment variable to the ranks "
                        "(repeatable; NAME alone forwards the launcher's "
                        "value)")
    p.add_argument("--gpu", action="store_true",
                   help="map ranks 1:1 onto local CUDA cards and join "
                        "them into one torch.distributed process group")
    p.add_argument("--trace", action="store_true",
                   help="arm the per-rank flight recorder "
                        "(OMPI_TPU_TRACE=1 in every rank); each rank "
                        "flushes a Chrome-trace JSON to "
                        "$TMPDIR/ompi_tpu_trace_<jobid>_rank<r>.json at "
                        "finalize/abort — merge with python -m "
                        "ompi_tpu_torch.tools.trace_export")
    p.add_argument("--timeout", type=float, default=None, metavar="SECS",
                   help="kill the job and exit 124 after SECS seconds "
                        "(mpirun --timeout; CI hang guard)")
    p.add_argument("--stdin", default=None, metavar="RANK|all|none",
                   help="forward launcher stdin to this rank (default 0)")
    p.add_argument("--tag-output", dest="tag", action="store_true",
                   default=None, help="tag output lines with [jobid,rank]")
    p.add_argument("--no-tag-output", dest="tag", action="store_false")
    p.add_argument("command", nargs=argparse.REMAINDER,
                   help="program and arguments to launch")
    return p


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    cmd = args.command
    if cmd and cmd[0] == "--":
        cmd = cmd[1:]
    if not cmd:
        print("tpurun: no command given (try: python -m "
              "ompi_tpu_torch.tools.tpurun -np 4 -- python app.py)",
              file=sys.stderr)
        return 2
    if args.timeout is not None and args.timeout <= 0:
        print("tpurun: --timeout must be > 0 seconds "
              f"(got {args.timeout:g})", file=sys.stderr)
        return 2

    # CLI --mca pairs get top precedence; framework-selection vars use the
    # bare framework name (e.g. --mca btl self,tcp → synonym of btl_).
    # They are also exported to the environment so app processes inherit
    # them — most frameworks (pml/coll/btl) select inside the app.
    if args.trace:
        os.environ["OMPI_TPU_TRACE"] = "1"
    var_registry.load_cli([(k, v) for k, v in args.mca])
    for k, v in args.mca:
        os.environ[var_registry.ENV_PREFIX + k] = v
    if args.tag is not None:
        var_registry.load_cli([("launcher_tag_output",
                                "1" if args.tag else "0")])
    env: dict[str, str] = {}
    for item in args.export:
        name, eq, value = item.partition("=")
        if eq:
            env[name] = value
        elif name in os.environ:
            env[name] = os.environ[name]

    from ompi_tpu_torch.runtime.launcher import launch
    from ompi_tpu_torch.runtime.ras import NoCardError

    try:
        return launch(cmd, np=args.np, want_gpu=args.gpu, env=env,
                      stdin_target=args.stdin, timeout=args.timeout)
    except NoCardError as e:
        print(f"tpurun: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
