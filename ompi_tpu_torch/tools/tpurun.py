"""tpurun — the mpirun equivalent (the port's trimmed copy of the JAX
package's ``tools/tpurun.py``).

≈ orte/tools/orterun (orterun.c:131-236): parse the command line, apply
--mca directives, build the job, drive the launch state machine, forward
output, propagate the first failure's exit code.

    python -m ompi_tpu_torch.tools.tpurun -np 4 -- python -m ompi_tpu_torch.examples.ring
    python -m ompi_tpu_torch.tools.tpurun -np 2 --mca pml_eager_limit 1024 -- python app.py
    python -m ompi_tpu_torch.tools.tpurun -np 4 --gpu -- python train.py
    python -m ompi_tpu_torch.tools.tpurun -np 4 --plm sim --hosts 2 -- python -m ompi_tpu_torch.examples.ring
    python -m ompi_tpu_torch.tools.tpurun -np 8 --plm ssh --hostfile hf -- python app.py
    python -m ompi_tpu_torch.tools.tpurun --clean

``--gpu`` maps ranks 1:1 onto the local CUDA cards (the counterpart of the
JAX package's ``--tpu``) and joins them into one ``torch.distributed``
process group at ``init()``.  ``--trace`` arms every rank's flight
recorder; each rank flushes ``$TMPDIR/ompi_tpu_trace_<jobid>_rank<r>.json``
at finalize or abort (merge them with ``python -m
ompi_tpu_torch.tools.trace_export``).

``--plm sim|ssh`` launches through the daemon tree (``runtime/plm.py``,
one orted per host): ``sim`` runs ``--hosts`` simulated hosts on this
machine (ranks on different ones ride tcp, never shm), ``ssh`` one daemon
on each host of ``--hostfile``.  ``--map-by byslot|bynode`` picks the
round-robin placement.  With ``--gpu`` the simulated hosts share out this
machine's cards and the ranks join one process group.  ``--clean``
sweeps the debris of dead jobs (``runtime/clean.py``, ≈ orte-clean).
Left out until ROADMAP.md Queue 1 item 6.15b: the persistent DVM
(``--dvm-*``, with ``--metrics-port``).
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
    p.add_argument("--hostfile", default=None, help="hostfile path")
    p.add_argument("--map-by", default=None, choices=["byslot", "bynode"],
                   help="round-robin mapping policy")
    p.add_argument("--plm", default=None, choices=["sim", "ssh"],
                   help="multi-host launch via a daemon tree: 'sim' runs "
                        "one daemon per simulated host on this machine, "
                        "'ssh' spawns daemons over ssh (≈ plm/rsh)")
    p.add_argument("--hosts", type=int, default=2,
                   help="number of simulated hosts for --plm sim")
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
    p.add_argument("--clean", action="store_true",
                   help="remove stale job debris (shm inboxes/segments "
                        "of dead ranks, dead DVM uri) — ≈ orte-clean; "
                        "liveness-checked unless --clean-age is given")
    p.add_argument("--clean-age", type=float, default=0.0, metavar="SECS",
                   help="with --clean: also remove ANY artifact older "
                        "than SECS (use when none of your jobs run)")
    p.add_argument("--clean-dry-run", action="store_true",
                   help="with --clean: report, remove nothing")
    p.add_argument("--tag-output", dest="tag", action="store_true",
                   default=None, help="tag output lines with [jobid,rank]")
    p.add_argument("--no-tag-output", dest="tag", action="store_false")
    p.add_argument("command", nargs=argparse.REMAINDER,
                   help="program and arguments to launch")
    return p


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    if args.clean:
        from ompi_tpu_torch.runtime import clean as clean_mod

        try:
            removed = clean_mod.clean(
                age=args.clean_age, dry_run=args.clean_dry_run,
                report=lambda s: print(f"tpurun: {s}", file=sys.stderr))
        except OSError as e:
            print(f"tpurun: {e}", file=sys.stderr)
            return 1
        verb = "would remove" if args.clean_dry_run else "removed"
        print(f"tpurun: {verb} {len(removed)} stale artifact(s)",
              file=sys.stderr)
        return 0
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
    if args.map_by:
        var_registry.load_cli([("rmaps_rr_policy", args.map_by)])
    if args.tag is not None:
        var_registry.load_cli([("launcher_tag_output",
                                "1" if args.tag else "0")])
    if args.hostfile:
        var_registry.load_cli([("ras_hostfile", args.hostfile)])
    env: dict[str, str] = {}
    for item in args.export:
        name, eq, value = item.partition("=")
        if eq:
            env[name] = value
        elif name in os.environ:
            env[name] = os.environ[name]

    from ompi_tpu_torch.runtime.ras import NoCardError

    try:
        if args.plm:
            return _launch_tree(args, cmd, env)
        from ompi_tpu_torch.runtime.launcher import launch

        return launch(cmd, np=args.np, want_gpu=args.gpu, env=env,
                      stdin_target=args.stdin, timeout=args.timeout)
    except NoCardError as e:
        print(f"tpurun: {e}", file=sys.stderr)
        return 1


def _launch_tree(args, cmd: list[str], env: dict[str, str]) -> int:
    """The multi-host path: one orted per host, routed tree, IOF up the
    tree.  ``sim`` without a hostfile fabricates ``--hosts`` nodes with
    enough slots between them for ``-np`` ranks."""
    import math

    if args.plm == "sim" and not args.hostfile:
        var_registry.load_cli([
            ("ras", "simulator"),
            ("ras_sim_num_nodes", str(args.hosts)),
            ("ras_sim_slots_per_node",
             str(math.ceil(args.np / max(1, args.hosts)))),
        ])
    from ompi_tpu_torch.runtime.job import AppContext, Job
    from ompi_tpu_torch.runtime.plm import MultiHostLauncher

    job = Job([AppContext(argv=cmd, np=args.np, env=env)])
    return MultiHostLauncher(
        plm_name=args.plm, want_gpu=args.gpu,
        stdin_target=args.stdin if args.stdin is not None else "0",
        timeout=args.timeout, remote_hosts=args.plm == "ssh",
    ).run(job)


if __name__ == "__main__":
    sys.exit(main())
