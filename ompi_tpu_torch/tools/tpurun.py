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
    python -m ompi_tpu_torch.tools.tpurun --dvm-start --plm sim --hosts 2 --slots 8 --metrics-port 0
    python -m ompi_tpu_torch.tools.tpurun --dvm-submit -np 4 -- python app.py
    python -m ompi_tpu_torch.tools.tpurun --dvm-ps
    python -m ompi_tpu_torch.tools.tpurun --dvm-stop

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

``--dvm-start`` brings up a standing, multi-tenant daemon VM
(``runtime/dvm.py``, ≈ orte-dvm) of ``--slots`` slots; ``--dvm-submit``
runs a job on it (≈ orte-submit; exit 75 with a JSON ``rejected``
verdict on stdout when the pool refuses it), ``--dvm-ps`` prints its
daemon, queue, job and proc tables (≈ orte-ps), ``--dvm-shrink
JOBID:RANK`` retires one rank of a running tenant and ``--dvm-stop``
shuts it down.  ``--dvm-uri`` names the pool's control URI or the file
holding it (default: the per-user uri file in ``$TMPDIR``).
``--metrics-port N`` serves ``/metrics``, ``/status``, ``/doctor`` and
``/timeline`` over HTTP on 127.0.0.1 (0: an ephemeral port, recorded in
``<uri>.metrics``).  ``--dvm-start --gpu`` gives each tenant's ranks
the simulated hosts' cards and a process group of their own.
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
    # persistent DVM (≈ orte-dvm / orte-submit / orte-ps)
    p.add_argument("--dvm-start", action="store_true",
                   help="bring up a persistent daemon VM and serve job "
                        "submissions (≈ orte-dvm)")
    p.add_argument("--dvm-submit", action="store_true",
                   help="run the command on a standing DVM (fast: skips "
                        "VM bring-up; ≈ orte-submit)")
    p.add_argument("--dvm-ps", action="store_true",
                   help="print a standing DVM's daemon/queue/job/proc "
                        "table (≈ orte-ps)")
    p.add_argument("--dvm-shrink", default=None, metavar="JOBID:RANK",
                   help="planned elastic shrink: retire one rank of a "
                        "running DVM job (no revive; the survivors "
                        "continue smaller per the ULFM recipe)")
    p.add_argument("--dvm-stop", action="store_true",
                   help="shut a standing DVM down")
    p.add_argument("--dvm-uri", default=None, metavar="FILE|HOST:PORT",
                   help="DVM control URI or the file holding it "
                        "(default: the per-user uri file in TMPDIR)")
    p.add_argument("--slots", type=int, default=None,
                   help="total rank slots the DVM allocates at start "
                        "(--dvm-start; default: np or hosts*ceil)")
    p.add_argument("--metrics-port", type=int, default=None,
                   metavar="PORT",
                   help="with --dvm-start: serve a long-lived HTTP "
                        "observability endpoint on 127.0.0.1:PORT — "
                        "/metrics (Prometheus text, per-job labels), "
                        "/status (proc table + FT event timeline), "
                        "/doctor and /timeline.  Arms the per-rank "
                        "metrics uplink (trace_metrics_push_period, "
                        "default 1.0 s when this flag is given).  PORT 0 "
                        "binds an ephemeral port, recorded in "
                        "<uri>.metrics")
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
    if args.dvm_ps or args.dvm_shrink or args.dvm_stop:
        return _dvm_control(args)
    cmd = args.command
    if cmd and cmd[0] == "--":
        cmd = cmd[1:]
    if not cmd and not args.dvm_start:
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
        if args.dvm_submit:
            return _dvm_submit(args, cmd, env)
        if args.dvm_start:
            return _dvm_start(args)
        if args.plm:
            return _launch_tree(args, cmd, env)
        from ompi_tpu_torch.runtime.launcher import launch

        return launch(cmd, np=args.np, want_gpu=args.gpu, env=env,
                      stdin_target=args.stdin, timeout=args.timeout)
    except NoCardError as e:
        print(f"tpurun: {e}", file=sys.stderr)
        return 1


def _configure_sim_ras(args, total_slots: int) -> None:
    """``--plm sim`` and ``--dvm-start`` without a hostfile: ``--hosts``
    simulated nodes with enough slots between them for
    ``total_slots``."""
    import math

    var_registry.load_cli([
        ("ras", "simulator"),
        ("ras_sim_num_nodes", str(args.hosts)),
        ("ras_sim_slots_per_node",
         str(math.ceil(total_slots / max(1, args.hosts)))),
    ])


def _dvm_control(args) -> int:
    """``--dvm-ps``, ``--dvm-shrink`` and ``--dvm-stop``: one request to
    a standing DVM."""
    import json

    from ompi_tpu_torch.runtime import dvm

    try:
        if args.dvm_ps:
            print(json.dumps(dvm.ps(args.dvm_uri), indent=1))
        elif args.dvm_shrink:
            try:
                jobid, _, rank = args.dvm_shrink.partition(":")
                reply = dvm.shrink(int(jobid), int(rank), uri=args.dvm_uri)
            except ValueError:
                print(f"tpurun: --dvm-shrink wants JOBID:RANK "
                      f"(got {args.dvm_shrink!r})", file=sys.stderr)
                return 2
            print(json.dumps(reply))
        else:
            dvm.stop(args.dvm_uri)
            print("dvm: stopped", file=sys.stderr)
    except RuntimeError as e:
        print(f"tpurun: {e}", file=sys.stderr)
        return 1
    return 0


def _dvm_submit(args, cmd: list[str], env: dict[str, str]) -> int:
    """Run ``cmd`` on a standing DVM.  The CLIENT's environment is the
    job's env (orte-submit / mpirun semantics: app processes see the
    submitter's variables, overlaid on the daemon's own env), less the
    per-rank/per-job identity vars the launcher owns and the HOST-LOCAL
    vars whose client values would break ranks on remote (ssh) daemons;
    the ``--mca`` pairs were exported into os.environ, so they ride
    along, and ``-x`` pairs on top."""
    import json

    from ompi_tpu_torch.runtime import dvm
    from ompi_tpu_torch.runtime import pmix
    from ompi_tpu_torch.runtime.orted import ENV_ORTED_PID

    skip = {pmix.ENV_URI, pmix.ENV_RANK, pmix.ENV_SIZE, pmix.ENV_JOBID,
            pmix.ENV_LOCAL_RANK, pmix.ENV_CHIP, ENV_ORTED_PID,
            "OMPI_TPU_RESTART", "OMPI_TPU_FAKE_HOST",
            "PATH", "HOME", "TMPDIR", "TMP", "TEMP", "PWD",
            "OLDPWD", "SHLVL", "HOSTNAME", "LD_LIBRARY_PATH",
            "LD_PRELOAD", "VIRTUAL_ENV", "PYTHONHOME"}
    job_env = {k: v for k, v in os.environ.items() if k not in skip}
    job_env.update(env)
    if args.tag is not None:
        job_env[var_registry.ENV_PREFIX + "launcher_tag_output"] = \
            "1" if args.tag else "0"
    if args.timeout is not None:
        import threading

        def expire() -> None:
            # the client gives up (exit 124); the tenant runs on until
            # the pool or --dvm-stop ends it, as orte-submit's does
            threading.Event().wait(args.timeout)
            print(f"tpurun: job timed out after {args.timeout:g}s",
                  file=sys.stderr, flush=True)
            os._exit(124)

        threading.Thread(target=expire, daemon=True,
                         name="tpurun-timeout").start()
    try:
        return dvm.submit(cmd, np_=args.np, uri=args.dvm_uri, env=job_env)
    except dvm.DvmRejected as e:
        # machine-readable admission verdict on stdout + EX_TEMPFAIL
        # (75): schedulers and scripts can parse-and-retry instead of
        # hanging against a full pool
        print(json.dumps(e.verdict))
        print(f"tpurun: dvm rejected the job: {e}", file=sys.stderr)
        return 75
    except RuntimeError as e:
        print(f"tpurun: {e}", file=sys.stderr)
        return 1


def _dvm_start(args) -> int:
    """Bring the standing DVM up and serve until ``--dvm-stop``."""
    from ompi_tpu_torch.runtime import dvm

    slots = args.slots or max(args.np, args.hosts)
    plm_name = args.plm or "sim"
    if plm_name == "sim" and not args.hostfile:
        _configure_sim_ras(args, slots)
    if args.metrics_port is not None:
        # the scrape endpoint is only useful with the uplink armed:
        # default the push period on (daemons inherit it via their spawn
        # env, ranks via the launch env overlay) unless the user pinned
        # it with --mca / the environment
        os.environ.setdefault(
            var_registry.ENV_PREFIX + "trace_metrics_push_period", "1.0")
    hnp = dvm.DvmHnp(plm_name=plm_name, want_gpu=args.gpu,
                     uri_path=args.dvm_uri, metrics_port=args.metrics_port,
                     remote_hosts=plm_name == "ssh")
    hnp.start(np_slots=slots)
    print(f"dvm: up ({args.hosts} hosts, {slots} slots); "
          f"uri file {hnp.uri_path}", file=sys.stderr, flush=True)
    if hnp.metrics_uri:
        print(f"dvm: metrics at {hnp.metrics_uri}/metrics and "
              f"{hnp.metrics_uri}/status", file=sys.stderr, flush=True)
    try:
        return hnp.serve_forever()
    except KeyboardInterrupt:
        hnp.shutdown()
        return 0


def _launch_tree(args, cmd: list[str], env: dict[str, str]) -> int:
    """The multi-host path: one orted per host, routed tree, IOF up the
    tree.  ``sim`` without a hostfile fabricates ``--hosts`` nodes with
    enough slots between them for ``-np`` ranks."""
    if args.plm == "sim" and not args.hostfile:
        _configure_sim_ras(args, args.np)
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
