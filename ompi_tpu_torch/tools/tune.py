"""Measured device-collective crossovers → dynamic rules file (the port's
copy of the JAX package's ``tools/tune.py``).

≈ the process behind the reference's fixed decision tables: the numbers in
ompi/mca/coll/tuned/coll_tuned_decision_fixed.c:56-74 were *measured* and
then baked in.  This tool reproduces that process on the ranks actually
present: it times every algorithm coll/xla can pick for each collective
across a size sweep, derives the per-size winners, and emits a rules file
in the ``ompi_tpu_torch.mpi.coll.rules`` format with provenance (``#!``
lines: platform ``cuda`` or ``cpu``, the card's name, the number of
ranks).

Where the JAX package times one SPMD program over its mesh, a port rank is
a process that owns one device, so every rank times its own calls:

- the timed loop is closed by a device synchronize (without it the clock
  measures launches), and the first call of each cell is left out (NCCL
  sets up its communicator on first use);
- each cell's seconds are reduced with MAX over the ranks (the slowest
  rank is the collective's time), so every rank derives the same winners
  and the same text;
- only rank 0 writes the file.

Lossy algorithms (``qint8``) are measured for the table but never put in
a rule.  On one rank every collective is a copy, so the rules are withheld
and only the provenance is written: coll/xla ignores a file with no rules.

``coll/xla`` reads the emitted file (``xla_measured_rules.conf`` beside the
component) when its platform matches the bound mesh's and its rank count is
within 2× of the communicator's.

Run on N cards (one rank a card):
``python -m ompi_tpu_torch.tools.tpurun -np N --gpu -- python -m
ompi_tpu_torch.tools.tune [--out PATH]``.
"""

from __future__ import annotations

import os
import sys
import time
from typing import Optional, Sequence

__all__ = ["tune_device_colls", "measure_one", "DEFAULT_OUT",
           "DEFAULT_SIZES"]

# element counts (float32) per rank's shard: 4KiB … 64MiB
DEFAULT_SIZES = (1 << 10, 1 << 14, 1 << 18, 1 << 21, 1 << 23, 1 << 24)

DEFAULT_OUT = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "mpi", "coll", "xla_measured_rules.conf")


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _sync(comm) -> None:
    import torch

    if comm.mesh.device.type == "cuda":
        torch.cuda.synchronize(comm.mesh.device)


def measure_one(comm, method: str, elems: int, iters: int = 10) -> float:
    """Seconds per call of one device collective at one size (this rank's
    shard of ``elems`` float32), timed on this rank: one untimed call,
    the ranks meet, then ``iters`` calls closed by a device synchronize."""
    import torch

    x = torch.ones((elems,), dtype=torch.float32, device=comm.mesh.device)
    fn = getattr(comm, method)
    fn(x)                                 # first call: NCCL's setup
    _sync(comm)
    comm.barrier()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(x)
    _sync(comm)
    return (time.perf_counter() - t0) / iters


def _slowest(comm, seconds: float) -> float:
    """MAX of ``seconds`` over the communicator's ranks (host group)."""
    import torch
    import torch.distributed as dist

    if comm.size == 1:
        return seconds
    t = torch.tensor([seconds], dtype=torch.float64)
    dist.all_reduce(t, op=dist.ReduceOp.MAX,
                    group=comm.mesh.host_group(comm.axes))
    return float(t.item())


def tune_device_colls(mesh=None, sizes: Sequence[int] = DEFAULT_SIZES,
                      out_path: Optional[str] = None,
                      iters: int = 10) -> tuple[str, dict]:
    """Measure all (collective, algorithm, size) cells over every rank of
    ``mesh`` (default: ``make_mesh()`` over the process group) and derive
    crossover rules.  Every rank of the mesh makes the call.

    Returns (rules_text, table), the same on every rank;
    ``table[coll][label][alg] = us``.  Rules are only emitted for n ≥ 2 —
    on one rank every collective is a copy and "crossovers" would be
    noise; the table still records the measurement.  Only rank 0 writes
    ``out_path``.
    """
    from ompi_tpu_torch.mpi.coll.xla import XlaColl
    from ompi_tpu_torch.mpi.device_comm import device_world

    comm = device_world(mesh)
    n = comm.size
    platform = kind = "cpu"
    if comm.mesh.device.type == "cuda":
        import torch

        platform, kind = "cuda", torch.cuda.get_device_name(comm.mesh.device)
    table: dict[str, dict[str, dict[str, float]]] = {}
    winners: dict[str, list[tuple[int, str]]] = {}
    for coll, impls in XlaColl._IMPL.items():
        table[coll] = {}
        winners[coll] = []
        lossy = XlaColl.LOSSY.get(coll, frozenset())
        for elems in sizes:
            nbytes = elems * 4
            label = (f"{nbytes >> 10}KiB" if nbytes < (1 << 20)
                     else f"{nbytes >> 20}MiB")
            row: dict[str, float] = {}
            for alg, method in impls.items():
                it = max(3, iters // 2) if elems >= (1 << 23) else iters
                try:
                    dt = measure_one(comm, method, elems, it)
                except (RuntimeError, ValueError) as e:
                    # record and keep going; the MAX below drops the cell
                    # on every rank alike
                    _log(f"tune[{coll}/{alg}@{label}]: "
                         f"{type(e).__name__}: {e}")
                    dt = float("inf")
                dt = _slowest(comm, dt)
                if dt != float("inf"):
                    row[alg] = round(dt * 1e6, 1)
            table[coll][label] = row
            # lossy algorithms (qint8): measured for the table, but a
            # crossover rule must never silently change results
            exact = {a: t for a, t in row.items() if a not in lossy}
            if exact:
                best = min(exact, key=exact.get)
                winners[coll].append((nbytes, best))
                if comm.rank() == 0:
                    _log(f"tune[{coll}@{label}]: {row} → {best}")

    lines = [
        "# Measured device-collective crossovers — generated by "
        "ompi_tpu_torch.tools.tune",
        "# (the measured-numbers discipline of "
        "coll_tuned_decision_fixed.c:56-74, reproduced on these ranks)",
        "# msg_bytes_min is PER-SHARD bytes (what one rank contributes) — "
        "the unit coll/xla decides on",
        f"#! platform={platform}",
        f"#! device_kind={kind.replace(' ', '_')}",
        f"#! n_devices={n}",
    ]
    if n < 2:
        lines.append("# n=1: collectives are copies; crossover rules "
                     "withheld (decision layer keeps its defaults)")
    else:
        for coll, picks in winners.items():
            prev = None
            for nbytes, alg in picks:
                if alg != prev:
                    # first rule of each collective applies from 0 bytes
                    lines.append(f"{coll}  0  {0 if prev is None else nbytes}"
                                 f"  {alg}")
                    prev = alg
    text = "\n".join(lines) + "\n"
    if out_path and comm.rank() == 0:
        with open(out_path, "w", encoding="utf-8") as f:
            f.write(text)
        _log(f"measured rules written to {out_path}")
    return text, table


def main(argv: Optional[list[str]] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        description="measure device-collective crossovers, emit rules")
    ap.add_argument("--out", default=DEFAULT_OUT,
                    help=f"rules file to write (default {DEFAULT_OUT})")
    ap.add_argument("--no-write", action="store_true",
                    help="print rules to stdout only")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the ranks' collectives run (cpu: gloo)")
    ap.add_argument("--sizes", default="",
                    help="comma-separated per-rank f32 element counts")
    args = ap.parse_args(argv)
    import ompi_tpu_torch
    from ompi_tpu_torch.parallel.mesh import make_mesh

    comm = ompi_tpu_torch.init()
    sizes = (tuple(int(s) for s in args.sizes.split(","))
             if args.sizes else DEFAULT_SIZES)
    text, _ = tune_device_colls(
        make_mesh(device=args.device), sizes=sizes,
        out_path=None if args.no_write else args.out)
    if comm.rank == 0:
        print(text)
    ompi_tpu_torch.finalize()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
