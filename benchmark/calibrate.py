"""Readings that a cell's limits are set from, on the card, at the cell's
own size, in one process:

- the program's numbers on each of ``--seeds`` (the lower readings);
- the control's on each of ``--control-seeds``: the reference computed
  in float8 in the program's place (training: its checked steps;
  serving: at each judged position the token the float8 reference puts
  first, read against the float32 reference);
- for a training cell, the program's numbers with each fault of
  ``faults.TRAIN`` planted, on each of ``--fault-seeds``.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,3 \
        --control-seeds 1,2,3 --fault-seeds 1,2,3 --out <file.jsonl>

One JSON line a reading, on standard output and appended to ``--out``.
The benchmark's own runs never run this.
"""

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != HERE]
sys.path.insert(0, os.path.dirname(HERE))

import argparse  # noqa: E402
import json  # noqa: E402
import time  # noqa: E402

import torch  # noqa: E402

from benchmark import checks, core, faults  # noqa: E402


def _seeds(text: str) -> list:
    return [int(s) for s in text.split(",") if s]


def _emit(out: str, **rec) -> None:
    line = json.dumps(rec)
    print(line, flush=True)
    if out:
        with open(out, "a") as f:
            f.write(line + "\n")


def _train(gen, cell, seed, dev, args, out) -> None:
    """Each side against the float32 reference from the same weights and
    batches; an MoE reference follows (and judges) that side's routing,
    so it runs once a side."""
    moe = bool(cell.config["model"].get("moe_experts"))
    t = time.perf_counter()
    sess = gen.Session(cell, seed, dev)
    sess.setup()
    sess.free()
    ref = sess.reference("f32")
    _emit(out, cell=cell.name, seed=seed, side="program",
          s=time.perf_counter() - t, route_gaps=ref["route_gaps"],
          **sess.numbers(sess.program, ref))
    if seed in args.control_seeds:
        ctl = sess.reference("fp8", follow=None)
        ref_c = sess.reference("f32", follow=ctl["routes"]) if moe else ref
        _emit(out, cell=cell.name, seed=seed, side="control",
              route_gaps=ref_c["route_gaps"], **sess.numbers(ctl, ref_c))
    if seed in args.fault_seeds:
        for fault in faults.TRAIN:
            with faults.planted("train", fault):
                bad = gen.Session(cell, seed, dev)
                bad.setup()
                bad.free()
            ref_b = bad.reference("f32") if moe else ref
            _emit(out, cell=cell.name, seed=seed, side=fault,
                  **sess.numbers(bad.program, ref_b))


def _decode(gen, cell, seed, dev, args, out) -> None:
    t = time.perf_counter()
    sess = gen.Session(cell, seed, dev)
    sess.setup(warm=False)
    sess.window(0.0, time.perf_counter())
    sess.outcome()
    sess.free()
    nums = sess.check()
    _emit(out, cell=cell.name, seed=seed, side="program",
          s=time.perf_counter() - t, **nums)
    if seed in args.control_seeds:
        tokens, _ = sess.judged()
        ref = sess.reference_logits(tokens)
        first = sess.reference_logits(tokens, "fp8").argmax(dim=-1)
        _emit(out, cell=cell.name, seed=seed, side="control",
              served_logit_gap=checks.served_gap(ref, first))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=_seeds, required=True)
    ap.add_argument("--control-seeds", type=_seeds, default=[])
    ap.add_argument("--fault-seeds", type=_seeds, default=[])
    ap.add_argument("--out", default="")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    bench = core.Bench()
    cell = bench.cell(args.workload)
    kind = cell.mix["kind"]
    gen = bench.kind(kind)
    dev = torch.device(args.device)
    for seed in args.seeds:
        (_train if kind == "train" else _decode)(gen, cell, seed, dev, args,
                                                 args.out)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
