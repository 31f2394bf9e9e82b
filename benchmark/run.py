"""One run of one cell of the port's benchmark.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout that holds the port (``ompi_tpu_torch``) and
a card.  Set-up builds the cell's program from the seed and warms every
shape the cell uses; then the window runs ``--seconds`` of the cell's
traffic (``--trace 0``: the end-to-end metrics), or a short window under
``torch.profiler`` with the harness's spans (``--trace 1``: the
per-layer metrics).  After the window the program's state is freed and
its outputs are compared with the plain reference (``checks``).  The
last line of standard output is one JSON object; the numbers compared
are also the last lines of standard error.

Exits non-zero without a result when there is no card, or fewer than
the cell asks for, when the program is not in this checkout, and when
JAX or the JAX package was loaded.
"""

import time

T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CACHE = os.path.join(HERE, ".cache")


def _fixed_caches() -> None:
    """Bytecode and every kernel cache at fixed paths in the checkout: the
    card's machine turns bytecode off, and a fresh process would compile
    torch's sources again."""
    os.environ.pop("PYTHONDONTWRITEBYTECODE", None)
    sys.dont_write_bytecode = False
    sys.pycache_prefix = os.path.join(HERE, ".pycache")
    os.environ["PYTHONPYCACHEPREFIX"] = sys.pycache_prefix
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = os.path.join(CACHE, sub)
    os.environ["USE_FLAX"] = "0"
    # the checkout's root, not this folder, first on the path: a module
    # here must not shadow one of the same name elsewhere
    sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != HERE]
    sys.path.insert(0, ROOT)


_fixed_caches()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import tempfile  # noqa: E402
import types  # noqa: E402

import torch  # noqa: E402

from benchmark import checks, core, roofline, spans  # noqa: E402
from benchmark.trace import Trace  # noqa: E402

GIB = 2 ** 30


class Refused(Exception):
    """A run that may print no result."""


def _args(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if args.seed < 0:
        ap.error("--seed is a whole number")
    return args


def _device(chips: int) -> torch.device:
    if not torch.cuda.is_available():
        raise Refused("no CUDA device")
    if torch.cuda.device_count() < chips:
        raise Refused(f"the cell asks for {chips} cards, "
                      f"{torch.cuda.device_count()} present")
    return torch.device("cuda", 0)


def _program_here() -> None:
    import ompi_tpu_torch

    where = os.path.dirname(os.path.abspath(ompi_tpu_torch.__file__))
    if os.path.dirname(where) != ROOT:
        raise Refused(f"the program was loaded from {where}, not from "
                      f"this checkout")


def _no_jax() -> None:
    found = core.forbidden_modules()
    if found:
        raise Refused("loaded in this process: " + ", ".join(found))


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _number(x):
    return x if isinstance(x, (int, float)) and math.isfinite(x) else None


def _measure(sess, seconds: float, dev) -> dict:
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    _sync(dev)
    t0 = time.perf_counter()
    work = sess.window(seconds, t0)
    _sync(dev)
    work["window_s"] = time.perf_counter() - t0
    work["peak_bytes"] = (torch.cuda.max_memory_allocated(dev)
                          if dev.type == "cuda" else 0)
    work.update(sess.outcome())
    return work


def _traced(sess, dev, cell) -> tuple:
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    records: dict = {}
    with spans.installed(sess.SPANS, records):
        with profile(activities=acts) as prof:
            _sync(dev)
            with record_function("bench.window"):
                work = sess.traced_window()
                _sync(dev)
    work.update(sess.outcome())
    tmp = tempfile.mkdtemp(prefix="bench-trace-")
    path = os.path.join(tmp, "trace.json")
    try:
        prof.export_chrome_trace(path)
        del prof
        trace = Trace.load(path)
    finally:
        if os.path.exists(path):
            os.remove(path)
        os.rmdir(tmp)
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    ctx = types.SimpleNamespace(
        trace=trace, work=work, records=records, kind=cell.mix["kind"],
        model=cell.config["model"], mix=cell.mix, peak=roofline.peaks(kind))
    return work, ctx


def run(argv=None, device=None, bench=None, t_start=None) -> dict:
    """One run → the result's dict.  ``device`` skips the look for a card
    (tests on the CPU); ``bench`` a :class:`core.Bench` of another
    folder."""
    t_start = T0 if t_start is None else t_start
    args = _args(argv)
    bench = bench or core.Bench()
    cell = bench.cell(args.workload)
    _program_here()
    dev = _device(cell.chips) if device is None else torch.device(device)
    gen = bench.kind(cell.mix["kind"])
    sess = gen.Session(cell, args.seed, dev)
    sess.setup()
    _sync(dev)
    setup_s = time.perf_counter() - t_start
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    if args.trace:
        work, ctx = _traced(sess, dev, cell)
        if dev.type == "cuda":
            peak = torch.cuda.max_memory_allocated(dev)
    else:
        work = _measure(sess, args.seconds, dev)
        peak = max(peak, work["peak_bytes"])
    _no_jax()
    sess.free()
    numbers = sess.check()
    correct, compared = checks.verdict(numbers, cell.limits["limits"])

    metrics, breakdown = {}, None
    if args.trace:
        for m in bench.metrics("per_layer", cell.name):
            value = bench.reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        dev_extra = {"busy_s": ctx.trace.busy_seconds(),
                     "window_s": ctx.trace.window_seconds()}
        breakdown = {"device_ops": ctx.trace.top_device_ops(),
                     "idle_gaps": ctx.trace.idle_gaps()}
    else:
        values = {"setup_s": setup_s,
                  "peak_mem_gib": work["peak_bytes"] / GIB,
                  sess.RATE: work["tokens"] / work["window_s"]}
        for m in bench.metrics("end_to_end", cell.name):
            if m["name"] not in values:
                raise KeyError(f"{cell.name} cannot report {m['name']}")
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
        dev_extra = {}
    line = {
        "correct": bool(correct),
        "attempted": int(work["attempted"]),
        "failed": int(work["failed"]),
        "metrics": metrics,
        "device": {
            "platform": "gpu" if dev.type == "cuda" else "cpu",
            "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                     else "cpu"),
            "count": cell.chips if dev.type == "cuda" else 1,
            "memory_peak_bytes": int(peak), **dev_extra},
    }
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = {k: {"value": _number(v["value"]), "limit": v["limit"]}
                      for k, v in compared.items()}
    _no_jax()
    return line


def main(argv=None) -> int:
    try:
        line = run(argv)
    except Refused as e:
        print(f"benchmark: refused: {e}", file=sys.stderr)
        return 2
    for name, c in line["checks"].items():
        ok = (None not in (c["value"], c["limit"])
              and c["value"] <= c["limit"])
        print(f"check {name} {c['value']!r} limit {c['limit']!r} "
              f"{'ok' if ok else 'FAIL'}", file=sys.stderr, flush=True)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
