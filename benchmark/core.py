"""Finding a cell's files by name, and the checks every run makes.

``BENCHMARK.json`` (at the checkout's root) names the cells and the
metrics.  For a cell ``<cell>`` of configuration ``<config>`` and
traffic mix ``<mix>`` the harness reads:

- ``configs/<config>.json``: the model, its training and serving
  options, what was reduced and assumed;
- ``traffic/<mix>.json``: the mix's parameters, with ``kind`` naming the
  generator ``traffic/<kind>.py`` that drives the program with them;
- ``workloads/<cell>.json``: the limits of the numbers that decide
  ``correct``, and the readings they were set from;
- ``metrics/<metric>.py``: each per-layer metric's reader, a function
  ``read(ctx)`` that returns a number or None.

So a new configuration, mix, cell or metric is new files and entries,
and no file here changes.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
#: top-level modules that may not be loaded in a run (the JAX stack and
#: the JAX package, whose name the port's begins with)
FORBIDDEN = ("jax", "jaxlib", "flax", "ompi_tpu")


@dataclasses.dataclass
class Cell:
    name: str
    entry: dict
    config: dict
    mix: dict
    limits: dict
    chips: int


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _module(path: str, tag: str):
    spec = importlib.util.spec_from_file_location(tag, path)
    if spec is None or not os.path.isfile(path):
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Bench:
    """The manifest and the files of one benchmark folder."""

    def __init__(self, here: str = HERE, manifest: str = None):
        self.here = here
        self.manifest = _json(manifest or os.path.join(
            os.path.dirname(here), "BENCHMARK.json"))

    def path(self, *parts) -> str:
        return os.path.join(self.here, *parts)

    def cell(self, name: str) -> Cell:
        entry = next((w for w in self.manifest["workloads"]
                      if w["name"] == name), None)
        if entry is None:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        config = _json(self.path("configs", entry["config"] + ".json"))
        mix = _json(self.path("traffic", entry["traffic"] + ".json"))
        limits = _json(self.path("workloads", name + ".json"))
        return Cell(name, entry, config, mix, limits, int(entry["chips"]))

    def kind(self, kind: str):
        """The generator of a traffic kind (``traffic/<kind>.py``)."""
        return _module(self.path("traffic", kind + ".py"),
                       f"benchmark_traffic_{kind}")

    def metrics(self, section: str, cell: str) -> list:
        """The ``section`` metrics (``end_to_end`` or ``per_layer``) that
        ``cell`` reports: those that list it, or that list no cell."""
        return [m for m in self.manifest[section]
                if cell in m.get("workloads", [cell])]

    def reader(self, metric: str):
        """``read(ctx)`` of ``metrics/<metric>.py``."""
        tag = "benchmark_metric_" + metric.replace(".", "_").replace("-", "_")
        return _module(self.path("metrics", metric + ".py"), tag).read


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name (the part before the first
    dot, compared whole) is of the JAX stack or the JAX package."""
    names = sys.modules if modules is None else modules
    return sorted({m for m in names if m.split(".")[0] in FORBIDDEN})
