"""The port's benchmark: one run of one cell, driven by the files here.

``python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` from the root of a checkout.  ``BENCHMARK.json`` at the
root names the cells; each cell's configuration, traffic mix, limits and
per-layer metrics sit in files of their own under this folder, found by
name (``core``).  Nothing here imports JAX or the JAX package.
"""
