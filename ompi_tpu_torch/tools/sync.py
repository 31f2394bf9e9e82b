"""ompi-tpu-sync — cross-rank clock-offset measurement (the port's copy
of the JAX package's ``tools/sync.py``, over the port's communicator and
numpy buffers; it imports no torch).

≈ ompi/tools/mpisync: measures each rank's wall-clock offset against rank 0
so cross-host traces (monitoring matrices, xprof timelines) can be aligned
to one timebase.  Same algorithm as the reference (and NTP): a ping-pong
per sample; the peer's clock read is bracketed by the origin's send/recv
timestamps, offset = t_peer − (t_send + t_recv)/2, and the sample with the
smallest round-trip wins (least queueing noise).

Run under the launcher::

    tpurun -np 4 -- python -m ompi_tpu_torch.tools.sync

or call :func:`clock_offsets` from a program that already has a
communicator (the monitoring subsystem feeds the result into trace
alignment).
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np

__all__ = ["clock_offsets", "main"]

_TAG_PING = 0x53C0
_TAG_PONG = 0x53C1


def clock_offsets(comm, samples: int = 32
                  ) -> Optional[dict[int, tuple[float, float]]]:
    """Measure every rank's clock offset against rank 0.

    Collective over ``comm``.  Returns ``{rank: (offset_s, min_rtt_s)}``
    on rank 0 (offset > 0 ⇒ that rank's clock is ahead), ``None``
    elsewhere.  Accuracy ≈ min_rtt/2 (the reference's bound as well —
    mpisync carries the same ±rtt/2 uncertainty).
    """
    if comm.rank == 0:
        out: dict[int, tuple[float, float]] = {0: (0.0, 0.0)}
        for peer in range(1, comm.size):
            best_rtt, best_off = float("inf"), 0.0
            for _ in range(samples):
                t0 = time.time()
                comm.send(np.array([t0], np.float64), dest=peer,
                          tag=_TAG_PING)
                tp = float(comm.recv(source=peer, tag=_TAG_PONG)[0])
                t1 = time.time()
                rtt = t1 - t0
                if rtt < best_rtt:
                    best_rtt = rtt
                    best_off = tp - (t0 + t1) / 2.0
            out[peer] = (best_off, best_rtt)
        return out
    for _ in range(samples):
        comm.recv(source=0, tag=_TAG_PING)
        comm.send(np.array([time.time()], np.float64), dest=0,
                  tag=_TAG_PONG)
    return None


def main(argv: Optional[list[str]] = None) -> int:
    import argparse

    import ompi_tpu_torch

    p = argparse.ArgumentParser(
        prog="ompi-tpu-sync",
        description="measure per-rank clock offsets against rank 0 "
                    "(≈ mpisync)")
    p.add_argument("-n", "--samples", type=int, default=32,
                   help="ping-pong samples per peer (min-RTT filtered)")
    args = p.parse_args(argv)

    comm = ompi_tpu_torch.init()
    result = clock_offsets(comm, samples=args.samples)
    if result is not None:
        print(f"# clock offsets vs rank 0 ({comm.size} ranks, "
              f"{args.samples} samples, min-RTT filter)")
        print(f"# {'rank':>4} {'offset_us':>12} {'min_rtt_us':>12}")
        for rank in sorted(result):
            off, rtt = result[rank]
            print(f"  {rank:>4} {off * 1e6:>12.1f} {rtt * 1e6:>12.1f}")
    ompi_tpu_torch.finalize()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
