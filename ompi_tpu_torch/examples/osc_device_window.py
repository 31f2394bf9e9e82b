"""One-sided device RMA: a ``DeviceWindow`` over the job's ranks (the
port's copy of the repo's ``examples/osc_device_window.py``, printing
the same lines).

Every rank holds one (4, 128) float32 part of the window on its device
and maps its peers' parts (CUDA IPC on the card, shared memory on the
CPU).  The put is NOT a collective: bytes move once, origin → target,
through the one-sided copy kernel of ``ops/remote_dma`` (on the CPU its
plain version).

Run on the card (two ranks may share one card: the window needs no
NCCL group):

    python -m ompi_tpu_torch.tools.tpurun -np 2 --gpu -- python -m ompi_tpu_torch.examples.osc_device_window

``--device cpu`` runs on gloo CPU ranks, with the rendezvous exported by
hand (``-x OMPI_TPU_COORD=127.0.0.1:<port> -x OMPI_TPU_NHOSTS=1``).
Besides the reference's lines, each rank prints one
``osc_device_window {json}`` line: its rank, device, the values it saw
and the put/get kernel launches it made.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch.distributed as dist

import ompi_tpu_torch
from ompi_tpu_torch.mpi.device_comm import device_world
from ompi_tpu_torch.mpi.osc import DeviceWindow
from ompi_tpu_torch.ops import remote_dma
from ompi_tpu_torch.parallel.mesh import make_mesh


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)

    ompi_tpu_torch.init()
    mesh = make_mesh(device=args.device)
    comm = device_world(mesh)
    n, me = comm.size, comm.rank()
    if n < 2:
        raise SystemExit("need >= 2 ranks (origin and target differ): "
                         "launch with tpurun -np 2 or more")
    if me == 0:
        print(f"{n}-device window over {mesh.device.type}")

    put0, get0 = remote_dma.put_launch_count, remote_dma.get_launch_count
    win = DeviceWindow(comm, local_shape=(4, 128), dtype=np.float32)
    win.put(np.full((4, 128), 42.0, np.float32), origin=0, target=n - 1)
    win.fence()
    mine = win.local(me)
    want = 42.0 if me == n - 1 else 0.0
    assert np.all(mine == want), (me, mine)
    fetched = win.get(origin=1, target=n - 1)
    if me in (1, n - 1):
        assert np.all(fetched == 42.0), (me, fetched)
    win.fence()
    if me == 1:
        print(f"one-sided put landed on device {n - 1}; "
              f"one-sided get fetched it back: {fetched[0, 0]}")
    res = {"rank": me, "size": n, "device": str(mesh.device),
           "local": float(mine[0, 0]), "fetched": float(fetched[0, 0]),
           "put_launches": remote_dma.put_launch_count - put0,
           "get_launches": remote_dma.get_launch_count - get0}
    win.free()
    print("osc_device_window " + json.dumps(res), flush=True)
    if dist.is_initialized():
        dist.barrier()
    ompi_tpu_torch.finalize()
    return res


if __name__ == "__main__":
    main()
