"""Both routes of one communicator in one job: ``init()``, then
``make_mesh()`` over the job's process group, ``comm.bind_device(
device_world(mesh))``, one ``allreduce`` of a tensor on the rank's card
(the device route, coll/xla → NCCL) and one of a numpy array (the host
route: coll/shm's arena when the ranks share a host, else coll/host over
the ob1 PML), each printed with a checksum.

Run:  python -m ompi_tpu_torch.tools.tpurun -np 1 --gpu -- python -m ompi_tpu_torch.examples.device_allreduce

``--mib`` sets the tensor's size (default 64 MiB of float32);
``--device cpu`` runs the device route on gloo CPU tensors (with the
rendezvous exported by hand, ``-x OMPI_TPU_COORD=127.0.0.1:<port>``).
Both routes sum the same data (small integers: every order of summation
is exact).  Each rank prints one ``device_allreduce {json}`` line: its
card (``OMPI_TPU_CHIP`` and ``torch.cuda.current_device()``), the
process group's size and the mesh, whether the communicator's result
equals the direct ``DeviceCommunicator.allreduce`` bit for bit and the
host route's, the tensor copies to the host made inside the
communicator's call (on the card, the device-to-host copies that
torch.profiler records; on the CPU, the calls that stage a tensor
through numpy), whether the host result equals numpy's sum, the
checksums, the host route's provider, coll/shm's mode and the BTL route
to the next rank, and the device route's error when ranks share a card
(the host route runs all the same).
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch
import torch.distributed as dist

import ompi_tpu_torch
from ompi_tpu_torch.mpi.device_comm import device_world
from ompi_tpu_torch.parallel.mesh import make_mesh


def _checksum(a: np.ndarray) -> str:
    return f"{float(a.astype(np.float64).sum()):.6e}"


def _dtoh_copies(fn, x):
    """Run ``fn`` in a torch.profiler window; (its result, the
    device-to-host copies the card made in it).  A deliberate copy of one
    element after ``fn`` is the control: the window must show it, or the
    count is None (the profiler saw nothing, so a zero would prove
    nothing)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        x[:1].clone()              # a window may miss its first event
        out = fn()
        x[:1].cpu()                # the control
        torch.cuda.synchronize()
    seen = sum(e.count for e in prof.key_averages()
               if e.device_type.name == "CUDA" and "DtoH" in e.key)
    return out, (seen - 1 if seen else None)


def _staging_calls(fn):
    """Run ``fn`` on CPU tensors, counting the calls that would stage a
    tensor through numpy or Python values (a CPU tensor makes no device
    copy for a profiler to see); (its result, the count)."""
    names = ("numpy", "tolist", "item", "cpu")
    saved = {n: getattr(torch.Tensor, n) for n in names}
    hits = []

    def watch(name, orig):
        def call(self, *a, **k):
            hits.append(name)
            return orig(self, *a, **k)
        return call

    for n in names:
        setattr(torch.Tensor, n, watch(n, saved[n]))
    try:
        out = fn()
    finally:
        for n in names:
            setattr(torch.Tensor, n, saved[n])
    return out, len(hits)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--mib", type=float, default=64.0)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)

    comm = ompi_tpu_torch.init()
    mesh = make_mesh(device=args.device)
    comm.bind_device(device_world(mesh))
    n = int(args.mib * (1 << 20)) // 4
    # small integers: every order of summation is exact
    rng = np.random.default_rng(1234 + comm.rank)
    h = rng.integers(-8, 8, size=n).astype(np.float32)
    x = torch.from_numpy(h).to(mesh.device)
    res = {"rank": comm.rank, "size": comm.size,
           "chip": os.environ.get("OMPI_TPU_CHIP"),
           "current_device": (torch.cuda.current_device()
                              if args.device == "cuda" else None),
           "group_size": dist.get_world_size() if dist.is_initialized()
           else None,
           "mesh": mesh.shape, "mesh_device": str(mesh.device),
           "bytes": n * 4,
           "provider": comm.coll.device_providers.get("allreduce"),
           "device_error": None}
    host = comm.allreduce(h)
    res["host_checksum"] = _checksum(host)
    res["host_provider"] = comm.coll.providers["allreduce"]
    res["host_mode"] = getattr(comm._coll_shm_state, "mode", None)
    res["host_route"] = comm.pml.endpoint.route((comm.rank + 1) % comm.size)
    try:
        comm.allreduce(x)   # warm: NCCL's first call, outside the window
        if args.device == "cuda":
            got, copies = _dtoh_copies(lambda: comm.allreduce(x), x)
        else:
            got, copies = _staging_calls(lambda: comm.allreduce(x))
        want = comm.device.allreduce(x)
        res["device_equal"] = bool(torch.equal(got, want))
        res["device_host_copies"] = copies
        got = got.cpu().numpy()
        res["device_checksum"] = _checksum(got)
        res["routes_equal"] = bool(np.array_equal(got, host))
    except NotImplementedError as e:
        res["device_error"] = str(e)
    res["host_equal"] = bool(np.array_equal(host, sum(
        np.random.default_rng(1234 + r).integers(-8, 8, size=n).astype(
            np.float32) for r in range(comm.size))))
    print(f"Rank {comm.rank} of {comm.size}: device allreduce "
          f"{res.get('device_checksum', 'refused')}, host allreduce "
          f"{res['host_checksum']}")
    print("device_allreduce " + json.dumps(res), flush=True)
    ompi_tpu_torch.finalize()
    return res


if __name__ == "__main__":
    main()
