"""Hello world (≈ examples/hello_c.c): rank/size + identity print; the
port's copy of the repo's ``examples/hello.py``, printing the same line.

Run:  python -m ompi_tpu_torch.tools.tpurun -np 4 -- python -m ompi_tpu_torch.examples.hello
"""

import ompi_tpu_torch


def main() -> None:
    comm = ompi_tpu_torch.init()
    print(f"Hello, world, I am {comm.rank} of {comm.size}")
    ompi_tpu_torch.finalize()


if __name__ == "__main__":
    main()
