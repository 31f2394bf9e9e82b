"""MPMD dispatch shim for spawn_multiple (the port's copy of the JAX
package's ``mpi/_mpmd_dispatch.py``; ≈ the reference's multi-app-context
job: orterun a.out : b.out builds one orte_job_t with several app contexts,
each rank exec'ing its context's argv).

Launched as every rank of a spawn_multiple child job; execs this rank's argv
from the OMPI_TPU_MPMD_TABLE environment table, inheriting the launcher's
rank/pmix environment so the target program's init() sees the full world.
"""

import json
import os
import sys


def main() -> None:
    table = json.loads(os.environ["OMPI_TPU_MPMD_TABLE"])
    rank = int(os.environ["OMPI_TPU_RANK"])
    argv, env = table[rank]
    os.environ.update(env)  # this command block's env (spawn_multiple envs[i])
    os.execvp(argv[0], argv)


if __name__ == "__main__":
    main()
