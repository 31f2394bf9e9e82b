"""chaos_soak — seeded fault plans vs. every recovery policy we ship (the
port's copy of the repo's ``tools/chaos_soak.py``: every plan class,
``--canary`` over the port's DVM and the replay check, each run through
``python -m ompi_tpu_torch.tools.tpurun``).

Generates K fault plans from one seed, runs each against the policy it
targets, and asserts the job lands in that policy's *defined* state:

- ``respawn``       — a rank is killed mid-ring; errmgr revives it, it
  restores from its ckpt snapshot, the job exits 0 with the exact accs.
- ``notify-shrink`` — a rank is killed mid-allreduce under ``--mca
  errmgr notify`` (optionally with seeded FT-frame drops); survivors
  revoke + agree + shrink + resume, every survivor prints the SAME,
  recomputable final acc, exit 0.
- ``continue``      — a rank is killed under ``--mca errmgr continue``;
  survivors (whose work never depended on it) finish, exit 0.
- ``abort``         — the default policy: the kill tears the whole job
  down; exit is nonzero and the abort help text names the dead rank.
- ``midtree-kill``  — a NON-LEAF orted is SIGKILLed on the sim daemon
  tree under ``notify``: its orphaned child daemons re-parent to the
  grandparent (TAG_REPARENT handshake, HNP arbitrating) instead of
  applying the lifeline teardown, so every other host's ranks finish
  and the job exits 0 — loss confined to the dead host.
- ``rank-hang``     — a rank SIGSTOPs mid-run (alive pid, silent rank:
  invisible to the daemon heartbeat layer); rank-plane gossip
  heartbeats declare it suspect, survivors shrink and finish with the
  same recomputed acc a kill would give, and the reported pid is
  reaped so the job exits 0.
- ``writer-death``  — a rank dies mid-collective inside the coll/shm
  arena with runtime dead-set polling crippled: the arena wait's btl
  pid probe surfaces MPI_ERR_PROC_FAILED in ~the probe grace (the
  driver asserts the printed time-to-error stays far below the 60 s
  ``coll_shm_timeout``), then the normal shrink recipe finishes.
- ``selfheal-hang`` — a rank SIGSTOPs mid-ring under ``--mca errmgr
  selfheal``: gossip declares it, the control plane reaps the hung pid,
  the errmgr revives it in place, it restores from its last snapshot
  (``snapc.auto_restore``) and the msglog replays the in-flight gap —
  every rank (victim included) finishes with the full-ring acc, and the
  survivors' printed failure→success gap (``heal_dt``) bounds the
  detect→rejoin cycle under 15 s.
- ``coll-hang``     — a rank stalls INSIDE its Kth collective
  (``stall@coll=K``, spin mode so its crash dump still flushes); the
  survivors wedge in the arena until ``coll_shm_timeout`` aborts the
  job, and the OFFLINE hang doctor (``tools.hang_doctor --dir``)
  must name the stalled rank as the straggler from the per-rank crash
  dumps alone — the postmortem-doctor acceptance class.
- ``selfheal-coll``  — the collective-capable rejoin prover: a 4-rank
  allreduce loop under ``--mca errmgr selfheal`` whose victim dies at
  its Nth top-level collective dispatch (``kill@coll=N`` — inside the
  dispatch, before publishing).  Survivors' allreduces fail fast, the
  errmgr revives the victim, it restores from its snapshot, and the
  survivors' epoch-fenced rebuild re-runs the node split + arena
  bootstrap with the revived rank included — every rank (victim too)
  converges to FULL-WORLD answers on the shm arena (``fallback=0``,
  mode ``arena``) with exactly one rejoin per survivor.
- ``selfheal-crashloop`` — a rank dies at the same step in EVERY life
  (the ``crash`` fault kind): the revive budget burns with backoff
  (min-uptime gating forced on via ``errmgr_min_uptime_s``), the policy
  escalates revive → shrink, survivors finish and the job exits 0
  smaller — with exactly ``errmgr_max_restarts`` revive events and one
  escalation event in the notifier stream.

No run may hang (every subprocess has a hard timeout — a timeout is a
soak failure), and no run may print a wrong answer (expected values are
recomputed by this driver from the plan, never trusted from the app).

``--canary`` flips the harness from single-shot launches to a standing
multi-tenant pool: one DVM (``--mca errmgr selfheal``) serves every
cycle, and each cycle submits TWO concurrent tenants — a chaos victim
running a seeded selfheal-class fault (kill@step / hang@step /
kill@coll, rotating) and a fault-free canary ring.  Both must exit 0
with their exact recomputed accs: the victim proves in-place recovery
works through the shared daemon tree, the canary proves ZERO
interference (its answers never wobble while its co-tenant is being
healed next door).  errmgr is a VM-level selection on a standing DVM,
so only selfheal-compatible classes rotate here; the doctor-driven
remediation ladder (SIGCONT probe / requeue / reject) is exercised by
the pool-smoke CI job and tests/runtime/test_dvm_sched.py, not this
mode — the canary pins ``dvm_remediate 0`` so the two recovery layers
are proven separately, not racing each other.

Replay determinism: each plan's first run is replayed with the same seed
and the fault logs are compared — injected kills must reproduce exactly
(same rank, same trigger step), and every frame verdict in both logs
must recompute to the same decision through the injector's pure hash
(``faultinject._u01``), which is the property that makes a plan a
*schedule* rather than a dice roll.

    python -m ompi_tpu_torch.tools.chaos_soak --plans 20 --seed 0
"""

from __future__ import annotations

import argparse
import json
import os
import random
import re
import subprocess
import sys
import tempfile
import threading
import time

from ompi_tpu_torch.testing import faultinject

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
#: the shrink recipe every notify-class plan runs (a module of the port)
SHRINK_APP = ("-m", "ompi_tpu_torch.examples.shrink_allreduce")

POLICIES = ("respawn", "notify-shrink", "continue", "abort",
            "midtree-kill", "rank-hang", "writer-death",
            "selfheal-hang", "selfheal-crashloop", "coll-hang",
            "selfheal-coll")

RING_APP = r"""
import os
import numpy as np
import ompi_tpu_torch
from ompi_tpu_torch.ckpt.msglog import MessageLog
from ompi_tpu_torch.ckpt.store import SnapshotStore
from ompi_tpu_torch.testing import faultinject

comm = ompi_tpu_torch.init()
rank, size = comm.rank, comm.size
store = SnapshotStore(os.environ["CKPT_DIR"], job=f"rank{rank}")
restarted = int(os.environ.get("OMPI_TPU_RESTART", "0"))
log = MessageLog(comm).attach(auto_replay=True)

start, acc = 0, 0.0
if restarted:
    seq = store.latest()
    if seq is not None:
        state = store.load_rank(seq, 0)
        start, acc = int(state["step"]) + 1, float(state["acc"])
    print(f"rank {rank} resumed at step {start}", flush=True)

right, left = (rank + 1) % size, (rank - 1) % size
steps = int(os.environ["SOAK_STEPS"])
for step in range(start, steps):
    faultinject.step()
    out = np.array([float(rank * 100 + step)])
    sreq = comm.isend(out, dest=right, tag=step)
    got = comm.recv(source=left, tag=step)
    sreq.wait()
    assert float(got[0]) == left * 100 + step, (step, got)
    acc += float(got[0])
    store.write_rank(step, 0, {"step": np.int64(step),
                               "acc": np.float64(acc)})
    store.commit(step, 1)

print(f"rank {rank} ring done acc={acc:.0f}", flush=True)
ompi_tpu_torch.finalize()
"""

LOCAL_APP = r"""
import numpy as np
import ompi_tpu_torch
from ompi_tpu_torch.testing import faultinject

comm = ompi_tpu_torch.init()
rank = comm.rank
import os
steps = int(os.environ["SOAK_STEPS"])
acc = 0.0
for step in range(steps):
    faultinject.step()
    acc += float(rank * 10 + step)
print(f"rank {rank} local done acc={acc:.0f}", flush=True)
ompi_tpu_torch.finalize()
"""

# the mid-tree plan: one rank per sim host, long enough past init that
# the injected daemon SIGKILL lands while ranks are quietly working —
# the orphaned daemons' ranks must keep running through the re-parenting
MIDTREE_APP = r"""
import time
import ompi_tpu_torch

comm = ompi_tpu_torch.init()
time.sleep(14.0)
print(f"rank {comm.rank} survived", flush=True)
ompi_tpu_torch.finalize()
"""

# the selfheal ring: same traffic as RING_APP, but under errmgr selfheal
# a peer's death is TRANSIENT (the errmgr is already reviving it) — ops
# that fail with PROC_FAILED retry until the revive lands, and the first
# failure→success gap per rank is printed so the driver can bound the
# whole detect→reap→revive→rejoin cycle
SELFHEAL_APP = r"""
import os, time
import numpy as np
import ompi_tpu_torch
from ompi_tpu_torch.ckpt import snapc
from ompi_tpu_torch.ckpt.msglog import MessageLog
from ompi_tpu_torch.ckpt.store import SnapshotStore
from ompi_tpu_torch.mpi.constants import ERR_PROC_FAILED, MPIException
from ompi_tpu_torch.testing import faultinject

comm = ompi_tpu_torch.init()
rank, size = comm.rank, comm.size
store = SnapshotStore(os.environ["CKPT_DIR"], job=f"rank{rank}")
log = MessageLog(comm).attach(auto_replay=True)

start, acc = 0, 0.0
restored = snapc.auto_restore(comm, store, rank=0)
if restored is not None:
    seq, state = restored
    start, acc = int(state["step"]) + 1, float(state["acc"])
    print(f"rank {rank} resumed at step {start} from snapshot {seq}",
          flush=True)

_t0 = [None]
def heal_retry(fn):
    # retry granularity is ONE operation: a send that died with the old
    # incarnation is re-sent (a duplicate of a delivered one parks
    # harmlessly — per-step tags never re-match), while a recv retries
    # only if it never returned — wrapping a whole send+recv step would
    # re-post a recv whose message the first attempt already consumed
    while True:
        try:
            out = fn()
            if _t0[0] is not None:
                print(f"rank {rank} heal_dt={time.monotonic() - _t0[0]:.2f}",
                      flush=True)
                _t0[0] = None
            return out
        except MPIException as e:
            if e.error_class != ERR_PROC_FAILED:
                raise
            if _t0[0] is None:
                _t0[0] = time.monotonic()
            time.sleep(0.1)

steps = int(os.environ["SOAK_STEPS"])
right, left = (rank + 1) % size, (rank - 1) % size
for step in range(start, steps):
    faultinject.step()
    out = np.array([float(rank * 100 + step)])
    heal_retry(lambda: comm.isend(out, dest=right, tag=step).wait())
    got = heal_retry(lambda: comm.recv(source=left, tag=step))
    assert float(got[0]) == left * 100 + step, (step, got)
    acc += float(got[0])
    store.write_rank(step, 0, {"step": np.int64(step),
                               "acc": np.float64(acc)})
    store.commit(step, 1)

print(f"rank {rank} selfheal done acc={acc:.0f}", flush=True)
ompi_tpu_torch.finalize()
"""

# the coll-hang app: one small allreduce per step — the victim's
# stall@coll freezes it mid-dispatch, everyone else wedges in the arena
COLLHANG_APP = r"""
import os
import numpy as np
import ompi_tpu_torch
from ompi_tpu_torch.testing import faultinject

comm = ompi_tpu_torch.init()
steps = int(os.environ["SOAK_STEPS"])
acc = 0.0
for step in range(steps):
    faultinject.step()
    acc += float(comm.allreduce(np.full(32, float(comm.rank + step)))[0])
print(f"rank {comm.rank} collhang done acc={acc:.0f}", flush=True)
ompi_tpu_torch.finalize()
"""

# the collective-capable rejoin prover: an allreduce loop under errmgr
# selfheal.  The victim dies INSIDE its Nth top-level collective
# dispatch (kill@coll — after the recorder post, before publishing into
# the arena), survivors' in-flight allreduces fail fast, and once the
# revive is adopted the epoch-fenced rebuild re-runs the node split +
# arena bootstrap with the revived rank included: every step's answer
# is FULL-world, the provider stays the shm arena (no host fallback),
# and each survivor records exactly one coll_rejoin
SELFHEAL_COLL_APP = r"""
import os, time
import numpy as np
import ompi_tpu_torch
from ompi_tpu_torch.ckpt import snapc
from ompi_tpu_torch.ckpt.store import SnapshotStore
from ompi_tpu_torch.mpi import trace
from ompi_tpu_torch.mpi.constants import ERR_PROC_FAILED, MPIException
from ompi_tpu_torch.testing import faultinject

comm = ompi_tpu_torch.init()
rank, size = comm.rank, comm.size
store = SnapshotStore(os.environ["CKPT_DIR"], job=f"rank{rank}")

start, acc = 0, 0.0
restored = snapc.auto_restore(comm, store, rank=0)
if restored is not None:
    seq, state = restored
    start, acc = int(state["step"]) + 1, float(state["acc"])
    print(f"rank {rank} resumed at step {start}", flush=True)

def heal_retry(fn):
    # a collective is atomic at the app level: a failed attempt (peer
    # died / rejoin fence) completed on NO rank, so re-running the
    # whole op is the retry unit — the epoch-fenced rebuild underneath
    # guarantees the retried op runs on fresh arena counters
    while True:
        try:
            return fn()
        except MPIException as e:
            if e.error_class != ERR_PROC_FAILED:
                raise
            time.sleep(0.1)

steps = int(os.environ["SOAK_STEPS"])
for step in range(start, steps):
    faultinject.step()
    out = heal_retry(
        lambda: comm.allreduce(np.full(8, float(rank * 100 + step))))
    acc += float(out[0])
    store.write_rank(step, 0, {"step": np.int64(step),
                               "acc": np.float64(acc)})
    store.commit(step, 1)

st = comm._coll_shm_state
print(f"rank {rank} collrejoin done acc={acc:.0f} "
      f"mode={getattr(st, 'mode', '?')} "
      f"fallback={trace.counters['coll_shm_fallback_total']} "
      f"rejoins={trace.counters['coll_rejoin_total']}", flush=True)
ompi_tpu_torch.finalize()
"""

# the crash-loop prover: the victim dies at the SAME step in every life
# (fault kind ``crash``), survivors do independent local work — the
# job's fate rides entirely on the selfheal ladder escalating
# revive → shrink instead of aborting or reviving forever
CRASHLOOP_APP = r"""
import os, time
import ompi_tpu_torch
from ompi_tpu_torch.testing import faultinject

comm = ompi_tpu_torch.init()
rank = comm.rank
steps = int(os.environ["SOAK_STEPS"])
acc = 0.0
for step in range(steps):
    faultinject.step()
    acc += float(rank * 10 + step)
    time.sleep(0.2)
print(f"rank {rank} crashloop done acc={acc:.0f}", flush=True)
ompi_tpu_torch.finalize()
"""


def tpurun(args, env_extra=None, timeout=150):
    env = dict(os.environ)
    env.pop("OMPI_TPU_RANK", None)
    if env_extra:
        env.update(env_extra)
    return subprocess.run(
        [sys.executable, "-m", "ompi_tpu_torch.tools.tpurun", *args],
        capture_output=True, text=True, timeout=timeout, env=env, cwd=REPO)


def gen_plan(seed: int, idx: int, np_: int, steps: int) -> dict:
    """Plan idx of the soak: policy + victim + kill step + drop rate,
    all drawn from the seeded stream."""
    rng = random.Random(f"{seed}:{idx}")  # str seed: tuples raise on 3.11+
    policy = POLICIES[idx % len(POLICIES)]
    victim = rng.randrange(0, np_) \
        if policy in ("notify-shrink", "rank-hang", "writer-death",
                      "selfheal-hang", "selfheal-crashloop") \
        else rng.randrange(1, np_)
    kill_step = rng.randrange(1, steps - 1)
    drop = rng.choice((0.0, 0.05, 0.15)) if policy == "notify-shrink" \
        else 0.0
    if policy == "midtree-kill":
        # daemon 1 is the canonical mid-tree node of the 4-host binary
        # routing tree (children 3 and 4).  The kill is keyed on the
        # ranks-registered barrier (PMIx reg count), not wall-clock: on
        # a slow box a fixed t=6–8 s could land while 4 ranks were
        # still importing, turning a containment test into an init
        # abort — @reg=4 cannot fire before every rank finished booting
        kill_after = round(rng.uniform(1.0, 2.0), 1)
        return {"idx": idx, "policy": policy, "victim": 1,
                "kill_step": None, "kill_after": kill_after, "drop": 0.0,
                "plan": f"daemon=1:kill@reg=4:after={kill_after}",
                "seed": seed}
    if policy == "coll-hang":
        # the stall ordinal counts RECORDED dispatches (init barrier is
        # ordinal 0, every app step issues >= 1), so any K in [1, steps]
        # lands mid-run on every box
        victim = rng.randrange(0, np_)
        coll_n = rng.randrange(1, steps)
        return {"idx": idx, "policy": policy, "victim": victim,
                "kill_step": coll_n, "drop": 0.0,
                "plan": f"rank={victim}:stall@coll={coll_n}",
                "seed": seed}
    if policy == "selfheal-coll":
        # the victim's top-level dispatch ordinals: init barrier = 0,
        # step s allreduce = s + 1 — any N in [2, steps-1] dies at app
        # step N-1 with at least one committed snapshot behind it and
        # at least one full-world step after the rejoin
        victim = rng.randrange(0, np_)
        coll_n = rng.randrange(2, steps)
        return {"idx": idx, "policy": policy, "victim": victim,
                "kill_step": coll_n - 1, "drop": 0.0,
                "plan": f"rank={victim}:kill@coll={coll_n}",
                "seed": seed}
    if policy in ("rank-hang", "selfheal-hang"):
        plan = f"rank={victim}:hang@step={kill_step}"
    elif policy == "selfheal-crashloop":
        plan = f"rank={victim}:crash@step={kill_step}"
    else:
        plan = f"rank={victim}:kill@step={kill_step}"
    if drop:
        plan += f";drop={drop}"
    return {"idx": idx, "policy": policy, "victim": victim,
            "kill_step": kill_step, "drop": drop, "plan": plan,
            "seed": seed}


def expected_shrink_acc(np_: int, steps: int, victim: int,
                        kill_step: int) -> float:
    """The acc every shrink_allreduce survivor must print: full-world
    sums for agreed steps before the kill, survivor sums from it on."""
    acc = 0.0
    for s in range(steps):
        ids = range(np_) if s < kill_step else \
            [i for i in range(np_) if i != victim]
        acc += sum(i * 10 + s for i in ids)
    return acc


def _assert_shrink_out(r, plan: dict, np_: int, steps: int) -> str:
    """Shared shrink-and-continue postcondition: exit 0 and every
    survivor prints the recomputed acc (a hang at step K and a kill at
    step K account identically — the victim froze/died BEFORE
    contributing step K, so agreed steps < K are full-world)."""
    out = r.stdout + r.stderr
    assert r.returncode == 0, \
        f"{plan['policy']} rc={r.returncode}: {out[-2000:]}"
    want = expected_shrink_acc(np_, steps, plan["victim"],
                               plan["kill_step"])
    survivors = [i for i in range(np_) if i != plan["victim"]]
    for rank in survivors:
        line = (f"id {rank} final acc={want:.0f} "
                f"size={len(survivors)} shrinks=1")
        assert line in out, (line, out[-2000:])
    return out


def run_plan(plan: dict, np_: int, steps: int, log_dir: str,
             verbose: bool) -> None:
    policy = plan["policy"]
    ck = tempfile.mkdtemp(prefix=f"chaos_ck_{plan['idx']}_")
    env = {"CKPT_DIR": ck, "SOAK_STEPS": str(steps),
           "SHRINK_DEMO_STEPS": str(steps),
           "OMPI_TPU_FAULT_LOG_DIR": log_dir}
    mca = ["--mca", "faultinject_plan", plan["plan"],
           "--mca", "faultinject_seed", str(plan["seed"])]
    if policy == "respawn":
        r = tpurun(["-np", str(np_), "--mca", "errmgr", "respawn", *mca,
                    "--", sys.executable, "-c", RING_APP], env)
        out = r.stdout + r.stderr
        assert r.returncode == 0, f"respawn rc={r.returncode}: {out[-2000:]}"
        assert f"rank {plan['victim']} resumed at step" in out, out[-2000:]
        for rank in range(np_):
            acc = sum(((rank - 1) % np_) * 100 + s for s in range(steps))
            assert f"rank {rank} ring done acc={acc:.0f}" in out, \
                (rank, acc, out[-2000:])
    elif policy == "notify-shrink":
        r = tpurun(["-np", str(np_), "--mca", "errmgr", "notify", *mca,
                    "--", sys.executable,
                    *SHRINK_APP],
                   env)
        _assert_shrink_out(r, plan, np_, steps)
    elif policy == "rank-hang":
        # SIGSTOP'd rank: alive pid, silent peer — only the rank-plane
        # gossip heartbeats can see it.  Survivors shrink and finish with
        # the SAME acc a kill at that step gives; the reported pid is
        # reaped via the control plane so the job still exits 0.
        r = tpurun(["-np", str(np_), "--mca", "errmgr", "notify",
                    "--mca", "ft_gossip_period", "0.3",
                    "--mca", "ft_gossip_timeout", "2.0", *mca,
                    "--", sys.executable,
                    *SHRINK_APP],
                   env, timeout=240)
        _assert_shrink_out(r, plan, np_, steps)
    elif policy == "writer-death":
        # the arena writer dies mid-collective while runtime dead-set
        # polling is crippled (ft_poll_period 30): the btl pid probe in
        # the arena wait is what must surface the failure — the printed
        # time-to-error stays in the probe window, not the 60 s timeout
        r = tpurun(["-np", str(np_), "--mca", "errmgr", "notify",
                    "--mca", "ft_poll_period", "30",
                    "--mca", "coll_shm_probe_grace", "1.0", *mca,
                    "--", sys.executable,
                    *SHRINK_APP],
                   env, timeout=240)
        out = _assert_shrink_out(r, plan, np_, steps)
        detects = [float(m) for m in
                   re.findall(r"detect_dt=([0-9.]+)", out)]
        assert detects, f"no detect_dt lines: {out[-2000:]}"
        assert max(detects) < 15.0, \
            (f"writer death took {max(detects):.1f}s to surface — "
             f"the arena probe should beat the 60s coll_shm_timeout")
    elif policy == "midtree-kill":
        # a NON-LEAF daemon dies: without re-parenting its whole subtree
        # (daemons 3 and 4 → ranks 2 and 3) would apply the lifeline
        # teardown; with it, only the dead host's rank is lost
        r = tpurun(["-np", "4", "--plm", "sim", "--hosts", "4",
                    "--mca", "errmgr", "notify",
                    "--mca", "multihost_auto_init", "0",
                    "--mca", "rml_heartbeat_period", "0.2",
                    "--mca", "rml_heartbeat_timeout", "2.0", *mca,
                    "--", sys.executable, "-c", MIDTREE_APP],
                   env, timeout=240)
        out = r.stdout + r.stderr
        assert r.returncode == 0, \
            f"midtree rc={r.returncode}: {out[-3000:]}"
        assert "daemon-reparent" in out, \
            f"no re-parenting event: {out[-3000:]}"
        # ranks 2 and 3 live on the ORPHANED daemons — their survival is
        # the re-parenting proof (rank 0 died with daemon 1; rank 1's
        # daemon 2 was never involved)
        for rank in (1, 2, 3):
            assert f"rank {rank} survived" in out, (rank, out[-3000:])
        assert "rank 0 survived" not in out, out[-3000:]
    elif policy == "selfheal-hang":
        # the full self-healing cycle: gossip detects the SIGSTOP, the
        # control plane reaps the pid, the errmgr revives it in place,
        # it restores from its snapshot, and the ring CONVERGES to the
        # full-world answer — nobody shrinks, nobody aborts
        # window 4 s (vs rank-hang's 2 s): a revived rank's interpreter
        # start saturates a small box's cores for seconds, and a too-
        # tight window then false-declares HEALTHY ranks mid-rejoin —
        # the detect→rejoin bound below still holds with 3x margin
        r = tpurun(["-np", str(np_), "--mca", "errmgr", "selfheal",
                    "--mca", "ft_gossip_period", "0.5",
                    "--mca", "ft_gossip_timeout", "4.0", *mca,
                    "--", sys.executable, "-c", SELFHEAL_APP],
                   env, timeout=240)
        out = r.stdout + r.stderr
        assert r.returncode == 0, \
            f"selfheal-hang rc={r.returncode}: {out[-3000:]}"
        assert f"rank {plan['victim']} resumed at step" in out, out[-3000:]
        assert "selfheal revive" in out, \
            f"no selfheal revive event: {out[-3000:]}"
        for rank in range(np_):
            acc = sum(((rank - 1) % np_) * 100 + s for s in range(steps))
            assert f"rank {rank} selfheal done acc={acc:.0f}" in out, \
                (rank, acc, out[-3000:])
        heals = [float(m) for m in re.findall(r"heal_dt=([0-9.]+)", out)]
        assert heals, f"no heal_dt lines: {out[-3000:]}"
        assert max(heals) < 15.0, \
            (f"detect→rejoin took {max(heals):.1f}s — the gossip window "
             f"+ reap + revive + restore cycle must stay under 15s")
    elif policy == "selfheal-coll":
        # the collective-capable rejoin: victim dies INSIDE a collective,
        # revives, and the epoch-fenced rebuild lets every rank finish
        # with FULL-world answers on the shm arena — transparently to
        # the allreduce loop (only the app-level PROC_FAILED retry the
        # FT contract already requires)
        r = tpurun(["-np", str(np_), "--mca", "errmgr", "selfheal", *mca,
                    "--", sys.executable, "-c", SELFHEAL_COLL_APP],
                   env, timeout=240)
        out = r.stdout + r.stderr
        assert r.returncode == 0, \
            f"selfheal-coll rc={r.returncode}: {out[-3000:]}"
        assert f"rank {plan['victim']} resumed at step" in out, out[-3000:]
        assert "selfheal revive" in out, \
            f"no selfheal revive event: {out[-3000:]}"
        total = sum(range(np_)) * 100
        acc = sum(total + np_ * s for s in range(steps))
        for rank in range(np_):
            # full-world answers, the shm arena (not host fallback), and
            # exactly one epoch-fenced rejoin per survivor (the revived
            # life builds FRESH state — no rejoin to count)
            want = (f"rank {rank} collrejoin done acc={acc:.0f} "
                    f"mode=arena fallback=0 "
                    f"rejoins={0 if rank == plan['victim'] else 1}")
            assert want in out, (want, out[-3000:])
    elif policy == "selfheal-crashloop":
        # the escalation ladder: the victim dies at the same step every
        # life; min-uptime gating (forced high) classifies every
        # re-death as a crash loop, the budget burns with backoff, and
        # the policy degrades revive → shrink — the job survives
        # smaller, with a deterministic revive/escalation event count
        r = tpurun(["-np", str(np_), "--mca", "errmgr", "selfheal",
                    "--mca", "errmgr_max_restarts", "2",
                    "--mca", "errmgr_min_uptime_s", "30", *mca,
                    "--", sys.executable, "-c", CRASHLOOP_APP],
                   env, timeout=240)
        out = r.stdout + r.stderr
        assert r.returncode == 0, \
            f"selfheal-crashloop rc={r.returncode}: {out[-3000:]}"
        for rank in range(np_):
            if rank == plan["victim"]:
                continue
            acc = sum(rank * 10 + s for s in range(steps))
            assert f"rank {rank} crashloop done acc={acc:.0f}" in out, \
                (rank, out[-3000:])
        assert f"rank {plan['victim']} crashloop done" not in out, \
            f"crash-looping victim claims completion: {out[-3000:]}"
        revives = out.count("selfheal revive")
        assert revives == 2, \
            (f"expected exactly 2 revives (errmgr_max_restarts) before "
             f"escalation, saw {revives}: {out[-3000:]}")
        assert "selfheal-escalate" in out and "degrading to shrink" in out, \
            f"no revive→shrink escalation event: {out[-3000:]}"
    elif policy == "coll-hang":
        # victim stalls inside collective K (spin: its dump flushes at
        # teardown); peers wedge until coll_shm_timeout aborts the job;
        # the OFFLINE doctor must then name the victim from dumps alone
        tdir = tempfile.mkdtemp(prefix=f"chaos_doctor_{plan['idx']}_")
        r = tpurun(["-np", str(np_), "--timeout", "90",
                    "--mca", "faultinject_hang_mode", "spin",
                    "--mca", "coll_shm_timeout", "10",
                    "--mca", "coll_stuck_timeout", "2", *mca,
                    "--", sys.executable, "-c", COLLHANG_APP],
                   dict(env, TMPDIR=tdir, OMPI_TPU_TRACE="1"),
                   timeout=240)
        out = r.stdout + r.stderr
        assert r.returncode != 0, \
            f"coll-hang exited 0 despite a stalled rank: {out[-2000:]}"
        assert f"rank {plan['victim']} collhang done" not in out, \
            f"stalled victim claims completion: {out[-2000:]}"
        dr = subprocess.run(
            [sys.executable, "-m", "ompi_tpu_torch.tools.hang_doctor",
             "--dir", tdir, "--expect", f"straggler:{plan['victim']}"],
            capture_output=True, text=True, timeout=60)
        assert dr.returncode == 0, \
            (f"offline doctor missed the stalled rank:\n"
             f"{dr.stdout}{dr.stderr}\njob tail: {out[-1500:]}")
    elif policy == "continue":
        r = tpurun(["-np", str(np_), "--mca", "errmgr", "continue", *mca,
                    "--", sys.executable, "-c", LOCAL_APP], env)
        out = r.stdout + r.stderr
        assert r.returncode == 0, f"continue rc={r.returncode}: {out[-2000:]}"
        for rank in range(np_):
            if rank == plan["victim"]:
                continue
            acc = sum(rank * 10 + s for s in range(steps))
            assert f"rank {rank} local done acc={acc:.0f}" in out, \
                (rank, out[-2000:])
    elif policy == "abort":
        r = tpurun(["-np", str(np_), *mca,
                    "--", sys.executable, "-c", LOCAL_APP], env)
        out = r.stdout + r.stderr
        assert r.returncode != 0, \
            f"abort policy exited 0 despite a kill: {out[-2000:]}"
        assert "aborted" in out.lower(), out[-2000:]
    if verbose:
        print(f"  plan {plan['idx']:>2} [{plan['policy']}] "
              f"{plan['plan']!r}: ok")


def read_fault_logs(log_dir: str) -> dict[int, dict]:
    """Per-rank fault logs, events merged across incarnations (a
    respawned rank dumps faults_rank<r>_life<n>.json per life)."""
    logs: dict[int, dict] = {}
    for name in sorted(os.listdir(log_dir)):
        if name.startswith("faults_rank") and name.endswith(".json"):
            with open(os.path.join(log_dir, name)) as fh:
                data = json.load(fh)
            prev = logs.get(data["rank"])
            if prev is None:
                logs[data["rank"]] = data
            else:
                prev["events"] = prev["events"] + data["events"]
    return logs


def check_replay(plan: dict, first: dict[int, dict],
                 second: dict[int, dict]) -> None:
    """Replay determinism, asserted on the parts a threaded run can
    guarantee:

    - the injected KILL schedule (rank, trigger, step) must reproduce
      exactly — this is the plan's event sequence;
    - frame-fault verdicts are a pure hash of (seed, rank, peer, frame
      identity), so any identity that fired in BOTH runs must have fired
      with the SAME kind (an impure/timing-dependent verdict function
      would diverge here);
    - every logged verdict must recompute through the injector's hash at
      the acting rank's stream position.

    Full set-equality of frame events is deliberately NOT asserted:
    WHICH identities get attempted depends on retransmission timing (a
    decision frame racing a resend timer), even though each identity's
    verdict does not.
    """
    kills_a = sorted((r, e["kind"], e["trigger"], e["value"])
                     for r, d in first.items() for e in d["events"]
                     if e["kind"] in ("kill", "hang", "crash",
                                      "stall", "mismatch"))
    kills_b = sorted((r, e["kind"], e["trigger"], e["value"])
                     for r, d in second.items() for e in d["events"]
                     if e["kind"] in ("kill", "hang", "crash",
                                      "stall", "mismatch"))
    assert kills_a == kills_b, \
        f"plan {plan['idx']}: kill schedule diverged: {kills_a} vs {kills_b}"

    def frame_faults(logs):
        return {(r, e["peer"], e["frame"]): e["kind"]
                for r, d in logs.items() for e in d["events"]
                if e["kind"] in ("drop", "dup", "delay")}

    fa, fb = frame_faults(first), frame_faults(second)
    for key in fa.keys() & fb.keys():
        assert fa[key] == fb[key], \
            (f"plan {plan['idx']}: frame {key} fired as {fa[key]!r} in "
             f"one run and {fb[key]!r} in the replay — verdicts are not "
             f"a pure function of the frame identity")
    for logs in (first, second):
        for r, d in logs.items():
            for e in d["events"]:
                if e["kind"] not in ("drop", "dup", "delay"):
                    continue
                u = faultinject._u01(plan["seed"], r, e["peer"],
                                     e["frame"], e["kind"])
                p = e.get("p", plan["drop"])
                assert u < p, \
                    (f"plan {plan['idx']}: logged {e['kind']} on "
                     f"{e['frame']!r} does not recompute "
                     f"(u={u:.3f} >= p={p})")


# ---------------------------------------------------------------------------
# --canary: chaos tenants vs. a fault-free co-tenant on ONE standing pool
# ---------------------------------------------------------------------------

# the selfheal-compatible rotation: every class here heals IN PLACE
# under --mca errmgr selfheal, so the job still exits 0 and the pool
# keeps serving — exactly the faults a standing multi-tenant VM must
# absorb without its other tenants noticing
CANARY_CLASSES = ("kill", "hang", "coll")


def _canary_plan(seed: int, cycle: int, np_: int, steps: int) -> dict:
    cls = CANARY_CLASSES[cycle % len(CANARY_CLASSES)]
    rng = random.Random(f"canary:{seed}:{cycle}")
    victim = rng.randrange(0, np_)
    if cls == "coll":
        # victim's dispatch ordinals: init barrier = 0, step s = s + 1;
        # N in [2, steps-1] leaves a snapshot behind and a full-world
        # step after the rejoin (same window the selfheal-coll soak uses)
        coll_n = rng.randrange(2, steps)
        plan = f"rank={victim}:kill@coll={coll_n}"
    else:
        step = rng.randrange(1, steps - 1)
        plan = f"rank={victim}:{cls}@step={step}"
    return {"cycle": cycle, "cls": cls, "victim": victim, "plan": plan}


def _dvm_submit(uri: str, np_: int, mca: list, app: str,
                env: dict, timeout: int = 240):
    return tpurun(["--dvm-submit", "--dvm-uri", uri, "-np", str(np_),
                   *mca, "--", sys.executable, "-c", app],
                  env, timeout=timeout)


def _check_canary_chaos(plan: dict, r, np_: int, steps: int) -> None:
    out = r.stdout + r.stderr
    assert r.returncode == 0, \
        (f"canary chaos [{plan['cls']}] rc={r.returncode}: {out[-3000:]}")
    v = plan["victim"]
    # the errmgr's "selfheal revive" log line lands in the DVM SERVER
    # process, not this client's IOF — the revive is asserted instead
    # on the pool's /status FT timeline after the cycles (run_canary)
    assert f"rank {v} resumed at step" in out, out[-3000:]
    if plan["cls"] == "coll":
        total = sum(range(np_)) * 100
        acc = sum(total + np_ * s for s in range(steps))
        for rank in range(np_):
            want = (f"rank {rank} collrejoin done acc={acc:.0f} "
                    f"mode=arena fallback=0 "
                    f"rejoins={0 if rank == v else 1}")
            assert want in out, (want, out[-3000:])
    else:
        for rank in range(np_):
            acc = sum(((rank - 1) % np_) * 100 + s for s in range(steps))
            assert f"rank {rank} selfheal done acc={acc:.0f}" in out, \
                (rank, acc, out[-3000:])


def _check_canary_ring(r, np_: int, steps: int) -> None:
    """The zero-interference contract: the fault-free co-tenant's accs
    are recomputed here and must match EXACTLY — a chaos tenant being
    healed on the same daemons must not perturb a single message."""
    out = r.stdout + r.stderr
    assert r.returncode == 0, \
        f"canary co-tenant rc={r.returncode}: {out[-3000:]}"
    for rank in range(np_):
        acc = sum(((rank - 1) % np_) * 100 + s for s in range(steps))
        assert f"rank {rank} ring done acc={acc:.0f}" in out, \
            (rank, acc, out[-3000:])


def run_canary(args) -> int:
    np_, steps = args.np_, args.steps
    pool_dir = tempfile.mkdtemp(prefix="chaos_canary_")
    uri = os.path.join(pool_dir, "dvm.uri")
    env = dict(os.environ)
    env.pop("OMPI_TPU_RANK", None)
    # --slots is the TOTAL pool: 2*np over 2 hosts lets the chaos
    # tenant and the canary ring gang-place side by side
    server = subprocess.Popen(
        [sys.executable, "-m", "ompi_tpu_torch.tools.tpurun", "--dvm-start",
         "--hosts", "2", "--slots", str(2 * np_),
         "--metrics-port", "0",
         "--mca", "errmgr", "selfheal",
         "--mca", "dvm_remediate", "0",
         "--dvm-uri", uri],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=env, cwd=REPO)
    deadline = time.monotonic() + 60
    while not os.path.exists(uri):
        if server.poll() is not None:
            print(f"canary DVM died: {server.stderr.read()[-2000:]}",
                  file=sys.stderr)
            return 1
        if time.monotonic() > deadline:
            server.kill()
            print("canary DVM uri never appeared", file=sys.stderr)
            return 1
        time.sleep(0.1)

    failures = []
    try:
        for cycle in range(args.plans):
            plan = _canary_plan(args.seed, cycle, np_, steps)
            ck_chaos = tempfile.mkdtemp(prefix=f"canary_ck_{cycle}c_")
            ck_ring = tempfile.mkdtemp(prefix=f"canary_ck_{cycle}r_")
            mca = ["--mca", "faultinject_plan", plan["plan"],
                   "--mca", "faultinject_seed", str(args.seed)]
            if plan["cls"] == "hang":
                # same gossip window the selfheal-hang soak class uses
                mca += ["--mca", "ft_gossip_period", "0.5",
                        "--mca", "ft_gossip_timeout", "4.0"]
            app = SELFHEAL_COLL_APP if plan["cls"] == "coll" \
                else SELFHEAL_APP
            res = {}

            def co_tenant():
                res["ring"] = _dvm_submit(
                    uri, np_, [], RING_APP,
                    {"CKPT_DIR": ck_ring, "SOAK_STEPS": str(steps)})

            t = threading.Thread(target=co_tenant, daemon=True)
            t.start()
            try:
                chaos = _dvm_submit(
                    uri, np_, mca, app,
                    {"CKPT_DIR": ck_chaos, "SOAK_STEPS": str(steps)})
                t.join(timeout=260)
                assert not t.is_alive(), "co-tenant submission hung"
                _check_canary_chaos(plan, chaos, np_, steps)
                _check_canary_ring(res["ring"], np_, steps)
                if args.verbose:
                    print(f"  canary cycle {cycle} [{plan['cls']}] "
                          f"{plan['plan']!r}: chaos healed, "
                          f"co-tenant clean")
            except (AssertionError, subprocess.TimeoutExpired) as e:
                failures.append((plan, e))
                print(f"FAIL canary cycle {cycle} [{plan['cls']}] "
                      f"{plan['plan']!r}: {type(e).__name__}: {e}",
                      file=sys.stderr)
        # the pool itself must have survived every cycle: all 2*N
        # tenants in history, every one rc 0, nothing stuck in queue —
        # and the /status FT timeline must carry one revive per cycle
        # (the errmgr healed IN the server; client IOF never sees it)
        ps = tpurun(["--dvm-ps", "--dvm-uri", uri], timeout=60)
        try:
            table = json.loads(ps.stdout)
            done = [h for h in table.get("history", [])
                    if h.get("rc") == 0]
            expect = 2 * args.plans
            assert len(done) >= min(expect, 20), \
                (f"pool history shows {len(done)} clean jobs, "
                 f"expected {expect}: {ps.stdout[-2000:]}")
            assert table.get("queue_depth", 0) == 0, ps.stdout[-2000:]
            import urllib.request
            with open(uri + ".metrics") as f:
                http = f.read().strip()
            with urllib.request.urlopen(http + "/status",
                                        timeout=10) as resp:
                status = json.loads(resp.read().decode())
            revives = {(e["jobid"], e["rank"])
                       for j in status.get("jobs", [])
                       for e in j.get("ft_events", [])
                       if e["kind"] == "revive"}
            assert len(revives) >= args.plans, \
                (f"{len(revives)} revive events on the FT timeline for "
                 f"{args.plans} chaos cycles: {sorted(revives)}")
        except (ValueError, AssertionError, OSError) as e:
            failures.append(({"cls": "pool-state"}, e))
            print(f"FAIL canary pool-state: {e}", file=sys.stderr)
    finally:
        tpurun(["--dvm-stop", "--dvm-uri", uri], timeout=30)
        try:
            server.wait(timeout=15)
        except subprocess.TimeoutExpired:
            server.kill()

    if failures:
        print(f"chaos_soak --canary: {len(failures)}/{args.plans} "
              f"cycles FAILED", file=sys.stderr)
        return 1
    print(f"chaos_soak --canary: {args.plans}/{args.plans} cycles ok "
          f"(seed {args.seed}, np {np_}, {steps} steps, "
          f"one standing pool)")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--plans", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--np", type=int, default=4, dest="np_")
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--replay-every", type=int, default=4,
                    help="replay every Nth plan to assert determinism "
                         "(0 = no replays; default 4 is co-prime with "
                         "the 9-policy rotation so every policy — "
                         "including the drop-carrying notify-shrink "
                         "plans — gets replayed over a long soak)")
    ap.add_argument("--only", default=None, choices=POLICIES,
                    help="run only plans of one class (the CI smoke "
                         "jobs pick single scenarios this way)")
    ap.add_argument("--canary", action="store_true",
                    help="multi-tenant pool mode: one standing selfheal "
                         "DVM serves every cycle; each cycle runs a "
                         "seeded chaos tenant (kill/hang/kill@coll "
                         "rotation) NEXT TO a fault-free canary ring — "
                         "both must exit 0 with exact recomputed accs "
                         "(--plans = cycles)")
    ap.add_argument("-v", "--verbose", action="store_true")
    ap.add_argument("--guard", action="store_true",
                    help="preflight: refuse to soak when hours-old "
                    "PPID-1 orphaned ompi_tpu_torch processes poison the box "
                    "(their CPU steal turns timing-sensitive chaos "
                    "windows into flakes)")
    ap.add_argument("--guard-kill", action="store_true",
                    help="like --guard but SIGKILL the orphans and "
                    "proceed")
    args = ap.parse_args(argv)

    if args.guard or args.guard_kill:
        from ompi_tpu_torch.tools import killorphans

        if not killorphans.preflight("chaos_soak",
                                     kill=args.guard_kill):
            return 2

    if args.canary:
        return run_canary(args)

    failures = []
    plans, i = [], 0
    while len(plans) < args.plans:
        plan = gen_plan(args.seed, i, args.np_, args.steps)
        i += 1
        if args.only and plan["policy"] != args.only:
            continue
        plans.append(plan)
    for i, plan in enumerate(plans):
        log_a = tempfile.mkdtemp(prefix=f"chaos_log_{i}a_")
        try:
            run_plan(plan, args.np_, args.steps, log_a, args.verbose)
            if args.replay_every and i % args.replay_every == 0:
                log_b = tempfile.mkdtemp(prefix=f"chaos_log_{i}b_")
                run_plan(plan, args.np_, args.steps, log_b, False)
                check_replay(plan, read_fault_logs(log_a),
                             read_fault_logs(log_b))
                if args.verbose:
                    print(f"  plan {i:>2} replay: deterministic")
        except (AssertionError, subprocess.TimeoutExpired) as e:
            failures.append((plan, e))
            print(f"FAIL plan {i} [{plan['policy']}] {plan['plan']!r}: "
                  f"{type(e).__name__}: {e}", file=sys.stderr)
    total = args.plans
    if failures:
        print(f"chaos_soak: {len(failures)}/{total} plans FAILED",
              file=sys.stderr)
        return 1
    print(f"chaos_soak: {total}/{total} plans ok "
          f"(seed {args.seed}, np {args.np_}, {args.steps} steps)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
