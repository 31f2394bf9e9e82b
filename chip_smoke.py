#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``ompi_tpu_torch``) on one NVIDIA H100.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure exits non-zero:

1. device — the card's name, count, and its name and power limit as
   nvidia-smi gives them (also printed alone on a line);
2. build — nvcc builds every kernel from ``ompi_tpu_torch/ops/csrc`` for
   sm_90a, one nvcc per source, all started together; prints the
   ``-Xptxas -v`` register and shared-memory lines and fails on a spill
   or a wgmma-serialisation warning (ptxas's C751x); then phase native:
   g++ builds the four host executors from ``ompi_tpu_torch/_native``
   (the convertor, the arena, the tcp plane and the fastdss extension),
   one build each, all started together, into build/ompi_tpu_torch/native,
   and each must load (no fall back to the Python branches); /dev/shm's
   capacity and the shm backing directory are printed;
3. hwtopo — ``core.hwtopo.discover(probe_accelerators=True)`` counts the
   CUDA cards (and counts none unless asked);
4. pipeline — ``parallel.gpipe`` at pp = 1 on the card at the flagship's
   width (a gelu(h @ w + b) stage, w 2048 × 2048, h 16·512 × 2048,
   bf16, 4 microbatches): output and the w, b and h gradients equal to
   the direct call's bit for bit, both timed;
5. host_plane (after native) — the host process mode through the port's
   launcher (``python -m ompi_tpu_torch.tools.tpurun``), a subprocess a
   job: ring and hello at -np 4 print the reference programs' lines;
   ping-pong (``tools/host_bench.py``) at 8 B, 4 KiB, 1 MiB and 64 MiB
   between ranks 0 and 1 of a -np 4 job (eager limit 4 KiB: 1 MiB and up
   go rendezvous), over the shm rings (the default selection; the rank
   reports the route), over tcp (``--mca btl self,tcp``) and over the
   shm rings with ``OMPI_TPU_NO_NATIVE=1``, and over proc between two
   ranks on threads of this process, medians over blocks of the half
   round trip and GB/s, the data bitwise back; in the shm job allreduce,
   bcast, allgather, alltoall, reduce_scatter_block and scan on 64 MiB a
   rank of float32 small integers and of int32, bitwise against numpy,
   and each forced ``coll_host_allreduce_algorithm``, every call served
   by coll/shm, allreduce and bcast through the arena (its payload cap
   raised to 64 MiB), then the same calls in a job with
   ``--mca coll_shm_enable 0`` (coll/host); ``tpurun -np 1 --gpu`` runs
   ``examples/device_allreduce.py``: card 0 bound, a process group of
   one, ``comm.allreduce`` of 64 MiB on the card bitwise equal to the
   direct ``DeviceCommunicator.allreduce`` with no device-to-host copy
   in a torch.profiler window around the call (whose control copy must
   show), the numpy allreduce right; ``tpurun -np 2 --gpu`` puts both
   ranks on card 0, where the device route raises the shared-card
   error and the host route runs over the shm rings and the arena;
   ``init()`` at -np 4 and a hello job's launch-to-exit time;
5a. host_tools (after host_nbc) — the port's host-plane microbenches,
   each CLI in a fresh process with ``--out`` under build/: pack_bench
   at runs 1,1000,100000, coll_bench --quick --ranks 4, net_bench
   --quick (two simulated hosts of the port's tpurun) and fleet_bench
   --quick --assert; one line a tool with its rows' key numbers and
   seconds, and a non-zero exit fails the run;
5b. trace (after host_tools) — the trace plane: (a) in a fresh process,
   ``init()`` and the world bound to a one-rank DeviceCommunicator on
   the card (NCCL); 64 ``comm.allreduce`` calls each at 4 KiB f32,
   64 MiB f32 and 64 MiB bf16, every one leaving a post and a done on
   the flight recorder (provider ``xla``, its bytes, the signature the
   JAX package gives the same dtype: f32 as numpy's 11/4, bf16 as
   256/2) and a ``coll_dispatch_ns`` sample, the results equal to the
   inputs, no device-to-host copy beside the control in a profiler
   window, and the host µs of a 4 KiB call beside the direct call with
   the timeline disarmed, armed, armed, disarmed; (b) ``tpurun -np 4
   --trace`` of ``examples/trace_demo``, its four dumps merged by
   ``tools/trace_export``: pml, btl, coll and datatype spans, flow
   arrows, no causality problem, the monitoring matrix's bytes; (c) a
   collective mismatch (coll/shm off) and a straggler, each a 4-rank
   job ended by ``tpurun --timeout``, named by ``tools/hang_doctor
   --expect mismatch:1`` / ``straggler:1`` from the dumps; (d) on the
   host, ns a recorder post+done, a span while armed, the disarmed gate;
6. kernel — the flash-attention forward kernel against its plain
   PyTorch version (O and lse) over causal/full, offsets, f32/bf16, head
   dims and lengths, bf16 without a mask at t = 1024, and at the decode
   prefill shape (B=16, T=512, H=16, D=128, bf16, causal), where it is
   timed beside the plain version, the byte/FLOP bound and
   ``scaled_dot_product_attention`` (a yardstick the port never calls),
   in bf16 and in f32; and timed at the training shape (B·H=256, T=1024,
   D=128, bf16, causal) beside its bound and SDPA;
7. kernel_bwd — the dq and dk/dv backward kernels against their plain
   versions over causal/full, offsets, f32/bf16, head dims, lengths and
   with or without an lse cotangent; the autograd backward with the
   kernels against the recompute backward; and, at the training shape
   (B·H=256, T=1024, D=128, bf16, causal), each kernel's time beside its
   plain version, its bound, the recompute backward and SDPA's backward,
   and ptxas's register and spill lines (and any wgmma-serialisation
   warning) of each D of the Hopper dq and dk/dv kernels;
8. ring (after kernel_bwd) — ring attention's hop and merge at full
   width in one process: a causal bf16 sequence of 4 × 1024 tokens
   (batch 4, 16 heads of 128) as 4 sequence-parallel ranks hold it; for
   each virtual rank, ``parallel.attention._ring_step`` over its 4 hops
   with the other ranks' K/V blocks in turn (16 forward launches at
   global offsets, 6 of them fully masked hops), then the backward
   through every merge (16 dq and 16 dk/dv launches, each with an lse
   cotangent); the output against one full-sequence flash forward (bf16
   tolerance of max|ref|), the q, k and v gradients against its kernel
   backward (relative L2), no NaN or Inf, the masked hops' O = 0 and
   lse ≈ -1e30, and the ring's forward + backward device time beside the
   full-sequence kernels', with a profiled ring by kernel kind;
9. decode — the flagship 468M dense model (bench.py's decode widths) with
   ``attention="flash"``: a greedy KV-cache decode of 16 prompts of 512
   tokens, the launch counts of that one call, the same prompt through the
   plain attention path, the prefill time (max_new=1), the per-token time
   by the two-max_new slope, tokens/s and peak memory; then torch.profiler
   windows over the prefill and a 16-token decode: device busy and idle
   share, and the kernels that take the time;
10. cache — on the small f32 config of the decode tests, the cached greedy
   decode through the kernel equals a token-by-token full-forward greedy
   exactly;
11. train — the flagship model training at bench.py's MFU widths (batch
   16 × seq 1024, bf16, remat "dots", ce_chunk 256), through the
   multi-rank training code at world size 1 (every collective elided;
   the token shard is the whole batch), with the flash
   kernels forward and backward: the first step's loss and gradients
   against the plain attention path and the recompute backward, then a
   warm-up step and an 8-step ``make_train_loop`` whose launch counts are
   read around it; step time, tokens/s, MFU, peak memory and a profiled
   step;
12. train_small — on the small f32 config of the model tests, the first
   step's loss and gradients on the card equal the port's CPU run, and
   three steps lower the loss on both;
12a. ckpt (after train_small) — checkpoint/restart of the flagship's
   training state at phase train's config and batch, its widths at 1 of
   its 8 layers (``CUT_LAYERS``, 116M parameters), one rank: 2 steps,
   a snapshot of the params, f32 moments and step count (~1.4 GB, free
   disk checked first) under ``build/ckpt_smoke``, 2 steps as the
   uninterrupted reference, then a restore into fresh tensors on the
   card and the same 2 steps, twice; the losses and every param and
   moment leaf bit for bit (or, should the two continuations differ, the
   nondeterministic op named and the resume held at their spread);
   through ``ckpt.SnapshotStore``, ``ckpt.DcpStore`` and
   ``ckpt.ShardedSnapshotStore`` (one ``.bin`` a leaf and a
   ``sharded-file`` metadata.json, written by collective MPI-IO over a
   one-rank world of ``init()``; the fcoll component that ran), each
   with its bytes, write and read s and GB/s; then the small bf16 config
   (bf16 params and moments, grad_accum 2) through SnapshotStore, which
   puts the bf16 manifest to work without ml_dtypes; the snapshots are
   removed;
13. moe_layer — the MoE family (every FFN a switch of 8 experts,
   capacity factor 1.25, at the flagship's widths and 1 of its 8 layers;
   its parameters drawn once by ``init_params``, 351M, and shared by the
   MoE phases): one
   full-width bf16 layer input (16 × 1024 tokens of 2048), the index
   dispatch and combine against the one-hot einsum plain version,
   output, aux and every gradient bit for bit, the same routing, and
   each part timed (route, dispatch, combine, expert FFN, the layer
   forward and backward in both forms) beside its byte bound;
14. moe_decode — phase decode's metrics and checks for the MoE model
   (1 forward launch a call), with the prefill's routing: the share
   of tokens dropped and the tokens routed to each expert, per layer;
15. moe_train — phase train for the MoE model at world size 1 (the ep
   exchange elided): the first step's loss and every gradient leaf
   against the plain attention path, an 8-step loop's launch counts
   (2 / 1 / 1 a step at its 1 layer), step time, tokens/s, MFU by the
   ACTIVE parameters (116M), peak memory, the loss falling, and a profiled
   step split into the flash kernels, the expert GEMMs, the index ops
   and the rest;
16. moe_small — phase train_small on the MoE tests' small f32 config
   (8 experts);
17. rma_kernel (after kernel_bwd) — the one-sided copy kernels (put, get
   and a root's push to 3 peers) at kernel level in this process, on
   local buffers with their flag words, bitwise against ``copy_plain``
   over float32, bfloat16 and int32 at 4 KiB, 1 MiB, 64 MiB and 256 MiB,
   a ragged (7, 129) float32 shard, byte offsets that 16 does not divide,
   16-byte-aligned offsets that 128 does not divide at sizes that fill no
   ring stage evenly (64 MiB + 48, 33 KiB + 16, 4096 + 7) and an empty
   copy; each kernel timed at 64 MiB (the main path's window) and
   256 MiB beside its byte bound, its plain version and ``Tensor.copy_``,
   and at 4 KiB (200 calls), where the call rate is the host's and the
   profiler gives the device time of one launch; put and get at 64 MiB also without the
   handshake;
18. rma_ranks (after rma_kernel) — 4 rank processes on the one card
   (tcp init on a free port, each mapping its peers' 64 MiB windows):
   ``DeviceCommunicator.put``/``get`` for all 12 (src, dst) pairs and a
   self-put, ``fetch_bcast`` from every root, ``DeviceWindow`` and the
   heap's put/quiet/get, every rank's window gathered over the host group
   and compared bitwise with the numpy expectation; the launch counts
   summed over ranks and the wall latency of a 4 KiB and a 64 MiB put;
   an ordering stress of 200 back-to-back 1 MiB puts 0 → 1 and 200 gets
   1 ← 2, each of a new value, compared on the card after every call
   (0 mismatches); a device collective over the ranks (which share the
   card) must raise;
18a. ft (after rma_ranks, before the flagship's parameters are drawn, so
   this process holds no card memory beside its context) — fault
   tolerance: (a) the dense model at its widths and 1 of its 8 layers
   (``CUT_LAYERS``, 116M parameters) at phase train's config trained
   6 steps by one rank on ``cuda:0`` through the port's launcher
   (``--gpu``, ``errmgr respawn``; the rank binds its card and joins no
   process group), an async ``CheckpointManager`` snapshot every 2 steps
   (~1.4 GB: f32 params and moments, pinned host copies), once
   uninterrupted and once with ``rank=0:kill@step=5``: the revived life
   (``OMPI_TPU_RESTART=1``) finds at least 70 GB of the card free,
   restores the latest committed snapshot onto the card
   (``auto_restore``), resumes from it and ends with every param and
   moment leaf bit for bit the uninterrupted job's (by a digest of the
   bits each job prints; should they differ, a second uninterrupted job
   and the nondeterministic op decide, as in phase ckpt); the flash
   kernels run in both lives; the seconds from the kill to the revived
   life's first step split into reap, respawn, interpreter with torch
   and CUDA init and restore (the launcher's FT events and the ranks'
   stamps), the snapshot's GB, the host copy's ms, GB/s written, and the
   step's ms with and without a save in flight; (b) ``tpurun -np 4
   --mca errmgr notify`` of ``examples/shrink_allreduce`` with
   ``rank=2:kill@step=3``: every survivor's final acc equals the
   recomputed expectation; the seconds from the kill to the first
   ERR_PROC_FAILED, revoke to shrink in ms, and ``agree``'s µs a call at
   n = 4 over 1000 calls; (c) 4 host ranks under ``errmgr selfheal``
   with ``rank=2:kill@coll=5`` over a 1 MiB allreduce loop through the
   coll/shm arena: the rank revived, every result equal to numpy's, each
   survivor's ``coll_rejoin_total`` at least 1, exit 0, and the seconds
   from the kill to the revived life's first collective; (d) ``tpurun
   -np 2 --gpu --mca errmgr notify`` with ``rank=1:kill@step=1`` (both
   ranks on card 0, one gloo group): rank 0 revokes, shrinks and
   finishes on the host route and its finalize ends inside the 10 s
   watchdog; (b)–(d) run side by side after (a);
18b. io (after ft) — MPI-IO through the port's launcher: (a)
   ``examples/mpiio_darray`` at -np 4 prints its marker; (b) 4 host
   ranks write a 4096 × 4096 f32 matrix (64 MiB, one file) through a
   block × block darray view with one ``write_at_all`` and read it with
   one ``read_at_all`` under each fcoll component and the auto decision,
   then a 4096² block × cyclic(256) darray under two_phase and
   individual: rank 0 holds every file bitwise to the matrix made with
   numpy and every rank its read-back; 64 ``write_shared`` records of
   1 MiB a rank under sm and lockedfile (each record once and whole) and
   a 16 MiB ``write_ordered`` a rank (rank order); GB/s, records/s, the
   fs type and the auto decision's component; (c) 4 ``--gpu`` ranks on
   card 0 hold ragged row cuts of every leaf of the flagship's
   parameters at 4 of its 8 layers (``IO_CUT_LAYERS``) and a bf16 copy
   on the card, save them collectively
   through ``ShardedSnapshotStore`` (rank 0's save in a profiler window:
   one device-to-host copy a leaf beside one control copy) and load
   their own block and a neighbour's, every leaf ``torch.equal`` on the
   card to the expected cut, bf16 as ``torch.bfloat16``, the metadata's
   ragged shapes; save and load GB/s;
18c. osc (after io) — host RMA windows and OpenSHMEM through the port's
   launcher: (a) the seven one-sided examples (``ring_oshmem``,
   ``oshmem_shmalloc``, ``oshmem_circular_shift``,
   ``oshmem_symmetric_data`` and ``rma_pscw`` at -np 3,
   ``oshmem_max_reduction`` at -np 4, ``oshmem_strided_puts`` at -np 2)
   print their markers; (c) 4 ``--gpu`` ranks on card 0 put a 64 MiB f32
   and a 64 MiB bf16 CUDA tensor into the right neighbour's f32 host
   window and into a ``SymmetricArray`` and fence: the neighbour's part
   equals ``t.float().cpu().numpy()`` bit for bit, rank 0's four puts in
   one profiler window make five device-to-host copies (one a put, one
   control), and a CUDA tensor as a host window's buffer raises; (a) and (c)
   side by side; then (b) 4 host ranks over the shm rings: put and get
   between ranks 0 and 1 under a fence and under lock/unlock (median µs
   at 8 B, GB/s at 16 MiB f32), a 16 MiB SUM accumulate from ranks 1–3
   into rank 0 bitwise to numpy, fetch_op and compare_swap µs a call,
   4 × 2500 get_accumulate tickets all distinct, a PSCW epoch and a
   dynamic window at 16 MiB, a 16 MiB-a-rank ``SharedWindow`` (stores
   into the neighbour's slice, then 4 × 100000 ``fetch_add`` on one slot
   totalling 400000), and SHMEM: a 16 MiB ``SymmetricArray`` put/get,
   ``to_all`` MAX at 16 MiB bitwise, 1000 ``Lock`` rounds around a
   shared counter (16 MiB: 64 MiB made the phase 62.5 s of its 60);
   no kernel of the port runs here;
18d. dpm (after osc) — dynamic process management and the mpi4py
   facade through the port's launcher: (b) 2 ``--gpu`` ranks on card 0
   through the facade: rank 0 ``Send``s a 64 MiB f32 CUDA tensor that
   rank 1 ``Recv``s into numpy, ``Allreduce`` from a CUDA send buffer
   into numpy, a ``Win.Allocate`` window ``Put`` from a CUDA tensor,
   ``File.Write_at_all`` of a CUDA tensor read back, a bf16 CUDA
   ``Send``: every result bitwise, each call once timed and once in a
   profiler window of its own with one device-to-host copy beside the
   control copy, and ``Recv`` into a CUDA tensor refused with
   ERR_BUFFER; side by side with it (a) ``mpi4py_ring`` and
   ``mpi4py_cart_halo`` at -np 3 print their markers, a 2-rank job
   ``Spawn``s 2 children (a pickled object and a buffer each way, 8 B
   half round trips, the merge into 4 ranks and a 16 MiB f32
   ``Allreduce`` on it bitwise to numpy, ``Disconnect``), a
   ``spawn_multiple`` of 2 + 1 ranks runs each block's argv and env, and
   two 2-rank jobs meet through ``publish_name``/``lookup_name`` and run
   the intercomm barrier, bcast, allreduce and merge; then (c) the
   facade bench (4 ranks on threads, 256 KiB, 30 iterations) in this
   process prints its three ratio lines; no kernel of the port runs
   here;
18e. plm (after dpm) — multi-host launch through the daemon tree
   (``tpurun --plm sim``: one orted a simulated host, ranks on different
   hosts over tcp): (b1) ``--plm sim --hosts 2 -np 2 --gpu``, one rank a
   host, both on card 0: each rank's card, ``OMPI_TPU_NHOSTS=2``, two
   hosts, one process group of 2 joined at the plm's rendezvous, the
   forward kernel at the prefill shape (16 × 512, 16 heads of 128,
   bf16, causal) against its plain version, then a 64 MiB f32 CUDA
   tensor through ``comm.allreduce`` (the device route refuses the
   shared card) and the facade's ``Allreduce`` into numpy over tcp,
   bitwise, one device-to-host copy beside the control copy; (b2) the
   same under ``--mca errmgr respawn``: no group, each life's kernel
   check, rank 1's first life SIGKILLs itself and its orted revives it
   (``TAG_RESPAWN``) on the same host and card with no rendezvous; (c)
   rank 1 SIGKILLs its own orted: the job fails and names the daemon;
   no rank of (b1), (b2) or (c) outlives its job or stays on the card;
   side by side with them (a) ring at -np 4 on 2 hosts prints the
   reference's lines, a 4-rank job ping-pongs 0↔1 (shm) and 0↔2 (tcp)
   at 8 B and 64 MiB and allreduces 64 MiB bitwise to numpy, ``--mca
   rtc_bind core`` pins each rank to one cpu, and a ``--map-by bynode``
   job driven from an in-process HNP reports every daemon's measured
   clock offset (within rtt/2 of 0); then hello alone (launch to exit),
   a mid-tree orted SIGKILLed under notify on 4 hosts (ranks 1–3
   finish, kill → reparent s), ``tpurun --clean`` of the inbox its dead
   rank left, and ``--plm ssh`` where passwordless ``ssh localhost``
   works; no kernel of the main process runs here;
18f. dvm (after plm) — the standing DVM (``tpurun --dvm-start``), two
   pools side by side, each with its own ``--dvm-uri`` under
   build/dvm_smoke/ (removed at the end), both with the metrics uplink
   (0.5 s) and the stuck watchdog (2 s): (a) a host pool of 2 simulated
   hosts × 2 slots with ``--metrics-port 0``: a cold ``tpurun --plm
   sim`` hello at -np 4 and two warm ``--dvm-submit`` ones on the same
   daemon pids, spanning both hosts; two 2-rank tenants at once, each
   client with its own lines only, one exiting 3 to its client; a
   submission that can never fit gets exit 75 and a ``rejected``
   verdict; ``--dvm-ps`` shows the daemons, the live job and the
   history; during a 4-rank ping-pong tenant ``/metrics`` carries its
   ``{job=,rank=}`` series and the ``ompi_tpu_job_*`` sums with one
   ``# TYPE`` line a name, ``/status`` its proc rows and FT timeline,
   ``/doctor`` a verdict, and ``hang_doctor``, ``timeline`` and
   ``straggler_report --uri`` read the pool; a tenant under
   ``rank=1:stall@coll=3`` is SIGCONT-probed and exits 0 (``sigcont``
   and ``recovered`` on ``/status``, ``ompi_tpu_dvm_remediations_total
   1``); a tenant spawns 2 children through the pool (``--dvm-submit``)
   and the merged 4-rank allreduce is bitwise (coll/host); ``tools.sync``
   at -np 4 puts every offset within rtt/2 of 0; ``--dvm-stop`` ends the
   pool and removes its uri files, and ``--clean --clean-dry-run`` lists
   none of its artifacts; (b) a ``--gpu`` pool of 2 hosts × 2 slots,
   whose HNP and orteds ``nvidia-smi`` never lists: (b1) one 2-rank
   tenant alone, then two at once (each on one host, card 0, its own
   rendezvous and process group of 2), each rank's forward kernel at the
   prefill shape against the plain version, both tenants' ``job``
   labels on ``/metrics``; (b2) a 2-rank tenant whose rank 1 freezes in
   its 3rd host collective holding its CUDA context: the watchdog names
   it, the actor SIGCONTs it and it runs the kernel check again; then
   ``--dvm-stop`` with a ``--gpu`` tenant still running, after which no
   pid of the pool or its tenants is alive or on the card; the tenants'
   forward launches are on the phase's line, not the kernels line;
18g. tools (after dvm) — the flagship's profiling tools as a user runs
   them, each CLI a fresh process on the card (``tools/flagship.py``'s
   widths, bf16, batch 16 × 1024, flash forward and backward kernels,
   at ``--layers 1`` of the 8: ``TOOLS_LAYERS``, 116M):
   (a) ``xprof_capture --steps 3``: the device events' fractions
   (tensor-core, copy, collective, other) sum to 1 and the flash
   kernels ran 2 / 1 / 1 a step (counters exactly, trace events within
   the window's edge); (b) ``step_breakdown fwd grad full``: finite step
   ms and MFU, full ≥ grad ≥ fwd; (c) ``cost_analysis``: the
   dispatcher's FLOPs (flash kernels added from their shapes) at least
   the analytic 6N + 12·L·D·S a token, with its roofline bounds; beside
   (c), (d) the examples ``generate`` and ``train`` on the card and
   with ``--device cpu`` (tokens equal, losses within SMALL_TOL) and
   ``osc_device_window`` across 3 ``--gpu`` ranks on card 0; the tools'
   flash launches are on the phase's line, not the kernels line;
18h. sweep (after tools) — the flagship's MFU sweep: the forward, dq and
   dk/dv at the long rows' (B·H, T) = (128, 2048) and (64, 4096), bf16,
   causal, against their plain versions on 16 heads (the kernel phases'
   tolerances, and row by row: relative L2 ≤ ``SWEEP_ROW_RL2``, lse
   within ``SWEEP_LSE_ATOL``; the same kernels given one zeroed tile of
   keys must fail each limit), timed beside their bounds and SDPA; then
   ``python -m ompi_tpu_torch.tools.mfu_sweep`` on ``SWEEP_ROWS`` (each
   row a fresh child at full depth, but ``SWEEP_CUT_ROWS``: b32, b8 ×
   2048 and b4 × 4096 run by a second command at ``--layers 1``, which
   paid for phase bench): every row a record and no error,
   losses finite and below ln(vocab) + 0.5, the flash rows' launches
   exact (the ``-pbwd`` row's dq and dk/dv too), none for ``xla``,
   matmul_peak's share of the peak in (0, 105], the ``SWEEP_SAME`` rows'
   losses within ``SWEEP_LOSS_RTOL``; the rows' launches are on the
   phase's line;
18i. bench (after sweep) — the benchmark tool as a user runs it,
   ``python -m ompi_tpu_torch.tools.bench`` in a fresh process: exit 0
   and one stdout line; backend ``gpu`` and this card's name; the
   flagship's MFU at the reference's configuration (plain attention,
   batch 16 × 1024, a 32-step chain) in (0, 105] over the sweep's 468M
   parameters; the 12 matrix rows in the reference's order, none an
   error, the four that need two cards carrying the one-card note;
   ``remote_dma`` correct over its 64 MiB window with one put launch a
   call; ``flash_bwd_kernel``'s gradients finite with 2 / 2 / 2 flash
   launches; the tuner's row (every algorithm of allreduce, allgather
   and bcast at 4 KiB–64 MiB a shard) holds platform=cuda, the card's
   name, n_devices=1 and no rule, ships nothing
   (``ompi_tpu_torch/mpi/coll/`` unchanged), and coll/xla's decisions
   at 4 KiB and 64 MiB are the same with its file as without; the
   bench's flash and put launches are on the kernels line (path
   ``bench``);
19. collectives (third from last) — ``make_mesh`` on the card with NCCL at
   world size 1: every device collective on CUDA tensors equals the same
   call on the one-process CPU communicator;
20. mpi_coll (on the same NCCL group) — the MPI communicator's
   device route: a ``Communicator`` bound to the card's
   ``DeviceCommunicator``; each buffer collective through
   ``comm.<slot>`` bitwise equal to the direct call at 4 KiB, 64 MiB and
   256 MiB float32 and 64 MiB bfloat16; the same calls, and a repeated
   datatype pack, in profiler windows of a fresh spawned process (this
   one's profiler no longer records copies after the decode phase) that
   must show one deliberate control copy and no other copy between host
   and card; the provider tables; the allreduce
   decision (fixed, forced, rules file; a lossy rules file raises); the
   refusals (``send`` of a tensor, a CPU tensor); the CUDA support
   probe; the datatype device pack over 64 MiB against the CPU, timed
   beside ``index_select``; the flagship's dense gradient set (1.87 GB,
   10 leaves) summed leaf by leaf through ``comm.allreduce``, bitwise
   equal to the direct call, timed with its peak memory; the host cost
   of a 4 KiB ``comm.allreduce`` beside the direct call, and psum against
   rs_ag at 64 and 256 MiB;
21. the ``kernels`` line (6 entries; the flash kernels' launches by
   path: decode, train, ring, moe_decode, moe_train, ckpt, bench; the
   put kernel's: rma_ranks, bench), then the
   card's nvidia-smi line,
   then the result line ``{"ok": true, "device": {...}}``.

The script and every process it starts keep Python's compiled bytecode
under ``build/pycache`` of the checkout (``PYTHONPYCACHEPREFIX``), also
where the environment turns the cache off (``PYTHONDONTWRITEBYTECODE``):
without it each of the run's fresh processes compiles torch's Python
sources again, and a training process compiles ``torch._dynamo`` as
well, which ``torch.utils.checkpoint`` imports at its first call.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import json
import os
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
BF16_FLOPS = 989e12            # H100 SXM dense bf16 tensor-core peak
F32_FLOPS = 67e12              # H100 SXM float32 outside the tensor cores
F32_TOL = 2e-5                 # tests/parallel/test_flash.py f32 tolerance
BF16_TOL = 3e-2                # tests/parallel/test_flash.py bf16 tolerance
LOGIT_TOL = 0.1                # flash vs plain prefill logits, bf16 model
BWD_F32_TOL = 2e-3             # tests/parallel/test_flash.py:147-149
BWD_BF16_TOL = 3e-2            # of max|ref|: a ds or p on a bf16 boundary
TRAIN_LOSS_RTOL = 5e-3         # kernel vs plain paths, flagship first step
TRAIN_GRAD_RL2 = 2e-2          # per-leaf relative L2, flagship first step
RING_ROW_RL2 = 2e-2            # ring output vs plain, relative L2 a row
SMALL_TOL = 1e-4               # small f32 model, card vs CPU
UNEMBED_LOSS_RTOL = 1e-4       # tensor-core unembed vs the f32 product
UNEMBED_GRAD_RL2 = 1e-2        # its h and emb gradients, relative L2
#: (q_offset, k_offset) of the kernel checks; the last three are not
#: multiples of the kernels' 64- and 128-row tiles, so the diagonal
#: crosses tiles off their edges
OFFSETS = ((0, 0), (128, 0), (0, 128), (64, 0), (0, 64), (100, 36))
#: the flagship dense model's widths (bench.py:478-484, 468M parameters)
FLAGSHIP = dict(vocab=32_000, d_model=2048, n_heads=16, n_layers=8,
                d_ff=8192)
#: the depth phases ft (a) and ckpt run the flagship at: its widths, 1
#: of its 8 layers (116M parameters, a 1.39 GB training state where the
#: 8 layers' is 5.62 GB; 2 layers paid for phase dvm's seconds, 1 for
#: phase tools'); the MoE phases' depth too (351M parameters, 116M active
#: a token, where the 8 layers' are 2.35B and 468M)
CUT_LAYERS = 1


#: io (c)'s depth: a ragged row cut of a 2-layer stack over 4 ranks
#: leaves rank 0 no row, and its save's one copy a leaf could not show
IO_CUT_LAYERS = 4


def flagship_cut(layers: int = CUT_LAYERS) -> dict:
    """The flagship's widths at ``layers`` layers."""
    return dict(FLAGSHIP, n_layers=min(layers, FLAGSHIP["n_layers"]))


def cut_layers(params_np: dict, n: int) -> dict:
    """The first ``n`` layers of a parameter set (the per-layer leaves
    stack their layers on axis 0; ``emb`` and ``lnf`` are whole)."""
    return {k: v if k in ("emb", "lnf") else v[:n]
            for k, v in params_np.items()}


#: its training batch (bench.py's MFU row): 16 sequences of 1024 tokens,
#: the loss in chunks of 256 positions
TRAIN = dict(batch=16, seq=1024, ce_chunk=256)
#: the MoE family at the flagship's widths: every FFN a switch of 8
#: experts (the reference's MoE tests' count), capacity factor 1.25 and
#: balance-loss weight 0.01 (the config's defaults, Switch Transformer's)
MOE = dict(moe_experts=8, moe_capacity_factor=1.25, moe_aux_weight=0.01)
#: sequence lengths of the backward kernels' checks
BWD_LENGTHS = (96, 256, 512, 1024)
#: the ring phase: a causal bf16 sequence of sp × block tokens, the
#: flagship's 16 heads of 128, as 4 sequence-parallel ranks would hold it
RING = dict(batch=4, sp=4, block=1024, heads=16, head_dim=128)
#: one-sided copies: the sizes checked, the size of the main path's window
#: (timed beside 4 KiB and 256 MiB), the ranks and their window
RMA_SIZES = (4 << 10, 1 << 20, 64 << 20, 256 << 20)
RMA_TIMED = 64 << 20
#: (source offset, landing offset, bytes) of the unaligned and boundary
#: copies: the first three take the byte path, the rest the bulk ring
RMA_OFFSET_CASES = ((3, 5, 1 << 20), (4, 8, 4096 + 7), (1, 0, 12345),
                    (16, 48, (64 << 20) + 48), (48, 16, (33 << 10) + 16),
                    (16, 0, 4096 + 7), (0, 0, 0))
RMA_RANKS = 4
RMA_WINDOW = (16384, 1024)     # float32, 64 MiB a rank
#: the ordering stress: back-to-back calls of 1 MiB float32, each of a
#: new value
RMA_STRESS = dict(calls=200, elems=1 << 18)
COLL_TOL = 1e-6                # a collective on the card vs its one-rank result
#: where the phases put their tensors (a rehearsal on the CPU changes it)
DEVICE = "cuda"


#: where the run's processes keep their compiled bytecode (gitignored)
PYCACHE = os.path.join("build", "pycache")


def cache_bytecode(root: str) -> str:
    """Keep compiled bytecode under ``root``/``PYCACHE`` for this process
    and every process it starts from now on; → the directory."""
    prefix = os.path.join(root, PYCACHE)
    os.environ.pop("PYTHONDONTWRITEBYTECODE", None)
    os.environ["PYTHONPYCACHEPREFIX"] = prefix
    sys.dont_write_bytecode = False
    sys.pycache_prefix = prefix
    return prefix


def check(ok: bool, what: str) -> None:
    """Fail the run (an assert would vanish under python -O)."""
    if not ok:
        raise AssertionError(what)


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` in ms, from CUDA events over ``iters``
    back-to-back calls after ``warmup`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters


def live_pairs(t_q, t_k, causal, q_off, k_off) -> int:
    """(query, key) pairs a causal mask on global positions leaves."""
    if not causal:
        return t_q * t_k
    qpos = q_off + np.arange(t_q)[:, None]
    kpos = k_off + np.arange(t_k)[None, :]
    return int((qpos >= kpos).sum())


def bound(nbytes, flops, peak_flops):
    """(least ms, what sets it): bytes over the HBM rate against
    operations over the peak of their type, whichever is larger."""
    t_bytes, t_flops = nbytes / HBM_BYTES_PER_S, flops / peak_flops
    return (max(t_bytes, t_flops) * 1e3,
            "bytes" if t_bytes >= t_flops else "operations")


def attention_bound_ms(b, h, t_q, t_k, d, itemsize, causal, q_off, k_off):
    """Least time for the attention forward on this card: the larger of
    bytes (q, k, v read once, o and lse written once) over HBM rate and
    the FLOPs of the live (query, key) pairs over the peak of the type
    (bf16 tensor cores, or f32 CUDA cores)."""
    nbytes = (2 * t_q + 2 * t_k) * b * h * d * itemsize + b * h * t_q * 4
    flops = 4 * b * h * d * live_pairs(t_q, t_k, causal, q_off, k_off)
    peak = BF16_FLOPS if itemsize == 2 else F32_FLOPS
    return (*bound(nbytes, flops, peak), nbytes, flops)


def bwd_bound_ms(kernel, bh, t_q, t_k, d, itemsize, causal, q_off, k_off):
    """Least time for one backward kernel: q, k, v and g read once, lse
    and dm read once, its outputs (dq, or dk and dv) written once; 6
    FLOPs a live pair and head-dim element for dq (s, dp, dq), 8 for
    dk/dv (s, dp, dk, dv)."""
    pairs = live_pairs(t_q, t_k, causal, q_off, k_off)
    ins = (2 * t_q + 2 * t_k) * bh * d * itemsize + 2 * bh * t_q * 4
    if kernel == "dq":
        nbytes, flops = ins + t_q * bh * d * itemsize, 6 * pairs * d * bh
    else:
        nbytes, flops = ins + 2 * t_k * bh * d * itemsize, 8 * pairs * d * bh
    peak = BF16_FLOPS if itemsize == 2 else F32_FLOPS
    return (*bound(nbytes, flops, peak), nbytes, flops)


def phase_native(card):
    """The four native host executors built with g++ from the port's own
    copies (``ompi_tpu_torch/_native``) into ``build/ompi_tpu_torch/
    native``, one build each, all started together: each library's build
    seconds and whether it loaded; fails if one did not (no fall back to
    the Python branches).  Also /dev/shm's capacity and free space and
    the shm backing directory the rings and arenas use."""
    import sysconfig

    from ompi_tpu_torch import _native
    from ompi_tpu_torch.core import shmseg

    inc = sysconfig.get_paths().get("include") or ""
    has_python_h = os.path.exists(os.path.join(inc, "Python.h"))
    check(has_python_h, f"native: no Python.h under {inc!r} on this "
          f"machine: the fastdss extension cannot build")
    loaders = {"convertor": _native.lib, "arena": _native.arena,
               "net": _native.net, "fastdss": _native.fastdss}
    built_before = set(os.listdir(_native.BUILD_DIR)) if os.path.isdir(
        _native.BUILD_DIR) else set()

    def build(item):
        name, fn = item
        t0 = time.perf_counter()
        lib = fn()
        return name, {"seconds": round(time.perf_counter() - t0, 3),
                      "loaded": lib is not None}

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(loaders)) as pool:
        libs = dict(pool.map(build, loaders.items()))
    secs = time.perf_counter() - t0
    files = sorted(set(os.listdir(_native.BUILD_DIR)) - built_before)
    shm_dir = shmseg.backing_dir()
    st = os.statvfs(shm_dir)
    out = {"card": card, "compiler": "g++", "build_dir": _native.BUILD_DIR,
           "libs": libs, "built": files, "seconds": round(secs, 3),
           "python_h": os.path.join(inc, "Python.h"),
           "shm_dir": shm_dir,
           "shm_capacity_bytes": st.f_frsize * st.f_blocks,
           "shm_free_bytes": st.f_frsize * st.f_bavail}
    emit("native", **out)
    check(all(v["loaded"] for v in libs.values()),
          f"native: a library did not load: {libs}")
    return out


def phase_device():
    import torch

    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    emit("device", name=name, count=count, nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda)
    return name, count, smi


def phase_build():
    from ompi_tpu_torch.ops import _build

    sources = sorted(p.name for p in _build.CSRC.glob("*.cu"))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(sources)) as pool:
        libs = list(pool.map(_build.load, sources))
    secs = time.perf_counter() - t0
    ptxas = {s: [ln for ln in _build.ptxas_info.get(s, [])
                 if "Used" in ln or "spill" in ln] for s in sources}
    spills = [f"{s}: {ln}" for s, lines in ptxas.items() for ln in lines
              if "spill" in ln and "0 bytes spill stores, 0 bytes spill "
              "loads" not in ln]
    serialised = [f"{s}: {ln}" for s in sources
                  for ln in _build.ptxas_info.get(s, []) if "(C751" in ln]
    emit("build", sources=sources, seconds=round(secs, 3),
         arch="sm_90a", libs=[str(lib._name) for lib in libs],
         ptxas=ptxas, spills=spills, wgmma_serialised=serialised)
    check(all(any("spill" in ln for ln in lines) for lines in ptxas.values()),
          "no -Xptxas -v spill lines in the build log")
    check(not spills, f"kernels spill registers: {spills}")
    check(not serialised, f"ptxas serialised wgmmas: {serialised}")


def phase_kernel(fa):
    import torch

    g = torch.Generator(device="cuda").manual_seed(0)
    worst = {"float32": 0.0, "bfloat16": 0.0}
    n_cases = 0
    for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
        for d in (16, 64, 128):
            for t in (96, 256, 512):
                shape = (2, t, 2, d)
                q, k, v = (torch.randn(shape, generator=g, device="cuda")
                           .to(dtype) for _ in range(3))
                for causal in (True, False):
                    for q_off, k_off in OFFSETS:
                        o, lse = fa.flash_attention_lse(
                            q, k, v, causal=causal, q_offset=q_off,
                            k_offset=k_off)
                        ro, rlse = fa.flash_attention_lse_reference(
                            q, k, v, causal=causal, q_offset=q_off,
                            k_offset=k_off)
                        torch.cuda.synchronize()
                        check(o.dtype == dtype and o.shape == q.shape,
                              f"output {o.dtype} {tuple(o.shape)}")
                        check(lse.shape == (2, 2, t),
                              f"lse shape {tuple(lse.shape)}")
                        for got, want in ((o.float(), ro.float()),
                                          (lse, rlse)):
                            check(torch.allclose(got, want, atol=tol,
                                                 rtol=tol),
                                  f"flash kernel disagrees: {dtype} d={d} "
                                  f"t={t} causal={causal} offsets="
                                  f"({q_off},{k_off}) max err "
                                  f"{(got - want).abs().max().item()}")
                        key = str(dtype).split(".")[-1]
                        worst[key] = max(worst[key],
                                         (o.float() - ro.float()).abs()
                                         .max().item())
                        n_cases += 1

    # bf16 without a mask at t = 1024: every tile takes the full-tile path
    for d in (64, 128):
        q, k, v = (torch.randn((2, 1024, 2, d), generator=g, device="cuda")
                   .to(torch.bfloat16) for _ in range(3))
        o, lse = fa.flash_attention_lse(q, k, v, causal=False)
        ro, rlse = fa.flash_attention_lse_reference(q, k, v, causal=False)
        torch.cuda.synchronize()
        for got, want in ((o.float(), ro.float()), (lse, rlse)):
            check(torch.allclose(got, want, atol=BF16_TOL, rtol=BF16_TOL),
                  f"flash kernel disagrees: bfloat16 d={d} t=1024 full, "
                  f"max err {(got - want).abs().max().item()}")
        worst["bfloat16"] = max(worst["bfloat16"],
                                (o.float() - ro.float()).abs().max().item())
        n_cases += 1

    # the decode prefill shape: B=16, T=512, H=16, D=128, bf16, causal
    B, T, H, D = 16, 512, 16, 128
    q, k, v = (torch.randn((B, T, H, D), generator=g, device="cuda")
               .to(torch.bfloat16) for _ in range(3))
    o, lse = fa.flash_attention_lse(q, k, v, causal=True)
    ro, rlse = fa.flash_attention_lse_reference(q, k, v, causal=True)
    torch.cuda.synchronize()
    err_o = (o.float() - ro.float()).abs().max().item()
    err_lse = (lse - rlse).abs().max().item()
    check(torch.allclose(o.float(), ro.float(), atol=BF16_TOL,
                         rtol=BF16_TOL), f"prefill-shape O err {err_o}")
    check(torch.allclose(lse, rlse, atol=BF16_TOL, rtol=BF16_TOL),
          f"prefill-shape lse err {err_lse}")

    scale = D ** -0.5
    q3, k3, v3 = (fa._to3(x) for x in (q, k, v))       # (B·H, T, D)
    ms = cuda_ms(lambda: fa.flash_fwd_3d(q3, k3, v3, 0, 0, scale, True))
    q4, k4, v4 = (x.unsqueeze(2) for x in (q3, k3, v3))
    plain_ms = cuda_ms(lambda: fa.flash_attention_lse_reference(
        q4, k4, v4, causal=True, scale=scale))
    qs, ks, vs = (x.view(B, H, T, D) for x in (q3, k3, v3))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library_ms = cuda_ms(lambda: sdpa(qs, ks, vs, is_causal=True))
    bound_ms, bound_by, nbytes, flops = attention_bound_ms(
        B, H, T, T, D, 2, True, 0, 0)
    # the same shape in float32 (the CUDA-core kernel)
    q3f, k3f, v3f = (x.float() for x in (q3, k3, v3))
    f32 = {"ms": cuda_ms(lambda: fa.flash_fwd_3d(q3f, k3f, v3f, 0, 0, scale,
                                                 True)),
           "plain_ms": cuda_ms(lambda: fa.flash_attention_lse_reference(
               *(x.unsqueeze(2) for x in (q3f, k3f, v3f)), causal=True,
               scale=scale)),
           "bound_ms": attention_bound_ms(B, H, T, T, D, 4, True, 0, 0)[0],
           "bound_by": attention_bound_ms(B, H, T, T, D, 4, True, 0, 0)[1]}
    qf, kf, vf = (x.view(B, H, T, D) for x in (q3f, k3f, v3f))
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 is on")
    f32["library_ms"] = cuda_ms(lambda: sdpa(qf, kf, vf, is_causal=True))
    del q3f, k3f, v3f, qf, kf, vf

    # the training shape: (B·H=256, T=1024, D=128) bf16, causal, 16
    # launches a train step (forward and the remat rerun)
    bt, tt = TRAIN["batch"], TRAIN["seq"]
    qt, kt, vt = (torch.randn((bt * H, tt, D), generator=g, device="cuda")
                  .to(torch.bfloat16) for _ in range(3))
    ot, lt = fa.flash_fwd_3d(qt, kt, vt, 0, 0, scale, True)
    rot, rlt = fa.flash_attention_lse_reference(
        *(x.unsqueeze(2) for x in (qt, kt, vt)), causal=True, scale=scale)
    torch.cuda.synchronize()
    err_t = (ot.float() - rot.squeeze(2).float()).abs().max().item()
    check(torch.allclose(ot.float(), rot.squeeze(2).float(), atol=BF16_TOL,
                         rtol=BF16_TOL)
          and torch.allclose(lt, rlt.reshape(lt.shape), atol=BF16_TOL,
                             rtol=BF16_TOL),
          f"train-shape forward err {err_t}")
    del rot, rlt
    tb_ms, tb_by = attention_bound_ms(bt, H, tt, tt, D, 2, True, 0, 0)[:2]
    train_shape = {
        "shape": [bt * H, tt, D], "max_abs_err": err_t,
        "ms": cuda_ms(lambda: fa.flash_fwd_3d(qt, kt, vt, 0, 0, scale,
                                              True)),
        "library_ms": cuda_ms(lambda: sdpa(
            *(x.view(bt, H, tt, D) for x in (qt, kt, vt)), is_causal=True)),
        "bound_ms": tb_ms, "bound_by": tb_by}
    del qt, kt, vt, ot, lt
    emit("kernel", cases=n_cases, max_abs_err_o=worst, float32=f32,
         prefill_shape=[B, T, H, D], prefill_dtype="bfloat16",
         prefill_max_abs_err_o=err_o, prefill_max_abs_err_lse=err_lse,
         ms=ms, plain_ms=plain_ms, library_ms=library_ms,
         bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes, flops=flops,
         tflops=flops / ms / 1e9, train_shape=train_shape)
    return {"max_abs_err": err_o, "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "train_shape": train_shape}


def bwd_err(got, want, dtype):
    """(ok, max abs error) of one backward output: f32 at BWD_F32_TOL abs
    + rel, bf16 at BWD_BF16_TOL of max|ref|."""
    import torch

    a, b = got.float(), want.float()
    err = (a - b).abs()
    if dtype == torch.float32:
        ok = bool((err <= BWD_F32_TOL * (1 + b.abs())).all())
    else:
        ok = bool((err <= BWD_BF16_TOL * b.abs().max()).all())
    return ok, err.max().item()


def phase_kernel_bwd(fa):
    import torch

    from ompi_tpu_torch.core.config import var_registry

    g = torch.Generator(device=DEVICE).manual_seed(1)
    worst = {"float32": 0.0, "bfloat16": 0.0}
    n_cases = 0
    for dtype in (torch.float32, torch.bfloat16):
        key = str(dtype).split(".")[-1]
        for d in (16, 64, 128):
            scale = d ** -0.5
            for t in BWD_LENGTHS:
                q3, k3, v3, g3 = (torch.randn((4, t, d), generator=g,
                                              device=DEVICE).to(dtype)
                                  for _ in range(4))
                g_lse = torch.randn((4, t), generator=g, device=DEVICE)
                for causal in (True, False):
                    for q_off, k_off in OFFSETS:
                        o3, lse = fa.flash_fwd_3d(q3, k3, v3, q_off, k_off,
                                                  scale, causal)
                        delta = (g3.float() * o3.float()).sum(-1)
                        for with_lse, dm in ((False, delta),
                                             (True, delta - g_lse)):
                            args = (q3, k3, v3, g3, lse, dm, q_off, k_off,
                                    scale, causal)
                            got = fa.flash_bwd_3d(*args)
                            want = fa.flash_bwd_reference(*args)
                            torch.cuda.synchronize()
                            for name, a, b in zip(("dq", "dk", "dv"), got,
                                                  want):
                                ok, err = bwd_err(a, b, dtype)
                                check(a.dtype == dtype and ok,
                                      f"flash {name} kernel disagrees: "
                                      f"{key} d={d} t={t} causal={causal} "
                                      f"offsets=({q_off},{k_off}) lse "
                                      f"cotangent={with_lse} max err {err}")
                                worst[key] = max(worst[key], err)
                            n_cases += 1

    # the autograd backward with the kernels against the recompute one
    var_before = var_registry.get("ops_flash_bwd_kernel")
    autograd_err = {}
    for dtype in (torch.float32, torch.bfloat16):
        base = [torch.randn((2, 512, 4, 128), generator=g, device=DEVICE)
                .to(dtype) for _ in range(4)]
        grads = {}
        for kernel in (False, True):
            var_registry.set("ops_flash_bwd_kernel", kernel)
            ts = [x.clone().requires_grad_(True) for x in base[:3]]
            o, lse = fa.flash_attention_lse(*ts, causal=True, q_offset=128)
            loss = (o.float() * base[3].float()).sum() + (lse * 0.01).sum()
            grads[kernel] = torch.autograd.grad(loss, ts)
        var_registry.set("ops_flash_bwd_kernel", var_before)
        key = str(dtype).split(".")[-1]
        autograd_err[key] = 0.0
        for name, a, b in zip(("dq", "dk", "dv"), grads[True], grads[False]):
            ok, err = bwd_err(a, b, dtype)
            check(ok, f"autograd {name} with the kernels disagrees with the "
                      f"recompute backward: {key} max err {err}")
            autograd_err[key] = max(autograd_err[key], err)

    # the training shape: q/k/v/g (B·H=256, T=1024, D=128) bf16, causal
    B, T = TRAIN["batch"], TRAIN["seq"]
    H = FLAGSHIP["n_heads"]
    D = FLAGSHIP["d_model"] // H
    scale = D ** -0.5
    q, k, v, go = (torch.randn((B, T, H, D), generator=g, device=DEVICE)
                   .to(torch.bfloat16) for _ in range(4))
    q3, k3, v3, g3 = (fa._to3(x) for x in (q, k, v, go))
    o3, lse = fa.flash_fwd_3d(q3, k3, v3, 0, 0, scale, True)
    dm = (g3.float() * o3.float()).sum(-1)
    args = (q3, k3, v3, g3, lse, dm, 0, 0, scale, True)
    got = fa.flash_bwd_3d(*args)
    want = fa.flash_bwd_reference(*args)
    torch.cuda.synchronize()
    shape_err = {}
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        ok, shape_err[name] = bwd_err(a, b, torch.bfloat16)
        check(ok, f"flash {name} kernel disagrees at the training shape: "
                  f"max err {shape_err[name]}")
    del got, want
    dq_ms = cuda_ms(lambda: fa.flash_bwd_dq_3d(*args))
    dkv_ms = cuda_ms(lambda: fa.flash_bwd_dkv_3d(*args))
    dq_plain_ms = cuda_ms(lambda: fa.flash_bwd_dq_reference(*args), iters=5,
                          warmup=1)
    dkv_plain_ms = cuda_ms(lambda: fa.flash_bwd_dkv_reference(*args),
                           iters=5, warmup=1)
    o = fa._from3(o3, B, H)
    recompute_ms = cuda_ms(lambda: fa.flash_bwd_recompute(
        q, k, v, o, go, None, 0, 0, scale, True), iters=5, warmup=1)

    # SDPA's backward (a yardstick only): fwd+bwd minus fwd
    qs, ks, vs = (x.view(B, H, T, D).detach().requires_grad_(True)
                  for x in (q3, k3, v3))
    gs = g3.view(B, H, T, D)
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def sdpa_fwd_bwd():
        torch.autograd.grad(sdpa(qs, ks, vs, is_causal=True), (qs, ks, vs),
                            gs)

    sdpa_fwd_ms = cuda_ms(lambda: sdpa(qs, ks, vs, is_causal=True))
    sdpa_bwd_ms = cuda_ms(sdpa_fwd_bwd) - sdpa_fwd_ms
    ptxas = {"dq": kernel_ptxas("bwd_dq_bf16_kernel"),
             "dkv": kernel_ptxas("bwd_dkv_bf16_kernel")}
    out = {}
    for name, ms, plain_ms in (("dq", dq_ms, dq_plain_ms),
                               ("dkv", dkv_ms, dkv_plain_ms)):
        bound_ms, bound_by, nbytes, flops = bwd_bound_ms(
            name, B * H, T, T, D, 2, True, 0, 0)
        err = (shape_err["dq"] if name == "dq"
               else max(shape_err["dk"], shape_err["dv"]))
        out[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "library_ms": sdpa_bwd_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "bytes": nbytes, "flops": flops,
                     "tflops": flops / ms / 1e9, "ptxas": ptxas[name]}
    emit("kernel_bwd", cases=n_cases, max_abs_err=worst,
         autograd_kernel_vs_recompute_max_abs_err=autograd_err,
         train_shape=[B * H, T, D], train_dtype="bfloat16",
         train_shape_max_abs_err=shape_err, dq=out["dq"], dkv=out["dkv"],
         recompute_bwd_ms=recompute_ms, sdpa_fwd_ms=sdpa_fwd_ms,
         sdpa_bwd_ms=sdpa_bwd_ms,
         library_note="SDPA backward computes dq, dk and dv together")
    return out


def kernel_ptxas(kernel):
    """``flash_bwd.cu``'s ``-Xptxas -v`` register and spill lines, and any
    C751x warning, of each instance ``kernel<D>`` of a kernel template,
    found by its mangled name (``...kernelILi<D>E...``); phase build has
    already failed on a spill or a warning."""
    import re

    from ompi_tpu_torch.ops import _build

    name = re.compile(rf"\d{kernel}ILi(\d+)E")
    out, cur = {}, None
    for ln in _build.ptxas_info.get("flash_bwd.cu", []):
        m = name.search(ln)
        if "(C751" in ln:
            if m:
                out.setdefault(f"{kernel}<{m.group(1)}>", []).append(ln)
        elif "Compiling entry function" in ln:
            cur = f"{kernel}<{m.group(1)}>" if m else None
        elif cur and ("Used" in ln or "spill" in ln):
            out.setdefault(cur, []).append(ln)
    check(any("Used" in ln for ln in out.get(f"{kernel}<128>", [])),
          f"no ptxas register line of {kernel}<128>: {out}")
    return out


def moe_fields() -> dict:
    """The MoE family's config fields: the flagship's widths, every FFN
    a switch of ``MOE``'s experts, at ``CUT_LAYERS`` of its 8 layers."""
    return dict(flagship_cut(), **MOE)


def flagship_params(moe: bool = False):
    """The flagship 468M model's parameters (init_params, seed 0) as numpy,
    or with ``moe`` its switch-MoE family's (``moe_fields``: 351M):
    decode and train share them (init_params does not read ``seq``)."""
    from ompi_tpu_torch.models.transformer import TransformerConfig, init_params

    return init_params(TransformerConfig(**(moe_fields() if moe
                                            else FLAGSHIP)), seed=0)


def routing_stats(records):
    """Per layer, the share of tokens dropped over capacity, and the
    tokens routed to each expert, from ``parallel.moe.recording()``."""
    import torch

    load = torch.stack([r["load"] for r in records]).cpu().numpy()
    dropped = [int(r["dropped"]) / r["tokens"] for r in records]
    return {"dropped_share_per_layer": dropped,
            "expert_load_per_layer": load.tolist(),
            "tokens_per_layer": records[0]["tokens"] if records else 0}


def routing_agreement(routes, routes_x):
    """Where the plain attention path, running free, routes the MoE
    prefill otherwise than the flash path, layer by layer: the decisions
    (expert or kept) that differ and the flash path's top-two gate
    margins of those.  A top-1 switch is discrete, so a token within the
    two paths' bf16 difference of a tie goes to another expert on each,
    and from there its hidden state, and through attention its
    sequence's later positions, differ by O(1): the logits check runs
    with the flash path's routing replayed instead
    (``parallel.moe.replaying``)."""
    import torch

    check(len(routes) == len(routes_x) > 0, "no routing recorded")
    per_layer, margins, moved = [], [], None
    for a, b in zip(routes, routes_x):
        diff = (a["expert"] != b["expert"]) | (a["keep"] != b["keep"])
        per_layer.append(int(diff.sum()))
        margins.append(a["margin"][diff])
        moved = diff if moved is None else moved | diff
    # layer 0's inputs differ by the attention alone: its differing
    # decisions are the near ties themselves
    return {"positions": moved.numel(),
            "positions_routed_differently": int(moved.sum()),
            "decisions_differing_per_layer": per_layer,
            "gate_margin_of_those_layer0_max": (
                margins[0].max().item() if per_layer[0] else None),
            "gate_margin_of_those_median": (
                torch.cat(margins).median().item() if any(per_layer)
                else None)}


def phase_decode(fa, card, params_np, moe: bool = False):
    import torch

    from ompi_tpu_torch.models.decode import make_decoder
    from ompi_tpu_torch.models.transformer import (TransformerConfig,
                                                   make_forward)
    from ompi_tpu_torch.models.weights import from_jax_params
    from ompi_tpu_torch.parallel import moe as moe_mod
    from ompi_tpu_torch.parallel.mesh import make_mesh

    # bench.py matrix_decode_throughput flagship widths (468M params; its
    # MoE family at 1 of the 8 layers, 351M, 116M active a token)
    cfg = TransformerConfig(**(moe_fields() if moe else FLAGSHIP),
                            seq=512 + 256, attention="flash",
                            compute_dtype="bfloat16")
    cfg_x = dataclasses.replace(cfg, attention="xla")
    batch, prompt_len, lo, hi = 16, 512, 32, 96
    mesh = make_mesh({"dp": 1, "sp": 1, "tp": 1}, device=DEVICE)
    t0 = time.perf_counter()
    params = from_jax_params(params_np, cfg, DEVICE)
    load_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in params.values())
    prompt = np.random.default_rng(0).integers(
        0, cfg.vocab, size=(batch, prompt_len)).astype(np.int32)
    dec = make_decoder(cfg, mesh, max_new=lo)

    # ---- the main path: one decode call, launch counts read around it ----
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.launch_count = 0
    out = dec(params, prompt)
    torch.cuda.synchronize()
    launches = fa.launch_count
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    check(launches == cfg.n_layers,
          f"{launches} flash launches in one decode call, want "
          f"{cfg.n_layers}")
    out = out.cpu().numpy()
    check(out.shape == (batch, prompt_len + lo) and out.dtype == np.int32,
          f"tokens {out.dtype} {out.shape}")
    np.testing.assert_array_equal(out[:, :prompt_len], prompt)
    check(out.min() >= 0 and out.max() < cfg.vocab, "token out of range")

    # the same prompt through the plain attention path
    out_x = make_decoder(cfg_x, mesh, max_new=lo)(params, prompt)
    out_x = out_x.cpu().numpy()
    agree = float((out[:, prompt_len:] == out_x[:, prompt_len:]).mean())
    first_agree = float((out[:, prompt_len] == out_x[:, prompt_len]).mean())
    extra = {}
    if moe:
        # the plain path once free (how its routing differs), then with
        # the flash path's routing replayed for the logits check
        with moe_mod.recording() as routes:
            logits = make_forward(cfg, mesh)(params, prompt)
        with moe_mod.recording() as routes_x:
            make_forward(cfg_x, mesh)(params, prompt)
        extra["routing_of_plain_path"] = routing_agreement(routes, routes_x)
        with moe_mod.replaying(routes):
            logits_x = make_forward(cfg_x, mesh)(params, prompt)
    else:
        logits = make_forward(cfg, mesh)(params, prompt)
        logits_x = make_forward(cfg_x, mesh)(params, prompt)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(logits).all()), "non-finite logits")
    logit_err = (logits - logits_x).abs().max().item()
    logit_scale = logits_x.abs().max().item()
    check(logit_err <= LOGIT_TOL,
          f"flash vs plain prefill logits differ by {logit_err}")
    del logits, logits_x

    def timed(max_new: int) -> float:
        """Best host wall time of 5 decode calls (after a warm call), each
        ending in a synchronize; the host loop shares its cores, so single
        calls vary."""
        d = make_decoder(cfg, mesh, max_new=max_new)
        d(params, prompt)
        torch.cuda.synchronize()
        best = float("inf")
        for _ in range(5):
            t1 = time.perf_counter()
            d(params, prompt)
            torch.cuda.synchronize()
            best = min(best, time.perf_counter() - t1)
        return best

    # max_new=1 is the prefill alone (one backbone pass, the first token
    # from its logits); the slope between two longer runs is the cached
    # step, with the prefill and the call overhead cancelled
    t_1, t_lo, t_hi = timed(1), timed(lo), timed(hi)
    step_s = (t_hi - t_lo) / (hi - lo)
    if moe:
        # the prefill alone, its routing recorded layer by layer
        with moe_mod.recording() as records:
            make_decoder(cfg, mesh, max_new=1)(params, prompt)
        check(len(records) == cfg.n_layers,
              f"{len(records)} switch calls in a prefill")
        extra["prefill_routing"] = routing_stats(records)
    name = "moe_decode" if moe else "decode"
    emit(name, config=(f"flagship MoE 8 experts at {cfg.n_layers} of its "
                       f"8 layers, {n_params / 1e6:.0f}M, bench.py decode "
                       f"widths" if moe else
                       "flagship 468M dense (bench.py decode widths)"),
         n_params=n_params, batch=batch, prompt=prompt_len,
         max_new=[lo, hi], load_s=load_s, flash_launches=launches,
         generated_agree_with_plain=agree,
         first_token_agree_with_plain=first_agree,
         prefill_logits_max_abs_diff=logit_err,
         prefill_logits_max_abs=logit_scale, logits_tol=LOGIT_TOL,
         wall_1_s=t_1, wall_lo_s=t_lo, wall_hi_s=t_hi,
         prefill_ms=t_1 * 1e3, ms_per_token=step_s * 1e3,
         ms_per_token_from_prefill=(t_hi - t_1) / (hi - 1) * 1e3,
         tokens_per_s=batch / step_s, peak_mem_gib=peak_gib, **extra,
         card=card)
    phase_profile(make_decoder, cfg, mesh, params, prompt, card,
                  "moe_profile" if moe else "profile")
    return launches


def dev_us(e):
    return getattr(e, "self_device_time_total",
                   getattr(e, "self_cuda_time_total", 0.0))


def profile_window(fn, moe: bool = False):
    """Device busy time and the kernels that take it, from torch.profiler,
    over one call of ``fn`` that ends in a synchronize; with ``moe`` also
    the MoE layer's split (:func:`moe_split`)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type.name == "CUDA" and dev_us(e) > 0]
    busy_ms = sum(dev_us(e) for e in kernels) / 1e3
    top = sorted(kernels, key=dev_us, reverse=True)[:12]
    by_kind = dict.fromkeys(("flash", "gemm_f32", "gemm_tf32", "gemm_bf16",
                             "gemm_unknown", "other"), 0.0)
    for e in kernels:
        by_kind[kernel_kind(e.key)] += dev_us(e) / 1e3
    unknown = sorted({e.key for e in kernels
                      if kernel_kind(e.key) == "gemm_unknown"})
    extra = {"moe_split_ms": moe_split(prof, busy_ms)} if moe else {}
    return {**extra, "wall_ms_profiled": wall_ms, "device_busy_ms": busy_ms,
            "device_idle_share": (1 - busy_ms / wall_ms) if busy_ms else None,
            "flash_kernel_ms": {
                name: sum(dev_us(e) for e in kernels if tag in e.key) / 1e3
                for name, tag in (("fwd", "flash_fwd_"),
                                  ("dq", "bwd_dq_"), ("dkv", "bwd_dkv_"))},
            "device_ms_by_kind": by_kind, "gemm_unknown_names": unknown,
            "top_kernels": [{"name": e.key[:80], "ms": dev_us(e) / 1e3,
                             "calls": e.count} for e in top]}


#: kernel names of the index ops: the MoE dispatch (index_copy) and
#: combine (index_select) and their backwards (index_select, index_add),
#: and the embedding's gather and its scatter-add
INDEX_KERNELS = ("indexSelect", "indexFunc", "index_elementwise",
                 "indexing_backward", "index_copy")


def moe_split(prof, busy_ms):
    """An MoE step's device ms by part: the flash kernels; the expert
    GEMMs (the kernels ``aten::bmm`` launches: the expert FFN is the
    only batched product on the flash path, forward, recompute and
    backward); the index ops (dispatch, combine, their backwards and the
    embedding's, by kernel name); the other GEMMs; and the rest."""
    split = dict.fromkeys(("flash", "expert_gemm", "index_ops", "other_gemm",
                           "rest"), 0.0)
    for e in prof.events():
        if e.device_type.name != "CPU" or e.name != "aten::bmm":
            continue
        split["expert_gemm"] += sum(k.duration for k in e.kernels) / 1e3
    for e in prof.key_averages():
        if e.device_type.name != "CUDA" or dev_us(e) <= 0:
            continue
        kind = kernel_kind(e.key)
        if kind == "flash":
            split["flash"] += dev_us(e) / 1e3
        elif any(tag in e.key for tag in INDEX_KERNELS):
            split["index_ops"] += dev_us(e) / 1e3
        elif kind.startswith("gemm"):
            split["other_gemm"] += dev_us(e) / 1e3
    split["other_gemm"] -= split["expert_gemm"]
    split["rest"] = busy_ms - sum(split.values())
    return split


def kernel_device_ms(fn, tag: str, n: int = 50) -> float:
    """Mean device time of one launch of the kernels whose name holds
    ``tag``, from torch.profiler over ``n`` calls of ``fn``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    def window():
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        hits = [e for e in prof.key_averages()
                if e.device_type.name == "CUDA" and tag in e.key]
        return hits, sum(e.count for e in hits)

    fn()
    torch.cuda.synchronize()
    hits, launches = window()
    if launches < n // 2:
        # a window that records fewer than half the launches gets exactly
        # one more (one whole run saw none of 50 after every bitwise
        # check had passed); only a second miss fails
        first = launches
        hits, launches = window()
        print(f"kernel_device_ms {tag}: the profiler saw {first} of {n} "
              f"launches, then {launches} in a second window", flush=True)
    # the profiler may miss a launch at the window's edge
    check(n // 2 <= launches <= n, f"the profiler saw {launches} launches "
          f"of {tag}, want {n}")
    return sum(getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))
               for e in hits) / launches / 1e3


def kernel_kind(name: str) -> str:
    """The port's flash kernels, the matrix products by operand type, or
    the rest (elementwise work, reductions, copies), by kernel name.

    A GEMM or GEMV is f32 on the CUDA cores when cuBLAS names it
    ``..._f32f32_f32f32_...``, ``sgemm``, ``nvjet_s...`` (nvjet names
    open with their operand types: s f32, t bf16, h fp16) or templates it
    on ``<int, int, float, ...`` (its gemv kernels); TF32 with ``tf32``
    in the name; bf16 or fp16 on the tensor cores with ``bf16``,
    ``bfloat16``, ``f16``, ``half``, ``nvjet_t`` or ``nvjet_h``; any other
    is ``gemm_unknown``, listed by name in the profile record."""
    if "flash_fwd_" in name or "bwd_dq_" in name or "bwd_dkv_" in name:
        return "flash"
    if not any(tag in name for tag in ("gemm", "gemv", "nvjet", "xmma")):
        return "other"
    if (any(tag in name for tag in ("f32f32_f32f32", "sgemm",
                                    "<int, int, float,"))
            or name.startswith("nvjet_s")):
        return "gemm_f32"
    if "tf32" in name:
        return "gemm_tf32"
    if (any(tag in name for tag in ("bf16", "bfloat16", "f16", "half"))
            or name.startswith(("nvjet_t", "nvjet_h"))):
        return "gemm_bf16"
    return "gemm_unknown"


def phase_profile(make_decoder, cfg, mesh, params, prompt, card,
                  name="profile"):
    """The prefill alone (max_new=1) and a decode of 16 tokens, profiled."""
    import torch

    for max_new in (1, 16):
        d = make_decoder(cfg, mesh, max_new=max_new)
        d(params, prompt)
        torch.cuda.synchronize()
        emit(name, max_new=max_new,
             **profile_window(lambda: d(params, prompt)), card=card)


def _greedy_reference(fwd, params, prompt, max_new):
    """Grow the sequence one token at a time via full forwards."""
    cur = prompt
    for _ in range(max_new):
        logits = fwd(params, cur).cpu().numpy()
        nxt = logits[:, -1, :].argmax(-1).astype(np.int32)[:, None]
        cur = np.concatenate([cur, nxt], axis=1)
    return cur


def phase_cache(fa):
    from ompi_tpu_torch.models.decode import make_decoder
    from ompi_tpu_torch.models.transformer import (TransformerConfig,
                                                   init_params, make_forward)
    from ompi_tpu_torch.models.weights import from_jax_params
    from ompi_tpu_torch.parallel.mesh import make_mesh

    cfg = TransformerConfig(vocab=97, d_model=64, n_heads=4, n_layers=2,
                            d_ff=128, seq=64, attention="flash",
                            compute_dtype="float32")
    mesh = make_mesh({"dp": 1, "sp": 1, "tp": 1})
    params = from_jax_params(init_params(cfg), cfg, "cuda")
    fwd = make_forward(cfg, mesh)
    before = fa.launch_count
    for seed, prompt_len, max_new in ((0, 8, 5), (4, 7, 3)):
        prompt = np.random.default_rng(seed).integers(
            0, cfg.vocab, size=(4, prompt_len)).astype(np.int32)
        got = make_decoder(cfg, mesh, max_new=max_new)(params, prompt)
        np.testing.assert_array_equal(
            got.cpu().numpy(),
            _greedy_reference(fwd, params, prompt, max_new))
    emit("cache", config="tests/parallel/test_decode.py CFG, flash, f32",
         prompts=[8, 7], exact=True,
         kernel_launches=fa.launch_count - before)


def counts(fa):
    return {"flash_fwd": fa.launch_count, "flash_bwd_dq": fa.dq_launch_count,
            "flash_bwd_dkv": fa.dkv_launch_count}


def zero_counts(fa):
    fa.launch_count = fa.dq_launch_count = fa.dkv_launch_count = 0


def value_and_grad(cfg, mesh, params, tokens):
    """(loss, {leaf: grad}) of one loss evaluation, as a train step takes
    them."""
    import torch

    from ompi_tpu_torch.models.transformer import make_loss_fn

    loss = make_loss_fn(cfg, mesh)(params, tokens)
    keys = list(params)
    grads = torch.autograd.grad(loss, [params[k] for k in keys])
    return loss.item(), dict(zip(keys, grads))


def step_ms(step, params, opt_state, tokens, n):
    """Device time of ``n`` train steps after a warm-up step, from CUDA
    events, in ms a step."""
    import torch

    params, opt_state, _ = step(params, opt_state, tokens)
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        params, opt_state, _ = step(params, opt_state, tokens)
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / n


def unembed_check(cfg, mesh, params, tokens):
    """The unembed of the train batch's final hidden states (the model's
    backbone under the initial parameters): ``unembed`` (bf16 operands on
    the tensor cores, f32 accumulation, the cotangent rounded to bf16)
    against ``unembed_reference`` (the bf16-rounded operands upcast, a
    full f32 product, an f32 cotangent).  Each gives the next-token
    cross-entropy sum over ``ce_chunk`` chunks and its gradients in h and
    emb; the losses agree to UNEMBED_LOSS_RTOL, the gradients to
    UNEMBED_GRAD_RL2 relative L2, and the argmax tokens are equal in
    every row whose top-two gap in the f32 logits exceeds the largest
    logit difference (rows nearer a tie are counted)."""
    import torch

    from ompi_tpu_torch.models import transformer as tfm

    cdt = torch.bfloat16
    with torch.no_grad():
        h, _ = tfm._local_backbone(cfg, tfm._comm_for(cfg, mesh), params,
                                   tokens)
    labels = torch.roll(tokens, -1, dims=1)
    c = cfg.ce_chunk
    chunks = [slice(i * c, (i + 1) * c) for i in range(cfg.seq // c)]
    leaves = {name: (h.detach().clone().requires_grad_(True),
                     params["emb"].detach().clone().requires_grad_(True))
              for name in ("unembed", "reference")}
    fns = {"unembed": tfm.unembed, "reference": tfm.unembed_reference}
    total = dict.fromkeys(fns, 0.0)
    max_diff, near_tie, mismatch = 0.0, 0, 0
    for sl in chunks:
        logits = {}
        for name, fn in fns.items():
            hl, el = leaves[name]
            lg = fn(hl[:, sl], el, cdt)
            lab = labels[:, sl, None]
            total[name] = total[name] + (torch.logsumexp(lg, -1)
                                         - lg.gather(-1, lab)[..., 0]).sum()
            logits[name] = lg.detach()
        diff = (logits["unembed"] - logits["reference"]).abs().max().item()
        max_diff = max(max_diff, diff)
        top2 = logits["reference"].topk(2, dim=-1).values
        clear = (top2[..., 0] - top2[..., 1]) > diff
        same = (logits["unembed"].argmax(-1)
                == logits["reference"].argmax(-1))
        near_tie += int((~clear).sum().item())
        mismatch += int((clear & ~same).sum().item())
        del logits, top2
    grads = {name: torch.autograd.grad(total[name], leaves[name])
             for name in fns}
    torch.cuda.synchronize()
    loss = {k: v.item() for k, v in total.items()}
    rel = {leaf: ((grads["unembed"][i].float() - grads["reference"][i]
                   .float()).norm() / grads["reference"][i].float().norm())
           .item() for i, leaf in enumerate(("h", "emb"))}
    loss_rel = abs(loss["unembed"] - loss["reference"]) / abs(
        loss["reference"])
    check(loss_rel <= UNEMBED_LOSS_RTOL,
          f"unembed loss {loss['unembed']} vs f32 {loss['reference']}")
    check(max(rel.values()) <= UNEMBED_GRAD_RL2,
          f"unembed gradients vs f32: relative L2 {rel}")
    check(mismatch == 0, f"unembed argmax differs from the f32 product in "
          f"{mismatch} rows clear of a tie")
    check(grads["unembed"][0].dtype == cdt, "grad h is not bf16")
    del grads, leaves

    # one chunk forward and backward, each way
    def one_chunk(fn):
        hl = h[:, :c].detach().requires_grad_(True)
        el = params["emb"].detach().requires_grad_(True)
        lg = fn(hl, el, cdt)
        lse = torch.logsumexp(lg, -1).sum()
        torch.autograd.grad(lse, (hl, el))

    ms = {name: cuda_ms(lambda f=fn: one_chunk(f), iters=10, warmup=2)
          for name, fn in fns.items()}
    return {"loss": loss, "loss_rel_diff": loss_rel, "grad_rel_l2": rel,
            "logits_max_abs_diff": max_diff, "argmax_rows": h.shape[0]
            * cfg.seq, "argmax_mismatch": mismatch,
            "argmax_near_tie_rows": near_tie,
            "chunk_fwd_bwd_ms": ms, "chunk": [h.shape[0], c],
            "loss_rtol": UNEMBED_LOSS_RTOL, "grad_rl2": UNEMBED_GRAD_RL2}


def phase_train(fa, card, params_np):
    import torch

    from ompi_tpu_torch.core.config import var_registry
    from ompi_tpu_torch.models.data import ArraySource, train_stream
    from ompi_tpu_torch.models.transformer import (TransformerConfig,
                                                   make_train_loop,
                                                   make_train_step)
    from ompi_tpu_torch.models.weights import from_jax_params
    from ompi_tpu_torch.parallel.mesh import make_mesh

    # bench.py:478-484 flagship MFU widths, with the flash kernels forward
    # and backward (tools/mfu_sweep.py's "-pbwd" switch)
    cfg = TransformerConfig(**FLAGSHIP, seq=TRAIN["seq"], attention="flash",
                            compute_dtype="bfloat16", remat="dots",
                            ce_chunk=TRAIN["ce_chunk"])
    batch, steps, lr = TRAIN["batch"], 8, 1e-3        # bench.py:448
    L = cfg.n_layers
    mesh = make_mesh({"dp": 1, "sp": 1, "tp": 1}, device=DEVICE)
    corpus = (np.arange(32_768) * 2654435761 % cfg.vocab).astype(np.int32)
    stream = train_stream(ArraySource(corpus, seed=0), mesh, batch, cfg.seq)
    tokens = next(stream)
    stream.close()
    check(tokens.device.type == DEVICE and tuple(tokens.shape)
          == (batch, cfg.seq), f"batch {tokens.device} {tokens.shape}")
    var_registry.set("ops_flash_bwd_kernel", True)
    params = from_jax_params(params_np, cfg, DEVICE, train=True, mesh=mesh)
    n_params = sum(p.numel() for p in params.values())

    # ---- the first step's loss and gradients: kernels vs plain paths ----
    zero_counts(fa)
    loss_k, grads_k = value_and_grad(cfg, mesh, params, tokens)
    torch.cuda.synchronize()
    first = counts(fa)
    check(first == {"flash_fwd": 2 * L, "flash_bwd_dq": L,
                    "flash_bwd_dkv": L},
          f"launches in one value_and_grad: {first}")
    agree = {}
    for name, cfg_v, kernel in (
            ("xla", dataclasses.replace(cfg, attention="xla"), True),
            ("bwd_kernel_off", cfg, False)):
        var_registry.set("ops_flash_bwd_kernel", kernel)
        before = counts(fa)
        loss_v, grads_v = value_and_grad(cfg_v, mesh, params, tokens)
        after = counts(fa)
        check(after["flash_bwd_dq"] == before["flash_bwd_dq"],
              f"{name}: the dq kernel ran")
        rel = {k: ((grads_v[k].float() - grads_k[k].float()).norm()
                   / grads_k[k].float().norm()).item() for k in grads_k}
        del grads_v
        agree[name] = {"loss": loss_v, "loss_rel_diff":
                       abs(loss_v - loss_k) / abs(loss_k),
                       "grad_rel_l2_max": max(rel.values()),
                       "grad_rel_l2": rel}
        check(agree[name]["loss_rel_diff"] <= TRAIN_LOSS_RTOL,
              f"{name}: first-step loss {loss_v} vs kernels {loss_k}")
        check(agree[name]["grad_rel_l2_max"] <= TRAIN_GRAD_RL2,
              f"{name}: gradient rel L2 {rel}")
    var_registry.set("ops_flash_bwd_kernel", True)
    del grads_k
    unembed = unembed_check(cfg, mesh, params, tokens)

    # ---- the main path: a warm-up step, then an 8-step train loop ----
    step, init_opt = make_train_step(cfg, mesh, lr=lr)
    loop, _ = make_train_loop(cfg, mesh, lr=lr, steps=steps)
    opt_state = init_opt(params)
    params, opt_state, warm_loss = step(params, opt_state, tokens)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    zero_counts(fa)
    a.record()
    params, opt_state, losses = loop(params, opt_state, tokens)
    b.record()
    b.synchronize()
    launches = counts(fa)
    ms = a.elapsed_time(b) / steps
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    losses = losses.cpu().numpy()
    check(losses.shape == (steps,) and bool(np.isfinite(losses).all()),
          f"losses {losses}")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    check(launches == {"flash_fwd": 2 * L * steps,
                       "flash_bwd_dq": L * steps,
                       "flash_bwd_dkv": L * steps},
          f"launches in {steps} steps: {launches}")
    n_tok = batch * cfg.seq
    flops_per_token = 6 * n_params + 12 * L * cfg.d_model * cfg.seq
    tflops = flops_per_token * n_tok / (ms / 1e3) / 1e12
    window = profile_window(lambda: step(params, opt_state, tokens))
    emit("train", config="flagship 468M dense, bench.py MFU widths, flash "
         "forward and backward kernels", n_params=n_params, batch=batch,
         seq=cfg.seq, remat=cfg.remat, ce_chunk=cfg.ce_chunk, lr=lr,
         steps=steps, launches=launches, launches_per_step={
             k: v // steps for k, v in launches.items()},
         first_step_loss=loss_k, first_step_agreement=agree,
         unembed_vs_f32=unembed,
         warmup_loss=float(warm_loss), losses=losses.tolist(),
         step_ms=ms, tokens_per_s=n_tok / (ms / 1e3), model_tflops=tflops,
         mfu=tflops * 1e12 / BF16_FLOPS, peak_mem_gib=peak_gib,
         profiled_step=window, card=card)
    del params, opt_state

    # ---- the step time of the plain attention path and of the recompute
    # backward, from the same parameters ----
    other_ms = {}
    for name, cfg_v, kernel in (
            ("xla", dataclasses.replace(cfg, attention="xla"), True),
            ("bwd_kernel_off", cfg, False)):
        var_registry.set("ops_flash_bwd_kernel", kernel)
        p = from_jax_params(params_np, cfg_v, DEVICE, train=True)
        st, init = make_train_step(cfg_v, mesh, lr=lr)
        other_ms[name] = step_ms(st, p, init(p), tokens, 3)
        del p
    var_registry.set("ops_flash_bwd_kernel", False)
    emit("train_paths", step_ms={"kernels": ms, **other_ms}, card=card)
    return launches


def ring_fwd_bwd(attn, q, k, v, g, sp):
    """Ring attention over the sp blocks of a (B, sp·T, H, D) sequence in
    one process: for each virtual rank ``my``, ``_ring_step`` over its sp
    hops with the other ranks' K/V blocks in turn (src = (my − i) mod
    sp, offsets my·T and src·T, the flash kernels), then the backward
    through every merge with cotangent ``g``.  Each rank's q, k and v
    block is a leaf of its own, as on a rank (a slice of one big leaf
    would add a full-size zero gradient a use).  → (out, dq, dk, dv)."""
    import torch

    T = q.shape[1] // sp
    qs, ks, vs = ([b.detach().clone().requires_grad_(True)
                   for b in x.split(T, dim=1)] for x in (q, k, v))
    outs = []
    for my in range(sp):
        out = lse = None
        for i in range(sp):
            src = (my - i) % sp
            out, lse = attn._ring_step(qs[my], ks[src], vs[src], out, lse,
                                       my * T, src * T, causal=True,
                                       impl="flash")
        outs.append(out.to(q.dtype))
    grads = torch.autograd.grad(outs, qs + ks + vs, g.split(T, dim=1))
    return (torch.cat(outs, dim=1).detach(),
            *(torch.cat(grads[j * sp:(j + 1) * sp], dim=1)
              for j in range(3)))


def ring_plain(fa, q, k, v, g):
    """The plain versions over the full causal sequence on the ring's bf16
    inputs, one sequence at a time: ``attention_plain``'s f32 output and
    ``flash_bwd_recompute``'s dq, dk and dv for cotangent ``g``."""
    import torch

    scale = q.shape[-1] ** -0.5
    outs, grads = [], []
    for b in range(q.shape[0]):
        qb, kb, vb, gb = (x[b:b + 1] for x in (q, k, v, g))
        o, _ = fa.attention_plain(qb, kb, vb, True, 0, 0, scale)
        outs.append(o)
        grads.append(fa.flash_bwd_recompute(qb, kb, vb, o, gb, None, 0, 0,
                                            scale, True))
    return (torch.cat(outs), *(torch.cat([d[j] for d in grads])
                               for j in range(3)))


def row_rel_l2(got, want) -> float:
    """The largest relative L2 error over the rows (sequence, position,
    head) of a (B, T, H, D) output: each row held to its own size, so a
    hop dropped from the late, small rows shows."""
    a, b = got.float(), want.float()
    return ((a - b).norm(dim=-1) / b.norm(dim=-1)).max().item()


def ring_hop_checks(fa, q, k, v, sp, gen):
    """Each of the ring's sp × sp hops through the three kernels at its
    own shape and offsets (my·T, src·T), against their plain versions:
    the forward at BF16_TOL, dq/dk/dv with a random lse cotangent at
    BWD_BF16_TOL of max|ref|.  A fully masked hop (src > my) must give
    O = 0, lse ≤ -1e29 and zero gradients.  → (worst errors, masked)."""
    import torch

    T, D = q.shape[1] // sp, q.shape[-1]
    scale = D ** -0.5
    worst = {"o": 0.0, "lse": 0.0, "dq": 0.0, "dk": 0.0, "dv": 0.0}
    masked = 0
    for my in range(sp):
        qb = q[:, my * T:(my + 1) * T]
        for src in range(sp):
            kb, vb = (x[:, src * T:(src + 1) * T] for x in (k, v))
            offs = (my * T, src * T)
            o, lse = fa.flash_attention_lse(qb, kb, vb, causal=True,
                                            q_offset=offs[0],
                                            k_offset=offs[1])
            ro, rlse = fa.flash_attention_lse_reference(
                qb, kb, vb, causal=True, q_offset=offs[0],
                k_offset=offs[1])
            torch.cuda.synchronize()
            for key, got, want in (("o", o.float(), ro.float()),
                                   ("lse", lse, rlse)):
                err = (got - want).abs().max().item()
                check(torch.allclose(got, want, atol=BF16_TOL,
                                     rtol=BF16_TOL),
                      f"ring hop my={my} src={src}: forward {key} vs plain "
                      f"max err {err}")
                worst[key] = max(worst[key], err)
            if src > my:
                check(bool((o == 0).all()) and bool((lse <= -1e29).all()),
                      f"fully masked hop my={my} src={src}: |O| max "
                      f"{o.abs().max().item()}, lse max {lse.max().item()}")
                masked += 1
            q3, k3, v3, o3 = (fa._to3(x) for x in (qb, kb, vb, o))
            g3 = torch.randn(q3.shape, generator=gen,
                             device=DEVICE).to(q3.dtype)
            g_lse = torch.randn(lse.reshape(-1, T).shape, generator=gen,
                                device=DEVICE)
            dm = (g3.float() * o3.float()).sum(-1) - g_lse
            args = (q3, k3, v3, g3, lse.reshape(-1, T), dm, *offs, scale,
                    True)
            got = fa.flash_bwd_3d(*args)
            want = fa.flash_bwd_reference(*args)
            torch.cuda.synchronize()
            for name, a, b in zip(("dq", "dk", "dv"), got, want):
                ok, err = bwd_err(a, b, torch.bfloat16)
                check(ok and bool(torch.isfinite(a).all()),
                      f"ring hop my={my} src={src}: {name} vs plain max "
                      f"err {err}")
                worst[name] = max(worst[name], err)
    check(masked == sp * (sp - 1) // 2, f"{masked} masked hops")
    return worst, masked


def phase_ring(fa, card):
    """Ring attention's hop-and-merge at full width on the card: the
    forward kernel at q/k offsets it does not see at sp = 1 (6 of the 16
    hops fully masked), the lse merge in f32, and the dq and dk/dv
    kernels with an lse cotangent at every hop.  Each hop's kernels are
    held against their plain versions at the hop's shape and offsets;
    the ring's output and gradients against the plain versions over the
    full sequence (and against one full-sequence flash forward and
    backward, which is timed beside it)."""
    import torch

    from ompi_tpu_torch.core.config import var_registry
    from ompi_tpu_torch.parallel import attention as attn

    B, sp, T = RING["batch"], RING["sp"], RING["block"]
    H, D = RING["heads"], RING["head_dim"]
    S = sp * T
    gen = torch.Generator(device=DEVICE).manual_seed(17)
    q, k, v, g = (torch.randn((B, S, H, D), generator=gen, device=DEVICE)
                  .to(torch.bfloat16) for _ in range(4))
    var_registry.set("ops_flash_bwd_kernel", True)
    zero_counts(fa)
    got = ring_fwd_bwd(attn, q, k, v, g, sp)
    torch.cuda.synchronize()
    launches = counts(fa)
    check(launches == {"flash_fwd": sp * sp, "flash_bwd_dq": sp * sp,
                       "flash_bwd_dkv": sp * sp},
          f"launches on the ring path: {launches}")

    def full_fwd_bwd():
        leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
        out, _ = fa.flash_attention_lse(*leaves, causal=True)
        return (out.detach(), *torch.autograd.grad(out, leaves, g))

    want = full_fwd_bwd()
    plain = ring_plain(fa, q, k, v, g)
    torch.cuda.synchronize()
    finite = all(bool(torch.isfinite(t).all()) for t in got)
    check(finite, "ring attention gave a NaN or Inf")
    ok, out_err = bwd_err(got[0], want[0], torch.bfloat16)
    check(ok, f"ring output vs the full-sequence kernel: max err {out_err}")
    rel = {name: ((a.float() - b.float()).norm() / b.float().norm()).item()
           for name, a, b in zip(("dq", "dk", "dv"), got[1:], want[1:])}
    check(max(rel.values()) <= TRAIN_GRAD_RL2,
          f"ring gradients vs the full-sequence kernels: rel L2 {rel}")
    vs_plain = {}
    for who, res in (("ring", got), ("full_sequence", want)):
        row = row_rel_l2(res[0], plain[0])
        check(row <= RING_ROW_RL2,
              f"{who} output vs plain: row relative L2 {row}")
        grel = {name: ((a.float() - b.float()).norm()
                       / b.float().norm()).item()
                for name, a, b in zip(("dq", "dk", "dv"), res[1:],
                                      plain[1:])}
        check(max(grel.values()) <= TRAIN_GRAD_RL2,
              f"{who} gradients vs plain: rel L2 {grel}")
        vs_plain[who] = {"out_row_rel_l2_max": row, "grad_rel_l2": grel}
    del plain
    hop_err, masked = ring_hop_checks(fa, q, k, v, sp, gen)
    ring_ms = cuda_ms(lambda: ring_fwd_bwd(attn, q, k, v, g, sp), iters=5,
                      warmup=1)
    full_ms = cuda_ms(full_fwd_bwd, iters=5, warmup=1)
    window = profile_window(lambda: ring_fwd_bwd(attn, q, k, v, g, sp))
    var_registry.set("ops_flash_bwd_kernel", False)
    emit("ring", shape=[B, S, H, D], sp=sp, block=T, dtype="bfloat16",
         causal=True, launches=launches, masked_hops=masked,
         out_max_abs_err=out_err, out_tol=BWD_BF16_TOL,
         grad_rel_l2=rel, grad_rl2=TRAIN_GRAD_RL2, finite=finite,
         vs_plain=vs_plain, row_rl2=RING_ROW_RL2,
         hop_vs_plain_max_abs_err=hop_err, hop_fwd_tol=BF16_TOL,
         hop_bwd_tol=BWD_BF16_TOL,
         ring_fwd_bwd_ms=ring_ms, full_sequence_fwd_bwd_ms=full_ms,
         profiled_ring=window,
         note="one process drives all sp virtual ranks' hops in turn, so "
         "the time is the sum over the ranks; no exchange is timed",
         card=card)
    return launches


def phase_train_small(fa, moe: bool = False):
    import torch

    from ompi_tpu_torch.core.config import var_registry
    from ompi_tpu_torch.models.transformer import (TransformerConfig,
                                                   init_params,
                                                   make_train_step)
    from ompi_tpu_torch.models.weights import from_jax_params
    from ompi_tpu_torch.parallel.mesh import make_mesh

    # tests/parallel/test_mesh_model.py:34-36 (the MoE family's:
    # test_moe_model.py:15-17, 8 experts), with the flash kernels
    cfg = TransformerConfig(vocab=128, d_model=64, n_heads=4, n_layers=2,
                            d_ff=128, seq=32, attention="flash",
                            compute_dtype="float32",
                            **(dict(moe_experts=8, remat=False) if moe
                               else {}))
    params_np = init_params(cfg, seed=0)
    tokens = np.random.default_rng(1).integers(
        0, cfg.vocab, size=(4, cfg.seq)).astype(np.int32)
    var_registry.set("ops_flash_bwd_kernel", True)
    res = {}
    for dev in (DEVICE, "cpu"):
        mesh = make_mesh({"dp": 1, "sp": 1, "tp": 1}, device=dev)
        before = counts(fa)
        loss, grads = value_and_grad(
            cfg, mesh, from_jax_params(params_np, cfg, dev, train=True),
            tokens)
        ran = {k: v - before[k] for k, v in counts(fa).items()}
        step, init_opt = make_train_step(cfg, mesh, lr=1e-2)
        params = from_jax_params(params_np, cfg, dev, train=True)
        opt_state = init_opt(params)
        losses = []
        for _ in range(3):
            params, opt_state, l_ = step(params, opt_state, tokens)
            losses.append(l_.item())
        res[dev] = (loss, {k: g.cpu() for k, g in grads.items()}, losses,
                    ran)
    var_registry.set("ops_flash_bwd_kernel", False)
    (l_gpu, g_gpu, s_gpu, ran_gpu), (l_cpu, g_cpu, s_cpu, ran_cpu) = (
        res[DEVICE], res["cpu"])
    check(all(v > 0 for v in ran_gpu.values()),
          f"the card's step ran no kernel: {ran_gpu}")
    check(not any(ran_cpu.values()), f"the CPU run launched: {ran_cpu}")
    check(abs(l_gpu - l_cpu) <= SMALL_TOL * abs(l_cpu),
          f"first-step loss {l_gpu} on the card vs {l_cpu} on the CPU")
    worst = 0.0
    for k in g_cpu:
        err = (g_gpu[k] - g_cpu[k]).abs()
        worst = max(worst, err.max().item())
        check(bool((err <= SMALL_TOL * (g_cpu[k].abs()
                                        + g_cpu[k].abs().max())).all()),
              f"grad {k}: card vs CPU max err {err.max().item()}")
    check(np.allclose(s_gpu, s_cpu, rtol=SMALL_TOL, atol=0),
          f"three steps: card {s_gpu} vs CPU {s_cpu}")
    check(s_gpu[-1] < s_gpu[0], f"loss did not fall: {s_gpu}")
    emit("moe_small" if moe else "train_small",
         config=("tests/parallel/test_moe_model.py CFG" if moe else
                 "tests/parallel/test_mesh_model.py CFG")
         + ", flash, f32, bwd kernels on", loss_card=l_gpu, loss_cpu=l_cpu,
         grad_max_abs_err=worst, losses_card=s_gpu, losses_cpu=s_cpu,
         launches_card=ran_gpu, tol=SMALL_TOL)


# ---------------------------------------------------------------------------
# the MoE family
# ---------------------------------------------------------------------------

def phase_moe_layer(card, moe_np):
    """One full-width bf16 MoE layer (the training batch's 16 × 1024
    tokens of 2048, layer 0's gate and 8 experts in f32 as training holds
    them): the index dispatch and combine against the one-hot einsum
    plain version, forward and backward, bit for bit, with the routing
    of both recorded; then each part timed."""
    import torch

    from ompi_tpu_torch.mpi.device_comm import DeviceCommunicator
    from ompi_tpu_torch.parallel import moe as M
    from ompi_tpu_torch.parallel.mesh import make_mesh

    B, T, D = TRAIN["batch"], TRAIN["seq"], FLAGSHIP["d_model"]
    E, F = MOE["moe_experts"], FLAGSHIP["d_ff"]
    comm = DeviceCommunicator(make_mesh({"ep": 1}, device=DEVICE), ("ep",))
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(0)
    x = torch.randn((B, T, D), generator=gen, device=DEVICE).to(
        torch.bfloat16)
    g = torch.randn((B, T, D), generator=gen, device=DEVICE).to(
        torch.bfloat16)
    p = {k: torch.from_numpy(moe_np[k][0]).to(DEVICE) for k in
         ("wg", "w1", "w2")}
    n_tok = B * T
    C = M.capacity_for(n_tok, E, MOE["moe_capacity_factor"])

    def layer(onehot):
        xl = x.detach().requires_grad_(True)
        pl = {k: v.detach().requires_grad_(True) for k, v in p.items()}
        with M.recording() as rec:
            y, aux = M.switch_moe(comm, xl, pl, with_aux=True,
                                  onehot=onehot)
        grads = torch.autograd.grad((y * g).sum() + aux,
                                    [xl, pl["wg"], pl["w1"], pl["w2"]])
        return y.detach(), aux.detach(), grads, rec[0]

    y_i, aux_i, g_i, rec_i = layer(False)
    y_o, aux_o, g_o, rec_o = layer(True)
    torch.cuda.synchronize()
    check(torch.equal(rec_i["load"], rec_o["load"]),
          "the two forms routed differently")
    check(bool(torch.isfinite(y_i.float()).all()), "non-finite MoE output")
    same = {"y": torch.equal(y_i, y_o), "aux": torch.equal(aux_i, aux_o)}
    for name, a, b in zip(("x", "wg", "w1", "w2"), g_i, g_o):
        same[f"grad_{name}"] = torch.equal(a, b)
    check(all(same.values()), f"index vs one-hot differ: {same}")
    routing = routing_stats([rec_i])
    del y_o, g_o, g_i

    # each part alone, then the layer, in both forms
    xf = x.reshape(n_tok, D)
    r = M.route(xf, p["wg"], C)
    send = M.dispatch(xf, r)
    recv = send.reshape(1, E, C, D)
    w1, w2 = p["w1"].to(torch.bfloat16), p["w2"].to(torch.bfloat16)
    out = M.expert_ffn(recv, w1, w2).reshape(E, C, D)
    ms = {
        "route": cuda_ms(lambda: M.route(xf, p["wg"], C)),
        "dispatch_index": cuda_ms(lambda: M.dispatch(xf, r)),
        "dispatch_onehot": cuda_ms(lambda: M.dispatch_onehot(xf, r),
                                   iters=5),
        "combine_index": cuda_ms(lambda: M.combine(out, r)),
        "combine_onehot": cuda_ms(lambda: M.combine_onehot(out, r),
                                  iters=5),
        "expert_ffn": cuda_ms(lambda: M.expert_ffn(recv, w1, w2), iters=5),
        "layer_fwd_bwd_index": cuda_ms(lambda: layer(False), iters=3,
                                       warmup=1),
        "layer_fwd_bwd_onehot": cuda_ms(lambda: layer(True), iters=3,
                                        warmup=1),
    }
    # least times: dispatch and combine move n_tok + E·C rows of D bf16
    # (each read once, each written once); the expert FFN's two products
    # over the E·C slots, capacity padding included
    moved = (n_tok + E * C) * D * 2
    ffn_flops = 2 * 2 * E * C * D * F
    emit("moe_layer", shape=[B, T, D], experts=E, capacity=C,
         dtype="bfloat16", bitwise_equal=same, routing=routing,
         aux=aux_i.item(), ms=ms,
         bound_ms={"dispatch": bound(moved, 0, BF16_FLOPS)[0],
                   "combine": bound(moved, 0, BF16_FLOPS)[0],
                   "expert_ffn": bound(
                       (E * C * D * 2 + 2 * E * D * F) * 2, ffn_flops,
                       BF16_FLOPS)[0]},
         card=card)


def phase_moe_train(fa, card, moe_np):
    """The MoE family at the flagship's widths training 8 steps at world
    size 1 (the ep exchange elided), as phase train: the first step's
    loss and every gradient leaf against the plain-attention path, the
    launch counts of an 8-step loop, step time, tokens/s, MFU by the
    ACTIVE parameters, peak memory and a profiled step split by part."""
    import torch

    from ompi_tpu_torch.core.config import var_registry
    from ompi_tpu_torch.models.data import ArraySource, train_stream
    from ompi_tpu_torch.models.transformer import (TransformerConfig,
                                                   make_train_loop,
                                                   make_train_step)
    from ompi_tpu_torch.models.weights import from_jax_params
    from ompi_tpu_torch.parallel import moe as moe_mod
    from ompi_tpu_torch.parallel.mesh import make_mesh

    cfg = TransformerConfig(**moe_fields(), seq=TRAIN["seq"],
                            attention="flash", compute_dtype="bfloat16",
                            remat="dots", ce_chunk=TRAIN["ce_chunk"])
    batch, steps, lr = TRAIN["batch"], 8, 1e-3
    L, D, E = cfg.n_layers, cfg.d_model, cfg.moe_experts
    mesh = make_mesh({"dp": 1, "sp": 1, "tp": 1}, device=DEVICE)
    corpus = (np.arange(32_768) * 2654435761 % cfg.vocab).astype(np.int32)
    stream = train_stream(ArraySource(corpus, seed=0), mesh, batch, cfg.seq)
    tokens = next(stream)
    stream.close()
    var_registry.set("ops_flash_bwd_kernel", True)
    torch.cuda.empty_cache()
    params = from_jax_params(moe_np, cfg, DEVICE, train=True, mesh=mesh)
    n_params = sum(p.numel() for p in params.values())
    n_expert = params["w1"].numel() + params["w2"].numel()
    n_active = n_params - n_expert + n_expert // E

    # ---- the first step's loss and gradients: kernels vs plain path,
    # the plain path routed as the kernels' (its recompute calls too) ----
    zero_counts(fa)
    with moe_mod.recording() as routes:
        loss_k, grads_k = value_and_grad(cfg, mesh, params, tokens)
    torch.cuda.synchronize()
    first = counts(fa)
    check(first == {"flash_fwd": 2 * L, "flash_bwd_dq": L,
                    "flash_bwd_dkv": L},
          f"launches in one value_and_grad: {first}")
    check(all(bool(torch.isfinite(g).all()) for g in grads_k.values()),
          "non-finite first-step gradient")
    routing = routing_stats(routes[:L])
    with moe_mod.replaying(routes):
        loss_x, grads_x = value_and_grad(
            dataclasses.replace(cfg, attention="xla"), mesh, params, tokens)
    del routes
    rel = {k: ((grads_x[k].float() - grads_k[k].float()).norm()
               / grads_k[k].float().norm()).item() for k in grads_k}
    del grads_x, grads_k
    agree = {"loss": loss_x, "loss_rel_diff": abs(loss_x - loss_k)
             / abs(loss_k), "grad_rel_l2_max": max(rel.values()),
             "grad_rel_l2": rel, "routing": "replayed from the kernels' path"}
    check(agree["loss_rel_diff"] <= TRAIN_LOSS_RTOL,
          f"xla: first-step loss {loss_x} vs kernels {loss_k}")
    check(agree["grad_rel_l2_max"] <= TRAIN_GRAD_RL2,
          f"xla: gradient rel L2 {rel}")

    # ---- the main path: a warm-up step, then an 8-step train loop ----
    step, init_opt = make_train_step(cfg, mesh, lr=lr)
    loop, _ = make_train_loop(cfg, mesh, lr=lr, steps=steps)
    opt_state = init_opt(params)
    params, opt_state, warm_loss = step(params, opt_state, tokens)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    zero_counts(fa)
    a.record()
    params, opt_state, losses = loop(params, opt_state, tokens)
    b.record()
    b.synchronize()
    launches = counts(fa)
    ms = a.elapsed_time(b) / steps
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    losses = losses.cpu().numpy()
    check(losses.shape == (steps,) and bool(np.isfinite(losses).all()),
          f"losses {losses}")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    check(launches == {"flash_fwd": 2 * L * steps,
                       "flash_bwd_dq": L * steps,
                       "flash_bwd_dkv": L * steps},
          f"launches in {steps} steps: {launches}")
    n_tok = batch * cfg.seq
    flops_per_token = 6 * n_active + 12 * L * D * cfg.seq
    tflops = flops_per_token * n_tok / (ms / 1e3) / 1e12
    window = profile_window(lambda: step(params, opt_state, tokens),
                            moe=True)
    var_registry.set("ops_flash_bwd_kernel", False)
    emit("moe_train", config=f"flagship MoE 8 experts at {L} of its 8 "
         f"layers ({n_params / 1e6:.0f}M, {n_active / 1e6:.0f}M active), "
         f"bench.py MFU widths, flash forward and backward kernels",
         n_params=n_params, n_active=n_active, batch=batch, seq=cfg.seq,
         remat=cfg.remat, ce_chunk=cfg.ce_chunk, lr=lr, steps=steps,
         launches=launches, launches_per_step={
             k: v // steps for k, v in launches.items()},
         first_step_loss=loss_k, first_step_agreement={"xla": agree},
         first_step_routing=routing,
         warmup_loss=float(warm_loss), losses=losses.tolist(),
         step_ms=ms, tokens_per_s=n_tok / (ms / 1e3), model_tflops=tflops,
         mfu_active=tflops * 1e12 / BF16_FLOPS, peak_mem_gib=peak_gib,
         profiled_step=window, card=card)
    del params, opt_state
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# one-sided RMA (kernels #4-#6) and the device collectives
# ---------------------------------------------------------------------------

def rma_bound_ms(kind: str, nbytes: int, n: int = RMA_RANKS) -> float:
    """Least time of one copy on one card: put and get read and write B
    bytes of the same HBM (2B), a root's push reads B and writes (n-1)B."""
    moved = 2 * nbytes if kind != "bcast" else n * nbytes
    return moved / HBM_BYTES_PER_S * 1e3


def same_bytes(a, b) -> bool:
    """Bitwise equality (NaN bit patterns included)."""
    import torch

    return a.shape == b.shape and torch.equal(
        a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8))


def phase_rma_kernel(rd, card):
    """The three copy kernels at kernel level in one process, on local
    buffers with their flag words (ready released beforehand), against
    copy_plain, bitwise; times at 64 and 256 MiB and at 4 KiB."""
    import torch

    dev = torch.device(DEVICE)
    g = torch.Generator(device=DEVICE).manual_seed(3)
    flags = torch.zeros(4, dtype=torch.int64, device=dev)
    ready, done, status, counter = (flags[i:i + 1] for i in range(4))
    ready.fill_(1 << 62)            # every wait passes at once
    sync = rd.Sync(wait=[ready], release=[done], counter=counter,
                   status=status)
    calls = {"put": lambda ls, s, y=sync: rd.put_kernel(ls[0], s, y),
             "get": lambda ls, s, y=sync: rd.get_kernel(ls[0], s, y),
             "bcast": lambda ls, s, y=sync: rd.bcast_kernel(ls, s, y)}
    n_land = {"put": 1, "get": 1, "bcast": RMA_RANKS - 1}

    def check_case(kind, src, lands, what) -> float:
        """Run the kernel once, hold it bitwise against copy_plain; the
        max abs difference (0 when equal; NaN-free inputs only)."""
        sync.seq += 1
        calls[kind](lands, src)
        want = [torch.empty_like(t) for t in lands]
        rd.copy_plain(want, src)
        torch.cuda.synchronize()
        check(all(same_bytes(a, b) for a, b in zip(lands, want)),
              f"{kind} kernel disagrees with copy_plain: {what}")
        check(int(done.item()) == sync.seq and int(status.item()) == 0,
              f"{kind} kernel flags: done {int(done.item())} want "
              f"{sync.seq}, status {int(status.item())}")
        return max(((a.double() - b.double()).abs().max().item()
                    if a.numel() else 0.0) for a, b in zip(lands, want))

    cases = 0
    for dtype in (torch.float32, torch.bfloat16, torch.int32):
        for nbytes in RMA_SIZES:
            numel = nbytes // torch.empty((), dtype=dtype).element_size()
            src = torch.randint(-2**31, 2**31 - 1, (nbytes // 4,),
                                dtype=torch.int32, generator=g,
                                device=dev).view(dtype)[:numel]
            for kind in calls:
                lands = [torch.empty_like(src) for _ in range(n_land[kind])]
                check_case(kind, src, lands, f"{dtype} {nbytes} bytes")
                cases += 1
                del lands
            del src
    # a ragged (7, 129) f32 shard, byte offsets 16 bytes do not divide (the
    # byte path), 16-byte-aligned offsets 128 does not divide with sizes
    # that fill no ring stage or block range evenly (the bulk ring and its
    # tail), and an empty copy
    ragged = torch.randn((7, 129), generator=g, device=dev)
    base = torch.randint(0, 256, ((64 << 20) + 128,), dtype=torch.uint8,
                         generator=g, device=dev)
    for kind in calls:
        lands = [torch.empty_like(ragged) for _ in range(n_land[kind])]
        check_case(kind, ragged, lands, "ragged (7, 129) f32")
        cases += 1
        for s_off, l_off, nbytes in RMA_OFFSET_CASES:
            src = base[s_off:s_off + nbytes]
            lands = [torch.zeros(nbytes + 64, dtype=torch.uint8,
                                 device=dev)[l_off:l_off + nbytes]
                     for _ in range(n_land[kind])]
            check_case(kind, src, lands,
                       f"offsets {s_off}/{l_off}, {nbytes} bytes")
            cases += 1
            del lands
    del base

    timed = {}
    for nbytes in (RMA_SIZES[0], RMA_TIMED, RMA_SIZES[-1]):
        src = torch.randn((nbytes // 4,), generator=g, device=dev)
        for kind in calls:
            lands = [torch.empty_like(src) for _ in range(n_land[kind])]
            # 4 KiB calls are host-bound: more of them steady the rate
            reps = (dict(iters=200, warmup=20) if nbytes == RMA_SIZES[0]
                    else {})
            ms = cuda_ms(lambda: calls[kind](lands, src), **reps)
            plain_ms = cuda_ms(lambda: rd.copy_plain(lands, src), **reps)
            library_ms = cuda_ms(lambda: [t.copy_(src) for t in lands],
                                 **reps)
            err = check_case(kind, src, lands, f"timed f32 {nbytes} bytes")
            bound = rma_bound_ms(kind, nbytes)
            row = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                   "library_ms": library_ms, "bound_ms": bound,
                   "bound_by": "bytes",
                   "gbps": n_land[kind] * nbytes / ms / 1e6,
                   "bound_share": bound / ms}
            if nbytes == RMA_SIZES[0]:
                # the call rate above is the host's; this is the card's
                row["device_ms"] = kernel_device_ms(
                    lambda: calls[kind](lands, src), f"rma_{kind}_kernel")
            elif nbytes == RMA_TIMED and kind != "bcast":
                row["no_handshake_ms"] = cuda_ms(
                    lambda: calls[kind](lands, src, rd.Sync()))
            timed.setdefault(kind, {})[nbytes] = row
            del lands
        del src
    out = {}
    for kind in calls:
        at = timed[kind]
        out[kind] = {**at[RMA_TIMED],
                     "bytes": RMA_TIMED,
                     "at_256MiB": at[RMA_SIZES[-1]],
                     "latency_4KiB_ms": at[RMA_SIZES[0]]["ms"],
                     "device_4KiB_ms": at[RMA_SIZES[0]]["device_ms"]}
    emit("rma_kernel", cases=cases, sizes=list(RMA_SIZES),
         dtypes=["float32", "bfloat16", "int32"], bitwise_equal=True,
         bcast_peers=RMA_RANKS - 1, timed=timed,
         library_note="Tensor.copy_ (cudaMemcpyAsync) for the same bytes, "
         "n-1 of them for bcast; the plain version is the same call",
         card=card)
    return out


HOST_RING_NP = 4
HOST_PINGPONG = (8, 4 << 10, 1 << 20, 64 << 20)
HOST_PINGPONG_EAGER = 4096      # 1 MiB and 64 MiB go rendezvous
HOST_COLL_MIB = 64
# the arena's payload cap for the 64 MiB collectives (the default, 4 MiB,
# sends them to coll/host); the arena itself stays p + 1 slots of 256 KiB
HOST_ARENA_CAP = "64M"
HOST_RING_BYTES = 4 << 20       # btl_shm_ring_size's default


def ring_lines(np_: int, tag: str = "1") -> list[str]:
    """The lines the repo's ``examples/ring.py`` prints at ``np_`` ranks
    (the port's ``examples/ring.py`` must print the same), tagged and
    sorted as the launcher's output is compared (``[<jobid>,<rank>]`` from
    the local launcher, ``[mh,<rank>]`` up the daemon tree)."""
    out = [(0, f"Process 0 sending 10 to 1, tag 201 ({np_} processes in "
               "ring)"), (0, "Process 0 sent to 1")]
    out += [(0, f"Process 0 decremented value: {v}") for v in range(9, -1, -1)]
    out += [(r, f"Process {r} exiting") for r in range(np_)]
    return sorted(f"[{tag},{r}]{line}" for r, line in out)


HOST_JOB_TIMEOUT = 180          # tpurun --timeout of every job (exit 124)
_HOST_JOBS: list = []


def tpurun_start(args):
    """Start one job of the port's launcher, as a user runs it; its own
    ``--timeout`` kills its ranks and exits 124 if it hangs.  A thread
    reads its output and notes when it ended, so a job that ends while
    another is awaited keeps its own wall time."""
    t0 = time.perf_counter()
    p = subprocess.Popen(
        [sys.executable, "-m", "ompi_tpu_torch.tools.tpurun", "--timeout",
         str(HOST_JOB_TIMEOUT), *args],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    done: dict = {}

    def reap():
        done["out"], done["err"] = p.communicate()
        done["secs"] = time.perf_counter() - t0

    job = (threading.Thread(target=reap, daemon=True), p, done)
    job[0].start()
    _HOST_JOBS.append(job)
    return job


def tpurun_wait(job):
    """(wall seconds from launch to exit, rc, stdout, stderr) of a job
    from ``tpurun_start``."""
    reaper, p, done = job
    reaper.join()
    return done["secs"], p.returncode, done["out"], done["err"]


def tpurun(args):
    return tpurun_wait(tpurun_start(args))


def tagged_json(out: str, tag: str) -> list[dict]:
    """The ``<tag> {json}`` lines of a job's output (tags stripped)."""
    rows = []
    for line in out.splitlines():
        line = line.split("]", 1)[1] if line.startswith("[") else line
        if line.startswith(tag + " "):
            rows.append(json.loads(line[len(tag) + 1:]))
    return rows


def phase_host_plane(card):
    """The host process mode through the port's launcher: (a) ring and
    hello at -np 4 against the reference programs' lines; (b) ping-pong
    between two launched ranks over the shm rings, over tcp and over the
    rings without the native executors, and over proc between two ranks
    on threads of one process; (c) the collectives at -np 4 on 64 MiB a
    rank through the coll/shm arena and through coll/host, bitwise
    against numpy, each forced allreduce algorithm once; (d) a --gpu
    rank on the card: both routes of one communicator; (e) two --gpu
    ranks sharing the card: the device route refuses, the host route
    runs over the rings and the arena; (f) init() and a hello job's wall
    times."""
    try:
        return _host_plane_jobs(card)
    finally:
        # a failed check leaves no job behind: each ends by itself or at
        # its --timeout
        for reaper, _, _ in _HOST_JOBS:
            reaper.join()
        _HOST_JOBS.clear()


def _host_plane_jobs(card):
    from ompi_tpu_torch.core import shmseg
    from ompi_tpu_torch.tools import host_bench

    out = {"card": card}
    jobs = {}
    # the jobs that check results only run side by side: (a)'s ring,
    # (d) one --gpu rank and (e) two --gpu ranks on the one card
    ring = tpurun_start(["-np", str(HOST_RING_NP), "--", sys.executable,
                         "-m", "ompi_tpu_torch.examples.ring"])
    gpu1 = tpurun_start(["-np", "1", "--gpu", "--no-tag-output", "--",
                         sys.executable, "-m",
                         "ompi_tpu_torch.examples.device_allreduce"])
    gpu2 = tpurun_start(["-np", "2", "--gpu", "--no-tag-output", "--",
                         sys.executable, "-m",
                         "ompi_tpu_torch.examples.device_allreduce",
                         "--mib", "1"])
    # (a) the example programs
    secs, rc, stdout, stderr = tpurun_wait(ring)
    check(rc == 0, f"host_plane ring: rc {rc}\n{stderr[-2000:]}")
    got = sorted(ln for ln in stdout.splitlines() if ln.strip())
    check(got == ring_lines(HOST_RING_NP),
          f"host_plane ring: lines differ from the reference's: {got}")
    jobs["ring_s"] = secs
    # (d) one --gpu rank on the card: both routes
    secs, rc, stdout, stderr = tpurun_wait(gpu1)
    check(rc == 0, f"host_plane --gpu -np 1: rc {rc}\n{stderr[-2000:]}")
    (one,) = tagged_json(stdout, "device_allreduce")
    check(one["chip"] == "0" and one["current_device"] == 0,
          f"host_plane --gpu: rank not bound to card 0: {one}")
    check(one["group_size"] == 1 and one["provider"] == "xla",
          f"host_plane --gpu: process group / route: {one}")
    check(one["device_error"] is None and one["device_equal"]
          and one["device_host_copies"] == 0 and one["bytes"] == 64 << 20,
          f"host_plane --gpu: comm.allreduce vs the direct call: {one}")
    check(one["host_equal"], f"host_plane --gpu: host allreduce: {one}")
    jobs["gpu_np1_s"] = secs
    out["gpu_np1"] = one
    # (e) two --gpu ranks on the one card
    secs, rc, stdout, stderr = tpurun_wait(gpu2)
    check(rc == 0, f"host_plane --gpu -np 2: rc {rc}\n{stderr[-2000:]}")
    two = tagged_json(stdout, "device_allreduce")
    check(len(two) == 2 and {r["chip"] for r in two} == {"0"}
          and {r["current_device"] for r in two} == {0},
          f"host_plane --gpu -np 2: both ranks bind card 0: {two}")
    for r in two:
        check(r["device_error"] is not None
              and "share a card" in r["device_error"]
              and "NCCL refuses two ranks" in r["device_error"],
              f"host_plane --gpu -np 2: no shared-card refusal: {r}")
        check(r["host_equal"] and r["group_size"] == 2,
              f"host_plane --gpu -np 2: the host route failed: {r}")
        check(r["host_route"] == "shm" and r["host_provider"] == "shm"
              and r["host_mode"] == "arena",
              f"host_plane --gpu -np 2: the host route is not the shm "
              f"rings and the arena: {r}")
    jobs["gpu_np2_s"] = secs
    out["gpu_np2"] = {"chips": [r["chip"] for r in two],
                      "device_error": two[0]["device_error"],
                      "host_equal": True, "host_route": "shm",
                      "host_mode": "arena"}
    # (a, f) hello, alone: its launch-to-exit time
    secs, rc, stdout, stderr = tpurun(["-np", "4", "--", sys.executable,
                                       "-m", "ompi_tpu_torch.examples.hello"])
    got = sorted(ln for ln in stdout.splitlines() if ln.strip())
    check(rc == 0 and got == [
        f"[1,{r}]Hello, world, I am {r} of 4" for r in range(4)],
        f"host_plane hello: rc {rc}, lines {got}")
    jobs["hello_launch_to_exit_s"] = secs
    out["examples"] = {"ring_lines": len(ring_lines(HOST_RING_NP)),
                       "hello_lines": 4, "equal": True}
    # (b, c) -np 4 jobs of tools/host_bench.py, one after the other:
    # ping-pong between ranks 0 and 1 over the shm rings with the
    # collectives through the arena (the default selection), the same
    # ping-pong over tcp and over shm without the native executors, and
    # the collectives through coll/host.  A 4-rank job holds up to 12
    # rings; on a small /dev/shm (a full tmpfs raises SIGBUS on a mapped
    # write) the rings shrink to fit, and the run records their size.
    st = os.statvfs(shmseg.backing_dir())
    free = st.f_frsize * st.f_bavail
    ring = HOST_RING_BYTES
    while ring > (256 << 10) and 12 * ring + (16 << 20) > free:
        ring //= 2
    out["shm"] = {"dir": shmseg.backing_dir(), "free_bytes": free,
                  "ring_bytes": ring}
    sizes = ",".join(map(str, HOST_PINGPONG))
    base = ["-np", "4", "--no-tag-output", "--mca", "pml_eager_limit",
            str(HOST_PINGPONG_EAGER), "--mca", "btl_shm_ring_size",
            str(ring)]
    bench = "ompi_tpu_torch.tools.host_bench"
    runs = {
        "shm": base + ["--mca", "coll_shm_arena_size", HOST_ARENA_CAP, "--",
                       sys.executable, "-m", bench, "--sizes", sizes,
                       "--mib", str(HOST_COLL_MIB)],
        "tcp": base + ["--mca", "btl", "self,tcp", "--", sys.executable,
                       "-m", bench, "--sizes", sizes, "--mib", "0"],
        "shm_no_native": base + ["-x", "OMPI_TPU_NO_NATIVE=1", "--",
                                 sys.executable, "-m", bench, "--sizes",
                                 sizes, "--mib", "0"],
        "coll_host": base + ["--mca", "coll_shm_enable", "0", "--",
                             sys.executable, "-m", bench, "--sizes", "",
                             "--mib", str(HOST_COLL_MIB)],
    }
    res = {}
    for label, args in runs.items():
        secs, rc, stdout, stderr = tpurun(args)
        check(rc == 0, f"host_plane host_bench {label}: rc {rc}\n"
              f"{stderr[-2000:]}")
        res[label] = tagged_json(stdout, "host_bench")[0]
        jobs[f"host_bench_{label}_s"] = secs
    natives = {label: r["native"] for label, r in res.items()}
    for label in ("shm", "tcp", "coll_host"):
        check(all(natives[label].values()),
              f"host_plane {label}: a native executor is off: {natives}")
    check(not any(natives["shm_no_native"].values()),
          f"host_plane OMPI_TPU_NO_NATIVE=1: an executor loaded: {natives}")
    out["native"] = natives
    # (b) ping-pong between two ranks on threads of this process
    t0 = time.perf_counter()
    proc = {"transport": "proc",
            "rows": host_bench._proc_pingpong(list(HOST_PINGPONG))}
    jobs["pingpong_proc_s"] = time.perf_counter() - t0
    out["pingpong"] = {}
    for label, want in (("shm", "shm"), ("tcp", "tcp"),
                        ("shm_no_native", "shm"), ("proc", "proc")):
        r = proc if label == "proc" else res[label]
        check(r["transport"] == want, f"host_plane pingpong {label}: rank "
              f"0 reached rank 1 over {r['transport']}, not {want}")
        for row in r["rows"]:
            check(row["bitwise"], f"host_plane pingpong {label} "
                  f"{row['bytes']} B: the data came back changed")
        check([row["protocol"] for row in r["rows"]]
              == ["eager", "eager", "rendezvous", "rendezvous"],
              "host_plane pingpong: pml_eager_limit did not reach the ranks")
        out["pingpong"][label] = [
            {k: row[k] for k in ("bytes", "protocol", "half_rtt_us", "gb_s",
                                 "half_rtt_us_blocks", "round_trips")}
            for row in r["rows"]]
    # (c) the collectives at -np 4, 64 MiB a rank: through the arena
    # (allreduce and bcast pipeline through its slot halves; the rest of
    # coll/shm's slots take coll/host past one 256 KiB slot, as do the
    # forced host algorithms) and through coll/host
    for label in ("shm", "coll_host"):
        calls = res[label]["calls"]
        check(len(calls) == 16, f"host_plane coll {label}: calls missing")
        for c in calls:
            check(c["bitwise"], f"host_plane coll {label} {c['coll']} "
                  f"{c['dtype']}: differs from numpy")
            want = "shm" if label == "shm" else "host"
            check(c["provider"] == want, f"host_plane coll {label}: "
                  f"{c['coll']} served by {c['provider']}, not {want}")
            if label == "shm" and c["coll"] in ("allreduce", "bcast"):
                check(c["path"] == "arena", f"host_plane coll: "
                      f"{c['coll']} {c['dtype']} did not ride the arena")
            if label == "coll_host":
                check(c["path"] == "host", f"host_plane coll_host: "
                      f"{c['coll']} rode an arena")
    out["coll"] = {"bytes_per_rank": res["shm"]["bytes_per_rank"],
                   "ranks": 4, "arena_cap": HOST_ARENA_CAP,
                   "shm": res["shm"]["calls"],
                   "host": res["coll_host"]["calls"]}
    bench = res["shm"]
    # (f) init() at -np 4, each rank's
    out["init_s_np4"] = bench["init_s"]
    out["job_wall_s"] = jobs
    emit("host_plane", **out)
    return out


#: a rank's size (64 MiB, the host_plane phase's, until phase tools had
#: to be paid for: job (b)'s nbc schedules took 32 s of the phase's 85)
NBC_MIB = 16
NBC_PART_MIB = 1                 # a part of the v and w forms, topologies
NBC_ARENA_CAP = NBC_MIB << 20    # coll_shm_arena_size of job (a)
NBC_PLAN_SLOTS = 10              # a 4-rank allreduce plan: 2 parities × 5


def phase_host_nbc(card):
    """Nonblocking, persistent and partitioned operations and the
    topologies through the port's launcher: (a) one -np 4 job of
    tools/host_bench.py --nbc with the arena at ``NBC_MIB`` (16 MiB):
    every i* collective at 16 MiB a rank against its blocking call,
    allreduce_init started 16 times (provider shm) with µs per
    start+wait beside the one-shot allreduce at 4 KiB and 16 MiB, every
    other *_init once,
    send_init/recv_init against isend/irecv, psend/precv in 8
    partitions, a periodic 2×2 cart's neighbor collectives and the halo
    exchange; (b) the persistent allreduce with coll/shm off (provider
    nbc); (c) -np 2 --gpu: an iallreduce of host memory overlapped with
    bf16 GEMMs on the card, and the refusal of a CUDA tensor by
    iallreduce, allreduce_init, psend_init and neighbor_alltoall with no
    device-to-host copy beside the control.  Every result bitwise."""
    try:
        return _host_nbc_jobs(card)
    finally:
        for reaper, _, _ in _HOST_JOBS:
            reaper.join()
        _HOST_JOBS.clear()


def _host_nbc_jobs(card):
    from ompi_tpu_torch.core import shmseg

    out = {"card": card}
    jobs = {}
    # an allreduce plan pins 2 parities × 5 slots of its size of
    # /dev/shm beside the 12 rings of a 4-rank job: shrink the rings, then
    # the plan's size and the arena cap with it, on a small tmpfs
    st = os.statvfs(shmseg.backing_dir())
    free = st.f_frsize * st.f_bavail
    ring = HOST_RING_BYTES
    while ring > (256 << 10) and 12 * ring + (16 << 20) > free // 2:
        ring //= 2
    cap = NBC_ARENA_CAP
    while cap > (1 << 20) and (NBC_PLAN_SLOTS + 1) * cap + 12 * ring \
            + (64 << 20) > free:
        cap //= 2
    mib = min(NBC_MIB, cap >> 20)
    out["shm"] = {"dir": shmseg.backing_dir(), "free_bytes": free,
                  "ring_bytes": ring, "arena_cap": cap, "mib": mib}
    bench = ["-m", "ompi_tpu_torch.tools.host_bench"]
    base = ["--no-tag-output", "--mca", "pml_eager_limit",
            str(HOST_PINGPONG_EAGER), "--mca", "btl_shm_ring_size",
            str(ring)]
    # (a) the whole slice at -np 4, alone (its rows are timed)
    secs, rc, stdout, stderr = tpurun(
        ["-np", "4", *base, "--mca", "coll_shm_arena_size", str(cap), "--",
         sys.executable, *bench, "--nbc", "--mib", str(mib), "--part-mib",
         str(NBC_PART_MIB)])
    check(rc == 0, f"host_nbc (a): rc {rc}\n{stderr[-3000:]}")
    (a,) = tagged_json(stdout, "host_bench")
    jobs["nbc_np4_s"] = secs
    check(a["transport"] == "shm", f"host_nbc (a): ranks reached each "
          f"other over {a['transport']}, not the shm rings")
    names = [c["coll"] for c in a["nbc"]]
    check(len(names) == 17 and len(set(names)) == 17,
          f"host_nbc (a): i* collectives missing: {names}")
    for c in a["nbc"]:
        check(c["bitwise"], f"host_nbc {c['coll']}: differs from the "
              f"blocking call")
    per = a["persistent"]
    check(per["bitwise"] and per["starts"] == 16 and per["bytes"]
          == mib << 20, f"host_nbc allreduce_init: {per}")
    check(per["provider"] == "shm"
          and per["algorithm"] in ("root_fold", "segment_parallel"),
          f"host_nbc allreduce_init: bound {per['provider']}/"
          f"{per['algorithm']}, not the arena")
    for label, row in per["per_op"].items():
        check(row["provider"] == "shm" and row["persistent_us"] > 0
              and row["oneshot_us"] > 0, f"host_nbc per-op {label}: {row}")
    kinds = {k["kind"]: k for k in per["kinds"]}
    check(len(kinds) == 9, f"host_nbc: *_init kinds missing: {list(kinds)}")
    for name, k in kinds.items():
        check(k["bitwise"], f"host_nbc {name}_init: differs from the "
              f"blocking call")
        want = "topo" if name.startswith("neighbor") else "shm"
        check(k["provider"] == want, f"host_nbc {name}_init: provider "
              f"{k['provider']}, not {want}")
    for row in a["p2p_persistent"]:
        for mode in ("persistent", "isend_irecv", "send_recv"):
            check(row[mode]["bitwise"], f"host_nbc {mode} ping-pong "
                  f"{row['bytes']} B: the data came back changed")
    part = a["partitioned"]
    check(part["bitwise"] and part["partitions"] == 8
          and part["bytes"] == mib << 20,
          f"host_nbc partitioned: {part}")
    topo = a["topo"]
    check(len(topo["calls"]) == 7 and all(
        c["bitwise"] for c in topo["calls"].values()),
        f"host_nbc topologies: {topo['calls']}")
    check(topo["calls"]["neighbor_alltoall_init"]["provider"] == "topo",
          "host_nbc neighbor_alltoall_init: not the topo provider")
    check(topo["halo_faces"] == 16, f"host_nbc cart_halo: "
          f"{topo['halo_faces']} faces checked, want 16")
    out["nbc"] = a
    # (b) the same persistent allreduce through nbc, coll/shm off
    secs, rc, stdout, stderr = tpurun(
        ["-np", "4", *base, "--mca", "coll_shm_enable", "0", "--",
         sys.executable, *bench, "--nbc", "persistent", "--mib", str(mib)])
    check(rc == 0, f"host_nbc (b): rc {rc}\n{stderr[-3000:]}")
    (b,) = tagged_json(stdout, "host_bench")
    jobs["persistent_no_shm_s"] = secs
    check(b["persistent"]["bitwise"] and b["persistent"]["provider"]
          == "nbc", f"host_nbc (b): {b['persistent']}")
    out["persistent_no_shm"] = b["persistent"]
    # (c) two --gpu ranks on the card: overlap and the refusals
    secs, rc, stdout, stderr = tpurun(
        ["-np", "2", "--gpu", "--no-tag-output", "--", sys.executable,
         *bench, "--overlap", "--mib", str(NBC_MIB)])
    check(rc == 0, f"host_nbc (c): rc {rc}\n{stderr[-3000:]}")
    ranks = [r["overlap"] for r in tagged_json(stdout, "host_bench")]
    jobs["overlap_np2_gpu_s"] = secs
    check(len(ranks) == 2, f"host_nbc (c): {len(ranks)} rank reports")
    for r in ranks:
        check(r["bitwise"], f"host_nbc (c) rank {r['rank']}: iallreduce "
              f"differs from numpy")
        check(all(m and "got a device buffer" in m
                  for m in r["refusals"].values()),
              f"host_nbc (c): a CUDA tensor was not refused: "
              f"{r['refusals']}")
        check(r["dtoh_copies_in_refusals"] == 0,
              f"host_nbc (c): {r['dtoh_copies_in_refusals']} device-to-host "
              f"copies in the refusals' window (None: the control copy "
              f"was not seen)")
    out["overlap"] = ranks
    out["job_wall_s"] = jobs
    emit("host_nbc", **out)
    return out


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rma_rank_main(rank: int, world: int, init: str, device: str,
                  shape: tuple, results) -> None:
    """One rank of the rma_ranks phase (a spawned process)."""
    import traceback

    try:
        results.put((rank, "ok", rma_rank_body(rank, world, init, device,
                                                shape)))
    except BaseException:  # noqa: BLE001 — reported to the parent
        results.put((rank, "err", traceback.format_exc()))


def rma_rank_body(rank, world, init, device, shape):
    """Drive DeviceCommunicator.put/get, fetch_bcast, DeviceWindow and the
    heap on this rank; rank 0 holds every rank's window, gathered over the
    host group, against the numpy expectation, bitwise."""
    import torch
    import torch.distributed as dist

    from ompi_tpu_torch.mpi.device_comm import device_world
    from ompi_tpu_torch.mpi.osc import DeviceWindow
    from ompi_tpu_torch.ops import remote_dma as rd
    from ompi_tpu_torch.ops import symmetric
    from ompi_tpu_torch.parallel.mesh import make_mesh
    from ompi_tpu_torch.shmem.device import DeviceSymmetricHeap

    torch.set_num_threads(1)
    mesh = make_mesh(device=device, rank=rank, world_size=world,
                     init_method=init)
    comm = device_world(mesh)
    host = mesh.host_group(mesh.axis_names)
    dev = mesh.device
    refused = None
    if mesh.shares_card:
        try:
            comm.allreduce(torch.zeros(4, device=dev))
        except NotImplementedError as e:
            refused = str(e)
        check(refused is not None, "a collective over ranks sharing a card "
              "did not raise")
    base_np = np.random.default_rng(0).standard_normal(shape).astype(
        np.float32)
    base = torch.from_numpy(base_np).to(dev)
    n_checks = 0

    def gathered(t):
        """Every rank's ``t`` on rank 0 (None elsewhere), over gloo."""
        t = t.detach().cpu().contiguous()
        parts = [torch.empty_like(t) for _ in range(world)] if rank == 0 \
            else None
        dist.gather(t, parts, dst=0, group=host)
        return None if parts is None else [p.numpy() for p in parts]

    def expect(t, want, what):
        nonlocal n_checks
        parts = gathered(t)
        if rank == 0:
            for r in range(world):
                check(parts[r].tobytes() == np.ascontiguousarray(
                    want[r]).tobytes(), f"{what}: rank {r} differs")
        n_checks += 1

    win = comm.window(shape, torch.float32)
    small = comm.window((1024,), torch.float32)       # 4 KiB
    state = [np.zeros(shape, np.float32) for _ in range(world)]
    comm.barrier()

    # ---- the main path: counts zeroed just before, read just after ----
    rd.put_launch_count = rd.get_launch_count = rd.bcast_launch_count = 0
    t0 = time.perf_counter()
    pairs = 0
    # puts: round j, every src puts into (src + j) mod n (distinct dsts),
    # then one self-put
    for j in (1, 2, 3, 0):
        srcs = range(world) if j else (1,)
        for src in srcs:
            dst = (src + j) % world
            tag = np.float32(100 * j + src)
            win = comm.put(win, base + tag, src, dst)
            state[dst] = base_np + tag
            pairs += 1
        expect(win, state, f"put round {j}")
    # gets: round j, every dst fetches (dst + j) mod n
    for j in (1, 2, 3):
        mine = None
        for dst in range(world):
            src = (dst + j) % world
            out = comm.get(win, src, dst)
            if rank == dst:
                mine = out.clone()
        expect(mine, [state[(r + j) % world] for r in range(world)],
               f"get round {j}")
        expect(win, state, f"windows after get round {j}")
    # fetch_bcast from every root, each rank's window made distinct first
    for root in range(world):
        win.copy_(base + np.float32(1000 * root + rank))
        rd.fetch_bcast(win, root, comm)
        state = [base_np + np.float32(1000 * root + root)] * world
        expect(win, state, f"fetch_bcast root {root}")
    # DeviceWindow put/fence/get/local, on a 1/64 part of the window
    part = (shape[0] // 64, shape[1])
    dwin = DeviceWindow(comm, part, np.float32)
    data = base_np[:part[0]] + np.float32(7)
    dwin.put(data, origin=2, target=3)
    dwin.fence()
    zero = np.zeros(part, np.float32)
    expect(torch.from_numpy(dwin.local(rank)),
           [data if r == 3 else zero for r in range(world)],
           "DeviceWindow put/fence/local")
    fetched = dwin.get(origin=1, target=3)
    expect(torch.from_numpy(fetched),
           [data if r in (1, 3) else zero for r in range(world)],
           "DeviceWindow get")
    dwin.fence()
    try:
        dwin.local((rank + 1) % world)
        check(False, "DeviceWindow.local(other rank) did not raise")
    except Exception as e:  # noqa: BLE001 — the expected refusal
        check("own part" in str(e), f"DeviceWindow.local: {e}")
    # the heap's put/quiet/get
    heap = DeviceSymmetricHeap(comm)
    sym = heap.array(part, np.float32)
    blk = heap.put(sym, torch.full(part, 9.0, device=dev), 0, 3)
    blk = heap.quiet(blk)
    out = heap.get(blk, 3, 1)
    nine = np.full(part, 9.0, np.float32)
    expect(out, [nine if r in (1, 3) else zero for r in range(world)],
           "heap put/quiet/get")
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    main_s = time.perf_counter() - t0
    launches = {"put": rd.put_launch_count, "get": rd.get_launch_count,
                "bcast": rd.bcast_launch_count}

    # ---- wall latency of a put 0 -> 1 (the src's clock) ----
    lat = {}
    for name, w, reps in (("4KiB", small, 50), ("64MiB", win, 10)):
        v = torch.ones_like(w)
        comm.barrier()
        times = []
        for _ in range(reps):
            t1 = time.perf_counter()
            w = comm.put(w, v, 0, 1)
            times.append(time.perf_counter() - t1)
        lat[name] = {"median_ms": float(np.median(times)) * 1e3,
                     "min_ms": float(np.min(times)) * 1e3, "reps": reps,
                     "bytes": w.numel() * 4}

    # ---- ordering stress: back-to-back puts 0 -> 1 and gets 1 <- 2, each
    # of a new value; after each call returns on rank 1 a comparison on
    # the card adds the elements that differ to a count read once at the end
    # (a done flag released before the landing is written shows here) ----
    calls, elems = RMA_STRESS["calls"], RMA_STRESS["elems"]
    stress = comm.window((elems,), torch.float32)
    val = torch.zeros(elems, device=dev)
    bad = torch.zeros((), dtype=torch.int64, device=dev)
    comm.barrier()
    for k in range(1, calls + 1):
        if rank == 0:
            val.fill_(float(k))
        stress = comm.put(stress, val, 0, 1)
        if rank == 1:
            bad += (stress != float(k)).sum()
    for k in range(1, calls + 1):
        if rank == 2:
            stress.fill_(float(-k))
        got = comm.get(stress, 2, 1)
        if rank == 1:
            bad += (got != float(-k)).sum()
    ordering = {"puts": calls, "gets": calls, "bytes": elems * 4,
                "mismatches": int(bad.item())}
    comm.barrier()
    heap.free(sym)
    dwin.free()
    for t in (small, win, stress):
        symmetric.free(mesh, t)
    dist.destroy_process_group()
    return {"launches": launches, "pairs": pairs, "checks": n_checks,
            "main_path_s": main_s, "put_latency": lat, "ordering": ordering,
            "shares_card": mesh.shares_card, "collective_refused": refused,
            "device": str(dev)}


def phase_rma_ranks(card, world: int = RMA_RANKS, shape=RMA_WINDOW,
                    timeout: float = 150.0):
    """4 rank processes on the one card, each mapping its peers' windows;
    their results, and the launch counts summed over ranks."""
    import multiprocessing as mp
    import queue

    import torch

    if DEVICE == "cuda":
        torch.cuda.empty_cache()
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    init = f"tcp://127.0.0.1:{free_port()}"
    procs = [ctx.Process(target=rma_rank_main,
                         args=(r, world, init, DEVICE, shape, results))
             for r in range(world)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    got, failed = {}, None
    try:
        while len(got) < world and failed is None:
            left = timeout - (time.perf_counter() - t0)
            try:
                r, status, value = results.get(timeout=max(1.0, left))
            except queue.Empty:
                failed = (f"ranks {sorted(set(range(world)) - set(got))} "
                          f"did not finish in {timeout} s")
                break
            if status != "ok":
                failed = f"rank {r} failed:\n{value}"
            got[r] = value
    finally:
        for p in procs:
            if failed is not None and p.is_alive():
                p.kill()
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
    check(failed is None, f"rma_ranks: {failed}")
    secs = time.perf_counter() - t0
    launches = {k: sum(got[r]["launches"][k] for r in range(world))
                for k in ("put", "get", "bcast")}
    lat = got[0]["put_latency"]
    ordering = got[1]["ordering"]
    check(ordering["mismatches"] == 0,
          f"rma_ranks ordering stress: {ordering}")
    emit("rma_ranks", ranks=world, window_shape=list(shape),
         window_bytes=int(np.prod(shape)) * 4, init=init.split(":")[0],
         devices=[got[r]["device"] for r in range(world)],
         shares_card=got[0]["shares_card"],
         collective_refused=got[0]["collective_refused"],
         pairs=got[0]["pairs"], checks=got[0]["checks"],
         bitwise_equal=True, launches=launches,
         launches_by_rank=[got[r]["launches"] for r in range(world)],
         main_path_s=[got[r]["main_path_s"] for r in range(world)],
         put_latency=lat, ordering_stress=ordering,
         put_64MiB_gbps=lat["64MiB"]["bytes"] / lat["64MiB"]["median_ms"]
         / 1e6, seconds=secs,
         note="wall time on the src rank; 4 processes on one card are "
         "time-sliced (no MPS), so a cross-process put costs scheduler "
         "slices, not copy time", card=card)
    return launches


def phase_collectives(card):
    """make_mesh on the card with NCCL at world size 1: every device
    collective on CUDA tensors equals the same call on the one-process
    CPU communicator.  Returns the mesh; its process group stays up for
    phase mpi_coll."""
    import torch
    import torch.distributed as dist

    from ompi_tpu_torch.mpi import op as op_mod
    from ompi_tpu_torch.mpi.device_comm import device_world
    from ompi_tpu_torch.ops import symmetric
    from ompi_tpu_torch.parallel.mesh import Mesh, make_mesh

    # the reference: the one-process CPU mesh, made before the process
    # group exists, so it has no groups
    ref = device_world(Mesh({"world": 1}, device="cpu"))
    mesh = make_mesh(device=DEVICE, rank=0, world_size=1,
                     init_method=f"tcp://127.0.0.1:{free_port()}")
    comm = device_world(mesh)
    backend = dist.get_backend(comm._group())
    rng = np.random.default_rng(5)
    x_np = rng.standard_normal((8, 256)).astype(np.float32)
    mats_np = (np.eye(2)[None] + 0.1 * rng.standard_normal((1, 2, 2))
               ).astype(np.float32)[0]
    matmul = op_mod.create_op(lambda a, b: a @ b, commutative=False,
                              device_fn=torch.matmul)
    calls = {
        "allreduce_sum": lambda c, x, m: c.allreduce(x),
        "allreduce_max": lambda c, x, m: c.allreduce(x, op_mod.MAX),
        "allreduce_min": lambda c, x, m: c.allreduce(x, op_mod.MIN),
        "allreduce_prod": lambda c, x, m: c.allreduce(x, op_mod.PROD),
        "allreduce_matmul": lambda c, x, m: c.allreduce(m, matmul),
        "reduce": lambda c, x, m: c.reduce(x, root=0),
        "bcast": lambda c, x, m: c.bcast(x, 0),
        "reduce_scatter": lambda c, x, m: c.reduce_scatter(x),
        "allgather": lambda c, x, m: c.allgather(x, axis=1),
        "alltoall": lambda c, x, m: c.alltoall(x),
        "alltoall_stacked": lambda c, x, m: c.alltoall_stacked(x[:1]),
        "gather": lambda c, x, m: c.gather(x),
        "scatter": lambda c, x, m: c.scatter(x),
        "scan": lambda c, x, m: c.scan(x),
        "exscan": lambda c, x, m: c.exscan(x),
        "scan_matmul": lambda c, x, m: c.scan(m, matmul),
        "allreduce_rs_ag": lambda c, x, m: c.allreduce_rs_ag(x),
        "allreduce_qint8": lambda c, x, m: c.allreduce_qint8(x),
        "allreduce_segmented": lambda c, x, m: c.allreduce_segmented(
            x, segment_elems=512),
        "allgather_ring": lambda c, x, m: c.allgather_ring(x),
        "bcast_ring": lambda c, x, m: c.bcast_ring(x, 0),
        "allgatherv": lambda c, x, m: c.allgatherv(x, (5,)),
        "gatherv": lambda c, x, m: c.gatherv(x, (5,)),
        "scatterv": lambda c, x, m: c.scatterv(x, (8,)),
        "alltoallv": lambda c, x, m: c.alltoallv(x[:1], [[1]]),
        "shift": lambda c, x, m: c.shift(x, 1),
        "permute": lambda c, x, m: c.permute(x, [(0, 0)]),
        "sendrecv": lambda c, x, m: c.sendrecv(x, 1),
    }
    x, m = torch.from_numpy(x_np).to(mesh.device), torch.from_numpy(
        mats_np).to(mesh.device)
    worst = 0.0
    for name, fn in calls.items():
        got = fn(comm, x, m)
        want = fn(ref, x.cpu(), m.cpu())
        torch.cuda.synchronize()
        check(got.device.type == mesh.device.type
              and tuple(got.shape) == tuple(want.shape)
              and got.dtype == want.dtype, f"{name}: {got.device} "
              f"{tuple(got.shape)} {got.dtype}")
        err = (got.cpu().double() - want.double()).abs().max().item()
        worst = max(worst, err)
        check(err <= COLL_TOL * (1 + want.abs().max().item()),
              f"collective {name} on the card differs from its one-rank "
              f"result by {err}")
    comm.barrier()
    # a one-sided self-put through the window at world size 1
    win = comm.window((1024,), torch.float32)
    win = comm.put(win, x.reshape(-1)[:1024], 0, 0)
    got = comm.get(win, 0, 0)
    torch.cuda.synchronize()
    check(same_bytes(got, x.reshape(-1)[:1024]), "self put/get at world 1")
    symmetric.free(mesh, win)
    emit("collectives", backend=backend, world_size=1,
         collectives=sorted(calls), max_abs_err=worst, tol=COLL_TOL,
         card=card)
    return mesh

#: phase mpi_coll: the f32 sizes of each buffer collective's check, and a
#: bf16 one (bytes); the flagship's dense leaves are summed at full size
MPI_COLL_SIZES = ((4 << 10, "float32"), (64 << 20, "float32"),
                  (256 << 20, "float32"), (64 << 20, "bfloat16"))
MPI_DISPATCH_CALLS = 200


def flagship_leaf_shapes() -> dict:
    """Every leaf shape of the flagship dense model (init_params' layout,
    layers stacked), without drawing it."""
    from ompi_tpu_torch.models.transformer import TransformerConfig, init_params

    V, D, F_, L = (FLAGSHIP[k] for k in ("vocab", "d_model", "d_ff",
                                         "n_layers"))
    shapes = {"emb": (V, D), "wq": (L, D, D), "wk": (L, D, D),
              "wv": (L, D, D), "wo": (L, D, D), "ln1": (L, D), "ln2": (L, D),
              "lnf": (D,), "w1": (L, D, F_), "w2": (L, F_, D)}
    tiny = init_params(TransformerConfig(vocab=8, d_model=8, n_heads=2,
                                         n_layers=1, d_ff=16))
    check(set(tiny) == set(shapes), f"flagship leaves {sorted(tiny)}")
    return shapes


def profiler_copies(prof) -> dict:
    """Device-to-host and host-to-device copies and ``aten::_to_copy``
    calls in a torch.profiler window."""
    out = {"dtoh": 0, "htod": 0, "to_copy": 0, "device_events": 0}
    for e in prof.key_averages():
        if e.key == "aten::_to_copy":
            out["to_copy"] += e.count
        if e.device_type.name != "CUDA":
            continue
        out["device_events"] += e.count
        if "DtoH" in e.key:
            out["dtoh"] += e.count
        if "HtoD" in e.key:
            out["htod"] += e.count
    return out


def host_us(fn, n: int) -> float:
    """Median host µs of one call of ``fn`` over ``n`` calls, after 20."""
    for _ in range(20):
        fn()
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return float(np.median(times)) * 1e6


def device_busy_ms(fn, n: int = 10) -> float:
    """Device time (kernels and copies) of one call of ``fn``, from
    torch.profiler over ``n`` calls: what the card works, whatever the
    host's pace."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return sum(dev_us(e) for e in prof.key_averages()
               if e.device_type.name == "CUDA") / n / 1e3


def mpi_slots():
    """Each buffer collective as (through the route, straight on the
    DeviceCommunicator); non-commutative allreduce and scan by a 2×2
    matmul op (at world size 1 it folds nothing)."""
    import torch

    from ompi_tpu_torch.mpi import op as op_mod

    S = op_mod.SUM
    matmul = op_mod.create_op(lambda a, b: a @ b, commutative=False,
                              device_fn=torch.matmul)
    return {
        "bcast": (lambda c, x: c.bcast(x, 0), lambda d, x: d.bcast(x, 0)),
        "reduce": (lambda c, x: c.reduce(x, S, 0),
                   lambda d, x: d.reduce(x, S, 0)),
        "allreduce": (lambda c, x: c.allreduce(x),
                      lambda d, x: d.allreduce(x)),
        "allreduce_matmul": (lambda c, x: c.allreduce(x, matmul),
                             lambda d, x: d.allreduce(x, matmul)),
        "gather": (lambda c, x: c.gather(x, 0), lambda d, x: d.gather(x, 0)),
        "allgather": (lambda c, x: c.allgather(x),
                      lambda d, x: d.allgather(x)),
        "scatter": (lambda c, x: c.scatter(x, 0),
                    lambda d, x: d.scatter(x, 0)),
        "alltoall": (lambda c, x: c.alltoall(x), lambda d, x: d.alltoall(x)),
        "reduce_scatter": (lambda c, x: c.reduce_scatter(x),
                           lambda d, x: d.reduce_scatter(x, S)),
        "reduce_scatter_block": (lambda c, x: c.reduce_scatter_block(x),
                                 lambda d, x: d.reduce_scatter(x, S)),
        "scan": (lambda c, x: c.scan(x), lambda d, x: d.scan(x, S)),
        "scan_matmul": (lambda c, x: c.scan(x, matmul),
                        lambda d, x: d.scan(x, matmul)),
        "exscan": (lambda c, x: c.exscan(x), lambda d, x: d.exscan(x, S)),
        "gatherv": (lambda c, x: c.gatherv(x, 0),
                    lambda d, x: d.gatherv(x, None, 0)),
        "scatterv": (lambda c, x: c.scatterv(x, 0),
                     lambda d, x: d.scatterv(x, None, 0)),
        "allgatherv": (lambda c, x: c.allgatherv(x),
                       lambda d, x: d.allgatherv(x)),
        "alltoallv": (lambda c, x: c.alltoallv(x[None]),
                      lambda d, x: d.alltoallv(x[None])),
    }


def mpi_inputs(dev, gen) -> list:
    """One (n, 1024) tensor of each of MPI_COLL_SIZES, drawn on ``dev``."""
    import torch

    out = []
    for nbytes, dtype in MPI_COLL_SIZES:
        t = getattr(torch, dtype)
        n = nbytes // torch.tensor([], dtype=t).element_size()
        out.append(torch.randn((max(1, n // 1024), 1024), generator=gen,
                               device=dev).to(t))
    return out


def mpi_vector_type():
    """Half of every row of a (16384, 1024) float32 tensor."""
    from ompi_tpu_torch.mpi import datatype as dt_mod

    return dt_mod.FLOAT32.vector(16384, 512, 1024).commit()


def mpi_profile_body(port: int, device: str) -> dict:
    """The profiler windows of phase mpi_coll, in a fresh process (a
    process's profiler stops recording memcpys after the decode phase's
    windows, so a zero there would prove nothing): the route's calls at
    every size with one deliberate device-to-host copy after them, and a
    repeated pack with one deliberate host-to-device copy; the control
    must show and nothing else may.  Also the device time of psum and
    rs_ag a call."""
    import torch
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    from ompi_tpu_torch.mpi.comm import Communicator
    from ompi_tpu_torch.mpi.group import Group
    from ompi_tpu_torch.parallel.mesh import make_mesh
    from ompi_tpu_torch.mpi.device_comm import device_world

    mesh = make_mesh(device=device, rank=0, world_size=1,
                     init_method=f"tcp://127.0.0.1:{port}")
    try:
        dev = mesh.device
        dc = device_world(mesh)
        comm = Communicator(Group([0]), cid=0, my_world_rank=0)
        comm.bind_device(dc)
        inputs = mpi_inputs(dev, torch.Generator(device=dev).manual_seed(9))
        slots = mpi_slots()
        for x in inputs:                      # warm: NCCL's first calls
            for f, _ in slots.values():
                f(comm, x)
        torch.cuda.synchronize()
        acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
        void = {"route": 0, "pack": 0}

        def window(name, body):
            # a window that recorded no device event at all (the profiler
            # now and then drops a whole one) is void: it is taken again,
            # at most twice, and counted
            for _ in range(3):
                with profile(activities=acts) as prof:
                    body()
                    torch.cuda.synchronize()
                got = profiler_copies(prof)
                if got["device_events"]:
                    break
                void[name] += 1
            return got

        def route_body():
            inputs[0].clone()                 # a window may miss its first
            for x in inputs:
                for f, _ in slots.values():
                    f(comm, x)
            comm.barrier()
            inputs[0][:1].cpu()               # the control: one DtoH

        route = window("route", route_body)
        vec = mpi_vector_type()
        vec.pack_device(inputs[1])
        torch.cuda.synchronize()

        def pack_body():
            inputs[1][:1].clone()
            vec.pack_device(inputs[1])
            torch.ones(1).to(dev)             # the control: one HtoD

        pack = window("pack", pack_body)
        busy = {label: {"psum_busy_ms": device_busy_ms(
                            lambda: dc.allreduce(x)),
                        "rs_ag_busy_ms": device_busy_ms(
                            lambda: dc.allreduce_rs_ag(x))}
                for label, x in (("64MiB", inputs[1]),
                                 ("256MiB", inputs[2]))}
        return {"route": route, "pack": pack, "busy": busy,
                "void_windows": void}
    finally:
        dist.destroy_process_group()


def mpi_profile_main(port: int, device: str, results) -> None:
    """Entry of the spawned process of phase mpi_coll."""
    import traceback

    try:
        results.put(("ok", mpi_profile_body(port, device)))
    except BaseException:  # noqa: BLE001 — reported to the parent
        results.put(("err", traceback.format_exc()))


def mpi_profiled(timeout: float = 180.0) -> dict:
    """mpi_profile_body in a spawned process; its result."""
    import multiprocessing as mp
    import queue

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    proc = ctx.Process(target=mpi_profile_main,
                       args=(free_port(), DEVICE, results))
    proc.start()
    try:
        status, value = results.get(timeout=timeout)
    except queue.Empty:
        status, value = "err", f"no result in {timeout} s"
    finally:
        proc.join(timeout=30)
        if proc.is_alive():
            proc.kill()
            proc.join()
    check(status == "ok", f"mpi_coll's profiled process: {value}")
    return value


#: the trace phase's device-route calls: 64 each of (label, bytes, dtype)
TRACE_CALLS = 64
TRACE_SIZES = (("4KiB_f32", 4 << 10, "float32"),
               ("64MiB_f32", 64 << 20, "float32"),
               ("64MiB_bf16", 64 << 20, "bfloat16"))
#: numpy's (type code, itemsize) of each dtype, as the JAX package signs
#: a collective on it (ml_dtypes' bfloat16 registers as 256)
TRACE_SIG_DTYPE = {"float32": (11, 4), "bfloat16": (256, 2)}
#: tpurun --timeout of the hang doctor's two jobs (each ends by it)
TRACE_HANG_TIMEOUT = 5
#: the straggler and mismatch jobs of phase trace (c)
TRACE_MISMATCH = """
import numpy as np, ompi_tpu_torch
c = ompi_tpu_torch.init()
c.barrier()
x = np.ones(1024)
if c.rank == 1:
    c.bcast(x, root=0)
else:
    c.allreduce(x)
c.barrier()
ompi_tpu_torch.finalize()
"""
TRACE_STRAGGLER = """
import time, numpy as np, ompi_tpu_torch
c = ompi_tpu_torch.init()
c.allreduce(np.ones(1024))
if c.rank == 1:
    time.sleep(120)
c.allreduce(np.ones(1024))
ompi_tpu_torch.finalize()
"""


def trace_device_body(port: int, device: str) -> dict:
    """Phase trace (a), in a fresh process: ``init()``, the world bound
    to a one-rank DeviceCommunicator on the card, TRACE_CALLS
    ``comm.allreduce`` calls at each of TRACE_SIZES; the flight
    recorder's records and the dispatch histogram's samples of them, a
    profiler window's copies, and the host µs of a 4 KiB call with the
    timeline disarmed and armed, in turns."""
    import types

    import torch
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    import ompi_tpu_torch
    from ompi_tpu_torch.mpi import trace
    from ompi_tpu_torch.mpi.device_comm import device_world
    from ompi_tpu_torch.parallel.mesh import make_mesh

    comm = ompi_tpu_torch.init()
    mesh = make_mesh(device=device, rank=0, world_size=1,
                     init_method=f"tcp://127.0.0.1:{port}")
    try:
        dc = device_world(mesh)
        comm.bind_device(dc)
        dev = mesh.device
        xs = {}
        for label, nbytes, dtype in TRACE_SIZES:
            t = getattr(torch, dtype)
            n = nbytes // torch.tensor([], dtype=t).element_size()
            xs[label] = torch.arange(n, device=dev).remainder(7).to(t)
        for x in xs.values():                  # warm: NCCL's first calls
            comm.allreduce(x)
        torch.cuda.synchronize()
        trace.collrec.reset()

        def samples():
            return {k: sum(v[:trace.HIST_NBUCKETS])
                    for k, v in trace.hists.items()
                    if k.startswith('coll_dispatch_ns{slot="allreduce",'
                                    'provider="xla"')}

        h0 = samples()
        equal = {}
        for label, x in xs.items():
            for _ in range(TRACE_CALLS):
                out = comm.allreduce(x)
            equal[label] = bool(torch.equal(out, x))
        torch.cuda.synchronize()
        h1 = samples()
        recs = [r for r in trace.collrec.snapshot() if r[2] == comm.cid]
        want = {}
        for label, nbytes, dtype in TRACE_SIZES:
            num, size = TRACE_SIG_DTYPE[dtype]
            want[label] = (nbytes, trace.collrec_sig(
                "allreduce", types.SimpleNamespace(num=num, itemsize=size),
                nbytes))
        posts = [r for r in recs if r[5] == "post"]
        rec = {"posts": len(posts),
               "dones": sum(1 for r in recs if r[5] == "done"),
               "providers": sorted({r[7]["prov"] for r in posts}),
               "seqs_in_order": [r[3] for r in posts]
               == list(range(len(posts))),
               "by_size": {}}
        for label, (nbytes, sig) in want.items():
            mine = [r for r in posts if r[7]["nb"] == nbytes
                    and r[6] == sig]
            rec["by_size"][label] = {"posts": len(mine), "sig": sig}
        rec["hist_samples"] = sum(h1.values()) - sum(h0.values())
        acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
        with profile(activities=acts) as prof:
            xs["4KiB_f32"].clone()             # a window may miss its first
            for x in xs.values():
                for _ in range(8):
                    comm.allreduce(x)
            xs["4KiB_f32"][:1].cpu()           # the control: one DtoH
            torch.cuda.synchronize()
        copies = profiler_copies(prof)
        x4 = xs["4KiB_f32"]
        turns = []
        for armed in (False, True, True, False):
            if armed:
                trace.enable(capacity=65536, rank=0)
            turns.append({"armed": armed,
                          "route_us": host_us(lambda: comm.allreduce(x4),
                                              400),
                          "direct_us": host_us(lambda: dc.allreduce(x4),
                                               400)})
            trace.disable()
        return {"equal": equal, "records": rec, "copies": copies,
                "host_us": turns}
    finally:
        dist.destroy_process_group()
        ompi_tpu_torch.finalize()


def trace_device_main(port: int, device: str, results) -> None:
    """Entry of the spawned process of phase trace."""
    import traceback

    try:
        results.put(("ok", trace_device_body(port, device)))
    except BaseException:  # noqa: BLE001 — reported to the parent
        results.put(("err", traceback.format_exc()))


def trace_record_costs(n: int = 20000) -> dict:
    """Phase trace (d): ns a recorder post+done, ns a span while the
    timeline is armed, ns a check of the disarmed gate (best of 5
    batches of ``n``, loop overhead included)."""
    from ompi_tpu_torch.mpi import trace

    def best(fn):
        out = float("inf")
        for _ in range(5):
            t0 = time.perf_counter_ns()
            fn()
            out = min(out, (time.perf_counter_ns() - t0) / n)
        return out

    rec = trace.CollRecorder(capacity=4096)

    def post_done():
        for _ in range(n):
            rec.done(0, 0, rec.post(0, 0, "allreduce", 7, "xla", 4096),
                     "allreduce")

    def gate():
        for _ in range(n):
            if trace.active:
                trace.instant("pml", "x")

    trace.disable()
    gate_ns = best(gate)
    trace.enable(capacity=1 << 16, rank=0)
    try:
        def span():
            for _ in range(n):
                t0 = trace.begin()
                trace.complete("coll", "allreduce", t0, rank=0, seq=1)

        span_ns = best(span)
    finally:
        trace.disable()
    return {"post_done_ns": best(post_done), "span_ns": span_ns,
            "disabled_gate_ns": gate_ns}


def phase_trace(card):
    """The trace plane: (a) the device route's collectives on the card
    pass the recorder and the dispatch histogram (a spawned process,
    NCCL at world size 1); (b) a traced 4-rank job of
    ``examples/trace_demo`` merged by ``tools/trace_export``; (c) the
    hang doctor's verdicts from the dumps of a mismatch job and a
    straggler job, each ended by ``tpurun --timeout``; (d) the record
    path's costs on this host."""
    import multiprocessing as mp
    import queue
    import shutil
    import tempfile

    from ompi_tpu_torch.runtime import timeline

    tmp = tempfile.mkdtemp(prefix="otpu-trace-")
    try:
        dirs = {k: os.path.join(tmp, k) for k in ("demo", "mismatch",
                                                  "straggler")}
        for d in dirs.values():
            os.makedirs(d)
        jobs = {
            "demo": tpurun_start([
                "-np", "4", "--trace", "--no-tag-output", "-x",
                f"TMPDIR={dirs['demo']}", "--", sys.executable, "-m",
                "ompi_tpu_torch.examples.trace_demo"]),
            "mismatch": tpurun_start([
                "-np", "4", "--trace", "--no-tag-output", "--timeout",
                str(TRACE_HANG_TIMEOUT), "--mca", "coll_shm_enable", "0",
                "-x", f"TMPDIR={dirs['mismatch']}", "--", sys.executable,
                "-c", TRACE_MISMATCH]),
            "straggler": tpurun_start([
                "-np", "4", "--trace", "--no-tag-output", "--timeout",
                str(TRACE_HANG_TIMEOUT), "-x",
                f"TMPDIR={dirs['straggler']}", "--", sys.executable, "-c",
                TRACE_STRAGGLER]),
        }
        ctx = mp.get_context("spawn")
        results = ctx.Queue()
        proc = ctx.Process(target=trace_device_main,
                           args=(free_port(), DEVICE, results))
        proc.start()
        try:
            status, dev = results.get(timeout=240)
        except queue.Empty:
            status, dev = "err", "no result in 240 s"
        finally:
            proc.join(timeout=30)
            if proc.is_alive():
                proc.kill()
                proc.join()
        check(status == "ok", f"trace's device process: {dev}")
        calls = TRACE_CALLS * len(TRACE_SIZES)
        rec = dev["records"]
        check(all(dev["equal"].values()),
              f"comm.allreduce differs from its input: {dev['equal']}")
        check(rec["posts"] == rec["dones"] == calls
              and rec["providers"] == ["xla"] and rec["seqs_in_order"],
              f"the recorder missed device-route calls: {rec}")
        check(all(v["posts"] == TRACE_CALLS
                  for v in rec["by_size"].values()),
              f"device-route records with the wrong bytes or signature "
              f"(bf16 must sign as numpy's 256/2): {rec['by_size']}")
        check(rec["hist_samples"] == calls,
              f"coll_dispatch_ns counted {rec['hist_samples']} of {calls}")
        cp = dev["copies"]
        check(cp["dtoh"] == 1,
              f"device-route window: {cp['dtoh']} device-to-host copies "
              f"(one is the control): {cp}")
        costs = trace_record_costs()

        out = {"card": card, "device_route": {
            "calls": calls, "records": rec, "copies": cp,
            "host_us_4KiB": dev["host_us"]}, "record_path": costs}
        secs, rc, sout, serr = tpurun_wait(jobs["demo"])
        check(rc == 0, f"trace_demo job: rc {rc}\n{serr[-2000:]}")
        mon = tagged_json(sout, "MONITOR")
        check(len(mon) == 1, f"trace_demo printed no matrix: {sout}")
        dumps = sorted(os.listdir(dirs["demo"]))
        check(len(dumps) == 4, f"trace_demo dumps: {dumps}")
        merged = os.path.join(tmp, "merged.json")
        res = subprocess.run(
            [sys.executable, "-m", "ompi_tpu_torch.tools.trace_export",
             "--dir", dirs["demo"], "-o", merged], capture_output=True,
            text=True, timeout=120,
            cwd=os.path.dirname(os.path.abspath(__file__)))
        check(res.returncode == 0, f"trace_export: {res.stderr[-2000:]}")
        with open(merged, encoding="utf-8") as f:
            doc = json.load(f)
        evs = doc["traceEvents"]
        cats = sorted({e.get("cat") for e in evs
                       if e.get("ph") in ("X", "i")})
        flows = sum(1 for e in evs if e.get("ph") == "s")
        problems = timeline.causality_problems(evs)
        check({"pml", "btl", "coll", "datatype"} <= set(cats),
              f"merged trace categories {cats}")
        check(flows > 0 and not problems,
              f"flow arrows {flows}, causality problems {problems[:5]}")
        out["traced_job"] = {"seconds": secs, "events": len(evs),
                             "categories": cats, "flow_arrows": flows,
                             "monitor_sent_bytes": mon[0]["sent_bytes"]}
        out["doctor"] = {}
        for kind in ("mismatch", "straggler"):
            secs, rc, _o, serr = tpurun_wait(jobs[kind])
            check(rc == 124, f"{kind} job: rc {rc} (the timeout ends it)"
                  f"\n{serr[-2000:]}")
            res = subprocess.run(
                [sys.executable, "-m", "ompi_tpu_torch.tools.hang_doctor",
                 "--dir", dirs[kind], "--expect", f"{kind}:1"],
                capture_output=True, text=True, timeout=120,
                cwd=os.path.dirname(os.path.abspath(__file__)))
            check(res.returncode == 0,
                  f"hang_doctor --expect {kind}:1: {res.stdout[-2000:]}"
                  f"{res.stderr[-1000:]}")
            out["doctor"][kind] = {
                "job_seconds": secs,
                "verdict": res.stdout.splitlines()[0] if res.stdout
                else ""}
        emit("trace", **out)
        return out
    finally:
        for reaper, _, _ in _HOST_JOBS:
            reaper.join()
        _HOST_JOBS.clear()
        shutil.rmtree(tmp, ignore_errors=True)


def phase_mpi_coll(card, mesh):
    """The MPI communicator's device route on the card, over the NCCL
    group of phase collectives (world size 1): ``comm.<slot>`` on CUDA
    tensors through coll/xla, never through the host."""
    import tempfile

    import torch

    from ompi_tpu_torch.core.buffer import BufferLocationError, classify
    from ompi_tpu_torch.core.config import var_registry
    from ompi_tpu_torch.mpi import mpiext
    from ompi_tpu_torch.mpi.coll import COLL_FUNCTIONS, coll_framework
    from ompi_tpu_torch.mpi.coll import xla as xla_mod
    from ompi_tpu_torch.mpi.comm import Communicator
    from ompi_tpu_torch.mpi.constants import MPIException
    from ompi_tpu_torch.mpi.device_comm import device_world
    from ompi_tpu_torch.mpi.group import Group

    dev = mesh.device
    dc = device_world(mesh)
    comm = Communicator(Group([0]), cid=0, my_world_rank=0).bind_device(dc)
    gen = torch.Generator(device=dev).manual_seed(9)

    # the table: coll/xla serves every slot it has on tensors, coll/self
    # the host buffers of this size-1 communicator; alltoallw has no
    # device provider (nor in the JAX package)
    xla_slots = [s for s in COLL_FUNCTIONS if s != "alltoallw"]
    check(all(comm.coll.device_providers.get(s) == "xla"
              for s in xla_slots), f"{comm.coll.device_providers}")
    check(all(comm.coll.providers.get(s) == "self" for s in xla_slots),
          f"{comm.coll.providers}")
    host_out = comm.allreduce(np.arange(4, dtype=np.float32))
    check(isinstance(host_out, np.ndarray), "numpy allreduce via self")
    try:
        comm.alltoallw([(torch.ones(4, device=dev), None, 4)],
                       [(torch.ones(4, device=dev), None, 4)])
        check(False, "alltoallw of a CUDA tensor must raise")
    except BufferLocationError:
        pass

    # the profiler windows, in a fresh process: the route added no copy
    # between host and card, and the controls show the profiler saw them
    prof = mpi_profiled()
    route, pack_win = prof["route"], prof["pack"]
    check(route["dtoh"] == 1 and route["to_copy"] == 1,
          f"the route's window: {route} (the control is 1 DtoH, 1 "
          f"aten::_to_copy)")
    check(route["device_events"] > 0, "the profiler saw no device work")
    check(pack_win["htod"] == 1, f"a repeated pack's window: {pack_win} "
          f"(the control is 1 HtoD)")

    # each buffer collective through comm.<slot> here, on phase
    # collectives' NCCL group, against the direct call
    slots = mpi_slots()
    inputs = mpi_inputs(dev, gen)
    got = [{name: f(comm, x) for name, (f, _) in slots.items()}
           for x in inputs]
    comm.barrier()
    for x, outs in zip(inputs, got):
        for name, (_, direct) in slots.items():
            want = direct(dc, x)
            check(outs[name].device == dev and same_bytes(outs[name], want),
                  f"comm.{name} differs from the direct call at "
                  f"{tuple(x.shape)} {x.dtype}")
    del got, outs, want

    # the decision at world size 1: which DeviceCommunicator method ran
    ran = []

    def counting(meth):
        f = getattr(dc, meth)

        def wrapped(*args, **kw):
            ran.append(meth)
            return f(*args, **kw)
        return wrapped

    methods = ("allreduce", "allreduce_rs_ag", "allreduce_segmented")
    for meth in methods:
        setattr(dc, meth, counting(meth))

    def decided(x) -> str:
        ran.clear()
        comm.allreduce(x)
        check(len(ran) >= 1, "no allreduce method ran")
        return ran[0]

    small, big = inputs[0], inputs[1]
    decision = {"4KiB": decided(small), "64MiB": decided(big)}
    check(decision == {"4KiB": "allreduce", "64MiB": "allreduce_rs_ag"},
          f"decision {decision}")
    var_registry.set("coll_xla_allreduce_algorithm", "segmented")
    try:
        decision["forced_segmented_4KiB"] = decided(small)
    finally:
        var_registry.set("coll_xla_allreduce_algorithm", "")
    with tempfile.TemporaryDirectory() as tmp:
        good, lossy = (os.path.join(tmp, f) for f in ("a.rules", "q.rules"))
        with open(good, "w") as fh:
            fh.write("allreduce 0 0 rs_ag\n")
        with open(lossy, "w") as fh:
            fh.write("allreduce 0 0 qint8\n")
        try:
            var_registry.set("coll_xla_dynamic_rules", good)
            decision["rules_file_4KiB"] = decided(small)
            var_registry.set("coll_xla_dynamic_rules", lossy)
            try:
                comm.allreduce(small)
                decision["rules_file_qint8"] = "ran"
            except MPIException:
                decision["rules_file_qint8"] = "raises"
        finally:
            var_registry.set("coll_xla_dynamic_rules", "")
    check(decision["forced_segmented_4KiB"] == "allreduce_segmented"
          and decision["rules_file_4KiB"] == "allreduce_rs_ag"
          and decision["rules_file_qint8"] == "raises", f"{decision}")
    for meth in methods:
        delattr(dc, meth)

    # refusals: p2p of a tensor (the PML's), a CPU tensor on the card
    refusals = {}
    other = "meta" if dev.type == "cpu" else "cpu"  # "meta" in a rehearsal
    for name, call in (("send", lambda: comm.send(small, dest=0)),
                       ("cpu_tensor", lambda: comm.allreduce(
                           torch.ones(4, device=other)))):
        try:
            call()
            check(False, f"{name} must raise")
        except BufferLocationError as e:
            refusals[name] = str(e)[:160]
    check(other in refusals["cpu_tensor"]
          and str(dev) in refusals["cpu_tensor"], refusals["cpu_tensor"])
    check(mpiext.query_cuda_support() is True, "query_cuda_support")

    # the datatype device pack: half of every row of a 64 MiB tensor
    vec = mpi_vector_type()
    xp = inputs[1]
    packed = vec.pack_device(xp)
    unpacked = vec.unpack_device(packed)
    xc = xp.cpu()
    check(same_bytes(packed.cpu(), vec.pack_device(xc))
          and same_bytes(unpacked.cpu(), vec.unpack_device(
              vec.pack_device(xc))), "pack/unpack on the card vs the CPU")
    idx = vec._device_index(1, dev)
    flat = xp.reshape(-1)
    pack = {"type": "vector(16384, 512, 1024) over (16384, 1024) float32",
            "count": 1, "bitwise_vs_cpu": True,
            "htod_on_repeat": pack_win["htod"] - 1,
            "pack_ms": cuda_ms(lambda: vec.pack_device(xp), iters=50),
            "index_select_ms": cuda_ms(
                lambda: torch.index_select(flat, 0, idx), iters=50),
            "unpack_ms": cuda_ms(lambda: vec.unpack_device(packed),
                                 iters=50),
            # 32 MiB read, the int64 index read, 32 MiB written
            "bytes_bound_ms": (packed.numel() * 4 * 2 + idx.numel() * 8)
            / HBM_BYTES_PER_S * 1e3}

    # host cost of one 4 KiB call through the route and straight, in
    # blocks (route, direct, direct, route, twice; the host's pace drifts),
    # and of the route's own steps
    x4 = inputs[0]
    xla = coll_framework.components()["xla"]
    paths = {"comm": lambda: comm.allreduce(x4),
             "direct": lambda: dc.allreduce(x4),
             "classify": lambda: classify(x4),
             "decide": lambda: xla._decide("allreduce", comm, dc, 4096),
             "check_device": lambda: xla_mod._check_device(comm, dc, x4)}
    blocks = {k: [] for k in paths}
    for name in ("comm", "direct", "direct", "comm") * 2 + (
            "classify", "decide", "check_device"):
        blocks[name].append(host_us(paths[name], MPI_DISPATCH_CALLS))
    torch.cuda.synchronize()
    dispatch = {f"{k}_us": v for k, v in blocks.items()}
    dispatch["calls_a_block"] = MPI_DISPATCH_CALLS
    dispatch["overhead_us"] = (float(np.median(blocks["comm"]))
                               - float(np.median(blocks["direct"])))
    forms = {}
    for label, x in (("64MiB", inputs[1]), ("256MiB", inputs[2])):
        forms[label] = {
            **prof["busy"][label],
            "psum_stream_ms": cuda_ms(lambda: dc.allreduce(x)),
            "rs_ag_stream_ms": cuda_ms(lambda: dc.allreduce_rs_ag(x))}
    del inputs, packed, unpacked, xp, xc, flat, idx, small, big, x4, x

    # the real-size case: the flagship's dense gradient set, leaf by leaf
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    start_gib = torch.cuda.memory_allocated() / 2**30
    grads = {k: torch.randn(s, generator=gen, device=dev)
             for k, s in flagship_leaf_shapes().items()}
    nbytes = sum(g.numel() * g.element_size() for g in grads.values())
    algs = {}
    for g in grads.values():
        a = xla._decide("allreduce", comm, dc, g.numel() * g.element_size())
        algs[a] = algs.get(a, 0) + 1
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    summed = {k: comm.allreduce(g) for k, g in grads.items()}
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    for k, g in grads.items():
        check(same_bytes(summed[k], dc.allreduce(g)),
              f"gradient leaf {k}: comm.allreduce differs from the direct "
              f"call")
    del summed
    route_ms = cuda_ms(lambda: [comm.allreduce(g) for g in grads.values()],
                       iters=3, warmup=1)
    direct_ms = cuda_ms(lambda: [dc.allreduce(g) for g in grads.values()],
                        iters=3, warmup=1)
    del grads
    torch.cuda.empty_cache()
    emit("mpi_coll", world_size=1, slots=sorted(slots) + ["barrier"],
         sizes=[(f"{n >> 20} MiB" if n >= 1 << 20 else f"{n >> 10} KiB")
                + f" {d}" for n, d in MPI_COLL_SIZES],
         bitwise_equal_to_direct=True,
         profiler_windows={"route": route, "pack": pack_win,
                           "void_taken_again": prof["void_windows"],
                           "process": "a fresh spawned process; the "
                                      "counts include one control copy "
                                      "each"},
         device_providers="xla for " + ", ".join(xla_slots),
         decision=decision, refusals=refusals, cuda_support=True,
         pack=pack, dispatch=dispatch, allreduce_forms_ms=forms,
         forms_note="world size 1: psum and rs_ag are copies here; their "
                    "crossover needs 2+ cards; busy = device time a call "
                    "(profiler, the fresh process), stream = CUDA events "
                    "over 20 calls",
         gradients={"leaves": sum(algs.values()), "bytes": nbytes,
                    "algorithms": algs,
                    "route_ms": route_ms, "first_pass_wall_ms": wall_ms,
                    "direct_ms": direct_ms, "peak_gib": peak_gib,
                    "allocated_before_gib": start_gib,
                    "bitwise_equal_to_direct": True},
         card=card)


# ---------------------------------------------------------------------------
# slice 11: hwtopo, tune, pipeline, ckpt
# ---------------------------------------------------------------------------

def phase_hwtopo(card):
    """``discover(probe_accelerators=True)`` counts the CUDA cards."""
    import dataclasses as dc

    import torch

    from ompi_tpu_torch.core.hwtopo import discover

    topo = discover(probe_accelerators=True)
    check(topo.accelerators == torch.cuda.device_count() >= 1,
          f"hwtopo: {topo.accelerators} accelerators, torch sees "
          f"{torch.cuda.device_count()}")
    check(discover().accelerators == 0, "hwtopo probed without being asked")
    emit("hwtopo", topology=dc.asdict(topo), smt=topo.smt, card=card)


#: the pipeline phase: one flagship-width stage over 16 × 512 tokens
PIPE = dict(tokens=16 * 512, width=2048, microbatches=4)


def phase_pipeline(card):
    """``gpipe`` at pp = 1 on the card at the flagship's width: the stage
    gelu(h @ w + b), bf16; forward and every gradient equal to the direct
    call's, bit for bit."""
    import torch

    from ompi_tpu_torch.mpi.device_comm import device_world
    from ompi_tpu_torch.parallel import gpipe
    from ompi_tpu_torch.parallel.mesh import Mesh

    comm = device_world(Mesh({"pp": 1}, device=DEVICE))
    gen = torch.Generator(device=DEVICE).manual_seed(11)
    T_, D = PIPE["tokens"], PIPE["width"]

    def draw(*shape, scale):
        return (torch.randn(*shape, device=DEVICE, generator=gen) * scale
                ).to(torch.bfloat16)

    w, b = draw(D, D, scale=D ** -0.5), draw(D, scale=0.1)
    h = draw(T_, D, scale=1.0)

    def stage(params, x):
        pw, pb = params
        return torch.nn.functional.gelu(x @ pw + pb)

    def run(fn):
        leaves = [t.clone().requires_grad_(True) for t in (w, b, h)]
        out = fn(leaves)
        out.float().square().sum().backward()
        return [out.detach()] + [t.grad for t in leaves]

    got = run(lambda l: gpipe(comm, stage, (l[0], l[1]), l[2],
                              PIPE["microbatches"], axis="pp"))
    want = run(lambda l: stage((l[0], l[1]), l[2]))
    torch.cuda.synchronize()
    for name, g, x in zip(("out", "dw", "db", "dh"), got, want):
        check(g.shape == x.shape and torch.equal(g, x),
              f"pipeline {name}: gpipe at pp = 1 differs from the direct "
              f"call")
    ms = cuda_ms(lambda: run(lambda l: gpipe(comm, stage, (l[0], l[1]),
                                             l[2], PIPE["microbatches"])),
                 iters=10)
    direct_ms = cuda_ms(lambda: run(lambda l: stage((l[0], l[1]), l[2])),
                        iters=10)
    emit("pipeline", pp=1, **PIPE, dtype="bfloat16", bitwise=True,
         fwd_bwd_ms=ms, direct_fwd_bwd_ms=direct_ms, card=card)


def _leaves_equal(a, b) -> dict:
    """{leaf: max |a − b|} over two (params, opt_state) pairs (0.0 =
    bitwise equal as values; NaN-safe by exact comparison first)."""
    import torch

    from ompi_tpu_torch.models.optim import AdamWState

    def flat(params, state):
        out = {f"p_{k}": v for k, v in params.items()}
        if isinstance(state, dict):
            out.update({f"master_{k}": v
                        for k, v in state["master"].items()})
            state = state["opt"]
        check(isinstance(state, AdamWState), f"optimizer state {state!r}")
        out.update({f"mu_{k}": v for k, v in state.mu.items()})
        out.update({f"nu_{k}": v for k, v in state.nu.items()})
        out["count"] = state.count
        return out

    fa, fb = flat(*a), flat(*b)
    res = {}
    for k in fa:
        x, y = fa[k].detach(), fb[k].detach().to(fa[k].device)
        res[k] = (0.0 if torch.equal(x, y)
                  else (x.double() - y.double()).abs().max().item())
    return res


def _dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(path) for f in files)


def _resume(cfg, mesh, params_np, toks, kind: str, base: str, snap_at: int,
            more: int):
    """Train ``snap_at`` steps, snapshot through the ``kind`` store
    (``npz``: SnapshotStore write_rank + commit, ``dcp``: DcpStore,
    ``sharded``: ShardedSnapshotStore's collective save over a one-rank
    world, ``init()`` as a singleton), train ``more`` steps (the
    uninterrupted reference), then restore into fresh tensors on the card
    twice and train the same ``more`` steps from each.
    Bitwise equality with the reference is demanded when the two
    continuations agree bit for bit; when they do not, the step has a
    nondeterministic op, named by a run under
    ``torch.use_deterministic_algorithms(True)``, and the resume is held
    at the two continuations' spread."""
    import shutil

    import torch

    from ompi_tpu_torch.ckpt import (DcpStore, ShardedSnapshotStore,
                                     SnapshotStore)
    from ompi_tpu_torch.models.transformer import make_train_step
    from ompi_tpu_torch.models.weights import (from_jax_params,
                                               from_train_state, train_state)

    step, init = make_train_step(cfg, mesh, lr=1e-3)
    params = from_jax_params(params_np, cfg, DEVICE, train=True, mesh=mesh)
    state = init(params)

    def steps(p, s, batches):
        losses = []
        for t in batches:
            p, s, loss = step(p, s, t)
            losses.append(loss.item())
        return losses, p, s

    _, params, state = steps(params, state, toks[:snap_at])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    snap = train_state(params, state, cfg, mesh=mesh)
    fcoll: list = []
    if kind == "npz":
        store = SnapshotStore(base, job="ckpt")
        store.write_rank(0, 0, snap)
        store.commit(0, nranks=1, extra={"step": snap_at})
    elif kind == "sharded":
        import ompi_tpu_torch

        store = ShardedSnapshotStore(base, ompi_tpu_torch.init(), job="ckpt")
        with fcoll_recorded(fcoll):
            store.save(0, snap, extra={"step": snap_at})
    else:
        store = DcpStore(base, job="ckpt")
        store.save(0, snap)
    write_s = time.perf_counter() - t0
    leaves = sorted(snap)
    del snap
    nbytes = _dir_bytes(store.snapshot_dir(0))
    if kind == "sharded":
        files = sorted(os.listdir(store.snapshot_dir(0)))
        meta = store.metadata(0)
        check(files == sorted([f"{k}.bin" for k in leaves]
                              + ["metadata.json"])
              and meta.get("layout") == "sharded-file"
              and sorted(meta["arrays"]) == leaves,
              f"sharded: the snapshot directory holds {files}, layout "
              f"{meta.get('layout')!r}")
    ref_losses, params, state = steps(params, state,
                                      toks[snap_at:snap_at + more])
    ref = (params, state)

    def restored():
        t0 = time.perf_counter()
        if kind == "dcp":
            blobs = store.restore(store.latest())
        else:
            with fcoll_recorded(fcoll):
                blobs = store.load_rank(store.latest(), 0)
        p, s = from_train_state(blobs, cfg, DEVICE, mesh=mesh)
        torch.cuda.synchronize()
        return p, s, time.perf_counter() - t0

    p1, s1, read_s = restored()
    count = (s1["opt"] if isinstance(s1, dict) else s1).count
    check(int(count) == snap_at, f"the restored step count {count}")
    got1, p1, s1 = steps(p1, s1, toks[snap_at:snap_at + more])
    vs_ref = _leaves_equal(ref, (p1, s1))
    del ref, params, state
    p2, s2, _ = restored()
    got2, p2, s2 = steps(p2, s2, toks[snap_at:snap_at + more])
    spread = _leaves_equal((p1, s1), (p2, s2))
    del p1, s1, p2, s2
    shutil.rmtree(store.base)
    if kind == "sharded":
        ompi_tpu_torch.finalize()       # the one-rank world's transports
    deterministic = got1 == got2 and not any(spread.values())
    res = {"bytes": nbytes, "write_s": write_s, "read_s": read_s,
           "write_GBps": nbytes / write_s / 1e9,
           "read_GBps": nbytes / read_s / 1e9,
           "losses_reference": ref_losses, "losses_resumed": got1,
           "losses_resumed_again": got2, "deterministic": deterministic}
    if kind == "sharded":
        res["fcoll"] = sorted(set(fcoll))
        res["files"] = len(leaves) + 1
    if deterministic:
        check(got1 == ref_losses and not any(vs_ref.values()),
              f"{kind}: the resumed run differs from the uninterrupted "
              f"one: losses {got1} vs {ref_losses}, leaves "
              f"{ {k: v for k, v in vs_ref.items() if v} }")
        res["resume"] = "bitwise"
        return res
    # a nondeterministic op: name it, then hold the resume at the spread
    torch.use_deterministic_algorithms(True)
    try:
        p3, s3, _ = restored()
        steps(p3, s3, toks[snap_at:snap_at + 1])
        res["nondeterministic_op"] = None
    except RuntimeError as e:       # the op that has no deterministic form
        res["nondeterministic_op"] = str(e).splitlines()[0]
    finally:
        torch.use_deterministic_algorithms(False)
    worse = {k: (vs_ref[k], spread[k]) for k in vs_ref
             if vs_ref[k] > spread[k]}
    check(not worse, f"{kind}: the resume is off by more than two "
          f"continuations from one state differ: {worse}")
    res["resume"] = "within the spread of two continuations"
    res["spread_max"] = max(spread.values())
    return res


@contextlib.contextmanager
def fcoll_recorded(into: list):
    """A context in which every collective IO call of ``mpi.io`` appends
    the fcoll component it chose to ``into``."""
    from ompi_tpu_torch.mpi import io as mio

    orig = mio.File._fcoll_component

    def rec(self, *a):
        comp = orig(self, *a)
        into.append(comp)
        return comp

    mio.File._fcoll_component = rec
    try:
        yield into
    finally:
        mio.File._fcoll_component = orig


def phase_ckpt(fa, card, params_np):
    """Checkpoint/restart of the flagship's training state on the card:
    the dense model at its widths and ``CUT_LAYERS`` of its layers (the
    first layers of ``params_np``), phase train's config and batch, one
    rank; 2 steps, a snapshot (params, f32 moments and the step count:
    ~1.4 GB),
    2 steps as the reference, a restore into fresh tensors and the same
    2 steps, bitwise, through SnapshotStore, DcpStore and
    ShardedSnapshotStore (one file per leaf through collective MPI-IO,
    over a one-rank world of ``init()``); then the
    small bf16 config (bf16 params and moments, grad_accum 2) through
    SnapshotStore, which puts the bf16 manifest to work without
    ml_dtypes.  Returns the flash kernels' launches on this path."""
    import shutil

    import torch

    from ompi_tpu_torch.core.config import var_registry
    from ompi_tpu_torch.models.transformer import (TransformerConfig,
                                                   init_params)
    from ompi_tpu_torch.parallel.mesh import make_mesh

    here = os.path.dirname(os.path.abspath(__file__))
    base = os.path.join(here, "build", "ckpt_smoke")
    os.makedirs(base, exist_ok=True)
    cfg = TransformerConfig(**flagship_cut(), seq=TRAIN["seq"],
                            attention="flash", compute_dtype="bfloat16",
                            remat="dots", ce_chunk=TRAIN["ce_chunk"])
    params_np = cut_layers(params_np, cfg.n_layers)
    n_params = sum(int(np.prod(v.shape)) for v in params_np.values())
    need = 3 * 4 * n_params                 # f32 params, mu, nu
    free = shutil.disk_usage(base).free
    check(free >= 1.5 * need,
          f"ckpt: {free / 1e9:.1f} GB free under {base}, a snapshot takes "
          f"{need / 1e9:.1f} GB")
    mesh = make_mesh({"dp": 1, "sp": 1, "tp": 1}, device=DEVICE)
    rng = np.random.default_rng(12)
    toks = [rng.integers(0, cfg.vocab, size=(TRAIN["batch"], cfg.seq))
            .astype(np.int32) for _ in range(4)]
    var_registry.set("ops_flash_bwd_kernel", True)
    stores = {}
    L = cfg.n_layers
    try:
        zero_counts(fa)
        for kind in ("npz", "dcp", "sharded"):
            stores[kind] = _resume(cfg, mesh, params_np, toks, kind, base,
                                   snap_at=2, more=2)
            torch.cuda.empty_cache()
        launches = counts(fa)
        small = TransformerConfig(
            vocab=128, d_model=64, n_heads=4, n_layers=2, d_ff=128, seq=32,
            attention="flash", compute_dtype="float32",
            param_dtype="bfloat16", adam_mu_dtype="bfloat16", grad_accum=2)
        small_toks = [rng.integers(0, 128, size=(4, 32)).astype(np.int32)
                      for _ in range(5)]
        stores["small_bf16_npz"] = _resume(
            small, mesh, init_params(small, seed=5), small_toks, "npz",
            base, snap_at=3, more=2)
    finally:
        var_registry.set("ops_flash_bwd_kernel", False)
        shutil.rmtree(base, ignore_errors=True)
    # 2 + 2 + 2 + 2 steps a store: the reference and two continuations
    n_steps = 3 * 8
    check(launches == {"flash_fwd": 2 * L * n_steps,
                       "flash_bwd_dq": L * n_steps,
                       "flash_bwd_dkv": L * n_steps},
          f"ckpt launches in {n_steps} steps: {launches}")
    emit("ckpt", config=f"flagship dense at {cfg.n_layers} of its 8 layers "
         "(its widths), phase train's config, batch 16 x 1024, one rank; "
         "then the small bf16 config (bf16 params and "
         "moments, grad_accum 2)", n_params=n_params, stores=stores,
         launches=launches, card=card)
    return launches


# ---------------------------------------------------------------------------
# phase ft: fault tolerance on the card
# ---------------------------------------------------------------------------

FT_STEPS = 6                 # (a) optimizer steps in each job
FT_KILL_STEP = 5             # (a) rank=0:kill@step=5, after snapshots 2, 4
FT_SNAP_EVERY = 2            # (a) a CheckpointManager snapshot every 2 steps
FT_FREE_BYTES = 70e9         # (a) card memory free when the new life starts
FT_JOB_TIMEOUT = 300         # every ft job's launcher timeout (exit 124)
FT_SHRINK = dict(np=4, victim=2, kill_step=3, steps=6)     # (b)
FT_AGREE_CALLS = 1000        # (b) agree calls at n = 4, no failure
FT_COLL = dict(np=4, victim=2, kill_coll=5, steps=10, elems=1 << 18)  # (c)
FT_WATCHDOG_S = 10.0         # (d) multihost.shutdown's bound
#: code the (a) rank runs before its body (a rehearsal on the CPU sets
#: the small shapes and DEVICE there)
FT_RANK_PRELUDE = ""


def _ft_digest(params, state) -> dict:
    """{leaf: [sum of the bits, index-weighted sum of the bits]} of every
    parameter and moment leaf and the step count, computed on the card:
    two runs whose leaves agree bit for bit give equal digests."""
    import torch

    leaves = {f"p_{k}": v for k, v in params.items()}
    leaves.update({f"mu_{k}": v for k, v in state.mu.items()})
    leaves.update({f"nu_{k}": v for k, v in state.nu.items()})
    out = {"count": int(state.count)}
    for k in sorted(leaves):
        t = leaves[k].detach().contiguous().reshape(-1)
        bits = t.view(torch.int32 if t.element_size() == 4
                      else torch.int16).to(torch.int64)
        w = (torch.arange(bits.numel(), device=t.device, dtype=torch.int64)
             * 2654435761) % 4294967291 + 1
        out[k] = [int(bits.sum()), int((bits * w).sum())]
        del bits, w
    return out


def _proc_start_wall() -> float:
    """This process's start (fork/exec) as wall time, from /proc."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/stat") as f:
        btime = next(int(ln.split()[1]) for ln in f
                     if ln.startswith("btime"))
    return btime + start_ticks / os.sysconf("SC_CLK_TCK")


def ft_train_rank(ckpt_dir: str) -> None:
    """Rank body of phase ft (a), one life: the flagship's training at
    phase train's config on ``cuda:0``; a snapshot every 2 steps through
    an async ``CheckpointManager``; a revived life restores the latest
    committed snapshot onto the card and resumes from it.  Prints
    ``FT_LIFE``, a ``FT_STEP`` line before each step (the fault plan's
    kill fires in ``faultinject.step()`` right after) and ``FT_RESULT``
    with the final digest."""
    t_py = time.time()
    import torch

    import ompi_tpu_torch
    from ompi_tpu_torch.ckpt import CheckpointManager, SnapshotStore
    from ompi_tpu_torch.core.config import var_registry
    from ompi_tpu_torch.models.transformer import (TransformerConfig,
                                                   init_params,
                                                   make_train_step)
    from ompi_tpu_torch.models.weights import (from_jax_params,
                                               from_train_state, train_state)
    from ompi_tpu_torch.parallel import multihost
    from ompi_tpu_torch.parallel.mesh import make_mesh
    from ompi_tpu_torch.testing import faultinject

    fa = importlib.import_module("ompi_tpu_torch.ops.flash_attention")
    life = int(os.environ.get("OMPI_TPU_RESTART") or 0)
    comm = ompi_tpu_torch.init()
    check(not multihost.is_initialized(),
          "ft: a rank under respawn joined the process group")
    if DEVICE == "cuda":
        check(torch.cuda.is_available() and torch.cuda.current_device() == 0,
              "ft: the rank is not on cuda:0")
        free, total = torch.cuda.mem_get_info()
        name = torch.cuda.get_device_name(0)
    else:
        free, total, name = 0, 0, DEVICE
    t_init = time.time()
    print("FT_LIFE " + json.dumps({
        "life": life, "free_bytes": free, "total_bytes": total,
        "device": name, "t_spawn":
        _proc_start_wall(), "t_py": t_py, "t_init": t_init}), flush=True)
    var_registry.set("ops_flash_bwd_kernel", True)
    cfg = TransformerConfig(**flagship_cut(), seq=TRAIN["seq"],
                            attention="flash", compute_dtype="bfloat16",
                            remat="dots",
                            ce_chunk=TRAIN["ce_chunk"])
    mesh = make_mesh({"dp": 1, "sp": 1, "tp": 1}, device=DEVICE)
    step, init = make_train_step(cfg, mesh, lr=1e-3)
    store = SnapshotStore(ckpt_dir, job="ft")
    mgr = CheckpointManager(comm, store, interval=FT_SNAP_EVERY,
                            keep_last=1, async_save=True)
    restored = mgr.auto_restore(
        restore_fn=lambda k, t: torch.as_tensor(t).to(DEVICE))
    if restored is None:
        check(life == 0, "ft: a revived life found no committed snapshot")
        params = from_jax_params(init_params(cfg, seed=0), cfg, DEVICE,
                                 train=True, mesh=mesh)
        state = init(params)
        start = 0
    else:
        start, blobs = restored
        check(all(v.device.type == DEVICE for v in blobs.values()
                  if hasattr(v, "device")),
              "ft: restore_fn left a leaf off the card")
        params, state = from_train_state(blobs, cfg, DEVICE, mesh=mesh)
        del blobs
        check(int(state.count) == start,
              f"ft: restored step count {int(state.count)} != {start}")
    if DEVICE == "cuda":
        torch.cuda.synchronize()
    t_restore = time.time()
    rng = np.random.default_rng(12)
    toks = [rng.integers(0, cfg.vocab, size=(TRAIN["batch"], cfg.seq))
            .astype(np.int32) for _ in range(FT_STEPS)]
    if os.environ.get("FT_NAME_OP"):
        torch.use_deterministic_algorithms(True)
        try:
            step(params, state, toks[start])
            op = None
        except RuntimeError as e:    # the op with no deterministic form
            op = str(e).splitlines()[0]
        print("FT_OP " + json.dumps({"op": op}), flush=True)
        ompi_tpu_torch.finalize()
        return
    zero_counts(fa)
    steps_ms, host_ms, losses = [], [], []
    t_first = None
    for s in range(start, FT_STEPS):
        in_flight = mgr._pending is not None and mgr._pending.is_alive()
        print("FT_STEP " + json.dumps({
            "life": life, "step": s, "t": time.time(),
            "launches": counts(fa)}), flush=True)
        faultinject.step()          # the plan's kill@step fires here
        t0 = time.perf_counter()
        params, state, loss = step(params, state, toks[s])
        losses.append(loss.item())  # synchronizes the step
        steps_ms.append(((time.perf_counter() - t0) * 1e3, in_flight))
        if t_first is None:
            t_first = time.time()
        if (s + 1) % FT_SNAP_EVERY == 0:
            # the save in three parts: waiting out the previous save (one
            # outstanding at most), train_state (the moments to pageable
            # numpy), the manager's host copy (params into pinned
            # buffers, the numpy leaves copied) before save returns
            t0 = time.perf_counter()
            mgr.wait()
            t1 = time.perf_counter()
            snap = train_state(params, state, cfg, mesh=mesh)
            t2 = time.perf_counter()
            mgr.save(s + 1, snap)
            t3 = time.perf_counter()
            host_ms.append({"wait_previous": (t1 - t0) * 1e3,
                            "train_state": (t2 - t1) * 1e3,
                            "manager_copy": (t3 - t2) * 1e3})
            del snap
            if s + 1 == FT_STEPS:
                mgr.wait()
                write_s = time.perf_counter() - t3
    nbytes = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in
                 os.walk(store.snapshot_dir(FT_STEPS)) for f in fs)
    print("FT_RESULT " + json.dumps({
        "life": life, "start": start, "t_restore": t_restore,
        "t_first_step": t_first, "losses": losses, "steps_ms": steps_ms,
        "host_copy_ms": host_ms, "snapshot_bytes": nbytes,
        "final_save_s": write_s, "launches": counts(fa),
        "digest": _ft_digest(params, state)}), flush=True)
    var_registry.set("ops_flash_bwd_kernel", False)
    ompi_tpu_torch.finalize()


def _ft_train_job(ckpt_dir: str, plan: str = "", extra_env=None):
    """One job of the (a) body: the port's launcher in this process (the
    API ``tpurun`` calls), ``--gpu``, ``errmgr respawn``, one rank; its
    tagged output lines, rc and the launcher's FT event timeline."""
    from ompi_tpu_torch.core.config import var_registry
    from ompi_tpu_torch.runtime import ftevents
    from ompi_tpu_torch.runtime.job import AppContext, Job
    from ompi_tpu_torch.runtime.launcher import LocalLauncher

    here = os.path.dirname(os.path.abspath(__file__))
    env = {"OMPI_TPU_MCA_errmgr": "respawn", **(extra_env or {})}
    if plan:
        env["OMPI_TPU_FAULT_PLAN"] = plan
    code = "\n".join(("import chip_smoke as C", FT_RANK_PRELUDE,
                      f"C.ft_train_rank({ckpt_dir!r})"))
    job = Job([AppContext(argv=[sys.executable, "-c", code], np=1,
                          env=env, cwd=here)])
    lines: list = []
    lock = threading.Lock()

    class _Sink:
        def __init__(self):
            self.buf = ""

        def write(self, s):
            with lock:
                self.buf += s
                while "\n" in self.buf:
                    ln, self.buf = self.buf.split("\n", 1)
                    lines.append((time.time(), ln))

        def flush(self):
            pass

    ftevents.log.clear()
    # respawn with one revive and no min-uptime reset: a life that
    # fails on its own ends the job instead of reviving until timeout
    policy = {"errmgr_": "respawn", "errmgr_max_restarts": 1,
              "errmgr_min_uptime_s": 0.0}
    old = {k: var_registry.get(k) for k in policy}
    for k, v in policy.items():
        var_registry.set(k, v)
    out, err = sys.stdout, sys.stderr
    sys.stdout = sys.stderr = _Sink()
    try:
        rc = LocalLauncher(want_gpu=DEVICE == "cuda",
                           timeout=FT_JOB_TIMEOUT).run(job)
    finally:
        sys.stdout, sys.stderr = out, err
        for k, v in old.items():
            var_registry.set(k, v)
    return rc, lines, ftevents.log.snapshot(job.jobid)


def _tagged(lines, tag: str) -> list[dict]:
    return tagged_json("\n".join(ln for _t, ln in lines), tag)


def _ft_spread_check(dirs: dict) -> dict:
    """The resumed job's final snapshot against the reference's, leaf by
    leaf, held at the spread of two uninterrupted runs (ref, ref2)."""
    import torch

    from ompi_tpu_torch.ckpt import SnapshotStore

    def load(d):
        st = SnapshotStore(d, job="ft")
        return st.load_rank(st.latest(), 0)

    ref, ref2, got = load(dirs["ref"]), load(dirs["ref2"]), load(dirs["fault"])
    worse = {}
    spread_max = 0.0
    def f64(v):
        return torch.as_tensor(v).double()

    for k in ref:
        a = f64(ref[k])
        spread = float((a - f64(ref2[k])).abs().max())
        off = float((a - f64(got[k])).abs().max())
        spread_max = max(spread_max, spread)
        if off > spread:
            worse[k] = (off, spread)
    check(not worse, f"ft: the revived run is off by more than two "
          f"uninterrupted runs differ: {worse}")
    return {"spread_max": spread_max}


def _ft_flagship(card) -> dict:
    """(a): the flagship's training killed at step 5 and revived in place
    on the card, against an uninterrupted job of the same body."""
    import shutil

    import torch

    here = os.path.dirname(os.path.abspath(__file__))
    base = os.path.join(here, "build", "ft_smoke")
    shutil.rmtree(base, ignore_errors=True)
    os.makedirs(base)
    need = 3 * 2.1e9                      # three jobs' final snapshots
    free_disk = shutil.disk_usage(base).free
    check(free_disk >= need, f"ft: {free_disk / 1e9:.1f} GB free under "
          f"{base}, the jobs' snapshots take {need / 1e9:.1f} GB")
    dirs = {k: os.path.join(base, k) for k in ("ref", "fault", "ref2")}
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
    res: dict = {"main_process_allocated_bytes":
                 torch.cuda.memory_allocated() if DEVICE == "cuda" else 0}
    try:
        rc, ref_lines, _ = _ft_train_job(dirs["ref"])
        check(rc == 0, f"ft: the uninterrupted job failed (rc {rc}):\n"
              + "\n".join(ln for _t, ln in ref_lines[-40:]))
        ref = _tagged(ref_lines, "FT_RESULT")[-1]
        check(ref["life"] == 0 and ref["start"] == 0,
              f"ft: the uninterrupted job was revived: {ref['life']}")
        plan = f"rank=0:kill@step={FT_KILL_STEP}"
        rc, lines, events = _ft_train_job(dirs["fault"], plan)
        check(rc == 0, f"ft: the job with {plan} failed (rc {rc}):\n"
              + "\n".join(ln for _t, ln in lines[-60:]))
        lives = {d["life"]: d for d in _tagged(lines, "FT_LIFE")}
        steps = _tagged(lines, "FT_STEP")
        results = _tagged(lines, "FT_RESULT")
        check(sorted(lives) == [0, 1] and len(results) == 1
              and results[0]["life"] == 1,
              f"ft: expected two lives and a result from the second, got "
              f"lives {sorted(lives)}, results {len(results)}")
        got = results[0]
        check(all(d["device"] == lives[0]["device"] for d in lives.values()),
              f"ft: the lives ran on different cards: {lives}")
        check(lives[1]["free_bytes"] >= FT_FREE_BYTES,
              f"ft: only {lives[1]['free_bytes'] / 1e9:.1f} GB of the card "
              f"free when the revived life started")
        kill = [d for d in steps if d["life"] == 0][-1]
        check(kill["step"] == FT_KILL_STEP,
              f"ft: life 0 reached step {kill['step']}, not the kill's")
        check(DEVICE != "cuda" or (
            kill["launches"]["flash_fwd"] > 0
            and got["launches"]["flash_fwd"] > 0
            and got["launches"]["flash_bwd_dq"] > 0
            and got["launches"]["flash_bwd_dkv"] > 0),
              f"ft: the flash kernels did not run in both lives: "
              f"{kill['launches']} / {got['launches']}")
        check(got["start"] in range(FT_SNAP_EVERY, FT_KILL_STEP + 1,
                                    FT_SNAP_EVERY),
              f"ft: the revived life resumed at {got['start']}")
        detect = next(e for e in events if e["kind"] == "detect")
        revive = next(e for e in events if e["kind"] == "revive")
        t_kill = kill["t"]
        l1 = lives[1]
        res["timeline_s"] = {
            "reap": detect["wall"] - t_kill,
            "respawn": revive["wall"] - detect["wall"],
            "interpreter_torch_cuda_init": l1["t_init"] - revive["wall"],
            "of_which_process_start_to_python": l1["t_py"] - l1["t_spawn"],
            "restore": got["t_restore"] - l1["t_init"],
            "kill_to_first_step_start": got["t_restore"] - t_kill,
            "first_step": got["t_first_step"] - got["t_restore"],
            "kill_to_first_step_done": got["t_first_step"] - t_kill}
        if got["digest"] == ref["digest"]:
            check(got["losses"] == ref["losses"][got["start"]:],
                  f"ft: equal leaves, different losses: {got['losses']} "
                  f"vs {ref['losses']}")
            res["resume"] = "bitwise"
        else:
            rc, lines2, _ = _ft_train_job(dirs["ref2"])
            check(rc == 0, f"ft: the second uninterrupted job failed ({rc})")
            ref2 = _tagged(lines2, "FT_RESULT")[-1]
            check(ref2["digest"] != ref["digest"],
                  "ft: the revived run differs from two identical "
                  "uninterrupted runs")
            res.update(_ft_spread_check(dirs))
            rc, lines3, _ = _ft_train_job(dirs["ref2"], "",
                                          {"FT_NAME_OP": "1"})
            res["nondeterministic_op"] = _tagged(lines3, "FT_OP")[-1]["op"]
            res["resume"] = "within the spread of two uninterrupted runs"
        in_flight = [ms for ms, f in ref["steps_ms"][1:] if f]
        idle = [ms for ms, f in ref["steps_ms"][1:] if not f]
        res.update(
            lives=2, resumed_at=got["start"],
            killed_at=FT_KILL_STEP, losses_reference=ref["losses"],
            losses_revived=got["losses"],
            free_gb_at_revived_start=l1["free_bytes"] / 1e9,
            snapshot_gb=ref["snapshot_bytes"] / 1e9,
            host_copy_ms=ref["host_copy_ms"],
            host_copy="pinned host buffers, one a key, reused by every "
                      "save (train_state moves the moments to pageable "
                      "numpy first)",
            final_write_s=ref["final_save_s"],
            write_GBps=ref["snapshot_bytes"] / ref["final_save_s"] / 1e9,
            step_ms_save_in_flight=in_flight,
            step_ms_no_save_in_flight=idle,
            first_step_ms_reference=ref["steps_ms"][0][0],
            launches={"life0_before_kill": kill["launches"],
                      "life1": got["launches"]})
    finally:
        shutil.rmtree(base, ignore_errors=True)
    return res


def _timed_tpurun(args, env=None) -> tuple:
    """A job of the port's launcher with each output line's arrival
    time: (rc, [(wall, line)])."""
    p = subprocess.Popen(
        [sys.executable, "-m", "ompi_tpu_torch.tools.tpurun", "--timeout",
         str(FT_JOB_TIMEOUT), *args], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True,
        cwd=os.path.dirname(os.path.abspath(__file__)),
        env={**os.environ, **(env or {})})
    lines = [(time.time(), ln.rstrip("\n")) for ln in p.stdout]
    return p.wait(), lines


def _fault_ts(log_dir: str, rank: int) -> float:
    with open(os.path.join(log_dir, f"faults_rank{rank}.json")) as f:
        return json.load(f)["ts"]


FT_AGREE_APP = """
import time, json
import ompi_tpu_torch
comm = ompi_tpu_torch.init()
comm.agree(True)
t0 = time.perf_counter()
for _ in range({n}):
    assert comm.agree(True) is True
us = (time.perf_counter() - t0) / {n} * 1e6
print("FT_AGREE " + json.dumps({{"rank": comm.rank, "us": us}}), flush=True)
ompi_tpu_torch.finalize()
"""


def _ft_shrink(card) -> dict:
    """(b): the ULFM recipe, ``examples/shrink_allreduce`` under notify
    with rank 2 killed at step 3; then agree's cost with no failure."""
    import shutil
    import tempfile

    S = FT_SHRINK
    tmp = tempfile.mkdtemp(prefix="ft_shrink_",
                           dir=os.path.join(os.path.dirname(
                               os.path.abspath(__file__)), "build"))
    try:
        rc, lines = _timed_tpurun(
            ["-np", str(S["np"]), "--mca", "errmgr", "notify",
             "--mca", "faultinject_plan",
             f"rank={S['victim']}:kill@step={S['kill_step']}",
             "-x", f"CKPT_DIR={tmp}/ckpt", "-x",
             f"OMPI_TPU_FAULT_LOG_DIR={tmp}", "--", sys.executable, "-m",
             "ompi_tpu_torch.examples.shrink_allreduce"])
        out = "\n".join(ln for _t, ln in lines)
        check(rc == 0, f"ft shrink_allreduce rc {rc}:\n{out[-3000:]}")
        want = 0
        for s in range(S["steps"]):
            want += sum(i * 10 + s for i in range(S["np"])
                        if s < S["kill_step"] or i != S["victim"])
        survivors = [i for i in range(S["np"]) if i != S["victim"]]
        for r in survivors:
            line = (f"[1,{r}]id {r} final acc={want} size={len(survivors)}"
                    f" shrinks=1")
            check(line in out, f"ft: missing {line!r}:\n{out[-3000:]}")
        t_kill = _fault_ts(tmp, S["victim"])
        detect = {r: t for t, ln in lines for r in survivors
                  if ln.startswith(f"[1,{r}]id {r} detect_dt=")}
        check(sorted(detect) == survivors,
              f"ft: survivors' detect lines {detect}")
        # revoke -> shrink, timed on a run without snapshots: with them
        # the shrink line follows the snapshot's load
        rc, lines = _timed_tpurun(
            ["-np", str(S["np"]), "--mca", "errmgr", "notify",
             "--mca", "faultinject_plan",
             f"rank={S['victim']}:kill@step={S['kill_step']}", "--",
             sys.executable, "-m",
             "ompi_tpu_torch.examples.shrink_allreduce"])
        check(rc == 0, f"ft shrink_allreduce without snapshots rc {rc}")
        bare = sum(i * 10 + s for s in range(S["steps"])
                   for i in survivors)
        got = "\n".join(ln for _t, ln in lines)
        for r in survivors:
            check(f"[1,{r}]id {r} final acc={bare} " in got,
                  f"ft: survivor {r} without snapshots:\n{got[-2000:]}")
        rdet = {r: t for t, ln in lines for r in survivors
                if ln.startswith(f"[1,{r}]id {r} detect_dt=")}
        shrank = {r: t for t, ln in lines for r in survivors
                  if ln.startswith(f"[1,{r}]id {r}: shrank")}
        check(sorted(rdet) == survivors and sorted(shrank) == survivors,
              f"ft: survivors' detect/shrink lines {rdet} {shrank}")
        rc, lines = _timed_tpurun(
            ["-np", "4", "--", sys.executable, "-c",
             FT_AGREE_APP.format(n=FT_AGREE_CALLS)])
        check(rc == 0, f"ft agree job rc {rc}")
        agree = {d["rank"]: d["us"] for d in _tagged(lines, "FT_AGREE")}
        check(sorted(agree) == [0, 1, 2, 3], f"ft agree rows {agree}")
        return {"expected_acc": want,
                "kill_to_first_err_proc_failed_s":
                    min(detect.values()) - t_kill,
                "revoke_to_shrink_ms": {r: (shrank[r] - rdet[r]) * 1e3
                                        for r in survivors},
                "agree_us_a_call_n4": agree,
                "agree_calls": FT_AGREE_CALLS}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


FT_COLL_APP = r"""
import json, os, time
import numpy as np
import ompi_tpu_torch
from ompi_tpu_torch.ckpt import snapc
from ompi_tpu_torch.ckpt.store import SnapshotStore
from ompi_tpu_torch.mpi import trace
from ompi_tpu_torch.mpi.constants import ERR_PROC_FAILED, MPIException

comm = ompi_tpu_torch.init()
rank, size = comm.rank, comm.size
life = snapc.restart_incarnation()
store = SnapshotStore(os.environ["CKPT_DIR"], job=f"rank{rank}")
start = 0
restored = snapc.auto_restore(comm, store, rank=0)
if restored is not None:
    start = int(restored[1]["step"]) + 1

def heal_retry(fn):
    # a failed attempt completed on NO rank (the arena is atomic at the
    # app level): re-running the whole op is the retry unit
    while True:
        try:
            return fn()
        except MPIException as e:
            if e.error_class != ERR_PROC_FAILED:
                raise
            time.sleep(0.05)

from ompi_tpu_torch.testing import faultinject
n, steps = int(os.environ["FT_ELEMS"]), int(os.environ["FT_STEPS"])
ok, t_first = 0, None
for step in range(start, steps):
    faultinject.step()
    x = np.arange(n, dtype=np.float32) % 251 + float(rank * 100 + step)
    t0 = time.time()
    out = heal_retry(lambda: comm.allreduce(x))
    if t_first is None:
        t_first = t0
    want = sum(np.arange(n, dtype=np.float32) % 251
               + np.float32(r * 100 + step) for r in range(size))
    ok += int(np.array_equal(out, want))
    store.write_rank(step, 0, {"step": np.int64(step)})
    store.commit(step, 1)
st = comm._coll_shm_state
print("FT_COLL " + json.dumps({
    "rank": rank, "life": life, "start": start, "steps": steps - start,
    "equal": ok, "t_first_coll": t_first, "mode": getattr(st, "mode", "?"),
    "rejoins": trace.counters["coll_rejoin_total"],
    "provider": comm.coll.providers.get("allreduce")}), flush=True)
ompi_tpu_torch.finalize()
"""


def _ft_selfheal(card) -> dict:
    """(c): selfheal through the arena — rank 2 killed inside its 5th
    collective of a 1 MiB allreduce loop over coll/shm, revived."""
    import shutil
    import tempfile

    C = FT_COLL
    tmp = tempfile.mkdtemp(prefix="ft_coll_",
                           dir=os.path.join(os.path.dirname(
                               os.path.abspath(__file__)), "build"))
    try:
        rc, lines = _timed_tpurun(
            ["-np", str(C["np"]), "--mca", "errmgr", "selfheal",
             "--mca", "faultinject_plan",
             f"rank={C['victim']}:kill@coll={C['kill_coll']}",
             "-x", f"CKPT_DIR={tmp}/ckpt", "-x",
             f"OMPI_TPU_FAULT_LOG_DIR={tmp}", "-x",
             f"FT_ELEMS={C['elems']}", "-x", f"FT_STEPS={C['steps']}",
             "--", sys.executable, "-c", FT_COLL_APP])
        out = "\n".join(ln for _t, ln in lines)
        check(rc == 0, f"ft selfheal job rc {rc}:\n{out[-3000:]}")
        rows = {d["rank"]: d for d in _tagged(lines, "FT_COLL")}
        check(sorted(rows) == list(range(C["np"])),
              f"ft selfheal rows {sorted(rows)}:\n{out[-3000:]}")
        victim = rows[C["victim"]]
        check(victim["life"] == 1, f"ft: rank {C['victim']} not revived: "
              f"{victim}")
        for r, d in rows.items():
            check(d["equal"] == d["steps"],
                  f"ft: rank {r}'s allreduce differs from numpy: {d}")
            check(d["provider"] == "shm" and d["mode"] == "arena",
                  f"ft: rank {r} left the arena: {d}")
            if r != C["victim"]:
                check(d["rejoins"] >= 1 and d["start"] == 0
                      and d["steps"] == C["steps"],
                      f"ft: survivor {r} did not rejoin: {d}")
        t_kill = _fault_ts(tmp, C["victim"])
        return {"rows": rows,
                "kill_to_revived_first_collective_s":
                    victim["t_first_coll"] - t_kill}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


FT_GPU_NOTIFY_APP = r"""
import json, time
import numpy as np
import ompi_tpu_torch
from ompi_tpu_torch.mpi.constants import (ERR_PROC_FAILED, ERR_REVOKED,
    MPIException)
from ompi_tpu_torch.parallel import multihost
from ompi_tpu_torch.testing import faultinject

comm = ompi_tpu_torch.init()
me, group = comm.rank, multihost.is_initialized()
acc, shrunk = 0.0, None
for step in range(4):
    faultinject.step()
    try:
        acc += float(comm.allreduce(np.array([1.0 + step]))[0])
    except MPIException as e:
        if e.error_class not in (ERR_PROC_FAILED, ERR_REVOKED):
            raise
        comm.revoke()
        comm = comm.shrink()
        shrunk = step
        acc += float(comm.allreduce(np.array([1.0 + step]))[0])
t0 = time.monotonic()
ompi_tpu_torch.finalize()
print("FT_GPU " + json.dumps({"rank": me, "group": group, "acc": acc,
      "shrunk_at": shrunk, "finalize_s": time.monotonic() - t0}),
      flush=True)
"""


def _ft_gpu_notify(card) -> dict:
    """(d): a ``--gpu`` notify job (both ranks on card 0, one gloo group)
    that loses rank 1; rank 0 finishes on the host route and leaves."""
    t0 = time.perf_counter()
    rc, lines = _timed_tpurun(
        ["-np", "2", "--gpu", "--mca", "errmgr", "notify",
         "--mca", "faultinject_plan", "rank=1:kill@step=1", "--",
         sys.executable, "-c", FT_GPU_NOTIFY_APP])
    wall = time.perf_counter() - t0
    out = "\n".join(ln for _t, ln in lines)
    check(rc == 0, f"ft --gpu notify job rc {rc}:\n{out[-3000:]}")
    rows = {d["rank"]: d for d in _tagged(lines, "FT_GPU")}
    check(sorted(rows) == [0], f"ft --gpu notify rows {rows}")
    r0 = rows[0]
    check(r0["group"] and r0["shrunk_at"] == 1 and r0["acc"] == 11.0,
          f"ft --gpu notify: {r0}")
    check(r0["finalize_s"] < FT_WATCHDOG_S,
          f"ft: rank 0's finalize took {r0['finalize_s']:.1f} s")
    return {"rank0": r0, "job_wall_s": wall}


def phase_ft(card):
    """Fault tolerance on the card: (a) the flagship's training revived in
    place, (b) the ULFM recipe, (c) selfheal through the arena, (d) a
    ``--gpu`` notify job with a dead member."""
    t0 = time.perf_counter()
    flagship = _ft_flagship(card)
    secs_a = time.perf_counter() - t0
    with ThreadPoolExecutor(3) as ex:
        b = ex.submit(_ft_shrink, card)
        c = ex.submit(_ft_selfheal, card)
        d = ex.submit(_ft_gpu_notify, card)
        shrink, selfheal, gpu = b.result(), c.result(), d.result()
    emit("ft", flagship=flagship, shrink=shrink, selfheal=selfheal,
         gpu_notify=gpu, seconds_a=secs_a,
         seconds_bcd=time.perf_counter() - t0 - secs_a, card=card)


# ---------------------------------------------------------------------------
# phase io: MPI-IO through the port's launcher
# ---------------------------------------------------------------------------

IO_NP = 4                    # ranks of (b) and (c)
#: (b) side of the f32 matrix: 64 MiB in one file (16384, 1 GiB, took
#: 9–12 s an aggregating collective call on the H100 machine's 9p
#: filesystem, 136 s for (b); 8192, 256 MiB, 2.2 s a call until phase
#: tools had to be paid for)
IO_MATRIX = 4096
IO_CYCLIC = (4096, 256)      # (b) side and cyclic block of the 2nd darray
IO_FCOLL = ("individual", "two_phase", "dynamic", "static", "dynamic_gen2",
            "")              # (b) forced components, then the auto decision
IO_CYCLIC_FCOLL = ("two_phase", "individual")
IO_SHARED = dict(records=64, record_bytes=1 << 20, ordered_bytes=16 << 20)
#: code the io ranks run before their body (a rehearsal on the CPU sets
#: the small shapes there)
IO_RANK_PRELUDE = ""


def _io_record(rank: int, i: int, nbytes: int) -> np.ndarray:
    """Record i of a rank for the shared-pointer writes: (rank, i) in its
    first 16 bytes, a pattern of both after them."""
    rec = np.empty(nbytes, np.uint8)
    rec[:16] = np.array([rank, i], np.int64).view(np.uint8)
    rec[16:] = (np.arange(nbytes - 16) + rank * 131 + i * 7) % 251
    return rec


def io_collective_rank(cfg: dict) -> None:
    """Rank body of phase io (b), a host rank: a 2-d darray view of one
    f32 matrix written with one ``write_at_all`` and read with one
    ``read_at_all`` under each fcoll component and the auto decision,
    a block × cyclic darray under two_phase and individual, then the
    shared file pointer (``write_shared`` under sm and lockedfile) and
    ``write_ordered``.  Rank 0 checks each file on disk against the
    matrix assembled with numpy; every rank checks its read-back.
    Prints one ``IO_B`` line a rank."""
    import math

    import ompi_tpu_torch
    from ompi_tpu_torch.core.config import var_registry
    from ompi_tpu_torch.mpi import datatype as dt
    from ompi_tpu_torch.mpi import io as mio
    from ompi_tpu_torch.mpi import op as op_mod

    comm = ompi_tpu_torch.init()
    r, n = comm.rank, comm.size
    q = math.isqrt(n)
    check(q * q == n, f"io: {n} ranks make no square grid")
    d = cfg["dir"]
    row = {"rank": r, "fs_type": mio._fs_type(d), "darray": {},
           "cyclic": {}, "shared": {}}

    def agree(ok: bool) -> bool:
        return bool(int(np.asarray(comm.allreduce(
            np.array([int(ok)], np.int32), op=op_mod.MIN))[0]))

    def roundtrip(path, view, local, whole, comp):
        """One write_at_all and one read_at_all of ``local`` through
        ``view`` under ``comp`` ('' = auto); rank 0 holds the file to
        ``whole``."""
        var_registry.set("io_fcoll", comp)
        chose: list = []
        try:
            f = mio.File.open(comm, path, mio.MODE_RDWR | mio.MODE_CREATE)
            f.set_view(0, dt.FLOAT32, view)
            with fcoll_recorded(chose):
                comm.barrier()
                t0 = time.perf_counter()
                f.write_at_all(0, local)
                comm.barrier()
                t1 = time.perf_counter()
                back = f.read_at_all(0, local.size)
                comm.barrier()
                t2 = time.perf_counter()
            f.close()
        finally:
            var_registry.set("io_fcoll", "")
        ok = back.tobytes() == local.tobytes()
        if r == 0:
            ok = ok and np.fromfile(path, np.uint8).tobytes() \
                == whole.tobytes()
            os.unlink(path)
        gb = whole.nbytes / 1e9
        return {"chose": sorted(set(chose)), "ok": agree(ok),
                "write_s": t1 - t0, "read_s": t2 - t1,
                "write_GBps": gb / (t1 - t0), "read_GBps": gb / (t2 - t1)}

    # (b1) block x block on the q x q grid
    side = cfg["side"]
    whole = np.random.default_rng(21).random((side, side), np.float32)
    pr, pc = divmod(r, q)
    b = side // q
    local = np.ascontiguousarray(whole[pr * b:(pr + 1) * b,
                                       pc * b:(pc + 1) * b])
    view = dt.create_darray(n, r, [side, side],
                            [dt.DISTRIBUTE_BLOCK, dt.DISTRIBUTE_BLOCK],
                            [dt.DISTRIBUTE_DFLT_DARG] * 2, [q, q],
                            dt.FLOAT32).commit()
    for comp in cfg["fcoll"]:
        row["darray"][comp or "auto"] = roundtrip(
            os.path.join(d, f"block_{comp or 'auto'}.bin"), view, local,
            whole, comp)
    del whole, local
    # (b2) block x cyclic(blk)
    side2, blk = cfg["cyclic"]
    whole = np.random.default_rng(22).random((side2, side2), np.float32)
    b = side2 // q
    rows = np.arange(pr * b, (pr + 1) * b)
    cols = np.array([c for c in range(side2) if (c // blk) % q == pc])
    local = np.ascontiguousarray(whole[np.ix_(rows, cols)])
    view = dt.create_darray(n, r, [side2, side2],
                            [dt.DISTRIBUTE_BLOCK, dt.DISTRIBUTE_CYCLIC],
                            [dt.DISTRIBUTE_DFLT_DARG, blk], [q, q],
                            dt.FLOAT32).commit()
    for comp in cfg["cyclic_fcoll"]:
        row["cyclic"][comp] = roundtrip(
            os.path.join(d, f"cyclic_{comp}.bin"), view, local, whole, comp)
    del whole, local
    # (b3) the shared file pointer, then the ordered write
    S = cfg["shared"]
    recs, nb = S["records"], S["record_bytes"]
    mine = [_io_record(r, i, nb) for i in range(recs)]
    for comp in ("sm", "lockedfile"):
        path = os.path.join(d, f"shared_{comp}.bin")
        var_registry.set("io_sharedfp", comp)
        try:
            f = mio.File.open(comm, path, mio.MODE_RDWR | mio.MODE_CREATE)
            ran = f._shfp.name
            comm.barrier()
            t0 = time.perf_counter()
            for rec in mine:
                f.write_shared(rec)
            comm.barrier()
            secs = time.perf_counter() - t0
            f.close()
        finally:
            var_registry.set("io_sharedfp", "")
        ok = ran == comp
        if r == 0:
            got = np.fromfile(path, np.uint8)
            ok = ok and got.size == n * recs * nb
            seen = set()
            for rec in got.reshape(-1, nb) if ok else ():
                who, i = (int(v) for v in rec[:16].view(np.int64))
                ok = ok and 0 <= who < n and 0 <= i < recs \
                    and (who, i) not in seen \
                    and rec.tobytes() == _io_record(who, i, nb).tobytes()
                seen.add((who, i))
            ok = ok and len(seen) == n * recs
            os.unlink(path)
        row["shared"][comp] = {"ok": agree(ok), "seconds": secs,
                               "records_per_s": n * recs / secs}
    ob = S["ordered_bytes"]
    path = os.path.join(d, "ordered.bin")
    data = ((np.arange(ob) + r * 17) % 253).astype(np.uint8)
    f = mio.File.open(comm, path, mio.MODE_RDWR | mio.MODE_CREATE)
    comm.barrier()
    t0 = time.perf_counter()
    f.write_ordered(data)
    comm.barrier()
    secs = time.perf_counter() - t0
    f.close()
    ok = True
    if r == 0:
        want = np.concatenate([((np.arange(ob) + k * 17) % 253).astype(
            np.uint8) for k in range(n)])
        ok = np.fromfile(path, np.uint8).tobytes() == want.tobytes()
        os.unlink(path)
    row["ordered"] = {"ok": agree(ok), "seconds": secs,
                      "GBps": n * ob / secs / 1e9}
    print("IO_B " + json.dumps(row), flush=True)
    ompi_tpu_torch.finalize()


def _io_cut(nrows: int, n: int) -> list[int]:
    """Row bounds of a ragged cut of ``nrows`` over ``n`` ranks: rank r
    holds [⌊r·nrows/n⌋, ⌊(r+1)·nrows/n⌋), and where n divides nrows rank
    0 takes one row more (rank 1 one less)."""
    b = [nrows * k // n for k in range(n + 1)]
    if nrows % n == 0 and nrows >= n:
        b[1] += 1
    return b


def io_card_rank(cfg: dict) -> None:
    """Rank body of phase io (c), a ``--gpu`` rank (all on card 0): a
    ragged row cut of every leaf of the flagship's ``init_params`` (seed
    0) and a bf16 copy of it, on the card, saved collectively through
    ``ShardedSnapshotStore`` (rank 0's save inside a profiler window that
    counts the device-to-host copies), loaded back for this rank's own
    block and its neighbour's, each leaf moved to the card and held with
    ``torch.equal`` against the expected cut.  Prints one ``IO_C`` line
    a rank."""
    import shutil

    import torch
    from torch.profiler import ProfilerActivity, profile

    import ompi_tpu_torch
    from ompi_tpu_torch.ckpt import ShardedSnapshotStore
    from ompi_tpu_torch.models.transformer import (TransformerConfig,
                                                   init_params)

    comm = ompi_tpu_torch.init()
    r, n = comm.rank, comm.size
    dev = torch.device(f"{DEVICE}:0") if DEVICE == "cuda" else \
        torch.device(DEVICE)
    params = init_params(TransformerConfig(**flagship_cut(IO_CUT_LAYERS)),
                         seed=0)
    cuts = {k: _io_cut(v.shape[0], n) for k, v in params.items()}

    def cut(k, rank):
        b = cuts[k]
        return torch.from_numpy(np.ascontiguousarray(
            params[k][b[rank]:b[rank + 1]])).to(dev)

    state = {}
    for k in sorted(params):
        state[k] = cut(k, r)
        state[k + "_bf16"] = state[k].to(torch.bfloat16)
    nbytes = sum(t.numel() * t.element_size() for t in state.values())
    store = ShardedSnapshotStore(cfg["dir"], comm, job="card")
    if DEVICE == "cuda":
        torch.cuda.synchronize()
    comm.barrier()
    t0 = time.perf_counter()
    copies = None
    if r == 0:
        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if DEVICE == "cuda" else [])
        with profile(activities=acts) as prof:
            state["lnf"][:1].clone()           # a window may miss its first
            store.save(0, state)
            state["lnf"][:1].cpu()             # the control: one DtoH
            if DEVICE == "cuda":
                torch.cuda.synchronize()
        copies = profiler_copies(prof)
    else:
        store.save(0, state)
    comm.barrier()
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    own = store.load(0)
    comm.barrier()
    load_s = time.perf_counter() - t0
    nb = (r + 1) % n
    other = store.load(0, rank=nb)
    ok = {"own": True, "neighbour": True, "bf16": True}
    for k in sorted(params):
        for suffix in ("", "_bf16"):
            key = k + suffix
            a = torch.as_tensor(own[key]).to(dev)
            b = torch.as_tensor(other[key]).to(dev)
            want_b = cut(k, nb)
            if suffix:
                want_b = want_b.to(torch.bfloat16)
                ok["bf16"] &= (a.dtype == b.dtype == torch.bfloat16
                               and isinstance(own[key], torch.Tensor))
            ok["own"] &= bool(torch.equal(a, state[key]))
            ok["neighbour"] &= bool(torch.equal(b, want_b))
    meta = store.metadata(0)
    shapes_ok = meta.get("layout") == "sharded-file" and all(
        [s["shape"][0] for s in meta["arrays"][k + sfx]]
        == [cuts[k][i + 1] - cuts[k][i] for i in range(n)]
        for k in params for sfx in ("", "_bf16"))
    row = {"rank": r, "leaves": len(state), "bytes": nbytes,
           "save_s": save_s, "load_s": load_s,
           "device": str(state["lnf"].device), "ok": ok,
           "ragged_shapes_ok": shapes_ok, "copies": copies,
           "fs_type": None}
    comm.barrier()
    if r == 0:
        from ompi_tpu_torch.mpi import io as mio

        row["fs_type"] = mio._fs_type(cfg["dir"])
        shutil.rmtree(store.base, ignore_errors=True)
    print("IO_C " + json.dumps(row), flush=True)
    ompi_tpu_torch.finalize()


def phase_io(card, sizes=None):
    """MPI-IO through the port's launcher: (a) ``examples/mpiio_darray``
    at -np 4; (b) 4 host ranks: one f32 matrix through a darray view under
    every fcoll component and the auto decision, a block × cyclic darray,
    the shared file pointer under sm and lockedfile and an ordered write,
    every file held bitwise to numpy; (c) ``--gpu -np 4`` ranks on the one
    card: ragged cuts of the flagship's parameters (f32 and bf16) on the
    card through ``ShardedSnapshotStore`` and back.  The files live under
    ``build/io_smoke/`` and are removed."""
    import shutil

    here = os.path.dirname(os.path.abspath(__file__))
    base = os.path.join(here, "build", "io_smoke")
    os.makedirs(base, exist_ok=True)
    cfg = {"dir": base, "side": IO_MATRIX, "cyclic": list(IO_CYCLIC),
           "fcoll": list(IO_FCOLL), "cyclic_fcoll": list(IO_CYCLIC_FCOLL),
           "shared": IO_SHARED, **(sizes or {})}
    def body(fn):
        return "\n".join(("import json", "import chip_smoke as C",
                          f"C.DEVICE = {DEVICE!r}", IO_RANK_PRELUDE,
                          f"C.{fn}(json.loads({json.dumps(cfg)!r}))"))

    secs = {}
    try:
        wall, rc, out, err = tpurun(
            ["-np", str(IO_NP), "--", sys.executable, "-m",
             "ompi_tpu_torch.examples.mpiio_darray"])
        check(rc == 0 and "darray collective IO ok" in out,
              f"io: mpiio_darray rc {rc}:\n{out[-2000:]}{err[-2000:]}")
        secs["mpiio_darray"] = wall
        wall, rc, out, err = tpurun(
            ["-np", str(IO_NP), "--", sys.executable, "-c",
             body("io_collective_rank")])
        check(rc == 0, f"io (b) rc {rc}:\n{out[-2000:]}{err[-2000:]}")
        secs["collective"] = wall
        rows = {d["rank"]: d for d in tagged_json(out, "IO_B")}
        check(sorted(rows) == list(range(IO_NP)), f"io (b) rows {rows}")
        b0 = rows[0]
        for part in ("darray", "cyclic", "shared"):
            bad = {k: v for k, v in b0[part].items() if not v["ok"]}
            check(not bad, f"io (b) {part}: {bad}")
        check(b0["ordered"]["ok"], f"io (b) ordered: {b0['ordered']}")
        for comp, v in b0["darray"].items():
            if comp != "auto":
                check(v["chose"] == [comp], f"io (b) forced {comp}: {v}")
        wall, rc, out, err = tpurun(
            ["-np", str(IO_NP), *(["--gpu"] if DEVICE == "cuda" else []),
             "--", sys.executable, "-c", body("io_card_rank")])
        check(rc == 0, f"io (c) rc {rc}:\n{out[-2000:]}{err[-2000:]}")
        secs["card"] = wall
        crow = {d["rank"]: d for d in tagged_json(out, "IO_C")}
        check(sorted(crow) == list(range(IO_NP)), f"io (c) rows {crow}")
        for rk, v in crow.items():
            check(all(v["ok"].values()) and v["ragged_shapes_ok"],
                  f"io (c) rank {rk}: {v}")
            check(v["device"].startswith(DEVICE),
                  f"io (c) rank {rk} held its leaves on {v['device']}")
        c0 = crow[0]
        if DEVICE == "cuda":
            check(c0["copies"]["dtoh"] == c0["leaves"] + 1,
                  f"io (c): rank 0's save made {c0['copies']} copies for "
                  f"{c0['leaves']} leaves (and one control copy)")
        total = sum(v["bytes"] for v in crow.values())
        save_s = max(v["save_s"] for v in crow.values())
        load_s = max(v["load_s"] for v in crow.values())
    finally:
        shutil.rmtree(base, ignore_errors=True)
    emit("io", fs_type=b0["fs_type"], matrix=[cfg["side"]] * 2,
         darray={k: {kk: v[kk] for kk in ("chose", "write_GBps",
                                         "read_GBps", "write_s", "read_s")}
                 for k, v in b0["darray"].items()},
         cyclic=b0["cyclic"], shared=b0["shared"], ordered=b0["ordered"],
         card_store={"ranks": IO_NP, "bytes": total, "save_s": save_s,
                     "load_s": load_s, "save_GBps": total / save_s / 1e9,
                     "load_GBps": total / load_s / 1e9,
                     "rank0_copies": c0["copies"], "fs_type": c0["fs_type"],
                     "leaves_a_rank": c0["leaves"]},
         seconds=secs, card=card)


# ---------------------------------------------------------------------------
# phase osc: host RMA windows and OpenSHMEM
# ---------------------------------------------------------------------------

OSC_NP = 4                   # ranks of (b) and (c)
#: (b)'s bulk size: a window part, an accumulate (64 MiB made the phase
#: 62.5 s of its 60 s budget on the H100 machine; the cut the phase's
#: budget allows first)
OSC_MIB = 16
OSC_CARD_MIB = 64            # (c) a CUDA tensor's size, f32 and bf16
OSC_SMALL = dict(iters=200, bulk_iters=3, tickets=2500, fetch_adds=100_000,
                 lock_rounds=1000)
#: (a) the one-sided examples: (module, ranks, marker) at the reference's
#: rank counts (tests/runtime/test_examples.py, tests/shmem/test_shmem.py)
OSC_EXAMPLES = (("ring_oshmem", 3, "exiting"),
                ("oshmem_shmalloc", 3, "shmalloc/shfree ok"),
                ("oshmem_circular_shift", 3, "circular shift ok"),
                ("oshmem_symmetric_data", 3, "verified symmetric data"),
                ("rma_pscw", 3, "dynamic window ok"),
                ("oshmem_max_reduction", 4, "max reduction ok"),
                ("oshmem_strided_puts", 2, "strided put ok"))


def _osc_ints(seed: int, n: int, dtype=np.float32) -> np.ndarray:
    """Small integers (a sum of four is exact in f32, in any order)."""
    return np.random.default_rng(seed).integers(
        0, 1000, n).astype(dtype)


def osc_host_rank(cfg: dict) -> None:
    """Rank body of phase osc (b), a host rank.  Rank 0 times its calls;
    every rank checks what landed in its own memory and the verdicts are
    agreed (MIN over the ranks).  Prints one ``OSC_B`` line a rank."""
    from ompi_tpu_torch import shmem
    from ompi_tpu_torch.mpi import op as op_mod
    from ompi_tpu_torch.mpi.constants import COMM_TYPE_SHARED
    from ompi_tpu_torch.mpi.osc import SharedWindow, Window

    boot = time.time() - _proc_start_wall()
    t_body = time.perf_counter()
    comm = shmem.init()
    r, n = comm.rank, comm.size
    check(n >= 4 and n % 2 == 0, f"osc (b) needs an even count >= 4: {n}")
    elems = (cfg["mib"] << 20) // 4
    nbytes = elems * 4
    iters, bulk = cfg["iters"], cfg["bulk_iters"]
    row = {"rank": r, "ok": {}, "us": {}, "GBps": {}, "seconds": {},
           "boot_s": boot, "marks": {}}
    pc = time.perf_counter

    def mark(what: str) -> None:
        """Seconds from the body's start to the end of a part."""
        row["marks"][what] = pc() - t_body

    mark("init")

    def agree(key: str, ok: bool) -> None:
        row["ok"][key] = bool(int(np.asarray(comm.allreduce(
            np.array([int(ok)], np.int32), op=op_mod.MIN))[0]))

    def median(ts) -> float:
        return float(np.median(ts))

    # -- put/get between ranks 0 and 1, under a fence and under locks ----
    win = Window(comm, size=elems, dtype=np.float32, name="pg")
    data = _osc_ints(31, elems)
    small = data[:2].copy()                       # 8 B
    for size, x, k in (("8B", small, iters), ("bulk", data, bulk)):
        win.fence()
        ts = []
        for i in range(k):
            t0 = pc()
            if r == 0:
                win.put(1, x)
            win.fence()
            ts.append(pc() - t0)
        ok = r != 1 or win.buf[:x.size].tobytes() == x.tobytes()
        agree(f"fence_put_{size}", ok)
        row["seconds"][f"fence_put_{size}"] = median(ts)
        ts = []
        ok = True
        if r == 0:
            for i in range(k):
                t0 = pc()
                got = win.get(1, x.size)
                ts.append(pc() - t0)
                ok = ok and got.tobytes() == x.tobytes()
            row["seconds"][f"fence_get_{size}"] = median(ts)
        win.fence()
        agree(f"fence_get_{size}", ok)
        y = x + 1
        ts_put, ts_get = [], []
        ok = True
        if r == 0:
            for i in range(k):
                t0 = pc()
                win.lock(1)
                win.put(1, y)
                win.unlock(1)
                ts_put.append(pc() - t0)
                t0 = pc()
                win.lock(1, exclusive=False)
                got = win.get(1, y.size)
                win.unlock(1)
                ts_get.append(pc() - t0)
                ok = ok and got.tobytes() == y.tobytes()
            row["seconds"][f"lock_put_{size}"] = median(ts_put)
            row["seconds"][f"lock_get_{size}"] = median(ts_get)
        comm.barrier()
        ok = ok and (r != 1 or win.buf[:y.size].tobytes() == y.tobytes())
        agree(f"lock_{size}", ok)
    win.free()
    del data, small
    for key, v in list(row["seconds"].items()):
        if key.endswith("_8B"):
            row["us"][key] = v * 1e6
        else:
            row["GBps"][key.removesuffix("_bulk")] = nbytes / v / 1e9

    mark("put_get")

    # -- accumulate SUM of `mib` MiB from ranks 1..n-1 into rank 0 ----------
    win = Window(comm, buffer=_osc_ints(40 + r, elems), name="acc")
    win.fence()
    t0 = pc()
    if r != 0:
        win.accumulate(0, _osc_ints(40 + r, elems), op_mod.SUM)
    win.fence()
    secs = pc() - t0
    ok = True
    if r == 0:
        want = _osc_ints(40, elems)
        for o in range(1, n):
            want = want + _osc_ints(40 + o, elems)
        ok = win.buf.tobytes() == want.tobytes()
        del want
    agree("accumulate_sum", ok)
    row["seconds"]["accumulate"] = secs
    row["GBps"]["accumulate"] = (n - 1) * nbytes / secs / 1e9
    win.free()

    mark("accumulate")

    # -- fetch_op and compare_swap, µs a call ------------------------------
    win = Window(comm, size=2, dtype=np.int64, name="atom")
    win.fence()
    if r == 0:
        ts = []
        for i in range(iters):
            t0 = pc()
            old = win.fetch_op(1, np.array([1]), op_mod.SUM)
            ts.append(pc() - t0)
        row["us"]["fetch_op"] = median(ts) * 1e6
        ts = []
        for i in range(iters):
            t0 = pc()
            old = win.compare_swap(1, i, i + 1, offset=1)
            ts.append(pc() - t0)
        row["us"]["compare_swap"] = median(ts) * 1e6
    win.fence()
    agree("fetch_op_compare_swap",
          r != 1 or win.buf.tolist() == [iters, iters])
    win.free()

    mark("atomics")

    # -- get_accumulate tickets from every rank ----------------------------
    win = Window(comm, size=1, dtype=np.int64, name="tix")
    win.fence()
    t0 = pc()
    tix = np.array([int(win.get_accumulate(0, np.array([1]),
                                           op_mod.SUM)[0])
                    for _ in range(cfg["tickets"])], np.int64)
    secs = pc() - t0
    win.fence()
    every = np.sort(np.asarray(comm.allgather(tix)).ravel())
    total = n * cfg["tickets"]
    agree("tickets_unique", every.tolist() == list(range(total))
          and (r != 0 or int(win.buf[0]) == total))
    slowest = float(np.asarray(comm.allreduce(np.array([secs]),
                                              op=op_mod.MAX))[0])
    row["tickets"] = {"count": total, "seconds": slowest,
                      "per_s": total / slowest}
    win.free()

    mark("tickets")

    # -- PSCW at `mib` MiB: even ranks expose, odd ranks access ---------------
    # (each even target's whole window is filled, a part from each
    # odd origin)
    win = Window(comm, size=elems, dtype=np.float32, name="pscw")
    evens, odds = list(range(0, n, 2)), list(range(1, n, 2))
    part = elems // len(odds)
    comm.barrier()
    t0 = pc()
    if r % 2 == 0:
        win.post(odds)
        win.wait()
        want = np.concatenate([_osc_ints(50 + o, part) for o in odds])
        ok = win.buf[:want.size].tobytes() == want.tobytes()
    else:
        mine = _osc_ints(50 + r, part)
        win.start(evens)
        for t in evens:
            win.put(t, mine, offset=(r // 2) * part)
        win.complete()
        ok = True
    comm.barrier()
    secs = pc() - t0
    agree("pscw", ok)
    row["seconds"]["pscw"] = secs
    row["GBps"]["pscw"] = len(evens) * len(odds) * part * 4 / secs / 1e9
    win.free()

    mark("pscw")

    # -- a dynamic window: attach `mib` MiB, put into the right neighbour -----
    win = Window.create_dynamic(comm, dtype=np.float32)
    region = np.zeros(elems, np.float32)
    base = win.attach(region)
    bases = [int(b) for b in np.asarray(comm.allgather(
        np.array([base], np.int64))).ravel()]
    right, left = (r + 1) % n, (r - 1) % n
    win.fence()
    t0 = pc()
    win.put(right, _osc_ints(60 + r, elems), offset=bases[right])
    win.fence()
    secs = pc() - t0
    agree("dynamic", region.tobytes() == _osc_ints(60 + left,
                                                   elems).tobytes())
    row["seconds"]["dynamic"] = secs
    row["GBps"]["dynamic"] = n * nbytes / secs / 1e9
    win.detach(base)
    win.free()
    del region

    mark("dynamic")

    # -- SharedWindow: `mib` MiB a rank, then a fetch_add counter -------------
    node = comm.split_type(COMM_TYPE_SHARED)
    check(node.size == n, f"osc (b): {node.size} of {n} ranks share a host")
    sw = SharedWindow(node, elems, np.float32, name="smoke")
    mine = _osc_ints(70 + r, elems)
    sw.sync()
    t0 = pc()
    sw.shared_query(right)[:] = mine
    sw.sync()
    secs = pc() - t0
    agree("shared_store", sw.local.tobytes() == _osc_ints(
        70 + left, elems).tobytes())
    row["GBps"]["shared_store"] = n * nbytes / secs / 1e9
    sw.free()
    del mine
    sw = SharedWindow(node, 1, np.int64, name="ctr")
    sw.sync()
    t0 = pc()
    for _ in range(cfg["fetch_adds"]):
        sw.fetch_add(0, 0, 1)
    secs = pc() - t0
    sw.sync()
    total = n * cfg["fetch_adds"]
    agree("fetch_add_total", int(sw.shared_query(0)[0]) == total)
    slowest = float(np.asarray(comm.allreduce(np.array([secs]),
                                              op=op_mod.MAX))[0])
    row["fetch_add"] = {"count": total, "seconds": slowest,
                        "per_s": total / slowest}
    sw.free()

    mark("shared_window")

    # -- SHMEM ---------------------------------------------------------------
    a = shmem.array((elems,), np.float32)
    data = _osc_ints(80, elems)
    shmem.barrier_all()
    ts_put, ts_get = [], []
    ok = True
    for i in range(bulk):
        t0 = pc()
        if r == 0:
            a.put(1, data)
        a.barrier()
        ts_put.append(pc() - t0)
        if r == 0:
            t0 = pc()
            got = a.get(1)
            ts_get.append(pc() - t0)
            ok = ok and got.tobytes() == data.tobytes()
        shmem.barrier_all()
    ok = ok and (r != 1 or a.local.tobytes() == data.tobytes())
    agree("shmem_put_get", ok)
    row["GBps"]["shmem_put"] = nbytes / median(ts_put) / 1e9
    if r == 0:
        row["GBps"]["shmem_get"] = nbytes / median(ts_get) / 1e9
    mark("shmem_put_get")
    a.local[:] = _osc_ints(90 + r, elems)
    shmem.barrier_all()
    t0 = pc()
    shmem.to_all(a, op=op_mod.MAX)
    secs = pc() - t0
    want = _osc_ints(90, elems)
    for o in range(1, n):
        want = np.maximum(want, _osc_ints(90 + o, elems))
    agree("shmem_to_all_max", a.local.tobytes() == want.tobytes())
    row["GBps"]["shmem_to_all"] = nbytes / secs / 1e9
    del want, data
    shmem.free(a)
    mark("shmem_to_all")
    counter = shmem.array((1,), np.int64)
    lock = shmem.Lock()
    shmem.barrier_all()
    rounds = cfg["lock_rounds"] // n
    t0 = pc()
    for _ in range(rounds):
        with lock:
            v = int(counter.get(0, 1)[0])
            counter.put(0, np.array([v + 1]))
    secs = pc() - t0
    shmem.barrier_all()
    agree("shmem_lock_counter", r != 0 or int(counter[0]) == rounds * n)
    slowest = float(np.asarray(comm.allreduce(np.array([secs]),
                                              op=op_mod.MAX))[0])
    row["lock"] = {"rounds": rounds * n, "seconds": slowest,
                   "per_s": rounds * n / slowest}
    mark("shmem_lock")
    print("OSC_B " + json.dumps(row), flush=True)
    shmem.finalize()


def osc_card_rank(cfg: dict) -> None:
    """Rank body of phase osc (c), a ``--gpu`` rank (all on card 0): a
    f32 and a bf16 CUDA tensor of ``card_mib`` MiB each put into the right
    neighbour's f32 host window and ``SymmetricArray``, once timed and
    once (rank 0) the four puts in one profiler window beside a control
    copy; the neighbour's parts must equal ``t.float().cpu().numpy()``
    bit for bit; a CUDA tensor as a window's buffer must raise.  Prints
    one ``OSC_C`` line a rank."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ompi_tpu_torch import shmem
    from ompi_tpu_torch.mpi import op as op_mod
    from ompi_tpu_torch.mpi.constants import MPIException
    from ompi_tpu_torch.mpi.osc import Window

    boot = time.time() - _proc_start_wall()
    t_body = time.perf_counter()
    marks = {}

    def mark(what: str) -> None:
        marks[what] = time.perf_counter() - t_body

    comm = shmem.init()
    r, n = comm.rank, comm.size
    mark("init")
    dev = torch.device(f"{DEVICE}:0") if DEVICE == "cuda" else \
        torch.device(DEVICE)
    nb = cfg["card_mib"] << 20
    n32, n16 = nb // 4, nb // 2

    def tensors(rank):
        gen = torch.Generator(device=dev).manual_seed(700 + rank)
        t32 = torch.randn(n32, device=dev, generator=gen)
        t16 = torch.randn(n16, device=dev, generator=gen).to(
            torch.bfloat16)
        return t32, t16

    def sync():
        if DEVICE == "cuda":
            torch.cuda.synchronize()

    t32, t16 = tensors(r)
    sync()
    mark("tensors")
    try:        # a CPU tensor (a rehearsal) is exposed: every rank makes it
        Window(comm, buffer=t32).free()
        refused = ""
    except MPIException as e:
        refused = str(e)
    win = Window(comm, size=n32 + n16, dtype=np.float32, name="card")
    sym = shmem.array((n32 + n16,), np.float32)
    right, left = (r + 1) % n, (r - 1) % n
    puts = {"win_f32": lambda: win.put(right, t32),
            "win_bf16": lambda: win.put(right, t16, offset=n32),
            "sym_f32": lambda: sym.put(right, t32),
            "sym_bf16": lambda: sym.put(right, t16, offset=n32)}
    win.fence()
    sym.barrier()
    mark("windows")
    secs = {}
    for name, fn in puts.items():
        sync()
        t0 = time.perf_counter()
        fn()
        secs[name] = time.perf_counter() - t0
    win.fence()
    sym.barrier()
    mark("timed_puts")
    copies = None
    if r == 0:
        # one window for the four puts: each moves its data off the card
        # at least once, so puts + 1 DtoH copies is one copy a put
        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if DEVICE == "cuda" else [])
        sync()
        with profile(activities=acts) as prof:
            t32[:1].clone()                      # a window may miss its first
            for fn in puts.values():
                fn()
            t32[:1].cpu()                        # the control: one DtoH
            sync()
        copies = {"puts": len(puts), **profiler_copies(prof)}
    win.fence()
    sym.barrier()
    mark("profiled_puts")
    w32, w16 = tensors(left)
    want = torch.cat([w32.float(), w16.float()]).cpu().numpy()
    ok = {"window": win.buf.tobytes() == want.tobytes(),
          "symmetric": sym.local.tobytes() == want.tobytes(),
          "refused": ("DeviceWindow" in refused) == (dev.type == "cuda")}
    agreed = {k: bool(int(np.asarray(comm.allreduce(
        np.array([int(v)], np.int32), op=op_mod.MIN))[0]))
        for k, v in ok.items()}
    row = {"rank": r, "ok": agreed, "copies": copies,
           "device": str(t32.device), "bytes": {"f32": n32 * 4,
                                                "bf16": n16 * 2},
           "put_s": secs,
           "put_GBps": {k: (n32 * 4 if k.endswith("f32") else n16 * 2)
                        / v / 1e9 for k, v in secs.items()},
           "refusal": refused[:200], "boot_s": boot, "marks": marks}
    mark("checked")
    win.free()
    print("OSC_C " + json.dumps(row), flush=True)
    shmem.finalize()


def phase_osc(card, sizes=None):
    """Host RMA windows and OpenSHMEM through the port's launcher: (a)
    the seven one-sided examples and (c) the ``--gpu`` ranks side by
    side, then (b) the 4-rank host job alone (it is the one that times).
    Launches no kernel of the port."""
    cfg = {"mib": OSC_MIB, "card_mib": OSC_CARD_MIB, **OSC_SMALL,
           **(sizes or {})}

    def body(fn):
        return "\n".join(("import json", "import chip_smoke as C",
                          f"C.DEVICE = {DEVICE!r}",
                          f"C.{fn}(json.loads({json.dumps(cfg)!r}))"))

    secs = {}
    try:
        card_job = tpurun_start(
            ["-np", str(OSC_NP), *(["--gpu"] if DEVICE == "cuda" else []),
             "--", sys.executable, "-c", body("osc_card_rank")])
        examples = {name: (tpurun_start(
            ["-np", str(np_), "--", sys.executable, "-m",
             f"ompi_tpu_torch.examples.{name}"]), marker)
            for name, np_, marker in OSC_EXAMPLES}
        for name, (job, marker) in examples.items():
            wall, rc, out, err = tpurun_wait(job)
            check(rc == 0 and marker in out,
                  f"osc (a) {name}: rc {rc}\n{out[-2000:]}{err[-2000:]}")
            secs[name] = wall
        wall, rc, out, err = tpurun_wait(card_job)
        check(rc == 0, f"osc (c) rc {rc}:\n{out[-2000:]}{err[-3000:]}")
        secs["card"] = wall
        crow = {d["rank"]: d for d in tagged_json(out, "OSC_C")}
        check(sorted(crow) == list(range(OSC_NP)), f"osc (c) rows {crow}")
        for rk, v in crow.items():
            check(all(v["ok"].values()), f"osc (c) rank {rk}: {v}")
            check(v["device"].startswith(DEVICE),
                  f"osc (c) rank {rk} held its tensors on {v['device']}")
        c0 = crow[0]
        cp = c0["copies"]
        if DEVICE == "cuda":
            check(cp["dtoh"] == cp["puts"] + 1,
                  f"osc (c): rank 0's {cp['puts']} puts made {cp} copies "
                  f"(one a put and one control)")
        wall, rc, out, err = tpurun(
            ["-np", str(OSC_NP), "--", sys.executable, "-c",
             body("osc_host_rank")])
        check(rc == 0, f"osc (b) rc {rc}:\n{out[-2000:]}{err[-3000:]}")
        secs["host"] = wall
        rows = {d["rank"]: d for d in tagged_json(out, "OSC_B")}
        check(sorted(rows) == list(range(OSC_NP)), f"osc (b) rows {rows}")
        b0 = rows[0]
        bad = {k: v for k, v in b0["ok"].items() if not v}
        check(not bad, f"osc (b) checks failed: {bad}")
    finally:
        for reaper, _, _ in _HOST_JOBS:
            reaper.join()
        _HOST_JOBS.clear()
    emit("osc", mib=cfg["mib"], card_mib=cfg["card_mib"], ranks=OSC_NP, checks=sorted(b0["ok"]),
         host_us=b0["us"], host_GBps=b0["GBps"], tickets=b0["tickets"],
         fetch_add=b0["fetch_add"], lock=b0["lock"],
         host_marks=b0["marks"], host_boot_s=b0["boot_s"],
         card={"copies": c0["copies"], "put_GBps": c0["put_GBps"],
               "put_s": c0["put_s"], "refusal": c0["refusal"],
               "boot_s": c0["boot_s"], "marks": c0["marks"]},
         seconds=secs, card_name=card)


# ---------------------------------------------------------------------------
# phase dpm: dynamic process management and the mpi4py facade
# ---------------------------------------------------------------------------

DPM_NP = 2                   # ranks of every (a) parent job and of (b)
DPM_CHILDREN = 2             # children of (a)'s Spawn
DPM_MULTI = (2, 1)           # (a)'s spawn_multiple command blocks
DPM_ALLREDUCE_MIB = 16       # (a) the merged 4-rank allreduce, f32
DPM_CARD_MIB = 64            # (b) the CUDA tensors (cut to 16 first)
DPM_PINGS = 200              # (a) 8 B intercomm round trips, after 20
#: (a) the facade examples at the reference's rank counts
#: (tests/runtime/test_examples.py)
DPM_EXAMPLES = (("mpi4py_ring", 3, "exiting"),
                ("mpi4py_cart_halo", 3, "halo exchange ok"))
#: (c) the facade bench: its module's defaults, named here to be recorded
DPM_BENCH = dict(ranks=4, elems=1 << 16, iters=30)


def _dpm_body(fn: str, cfg: dict, child: bool = False) -> str:
    """``python -c`` source of a rank body ``fn(cfg)`` of this module.  A
    spawned ``child`` exits after ``HOST_JOB_TIMEOUT`` s whatever it
    waits on: its launcher has no ``--timeout``, and the ranks of a
    parent job that failed would leave it blocked on the intercomm."""
    guard = (["import faulthandler",
              f"faulthandler.dump_traceback_later({HOST_JOB_TIMEOUT}, "
              f"exit=True)"] if child else [])
    return "\n".join((*guard, "import json", "import chip_smoke as C",
                      f"C.DEVICE = {DEVICE!r}",
                      f"C.{fn}(json.loads({json.dumps(cfg)!r}))"))


def _dpm_agree(comm, ok: dict) -> dict:
    """Each check ANDed over ``comm`` (a facade communicator) in one
    Allreduce; every rank passes the same keys."""
    from ompi_tpu_torch.compat import MPI

    keys = sorted(ok)
    got = np.zeros(len(keys), np.int32)
    comm.Allreduce(np.array([int(bool(ok[k])) for k in keys], np.int32),
                   got, op=MPI.MIN)
    return {k: bool(v) for k, v in zip(keys, got)}


def _dpm_merged_allreduce(m, mib: int) -> tuple:
    """A ``mib`` MiB f32 Allreduce over the merged communicator ``m``,
    bitwise against numpy's sum; (ok, seconds)."""
    n = (mib << 20) // 4
    send = _osc_ints(900 + m.Get_rank(), n)
    recv = np.zeros(n, np.float32)
    m.Barrier()
    t0 = time.perf_counter()
    m.Allreduce(send, recv)
    secs = time.perf_counter() - t0
    want = np.zeros(n, np.float32)
    for k in range(m.Get_size()):
        want += _osc_ints(900 + k, n)
    return recv.tobytes() == want.tobytes(), secs


def dpm_spawn_parent(cfg: dict) -> None:
    """Rank body of phase dpm (a)'s parent job: ``MPI.COMM_WORLD.Spawn``
    of ``children`` children (each runs ``dpm_spawn_child``), a pickled
    object and a buffer each way, 8 B half round trips between rank 0
    and child 0, the merge into one intracommunicator (parents first)
    and a ``DPM_ALLREDUCE_MIB`` MiB Allreduce on it bitwise to numpy,
    then Disconnect.  Prints one ``DPM_SPAWN`` line a rank."""
    from ompi_tpu_torch.compat import MPI

    boot = time.time() - _proc_start_wall()
    comm = MPI.COMM_WORLD
    r = comm.Get_rank()
    comm.Barrier()
    t0 = time.perf_counter()
    ic = comm.Spawn(sys.executable,
                    args=["-c", _dpm_body("dpm_spawn_child", cfg,
                                          child=True)],
                    maxprocs=cfg["children"])
    spawn_s = time.perf_counter() - t0
    ok = {"remote_size": ic.Get_remote_size() == cfg["children"],
          "object": True, "buffer": True, "pings": True}
    half_us = None
    if r == 0:
        for c in range(cfg["children"]):
            ic.send({"token": 10 + c}, dest=c, tag=7)
        ok["object"] = sorted(ic.recv(source=c, tag=8)["double"]
                              for c in range(cfg["children"])) == [
            2 * (10 + c) for c in range(cfg["children"])]
        buf = np.arange(1024, dtype=np.float64)
        ic.Send(buf, dest=0, tag=9)
        back = np.zeros(1024)
        ic.Recv(back, source=0, tag=10)
        ok["buffer"] = back.tobytes() == (buf * 2).tobytes()
        ping = np.zeros(1, np.float64)           # 8 B
        times = []
        for i in range(20 + cfg["pings"]):
            t1 = time.perf_counter()
            ic.Send(ping, 0, tag=11)
            ic.Recv(ping, source=0, tag=12)
            if i >= 20:
                times.append(time.perf_counter() - t1)
        ok["pings"] = int(ping[0]) == 20 + cfg["pings"]
        half_us = float(np.median(times)) / 2 * 1e6
    m = ic.Merge(high=False)
    ok["merged_rank"] = m.Get_rank() == r
    ok["allreduce"], secs = _dpm_merged_allreduce(m, cfg["mib"])
    agreed = _dpm_agree(m, ok)
    ic.Disconnect()
    nbytes = cfg["mib"] << 20
    print("DPM_SPAWN " + json.dumps({
        "rank": r, "ok": agreed, "spawn_s": spawn_s, "half_rtt_us": half_us,
        "allreduce_ms": secs * 1e3, "allreduce_GBps": nbytes / secs / 1e9,
        "merged_size": m.Get_size(), "boot_s": boot}), flush=True)
    MPI.Finalize()


def dpm_spawn_child(cfg: dict) -> None:
    """Rank body of a child of ``dpm_spawn_parent``: the parent's object
    doubled back, child 0 the buffer doubled and the round trips, the
    merge (children last) and the same Allreduce.  Its checks join the
    parents' through the merged communicator."""
    from ompi_tpu_torch.compat import MPI

    parent = MPI.Comm.Get_parent()
    c = MPI.COMM_WORLD.Get_rank()
    ok = {"remote_size": parent.Get_remote_size() == DPM_NP}
    obj = parent.recv(source=0, tag=7)
    parent.send({"double": obj["token"] * 2}, dest=0, tag=8)
    ok["object"] = obj["token"] == 10 + c
    if c == 0:
        buf = np.zeros(1024)
        parent.Recv(buf, source=0, tag=9)
        parent.Send(buf * 2, dest=0, tag=10)
        ping = np.zeros(1, np.float64)
        for _ in range(20 + cfg["pings"]):
            parent.Recv(ping, source=0, tag=11)
            ping += 1
            parent.Send(ping, 0, tag=12)
        ok["buffer"] = ok["pings"] = True
    else:
        ok["buffer"] = ok["pings"] = True
    m = parent.Merge(high=True)
    ok["merged_rank"] = m.Get_rank() == DPM_NP + c
    ok["allreduce"], _ = _dpm_merged_allreduce(m, cfg["mib"])
    _dpm_agree(m, ok)
    parent.Disconnect()
    MPI.Finalize()


def dpm_multi_parent(cfg: dict) -> None:
    """Rank body of phase dpm (a)'s ``spawn_multiple`` job: two command
    blocks (``DPM_MULTI`` ranks), each with its own argv and env; every
    child reports (argv[1], its block's env, rank, size).  Prints one
    ``DPM_MULTI`` line a rank."""
    import ompi_tpu_torch
    from ompi_tpu_torch.mpi import dpm

    comm = ompi_tpu_torch.init()
    body = _dpm_body("dpm_multi_child", cfg, child=True)
    t0 = time.perf_counter()
    ic = dpm.spawn_multiple(
        comm, [[sys.executable, "-c", body, "a"],
               [sys.executable, "-c", body, "b"]], list(cfg["multi"]),
        envs=[{"DPM_BLOCK": "x"}, {"DPM_BLOCK": "y"}])
    spawn_s = time.perf_counter() - t0
    n = ic.remote_size
    got = []
    if comm.rank == 0:
        got = [bytes(np.asarray(ic.recv(source=k, tag=4))).decode()
               for k in range(n)]
    ic.disconnect()
    total = sum(cfg["multi"])
    want = [repr(("a" if k < cfg["multi"][0] else "b",
                  "x" if k < cfg["multi"][0] else "y", k, total))
            for k in range(total)]
    print("DPM_MULTI " + json.dumps({
        "rank": comm.rank, "remote_size": n, "spawn_s": spawn_s,
        "ok": n == total and (comm.rank != 0 or got == want),
        "got": got}), flush=True)
    ompi_tpu_torch.finalize()


def dpm_multi_child(cfg: dict) -> None:
    import ompi_tpu_torch
    from ompi_tpu_torch.mpi import dpm

    comm = ompi_tpu_torch.init()
    parent = dpm.get_parent(comm)
    parent.send(np.frombuffer(repr((sys.argv[1], os.environ["DPM_BLOCK"],
                                    comm.rank, comm.size)).encode(),
                              np.uint8), dest=0, tag=4)
    parent.disconnect()
    ompi_tpu_torch.finalize()


def dpm_ns_rank(cfg: dict) -> None:
    """Rank body of phase dpm (a)'s name-service pair: two independent
    jobs meet through ``publish_name``/``lookup_name`` in a shared
    ``OMPI_TPU_NAME_DIR``, ``accept``/``connect``, and run the intercomm
    barrier, rooted bcast, allreduce (the swap) and merge (with an
    allreduce on it), then disconnect.  Prints one ``DPM_NS`` line a
    rank."""
    import ompi_tpu_torch
    from ompi_tpu_torch.mpi import dpm
    from ompi_tpu_torch.mpi.constants import PROC_NULL, MPIException

    comm = ompi_tpu_torch.init()
    r = comm.rank
    server = cfg["role"] == "server"
    svc = cfg["service"]
    connect_s = None
    port = None
    if server:
        if r == 0:
            port = dpm.open_port()
            dpm.publish_name(svc, port)
        ic = dpm.accept(comm, port)
    else:
        if r == 0:
            deadline = time.time() + 60
            while port is None:
                try:
                    port = dpm.lookup_name(svc)
                except MPIException:
                    check(time.time() < deadline, "dpm (a): no service")
                    time.sleep(0.02)
        comm.barrier()
        t0 = time.perf_counter()
        ic = dpm.connect(comm, port)
        connect_s = time.perf_counter() - t0
    ok = {"remote_size": ic.remote_size == comm.size}
    ic.barrier()
    data = np.arange(8, dtype=np.float64) * 3
    if server:
        b = (ic.bcast(data, root="root") if r == 0
             else ic.bcast(root=PROC_NULL))
    else:
        b = ic.bcast(root=0)
        ok["bcast"] = np.asarray(b).tobytes() == data.tobytes()
    base = 100 if server else 200
    s = np.asarray(ic.allreduce(np.array([base + r], np.int64)))
    other = 200 if server else 100
    ok["allreduce"] = int(s[0]) == sum(other + k for k in range(comm.size))
    m = ic.merge()
    t = np.asarray(m.allreduce(np.array([m.rank], np.int64)))
    ok["merge"] = int(t[0]) == sum(range(2 * comm.size)) and \
        m.rank == (r if server else comm.size + r)
    ic.disconnect()
    if server and r == 0:
        dpm.unpublish_name(svc)
        dpm.close_port(port)
    print("DPM_NS " + json.dumps({"role": cfg["role"], "rank": r,
                                  "ok": ok, "connect_s": connect_s}),
          flush=True)
    ompi_tpu_torch.finalize()


def dpm_card_rank(cfg: dict) -> None:
    """Rank body of phase dpm (b), a ``--gpu`` rank (both on card 0),
    through the facade: rank 0 ``Send``s a ``card_mib`` MiB f32 CUDA
    tensor that rank 1 ``Recv``s into numpy; ``Allreduce`` from a CUDA
    send buffer into numpy; a ``Win.Allocate`` window ``Put`` from a CUDA
    tensor; ``File.Write_at_all`` of a CUDA tensor read back; a bf16 CUDA
    ``Send``.  Every result bitwise; each staged call once timed and once
    in a profiler window of its own beside a control copy (one
    device-to-host copy a call); ``Recv`` into a CUDA tensor must raise
    ERR_BUFFER.  Prints one ``DPM_CARD`` line a rank."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ompi_tpu_torch.compat import MPI
    from ompi_tpu_torch.mpi.constants import ERR_BUFFER, MPIException

    boot = time.time() - _proc_start_wall()
    t_body = time.perf_counter()
    comm = MPI.COMM_WORLD
    r, n = comm.Get_rank(), comm.Get_size()
    check(n == 2, f"dpm (b) runs at 2 ranks, not {n}")
    dev = torch.device(f"{DEVICE}:0") if DEVICE == "cuda" else \
        torch.device(DEVICE)
    nb = cfg["card_mib"] << 20
    n32, n16 = nb // 4, nb // 2

    def tensors(rank):
        gen = torch.Generator(device=dev).manual_seed(800 + rank)
        t32 = torch.randint(0, 1000, (n32,), device=dev,
                            generator=gen).float()
        t16 = torch.randn(n16, device=dev, generator=gen).to(
            torch.bfloat16)
        return t32, t16

    def sync():
        if DEVICE == "cuda":
            torch.cuda.synchronize()

    t32, t16 = tensors(r)
    other32, other16 = tensors(1 - r)
    sync()
    path = os.path.join(cfg["dir"], "card.bin")
    win = MPI.Win.Allocate(nb, disp_unit=4, comm=comm)
    fh = MPI.File.Open(comm, path, MPI.MODE_RDWR | MPI.MODE_CREATE)
    recv32 = np.zeros(n32, np.float32)
    red = np.zeros(n32, np.float32)
    recv16 = np.zeros(n16, np.int16)
    back = np.zeros(2 * n32, np.float32)

    # each staged call: (what rank r runs, whether it stages a tensor)
    calls = {
        "send": (lambda: comm.Send(t32, dest=1, tag=1) if r == 0
                 else comm.Recv(recv32, source=0, tag=1), r == 0),
        "allreduce": (lambda: comm.Allreduce(t32, red), True),
        "put": (lambda: (win.Fence(), win.Put(t32, 1 - r), win.Fence()),
                 True),
        "write_at_all": (lambda: fh.Write_at_all(r * nb, t32), True),
        "send_bf16": (lambda: comm.Send(t16, dest=1, tag=2) if r == 0
                      else comm.Recv(recv16, source=0, tag=2), r == 0),
    }
    secs, copies = {}, {}
    for name, (fn, staged) in calls.items():
        comm.Barrier()
        sync()
        t0 = time.perf_counter()
        fn()
        secs[name] = time.perf_counter() - t0
        if DEVICE == "cuda":
            comm.Barrier()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t32[:1].clone()                 # a window may miss its first
                fn()
                t32[:1].cpu()                   # the control: one DtoH
                sync()
            copies[name] = {"staged": staged, **profiler_copies(prof)}
    comm.Barrier()
    fh.Read_at_all(0, back)
    fh.Close()
    mem = np.asarray(win.memory).view(np.float32).copy()
    win.Free()
    want_sum = (t32 + other32).cpu().numpy()
    lo32 = (t32 if r == 0 else other32).cpu().numpy()
    ok = {"allreduce": red.tobytes() == want_sum.tobytes(),
          "put": mem.tobytes() == other32.cpu().numpy().tobytes(),
          "write_at_all": back.tobytes() == np.concatenate(
              [lo32, (other32 if r == 0 else t32).cpu().numpy()]).tobytes()}
    if r == 1:
        ok["send"] = recv32.tobytes() == other32.cpu().numpy().tobytes()
        ok["send_bf16"] = recv16.tobytes() == other16.view(
            torch.int16).cpu().numpy().tobytes()
    else:
        ok["send"] = ok["send_bf16"] = True
    if DEVICE == "cuda":
        ok["copies"] = all(c["dtoh"] == (2 if c["staged"] else 1)
                           for c in copies.values())
    # a receive into a CUDA tensor must raise before it matches (the
    # peer's message is then drained into numpy); a CPU rehearsal's
    # tensor takes the message
    sreq = comm.Isend(np.arange(8, dtype=np.float32), dest=1 - r, tag=3)
    refusal = ""
    try:
        comm.Recv(torch.zeros(8, device=dev), source=1 - r, tag=3)
        landed = True
    except MPIException as e:
        landed = False
        refusal = f"{e.error_class}: {e}"
        comm.Recv(np.zeros(8, np.float32), source=1 - r, tag=3)
    sreq.Wait()
    ok["refused"] = (not landed and refusal.startswith(f"{ERR_BUFFER}:")
                     and "DeviceCommunicator" in refusal
                     if dev.type == "cuda" else landed)
    agreed = _dpm_agree(comm, ok)
    body = time.perf_counter() - t_body
    gbps = {k: nb / v / 1e9 for k, v in secs.items()}
    gbps["send_bf16"] = n16 * 2 / secs["send_bf16"] / 1e9
    print("DPM_CARD " + json.dumps({
        "rank": r, "ok": agreed, "copies": copies, "secs": secs,
        "GBps": gbps, "bytes": nb, "device": str(t32.device),
        "refusal": refusal[:300], "boot_s": boot, "body_s": body,
        "end_wall": time.time()}), flush=True)
    MPI.Finalize()


def _dpm_bench() -> dict:
    """Phase dpm (c): the facade bench's ``main`` in this process (4
    ranks on threads); its three ratio lines, parsed."""
    import io
    import re

    bench = importlib.import_module(
        "ompi_tpu_torch.examples.facade_collectives_bench")
    check((bench.N_RANKS, bench.ELEMS, bench.ITERS) == tuple(
        DPM_BENCH.values()), "dpm (c): the bench's defaults moved")
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        bench.main()
    secs = time.perf_counter() - t0
    rows = {}
    for line in buf.getvalue().splitlines():
        m = re.match(r"\s*(\w+)\s+native\s+([\d.]+)us\s+facade\s+([\d.]+)us"
                     r"\s+ratio\s+([\d.]+)x", line)
        if m:
            rows[m.group(1)] = {"native_us": float(m.group(2)),
                                "facade_us": float(m.group(3)),
                                "ratio": float(m.group(4))}
    check(sorted(rows) == ["allgather", "allreduce", "bcast"],
          f"dpm (c): the bench printed {buf.getvalue()!r}")
    return {"rows": rows, "seconds": secs}


def phase_dpm(card, sizes=None):
    """Dynamic process management and the mpi4py facade through the
    port's launcher: (b) the ``--gpu`` facade job started first, (a) the
    host jobs side by side with it, then (c) the facade bench in this
    process.  Launches no kernel of the port."""
    import shutil
    import tempfile

    cfg = {"children": DPM_CHILDREN, "multi": list(DPM_MULTI),
           "mib": DPM_ALLREDUCE_MIB, "card_mib": DPM_CARD_MIB,
           "pings": DPM_PINGS, **(sizes or {})}
    work = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "build", "dpm_smoke")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    names = tempfile.mkdtemp(dir=work, prefix="names-")
    secs = {}
    try:
        t_card = time.time()
        card_job = tpurun_start(
            ["-np", str(DPM_NP), *(["--gpu"] if DEVICE == "cuda" else []),
             "--", sys.executable, "-c",
             _dpm_body("dpm_card_rank", {**cfg, "dir": work})])
        jobs = {name: (tpurun_start(
            ["-np", str(np_), "--", sys.executable, "-m",
             f"ompi_tpu_torch.examples.{name}"]), marker)
            for name, np_, marker in DPM_EXAMPLES}
        svc = f"chip-smoke-{os.getpid()}"
        ns = {role: tpurun_start(
            ["-np", str(DPM_NP), "-x", f"OMPI_TPU_NAME_DIR={names}", "--",
             sys.executable, "-c",
             _dpm_body("dpm_ns_rank", {**cfg, "role": role,
                                       "service": svc})])
            for role in ("server", "client")}
        multi = tpurun_start(["-np", "1", "--", sys.executable, "-c",
                              _dpm_body("dpm_multi_parent", cfg)])
        spawn = tpurun_start(["-np", str(DPM_NP), "--", sys.executable,
                              "-c", _dpm_body("dpm_spawn_parent", cfg)])
        for name, (job, marker) in jobs.items():
            wall, rc, out, err = tpurun_wait(job)
            check(rc == 0 and marker in out,
                  f"dpm (a) {name}: rc {rc}\n{out[-2000:]}{err[-2000:]}")
            secs[name] = wall
        ns_rows = []
        for role, job in ns.items():
            wall, rc, out, err = tpurun_wait(job)
            check(rc == 0, f"dpm (a) {role}: rc {rc}\n{out[-2000:]}"
                           f"{err[-3000:]}")
            secs[f"ns_{role}"] = wall
            ns_rows += tagged_json(out, "DPM_NS")
        check(len(ns_rows) == 2 * DPM_NP and all(
            all(r["ok"].values()) for r in ns_rows), f"dpm (a) ns {ns_rows}")
        connect_s = [r["connect_s"] for r in ns_rows
                     if r["role"] == "client" and r["rank"] == 0][0]
        wall, rc, out, err = tpurun_wait(multi)
        check(rc == 0, f"dpm (a) spawn_multiple: rc {rc}\n{out[-2000:]}"
                       f"{err[-3000:]}")
        secs["spawn_multiple"] = wall
        mrow = tagged_json(out, "DPM_MULTI")
        check(len(mrow) == 1 and mrow[0]["ok"], f"dpm (a) multi {mrow}")
        wall, rc, out, err = tpurun_wait(spawn)
        check(rc == 0, f"dpm (a) spawn: rc {rc}\n{out[-2000:]}"
                       f"{err[-3000:]}")
        secs["spawn"] = wall
        srows = {d["rank"]: d for d in tagged_json(out, "DPM_SPAWN")}
        check(sorted(srows) == list(range(DPM_NP)), f"dpm (a) {srows}")
        for rk, v in srows.items():
            check(all(v["ok"].values()) and v["merged_size"] ==
                  DPM_NP + cfg["children"], f"dpm (a) spawn rank {rk}: {v}")
        s0 = srows[0]
        wall, rc, out, err = tpurun_wait(card_job)
        t_end = t_card + wall
        check(rc == 0, f"dpm (b) rc {rc}:\n{out[-2000:]}{err[-3000:]}")
        secs["card"] = wall
        crow = {d["rank"]: d for d in tagged_json(out, "DPM_CARD")}
        check(sorted(crow) == list(range(DPM_NP)), f"dpm (b) rows {crow}")
        for rk, v in crow.items():
            check(all(v["ok"].values()), f"dpm (b) rank {rk}: {v}")
            check(v["device"].startswith(DEVICE),
                  f"dpm (b) rank {rk} held its tensors on {v['device']}")
        c0 = crow[0]
        bench = _dpm_bench()
        secs["bench"] = bench["seconds"]
    finally:
        for reaper, _, _ in _HOST_JOBS:
            reaper.join()
        _HOST_JOBS.clear()
        shutil.rmtree(work, ignore_errors=True)
    emit("dpm", ranks=DPM_NP, children=cfg["children"],
         multi=cfg["multi"], checks={
             "spawn": sorted(s0["ok"]), "card": sorted(c0["ok"]),
             "ns": sorted(ns_rows[0]["ok"])},
         spawn_s=s0["spawn_s"], connect_s=connect_s,
         multi_spawn_s=mrow[0]["spawn_s"],
         half_rtt_us=s0["half_rtt_us"], allreduce_mib=cfg["mib"],
         allreduce_ms=s0["allreduce_ms"],
         allreduce_GBps=s0["allreduce_GBps"],
         card={"mib": cfg["card_mib"], "copies": c0["copies"],
               "GBps": {r: crow[r]["GBps"] for r in crow},
               "secs": {r: crow[r]["secs"] for r in crow},
               "refusal": c0["refusal"], "boot_s": c0["boot_s"],
               "body_s": c0["body_s"],
               "exit_s": t_end - max(v["end_wall"] for v in crow.values())},
         bench={**DPM_BENCH, **bench["rows"]},
         seconds=secs, card_name=card)


# ---------------------------------------------------------------------------
# phase plm: the daemon tree (multi-host launch on simulated hosts)
# ---------------------------------------------------------------------------

PLM_HOSTS = 2                # simulated hosts of (a), (b1), (b2) and (c)
PLM_NP = 4                   # ranks of (a)'s jobs, byslot: 0, 1 | 2, 3
PLM_PAIRS = ((0, 1), (0, 2))  # (a) ping-pong: within a host, across
PLM_PINGPONG = (8, 64 << 20)  # (a) bytes a ping-pong
PLM_COLL_MIB = 64            # (a) the allreduce, f32 a rank
PLM_CARD_MIB = 64            # (b1) the CUDA tensors, f32
PLM_FLASH = (16, 512, 16, 128)  # (b) B, T, H, D: the prefill shape, bf16
#: (a) containment: a mid-tree orted SIGKILLed under notify
PLM_CONTAIN = dict(hosts=4, np=4, period=0.2, timeout=2.0,
                   plan="daemon=1:kill@reg=4:after=1.5", sleep=4.0)
PLM_CLOCK = dict(push=0.2, sync=0.1, sleep=1.5)  # (a) the clock job
PLM_REAP_S = 5.0             # seconds a dead rank's card context may take


def _plm_flash(label: str, shape) -> dict:
    """The forward kernel at the prefill shape (causal), held against the
    plain version within phase kernel's bound; its launches counted."""
    import torch

    fa = importlib.import_module("ompi_tpu_torch.ops.flash_attention")
    dev = torch.device(DEVICE)
    B, T, H, D = shape
    gen = torch.Generator(device=dev).manual_seed(5)
    q, k, v = (torch.randn((B, T, H, D), generator=gen, device=dev)
               .to(torch.bfloat16) for _ in range(3))
    before = fa.launch_count
    t0 = time.perf_counter()
    o, lse = fa.flash_attention_lse(q, k, v, causal=True)
    if DEVICE == "cuda":
        torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = fa.launch_count - before
    ro, rlse = fa.flash_attention_lse_reference(q, k, v, causal=True)
    err = (o.float() - ro.float()).abs().max().item()
    ok = (torch.allclose(o.float(), ro.float(), atol=BF16_TOL,
                         rtol=BF16_TOL)
          and torch.allclose(lse, rlse, atol=BF16_TOL, rtol=BF16_TOL)
          and launches == (1 if DEVICE == "cuda" else 0))
    return {"ok": bool(ok), "max_abs_err": err, "launches": launches,
            "launch_count": fa.launch_count, "first_call_s": secs,
            "wall": time.time(), "label": label}


def plm_host_rank(cfg: dict) -> None:
    """Rank body of phase plm (a)'s 4-rank job on 2 simulated hosts:
    ping-pong for each pair of ``pairs`` (8 B half round trip and 64 MiB
    GB/s, medians over blocks, bitwise back) with the route rank 0's
    endpoint took, then a 64 MiB f32 allreduce of small integers bitwise
    against numpy, with the provider and path that served it.  Rank 0
    prints one ``PLM_HOST`` line."""
    import statistics

    import ompi_tpu_torch
    from ompi_tpu_torch.tools import host_bench

    comm = ompi_tpu_torch.init()
    r = comm.rank
    host = os.environ["OMPI_TPU_FAKE_HOST"]
    hosts = [int(h) for h in np.asarray(
        comm.allgather(np.array([int(host[3:])]))).ravel()]
    pairs = {}
    for a, b in cfg["pairs"]:
        rows = []
        for nbytes in cfg["sizes"]:
            x = (np.arange(nbytes, dtype=np.uint64) * 2654435761 % 251
                 ).astype(np.uint8)
            back = np.empty_like(x)
            blocks, reps = host_bench._plan(nbytes)
            half, ok = [], True
            comm.barrier()
            if r in (a, b):
                peer = b if r == a else a
                for _ in range(blocks + 1):
                    t0 = time.perf_counter()
                    for _ in range(reps):
                        if r == a:
                            comm.send(x, dest=peer, tag=1)
                            comm.recv(back, source=peer, tag=2)
                        else:
                            comm.recv(back, source=peer, tag=1)
                            comm.send(back, dest=peer, tag=2)
                    half.append((time.perf_counter() - t0) / reps / 2 * 1e6)
                    if r == a:
                        ok = ok and back.tobytes() == x.tobytes()
                        back[:] = 0
                half = half[1:]
            comm.barrier()
            if r == a:
                med = statistics.median(half)
                rows.append({"bytes": nbytes, "half_rtt_us": med,
                             "half_rtt_us_blocks": half,
                             "gb_s": nbytes / (med * 1e-6) / 1e9,
                             "bitwise": ok})
        if r == a:
            pairs[f"{a}-{b}"] = {"route": comm.pml.endpoint.route(b),
                                 "rows": rows}
    n = (cfg["mib"] << 20) // 4
    data = [host_bench._rank_data(k, n, np.float32) for k in range(comm.size)]
    want = data[0].copy()
    for k in range(1, comm.size):
        want += data[k]
    comm.barrier()
    ops = host_bench._arena_ops(comm)
    t0 = time.perf_counter()
    got = np.asarray(comm.allreduce(data[r]))
    secs = time.perf_counter() - t0
    arena = host_bench._arena_ops(comm) > ops
    oks = np.asarray(comm.allgather(np.array([got.tobytes()
                                              == want.tobytes()])))
    paths = np.asarray(comm.allgather(np.array([arena])))
    times = np.asarray(comm.allgather(np.array([secs])))
    if r == 0:
        print("PLM_HOST " + json.dumps({
            "hosts": hosts, "pairs": pairs, "allreduce": {
                "bytes": n * 4, "bitwise": bool(oks.all()),
                "provider": comm.coll.providers["allreduce"],
                "path": "arena" if paths.all() else "host",
                "seconds_max": float(times.max())}}), flush=True)
    ompi_tpu_torch.finalize()


def plm_clock_hnp(cfg: dict) -> None:
    """Phase plm (a)'s clock and bynode job, driven from this process as
    its HNP (``MultiHostLauncher``, so its metrics aggregate can be
    read): 4 ranks ``--map-by bynode`` on 2 simulated hosts, each
    printing its host, living ``sleep`` s with the metrics uplink and the
    clock-sync prober on.  Prints one ``PLM_CLOCK`` line: every rank's
    pushed ``rank_clock_to_root_ns`` and ``rank_clock_rtt_ns`` (its
    daemon's composed offset and edge rtt)."""
    os.environ["OMPI_TPU_MCA_trace_metrics_push_period"] = str(cfg["push"])
    os.environ["OMPI_TPU_MCA_clock_sync_period"] = str(cfg["sync"])
    from ompi_tpu_torch.core.config import var_registry
    from ompi_tpu_torch.runtime.job import AppContext, Job
    from ompi_tpu_torch.runtime.plm import MultiHostLauncher

    var_registry.load_cli([("ras", "simulator"),
                           ("ras_sim_num_nodes", str(cfg["hosts"])),
                           ("ras_sim_slots_per_node",
                            str(-(-cfg["np"] // cfg["hosts"]))),
                           ("rmaps_rr_policy", "bynode")])
    prog = ("import os, time, ompi_tpu_torch\n"
            "comm = ompi_tpu_torch.init()\n"
            "print('PLM_MAP', comm.rank, os.environ['OMPI_TPU_FAKE_HOST'],"
            " os.environ['OMPI_TPU_LOCAL_RANK'], flush=True)\n"
            f"time.sleep({cfg['sleep']})\n"
            "ompi_tpu_torch.finalize()\n")
    job = Job([AppContext(argv=[sys.executable, "-c", prog], np=cfg["np"])])
    hnp = MultiHostLauncher(plm_name="sim", stdin_target="none",
                            timeout=HOST_JOB_TIMEOUT)
    rc = hnp.run(job)
    snap = hnp.metrics_agg.snapshot().get(job.jobid, {})
    rows = {int(rank): {"offset_ns": vals.get("rank_clock_to_root_ns"),
                        "rtt_ns": vals.get("rank_clock_rtt_ns"),
                        "host": job.procs[int(rank)].node.name}
            for rank, (_ts, vals) in snap.items()}
    print("PLM_CLOCK " + json.dumps({"rc": rc, "ranks": rows}), flush=True)


def plm_card_rank(cfg: dict) -> None:
    """Rank body of phase plm (b1), (b2) and (c), a ``--gpu`` rank that
    an orted started on a simulated host (both ranks on card 0).

    (b1) ``group``: the rank's card and environment, the process group
    of 2 joined at the plm's rendezvous, the forward kernel at the
    prefill shape, then a 64 MiB f32 CUDA tensor across the fake-host
    boundary through ``comm.allreduce`` (the device route must raise the
    shared-card error) and through the facade's ``Allreduce`` into numpy
    over tcp, bitwise against numpy's sum, in a profiler window with one
    device-to-host copy beside the control copy.  (b2) ``respawn``: no
    group; each life runs the kernel check; rank 1's first life SIGKILLs
    itself after it and its revived life (same host and card, no
    rendezvous) runs it again.  (c) ``lifeline``: after init binds the
    card, rank 1 SIGKILLs its own orted and both sleep; the job must
    end all the same.  Prints one ``PLM_CARD`` line a life."""
    import signal

    import torch

    import ompi_tpu_torch
    from ompi_tpu_torch.parallel import multihost

    boot = time.time() - _proc_start_wall()
    t_body = time.perf_counter()
    env = os.environ
    life = int(env.get("OMPI_TPU_RESTART") or 0)
    row = {"mode": cfg["mode"], "rank": int(env["OMPI_TPU_RANK"]),
           "life": life, "pid": os.getpid(),
           "orted": int(env.get("OMPI_TPU_ORTED_PID") or 0),
           "host": env.get("OMPI_TPU_FAKE_HOST"),
           "chip": env.get("OMPI_TPU_CHIP"),
           "nhosts": env.get("OMPI_TPU_NHOSTS"),
           "coord": env.get("OMPI_TPU_COORD"), "boot_s": boot,
           "start_wall": _proc_start_wall()}
    comm = ompi_tpu_torch.init()
    r = comm.rank
    row["grouped"] = multihost.is_initialized()
    if DEVICE == "cuda":
        row["current_device"] = torch.cuda.current_device()
    if cfg["mode"] == "group":
        import torch.distributed as dist

        row["group_size"] = dist.get_world_size()
        row["group_rank"] = dist.get_rank()
        row["hosts"] = [int(h) for h in np.asarray(comm.allgather(
            np.array([int(row["host"][3:])]))).ravel()]
    if cfg["mode"] == "lifeline":
        torch.ones(1 << 20, device=DEVICE).sum().item()  # hold a context
        # the row goes up before the kill (its orted forwards it); the
        # kill lands 0.5 s after the stamp, once the line is out
        row["kill_wall"] = time.time() + 0.5
        print("PLM_CARD " + json.dumps(row), flush=True)
        if r == 1:
            time.sleep(0.5)
            os.kill(os.getppid(), signal.SIGKILL)
        time.sleep(60)
        return
    row["flash"] = _plm_flash(f"life {life}", cfg["flash"])
    if cfg["mode"] == "respawn":
        if r == 1 and life == 0:
            row["kill_wall"] = time.time()
            print("PLM_CARD " + json.dumps(row), flush=True)
            os.kill(os.getpid(), signal.SIGKILL)
        row["body_s"] = time.perf_counter() - t_body
        row["end_wall"] = time.time()
        print("PLM_CARD " + json.dumps(row), flush=True)
        ompi_tpu_torch.finalize()
        return
    # (b1): the 64 MiB tensor across the fake-host boundary, twice
    from torch.profiler import ProfilerActivity, profile

    from ompi_tpu_torch.compat import MPI
    from ompi_tpu_torch.mpi.device_comm import device_world
    from ompi_tpu_torch.parallel.mesh import make_mesh

    n32 = (cfg["card_mib"] << 20) // 4

    def tensor(rank):
        gen = torch.Generator(device=DEVICE).manual_seed(900 + rank)
        return torch.randint(0, 1000, (n32,), device=DEVICE,
                             generator=gen).float()

    mine, other = tensor(r), tensor(1 - r)
    comm.bind_device(device_world(make_mesh(device=DEVICE)))
    try:
        comm.allreduce(mine)
        row["device_error"] = None
    except NotImplementedError as e:
        row["device_error"] = str(e)[:400]
    row["route"] = comm.pml.endpoint.route(1 - r)
    world = MPI.COMM_WORLD
    red = np.zeros(n32, np.float32)
    world.Barrier()
    t0 = time.perf_counter()
    world.Allreduce(mine, red)
    row["allreduce_s"] = time.perf_counter() - t0
    want = (mine + other).cpu().numpy()
    row["allreduce_bitwise"] = red.tobytes() == want.tobytes()
    if DEVICE == "cuda":
        world.Barrier()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            mine[:1].clone()                    # a window may miss its first
            world.Allreduce(mine, red)
            mine[:1].cpu()                      # the control: one DtoH
            torch.cuda.synchronize()
        row["copies"] = profiler_copies(prof)
    row["allreduce_GBps"] = n32 * 4 / row["allreduce_s"] / 1e9
    row["body_s"] = time.perf_counter() - t_body
    row["end_wall"] = time.time()
    print("PLM_CARD " + json.dumps(row), flush=True)
    ompi_tpu_torch.finalize()


def _plm_stamped(args):
    """One tpurun job whose output lines are stamped (wall time) as they
    arrive: (seconds, rc, stdout, [(wall, stderr line), ...])."""
    t0 = time.perf_counter()
    p = subprocess.Popen(
        [sys.executable, "-m", "ompi_tpu_torch.tools.tpurun", "--timeout",
         str(HOST_JOB_TIMEOUT), *args],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    lines: list = []
    outs: list = []

    def read(pipe, into, stamp):
        for line in iter(pipe.readline, ""):
            into.append((time.time(), line) if stamp else line)

    readers = [threading.Thread(target=read, args=(p.stderr, lines, True)),
               threading.Thread(target=read, args=(p.stdout, outs, False))]
    for t in readers:
        t.start()
    rc = p.wait()
    for t in readers:
        t.join()
    return time.perf_counter() - t0, rc, "".join(outs), lines


def _shm_inboxes() -> set:
    from ompi_tpu_torch.core import shmseg

    base = shmseg.backing_dir()
    return {os.path.join(base, n) for n in os.listdir(base)
            if n.startswith("otpu-shm-")}


def _ssh_localhost_ok() -> bool:
    """The reference's probe (``tests/runtime/test_plm.py``): passwordless
    ``ssh localhost``."""
    import shutil

    if shutil.which("ssh") is None:
        return False
    try:
        r = subprocess.run(
            ["ssh", "-o", "BatchMode=yes", "-o", "StrictHostKeyChecking=no",
             "-o", "ConnectTimeout=3", "localhost", "true"],
            capture_output=True, timeout=10)
        return r.returncode == 0
    except (subprocess.TimeoutExpired, OSError):
        return False


def _gone(pids, apps0=None) -> list:
    """What outlived its job, after waiting up to ``PLM_REAP_S`` s (a
    killed rank's context is freed a moment after its kill): the pids of
    ``pids`` still alive, and, on the card with ``apps0`` (the compute
    processes ``_card_apps`` listed before those processes started), a
    line for the card's compute processes while there are more than
    there were.  The card half counts processes: in the card machine's
    container ``nvidia-smi`` reports every compute pid as 1, so a pid
    matches none."""
    deadline = time.monotonic() + PLM_REAP_S
    while True:
        left = []
        for pid in pids:
            try:
                os.kill(pid, 0)
                left.append(pid)
            except ProcessLookupError:
                pass
            except PermissionError:
                left.append(pid)
        if DEVICE == "cuda" and apps0 is not None:
            apps = _card_apps()
            if len(apps) > len(apps0):
                left.append(f"card: {len(apps)} compute processes "
                            f"{apps}, {len(apps0)} before {apps0}")
        if not left or time.monotonic() > deadline:
            return left
        time.sleep(0.1)


def phase_plm(card, sizes=None):
    """Multi-host launch through the daemon tree (``tpurun --plm sim``):
    the card jobs (b1), (b2) and (c) started first, the host jobs of (a)
    side by side with them, then hello alone, the containment job and
    the clean.  Files go under build/plm_smoke/, removed at the end."""
    import shutil

    from ompi_tpu_torch.runtime import clean as clean_mod

    cfg = {"pairs": [list(p) for p in PLM_PAIRS], "sizes": list(PLM_PINGPONG),
           "mib": PLM_COLL_MIB, "card_mib": PLM_CARD_MIB,
           "flash": list(PLM_FLASH), **PLM_CONTAIN, **(sizes or {})}
    work = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "build", "plm_smoke")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    sim = ["--plm", "sim", "--hosts", str(PLM_HOSTS)]
    # a CPU rehearsal has no --gpu: its group's rendezvous is given by hand
    gpu = (["--gpu"] if DEVICE == "cuda" else
           ["-x", f"OMPI_TPU_COORD=127.0.0.1:{free_port()}",
            "-x", f"OMPI_TPU_NHOSTS={PLM_HOSTS}"])
    secs, out = {}, {"card": card}
    apps0 = _card_apps()          # this process's own context
    try:
        t0 = time.time()   # the card jobs start within ms of it
        card_jobs = {
            "b1": tpurun_start([*sim, "-np", "2", *gpu, "--", sys.executable,
                                "-c", _dpm_body("plm_card_rank",
                                                {**cfg, "mode": "group"})]),
            "b2": tpurun_start([*sim, "-np", "2", *(
                gpu if DEVICE == "cuda" else
                ["-x", "OMPI_TPU_COORD=127.0.0.1:1", "-x",
                 f"OMPI_TPU_NHOSTS={PLM_HOSTS}"]), "--mca", "errmgr",
                                "respawn", "--", sys.executable, "-c",
                                _dpm_body("plm_card_rank",
                                          {**cfg, "mode": "respawn"})]),
            "c": tpurun_start([*sim, "-np", "2",
                               *(gpu if DEVICE == "cuda" else []), "--",
                               sys.executable,
                               "-c", _dpm_body("plm_card_rank",
                                               {**cfg, "mode": "lifeline"})]),
        }
        host_prog = ("import os; print('PLM_CPU', os.environ["
                     "'OMPI_TPU_FAKE_HOST'], sorted(os.sched_getaffinity(0)),"
                     " flush=True)")
        host_jobs = {
            "ring": tpurun_start([*sim, "-np", str(PLM_NP), "--",
                                  sys.executable, "-m",
                                  "ompi_tpu_torch.examples.ring"]),
            "bench": tpurun_start([*sim, "-np", str(PLM_NP), "--",
                                   sys.executable, "-c",
                                   _dpm_body("plm_host_rank", cfg)]),
            "rtc": tpurun_start([*sim, "-np", str(PLM_NP), "--mca",
                                 "rtc_bind", "core", "--", sys.executable,
                                 "-c", host_prog]),
        }
        clock = subprocess.Popen(
            [sys.executable, "-c", _dpm_body(
                "plm_clock_hnp", {"hosts": PLM_HOSTS, "np": PLM_NP,
                                  **PLM_CLOCK})],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            cwd=os.path.dirname(os.path.abspath(__file__)))
        ssh_ok = _ssh_localhost_ok()
        # (a) the host jobs
        wall, rc, so, se = tpurun_wait(host_jobs["ring"])
        got = sorted(ln for ln in so.splitlines() if ln.strip())
        check(rc == 0 and got == ring_lines(PLM_NP, tag="mh"),
              f"plm ring: rc {rc}, lines {got}\n{se[-2000:]}")
        secs["ring"] = wall
        wall, rc, so, se = tpurun_wait(host_jobs["bench"])
        check(rc == 0, f"plm host job: rc {rc}\n{so[-2000:]}{se[-3000:]}")
        secs["bench"] = wall
        (bench,) = tagged_json(so, "PLM_HOST")
        check(bench["hosts"] == [0, 0, 1, 1],
              f"plm byslot: ranks on hosts {bench['hosts']}")
        for pair, want in (("0-1", "shm"), ("0-2", "tcp")):
            p = bench["pairs"][pair]
            check(p["route"] == want, f"plm {pair}: route {p['route']}, "
                  f"not {want}")
            check(all(x["bitwise"] for x in p["rows"]),
                  f"plm {pair}: ping-pong data changed")
        check(bench["allreduce"]["bitwise"],
              f"plm allreduce differs from numpy: {bench['allreduce']}")
        wall, rc, so, se = tpurun_wait(host_jobs["rtc"])
        check(rc == 0, f"plm rtc job: rc {rc}\n{se[-2000:]}")
        secs["rtc"] = wall
        cpus: dict = {}
        for ln in so.splitlines():
            if "PLM_CPU " in ln:
                host, aff = ln.split("PLM_CPU ", 1)[1].split(" ", 1)
                cpus.setdefault(host, []).append(json.loads(aff))
        allowed = sorted(os.sched_getaffinity(0))
        check(sum(len(v) for v in cpus.values()) == PLM_NP,
              f"plm rtc: {cpus}")
        if len(allowed) >= 2:
            for host, sets in cpus.items():
                check(all(len(s) == 1 for s in sets)
                      and len({s[0] for s in sets}) == len(sets),
                      f"plm rtc_bind core: {host} ranks pinned to {sets}")
        so, se = clock.communicate(timeout=HOST_JOB_TIMEOUT)
        check(clock.returncode == 0, f"plm clock job: rc {clock.returncode}"
              f"\n{se[-3000:]}")
        (clk,) = tagged_json(so, "PLM_CLOCK")
        check(clk["rc"] == 0, f"plm clock job: {clk}")
        maps = sorted(ln.split("PLM_MAP ", 1)[1] for ln in so.splitlines()
                      if "PLM_MAP " in ln)
        check(maps == ["0 sim000 0", "1 sim001 0", "2 sim000 1",
                       "3 sim001 1"], f"plm --map-by bynode: {maps}")
        check(sorted(clk["ranks"]) == [str(k) for k in range(PLM_NP)],
              f"plm clock: metrics rows {clk['ranks']}")
        for rank, v in clk["ranks"].items():
            check(v["offset_ns"] is not None and v["rtt_ns"] is not None
                  and abs(v["offset_ns"]) <= v["rtt_ns"] / 2 + 1,
                  f"plm clock: rank {rank}'s daemon offset {v}")
        # (b1)
        b1_pids, card_pids = [], []
        wall, rc, so, se = tpurun_wait(card_jobs["b1"])
        t_b1 = t0 + wall
        check(rc == 0, f"plm (b1): rc {rc}\n{so[-2000:]}{se[-3000:]}")
        secs["b1"] = wall
        b1 = {d["rank"]: d for d in tagged_json(so, "PLM_CARD")}
        check(sorted(b1) == [0, 1], f"plm (b1) rows {b1}")
        for rk, v in b1.items():
            card_pids.append(v["pid"])
            check(v["chip"] == ("0" if DEVICE == "cuda" else None)
                  and v["nhosts"] == "2" and v["coord"],
                  f"plm (b1) rank {rk} env: {v}")
            check(v["grouped"] and v["group_size"] == 2
                  and v["group_rank"] == rk,
                  f"plm (b1) rank {rk} not in one group of 2: {v}")
            check(sorted(v["hosts"]) == [0, 1],
                  f"plm (b1) rank {rk}: hosts {v['hosts']}")
            check(v["flash"]["ok"], f"plm (b1) rank {rk} flash: {v['flash']}")
            check(v["route"] == "tcp", f"plm (b1) route {v['route']}")
            check(v["allreduce_bitwise"],
                  f"plm (b1) rank {rk}: facade Allreduce differs")
            if DEVICE == "cuda":
                check(v["current_device"] == 0, f"plm (b1) card: {v}")
                check(v["device_error"] is not None
                      and "share a card" in v["device_error"],
                      f"plm (b1) rank {rk}: no shared-card refusal: {v}")
                check(v["copies"]["dtoh"] == 2,
                      f"plm (b1) rank {rk}: copies {v['copies']}")
        check(b1[0]["coord"] == b1[1]["coord"], "plm (b1) rendezvous")
        # (b2)
        wall, rc, so, se = tpurun_wait(card_jobs["b2"])
        check(rc == 0, f"plm (b2): rc {rc}\n{so[-2000:]}{se[-3000:]}")
        secs["b2"] = wall
        t_b2 = t0 + wall
        b2 = {(d["rank"], d["life"]): d for d in tagged_json(so, "PLM_CARD")}
        check(sorted(b2) == [(0, 0), (1, 0), (1, 1)], f"plm (b2) {b2}")
        for key, v in b2.items():
            card_pids.append(v["pid"])
            check(v["flash"]["ok"], f"plm (b2) {key} flash: {v['flash']}")
            check(v["chip"] == ("0" if DEVICE == "cuda" else None)
                  and not v["grouped"], f"plm (b2) {key}: {v}")
            check((v["coord"] is None) == (v["life"] > 0),
                  f"plm (b2) {key}: rendezvous {v['coord']}")
            if DEVICE == "cuda":
                check(v["current_device"] == 0, f"plm (b2) card: {v}")
        check(b2[(1, 1)]["host"] == b2[(1, 0)]["host"]
              and b2[(1, 1)]["pid"] != b2[(1, 0)]["pid"],
              f"plm (b2) revived elsewhere: {b2}")
        revive_s = b2[(1, 1)]["flash"]["wall"] - b2[(1, 0)]["kill_wall"]
        # (c)
        wall, c_rc, so, se = tpurun_wait(card_jobs["c"])
        secs["c"] = wall
        check(c_rc != 0
              and ("daemon" in se.lower() or "died" in se.lower()),
              f"plm (c): rc {c_rc}\n{se[-3000:]}")
        crow = {d["rank"]: d for d in tagged_json(so, "PLM_CARD")}
        check(sorted(crow) == [0, 1], f"plm (c) rows {crow}")
        kill_to_exit = t0 + wall - crow[1]["kill_wall"]
        card_pids += [v["pid"] for v in crow.values()]
        left = _gone(card_pids, apps0)
        check(not left, f"plm: ranks {left} outlived their jobs")
        # hello, alone: its launch-to-exit time
        wall, rc, so, se = tpurun([*sim, "-np", str(PLM_NP), "--",
                                   sys.executable, "-c",
                                   "import os, ompi_tpu_torch\n"
                                   "c = ompi_tpu_torch.init()\n"
                                   "print(f'Hello, world, I am {c.rank} of "
                                   "{c.size} on ' + os.environ["
                                   "'OMPI_TPU_FAKE_HOST'])\n"
                                   "ompi_tpu_torch.finalize()\n"])
        got = sorted(ln for ln in so.splitlines() if ln.strip())
        check(rc == 0 and got == sorted(
            f"[mh,{k}]Hello, world, I am {k} of {PLM_NP} on "
            f"sim00{k // 2}" for k in range(PLM_NP)),
            f"plm hello: rc {rc}, lines {got}")
        secs["hello_launch_to_exit"] = wall
        # containment, then the clean of what its dead rank left
        before = _shm_inboxes()
        k = cfg
        wall, rc, so, stamped = _plm_stamped([
            "--plm", "sim", "--hosts", str(k["hosts"]), "-np", str(k["np"]),
            "--mca", "errmgr", "notify",
            "--mca", "rml_heartbeat_period", str(k["period"]),
            "--mca", "rml_heartbeat_timeout", str(k["timeout"]),
            "--mca", "faultinject_plan", k["plan"], "--", sys.executable,
            "-c", "import time, ompi_tpu_torch\n"
                  "comm = ompi_tpu_torch.init()\n"
                  f"time.sleep({k['sleep']})\n"
                  "print(f'rank {comm.rank} survived', flush=True)\n"
                  "ompi_tpu_torch.finalize()\n"])
        secs["containment"] = wall
        se = "".join(ln for _t, ln in stamped)
        check(rc == 0 and "daemon-reparent" in se,
              f"plm containment: rc {rc}\n{so[-2000:]}{se[-3000:]}")
        for rk in (1, 2, 3):
            check(f"rank {rk} survived" in so, f"plm containment: rank {rk}")
        check("rank 0 survived" not in so, "plm containment: rank 0 lived")
        t_kill = next(t for t, ln in stamped if "injected SIGKILL" in ln)
        t_rep = next(t for t, ln in stamped if "daemon-reparent" in ln)
        # this job's own debris only: an inbox made while it ran whose
        # doorbell has no reader (a concurrent job's live inbox has one)
        dead = sorted(d for d in _shm_inboxes() - before
                      if not clean_mod._inbox_alive(d))
        check(len(dead) >= 1, "plm containment: the dead rank left no inbox")
        # an inbox within the sweep's grace is left unjudged (a rank
        # still starting up): wait it out, then sweep
        newest = max(os.stat(d).st_mtime for d in dead)
        time.sleep(max(0.0, newest + clean_mod._INBOX_GRACE_S + 0.2
                       - time.time()))
        r1 = subprocess.run([sys.executable, "-m",
                             "ompi_tpu_torch.tools.tpurun", "--clean"],
                            capture_output=True, text=True, timeout=60)
        r2 = subprocess.run([sys.executable, "-m",
                             "ompi_tpu_torch.tools.tpurun", "--clean",
                             "--clean-dry-run"],
                            capture_output=True, text=True, timeout=60)
        check(r1.returncode == 0 and all(f"removing {d}" in r1.stderr
                                         for d in dead)
              and not any(os.path.exists(d) for d in dead),
              f"plm --clean: {r1.stderr[-2000:]}")
        check(r2.returncode == 0 and not any(d in r2.stderr for d in dead),
              f"plm --clean --clean-dry-run: {r2.stderr[-2000:]}")
        ssh = {"probe": ssh_ok}
        if ssh_ok:
            hf = os.path.join(work, "hostfile")
            with open(hf, "w") as f:
                f.write("localhost\nlocalhost\n")
            wall, rc, so, se = tpurun(["--plm", "ssh", "--hostfile", hf,
                                       "-np", "2", "--", sys.executable,
                                       "-c", "import os; print('ssh rank', "
                                       "os.environ['OMPI_TPU_RANK'])"])
            check(rc == 0 and "ssh rank 0" in so and "ssh rank 1" in so,
                  f"plm ssh: rc {rc}\n{se[-2000:]}")
            ssh["seconds"] = wall
    finally:
        for reaper, _, _ in _HOST_JOBS:
            reaper.join()
        _HOST_JOBS.clear()
        shutil.rmtree(work, ignore_errors=True)

    def times(rows, t_end):
        # launch: tpurun's start to its first rank's (HNP, orteds, wire-up)
        return {"launch_s": min(v["start_wall"] for v in rows) - t0,
                "boot_s": max(v["boot_s"] for v in rows),
                "body_s": max(v.get("body_s", 0.0) for v in rows),
                "exit_s": t_end - max(v.get("end_wall", v.get(
                    "kill_wall", t_end)) for v in rows)}

    emit("plm", hosts=PLM_HOSTS, ranks=PLM_NP,
         pingpong={k: {"route": v["route"], "rows": [
             {x: row[x] for x in ("bytes", "half_rtt_us", "gb_s")}
             for row in v["rows"]]} for k, v in bench["pairs"].items()},
         allreduce=bench["allreduce"], rtc=cpus,
         clock={k: v for k, v in clk["ranks"].items()},
         card={"b1": {"ranks": {k: {x: v[x] for x in (
                   "chip", "host", "group_size", "route", "allreduce_s",
                   "allreduce_GBps", "copies", "boot_s", "body_s")
                   if x in v} for k, v in b1.items()},
                   "device_error": b1[0]["device_error"],
                   "flash": {k: v["flash"] for k, v in b1.items()},
                   **times(list(b1.values()), t_b1)},
               "b2": {"flash": {f"{k[0]}.{k[1]}": v["flash"]
                                for k, v in b2.items()},
                      "kill_to_revived_kernel_s": revive_s,
                      **times(list(b2.values()), t_b2)},
               "c": {"rc": c_rc, "seconds": secs["c"],
                     "kill_to_exit_s": kill_to_exit,
                     "launch_s": min(v["start_wall"]
                                     for v in crow.values()) - t0}},
         pids_left=left,
         rank_flash_launches=sum(
             v["flash"]["launches"] for v in [*b1.values(), *b2.values()]),
         containment={"kill_to_reparent_s": t_rep - t_kill,
                      "dead_inboxes": len(dead),
                      "cleaned": r1.stderr.strip().splitlines()[-1]},
         ssh=ssh, seconds=secs, card_name=card)


# ---------------------------------------------------------------------------
# phase dvm: the standing pool
# ---------------------------------------------------------------------------

#: (a) the host pool: 2 simulated hosts of 2 slots, so a 4-rank tenant
#: spans both (the gang scheduler fills the least-loaded host first)
DVM_HOST = dict(hosts=2, slots=4)
#: (b) the --gpu pool: 2 slots a host, so the gang scheduler puts each
#: 2-rank tenant on one host (one a host would need 1 slot a host, and
#: the stuck watchdog sees arena waits only, which need a shared host)
DVM_GPU = dict(hosts=2, slots=4)
#: both pools: the metrics uplink and the stuck-collective watchdog
DVM_MCA = ("--mca", "trace_metrics_push_period", "0.5",
           "--mca", "coll_stuck_timeout", "2")
DVM_NP = 4                   # (a) hello, the ping-pong tenant, sync
DVM_HOLD_S = 1.5             # (b1) a pair's hold after its kernel check
DVM_SPAWN = dict(children=2, mib=4)  # (a) spawn: the merged allreduce


def dvm_host_rank(cfg: dict) -> None:
    """Rank body of phase dvm (a)'s host tenants.  ``pingpong``: ranks 0
    and 1 trade 8 B (bitwise back) and all four allreduce until the
    ``release`` file appears; ``straggler``: the reference's STRAGGLER_APP (8
    allreduces, ``faultinject.step()`` before each); ``spawn_parent`` /
    ``spawn_child``: 2 ranks spawn 2 through ``dpm.spawn`` (under the
    pool: ``--dvm-submit``), merge, and allreduce ``mib`` MiB of small
    integers bitwise against numpy.  Rank 0 (each rank for
    ``straggler``) prints one ``DVM_HOST`` line."""
    import ompi_tpu_torch
    from ompi_tpu_torch.mpi import dpm

    mode = cfg["mode"]
    comm = ompi_tpu_torch.init()
    r = comm.rank
    row = {"mode": mode, "rank": r, "jobid": os.environ.get("OMPI_TPU_JOBID"),
           "host": os.environ.get("OMPI_TPU_FAKE_HOST")}
    if mode == "pingpong":
        t_end = time.time() + HOST_JOB_TIMEOUT / 2
        x = np.arange(8, dtype=np.uint8)
        back = np.empty_like(x)
        rounds, ok = 0, True
        while not int(np.asarray(comm.allreduce(np.array([int(
                os.path.exists(cfg["release"]) or time.time() >= t_end)])
                ))[0]):
            for _ in range(64):
                if r == 0:
                    comm.send(x, dest=1, tag=1)
                    comm.recv(back, source=1, tag=2)
                    ok = ok and back.tobytes() == x.tobytes()
                elif r == 1:
                    comm.recv(back, source=0, tag=1)
                    comm.send(back, dest=0, tag=2)
            rounds += 1
        row.update(rounds=rounds, bitwise=bool(ok))
    elif mode == "straggler":
        from ompi_tpu_torch.testing import faultinject

        acc = 0.0
        for step in range(8):
            faultinject.step()
            acc += float(np.asarray(comm.allreduce(
                np.full(8, float(r + step))))[0])
        row["acc"] = acc
    elif mode in ("spawn_parent", "spawn_child"):
        if mode == "spawn_parent":
            ic = dpm.spawn(comm, [sys.executable, "-c", _dpm_body(
                "dvm_host_rank", {**cfg, "mode": "spawn_child"},
                child=True)], cfg["children"])
            row.update(intercomm=type(ic).__name__,
                       remote_size=ic.remote_size)
        else:
            ic = dpm.get_parent(comm)
        m = ic.merge(high=mode == "spawn_child")
        n = (cfg["mib"] << 20) // 4
        got = np.asarray(m.allreduce(_osc_ints(900 + m.rank, n)))
        want = np.zeros(n, np.float32)
        for k in range(m.size):
            want += _osc_ints(900 + k, n)
        ok = np.asarray(m.allreduce(np.array(
            [int(got.tobytes() == want.tobytes())])))
        row.update(merged_size=m.size, bitwise=int(ok[0]) == m.size,
                   dvm_uri=bool(os.environ.get("OMPI_TPU_DVM_URI")))
        if mode == "spawn_child":
            ompi_tpu_torch.finalize()
            return
    if r == 0 or mode == "straggler":
        print("DVM_HOST " + json.dumps(row), flush=True)
    ompi_tpu_torch.finalize()


def dvm_card_rank(cfg: dict) -> None:
    """Rank body of phase dvm (b), a ``--gpu`` tenant's rank on a
    simulated host of the standing pool (every rank on card 0).  Every
    mode checks the rank's card and environment, joins its tenant's
    process group and runs the forward kernel at the prefill shape
    against the plain version.  ``b1``: holds ``hold`` s (the scrape),
    then finalizes.  ``b2``: then 6 host allreduces, ``faultinject``'s
    stall freezing rank 1 in the 3rd until the pool's remediation
    SIGCONTs it, and the kernel check again.  ``stop``: holds until the
    pool is stopped.  Prints one ``DVM_CARD`` line (b2: after the
    second check)."""
    import torch

    import ompi_tpu_torch
    from ompi_tpu_torch.parallel import multihost

    env = os.environ
    row = {"mode": cfg["mode"], "tenant": cfg["tenant"],
           "rank": int(env["OMPI_TPU_RANK"]),
           "jobid": env.get("OMPI_TPU_JOBID"),
           "life": int(env.get("OMPI_TPU_RESTART") or 0), "pid": os.getpid(),
           "orted": int(env.get("OMPI_TPU_ORTED_PID") or 0),
           "host": env.get("OMPI_TPU_FAKE_HOST"),
           "chip": env.get("OMPI_TPU_CHIP"),
           "nhosts": env.get("OMPI_TPU_NHOSTS"),
           "coord": env.get("OMPI_TPU_COORD"),
           "start_wall": _proc_start_wall()}
    comm = ompi_tpu_torch.init()
    r = comm.rank
    row["grouped"] = multihost.is_initialized()
    if row["grouped"]:
        import torch.distributed as dist

        row["group_size"] = dist.get_world_size()
        row["group_rank"] = dist.get_rank()
    if DEVICE == "cuda":
        row["current_device"] = torch.cuda.current_device()
    row["flash"] = _plm_flash("first", cfg["flash"])
    if cfg["mode"] == "b1":
        print("DVM_CARD " + json.dumps(row), flush=True)
        time.sleep(cfg["hold"])
    elif cfg["mode"] == "stop":
        # the client prints its lines at exit: the row goes to a file too
        with open(f"{cfg['marker']}{r}.json", "w") as f:
            json.dump(row, f)
        print("DVM_CARD " + json.dumps(row), flush=True)
        time.sleep(HOST_JOB_TIMEOUT)
    else:
        from ompi_tpu_torch.testing import faultinject

        walls = []
        for step in range(6):
            faultinject.step()
            t = time.time()
            comm.allreduce(np.full(8, float(r + step)))
            walls.append([t, time.time()])
        row["coll_walls"] = walls
        row["flash_after"] = _plm_flash("after", cfg["flash"])
        print("DVM_CARD " + json.dumps(row), flush=True)
    ompi_tpu_torch.finalize()


def _card_apps() -> list:
    """The compute processes ``nvidia-smi`` lists on the card (pid and
    memory as it prints them: in a container its pids need not be this
    namespace's, so the phase compares counts), [] off the card."""
    if DEVICE != "cuda":
        return []
    out = subprocess.run(["nvidia-smi", "--query-compute-apps=pid,"
                          "used_memory", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout
    return [ln.strip() for ln in out.splitlines() if ln.strip()]


def _dvm_start_pool(uri: str, args: list, log: str):
    """``tpurun --dvm-start`` with its control URI at ``uri``; waits for
    the uri file.  Returns (Popen, the metrics base URL)."""
    f = open(log, "w")
    p = subprocess.Popen(
        [sys.executable, "-m", "ompi_tpu_torch.tools.tpurun", "--dvm-start",
         *args, "--dvm-uri", uri], stdout=f, stderr=subprocess.STDOUT,
        text=True, cwd=os.path.dirname(os.path.abspath(__file__)))
    f.close()
    deadline = time.monotonic() + 90
    while not os.path.exists(uri):
        if p.poll() is not None or time.monotonic() > deadline:
            p.kill()
            check(False, f"dvm: the pool at {uri} did not come up (rc "
                  f"{p.poll()}):\n{open(log).read()[-3000:]}")
        time.sleep(0.05)
    with open(uri + ".metrics") as fh:
        return p, fh.read().strip()


def _dvm_submit(uri: str, np_: int, prog: list, extra=()):
    return tpurun_start(["--dvm-submit", "-np", str(np_), "--dvm-uri", uri,
                         *extra, "--", *prog])


def _dvm_http(base: str, path: str) -> tuple:
    """(ms, body) of one GET of the pool's HTTP plane."""
    import urllib.request

    t0 = time.perf_counter()
    with urllib.request.urlopen(base + path, timeout=30) as resp:
        body = resp.read().decode()
    return (time.perf_counter() - t0) * 1e3, body


def _dvm_tool(*args) -> tuple:
    """(seconds, rc, stdout, stderr) of one ``python -m`` port tool."""
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", *args], capture_output=True,
                       text=True, timeout=120,
                       cwd=os.path.dirname(os.path.abspath(__file__)))
    return time.perf_counter() - t0, r.returncode, r.stdout, r.stderr


def _dvm_ps(uri: str) -> dict:
    _s, rc, so, se = _dvm_tool("ompi_tpu_torch.tools.tpurun", "--dvm-ps",
                               "--dvm-uri", uri)
    check(rc == 0, f"dvm --dvm-ps: rc {rc}\n{se[-2000:]}")
    return json.loads(so)


def _dvm_remediation(base: str, jobid, timeout: float = 30.0) -> list:
    """The job's ``remediate`` and ``doctor`` FT events from /status,
    polled until the probe's conclusion is on the timeline."""
    deadline = time.monotonic() + timeout
    while True:
        _ms, body = _dvm_http(base, "/status")
        jobs = {str(j["jobid"]): j for j in json.loads(body)["jobs"]}
        events = [e for e in jobs.get(str(jobid), {}).get("ft_events", [])
                  if e["kind"] in ("doctor", "remediate", "stuck")]
        acts = {e.get("info", {}).get("action") for e in events}
        if "recovered" in acts or time.monotonic() > deadline:
            return events
        time.sleep(0.25)


def _dvm_stop(uri: str, pool) -> dict:
    s, rc, _so, se = _dvm_tool("ompi_tpu_torch.tools.tpurun", "--dvm-stop",
                               "--dvm-uri", uri)
    check(rc == 0, f"dvm --dvm-stop: rc {rc}\n{se[-2000:]}")
    try:
        pool_rc = pool.wait(timeout=60)
    except subprocess.TimeoutExpired:
        pool.kill()
        pool_rc = None
    check(pool_rc == 0, f"dvm: the pool at {uri} exited {pool_rc}")
    check(not os.path.exists(uri) and not os.path.exists(uri + ".metrics"),
          f"dvm: --dvm-stop left {uri} or its .metrics")
    return {"stop_s": s, "rc": pool_rc}


def _dvm_host(work: str, a_done: threading.Event, inboxes: set) -> dict:
    """(a): the host pool's checks, in order; returns the numbers."""
    from ompi_tpu_torch.runtime import clean as clean_mod

    uri = os.path.join(work, "host.uri")
    sim = ["--plm", "sim", "--hosts", str(DVM_HOST["hosts"])]
    out: dict = {}
    t0 = time.perf_counter()
    pool, base = _dvm_start_pool(uri, [*sim, "--slots",
                                       str(DVM_HOST["slots"]),
                                       "--metrics-port", "0", *DVM_MCA],
                                 os.path.join(work, "host_pool.log"))
    out["pool_up_s"] = time.perf_counter() - t0
    try:
        hello = [sys.executable, "-c",
                 "import os, ompi_tpu_torch\n"
                 "c = ompi_tpu_torch.init()\n"
                 "print('HELLO', c.rank, os.environ['OMPI_TPU_FAKE_HOST'])\n"
                 "ompi_tpu_torch.finalize()\n"]

        def hosts_of(so):
            return {ln.split("HELLO ", 1)[1].split()[0]:
                    ln.split("HELLO ", 1)[1].split()[1]
                    for ln in so.splitlines() if "HELLO " in ln}

        wall, rc, so, se = tpurun([*sim, "-np", str(DVM_NP), "--", *hello])
        check(rc == 0 and len(hosts_of(so)) == DVM_NP,
              f"dvm cold hello: rc {rc}\n{so[-1000:]}{se[-2000:]}")
        out["cold_hello_s"] = wall
        pids = [d["pid"] for d in _dvm_ps(uri)["daemons"]]
        warm = []
        for _ in range(2):
            wall, rc, so, se = tpurun_wait(_dvm_submit(uri, DVM_NP, hello))
            got = hosts_of(so)
            check(rc == 0 and sorted(got) == [str(k) for k in range(DVM_NP)]
                  and set(got.values()) == {"sim000", "sim001"},
                  f"dvm warm hello: rc {rc}, hosts {got}\n{se[-2000:]}")
            warm.append(wall)
        table = _dvm_ps(uri)
        check([d["pid"] for d in table["daemons"]] == pids
              and all(pids) and len(pids) == DVM_HOST["hosts"],
              f"dvm: daemons changed across warm jobs: {pids} → "
              f"{table['daemons']}")
        out["warm_hello_s"] = warm
        # tenancy: two 2-rank tenants at once, each client its own lines
        a = _dvm_submit(uri, 2, [sys.executable, "-c",
                                 "import time; print('TENANT_A', flush=True)"
                                 "; time.sleep(3); print('A_DONE')"])
        time.sleep(0.5)
        b = _dvm_submit(uri, 2, [sys.executable, "-c",
                                 "import sys; print('TENANT_B', flush=True)"
                                 "; sys.exit(3)"])
        live = _dvm_ps(uri)
        _w, b_rc, b_out, b_err = tpurun_wait(b)
        _w, a_rc, a_out, a_err = tpurun_wait(a)
        check(b_rc == 3 and "TENANT_B" in b_out and "TENANT_A" not in b_out,
              f"dvm tenant B: rc {b_rc}\n{b_out[-1000:]}{b_err[-1000:]}")
        check(a_rc == 0 and "A_DONE" in a_out and "TENANT_B" not in a_out,
              f"dvm tenant A: rc {a_rc}\n{a_out[-1000:]}{a_err[-1000:]}")
        cur = live.get("current_job") or {}
        check(len(live["daemons"]) == DVM_HOST["hosts"]
              and cur.get("np") == 2 and cur.get("procs"),
              f"dvm --dvm-ps during the tenants: {live}")
        _w, rc, so, se = tpurun_wait(_dvm_submit(
            uri, 2 * DVM_HOST["slots"] + 1, [sys.executable, "-c", "pass"]))
        verdict = json.loads(so.strip().splitlines()[-1])
        check(rc == 75 and verdict["verdict"] == "rejected"
              and "can never fit" in verdict["reason"],
              f"dvm never-fits submission: rc {rc}, {so[-500:]}")
        hist = _dvm_ps(uri)["history"]
        check(sorted(h["rc"] for h in hist[-2:]) == [0, 3],
              f"dvm --dvm-ps history: {hist}")
        # the HTTP plane during a 4-rank ping-pong tenant, and the tools
        release = os.path.join(work, "pingpong.release")
        job = _dvm_submit(uri, DVM_NP, [sys.executable, "-c", _dpm_body(
            "dvm_host_rank", {"mode": "pingpong", "release": release})])
        deadline = time.monotonic() + 60
        while True:
            _ms, status = _dvm_http(base, "/status")
            status = json.loads(status)
            running = [j for j in status["jobs"]
                       if j.get("state") == "running" and j.get("procs")]
            if running:
                break
            check(time.monotonic() < deadline and job[0].is_alive(),
                  f"dvm: the ping-pong tenant never ran: {status['jobs']}")
            time.sleep(0.1)
        (tenant,) = running
        check(len(tenant["procs"]) == DVM_NP and "ft_events" in tenant
              and all(p["state"] == "running" for p in tenant["procs"]),
              f"dvm /status during the tenant: {tenant}")
        want = [f'{{job="{tenant["jobid"]}",rank="{k}"}}' for k in (0, 1)]
        while True:
            _ms, metrics = _dvm_http(base, "/metrics")
            if all(w in metrics for w in want) and any(
                    ln.startswith("ompi_tpu_job_")
                    and f'job="{tenant["jobid"]}"' in ln
                    for ln in metrics.splitlines()):
                break
            check(time.monotonic() < deadline and job[0].is_alive(),
                  f"dvm /metrics never carried the tenant's ranks:\n"
                  f"{metrics[-2000:]}")
            time.sleep(0.2)
        scrapes = [_dvm_http(base, "/metrics")[0] for _ in range(3)]
        typed = [ln.split()[2] for ln in metrics.splitlines()
                 if ln.startswith("# TYPE")]
        check(len(typed) == len(set(typed)),
              f"dvm /metrics: duplicate # TYPE lines "
              f"{sorted({t for t in typed if typed.count(t) > 1})}")
        doctor_ms, doc = _dvm_http(base, "/doctor")
        doc = json.loads(doc)
        tl = os.path.join(work, "timeline.json")
        with ThreadPoolExecutor(3) as ex:
            tools = {k: ex.submit(_dvm_tool, *v) for k, v in {
                "hang_doctor": ("ompi_tpu_torch.tools.hang_doctor",
                                "--uri", uri, "--json"),
                "timeline": ("ompi_tpu_torch.tools.timeline", "--uri", base,
                             "--tail", "256", "-o", tl),
                "straggler_report": ("ompi_tpu_torch.tools.straggler_report",
                                     "--uri", base)}.items()}
            tools = {k: f.result() for k, f in tools.items()}
        open(release, "w").close()
        _w, rc, so, se = tpurun_wait(job)
        (pp,) = tagged_json(so, "DVM_HOST")
        check(rc == 0 and pp["bitwise"] and pp["rounds"] > 0,
              f"dvm ping-pong tenant: rc {rc}, {pp}\n{se[-2000:]}")
        _s, rc, so, se = tools["hang_doctor"]
        verdict = (json.loads(so).get("verdict") or {}) if rc == 0 else {}
        check(rc == 0 and verdict.get("kind") in (
            "healthy", "straggler", "deadlock", "mismatch", "no_data"),
              f"dvm hang_doctor --uri: rc {rc} {so[-500:]}{se[-1000:]}")
        _s, rc, so, se = tools["timeline"]
        check(rc == 0 and "events" in so and os.path.exists(tl),
              f"dvm timeline --uri: rc {rc} {so[-500:]}{se[-1000:]}")
        events = len(json.load(open(tl)).get("traceEvents") or [])
        _s, rc, so, se = tools["straggler_report"]
        check(rc in (0, 1) and ("job " in so or "no straggler" in so),
              f"dvm straggler_report --uri: rc {rc} {so[-500:]}"
              f"{se[-1000:]}")
        out["http"] = {"metrics_scrape_ms": scrapes,
                       "doctor_capture_s": doctor_ms / 1e3,
                       "doctor_verdict": (doc.get("verdict") or {}).get(
                           "kind"),
                       "hang_doctor_verdict": verdict.get("kind"),
                       "timeline_events": events,
                       "straggler_report_rc": rc,
                       "tools_s": {k: v[0] for k, v in tools.items()},
                       "pingpong_rounds": pp["rounds"]}
        # remediation: rank 1 stalls in its 3rd collective
        job = _dvm_submit(uri, 2, [sys.executable, "-c", _dpm_body(
            "dvm_host_rank", {"mode": "straggler"})], extra=(
            "--mca", "faultinject_plan", "rank=1:stall@coll=3",
            "--mca", "faultinject_seed", "0"))
        wall, rc, so, se = tpurun_wait(job)
        rows = {d["rank"]: d for d in tagged_json(so, "DVM_HOST")}
        check(rc == 0 and sorted(rows) == [0, 1]
              and all(v["acc"] == 64.0 for v in rows.values()),
              f"dvm straggler tenant: rc {rc} {rows}\n{se[-3000:]}")
        events = _dvm_remediation(base, rows[1]["jobid"])
        acts = {e.get("info", {}).get("action"): e for e in events
                if e["kind"] == "remediate"}
        check("sigcont" in acts and "recovered" in acts
              and acts["sigcont"]["rank"] == 1,
              f"dvm remediation events: {events}")
        _ms, metrics = _dvm_http(base, "/metrics")
        check("ompi_tpu_dvm_remediations_total 1" in metrics,
              "dvm: ompi_tpu_dvm_remediations_total is not 1")
        out["remediation"] = {
            "job_s": wall,
            "probe_latency_ms": acts["recovered"]["info"].get("latency_ms"),
            "verdicts": [e.get("info", {}).get("verdict") for e in events
                         if e["kind"] == "doctor"]}
        # spawn through the pool (coll/host: the arena hangs on a
        # communicator merged across two simulated hosts, in the JAX
        # package's pool too)
        wall, rc, so, se = tpurun_wait(_dvm_submit(
            uri, 2, [sys.executable, "-c", _dpm_body(
                "dvm_host_rank", {"mode": "spawn_parent", **DVM_SPAWN})],
            extra=("--mca", "coll_shm_enable", "0")))
        (sp,) = tagged_json(so, "DVM_HOST") or [{}]
        check(rc == 0 and sp.get("intercomm") == "Intercomm"
              and sp.get("remote_size") == DVM_SPAWN["children"]
              and sp.get("merged_size") == 2 + DVM_SPAWN["children"]
              and sp.get("bitwise") and sp.get("dvm_uri"),
              f"dvm spawn: rc {rc} {sp}\n{se[-3000:]}")
        hist = _dvm_ps(uri)["history"]
        check(any(h["np"] == DVM_SPAWN["children"] and h["rc"] == 0
                  and "spawn_child" in " ".join(h["argv"])
                  for h in hist), f"dvm: the children were no tenant: {hist}")
        out["spawn_job_s"] = wall
        # sync: offsets within rtt/2 (every sim host is this machine)
        wall, rc, so, se = tpurun_wait(_dvm_submit(
            uri, DVM_NP, [sys.executable, "-m", "ompi_tpu_torch.tools.sync",
                          "-n", "16"]))
        offs = {}
        for ln in so.splitlines():
            parts = ln.split("]", 1)[-1].split()
            if len(parts) == 3 and parts[0].isdigit():
                offs[int(parts[0])] = (float(parts[1]), float(parts[2]))
        check(rc == 0 and sorted(offs) == list(range(DVM_NP))
              and all(abs(o) <= t / 2 for k, (o, t) in offs.items() if k),
              f"dvm sync: rc {rc} {offs}\n{so[-1000:]}{se[-1000:]}")
        out["sync_us"] = offs
    finally:
        out["stop"] = _dvm_stop(uri, pool)
    # the --gpu pool runs on beside this one: phase_dvm counts the card's
    # compute processes against their number before both pools, once
    # both are down
    left = _gone(pids)
    check(not left, f"dvm: orteds {left} outlived --dvm-stop")
    out["orted_pids"] = pids
    _s, rc, _so, se = _dvm_tool("ompi_tpu_torch.tools.tpurun", "--clean",
                                "--clean-dry-run")
    new = _shm_inboxes() - inboxes
    check(rc == 0 and uri not in se
          and not any(d in se for d in new if not os.path.exists(d)
                      or not clean_mod._inbox_alive(d)),
          f"dvm --clean --clean-dry-run lists the pool's artifacts:\n"
          f"{se[-2000:]}")
    out["clean_dry_run"] = se.strip().splitlines()[-1]
    a_done.set()
    return out


def _dvm_card(work: str, a_done: threading.Event) -> dict:
    """(b): the --gpu pool: no CUDA context in it, (b1) one tenant alone
    then two at once, (b2) with the stop tenant, then --dvm-stop with
    the stop tenant running and nothing of the pool left on the card."""
    uri = os.path.join(work, "gpu.uri")
    sim = ["--plm", "sim", "--hosts", str(DVM_GPU["hosts"])]
    gpu = ["--gpu"] if DEVICE == "cuda" else []
    apps0 = _card_apps()          # this process's own context
    t0 = time.perf_counter()
    pool, base = _dvm_start_pool(uri, [*sim, "--slots", str(DVM_GPU["slots"]),
                                       *gpu, "--metrics-port", "0",
                                       *DVM_MCA],
                                 os.path.join(work, "gpu_pool.log"))
    out: dict = {"pool_up_s": time.perf_counter() - t0}
    pids: list = []
    try:
        daemons = [d["pid"] for d in _dvm_ps(uri)["daemons"]]
        pool_pids = [pool.pid, *daemons]
        apps = _card_apps()
        check(len(apps) == len(apps0),
              f"dvm: the --gpu pool holds a CUDA context: nvidia-smi lists "
              f"{apps}, {apps0} before the pool")
        out["pool_pids"] = pool_pids
        out["card_apps"] = {"before_pool": apps0, "pool_up": apps}

        def tenant(tag: str, mode: str, extra=(), hold=DVM_HOLD_S):
            # the CPU rehearsal passes each tenant's rendezvous by hand
            coord = ([] if DEVICE == "cuda" else
                     ["-x", f"OMPI_TPU_COORD=127.0.0.1:{free_port()}",
                      "-x", "OMPI_TPU_NHOSTS=1"])
            return time.time(), _dvm_submit(uri, 2, [
                sys.executable, "-c", _dpm_body("dvm_card_rank", {
                    "mode": mode, "tenant": tag, "flash": list(PLM_FLASH),
                    "hold": hold,
                    "marker": os.path.join(work, "stop_rank")})],
                extra=(*coord, *extra))

        def rows_of(t_sub, job, tag):
            wall, rc, so, se = tpurun_wait(job)
            rows = {d["rank"]: d for d in tagged_json(so, "DVM_CARD")}
            check(rc == 0 and sorted(rows) == [0, 1],
                  f"dvm (b) tenant {tag}: rc {rc} {rows}\n{se[-3000:]}")
            for rk, v in rows.items():
                pids.append(v["pid"])
                check(v["chip"] == ("0" if DEVICE == "cuda" else None)
                      and v["nhosts"] == "1" and v["coord"]
                      and v["life"] == 0,
                      f"dvm (b) tenant {tag} rank {rk} env: {v}")
                check(v["grouped"] and v["group_size"] == 2
                      and v["group_rank"] == rk,
                      f"dvm (b) tenant {tag} rank {rk} group: {v}")
                check(v["flash"]["ok"],
                      f"dvm (b) tenant {tag} rank {rk} flash: {v['flash']}")
                if DEVICE == "cuda":
                    check(v["current_device"] == 0, f"dvm (b) card: {v}")
            check(rows[0]["coord"] == rows[1]["coord"]
                  and rows[0]["host"] == rows[1]["host"],
                  f"dvm (b) tenant {tag}: {rows}")
            return {"wall_s": wall, "rows": rows,
                    "submit_to_kernel_s": sorted(
                        v["flash"]["wall"] - t_sub for v in rows.values())}

        # (b1): one tenant alone, then two at once (their labels on
        # /metrics while both hold)
        def job_labels() -> set:
            _ms, metrics = _dvm_http(base, "/metrics")
            return {ln.split('job="', 1)[1].split('"', 1)[0]
                    for ln in metrics.splitlines()
                    if ln.startswith("ompi_tpu_") and 'job="' in ln}

        solo = rows_of(*tenant("solo", "b1", hold=0.0), "solo")
        before = job_labels()
        t_pair = time.time()
        pair = {tag: tenant(tag, "b1") for tag in ("x", "y")}
        labels: set = set()
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline and len(labels) < 2 and any(
                job[0].is_alive() for _t, job in pair.values()):
            labels = job_labels() - before
            time.sleep(0.2)
        got = {tag: rows_of(t, job, tag) for tag, (t, job) in pair.items()}
        pair_wall = time.time() - t_pair
        jobids = {got[t]["rows"][0]["jobid"] for t in got}
        check(len(jobids) == 2 and jobids <= labels,
              f"dvm /metrics during (b1) carried jobs {labels}, not {jobids}")
        check(got["x"]["rows"][0]["coord"] != got["y"]["rows"][0]["coord"]
              and got["x"]["rows"][0]["host"] != got["y"]["rows"][0]["host"],
              "dvm (b1): the two tenants share a rendezvous or a host")
        # (b2) beside the stop tenant
        t_b2, b2 = tenant("b2", "b2", extra=(
            "--mca", "faultinject_plan", "rank=1:stall@coll=3",
            "--mca", "faultinject_seed", "0"))
        _t, stop_job = tenant("stop", "stop")
        b2 = rows_of(t_b2, b2, "b2")
        r1 = b2["rows"][1]
        check(r1["flash_after"]["ok"] and b2["rows"][0]["flash_after"]["ok"],
              f"dvm (b2): the kernel after the stall: {b2['rows']}")
        events = _dvm_remediation(base, r1["jobid"])
        acts = {e.get("info", {}).get("action"): e for e in events
                if e["kind"] == "remediate"}
        doctors = [e for e in events if e["kind"] == "doctor"]
        check(any(e.get("info", {}).get("verdict") == "straggler"
                  and e["rank"] == 1 for e in doctors)
              and "sigcont" in acts and acts["sigcont"]["rank"] == 1
              and "recovered" in acts,
              f"dvm (b2) remediation events: {events}")
        stall_enter, stall_leave = r1["coll_walls"][2]
        # the stop tenant: its ranks are up and hold their contexts
        marker = os.path.join(work, "stop_rank")
        deadline = time.monotonic() + 120
        while not all(os.path.exists(f"{marker}{k}.json") for k in (0, 1)):
            check(time.monotonic() < deadline and stop_job[0].is_alive(),
                  f"dvm: the stop tenant never came up: {stop_job[2]}")
            time.sleep(0.2)
        time.sleep(0.2)
        rows = {k: json.load(open(f"{marker}{k}.json")) for k in (0, 1)}
        check(all(v["flash"]["ok"] for v in rows.values()),
              f"dvm stop tenant: {rows}")
        out["card_apps"]["stop_tenant_up"] = _card_apps()
        a_done.wait(timeout=300)   # (a)'s clean dry run sees no dead rank
        out["stop"] = _dvm_stop(uri, pool)
        wall, rc, _so, _se = tpurun_wait(stop_job)
        pids += [v["pid"] for v in rows.values()]
        left = _gone(pids + pool_pids, apps0)
        check(not left, f"dvm: {left} outlived the --gpu pool's stop "
                        f"({apps0} on the card before the pool)")
        out["card_apps"]["after_stop"] = _card_apps()
        out.update(
            b1={"solo": {"wall_s": solo["wall_s"],
                         "submit_to_kernel_s": solo["submit_to_kernel_s"]},
                "pair_wall_s": pair_wall,
                "pair": {t: {"wall_s": v["wall_s"],
                             "submit_to_kernel_s": v["submit_to_kernel_s"],
                             "hosts": sorted(r["host"]
                                             for r in v["rows"].values())}
                         for t, v in got.items()},
                "metrics_jobs": sorted(labels)},
            b2={"wall_s": b2["wall_s"],
                "stall_to_recovered_s": stall_leave - stall_enter,
                "probe_latency_ms": acts["recovered"]["info"].get(
                    "latency_ms"),
                "verdicts": [e.get("info", {}).get("verdict")
                             for e in doctors]},
            stop_tenant={"rc": rc, "wall_s": wall}, pids_left=left,
            rank_flash_launches=sum(
                v["flash"]["launches"] + v.get("flash_after", {}).get(
                    "launches", 0)
                for t in (solo, *got.values(), b2) for v in
                t["rows"].values()) + sum(v["flash"]["launches"]
                                           for v in rows.values()))
    finally:
        if pool.poll() is None:
            _dvm_tool("ompi_tpu_torch.tools.tpurun", "--dvm-stop",
                      "--dvm-uri", uri)
            try:
                pool.wait(timeout=60)
            except subprocess.TimeoutExpired:
                pool.kill()
    return out


def phase_dvm(card):
    """The standing DVM (``tpurun --dvm-start``): (a) a host pool and (b)
    a ``--gpu`` pool side by side, each with its own ``--dvm-uri`` under
    build/dvm_smoke/ (removed at the end)."""
    import shutil

    work = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "build", "dvm_smoke")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    inboxes = _shm_inboxes()
    a_done = threading.Event()
    apps0 = _card_apps()          # this process's own context
    t0 = time.perf_counter()
    try:
        with ThreadPoolExecutor(2) as ex:
            fb = ex.submit(_dvm_card, work, a_done)
            fa = ex.submit(_dvm_host, work, a_done, inboxes)
            try:
                host = fa.result()
            finally:
                a_done.set()
            gpu = fb.result()
        left = _gone(host["orted_pids"], apps0)
        check(not left, f"dvm: {left} on the card after both pools' stop")
    finally:
        for reaper, _, _ in _HOST_JOBS:
            reaper.join()
        _HOST_JOBS.clear()
        shutil.rmtree(work, ignore_errors=True)
    emit("dvm", host_pool=host, gpu_pool=gpu, seconds=time.perf_counter() - t0,
         card=card)
    return gpu["rank_flash_launches"]


TOOLS_STEPS = 3              # (a) xprof_capture --steps
#: (a)-(c)'s depth (--layers): the flagship's widths at CUT_LAYERS, which
#: paid for phase sweep's seconds; the sweep times the 8 layers
TOOLS_LAYERS = CUT_LAYERS
TOOLS_JOB_TIMEOUT = 900      # every tool's child, seconds
TOOLS_OSC_NP = 3             # (d) osc_device_window's ranks, on card 0
#: (a)-(c) on the CPU rehearsal: the tools' small configs
TOOLS_SMALL = False


def _tools_run(module: str, *args) -> tuple:
    """(seconds, stdout) of ``python -m ompi_tpu_torch.tools.<module>``;
    a non-zero exit fails the phase."""
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", f"ompi_tpu_torch.tools.{module}",
                        *args], capture_output=True, text=True,
                       timeout=TOOLS_JOB_TIMEOUT,
                       cwd=os.path.dirname(os.path.abspath(__file__)))
    check(r.returncode == 0, f"tools {module}: rc {r.returncode}\n"
          f"{r.stdout[-2000:]}{r.stderr[-3000:]}")
    return time.perf_counter() - t0, r.stdout


HOST_TOOLS_PACK_RUNS = "1,1000,100000"   # pack_bench --runs


def _jsonl(path: str) -> list:
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def phase_host_tools(card):
    """The port's host-plane microbenches as a user runs them, each CLI
    in a fresh process with ``--out`` under build/host_tools_smoke/
    (removed at the end): (a) pack_bench at ``HOST_TOOLS_PACK_RUNS``
    runs; (b) coll_bench --quick --ranks 4 (coll/shm arena against
    coll/host); (c) net_bench --quick (two ranks on two simulated hosts
    of the port's tpurun, the native tcp plane against the Python one);
    (d) fleet_bench --quick --assert (the simulated fleet's invariants
    at 25 and 100 daemons).  Every tool must exit 0 and write the rows
    its flags ask for; one line a tool gives its rows' key numbers and
    its seconds.  These are host figures of the card's machine: no tool
    touches the card."""
    import shutil

    work = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "build", "host_tools_smoke")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    try:
        # (a) the convertor's three plan families at three run counts
        out = os.path.join(work, "pack.jsonl")
        secs, _so = _tools_run("pack_bench", "--runs", HOST_TOOLS_PACK_RUNS,
                               "--out", out)
        rows = _jsonl(out)
        runs = [int(x) for x in HOST_TOOLS_PACK_RUNS.split(",")]
        check(len(rows) == 3 * len(runs)
              and [(r["layout"], r["runs"]) for r in rows]
              == [(lay, n) for lay in ("vector", "hindexed", "ragged")
                  for n in runs]
              and all(r["pack_into_ms"] > 0 and r["unpack_ms"] > 0
                      and r["payload_bytes"] > 0 for r in rows),
              f"host_tools pack_bench rows: {rows}")
        emit("host_tools", tool="pack_bench", seconds=secs, card=card,
             rows=[{k: r[k] for k in (
                 "layout", "runs", "plan", "native", "payload_bytes",
                 "commit_ms", "first_pack_ms", "pack_into_ms",
                 "pack_into_gibps", "pack_ms", "unpack_ms")}
                 for r in rows])
        # (b) shm arena against coll/host, 4 in-process ranks
        out = os.path.join(work, "coll.jsonl")
        secs, so = _tools_run("coll_bench", "--quick", "--ranks", "4",
                              "--out", out)
        rows = _jsonl(out)
        check(len(rows) == 14 and f"{len(rows)} rows -> " in so
              and {r["component"] for r in rows} == {"shm", "host"}
              and all(r["ranks"] == 4 and r["per_op_us"] > 0
                      for r in rows),
              f"host_tools coll_bench rows: {rows}\n{so[-2000:]}")
        emit("host_tools", tool="coll_bench", seconds=secs, card=card,
             rows=[{k: r[k] for k in (
                 "coll", "payload_bytes", "component", "per_op_us",
                 "p50_us", "p99_us", "shm_speedup")} for r in rows])
        # (c) native against Python tcp plane across two simulated hosts
        out = os.path.join(work, "net.jsonl")
        secs, so = _tools_run("net_bench", "--quick", "--out", out)
        rows = _jsonl(out)
        check(len(rows) == 6 and {r["world"] for r in rows} == {"fakehost"}
              and all((r.get("p50_us") or r.get("msgs_per_s") or 0) > 0
                      for r in rows)
              and "acceptance (fakehost)" in so,
              f"host_tools net_bench rows: {rows}\n{so[-2000:]}")
        emit("host_tools", tool="net_bench", seconds=secs, card=card,
             rows=[{k: r[k] for k in r if k not in ("iters", "reps")}
                   for r in rows],
             acceptance=[ln for ln in so.splitlines()
                         if ln.startswith("acceptance")])
        # (d) the simulated fleet under correlated loss, invariants held
        out = os.path.join(work, "fleet.jsonl")
        secs, so = _tools_run("fleet_bench", "--quick", "--assert",
                              "--out", out)
        rows = _jsonl(out)
        check([r["n_daemons"] for r in rows] == [25, 100]
              and all(r["ok"] for r in rows),
              f"host_tools fleet_bench rows: {rows}")
        emit("host_tools", tool="fleet_bench", seconds=secs, card=card,
             rows=[{k: r[k] for k in (
                 "n_daemons", "n_ranks", "killed_daemons", "boot_s",
                 "adopt_s", "reparent_epochs", "reparent_orphans",
                 "reparent_frames", "false_positive_ranks", "doctor_rows",
                 "doctor_s", "agg_merges", "agg_sheds", "ok")}
                 for r in rows])
    finally:
        shutil.rmtree(work, ignore_errors=True)


def _tools_examples(work: str) -> dict:
    """(d): generate and train on the card and with ``--device cpu``, and
    osc_device_window across ``TOOLS_OSC_NP`` ranks on card 0, side by
    side; returns their results."""
    gpu = ["--gpu"] if DEVICE == "cuda" else []
    cpu = ["--device", "cpu"]
    card_dev = [] if DEVICE == "cuda" else cpu
    jobs = {
        "generate_card": ["-np", "1", *gpu, "--no-tag-output", "--",
                          sys.executable, "-m",
                          "ompi_tpu_torch.examples.generate", *card_dev],
        "generate_cpu": ["-np", "1", "--no-tag-output", "--",
                         sys.executable, "-m",
                         "ompi_tpu_torch.examples.generate", *cpu],
        "train_card": ["-np", "1", *gpu, "--no-tag-output", "--",
                       sys.executable, "-m", "ompi_tpu_torch.examples.train",
                       "--ckpt-dir", os.path.join(work, "train_card"),
                       *card_dev],
        "train_cpu": ["-np", "1", "--no-tag-output", "--", sys.executable,
                      "-m", "ompi_tpu_torch.examples.train", "--ckpt-dir",
                      os.path.join(work, "train_cpu"), *cpu],
        "osc": ["-np", str(TOOLS_OSC_NP), *(
            gpu if DEVICE == "cuda" else
            ["-x", f"OMPI_TPU_COORD=127.0.0.1:{free_port()}",
             "-x", "OMPI_TPU_NHOSTS=1"]), "--no-tag-output", "--",
                sys.executable, "-m",
                "ompi_tpu_torch.examples.osc_device_window", *card_dev],
    }
    started = {k: tpurun_start(v) for k, v in jobs.items()}
    res = {}
    for k, job in started.items():
        wall, rc, so, se = tpurun_wait(job)
        check(rc == 0, f"tools example {k}: rc {rc}\n{so[-2000:]}"
                       f"{se[-3000:]}")
        res[k] = {"wall_s": wall, "lines": [
            ln for ln in so.splitlines() if ln.strip()]}
    out: dict = {"wall_s": {k: v["wall_s"] for k, v in res.items()}}
    # generate: the card's tokens equal the CPU's
    g_card, g_cpu = res["generate_card"]["lines"], res["generate_cpu"]["lines"]
    check(len(g_cpu) == 3 and g_cpu[0].startswith("mesh {'dp': 1")
          and g_card == g_cpu,
          f"tools generate: the card's lines {g_card} are not the CPU's "
          f"{g_cpu}")
    out["generate_rows"] = [json.loads(ln) for ln in g_card[1:]]
    # train: the reference's lines; the card's losses the CPU's at SMALL_TOL
    rec = {}
    for k in ("train_card", "train_cpu"):
        lines = res[k]["lines"]
        (rec[k],) = tagged_json("\n".join(lines), "train")
        check([ln.split(":")[0] for ln in lines if ln.startswith("step ")]
              == [f"step {i}" for i in range(6)]
              and any(ln.startswith("checkpoint at step 3 -> ")
                      for ln in lines)
              and "resume: batch stream reproduced from checkpointed step "
                  "— ok" in lines, f"tools {k}: {lines}")
    lc, lp = (np.asarray(rec[k]["losses"]) for k in ("train_card",
                                                     "train_cpu"))
    rel = float(np.max(np.abs(lc - lp) / np.abs(lp)))
    check(rec["train_card"]["device"].startswith(DEVICE)
          and rec["train_cpu"]["device"] == "cpu"
          and bool(np.isfinite(lc).all()) and rel <= SMALL_TOL,
          f"tools train: card {rec['train_card']} vs cpu "
          f"{rec['train_cpu']} (max rel {rel})")
    out["train"] = {"losses_card": lc.tolist(), "losses_cpu": lp.tolist(),
                    "max_rel_diff": rel, "tol": SMALL_TOL}
    # osc_device_window: the reference's lines, each rank's part
    lines = res["osc"]["lines"]
    n = TOOLS_OSC_NP
    rows = {r["rank"]: r for r in tagged_json("\n".join(lines),
                                               "osc_device_window")}
    check(f"{n}-device window over {DEVICE}" in lines
          and f"one-sided put landed on device {n - 1}; one-sided get "
              f"fetched it back: 42.0" in lines
          and sorted(rows) == list(range(n))
          and [rows[r]["local"] for r in range(n)]
          == [0.0] * (n - 1) + [42.0]
          and rows[1]["fetched"] == rows[n - 1]["fetched"] == 42.0,
          f"tools osc_device_window: {lines}")
    launches = {k: sum(r[f"{k}_launches"] for r in rows.values())
                for k in ("put", "get")}
    if DEVICE == "cuda":
        check(all(r["device"].startswith("cuda") for r in rows.values())
              and launches["put"] >= 1 and launches["get"] >= 1,
              f"tools osc_device_window: the copy kernels never ran: "
              f"{rows}")
    out["osc"] = {"rows": rows, "launches": launches}
    return out


def phase_tools(card, device_name: str = ""):
    """The flagship's profiling tools as a user runs them, each CLI in a
    fresh process at ``TOOLS_LAYERS`` of depth, then the four examples:
    (a) xprof_capture; (b) step_breakdown fwd grad full; (c) cost_analysis side by side with (d)
    generate, train and osc_device_window.  Files go under
    build/tools_smoke/ (removed at the end)."""
    import shutil

    work = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "build", "tools_smoke")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    size = ["--small"] * TOOLS_SMALL + ["--layers", str(TOOLS_LAYERS)]
    on_cpu = DEVICE != "cuda"
    L = TOOLS_LAYERS
    secs, out = {}, {"card": card}
    try:
        # (a) the trace of TOOLS_STEPS train steps
        secs["xprof"], so = _tools_run(
            "xprof_capture", "--steps", str(TOOLS_STEPS), "--out",
            os.path.join(work, "xprof"), *size, *(["--cpu", "1"] * on_cpu))
        xp = json.loads(so.strip().splitlines()[-1])
        fr = xp["fractions"]
        check(xp["events"] > 0 and set(fr) <= {"mxu", "copy", "collective",
                                               "other"}
              and abs(sum(fr.values()) - 1.0) < 1e-6 and fr.get("mxu", 0) > 0
              and xp["steps"] == TOOLS_STEPS
              and os.path.exists(os.path.join(work, "xprof", "summary.json"))
              and np.isfinite(xp["loss"]),
              f"tools xprof_capture: {xp}")
        want = {"flash_fwd": 2 * L, "flash_bwd_dq": L, "flash_bwd_dkv": L}
        if not on_cpu:
            check(xp["backend"] == device_name
                  and xp["flash_launches"] == {
                      k: v * TOOLS_STEPS for k, v in want.items()}
                  and all(v * TOOLS_STEPS - 1 <= xp["flash_events"][k]
                          <= v * TOOLS_STEPS for k, v in want.items()),
                  f"tools xprof_capture: flash launches "
                  f"{xp['flash_launches']}, trace events "
                  f"{xp['flash_events']}, want {want} a step")
        out["xprof"] = {k: xp[k] for k in (
            "events", "total_op_ms", "fractions", "top_ops_ms", "backend",
            "steps", "traced_wall_ms", "params", "flash_launches",
            "flash_events", "loss")}
        out["xprof"]["device_busy_ms_per_step"] = (xp["total_op_ms"]
                                                   / TOOLS_STEPS)
        # (b) fwd, grad and full, each in its own child
        secs["breakdown"], so = _tools_run(
            "step_breakdown", "fwd", "grad", "full", *size,
            *(["--cpu"] * on_cpu))
        bd = {}
        for ln in so.splitlines():
            if ln.startswith("[breakdown] "):
                rec = json.loads(ln.split(": ", 1)[1])
                bd[rec["phase"]] = rec
        check(sorted(bd) == ["full", "fwd", "grad"]
              and all(np.isfinite(r["step_ms"]) and np.isfinite(r["loss"])
                      and (on_cpu or np.isfinite(r["mfu_pct"]))
                      for r in bd.values())
              # on the rehearsal's tiny model the order is noise
              and (on_cpu or bd["full"]["step_ms"] >= bd["grad"]["step_ms"]
                   >= bd["fwd"]["step_ms"]),
              f"tools step_breakdown: {bd}")
        if not on_cpu:
            chain = bd["fwd"]["chain"]
            check(bd["grad"]["flash_launches"] == {
                k: v * chain for k, v in want.items()}
                  and bd["fwd"]["flash_launches"]["flash_fwd"] == L * chain,
                  f"tools step_breakdown: launches {bd}")
        out["breakdown"] = bd
        # (c) beside (d): cost_analysis runs no timing
        with ThreadPoolExecutor(1) as ex:
            ex_job = ex.submit(_tools_examples, work)
            try:
                secs["cost"], so = _tools_run(
                    "cost_analysis", *size, *(["--cpu"] * on_cpu))
            finally:
                t_ex = time.perf_counter()
                examples = ex_job.result()
                secs["examples_after_cost"] = time.perf_counter() - t_ex
        ca = json.loads(so[so.index("{"):])
        check(ca["flops"] >= ca["analytic_flops"] > 0
              and ca["bytes_accessed"] > 0
              and (on_cpu or (ca["flash_launches"] == want
                              and ca["kernel_flops"] > 0
                              and np.isfinite(ca["flops_bound_ms"])
                              and np.isfinite(ca["bytes_bound_ms"]))),
              f"tools cost_analysis: {ca}")
        out["cost"] = ca
        out["examples"] = examples
    finally:
        for reaper, _, _ in _HOST_JOBS:
            reaper.join()
        _HOST_JOBS.clear()
        shutil.rmtree(work, ignore_errors=True)
    launches = {k: out["xprof"]["flash_launches"][k]
                + sum(r["flash_launches"][k] for r in out["breakdown"].values())
                + out["cost"]["flash_launches"][k] for k in want}
    emit("tools", **out, flash_launches=launches,
         osc_launches=out["examples"]["osc"]["launches"], seconds=secs)
    return launches


#: phase sweep's rows of ``ompi_tpu_torch.tools.mfu_sweep``: its QUICK
#: rows, the plain attention and the flash backward kernels beside
#: b16-chunk128-dots, and the two long sequences; each with its own
#: chain and outer
SWEEP_ROWS = ("matmul_peak", "b16-chunk128-dots", "b32-chunk128-dots",
              "b16-chunk128-xla", "b16-chunk128-dots-pbwd",
              "b8-s2048-flash-chain16", "b4-s4096-flash-chain16")
#: rows that compute one function (same batch, chain, outer and dtypes)
SWEEP_SAME = ("b16-chunk128-dots", "b16-chunk128-xla",
              "b16-chunk128-dots-pbwd")
#: their last losses' largest relative spread.  In f32 on the CPU these
#: paths give one loss; in bf16 at flagship.SMALL's widths the rows'
#: 24 steps spread them by 1.7e-3, and a -pbwd row whose dq is zero or
#: scaled twice moves its loss by 2.0e-2 or 1.5e-2
#: (tests/test_torch_mfu_sweep.py holds both sides); on the card the
#: three rows spread by 5.3e-3
SWEEP_LOSS_RTOL = 1e-2
#: (B·H, T) of the long rows' attention (bf16, causal, 128 a head): the
#: forward, dq and dk/dv held against their plain versions there
SWEEP_LENGTHS = ((128, 2048), (64, 4096))
#: the heads (of B·H) the plain versions compute: their T² scores
SWEEP_SLICE = 16
#: at those lengths the kernel phases' tolerances no longer separate a
#: wrong kernel (an output element's size is about sqrt(e/T), 0.036 at
#: T = 2048: BF16_TOL's size), so o, dq, dk and dv are held row by row
#: (``long_row_rl2``) and lse absolutely as well
SWEEP_ROW_RL2 = RING_ROW_RL2
SWEEP_LSE_ATOL = 1e-3
#: the planted fault those limits must catch: the keys and values of one
#: tile of this many keys, from the middle of the sequence on, zeroed in
#: the kernels' inputs and the outputs held against the true references
SWEEP_FAULT_KEYS = 128
SWEEP_TIMEOUT = 900          # a sweep command, seconds
#: the rows run by a second command at ``SWEEP_LAYERS`` of depth
#: (``--layers``: the flagship's widths and the rows' batch and sequence
#: kept), which paid for phase bench's seconds; their checks hold at any
#: depth.  matmul_peak and the ``SWEEP_SAME`` rows keep the 8 layers: at
#: 1–3 layers in bf16 the three rows memorise their batch within the 24
#: steps and their losses part by 10–47% on the H100
SWEEP_CUT_ROWS = ("b32-chunk128-dots", "b8-s2048-flash-chain16",
                  "b4-s4096-flash-chain16")
SWEEP_LAYERS = CUT_LAYERS
#: the CPU rehearsal: the rows at --cpu --small
SWEEP_SMALL = False


def long_row_rl2(got, want) -> float:
    """The largest relative L2 error over the rows (the last dimension)
    of a kernel's output, each row held to its own size or, where that
    is smaller, to the median row's: a causal dq's first row is zero but
    for rounding (one key, so P = 1 and dP − dm cancels), and noise of
    that size is no error."""
    a, b = got.float(), want.float()
    size = b.norm(dim=-1)
    return ((a - b).norm(dim=-1) / size.clamp_min(size.median())).max().item()


def _long_errors(o, lse, grads, ro, rlse, want) -> dict:
    """The long rows' error measures of a forward (o, lse) and backward
    (dq, dk, dv) against their plain versions."""
    err = {"o": long_row_rl2(o, ro),
           "lse": (lse - rlse).abs().max().item()}
    for name, a, b in zip(("dq", "dk", "dv"), grads, want):
        err[name] = long_row_rl2(a, b)
    return err


def _sweep_kernels(fa) -> dict:
    """The forward, dq and dk/dv at ``SWEEP_LENGTHS``, each held on its
    first ``SWEEP_SLICE`` heads against its plain version at the kernel
    phases' bf16 tolerances and by ``SWEEP_ROW_RL2`` a row
    (``SWEEP_LSE_ATOL`` for lse); the same kernels given one tile of
    zeroed keys and values (``SWEEP_FAULT_KEYS``) must fail every one of
    those limits; each timed (CUDA events) beside its bound and SDPA."""
    import torch

    limit = {"o": SWEEP_ROW_RL2, "lse": SWEEP_LSE_ATOL, "dq": SWEEP_ROW_RL2,
             "dk": SWEEP_ROW_RL2, "dv": SWEEP_ROW_RL2}

    g = torch.Generator(device=DEVICE).manual_seed(3)
    H = FLAGSHIP["n_heads"]
    D = FLAGSHIP["d_model"] // H
    scale = D ** -0.5
    n = SWEEP_SLICE
    out = {}
    for bh, t in SWEEP_LENGTHS:
        q3, k3, v3, g3 = (torch.randn((bh, t, D), generator=g, device=DEVICE)
                          .to(torch.bfloat16) for _ in range(4))
        o3, lse = fa.flash_fwd_3d(q3, k3, v3, 0, 0, scale, True)
        ro, rlse = fa.flash_attention_lse_reference(
            *(x[:n].unsqueeze(2) for x in (q3, k3, v3)), causal=True,
            scale=scale)
        ro, rlse = ro.squeeze(2).float(), rlse.reshape(n, t)
        err = {"o": (o3[:n].float() - ro).abs().max().item(),
               "lse": (lse[:n] - rlse).abs().max().item()}
        check(torch.allclose(o3[:n].float(), ro, atol=BF16_TOL, rtol=BF16_TOL)
              and torch.allclose(lse[:n], rlse, atol=BF16_TOL, rtol=BF16_TOL),
              f"sweep: the forward disagrees at (B·H, T) = ({bh}, {t}): "
              f"max err {err}")
        dm = (g3.float() * o3.float()).sum(-1)
        args = (q3, k3, v3, g3, lse, dm, 0, 0, scale, True)
        got = fa.flash_bwd_3d(*args)
        want = fa.flash_bwd_reference(*(x[:n] for x in args[:6]), 0, 0,
                                      scale, True)
        for name, a, b in zip(("dq", "dk", "dv"), got, want):
            ok, err[name] = bwd_err(a[:n], b, torch.bfloat16)
            check(ok, f"sweep: the {name} kernel disagrees at (B·H, T) = "
                      f"({bh}, {t}): max err {err[name]}")
        rows = _long_errors(o3[:n], lse[:n], [x[:n] for x in got], ro, rlse,
                            want)
        check(all(rows[k] <= limit[k] for k in limit),
              f"sweep: the kernels disagree row by row at (B·H, T) = "
              f"({bh}, {t}): {rows}, limits {limit}")
        del got
        # the planted fault: the keys of one tile zeroed in the inputs
        lo = t // 2
        kf, vf = k3.clone(), v3.clone()
        kf[:, lo:lo + SWEEP_FAULT_KEYS] = 0
        vf[:, lo:lo + SWEEP_FAULT_KEYS] = 0
        of, lsef = fa.flash_fwd_3d(q3[:n], kf[:n], vf[:n], 0, 0, scale, True)
        bad = fa.flash_bwd_3d(q3[:n], kf[:n], vf[:n], g3[:n], lse[:n],
                              dm[:n], 0, 0, scale, True)
        fault = _long_errors(of, lsef, bad, ro, rlse, want)
        check(all(fault[k] > limit[k] for k in limit),
              f"sweep: at (B·H, T) = ({bh}, {t}) kernels given a zeroed "
              f"tile of keys pass a limit: {fault}, limits {limit}")
        del want, kf, vf, of, lsef, bad, ro, rlse
        rec = {"shape": [bh, t, D], "slice": n, "max_abs_err": err,
               "row_errors": rows, "limits": limit,
               "fault": {"zeroed_keys": [lo, lo + SWEEP_FAULT_KEYS],
                         "errors": fault}}
        if DEVICE == "cuda":
            qs, ks, vs = (x.view(bh // H, H, t, D).detach()
                          .requires_grad_(True) for x in (q3, k3, v3))
            gs = g3.view(bh // H, H, t, D)
            sdpa = torch.nn.functional.scaled_dot_product_attention
            sdpa_fwd = cuda_ms(lambda: sdpa(qs, ks, vs, is_causal=True))
            sdpa_bwd = cuda_ms(lambda: torch.autograd.grad(
                sdpa(qs, ks, vs, is_causal=True), (qs, ks, vs), gs)) - sdpa_fwd
            timed = (("fwd", lambda: fa.flash_fwd_3d(q3, k3, v3, 0, 0, scale,
                                                     True),
                      attention_bound_ms(bh, 1, t, t, D, 2, True, 0, 0),
                      sdpa_fwd),
                     ("dq", lambda: fa.flash_bwd_dq_3d(*args),
                      bwd_bound_ms("dq", bh, t, t, D, 2, True, 0, 0),
                      sdpa_bwd),
                     ("dkv", lambda: fa.flash_bwd_dkv_3d(*args),
                      bwd_bound_ms("dkv", bh, t, t, D, 2, True, 0, 0),
                      sdpa_bwd))
            for name, fn, (b_ms, b_by, nbytes, flops), lib_ms in timed:
                ms = cuda_ms(fn)
                rec[name] = {"ms": ms, "bound_ms": b_ms, "bound_by": b_by,
                             "bytes": nbytes, "flops": flops,
                             "tflops": flops / ms / 1e9, "library_ms": lib_ms}
            rec["library_note"] = ("SDPA; its backward computes dq, dk and "
                                   "dv together")
            del qs, ks, vs, gs
        out[f"T{t}"] = rec
        del q3, k3, v3, g3, o3, lse, dm, args
    return out


def _sweep_expected(cfg: dict, layers: int) -> dict:
    """A sweep row's flash launches on the card: a forward a layer and
    its rerun under remat, a dq and a dk/dv a layer with the backward
    kernels on, per microbatch of each of its warm and timed steps (on
    the CPU none: the wrappers run their plain versions)."""
    if cfg["attention"] != "flash" or DEVICE != "cuda":
        return {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
    steps = (cfg.get("chain", 8) * (1 + cfg.get("outer", 2))
             * cfg.get("grad_accum", 1))
    bwd = bool((cfg.get("_mca") or {}).get("ops_flash_bwd_kernel"))
    fwd = layers * (2 if cfg["remat"] in ("dots", "full") else 1)
    return {"flash_fwd": fwd * steps, "flash_bwd_dq": layers * steps * bwd,
            "flash_bwd_dkv": layers * steps * bwd}


def phase_sweep(fa, card):
    """The flagship MFU sweep as a user runs it: ``python -m
    ompi_tpu_torch.tools.mfu_sweep`` on ``SWEEP_ROWS``, each row in its
    own child (records appended to build/ompi_tpu_torch/MFU_SWEEP.jsonl),
    ``SWEEP_CUT_ROWS`` by a second command at ``SWEEP_LAYERS`` of depth,
    after the forward, dq and dk/dv are held against their plain
    versions at the long rows' lengths.  Every row must give a record
    and no error; every loss finite and below ln(vocab) + 0.5; the flash
    rows must launch exactly the forwards (and, ``-pbwd``, the dq and
    dk/dv) their steps call for, the ``xla`` row none; matmul_peak's
    share of the peak in (0, 105]; the ``SWEEP_SAME`` rows' losses within
    ``SWEEP_LOSS_RTOL`` of each other."""
    import math

    import torch

    from ompi_tpu_torch.tools import flagship
    from ompi_tpu_torch.tools import mfu_sweep as M

    secs = {}
    t0 = time.perf_counter()
    kernels = _sweep_kernels(fa)
    secs["kernels"] = time.perf_counter() - t0
    if DEVICE == "cuda":
        torch.cuda.empty_cache()     # the rows' children get the card whole
    small = ["--cpu", "--small"] if SWEEP_SMALL else []
    n_before = len(_jsonl(flagship.SWEEP)) if os.path.exists(
        flagship.SWEEP) else 0
    widths = flagship.SMALL if SWEEP_SMALL else FLAGSHIP
    layers = {label: min(SWEEP_LAYERS, widths["n_layers"])
              if label in SWEEP_CUT_ROWS else widths["n_layers"]
              for label in SWEEP_ROWS}
    t1 = time.perf_counter()
    recs, rcs, errs = {}, [], ""
    for rows, depth in (([k for k in SWEEP_ROWS if k not in SWEEP_CUT_ROWS],
                         []),
                        (list(SWEEP_CUT_ROWS),
                         ["--layers", str(SWEEP_LAYERS)])):
        r = subprocess.run([sys.executable, "-m",
                            "ompi_tpu_torch.tools.mfu_sweep", *rows, *small,
                            *depth], capture_output=True, text=True,
                           timeout=SWEEP_TIMEOUT,
                           cwd=os.path.dirname(os.path.abspath(__file__)))
        rcs.append(r.returncode)
        errs += r.stderr[-2000:]
        for ln in r.stdout.splitlines():
            if ln.startswith("[sweep] ") and ": {" in ln:
                rec = json.loads(ln.split(": ", 1)[1])
                recs[rec["label"]] = rec
    secs["rows"] = time.perf_counter() - t1
    check(sorted(recs) == sorted(SWEEP_ROWS)
          and not [k for k, v in recs.items() if "error" in v]
          and rcs == [0, 0],
          f"sweep: rc {rcs}, rows {sorted(recs)}, errors "
          f"{ {k: v for k, v in recs.items() if 'error' in v} }\n{errs}")
    check(len(_jsonl(flagship.SWEEP)) == n_before + len(SWEEP_ROWS),
          f"sweep: {flagship.SWEEP} did not gain {len(SWEEP_ROWS)} rows")
    grid = {label: cfg for label, cfg, _ in M.GRID}
    most = math.log(widths["vocab"]) + 0.5
    launches = {}
    for label, rec in recs.items():
        cfg = grid[label]
        if cfg is None:
            pct = rec["pct_of_peak"]
            check(SWEEP_SMALL or (pct is not None and 0 < pct <= 105),
                  f"sweep matmul_peak: {rec}")
            continue
        check(np.isfinite(rec["loss"]) and rec["loss"] < most
              and rec["step_ms"] > 0 and np.isfinite(rec["step_ms"]),
              f"sweep {label}: loss {rec['loss']} (below {most}), step ms "
              f"{rec['step_ms']}")
        launches[label] = rec["flash_launches"]
        check(rec["n_layers"] == layers[label],
              f"sweep {label}: {rec['n_layers']} layers, want "
              f"{layers[label]}")
        want = _sweep_expected(cfg, layers[label])
        check(rec["flash_launches"] == want,
              f"sweep {label}: flash launches {rec['flash_launches']}, want "
              f"{want}")
    same = [recs[k]["loss"] for k in SWEEP_SAME]
    spread = (max(same) - min(same)) / min(same)
    check(spread <= SWEEP_LOSS_RTOL,
          f"sweep: the losses of {SWEEP_SAME} are {same} (spread {spread}, "
          f"at most {SWEEP_LOSS_RTOL})")
    keys = ("step_ms", "tokens_per_s", "mfu_pct", "loss", "params",
            "peak_gib", "import_s", "init_s", "wall_s", "wait_s",
            "flash_launches", "batch", "seq", "n_layers", "chain", "outer",
            "ms",
            "tflops", "pct_of_peak", "dispatch_rt_ms", "backend")
    secs["phase"] = time.perf_counter() - t0
    emit("sweep", card=card,
         rows={k: {f: v[f] for f in keys if f in v} for k, v in recs.items()},
         same_function={"rows": SWEEP_SAME, "losses": same,
                        "spread": spread, "rtol": SWEEP_LOSS_RTOL},
         kernels=kernels, flash_launches=launches, seconds=secs)
    return {label: rec["params"] for label, rec in recs.items()
            if "params" in rec}


#: phase bench: the bench's command, seconds
BENCH_TIMEOUT = 900
#: the bench's matrix rows, in the reference's order (bench.py:1098-1115)
BENCH_ROWS = ("ring_latency", "shm_pingpong", "shm_msgrate", "hbm_copy",
              "allreduce_sweep", "mesh_bcast_allgather",
              "grad_reduce_scatter", "oshmem_device", "remote_dma",
              "decode_throughput", "flash_bwd_kernel", "tuned_crossovers")
#: the rows that need two or more cards: on one card they carry the note
BENCH_ONE_CARD_ROWS = ("allreduce_sweep", "mesh_bcast_allgather",
                       "grad_reduce_scatter", "oshmem_device")
#: the sweep row whose parameters (468M) the headline must count
BENCH_PARAMS_ROW = "b16-chunk128-xla"


def _tree_digest(path: str) -> dict:
    """{file name: sha256} of the files directly in ``path``."""
    import hashlib

    out = {}
    for fn in sorted(os.listdir(path)):
        full = os.path.join(path, fn)
        if os.path.isfile(full):
            with open(full, "rb") as f:
                out[fn] = hashlib.sha256(f.read()).hexdigest()
    return out


def _bench_tuner_checks(row: dict, name: str) -> dict:
    """The tuner's row at one card: provenance only, no rule, every cell
    measured, nothing shipped, and coll/xla decides with the row's file
    exactly as without it."""
    import tempfile

    from ompi_tpu_torch.mpi.coll import rules, xla
    from ompi_tpu_torch.mpi.device_comm import device_world
    from ompi_tpu_torch.parallel.mesh import make_mesh

    check(row["meta"] == {"platform": "cuda",
                          "device_kind": name.replace(" ", "_"),
                          "n_devices": "1"}, f"tune provenance {row['meta']}")
    check(row["value"] == 0 and row["rules"] == [],
          f"tune at one card gave rules: {row['rules']}")
    check(row["shipped"].startswith("no"), f"tune shipped {row['shipped']}")
    table = row["table_us"]
    check(all(set(cell) == set(xla.XlaColl.ALGORITHMS[c])
              for c, cells in table.items() for cell in cells.values())
          and set(table) == set(xla.XlaColl.ALGORITHMS),
          f"a cell was not measured: {table}")
    dc = device_world(make_mesh(device=DEVICE))
    comp = xla.XlaColl()
    comp.register_params()

    def decisions():
        xla._measured_cache.clear()
        return {c: [comp._decide(c, None, dc, n) for n in (4 << 10,
                                                            64 << 20)]
                for c in xla.XlaColl.ALGORITHMS}

    with tempfile.TemporaryDirectory() as d:
        out = os.path.join(d, "xla_measured_rules.conf")
        with open(out, "w") as f:
            f.write("".join(f"#! {k}={v}\n" for k, v in row["meta"].items()))
        check(rules.load_rules(out).meta == row["meta"]
              and len(rules.load_rules(out)) == 0, "tune file round trip")
        saved = xla._MEASURED_PATH
        without = decisions()
        xla._MEASURED_PATH = out
        try:
            with_file = decisions()
        finally:
            xla._MEASURED_PATH = saved
            xla._measured_cache.clear()
    check(with_file == without,
          f"decisions moved with the file: {with_file} vs {without}")
    ar = table["allreduce"]["64MiB"]
    return {"decisions_4KiB_64MiB": without,
            "psum_over_rs_ag_64MiB": ar["psum"] / ar["rs_ag"]}


def phase_bench(card, name: str, params: int):
    """The benchmark tool as a user runs it: ``python -m
    ompi_tpu_torch.tools.bench`` once, in a fresh process.  It must exit
    0 with exactly one stdout line: backend ``gpu`` and this card's name,
    a headline MFU in (0, 105] over ``params`` parameters (the sweep's
    468M), the 12 rows in the reference's order with no ``error``, the
    four rows that need two cards carrying the one-card note,
    ``remote_dma`` correct over its 64 MiB window with one put launch a
    call, ``flash_bwd_kernel``'s gradients finite with the forward, dq
    and dk/dv launched twice each (warm and timed), and the tuner's row
    shipping nothing: ``ompi_tpu_torch/mpi/coll/`` is unchanged and
    coll/xla decides as without its file.  → the bench's kernel
    launches."""
    import torch

    here = os.path.dirname(os.path.abspath(__file__))
    coll = os.path.join(here, "ompi_tpu_torch", "mpi", "coll")
    before = _tree_digest(coll)
    if DEVICE == "cuda":
        torch.cuda.empty_cache()     # the bench's processes get the card
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "ompi_tpu_torch.tools.bench"],
                       capture_output=True, text=True, timeout=BENCH_TIMEOUT,
                       cwd=here)
    secs = time.perf_counter() - t0
    lines = r.stdout.splitlines()
    check(r.returncode == 0 and len(lines) == 1,
          f"bench: rc {r.returncode}, {len(lines)} stdout lines\n"
          f"{r.stdout[-2000:]}{r.stderr[-3000:]}")
    rec = json.loads(lines[0])
    check(rec["backend"] == "gpu" and rec["kind"] == name
          and rec["n_devices"] == 1, f"bench backend: {rec.get('backend')}, "
          f"{rec.get('kind')}, {rec.get('n_devices')}")
    check(rec["unit"] == "% MFU" and 0 < rec["value"] <= 105
          and rec["params"] == params and rec["step_ms"] > 0
          and rec["tokens_per_s"] > 0,
          f"bench headline: {rec.get('value')} {rec.get('unit')}, params "
          f"{rec.get('params')} (want {params}), {rec.get('error')}")
    rows = {row["config"]: row for row in rec["matrix"]}
    check([row["config"] for row in rec["matrix"]] == list(BENCH_ROWS),
          f"bench rows: {[row['config'] for row in rec['matrix']]}")
    bad = {k: v["error"] for k, v in rows.items() if "error" in v}
    check(not bad, f"bench rows failed: {bad}")
    for k in BENCH_ONE_CARD_ROWS:
        check(rows[k].get("note") == rows["mesh_bcast_allgather"]["note"]
              and "single card" in rows[k]["note"],
              f"bench {k}: no one-card note")
    dma = rows["remote_dma"]
    lo, hi = dma["iters"]
    want_puts = (1 + len(dma["reps_lo_s"])) * lo + (
        1 + len(dma["reps_hi_s"])) * hi + 1
    check(dma["correct"] is True and dma["shape"] == [1 << 24]
          and dma["launches"] == want_puts,
          f"bench remote_dma: correct {dma['correct']}, shape "
          f"{dma['shape']}, put launches {dma['launches']} (want "
          f"{want_puts})")
    fb = rows["flash_bwd_kernel"]
    check(fb["grads_finite"] is True and fb["launches"] == {
        "flash_fwd": 2, "flash_bwd_dq": 2, "flash_bwd_dkv": 2},
          f"bench flash_bwd_kernel: finite {fb['grads_finite']}, launches "
          f"{fb['launches']}")
    tune = _bench_tuner_checks(rows["tuned_crossovers"], name)
    check(_tree_digest(coll) == before,
          "bench changed ompi_tpu_torch/mpi/coll/")
    emit("bench", seconds=secs, card=card,
         record={k: v for k, v in rec.items() if k != "counters"},
         tune=tune)
    return {"flash_fwd": fb["launches"]["flash_fwd"],
            "flash_bwd_dq": fb["launches"]["flash_bwd_dq"],
            "flash_bwd_dkv": fb["launches"]["flash_bwd_dkv"],
            "put": dma["launches"]}


def main() -> int:
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    import torch

    import ompi_tpu_torch  # fails outside a checkout

    if not os.path.abspath(ompi_tpu_torch.__file__).startswith(
            os.path.join(here, "")):
        print(f"chip_smoke: ompi_tpu_torch was imported from "
              f"{ompi_tpu_torch.__file__}, not from this checkout",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on the "
              "card only", file=sys.stderr)
        return 2
    pycache = cache_bytecode(here)
    fa = importlib.import_module("ompi_tpu_torch.ops.flash_attention")
    rd = importlib.import_module("ompi_tpu_torch.ops.remote_dma")
    torch.backends.cuda.matmul.allow_tf32 = False   # f32 parity
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    secs = {}

    def run(phase, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        secs[phase] = time.perf_counter() - t0
        return out

    name, count, smi = run("device", phase_device)
    card = f"{name}, power limit {smi.split(',')[-1].strip()}"
    run("build", phase_build)
    run("native", phase_native, card)
    run("hwtopo", phase_hwtopo, card)
    run("pipeline", phase_pipeline, card)
    run("host_plane", phase_host_plane, card)
    run("host_nbc", phase_host_nbc, card)
    run("host_tools", phase_host_tools, card)
    run("trace", phase_trace, card)
    fwd = run("kernel", phase_kernel, fa)
    bwd = run("kernel_bwd", phase_kernel_bwd, fa)
    ring = run("ring", phase_ring, fa, card)
    rma = run("rma_kernel", phase_rma_kernel, rd, card)
    rma_launches = run("rma_ranks", phase_rma_ranks, card)
    run("ft", phase_ft, card)
    run("io", phase_io, card)
    run("osc", phase_osc, card)
    run("dpm", phase_dpm, card)
    run("plm", phase_plm, card)
    run("dvm", phase_dvm, card)
    run("tools", phase_tools, card, name)
    sweep_params = run("sweep", phase_sweep, fa, card)
    bench = run("bench", phase_bench, card, name,
                sweep_params[BENCH_PARAMS_ROW])
    params_np = run("params", flagship_params)
    decode_launches = run("decode", phase_decode, fa, card, params_np)
    run("cache", phase_cache, fa)
    train = run("train", phase_train, fa, card, params_np)
    run("train_small", phase_train_small, fa)
    ckpt = run("ckpt", phase_ckpt, fa, card, params_np)
    del params_np
    moe_np = run("moe_params", flagship_params, True)
    run("moe_layer", phase_moe_layer, card, moe_np)
    moe_decode = run("moe_decode", phase_decode, fa, card, moe_np, True)
    moe_train = run("moe_train", phase_moe_train, fa, card, moe_np)
    del moe_np
    run("moe_small", phase_train_small, fa, True)
    mesh = run("collectives", phase_collectives, card)
    run("mpi_coll", phase_mpi_coll, card, mesh)
    import torch.distributed as dist

    dist.destroy_process_group()
    check(all(v > 0 for v in rma_launches.values()),
          f"a one-sided kernel never ran on the rma_ranks path: "
          f"{rma_launches}")
    src = "ompi_tpu_torch/ops/csrc/"
    kernels = [
        {"name": "flash_fwd", "route": "cuda", "source": src + "flash_fwd.cu",
         "replaces": "ompi_tpu/ops/flash_attention.py:61 (_fwd_kernel)",
         "launches": decode_launches + train["flash_fwd"]
         + ring["flash_fwd"] + moe_decode + moe_train["flash_fwd"]
         + ckpt["flash_fwd"] + bench["flash_fwd"],
         "launches_by_path": {"decode": decode_launches,
                              "train": train["flash_fwd"],
                              "ring": ring["flash_fwd"],
                              "moe_decode": moe_decode,
                              "moe_train": moe_train["flash_fwd"],
                              "ckpt": ckpt["flash_fwd"],
                              "bench": bench["flash_fwd"]},
         **fwd, "ok": True},
    ]
    for part, line in (("dq", 173), ("dkv", 215)):
        key = f"flash_bwd_{part}"
        kernels.append({
            "name": key, "route": "cuda", "source": src + "flash_bwd.cu",
            "replaces": f"ompi_tpu/ops/flash_attention.py:{line} "
                        f"(_bwd_{part}_kernel)",
            "launches": train[key] + ring[key] + moe_train[key]
            + ckpt[key] + bench[key],
            "launches_by_path": {"train": train[key], "ring": ring[key],
                                 "moe_train": moe_train[key],
                                 "ckpt": ckpt[key], "bench": bench[key]},
            **bwd[part], "ok": True})
    for kind, line in (("put", 55), ("get", 120), ("bcast", 178)):
        by_path = {"rma_ranks": rma_launches[kind],
                   "bench": bench.get(kind, 0)}
        kernels.append({
            "name": f"remote_dma_{kind}", "route": "cuda",
            "source": src + "remote_dma.cu",
            "replaces": f"ompi_tpu/ops/remote_dma.py:{line} (_{kind}_kernel)",
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            **rma[kind], "ok": True})
    print(json.dumps({"kernels": kernels}), flush=True)
    emit("done", seconds=time.perf_counter() - t_start, phase_seconds=secs,
         card=card, bytecode_cache=pycache)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
