"""Drive the PyTorch/CUDA port of the SNN simulator on one NVIDIA card.

    python3 chip_smoke.py

Phases (each raises, and the script exits non-zero, on any failure):

1. Build ``src/repro_torch/kernels/csrc/*.cu`` for sm_90a (one nvcc per
   source, all at once) and print the compile times and ptxas reports,
   with ``plastic_drive_kernel``'s on a line of its own, and the loaded
   kernel's registers and local memory as the CUDA runtime reports them
   (built now or cached, it must use no stack frame and spill nothing).
2. Hold each kernel against its plain PyTorch version on the card at the
   shapes the Synfire4 paths give it, bit for bit where the arithmetic is
   exact and at a stated tolerance for random weights, and time kernel,
   plain version and (where one exists) a single PyTorch library call
   with CUDA events (per call, host enqueue included), and the kernel
   alone on the device with ``torch.profiler`` (a library call's kernels
   too). ``syn_matmul`` goes through ``ops.syn_matmul`` and the engine's
   per-run launcher ``ops.MatmulRun``; ``syn_gather`` through
   ``ops.syn_gather`` per compiled table, on bad indices (the reference's
   ``jnp.take`` contract) and at spike rows of 20,000 and 70,000, and
   through the engine's per-run launcher ``ops.GatherRun`` (one launch
   over a tick's 13 buckets) on the compiled Synfire4 and x10 tables, bit
   for bit, on random weights at 1e-5, staged against unstaged, beside
   ``embedding_bag``. ``izh4_update`` through ``ops.izh4_update`` and
   through the engine's per-run neuron-phase launcher ``ops.NeuronRun``
   (one launch per tick: ring slot, IZH4, generator merge, refractory
   countdown, raster, record and count writes), held bit for bit against
   its plain version over twelve chained ticks on Synfire4 fp16 and fp32
   with and without an external current and records (x100 in phase 4).
   ``fused_tick`` is held on states taken from 50-tick runs of every
   Synfire path, twelve chained ticks each, and each path's grid,
   grid-barrier cost and tick on the grid against one CTA are measured,
   then on bad input: CSR indices of -1 and -(N + 1) (the reference's
   ``jnp.take`` contract) and an infinite weight on a silent pre
   (recorded: the kernel skips silent pres); ``stdp_update`` and
   ``stdp_gather`` bit for bit on random weights, traces and masks at the
   plastic chain's shapes (Synfire4 packed [200, 200] and an odd shape;
   the compiled Synfire4 and x10 fan-in tables with int16 and int32
   indices), ``stdp_gather`` on the reference's bad indices, and the
   engine's per-run launchers ``ops.StdpGatherRun`` (one launch per tick
   over every CSR pair-STDP projection, trace steps folded in) against
   the per-call path on plastic Synfire4 and x10 fp16/fp32 and on two
   projections with bad indices, and ``ops.StdpUpdateRun`` (the same for
   every dense-stored one, weights on zero-ended buffers) against its
   plain version tick by tick on the plastic Synfire4 packed chain
   fp16/fp32 and on a plan mixing [37, 113] f32 with [200, 200] fp16;
   a NaN weight through ``stdp_update`` and ``StdpUpdateRun`` (NaN inside
   the mask, +0.0 outside, as the plain version); the port's own
   ``plastic_drive`` (``ops.DriveRun``: every plastic and STP projection's
   fan-in drive in one launch, rows summed in XLA CPU's order) bit for bit
   against its plain version on random off-grid weights on the plastic
   Synfire4 chain fp16/fp32 x packed/sparse, plastic x10 sparse and an STP
   net, and timed at the plastic Synfire4 fp16 sparse and packed ticks and
   the plastic x10 fp16 sparse tick (8,000 rows), beside ``embedding_bag``
   with ``per_sample_weights`` where the rows are CSR-stored and
   ``torch.bmm`` over the masked dense images where they are dense.
3. Run Synfire4 for 1,000 ticks on the card in fp16/fp32 x packed/sparse
   through ``build_synfire`` and ``run``, on the default backend and on
   ``backend="fused"``, with the launch counters reset just before each
   run; check the paper's spike statistics, the launch counts, and that
   every card raster equals the port's CPU raster for the same generator
   uniforms.
4. Synfire4-mini fp16 packed for 5,000 ticks on both backends, on the
   default generator stream (the reference's threefry draws, so the card
   raster equals the CPU raster) and with injected uniforms (the wave dies
   out in every run), and Synfire4x10 sparse fp16 for 1,000 ticks on both
   backends (raster against the CPU again); launch counts checked. Then
   Synfire4x100 (N = 120,000) sparse fp16 for 1,000 ticks on both
   backends (built once: the default net is the fused compile without its
   fused plan), whose rasters must be equal bit for bit (two independent
   kernel paths), at 17-29 Hz, with peak device memory, ``ops.GatherRun``
   against its plain version on the x100 tables (and staged against
   unstaged on its longest pre row alone), ``ops.NeuronRun`` against its
   plain version at N = 120,000, and fused_tick against its plain version
   on a x100 state. The default-backend paths launch ``izh4_update`` once
   per tick, the sparse ones ``syn_gather`` once. The x100 default net
   then runs the same uniforms under ``record="monitors"`` (phase 9's
   x100 case, on the net built here): its group rates equal the raster
   run's, and its peak device memory is printed beside the raster run's.
5. Plastic Synfire4 (``CHAIN_STDP`` on the exc->exc chain) for 1,000
   ticks in fp16/fp32 x packed/sparse: card raster and final plastic
   weights equal the CPU port's, packed and sparse weights equal at the
   twin cells, each tick launches ``stdp_update`` (packed) or
   ``stdp_gather`` (sparse) once for the four chain projections; the same
   with homeostasis every 100 ticks (fp16 sparse and packed); plastic Synfire4x10 fp16
   sparse inside the 8.477 MB ledger (card equals CPU); and plastic nets
   on ``backend="fused"``, which launch no ``fused_tick`` and give the
   default backend's raster and weights.
5b. Conductance-based (COBA) synapses: ``ops.NeuronRun`` in COBA mode
   (both ring channels read and zeroed, the four conductances decayed,
   delivered and stored, the current from them) against its plain
   version, fp16 and f32, on random conductances, ring and external
   current, bit for bit; ``ops.GatherRun`` over two channels (rows keyed
   by (delay, channel), ``|drive|`` per bucket) against its plain version
   on a plan where an excitatory and an inhibitory bucket share a delay
   and posts and two excitatory buckets share entries, bit for bit; both
   timed beside the CUBA mode (rows ``izh4_update.coba`` and
   ``syn_gather.coba``). Then Synfire4's Table II network compiled with
   ``conductances=COBAConfig()`` for 1,000 ticks, fp16/fp32 x
   packed/sparse: card raster and final v, u, refrac, ring and
   conductances equal the CPU port's; one ``izh4_update`` per tick and 8
   ``syn_matmul`` (packed) or one ``syn_gather`` (sparse); us/tick and
   device events per tick (beside the CUBA sparse tick's); the same nets
   on ``backend="fused"`` launch no ``fused_tick`` and give the same
   raster and state. COBA Synfire4x100 fp16 sparse (N = 120,000) through
   the launcher against the per-op COBA phase on the card (raster and
   state equal), with us/tick and peak device memory; plastic COBA
   Synfire4 fp16 packed and sparse (card raster, chain weights and traces
   equal the CPU port's, packed weights equal sparse ones).
5c. ``run``'s serving arguments on Synfire4 fp16 sparse: ``gen_base`` (one
   run(1000) equals four run(250) on the card, and the CPU port),
   ``gen_chunk=100`` (card equals CPU, also with homeostasis every 100
   ticks), ``active=False`` for 200 ticks (no generator spike, homeostasis
   holds the weights), and the ``propagation="loop"`` oracle, fp16 and
   fp32, whose raster equals packed's on the card.
8. Lanes (run before phase 6, in a process of its own: late in a long
   process ``torch.profiler`` stops recording kernels): (a) ``ops.NeuronRun``, ``ops.GatherRun``
   and ``ops.MatmulRun`` over 64 lanes on Synfire4 fp16 and fp32, packed
   and sparse, with the lanes' ring slots spread over all L slots and a
   third of the lanes inactive: bit for bit their plain lane versions over
   12 chained ticks (``GatherRun`` and ``MatmulRun`` with shared and
   per-lane Synfire-valued weights) and the one-lane launcher on every
   lane on random weights; timed per call and on the device beside 64
   one-lane calls, the plain version and the library call (B2
   ``embedding_bag`` over the same rows, sums only; B3 ``torch.matmul``
   (shared, M = 64) and ``torch.bmm`` (per lane)), with byte bounds; the
   per-lane cases rotate through copies of their tables or images that
   together hold three times the L2, so that each call reads them from
   device memory (their L2-warm times beside).
   (b) ``run_batch(1000, 64)`` on Synfire4 fp16 packed and sparse
   (``budget=None``): one ``izh4_update`` per tick for all lanes and 8
   ``syn_matmul`` or one ``syn_gather``; 8 lanes, the first and last among
   them, equal solo card runs in raster and state; every lane's spikes in
   20,000-33,000; µs/tick, lane-ticks per second, device events per tick
   and peak device memory. (c) ``LaneScheduler(capacity=64,
   record="none")`` on Synfire4 fp16 sparse: 48 tenants admitted in three
   waves, 10 chunks of 100 ticks, 4 evicted to solo sessions, 4 exported
   to a second scheduler and 2 moved there through ``save_lane``/
   ``restore_lane``; every moved tenant and 8 more equal solo sessions;
   µs per chunk of each scheduler against ``run_batch(100, 64)`` timed
   beside them, and the ledger's serve bytes. (d) Synfire4-mini fp16 at
   512 lanes, one 100-tick chunk. (e) plastic Synfire4-mini at 8 lanes in
   a scheduler, batched (one ``izh4_update``, ``stdp_update`` and
   ``plastic_drive`` per tick for all lanes), each lane equal to its solo
   session, beside one solo session's chunk. (f) B4 (``FusedTickRun``),
   B5 (``StdpGatherRun``), B6 (``StdpUpdateRun``) and the drive
   (``DriveRun``) over 64 lanes of Synfire4 fp16 (the plastic chain for
   B5, B6 and the drive; B4 on shared and per-lane tables), a third of the
   lanes silent: bit for bit their plain lane versions and every lane its
   one-lane launch, timed per call and on the device beside 64 one-lane
   calls, the plain version, a byte bound and, for the drive,
   ``embedding_bag``. (g) plastic ``run_batch(1000, 64)`` fp16, packed
   with homeostasis every 100 ticks and sparse: one launch per kernel per
   tick for every lane; 8 lanes, the first and last among them, equal
   solo card runs in raster, weights, traces, rates and state; µs/tick,
   lane-ticks per second against the solo run's ticks per second, device
   events per tick and peak memory. (h) fused ``run_batch(1000, 64)``
   packed and sparse: one ``fused_tick`` launch per tick and nothing else,
   the same lanes equal solo fused runs.
9. In-run monitors (after phase 8, in a process of its own too:
   ``chip_smoke.py --monitors-json PATH``): (a) Synfire4 fp16/fp32 x
   packed/sparse x default/fused for 1,000 ticks of ``record="both"``:
   the launch counts of an unmonitored run, card telemetry equal to the
   CPU port's bit for bit, the raster equal to a ``"raster"`` run's, the
   SpikeCount totals equal to the raster's group sums; (b) device events
   per tick in the tick loop with the default monitors equal to
   ``record="none"``'s (1 on the fused tick), host us/tick of both in
   interleaved turns, and ``izh4_update`` and ``fused_tick`` with the
   monitor slots bit for bit against their plain versions at one lane
   and 64, timed on the device with and without the slots; (c)
   ``run_batch(1000, 64, record="monitors")`` fp16 sparse, packed and
   fused (lanes equal to solo runs), and a ``LaneScheduler(64)`` under its
   default ``record="monitors"`` whose tenants' flushes sum to their
   uninterrupted sessions' through evicts and ``save_lane`` moves; (d) the
   paper's fp16 vs fp32 accuracy (at least 0.97), real-time factors of
   Synfire4 and the mini on both backends and the energy model's M33 and
   Pi Zero 2 W rows from the card's telemetry.
10. Observability (after phase 9, in a process of its own too:
   ``chip_smoke.py --obs-json PATH``): (a) Synfire4 with the default
   watches (NonFinite, RateBand, Silent), fp16/fp32 x packed/sparse x
   default/fused, 1,000 ticks of ``record="both"``: raster, telemetry,
   final state and launch counts equal to the same net without watches,
   the watch carry equal to the CPU port's bit for bit, and device events
   per tick in the tick loop equal to the unwatched run's; (b)
   ``izh4_update`` (fp16 and fp32, and fp16 with one Euler substep) and
   ``fused_tick`` with the watch slots bit for bit against their plain
   versions at one lane and 64, with a NaN membrane, one stored as inf, a
   lane that never spikes and (one substep) a membrane whose f32 value
   fp16 stores as -inf, timed on the device with and without the slots;
   (c) plastic Synfire4 fp16 sparse with ``NonFinite(weight_stride=100)``
   and ``WeightDrift()``: the carry equal to the CPU port's (the norms at
   rtol 1e-6) and the device events the strided checks add per 100
   ticks; (d) a ``LaneScheduler(64)`` with ``flight_window=4`` and 16
   tenants beside an unpoisoned twin: one tenant's membrane NaN'd, found by
   ``check_watches`` after one chunk, the other lanes equal to the twin's,
   quarantined, dumped, restored and replayed bit for bit from its first
   flight snapshot; (e) obs on and off bit for bit, host us/tick of both in
   turns, the compile and cache-hit counts of a first and a second
   scheduler step (printed), the Prometheus text's size and
   ``health_snapshot``'s status (the mini pass on the M33, Synfire4 fail).
11. Partitioning (after phase 10, in a process of its own too:
   ``chip_smoke.py --partition-json PATH``): (a) Synfire4 fp32 packed,
   fp16 auto, fp32 packed on ``backend="fused"``, plastic fp32 sparse and
   plastic fp16 packed, each unpartitioned and cut at ``n_cores=2`` and at
   a byte budget (300,000 B static, 1,000,000 B plastic), sequential
   lowering, 500 ticks: raster, neuron state, ring, weights and traces
   equal to the unpartitioned card run's and the CPU port's partitioned
   run's bit for bit, launches per tick as the plan says, device events
   per tick; (b) every core's launchers (``NeuronRun``, ``GatherRun``,
   ``MatmulRun`` and, on the plastic owner core, ``DriveRun``,
   ``StdpGatherRun``/``StdpUpdateRun``) against their plain versions over
   12 chained ticks, the 50-post core of the plastic cut among them; (c)
   Synfire4x100 fp16 sparse under ``PartitionSpec()`` (the MCU budget per
   core), 200 ticks: raster and state equal to the unpartitioned x100
   card run's, every core's ledger within 8.477 MB, ``health_snapshot``'s
   per-core checks passing; cores, largest core, exchange bytes per tick,
   us/tick of both, device events and launches per tick, peak memory; (d)
   the mesh lowering at 4 cores on ``core_mesh(devices=[card] * 4)`` and
   on ``core_mesh()`` (every visible card), fp32 sparse and fp16 packed,
   500 ticks, equal to the unpartitioned run, us/tick beside the
   sequential lowering; (e) ``LaneScheduler(mesh=lane_mesh(devices=[card]
   * 4))``: 8 lanes of the plastic mini at 60 Hz, two 50-tick chunks, and
   64 lanes of Synfire4 fp16 sparse, 10 chunks of 100 ticks, states and
   flushes equal to the unsharded scheduler's; (f) ``ShardedSNN`` (1,024
   neurons, fan-in 32) at mesh sizes 1 and 4, 100 ticks, equal to the CPU
   port's.
12. Precision policies (after phase 11, in a process of its own too:
   ``chip_smoke.py --precision-json PATH``): (a) the bf16 entries of B1
   (``NeuronRun`` over 64 lanes, CUBA and COBA, one lane COBA with
   records, the monitor and watch slots), B4 (``FusedTickRun`` over 64
   lanes, packed and sparse, with the monitor and watch slots), B5
   (``StdpGatherRun``), B6 (``StdpUpdateRun``) and the drive (``DriveRun``
   over 64 lanes, and on an STP net) bit for bit against their plain
   versions, each timed per call and on the device beside its fp16 entry;
   (b) bf16 Synfire4 packed and sparse on both backends, 1,000 ticks:
   raster and state equal to the CPU port's, 25,779 spikes (the
   reference's), SpikeCount accuracy of fp16 and bf16 against fp32
   required >= 0.97, the bf16 ledger equal to fp16's, us/tick; (c)
   plastic bf16 packed and sparse and COBA bf16 sparse equal to the CPU
   port's; (d) bf16 ``run_batch(1000, 64)`` sparse with every lane equal
   to its solo run, a ``LaneScheduler(64)`` chunk with the default
   monitors and watches, a ``save_lane``/``restore_lane`` round trip; (e)
   Synfire4 fp32 on int8-round-tripped weights, packed on both backends,
   accuracy against fp32 required >= 0.97, the card raster against the CPU
   port's; (f) stochastic rounding (``fp16_sr``, bf16) of a card tensor
   equal to the CPU port's; (g) smollm-360m at full width cut to 4 layers
   served under fp16, bf16 and fp16_opt, and at 2 layers the card against
   the CPU port.
   The bf16 entries join the kernel rows as ``<kernel>[bf16]``, their
   launches counted on (b)-(d).
13. Training (after phase 12, in a process of its own too: ``chip_smoke.py
   --train-json PATH``): (a) the attention backward ``flash_attn_bwd`` and
   B7's forward with the rows' log-sum-exp against their plain versions
   (each output within ``BWD_TOL`` of its scale, two backward calls bit
   for bit) at smollm-360m's training shape, the reduced shape, 5 rows per
   KV head, a window, invalid slots and rows with no key, head dims 128
   and 160 (GQA groups 5 and 4), Sk = 1,536 and head dim 20 (4-byte
   copies, a group of 7, Sk 100), each timed beside its plain version and
   the backward of ``scaled_dot_product_attention`` (an explicit boolean
   mask where the mask is not the index-causal one), its device time split
   by sub-kernel (delta, dK/dV, the reductions, dQ), SDPA's kernels named;
   (b) smollm-360m at full width trained through ``launch.train.train``
   for 10 steps of 8 x 512 ``TokenStream`` tokens under fp16 (the main
   path: finite losses, no skipped step, exactly 64 ``flash_attention``
   and 32 ``flash_attention_bwd`` launches a step), ms/step, tokens/s and
   peak device memory; (c) the card against the CPU port at full width cut
   to 2 layers, fp32 and fp16: one step's loss, grad norm and new masters,
   three steps' losses; (d) the reduced model learning over 20 steps, 4
   straight steps equal to 2 + save/restore + 2 bit for bit, a NaN step
   skipped; (e) bf16 and fp16_opt at full width cut to 8 layers for 3
   steps.
14. The other five LM families (in a process of its own, started before
   the build: its CPU half (each arch drawn once as a train state on the
   CPU, the CPU port's logits and, for three archs, a train step) runs on
   6 threads beside the build, and phase 2 starts once it is done; its
   card half runs after phase 6; alone: ``chip_smoke.py --archs-json
   PATH``): (a) B7 and the attention backward against their plain
   versions at the shapes (b) and (e) give them: recurrentgemma's D 256
   with 10 query heads on 1 KV head, prefill under its window of 2,048
   over 2,100 keys and decode on a wrapped 2,048-slot fp16 ring whose slot
   positions are out of order, its training shape with and without the
   window binding (2,560 keys); qwen2-vl's D 128 GQA 6:1 with M-RoPE's
   repeated t positions (256 patches at t = 0) in prefill, decode and
   training; qwen2-moe's D 128 MHA 16:16, musicgen's D 64 MHA 32:32 and
   granite's D 64 GQA 2:1 in prefill, decode and training; each timed
   beside its plain version and SDPA (the backward as in 13a; rows
   ``flash_attention[archs]`` and
   ``flash_attention_bwd[archs]``); then for granite-moe-1b-a400m,
   qwen2-moe-a2.7b, falcon-mamba-7b, recurrentgemma-2b, musicgen-large
   and qwen2-vl-2b at full width cut to 2 layers (the hybrid 3: one
   period): (b) served
   through ``launch.serve.serve`` (the VLM through the step functions) at
   batch 2 x 128 + 8 tokens (the hybrid one 2,100-token prompt into a
   2,048-slot ring), the main path, with exactly one B7 launch per
   attention layer and step (none for falcon-mamba); (c) the card against
   the CPU port, fp16, prefill and 2 decode steps on the CPU's tokens,
   MoE routes compared first (a row whose routes flip is counted with its
   top-k margin and not gated); (d) prefill against token-by-token decode;
   (e) one timed train step (after a warm-up step) at 4 x 512 (the hybrid
   1 x 2,560: its window binds; qwen2-moe on its first layer), peak
   memory, two B7 forwards and one backward per attention layer, the main
   path too; (f) one train step on the card against the CPU port at full
   width for granite-moe, falcon-mamba and recurrentgemma: loss, grad
   norm, each leaf's first moment and the new masters.
15. The LM mesh (after phase 14's card half, in a process of its own:
   ``chip_smoke.py --mesh-json PATH``): (a) smollm-360m fp16 at full width
   trained through ``build_task``, which splits it over the ``model`` axis
   (the Megatron lowering: heads, d_ff and vocabulary over the model
   ranks, the sequence-sharded residual stream), on a 4x2 mesh of ``[card]
   * 8`` (2 model ranks on 5 KV groups: 3 + 2), 3 steps of 8 x 512
   ``TokenStream`` tokens (the main path: exactly 2 B7 launches and one
   ``flash_attn_bwd`` per layer and model rank with heads a step), then
   ``ckpt.save``, ``restore`` and ``reshard`` onto a 1x8 mesh of ``[card]
   * 8`` (8 model ranks on 15 query heads: KV heads shared) for 3 steps and
   onto a 2x2 mesh of ``[card] * 4`` for 2; every step held against the
   single-device step on the card from the same state and batch (loss,
   grad norm, first moments, new masters within 2 lr_t), its collective
   bytes per device by kind and ms printed beside the single-device step's
   ms; (b) granite-moe-1b-a400m fp16 at full width on 2 layers split
   EP on 2x2 and TP on 1x3, falcon-mamba-7b (2 layers) and
   recurrentgemma-2b (3) on 2x2, one step each from a state drawn on the
   card, held the same way (the main path too), then the split prefill of
   the last two; (c) smollm-360m served on the 2x2 mesh through
   ``build_task`` (the split prefill cell, 2 x 128 prompt, then 8 split
   decode steps on its cache, their B7 launches counted) under both KV
   layouts against single-device serving; (f) split decode at full width
   (``MESH_DECODE_RUNS``: smollm-360m on 1x8, qwen2.5-14b's uneven head
   runs on 1x9, granite-moe EP on 2x2 and TP on 1x3, falcon-mamba and
   recurrentgemma's 2,048-slot ring on 2x2),
   4 steps each against single-device decode from the same cache, B7
   launches per step, ms beside the single-device step's, collective bytes
   by kind and each rank's B7 path, then B7 at the ranks' decode shapes
   against its plain version and SDPA; (d) ``psum_compressed`` over
   ``[card] * 4``; (e) the meta dry-runs of smollm train_4k and decode_32k
   on 16x16 (CPU processes beside the build), their per-device argument
   bytes held against the plan's.
6. LM serving on the dense decoder (``repro_torch.launch.serve``; after
   phase 12, in a process of its own: ``chip_smoke.py --lm-json PATH``): (a) the
   attention kernel ``flash_attention`` against its plain version on the
   card, at rtol = atol = 1e-5, at smollm-360m's prefill and decode shapes,
   decode at caches of 1,100 to 32,768 slots (split-K), a local window,
   the Pallas signature, head dims 16/64/128/160, GQA groups 3 and 4 and
   rows with no allowed key (the reference's sum of v over Sk + pad),
   each timed beside its plain version and
   ``scaled_dot_product_attention`` (per call and on the device), decode
   also with L2 flushed before each launch; (b) smollm-360m at
   full width (32 layers, random weights from a seed) serving batch 4,
   512-token prompts, 32 generated tokens, fp16, with exactly one
   attention launch per layer per prefill and decode step; (c) the card
   against the CPU port at full width cut to 2 layers, same weights, fp32
   and fp16 policies: logits and greedy tokens; (d) prefill against
   token-by-token decode at full depth on the card; (e) five decode
   steps under ``torch.profiler``, with the attention kernel's time per
   launch inside the step.
7. (A process of its own too: ``chip_smoke.py --profile-json PATH``.)
   Profile 100 Synfire4 fp16 ticks per propagation mode and backend, and
   of the plastic default-backend tick, with ``torch.profiler``: device
   busy time per tick, the device's idle share, device events per tick
   and device time by kernel name; and the packed default tick's host
   time through the per-run ``syn_matmul`` launcher, and the sparse
   default tick's through the per-run ``syn_gather`` launcher, each
   against its per-call path, in turns; and, in turns with the same raster
   (and weights), the static fp16 sparse and packed ticks with and without
   ``ops.NeuronRun``, the plastic fp16 sparse tick with and without
   ``ops.StdpGatherRun`` and the plastic fp16 packed tick with and without
   ``ops.StdpUpdateRun``: host us/tick and device events per tick.

The CPU work of later phases runs beside the build (1): phase 14's CPU
half, the CPU port's references of phases 3-5c, 9, 10 and 12
(``REF_PROCS`` processes ``chip_smoke.py --cpu-refs DIR I N`` on one torch
thread each, read back by name through ``cpu_ref``; a phase run alone
computes them itself) and phase 15's meta dry-runs. No timed phase starts
before all of them end; the wait is logged as ``[refs] waited N s``.

Each phase's end is logged as ``[clock] <phase> done at N s``. The last
lines are a JSON object of per-kernel numbers, a JSON object of per-path
numbers, the card's name and power limit from nvidia-smi, and ``{"ok":
true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import copy
import itertools
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from types import SimpleNamespace

import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
FP32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
TICKS = 1000


def log(*args) -> None:
    print(*args, flush=True)


def require(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def cuda_ms(fn, reps: int = 200, warmup: int = 20) -> float:
    """Mean milliseconds per call over ``reps`` back-to-back calls, timed
    with CUDA events after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


PROFILE_TRIES = 8


def _cuda_events(fn, reps: int, activities=None) -> list:
    """The device events of ``reps`` calls of ``fn`` under ``torch.profiler``
    (after one warm call)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=activities or [ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return [e for e in prof.events() if e.device_type == DeviceType.CUDA]


def device_ms(fn, name_part: str, reps: int = 100) -> float:
    """Mean device time (ms) of one launch of the kernel whose name
    contains ``name_part`` (one per call of ``fn``), from a
    ``torch.profiler`` trace of ``reps`` calls: the kernel alone, without
    the host's enqueue cost. Late in a long process the profiler may drop
    kernel records (it kept 44 of 50 100-us launches once, and none of 100
    2-us ones another time, while a fresh process on the same card kept
    every one; three traces in a row have held none or one): the trace is
    taken again, up to PROFILE_TRIES times, until it holds at least half
    of the launches, and the mean is over those."""
    for attempt in range(PROFILE_TRIES):
        events = _cuda_events(fn, reps)
        spans = [e.time_range.elapsed_us() for e in events if name_part in e.name]
        if reps // 2 <= len(spans) <= reps:
            break
        log(f"[profile] {name_part}: trace {attempt + 1} held {len(spans)} of {reps} "
            "launches; tracing again")
    require(reps // 2 <= len(spans) <= reps, f"profiler saw {len(spans)} launches of "
            f"{name_part!r} in {reps} calls; device events by name: "
            f"{sorted({e.name[:80] for e in events})}")
    if len(spans) < reps:
        log(f"[profile] {name_part}: the profiler recorded {len(spans)} of {reps} launches")
    return sum(spans) / len(spans) / 1e3


def device_total_ms(fn, reps: int = 100) -> float:
    """Mean device time (ms) of all kernels one call of ``fn`` launches,
    from a ``torch.profiler`` trace of ``reps`` calls: a library call's
    kernels, whatever their names (traced again as :func:`device_ms` is
    when records are missing; the fullest trace counts, since a later one
    may hold none at all)."""
    spans: list = []
    for attempt in range(PROFILE_TRIES):
        trace = [e.time_range.elapsed_us() for e in _cuda_events(fn, reps)]
        if len(trace) > len(spans):
            spans = trace
        if len(spans) >= reps:
            break
        log(f"[profile] all kernels: trace {attempt + 1} held {len(trace)} events in "
            f"{reps} calls; tracing again")
    require(len(spans) >= reps // 2, f"profiler saw {len(spans)} kernels in {reps} calls")
    return sum(spans) / reps / 1e3


def bound(nbytes: int, ops: int) -> tuple[float, str]:
    """Least time for the work: bytes over the memory rate or float32
    operations over the peak rate, whichever is larger (ms)."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max()) if a.numel() else 0.0


def fused_bound(payload, spikes: torch.Tensor, n: int, state_bytes: int) -> tuple[float, str]:
    """The least work of one fused tick on this tick's spikes: v and u read
    and written, gen_row, is_gen and the spike row, a-d, i_syn, the ring
    rows the tick touches (its slot and one per delay, each read and
    written), the descriptors, the dense rows of the pres that spiked, the
    CSR index tables and the CSR weights of spiking pres; one f32 add per
    weight added, about 31 operations per neuron for IZH4."""
    return bound(*_fused_work(payload, spikes, n, state_bytes))


def _fused_shared_bytes(payload, n: int) -> int:
    """What the lanes of a fused tick share, read once for all of them:
    a-d, is_gen, the descriptors and the CSR index tables."""
    return 17 * n + nbytes(payload.desc) + sum(nbytes(idx) for _, _, idx, _ in payload.csr)


def _fused_work(payload, spikes: torch.Tensor, n: int, state_bytes: int) -> tuple[int, int]:
    """:func:`fused_bound`'s bytes and operations."""
    sp = spikes.to(torch.int64).cpu()
    k = len(payload.delays)
    moved = (4 * n * state_bytes + 3 * n + 16 * n + 4 * n
             + 2 * (1 + k) * n * state_bytes + nbytes(payload.desc))
    adds = 0
    for ps, _, _, w in payload.dense:
        rows = int(sp[ps:ps + w.shape[0]].sum())
        moved += rows * w.shape[1] * 4
        adds += rows * w.shape[1]
    for _, _, idx, w in payload.csr:
        hits = int(sp[idx.long().cpu()].sum())
        moved += nbytes(idx) + hits * 4
        adds += hits
    return moved, adds + 31 * n


def phase_build() -> dict:
    from repro_torch.kernels import _build
    from repro_torch.kernels.plastic_drive import kernel_resources

    t0 = time.perf_counter()
    report = _build.build()
    wall = time.perf_counter() - t0
    for name, r in report.items():
        log(f"[build] {name}.cu: {r['seconds']:.2f} s")
        for line in r["log"].splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build]   {line.strip()}")
    log(f"[build] all kernels in {wall:.2f} s wall (parallel nvcc)")
    bwd = _build.ptxas_entries(report["flash_attn_bwd"]["log"])
    for name, line in bwd.items():
        log(f"[build] flash_attn_bwd {name}: {line}")
    drive = _build.ptxas_entries(report["plastic_drive"]["log"]).get("plastic_drive_kernel")
    log(f"[build] plastic_drive_kernel ptxas: {drive or 'not in the log (a cached build)'}")
    if drive is not None:
        require("0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads" in drive,
                f"plastic_drive_kernel uses local memory: {drive}")
    res = kernel_resources()  # the loaded library's, whether built now or cached
    log(f"[build] plastic_drive_kernel loaded: {res['registers']} registers, "
        f"{res['local_bytes']} bytes local memory a thread")
    require(res["local_bytes"] == 0,
            f"plastic_drive_kernel uses {res['local_bytes']} bytes of local memory a thread")
    return {"nvcc_wall_s": wall, "plastic_drive_ptxas": drive, "plastic_drive_resources": res,
            "flash_attn_bwd_ptxas": bwd,
            "nvcc_s": {k: v["seconds"] for k, v in report.items()}}


def _izh_inputs(n: int, dtype, dev, seed: int):
    g = torch.Generator(device="cpu").manual_seed(seed)
    v = (torch.rand(n, generator=g) * 115 - 80).to(dtype)
    u = (torch.rand(n, generator=g) * 10 - 15).to(dtype)
    i_syn = torch.rand(n, generator=g) * 25
    fs = torch.rand(n, generator=g) < 0.2  # fast-spiking share, as Synfire4's
    a = torch.where(fs, 0.1, 0.02)
    b = torch.full((n,), 0.2)
    c = torch.full((n,), -65.0)
    d = torch.where(fs, 2.0, 8.0)
    return [x.to(dev).contiguous() for x in (v, u, i_syn, a, b, c, d)]


NEURON_TICKS = 12  # chained ticks per NeuronRun case: ring slots wrap past L = 11


def _gen_cols(static, dev) -> torch.Tensor:
    """Each neuron's column in the run's ``[T, n_gen]`` generator spikes
    (the spans side by side), -1 for the other neurons."""
    cols = torch.full((static.n,), -1, dtype=torch.int64, device=dev)
    off = 0
    for g0, sz in static.gen_spans:
        cols[g0:g0 + sz] = torch.arange(off, off + sz, device=dev)
        off += sz
    return cols


def _random_cond(net, g, dev):
    """Four random conductances in [0, 3) in the net's storage dtype, or
    None for a current-based net."""
    if net.static.coba is None:
        return None
    dtype, n = net.state0.neurons.v.dtype, net.static.n
    return tuple((torch.rand(n, generator=g) * 3).to(dtype).to(dev) for _ in range(4))


def _hold_neuron_run(net, g, dev, i_ext: bool, records: bool, what: str) -> int:
    """``ops.NeuronRun`` (the run's neuron phase, one launch per tick) on the
    card against its plain version (``ref.neuron_run_ref`` on the card) on
    the same inputs: a random ring, v, u and refractory counts, random
    generator rows, on a COBA net random conductances, and, where asked,
    an external current and the raster, v, i_syn rows and homeostasis
    counts; v, u, refrac, the whole ring, the conductances and the f32
    spike row after every tick, the rows and counts at the end, bit for
    bit; the caller's state left as it was. Returns the neuron spikes seen
    (raises on none)."""
    from repro_torch.core import backend as be
    from repro_torch.core.neurons import NeuronModel, NeuronState
    from repro_torch.kernels import ops, ref

    static, params = net.static, net.params
    n, ticks, dtype = static.n, NEURON_TICKS, net.state0.neurons.v.dtype
    v = (torch.rand(n, generator=g) * 115 - 80).to(dtype).to(dev)
    u = (torch.rand(n, generator=g) * 10 - 15).to(dtype).to(dev)
    refrac = torch.randint(0, 3, (n,), generator=g).to(torch.int16).to(dev)
    ring = (torch.rand(tuple(net.state0.ring.shape), generator=g) * 12).to(dtype).to(dev)
    cond = _random_cond(net, g, dev)
    coba = None if cond is None else be.coba_coeffs(static)
    gen_spk = (torch.rand((ticks, static.n_gen), generator=g) < 0.3).to(dev)
    cur = (torch.rand((ticks, n), generator=g) * 8).to(dev) if i_ext else None
    neurons = NeuronState(v=v, u=u, refrac=refrac)
    saved = [x.clone() for x in (v, u, refrac)]

    def rows():
        return ({"raster": torch.zeros((ticks, n), dtype=torch.bool, device=dev),
                 "v_rows": torch.zeros((ticks, n), device=dev),
                 "i_rows": torch.zeros((ticks, n), device=dev),
                 "counts": torch.zeros(n, dtype=torch.int32, device=dev)} if records else {})

    k_rows, p_rows = rows(), rows()
    k_ring, p_ring = ring.clone(), ring.clone()
    run = be.assemble_neurons(static, params, neurons, k_ring, cond=cond, gen_spk=gen_spk,
                              i_ext=cur, **k_rows)
    require(run.launcher is not None, f"NeuronRun {what}: no launcher on the card")
    p = params.neuron
    is_gen = p.model == NeuronModel.GENERATOR
    cols = _gen_cols(static, dev)
    pv, pu, pr = v.clone(), u.clone(), refrac.clone()
    p_cond = None if cond is None else tuple(x.clone() for x in cond)
    saved += [] if cond is None else [x.clone() for x in cond]
    p_spikes = torch.zeros(n, device=dev)
    ops.reset_launches()
    spiked = 0
    for i in range(ticks):
        t = 100 + i
        run(i, t)
        ref.neuron_run_ref(pv, pu, pr, p_ring, t % static.ring_len, is_gen, p.a, p.b, p.c,
                           p.d, cols, p_spikes, gen_row=gen_spk[i],
                           i_ext_row=None if cur is None else cur[i],
                           raster_row=p_rows["raster"][i] if records else None,
                           v_row=p_rows["v_rows"][i] if records else None,
                           i_row=p_rows["i_rows"][i] if records else None,
                           counts=p_rows.get("counts"), cond=p_cond, coba=coba,
                           dt=static.dt, substeps=static.substeps)
        torch.cuda.synchronize()
        checks = [("v", run.v, pv), ("u", run.u, pu), ("refrac", run.refrac, pr),
                  ("ring", k_ring, p_ring), ("spikes", run.spikes, p_spikes)]
        if cond is not None:
            checks += [(f"g{k}", a, b) for k, (a, b) in enumerate(zip(run.cond, p_cond))]
        for name, got, want in checks:
            _require_bitwise(got, want, f"NeuronRun {what} tick {t} {name}")
        spiked += int(run.spikes[~is_gen].sum())
    for name in k_rows:
        _require_bitwise(k_rows[name], p_rows[name], f"NeuronRun {what} {name}")
    require(ops.LAUNCHES["izh4_update"] == ticks, f"NeuronRun {what}: "
            f"{ops.LAUNCHES['izh4_update']} launches in {ticks} ticks")
    require(all(torch.equal(a, b) for a, b in zip((v, u, refrac, *(cond or ())), saved)),
            f"NeuronRun {what}: the caller's state changed")
    require(spiked > 0, f"NeuronRun {what}: no neuron spiked")
    log(f"[kernels] NeuronRun {what} (N={n}, i_ext={i_ext}, records={records}): {ticks} "
        f"ticks bitwise against its plain version (v, u, refrac, ring, "
        + ("conductances, " if cond is not None else "") + "spike rows"
        + (", raster, v, i_syn rows, counts" if records else "") + f"), {spiked} spikes")
    return spiked


def _neuron_run_row(net, g, dev, what: str) -> dict:
    """The NeuronRun's numbers on ``net`` as the main path runs it (raster
    recorded, generator rows): per call (the ctypes call included) and
    alone on the device, the plain version on the card, and the bound: the
    ring slot read and zeroed (both channels on a COBA net), v, u and
    refrac read and written, a-d, is_gen, the generator column map and
    row, the f32 spike row and the raster row, on a COBA net the four
    conductances read and written; about 31 operations per neuron, 26 more
    for COBA."""
    from repro_torch.core import backend as be
    from repro_torch.core.neurons import NeuronModel
    from repro_torch.kernels import ref

    static, params = net.static, net.params
    n, rows_t, s = static.n, 230, net.state0.neurons.v.element_size()
    ring = net.state0.ring.clone()
    gen_spk = (torch.rand((rows_t, static.n_gen), generator=g) < 0.3).to(dev)
    raster = torch.zeros((rows_t, n), dtype=torch.bool, device=dev)
    cond = _random_cond(net, g, dev)
    coba = None if cond is None else be.coba_coeffs(static)
    run = be.assemble_neurons(static, params, net.state0.neurons, ring, cond=cond,
                              gen_spk=gen_spk, raster=raster)
    counter = iter(range(10**9))

    def tick():
        i = next(counter)
        run(i % rows_t, i)

    p = params.neuron
    is_gen = p.model == NeuronModel.GENERATOR
    cols = _gen_cols(static, dev)
    pv, pu, pr = (x.clone() for x in (run.v, run.u, run.refrac))
    sp = torch.zeros(n, device=dev)
    pc = None if cond is None else tuple(x.clone() for x in cond)
    plain = lambda: ref.neuron_run_ref(pv, pu, pr, ring, 0, is_gen, p.a, p.b, p.c, p.d,  # noqa: E731
                                       cols, sp, gen_row=gen_spk[0], raster_row=raster[0],
                                       cond=pc, coba=coba)
    channels = static.ring_channels
    moved = (2 * channels * n * s + 2 * 2 * n * s + 2 * 2 * n + 4 * 4 * n + n + 4 * n
             + static.n_gen + 4 * n + n + (0 if cond is None else 2 * 4 * n * s))
    b_ms, b_by = bound(moved, (31 if cond is None else 57) * n)
    return {"shape": f"{what} tick: N={n}, raster recorded, one launch"
                     + (", COBA" if cond is not None else ""),
            "ms": cuda_ms(tick), "device_ms": device_ms(tick, "izh4_run_kernel"),
            "plain_ms": cuda_ms(plain, reps=50, warmup=5), "bound_ms": b_ms,
            "bound_by": b_by, "bound_bytes": moved}


def _check_gather_run(dev, g, net, what: str, staged_fits: bool = True) -> dict:
    """``ops.GatherRun`` (the default backend's per-run gather launcher) on
    a compiled sparse net's tables: one launch per tick, bit for bit with
    its plain version on random spike rows and the compiled weights, and
    within rtol = atol = 1e-5 on random normal weights; timed per call (the
    launcher's ctypes call included), alone on the device, staged (the
    whole spike row in shared memory in every CTA, where it fits) against
    unstaged in the same run, the plain version, and ``embedding_bag`` over
    the same rows (their sums alone, without the per-entry adds). The
    bound reads every table entry, the spike row once and writes the rows
    once, with two operations per entry."""
    from repro_torch.core import backend as be
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import syn_gather as gsyn

    static, params = net.static, net.params
    packed = be.assemble_packed(static, net.state0.weights)
    run = be.assemble_gather(static, params, packed)
    require(len(run.starts) == 1 and len(run.plan.groups[0]) == 13,
            f"{what}: gather plan {run.plan.groups}")
    plain = [(k, posts.to(dev), gidx.to(dev), w) for k, posts, gidx, w in run.plan.plain[0]]
    want = torch.empty_like(run.rows)
    for _ in range(3):
        spikes = (torch.rand(static.n, generator=g) < 0.3).float().to(dev)
        ops.reset_launches()
        run(0, spikes)
        ref.gather_run_ref(spikes, want, plain, first=True)
        torch.cuda.synchronize()
        require(ops.LAUNCHES["syn_gather"] == 1 and torch.equal(run.rows, want),
                f"{what}: GatherRun differs from its plain version, max abs err "
                f"{max_err(run.rows, want)}")
    rand = [(k, posts, gidx, torch.randn(tuple(w.shape), generator=g).to(dev))
            for k, posts, gidx, w in plain]
    buckets = [gsyn.Bucket(run.delays[k], posts.cpu().numpy(),
                           (torch.arange(static.n).numpy(), gidx.int(), w))
               for k, posts, gidx, w in rand]
    rrun = ops.GatherRun(static.n, buckets, dev)
    rrun(0, spikes)
    rwant = torch.empty_like(run.rows)
    ref.gather_run_ref(spikes, rwant, rand, first=True)
    torch.cuda.synchronize()
    err = max_err(rrun.rows, rwant)
    require(torch.allclose(rrun.rows, rwant, rtol=1e-5, atol=1e-5),
            f"{what}: GatherRun on random weights, max abs err {err}")
    ptr = spikes.data_ptr()
    unstaged = lambda: run.launcher(0, ptr)  # noqa: E731
    staged_ms = None
    if staged_fits:
        staged = gsyn.GatherLauncher(run.plan, dev, staged=True)
        staged(0, ptr)
        torch.cuda.synchronize()
        require(torch.equal(staged.rows, want), f"{what}: staged GatherRun differs")
        staged_ms = device_ms(lambda: staged(0, ptr), "gather_kernel")
    plan = run.plan
    entries = int(plan.idx.numel())
    rows_i = [gidx.reshape(-1).long() for _, _, gidx, _ in plain]
    flat = torch.cat(rows_i)
    wflat = torch.cat([w.reshape(-1) for *_, w in plain]).float()
    offsets = torch.cat([torch.arange(0, gidx.numel(), gidx.shape[1], device=dev)
                         + sum(x.numel() for x in rows_i[:i])
                         for i, (_, _, gidx, _) in enumerate(plain)])
    bag = lambda: torch.nn.functional.embedding_bag(  # noqa: E731
        flat, spikes[:, None], offsets, per_sample_weights=wflat, mode="sum")
    b_ms, b_by = bound(nbytes(plan.idx, plan.w) + static.n * 4 + nbytes(run.rows),
                       2 * entries)
    out = {"shape": f"{what}: 13 CSR buckets, {entries} entries, N={static.n}, "
                    f"{str(plan.idx_dtype).removeprefix('torch.')}/"
                    f"{str(plan.w_dtype).removeprefix('torch.')}, one launch",
           "max_abs_err": err, "ms": cuda_ms(lambda: run(0, spikes)),
           "device_ms": device_ms(unstaged, "gather_kernel"), "staged_device_ms": staged_ms,
           "plain_ms": cuda_ms(lambda: ref.gather_run_ref(spikes, want, plain, first=True),
                               reps=20, warmup=3),
           "bound_ms": b_ms, "bound_by": b_by, "library_ms": cuda_ms(bag),
           "library_device_ms": device_total_ms(bag)}
    log(f"[kernels] GatherRun {what}: bitwise on 3 ticks, random weights within 1e-5 "
        f"(max abs err {err:.3g}); {out['ms'] * 1e3:.2f} us per call, "
        f"{out['device_ms'] * 1e3:.2f} us on the device"
        + ("" if staged_ms is None else f" ({staged_ms * 1e3:.2f} us staged)")
        + f", plain {out['plain_ms'] * 1e3:.2f} us, bound {b_ms * 1e3:.4f} us ({b_by}), "
        f"embedding_bag {out['library_ms'] * 1e3:.2f} us "
        f"({out['library_device_ms'] * 1e3:.2f} us on the device)")
    return out


def phase_kernels(dev) -> tuple[list[dict], dict]:
    from repro_torch.configs.synfire4 import (SYNFIRE4, SYNFIRE4_MINI, SYNFIRE4_X10,
                                              build_synfire)
    from repro_torch.core.backend import assemble_packed
    from repro_torch.kernels import ops, ref

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rows = []

    # izh4_update: bit for bit (pinned rounding on both sides).
    err = 0.0
    for n in (1200, 12000):
        for dtype in (torch.float16, torch.float32):
            args = _izh_inputs(n, dtype, dev, seed=n)
            got = ops.izh4_update(*args)
            want = ref.izh4_ref(*args)
            torch.cuda.synchronize()
            for g_, w_, what in zip(got, want, ("v", "u", "spiked")):
                require(g_.dtype == w_.dtype and torch.equal(g_, w_),
                        f"izh4_update {what} differs from its plain version "
                        f"(N={n}, {dtype}): max abs err {max_err(g_, w_)}")
            require(0 < int(got[2].sum()) < n, "izh4 test inputs never spiked")
            err = max(err, max_err(got[0], want[0]))
            log(f"[kernels] izh4_update N={n} {dtype}: bitwise equal")
    args = _izh_inputs(1200, torch.float16, dev, seed=1)
    single = {"ops_shape": "N=1200 fp16", "ops_ms": cuda_ms(lambda: ops.izh4_update(*args)),
              "ops_device_ms": device_ms(lambda: ops.izh4_update(*args), "izh4_kernel"),
              "ops_plain_ms": cuda_ms(lambda: ref.izh4_ref(*args))}
    g_nrn = torch.Generator(device="cpu").manual_seed(3)
    for policy in ("fp16", "fp32"):
        net = build_synfire(SYNFIRE4, policy=policy, propagation="sparse", device=dev)
        for i_ext, records in ((False, False), (True, True), (False, True)):
            _hold_neuron_run(net, g_nrn, dev, i_ext, records, f"SYNFIRE4 {policy}")
    rows.append({
        "name": "izh4_update", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/izh_update.cu",
        "replaces": "src/repro/kernels/izh_update.py:50", "max_abs_err": err,
        **_neuron_run_row(build_synfire(SYNFIRE4, policy="fp16", propagation="sparse",
                                        device=dev), g_nrn, dev, "Synfire4 fp16"),
        **single, "library_ms": None})

    # syn_matmul: exact on 0/1 spikes x Synfire4's weight table, through
    # ops.syn_matmul and the per-run launcher the engine uses
    # (ops.MatmulRun); stated tolerance (summation order only) on random
    # normal operands.
    g = torch.Generator(device="cpu").manual_seed(2)
    table = torch.tensor([0.0, 1.0, 3.5, -2.0])
    err = 0.0
    for m, k, n in ((1, 200, 250), (1, 50, 200), (64, 200, 250)):
        x = (torch.rand((m, k), generator=g) < 0.3).float().to(dev)
        w = table[torch.randint(0, 4, (k, n), generator=g)].to(dev)
        got, want = ops.syn_matmul(x, w), ref.syn_matmul_ref(x, w)
        torch.cuda.synchronize()
        require(torch.equal(got, want),
                f"syn_matmul [{m},{k}]x[{k},{n}] exact case: max abs err {max_err(got, want)}")
        if m == 1:
            got = ops.MatmulRun([w])(0, x[0])
            torch.cuda.synchronize()
            require(torch.equal(got, want[0]), f"syn_matmul launcher [1,{k}]x[{k},{n}] "
                    f"exact case: max abs err {max_err(got, want[0])}")
        for wdt in (torch.float32, torch.float16):
            xr = torch.randn((m, k), generator=g).to(dev)
            wr = torch.randn((k, n), generator=g).to(wdt).to(dev)
            got, want = ops.syn_matmul(xr, wr), ref.syn_matmul_ref(xr, wr)
            require(torch.allclose(got, want, rtol=1e-5, atol=1e-4),
                    f"syn_matmul [{m},{k}]x[{k},{n}] {wdt}: max abs err {max_err(got, want)}")
            err = max(err, max_err(got, want))
        log(f"[kernels] syn_matmul [{m},{k}]x[{k},{n}]: bitwise on spikes"
            + (" (ops.syn_matmul and the launcher)" if m == 1 else "")
            + ", random within rtol=1e-5 atol=1e-4")
    # The mini's packed images: its fp16 weights (4, 14, -6.66796875) are
    # multiples of 1/256, so every sum of them is exact in f32.
    mini = build_synfire(SYNFIRE4_MINI, policy="fp16", device=dev)
    images = assemble_packed(mini.static, mini.state0.weights)
    launcher = ops.MatmulRun(images)
    for i, w in enumerate(images):
        x = (torch.rand((1, w.shape[0]), generator=g) < 0.3).float().to(dev)
        got, want = ops.syn_matmul(x, w), ref.syn_matmul_ref(x, w)
        via_run = launcher(i, x[0])
        torch.cuda.synchronize()
        require(torch.equal(got, want) and torch.equal(via_run, want[0]),
                f"syn_matmul mini [1,{w.shape[0]}]x{list(w.shape)}: max abs err "
                f"{max_err(got, want)}, launcher {max_err(via_run, want[0])}")
    log(f"[kernels] syn_matmul Synfire4-mini packed images "
        f"{sorted({tuple(w.shape) for w in images})}: bitwise (both entries)")
    x = (torch.rand((1, 200), generator=g) < 0.3).float().to(dev)
    w = table[torch.randint(0, 4, (200, 250), generator=g)].to(dev)
    b_ms, b_by = bound(nbytes(x, w) + 250 * 4, 2 * 200 * 250)
    run = ops.MatmulRun([w])
    x0 = x[0]
    rows.append({
        "name": "syn_matmul", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/syn_matmul.cu",
        "replaces": "src/repro/kernels/syn_matmul.py:40",
        "shape": "[1,200]x[200,250] f32", "max_abs_err": err,
        "ms": cuda_ms(lambda: run(0, x0)),
        "ops_ms": cuda_ms(lambda: ops.syn_matmul(x, w)),
        "device_ms": device_ms(lambda: run(0, x0), "gemv_kernel"),
        "plain_ms": cuda_ms(lambda: ref.syn_matmul_ref(x, w)),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": cuda_ms(lambda: torch.matmul(x, w)),
        "library_device_ms": device_total_ms(lambda: torch.matmul(x, w))})

    # syn_gather: the compiled Synfire4 and x10 CSR tables, exact with their
    # weights, stated tolerance with random normal weights.
    err = 0.0
    timed = None
    for cfg in (SYNFIRE4, SYNFIRE4_X10):
        net = build_synfire(cfg, policy="fp16", propagation="sparse", budget=None,
                            monitor_ms_hint=0, device=dev)
        packed = assemble_packed(net.static, net.state0.weights)
        for bi, b in enumerate(net.static.buckets):
            idx = net.params.bucket_csr_idx[bi]
            spikes = (torch.rand(b.p, generator=g) < 0.3).float().to(dev)
            got, want = ops.syn_gather(spikes, idx, packed[bi]), ref.syn_gather_ref(
                spikes, idx, packed[bi])
            torch.cuda.synchronize()
            require(torch.equal(got, want),
                    f"syn_gather {cfg.name} bucket {bi}: max abs err {max_err(got, want)}")
            wr = torch.randn(tuple(idx.shape), generator=g).to(dev)
            got, want = ops.syn_gather(spikes, idx, wr), ref.syn_gather_ref(spikes, idx, wr)
            require(torch.allclose(got, want, rtol=1e-5, atol=1e-5),
                    f"syn_gather {cfg.name} bucket {bi} random: max abs err {max_err(got, want)}")
            err = max(err, max_err(got, want))
            if timed is None:
                timed = (spikes, idx, packed[bi])
        log(f"[kernels] syn_gather {cfg.name}: {len(net.static.buckets)} tables "
            f"(Q x F {sorted({tuple(t.shape) for t in net.params.bucket_csr_idx})}) "
            f"bitwise; random weights within rtol=1e-5 atol=1e-5")
    bad = torch.tensor([[0, 1], [2, 200], [-1, 0], [-201, 0]], dtype=torch.int16, device=dev)
    out = ops.syn_gather(torch.ones(200, device=dev), bad, torch.ones((4, 2), device=dev))
    want = ref.syn_gather_ref(torch.ones(200, device=dev), bad, torch.ones((4, 2), device=dev))
    require(out[0] == 2.0 and bool(out[1].isnan()) and out[2] == 2.0 and bool(out[3].isnan())
            and torch.equal(out.isnan(), want.isnan()) and torch.equal(out[[0, 2]], want[[0, 2]]),
            f"syn_gather: indices outside [0, P) gave {out.tolist()}, want [2, nan, 2, nan] "
            f"(the plain version {want.tolist()})")
    log("[kernels] syn_gather: an index in [-P, -1] counts from the row's end, any other "
        "outside [0, P) gives NaN, as the plain version (the reference's jnp.take)")
    for p in (20_000, 70_000):  # long rows, read through the read-only path
        q, f = 300, 97
        idx = torch.randint(0, p, (q, f), generator=g, dtype=torch.int32)
        wl = table[torch.randint(0, 4, (q, f), generator=g)]
        spikes = (torch.rand(p, generator=g) < 0.3).float()
        args = [spikes.to(dev), idx.to(dev), wl.to(dev)]
        got, want = ops.syn_gather(*args), ref.syn_gather_ref(*args)
        torch.cuda.synchronize()
        require(torch.equal(got, want), f"syn_gather P={p}: max abs err {max_err(got, want)}")
        idx[7, 3] = p
        got = ops.syn_gather(args[0], idx.to(dev), args[2])
        ok = torch.arange(q, device=dev) != 7
        require(bool(got[7].isnan()) and torch.equal(got[ok], want[ok]),
                f"syn_gather P={p}: an index outside [0, P) gave {float(got[7])}")
        log(f"[kernels] syn_gather P={p} Q={q} F={f}: bitwise, NaN for an index outside [0, P)")
    gather_rows = []
    for cfg in (SYNFIRE4, SYNFIRE4_X10):
        gather_rows.append(_check_gather_run(dev, g, build_synfire(
            cfg, policy="fp16", propagation="sparse", budget=None, monitor_ms_hint=0,
            device=dev), cfg.name))
    spikes, idx, w = timed
    q, f = idx.shape
    idx64 = idx.long()
    main = gather_rows[0]
    rows.append({
        "name": "syn_gather", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/syn_gather.cu",
        "replaces": "src/repro/kernels/syn_gather.py:41",
        "shape": main["shape"], "max_abs_err": max(err, *(r["max_abs_err"] for r in gather_rows)),
        **{k: main[k] for k in ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
                                "library_ms", "library_device_ms")},
        "staged_device_ms": main["staged_device_ms"],
        "ops_ms": cuda_ms(lambda: ops.syn_gather(spikes, idx, w)),
        "ops_device_ms": device_ms(lambda: ops.syn_gather(spikes, idx, w), "gather_kernel"),
        "ops_shape": f"Synfire4 bucket 0: P={spikes.shape[0]} Q={q} F={f} int16/f32",
        "ops_library_device_ms": device_total_ms(lambda: torch.nn.functional.embedding_bag(
            idx64, spikes[:, None], per_sample_weights=w, mode="sum")),
        "per_tick": gather_rows})
    fused_row, designs = _check_fused_tick(dev, g)
    fused_row["bad_input"] = _fused_bad_input(dev)
    rows.append(fused_row)
    rows += _check_stdp(dev, g)
    rows.append(_check_drive(dev, g))
    for r in rows:
        lib = "-" if r["library_ms"] is None else f"{r['library_ms'] * 1e3:.2f} us"
        if r.get("library_device_ms") is not None:
            lib += f" ({r['library_device_ms'] * 1e3:.2f} us on the device)"
        log(f"[kernels] {r['name']} ({r['shape']}): {r['ms'] * 1e3:.2f} us per call "
            f"({r['device_ms'] * 1e3:.2f} us on the device), plain "
            f"{r['plain_ms'] * 1e3:.2f} us, bound {r['bound_ms'] * 1e3:.4f} us "
            f"({r['bound_by']}), library {lib}")
    return rows, designs


FUSED_STATES = (  # (config name, policy, propagation, build keywords)
    ("SYNFIRE4", "fp16", "packed", {}), ("SYNFIRE4", "fp32", "packed", {}),
    ("SYNFIRE4", "fp16", "sparse", {}), ("SYNFIRE4", "fp32", "sparse", {}),
    ("SYNFIRE4_MINI", "fp16", "packed", {}),
    ("SYNFIRE4_X10", "fp16", "sparse", {"budget": None, "monitor_ms_hint": 0}),
)
TICK_OUTPUTS = ("v", "u", "spikes", "ring", "i_syn")
# Chained ticks per state: more than the longest delay (10), so the random
# generator rows' drive arrives and neurons spike within the check.
CHAINED = 12


def _fused_state(cfg_name, policy, propagation, dev, build_kw, ticks=50, net=None):
    """A fused net (built here unless ``net`` is given) and its state after
    ``ticks`` ticks on the card (the ring then holds currents and neurons
    spike), with the tick's operands."""
    from repro_torch.configs import synfire4
    from repro_torch.core.backend import assemble_fused
    from repro_torch.core.engine import run

    if net is None:
        net = synfire4.build_synfire(getattr(synfire4, cfg_name), policy=policy,
                                     propagation=propagation, device=dev,
                                     backend="fused", **build_kw)
    state, _ = run(net.static, net.params, net.state0, ticks)
    payload = assemble_fused(net.static, state.weights, net.params).kernel
    p = net.params.neuron
    args = [state.neurons.v, state.neurons.u, state.ring[:, :, 0].contiguous(),
            None, p.model == 0, p.a, p.b, p.c, p.d]
    return net, state, payload, args


def _fused_kernel_tick(args, t, payload, grid=None):
    """Tick ``t`` through the run wrapper on copies of ``args``: (v', u',
    spikes, ring', i_syn), the plain version's outputs."""
    from repro_torch.kernels import ops

    v, u, ring = (x.clone() for x in args[:3])
    rows = args[3][None].clone()
    i_rows = torch.empty((1, v.shape[0]), dtype=torch.float32, device=v.device)
    ops.FusedTickRun(payload, v, u, ring, *args[4:], rows, i_rows=i_rows,
                     grid=grid).tick(0, t)
    return v, u, rows[0], ring, i_rows[0]


def _fused_both(args, t, payload):
    from repro_torch.kernels import ref

    got = _fused_kernel_tick(args, t, payload)
    want = ref.fused_tick_ref(*args, t, dense=payload.dense, csr=payload.csr,
                              ring_len=args[2].shape[0])
    torch.cuda.synchronize()
    return got, want


def _hold_fused(net, state, payload, args, g, what) -> int:
    """CHAINED chained ticks of the kernel against its plain version from
    ``state``, bit for bit, on random generator rows; returns the neuron
    spikes seen (raises on none). Leaves ``args`` at the last state."""
    n = net.static.n
    dev = args[0].device
    require(float(args[2].float().abs().sum()) > 0, f"{what}: empty ring")
    spiked = 0
    for t in range(state.t, state.t + CHAINED):
        args[3] = (torch.rand(n, generator=g) < 0.3).to(dev)
        got, want = _fused_both(args, t, payload)
        for name, g_, w_ in zip(TICK_OUTPUTS, got, want):
            require(g_.dtype == w_.dtype and torch.equal(g_, w_),
                    f"fused_tick {what} tick {t}: {name} differs from the plain "
                    f"version, max abs err {max_err(g_, w_)}")
        spiked += int(got[2][~args[4]].sum())
        args[0], args[1], args[2] = got[0], got[1], got[3]
    require(spiked > 0, f"fused_tick {what}: no neuron spiked in {CHAINED} ticks")
    return spiked


def _fused_design(net, payload, args, t0=60) -> dict:
    """The grid the launcher picks for this net, the cost of one grid-wide
    barrier at that grid (a kernel of 100 barriers against one of none),
    and the fused tick's time per call on that grid and on one CTA (the
    previous design's layout), in turns."""
    from repro_torch.kernels import ops

    n = net.static.n
    rows_buf = torch.zeros((230, n), dtype=torch.bool, device=args[0].device)
    runners = {}
    for grid in (None, 1):
        v, u, ring = args[0].clone(), args[1].clone(), args[2].clone()
        runners[grid] = ops.FusedTickRun(payload, v, u, ring, *args[4:], rows_buf,
                                         dt=net.static.dt, substeps=net.static.substeps,
                                         grid=grid)
    launcher = runners[None].launcher
    empty = cuda_ms(lambda: launcher.barrier_probe(0), reps=100)
    synced = cuda_ms(lambda: launcher.barrier_probe(100), reps=100)

    def timer(runner):
        counter = iter(range(10**9))

        def one_tick():
            i = next(counter)
            runner.tick(i % 230, t0 + i)
        return one_tick

    times = {None: [], 1: []}
    for grid in (None, 1, 1, None):
        times[grid].append(cuda_ms(timer(runners[grid]), reps=100))
    return {"grid": launcher.grid, "resident_ctas": launcher.resident,
            "barrier_us": (synced - empty) / 100 * 1e3,
            "us_per_tick_grid": min(times[None]) * 1e3,
            "us_per_tick_one_cta": min(times[1]) * 1e3}


def _check_fused_tick(dev, g) -> tuple[dict, dict]:
    """fused_tick against fused_tick_ref on the card: bit for bit on every
    Synfire state (CHAINED chained ticks each), and on random normal weights
    v', u', spikes and i_syn bit for bit (they do not depend on the
    weights within a tick) with ring' at rtol=1e-5, atol=1e-4 (f32 sums
    in another order). Returns the kernel's row, timed at Synfire4 fp16
    packed, and per state the grid, the barrier's cost and the tick on
    that grid against one CTA (:func:`_fused_design`)."""
    from repro_torch.core.backend import assemble_packed
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.fused_tick import assemble_kernel

    err, timed, designs = 0.0, None, {}
    for cfg_name, policy, propagation, kw in FUSED_STATES:
        net, state, payload, args = _fused_state(cfg_name, policy, propagation, dev, kw)
        n = net.static.n
        what = f"{cfg_name} {policy}/{propagation}"
        spiked = _hold_fused(net, state, payload, args, g, what)
        design = designs[what] = _fused_design(net, payload, args)
        log(f"[kernels] fused_tick {what} (N={n}, {len(payload.dense)} dense, "
            f"{len(payload.csr)} CSR buckets): {CHAINED} ticks bitwise, {spiked} neuron "
            f"spikes; grid {design['grid']} CTAs (of {design['resident_ctas']} resident), "
            f"barrier {design['barrier_us']:.2f} us, {design['us_per_tick_grid']:.2f} "
            f"us/tick on the grid vs {design['us_per_tick_one_cta']:.2f} on one CTA")
        if cfg_name == "SYNFIRE4" and policy == "fp32":
            # Random normal weights in the same layout.
            packed = [torch.randn(tuple(w.shape), generator=g).to(dev)
                      for w in assemble_packed(net.static, state.weights)]
            rpay = assemble_kernel(net.static, net.params, packed)
            got, want = _fused_both(args, state.t + CHAINED, rpay)
            for name, g_, w_ in zip(TICK_OUTPUTS, got, want):
                if name == "ring":
                    require(torch.allclose(g_, w_, rtol=1e-5, atol=1e-4),
                            f"fused_tick random {propagation}: ring max abs err "
                            f"{max_err(g_, w_)}")
                    err = max(err, max_err(g_, w_))
                else:
                    require(torch.equal(g_, w_), f"fused_tick random {propagation}: "
                            f"{name} max abs err {max_err(g_, w_)}")
            log(f"[kernels] fused_tick random normal weights ({propagation}): ring "
                f"within rtol=1e-5 atol=1e-4 (max abs err {err:.3g}), the rest bitwise")
        if timed is None:
            timed = (net, payload, list(args))
    net, payload, args = timed
    n, t0 = net.static.n, 60
    got = _fused_kernel_tick(args, t0, payload)
    b_ms, b_by = fused_bound(payload, got[2], n, args[0].element_size())
    rows_buf = torch.zeros((230, n), dtype=torch.bool, device=dev)
    v, u, ring = args[0].clone(), args[1].clone(), args[2].clone()
    runner = ops.FusedTickRun(payload, v, u, ring, *args[4:], rows_buf,
                              dt=net.static.dt, substeps=net.static.substeps)
    counter = iter(range(10**9))

    def one_tick():
        i = next(counter)
        runner.tick(i % 230, t0 + i)

    return {
        "name": "fused_tick", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fused_tick.cu",
        "replaces": "src/repro/kernels/fused_tick.py:243",
        "shape": f"Synfire4 fp16 packed tick: N={n}, 8 dense buckets, "
                 f"grid {runner.launcher.grid} CTAs", "max_abs_err": err,
        "ms": cuda_ms(one_tick),
        "device_ms": device_ms(one_tick, "fused_tick_kernel"),
        "plain_ms": cuda_ms(lambda: ref.fused_tick_ref(
            *args, t0, dense=payload.dense, csr=payload.csr, ring_len=args[2].shape[0])),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}, designs


def _payload_with(payload, k: int, idx=None, w=None):
    """``payload`` with CSR bucket ``k``'s index table or weights replaced."""
    from repro_torch.kernels import fused_tick as ftk

    dense, csr, buckets = list(payload.dense), list(payload.csr), []
    for row in payload.desc.tolist():
        if row[0] == 0:
            buckets.append(("dense", *dense.pop(0)))
            continue
        qs, dly, c_idx, c_w = csr.pop(0)
        if len(payload.csr) - len(csr) - 1 == k:
            c_idx = c_idx if idx is None else idx
            c_w = c_w if w is None else w
        buckets.append(("csr", row[1], row[3], qs, dly, c_idx, c_w))
    return ftk.pack_payload(payload.delays, buckets, payload.desc.device)


def _fused_bad_input(dev) -> dict:
    """fused_tick on bad input, on a Synfire4 fp32 sparse state: a CSR
    index of -1 counts from the end of the spike row and -(N + 1) makes its
    row's drive NaN, as the plain version (the reference's jnp.take), bit
    for bit; and an infinite weight on a silent pre (a generator entry of
    the stimulus bucket, every generator silent this tick), which the
    kernel skips (it adds only the weights of pres that spiked) where the
    plain version multiplies 0 by inf: what each gives is returned, and the
    card must give the plain version's value on the intact table."""
    import numpy as np

    net, state, payload, args = _fused_state("SYNFIRE4", "fp32", "sparse", dev, {})
    n, t = net.static.n, state.t
    args[3] = torch.zeros(n, dtype=torch.bool, device=dev)  # every generator silent
    qs, dly, idx, w = payload.csr[0]
    bad = idx.clone()
    bad[0, 0] = -1
    bad[1, 0] = -(n + 1)
    got, want = _fused_both(args, t, _payload_with(payload, 0, idx=bad))
    slot = (t + dly) % args[2].shape[0]
    for name, g_, w_ in zip(TICK_OUTPUTS, got, want):
        nan = g_.isnan() if g_.is_floating_point() else torch.zeros_like(g_)
        require(torch.equal(nan, w_.isnan() if w_.is_floating_point() else nan)
                and torch.equal(g_[~nan], w_[~nan]),
                f"fused_tick bad indices: {name} differs from the plain version")
    ring_nan = got[3].isnan()
    require(int(ring_nan.sum()) == 1 and bool(ring_nan[slot, qs + 1]),
            f"fused_tick: -(N + 1) gave NaN at {torch.nonzero(ring_nan).tolist()}")
    log("[kernels] fused_tick: a CSR index of -1 counts from the row's end and -(N + 1) "
        "gives NaN, bit for bit as the plain version")

    gens = [(g0, g0 + sz) for g0, sz in net.static.gen_spans]
    k = next(i for i, row in enumerate(
        r for r in payload.desc.tolist() if r[0] == 1)
             if any(lo <= row[1] < hi for lo, hi in gens))
    qs, dly, idx, w = payload.csr[k]
    inf_w = w.clone()
    inf_w[0, 0] = float("inf")
    got, want = _fused_both(args, t, _payload_with(payload, k, w=inf_w))
    intact, _ = _fused_both(args, t, payload)
    slot = (t + dly) % args[2].shape[0]
    out = {"card_ring_entry": float(got[3][slot, qs]),
           "plain_ring_entry": float(want[3][slot, qs]),
           "card_equals_intact_table": bool(torch.equal(got[3], intact[3]))}
    require(out["card_equals_intact_table"] and bool(np.isnan(out["plain_ring_entry"])),
            f"fused_tick inf weight on a silent pre: {out}")
    log(f"[kernels] fused_tick, inf weight on a silent pre: the card adds nothing (ring "
        f"entry {out['card_ring_entry']}, the intact table's), the plain version gives "
        f"{out['plain_ring_entry']} (0 * inf)")
    return out


STDP_KW = dict(a_plus=0.004, a_minus=0.0033, w_min=0.0, w_max=4.0)  # CHAIN_STDP


def _stdp_vectors(g, p: int, q: int, dev):
    """Random pre/post traces in [0, 3) and 0/1 spikes (30 %), f32."""
    return [x.to(dev) for x in (torch.rand(p, generator=g) * 3, torch.rand(q, generator=g) * 3,
                                (torch.rand(p, generator=g) < 0.3).float(),
                                (torch.rand(q, generator=g) < 0.3).float())]


_HELD: list[list[float]] = []  # the open _tracking_held boxes


def _held(got, want) -> float:
    """The largest |got - want| over the elements that differ (equal values
    and NaN against NaN count 0), folded into every open
    :func:`_tracking_held` box."""
    err = 0.0
    if got.numel():
        a, b = got.float(), want.float()
        same = (a == b) | (a.isnan() & b.isnan())
        err = float((a - b).abs().masked_fill(same, 0.0).max())
    for box in _HELD:
        box[0] = max(box[0], err)
    return err


@contextlib.contextmanager
def _tracking_held(box: list[float] | None = None):
    """Yield ``box`` (a new ``[0.0]`` when None), which holds the largest
    difference of the comparisons with plain versions made inside
    (:func:`_require_bitwise` and the slot holds)."""
    box = [0.0] if box is None else box
    _HELD.append(box)
    try:
        yield box
    finally:
        _HELD.remove(box)


def _require_bitwise(got, want, what):
    require(got.dtype == want.dtype and torch.equal(got, want),
            f"{what} differs from its plain version: max abs err {max_err(got, want)}")
    if _HELD:
        _held(got, want)


def _check_stdp(dev, g) -> list[dict]:
    """stdp_update and stdp_gather against their plain versions on the card,
    bit for bit (both pin their rounding and reduce nothing), single calls
    and per-run launchers, and their rows timed at the plastic chain's
    shapes: a plastic Synfire4 packed and sparse fp16 tick's four chain
    projections through the launchers, and one [200, 200] fp16 block and
    Synfire4 sparse's first chain table (int16, fp16) through the single
    calls (``ops_*``)."""
    from repro_torch.configs.synfire4 import CHAIN_STDP, SYNFIRE4, SYNFIRE4_X10, build_synfire
    from repro_torch.kernels import ops, ref

    timed = {}
    with _tracking_held() as update_err:
        for p, q in ((200, 200), (37, 113)):
            for dtype in (torch.float16, torch.float32):
                mask = (torch.rand((p, q), generator=g) < 0.3).to(dev)
                w = torch.where(mask.cpu(), torch.rand((p, q), generator=g) * 4, 0.0).to(dtype).to(dev)
                args = [w, mask, *_stdp_vectors(g, p, q, dev)]
                got = ops.stdp_update(*args, **STDP_KW)
                want = ref.stdp_update_ref(*args, **STDP_KW)
                torch.cuda.synchronize()
                _require_bitwise(got, want, f"stdp_update [{p},{q}] {dtype}")
                require(not torch.equal(got, w), "stdp_update moved no weight")
                timed.setdefault("update", args)
                log(f"[kernels] stdp_update [{p},{q}] {dtype}: bitwise equal")
    with _tracking_held() as gather_err:
        for cfg in (SYNFIRE4, SYNFIRE4_X10):
            net = build_synfire(cfg, policy="fp16", propagation="sparse", stdp_chain=CHAIN_STDP,
                                monitor_ms_hint=0, device=dev)
            for j in net.static.plastic_csr:
                spec = net.static.projections[j]
                valid, idx16 = net.params.masks[j], net.params.proj_csr_idx[j]
                for idx in (idx16, idx16.to(torch.int32)):
                    for dtype in (torch.float16, torch.float32):
                        w = torch.where(valid.cpu(), torch.rand(tuple(valid.shape), generator=g)
                                        * 4, 0.0).to(dtype).to(dev)
                        args = [w, idx, valid, *_stdp_vectors(g, spec.pre_size, spec.post_size,
                                                              dev)]
                        got = ops.stdp_gather(*args, **STDP_KW)
                        want = ref.stdp_gather_ref(*args, **STDP_KW)
                        torch.cuda.synchronize()
                        _require_bitwise(got, want, f"stdp_gather {cfg.name} proj {j} "
                                         f"{idx.dtype} {dtype}")
                        timed.setdefault("gather", args)
            log(f"[kernels] stdp_gather {cfg.name}: {len(net.static.plastic_csr)} chain "
                f"tables (Q x F {sorted({tuple(net.params.masks[j].shape) for j in net.static.plastic_csr})}) "
                "x int16/int32 x fp16/fp32 bitwise")
        # The reference's jnp.take contract on bad indices (P = 8): -1 reads the
        # row's last entry, 8 and -9 read NaN, and a cell that is not valid is
        # +0.0 whatever its index.
        bad = torch.tensor([[1, -1, 8], [2, -9, 0]], dtype=torch.int16, device=dev)
        vecs = _stdp_vectors(g, 8, 2, dev)
        w1 = torch.tensor([[1.0, 1.06, 0.5], [1.0, 2.0, 1.0]], device=dev)
        for valid in (torch.ones((2, 3), dtype=torch.bool, device=dev),
                      torch.tensor([[True, True, False], [True, False, True]], device=dev)):
            out = ops.stdp_gather(w1, bad, valid, *vecs, **STDP_KW)
            want = ref.stdp_gather_ref(w1, bad, valid, *vecs, **STDP_KW)
            torch.cuda.synchronize()
            nan = torch.tensor([[False, False, True], [False, True, False]], device=dev) & valid
            require(torch.equal(out.isnan(), nan) and torch.equal(want.isnan(), nan)
                    and torch.equal(out[~nan], want[~nan]),
                    f"stdp_gather bad indices: {out.tolist()}, plain version {want.tolist()}")
            _held(out, want)
    log("[kernels] stdp_gather: an index in [-P, -1] counts from the row's end, any other "
        "outside [0, P) gives NaN where valid and +0.0 where not, as the plain version "
        "(the reference's jnp.take)")

    rows = []
    args = timed["update"]
    p, q = args[0].shape
    single = {"ops_shape": f"Synfire4 packed chain block [{p},{q}] fp16",
              "ops_ms": cuda_ms(lambda: ops.stdp_update(*args, **STDP_KW)),
              "ops_device_ms": device_ms(lambda: ops.stdp_update(*args, **STDP_KW),
                                         "stdp_update_kernel"),
              "ops_plain_ms": cuda_ms(lambda: ref.stdp_update_ref(*args, **STDP_KW))}
    with _tracking_held(update_err):
        for policy in ("fp16", "fp32"):
            net = build_synfire(SYNFIRE4, policy=policy, propagation="packed",
                                stdp_chain=CHAIN_STDP, monitor_ms_hint=0, device=dev)
            _hold_stdp_update_run(net, g, dev, f"{SYNFIRE4.name} {policy}")
        _stdp_update_mixed_plan(g, dev)
    nan = _stdp_update_nan_weight(g, dev)
    net = build_synfire(SYNFIRE4, policy="fp16", propagation="packed", stdp_chain=CHAIN_STDP,
                        device=dev)
    rows.append({
        "name": "stdp_update", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/stdp_update.cu",
        "replaces": "src/repro/kernels/stdp_update.py:33", "max_abs_err": update_err[0],
        **_stdp_update_run_row(net, g, dev), **single, "nan_weight": nan,
        "library_ms": None})
    args = timed["gather"]
    q, f = args[0].shape
    single = {"ops_shape": f"Synfire4 sparse chain table: P={args[3].shape[0]} Q={q} F={f} "
                           "int16/fp16",
              "ops_ms": cuda_ms(lambda: ops.stdp_gather(*args, **STDP_KW)),
              "ops_device_ms": device_ms(lambda: ops.stdp_gather(*args, **STDP_KW),
                                         "stdp_gather_kernel"),
              "ops_plain_ms": cuda_ms(lambda: ref.stdp_gather_ref(*args, **STDP_KW))}
    with _tracking_held(gather_err):
        for cfg in (SYNFIRE4, SYNFIRE4_X10):
            for policy in ("fp16", "fp32"):
                net = build_synfire(cfg, policy=policy, propagation="sparse",
                                    stdp_chain=CHAIN_STDP, budget=None, monitor_ms_hint=0,
                                    device=dev)
                _hold_stdp_run(net, g, dev, f"{cfg.name} {policy}")
        _stdp_run_bad_indices(g, dev)
    net = build_synfire(SYNFIRE4, policy="fp16", propagation="sparse", stdp_chain=CHAIN_STDP,
                        device=dev)
    rows.append({
        "name": "stdp_gather", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/stdp_gather.cu",
        "replaces": "src/repro/kernels/stdp_gather.py:59", "max_abs_err": gather_err[0],
        **_stdp_run_row(net, g, dev), **single, "library_ms": None})
    return rows


def _drive_case(net, g, dev, lanes=None):
    """The plastic and STP projections of ``net`` as ``DriveProjection`` s
    landing in random f32 accumulator entries ``[(B,) N]`` (``acc``), with
    random off-grid weights in [0, 3) and STP state in [0, 1) (each lane
    its own over ``lanes``): ``(projs, acc, weights, stp, keys)``;
    ``projs_on(out)`` rebuilds the projections onto another accumulator."""
    from repro_torch.core import backend as be
    from repro_torch.kernels.plastic_drive import DriveProjection

    lead = () if lanes is None else (lanes,)
    fanin = be.assemble_fanin(net.static, net.params)
    keys = [j for j, s in enumerate(net.static.projections) if s.plastic or s.stp is not None]
    acc = torch.rand((*lead, net.static.n), generator=g).to(dev)
    weights, stp, fields = [], [], []
    for j in keys:
        spec, fr = net.static.projections[j], fanin[j]
        w0 = net.state0.weights[j]
        weights.append((torch.rand((*lead, *w0.shape), generator=g) * 3).to(w0.dtype).to(dev))
        st = None
        if spec.stp is not None:
            u0 = net.state0.stp[j].u
            st = tuple(torch.rand((*lead, *u0.shape), generator=g).to(u0.dtype).to(dev)
                       for _ in range(2))
        stp.append(st)
        fields.append((slice(spec.post_start, spec.post_start + spec.post_size), dict(
            pre=fr.pre, rows=fr.rows, w_dtype=w0.dtype, stp=spec.stp is not None,
            pre_start=spec.pre_start, n_pre=spec.pre_size,
            stp_dtype=st[0].dtype if st else torch.float32,
            sentinel=spec.pre_size * spec.post_size if fr.rows is not None else -1)))

    def projs_on(out):
        return [DriveProjection(out=out[..., cols], **kw) for cols, kw in fields]

    return projs_on, acc, weights, stp, keys


def _drive_bound(projs, weights, stp, n: int, lanes: int = 1) -> tuple[float, str, int]:
    """The drive's least work: each lane's spike row, STP state and
    accumulator entries (read and written), a multiply and an add per
    fan-in entry of every lane, and per projection the cheaper way to read
    its weights: through its fan-in rows (the pre ids, int32, and, dense,
    the flat rows, shared by the lanes; each lane's Q·F weights they pick)
    or, dense-stored, each lane's whole [P, Q] image and a bit a cell of
    its mask, shared by the lanes."""
    moved, ops_ = lanes * n * 4, 0
    for p, w, st in zip(projs, weights, stp):
        q, f = p.pre.shape
        size = w.element_size()
        read = q * f * 4 * (1 if p.rows is None else 2) + lanes * q * f * size
        if p.rows is not None:
            cells = p.sentinel  # P·Q
            read = min(read, lanes * cells * size + -(-cells // 8))
        moved += read + lanes * 2 * q * 4
        moved += 0 if st is None else nbytes(*st)
        ops_ += 2 * q * f * lanes
    b_ms, b_by = bound(moved, ops_)
    return b_ms, b_by, moved


DRIVE_LIBRARY_TOL = (1e-5, 1e-4)  # rtol, atol: the library sums in another order


def _drive_library(projs, weights, stp, spikes, dev):
    """One PyTorch call for the drive of every projection (of every lane),
    in the library's order and with no landing: where the rows are
    CSR-stored, ``embedding_bag(mode="sum", per_sample_weights=...)`` over
    them with the spike rows and a zero appended as its table; where every
    projection is dense-stored with one [P, Q] shape, ``torch.bmm`` of each
    pre group's spikes by its f32 image masked to the fan-in (made outside
    the call). The call's drives are held against the plain version's at
    ``DRIVE_LIBRARY_TOL``. Returns ``(call, name)``, or None where STP
    scales a row or the projections mix storage or dense shapes."""
    from repro_torch.kernels import ref

    if any(p.stp for p in projs):
        return None
    lanes = spikes.shape[0] if spikes.dim() == 2 else 1
    rows = spikes.reshape(lanes, -1)
    if all(p.rows is None for p in projs):
        n1 = rows.shape[1] + 1
        table = torch.nn.functional.pad(rows, (0, 1)).reshape(-1, 1)
        idx, psw, offs, at = [], [], [], 0
        for p, w in zip(projs, weights):
            q, f = p.pre.shape
            lane_ids = torch.arange(lanes, device=dev).view(-1, 1, 1) * n1
            idx.append((p.pre.long()[None] + lane_ids).reshape(-1))
            psw.append(w.float().reshape(-1))
            offs.append(torch.arange(lanes * q, device=dev) * f + at)
            at += lanes * q * f
        idx, psw, offs = torch.cat(idx), torch.cat(psw), torch.cat(offs)
        call = lambda: torch.nn.functional.embedding_bag(  # noqa: E731
            idx, table, offs, mode="sum", per_sample_weights=psw)
        name = "embedding_bag(mode='sum', per_sample_weights) over the same rows"
    elif all(p.rows is not None for p in projs) and len(
            {(p.sentinel, p.pre.shape[0]) for p in projs}) == 1:
        q = projs[0].pre.shape[0]
        cells = projs[0].sentinel
        images, pres = [], []
        for p, w in zip(projs, weights):
            valid = p.rows.long() != cells
            flat = p.rows.long()[valid]
            mask = torch.zeros(cells, dtype=torch.bool, device=dev)
            mask[flat] = True
            image = w.reshape(lanes, -1)[:, :cells].float() * mask
            images.append(image.reshape(lanes, cells // q, q))
            starts = p.pre.long()[valid] - flat // q  # a dense row's pre ids: pre_start + p
            require(bool((starts == starts[0]).all()), "plastic_drive library: pre ids")
            start = int(starts[0])
            pres.append(rows[:, start:start + cells // q])
        image = torch.stack(images).reshape(-1, cells // q, q)
        pre = torch.stack(pres).reshape(-1, 1, cells // q)
        call = lambda: torch.bmm(pre, image)  # noqa: E731
        name = "torch.bmm of the pre spikes by the masked f32 dense images"
    else:
        return None
    outs = [torch.zeros(p.out.shape, device=dev) for p in projs]
    ref.drive_run_ref(spikes, [p._replace(out=o) for p, o in zip(projs, outs)], weights, stp)
    want = torch.cat([o.reshape(-1) for o in outs])
    got = call().reshape(-1)
    rtol, atol = DRIVE_LIBRARY_TOL
    require(torch.allclose(got, want, rtol=rtol, atol=atol),
            f"plastic_drive library call ({name}) differs from the plain version by "
            f"{max_err(got, want)}")
    return call, name


def _stp_net(policy: str, dev):
    """A generator group driving 20 IZH4 neurons through one STP
    projection (fan-in 20), the drive's STP case."""
    from repro_torch.core import NetworkBuilder, izh4
    from repro_torch.core.synapses import STPConfig

    b_ = NetworkBuilder(seed=0)
    b_.add_spike_generator("g", 50, rate_hz=200.0)
    b_.add_group("n", izh4(20, a=0.02, b=0.2, c=-65.0, d=8.0))
    b_.connect("g", "n", fanin=20, weight=0.3, delay_ms=1,
               stp=STPConfig(u0=0.45, tau_f=50.0, tau_d=750.0))
    return b_.compile(policy=policy, device=dev)


def _check_drive(dev, g) -> dict:
    """``plastic_drive`` (the port's own kernel: the reference's drive is
    XLA, ``src/repro/core/backend.py:161``) against its plain version on
    the card, bit for bit (both sum each row in XLA CPU's order), on random
    off-grid weights: the plastic Synfire4 chain fp16/fp32 x packed/sparse,
    plastic x10 sparse (fan-in rows wider than 32) and an STP net; its row
    at the plastic Synfire4 fp16 sparse tick (four chain projections, one
    launch), beside ``embedding_bag`` over the same rows."""
    from repro_torch.configs.synfire4 import CHAIN_STDP, SYNFIRE4, SYNFIRE4_X10, build_synfire
    from repro_torch.kernels import ops, ref

    nets = []
    for cfg, policy, propagation in ((SYNFIRE4, "fp16", "packed"), (SYNFIRE4, "fp32", "packed"),
                                     (SYNFIRE4, "fp16", "sparse"), (SYNFIRE4, "fp32", "sparse"),
                                     (SYNFIRE4_X10, "fp16", "sparse")):
        nets.append((f"{cfg.name} {policy}/{propagation}", build_synfire(
            cfg, policy=policy, propagation=propagation, stdp_chain=CHAIN_STDP, device=dev,
            budget=None, monitor_ms_hint=0)))
    nets.append(("STP net fp16", _stp_net("fp16", dev)))
    err = 0.0
    for what, net in nets:
        projs_on, acc, weights, stp, _ = _drive_case(net, g, dev)
        plain_acc = acc.clone()
        run = ops.DriveRun(net.static.n, projs_on(acc))
        plain = projs_on(plain_acc)
        require(run.launcher is not None, f"plastic_drive {what}: no launcher on the card")
        for t in range(3):
            spikes = (torch.rand(net.static.n, generator=g) < 0.3).float().to(dev)
            ops.reset_launches()
            run(spikes, weights, stp)
            ref.drive_run_ref(spikes, plain, weights, stp)
            torch.cuda.synchronize()
            require(ops.LAUNCHES["plastic_drive"] == 1, f"plastic_drive {what}: launches")
            _require_bitwise(acc, plain_acc, f"plastic_drive {what} tick {t}")
        f_max = max(p.pre.shape[1] for p in plain)
        log(f"[kernels] plastic_drive {what}: {len(plain)} projections (F up to {f_max}), "
            "3 ticks bitwise against its plain version (XLA CPU's row order)")
    return {"name": "plastic_drive", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/plastic_drive.cu",
            "replaces": "none: the port's own kernel (the reference's drive is XLA, "
                        "src/repro/core/backend.py:161)",
            "max_abs_err": err, **_time_drive(nets[2], g, dev),
            "x10": _time_drive(nets[4], g, dev), "packed": _time_drive(nets[0], g, dev)}


def _time_drive(named, g, dev) -> dict:
    """One lane's drive of every plastic projection of ``named`` (a
    ``(what, net)`` pair) on random off-grid weights: per call, alone on
    the device, the plain version, the byte bound and, for CSR-stored
    rows, ``embedding_bag`` over the same rows."""
    from repro_torch.kernels import ops, ref

    what, net = named
    projs_on, acc, weights, stp, _ = _drive_case(net, g, dev)
    projs = projs_on(acc)
    run = ops.DriveRun(net.static.n, projs)
    spikes = (torch.rand(net.static.n, generator=g) < 0.3).float().to(dev)
    plain = projs_on(acc.clone())
    b_ms, b_by, moved = _drive_bound(projs, weights, stp, net.static.n)
    lib = _drive_library(projs, weights, stp, spikes, dev)
    call = lambda: run(spikes, weights, stp)  # noqa: E731
    rows = sum(p.pre.shape[0] for p in projs)
    return {"shape": f"plastic {what} tick: {len(projs)} chain projections, {rows} rows "
                     f"(Q x F {sorted({tuple(p.pre.shape) for p in projs})}), one launch",
            "ms": cuda_ms(call), "device_ms": device_ms(call, "plastic_drive_kernel"),
            "plain_ms": cuda_ms(lambda: ref.drive_run_ref(spikes, plain, weights, stp),
                                reps=20, warmup=2),
            "bound_ms": b_ms, "bound_by": b_by, "bound_bytes": moved,
            **_drive_library_times(lib)}


def _drive_library_times(lib) -> dict:
    """The library call of :func:`_drive_library` (or None): its name, per
    call and alone on the device."""
    if lib is None:
        return {"library": None, "library_ms": None, "library_device_ms": None}
    call, name = lib
    return {"library": name, "library_ms": cuda_ms(call),
            "library_device_ms": device_total_ms(call)}


STDP_TICKS = 10  # chained ticks per StdpGatherRun and StdpUpdateRun case


def _plastic_tables(net, g, dev):
    """Random weights (in [0, 4) on valid cells, +0.0 elsewhere) and traces
    (in [0, 3)) for the plastic chain of ``net``."""
    from repro_torch.core.plasticity import STDPState

    weights, stdp = list(net.state0.weights), list(net.state0.stdp)
    for j in _chain(net):
        valid, w = net.params.masks[j], weights[j]
        weights[j] = torch.where(valid.cpu(), torch.rand(tuple(w.shape), generator=g) * 4,
                                 0.0).to(w.dtype).to(dev)
        tr = stdp[j]
        stdp[j] = STDPState(*(torch.rand(x.shape[0], generator=g).mul(3).to(dev)
                              for x in (tr.pre_trace, tr.post_trace)))
    return tuple(weights), tuple(stdp)


def _hold_stdp_run(net, g, dev, what: str) -> None:
    """``ops.StdpGatherRun`` (every CSR pair-STDP projection of a tick in
    one launch, trace steps folded in) against the per-call path
    (``backend.stdp_dispatch``: the two ``_trace_step`` s and one
    ``ops.stdp_gather`` per projection) on the card, from random weights
    and traces over STDP_TICKS random spike rows: weights and both traces
    bit for bit after every tick, one launch per tick, the caller's tensors
    left as they were."""
    from repro_torch.core import backend as be
    from repro_torch.kernels import ops

    static, params = net.static, net.params
    weights, stdp = _plastic_tables(net, g, dev)
    saved = [w.clone() for w in weights]
    run = be.assemble_stdp_gather(static, params, weights, stdp)
    require(run is not None and run.launcher is not None
            and run.keys == tuple(j for j in _chain(net) if j in static.csr_projs),
            f"StdpGatherRun {what}: keys {None if run is None else run.keys}")
    w_pc, tr_pc = dict(enumerate(weights)), dict(enumerate(stdp))
    launched = 0
    for t in range(STDP_TICKS):
        spikes = (torch.rand(static.n, generator=g) < 0.3).float().to(dev)
        ops.reset_launches()
        run(spikes)
        launched += ops.LAUNCHES["stdp_gather"]
        for j in run.keys:
            spec = static.projections[j]
            tr_pc[j], w_pc[j] = be.stdp_dispatch(
                static, static.stdp[j], tr_pc[j], w_pc[j], params.masks[j],
                spikes[spec.pre_slice], spikes[spec.post_slice], params.proj_csr_idx[j])
        torch.cuda.synchronize()
        for k, j in enumerate(run.keys):
            pre, post = run.traces(k)
            for name, got, want in (("weights", run.projs[k].w, w_pc[j]),
                                    ("pre trace", pre, tr_pc[j].pre_trace),
                                    ("post trace", post, tr_pc[j].post_trace)):
                _require_bitwise(got, want, f"StdpGatherRun {what} tick {t} projection "
                                 f"{j} {name} (against the per-call path)")
    require(launched == STDP_TICKS,
            f"StdpGatherRun {what}: {launched} launches in {STDP_TICKS} ticks")
    require(all(torch.equal(a, b) for a, b in zip(weights, saved)),
            f"StdpGatherRun {what}: the caller's weights changed")
    log(f"[kernels] StdpGatherRun {what}: {len(run.keys)} projections "
        f"(Q x F {sorted({tuple(p.w.shape) for p in run.projs})}) in one launch a tick, "
        f"{STDP_TICKS} ticks bitwise against the per-call path (weights, both traces)")


def _stdp_run_bad_indices(g, dev) -> None:
    """A StdpGatherRun of two projections of different P, Q and F, the first
    with the reference's bad indices (P = 8: -1 reads the last pre, 8 and
    -9 read NaN; one bad cell not valid), against its plain version
    (``ref.stdp_gather_run_ref``) on the card: bit for bit where a number,
    NaN at the same cells, over three ticks."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.stdp_gather import Projection

    def projs():
        g2 = torch.Generator(device="cpu").manual_seed(5)
        out = []
        for idx, valid, p_, ps, qs in (
                ([[1, -1, 8], [2, -9, 0]], [[True, True, True], [True, False, True]], 8, 0,
                 8),
                (torch.randint(0, 30, (7, 5), generator=g2).tolist(), [[True] * 5] * 7, 30,
                 10, 2)):
            idx = torch.tensor(idx, dtype=torch.int32, device=dev)
            valid = torch.tensor(valid, device=dev)
            q, f = idx.shape
            pre = torch.rand(p_, generator=g2).to(dev)
            post = torch.rand(q, generator=g2).to(dev)
            out.append(Projection(
                w=(torch.rand((q, f), generator=g2) * 2).half().to(dev), idx=idx,
                valid=valid, pre_tr=(pre, torch.empty_like(pre)),
                post_tr=(post, torch.empty_like(post)), pre_start=ps, post_start=qs,
                **STDP_KW, decay_pre=0.951229424500714, decay_post=0.951229424500714))
        return out

    card, plain = projs(), projs()
    run = ops.StdpGatherRun(40, card)
    require(run.launcher is not None, "StdpGatherRun bad indices: no launcher")
    for t in range(3):
        spikes = (torch.rand(40, generator=g) < 0.5).float().to(dev)
        run(spikes)
        ref.stdp_gather_run_ref(spikes, plain, t % 2)
        torch.cuda.synchronize()
        for a, b in zip(card, plain):
            for name, x, y in (("w", a.w, b.w), ("pre", a.pre_tr[1 - t % 2],
                                                 b.pre_tr[1 - t % 2]),
                               ("post", a.post_tr[1 - t % 2], b.post_tr[1 - t % 2])):
                nan = x.isnan()
                require(torch.equal(nan, y.isnan()) and torch.equal(x[~nan], y[~nan]),
                        f"StdpGatherRun bad indices tick {t} {name}: {x.tolist()} vs "
                        f"{y.tolist()}")
    nan = card[0].w.isnan()
    require(nan.tolist() == [[False, False, True], [False, False, False]],
            f"StdpGatherRun bad indices: NaN at {nan.tolist()}")
    log("[kernels] StdpGatherRun on the reference's bad indices: equal to its plain "
        "version (NaN where valid and outside [-P, P), +0.0 where not valid)")


def _stdp_run_row(net, g, dev) -> dict:
    """StdpGatherRun's numbers on the plastic Synfire4 sparse chain (four
    projections in one launch): per call (the ctypes call included) and
    alone on the device, its plain version on the card, and the bound:
    each projection's weights read and written, its indices and validity
    rows, its traces read and written and its pre and post spikes read
    once, 7 operations per cell and 2 per trace."""
    from repro_torch.core import backend as be
    from repro_torch.kernels import ref

    weights, stdp = _plastic_tables(net, g, dev)
    run = be.assemble_stdp_gather(net.static, net.params, weights, stdp)
    spikes = (torch.rand(net.static.n, generator=g) < 0.3).float().to(dev)
    moved = ops_ = 0
    for p in run.projs:
        q, f = p.w.shape
        n_tr = p.pre_tr[0].shape[0] + q
        moved += 2 * nbytes(p.w) + nbytes(p.idx, p.valid) + 3 * 4 * n_tr
        ops_ += 7 * q * f + 2 * n_tr
    b_ms, b_by = bound(moved, ops_)
    plain = lambda: ref.stdp_gather_run_ref(spikes, run.projs, 0)  # noqa: E731
    return {"shape": f"plastic Synfire4 sparse fp16 tick: {len(run.projs)} chain "
                     f"projections (Q x F {sorted({tuple(p.w.shape) for p in run.projs})}, "
                     "int16/fp16), one launch",
            "ms": cuda_ms(lambda: run(spikes)),
            "device_ms": device_ms(lambda: run(spikes), "stdp_run_kernel"),
            "plain_ms": cuda_ms(plain, reps=50, warmup=5), "bound_ms": b_ms,
            "bound_by": b_by, "bound_bytes": moved}


def _dense_plain_copy(projs):
    """Copies of ``DenseProjection`` s (weights and both trace buffers,
    without the zero-ended buffer) for the plain run."""
    return [p._replace(w=p.w.clone(), pre_tr=tuple(t.clone() for t in p.pre_tr),
                       post_tr=tuple(t.clone() for t in p.post_tr), padded=None)
            for p in projs]


def _require_same_dense(card, plain, what):
    for k, (a, b) in enumerate(zip(card, plain)):
        for name, x, y in (("weights", a.w, b.w), ("pre trace 0", a.pre_tr[0], b.pre_tr[0]),
                           ("pre trace 1", a.pre_tr[1], b.pre_tr[1]),
                           ("post trace 0", a.post_tr[0], b.post_tr[0]),
                           ("post trace 1", a.post_tr[1], b.post_tr[1])):
            _require_bitwise(x, y, f"{what} projection {k} {name}")


def _hold_stdp_update_run(net, g, dev, what: str) -> None:
    """``ops.StdpUpdateRun`` (every dense pair-STDP projection of a tick in
    one launch, trace steps folded in, weights in place on zero-ended
    buffers) against its plain version (``ref.stdp_update_run_ref``) on the
    card, from random weights and traces over STDP_TICKS random spike rows:
    weights and both trace buffers bit for bit after every tick, one launch
    per tick, each buffer's last entry +0.0, the caller's tensors left as
    they were."""
    from repro_torch.core import backend as be
    from repro_torch.kernels import ops, ref

    static, params = net.static, net.params
    weights, stdp = _plastic_tables(net, g, dev)
    saved = [w.clone() for w in weights]
    run = be.assemble_stdp_update(static, params, weights, stdp)
    require(run is not None and run.launcher is not None
            and run.keys == tuple(j for j in _chain(net) if j not in static.csr_projs)
            and sorted(run.padded) == list(run.keys),
            f"StdpUpdateRun {what}: keys {None if run is None else run.keys}")
    plain = _dense_plain_copy(run.projs)
    launched = 0
    for t in range(STDP_TICKS):
        spikes = (torch.rand(static.n, generator=g) < 0.3).float().to(dev)
        ops.reset_launches()
        run(spikes)
        launched += ops.LAUNCHES["stdp_update"]
        ref.stdp_update_run_ref(spikes, plain, t % 2)
        torch.cuda.synchronize()
        _require_same_dense(run.projs, plain, f"StdpUpdateRun {what} tick {t}")
    require(all(float(b[-1]) == 0.0 for b in run.padded.values()),
            f"StdpUpdateRun {what}: a zero-ended buffer lost its zero")
    require(launched == STDP_TICKS,
            f"StdpUpdateRun {what}: {launched} launches in {STDP_TICKS} ticks")
    require(all(torch.equal(a, b) for a, b in zip(weights, saved)),
            f"StdpUpdateRun {what}: the caller's weights changed")
    log(f"[kernels] StdpUpdateRun {what}: {len(run.keys)} projections "
        f"(P x Q {sorted({tuple(p.w.shape) for p in run.projs})}) in one launch a tick, "
        f"{STDP_TICKS} ticks bitwise against its plain version (weights, both trace buffers)")


def _dense_projs(dev, seed: int, plan):
    """``DenseProjection`` s from ``plan`` ((P, Q, dtype, pre_start,
    post_start) each): random weights in [0, 4) on a 40 % mask, traces in
    [0, 2)."""
    from repro_torch.kernels.stdp_update import DenseProjection

    g2 = torch.Generator(device="cpu").manual_seed(seed)
    out = []
    for p_, q_, dtype, ps, qs in plan:
        mask = torch.rand((p_, q_), generator=g2) < 0.4
        w = torch.where(mask, torch.rand((p_, q_), generator=g2) * 4, 0.0).to(dtype)
        pre, post = (torch.rand(x, generator=g2).mul(2).to(dev) for x in (p_, q_))
        out.append(DenseProjection(
            w=w.to(dev), mask=mask.to(dev), pre_tr=(pre, torch.empty_like(pre)),
            post_tr=(post, torch.empty_like(post)), pre_start=ps, post_start=qs,
            **STDP_KW, decay_pre=0.951229424500714, decay_post=0.9355069850316178))
    return out


def _stdp_update_mixed_plan(g, dev) -> None:
    """One StdpUpdateRun over two projections of different P, Q and storage
    ([37, 113] f32 and [200, 200] fp16) against its plain version on the
    card over STDP_TICKS ticks, bit for bit."""
    from repro_torch.kernels import ops, ref

    plan = ((37, 113, torch.float32, 0, 40), (200, 200, torch.float16, 153, 400))
    card = _dense_projs(dev, 21, plan)
    plain = _dense_plain_copy(card)
    run = ops.StdpUpdateRun(600, card)
    require(run.launcher is not None, "StdpUpdateRun mixed plan: no launcher")
    for t in range(STDP_TICKS):
        spikes = (torch.rand(600, generator=g) < 0.3).float().to(dev)
        run(spikes)
        ref.stdp_update_run_ref(spikes, plain, t % 2)
        torch.cuda.synchronize()
        _require_same_dense(card, plain, f"StdpUpdateRun mixed plan tick {t}")
    log(f"[kernels] StdpUpdateRun mixed plan ([37, 113] f32 + [200, 200] fp16, "
        f"{run.launcher.items} CTAs): {STDP_TICKS} ticks bitwise against its plain version")


def _stdp_update_nan_weight(g, dev) -> str:
    """A NaN weight in a masked-in cell and one in a masked-out cell,
    through ``ops.stdp_update`` and ``ops.StdpUpdateRun`` on the card in
    fp16 and f32: NaN in the first, +0.0 in the second, as in the plain
    version (``torch.clamp``, the reference's ``jnp.clip``); every other
    cell equal to the plain version."""
    from repro_torch.kernels import ops, ref

    def check(got, want, what):
        for name, x in (("card", got), ("plain", want)):
            require(bool(x[3, 5].isnan()) and int(x.isnan().sum()) == 1,
                    f"{what}: {name} NaN cells {x.isnan().nonzero().tolist()}, want [[3, 5]]")
            require(float(x[20, 100]) == 0.0 and not bool(torch.signbit(x[20, 100])),
                    f"{what}: {name} masked-out NaN cell gave {float(x[20, 100])}")
        ok = ~want.isnan()
        require(torch.equal(got[ok], want[ok]), f"{what}: other cells differ")

    for dtype in (torch.float16, torch.float32):
        card = _dense_projs(dev, 22, ((37, 113, dtype, 0, 37),))
        p = card[0]
        p.w[3, 5] = p.w[20, 100] = float("nan")
        p.mask[3, 5], p.mask[20, 100] = True, False
        plain = _dense_plain_copy(card)
        spikes = (torch.rand(150, generator=g) < 0.5).float().to(dev)
        args = [p.w, p.mask, p.pre_tr[0], p.post_tr[0], spikes[:37], spikes[37:]]
        check(ops.stdp_update(*args, **STDP_KW), ref.stdp_update_ref(*args, **STDP_KW),
              f"stdp_update NaN weight {dtype}")
        ops.StdpUpdateRun(150, card)(spikes)
        ref.stdp_update_run_ref(spikes, plain, 0)
        torch.cuda.synchronize()
        check(card[0].w, plain[0].w, f"StdpUpdateRun NaN weight {dtype}")
    log("[kernels] stdp_update: a NaN weight stays NaN in a masked-in cell and is +0.0 in "
        "a masked-out one (single call and StdpUpdateRun, fp16 and f32), as the plain "
        "version and the reference's jnp.clip")
    return "NaN kept in a masked-in cell, +0.0 in a masked-out one (fp16, f32; single call, run)"


def _stdp_update_run_row(net, g, dev) -> dict:
    """StdpUpdateRun's numbers on the plastic Synfire4 packed chain (four
    [200, 200] projections in one launch): per call (the ctypes call
    included) and alone on the device, its plain version on the card, and
    the bound: each projection's weights read and written, its mask, its
    traces read and written and its pre and post spikes read once, 7
    operations per cell and 2 per trace."""
    from repro_torch.core import backend as be
    from repro_torch.kernels import ref

    weights, stdp = _plastic_tables(net, g, dev)
    run = be.assemble_stdp_update(net.static, net.params, weights, stdp)
    spikes = (torch.rand(net.static.n, generator=g) < 0.3).float().to(dev)
    moved = ops_ = 0
    for p in run.projs:
        p_, q_ = p.w.shape
        n_tr = p_ + q_
        moved += 2 * nbytes(p.w) + nbytes(p.mask) + 3 * 4 * n_tr
        ops_ += 7 * p_ * q_ + 2 * n_tr
    b_ms, b_by = bound(moved, ops_)
    plain = lambda: ref.stdp_update_run_ref(spikes, run.projs, 0)  # noqa: E731
    return {"shape": f"plastic Synfire4 packed fp16 tick: {len(run.projs)} chain "
                     f"projections (P x Q {sorted({tuple(p.w.shape) for p in run.projs})}, "
                     f"fp16), one launch of {run.launcher.items} CTAs",
            "ms": cuda_ms(lambda: run(spikes)),
            "device_ms": device_ms(lambda: run(spikes), "stdp_update_run_kernel"),
            "plain_ms": cuda_ms(plain, reps=50, warmup=5), "bound_ms": b_ms,
            "bound_by": b_by, "bound_bytes": moved}


# -- the CPU port's references, computed beside the build -------------------------------

REF_PROCS = 3  # processes computing the CPU references of phases 3-5c beside the build
REF_THREADS = 1  # their torch threads: a Synfire tick's small ops gain nothing from more
REF_TIMEOUT = 900
REFS_ENV = "CHIP_SMOKE_REFS"  # the directory of the references (the children's files)


MINI_TICKS = 5000
# The injected uniforms of phases 3-5 (the card half and its CPU reference
# draw them alike through ``_uniforms``): name -> (seed, config, ticks).
UNIFORMS = {"synfire": (7, "SYNFIRE4", TICKS), "x10": (11, "SYNFIRE4_X10", TICKS),
            "mini": (13, "SYNFIRE4_MINI", MINI_TICKS), "plastic": (17, "SYNFIRE4", TICKS),
            "plastic_x10": (19, "SYNFIRE4_X10", TICKS)}
# The build keywords of the static x10 net (phase 4; the plastic one's:
# ``_plastic_x10_build``, homeostasis': ``_homeo``).
X10_BUILD = dict(budget=None, monitor_ms_hint=0)
A5_KEY_SEED = 7  # phase 5c's gen_base key


def _uniforms(name: str) -> torch.Tensor:
    from repro_torch.configs import synfire4

    seed, cfg, ticks = UNIFORMS[name]
    g = torch.Generator(device="cpu").manual_seed(seed)
    return torch.rand((ticks, getattr(synfire4, cfg).n_stim), generator=g)


def _homeo() -> dict:
    from repro_torch.core.plasticity import HomeostasisConfig

    return dict(homeo_chain=HomeostasisConfig(**HOMEO), homeostasis_period=100)


def _plastic_x10_build() -> dict:
    from repro_torch.memory import MCU_BUDGET_BYTES

    return dict(budget=MCU_BUDGET_BYTES, monitor_ms_hint=0)


def _ref_jobs() -> dict:
    """Every CPU-port reference of phases 3-5c: name -> ``(cost, fn)``, ``fn``
    computing it on the CPU from seeds alone (the same inputs the card half
    draws), so a child process can compute it while the kernels build."""
    from repro_torch.configs.synfire4 import (
        CHAIN_STDP, SYNFIRE4, SYNFIRE4_MINI, SYNFIRE4_X10, build_synfire,
    )
    from repro_torch.core import rng

    cpu = torch.device("cpu")

    def plastic(cfg, policy, propagation, uniforms, **kw):
        out = _plastic_run(cfg, policy, propagation, _uniforms(uniforms), cpu, **kw)
        return (None, *out[1:])  # the net stays behind

    def sparse(**kw):
        return build_synfire(SYNFIRE4, policy="fp16", propagation="sparse", device=cpu, **kw)

    homeo = _homeo()
    jobs = {
        "mini/default": (3, lambda: _cpu_raster(SYNFIRE4_MINI, "fp16", "packed", None,
                                                MINI_TICKS)),
        "mini/injected": (3, lambda: _cpu_raster(SYNFIRE4_MINI, "fp16", "packed",
                                                 _uniforms("mini"), MINI_TICKS)),
        "x10": (20, lambda: _cpu_raster(SYNFIRE4_X10, "fp16", "sparse", _uniforms("x10"), TICKS,
                                       **X10_BUILD)),
        "plastic_x10": (40, lambda: plastic(SYNFIRE4_X10, "fp16", "sparse", "plastic_x10",
                                            **_plastic_x10_build())),
        "a5/gen_base": (3, lambda: _timed_run(sparse(), TICKS, cpu,
                                              gen_base=rng.key(A5_KEY_SEED, cpu))),
    }
    for propagation in ("packed", "sparse"):
        jobs[f"plastic_homeo/{propagation}"] = (
            5, lambda p=propagation: plastic(SYNFIRE4, "fp16", p, "plastic", **homeo))
        jobs[f"coba_plastic/{propagation}"] = (6, lambda p=propagation: _timed_run(
            _coba_net(SYNFIRE4, "fp16", p, cpu, stdp_chain=CHAIN_STDP), TICKS, cpu))
        for policy in ("fp16", "fp32"):
            jobs[f"synfire/{policy}/{propagation}"] = (2, lambda p=propagation, q=policy: (
                _cpu_raster(SYNFIRE4, q, p, _uniforms("synfire"), TICKS)))
            jobs[f"plastic/{policy}/{propagation}"] = (
                5, lambda p=propagation, q=policy: plastic(SYNFIRE4, q, p, "plastic"))
            jobs[f"coba/{policy}/{propagation}"] = (2, lambda p=propagation, q=policy: (
                _timed_run(_coba_net(SYNFIRE4, q, p, cpu), TICKS, cpu)))
    for label, kw in (("static", {}), ("homeostasis", homeo)):
        jobs[f"a5/gen_chunk/{label}"] = (3, lambda kw=kw: _timed_run(sparse(**kw), TICKS, cpu,
                                                                     gen_chunk=100))
    jobs.update(_later_ref_jobs(cpu))
    return jobs


def _later_ref_jobs(cpu) -> dict:
    """The CPU references of phases 9, 10 and 12 (read in their own
    processes): monitored telemetry, watch carries, the bf16 and int8 runs."""
    from repro_torch.configs.synfire4 import CHAIN_STDP, SYNFIRE4, build_synfire
    from repro_torch.core.engine import run
    from repro_torch.obs import watch as wat
    from repro_torch.precision import dequantize, quantize_int8

    def monitored(policy, propagation, backend):
        net = build_synfire(SYNFIRE4, policy=policy, propagation=propagation, backend=backend,
                            device=cpu)
        return run(net.static, net.params, net.state0, MON_TICKS,
                   record="monitors")[1]["telemetry"]

    def watched(watches, **kw):
        net = build_synfire(SYNFIRE4, watches=watches, device=cpu, **kw)
        return run(net.static, net.params, net.state0, OBS_TICKS, record="none")[1]

    def int8():  # phase 12e's net on int8-round-tripped weights
        net = build_synfire(SYNFIRE4, policy="fp32", propagation="packed", device=cpu)
        w = tuple(dequantize(quantize_int8(x, axis=0)) for x in net.state0.weights)
        net.state0 = net.state0._replace(weights=w)
        return _timed_run(net, TICKS, cpu)[1]

    jobs = {
        "watch/plastic": (4, lambda: watched(
            (wat.NonFinite(weight_stride=100), wat.WeightDrift()), policy="fp16",
            propagation="sparse", stdp_chain=CHAIN_STDP)),
        "prec/coba": (3, lambda: _timed_run(_coba_net(SYNFIRE4, "bf16", "sparse", cpu), TICKS,
                                            cpu)),
        "prec/int8": (2, int8),
    }
    for propagation in ("packed", "sparse"):
        jobs[f"prec/plastic/{propagation}"] = (5, lambda p=propagation: _timed_run(
            build_synfire(SYNFIRE4, policy="bf16", propagation=p, device=cpu,
                          stdp_chain=CHAIN_STDP), TICKS, cpu))
        for backend in (None, "fused"):
            jobs[f"prec/{propagation}/{backend}"] = (2, lambda p=propagation, b=backend: (
                _timed_run(build_synfire(SYNFIRE4, policy="bf16", propagation=p, device=cpu,
                                         backend=b), TICKS, cpu)))
            for policy in ("fp16", "fp32"):
                jobs[f"mon/{policy}/{propagation}/{backend}"] = (
                    2, lambda p=propagation, q=policy, b=backend: monitored(q, p, b))
                jobs[f"watch/{policy}/{propagation}/{backend}"] = (
                    2, lambda p=propagation, q=policy, b=backend: watched(
                        "default", policy=q, propagation=p, backend=b))
    return jobs



def _ref_path(root, name: str) -> Path:
    return Path(root) / (name.replace("/", "__") + ".pt")


def cpu_ref(name: str):
    """The CPU port's reference ``name`` (:func:`_ref_jobs`): read from the
    reference processes' directory when the whole script runs (waiting for
    it if it is not there yet), else computed here."""
    root = os.environ.get(REFS_ENV)
    if not root:
        return _ref_jobs()[name][1]()
    path, t0 = _ref_path(root, name), time.perf_counter()
    while not path.exists():
        require(time.perf_counter() - t0 < REF_TIMEOUT, f"CPU reference {name} never came")
        time.sleep(0.2)
    return torch.load(path, weights_only=False)


def _refs_main(root: str, index: int, procs: int) -> int:
    """``--cpu-refs DIR I N``: the references of the I-th of N shares
    (greedy by cost), each written to DIR as it is done."""
    torch.set_num_threads(REF_THREADS)
    jobs = _ref_jobs()
    loads, mine = [0] * procs, []
    for name in sorted(jobs, key=lambda n: (-jobs[n][0], n)):
        i = loads.index(min(loads))
        loads[i] += jobs[name][0]
        if i == index:
            mine.append(name)
    for name in mine:
        t0 = time.perf_counter()
        out = jobs[name][1]()
        tmp = _ref_path(root, name).with_suffix(".tmp")
        torch.save(out, tmp)
        os.replace(tmp, _ref_path(root, name))
        log(f"[refs] {name} in {time.perf_counter() - t0:.1f} s")
    return 0


def _require_same_raster(card, cpu, what):
    if not torch.equal(card, cpu):
        first = int(torch.nonzero((card != cpu).any(dim=1))[0])
        raise AssertionError(f"{what}: card raster differs from the CPU raster "
                             f"first at tick {first}")


def _card_run(cfg, policy, propagation, gen_u, ticks, dev, backend=None, net=None, **build_kw):
    """The main path on the card for ``ticks`` ticks (timed, launch counts
    reset just before and read just after), on ``gen_u`` or, when it is
    None, the default generator stream; on ``net`` when given (built
    otherwise)."""
    from repro_torch.configs.synfire4 import build_synfire
    from repro_torch.core.engine import run
    from repro_torch.kernels import ops

    if net is None:
        net = build_synfire(cfg, policy=policy, propagation=propagation, device=dev,
                            backend=backend, **build_kw)
    gu = None if gen_u is None else gen_u.to(dev)
    run(net.static, net.params, net.state0, 20,
        gen_u=None if gu is None else gu[:20])  # warm-up
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    _, out = run(net.static, net.params, net.state0, ticks, gen_u=gu)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return net, out["spikes"].cpu(), dict(ops.LAUNCHES), seconds


def _cpu_raster(cfg, policy, propagation, gen_u, ticks, **build_kw):
    from repro_torch.configs.synfire4 import build_synfire
    from repro_torch.core.engine import run

    net = build_synfire(cfg, policy=policy, propagation=propagation, device="cpu",
                        **build_kw)
    _, out = run(net.static, net.params, net.state0, ticks, gen_u=gen_u)
    return out["spikes"]


def _card_and_cpu_rasters(cfg, policy, propagation, gen_u, dev, ref: str, **build_kw):
    """The main path on the card on both backends for ``len(gen_u)`` ticks
    and the same network with the same uniforms on the CPU (the reference
    ``ref``); raises unless every card raster equals the CPU raster.
    Returns per backend ``(net, raster, launches, seconds)``."""
    ticks = gen_u.shape[0]
    cpu = cpu_ref(ref)
    out = {}
    for backend in (None, "fused"):
        out[backend] = _card_run(cfg, policy, propagation, gen_u, ticks, dev,
                                 backend=backend, **build_kw)
        _require_same_raster(out[backend][1], cpu, f"{cfg.name} {policy}/"
                             f"{propagation} backend={backend}")
    return out


NOT_ON_PATH = {"stdp_update": 0, "stdp_gather": 0, "plastic_drive": 0,
               "flash_attention": 0, "flash_attention_bwd": 0}  # of a static tick


def _fused_launches(ticks: int) -> dict:
    return {"izh4_update": 0, "syn_matmul": 0, "syn_gather": 0, "fused_tick": ticks,
            **NOT_ON_PATH}


def _add(totals: dict, launches: dict) -> None:
    for k, v in launches.items():
        totals[k] += v


def phase_synfire(dev, totals: dict) -> dict:
    from repro_torch.configs.synfire4 import SYNFIRE4

    gen_u = _uniforms("synfire")
    paths, counts = {}, {}
    for propagation in ("packed", "sparse"):
        for policy in ("fp16", "fp32"):
            runs = _card_and_cpu_rasters(SYNFIRE4, policy, propagation, gen_u, dev,
                                         f"synfire/{policy}/{propagation}")
            for backend, (net, sp, launches, seconds) in runs.items():
                _add(totals, launches)
                kinds = [b.kind for b in net.static.buckets]
                expect = _fused_launches(TICKS) if backend else {
                    "izh4_update": TICKS, "syn_matmul": kinds.count("dense") * TICKS,
                    "syn_gather": TICKS if "sparse" in kinds else 0, "fused_tick": 0,
                    **NOT_ON_PATH}
                require(launches == expect, f"launches {launches} != {expect}")
                require(kinds.count("dense" if propagation == "packed" else "sparse")
                        == (8 if propagation == "packed" else 13), f"plan {kinds}")
                total = int(sp.sum())
                rate = total / (net.n_neurons * TICKS) * 1000.0
                require(20_000 <= total <= 33_000, f"{total} spikes outside 20k-33k")
                require(17.0 <= rate <= 29.0, f"mean rate {rate:.2f} Hz outside 17-29")
                counts[(policy, propagation)] = total
                key = f"synfire4/{policy}/{propagation}" + ("/fused" if backend else "")
                paths[key] = {"us_per_tick": seconds / TICKS * 1e6, "spikes": total,
                              "rate_hz": rate, "launches": launches,
                              "raster_equals_cpu": True}
                log(f"[synfire4] {policy}/{propagation} backend={backend}: {total} "
                    f"spikes, {rate:.2f} Hz, {seconds / TICKS * 1e6:.1f} us/tick, "
                    f"launches {launches}, card raster == CPU raster")
        acc = (min(counts[("fp16", propagation)], counts[("fp32", propagation)])
               / max(counts[("fp16", propagation)], counts[("fp32", propagation)]))
        require(acc >= 0.97, f"fp16 spike-count accuracy {acc:.4f} < 0.97")
        paths[f"synfire4/fp16_accuracy/{propagation}"] = acc
    return paths


def phase_scale(dev, totals: dict) -> dict:
    from repro_torch.configs.synfire4 import SYNFIRE4_MINI, SYNFIRE4_X10

    paths = {}
    mini_ticks = MINI_TICKS
    mini_launches = {"izh4_update": mini_ticks, "syn_matmul": 8 * mini_ticks,
                     "syn_gather": 0, "fused_tick": 0, **NOT_ON_PATH}

    def died_out(sp, what):
        total, tail = int(sp.sum()), int(sp[-1000:].sum())
        require(150 <= total <= 900 and tail == 0,
                f"mini {what}: {total} spikes, {tail} in the last second "
                f"(want 150-900, 0)")
        return total, tail

    def mini_path(key, backend, sp, launches, seconds, what):
        want = _fused_launches(mini_ticks) if backend else mini_launches
        require(launches == want, f"mini launches {launches} != {want}")
        _add(totals, launches)
        total, tail = died_out(sp, what)
        paths[key] = {"us_per_tick": seconds / mini_ticks * 1e6, "spikes": total,
                      "last_second_spikes": tail, "launches": launches,
                      "raster_equals_cpu": True}
        log(f"[mini] {mini_ticks} ticks, {what}, backend={backend}: {total} spikes, "
            f"silent last second, {seconds / mini_ticks * 1e6:.1f} us/tick, "
            f"launches {launches}, card raster == CPU raster")

    # The default generator stream (the reference's threefry draws), as
    # Engine.run draws it: the card's raster equals the CPU's.
    cpu = cpu_ref("mini/default")
    for backend in (None, "fused"):
        _, sp, launches, seconds = _card_run(SYNFIRE4_MINI, "fp16", "packed", None,
                                             mini_ticks, dev, backend=backend)
        _require_same_raster(sp, cpu, f"mini default stream backend={backend}")
        mini_path("synfire4_mini/fp16/packed" + ("/fused" if backend else ""),
                  backend, sp, launches, seconds, "default stream")

    # Injected uniforms.
    gen_u = _uniforms("mini")
    for backend, (_, sp, launches, seconds) in _card_and_cpu_rasters(
            SYNFIRE4_MINI, "fp16", "packed", gen_u, dev, "mini/injected").items():
        mini_path("synfire4_mini/fp16/packed/injected" + ("/fused" if backend else ""),
                  backend, sp, launches, seconds, "injected uniforms")

    gen_u = _uniforms("x10")
    x10_launches = {"izh4_update": TICKS, "syn_matmul": 0, "syn_gather": TICKS,
                    "fused_tick": 0, **NOT_ON_PATH}
    for backend, (net, sp, launches, seconds) in _card_and_cpu_rasters(
            SYNFIRE4_X10, "fp16", "sparse", gen_u, dev, "x10", **X10_BUILD).items():
        _add(totals, launches)
        rate = int(sp.sum()) / (net.n_neurons * TICKS) * 1000.0
        require(17.0 <= rate <= 29.0, f"x10 mean rate {rate:.2f} Hz outside 17-29")
        want = _fused_launches(TICKS) if backend else x10_launches
        require(launches == want, f"x10 launches {launches} != {want}")
        paths["synfire4_x10/fp16/sparse" + ("/fused" if backend else "")] = {
            "us_per_tick": seconds / TICKS * 1e6, "spikes": int(sp.sum()),
            "rate_hz": rate, "synapse_bytes": net.ledger.synapse_bytes(),
            "launches": launches, "raster_equals_cpu": True}
        log(f"[x10] sparse fp16 backend={backend}: {int(sp.sum())} spikes, "
            f"{rate:.2f} Hz, {seconds / TICKS * 1e6:.1f} us/tick, synapse bytes "
            f"{net.ledger.synapse_bytes()}, launches {launches}, card raster == "
            f"CPU raster")
    paths.update(_phase_x100(dev, totals))
    return paths


X100_TICKS = 1000


def _phase_x100(dev, totals: dict) -> dict:
    """Synfire4x100 (N = 120,000) fp16 sparse for X100_TICKS ticks on both
    backends: two independent kernel paths (izh4_update and one syn_gather
    launch over the 13 CSR buckets per tick, against one fused_tick per
    tick on a grid of many CTAs), whose rasters must be equal bit for bit;
    the gather launcher against its plain version on the x100 tables, and
    staged against unstaged on its longest pre row; then fused_tick against
    its plain version on a x100 state and the fused design's numbers
    there."""
    from repro_torch.configs.synfire4 import SYNFIRE4, scale_synfire

    import dataclasses

    from repro_torch.configs.synfire4 import build_synfire

    cfg = scale_synfire(SYNFIRE4, 100)
    g = torch.Generator(device="cpu").manual_seed(43)
    gen_u = torch.rand((X100_TICKS, cfg.n_stim), generator=g)
    paths, rasters, nets = {}, {}, {}
    # One build (about 30 s on the host): a fused compile is the default
    # compile plus its fused plan, so the default net is it without the plan.
    t0 = time.perf_counter()
    fused = build_synfire(cfg, policy="fp16", propagation="sparse", device=dev, backend="fused",
                          budget=None, monitor_ms_hint=0)
    build_s = time.perf_counter() - t0
    built = {"fused": fused, None: dataclasses.replace(
        fused, static=dataclasses.replace(fused.static, backend=None, fused=None))}
    for backend in (None, "fused"):
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        net, sp, launches, seconds = _card_run(cfg, "fp16", "sparse", gen_u, X100_TICKS,
                                               dev, backend=backend, net=built[backend])
        total_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(dev)
        kinds = [b.kind for b in net.static.buckets]
        require(net.static.n == 120_000 and kinds.count("sparse") == 13,
                f"x100 plan: N={net.static.n}, buckets {kinds}")
        want = _fused_launches(X100_TICKS) if backend else {
            "izh4_update": X100_TICKS, "syn_matmul": 0, "syn_gather": X100_TICKS,
            "fused_tick": 0, **NOT_ON_PATH}
        require(launches == want, f"x100 launches {launches} != {want}")
        _add(totals, launches)
        total = int(sp.sum())
        rate = total / (net.n_neurons * X100_TICKS) * 1000.0
        require(17.0 <= rate <= 29.0, f"x100 mean rate {rate:.2f} Hz outside 17-29")
        rasters[backend], nets[backend] = sp, net
        longest = max(b.p for b in net.static.buckets)
        key = "synfire4_x100/fp16/sparse" + ("/fused" if backend else "")
        paths[key] = {"us_per_tick": seconds / X100_TICKS * 1e6, "spikes": total,
                      "rate_hz": rate, "n": net.static.n, "longest_pre": longest,
                      "synapse_bytes": net.ledger.synapse_bytes(),
                      "peak_device_bytes": peak, "build_s": build_s, "runs_s": total_s,
                      "launches": launches}
        log(f"[x100] sparse fp16 backend={backend}: N={net.static.n}, {total} spikes, "
            f"{rate:.2f} Hz, {seconds / X100_TICKS * 1e6:.1f} us/tick, longest pre row "
            f"{longest}, synapse bytes {net.ledger.synapse_bytes()}, peak device memory "
            f"{peak} B, build (shared) {build_s:.1f} s, runs {total_s:.1f} s, launches {launches}")
    _require_same_raster(rasters["fused"], rasters[None], "x100 fused vs default backend")
    log("[x100] the fused raster equals the default backend's bit for bit")
    paths["synfire4_x100/fp16/sparse"]["monitors"] = _x100_monitored(
        nets[None], gen_u, rasters[None], dev, totals)
    for i_ext, records in ((False, False), (True, True)):
        _hold_neuron_run(nets[None], g, dev, i_ext, records, "SYNFIRE4_X100 fp16")
    paths["synfire4_x100/fp16/sparse"]["neuron_run"] = _neuron_run_row(
        nets[None], g, dev, "Synfire4x100 fp16")
    row = _check_gather_run(dev, g, nets[None], "SYNFIRE4_X100", staged_fits=False)
    row["staged"] = ("not possible: the 120,000-entry f32 spike row (480,000 B) exceeds a "
                     "CTA's shared memory")
    row["one_bucket"] = _staged_one_bucket(dev, nets[None])
    paths["synfire4_x100/fp16/sparse"]["gather_run"] = row
    net = nets["fused"]
    net, state, payload, args = _fused_state(None, None, None, dev, {}, net=net)
    spiked = _hold_fused(net, state, payload, args, g, "SYNFIRE4_X100 fp16/sparse")
    design = _fused_design(net, payload, args)
    b_ms, b_by = fused_bound(payload, _fused_kernel_tick(args, state.t + CHAINED,
                                                         payload)[2],
                             net.static.n, args[0].element_size())
    paths["synfire4_x100/fp16/sparse/fused"].update(
        fused_design=design, tick_bound_us=b_ms * 1e3, tick_bound_by=b_by)
    log(f"[x100] fused_tick: {CHAINED} ticks bitwise against the plain version "
        f"({spiked} neuron spikes); grid {design['grid']} CTAs (of "
        f"{design['resident_ctas']} resident), barrier {design['barrier_us']:.2f} us, "
        f"{design['us_per_tick_grid']:.2f} us/tick on the grid vs "
        f"{design['us_per_tick_one_cta']:.2f} on one CTA; bound {b_ms * 1e3:.3f} us ({b_by})")
    return paths


def _x100_monitored(net, gen_u, raster, dev, totals) -> dict:
    """Phase 9 on the x100 net built for phase 4 (default backend): the same
    uniforms under ``record="monitors"`` (no [T, N] raster), its peak device
    memory beside the raster run's, and its streamed group rates equal to
    the raster's post-hoc ones, dict for dict."""
    from repro_torch.core.engine import run
    from repro_torch.core.monitors import group_rates
    from repro_torch.kernels import ops
    from repro_torch.telemetry import summarize

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launches()
    t0 = time.perf_counter()
    _, out = run(net.static, net.params, net.state0, X100_TICKS, gen_u=gen_u.to(dev),
                 record="monitors")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    launches = dict(ops.LAUNCHES)
    want = {"izh4_update": X100_TICKS, "syn_matmul": 0, "syn_gather": X100_TICKS,
            "fused_tick": 0, **NOT_ON_PATH}
    require(launches == want, f"x100 monitors launches {launches} != {want}")
    _add(totals, launches)
    require(set(out) == {"telemetry"}, f"x100 monitors outputs {set(out)}")
    s = summarize(net.static, out["telemetry"], X100_TICKS)
    require(s["group_rates"] == group_rates(net.static, raster),
            "x100: streamed group rates differ from the raster's")
    log(f"[x100] record='monitors': group rates == the raster run's, {s['total_spikes']} "
        f"spikes, {seconds / X100_TICKS * 1e6:.1f} us/tick, peak device memory {peak} B "
        f"(the raster alone: {raster.numel()} B)")
    return {"us_per_tick": seconds / X100_TICKS * 1e6, "peak_device_bytes": peak,
            "spikes": s["total_spikes"], "launches": launches}


def _staged_one_bucket(dev, net) -> dict:
    """x100's bucket with the longest pre row (20,000 f32, 80,000 B: it
    fits shared memory) alone over its own pre row, as the per-bucket path
    ran it: the gather kernel staged against unstaged, device time in the
    same run, bit for bit equal."""
    import numpy as np

    from repro_torch.core import backend as be
    from repro_torch.kernels import syn_gather as gsyn

    static, params = net.static, net.params
    packed = be.assemble_packed(static, net.state0.weights)
    bi = max(range(len(static.buckets)), key=lambda i: static.buckets[i].p)
    b = static.buckets[bi]
    plan = gsyn.GatherPlan(b.p, [gsyn.Bucket(b.delay_ms, np.arange(b.q), (
        np.arange(b.p), params.bucket_csr_idx[bi], packed[bi]))])
    spikes = (torch.rand(b.p, device=dev) < 0.3).float()
    ptr = spikes.data_ptr()
    runs = {k: gsyn.GatherLauncher(plan, dev, staged=k == "staged")
            for k in ("unstaged", "staged")}
    for r in runs.values():
        r(0, ptr)
    torch.cuda.synchronize()
    require(torch.equal(runs["staged"].rows, runs["unstaged"].rows),
            "x100 one bucket: staged and unstaged gathers differ")
    out = {"bucket": bi, "p": b.p, "q": b.q, "f": b.fanin,
           **{f"{k}_device_ms": device_ms(lambda r=r: r(0, ptr), "gather_kernel")
              for k, r in runs.items()}}
    log(f"[x100] one bucket (P={b.p}, Q={b.q}, F={b.fanin}): unstaged "
        f"{out['unstaged_device_ms'] * 1e3:.2f} us, staged "
        f"{out['staged_device_ms'] * 1e3:.2f} us on the device, equal sums")
    return out


HOMEO = dict(target_hz=10.0, tau_avg_ms=1000.0, beta=2.0)  # visible within 1 s


def _plastic_run(cfg, policy, propagation, gen_u, dev, backend=None, **build_kw):
    """Plastic Synfire (``CHAIN_STDP`` on the exc->exc chain) through
    ``build_synfire`` and ``run`` on ``dev`` for ``len(gen_u)`` ticks. On the
    card it is warmed up, then timed with the launch counts reset just
    before and read just after. Returns (net, raster, final state,
    launches or None, seconds)."""
    from repro_torch.configs.synfire4 import CHAIN_STDP, build_synfire
    from repro_torch.core.engine import run
    from repro_torch.kernels import ops

    net = build_synfire(cfg, policy=policy, propagation=propagation, device=dev,
                        backend=backend, stdp_chain=CHAIN_STDP, **build_kw)
    gu = gen_u.to(dev)
    card = dev.type == "cuda"
    if card:
        warm = net.static.homeo_period or 20
        run(net.static, net.params, net.state0, warm, gen_u=gu[:warm])
        torch.cuda.synchronize()
        ops.reset_launches()
    t0 = time.perf_counter()
    final, out = run(net.static, net.params, net.state0, gen_u.shape[0], gen_u=gu)
    if card:
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return (net, out["spikes"].cpu(), final, dict(ops.LAUNCHES) if card else None,
            seconds)


def _chain(net) -> list[int]:
    return [j for j, c in enumerate(net.static.stdp) if c is not None]


def _require_same_plastic_state(card, cpu, what):
    """The card's final plastic weights, traces and homeostasis rates equal
    those of ``cpu`` (a CPU port run, or another card run) bit for bit."""
    net, final = card[0], card[2]
    cpu_final = cpu[2]
    for j in _chain(net):
        for name, a, b in [("weights", final.weights[j], cpu_final.weights[j])] + [
                (f"stdp.{f}", getattr(final.stdp[j], f), getattr(cpu_final.stdp[j], f))
                for f in final.stdp[j]._fields]:
            a, b = a.cpu(), b.cpu()
            require(torch.equal(a, b), f"{what}: card {name} of projection {j} "
                    f"differ from the CPU's, max abs err {max_err(a, b)}")
    for j, h in enumerate(final.homeo):
        if h is not None:
            require(torch.equal(h.cpu(), cpu_final.homeo[j].cpu()),
                    f"{what}: card homeostasis rates of projection {j} differ")


def _dense_chain(net, final) -> dict:
    """The chain's final weights as dense f32 images (CSR rows scattered)."""
    from repro_torch.core.synapses import CSRFanin, csr_to_dense

    out = {}
    for j in _chain(net):
        w = final.weights[j]
        if j in net.static.csr_projs:
            out[j] = csr_to_dense(CSRFanin(net.params.proj_csr_idx[j], w,
                                           net.params.masks[j]),
                                  net.static.projections[j].pre_size)
        else:
            out[j] = w.float().cpu().numpy()
    return out


def _plastic_launches(net, ticks: int) -> dict:
    kinds = [b.kind for b in net.static.buckets]
    chain = len(_chain(net))
    csr = sum(j in net.static.csr_projs for j in _chain(net))
    return {"izh4_update": ticks, "syn_matmul": kinds.count("dense") * ticks,
            "syn_gather": ticks if "sparse" in kinds else 0, "fused_tick": 0,
            "stdp_update": ticks if chain - csr else 0, "stdp_gather": ticks if csr else 0,
            "plastic_drive": ticks, "flash_attention": 0, "flash_attention_bwd": 0}


def phase_plastic(dev, totals: dict) -> dict:
    """Plastic Synfire4 on the card against the CPU port (see phase 5 of the
    module's docstring)."""
    import numpy as np

    from repro_torch.configs.synfire4 import SYNFIRE4, SYNFIRE4_X10
    from repro_torch.memory import MCU_BUDGET_BYTES

    gen_u = _uniforms("plastic")
    paths, images, card_runs = {}, {}, {}

    def record(key, card, cpu, extra=None):
        net, sp, final, launches, seconds = card
        _require_same_raster(sp, cpu[1], key)
        _require_same_plastic_state(card, cpu, key)
        want = _plastic_launches(net, sp.shape[0])
        require(launches == want, f"{key}: launches {launches} != {want}")
        _add(totals, launches)
        moved = sum(int((final.weights[j].cpu() != net.state0.weights[j].cpu()).sum())
                    for j in _chain(net))
        require(moved > 0, f"{key}: no plastic weight moved")
        total = int(sp.sum())
        rate = total / (net.n_neurons * sp.shape[0]) * 1000.0
        require(17.0 <= rate <= 29.0, f"{key}: mean rate {rate:.2f} Hz outside 17-29")
        paths[key] = {"us_per_tick": seconds / sp.shape[0] * 1e6, "spikes": total,
                      "rate_hz": rate, "plastic_weights_moved": moved,
                      "launches": launches, "raster_equals_cpu": True,
                      "weights_equal_cpu": True, "cpu_us_per_tick": cpu[4] / sp.shape[0] * 1e6,
                      **(extra or {})}
        log(f"[plastic] {key}: {total} spikes, {rate:.2f} Hz, {moved} plastic weights "
            f"moved, {seconds / sp.shape[0] * 1e6:.1f} us/tick (CPU port "
            f"{cpu[4] / sp.shape[0] * 1e6:.1f}), launches {launches}, card raster "
            "and weights == CPU")

    for propagation in ("packed", "sparse"):
        for policy in ("fp16", "fp32"):
            cpu = cpu_ref(f"plastic/{policy}/{propagation}")
            card = _plastic_run(SYNFIRE4, policy, propagation, gen_u, dev)
            record(f"synfire4_plastic/{policy}/{propagation}", card, cpu)
            images[(policy, propagation)] = _dense_chain(card[0], card[2])
            card_runs[(policy, propagation)] = card
    for policy in ("fp16", "fp32"):
        for j, img in images[(policy, "packed")].items():
            require(np.array_equal(img, images[(policy, "sparse")][j]),
                    f"plastic {policy}: packed and sparse weights of projection {j} differ")
        require(torch.equal(card_runs[(policy, "packed")][1], card_runs[(policy, "sparse")][1]),
                f"plastic {policy}: packed and sparse rasters differ")
        log(f"[plastic] {policy}: packed and sparse rasters and chain weights bitwise equal")

    homeo = _homeo()
    for propagation in ("sparse", "packed"):
        cpu = cpu_ref(f"plastic_homeo/{propagation}")
        card = _plastic_run(SYNFIRE4, "fp16", propagation, gen_u, dev, **homeo)
        record(f"synfire4_plastic_homeo/fp16/{propagation}", card, cpu)
        scaled = card_runs[("fp16", propagation)][2]
        require(any(not torch.equal(card[2].weights[j], scaled.weights[j])
                    for j in _chain(card[0])),
                f"homeostasis ({propagation}) moved no weight beyond STDP")

    gen_u10 = _uniforms("plastic_x10")
    x10 = _plastic_x10_build()
    cpu = cpu_ref("plastic_x10")
    card = _plastic_run(SYNFIRE4_X10, "fp16", "sparse", gen_u10, dev, **x10)
    used = card[0].ledger.total_used
    require(used <= MCU_BUDGET_BYTES, f"plastic x10: ledger {used} > {MCU_BUDGET_BYTES}")
    record("synfire4_x10_plastic/fp16/sparse", card, cpu,
           {"ledger_bytes": used, "budget_bytes": MCU_BUDGET_BYTES})

    for propagation in ("packed", "sparse"):
        key = f"synfire4_plastic/fp16/{propagation}/fused"
        net, sp, final, launches, seconds = _plastic_run(SYNFIRE4, "fp16", propagation,
                                                          gen_u, dev, backend="fused")
        require(not net.static.fused_kernel, f"{key}: plastic net planned as one kernel")
        plain = card_runs[("fp16", propagation)]
        _require_same_raster(sp, plain[1], f"{key} vs the default backend")
        _require_same_plastic_state((net, sp, final), plain, f"{key} vs the default backend")
        want = _plastic_launches(net, TICKS)
        require(launches == want, f"{key}: launches {launches} != {want}")
        _add(totals, launches)
        paths[key] = {"us_per_tick": seconds / TICKS * 1e6, "spikes": int(sp.sum()),
                      "launches": launches, "raster_equals_default_backend": True}
        log(f"[plastic] {key}: no fused_tick launch, raster and weights == default "
            f"backend, {seconds / TICKS * 1e6:.1f} us/tick, launches {launches}")
    return paths


# -- COBA synapses and run's serving arguments (A5) -------------------------------------


def _coba_net(cfg, policy, propagation, dev, backend=None, stdp_chain=None,
              budget=None, monitor_ms_hint=1000):
    """Synfire's Table II network (``configs/synfire4._synfire_builder``, what
    ``build_synfire`` compiles) compiled with ``conductances=COBAConfig()``."""
    from repro_torch.configs import synfire4 as tsyn
    from repro_torch.core import COBAConfig
    from repro_torch.memory import MemoryLedger

    return tsyn._synfire_builder(cfg, stdp_chain=stdp_chain).compile(
        policy=policy, propagation=propagation, backend=backend, conductances=COBAConfig(),
        ledger=MemoryLedger(budget=budget, name=f"{cfg.name}/{policy}/coba"),
        monitor_ms_hint=monitor_ms_hint, device=dev)


def _timed_run(net, ticks, dev, **kw):
    """``run`` of ``net`` for ``ticks`` ticks from its state0 on the default
    generator stream; on the card warmed up first, timed, the launch counts
    reset just before and read just after. Returns (final, raster,
    launches or None, seconds)."""
    from repro_torch.core.engine import run
    from repro_torch.kernels import ops

    card = dev.type == "cuda"
    if card:
        warm = net.static.homeo_period or 20
        run(net.static, net.params, net.state0, warm)
        torch.cuda.synchronize()
        ops.reset_launches()
    t0 = time.perf_counter()
    final, out = run(net.static, net.params, net.state0, ticks, **kw)
    if card:
        torch.cuda.synchronize()
    return (final, out["spikes"].cpu(), dict(ops.LAUNCHES) if card else None,
            time.perf_counter() - t0)


def _require_same_state(a, b, what, plastic=()):
    """Two final NetStates equal bit for bit: v, u, refrac, ring, the
    conductances and key, and the weights and STDP traces of the projections
    in ``plastic``."""
    pairs = [("v", a.neurons.v, b.neurons.v), ("u", a.neurons.u, b.neurons.u),
             ("refrac", a.neurons.refrac, b.neurons.refrac), ("ring", a.ring, b.ring),
             ("key", a.key, b.key)]
    if a.cond is not None or b.cond is not None:
        pairs += [(f"cond.{f}", x, y) for f, x, y in zip(a.cond._fields, a.cond, b.cond)]
    for j in plastic:
        pairs.append((f"weights.{j}", a.weights[j], b.weights[j]))
        if a.stdp[j] is not None:
            pairs += [(f"stdp.{j}.{f}", x, y)
                      for f, x, y in zip(a.stdp[j]._fields, a.stdp[j], b.stdp[j])]
    for name, x, y in pairs:
        x, y = x.cpu(), y.cpu()
        require(x.dtype == y.dtype and torch.equal(x, y),
                f"{what}: {name} differs, max abs err {max_err(x, y)}")


def _events_per_tick(net, ticks: int = 20) -> float:
    """Device events per tick of a ``ticks``-tick run on injected uniforms
    (its set-up included) under ``torch.profiler``, as phase 7 counts them."""
    from repro_torch.core.engine import run

    gu = torch.rand((ticks, net.static.n_gen), device=net.state0.ring.device)
    return len(_cuda_events(lambda: run(net.static, net.params, net.state0, ticks, gen_u=gu),
                            1)) / ticks


def _static_launches(net, ticks: int) -> dict:
    kinds = [b.kind for b in net.static.buckets]
    return {"izh4_update": ticks, "syn_matmul": kinds.count("dense") * ticks,
            "syn_gather": ticks if "sparse" in kinds else 0, "fused_tick": 0,
            **NOT_ON_PATH}


def _check_gather_channels(dev, g) -> dict:
    """``ops.GatherRun`` on a two-channel (COBA) plan against its plain
    version, bit for bit: an excitatory and an inhibitory bucket sharing a
    delay and post columns, two excitatory buckets sharing entries, a
    bucket of another delay, and a dense bucket between them (a second
    launch group), on weights of both signs that are multiples of 1/4 (so
    every sum is exact) in f32 and fp16; each bucket's drive enters as
    its absolute value."""
    import numpy as np

    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import syn_gather as gsyn

    n, f = 300, 7

    def table(q, wdt):
        idx = torch.randint(0, 100, (q, f), generator=g, dtype=torch.int16)
        w = (torch.randint(-16, 17, (q, f), generator=g).float() / 4).to(wdt)
        return (np.arange(100, 200), idx.to(dev), w.to(dev))

    for wdt in (torch.float32, torch.float16):
        buckets = [gsyn.Bucket(3, np.arange(0, 100), table(100, wdt), 0),
                   gsyn.Bucket(3, np.arange(0, 100), table(100, wdt), 1),
                   gsyn.Bucket(3, np.arange(50, 150), table(100, wdt), 0),
                   gsyn.Bucket(5, np.arange(200, 300), table(100, wdt), 0),
                   gsyn.Bucket(3, np.arange(40, 60), None, 0),
                   gsyn.Bucket(3, np.arange(55, 85), table(30, wdt), 0)]
        run = ops.GatherRun(n, buckets, dev, channels=2)
        require(run.keys == ((3, 0), (3, 1), (5, 0), (5, 1)) and len(run.starts) == 2,
                f"GatherRun COBA plan: keys {run.keys}, starts {run.starts}")
        want = torch.empty_like(run.rows)
        plain = [[(k, posts.to(dev), gidx.to(dev), w) for k, posts, gidx, w in grp]
                 for grp in run.plan.plain]
        for _ in range(3):
            spikes = (torch.rand(n, generator=g) < 0.5).float().to(dev)
            ops.reset_launches()
            for grp in range(len(run.starts)):
                run(grp, spikes)
                ref.gather_run_ref(spikes, want, plain[grp], first=grp == 0, absolute=True)
            torch.cuda.synchronize()
            require(ops.LAUNCHES["syn_gather"] == 2, "GatherRun COBA: launches "
                    f"{ops.LAUNCHES['syn_gather']} for 2 groups")
            _require_bitwise(run.rows, want, f"GatherRun COBA {wdt}")
            require(bool((want >= 0).all()) and float(want.sum()) > 0,
                    "GatherRun COBA: rows not non-negative magnitudes")
    log("[kernels] GatherRun two channels (exc + inh sharing a delay and posts, exc "
        "buckets sharing entries, two launch groups), f32 and fp16: bitwise against its "
        "plain version, |drive| per bucket")
    return {"channel_plan": "exc+inh on one delay and posts, shared exc entries, "
                            "two groups: bitwise"}


def _coba_gather_row(dev, g, net) -> dict:
    """``ops.GatherRun`` on a compiled COBA Synfire4 sparse net's tables
    (13 buckets, rows keyed by (delay, channel)): bit for bit against its
    plain version on random spike rows and timed as the CUBA row is."""
    from repro_torch.core import backend as be
    from repro_torch.kernels import ops, ref

    static, params = net.static, net.params
    packed = be.assemble_packed(static, net.state0.weights)
    run = be.assemble_gather(static, params, packed)
    require(len(run.starts) == 1 and len(run.plan.groups[0]) == 13
            and len(run.keys) == 2 * len(run.delays),
            f"COBA gather plan {run.plan.groups}, keys {run.keys}")
    plain = [(k, posts.to(dev), gidx.to(dev), w) for k, posts, gidx, w in run.plan.plain[0]]
    want = torch.empty_like(run.rows)
    for _ in range(3):
        spikes = (torch.rand(static.n, generator=g) < 0.3).float().to(dev)
        ops.reset_launches()
        run(0, spikes)
        ref.gather_run_ref(spikes, want, plain, first=True, absolute=True)
        torch.cuda.synchronize()
        require(ops.LAUNCHES["syn_gather"] == 1, "COBA GatherRun: one launch a tick")
        _require_bitwise(run.rows, want, "COBA GatherRun Synfire4")
    plan = run.plan
    ptr = spikes.data_ptr()
    b_ms, b_by = bound(nbytes(plan.idx, plan.w) + static.n * 4 + nbytes(run.rows),
                       3 * int(plan.idx.numel()))
    out = {"shape": f"COBA Synfire4 tick: 13 CSR buckets, {int(plan.idx.numel())} "
                    f"entries, keys {run.keys}, one launch",
           "ms": cuda_ms(lambda: run(0, spikes)),
           "device_ms": device_ms(lambda: run.launcher(0, ptr), "gather_kernel"),
           "plain_ms": cuda_ms(lambda: ref.gather_run_ref(spikes, want, plain, first=True,
                                                          absolute=True), reps=20, warmup=3),
           "bound_ms": b_ms, "bound_by": b_by}
    log(f"[kernels] GatherRun COBA Synfire4: bitwise on 3 ticks; {out['ms'] * 1e3:.2f} us "
        f"per call, {out['device_ms'] * 1e3:.2f} us on the device, plain "
        f"{out['plain_ms'] * 1e3:.2f} us, bound {b_ms * 1e3:.4f} us ({b_by})")
    return out


def phase_coba_kernels(dev, rows: list) -> None:
    """COBA mode of B1 (``NeuronRun``) and B2 (``GatherRun``) on the card
    against their plain versions, and their numbers beside the CUBA
    mode's, into the izh4_update and syn_gather rows."""
    from repro_torch.configs.synfire4 import SYNFIRE4

    g = torch.Generator(device="cpu").manual_seed(29)
    row = {r["name"]: r for r in rows}
    for policy in ("fp16", "fp32"):
        net = _coba_net(SYNFIRE4, policy, "sparse", dev)
        for i_ext, records in ((False, False), (True, True)):
            _hold_neuron_run(net, g, dev, i_ext, records, f"COBA SYNFIRE4 {policy}")
    fp16 = _coba_net(SYNFIRE4, "fp16", "sparse", dev)
    nr = _neuron_run_row(fp16, g, dev, "COBA Synfire4 fp16")
    row["izh4_update"]["coba"] = nr
    log(f"[kernels] NeuronRun COBA Synfire4 fp16: {nr['ms'] * 1e3:.2f} us per call, "
        f"{nr['device_ms'] * 1e3:.2f} us on the device (CUBA: "
        f"{row['izh4_update']['ms'] * 1e3:.2f}, {row['izh4_update']['device_ms'] * 1e3:.2f}), "
        f"plain {nr['plain_ms'] * 1e3:.2f} us, bound {nr['bound_ms'] * 1e3:.4f} us")
    gr = _coba_gather_row(dev, g, fp16)
    gr.update(_check_gather_channels(dev, g))
    row["syn_gather"]["coba"] = gr
    log(f"[kernels] GatherRun COBA: {gr['ms'] * 1e3:.2f} us per call, "
        f"{gr['device_ms'] * 1e3:.2f} us on the device (CUBA: "
        f"{row['syn_gather']['ms'] * 1e3:.2f}, {row['syn_gather']['device_ms'] * 1e3:.2f})")


def phase_coba(dev, totals: dict) -> dict:
    """COBA Synfire4 (Table II compiled with ``conductances=COBAConfig()``)
    on the card against the CPU port, at 1,200 and 120,000 neurons, static
    and plastic, and on ``backend="fused"``."""
    import numpy as np

    from repro_torch.configs.synfire4 import CHAIN_STDP, SYNFIRE4, build_synfire, scale_synfire
    from repro_torch.core import backend as be

    paths, rasters = {}, {}
    for propagation in ("packed", "sparse"):
        for policy in ("fp16", "fp32"):
            key = f"synfire4_coba/{policy}/{propagation}"
            net = _coba_net(SYNFIRE4, policy, propagation, dev)
            final, sp, launches, seconds = _timed_run(net, TICKS, dev)
            cfinal, csp, _, cseconds = cpu_ref(f"coba/{policy}/{propagation}")
            _require_same_raster(sp, csp, key)
            _require_same_state(final, cfinal, f"{key} card vs CPU")
            want = _static_launches(net, TICKS)
            require(launches == want, f"{key}: launches {launches} != {want}")
            require(want["syn_matmul" if propagation == "packed" else "syn_gather"]
                    == (8 if propagation == "packed" else 1) * TICKS, f"{key}: plan")
            _add(totals, launches)
            events = _events_per_tick(net)
            rasters[key] = sp
            total = int(sp.sum())
            paths[key] = {"us_per_tick": seconds / TICKS * 1e6, "spikes": total,
                          "rate_hz": total / (net.n_neurons * TICKS) * 1000.0,
                          "launches": launches, "device_events_per_tick": events,
                          "cpu_us_per_tick": cseconds / TICKS * 1e6,
                          "raster_and_state_equal_cpu": True}
            log(f"[coba] {key}: {total} spikes, {seconds / TICKS * 1e6:.1f} us/tick (CPU "
                f"port {cseconds / TICKS * 1e6:.1f}), {events:.2f} device events per tick, "
                f"launches {launches}; card raster, v, u, refrac, ring and conductances == CPU")
            fnet = _coba_net(SYNFIRE4, policy, propagation, dev, backend="fused")
            require(not fnet.static.fused_kernel, f"{key}: COBA net planned as one kernel")
            ffinal, fsp, flaunches, fseconds = _timed_run(fnet, TICKS, dev)
            _require_same_raster(fsp, sp, f"{key}/fused vs the default backend")
            _require_same_state(ffinal, final, f"{key}/fused vs the default backend")
            require(flaunches == want, f"{key}/fused: launches {flaunches} != {want}")
            _add(totals, flaunches)
            paths[key + "/fused"] = {"us_per_tick": fseconds / TICKS * 1e6,
                                     "launches": flaunches,
                                     "raster_equals_default_backend": True}
            log(f"[coba] {key}/fused: no fused_tick launch, raster and state == default "
                f"backend, {fseconds / TICKS * 1e6:.1f} us/tick")
    for policy in ("fp16", "fp32"):
        require(torch.equal(rasters[f"synfire4_coba/{policy}/packed"],
                            rasters[f"synfire4_coba/{policy}/sparse"]),
                f"COBA {policy}: packed and sparse rasters differ")
    paths["synfire4/fp16/sparse/device_events_per_tick"] = _events_per_tick(
        build_synfire(SYNFIRE4, policy="fp16", propagation="sparse", device=dev))

    # x100: the launcher path against the per-op COBA phase, both on the card.
    cfg = scale_synfire(SYNFIRE4, 100)
    net = _coba_net(cfg, "fp16", "sparse", dev, monitor_ms_hint=0)
    torch.cuda.reset_peak_memory_stats(dev)
    final, sp, launches, seconds = _timed_run(net, TICKS, dev)
    peak = torch.cuda.max_memory_allocated(dev)
    want = _static_launches(net, TICKS)
    require(net.static.n == 120_000 and launches == want,
            f"COBA x100: N={net.static.n}, launches {launches} != {want}")
    _add(totals, launches)
    built = be.assemble_neurons
    be.assemble_neurons = _none
    try:
        pfinal, psp, _, pseconds = _timed_run(net, TICKS, dev)
    finally:
        be.assemble_neurons = built
    _require_same_raster(sp, psp, "COBA x100 launcher vs per-op phase")
    _require_same_state(final, pfinal, "COBA x100 launcher vs per-op phase")
    paths["synfire4_x100_coba/fp16/sparse"] = {
        "us_per_tick": seconds / TICKS * 1e6, "per_op_us_per_tick": pseconds / TICKS * 1e6,
        "spikes": int(sp.sum()), "n": net.static.n, "peak_device_bytes": peak,
        "launches": launches, "raster_and_state_equal_per_op": True}
    log(f"[coba] x100 fp16 sparse: N={net.static.n}, {int(sp.sum())} spikes, "
        f"{seconds / TICKS * 1e6:.1f} us/tick (per-op COBA phase "
        f"{pseconds / TICKS * 1e6:.1f}), peak device memory {peak} B, launches {launches}; "
        "launcher raster and state == per-op phase")

    # Plastic COBA: the chain's weights and traces too.
    images, prast = {}, {}
    for propagation in ("packed", "sparse"):
        key = f"synfire4_coba_plastic/fp16/{propagation}"
        net = _coba_net(SYNFIRE4, "fp16", propagation, dev, stdp_chain=CHAIN_STDP)
        final, sp, launches, seconds = _timed_run(net, TICKS, dev)
        cfinal, csp, _, _ = cpu_ref(f"coba_plastic/{propagation}")
        chain = _chain(net)
        _require_same_raster(sp, csp, key)
        _require_same_state(final, cfinal, f"{key} card vs CPU", plastic=chain)
        want = _plastic_launches(net, TICKS)
        require(launches == want, f"{key}: launches {launches} != {want}")
        _add(totals, launches)
        moved = sum(int((final.weights[j].cpu() != net.state0.weights[j].cpu()).sum())
                    for j in chain)
        require(moved > 0, f"{key}: no plastic weight moved")
        images[propagation], prast[propagation] = _dense_chain(net, final), sp
        paths[key] = {"us_per_tick": seconds / TICKS * 1e6, "spikes": int(sp.sum()),
                      "plastic_weights_moved": moved, "launches": launches,
                      "raster_weights_traces_equal_cpu": True}
        log(f"[coba] {key}: {int(sp.sum())} spikes, {moved} plastic weights moved, "
            f"{seconds / TICKS * 1e6:.1f} us/tick, launches {launches}; card raster, "
            "weights and traces == CPU")
    for j, img in images["packed"].items():
        require(np.array_equal(img, images["sparse"][j]),
                f"plastic COBA: packed and sparse weights of projection {j} differ")
    require(torch.equal(prast["packed"], prast["sparse"]),
            "plastic COBA: packed and sparse rasters differ")
    log("[coba] plastic fp16: packed and sparse rasters and chain weights bitwise equal")
    return paths


def phase_a5(dev, totals: dict) -> dict:
    """``run``'s ``gen_base``, ``gen_chunk`` and ``active`` and the loop
    oracle on Synfire4 on the card, against the CPU port and each other."""
    from repro_torch.configs.synfire4 import SYNFIRE4, build_synfire
    from repro_torch.core import rng
    from repro_torch.core.engine import run

    paths = {}
    sparse = lambda d, **kw: build_synfire(SYNFIRE4, policy="fp16",  # noqa: E731
                                           propagation="sparse", device=d, **kw)

    # gen_base: call-split invariance on the card, and card == CPU.
    net = sparse(dev)
    base = rng.key(A5_KEY_SEED, dev)
    final, sp, launches, seconds = _timed_run(net, TICKS, dev, gen_base=base)
    require(launches == _static_launches(net, TICKS), f"gen_base launches {launches}")
    _add(totals, launches)
    state, parts = net.state0, []
    for _ in range(4):
        state, out = run(net.static, net.params, state, TICKS // 4, gen_base=base)
        parts.append(out["spikes"].cpu())
    _require_same_raster(torch.cat(parts), sp, "gen_base 4 x 250 vs 1 x 1000")
    _require_same_state(state, final, "gen_base 4 x 250 vs 1 x 1000")
    require(torch.equal(final.key, net.state0.key), "gen_base moved the key")
    require(torch.equal(base.cpu(), rng.key(A5_KEY_SEED, torch.device("cpu"))), "gen_base key")
    cfinal, csp, _, _ = cpu_ref("a5/gen_base")
    _require_same_raster(sp, csp, "gen_base card vs CPU")
    _require_same_state(final, cfinal, "gen_base card vs CPU")
    paths["a5/gen_base/fp16/sparse"] = {"us_per_tick": seconds / TICKS * 1e6,
                                        "spikes": int(sp.sum()), "launches": launches}
    log(f"[a5] gen_base: run(1000) == 4 x run(250) bitwise on the card, == CPU port; "
        f"{int(sp.sum())} spikes, {seconds / TICKS * 1e6:.1f} us/tick")

    # gen_chunk: card == CPU, also with homeostasis every 100 ticks.
    for label, kw in (("static", {}), ("homeostasis", _homeo())):
        net = sparse(dev, **kw)
        final, sp, launches, seconds = _timed_run(net, TICKS, dev, gen_chunk=100)
        cfinal, csp, _, _ = cpu_ref(f"a5/gen_chunk/{label}")
        chain = [j for j, h in enumerate(net.static.homeo) if h is not None]
        _require_same_raster(sp, csp, f"gen_chunk {label}")
        _require_same_state(final, cfinal, f"gen_chunk {label} card vs CPU", plastic=chain)
        _add(totals, launches)
        paths[f"a5/gen_chunk/{label}/fp16/sparse"] = {
            "us_per_tick": seconds / TICKS * 1e6, "spikes": int(sp.sum()),
            "launches": launches}
        log(f"[a5] gen_chunk=100 {label}: card raster and state == CPU port; "
            f"{int(sp.sum())} spikes, {seconds / TICKS * 1e6:.1f} us/tick")

    # active=False: no generator spike, homeostasis leaves the weights.
    net = sparse(dev, **_homeo())
    chain = [j for j, h in enumerate(net.static.homeo) if h is not None]
    idle = torch.tensor(False, device=dev)
    final, out = run(net.static, net.params, net.state0, 200, active=idle)
    gen_cols = torch.cat([out["spikes"][:, g0:g0 + sz] for g0, sz in net.static.gen_spans], 1)
    require(int(gen_cols.sum()) == 0, "active=False: generators spiked")
    require(all(torch.equal(final.weights[j], net.state0.weights[j]) for j in chain),
            "active=False: homeostasis moved weights")
    busy, _ = run(net.static, net.params, net.state0, 200, active=torch.tensor(True, device=dev))
    require(any(not torch.equal(busy.weights[j], net.state0.weights[j]) for j in chain),
            "active=True: homeostasis moved no weight")
    paths["a5/active_false"] = {"generator_spikes": 0, "weights_unchanged": True,
                                "spikes": int(out["spikes"].sum())}
    log(f"[a5] active=False for 200 ticks: no generator spike ({int(out['spikes'].sum())} "
        "spikes in all), homeostasis left the weights; active=True moves them")

    # The loop oracle against packed on the card.
    for policy in ("fp16", "fp32"):
        key = f"a5/loop/{policy}"
        loop = build_synfire(SYNFIRE4, policy=policy, propagation="loop", device=dev)
        packed = build_synfire(SYNFIRE4, policy=policy, propagation="packed", device=dev)
        lfinal, lsp, launches, seconds = _timed_run(loop, TICKS, dev)
        _, psp, _, _ = _timed_run(packed, TICKS, dev)
        _require_same_raster(lsp, psp, f"{key}: loop vs packed")
        want = {**_static_launches(loop, TICKS), "syn_matmul": 0, "syn_gather": 0}
        require(launches == want, f"{key}: launches {launches} != {want}")
        _add(totals, launches)
        paths[key] = {"us_per_tick": seconds / TICKS * 1e6, "spikes": int(lsp.sum()),
                      "launches": launches, "raster_equals_packed": True}
        log(f"[a5] loop {policy}: raster == packed on the card, {int(lsp.sum())} spikes, "
            f"{seconds / TICKS * 1e6:.1f} us/tick")
    return paths


# -- lanes (A9): B1-B3 over a leading lane dimension, run_batch, LaneScheduler --------

LANES = 64
LANE_SAMPLE = (0, 9, 18, 27, 36, 45, 54, 63)  # lanes held against solo runs
SCHED_CHUNK = 100  # ticks per LaneScheduler chunk


def _lane_t0() -> tuple[int, ...]:
    """Lanes' first ticks, spread over every ring slot."""
    return tuple(100 + 7 * b for b in range(LANES))


def _lane_gen(g, static, dev, ticks: int) -> torch.Tensor:
    """Random generator rows ``[B, T, n_gen]``, a third of the lanes
    inactive (their rows all False: ``active`` folds into them)."""
    gen = torch.rand((LANES, ticks, static.n_gen), generator=g) < 0.3
    gen[2::3] = False
    return gen.to(dev)


def _hold_neuron_lanes(net, g, dev, what: str) -> dict:
    """``ops.NeuronRun`` over 64 lanes (ring slots spread over all L, a third
    of the lanes inactive) for 12 chained ticks on random v, u, refrac and
    rings: bit for bit its plain version (``ref.neuron_lanes_ref`` on the
    card) after every tick and the one-lane launcher on every lane; timed
    beside the plain version and 64 one-lane calls. The bound is 64 times
    the one-lane tick's bytes (raster recorded)."""
    from repro_torch.core import backend as be
    from repro_torch.core.lanes import lane_state
    from repro_torch.core.neurons import NeuronModel, NeuronState
    from repro_torch.kernels import ops, ref

    static, params = net.static, net.params
    n, dtype, ticks = static.n, net.state0.neurons.v.dtype, NEURON_TICKS
    v = (torch.rand((LANES, n), generator=g) * 115 - 80).to(dtype).to(dev)
    u = (torch.rand((LANES, n), generator=g) * 10 - 15).to(dtype).to(dev)
    refrac = torch.randint(0, 3, (LANES, n), generator=g).to(torch.int16).to(dev)
    ring = (torch.rand((LANES, *net.state0.ring.shape), generator=g) * 12).to(dtype).to(dev)
    t0 = _lane_t0()
    require(len({t % static.ring_len for t in t0}) == static.ring_len, f"t0 {t0}")
    gen = _lane_gen(g, static, dev, ticks)
    raster = torch.zeros((LANES, ticks, n), dtype=torch.bool, device=dev)
    neurons = NeuronState(v=v, u=u, refrac=refrac)
    k_ring, p_ring = ring.clone(), ring.clone()
    run = be.assemble_neurons(static, params, neurons, k_ring, gen_spk=gen, raster=raster,
                              t0=t0)
    require(run.launcher is not None, f"NeuronRun lanes {what}: no launcher on the card")
    p = params.neuron
    is_gen = p.model == NeuronModel.GENERATOR
    cols = _gen_cols(static, dev)
    pv, pu, pr = v.clone(), u.clone(), refrac.clone()
    p_spikes = torch.zeros((LANES, n), device=dev)
    p_raster = torch.zeros_like(raster)
    ops.reset_launches()
    for i in range(ticks):
        run(i)
        ref.neuron_lanes_ref(pv, pu, pr, p_ring, [(t + i) % static.ring_len for t in t0],
                             is_gen, p.a, p.b, p.c, p.d, cols, p_spikes, gen_rows=gen[:, i],
                             raster_rows=p_raster[:, i], dt=static.dt,
                             substeps=static.substeps)
        torch.cuda.synchronize()
        for name, got, want in (("v", run.v, pv), ("u", run.u, pu), ("refrac", run.refrac, pr),
                                ("ring", k_ring, p_ring), ("spikes", run.spikes, p_spikes)):
            _require_bitwise(got, want, f"NeuronRun lanes {what} tick {i} {name}")
    _require_bitwise(raster, p_raster, f"NeuronRun lanes {what} raster")
    require(ops.LAUNCHES["izh4_update"] == ticks, f"NeuronRun lanes {what}: "
            f"{ops.LAUNCHES['izh4_update']} launches in {ticks} ticks")
    fired = raster[:, :, ~is_gen].sum(dim=(1, 2))
    require(int(fired.sum()) > 0, f"NeuronRun lanes {what}: no neuron spiked")
    solos = []
    for b in range(LANES):
        one_ring = ring[b].clone()
        one_raster = torch.zeros((ticks, n), dtype=torch.bool, device=dev)
        solo = be.assemble_neurons(static, params, NeuronState(v[b], u[b], refrac[b]),
                                   one_ring, gen_spk=gen[b].contiguous(), raster=one_raster)
        for i in range(ticks):
            solo(i, t0[b] + i)
        for name, got, want in (("v", solo.v, run.v[b]), ("u", solo.u, run.u[b]),
                                ("ring", one_ring, k_ring[b]), ("raster", one_raster,
                                                                raster[b])):
            _require_bitwise(got, want, f"NeuronRun lanes {what} lane {b} vs one lane {name}")
        solos.append(solo)
    log(f"[lanes] NeuronRun {what}: 64 lanes (slots over all {static.ring_len}, a third "
        f"inactive) x {ticks} ticks bitwise against the plain lane version and the "
        f"one-lane launcher on every lane; {int(fired.sum())} neuron spikes")
    counter = iter(range(10**9))

    def tick():
        run(next(counter) % ticks)

    def one_lane_calls():
        i = next(counter) % ticks
        for b, solo in enumerate(solos):
            solo(i, t0[b] + i)

    plain = lambda: ref.neuron_lanes_ref(  # noqa: E731
        pv, pu, pr, p_ring, [t % static.ring_len for t in t0], is_gen, p.a, p.b, p.c, p.d,
        cols, p_spikes, gen_rows=gen[:, 0], raster_rows=p_raster[:, 0])
    s = v.element_size()
    moved = LANES * (2 * n * s + 2 * 2 * n * s + 2 * 2 * n + 4 * n + static.n_gen + n) + (
        4 * 4 * n + n + 4 * n)
    b_ms, b_by = bound(moved, 31 * n * LANES)
    return {"shape": f"{what} tick over 64 lanes: N={n}, raster recorded, one launch",
            "ms": cuda_ms(tick), "device_ms": device_ms(tick, "izh4_run_kernel"),
            "one_lane_x64_ms": cuda_ms(one_lane_calls, reps=20, warmup=2),
            "plain_ms": cuda_ms(plain, reps=5, warmup=1), "bound_ms": b_ms,
            "bound_by": b_by, "bound_bytes": moved, "library_ms": None}


L2_BYTES = 50 * 2**20  # the H100's L2


def _l2_copies(nbytes_each: int) -> int:
    """How many copies of an operand of ``nbytes_each`` bytes together hold
    three times the L2: rotating through them, each call reads its copy
    from device memory."""
    return max(2, -(-3 * L2_BYTES // nbytes_each))


def _cycling(fns):
    """A call that runs the next of ``fns`` each time."""
    it = itertools.cycle(fns)
    return lambda: next(it)()


def _gather_copies(run, dev, copies: int) -> list:
    """``run`` (a per-lane ``ops.GatherRun``) and ``copies - 1`` more on
    copies of its weight table, each with its own launcher and rows."""
    from repro_torch.kernels import syn_gather as gsyn

    out = [run]
    for _ in range(copies - 1):
        plan = copy.copy(run.plan)
        plan.w = run.plan.w.clone()
        other = copy.copy(run)
        other.plan = plan
        with torch.cuda.device(dev):
            other.launcher = gsyn.GatherLauncher(plan, dev, lanes=LANES)
        other.rows = other.launcher.rows
        out.append(other)
    return out


def _gather_lanes_bag(run, spikes, dev, copies: int = 1):
    """``embedding_bag`` over the CSR rows of ``run`` (an ``ops.GatherRun``
    over 64 lanes, one group) on the lanes' ``spikes`` ``[B, N]``, sums
    only: shared tables are one call with the transposed spike rows ``[N,
    B]`` as the table (transposed outside the call); per-lane tables one
    call on ``spikes`` as ``[B·N, 1]``, lane b's indices offset by b·N and
    its weights as per-sample weights (int32 indices), rotated through
    ``copies`` copies of the weights. Returns the call and a check that
    scatters its sums into ``run.rows``' layout."""
    plain = run.plan.plain[0]
    n, lanes = spikes.shape[1], spikes.shape[0]
    rows_i = [gidx.reshape(-1).to(dev, torch.int32) for _, _, gidx, _ in plain]
    flat = torch.cat(rows_i)
    sizes = [gidx.shape[0] for _, _, gidx, _ in plain]
    offsets = torch.cat([torch.arange(0, gidx.numel(), gidx.shape[1], device=dev,
                                      dtype=torch.int32) + sum(x.numel() for x in rows_i[:i])
                         for i, (_, _, gidx, _) in enumerate(plain)])
    per_lane = plain[0][3].dim() == 3
    bag = torch.nn.functional.embedding_bag
    if per_lane:
        lane = torch.arange(lanes, device=dev, dtype=torch.int32)[:, None]
        offsets = (offsets[None] + lane * flat.numel()).reshape(-1)
        flat = (flat[None] + lane * n).reshape(-1)
        w0 = torch.cat([w.reshape(lanes, -1) for *_, w in plain], dim=1).reshape(-1).float()
        ws = [w0] + [w0.clone() for _ in range(copies - 1)]
        table = spikes.reshape(-1, 1)
        calls = [lambda w=w: bag(flat, table, offsets, per_sample_weights=w, mode="sum")
                 for w in ws]
        fn = _cycling(calls)

        def sums():
            return calls[0]().reshape(lanes, -1)
    else:
        wflat = torch.cat([w.reshape(-1) for *_, w in plain]).float()
        table = spikes.T.contiguous()

        def fn():
            return bag(flat, table, offsets, per_sample_weights=wflat, mode="sum")

        def sums():
            return fn().T

    def check():
        got = torch.zeros_like(run.rows)
        per_row = sums()
        r0 = 0
        for (k, posts, _, _), q in zip(plain, sizes):
            got[:, k].index_add_(1, posts.to(dev), per_row[:, r0:r0 + q])
            r0 += q
        return got

    return fn, check


def _hold_gather_lanes(net, g, dev, what: str) -> dict:
    """``ops.GatherRun`` over 64 lanes on the compiled Synfire4 tables: with
    the compiled weights shared and, per lane, Synfire-valued tables, bit
    for bit its plain lane version on 12 random spike rows each; on random
    normal weights, shared and per lane, bit for bit the one-lane launcher
    on every lane. Timed (per call, device, 64 one-lane calls, plain,
    ``embedding_bag`` over the same rows) with shared and with per-lane
    tables, the per-lane ones rotated through copies past the L2; the
    library's sums are held against the kernel's at rtol 1e-5, atol 1e-4.
    The bound reads the index table once,
    the weights once (shared) or 64 times, the 64 spike rows, and writes
    the 64 accumulator blocks."""
    from repro_torch.core import backend as be
    from repro_torch.kernels import ops, ref

    static, params = net.static, net.params
    packed = be.assemble_packed(static, net.state0.weights)
    table = torch.tensor([0.0, 1.0, 3.5, -2.0])
    variants = {
        "shared": packed,
        "per-lane": tuple(table[torch.randint(0, 4, (LANES, *w.shape), generator=g)].to(dev)
                          for w in packed)}
    out = {}
    for label, pk in variants.items():
        run = be.assemble_gather(static, params, pk, LANES)
        plain = [(k, posts.to(dev), gidx.to(dev), w) for k, posts, gidx, w in run.plan.plain[0]]
        want = torch.empty_like(run.rows)
        for _ in range(NEURON_TICKS):
            spikes = (torch.rand((LANES, static.n), generator=g) < 0.3).float().to(dev)
            spikes[2::3] = 0.0
            ops.reset_launches()
            run(0, spikes)
            ref.gather_lanes_ref(spikes, want, plain, first=True)
            torch.cuda.synchronize()
            require(ops.LAUNCHES["syn_gather"] == 1, f"GatherRun lanes {what} {label}: "
                    f"{ops.LAUNCHES['syn_gather']} launches")
            _require_bitwise(run.rows, want, f"GatherRun lanes {what} {label}")
        rand = tuple(torch.randn(tuple(w.shape), generator=g).to(dev) for w in pk)
        rrun = be.assemble_gather(static, params, rand, LANES)
        rrun(0, spikes)
        if label == "shared":
            ones = [be.assemble_gather(static, params, rand)] * LANES
        else:
            ones = [be.assemble_gather(static, params, tuple(w[b] for w in rand))
                    for b in range(LANES)]
        lane_rows = [spikes[b].contiguous() for b in range(LANES)]
        for b in range(LANES):
            ones[b](0, lane_rows[b])
            torch.cuda.synchronize()
            _require_bitwise(ones[b].rows, rrun.rows[b],
                             f"GatherRun lanes {what} {label} random lane {b} vs one lane")
        plan = run.plan
        moved = (nbytes(plan.idx) + nbytes(plan.w.to(dev)) + nbytes(spikes) + nbytes(run.rows))
        entries = int(plan.idx.numel()) * LANES
        b_ms, b_by = bound(moved, 2 * entries)
        bag, bag_check = _gather_lanes_bag(rrun, spikes, dev)
        bag_rows = bag_check()
        bag_err = max_err(rrun.rows, bag_rows)
        require(torch.allclose(rrun.rows, bag_rows, rtol=1e-5, atol=1e-4),
                f"GatherRun lanes {what} {label}: embedding_bag differs by {bag_err}")
        call, launch, lib = (lambda: rrun(0, spikes)), (
            lambda: rrun.launcher(0, spikes.data_ptr())), bag
        warm = {}
        if label == "per-lane":  # per-lane tables rotated through copies past the L2
            warm = {"l2_warm_ms": cuda_ms(call), "l2_warm_device_ms": device_ms(
                launch, "gather_kernel")}
            runs = _gather_copies(rrun, dev, _l2_copies(nbytes(rrun.plan.w)))
            call = _cycling([lambda r=r: r(0, spikes) for r in runs])
            launch = _cycling([lambda r=r: r.launcher(0, spikes.data_ptr()) for r in runs])
            lib = _gather_lanes_bag(rrun, spikes, dev, copies=len(runs))[0]
            warm["copies"] = len(runs)
        out[label] = {
            "shape": f"{what}: 13 CSR buckets over 64 lanes, {label} weights, one launch",
            "ms": cuda_ms(call), "device_ms": device_ms(launch, "gather_kernel"), **warm,
            "one_lane_x64_ms": cuda_ms(lambda: [o(0, r) for o, r in zip(ones, lane_rows)],
                                       reps=20, warmup=2),
            "plain_ms": cuda_ms(lambda: ref.gather_lanes_ref(spikes, want, plain, first=True),
                                reps=3, warmup=1),
            "bound_ms": b_ms, "bound_by": b_by, "bound_bytes": moved,
            "library": "embedding_bag (sums only)", "library_ms": cuda_ms(lib),
            "library_device_ms": device_total_ms(lib), "library_max_abs_err": bag_err}
        log(f"[lanes] GatherRun {what} {label}: bitwise against the plain lane version "
            f"on {NEURON_TICKS} spike rows and the one-lane launcher on every lane on "
            f"random weights; {out[label]['ms'] * 1e3:.2f} us per call "
            f"({out[label]['device_ms'] * 1e3:.2f} us on the device"
            + ("" if not warm else f"; {warm['copies']} table copies rotated, "
               f"{warm['l2_warm_device_ms'] * 1e3:.2f} us L2-warm")
            + f"), 64 one-lane calls {out[label]['one_lane_x64_ms'] * 1e3:.2f} us, "
            f"embedding_bag {out[label]['library_ms'] * 1e3:.2f} us "
            f"({out[label]['library_device_ms'] * 1e3:.2f} us on the device), bound "
            f"{b_ms * 1e3:.4f} us")
    return out


def _hold_matmul_lanes(net, g, dev, what: str) -> dict:
    """``ops.MatmulRun`` over 64 lanes on the packed Synfire4 images, the
    lanes' rows column slices of ``[64, N]`` spike rows: shared images and
    per-lane Synfire-valued images bit for bit the plain lane version; on
    random normal weights, shared and per lane, bit for bit the one-lane
    GEMV on every lane. Timed at bucket 0 ([64, 200] x [200, 250] f32)
    beside 64 one-lane calls, the plain version, ``torch.matmul`` (shared)
    and ``torch.bmm`` (per lane), the per-lane image rotated through copies
    past the L2."""
    from repro_torch.core import backend as be
    from repro_torch.kernels import ops, ref

    static = net.static
    images = be.assemble_packed(static, net.state0.weights)
    table = torch.tensor([0.0, 1.0, 3.5, -2.0])
    variants = {
        "shared": images,
        "per-lane": tuple(table[torch.randint(0, 4, (LANES, *w.shape), generator=g)].to(dev)
                          for w in images)}
    out, err = {}, 0.0
    for label, imgs in variants.items():
        run = ops.MatmulRun(imgs, LANES)
        rand = tuple(torch.randn(tuple(w.shape), generator=g).to(dev) for w in imgs)
        rrun = ops.MatmulRun(rand, LANES)
        spikes = (torch.rand((LANES, static.n), generator=g) < 0.3).float().to(dev)
        spikes[2::3] = 0.0
        ops.reset_launches()
        for bi, b in enumerate(static.buckets):
            x = spikes[:, b.pre_start:b.pre_start + b.p]
            got = run(bi, x)
            want = ref.syn_matmul_lanes_ref(x, imgs[bi])
            torch.cuda.synchronize()
            _require_bitwise(got, want, f"MatmulRun lanes {what} {label} bucket {bi}")
            got = rrun(bi, x).clone()
            for lane in range(LANES):
                one = ops.MatmulRun([rand[bi][lane] if label == "per-lane" else rand[bi]])
                _require_bitwise(one(0, x[lane].contiguous()), got[lane],
                                 f"MatmulRun lanes {what} {label} random bucket {bi} lane "
                                 f"{lane} vs one lane")
            err = max(err, max_err(got, ref.syn_matmul_lanes_ref(x, rand[bi])))
        require(ops.LAUNCHES["syn_matmul"] >= 2 * len(static.buckets),
                f"MatmulRun lanes {what}: {ops.LAUNCHES['syn_matmul']} launches")
        w = imgs[0]
        b0 = static.buckets[0]
        x = spikes[:, b0.pre_start:b0.pre_start + b0.p]
        xc = x.contiguous()
        ones = [ops.MatmulRun([w[lane] if label == "per-lane" else w]) for lane in range(LANES)]
        rows = [x[lane].contiguous() for lane in range(LANES)]
        call = lambda: run(0, x)  # noqa: E731
        lib = ((lambda: torch.matmul(xc, w)) if label == "shared"
               else (lambda: torch.bmm(xc[:, None, :], w)))
        warm = {}
        if label == "per-lane":  # per-lane images rotated through copies past the L2
            warm = {"l2_warm_ms": cuda_ms(call),
                    "l2_warm_device_ms": device_ms(call, "gemv_lanes_kernel")}
            ws = [w] + [w.clone() for _ in range(_l2_copies(nbytes(w)) - 1)]
            call = _cycling([lambda r=ops.MatmulRun([c], LANES): r(0, x) for c in ws])
            lib = _cycling([lambda c=c: torch.bmm(xc[:, None, :], c) for c in ws])
            warm["copies"] = len(ws)
        moved = nbytes(w) + nbytes(xc) + LANES * w.shape[-1] * 4
        b_ms, b_by = bound(moved, 2 * LANES * w.shape[-2] * w.shape[-1])
        out[label] = {
            "shape": f"[64,{w.shape[-2]}]x{list(w.shape)} f32, {label} image, one launch",
            "ms": cuda_ms(call), "device_ms": device_ms(call, "gemv_lanes_kernel"), **warm,
            "one_lane_x64_ms": cuda_ms(lambda: [o(0, r) for o, r in zip(ones, rows)],
                                       reps=20, warmup=2),
            "plain_ms": cuda_ms(lambda: ref.syn_matmul_lanes_ref(x, w), reps=20, warmup=2),
            "bound_ms": b_ms, "bound_by": b_by, "bound_bytes": moved,
            "library": "torch.matmul" if label == "shared" else "torch.bmm",
            "library_ms": cuda_ms(lib), "library_device_ms": device_total_ms(lib)}
        log(f"[lanes] MatmulRun {what} {label}: bitwise against the plain lane version on "
            f"Synfire-valued images and the one-lane GEMV on every lane on random weights; "
            f"{out[label]['ms'] * 1e3:.2f} us per call ({out[label]['device_ms'] * 1e3:.2f} "
            f"us on the device"
            + ("" if not warm else f"; {warm['copies']} image copies rotated, "
               f"{warm['l2_warm_device_ms'] * 1e3:.2f} us L2-warm")
            + f"), 64 one-lane calls {out[label]['one_lane_x64_ms'] * 1e3:.2f} "
            f"us, {out[label]['library']} {out[label]['library_ms'] * 1e3:.2f} us "
            f"({out[label]['library_device_ms'] * 1e3:.2f} us on the device), bound "
            f"{b_ms * 1e3:.4f} us")
    out["max_abs_err_vs_plain_random"] = err
    return out


def phase_lane_kernels(dev, rows: list) -> None:
    """Phase 8a: B1-B3 over 64 lanes against their plain versions and the
    one-lane launchers, on Synfire4 fp16 and fp32, packed and sparse; the
    fp16 numbers join the kernel rows under ``lanes``."""
    from repro_torch.configs.synfire4 import SYNFIRE4, build_synfire

    g = torch.Generator(device="cpu").manual_seed(80)
    by_name = {r["name"]: r for r in rows}
    for policy in ("fp16", "fp32"):
        for propagation in ("packed", "sparse"):
            net = build_synfire(SYNFIRE4, policy=policy, propagation=propagation, device=dev,
                                budget=None)
            what = f"SYNFIRE4 {policy}/{propagation}"
            neuron = _hold_neuron_lanes(net, g, dev, what)
            syn = (_hold_matmul_lanes(net, g, dev, what) if propagation == "packed"
                   else _hold_gather_lanes(net, g, dev, what))
            if policy == "fp16":
                if propagation == "sparse":
                    by_name["izh4_update"]["lanes"] = neuron
                by_name["syn_matmul" if propagation == "packed" else "syn_gather"][
                    "lanes"] = syn


def _loop_events(fn, ticks: int, marker: str = "izh4_run_kernel") -> tuple[float, float]:
    """Device events per tick of ``fn`` (a ``ticks``-tick run) under
    ``torch.profiler``: all of them (set-up included) over ``ticks``, and
    those from the first launch of the once-a-tick kernel ``marker`` to
    the last over the ticks between them (the tick loop alone)."""
    for attempt in range(PROFILE_TRIES):
        events = sorted(_cuda_events(fn, 1), key=lambda e: e.time_range.start)
        ticks_at = [i for i, e in enumerate(events) if marker in e.name]
        if len(ticks_at) == ticks:
            return len(events) / ticks, (ticks_at[-1] - ticks_at[0]) / (ticks - 1)
        log(f"[profile] trace {attempt + 1} held {len(ticks_at)} of {ticks} "
            f"{marker} launches; tracing again")
    return len(events) / ticks, None


def _require_lane_equals(final, out, b, solo, solo_out, what):
    from repro_torch.core.lanes import lane_state

    lane = lane_state(final, b)
    if solo_out is not None:
        _require_same_raster(out["spikes"][b].cpu(), solo_out["spikes"].cpu(), f"{what} lane {b}")
    _require_same_state(lane, solo, f"{what} lane {b}")
    require(lane.t == solo.t, f"{what} lane {b}: t {lane.t} != {solo.t}")


def _run_batch_path(dev, propagation: str, totals: dict) -> dict:
    """Phase 8b: ``run_batch(1000, 64)`` on Synfire4 fp16 (``budget=None``):
    one ``izh4_update`` per tick for all lanes, one ``syn_gather`` (sparse)
    or 8 ``syn_matmul`` (packed); 8 lanes, the first and last among them,
    equal solo card runs on ``split(key, 64)[b]``; every lane's spikes in
    the paper's 20,000-33,000. Wall µs/tick beside the solo run's,
    lane-ticks per second, device events per tick, peak device memory."""
    from repro_torch.configs.synfire4 import SYNFIRE4, build_synfire
    from repro_torch.core import rng, run, run_batch
    from repro_torch.kernels import ops

    net = build_synfire(SYNFIRE4, policy="fp16", propagation=propagation, device=dev,
                        budget=None)
    static, params, state0 = net.static, net.params, net.state0
    run_batch(static, params, state0, 20, LANES)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    final, out = run_batch(static, params, state0, TICKS, LANES)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    _add(totals, launches)
    want = {**_static_launches(net, TICKS)}
    require(launches == want, f"run_batch {propagation}: launches {launches} != {want}")
    counts = out["spikes"].sum(dim=(1, 2)).cpu()
    require(bool(((counts >= 20_000) & (counts <= 33_000)).all()),
            f"run_batch {propagation}: lane spike counts {counts.min()}-{counts.max()} "
            "outside 20,000-33,000")
    keys = rng.split(state0.key, LANES)
    solo_s = None
    for b in LANE_SAMPLE:
        t1 = time.perf_counter()
        solo, solo_out = run(static, params, state0._replace(key=keys[b]), TICKS)
        torch.cuda.synchronize()
        solo_s = time.perf_counter() - t1
        _require_lane_equals(final, out, b, solo, solo_out, f"run_batch {propagation}")
    events, in_loop = _loop_events(lambda: run_batch(static, params, state0, 20, LANES), 20)
    res = {"us_per_tick": seconds / TICKS * 1e6, "solo_us_per_tick": solo_s / TICKS * 1e6,
           "lane_ticks_per_s": LANES * TICKS / seconds,
           "solo_ticks_per_s": TICKS / solo_s, "device_events_per_tick": events,
           "device_events_per_tick_in_loop": in_loop,
           "peak_device_bytes": peak, "spikes_min": int(counts.min()),
           "spikes_max": int(counts.max()), "launches": launches,
           "lanes_equal_solo": list(LANE_SAMPLE)}
    log(f"[lanes] run_batch(1000, 64) Synfire4 fp16 {propagation}: "
        f"{res['us_per_tick']:.1f} us/tick ({res['lane_ticks_per_s']:.0f} lane-ticks/s; "
        f"solo {res['solo_us_per_tick']:.1f} us/tick), {events:.2f} device events per tick "
        f"({in_loop} in the tick loop), "
        f"peak {peak} B, lane spikes {res['spikes_min']}-{res['spikes_max']}, launches "
        f"{launches}; lanes {LANE_SAMPLE} == solo card runs (raster and state)")
    return res


def _solo_session(net, key, ticks, state=None):
    from repro_torch.serve import Session

    sess = Session.create(net, key=key, state=state)
    sess.run(ticks, record="none")
    return sess.state


def _scheduler_path(dev, totals: dict) -> dict:
    """Phase 8c: ``LaneScheduler(capacity=64, record="none")`` over
    Synfire4 fp16 sparse: 48 tenants admitted in three waves (chunks 0, 2
    and 4), 10 chunks of 100 ticks; after chunk 5, 4 tenants evicted and
    resumed as solo sessions, 4 exported into a second scheduler
    (capacity 8) and 2 moved there through ``save_lane``/``restore_lane``
    on disk; at the end every moved tenant and 8 more equal a solo session
    over the same key and ticks. Each scheduler's chunks are timed apart,
    and beside them ``run_batch(100, 64)`` on the same net."""
    import tempfile
    import zlib

    from repro_torch.configs.synfire4 import SYNFIRE4, build_synfire
    from repro_torch.core import rng, run_batch
    from repro_torch.core.lanes import lane_state
    from repro_torch.kernels import ops
    from repro_torch.serve import LaneScheduler, restore_lane, save_lane

    net = build_synfire(SYNFIRE4, policy="fp16", propagation="sparse", device=dev, budget=None)
    big = LaneScheduler(net, LANES, record="none")
    small = LaneScheduler(net, 8, record="none", ledger_key="small")
    admitted, solos, chunk_s, small_s = {}, {}, [], []
    chunks, chunk = 10, SCHED_CHUNK
    ops.reset_launches()
    with tempfile.TemporaryDirectory() as tmp:
        for c in range(chunks):
            if c in (0, 2, 4):
                for k in range(LANES // 4):
                    sid = f"tenant{len(admitted)}"
                    big.admit(sid)
                    admitted[sid] = c
            if c == 6:
                moved = big.session_ids[:10]
                for sid in moved[:4]:  # evicted, resumed as solo sessions below
                    solos[sid] = (big.evict(sid), (chunks - c) * chunk)
                for sid in moved[4:8]:
                    small.restore(big.export(sid))
                for i, sid in enumerate(moved[8:]):
                    save_lane(f"{tmp}/{i}", big.export(sid))
                    small.restore(restore_lane(f"{tmp}/{i}", net))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            big.step(chunk)
            torch.cuda.synchronize()
            chunk_s.append(time.perf_counter() - t0)
            if small.occupancy:
                t0 = time.perf_counter()
                small.step(chunk)
                torch.cuda.synchronize()
                small_s.append(time.perf_counter() - t0)
    launches = dict(ops.LAUNCHES)
    _add(totals, launches)
    for sid, (ev, ticks) in solos.items():
        solos[sid] = _solo_session(net, ev.gen_key, ticks, state=ev.state)
    steps = chunks + (chunks - 6)
    require(launches["izh4_update"] == steps * chunk and launches["syn_gather"] == steps * chunk,
            f"scheduler launches {launches}: want {steps * chunk} izh4_update and syn_gather")
    checked = []
    for sid in list(solos) + small.session_ids + big.session_ids[:8]:
        key = rng.key(zlib.crc32(sid.encode()), dev)
        ticks = (chunks - admitted[sid]) * chunk
        want = _solo_session(net, key, ticks)
        if sid in solos:
            got = solos[sid]
        else:
            sched = small if sid in small.session_ids else big
            got = lane_state(sched.states, sched.lane_of(sid))
        _require_same_state(got, want, f"scheduler tenant {sid}")
        require(got.t == ticks, f"scheduler tenant {sid}: t {got.t} != {ticks}")
        checked.append(sid)
    # The same 64 lanes' 100 ticks batched (one shared table, one ring
    # phase), in the same phase of the script: what a chunk is held to.
    run_batch(net.static, net.params, net.state0, chunk, LANES, record="none")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run_batch(net.static, net.params, net.state0, chunk, LANES, record="none")
    torch.cuda.synchronize()
    batched_s = time.perf_counter() - t0
    res = {"us_per_chunk": [s * 1e6 for s in chunk_s], "chunk_ticks": chunk,
           "small_us_per_chunk": [s * 1e6 for s in small_s],
           "batched_us_per_100_ticks": batched_s * 1e6,
           "chunk_over_batched": [s / batched_s for s in chunk_s],
           "serve_bytes": net.ledger.serve_bytes(),
           "serve_rung_bytes": net.ledger.serve_rung_bytes(),
           "session_bytes": big.session_bytes, "tenants_checked": checked,
           "launches": launches}
    log(f"[lanes] LaneScheduler(64) Synfire4 fp16 sparse: 48 tenants in 3 waves, 10 chunks "
        f"of 100 ticks; 4 evicted to solo sessions, 4 exported and 2 through save_lane/"
        f"restore_lane into a second scheduler (8); {len(checked)} tenants (every moved one) "
        f"== solo sessions; us per chunk {[round(s * 1e6) for s in chunk_s]} (the 8-lane "
        f"scheduler {[round(s * 1e6) for s in small_s]}), run_batch(100, 64) "
        f"{batched_s * 1e6:.0f} us, chunk / batched "
        f"{[round(s / batched_s, 2) for s in chunk_s]}; serve bytes {res['serve_bytes']} "
        f"({res['serve_rung_bytes']}), {res['session_bytes']} B per session")
    return res


def _mini_512_path(dev, totals: dict) -> dict:
    """Phase 8d: Synfire4-mini fp16 (packed, ``build_synfire``'s default) at
    capacity 512, bench_serve's top rung (``budget=None``: 512 lanes exceed
    8.477 MB), every lane admitted, one chunk of 100 ticks after a warm-up
    chunk; lanes 0 and 511 equal solo sessions."""
    import zlib

    from repro_torch.configs.synfire4 import SYNFIRE4_MINI, build_synfire
    from repro_torch.core import rng
    from repro_torch.core.lanes import lane_state
    from repro_torch.kernels import ops
    from repro_torch.serve import LaneScheduler

    net = build_synfire(SYNFIRE4_MINI, policy="fp16", device=dev, budget=None)
    sched = LaneScheduler(net, 512, record="none")
    for i in range(512):
        sched.admit(f"tenant{i}")
    sched.step(100)
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    sched.step(100)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    _add(totals, launches)
    require(launches == _static_launches(net, 100), f"mini 512 launches {launches}")
    for lane in (0, 511):
        want = _solo_session(net, rng.key(zlib.crc32(f"tenant{lane}".encode()), dev), 200)
        _require_same_state(lane_state(sched.states, lane), want, f"mini 512 lane {lane}")
    res = {"us_per_chunk": seconds * 1e6, "chunk_ticks": 100,
           "lane_ticks_per_s": 512 * 100 / seconds, "serve_bytes": net.ledger.serve_bytes(),
           "launches": launches}
    log(f"[lanes] LaneScheduler(512) Synfire4-mini fp16: {seconds * 1e6:.0f} us per 100-tick "
        f"chunk ({res['lane_ticks_per_s']:.0f} lane-ticks/s), serve bytes "
        f"{res['serve_bytes']}, launches {launches}; lanes 0 and 511 == solo sessions")
    return res


def _plastic_lanes_path(dev, totals: dict) -> dict:
    """Phase 8e: plastic Synfire4-mini fp16 (``CHAIN_STDP``) at capacity 8
    in a ``LaneScheduler``, the batched route: one chunk of 100 ticks
    after a warm-up chunk, one launch per kernel per tick for every lane
    (``izh4_update``, ``stdp_update``, ``plastic_drive``); every lane equal
    to its solo session, weights and traces included; beside one solo
    session's chunk of 100 ticks, timed in the same phase."""
    import zlib

    from repro_torch.configs.synfire4 import CHAIN_STDP, SYNFIRE4_MINI, build_synfire
    from repro_torch.core import rng
    from repro_torch.core.engine import batched_route
    from repro_torch.core.lanes import lane_state
    from repro_torch.kernels import ops
    from repro_torch.serve import LaneScheduler, Session

    net = build_synfire(SYNFIRE4_MINI, policy="fp16", device=dev, stdp_chain=CHAIN_STDP)
    require(batched_route(net.static), "plastic mini takes the lane-by-lane route")
    sched = LaneScheduler(net, 8, record="none")
    for i in range(8):
        sched.admit(f"p{i}")
    sched.step(100)
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    sched.step(100)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    _add(totals, launches)
    want = _plastic_launches(net, 100)
    require(launches == want, f"plastic lanes launches {launches} != {want}")
    chain = _chain(net)
    for lane in range(8):
        want_state = _solo_session(net, rng.key(zlib.crc32(f"p{lane}".encode()), dev), 200)
        _require_same_state(lane_state(sched.states, lane), want_state, f"plastic lane {lane}",
                            plastic=chain)
    sess = Session.create(net, seed=3)
    sess.run(100, record="none")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sess.run(100, record="none")
    torch.cuda.synchronize()
    solo_s = time.perf_counter() - t0
    log(f"[lanes] plastic Synfire4-mini, 8 lanes batched: {seconds * 1e6:.0f} us per "
        f"100-tick chunk (one solo session's chunk {solo_s * 1e6:.0f} us, ratio "
        f"{seconds / solo_s:.2f}), launches {launches}; every lane == its solo session "
        "(weights and traces)")
    return {"us_per_chunk": seconds * 1e6, "solo_us_per_chunk": solo_s * 1e6,
            "chunk_over_solo": seconds / solo_s, "lane_ticks_per_s": 800 / seconds,
            "launches": launches}


# -- phase 8f-8h: B4, B5, B6 and the drive over lanes ------------------------------


def _lane_plastic_tables(net, g, dev):
    """Each of the 64 lanes' own random chain weights (in [0, 4) on valid
    cells) and traces (in [0, 3))."""
    from repro_torch.core.plasticity import STDPState

    weights, stdp = list(net.state0.weights), list(net.state0.stdp)
    for j in _chain(net):
        valid, w = net.params.masks[j], weights[j]
        weights[j] = torch.where(valid.cpu(), torch.rand((LANES, *w.shape), generator=g) * 4,
                                 0.0).to(w.dtype).to(dev)
        stdp[j] = STDPState(*(torch.rand((LANES, x.shape[-1]), generator=g).mul(3).to(dev)
                              for x in (stdp[j].pre_trace, stdp[j].post_trace)))
    return tuple(weights), tuple(stdp)


def _lane_spike_rows(g, n: int, dev) -> torch.Tensor:
    """Random 0/1 f32 spike rows of the 64 lanes, a third of them silent."""
    s = (torch.rand((LANES, n), generator=g) < 0.3).float()
    s[2::3] = 0.0
    return s.to(dev)


def _hold_stdp_lanes(net, g, dev, what: str) -> dict:
    """B6 (``StdpUpdateRun``, packed) or B5 (``StdpGatherRun``, sparse) over
    64 lanes of the plastic chain, each lane its own random weights and
    traces, a third of the lanes silent: bit for bit its plain lane version
    after every tick and every lane its one-lane launch, one launch a tick;
    timed per call and on the device beside 64 one-lane calls and the plain
    version. The bound: 64 lanes' weights read and written and traces read
    and written, the mask or index and validity rows once, 7 operations
    per cell and 2 per trace of every lane."""
    from repro_torch.core import backend as be
    from repro_torch.kernels import ops, ref

    static, params = net.static, net.params
    packed = static.propagation == "packed"
    build = be.assemble_stdp_update if packed else be.assemble_stdp_gather
    plain_fn = ref.stdp_update_lanes_ref if packed else ref.stdp_gather_lanes_ref
    name, kernel = (("stdp_update", "stdp_update_run_kernel") if packed
                    else ("stdp_gather", "stdp_run_kernel"))
    weights, stdp = _lane_plastic_tables(net, g, dev)
    chain = set(_chain(net))

    def lane(b):
        return (tuple(w[b] if j in chain else w for j, w in enumerate(weights)),
                tuple(s if j not in chain else type(s)(*(x[b] for x in s))
                      for j, s in enumerate(stdp)))

    runs = build(static, params, weights, stdp, LANES)
    plain = build(static, params, weights, stdp, LANES)
    ones = [build(static, params, *lane(b)) for b in range(LANES)]
    require(runs.launcher is not None, f"{name} lanes {what}: no launcher on the card")
    ops.reset_launches()
    for t in range(STDP_TICKS):
        spikes = _lane_spike_rows(g, static.n, dev)
        runs(spikes)
        plain_fn(spikes, plain.projs, t % 2)
        for b, one in enumerate(ones):
            one(spikes[b])
        torch.cuda.synchronize()
        for k in range(len(runs.keys)):
            p, q = runs.projs[k], plain.projs[k]
            pre_t, post_t = runs.traces(k)
            for part, x, y in (("weights", p.w, q.w), ("pre trace", pre_t, q.pre_tr[1 - t % 2]),
                               ("post trace", post_t, q.post_tr[1 - t % 2])):
                _require_bitwise(x, y, f"{name} lanes {what} tick {t} proj {k} {part}")
    require(ops.LAUNCHES[name] == STDP_TICKS * (1 + LANES),
            f"{name} lanes {what}: {ops.LAUNCHES[name]} launches")
    for b, one in enumerate(ones):
        for k in range(len(runs.keys)):
            _require_bitwise(runs.projs[k].w[b], one.projs[k].w,
                             f"{name} lanes {what} lane {b} vs one lane, proj {k}")
    log(f"[lanes] {name} {what}: 64 lanes x {len(runs.keys)} projections x {STDP_TICKS} "
        "ticks bitwise against the plain lane version and the one-lane launch on every lane")
    spikes = _lane_spike_rows(g, static.n, dev)
    moved = ops_ = 0
    for p in runs.projs:
        cells = p.w.shape[-2] * p.w.shape[-1]
        n_tr = p.pre_tr[0].shape[-1] + p.post_tr[0].shape[-1]
        shared = nbytes(p.mask) if packed else nbytes(p.idx, p.valid)
        moved += 2 * LANES * cells * p.w.element_size() + shared + 3 * 4 * n_tr * LANES
        ops_ += LANES * (7 * cells + 2 * n_tr)
    b_ms, b_by = bound(moved, ops_)
    return {"shape": f"plastic Synfire4 {static.propagation} {static.policy_name} tick over "
                     "64 lanes: "
                     f"{len(runs.keys)} chain projections, one launch",
            "ms": cuda_ms(lambda: runs(spikes)),
            "device_ms": device_ms(lambda: runs(spikes), kernel),
            "one_lane_x64_ms": cuda_ms(lambda: [one(spikes[b]) for b, one in enumerate(ones)],
                                       reps=20, warmup=2),
            "plain_ms": cuda_ms(lambda: plain_fn(spikes, plain.projs, 0), reps=3, warmup=1),
            "bound_ms": b_ms, "bound_by": b_by, "bound_bytes": moved, "library_ms": None}


def _hold_drive_lanes(net, g, dev, what: str) -> dict:
    """The drive over 64 lanes of the plastic chain, each lane its own
    random off-grid weights, a third silent: bit for bit its plain version
    on the card and every lane its one-lane launch; timed per call and on
    the device beside 64 one-lane calls, the plain version and, for
    CSR-stored rows, ``embedding_bag`` over the same rows of every lane."""
    from repro_torch.kernels import ops, ref

    n = net.static.n
    projs_on, acc, weights, stp, _ = _drive_case(net, g, dev, LANES)
    plain_acc, one_acc = acc.clone(), acc.clone()
    projs = projs_on(acc)
    run = ops.DriveRun(n, projs, lanes=LANES)
    plain = projs_on(plain_acc)
    ones = [ops.DriveRun(n, projs_on(one_acc[b])) for b in range(LANES)]
    lane_in = [([w[b] for w in weights],
                [None if s is None else (s[0][b], s[1][b]) for s in stp])
               for b in range(LANES)]
    ops.reset_launches()
    for t in range(3):
        spikes = _lane_spike_rows(g, n, dev)
        run(spikes, weights, stp)
        ref.drive_run_ref(spikes, plain, weights, stp)
        for b, one in enumerate(ones):
            one(spikes[b], *lane_in[b])
        torch.cuda.synchronize()
        _require_bitwise(acc, plain_acc, f"plastic_drive lanes {what} tick {t}")
        _require_bitwise(acc, one_acc, f"plastic_drive lanes {what} tick {t} vs one lane")
    require(ops.LAUNCHES["plastic_drive"] == 3 * (1 + LANES), "plastic_drive lanes launches")
    log(f"[lanes] plastic_drive {what}: 64 lanes x {len(projs)} projections x 3 ticks "
        "bitwise against the plain version and the one-lane launch on every lane")
    spikes = _lane_spike_rows(g, n, dev)
    b_ms, b_by, moved = _drive_bound(projs, weights, stp, n, LANES)
    lib = _drive_library(projs, weights, stp, spikes, dev)
    call = lambda: run(spikes, weights, stp)  # noqa: E731
    return {"shape": f"plastic Synfire4 {net.static.propagation} {net.static.policy_name} "
                     "tick over 64 lanes: "
                     f"{len(projs)} chain projections, one launch",
            "ms": cuda_ms(call), "device_ms": device_ms(call, "plastic_drive_kernel"),
            "one_lane_x64_ms": cuda_ms(lambda: [one(spikes[b], *lane_in[b])
                                                for b, one in enumerate(ones)],
                                       reps=20, warmup=2),
            "plain_ms": cuda_ms(lambda: ref.drive_run_ref(spikes, plain, weights, stp),
                                reps=5, warmup=1),
            "bound_ms": b_ms, "bound_by": b_by, "bound_bytes": moved,
            **_drive_library_times(lib)}


def _hold_fused_lanes(net, g, dev, what: str) -> dict:
    """B4 (``FusedTickRun`` over lanes) on 64 lanes of Synfire4 fp16 at
    their own ring slots (random v, u, ring and generator rows, a third of
    the lanes silent), on per-lane tables (each lane's Synfire table times
    a power of two, so every sum stays exact) and on the shared payload
    ``run_batch`` uses: bit for bit its plain lane version and the one-lane
    launch on every lane over 12 chained ticks, one launch a tick; timed
    (shared payload) per tick and on the device beside 64 one-lane ticks
    and the plain version. The bound is the sum of each lane's one-lane
    fused bound on its last tick's spikes, the tables the lanes share
    (a-d, is_gen, descriptors, CSR indices) counted once."""
    from repro_torch.core import backend as be
    from repro_torch.core.neurons import NeuronModel
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.fused_tick import assemble_kernel

    static, params = net.static, net.params
    n, ticks, L = static.n, CHAINED, static.ring_len
    p = params.neuron
    is_gen = p.model == NeuronModel.GENERATOR
    dtype = net.state0.neurons.v.dtype
    base = be.assemble_packed(static, net.state0.weights)
    scale = (2.0 ** torch.randint(-2, 3, (LANES,), generator=g)).to(dev)
    t0 = _lane_t0()
    out = {}
    for label, packed in (("per-lane", tuple(w[None] * scale.view(-1, *[1] * w.dim())
                                             for w in base)), ("shared", base)):
        payload = assemble_kernel(static, params, packed)
        v = (torch.rand((LANES, n), generator=g) * 100 - 75).to(dtype).to(dev)
        u = (torch.rand((LANES, n), generator=g) * 10 - 15).to(dtype).to(dev)
        ring = (torch.rand((LANES, L, n), generator=g) * 10).to(dtype).to(dev)
        rows = torch.rand((LANES, ticks, n), generator=g) < 0.2
        rows[2::3] = False
        rows = rows.to(dev)
        state = [x.clone() for x in (v, u, ring, rows)]
        plain = [x.clone() for x in (v, u, ring, rows)]
        runs = ops.FusedTickRun(payload, *state[:3], is_gen, p.a, p.b, p.c, p.d, state[3],
                                t0=t0)
        require(runs.launcher is not None, f"fused_tick lanes {what}: no launcher")
        ops.reset_launches()
        for i in range(ticks):
            runs.tick(i)
            pv, pu, pring, prows = plain
            v2, u2, sp, ring2, _ = ref.fused_tick_lanes_ref(
                pv, pu, pring, prows[:, i], is_gen, p.a, p.b, p.c, p.d,
                [t + i for t in t0], dense=payload.dense, csr=payload.csr, ring_len=L)
            pv.copy_(v2)
            pu.copy_(u2)
            pring.copy_(ring2)
            prows[:, i] = sp
            torch.cuda.synchronize()
            for part, x, y in zip(("v", "u", "ring", "rows"), state, plain):
                _require_bitwise(x, y, f"fused_tick lanes {what} {label} tick {i} {part}")
        require(ops.LAUNCHES["fused_tick"] == ticks, f"fused_tick lanes {what}: launches")
        solos = []
        for b in range(LANES):
            one = payload if label == "shared" else assemble_kernel(
                static, params, tuple(w[b] for w in packed))
            mine = [x[b].clone() for x in (v, u, ring, rows)]
            solo = ops.FusedTickRun(one, *mine[:3], is_gen, p.a, p.b, p.c, p.d, mine[3])
            for i in range(ticks):
                solo.tick(i, t0[b] + i)
            torch.cuda.synchronize()
            for part, x, y in zip(("v", "u", "ring", "rows"), mine, state):
                _require_bitwise(x, y[b], f"fused_tick lanes {what} {label} lane {b} vs "
                                 f"one lane: {part}")
            solos.append((solo, t0[b]))
        fired = int(state[3][:, :, ~is_gen].sum())
        require(fired > 0, f"fused_tick lanes {what}: no neuron spiked")
        log(f"[lanes] fused_tick {what} ({label} weights): 64 lanes (slots over all {L}, a "
            f"third silent) x {ticks} ticks bitwise against the plain lane version and the "
            f"one-lane launch on every lane; {fired} neuron spikes; grid "
            f"{getattr(runs.launcher, 'grid', None)} CTAs")
        out[label] = (runs, solos, payload, state)
    runs, solos, payload, state = out["shared"]
    counter = iter(range(10**9))

    def tick():
        runs.tick(next(counter) % ticks)

    def one_lane_ticks():
        i = next(counter) % ticks
        for solo, t in solos:
            solo.tick(i, t + i)

    pv, pu, pring, prows = (x.clone() for x in state)
    plain_tick = lambda: ref.fused_tick_lanes_ref(  # noqa: E731
        pv, pu, pring, prows[:, 0], is_gen, p.a, p.b, p.c, p.d, list(t0),
        dense=payload.dense, csr=payload.csr, ring_len=L)
    moved = ops_ = 0
    for b in range(LANES):
        lane_bytes, lane_ops = _fused_work(payload, state[3][b, -1], n, state[0].element_size())
        moved += lane_bytes
        ops_ += lane_ops
    moved -= (LANES - 1) * _fused_shared_bytes(payload, n)
    b_ms, b_by = bound(moved, ops_)
    grid = getattr(runs.launcher, "grid", None)
    return {"shape": f"{what} tick over 64 lanes (shared weights, as run_batch), one "
                     f"launch on {grid} CTAs",
            "ms": cuda_ms(tick), "device_ms": device_ms(tick, "fused_tick_kernel"),
            "one_lane_x64_ms": cuda_ms(one_lane_ticks, reps=10, warmup=2),
            "plain_ms": cuda_ms(plain_tick, reps=2, warmup=1), "bound_ms": b_ms,
            "bound_by": b_by, "bound_bytes": moved, "library_ms": None, "grid": grid}


def phase_plastic_lane_kernels(dev, rows: list) -> None:
    """Phase 8f: B4, B5, B6 and the drive over 64 lanes of Synfire4 fp16
    (plastic chain for B5, B6 and the drive) against their plain versions
    and the one-lane launches; their numbers join the kernel rows under
    ``lanes`` (the sparse tick's for B4 and the drive)."""
    from repro_torch.configs.synfire4 import CHAIN_STDP, SYNFIRE4, build_synfire

    g = torch.Generator(device="cpu").manual_seed(81)
    by_name = {r["name"]: r for r in rows}
    for propagation in ("packed", "sparse"):
        net = build_synfire(SYNFIRE4, policy="fp16", propagation=propagation, device=dev,
                            stdp_chain=CHAIN_STDP, budget=None)
        what = f"SYNFIRE4 fp16/{propagation}"
        by_name["stdp_update" if propagation == "packed" else "stdp_gather"]["lanes"] = (
            _hold_stdp_lanes(net, g, dev, what))
        drive = _hold_drive_lanes(net, g, dev, what)
        fused = build_synfire(SYNFIRE4, policy="fp16", propagation=propagation, device=dev,
                              backend="fused", budget=None)
        tick = _hold_fused_lanes(fused, g, dev, f"SYNFIRE4 fp16/{propagation} fused")
        if propagation == "sparse":
            by_name["plastic_drive"]["lanes"] = drive
            by_name["fused_tick"]["lanes"] = tick


def _require_plastic_lane(final, out, b, solo, solo_out, net, what):
    """Lane ``b`` equals the solo run: raster, state, and the chain's
    weights, traces and homeostasis rates."""
    from repro_torch.core.lanes import lane_state

    _require_lane_equals(final, out, b, solo, solo_out, what)
    lane = lane_state(final, b)
    _require_same_state(lane, solo, f"{what} lane {b}", plastic=_chain(net))
    for j, h in enumerate(lane.homeo):
        if h is not None:
            _require_bitwise(h, solo.homeo[j], f"{what} lane {b} homeostasis rates {j}")


def _widened_run_batch_path(dev, propagation: str, totals: dict, *, plastic: bool,
                            homeo: bool = False) -> dict:
    """Phase 8g (``plastic``: plastic Synfire4 fp16, ``CHAIN_STDP``, with
    homeostasis every 100 ticks where ``homeo``) and 8h (fused Synfire4
    fp16): ``run_batch(1000, 64)`` (``budget=None``), one launch per kernel
    per tick for every lane; 8 lanes, the first and last among them, equal
    solo card runs in raster, weights, traces, rates and state. Wall
    µs/tick beside one solo run's, lane-ticks per second, device events
    per tick and peak device memory."""
    from repro_torch.configs.synfire4 import CHAIN_STDP, SYNFIRE4, build_synfire
    from repro_torch.core import rng, run, run_batch
    from repro_torch.core.plasticity import HomeostasisConfig
    from repro_torch.kernels import ops

    kw = dict(stdp_chain=CHAIN_STDP) if plastic else dict(backend="fused")
    if homeo:
        kw.update(homeo_chain=HomeostasisConfig(**HOMEO), homeostasis_period=100)
    net = build_synfire(SYNFIRE4, policy="fp16", propagation=propagation, device=dev,
                        budget=None, **kw)
    static, params, state0 = net.static, net.params, net.state0
    what = (f"{'plastic' if plastic else 'fused'} run_batch {propagation}"
            + (" homeostasis" if homeo else ""))
    short = 100 if homeo else 20
    run_batch(static, params, state0, short, LANES)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    final, out = run_batch(static, params, state0, TICKS, LANES)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    _add(totals, launches)
    want = _plastic_launches(net, TICKS) if plastic else _fused_launches(TICKS)
    require(launches == want, f"{what}: launches {launches} != {want}")
    counts = out["spikes"].sum(dim=(1, 2)).cpu()
    require(bool((counts > 0).all()), f"{what}: a lane never spiked")
    keys = rng.split(state0.key, LANES)
    solo_s = None
    for b in LANE_SAMPLE:
        t1 = time.perf_counter()
        solo, solo_out = run(static, params, state0._replace(key=keys[b]), TICKS)
        torch.cuda.synchronize()
        solo_s = time.perf_counter() - t1
        _require_plastic_lane(final, out, b, solo, solo_out, net, what)
    events, in_loop = _loop_events(lambda: run_batch(static, params, state0, short, LANES),
                                   short, "izh4_run_kernel" if plastic else "fused_tick_kernel")
    res = {"us_per_tick": seconds / TICKS * 1e6, "solo_us_per_tick": solo_s / TICKS * 1e6,
           "lane_ticks_per_s": LANES * TICKS / seconds, "solo_ticks_per_s": TICKS / solo_s,
           "lane_ticks_over_solo": LANES * solo_s / seconds,
           "device_events_per_tick": events, "device_events_per_tick_in_loop": in_loop,
           "peak_device_bytes": peak, "spikes_min": int(counts.min()),
           "spikes_max": int(counts.max()), "launches": launches,
           "lanes_equal_solo": list(LANE_SAMPLE)}
    log(f"[lanes] {what} (1000, 64) Synfire4 fp16: {res['us_per_tick']:.1f} us/tick "
        f"({res['lane_ticks_per_s']:.0f} lane-ticks/s, {res['lane_ticks_over_solo']:.1f}x "
        f"the solo run's {res['solo_ticks_per_s']:.0f} ticks/s), {events:.2f} device events "
        f"per tick ({in_loop} in the tick loop), peak {peak} B, lane spikes "
        f"{res['spikes_min']}-{res['spikes_max']}, launches {launches}; lanes {LANE_SAMPLE} "
        "== solo card runs (raster, weights, traces, rates and state)")
    return res


def phase_lanes(dev, rows: list, totals: dict) -> dict:
    """Phase 8: lanes. (a) B1-B3 over 64 lanes; (b) run_batch(1000, 64) on
    Synfire4 fp16 packed and sparse; (c) a 64-lane LaneScheduler with
    waves, evictions and migrations; (d) the mini at 512 lanes; (e) the
    plastic mini at 8 lanes in a scheduler, batched; (f) B4, B5, B6 and
    the drive over 64 lanes; (g) plastic run_batch(1000, 64), packed with
    homeostasis every 100 ticks and sparse; (h) fused run_batch(1000,
    64), packed and sparse."""
    phase_lane_kernels(dev, rows)
    paths = {f"lanes/run_batch/fp16/{p}": _run_batch_path(dev, p, totals)
             for p in ("packed", "sparse")}
    paths["lanes/scheduler/synfire4/fp16/sparse"] = _scheduler_path(dev, totals)
    paths["lanes/scheduler/mini512/fp16/packed"] = _mini_512_path(dev, totals)
    paths["lanes/scheduler/plastic_mini8/fp16"] = _plastic_lanes_path(dev, totals)
    phase_plastic_lane_kernels(dev, rows)
    paths["lanes/run_batch/plastic/fp16/packed_homeo100"] = _widened_run_batch_path(
        dev, "packed", totals, plastic=True, homeo=True)
    paths["lanes/run_batch/plastic/fp16/sparse"] = _widened_run_batch_path(
        dev, "sparse", totals, plastic=True)
    for p in ("packed", "sparse"):
        paths[f"lanes/run_batch/fused/fp16/{p}"] = _widened_run_batch_path(
            dev, p, totals, plastic=False)
    return paths


LANE_ROWS = ("izh4_update", "syn_matmul", "syn_gather", "fused_tick", "stdp_update",
             "stdp_gather", "plastic_drive")


def phase_lanes_fresh(rows: list, totals: dict) -> dict:
    """Phase 8 in a process of its own (``chip_smoke.py --lanes-json PATH``),
    which this one waits for: late in a long process ``torch.profiler``
    records fewer and fewer kernels (none at all once, in phase 8 after
    phases 1-5c), and a fresh process records every one. Its lane rows,
    paths and launch counts join this run's."""
    import tempfile

    from repro_torch.kernels import ops

    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "lanes.json"
        subprocess.run([sys.executable, str(Path(__file__).resolve()), "--lanes-json",
                        str(out)], check=True, timeout=900)
        res = json.loads(out.read_text())
    for r in rows:
        if r["name"] in res["lanes"]:
            r["lanes"] = res["lanes"][r["name"]]
    require(set(res["totals"]) == set(ops.LAUNCHES), f"phase 8 counts {res['totals']}")
    _add(totals, res["totals"])
    return res["paths"]


def _lanes_main(out: str) -> int:
    """``--lanes-json PATH``: phase 8 alone, written to ``PATH`` as JSON."""
    from repro_torch.kernels import _build, ops

    _build.build()
    rows = [{"name": name} for name in LANE_ROWS]
    totals = {k: 0 for k in ops.LAUNCHES}
    paths = phase_lanes(torch.device("cuda", 0), rows, totals)
    Path(out).write_text(json.dumps({"lanes": {r["name"]: r["lanes"] for r in rows},
                                     "paths": paths, "totals": totals}))
    return 0


# -- phase 9: in-run monitors (A6) ----------------------------------------------------

MON_TICKS = 1000
MON_SLOT_TICKS = 12  # chained ticks per slot case: ring slots wrap past L = 11
MON_EVENT_TICKS = 20
MON_REPS = 5  # interleaved timing reps of none and monitors
MON_TENANTS = 16
MON_BATCH_REPS = 3  # interleaved turns of a 64-lane batch with and without monitors


def _slot_inputs(g, net, shape, dev):
    """A SpikeCount count and a GroupRate level (random, so the fold rounds
    off its grid), and the constants of ``net``'s GroupRate."""
    from repro_torch.telemetry.monitors import kernel_slots, rate_constants

    count = torch.randint(0, 50, shape, generator=g, dtype=torch.int32).to(dev)
    level = (torch.rand(shape, generator=g) * 40).to(dev)
    rate = net.static.monitors[kernel_slots(net.static)[1]]
    return count, level, rate_constants(net.static, rate)


def _hold_neuron_slots(net, g, dev, lanes) -> dict:
    """``ops.NeuronRun`` with the monitor slots (a SpikeCount's count and a
    GroupRate's level folded in the launch) for 12 chained ticks on random
    state, one lane or 64 at spread ring slots: bit for bit its plain
    version with the same slots; device time of one tick with and without
    the slots."""
    from repro_torch.core import backend as be
    from repro_torch.core.neurons import NeuronModel, NeuronState
    from repro_torch.kernels import ref

    static, params = net.static, net.params
    n, dtype, ticks = static.n, net.state0.neurons.v.dtype, MON_SLOT_TICKS
    lead = () if lanes is None else (LANES,)
    v = (torch.rand((*lead, n), generator=g) * 115 - 80).to(dtype).to(dev)
    u = (torch.rand((*lead, n), generator=g) * 10 - 15).to(dtype).to(dev)
    refrac = torch.zeros((*lead, n), dtype=torch.int16, device=dev)
    ring = (torch.rand((*lead, *net.state0.ring.shape), generator=g) * 12).to(dtype).to(dev)
    gen = (torch.rand((*lead, ticks, static.n_gen), generator=g) < 0.3).to(dev)
    count, level, rate = _slot_inputs(g, net, (*lead, n), dev)
    t0 = _lane_t0() if lanes else None
    tel = dict(tel_count=count.clone(), tel_rate=level.clone(), rate=rate)
    k_ring = ring.clone()
    run = be.assemble_neurons(static, params, NeuronState(v=v, u=u, refrac=refrac), k_ring,
                              gen_spk=gen, t0=t0, tel=tel)
    require(run.launcher is not None, "NeuronRun with slots: no launcher on the card")
    p = params.neuron
    is_gen = p.model == NeuronModel.GENERATOR
    cols = _gen_cols(static, dev)
    pv, pu, pr, p_ring = v.clone(), u.clone(), refrac.clone(), ring.clone()
    pc, pl = count.clone(), level.clone()
    spikes = torch.zeros((*lead, n), device=dev)
    for i in range(ticks):
        if lanes:
            run(i)
            ref.neuron_lanes_ref(pv, pu, pr, p_ring, [(t + i) % static.ring_len for t in t0],
                                 is_gen, p.a, p.b, p.c, p.d, cols, spikes, gen_rows=gen[:, i],
                                 tel_count=pc, tel_rate=pl, rate=rate, dt=static.dt,
                                 substeps=static.substeps)
        else:
            run(i, 100 + i)
            ref.neuron_run_ref(pv, pu, pr, p_ring, (100 + i) % static.ring_len, is_gen, p.a,
                               p.b, p.c, p.d, cols, spikes, gen_row=gen[i], tel_count=pc,
                               tel_rate=pl, rate=rate, dt=static.dt, substeps=static.substeps)
    torch.cuda.synchronize()
    what = f"NeuronRun with monitor slots, {LANES if lanes else 1} lane(s)"
    err = 0.0
    for name, a, b in (("v", run.v, pv), ("u", run.u, pu), ("ring", k_ring, p_ring),
                       ("count", tel["tel_count"], pc), ("level", tel["tel_rate"], pl)):
        require(torch.equal(a, b), f"{what}: {name} differs from the plain version "
                f"(max abs err {max_err(a.float(), b.float())})")
        err = max(err, _held(a, b))
    require(not torch.equal(pl, level) and int((pc - count).sum()) > 0, f"{what}: idle")
    bare = be.assemble_neurons(static, params, NeuronState(v=v, u=u, refrac=refrac),
                               ring.clone(), gen_spk=gen, t0=t0)
    step = (lambda r: (lambda: r(0))) if lanes else (lambda r: (lambda: r(0, 100)))
    with_us = device_ms(step(run), "izh4_run_kernel", reps=200) * 1e3
    none_us = device_ms(step(bare), "izh4_run_kernel", reps=200) * 1e3
    log(f"[monitors] {what}: {ticks} ticks bit for bit the plain version; device "
        f"{with_us:.3f} us a tick with the slots, {none_us:.3f} without")
    return {"device_us_slots": with_us, "device_us_none": none_us, "max_abs_err": err}


def _hold_fused_slots(net, g, dev, lanes) -> dict:
    """``ops.FusedTickRun`` with the monitor slots for 12 ticks on random
    state (one lane, or 64 at their own ring slots): bit for bit its plain
    version with the same slots, still one launch a tick; device time of a
    tick with and without the slots."""
    from repro_torch.core import backend as be
    from repro_torch.core.neurons import NeuronModel
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.fused_tick import assemble_kernel

    static, params = net.static, net.params
    n, dtype, ticks = static.n, net.state0.neurons.v.dtype, MON_SLOT_TICKS
    lead = () if lanes is None else (LANES,)
    payload = assemble_kernel(static, params, be.assemble_packed(static, net.state0.weights))
    v = (torch.rand((*lead, n), generator=g) * 100 - 75).to(dtype).to(dev)
    u = (torch.rand((*lead, n), generator=g) * 10 - 15).to(dtype).to(dev)
    ring = (torch.rand((*lead, static.ring_len, n), generator=g) * 10).to(dtype).to(dev)
    rows = (torch.rand((*lead, ticks, n), generator=g) < 0.2).to(dev)
    count, level, rate = _slot_inputs(g, net, (*lead, n), dev)
    t0 = _lane_t0() if lanes else None
    p = params.neuron
    is_gen = p.model == NeuronModel.GENERATOR
    state = [x.clone() for x in (v, u, ring, rows, count, level)]
    plain = [x.clone() for x in state]
    runs = ops.FusedTickRun(payload, *state[:3], is_gen, p.a, p.b, p.c, p.d, state[3], t0=t0,
                            tel_count=state[4], tel_rate=state[5], rate=rate)
    require(runs.launcher is not None, "FusedTickRun with slots: no launcher on the card")
    kw = dict(dense=payload.dense, csr=payload.csr, ring_len=static.ring_len,
              tel_count=plain[4], tel_rate=plain[5], rate=rate)
    ops.reset_launches()
    for i in range(ticks):
        pv, pu, pring, prows = plain[:4]
        if lanes:
            runs.tick(i)
            out = ref.fused_tick_lanes_ref(pv, pu, pring, prows[:, i], is_gen, p.a, p.b, p.c,
                                           p.d, [t + i for t in t0], **kw)
        else:
            runs.tick(i, 100 + i)
            out = ref.fused_tick_ref(pv, pu, pring, prows[i], is_gen, p.a, p.b, p.c, p.d,
                                     100 + i, **kw)
        pv.copy_(out[0])
        pu.copy_(out[1])
        pring.copy_(out[3])
        prows[..., i, :] = out[2]
    torch.cuda.synchronize()
    what = f"FusedTickRun with monitor slots, {LANES if lanes else 1} lane(s)"
    require(ops.LAUNCHES["fused_tick"] == ticks, f"{what}: {ops.LAUNCHES}")
    err = 0.0
    for name, a, b in zip(("v", "u", "ring", "rows", "count", "level"), state, plain):
        require(torch.equal(a, b), f"{what}: {name} differs from the plain version")
        err = max(err, _held(a, b))
    require(not torch.equal(state[5], level), f"{what}: the level never moved")
    bare = ops.FusedTickRun(payload, v.clone(), u.clone(), ring.clone(), is_gen, p.a, p.b,
                            p.c, p.d, rows.clone(), t0=t0)
    step = (lambda r: (lambda: r.tick(0))) if lanes else (lambda r: (lambda: r.tick(0, 100)))
    with_us = device_ms(step(runs), "fused_tick_kernel", reps=200) * 1e3
    none_us = device_ms(step(bare), "fused_tick_kernel", reps=200) * 1e3
    log(f"[monitors] {what}: {ticks} ticks bit for bit the plain version; device "
        f"{with_us:.3f} us a tick with the slots, {none_us:.3f} without")
    return {"device_us_slots": with_us, "device_us_none": none_us, "max_abs_err": err}


def _require_same_telemetry(a: dict, b: dict, what: str) -> None:
    for name in ("spike_count", "group_rate"):
        x, y = a[name].cpu(), b[name].cpu()
        require(x.dtype == y.dtype and torch.equal(x, y),
                f"{what}: {name} differs (max abs err {max_err(x.float(), y.float())})")


def _monitored_cell(cfg, policy, propagation, backend, dev, totals) -> dict:
    """Phase 9a, one cell: ``record="both"`` for MON_TICKS ticks on the card
    (warmed up, timed, launch counts reset just before and read just after)
    against the CPU port's ``record="monitors"`` (telemetry bit for bit), the
    card's ``"raster"`` run (the same raster), and the raster's group sums
    (the SpikeCount totals)."""
    from repro_torch.configs.synfire4 import build_synfire
    from repro_torch.core.engine import run
    from repro_torch.kernels import ops

    net = build_synfire(cfg, policy=policy, propagation=propagation, backend=backend,
                        device=dev)
    run(net.static, net.params, net.state0, 20, record="both")
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    _, out = run(net.static, net.params, net.state0, MON_TICKS, record="both")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    want = _fused_launches(MON_TICKS) if backend else _static_launches(net, MON_TICKS)
    what = f"{cfg.name} {policy}/{propagation} backend={backend} monitors"
    require(launches == want, f"{what}: launches {launches} != {want}")
    _add(totals, launches)
    _, raster = run(net.static, net.params, net.state0, MON_TICKS)
    _require_same_raster(out["spikes"].cpu(), raster["spikes"].cpu(), f"{what}: both vs raster")
    sp = out["spikes"]
    sums = [int(sp[:, g.start:g.start + g.size].sum()) for g in net.static.groups]
    tel = out["telemetry"]
    require(tel["spike_count"].tolist() == sums, f"{what}: counts {tel['spike_count']} "
            f"!= raster group sums {sums}")
    require(cfg.name == "synfire4", f"no CPU reference of {cfg.name}'s monitors")
    cpu = cpu_ref(f"mon/{policy}/{propagation}/{backend}")
    _require_same_telemetry(tel, cpu, f"{what}: card vs CPU port")
    total = int(tel["spike_count"].sum())
    log(f"[monitors] {what}: card telemetry == CPU port's, raster == record='raster' run's, "
        f"counts == raster group sums; {total} spikes, {seconds / MON_TICKS * 1e6:.1f} us/tick")
    return {"us_per_tick": seconds / MON_TICKS * 1e6, "spikes": total, "seconds": seconds,
            "launches": launches, "net": net, "telemetry": tel}


def _events_and_overhead(net, marker: str) -> dict:
    """Phase 9b, one cell: device events per tick in the tick loop with
    ``record="monitors"`` and ``"none"`` (equal: a ``require``), and host
    us/tick of MON_TICKS-tick runs in interleaved turns, none then
    monitors, MON_REPS times."""
    from repro_torch.core.engine import run

    gu = torch.rand((MON_EVENT_TICKS, net.static.n_gen), device=net.state0.ring.device)
    events = {}
    for record in ("none", "monitors"):
        events[record] = _loop_events(
            lambda: run(net.static, net.params, net.state0, MON_EVENT_TICKS, gen_u=gu,
                        record=record), MON_EVENT_TICKS, marker)
    require(events["none"][1] is not None and events["monitors"][1] == events["none"][1],
            f"device events per tick in the loop: monitors {events['monitors']} vs none "
            f"{events['none']}")
    walls = {"none": [], "monitors": []}
    for _ in range(MON_REPS):
        for record in ("none", "monitors"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run(net.static, net.params, net.state0, MON_TICKS, record=record)
            torch.cuda.synchronize()
            walls[record].append((time.perf_counter() - t0) / MON_TICKS * 1e6)
    med = {k: sorted(v)[len(v) // 2] for k, v in walls.items()}
    return {"events_per_tick_all": {k: e[0] for k, e in events.items()},
            "events_per_tick_loop": {k: e[1] for k, e in events.items()},
            "us_per_tick_none": walls["none"], "us_per_tick_monitors": walls["monitors"],
            "median_ratio": med["monitors"] / med["none"]}


def _lanes_monitored(dev, propagation, backend, totals) -> dict:
    """Phase 9c: ``run_batch(MON_TICKS, 64, record="monitors")`` on Synfire4
    fp16 (``budget=None``): the launch counts of the unmonitored batch, every
    checked lane's telemetry equal to its solo run's; timed in turns with
    the unmonitored batch (medians)."""
    from repro_torch.configs.synfire4 import SYNFIRE4, build_synfire
    from repro_torch.core import rng
    from repro_torch.core.engine import run, run_batch
    from repro_torch.kernels import ops

    net = build_synfire(SYNFIRE4, policy="fp16", propagation=propagation, backend=backend,
                        device=dev, budget=None)
    run_batch(net.static, net.params, net.state0, 20, LANES, record="monitors")
    walls = {"none": [], "monitors": []}
    for _ in range(MON_BATCH_REPS):
        for record in ("none", "monitors"):
            torch.cuda.synchronize()
            ops.reset_launches()
            t0 = time.perf_counter()
            _, out = run_batch(net.static, net.params, net.state0, MON_TICKS, LANES,
                               record=record)
            torch.cuda.synchronize()
            walls[record].append(time.perf_counter() - t0)
            launches = dict(ops.LAUNCHES)
    walls = {k: sorted(v)[len(v) // 2] for k, v in walls.items()}  # medians
    want = _fused_launches(MON_TICKS) if backend else _static_launches(net, MON_TICKS)
    what = f"run_batch({MON_TICKS}, {LANES}) fp16 {propagation} backend={backend} monitors"
    require(launches == want, f"{what}: launches {launches} != {want}")
    _add(totals, launches)
    tel = out["telemetry"]
    require(tuple(tel["spike_count"].shape) == (LANES, len(net.static.groups)), what)
    keys = rng.split(net.state0.key, LANES)
    for b in (0, 21, 63):
        solo = run(net.static, net.params, net.state0._replace(key=keys[b]), MON_TICKS,
                   record="monitors")[1]["telemetry"]
        _require_same_telemetry({k: v[b] for k, v in tel.items()}, solo, f"{what} lane {b}")
    per_lane = tel["spike_count"].sum(dim=1)
    require(bool(((per_lane >= 20_000) & (per_lane <= 33_000)).all()),
            f"{what}: lane spikes {per_lane.min()}-{per_lane.max()} outside 20,000-33,000")
    log(f"[monitors] {what}: lanes 0, 21, 63 == solo runs; median of {MON_BATCH_REPS} turns "
        f"{walls['monitors'] / MON_TICKS * 1e6:.1f} us/tick "
        f"({walls['none'] / MON_TICKS * 1e6:.1f} without monitors)")
    return {"us_per_tick": walls["monitors"] / MON_TICKS * 1e6,
            "us_per_tick_none": walls["none"] / MON_TICKS * 1e6,
            "lane_ticks_per_s": LANES * MON_TICKS / walls["monitors"], "launches": launches}


def _scheduler_monitored(dev, tmp) -> dict:
    """Phase 9c: a ``LaneScheduler(64)`` under its default
    ``record="monitors"`` on Synfire4 fp16 sparse: MON_TENANTS tenants, five
    chunks of 100 ticks with a flush of every tenant after chunk 2; after
    chunk 3 two tenants are evicted to solo sessions (their final flush
    kept) and two moved to a second scheduler through ``save_lane``/
    ``restore_lane``. Each tenant's flushes sum to its uninterrupted
    session's one flush, and its last filter level is that session's."""
    import zlib

    from repro_torch.configs.synfire4 import SYNFIRE4, build_synfire
    from repro_torch.serve import LaneScheduler, Session, restore_lane, save_lane

    net = build_synfire(SYNFIRE4, policy="fp16", propagation="sparse", device=dev,
                        budget=None)
    sched, small = LaneScheduler(net, LANES), LaneScheduler(net, 8, ledger_key="small")
    ids = [f"tenant{i}" for i in range(MON_TENANTS)]
    for sid in ids:
        sched.admit(sid)
    flushes = {sid: [] for sid in ids}
    solos = {}
    t0 = time.perf_counter()
    for c in range(5):
        sched.step(100)
        if small.occupancy:
            small.step(100)
        for sid, sess in solos.items():
            sess.run(100)
        if c == 1:
            for sid in sched.session_ids:
                flushes[sid].append(sched.flush(sid))
        if c == 2:
            for sid in ids[:2]:
                ev = sched.evict(sid)
                flushes[sid].append(ev.flush)
                solos[sid] = Session.create(net, key=ev.gen_key, state=ev.state)
            for k, sid in enumerate(ids[2:4]):
                d = str(Path(tmp) / f"lane{k}")
                save_lane(d, sched.export(sid))
                small.restore(restore_lane(d, net))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for sid in ids:
        if sid in solos:
            flushes[sid].append(solos[sid].flush())
        else:
            flushes[sid].append((small if sid in small.session_ids else sched).flush(sid))
    for sid in ids:
        solo = Session.create(net, seed=zlib.crc32(sid.encode()))
        solo.run(500)
        want = solo.flush()
        got = sum(f["spike_count"].astype("int64") for f in flushes[sid])
        require((got == want["spike_count"]).all() and sum(f["n_ticks"] for f in flushes[sid])
                == 500, f"scheduler tenant {sid}: flushes sum to {got}, the uninterrupted "
                f"session's {want['spike_count']}")
        # An evicted tenant's solo session starts a fresh filter; the others
        # carry theirs through the moves.
        require(sid in solos or (flushes[sid][-1]["group_rate"] == want["group_rate"]).all(),
                f"scheduler tenant {sid}: last filter level differs from the session's")
    log(f"[monitors] LaneScheduler({LANES}) record='monitors': {MON_TENANTS} tenants' flushes "
        f"sum to their uninterrupted sessions' through evicts and save_lane moves; "
        f"{wall:.2f} s for 5 chunks; serve bytes {net.ledger.serve_bytes()}")
    return {"seconds_5_chunks": wall, "serve_bytes": net.ledger.serve_bytes(),
            "session_bytes": sched.session_bytes}


def _paper_metrics(cells: dict, dev) -> dict:
    """Phase 9d: the paper's three numbers from the card's telemetry, as
    ``benchmarks/report.py`` computes them: fp16 vs fp32 spike-count
    accuracy of 1 s of Synfire4 (at least 0.97), the real-time factor of
    Synfire4 and of the mini on both backends (warm runs), and the energy
    model's rows for the M33 and the Pi Zero 2 W (a model: no card power)."""
    from repro_torch.configs.synfire4 import SYNFIRE4_MINI, build_synfire
    from repro_torch.core.engine import run
    from repro_torch.core.sizing import M33, PI_ZERO_2W
    from repro_torch.telemetry import metrics, summarize

    out = {}
    for propagation in ("packed", "sparse"):
        for backend in (None, "fused"):
            c16 = cells[("fp16", propagation, backend)]
            c32 = cells[("fp32", propagation, backend)]
            acc = metrics.spike_count_accuracy(c16["spikes"], c32["spikes"])
            require(acc >= 0.97, f"fp16 accuracy {acc} < 0.97 ({propagation}, {backend})")
            out[f"accuracy/{propagation}/{backend or 'default'}"] = acc
    nets = {("synfire4", b): (cells[("fp16", "sparse", b)]["net"],
                              cells[("fp16", "sparse", b)]["telemetry"],
                              cells[("fp16", "sparse", b)]["seconds"]) for b in (None, "fused")}
    for backend in (None, "fused"):
        net = build_synfire(SYNFIRE4_MINI, policy="fp16", backend=backend, device=dev)
        run(net.static, net.params, net.state0, MON_TICKS, record="monitors")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, o = run(net.static, net.params, net.state0, MON_TICKS, record="monitors")
        torch.cuda.synchronize()
        nets[("synfire4_mini", backend)] = (net, o["telemetry"], time.perf_counter() - t0)
    for (label, backend), (net, tel, wall) in nets.items():
        s = summarize(net.static, tel, MON_TICKS)
        events = metrics.synaptic_events(net.static, tel["spike_count"].numpy())
        kw = dict(n_neurons=net.n_neurons, fanin=net.n_synapses / net.n_neurons,
                  synaptic_events=events, model_time_s=s["model_time_s"],
                  mean_rate_hz=s["mean_rate_hz"])
        reps = {hw.name: metrics.energy_report(hw, **kw) for hw in (M33, PI_ZERO_2W)}
        key = f"{label}/{backend or 'default'}"
        out[key] = {"realtime_factor_card": metrics.realtime_factor(s["model_time_s"], wall),
                    "total_spikes": s["total_spikes"], "mean_rate_hz": s["mean_rate_hz"],
                    "synaptic_events": events,
                    **{name: r.as_dict() for name, r in reps.items()},
                    "mcu_vs_pi": metrics.energy_comparison(reps[M33.name],
                                                          reps[PI_ZERO_2W.name])}
        log(f"[monitors] {key}: real-time factor on the card "
            f"{out[key]['realtime_factor_card']:.1f}, M33 {reps[M33.name].realtime_factor:.3f}"
            f", {s['total_spikes']} spikes, {events:.0f} synaptic events")
    return out


def phase_monitors(dev, rows: list, totals: dict) -> dict:
    """Phase 9: in-run monitors. (a) Synfire4 fp16/fp32 x packed/sparse x
    default/fused, 1,000 ticks of record="both"; (b) device events per tick
    with monitors as without, host us/tick in turns, B1/B4 held with the
    slots against their plain versions at one lane and 64 and timed with
    and without; (c) monitored run_batch(1000, 64) and a monitored
    LaneScheduler(64); (d) the paper's metrics from the card's telemetry."""
    import tempfile

    from repro_torch.configs.synfire4 import SYNFIRE4

    g = torch.Generator(device="cpu").manual_seed(91)
    paths, cells = {}, {}
    for propagation in ("packed", "sparse"):
        for policy in ("fp16", "fp32"):
            for backend in (None, "fused"):
                cell = _monitored_cell(SYNFIRE4, policy, propagation, backend, dev, totals)
                cells[(policy, propagation, backend)] = cell
                paths[f"monitors/synfire4/{policy}/{propagation}/{backend or 'default'}"] = {
                    k: cell[k] for k in ("us_per_tick", "spikes", "launches")}
    slots = {"izh4_update": {}, "fused_tick": {}}
    for propagation in ("packed", "sparse"):
        for backend in (None, "fused"):
            net = cells[("fp16", propagation, backend)]["net"]
            marker = "fused_tick_kernel" if backend else "izh4_run_kernel"
            res = _events_and_overhead(net, marker)
            paths[f"monitors/synfire4/fp16/{propagation}/{backend or 'default'}"].update(res)
            log(f"[monitors] fp16 {propagation} backend={backend}: device events per tick in "
                f"the loop {res['events_per_tick_loop']}, all {res['events_per_tick_all']}; "
                f"host us/tick none {res['us_per_tick_none']} monitors "
                f"{res['us_per_tick_monitors']}")
    for lanes in (None, LANES):
        key = f"{LANES if lanes else 1}_lanes"
        slots["izh4_update"][key] = _hold_neuron_slots(
            cells[("fp16", "sparse", None)]["net"], g, dev, lanes)
        slots["fused_tick"][key] = _hold_fused_slots(
            cells[("fp16", "packed", "fused")]["net"], g, dev, lanes)
    for r in rows:
        if r["name"] in slots:
            r["monitors"] = slots[r["name"]]
    for propagation, backend in (("sparse", None), ("packed", None), ("sparse", "fused")):
        paths[f"monitors/run_batch/fp16/{propagation}/{backend or 'default'}"] = (
            _lanes_monitored(dev, propagation, backend, totals))
    with tempfile.TemporaryDirectory() as tmp:
        paths["monitors/scheduler/synfire4/fp16/sparse"] = _scheduler_monitored(dev, tmp)
    paths["monitors/paper_metrics"] = _paper_metrics(cells, dev)
    return paths


def phase_monitors_fresh(rows: list, totals: dict) -> dict:
    """Phase 9 in a process of its own (``chip_smoke.py --monitors-json
    PATH``), as phase 8 is: its device-event counts need a profiler that
    records every kernel. Its rows, paths and launch counts join this
    run's."""
    import tempfile

    from repro_torch.kernels import ops

    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "monitors.json"
        subprocess.run([sys.executable, str(Path(__file__).resolve()), "--monitors-json",
                        str(out)], check=True, timeout=600)
        res = json.loads(out.read_text())
    for r in rows:
        if r["name"] in res["rows"]:
            r["monitors"] = res["rows"][r["name"]]
    require(set(res["totals"]) == set(ops.LAUNCHES), f"phase 9 counts {res['totals']}")
    _add(totals, res["totals"])
    return res["paths"]


def _monitors_main(out: str) -> int:
    """``--monitors-json PATH``: phase 9 alone, written to ``PATH`` as JSON."""
    from repro_torch.kernels import _build, ops

    _build.build()
    rows = [{"name": name} for name in ("izh4_update", "fused_tick")]
    totals = {k: 0 for k in ops.LAUNCHES}
    paths = phase_monitors(torch.device("cuda", 0), rows, totals)
    Path(out).write_text(json.dumps({"rows": {r["name"]: r["monitors"] for r in rows},
                                     "paths": paths, "totals": totals}))
    return 0


# -- phase 10: observability (watches, quarantine and replay, the obs plane) ----------

OBS_TICKS = 1000
WATCH_SLOT_TICKS = 12  # chained ticks per slot case: ring slots wrap past L = 11
OBS_TENANTS = 16
OBS_FLIGHT = 4
OBS_REPS = 5  # interleaved turns of obs on and off
WATCH_TURNS = 3  # interleaved device timings with and without the watch slots


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal bit for bit, NaNs included (a NaN in the same place equals)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if not a.is_floating_point():
        return torch.equal(a, b)
    nan = a.isnan()
    return torch.equal(nan, b.isnan()) and torch.equal(a[~nan], b[~nan])


def _require_state_bits(a, b, what) -> None:
    """Two NetStates equal bit for bit in every tensor (NaNs in the same
    places equal): the tick, neurons, ring, key, weights and traces."""
    def leaves(st):
        out = [("ring", st.ring), ("key", st.key)]
        out += [(f"neurons.{f}", x) for f, x in zip(st.neurons._fields, st.neurons)]
        out += [(f"weights.{j}", w) for j, w in enumerate(st.weights)]
        out += [(f"stdp.{j}.{f}", x) for j, tr in enumerate(st.stdp) if tr is not None
                for f, x in zip(tr._fields, tr)]
        return out

    require(a.t == b.t, f"{what}: tick {a.t} vs {b.t}")
    for (name, x), (_, y) in zip(leaves(a), leaves(b)):
        require(_same_bits(x.cpu(), y.cpu()), f"{what}: {name} differs")


def _watch_inputs(g, lead, n, dev):
    """Random watch slots over ``lead`` lanes: a RateBand count, a Silent's
    {last, gap, flags} words and a NonFinite's {ticks, 0, flags} words (the
    flags clear, as a run starts them)."""
    count = torch.randint(0, 50, (*lead, n), generator=g, dtype=torch.int32)
    zero = torch.zeros(lead, dtype=torch.int32)
    silent = torch.stack([-1 - torch.randint(0, 30, lead, generator=g, dtype=torch.int32),
                          torch.randint(0, 60, lead, generator=g, dtype=torch.int32),
                          zero, zero], -1)
    bad = torch.stack([torch.randint(0, 5, lead, generator=g, dtype=torch.int32),
                       zero, zero, zero], -1)
    return [x.to(torch.int32).contiguous().to(dev) for x in (count, silent, bad)]


def _poison_lanes(v, ring, gen, lanes: bool) -> None:
    """In place: lane 0 a NaN membrane; over lanes, lane 1 a membrane stored
    as inf (an fp16 value past 65,504; an f32 one at inf), lane 2 at rest
    with no input (it never spikes) and lane 3's ring at -65,504 (with one
    substep its f32 membrane lands finite past -65,504, which fp16 stores
    as -inf)."""
    first = v[0] if lanes else v
    first[-7] = float("nan")  # a neuron of the last group, not a generator
    if lanes:
        v[1, -20] = float("inf")
        v[2] = -70.0
        ring[2] = 0.0
        gen[2] = False
        ring[3] = -65504.0


def _slot_times(with_slots, without, marker: str) -> dict:
    """Device time (us) of one launch with the watch slots and without, in
    WATCH_TURNS interleaved turns of 100 launches each: the medians, and
    their ratio."""
    times = {"watch": [], "none": []}
    for _ in range(WATCH_TURNS):
        for key, fn in (("watch", with_slots), ("none", without)):
            times[key].append(device_ms(fn, marker, reps=100) * 1e3)
    med = {k: sorted(v)[len(v) // 2] for k, v in times.items()}
    return {"device_us_watch": med["watch"], "device_us_none": med["none"],
            "ratio": med["watch"] / med["none"], "turns": times}


def _hold_neuron_watch_slots(net, g, dev, lanes, substeps: int) -> dict:
    """``ops.NeuronRun`` with the watch slots (and the monitor slots) for 12
    chained ticks on random state with the poisoned lanes, one lane or 64:
    bit for bit its plain version with the same slots, NaNs in place; the
    silent lane's gap grows, the NaN lane's bad ticks count; device time of
    a tick with and without the watch slots."""
    from repro_torch.core.neurons import NeuronModel
    from repro_torch.kernels import ops, ref

    static, params = net.static, net.params
    n, dtype, ticks = static.n, net.state0.neurons.v.dtype, WATCH_SLOT_TICKS
    lead = () if lanes is None else (LANES,)
    v = (torch.rand((*lead, n), generator=g) * 115 - 80).to(dtype)
    u = (torch.rand((*lead, n), generator=g) * 10 - 15).to(dtype)
    ring = (torch.rand((*lead, *net.state0.ring.shape), generator=g) * 12).to(dtype)
    gen = torch.rand((*lead, ticks, static.n_gen), generator=g) < 0.3
    _poison_lanes(v, ring, gen, lanes is not None)
    if lanes:
        u[2] = -14.0
    v, u, ring, gen = v.to(dev), u.to(dev), ring.to(dev), gen.to(dev)
    refrac = torch.zeros((*lead, n), dtype=torch.int16, device=dev)
    count, level, rate = _slot_inputs(g, net, (*lead, n), dev)
    w_count, w_silent, w_bad = _watch_inputs(g, lead, n, dev)
    t0 = _lane_t0() if lanes else None
    p = params.neuron
    is_gen = p.model == NeuronModel.GENERATOR
    cols = _gen_cols(static, dev)
    slots = [x.clone() for x in (count, level, w_count, w_silent, w_bad)]
    k_ring = ring.clone()
    kw = dict(gen_spk=gen, gen_cols=cols, dt=static.dt, substeps=substeps, t0=t0)
    run = ops.NeuronRun(v, u, refrac, k_ring, is_gen, p.a, p.b, p.c, p.d, tel_count=slots[0],
                        tel_rate=slots[1], rate=rate, w_count=slots[2], w_silent=slots[3],
                        w_bad=slots[4], **kw)
    require(run.launcher is not None, "NeuronRun with watch slots: no launcher on the card")
    pv, pu, pr, p_ring = v.clone(), u.clone(), refrac.clone(), ring.clone()
    plain = [x.clone() for x in (count, level, w_count, w_silent, w_bad)]
    spikes = torch.zeros((*lead, n), device=dev)
    pk = dict(tel_count=plain[0], tel_rate=plain[1], rate=rate, w_count=plain[2],
              w_silent=plain[3], w_bad=plain[4], dt=static.dt, substeps=substeps)
    for i in range(ticks):
        if lanes:
            run(i)
            ref.neuron_lanes_ref(pv, pu, pr, p_ring, [(t + i) % static.ring_len for t in t0],
                                 is_gen, p.a, p.b, p.c, p.d, cols, spikes, gen_rows=gen[:, i],
                                 step=i, **pk)
        else:
            run(i, 100 + i)
            ref.neuron_run_ref(pv, pu, pr, p_ring, (100 + i) % static.ring_len, is_gen, p.a,
                               p.b, p.c, p.d, cols, spikes, gen_row=gen[i], step=i, **pk)
    torch.cuda.synchronize()
    what = (f"NeuronRun with watch slots, {dtype}, {LANES if lanes else 1} lane(s), "
            f"substeps {substeps}")
    err = 0.0
    for name, a, b in (("v", run.v, pv), ("u", run.u, pu), ("ring", k_ring, p_ring),
                       *zip(("count", "level", "w_count", "w_silent", "w_bad"), slots, plain)):
        require(_same_bits(a, b), f"{what}: {name} differs from the plain version")
        err = max(err, _held(a, b))
    bad = (slots[4] - w_bad)[..., 0].reshape(-1)  # the ticks folded: all but the last
    require(int(bad[0]) >= ticks - 2, f"{what}: the NaN lane counted {int(bad[0])} bad ticks")
    if lanes:
        require(int(bad[1]) > 0, f"{what}: the inf lane counted no bad tick")
        require(torch.equal(slots[3][2], w_silent[2]), f"{what}: the silent lane spiked")
        if substeps == 1 and dtype == torch.float16:
            require(int(bad[3]) > 0, f"{what}: the overflowed lane counted no bad tick")
    out = {"max_abs_err": err, "bad_ticks_lane0": int(bad[0])}
    if substeps == static.substeps:
        bare = ops.NeuronRun(v, u, refrac, ring.clone(), is_gen, p.a, p.b, p.c, p.d,
                             tel_count=count.clone(), tel_rate=level.clone(), rate=rate, **kw)
        step = (lambda r: (lambda: r(0))) if lanes else (lambda r: (lambda: r(0, 100)))
        out.update(_slot_times(step(run), step(bare), "izh4_run_kernel"))
    log(f"[watches] {what}: {ticks} ticks bit for bit the plain version (NaN, inf, silent and "
        f"overflow lanes); {out}")
    return out


def _hold_fused_watch_slots(net, g, dev, lanes) -> dict:
    """``ops.FusedTickRun`` with the watch slots for 12 ticks on random state
    with the poisoned lanes (one lane, or 64 at their own ring slots): bit
    for bit its plain version, still one launch a tick; device time of a
    tick with and without the watch slots."""
    from repro_torch.core import backend as be
    from repro_torch.core.neurons import NeuronModel
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.fused_tick import assemble_kernel

    static, params = net.static, net.params
    n, dtype, ticks = static.n, net.state0.neurons.v.dtype, WATCH_SLOT_TICKS
    lead = () if lanes is None else (LANES,)
    payload = assemble_kernel(static, params, be.assemble_packed(static, net.state0.weights))
    v = (torch.rand((*lead, n), generator=g) * 100 - 75).to(dtype)
    u = (torch.rand((*lead, n), generator=g) * 10 - 15).to(dtype)
    ring = (torch.rand((*lead, static.ring_len, n), generator=g) * 10).to(dtype)
    rows = torch.rand((*lead, ticks, n), generator=g) < 0.2
    p = params.neuron
    is_gen = (p.model == NeuronModel.GENERATOR).cpu()
    _poison_lanes(v, ring, rows, lanes is not None)
    if lanes:
        u[2] = -14.0
        ring[3] = 0.0  # the overflow lane is the one-substep case of B1
    is_gen = is_gen.to(dev)
    v, u, ring, rows = v.to(dev), u.to(dev), ring.to(dev), rows.to(dev)
    w_count, w_silent, w_bad = _watch_inputs(g, lead, n, dev)
    t0 = _lane_t0() if lanes else None
    state = [x.clone() for x in (v, u, ring, rows, w_count, w_silent, w_bad)]
    plain = [x.clone() for x in state]
    runs = ops.FusedTickRun(payload, *state[:3], is_gen, p.a, p.b, p.c, p.d, state[3], t0=t0,
                            w_count=state[4], w_silent=state[5], w_bad=state[6])
    require(runs.launcher is not None, "FusedTickRun with watch slots: no launcher on the card")
    kw = dict(dense=payload.dense, csr=payload.csr, ring_len=static.ring_len,
              w_count=plain[4], w_silent=plain[5], w_bad=plain[6])
    ops.reset_launches()
    for i in range(ticks):
        pv, pu, pring, prows = plain[:4]
        if lanes:
            runs.tick(i)
            out = ref.fused_tick_lanes_ref(pv, pu, pring, prows[:, i], is_gen, p.a, p.b, p.c,
                                           p.d, [t + i for t in t0], step=i, **kw)
        else:
            runs.tick(i, 100 + i)
            out = ref.fused_tick_ref(pv, pu, pring, prows[i], is_gen, p.a, p.b, p.c, p.d,
                                     100 + i, step=i, **kw)
        pv.copy_(out[0])
        pu.copy_(out[1])
        pring.copy_(out[3])
        prows[..., i, :] = out[2]
    torch.cuda.synchronize()
    what = f"FusedTickRun with watch slots, {LANES if lanes else 1} lane(s)"
    require(ops.LAUNCHES["fused_tick"] == ticks, f"{what}: {ops.LAUNCHES}")
    err = 0.0
    for name, a, b in zip(("v", "u", "ring", "rows", "w_count", "w_silent", "w_bad"), state,
                          plain):
        require(_same_bits(a, b), f"{what}: {name} differs from the plain version")
        err = max(err, _held(a, b))
    bad = (state[6] - w_bad)[..., 0].reshape(-1)  # the ticks folded: all but the last
    require(int(bad[0]) >= ticks - 2, f"{what}: the NaN lane counted {int(bad[0])} bad ticks")
    if lanes:
        require(int(bad[1]) > 0, f"{what}: the inf lane counted no bad tick")
        require(torch.equal(state[5][2], w_silent[2]), f"{what}: the silent lane spiked")
    bare = ops.FusedTickRun(payload, v.clone(), u.clone(), ring.clone(), is_gen, p.a, p.b,
                            p.c, p.d, rows.clone(), t0=t0)
    step = (lambda r: (lambda: r.tick(0))) if lanes else (lambda r: (lambda: r.tick(0, 100)))
    out = {"max_abs_err": err, "bad_ticks_lane0": int(bad[0]),
           **_slot_times(step(runs), step(bare), "fused_tick_kernel")}
    log(f"[watches] {what}: {ticks} ticks bit for bit the plain version; {out}")
    return out


def _require_same_carry(a, b, what, rtol=None) -> float:
    """Two watch carries equal slot for slot (bit for bit, or float slots at
    ``rtol``); returns the largest relative error of the float slots."""
    worst = 0.0
    for k, (x, y) in enumerate(zip(a, b)):
        for j, (p, q) in enumerate(zip(x, y)):
            p, q = p.cpu(), q.cpu()
            if rtol is not None and p.is_floating_point():
                err = float(((p - q).abs() / q.abs().clamp_min(1e-30)).max()) if p.numel() else 0.0
                worst = max(worst, err)
                require(err <= rtol, f"{what}: slot {k}.{j} off by {err} (rtol {rtol})")
            else:
                require(_same_bits(p, q), f"{what}: slot {k}.{j} differs: {p} vs {q}")
    return worst


def _watched_cell(cfg, policy, propagation, backend, dev, totals) -> dict:
    """Phase 10a, one cell: the net with the default watches and without,
    ``record="both"`` for OBS_TICKS ticks on the card: raster, telemetry and
    final state equal, the same launches; the watch carry equal to the CPU
    port's bit for bit; device events per tick in the tick loop with
    watches equal to those without."""
    from repro_torch.configs.synfire4 import build_synfire
    from repro_torch.core.engine import run
    from repro_torch.kernels import ops

    kw = dict(policy=policy, propagation=propagation, backend=backend)
    nets = {w: build_synfire(cfg, watches=w, device=dev, **kw) for w in ("default", None)}
    outs, launches = {}, {}
    for w, net in nets.items():
        run(net.static, net.params, net.state0, 20, record="both")
        torch.cuda.synchronize()
        ops.reset_launches()
        outs[w] = run(net.static, net.params, net.state0, OBS_TICKS, record="both")
        torch.cuda.synchronize()
        launches[w] = dict(ops.LAUNCHES)
    what = f"{cfg.name} {policy}/{propagation} backend={backend} watches"
    require(launches["default"] == launches[None], f"{what}: launches {launches}")
    _add(totals, launches["default"])
    (fw, ow), (fn, on) = outs["default"], outs[None]
    _require_same_raster(ow["spikes"].cpu(), on["spikes"].cpu(), f"{what}: watched vs bare")
    _require_same_telemetry(ow["telemetry"], on["telemetry"], f"{what}: watched vs bare")
    _require_same_state(fw, fn, what)
    require(cfg.name == "synfire4", f"no CPU reference of {cfg.name}'s watches")
    cpu = cpu_ref(f"watch/{policy}/{propagation}/{backend}")
    _require_same_carry(ow["watch_carry"], cpu["watch_carry"], f"{what}: card vs CPU port")
    res = {"spikes": int(ow["spikes"].sum()), "launches": launches["default"],
           "carry": [[x.cpu().tolist() if x.numel() < 8 else int(x.sum()) for x in c]
                     for c in ow["watch_carry"]]}
    marker = "fused_tick_kernel" if backend else "izh4_run_kernel"
    ev = {}
    for w, net in nets.items():
        gu = torch.rand((MON_EVENT_TICKS, net.static.n_gen), device=dev)
        ev[w] = _loop_events(lambda: run(net.static, net.params, net.state0, MON_EVENT_TICKS,
                                         gen_u=gu, record="none"), MON_EVENT_TICKS, marker)
    require(ev[None][1] is not None and ev["default"][1] == ev[None][1],
            f"{what}: device events per tick in the loop with watches {ev['default']} "
            f"vs without {ev[None]}")
    res["events_per_tick_loop"] = {"watches": ev["default"][1], "none": ev[None][1]}
    res["events_per_tick_all"] = {"watches": ev["default"][0], "none": ev[None][0]}
    log(f"[watches] {what}: raster, telemetry, state and launches equal the unwatched run's, "
        f"card carry == CPU port's; {res}")
    return res


def _plastic_watched(dev, totals) -> dict:
    """Phase 10c: plastic Synfire4 fp16 sparse with ``NonFinite(weight_stride
    =100)`` and ``WeightDrift()`` for OBS_TICKS ticks: raster and state equal
    the unwatched run's, the card's carry the CPU port's (the norms at
    WeightNorm's rtol 1e-6), and the device events the strided plain checks
    add per 100 ticks."""
    from repro_torch.configs.synfire4 import CHAIN_STDP, SYNFIRE4, build_synfire
    from repro_torch.core.engine import run
    from repro_torch.kernels import ops
    from repro_torch.obs import watch as wat

    specs = (wat.NonFinite(weight_stride=100), wat.WeightDrift())
    kw = dict(policy="fp16", propagation="sparse", stdp_chain=CHAIN_STDP)
    nets = {w: build_synfire(SYNFIRE4, watches=w, device=dev, **kw) for w in (specs, None)}
    outs = {}
    for w, net in nets.items():
        ops.reset_launches()
        outs[w] = run(net.static, net.params, net.state0, OBS_TICKS)
        torch.cuda.synchronize()
        if w is not None:
            _add(totals, dict(ops.LAUNCHES))
    what = "plastic Synfire4 fp16 sparse, NonFinite(weight_stride=100) + WeightDrift()"
    (fw, ow), (fn, on) = outs[specs], outs[None]
    _require_same_raster(ow["spikes"].cpu(), on["spikes"].cpu(), f"{what}: watched vs bare")
    plastic = [j for j, c in enumerate(nets[None].static.stdp) if c is not None]
    _require_same_state(fw, fn, what, plastic)
    cpu = cpu_ref("watch/plastic")
    err = _require_same_carry(ow["watch_carry"], cpu["watch_carry"],
                              f"{what}: card vs CPU port", rtol=1e-6)
    verdicts, _ = wat.drain(nets[specs].static, ow["watch_carry"])
    events = {}
    for w, net in nets.items():
        gu = torch.rand((100, net.static.n_gen), device=dev)
        events[w] = len(_cuda_events(lambda: run(net.static, net.params, net.state0, 100,
                                                 gen_u=gu, record="none"), 1))
    res = {"norms_max_rel_err": err, "verdicts": [v.as_dict() for v in verdicts],
           "device_events_per_100_ticks": {"watches": events[specs], "none": events[None]}}
    log(f"[watches] {what}: raster and state == unwatched, card carry == CPU port's (norms "
        f"rel err {err:.3g}); events per 100 ticks {res['device_events_per_100_ticks']}")
    return res


def _quarantine_path(dev, tmp) -> dict:
    """Phase 10d: ``LaneScheduler(64)`` over Synfire4 fp16 sparse with the
    default watches and ``flight_window=4``, OBS_TENANTS tenants, beside an
    unpoisoned twin: three healthy 100-tick chunks, one tenant's membrane
    NaN'd in place, one more chunk; ``check_watches`` names exactly that
    tenant (NonFinite tripped), the other lanes equal the twin's, the
    tenant is quarantined, dumped and restored, and the replay of its
    first flight snapshot equals its live chunks bit for bit."""
    from repro_torch import serve
    from repro_torch.configs.synfire4 import SYNFIRE4, build_synfire
    from repro_torch.core.lanes import lane_state, set_lane
    from repro_torch.kernels import ops

    net = build_synfire(SYNFIRE4, policy="fp16", propagation="sparse", device=dev,
                        budget=None, watches="default")
    bare = build_synfire(SYNFIRE4, policy="fp16", propagation="sparse", device=dev,
                         budget=None)
    live = serve.LaneScheduler(net, LANES, flight_window=OBS_FLIGHT)
    twin = serve.LaneScheduler(net, LANES, ledger_key="twin")
    ids = [f"tenant{i}" for i in range(OBS_TENANTS)]
    for sid in ids:
        live.admit(sid)
        twin.admit(sid)
    victim = ids[len(ids) // 3]
    ops.reset_launches()
    t0 = time.perf_counter()
    for c in range(4):
        if c == 3:
            lane = live.lane_of(victim)
            st = lane_state(live.states, lane)
            st.neurons.v[-7] = float("nan")  # a neuron of the last group
            live.states = set_lane(live.states, lane, st)
        live.step(SCHED_CHUNK)
        twin.step(SCHED_CHUNK)
        alerts = live.check_watches()
        require(alerts == {} if c < 3 else set(alerts) == {victim},
                f"chunk {c}: check_watches named {sorted(alerts)}")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    require(launches["syn_gather"] == 8 * SCHED_CHUNK and launches["izh4_update"] ==
            8 * SCHED_CHUNK, f"scheduler chunks: launches {launches}")
    require(any(v.watch == "nonfinite" and v.tripped for v in alerts[victim]),
            f"{victim}: {alerts[victim]}")
    for sid in ids:
        if sid != victim:
            _require_state_bits(live.snapshot(sid).state, twin.snapshot(sid).state,
                                f"survivor {sid} vs the unpoisoned twin")
    q = live.quarantine(victim, alerts[victim])
    require(len(q.recording) == OBS_FLIGHT and victim not in live.session_ids,
            f"quarantine: {len(q.recording)} snapshots")
    ddir = serve.dump_quarantine(str(Path(tmp) / "dumps"), q)
    snap = serve.restore_lane(str(Path(ddir) / "final"), net)
    _require_state_bits(snap.state, q.snapshot.state, "the dumped final snapshot")
    sess, _ = serve.replay(net, q.recording[0], SCHED_CHUNK, record="raster")
    _require_state_bits(sess.state, q.recording[1].state, "replay of chunk 2")
    sess.run(SCHED_CHUNK, record="raster")
    _require_state_bits(sess.state, q.recording[2].state, "replay of chunk 3")
    live.step(SCHED_CHUNK)
    twin.step(SCHED_CHUNK)
    for sid in ids:
        if sid != victim:
            _require_state_bits(live.snapshot(sid).state, twin.snapshot(sid).state,
                                f"survivor {sid} after the quarantine")
    require(live.check_watches() == {}, "the fleet after the quarantine")
    bare_sched = serve.LaneScheduler(bare, LANES)
    res = {"seconds_4_chunks_2_schedulers": wall, "launches": launches,
           "verdicts": [v.as_dict() for v in alerts[victim]],
           "session_bytes": live.session_bytes, "session_bytes_none": bare_sched.session_bytes,
           "serve_bytes_delta": LANES * (live.session_bytes - bare_sched.session_bytes)}
    log(f"[watches] LaneScheduler({LANES}) fp16 sparse, {OBS_TENANTS} tenants: {victim} found "
        f"after one chunk, quarantined, dumped, restored and replayed bit for bit; the other "
        f"lanes == the unpoisoned twin's; {res}")
    return res, launches


def _obs_plane(dev) -> dict:
    """Phase 10e: obs on and off give bitwise-equal results (a 1,000-tick
    ``record="both"`` run and a scheduler's chunks and flushes, watches
    drained); host us/tick of 10-chunk sessions with obs on and off in
    turns; the compile and cache-hit counts of a first and a second
    dispatch; the Prometheus text's size; and health_snapshot's status for
    the mini (pass on the M33) and Synfire4 (fail)."""
    from repro_torch import obs, serve
    from repro_torch.configs.synfire4 import SYNFIRE4, SYNFIRE4_MINI, build_synfire
    from repro_torch.core import Engine, rng
    from repro_torch.obs.metrics import MetricsRegistry

    def workload(enabled):
        obs.configure(enabled=enabled, reset=True)
        net = build_synfire(SYNFIRE4, policy="fp16", propagation="sparse", device=dev,
                            budget=None, watches="default")
        final, out = Engine(net).run(OBS_TICKS, gen_base=rng.key(5, dev), record="both")
        sched = serve.LaneScheduler(net, 8)
        for i in range(4):
            sched.admit(f"s{i}", seed=i)
        for _ in range(3):
            sched.step(SCHED_CHUNK)
        flushed = sched.flush_all()
        alerts = sched.check_watches()
        torch.cuda.synchronize()
        return final, out, sched, flushed, alerts

    on, off = workload(True), workload(False)
    _require_same_state(on[0], off[0], "obs on vs off: final state")
    _require_same_raster(on[1]["spikes"].cpu(), off[1]["spikes"].cpu(), "obs on vs off")
    _require_same_telemetry(on[1]["telemetry"], off[1]["telemetry"], "obs on vs off")
    _require_same_carry(on[1]["watch_carry"], off[1]["watch_carry"], "obs on vs off")
    for sid in on[3]:
        for k in on[3][sid]:
            require(torch.equal(torch.as_tensor(on[3][sid][k]), torch.as_tensor(off[3][sid][k])),
                    f"obs on vs off: flush {sid}.{k}")
        _require_same_state(on[2].snapshot(sid).state, off[2].snapshot(sid).state,
                            f"obs on vs off: lane {sid}")
    require(on[4] == off[4] == {}, "obs on vs off: watch alerts")
    # The dispatch classification in a fresh registry: the first run of a
    # mini net of another dtype loads no new library (phase 10a did), so
    # count a first and a second scheduler step instead (the first builds
    # the launchers).
    obs.configure(enabled=True, reset=True)
    mini = build_synfire(SYNFIRE4_MINI, policy="fp16", device=dev, watches="default")
    sched = serve.LaneScheduler(mini, 8)
    sched.admit("a", seed=1)
    sched.step(SCHED_CHUNK)
    first = (obs.registry().counter("repro_compiles_total").value(site="serve.step_lanes"),
             obs.registry().counter("repro_jit_cache_hits_total").value(site="serve.step_lanes"))
    sched.step(SCHED_CHUNK)
    second = (obs.registry().counter("repro_compiles_total").value(site="serve.step_lanes"),
              obs.registry().counter("repro_jit_cache_hits_total").value(site="serve.step_lanes"))
    net = build_synfire(SYNFIRE4, policy="fp16", propagation="sparse", device=dev,
                        budget=None, watches="default")
    walls = {True: [], False: []}
    for _ in range(OBS_REPS):
        for enabled in (False, True):
            obs.configure(enabled=enabled)
            sess = serve.Session.create(net, seed=3)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(10):
                sess.run(SCHED_CHUNK)
            torch.cuda.synchronize()
            walls[enabled].append((time.perf_counter() - t0) / (10 * SCHED_CHUNK) * 1e6)
    obs.configure(enabled=True)
    med = {k: sorted(v)[len(v) // 2] for k, v in walls.items()}
    text = obs.registry().to_prometheus()
    status_mini = obs.health.health_snapshot(mini, registry=MetricsRegistry())["status"]
    status_s4 = obs.health.health_snapshot(net, registry=MetricsRegistry())["status"]
    status_live = obs.health.health_snapshot(mini)["status"]
    require(status_mini == "pass" and status_s4 == "fail",
            f"health_snapshot: mini {status_mini}, Synfire4 {status_s4}")
    res = {"us_per_tick_obs_on": walls[True], "us_per_tick_obs_off": walls[False],
           "median_ratio_on_off": med[True] / med[False],
           "dispatch_after_first_step": first, "dispatch_after_second_step": second,
           "prometheus_bytes": len(text.encode()), "prometheus_series": sum(
               1 for ln in text.splitlines() if ln and not ln.startswith("#")),
           "health_mini": status_mini, "health_synfire4": status_s4,
           "health_live_registry": status_live}
    log(f"[obs] on == off bit for bit (run, lanes, flushes, watches); {res}")
    return res


def phase_obs(dev, rows: list, totals: dict) -> dict:
    """Phase 10: observability. (a) Synfire4 with the default watches, fp16
    and fp32 x packed and sparse x default and fused, 1,000 ticks: equal to
    the unwatched run, the carry equal to the CPU port's, device events per
    tick equal (fp16); (b) B1 and B4 with the watch slots bit for bit their
    plain versions at one lane and 64 with NaN, inf, silent and overflow
    lanes, timed with and without; (c) a plastic net's strided watches
    against the CPU port; (d) quarantine and replay on a 64-lane
    scheduler; (e) the obs plane on and off."""
    import tempfile

    from repro_torch.configs.synfire4 import SYNFIRE4

    g = torch.Generator(device="cpu").manual_seed(101)
    paths, nets = {}, {}
    t0 = time.perf_counter()
    for propagation in ("packed", "sparse"):
        for policy in ("fp16", "fp32"):
            for backend in (None, "fused"):
                paths[f"watches/synfire4/{policy}/{propagation}/{backend or 'default'}"] = (
                    _watched_cell(SYNFIRE4, policy, propagation, backend, dev, totals))
    from repro_torch.configs.synfire4 import build_synfire

    seconds = {"a": time.perf_counter() - t0}
    slots = {"izh4_update": {}, "fused_tick": {}}
    for policy in ("fp16", "fp32"):
        nets[policy] = build_synfire(SYNFIRE4, policy=policy, propagation="sparse", device=dev,
                                     budget=None)
    fused = build_synfire(SYNFIRE4, policy="fp16", propagation="packed", backend="fused",
                          device=dev, budget=None)
    for lanes in (None, LANES):
        key = f"{LANES if lanes else 1}_lanes"
        slots["izh4_update"][key] = _hold_neuron_watch_slots(nets["fp16"], g, dev, lanes, 2)
        slots["izh4_update"][f"{key}_fp32"] = _hold_neuron_watch_slots(nets["fp32"], g, dev,
                                                                       lanes, 2)
        slots["izh4_update"][f"{key}_one_substep"] = _hold_neuron_watch_slots(
            nets["fp16"], g, dev, lanes, 1)
        slots["fused_tick"][key] = _hold_fused_watch_slots(fused, g, dev, lanes)
    for r in rows:
        if r["name"] in slots:
            r["watches"] = slots[r["name"]]
    seconds["b"] = time.perf_counter() - t0 - sum(seconds.values())
    paths["watches/plastic/synfire4/fp16/sparse"] = _plastic_watched(dev, totals)
    seconds["c"] = time.perf_counter() - t0 - sum(seconds.values())
    with tempfile.TemporaryDirectory() as tmp:
        res, launches = _quarantine_path(dev, tmp)
    _add(totals, launches)
    paths["watches/scheduler/synfire4/fp16/sparse"] = res
    seconds["d"] = time.perf_counter() - t0 - sum(seconds.values())
    paths["obs/plane"] = _obs_plane(dev)
    seconds["e"] = time.perf_counter() - t0 - sum(seconds.values())
    paths["obs/phase_seconds"] = seconds
    log(f"[obs] phase 10 seconds by part: {seconds}")
    return paths


def phase_obs_fresh(rows: list, totals: dict) -> dict:
    """Phase 10 in a process of its own (``chip_smoke.py --obs-json PATH``),
    as phases 8 and 9 are. Its rows, paths and launch counts join this
    run's."""
    import tempfile

    from repro_torch.kernels import ops

    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "obs.json"
        subprocess.run([sys.executable, str(Path(__file__).resolve()), "--obs-json",
                        str(out)], check=True, timeout=600)
        res = json.loads(out.read_text())
    for r in rows:
        if r["name"] in res["rows"]:
            r["watches"] = res["rows"][r["name"]]
    require(set(res["totals"]) == set(ops.LAUNCHES), f"phase 10 counts {res['totals']}")
    _add(totals, res["totals"])
    return res["paths"]


def _obs_main(out: str) -> int:
    """``--obs-json PATH``: phase 10 alone, written to ``PATH`` as JSON."""
    from repro_torch.kernels import _build, ops

    _build.build()
    rows = [{"name": name} for name in ("izh4_update", "fused_tick")]
    totals = {k: 0 for k in ops.LAUNCHES}
    paths = phase_obs(torch.device("cuda", 0), rows, totals)
    Path(out).write_text(json.dumps({"rows": {r["name"]: r["watches"] for r in rows},
                                     "paths": paths, "totals": totals}, default=str))
    return 0


# -- partitioning (phase 11) -----------------------------------------------------------

PART_TICKS = 500  # 1,000 until phase 15 came to share the script's time
PART_CELLS = (  # (name, policy, propagation, backend, plastic)
    ("fp32/packed", "fp32", "packed", None, False),
    ("fp16/auto", "fp16", "auto", None, False),
    ("fp32/packed/fused", "fp32", "packed", "fused", False),
    ("plastic/fp32/sparse", "fp32", "sparse", None, True),
    ("plastic/fp16/packed", "fp16", "packed", None, True),
)
PART_X100_TICKS = 200
PART_TWIN_TICKS = 12  # chained ticks per per-core launcher case: ring slots wrap past L = 11
PART_CHUNKS = 10  # 100-tick chunks of the 64-lane sharded scheduler
SNN_TICKS = 100  # 300 until phase 15 came to share the script's time


def _part_launches(plan, ticks: int) -> dict:
    """The launches a partitioned run of ``ticks`` ticks makes: per core and
    tick, one ``izh4_update``, one ``syn_matmul`` per dense bucket, one
    ``syn_gather`` where the core has a sparse bucket, one ``plastic_drive``
    where it owns a plastic projection, one ``stdp_gather`` and one
    ``stdp_update`` where it owns CSR or dense pair-STDP projections."""
    from repro_torch.kernels import ops

    per = {k: 0 for k in ops.LAUNCHES}
    for cp in plan.cores:
        cs = cp.static
        kinds = [b.kind for b in cs.buckets]
        pair = [j for j, c in enumerate(cs.stdp) if c is not None and c.tau_elig is None]
        per["izh4_update"] += 1
        per["syn_matmul"] += kinds.count("dense")
        per["syn_gather"] += int("sparse" in kinds)
        per["plastic_drive"] += int(any(s.plastic or s.stp is not None
                                        for s in cs.projections))
        per["stdp_gather"] += int(any(j in cs.csr_projs for j in pair))
        per["stdp_update"] += int(any(j not in cs.csr_projs for j in pair))
    return {k: v * ticks for k, v in per.items()}


def _engine_run(net, ticks: int, dev, warm: int = 20, **kw):
    """``Engine(net).run(ticks)`` from state0 on the default generator
    stream; on the card warmed up first and timed, the launch counts reset
    just before and read just after. Returns (final, raster or None,
    launches or None, seconds)."""
    from repro_torch.core.engine import Engine
    from repro_torch.kernels import ops

    card = dev.type == "cuda"
    if card and warm:
        Engine(net).run(warm, **kw)
        torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    final, out = Engine(net).run(ticks, **kw)
    if card:
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return (final, out["spikes"].cpu() if "spikes" in out else None,
            dict(ops.LAUNCHES) if card else None, seconds)


def _all_projections(net) -> range:
    return range(len(net.static.projections))


def _part_specs(plastic: bool):
    """Phase 11a's two cuts of a cell: two cores, and a byte budget
    (300,000 B static, 1,000,000 B plastic: the STDP cluster's span)."""
    from repro_torch.core.partition import PartitionSpec

    budget = 1_000_000 if plastic else 300_000
    return (("n_cores=2", PartitionSpec(n_cores=2)),
            (f"budget={budget}", PartitionSpec(core_budget_bytes=budget)))


def _part_kw(policy, propagation, backend, plastic) -> dict:
    from repro_torch.configs.synfire4 import CHAIN_STDP

    return dict(policy=policy, propagation=propagation, backend=backend,
                stdp_chain=CHAIN_STDP if plastic else None)


def _part_cpu_run(kw: dict, spec) -> tuple:
    """The CPU port's partitioned run of a phase 11a cut (a worker process
    of its own, one PyTorch thread): (raster, final state)."""
    from repro_torch.configs.synfire4 import SYNFIRE4, build_synfire
    from repro_torch.core.engine import Engine

    torch.set_num_threads(1)
    net = build_synfire(SYNFIRE4, device="cpu", partition=spec, **kw)
    final, out = Engine(net).run(PART_TICKS)
    return out["spikes"], final


def _part_cell(name, policy, propagation, backend, plastic, dev, totals, cpu_runs) -> dict:
    """Phase 11a: one Synfire4 cell unpartitioned on the card, then cut at
    ``n_cores=2`` and at a byte budget (300,000 B static, 1,000,000 B
    plastic), sequential lowering, 1,000 ticks each: raster, neuron state,
    ring, weights and traces equal the unpartitioned card run's and the
    CPU port's partitioned run's (``cpu_runs[label]``, futures of worker
    processes that run beside the card) bit for bit; launches per tick as
    the plan says; device events per tick."""
    from repro_torch.configs.synfire4 import SYNFIRE4, build_synfire
    from repro_torch.core.engine import Engine

    kw = _part_kw(policy, propagation, backend, plastic)
    base = build_synfire(SYNFIRE4, device=dev, **kw)
    f0, r0, _, s0 = _engine_run(base, PART_TICKS, dev)
    out = {"unpartitioned_us_per_tick": s0 / PART_TICKS * 1e6, "spikes": int(r0.sum())}
    for label, spec in _part_specs(plastic):
        net = build_synfire(SYNFIRE4, device=dev, partition=spec, **kw)
        plan = net.partition
        f1, r1, launches, s1 = _engine_run(net, PART_TICKS, dev)
        want = _part_launches(plan, PART_TICKS)
        require(launches == want, f"partition {name} {label}: launches {launches} != {want}")
        _add(totals, launches)
        what = f"partition {name} {label}"
        _require_same_raster(r1, r0, f"{what} vs the unpartitioned card run")
        _require_same_state(f1, f0, f"{what} vs unpartitioned", plastic=_all_projections(net))
        raster2, f2 = cpu_runs[label].result(timeout=300)
        _require_same_raster(r1, raster2, f"{what} card vs CPU port")
        _require_same_state(f1, f2, f"{what} card vs CPU port", plastic=_all_projections(net))
        events = len(_cuda_events(lambda: Engine(net).run(20), 1)) / 20
        out[label] = {
            "cores": [(c.lo, c.hi) for c in plan.cores],
            "core_bytes": [c.bytes_total for c in plan.cores],
            "exchange_bytes_per_tick": plan.exchange.bytes_per_tick,
            "us_per_tick": s1 / PART_TICKS * 1e6,
            "launches_per_tick": {k: v / PART_TICKS for k, v in launches.items() if v},
            "device_events_per_tick": events}
        log(f"[partition] {name} {label}: cores {out[label]['cores']}, exchange "
            f"{plan.exchange.bytes_per_tick} B/tick, {s1 / PART_TICKS * 1e6:.1f} us/tick "
            f"(unpartitioned {s0 / PART_TICKS * 1e6:.1f}), launches/tick "
            f"{out[label]['launches_per_tick']}, device events/tick {events:.2f}; raster and "
            f"state == unpartitioned card run == CPU port")
    return out


def _core_twins(net_card, net_cpu, what: str) -> dict:
    """Phase 11b: every core's launchers on the card against their plain
    versions over PART_TWIN_TICKS chained ticks: the card's cores and the
    CPU port's, each set driven tick by tick; after phase A each core's
    ``NeuronRun`` (spikes, v, u, refrac, ring), after phase B its
    ``GatherRun`` rows, its ring (``MatmulRun`` and the commits), its
    ``DriveRun`` accumulators and, on the owner core, its
    ``StdpGatherRun``/``StdpUpdateRun`` weights and traces, bit for bit.
    Each card launcher must be a kernel launcher."""
    from repro_torch.core import partition as part

    sets = []
    for net in (net_card, net_cpu):
        plan = net.partition
        sets.append(part._sequential_cores(net.static, plan, plan.run_params, net.state0,
                                           PART_TWIN_TICKS, True)[2])
    card, cpu = sets
    require(all(c.neuron_run.launcher is None for c in cpu),
            f"{what}: the CPU twin's cores must run the plain versions")
    held = {}
    for c in card:
        kinds = [b.kind for b in c.cs.buckets]
        names = ["NeuronRun"] + (["GatherRun"] if "sparse" in kinds else []) + (
            ["MatmulRun"] if "dense" in kinds else []) + (
            ["DriveRun"] if c.drive is not None else []) + [
            type(r).__name__ for r in c.stdp_runs]
        require(c.neuron_run is not None and c.neuron_run.launcher is not None,
                f"{what}: core {c.cp.index} has no izh4_update launcher")
        require("sparse" not in kinds or c.gather.launcher is not None,
                f"{what}: core {c.cp.index} has no syn_gather launcher")
        require(c.drive is None or c.drive.run.launcher is not None,
                f"{what}: core {c.cp.index} has no plastic_drive launcher")
        require(all(r.launcher is not None for r in c.stdp_runs),
                f"{what}: core {c.cp.index} has a plain STDP launcher")
        held[f"core{c.cp.index} [{c.cp.lo}, {c.cp.hi})"] = {
            "launchers": names, "n_ext": c.cp.n_ext,
            "gather_idx": str(c.gather.plan.idx_dtype) if "sparse" in kinds else None}

    def same(a, b, label):
        a, b = a.cpu(), b.cpu()
        require(a.dtype == b.dtype and torch.equal(a, b),
                f"{what}: {label} differs from the plain version, max abs err "
                f"{max_err(a.float(), b.float())}")

    for i in range(PART_TWIN_TICKS):
        for cores in sets:
            for c in cores:
                c.phase_a(i, i)
        for a, b in zip(card, cpu):
            k = a.cp.index
            nr_a, nr_b = a.neuron_run, b.neuron_run
            for label, x, y in (("spikes", a.spikes, b.spikes), ("v", nr_a.v, nr_b.v),
                                ("u", nr_a.u, nr_b.u), ("refrac", nr_a.refrac, nr_b.refrac),
                                ("ring", a.ring, b.ring)):
                same(x, y, f"tick {i} core {k} NeuronRun {label}")
        for cores in sets:
            for c in cores:
                c.phase_b(i)
        for a, b in zip(card, cpu):
            k = a.cp.index
            same(a.gather.rows, b.gather.rows, f"tick {i} core {k} GatherRun rows")
            same(a.ring, b.ring, f"tick {i} core {k} ring (MatmulRun, commits)")
            if a.drive is not None and a.drive.own:
                same(a.drive._own, b.drive._own, f"tick {i} core {k} DriveRun accumulators")
            for ra, rb in zip(a.stdp_runs, b.stdp_runs):
                for pa, pb in zip(ra.projs, rb.projs):
                    same(pa.w, pb.w, f"tick {i} core {k} {type(ra).__name__} weights")
                for n in range(len(ra.projs)):
                    for x, y in zip(ra.traces(n), rb.traces(n)):
                        same(x, y, f"tick {i} core {k} {type(ra).__name__} traces")
    log(f"[partition] {what}: every core's launchers == their plain versions over "
        f"{PART_TWIN_TICKS} chained ticks: {held}")
    return held


def _part_x100(dev, totals) -> dict:
    """Phase 11c: Synfire4x100 fp16 sparse under ``PartitionSpec()`` (the
    MCU budget per core), sequential lowering, PART_X100_TICKS ticks: raster
    and final state equal to the unpartitioned x100 card run's, every
    core's ledger within MCU_BUDGET_BYTES, ``health_snapshot``'s per-core
    checks passing; every core's launchers held against their plain
    versions at these shapes (phase 11b's comparison, on a CPU copy of the
    plan and state); the core count, largest core, exchange bytes per tick,
    us/tick of both (steady state: a 20-tick run's time taken from a
    220-tick run's), device events and launches per tick, peak device
    memory."""
    from repro_torch.configs.synfire4 import SYNFIRE4, build_synfire, scale_synfire
    from repro_torch.core.engine import Engine
    from repro_torch.core.partition import PartitionSpec
    from repro_torch.memory import MCU_BUDGET_BYTES
    from repro_torch.obs.health import health_snapshot

    import dataclasses

    from repro_torch.core.network import _to_device
    from repro_torch.core.partition import plan_partition

    cfg = scale_synfire(SYNFIRE4, 100)
    kw = dict(policy="fp16", propagation="sparse", monitors=None, monitor_ms_hint=0)
    t0 = time.perf_counter()
    base = build_synfire(cfg, device=dev, budget=None, **kw)
    build_s = time.perf_counter() - t0
    # build_synfire(cfg, partition=PartitionSpec()) is this net (its global
    # budget dropped) with the plan: one x100 build serves both runs.
    net = dataclasses.replace(base, partition=plan_partition(base, PartitionSpec()))
    plan_s = time.perf_counter() - t0 - build_s
    plan = net.partition
    require(net.n_neurons == 120_000 and plan.n_cores > 1, f"x100 plan: {plan.n_cores} cores")
    require(all(c.bytes_total <= MCU_BUDGET_BYTES for c in plan.cores),
            f"x100 core bytes {[c.bytes_total for c in plan.cores]} over the MCU budget")
    rows = [c for c in health_snapshot(net)["checks"] if c["name"].startswith("core_bytes")]
    require(len(rows) == plan.n_cores and all(c["status"] == "pass" for c in rows),
            f"x100 health per-core checks {rows}")
    out = {"cores": plan.n_cores, "core_ranges": [(c.lo, c.hi) for c in plan.cores],
           "largest_core_bytes": max(c.bytes_total for c in plan.cores),
           "exchange_bytes_per_tick": plan.exchange.bytes_per_tick,
           "max_import_row": max(c.n_ext for c in plan.cores), "build_s": build_s,
           "plan_s": plan_s}
    # Phase 11b at the x100 cores' shapes: import rows up to 65,000 entries,
    # so int32 gather indices, against the plain versions on a CPU copy of
    # the same plan and state.
    cpu = torch.device("cpu")
    cpu_plan = dataclasses.replace(plan, params=_to_device(plan.params, cpu),
                                   ext_idx=_to_device(plan.ext_idx, cpu))
    cpu_net = dataclasses.replace(net, state0=_to_device(net.state0, cpu), partition=cpu_plan)
    t1 = time.perf_counter()
    out["core_launchers"] = _core_twins(net, cpu_net, "x100 PartitionSpec()")
    out["core_launchers_s"] = time.perf_counter() - t1
    require(any(h["gather_idx"] == str(torch.int32) for h in out["core_launchers"].values()),
            f"x100 cores: no int32 gather index held, {out['core_launchers']}")
    finals = {}
    for label, n in (("partitioned", net), ("unpartitioned", base)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        final, raster, launches, seconds = _engine_run(n, PART_X100_TICKS, dev, warm=0)
        peak = torch.cuda.max_memory_allocated(dev)
        _add(totals, launches)
        short = _engine_run(n, 20, dev, warm=0)[3]
        long = _engine_run(n, 220, dev, warm=0)[3]
        events = len(_cuda_events(lambda n=n: Engine(n).run(20), 1)) / 20
        finals[label] = (final, raster)
        out[label] = {"us_per_tick_with_setup": seconds / PART_X100_TICKS * 1e6,
                      "us_per_tick": (long - short) / 200 * 1e6,
                      "launches_per_tick": {k: v / PART_X100_TICKS
                                            for k, v in launches.items() if v},
                      "device_events_per_tick": events, "peak_device_bytes": peak}
    require(out["partitioned"]["launches_per_tick"] == {
        k: v / PART_X100_TICKS for k, v in _part_launches(plan, PART_X100_TICKS).items() if v},
        f"x100 partitioned launches {out['partitioned']['launches_per_tick']}")
    _require_same_raster(finals["partitioned"][1], finals["unpartitioned"][1],
                         "x100 partitioned vs unpartitioned")
    _require_same_state(finals["partitioned"][0], finals["unpartitioned"][0],
                        "x100 partitioned vs unpartitioned")
    log(f"[partition] x100 under PartitionSpec(): {plan.n_cores} cores, largest "
        f"{out['largest_core_bytes']} B (<= {MCU_BUDGET_BYTES}), exchange "
        f"{plan.exchange.bytes_per_tick} B/tick, import rows up to {out['max_import_row']}, "
        f"build {build_s:.1f} s, plan {plan_s:.1f} s; us/tick {out['partitioned']['us_per_tick']:.1f} "
        f"partitioned vs {out['unpartitioned']['us_per_tick']:.1f} unpartitioned (with "
        f"set-up {out['partitioned']['us_per_tick_with_setup']:.1f} vs "
        f"{out['unpartitioned']['us_per_tick_with_setup']:.1f}); device events/tick "
        f"{out['partitioned']['device_events_per_tick']:.2f} vs "
        f"{out['unpartitioned']['device_events_per_tick']:.2f}; launches/tick "
        f"{out['partitioned']['launches_per_tick']}; peak device memory "
        f"{out['partitioned']['peak_device_bytes']} vs "
        f"{out['unpartitioned']['peak_device_bytes']} B; raster and state == unpartitioned")
    return out


def _part_mesh(dev, totals) -> dict:
    """Phase 11d: the mesh lowering, Synfire4 fp32 sparse and fp16 packed,
    1,000 ticks: 4 cores on ``core_mesh(devices=[card] * 4)`` and
    ``core_mesh()`` (every visible card, one core each) through
    ``Engine.run``, both equal to the unpartitioned card run bit for bit;
    us/tick beside the sequential lowering of the same 4-core plan."""
    from repro_torch.configs.synfire4 import SYNFIRE4, build_synfire
    from repro_torch.core import partition as part
    from repro_torch.core.distributed import core_mesh
    from repro_torch.kernels import ops

    out = {}
    for policy, propagation in (("fp32", "sparse"), ("fp16", "packed")):
        kw = dict(policy=policy, propagation=propagation)
        base = build_synfire(SYNFIRE4, device=dev, **kw)
        f0, r0, _, s0 = _engine_run(base, PART_TICKS, dev)
        net = build_synfire(SYNFIRE4, device=dev, **kw,
                            partition=part.PartitionSpec(n_cores=4, lowering="mesh"))
        plan = net.partition
        mesh = core_mesh(devices=[dev] * 4)
        res = {}
        for label, fn in (("mesh", lambda n: part.run_partitioned_mesh(
                net.static, plan, plan.run_params, net.state0, n, mesh=mesh)),
                          ("sequential", lambda n: part.run_partitioned(
                              net.static, plan, plan.run_params, net.state0, n))):
            fn(20)
            torch.cuda.synchronize()
            ops.reset_launches()
            t0 = time.perf_counter()
            final, o = fn(PART_TICKS)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            launches = dict(ops.LAUNCHES)
            require(launches == _part_launches(plan, PART_TICKS),
                    f"{label} {policy}/{propagation} launches {launches}")
            _add(totals, launches)
            _require_same_raster(o["spikes"].cpu(), r0, f"{label} lowering {policy}")
            _require_same_state(final, f0, f"{label} lowering {policy}")
            res[f"{label}_us_per_tick"] = seconds / PART_TICKS * 1e6
        k = torch.cuda.device_count()
        every = build_synfire(SYNFIRE4, device=dev, **kw,
                              partition=part.PartitionSpec(n_cores=k, lowering="mesh"))
        f3, r3, launches, s3 = _engine_run(every, PART_TICKS, dev)
        _add(totals, launches)
        _require_same_raster(r3, r0, f"core_mesh() lowering {policy}")
        _require_same_state(f3, f0, f"core_mesh() lowering {policy}")
        res.update(unpartitioned_us_per_tick=s0 / PART_TICKS * 1e6, visible_cards=k,
                   every_card_us_per_tick=s3 / PART_TICKS * 1e6)
        out[f"{policy}/{propagation}"] = res
        log(f"[partition] mesh {policy}/{propagation}: 4 cores on [card] * 4 "
            f"{res['mesh_us_per_tick']:.1f} us/tick, sequential "
            f"{res['sequential_us_per_tick']:.1f}, unpartitioned "
            f"{res['unpartitioned_us_per_tick']:.1f}, core_mesh() over {k} card(s) "
            f"{res['every_card_us_per_tick']:.1f}; every raster and state == unpartitioned")
    return out


def _part_lanes(dev, totals) -> dict:
    """Phase 11e: ``LaneScheduler(mesh=lane_mesh(devices=[card] * 4))``: 8
    lanes of plastic Synfire4-mini fp16 sparse at 60 Hz for two 50-tick
    chunks (the reference's case), and 64 lanes of Synfire4 fp16 sparse for
    PART_CHUNKS chunks of 100 ticks: states and flushes equal the
    unsharded scheduler's; us per chunk of both."""
    import dataclasses

    from repro_torch.configs.synfire4 import (
        CHAIN_STDP,
        SYNFIRE4,
        SYNFIRE4_MINI,
        build_synfire,
    )
    from repro_torch.core.distributed import lane_mesh
    from repro_torch.kernels import ops
    from repro_torch.serve import LaneScheduler

    mini = build_synfire(dataclasses.replace(SYNFIRE4_MINI, stim_rate_hz=60.0), policy="fp16",
                         propagation="sparse", stdp_chain=CHAIN_STDP, device=dev)
    syn = build_synfire(SYNFIRE4, policy="fp16", propagation="sparse", device=dev, budget=None)
    out = {}
    for name, net, cap, chunks, chunk in (("plastic_mini_8", mini, 8, 2, 50),
                                          ("synfire4_64", syn, LANES, PART_CHUNKS, 100)):
        res, got = {}, {}
        for label, mesh in (("sharded", lane_mesh(devices=[dev] * 4)), ("unsharded", None)):
            s = LaneScheduler(net, cap, mesh=mesh, ledger_key=f"{name}_{label}")
            for i in range(cap):
                s.admit(f"t{i}")
            ops.reset_launches()
            times = []
            for _ in range(chunks):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                s.step(chunk)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e6)
            _add(totals, dict(ops.LAUNCHES))
            got[label] = (s.states, s.flush_all())
            res[f"{label}_us_per_chunk"] = times
            s.close()
        (a, fa), (b, fb) = got["sharded"], got["unsharded"]
        require(a.t == b.t, f"{name}: lane ticks differ")
        _require_same_state(a, b, f"sharded lanes {name}", plastic=_all_projections(net))
        require(fa.keys() == fb.keys() and all(
            torch.equal(torch.as_tensor(fa[k][n]), torch.as_tensor(fb[k][n]))
            for k in fb for n in fb[k]), f"sharded lanes {name}: flushes differ")
        out[name] = res
        log(f"[partition] sharded lanes {name}: states and flushes == unsharded; us per chunk "
            f"sharded {[round(x) for x in res['sharded_us_per_chunk']]} vs unsharded "
            f"{[round(x) for x in res['unsharded_us_per_chunk']]}")
    return out


def _part_sharded_snn(dev) -> dict:
    """Phase 11f: ``ShardedSNN`` (1,024 neurons, fan-in 32, delay 8, seed 3,
    SNN_TICKS ticks) at mesh sizes 1 and 4 on the card against the CPU port
    at the same size: per-tick counts, final v, u and ring bit for bit."""
    from repro_torch.core.distributed import build_sharded, lane_mesh

    out = {}
    for k in (1, 4):
        runs = {}
        for d in (dev, torch.device("cpu")):
            snn = build_sharded(lane_mesh(k, axis="model", devices=[d] * k), "model",
                                n_neurons=1024, fanin=32, max_delay=8, seed=3)
            if d.type == "cuda":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            st, counts = snn.run(SNN_TICKS)
            if d.type == "cuda":
                torch.cuda.synchronize()
            runs[d.type] = (st, counts.cpu(), time.perf_counter() - t0)
        (a, ca, sa), (b, cb, _) = runs["cuda"], runs["cpu"]
        require(torch.equal(ca, cb), f"ShardedSNN mesh {k}: per-tick counts differ")
        for name in ("v", "u", "ring"):
            require(torch.equal(getattr(a, name).cpu(), getattr(b, name)),
                    f"ShardedSNN mesh {k}: {name} differs")
        out[f"mesh{k}"] = {"spikes": int(ca.sum()), "us_per_tick": sa / SNN_TICKS * 1e6}
        log(f"[partition] ShardedSNN mesh {k}: card == CPU port ({int(ca.sum())} spikes, "
            f"{sa / SNN_TICKS * 1e6:.1f} us/tick on the card)")
    return out


def phase_partition(dev, totals: dict) -> dict:
    """Phase 11: partitioning (A11). (a) Synfire4 cells cut at 2 cores and
    at a byte budget equal to the unpartitioned card run and the CPU
    port's partitioned run; (b) every core's launchers against their plain
    versions, the 50-post core among them; (c) Synfire4x100 under the MCU
    budget per core; (d) the mesh lowering; (e) sharded scheduler lanes;
    (f) ``ShardedSNN``."""
    from repro_torch.configs.synfire4 import CHAIN_STDP, SYNFIRE4, build_synfire
    from repro_torch.core.partition import PartitionSpec

    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    t0 = time.perf_counter()
    paths, seconds = {}, {}
    # The CPU port's runs of 11a in worker processes beside the card's work
    # (the host has cores to spare; the card's loop is one thread).
    with ProcessPoolExecutor(max_workers=5,
                             mp_context=multiprocessing.get_context("spawn")) as pool:
        cpu_runs = {name: {label: pool.submit(_part_cpu_run,
                                              _part_kw(policy, propagation, backend, plastic),
                                              spec)
                           for label, spec in _part_specs(plastic)}
                    for name, policy, propagation, backend, plastic in PART_CELLS}
        for name, policy, propagation, backend, plastic in PART_CELLS:
            paths[f"partition/synfire4/{name}"] = _part_cell(
                name, policy, propagation, backend, plastic, dev, totals, cpu_runs[name])
    seconds["a"] = time.perf_counter() - t0
    twins = {}
    for label, kw, spec in (
            ("plastic/fp32/sparse n_cores=2", dict(policy="fp32", propagation="sparse",
                                                   stdp_chain=CHAIN_STDP),
             PartitionSpec(n_cores=2)),
            ("plastic/fp16/packed n_cores=2", dict(policy="fp16", propagation="packed",
                                                   stdp_chain=CHAIN_STDP),
             PartitionSpec(n_cores=2)),
            ("fp32/packed n_cores=4", dict(policy="fp32", propagation="packed"),
             PartitionSpec(n_cores=4)),
            ("fp16/sparse budget=300000", dict(policy="fp16", propagation="sparse"),
             PartitionSpec(core_budget_bytes=300_000))):
        twins[label] = _core_twins(build_synfire(SYNFIRE4, device=dev, partition=spec, **kw),
                                   build_synfire(SYNFIRE4, device="cpu", partition=spec,
                                                 **kw), label)
    paths["partition/core_launchers"] = twins
    seconds["b"] = time.perf_counter() - t0 - sum(seconds.values())
    paths["partition/synfire4_x100/fp16/sparse"] = _part_x100(dev, totals)
    seconds["c"] = time.perf_counter() - t0 - sum(seconds.values())
    paths["partition/mesh"] = _part_mesh(dev, totals)
    seconds["d"] = time.perf_counter() - t0 - sum(seconds.values())
    paths["partition/lanes"] = _part_lanes(dev, totals)
    seconds["e"] = time.perf_counter() - t0 - sum(seconds.values())
    paths["partition/sharded_snn"] = _part_sharded_snn(dev)
    seconds["f"] = time.perf_counter() - t0 - sum(seconds.values())
    paths["partition/phase_seconds"] = seconds
    log(f"[partition] phase 11 seconds by part: {seconds}")
    return paths


def phase_partition_fresh(totals: dict) -> dict:
    """Phase 11 in a process of its own (``chip_smoke.py --partition-json
    PATH``), as phases 8-10 are. Its paths and launch counts join this
    run's."""
    import tempfile

    from repro_torch.kernels import ops

    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "partition.json"
        subprocess.run([sys.executable, str(Path(__file__).resolve()), "--partition-json",
                        str(out)], check=True, timeout=600)
        res = json.loads(out.read_text())
    require(set(res["totals"]) == set(ops.LAUNCHES), f"phase 11 counts {res['totals']}")
    _add(totals, res["totals"])
    return res["paths"]


def _partition_main(out: str) -> int:
    """``--partition-json PATH``: phase 11 alone, written to ``PATH`` as JSON."""
    from repro_torch.kernels import _build, ops

    _build.build()
    totals = {k: 0 for k in ops.LAUNCHES}
    paths = phase_partition(torch.device("cuda", 0), totals)
    Path(out).write_text(json.dumps({"paths": paths, "totals": totals}, default=str))
    return 0


# -- phase 12: precision policies (A12a) ----------------------------------------------

SYNFIRE4_BF16_SPIKES = 25_779  # the reference's bf16 count over 1,000 ticks on its CPU
BF16_ENTRIES = ("izh4_update", "fused_tick", "stdp_gather", "stdp_update", "plastic_drive")


def _hold_coba_lanes(net, g, dev, what: str) -> None:
    """B1's COBA mode over 64 lanes at their own ticks for 12 chained ticks
    on random state, rings and conductances: bit for bit its plain lane
    version and, on every eighth lane, the one-lane launch."""
    from repro_torch.core import backend as be
    from repro_torch.core.lanes import broadcast_state, lane_state
    from repro_torch.core.neurons import NeuronModel
    from repro_torch.kernels import ops, ref

    static, params, n = net.static, net.params, net.static.n
    st = broadcast_state(net.state0, LANES)
    t0 = _lane_t0()
    dtype = net.state0.neurons.v.dtype
    v = (torch.rand((LANES, n), generator=g) * 115 - 80).to(dtype).to(dev)
    u = (torch.rand((LANES, n), generator=g) * 10 - 15).to(dtype).to(dev)
    cond = tuple((torch.rand((LANES, n), generator=g) * 2).to(dtype).to(dev)
                 for _ in st.cond)
    ring = (torch.rand(tuple(st.ring.shape), generator=g) * 8).to(dtype).to(dev)
    neurons = st.neurons._replace(v=v, u=u)
    gen = (torch.rand((LANES, NEURON_TICKS, static.n_gen), generator=g) < 0.3).to(dev)
    raster = torch.zeros((LANES, NEURON_TICKS, n), dtype=torch.bool, device=dev)
    saved = [x.clone() for x in (v, u, neurons.refrac, ring, *cond)]
    k_ring = ring.clone()
    run = be.assemble_neurons(static, params, neurons, k_ring, cond=cond, gen_spk=gen,
                              raster=raster, t0=t0)
    require(run.launcher is not None, f"NeuronRun COBA lanes {what}: no launcher")
    p = params.neuron
    is_gen = p.model == NeuronModel.GENERATOR
    cols = _gen_cols(static, dev)
    pv, pu, pr, p_ring = (x.clone() for x in (v, u, neurons.refrac, ring))
    pc = tuple(x.clone() for x in cond)
    p_raster, p_spikes = raster.clone(), torch.zeros((LANES, n), device=dev)
    coeffs = be.coba_coeffs(static)
    ops.reset_launches()
    for i in range(NEURON_TICKS):
        run(i)
        ref.neuron_lanes_ref(pv, pu, pr, p_ring, [(t + i) % static.ring_len for t in t0],
                             is_gen, p.a, p.b, p.c, p.d, cols, p_spikes, gen_rows=gen[:, i],
                             raster_rows=p_raster[:, i], cond=pc, coba=coeffs, dt=static.dt,
                             substeps=static.substeps)
    torch.cuda.synchronize()
    require(ops.LAUNCHES["izh4_update"] == NEURON_TICKS, f"COBA lanes {what}: launches")
    for name, a, b in (("v", run.v, pv), ("u", run.u, pu), ("refrac", run.refrac, pr),
                       ("ring", k_ring, p_ring), ("raster", raster, p_raster),
                       *((f"g{k}", a, b) for k, (a, b) in enumerate(zip(run.cond, pc)))):
        _require_bitwise(a, b, f"NeuronRun COBA lanes {what} {name}")
    for b in range(0, LANES, 8):
        one = lane_state(st._replace(neurons=neurons._replace(
            v=saved[0], u=saved[1], refrac=saved[2]), cond=type(st.cond)(*saved[4:])), b)
        ring_b = saved[3][b].clone()
        solo_raster = torch.zeros((NEURON_TICKS, n), dtype=torch.bool, device=dev)
        solo = be.assemble_neurons(static, params, one.neurons, ring_b, cond=one.cond,
                                   gen_spk=gen[b].contiguous(), raster=solo_raster)
        for i in range(NEURON_TICKS):
            solo(i, t0[b] + i)
        for name, x, y in (("v", solo.v, run.v[b]), ("ring", ring_b, k_ring[b]),
                           ("raster", solo_raster, raster[b]),
                           *((f"g{k}", x, y[b]) for k, (x, y) in enumerate(
                               zip(solo.cond, run.cond)))):
            _require_bitwise(x, y, f"NeuronRun COBA lanes {what} lane {b} vs one lane {name}")
    require(int(raster[:, :, ~is_gen].sum()) > 0, f"COBA lanes {what}: no neuron spiked")
    log(f"[precision] NeuronRun COBA {what}: 64 lanes x {NEURON_TICKS} ticks bitwise against "
        "the plain lane version (v, u, refrac, ring, conductances, raster) and the one-lane "
        "launch on every eighth lane")


def _hold_drive_stp(dev, g, policy: str) -> None:
    """The drive on an STP net in ``policy`` (u, x and weights in its
    storage dtype; u * x rounded to it, as the plain version's product of
    two stored tensors), 16 lanes, bit for bit its plain version."""
    from repro_torch.kernels import ops, ref

    net = _stp_net(policy, dev)
    projs_on, acc, weights, stp, _ = _drive_case(net, g, dev, 16)
    require(stp[0] is not None and stp[0][0].dtype == net.state0.weights[0].dtype,
            f"drive STP {policy}: the STP state is not in the storage dtype")
    plain_acc = acc.clone()
    run = ops.DriveRun(net.static.n, projs_on(acc), lanes=16)
    plain = projs_on(plain_acc)
    for t in range(3):
        spikes = (torch.rand((16, net.static.n), generator=g) < 0.3).float().to(dev)
        run(spikes, weights, stp)
        ref.drive_run_ref(spikes, plain, weights, stp)
        torch.cuda.synchronize()
        _require_bitwise(acc, plain_acc, f"plastic_drive STP {policy} tick {t}")
    log(f"[precision] plastic_drive STP net {policy}: 16 lanes x 3 ticks bitwise against its "
        "plain version (u * x rounded to the storage dtype)")


def _prec_kernels(dev, g) -> dict:
    """Phase 12a: each bf16 entry against its plain version on the card, bit
    for bit, and timed beside its fp16 entry (per call and on the device
    alone, with its bound from bytes): B1 over 64 lanes (CUBA, COBA, the
    monitor and watch slots), B4 over 64 lanes (packed and sparse), B5, B6
    and the drive over 64 lanes of the plastic chain, the drive on an STP
    net. Returns per kernel ``{"bf16": ..., "fp16": ...}`` timing rows, each
    with the largest difference from the plain version it compared."""
    from repro_torch.configs.synfire4 import CHAIN_STDP, SYNFIRE4, build_synfire

    out = {k: {} for k in BF16_ENTRIES}
    for policy in ("fp16", "bf16"):
        # each kernel's largest difference from its plain version in this policy
        err = {k: [0.0] for k in BF16_ENTRIES}
        held = lambda name: _tracking_held(err[name])  # noqa: E731
        net = build_synfire(SYNFIRE4, policy=policy, propagation="sparse", device=dev,
                            budget=None)
        with held("izh4_update"):
            out["izh4_update"][policy] = _hold_neuron_lanes(net, g, dev,
                                                            f"SYNFIRE4 {policy}/sparse")
        for propagation in ("packed", "sparse"):
            fused = build_synfire(SYNFIRE4, policy=policy, propagation=propagation, device=dev,
                                  backend="fused", budget=None)
            with held("fused_tick"):
                row = _hold_fused_lanes(fused, g, dev, f"SYNFIRE4 {policy}/{propagation} fused")
            if propagation == "sparse":
                out["fused_tick"][policy] = row
            plastic = build_synfire(SYNFIRE4, policy=policy, propagation=propagation,
                                    device=dev, stdp_chain=CHAIN_STDP, budget=None)
            what = f"SYNFIRE4 {policy}/{propagation} plastic"
            name = "stdp_update" if propagation == "packed" else "stdp_gather"
            with held(name):
                out[name][policy] = _hold_stdp_lanes(plastic, g, dev, what)
            with held("plastic_drive"):
                drive = _hold_drive_lanes(plastic, g, dev, what)
            if propagation == "sparse":
                out["plastic_drive"][policy] = drive
            if policy == "bf16":
                one = _hold_stdp_run if propagation == "sparse" else _hold_stdp_update_run
                with held(name):
                    one(plastic, g, dev, f"{what} one lane")
                with held("fused_tick"):
                    _hold_fused_slots(fused, g, dev, LANES)
                    _hold_fused_watch_slots(fused, g, dev, LANES)
        if policy == "bf16":
            coba = _coba_net(SYNFIRE4, "bf16", "sparse", dev)
            with held("izh4_update"):
                _hold_neuron_run(coba, g, dev, True, True, "SYNFIRE4 bf16/sparse COBA")
                _hold_coba_lanes(coba, g, dev, "SYNFIRE4 bf16/sparse")
                _hold_neuron_slots(net, g, dev, LANES)
                for substeps in (net.static.substeps, 1):
                    _hold_neuron_watch_slots(net, g, dev, LANES, substeps)
        with held("plastic_drive"):
            _hold_drive_stp(dev, g, policy)
        for name in BF16_ENTRIES:
            out[name][policy]["max_abs_err"] = err[name][0]
    for name, pair in out.items():
        b, h = pair["bf16"], pair["fp16"]
        log(f"[precision] {name} bf16 entry: {b['ms'] * 1e3:.2f} us per call, "
            f"{b['device_ms'] * 1e3:.2f} us on the device (bound {b['bound_ms'] * 1e3:.3f} "
            f"us by {b['bound_by']}); fp16 entry {h['ms'] * 1e3:.2f} / "
            f"{h['device_ms'] * 1e3:.2f} us (bound {h['bound_ms'] * 1e3:.3f}); device "
            f"bf16/fp16 {b['device_ms'] / h['device_ms']:.3f}; max |card - plain| "
            f"{b['max_abs_err']} (fp16 {h['max_abs_err']})")
    return out


def _prec_synfire(dev, bf16_totals: dict) -> dict:
    """Phase 12b: bf16 Synfire4 packed and sparse on the default and fused
    backends, 1,000 ticks on the default generator stream with the default
    monitors: raster and final state equal to the CPU port's, the spike
    count the reference's; SpikeCount accuracy of fp16 and bf16 against
    fp32, required >= 0.97; the bf16 ledger equal to fp16's; us/tick."""
    from repro_torch.configs.synfire4 import SYNFIRE4, build_synfire
    from repro_torch.core.engine import run
    from repro_torch.kernels import ops

    paths, counts = {}, {}
    for propagation in ("packed", "sparse"):
        for backend in (None, "fused"):
            cpu_final, cpu_raster, _, _ = cpu_ref(f"prec/{propagation}/{backend}")
            card = build_synfire(SYNFIRE4, policy="bf16", propagation=propagation, device=dev,
                                 backend=backend)
            final, raster, launches, seconds = _timed_run(card, TICKS, dev, record="both")
            _add(bf16_totals, launches)
            what = f"bf16 Synfire4 {propagation} backend={backend}"
            _require_same_raster(raster, cpu_raster, what)
            _require_same_state(final, cpu_final, what)
            total = int(raster.sum())
            require(total == SYNFIRE4_BF16_SPIKES,
                    f"{what}: {total} spikes, the reference's CPU run {SYNFIRE4_BF16_SPIKES}")
            require(launches["fused_tick"] == (TICKS if backend else 0),
                    f"{what}: launches {launches}")
            key = f"precision/synfire4/bf16/{propagation}" + ("/fused" if backend else "")
            paths[key] = {"us_per_tick": seconds / TICKS * 1e6, "spikes": total,
                          "launches": launches, "raster_equals_cpu": True,
                          "state_equals_cpu": True}
            log(f"[precision] {what}: {total} spikes (the reference's), card raster and state "
                f"== CPU port's, {seconds / TICKS * 1e6:.1f} us/tick, launches {launches}")
    for policy in ("fp32", "fp16", "bf16"):
        net = build_synfire(SYNFIRE4, policy=policy, propagation="sparse", device=dev)
        ops.reset_launches()
        _, out = run(net.static, net.params, net.state0, TICKS, record="both")
        counts[policy] = int(out["telemetry"]["spike_count"].sum())
        require(counts[policy] == int(out["spikes"].sum()),
                f"{policy}: SpikeCount {counts[policy]} != the raster's total")
        if policy == "bf16":
            _add(bf16_totals, dict(ops.LAUNCHES))
            ledgers = (net.ledger, build_synfire(SYNFIRE4, policy="fp16", propagation="sparse",
                                                 device=dev).ledger)
            require(ledgers[0].rampup_rows() == ledgers[1].rampup_rows(),
                    "bf16 ledger stages differ from fp16's")
            paths["precision/synfire4/ledger_bytes"] = {"bf16": ledgers[0].total_used,
                                                        "fp16": ledgers[1].total_used}
    for policy in ("fp16", "bf16"):
        acc = min(counts[policy], counts["fp32"]) / max(counts[policy], counts["fp32"])
        require(acc >= 0.97, f"{policy} spike-count accuracy {acc:.4f} < 0.97")
        paths[f"precision/synfire4/{policy}_accuracy"] = acc
    log(f"[precision] SpikeCount accuracy against fp32 (sparse, 1,000 ticks): fp16 "
        f"{paths['precision/synfire4/fp16_accuracy']:.4f}, bf16 "
        f"{paths['precision/synfire4/bf16_accuracy']:.4f} (counts {counts}); bf16 ledger "
        f"{paths['precision/synfire4/ledger_bytes']} B == fp16's stage for stage")
    return paths


def _prec_plastic_coba(dev, bf16_totals: dict) -> dict:
    """Phase 12c: plastic bf16 Synfire4 packed and sparse, 1,000 ticks:
    raster, chain weights and traces equal to the CPU port's; COBA bf16
    Synfire4 sparse: raster and state (conductances too) equal to the CPU
    port's."""
    from repro_torch.configs.synfire4 import CHAIN_STDP, SYNFIRE4, build_synfire

    paths = {}
    for propagation in ("packed", "sparse"):
        cpu_final, cpu_raster, _, _ = cpu_ref(f"prec/plastic/{propagation}")
        net = build_synfire(SYNFIRE4, policy="bf16", propagation=propagation, device=dev,
                            stdp_chain=CHAIN_STDP)
        final, raster, launches, seconds = _timed_run(net, TICKS, dev)
        _add(bf16_totals, launches)
        what = f"plastic bf16 Synfire4 {propagation}"
        require(launches == _plastic_launches(net, TICKS), f"{what}: launches {launches}")
        _require_same_raster(raster, cpu_raster, what)
        _require_same_state(final, cpu_final, what, plastic=_chain(net))
        paths[f"precision/plastic/bf16/{propagation}"] = {
            "us_per_tick": seconds / TICKS * 1e6, "spikes": int(raster.sum()),
            "launches": launches, "equals_cpu": True}
        log(f"[precision] {what}: {int(raster.sum())} spikes, raster, state, chain weights "
            f"and traces == CPU port's, {seconds / TICKS * 1e6:.1f} us/tick, launches "
            f"{launches}")
    card = _coba_net(SYNFIRE4, "bf16", "sparse", dev)
    cpu_final, cpu_raster, _, _ = cpu_ref("prec/coba")
    final, raster, launches, seconds = _timed_run(card, TICKS, dev)
    _add(bf16_totals, launches)
    _require_same_raster(raster, cpu_raster, "COBA bf16 Synfire4 sparse")
    _require_same_state(final, cpu_final, "COBA bf16 Synfire4 sparse")
    paths["precision/coba/bf16/sparse"] = {"us_per_tick": seconds / TICKS * 1e6,
                                           "spikes": int(raster.sum()), "launches": launches,
                                           "equals_cpu": True}
    log(f"[precision] COBA bf16 Synfire4 sparse: {int(raster.sum())} spikes, raster and state "
        f"(conductances too) == CPU port's, {seconds / TICKS * 1e6:.1f} us/tick")
    return paths


def _prec_lanes(dev, bf16_totals: dict) -> dict:
    """Phase 12d: ``run_batch(1000, 64)`` bf16 sparse, every lane equal to
    its solo card run, lane-ticks/s; a bf16 ``LaneScheduler(64)`` chunk with
    the default watches and monitors, four lanes equal to solo sessions
    and no watch tripped; a ``save_lane``/``restore_lane`` round trip."""
    import tempfile

    from repro_torch.configs.synfire4 import SYNFIRE4, build_synfire
    from repro_torch.core import rng, run, run_batch
    from repro_torch.core.lanes import lane_state
    from repro_torch.kernels import ops
    from repro_torch.serve import LaneScheduler, restore_lane, save_lane

    net = build_synfire(SYNFIRE4, policy="bf16", propagation="sparse", device=dev, budget=None,
                        watches="default")
    static, params, state0 = net.static, net.params, net.state0
    run_batch(static, params, state0, 20, LANES)
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    final, out = run_batch(static, params, state0, TICKS, LANES)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    _add(bf16_totals, launches)
    require(launches == _static_launches(net, TICKS), f"bf16 run_batch: launches {launches}")
    keys = rng.split(state0.key, LANES)
    t1 = time.perf_counter()
    for b in range(LANES):
        solo, solo_out = run(static, params, state0._replace(key=keys[b]), TICKS)
        _require_lane_equals(final, out, b, solo, solo_out, "bf16 run_batch")
    torch.cuda.synchronize()
    solo_s = (time.perf_counter() - t1) / LANES
    res = {"run_batch": {"us_per_tick": seconds / TICKS * 1e6,
                         "lane_ticks_per_s": LANES * TICKS / seconds,
                         "solo_us_per_tick_with_check": solo_s / TICKS * 1e6,
                         "lanes_equal_solo": LANES, "launches": launches}}
    log(f"[precision] run_batch(1000, 64) bf16 sparse: {seconds / TICKS * 1e6:.1f} us/tick, "
        f"{LANES * TICKS / seconds:.0f} lane-ticks/s; all 64 lanes == solo card runs")
    sched = LaneScheduler(net, LANES)
    for k in range(LANES):
        sched.admit(f"t{k}", seed=k)
    ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sched.step(SCHED_CHUNK)
    torch.cuda.synchronize()
    chunk_s = time.perf_counter() - t0
    _add(bf16_totals, dict(ops.LAUNCHES))
    tripped = sched.check_watches()
    kinds = sorted({v.kind for verdicts in tripped.values() for v in verdicts})
    require("NonFinite" not in kinds, f"bf16 scheduler: a NonFinite watch tripped {tripped}")
    for k in (0, 21, 42, 63):
        want = _solo_session(net, rng.key(k, dev), SCHED_CHUNK)
        _require_same_state(lane_state(sched.states, sched.lane_of(f"t{k}")), want,
                            f"bf16 scheduler lane t{k}")
    with tempfile.TemporaryDirectory() as tmp:
        snap = sched.export("t5")
        save_lane(tmp, snap)
        back = restore_lane(tmp, net)
        _require_same_state(back.state, snap.state, "bf16 save_lane/restore_lane")
    res["scheduler"] = {"us_per_chunk": chunk_s * 1e6, "chunk_ticks": SCHED_CHUNK,
                        "sessions_tripped": len(tripped), "kinds_tripped": kinds,
                        "lanes_equal_solo": [0, 21, 42, 63]}
    log(f"[precision] LaneScheduler(64) bf16 sparse, default monitors and watches: one chunk "
        f"of {SCHED_CHUNK} ticks in {chunk_s * 1e6:.0f} us, {len(tripped)} sessions tripped "
        f"({kinds}; no NonFinite), lanes 0, 21, 42, 63 == solo sessions; save_lane/"
        "restore_lane round trip bit for bit")
    return {f"precision/lanes/bf16/{k}": v for k, v in res.items()}


def _prec_int8(dev, totals: dict) -> dict:
    """Phase 12e: Synfire4 fp32 on int8-round-tripped weights (axis 0),
    packed on both backends, 1,000 ticks: spike-count accuracy against the
    fp32 run required >= 0.97; the card raster against the CPU port's, its
    first divergent tick printed if there is one."""
    from repro_torch.configs.synfire4 import SYNFIRE4, build_synfire
    from repro_torch.precision import dequantize, quantize_int8

    def int8_net(where, backend):
        net = build_synfire(SYNFIRE4, policy="fp32", propagation="packed", device=where,
                            backend=backend)
        w = tuple(dequantize(quantize_int8(x, axis=0)) for x in net.state0.weights)
        net.state0 = net.state0._replace(weights=w)
        return net

    paths = {}
    cpu_raster = cpu_ref("prec/int8")
    for backend in (None, "fused"):
        ref_net = build_synfire(SYNFIRE4, policy="fp32", propagation="packed", device=dev,
                                backend=backend)
        c32 = int(_timed_run(ref_net, TICKS, dev)[1].sum())
        _, raster, launches, seconds = _timed_run(int8_net(dev, backend), TICKS, dev)
        _add(totals, launches)
        c8 = int(raster.sum())
        acc = min(c8, c32) / max(c8, c32)
        require(acc >= 0.97, f"int8 backend={backend}: accuracy {acc:.4f} < 0.97 ({c8}, {c32})")
        diff = (raster != cpu_raster).any(dim=1)
        first = int(torch.nonzero(diff)[0]) if bool(diff.any()) else None
        paths["precision/int8/synfire4/packed" + ("/fused" if backend else "")] = {
            "spikes": c8, "fp32_spikes": c32, "accuracy": acc, "us_per_tick":
            seconds / TICKS * 1e6, "first_tick_differing_from_cpu": first}
        log(f"[precision] Synfire4 fp32 on int8-round-tripped weights, packed backend="
            f"{backend}: {c8} spikes against fp32's {c32}, accuracy {acc:.4f}; card raster vs "
            f"CPU port's: " + ("equal" if first is None else f"first differs at tick {first}"))
    return paths


def _prec_sr(dev) -> dict:
    """Phase 12f: stochastic rounding of a card tensor to fp16 (``fp16_sr``'s
    store with a key) and to bf16, equal to the CPU port's bit for bit
    (NaNs by place)."""
    from repro_torch.core import rng
    from repro_torch.precision import get_policy
    from repro_torch.precision.policy import _stochastic_round

    g = torch.Generator().manual_seed(61)
    x = torch.randn((4096, 257), generator=g) * 10.0 ** torch.randint(-6, 6, (4096, 1),
                                                                      generator=g)
    x[0, :6] = torch.tensor([0.0, -0.0, 1e-40, 65520.0, float("inf"), float("nan")])
    out = {}
    for name, fn in (("fp16_sr", lambda t, k: get_policy("fp16_sr").store(t, key=k)),
                     ("bf16", lambda t, k: _stochastic_round(t, torch.bfloat16, k))):
        card = fn(x.to(dev), rng.key(9, dev)).cpu()
        cpu = fn(x, rng.key(9))
        require(_same_bits(card, cpu), f"stochastic rounding {name}: card != CPU port")
        nearest = x.to(card.dtype)
        out[name] = {"equals_cpu": True, "n": x.numel(),
                     "share_off_nearest": float((card != nearest).float().mean())}
    log(f"[precision] stochastic rounding of a card tensor [4096, 257] (fp16_sr store, bf16): "
        f"== CPU port bit for bit; {out}")
    return {"precision/stochastic_round": out}


PREC_LM_LAYERS = 4  # 8 until phase 15 came to share the script's time


def _prec_lm(dev, totals: dict) -> dict:
    """Phase 12g: smollm-360m at full width cut to ``PREC_LM_LAYERS`` layers
    (32 until phase 14 came to share the script's time: the draws of 32
    layers took 4 s a policy) served under ``bf16`` and ``fp16_opt``
    beside ``fp16`` (batch 4, 512-token prompts, 32 tokens): prefill ms and
    tokens/s; one attention launch per layer per step; and at 2 layers the
    card against the CPU port (logits within the stated tolerance; greedy
    tokens counted, not gated: see :func:`_card_vs_cpu`)."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import serve
    from repro_torch.models import transformer as tf
    from repro_torch.precision import get_policy

    cfg, paths = dataclasses.replace(get_arch(SMOLLM), n_layers=PREC_LM_LAYERS), {}
    for policy_name in ("fp16", "bf16", "fp16_opt"):
        model = tf.init_params(cfg, get_policy(policy_name), seed=0, device=dev)
        kw = dict(batch=LM_BATCH, prompt_len=LM_PROMPT, reduced=False, params=model,
                  device=dev, policy_name=policy_name)
        serve(SMOLLM, gen=4, **kw)
        ops.reset_launches()
        out = serve(SMOLLM, gen=LM_GEN, **kw)
        launches = dict(ops.LAUNCHES)
        _add(totals, launches)
        require(launches["flash_attention"] == cfg.n_layers * LM_GEN,
                f"serve {policy_name}: launches {launches}")
        tokens = out["tokens"]
        require(tokens.shape == (LM_BATCH, LM_GEN) and int(tokens.min()) >= 0
                and int(tokens.max()) < cfg.vocab_size, f"served tokens {policy_name}")
        step_ms = out["decode_s"] / (LM_GEN - 1) * 1e3
        paths[f"precision/lm/smollm-360m/serve/{policy_name}"] = {
            "prefill_ms": out["prefill_s"] * 1e3, "decode_ms_per_step": step_ms,
            "decode_tok_s": out["decode_tok_s"],
            "prefill_tok_s": LM_BATCH * LM_PROMPT / out["prefill_s"],
            "kv_dtype": str(get_policy(policy_name).state_storage)}
        log(f"[precision] serve {SMOLLM} full width {cfg.n_layers} layers {policy_name}: prefill "
            f"{out['prefill_s'] * 1e3:.1f} ms ({LM_BATCH * LM_PROMPT / out['prefill_s']:.0f} "
            f"tok/s), decode {step_ms:.2f} ms/step, {out['decode_tok_s']:.1f} tok/s")
        del model
    for policy_name in ("bf16", "fp16_opt"):
        paths[f"precision/lm/smollm-360m-2l/card_vs_cpu/{policy_name}"] = _card_vs_cpu(
            dev, policy_name)
    return paths


def phase_precision(dev, rows: list, totals: dict) -> dict:
    """Phase 12 (a)-(g) in this order; the bf16 entries' rows join ``rows``
    (``<kernel>[bf16]``, their launches on phase 12's bf16 paths (b)-(d);
    the parent adds each kernel's route, source and TPU kernel)."""
    g = torch.Generator(device="cpu").manual_seed(121)
    t0 = time.perf_counter()
    timing = _prec_kernels(dev, g)
    bf16_totals = {k: 0 for k in totals}
    paths = _prec_synfire(dev, bf16_totals)
    paths.update(_prec_plastic_coba(dev, bf16_totals))
    paths.update(_prec_lanes(dev, bf16_totals))
    _add(totals, bf16_totals)
    paths.update(_prec_int8(dev, totals))
    paths.update(_prec_sr(dev))
    paths.update(_prec_lm(dev, totals))
    for name in BF16_ENTRIES:
        b, h = timing[name]["bf16"], timing[name]["fp16"]
        rows.append({"name": f"{name}[bf16]", "kernel": name, "entry": "bf16",
                     "launches": bf16_totals[name], "max_abs_err": b["max_abs_err"],
                     "ms": b["ms"],
                     "device_ms": b["device_ms"], "plain_ms": b["plain_ms"],
                     "bound_ms": b["bound_ms"], "bound_by": b["bound_by"],
                     "library_ms": b.get("library_ms"), "shape": b["shape"],
                     "fp16": {k: h[k] for k in ("ms", "device_ms", "plain_ms", "bound_ms",
                                                  "max_abs_err")}})
        require(bf16_totals[name] > 0, f"{name}'s bf16 entry never launched on phase 12's "
                "bf16 paths")
    seconds = time.perf_counter() - t0
    paths["precision/phase_s"] = seconds
    log(f"[precision] phase 12 in {seconds:.1f} s; bf16 launches on its bf16 paths "
        f"{ {k: bf16_totals[k] for k in BF16_ENTRIES} }")
    return paths


def phase_precision_fresh(rows: list, totals: dict) -> dict:
    """Phase 12 in a process of its own (``chip_smoke.py --precision-json
    PATH``), as phases 8-11 are. Its rows, paths and launch counts join this
    run's."""
    import tempfile

    from repro_torch.kernels import ops

    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "precision.json"
        subprocess.run([sys.executable, str(Path(__file__).resolve()), "--precision-json",
                        str(out)], check=True, timeout=600)
        res = json.loads(out.read_text())
    require(set(res["totals"]) == set(ops.LAUNCHES), f"phase 12 counts {res['totals']}")
    _add(totals, res["totals"])
    by_name = {r["name"]: r for r in rows}
    for r in res["rows"]:  # the entry's route, source and TPU kernel are its kernel's
        base = by_name[r["kernel"]]
        rows.append({**{k: base[k] for k in ("route", "source", "replaces")}, **r})
    return res["paths"]


def _precision_main(out: str) -> int:
    """``--precision-json PATH``: phase 12 alone, written to ``PATH`` as JSON."""
    from repro_torch.kernels import _build, ops

    _build.build()
    totals = {k: 0 for k in ops.LAUNCHES}
    rows: list = []
    paths = phase_precision(torch.device("cuda", 0), rows, totals)
    Path(out).write_text(json.dumps({"rows": rows, "paths": paths, "totals": totals},
                                    default=str))
    return 0


# -- LM serving ----------------------------------------------------------------------

SMOLLM = "smollm-360m"
LM_BATCH, LM_PROMPT, LM_GEN = 4, 512, 32
# Full width, fp16 policy: the logits reach about |5|, where one fp16 ulp
# of a projection input moves a logit by up to about 3e-3 (ROADMAP queue C),
# so card and CPU are held at 4e-3 there and at 1e-4 under fp32.
# bf16 rounds each projection input to 8 bits, so a card sum one f32 ulp
# apart moves a logit 8 times as far as an fp16 one: 8 x 4e-3; fp16_opt's
# logits are bf16 themselves: two bf16 ulps of their scale (queue C).
CARD_VS_CPU_TOL = {"fp32": 1e-4, "fp16": 4e-3, "bf16": 3.2e-2, "fp16_opt": 2**-4}
ATTN_TOL = 1e-5


def _attn_case(g, b, sq, sk, hq, hkv, d, kvdt, dev, invalid=0, shift=0):
    """q, k, v, qpos, kpos on the card in the model's layout: kpos =
    arange(Sk) with the last ``invalid`` slots empty, queries at the end of
    the valid keys moved by ``shift``."""
    q = torch.randn((b, sq, hq, d), generator=g)
    k = torch.randn((b, sk, hkv, d), generator=g).to(kvdt)
    v = torch.randn((b, sk, hkv, d), generator=g).to(kvdt)
    kpos = torch.arange(sk, dtype=torch.int32)
    if invalid:
        kpos[-invalid:] = -1
    qpos = (torch.arange(sq, dtype=torch.int32) + (sk - invalid - sq + shift)).expand(b, sq)
    return [x.contiguous().to(dev) for x in (q, k, v, qpos, kpos)]


def _allowed(qpos, kpos, causal: bool, window: int):
    """[B, Sq, Sk] bool: the keys each query may see."""
    kp, qp = kpos[None, None, :], qpos[:, :, None]
    mask = (kp >= 0).expand(qpos.shape[0], qpos.shape[1], kpos.shape[0])
    if causal:
        mask = mask & (kp <= qp)
    if window > 0:
        mask = mask & (kp > qp - window)
    return mask


def _attn_row(name, args, causal, window, pallas=False):
    """Check and time one attention case: the kernel against its plain
    version (max abs error, rtol = atol = 1e-5), per-call and device-alone
    time, the plain version's time, one ``scaled_dot_product_attention``
    on the same f32 inputs with the same mask (None where a row sees no
    key: SDPA gives NaN there), and the bound: each input read once and
    the output written once at 3.35 TB/s, or 4 * Hq * D f32 operations per
    allowed (query, key) pair at 67 TFLOP/s, whichever is larger."""
    from repro_torch.kernels import flash_attn as fa
    from repro_torch.kernels import ops, ref

    q, k, v, qpos, kpos = args
    n_sm = torch.cuda.get_device_properties(q.device).multi_processor_count
    splits = fa.plan(q.shape[0], q.shape[1], k.shape[1], q.shape[2], k.shape[2], q.shape[3],
                     n_sm)[0]
    kernel = "decode_kernel" if splits else "prefill_kernel"
    if pallas:  # the Pallas signature: [B, H, S, D] operands
        qh, kh, vh = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        run = lambda: ops.flash_attention(qh, kh, vh, causal=causal, window=window)  # noqa: E731
        plain = lambda: ref.flash_attention_ref(qh, kh, vh, causal=causal, window=window)  # noqa: E731
        got, want = run().transpose(1, 2), plain().transpose(1, 2)
    else:
        run = lambda: ops.attention(q, k, v, qpos, kpos, causal=causal, window=window)  # noqa: E731
        plain = lambda: ref.chunked_attention_ref(q, k, v, qpos, kpos, causal=causal,  # noqa: E731
                                                  window=window)
        got, want = run(), plain()
    torch.cuda.synchronize()
    err = max_err(got, want)
    require(torch.allclose(got, want, rtol=ATTN_TOL, atol=ATTN_TOL),
            f"flash_attention {name}: max abs err {err} against its plain version")
    allowed = _allowed(qpos, kpos, causal, window)
    empty = ~allowed.any(dim=-1)  # [B, Sq]
    b, sq, hq, d = q.shape
    if bool(empty.any()):  # the reference's value: sum of v over Sk + pad
        mean = (v.float().sum(dim=1) / fa.pad_den(k.shape[1])).repeat_interleave(
            hq // k.shape[2], dim=1)  # [B, Hq, D]
        want_empty = mean[:, None].expand(b, sq, hq, d)[empty]
        require(torch.allclose(got[empty], want_empty, rtol=ATTN_TOL, atol=ATTN_TOL),
                f"flash_attention {name}: rows with no allowed key differ from sum(v) / "
                f"(Sk + pad) by {max_err(got[empty], want_empty)}")
    pairs = int(allowed.sum())
    b_ms, b_by = bound(nbytes(q, k, v, qpos, kpos) + nbytes(got), 4 * hq * d * pairs)
    library = library_device = None
    if not bool(empty.any()):
        qt, kt, vt = (x.float().transpose(1, 2).contiguous() for x in (q, k, v))
        mask = allowed[:, None]

        def sdpa():
            return torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, enable_gqa=True)

        library = cuda_ms(sdpa, reps=50)
        library_device = device_total_ms(sdpa, reps=20)
    cold = None
    if splits:  # L2 flushed before each launch, as inside a decode step
        flush = torch.empty(64 << 20, dtype=torch.int32, device=q.device)

        def flushed():
            flush.zero_()
            run()

        cold = device_ms(flushed, kernel, reps=50)
    row = {"case": name, "shape": f"q {list(q.shape)} kv {list(k.shape)} "
           f"{str(k.dtype).removeprefix('torch.')} causal={causal} window={window}"
           + (" (Pallas signature)" if pallas else ""),
           "path": f"decode, {splits} splits" if splits else "prefill",
           "max_abs_err": err, "allowed_pairs": pairs, "empty_rows": int(empty.sum()),
           "ms": cuda_ms(run, reps=50), "device_ms": device_ms(run, kernel, reps=50),
           "device_ms_l2_flushed": cold,
           "plain_ms": cuda_ms(plain, reps=20, warmup=3), "bound_ms": b_ms, "bound_by": b_by,
           "library_ms": library, "library_device_ms": library_device}
    lib = "-" if library is None else f"{library * 1e3:.2f} us"
    if library_device is not None:
        lib += f" ({library_device * 1e3:.2f} us on the device)"
    log(f"[lm] flash_attention {name} ({row['shape']}, {row['path']}): max abs err {err:.3g}, "
        f"{row['ms'] * 1e3:.2f} us per call ({row['device_ms'] * 1e3:.2f} us on the device"
        + ("" if cold is None else f", {cold * 1e3:.2f} us with L2 flushed") + "), "
        f"plain {row['plain_ms'] * 1e3:.2f} us, bound {b_ms * 1e3:.3f} us ({b_by}), SDPA {lib}")
    return row


def _check_attention(dev) -> dict:
    """Phase 6a; returns the kernel's row (its numbers: the decode case,
    992 of the serve path's 1,024 launches) with every case under
    ``cases``."""
    g = torch.Generator(device="cpu").manual_seed(23)
    f16, f32, bf16 = torch.float16, torch.float32, torch.bfloat16
    cases = [
        ("smollm prefill", _attn_case(g, 4, 512, 512, 15, 5, 64, f32, dev), True, -1, False),
        ("smollm decode, 544-slot fp16 cache, 32 empty",
         _attn_case(g, 4, 1, 544, 15, 5, 64, f16, dev, invalid=32), True, -1, False),
        ("smollm prefill, window 64", _attn_case(g, 4, 512, 512, 15, 5, 64, f32, dev),
         True, 64, False),
        ("Pallas signature [1,4,256,64], fp16 KV",
         _attn_case(g, 1, 256, 256, 4, 2, 64, f16, dev), True, -1, True),
        ("D 128, group 4 (qwen2.5/minitron heads)",
         _attn_case(g, 2, 256, 256, 8, 2, 128, f16, dev), True, -1, False),
        ("D 160, group 4 (stablelm heads)", _attn_case(g, 2, 256, 256, 8, 2, 160, f32, dev),
         True, -1, False),
        ("D 16, group 4 (reduced)", _attn_case(g, 2, 64, 64, 4, 1, 16, bf16, dev),
         True, -1, False),
        ("rows with no allowed key", _attn_case(g, 2, 40, 40, 6, 2, 64, f32, dev, shift=-8),
         True, -1, False),
        ("decode, 4,096-slot fp16 cache, group 3",
         _attn_case(g, 4, 1, 4096, 15, 5, 64, f16, dev, invalid=64), True, -1, False),
        ("decode, 32,768-slot fp16 cache, group 3",
         _attn_case(g, 4, 1, 32768, 15, 5, 64, f16, dev), True, -1, False),
        ("decode, group 4, D 128, bf16 cache",
         _attn_case(g, 2, 1, 2048, 32, 8, 128, bf16, dev, invalid=10), True, -1, False),
        ("decode, window 256", _attn_case(g, 4, 1, 1500, 15, 5, 64, f16, dev), True, 256,
         False),
        ("decode, rows with no allowed key (Sk 1,100: pad 948)",
         _attn_case(g, 2, 1, 1100, 15, 5, 64, f16, dev, shift=-1200), True, -1, False),
    ]
    rows = [_attn_row(name, args, causal, window, pallas)
            for name, args, causal, window, pallas in cases]
    main = rows[1]
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attn.cu",
            "replaces": "src/repro/kernels/flash_attn.py:70",
            "shape": main["shape"], "max_abs_err": max(r["max_abs_err"] for r in rows),
            **{k: main[k] for k in ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
                                    "library_ms", "library_device_ms", "device_ms_l2_flushed")},
            **{f"prefill_{k}": rows[0][k] for k in ("ms", "device_ms", "plain_ms", "bound_ms",
                                                    "bound_by", "library_ms",
                                                    "library_device_ms")},
            "cases": rows}


def _card_vs_cpu(dev, policy_name: str) -> dict:
    """Phase 6c (and 12g): smollm-360m at full width cut to 2 layers, the
    same weights on the card and the CPU, a [2, 64] prompt and 8 greedy
    steps, both devices fed the CPU's tokens. Logits within the policy's
    tolerance at every step. Under ``fp32`` and ``fp16`` greedy tokens are
    required equal. Under ``bf16`` and ``fp16_opt`` only the logits are
    gated: their tolerance is wider than many top-2 margins of random
    weights (one bf16 ulp of a projection input decides such a tie, on
    either device), so a token check could only pass or flip by chance;
    the greedy tokens that differ are counted and printed, each with the
    CPU's top-2 margin."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import get_arch
    from repro_torch.models import tasks
    from repro_torch.models import transformer as tf
    from repro_torch.precision import get_policy

    cfg = dataclasses.replace(get_arch(SMOLLM), n_layers=2)
    policy = get_policy(policy_name)
    toks = torch.from_numpy(np.random.default_rng(29).integers(0, cfg.vocab_size, (2, 64)))
    errs, runs, fed = [], [], []
    for where in (torch.device("cpu"), dev):
        model = tf.init_params(cfg, policy, seed=31, device=where)
        prefill = tasks.make_prefill_step(cfg, policy, collect_cache=True, cache_len=72)
        decode = tasks.make_decode_step(cfg, policy)
        with torch.inference_mode():
            out, cache = prefill(model, {"tokens": toks.to(where)})
            steps = [out.cpu()]
            for i in range(8):
                if where.type == "cpu":
                    fed.append(out.argmax(dim=-1)[:, None])
                out, cache = decode(model, cache, fed[i].to(where), 64 + i)
                steps.append(out.cpu())
        runs.append(steps)
    tol = CARD_VS_CPU_TOL[policy_name]
    gate_tokens = policy_name in ("fp32", "fp16")
    flips = []
    for i, (cpu, card) in enumerate(zip(*runs)):
        errs.append(max_err(card, cpu))
        require(torch.allclose(card, cpu, rtol=tol, atol=tol) if policy_name == "fp32" else
                torch.allclose(card, cpu, rtol=0, atol=tol),
                f"card vs CPU {policy_name} step {i}: max abs err {errs[-1]}")
        top2 = cpu.float().topk(2, dim=-1).values
        for row in torch.nonzero(card.argmax(-1) != cpu.argmax(-1)).flatten().tolist():
            flips.append({"step": i, "row": row, "cpu_margin": float(top2[row, 0] - top2[row, 1]),
                          "step_err": errs[-1]})
        require(not (gate_tokens and flips),
                f"card vs CPU {policy_name} step {i}: greedy tokens differ: {flips}")
    log(f"[lm] card vs CPU port, {SMOLLM} full width 2 layers {policy_name}: prefill + 8 "
        f"decode steps on the CPU's tokens, max abs logit err {max(errs):.3g} (tolerance "
        f"{tol}); greedy tokens " + ("equal" if gate_tokens else
                                     f"not gated, {len(flips)} of {2 * 9} differ: {flips}"))
    return {"max_abs_err_per_step": errs, "tolerance": tol, "tokens_gated": gate_tokens,
            "tokens_equal": not flips, "token_flips": flips}


def _profile_decode(model, cfg, policy, dev, steps: int = 5) -> dict:
    """Phase 6e: ``steps`` decode steps of the served batch under
    ``torch.profiler`` (after a 512-token prefill and two warm steps)."""
    import numpy as np
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import tasks

    toks = torch.from_numpy(np.random.default_rng(37).integers(
        0, cfg.vocab_size, (LM_BATCH, LM_PROMPT))).to(dev)
    prefill = tasks.make_prefill_step(cfg, policy, collect_cache=True,
                                      cache_len=LM_PROMPT + LM_GEN)
    decode = tasks.make_decode_step(cfg, policy)
    with torch.inference_mode():
        logits, cache = prefill(model, {"tokens": toks})
        pos = LM_PROMPT
        for _ in range(2):
            logits, cache = decode(model, cache, logits.argmax(-1)[:, None], pos)
            pos += 1
        torch.cuda.synchronize()
        for attempt in range(PROFILE_TRIES):  # the profiler may drop records (device_ms)
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for _ in range(steps):
                    logits, cache = decode(model, cache, logits.argmax(-1)[:, None], pos)
                    pos += 1
                torch.cuda.synchronize()
                wall_us = (time.perf_counter() - t0) * 1e6
            spans = sorted((e.time_range.start, e.time_range.end, e.name)
                           for e in prof.events() if e.device_type == DeviceType.CUDA)
            attn = sum(1 for sp in spans if "decode_kernel" in sp[2])
            if attn == steps * cfg.n_layers:
                break
            log(f"[profile] decode: trace {attempt + 1} held {attn} of {steps * cfg.n_layers} "
                "attention launches; tracing again")
    busy, end, by_name = 0.0, float("-inf"), {}
    for s0, s1, name in spans:
        busy += max(0.0, s1 - max(s0, end))
        end = max(end, s1)
        name = name.replace("(anonymous namespace)::", "").removeprefix("void ")
        name = name.split("(")[0][:100]
        by_name[name] = by_name.get(name, 0.0) + (s1 - s0)
    require(attn == steps * cfg.n_layers, f"profile: {attn} attention launches in {steps} "
            f"decode steps, want {steps * cfg.n_layers}")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    attn_us = [s1 - s0 for s0, s1, name in spans if "decode_kernel" in name]
    out = {"device_events": len(spans), "device_events_per_step": len(spans) / steps,
           "decode_attention_us_per_launch": sum(attn_us) / len(attn_us),
           "decode_attention_us_per_launch_max": max(attn_us),
           "device_busy_us_per_step": busy / steps, "host_us_per_step_profiled": wall_us / steps,
           "idle_share": 1.0 - busy / wall_us,
           "device_us_per_step_by_kernel": {n: t / steps for n, t in top}}
    log(f"[lm] profile {steps} decode steps: {len(spans) / steps:.0f} device events per step, "
        f"busy {busy / steps:.1f} us/step of {wall_us / steps:.1f} us/step wall (idle share "
        f"{1.0 - busy / wall_us:.3f}); decode attention {sum(attn_us) / len(attn_us):.2f} us "
        f"per launch in the step (max {max(attn_us):.2f}); largest: "
        + ", ".join(f"{n} {t / steps:.1f} us" for n, t in top[:5]))
    return out


def phase_lm(dev, totals: dict) -> tuple[dict, dict]:
    """Phase 6: the attention kernel's checks and row, smollm-360m served at
    full width (the main path: launches counted), card against CPU, prefill
    against decode at full depth, and a decode profile. Returns (the
    kernel's row, paths)."""
    import numpy as np

    from repro_torch.configs import count_params, get_arch
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import serve
    from repro_torch.models import tasks
    from repro_torch.models import transformer as tf
    from repro_torch.precision import get_policy, tree_bytes

    log(f"[lm] torch.backends.cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}, "
        f"float32 matmul precision {torch.get_float32_matmul_precision()!r}")
    row = _check_attention(dev)
    paths = {}

    cfg, policy = get_arch(SMOLLM), get_policy("fp16")
    t0 = time.perf_counter()
    model = tf.init_params(cfg, policy, seed=0, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    param_bytes = tree_bytes(list(model.parameters()))
    n_params = sum(p.numel() for p in model.parameters())
    kw = dict(batch=LM_BATCH, prompt_len=LM_PROMPT, reduced=False, params=model, device=dev)
    serve(SMOLLM, gen=4, **kw)  # warm-up (cuBLAS handles, allocator)
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launches()
    out = serve(SMOLLM, gen=LM_GEN, **kw)
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated(dev)
    want = {k: 0 for k in launches}
    want["flash_attention"] = cfg.n_layers * LM_GEN  # 1 prefill + 31 decode steps
    require(launches == want, f"serve launches {launches} != {want}")
    _add(totals, launches)
    tokens = out["tokens"]
    require(tokens.shape == (LM_BATCH, LM_GEN) and int(tokens.min()) >= 0
            and int(tokens.max()) < cfg.vocab_size, f"served tokens {tokens.shape}")
    cap = LM_PROMPT + LM_GEN
    kv_bytes = cfg.n_layers * 2 * LM_BATCH * cap * cfg.n_kv_heads * cfg.head_dim * 2
    pos_bytes = cfg.n_layers * cap * 4
    step_ms = out["decode_s"] / (LM_GEN - 1) * 1e3
    paths["lm/smollm-360m/serve/fp16"] = {
        "batch": LM_BATCH, "prompt_len": LM_PROMPT, "gen": LM_GEN,
        "prefill_ms": out["prefill_s"] * 1e3, "decode_ms_per_step": step_ms,
        "decode_tok_s": out["decode_tok_s"],
        "prefill_tok_s": LM_BATCH * LM_PROMPT / out["prefill_s"],
        "params": n_params, "count_params": count_params(cfg), "param_bytes": param_bytes,
        "kv_cache_bytes": kv_bytes, "kv_pos_bytes": pos_bytes, "peak_device_bytes": peak,
        "init_s": init_s, "launches": launches, "tokens_row0": tokens[0].tolist()}
    log(f"[lm] serve {SMOLLM} full width (32 layers) fp16, batch {LM_BATCH}, prompt "
        f"{LM_PROMPT}, gen {LM_GEN}: prefill {out['prefill_s'] * 1e3:.1f} ms, decode "
        f"{step_ms:.2f} ms/step, {out['decode_tok_s']:.1f} tok/s; {n_params} parameters "
        f"({count_params(cfg)} counted without the final norm) in {param_bytes} B, KV cache "
        f"{kv_bytes} B + pos {pos_bytes} B, peak device memory {peak} B; launches {launches}")

    for policy_name in ("fp32", "fp16"):
        paths[f"lm/smollm-360m-2l/card_vs_cpu/{policy_name}"] = _card_vs_cpu(dev, policy_name)

    # Prefill against decode at full depth (the reference's test_archs check).
    toks = torch.from_numpy(np.random.default_rng(41).integers(0, cfg.vocab_size, (1, 8))).to(dev)
    with torch.inference_mode():
        logits_p = tasks.make_prefill_step(cfg, policy)(model, {"tokens": toks})
        cache = tf.init_cache(cfg, 1, 16, policy.state_storage, dev)
        step = tasks.make_decode_step(cfg, policy)
        for pos in range(8):
            logits_d, cache = step(model, cache, toks[:, pos:pos + 1], pos)
    err = max_err(logits_p, logits_d)
    require(bool(torch.isfinite(logits_d).all()) and torch.allclose(
        logits_p, logits_d, rtol=5e-2, atol=5e-2),
            f"prefill vs decode at full depth: max abs err {err}")
    paths["lm/smollm-360m/prefill_vs_decode/fp16"] = {"max_abs_err": err, "tolerance": 5e-2}
    log(f"[lm] prefill vs token-by-token decode, {SMOLLM} 32 layers fp16: max abs logit "
        f"err {err:.3g} (tolerance 5e-2)")

    paths["profile/lm/smollm-360m/decode/fp16"] = _profile_decode(model, cfg, policy, dev)
    return row, paths


def _per_call_matmul(static, packed):
    """The per-call syn_matmul path, the earlier one, in ``ops.MatmulRun``'s
    shape: one ``ops.syn_matmul`` per dense bucket and tick."""
    from repro_torch.kernels import ops

    return lambda bi, x: ops.syn_matmul(x[None, :], packed[bi])[0]


class _PerBucketGather:
    """The per-bucket gather path, the earlier one, in
    ``ops.GatherRun``'s shape: each tick ``ops.syn_gather`` on every
    sparse bucket's pre row, each drive added at its post columns into
    rows zeroed first, in plan order (a compiled plan's sparse buckets
    come first)."""

    def __init__(self, static, params, packed):
        from repro_torch.core import backend as be
        from repro_torch.kernels import ops

        self._go = lambda bi, x: ops.syn_gather(be._bucket_pre(static, params, x, bi),
                                                params.bucket_csr_idx[bi], packed[bi])
        self._sparse = [(bi, b) for bi, b in enumerate(static.buckets) if b.kind == "sparse"]
        self._ids = params.bucket_post_ids
        self.delays = tuple(sorted({b.delay_ms for _, b in self._sparse}))
        self.starts = [0] if self._sparse else []
        self.rows = torch.zeros((len(self.delays), static.n), device=params.neuron.a.device)

    def __call__(self, g, x):
        self.rows.zero_()
        for bi, b in self._sparse:
            row, drive = self.rows[self.delays.index(b.delay_ms)], self._go(bi, x)
            if b.post_start >= 0:
                row[b.post_start:b.post_start + b.q] += drive
            else:
                row.index_add_(0, self._ids[bi], drive)


def _none(*args, **kwargs):
    """A launcher builder that builds nothing: the engine then runs that
    phase op by op or call by call, the earlier path."""
    return None


# (key, propagation, plastic chain, backend builder swapped, its earlier path)
IN_TURNS = (
    ("synfire4/fp16/packed/matmul_launcher_vs_per_call", "packed", False, "assemble_matmul",
     _per_call_matmul),
    ("synfire4/fp16/sparse/gather_launcher_vs_per_call", "sparse", False, "assemble_gather",
     _PerBucketGather),
    ("synfire4/fp16/sparse/neuron_launcher_vs_per_op", "sparse", False, "assemble_neurons",
     _none),
    ("synfire4/fp16/packed/neuron_launcher_vs_per_op", "packed", False, "assemble_neurons",
     _none),
    ("synfire4_plastic/fp16/sparse/stdp_launcher_vs_per_call", "sparse", True,
     "assemble_stdp_gather", _none),
    ("synfire4_plastic/fp16/packed/stdp_launcher_vs_per_call", "packed", True,
     "assemble_stdp_update", _none),
)


def _launchers_in_turns(dev, ticks: int = 300) -> dict:
    """Host us/tick and device events per tick of the Synfire4 fp16 default
    tick through each per-run launcher of the engine (``backend.<builder>``)
    against the earlier path it replaced (the builder swapped for a shim
    in this file: per-call ``ops.syn_matmul``, the per-bucket gathers, or
    none at all, where the engine then runs the neuron phase op by op or
    STDP call by call), in turns (per call, launcher, launcher, per call)
    in one process, every other launcher on in both; each pair must give
    the same raster (and, for plastic, the same final weights and traces).
    Device events per tick from a ``torch.profiler`` trace of 20 ticks."""
    from repro_torch.configs.synfire4 import CHAIN_STDP, SYNFIRE4, build_synfire
    from repro_torch.core import backend as be
    from repro_torch.core.engine import run

    out = {}
    for key, propagation, plastic, builder, earlier in IN_TURNS:
        net = build_synfire(SYNFIRE4, policy="fp16", propagation=propagation, device=dev,
                            stdp_chain=CHAIN_STDP if plastic else None)
        gu = torch.rand((ticks, SYNFIRE4.n_stim), device=dev)
        launcher = getattr(be, builder)
        times, finals, events = {"per_call": [], "launcher": []}, {}, {}
        try:
            for mode in ("per_call", "launcher", "launcher", "per_call"):
                setattr(be, builder, launcher if mode == "launcher" else earlier)
                run(net.static, net.params, net.state0, 20, gen_u=gu[:20])
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                finals[mode] = run(net.static, net.params, net.state0, ticks, gen_u=gu)
                torch.cuda.synchronize()
                times[mode].append((time.perf_counter() - t0) / ticks * 1e6)
                if mode not in events:
                    events[mode] = len(_cuda_events(
                        lambda: run(net.static, net.params, net.state0, 20, gen_u=gu[:20]),
                        1)) / 20
        finally:
            setattr(be, builder, launcher)
        (fl, ol), (fp, op) = finals["launcher"], finals["per_call"]
        require(torch.equal(ol["spikes"], op["spikes"]),
                f"{key}: the launcher's raster differs from the earlier path's")
        if plastic:
            _require_same_plastic_state((net, None, fl), (net, None, fp), key)
        out[key] = {**{f"{k}_us_per_tick": v for k, v in times.items()},
                    **{f"{k}_device_events_per_tick": v for k, v in events.items()}}
        log(f"[profile] {key}, host us/tick in turns: earlier path {times['per_call']}, "
            f"launcher {times['launcher']} (same raster" + (" and weights" if plastic else "")
            + f"); device events per tick {events}")
    return out


def phase_profile(dev) -> dict:
    """Device busy time per tick and idle share of the Synfire4 fp16 tick,
    from a ``torch.profiler`` trace of 100 ticks per propagation mode and
    backend: busy is the union of the device's activity intervals, idle
    share is 1 - busy / host wall time (the profiler's own host cost
    included, so idle reads high). On the fused path it also counts the
    device events from the first ``fused_tick`` launch to the last: one
    per tick."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs.synfire4 import CHAIN_STDP, SYNFIRE4, build_synfire
    from repro_torch.core.engine import run

    out = {}
    ticks = 100
    for propagation, backend, stdp in (
            ("packed", None, None), ("sparse", None, None), ("packed", "fused", None),
            ("sparse", "fused", None), ("packed", None, CHAIN_STDP),
            ("sparse", None, CHAIN_STDP)):
        net = build_synfire(SYNFIRE4, policy="fp16", propagation=propagation,
                            device=dev, backend=backend, stdp_chain=stdp)
        gu = torch.rand((ticks, SYNFIRE4.n_stim), device=dev)
        run(net.static, net.params, net.state0, 20, gen_u=gu[:20])
        torch.cuda.synchronize()
        key = (f"profile/synfire4{'_plastic' if stdp else ''}/fp16/{propagation}"
               + ("/fused" if backend else ""))
        for attempt in range(PROFILE_TRIES):
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                run(net.static, net.params, net.state0, ticks, gen_u=gu)
                torch.cuda.synchronize()
                wall_us = (time.perf_counter() - t0) * 1e6
            spans = sorted((e.time_range.start, e.time_range.end, e.name)
                           for e in prof.events() if e.device_type == DeviceType.CUDA)
            launched = sum("fused_tick_kernel" in sp[2] for sp in spans)
            if not backend or launched == ticks:
                break
            log(f"[profile] {key}: trace {attempt + 1} held {launched} of {ticks} "
                "fused_tick launches; tracing again")
        busy, end, by_name = 0.0, float("-inf"), {}
        for s0, s1, name in spans:
            busy += max(0.0, s1 - max(s0, end))
            end = max(end, s1)
            name = name.replace("(anonymous namespace)::", "").removeprefix("void ")
            name = name.split("(")[0][:100]  # drop the signature
            by_name[name] = by_name.get(name, 0.0) + (s1 - s0)
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
        in_loop = None
        if backend:
            starts = [i for i, sp in enumerate(spans) if "fused_tick_kernel" in sp[2]]
            require(len(starts) == ticks, f"profile {key}: {len(starts)} fused_tick "
                    f"launches in {ticks} ticks")
            in_loop = (starts[-1] - starts[0] + 1) / ticks
            require(in_loop == 1.0, f"profile {key}: {in_loop} device events per tick "
                    "inside the loop, want 1")
        out[key] = {
            "device_events": len(spans),
            "device_events_per_tick_in_loop": in_loop,
            "device_busy_us_per_tick": busy / ticks if spans else None,
            "host_us_per_tick_profiled": wall_us / ticks,
            "idle_share": 1.0 - busy / wall_us if spans else None,
            "device_us_per_tick_by_kernel": {n: t / ticks for n, t in top},
        }
        log(f"[profile] {key}: {len(spans)} device events, busy "
            f"{busy / ticks:.1f} us/tick of {wall_us / ticks:.1f} us/tick wall "
            f"(idle share {1.0 - busy / wall_us:.3f})" if spans else
            f"[profile] {key}: the profiler recorded no "
            "device activity")
    out.update(_launchers_in_turns(dev))
    return out


# -- training (A12b) ------------------------------------------------------------------

TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 512, 10
# Phase 13e's depth: 32 until phase 15 came to share the script's time.
TRAIN_CUT_LAYERS = 8
# Of each output's scale: the kernel and the plain version (cuBLAS) sum in
# their own orders, over up to Sq x G terms for dK and dV (1.5e-5 measured
# at smollm's shape, run 3; NVIDIA H100 80GB HBM3).
BWD_TOL = 2e-4
# Card against the CPU port, one step from the same state and tokens (full
# width, 2 layers): fp32 sums in another order; under fp16 each gradient is
# also rounded to fp16 on its way back, where a sum one ulp apart flips it.
TRAIN_CARD_TOL = {"fp32": {"loss": 1e-5, "grad_norm": 1e-4, "losses": 1e-4},
                  "fp16": {"loss": 1e-4, "grad_norm": 1e-3, "losses": 1e-3}}


def _bwd_case(g, b, s, hq, hkv, d, dev, invalid=0, shift=0):
    q = torch.randn((b, s, hq, d), generator=g)
    k = torch.randn((b, s, hkv, d), generator=g)
    v = torch.randn((b, s, hkv, d), generator=g)
    dout = torch.randn((b, s, hq, d), generator=g)
    kpos = torch.arange(s, dtype=torch.int32)
    if invalid:
        kpos[-invalid:] = -1
    qpos = (torch.arange(s, dtype=torch.int32) + shift).expand(b, s)
    return [x.contiguous().to(dev) for x in (q, k, v, qpos, kpos, dout)]


# flash_attn_bwd's sub-kernels, by name in a trace.
BWD_PARTS = ("delta_kernel", "dkv_kernel", "reduce_kernel", "dq_kernel", "reduce_q_kernel")
# Split TF32: three tensor-core passes at 495 TFLOP/s, f32-accurate products.
SPLIT_TF32_OPS_PER_S = 495e12 / 3


def device_split_ms(fn, reps: int = 10) -> tuple[float, dict]:
    """Mean device time (ms) per call of all kernels ``fn`` launches, and
    per kernel name, from one ``torch.profiler`` trace of ``reps`` calls
    (traced again as :func:`device_total_ms` is when records are missing)."""
    best: list = []
    for attempt in range(PROFILE_TRIES):
        trace = [(e.name, e.time_range.elapsed_us()) for e in _cuda_events(fn, reps)]
        if len(trace) > len(best):
            best = trace
        if len(best) >= reps:
            break
        log(f"[profile] by kernel: trace {attempt + 1} held {len(trace)} events in {reps} "
            "calls; tracing again")
    require(len(best) >= reps // 2, f"profiler saw {len(best)} kernels in {reps} calls")
    by: dict = {}
    for n, us in best:
        by[n] = by.get(n, 0.0) + us / reps / 1e3
    return sum(by.values()), by


def _bwd_row(name, args, causal, window):
    """Check and time B7's forward with the rows' log-sum-exp and the
    attention backward on one case: each output against its plain version
    (within ``BWD_TOL`` of its scale), two backward calls bit for bit; per
    call and on the device, the backward split by sub-kernel (delta,
    dK/dV, the head and split reduction, dQ, the dQ splits' sum), the plain
    backward, the backward of one ``scaled_dot_product_attention`` on the
    same f32 inputs (``is_causal`` where the mask is the index-causal one,
    else an explicit boolean ``attn_mask``; ``enable_gqa``) with the names
    of the kernels it ran; and two bounds: the inputs read and the
    gradients written once at 3.35 TB/s, or five f32 products (2
    operations each) of D per allowed (query, key) pair and head at 67
    TFLOP/s (``bound_ms``) or as split TF32 at 165 TFLOP/s
    (``bound_tc_ms``), whichever is larger. ``device_ms`` sums the
    sub-kernels' device times; dQ runs beside dK/dV on a second stream, so
    the call (``ms``, CUDA events over back-to-back calls) can take less.
    ``added_s``: the seconds SDPA took where it needs an explicit mask
    (not timed before)."""
    from repro_torch.kernels import ops, ref

    q, k, v, qpos, kpos, dout = args
    fwd = lambda: ops._attention_fwd(q, k, v, qpos, kpos, causal, window, with_lse=True)  # noqa: E731
    out, lse = fwd()
    bwd = lambda: ops.attention_bwd(q, k, v, qpos, kpos, out, lse, dout, causal=causal,  # noqa: E731
                                    window=window)
    got, again = bwd(), bwd()
    w_out, w_lse = ref.chunked_attention_ref(q, k, v, qpos, kpos, causal=causal,
                                             window=window, return_lse=True)
    plain = lambda: ref.chunked_attention_bwd_ref(q, k, v, qpos, kpos, w_out, w_lse, dout,  # noqa: E731
                                                  causal=causal, window=window)
    want = plain()
    torch.cuda.synchronize()
    require(all(torch.equal(x, y) for x, y in zip(got, again)),
            f"flash_attn_bwd {name}: two calls differ")
    errs, rel = {}, {}
    for what, x, y in zip(("out", "lse", "dq", "dk", "dv"), (out, lse, *got), (w_out, w_lse, *want)):
        errs[what] = max_err(x, y)
        rel[what] = errs[what] / max(float(y.abs().max()), 1.0)
        require(rel[what] <= BWD_TOL, f"flash_attn_bwd {name}: {what} max abs err "
                f"{errs[what]}, {rel[what]} of its scale > {BWD_TOL}")
    allowed = _allowed(qpos, kpos, causal, window)
    pairs = int(allowed.sum())
    b, s, hq, d = q.shape
    moved, flops = nbytes(q, k, v, out, lse, dout, qpos, kpos) + nbytes(*got), 10 * hq * d * pairs
    b_ms, b_by = bound(moved, flops)
    tc_ms = max(moved / HBM_BYTES_PER_S, flops / SPLIT_TF32_OPS_PER_S) * 1e3
    device, kernels = device_split_ms(bwd)
    parts = {p: sum(ms for n, ms in kernels.items() if p in n) for p in BWD_PARTS}
    require(abs(sum(parts.values()) - device) <= 1e-6 * max(device, 1.0),
            f"flash_attn_bwd {name}: kernels outside the sub-kernels: {sorted(kernels)}")
    # SDPA's backward on the same inputs and mask.
    tril = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
    index_causal = causal and window <= 0 and torch.equal(allowed, tril.expand_as(allowed))
    t_added = time.perf_counter()
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_() for x in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    mask = None if index_causal else allowed[:, None]
    ot = sdpa(qt, kt, vt, attn_mask=mask, is_causal=index_causal, enable_gqa=True)
    gt = dout.transpose(1, 2).contiguous()

    def sdpa_bwd():
        return torch.autograd.grad(ot, (qt, kt, vt), gt, retain_graph=True)

    library = cuda_ms(sdpa_bwd, reps=20, warmup=3)
    library_device, lib_kernels = device_split_ms(sdpa_bwd)
    top = sorted(lib_kernels.items(), key=lambda kv: -kv[1])[:4]
    library_finite = bool(all(torch.isfinite(x).all() for x in sdpa_bwd()))
    t_added = 0.0 if index_causal else time.perf_counter() - t_added  # new with the mask
    row = {"case": name, "shape": f"q {list(q.shape)} kv {list(k.shape)} causal={causal} "
           f"window={window}", "max_abs_err": max(errs.values()), "errs": errs,
           "errs_of_scale": rel,
           "allowed_pairs": pairs, "ms": cuda_ms(bwd, reps=20, warmup=3),
           "device_ms": device, "parts_ms": parts,
           "fwd_lse_ms": cuda_ms(fwd, reps=20, warmup=3),
           "fwd_ms": cuda_ms(lambda: ops.attention(q, k, v, qpos, kpos, causal=causal,
                                                   window=window), reps=20, warmup=3),
           "plain_ms": cuda_ms(plain, reps=3, warmup=1), "bound_ms": b_ms, "bound_by": b_by,
           "bound_tc_ms": tc_ms, "library_ms": library, "library_device_ms": library_device,
           "library_mask": "is_causal" if index_causal else "attn_mask",
           "library_kernels_ms": {n[:100]: ms for n, ms in top},
           "library_finite": library_finite, "added_s": t_added}
    part_us = {p.removesuffix("_kernel"): round(ms * 1e3, 2) for p, ms in parts.items() if ms}
    log(f"[train] flash_attn_bwd {name} ({row['shape']}): errs {errs}, of the scale "
        f"{ {k: float(f'{v:.3g}') for k, v in rel.items()} }, "
        f"{row['ms'] * 1e3:.2f} us per call ({device * 1e3:.2f} us on the device: {part_us}), "
        f"plain {row['plain_ms'] * 1e3:.2f} us, bound {b_ms * 1e3:.3f} us ({b_by}; split TF32 "
        f"{tc_ms * 1e3:.3f}), SDPA backward {library * 1e3:.2f} us ({library_device * 1e3:.2f} "
        f"us on the device, {row['library_mask']}{'' if library_finite else ', not finite'}: "
        f"{[n[:60] for n, _ in top[:2]]}); forward with lse {row['fwd_lse_ms'] * 1e3:.2f} us, "
        f"without {row['fwd_ms'] * 1e3:.2f} us; added {t_added:.2f} s")
    return row


def _check_bwd(dev) -> dict:
    """Phase 13a; returns the backward kernel's row (its numbers: smollm's
    training shape) with every case under ``cases``."""
    g = torch.Generator(device="cpu").manual_seed(43)
    cases = [
        ("smollm train [8,512,15,64], 5 KV heads", _bwd_case(g, 8, 512, 15, 5, 64, dev),
         True, -1),
        ("reduced [4,64,4,16], 1 KV head", _bwd_case(g, 4, 64, 4, 1, 16, dev), True, -1),
        ("5 rows per KV head (decode-sized)", _bwd_case(g, 2, 5, 3, 1, 16, dev), True, -1),
        ("window 64, group 4", _bwd_case(g, 2, 160, 8, 2, 16, dev), True, 64),
        ("invalid slots and rows with no key",
         _bwd_case(g, 2, 40, 6, 2, 64, dev, invalid=5, shift=-8), True, -1),
        ("D 128, group 5 (qwen2.5)", _bwd_case(g, 1, 512, 10, 2, 128, dev), True, -1),
        ("D 128, group 4 (minitron)", _bwd_case(g, 1, 512, 8, 2, 128, dev), True, -1),
        ("D 160, group 4 (stablelm)", _bwd_case(g, 1, 512, 8, 2, 160, dev), True, -1),
        ("Sk 1,536, group 3", _bwd_case(g, 1, 1536, 15, 5, 64, dev), True, -1),
        ("D 20 (4-byte copies), group 7, Sk 100", _bwd_case(g, 2, 100, 7, 1, 20, dev), True, -1),
    ]
    t0 = time.perf_counter()
    rows = [_bwd_row(name, args, causal, window) for name, args, causal, window in cases]
    log(f"[train] phase 13a: {time.perf_counter() - t0:.1f} s, of which SDPA under an "
        f"explicit mask {sum(r['added_s'] for r in rows):.2f} s")
    main = rows[0]
    return {"name": "flash_attention_bwd", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attn_bwd.cu",
            "replaces": "src/repro/models/attention.py:53 (XLA autodiff of chunked_attention; "
                        "no Pallas kernel)",
            "shape": main["shape"], "max_abs_err": max(r["max_abs_err"] for r in rows),
            **{k: main[k] for k in ("ms", "device_ms", "parts_ms", "plain_ms", "bound_ms",
                                    "bound_by", "bound_tc_ms", "library_ms",
                                    "library_device_ms", "library_kernels_ms", "fwd_lse_ms",
                                    "fwd_ms")},
            "cases": rows}


def _state_to(state, dev):
    from repro_torch.precision.policy import tree_map

    return tree_map(lambda x: x.to(dev), state)


def _train_card_vs_cpu(dev, policy_name: str) -> dict:
    """Phase 13c: smollm-360m at full width cut to 2 layers, one state on
    the CPU and the card, 2 x 64 tokens: one step's loss, grad norm and
    every new master (within 2 lr_t: Adam's first step moves each entry by
    about lr_t sign(g), so a gradient entry that is rounding noise on both
    devices may move the other way), then three steps' losses."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.data.synthetic import TokenStream
    from repro_torch.models import tasks
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.precision import get_policy
    from repro_torch.precision.policy import tree_leaves

    cfg = dataclasses.replace(get_arch(SMOLLM), n_layers=2)
    policy = get_policy(policy_name)
    lr = 1e-3
    step = tasks.make_train_step(cfg, policy, opt_cfg=AdamWConfig(lr=lr), ce_chunk=64)
    stream = TokenStream(cfg.vocab_size, 64, 2, seed=3)
    state0 = tasks.init_train_state(cfg, policy, seed=5, device="cpu")
    out = {}
    for where, state in (("cpu", state0), ("card", _state_to(state0, dev))):
        losses, first = [], None
        where_dev = state["params"]["embed"].device
        for i in range(3):
            state, m = step(state, {"tokens": stream.batch(i)["tokens"].to(where_dev)})
            losses.append(float(m["loss"]))
            if i == 0:
                first = ({k: float(v) for k, v in m.items()}, _state_to(state, "cpu"))
        out[where] = (losses, first)
    tol = TRAIN_CARD_TOL[policy_name]
    (cl, (cm, cs)), (gl, (gm, gs)) = out["cpu"], out["card"]
    lr_t = lr * 2 / 100
    master = "master" if policy.master_fp32 else "params"
    leaf_err = max(max_err(a, b) for a, b in zip(tree_leaves(gs[master]),
                                                 tree_leaves(cs[master])))
    rel = {k: abs(gm[k] - cm[k]) / abs(cm[k]) for k in ("loss", "grad_norm")}
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(gl, cl))
    require(rel["loss"] <= tol["loss"] and rel["grad_norm"] <= tol["grad_norm"],
            f"train card vs CPU {policy_name}: {rel} against {tol}")
    require(leaf_err <= 2 * lr_t + 1e-6, f"train card vs CPU {policy_name}: a new master "
            f"is {leaf_err} from the CPU's (> 2 lr_t = {2 * lr_t})")
    require(loss_rel <= tol["losses"], f"train card vs CPU {policy_name}: 3-step losses "
            f"{gl} against {cl}")
    log(f"[train] card vs CPU port, {SMOLLM} full width 2 layers {policy_name}: step 1 loss "
        f"rel {rel['loss']:.3g}, grad norm rel {rel['grad_norm']:.3g}, new masters max abs "
        f"{leaf_err:.3g} (2 lr_t = {2 * lr_t:.3g}); 3-step losses card {gl} CPU {cl} (max rel "
        f"{loss_rel:.3g}); tolerance {tol}")
    return {"rel": rel, "master_max_abs": leaf_err, "losses_card": gl, "losses_cpu": cl,
            "losses_max_rel": loss_rel, "tolerance": tol}


def _train_learns_and_resumes(dev) -> dict:
    """Phase 13d on the card: the reduced smollm learns over 20 steps at lr
    3e-3 (the reference's ``test_loss_descends``); 4 straight steps equal
    2 steps, ``save``, ``restore`` and 2 more, bit for bit; a NaN in the
    embedding's master skips the step."""
    import tempfile

    from repro_torch.checkpoint import ckpt
    from repro_torch.configs import get_arch, reduce_arch
    from repro_torch.data.synthetic import TokenStream
    from repro_torch.models import tasks
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.precision import get_policy
    from repro_torch.precision.policy import tree_leaves

    cfg, policy = reduce_arch(get_arch(SMOLLM)), get_policy("fp16")
    step = tasks.make_train_step(cfg, policy, opt_cfg=AdamWConfig(lr=3e-3), ce_chunk=32)
    stream = TokenStream(cfg.vocab_size, 64, 4, seed=1)
    batch = lambda i: {"tokens": stream.batch(i)["tokens"].to(dev)}  # noqa: E731
    state = tasks.init_train_state(cfg, policy, seed=0, device=dev)
    losses = []
    for i in range(20):
        state, m = step(state, batch(i))
        losses.append(float(m["loss"]))
    first, last = sum(losses[:5]) / 5, sum(losses[-5:]) / 5
    require(all(map(math.isfinite, losses)) and last < first,
            f"reduced {SMOLLM} on the card does not learn: {losses}")

    s = tasks.init_train_state(cfg, policy, seed=5, device=dev)
    for i in range(4):
        s, m_straight = step(s, batch(100 + i))
    s2 = tasks.init_train_state(cfg, policy, seed=5, device=dev)
    for i in range(2):
        s2, _ = step(s2, batch(100 + i))
    with tempfile.TemporaryDirectory() as d:
        ckpt.save(d, 2, s2)
        s2 = ckpt.restore(d, 2, tasks.init_train_state(cfg, policy, seed=9, device=dev))
    for i in range(2, 4):
        s2, m_resumed = step(s2, batch(100 + i))
    same = all(torch.equal(a, b) for a, b in zip(tree_leaves((s, m_straight)),
                                                  tree_leaves((s2, m_resumed))))
    require(same, "4 straight steps on the card differ from 2 + save/restore + 2")

    bad = tasks.init_train_state(cfg, policy, seed=0, device=dev)
    bad["master"]["embed"][0, 0] = float("nan")
    scale_before = bad["master"]["final_norm"]["scale"].clone()
    new, m = step(bad, {"tokens": torch.zeros((4, 32), dtype=torch.int64, device=dev)})
    skipped = float(m["skipped"])
    require(skipped == 1.0 and torch.equal(new["master"]["final_norm"]["scale"], scale_before)
            and float(new["scale"].scale) == 2048.0 and int(new["opt"].step) == 0,
            f"the NaN step on the card was not skipped: {m}")
    log(f"[train] reduced {SMOLLM} fp16 on the card, 20 steps at lr 3e-3: loss {losses[0]:.4f} "
        f"-> {losses[-1]:.4f} (mean of the first 5 {first:.4f}, of the last 5 {last:.4f}); "
        f"resume bit for bit: {same}; NaN step skipped, scale 4096 -> "
        f"{float(new['scale'].scale):.0f}")
    return {"losses": losses, "first5": first, "last5": last, "resume_bitwise": same,
            "nan_skipped": skipped}


def _train_cut(cfg, policy_name: str, steps: int, dev) -> dict:
    """``launch.train.train``'s loop (lr 1e-4, its warm-up, ``TokenStream``
    batches, the loss read back each step) on ``cfg``, a depth cut of
    smollm-360m: ``train`` takes an arch by name only."""
    from repro_torch.data.synthetic import TokenStream
    from repro_torch.models import tasks
    from repro_torch.optim.adamw import AdamWConfig

    opt = AdamWConfig(lr=1e-4, warmup_steps=max(10, steps // 20))
    state = tasks.init_train_state(cfg, policy_name, seed=0, device=dev)
    step_fn = tasks.make_train_step(cfg, policy_name, opt_cfg=opt, ce_chunk=min(512, TRAIN_SEQ))
    stream = TokenStream(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=0)
    losses, times = [], []
    for i in range(steps):
        t0 = time.perf_counter()
        state, m = step_fn(state, {"tokens": stream.batch(i)["tokens"].to(dev)})
        losses.append(float(m["loss"]))
        times.append(time.perf_counter() - t0)
    return {"losses": losses, "times": times, "state": state}


def _train_full(dev, policy_name: str, steps: int, totals: dict | None,
                layers: int | None = None) -> dict:
    """smollm-360m at full width (32 layers, or cut to ``layers``) through
    ``launch.train.train`` (:func:`_train_cut` at a cut depth) from
    ``TokenStream``: ``steps`` steps of batch 8 x 512. Losses finite, no
    step skipped (the scale stays at the policy's, the step count at
    ``steps``); with ``totals`` the launches are counted (the main path)
    and required: 2 B7 forwards a layer a step (remat runs each block
    twice) and one backward."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops
    from repro_torch.launch.train import train
    from repro_torch.precision import get_policy

    cfg, policy = get_arch(SMOLLM), get_policy(policy_name)
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launches()
    if layers is None:
        out = train(SMOLLM, steps=steps, global_batch=TRAIN_BATCH, seq_len=TRAIN_SEQ,
                    policy_name=policy_name, reduced=False, lr=1e-4, seed=0, log_every=steps,
                    device=dev)
    else:
        cfg = dataclasses.replace(cfg, n_layers=layers)
        out = _train_cut(cfg, policy_name, steps, dev)
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated(dev)
    state = out["state"]
    require(all(map(math.isfinite, out["losses"])), f"train {policy_name}: {out['losses']}")
    want_scale = policy.loss_scale or 1.0
    require(float(state["scale"].scale) == want_scale and int(state["opt"].step) == steps,
            f"train {policy_name}: a step was skipped (scale {float(state['scale'].scale)}, "
            f"step {int(state['opt'].step)})")
    if totals is not None:
        want = {k: 0 for k in launches}
        want["flash_attention"] = 2 * cfg.n_layers * steps
        want["flash_attention_bwd"] = cfg.n_layers * steps
        require(launches == want, f"train launches {launches} != {want}")
        _add(totals, launches)
    times = out["times"][2:] if steps > 3 else out["times"][1:]
    ms = sorted(times)[len(times) // 2] * 1e3
    tokens = TRAIN_BATCH * TRAIN_SEQ
    res = {"policy": policy_name, "layers": cfg.n_layers, "steps": steps, "batch": TRAIN_BATCH,
           "seq_len": TRAIN_SEQ,
           "losses": out["losses"], "ms_per_step_median": ms,
           "ms_per_step": [t * 1e3 for t in out["times"]], "tokens_per_s": tokens / ms * 1e3,
           "peak_device_bytes": peak, "launches": launches,
           "loss_scale": float(state["scale"].scale)}
    log(f"[train] {SMOLLM} full width ({cfg.n_layers} layers) {policy_name}, batch {TRAIN_BATCH} x "
        f"{TRAIN_SEQ}, {steps} steps: losses {out['losses'][0]:.4f} -> {out['losses'][-1]:.4f}, "
        f"{ms:.1f} ms/step (median after warm-up; steps {[round(t * 1e3, 1) for t in out['times']]}), "
        f"{res['tokens_per_s']:.0f} tokens/s, peak device memory {peak} B, launches {launches}")
    return res


def phase_train(dev, totals: dict) -> tuple[dict, dict]:
    """Phase 13: the attention backward and B7's log-sum-exp against their
    plain versions (a); smollm-360m trained at full width, the main path
    (b); the card against the CPU port (c); learning, resume and the NaN
    skip (d); the bf16 and fp16_opt policies at full width (e). Returns
    (the backward kernel's row, paths)."""
    t0 = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    log(f"[train] {smi}")
    row = _check_bwd(dev)
    paths = {"train/card": smi,
             "train/smollm-360m/fp16": _train_full(dev, "fp16", TRAIN_STEPS, totals)}
    for policy_name in ("fp32", "fp16"):
        paths[f"train/smollm-360m-2l/card_vs_cpu/{policy_name}"] = _train_card_vs_cpu(
            dev, policy_name)
    paths["train/smollm-360m-reduced/learn_resume_nan"] = _train_learns_and_resumes(dev)
    for policy_name in ("bf16", "fp16_opt"):
        paths[f"train/smollm-360m/{policy_name}"] = _train_full(dev, policy_name, 3, None,
                                                                layers=TRAIN_CUT_LAYERS)
    seconds = time.perf_counter() - t0
    paths["train/phase_s"] = seconds
    log(f"[train] phase 13 in {seconds:.1f} s")
    return row, paths


def _train_main(out: str) -> int:
    """``--train-json PATH``: phase 13 alone, its row, paths and launch
    counts written to ``PATH`` as JSON."""
    from repro_torch.kernels import _build, ops

    _build.build()
    totals = {k: 0 for k in ops.LAUNCHES}
    row, paths = phase_train(torch.device("cuda", 0), totals)
    Path(out).write_text(json.dumps({"row": row, "paths": paths, "totals": totals},
                                    default=str))
    return 0


# -- the other five LM families (A12c) ---------------------------------------------------

ARCHS_NEW = ("granite-moe-1b-a400m", "qwen2-moe-a2.7b", "falcon-mamba-7b", "recurrentgemma-2b",
             "musicgen-large", "qwen2-vl-2b")
# Depth at full width: one period of the hybrid (two RG-LRU layers and one
# local-attention layer), 2 layers otherwise. Each arch is drawn once, as a
# train state on the CPU in phase 14's CPU half (the randn of 1.76 B
# weights alone takes about 18 s there): its params serve, and it trains
# on the card. qwen2-moe trains on its first
# layer only: at 2 layers its f32 masters, moments, gradients and saved
# activations ran out of the card's 80 GB.
ARCH_DEPTH = {"recurrentgemma-2b": 3}
ARCH_TRAIN_LAYERS = {"qwen2-moe-a2.7b": 1}
# Serving: batch 2, 128-token prompts and 8 tokens; the hybrid serves one
# 2,100-token prompt into a 2,048-slot cache (its window), so prefill
# packs a ring of the last 2,048 tokens and every decode step writes past
# a wrap.
ARCH_SERVE = {"recurrentgemma-2b": dict(batch=1, prompt_len=2100, gen=8, capacity=2048)}
ARCH_SERVE_DEFAULT = dict(batch=2, prompt_len=128, gen=8)
# One train step: batch 4 x 512 (the hybrid 1 x 2,560, so that its window of
# 2,048 binds in the forward and the backward).
ARCH_TRAIN = {"recurrentgemma-2b": (1, 2560)}
ARCH_TRAIN_DEFAULT = (4, 512)
# Card against the CPU port (fp16, full width at the depths above): one fp16
# ulp of a projection input moves a logit by up to about 3e-3 at full width
# (smollm, ROADMAP queue C), 4e-3 held there; the same here but for the
# hybrid, whose RG-LRU gates carry an f32 ulp of their exp and sigmoid
# through the recurrence into every later position (queue C).
ARCH_CARD_TOL = {"recurrentgemma-2b": 8e-3}
ARCH_CARD_TOL_DEFAULT = 4e-3
# One train step card against CPU port: the first moments at queue C's
# fp16 5e-3 of a leaf's scale (each cotangent rounds to fp16 on its way
# back, where a sum one f32 ulp apart lands an fp16 ulp apart).
ARCH_TRAIN_TOL = {"loss": 1e-4, "grad_norm": 1e-3, "m": 5e-3}


def _arch_cfg(arch: str, depth: int | None = None):
    import dataclasses

    from repro_torch.configs import get_arch

    cfg = get_arch(arch)
    return dataclasses.replace(cfg, n_layers=depth or ARCH_DEPTH.get(arch, 2))


def _attn_layers(cfg) -> int:
    return sum(cfg.layer_kind(i) == "attn" for i in range(cfg.n_layers))


def _vlm_batch(cfg, b: int, s: int, seed: int, dev):
    """The VLM's prefill batch: ``cfg.n_patches`` bf16 patch embeddings on
    a 16-wide grid at t = 0 (repeated key positions), then ``s`` text
    tokens at t = h = w = 2, 3, ... (as the reference's test batch)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    p = cfg.n_patches
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s)))
    patches = torch.from_numpy(rng.normal(size=(b, p, cfg.d_model)).astype(np.float32))
    pos = np.zeros((b, p + s, 3), np.int32)
    pos[:, :p, 1] = np.arange(p) // 16
    pos[:, :p, 2] = np.arange(p) % 16
    pos[:, p:] = (np.arange(s) + 2)[None, :, None]
    return {"tokens": toks.to(dev), "patch_embeds": patches.to(torch.bfloat16).float().to(dev),
            "positions": torch.from_numpy(pos).to(dev)}


def _arch_attn_cases(g, dev) -> list:
    """Phase 14a's B7 cases: the new families' shapes."""
    f16, f32 = torch.float16, torch.float32
    # The hybrid's ring after a wrap: 2,048 slots holding positions P-2047..P
    # at slot pos mod 2048, the query at P, window 2,048.
    p_now = 2107
    ring = _attn_case(g, 1, 1, 2048, 10, 1, 256, f16, dev)
    slots = torch.arange(2048)
    ring[4] = (p_now - ((p_now - slots) % 2048)).to(torch.int32).to(dev)
    ring[3] = torch.full((1, 1), p_now, dtype=torch.int32, device=dev)
    # M-RoPE as phase 14b serves qwen2-vl: 256 patches at t = 0, then 128
    # text tokens at t = 2..129; its third decode step at position 386 over
    # 392 slots, the prefill's t positions and the decoded 384..386.
    mrope = _attn_case(g, 2, 384, 384, 12, 2, 128, f32, dev)
    t = torch.cat([torch.zeros(256), torch.arange(128) + 2]).to(torch.int32)
    mrope[3], mrope[4] = t.expand(2, 384).contiguous().to(dev), t.to(dev)
    vlm_decode = _attn_case(g, 2, 1, 392, 12, 2, 128, f16, dev)
    kpos = torch.cat([t, torch.arange(384, 387, dtype=torch.int32),
                      torch.full((5,), -1, dtype=torch.int32)])
    vlm_decode[3] = torch.full((2, 1), 386, dtype=torch.int32, device=dev)
    vlm_decode[4] = kpos.to(dev)
    return [
        ("recurrentgemma prefill, D 256 MQA 10:1, window 2,048 over 2,100",
         _attn_case(g, 1, 2100, 2100, 10, 1, 256, f32, dev), True, 2048),
        ("recurrentgemma decode on a wrapped 2,048-slot fp16 ring, window 2,048", ring,
         True, 2048),
        ("qwen2-vl prefill, D 128 GQA 6:1, M-RoPE t positions (256 repeated)", mrope,
         True, -1),
        ("qwen2-moe prefill, D 128 MHA 16:16", _attn_case(g, 2, 128, 128, 16, 16, 128, f32, dev),
         True, -1),
        ("qwen2-moe decode, D 128 MHA 16:16, fp16 cache",
         _attn_case(g, 2, 1, 136, 16, 16, 128, f16, dev, invalid=6), True, -1),
        ("musicgen decode, D 64 MHA 32:32, fp16 cache",
         _attn_case(g, 2, 1, 136, 32, 32, 64, f16, dev, invalid=6), True, -1),
        ("granite decode, D 64 GQA 2:1, fp16 cache",
         _attn_case(g, 2, 1, 136, 16, 8, 64, f16, dev, invalid=6), True, -1),
        ("granite prefill, D 64 GQA 2:1", _attn_case(g, 2, 128, 128, 16, 8, 64, f32, dev),
         True, -1),
        ("musicgen prefill, D 64 MHA 32:32", _attn_case(g, 2, 128, 128, 32, 32, 64, f32, dev),
         True, -1),
        ("qwen2-vl decode, D 128 GQA 6:1, fp16 cache, M-RoPE t positions (256 repeated)",
         vlm_decode, True, -1),
    ]


def _arch_bwd_cases(g, dev) -> list:
    """Phase 14a's backward cases: the new families' training shapes."""
    mrope = _bwd_case(g, 4, 512, 12, 2, 128, dev)
    t = torch.cat([torch.zeros(256), torch.arange(256) + 2]).to(torch.int32).to(dev)
    mrope[3], mrope[4] = t.expand(4, 512).contiguous(), t
    return [
        ("recurrentgemma train, D 256 MQA 10:1", _bwd_case(g, 4, 512, 10, 1, 256, dev),
         True, -1),
        ("recurrentgemma train, D 256 MQA 10:1, window 2,048 over 2,560",
         _bwd_case(g, 1, 2560, 10, 1, 256, dev), True, 2048),
        ("qwen2-vl train, D 128 GQA 6:1, M-RoPE t positions (256 repeated)", mrope, True, -1),
        ("qwen2-moe train, D 128 MHA 16:16", _bwd_case(g, 4, 512, 16, 16, 128, dev), True, -1),
        ("musicgen train, D 64 MHA 32:32", _bwd_case(g, 4, 512, 32, 32, 64, dev), True, -1),
        ("granite train, D 64 GQA 2:1", _bwd_case(g, 4, 512, 16, 8, 64, dev), True, -1),
    ]


def _entry_row(kernel: str, rows: list, main: int, entry: str = "archs") -> dict:
    m = rows[main]
    return {"name": f"{kernel}[{entry}]", "kernel": kernel, "entry": entry,
            "shape": m["shape"], "max_abs_err": max(r["max_abs_err"] for r in rows),
            **{k: m.get(k) for k in ("ms", "device_ms", "parts_ms", "plain_ms", "bound_ms",
                                     "bound_by", "bound_tc_ms", "library_ms",
                                     "library_device_ms")},
            "cases": rows}


def _record_routes():
    """A wrapper of the transformer's ``moe_apply`` that records each call's
    routes (eids and the top-k margin: the k-th probability less the next),
    and its undo."""
    from repro_torch.models import transformer as tf

    calls, orig = [], tf.moe_apply

    def recording(p, x, cfg, act_to=None, **kw):
        from repro_torch.models.moe import route

        k = cfg.moe.top_k
        probs, eids, _ = route(p, x, cfg, act_to)
        top = probs.topk(k + 1, dim=-1).values
        calls.append({"eids": eids.cpu(), "margin": (top[..., k - 1] - top[..., k]).cpu()})
        return orig(p, x, cfg, act_to, **kw)

    tf.moe_apply = recording
    return calls, lambda: setattr(tf, "moe_apply", orig)


def _arch_steps(model, cfg, policy, batch: dict, fed: list, gen: int, cap: int, where):
    """Prefill of ``batch`` and ``gen - 1`` decode steps, each fed ``fed``'s
    token (the CPU's greedy choice; appended when ``fed`` is shorter):
    the logits of every step on the host."""
    from repro_torch.models import tasks

    prefill = tasks.make_prefill_step(cfg, policy, collect_cache=True, cache_len=cap)
    decode = tasks.make_decode_step(cfg, policy)
    b = {k: v.to(where) for k, v in batch.items()}
    s = b["positions"].shape[1] if "positions" in b else b["tokens"].shape[1]
    with torch.inference_mode():
        out, cache = prefill(model, b)
        steps = [out.float().cpu()]
        for i in range(gen - 1):
            if len(fed) <= i:
                fed.append(out.argmax(dim=-1)[:, None].cpu())
            out, cache = decode(model, cache, fed[i].to(where), s + i)
            steps.append(out.float().cpu())
    return steps


def _arch_routed_steps(model, cfg, batch, cap, gen, fed: list, where) -> tuple[list, list]:
    """``_arch_steps`` at fp16 with the MoE routes of every layer call
    recorded: (logits per step, route calls)."""
    from repro_torch.precision import get_policy

    calls, undo = _record_routes()
    try:
        steps = _arch_steps(model, cfg, get_policy("fp16"), batch, fed, gen, cap, where)
    finally:
        undo()
    return steps, calls


def _arch_card_vs_cpu(arch, cfg, cpu: dict, card_model, batch, cap, gen) -> dict:
    """Phase 14c: the same weights on the CPU (``cpu``: its logits per
    step, the greedy tokens it fed and its routes, from :func:`_arch_prep`)
    and the card, fp16, a prefill and ``gen - 1`` decode steps, the card
    fed the CPU's tokens. Under MoE the routes are compared first, per
    layer call: a batch row any of whose routes differ (a near tie an ulp
    decides) is counted, with the CPU's top-k margin there, and its logits
    are not gated; every other row's are, at the arch's tolerance."""
    card, card_routes = _arch_routed_steps(card_model, cfg, batch, cap, gen, list(cpu["fed"]),
                                           torch.device("cuda", 0))
    b = batch["tokens"].shape[0]
    flipped_rows, flips = set(), []
    for i, (c, d) in enumerate(zip(cpu["routes"], card_routes)):
        diff = (c["eids"].sort(-1).values != d["eids"].sort(-1).values).any(-1)  # [B, S]
        for row, pos in torch.nonzero(diff).tolist():
            flipped_rows.add(row)
            flips.append({"call": i, "row": row, "pos": pos,
                          "cpu_margin": float(c["margin"][row, pos])})
    keep = [r for r in range(b) if r not in flipped_rows]
    tol = ARCH_CARD_TOL.get(arch, ARCH_CARD_TOL_DEFAULT)
    errs = []
    for i, (c, d) in enumerate(zip(cpu["steps"], card)):
        errs.append(max_err(d[keep], c[keep]) if keep else 0.0)
        require(errs[-1] <= tol, f"[archs] {arch} card vs CPU step {i}: max abs logit err "
                f"{errs[-1]} > {tol} on rows {keep}")
    require(keep, f"[archs] {arch}: every row's routes flipped: {flips[:8]}")
    require(len(card_routes) == len(cpu["routes"]), f"[archs] {arch}: route calls differ")
    log(f"[archs] card vs CPU port, {arch} full width {cfg.n_layers} layers fp16: prefill + "
        f"{gen - 1} decode steps on the CPU's tokens, max abs logit err {max(errs):.3g} "
        f"(tolerance {tol}) on rows {keep}; MoE route calls {len(card_routes)}, flips "
        f"{len(flips)}: {flips[:6]}")
    return {"max_abs_err_per_step": errs, "tolerance": tol, "rows_gated": keep,
            "route_calls": len(card_routes), "route_flips": flips}


def _arch_prefill_vs_decode(arch, cfg, model, dev) -> dict:
    """Phase 14d: the reference's ``test_prefill_matches_decode`` at full
    width on the card (8 tokens; MoE at drop-free capacity, the VLM's
    text-only prompt as the other archs', its M-RoPE positions all equal)."""
    import dataclasses

    import numpy as np

    from repro_torch.models import tasks
    from repro_torch.models import transformer as tf
    from repro_torch.precision import get_policy

    policy = get_policy("fp16")
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=float(cfg.moe.n_experts)))
    if isinstance(model, tf.Transformer):
        view = tf.params_view(cfg, tf.params_tree(model))
    else:  # a params_view already: the same weights under the drop-free config
        view = copy.copy(model)
        view.cfg = cfg
    toks = torch.from_numpy(np.random.default_rng(41).integers(0, cfg.vocab_size, (1, 8)))
    toks = toks.to(dev)
    batch = {"tokens": toks}
    if cfg.frontend == "vision":
        cfg = dataclasses.replace(cfg, frontend="none")
        view.cfg = cfg
        batch["positions"] = torch.arange(8, dtype=torch.int32, device=dev)[None, :, None] \
            .expand(1, 8, 3).contiguous()
    with torch.inference_mode():
        logits_p = tasks.make_prefill_step(cfg, policy)(view, batch)
        cache = tf.init_cache(cfg, 1, 16, policy.state_storage, dev)
        step = tasks.make_decode_step(cfg, policy)
        for pos in range(8):
            logits_d, cache = step(view, cache, toks[:, pos:pos + 1], pos)
    err = max_err(logits_p, logits_d)
    require(bool(torch.isfinite(logits_d).all()) and err <= 5e-2,
            f"[archs] {arch} prefill vs decode on the card: max abs err {err}")
    return {"max_abs_err": err, "tolerance": 5e-2}


def _arch_serve(arch, cfg, model, dev, totals) -> dict:
    """Phase 14b, the main path: ``launch.serve.serve`` (the VLM through
    the step functions, which ``launch.serve`` leaves to the caller) at full
    width, launches counted: one B7 launch per attention layer and step."""
    import numpy as np

    from repro_torch.kernels import ops
    from repro_torch.launch.serve import serve
    from repro_torch.precision import get_policy

    kw = dict(ARCH_SERVE.get(arch, ARCH_SERVE_DEFAULT))
    gen = kw["gen"]
    if cfg.frontend == "vision":
        policy = get_policy("fp16")
        batch = _vlm_batch(cfg, kw["batch"], kw["prompt_len"], 43, dev)
        cap = cfg.n_patches + kw["prompt_len"] + gen

        def run():
            t0 = time.perf_counter()
            steps = _arch_steps(model, cfg, policy, batch, [], gen, cap, dev)
            torch.cuda.synchronize()
            return {"tokens": torch.stack([s.argmax(-1) for s in steps], 1).numpy(),
                    "wall_s": time.perf_counter() - t0}
    else:
        def run():
            return serve(arch, reduced=False, params=model, device=dev, **kw)

    run()  # warm-up: cuBLAS handles, the allocator
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launches()
    out = run()
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    want = {k: 0 for k in launches}
    want["flash_attention"] = _attn_layers(cfg) * gen
    require(launches == want, f"[archs] serve {arch}: launches {launches} != {want}")
    _add(totals, launches)
    toks = np.asarray(out["tokens"])
    require(toks.shape == (kw["batch"], gen) and int(toks.min()) >= 0
            and int(toks.max()) < cfg.vocab_size, f"[archs] {arch} served tokens {toks.shape}")
    res = {"batch": kw["batch"], "prompt_len": kw["prompt_len"], "gen": gen,
           "capacity": kw.get("capacity"), "launches": launches,
           "peak_device_bytes": torch.cuda.max_memory_allocated(dev)}
    if "decode_s" in out:
        res.update(prefill_ms=out["prefill_s"] * 1e3,
                   decode_ms_per_step=out["decode_s"] / (gen - 1) * 1e3,
                   decode_tok_s=out["decode_tok_s"])
    else:
        res.update(wall_ms=out["wall_s"] * 1e3)
    return res


def _arch_train(arch, cfg, dev, totals, state) -> dict:
    """Phase 14e, the main path: ``make_train_step`` (fp16) at full width on
    ``state`` (on the card), a warm-up step and a timed one at the arch's
    shape, launches counted: two B7 forwards (the block's remat) and one
    backward per attention layer and step."""
    from repro_torch.data.synthetic import TokenStream
    from repro_torch.kernels import ops
    from repro_torch.models import tasks
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.precision import get_policy

    policy = get_policy("fp16")
    b, s = ARCH_TRAIN.get(arch, ARCH_TRAIN_DEFAULT)
    torch.cuda.reset_peak_memory_stats(dev)
    step = tasks.make_train_step(cfg, policy, opt_cfg=AdamWConfig(lr=1e-4), ce_chunk=512)
    p = cfg.n_patches if cfg.frontend == "vision" else 0
    stream = TokenStream(cfg.vocab_size, s - p, b, seed=0)

    def batch(i):
        if p:
            out = _vlm_batch(cfg, b, s - p, 47 + i, dev)
            out["tokens"] = stream.batch(i)["tokens"].to(dev)
            return out
        return {"tokens": stream.batch(i)["tokens"].to(dev)}

    state, m0 = step(state, batch(0))
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    state, m1 = step(state, batch(1))
    loss = float(m1["loss"])
    ms = (time.perf_counter() - t0) * 1e3
    launches = dict(ops.LAUNCHES)
    want = {k: 0 for k in launches}
    want["flash_attention"] = 2 * _attn_layers(cfg)
    want["flash_attention_bwd"] = _attn_layers(cfg)
    require(launches == want, f"[archs] train {arch}: launches {launches} != {want}")
    _add(totals, launches)
    losses = [float(m0["loss"]), loss]
    require(all(map(math.isfinite, losses)) and float(m1["skipped"]) == 0.0
            and float(m0["skipped"]) == 0.0, f"[archs] train {arch}: {losses}, skipped "
            f"{float(m0['skipped'])}, {float(m1['skipped'])}")
    peak = torch.cuda.max_memory_allocated(dev)
    return {"layers": cfg.n_layers, "batch": b, "seq_len": s, "losses": losses,
            "ms_per_step": ms, "tokens_per_s": b * (s - p) / ms * 1e3,
            "peak_device_bytes": peak, "launches": launches}


ARCH_TRAIN_LR = 1e-3
ARCH_TRAIN_VS_CPU = ("granite-moe-1b-a400m", "falcon-mamba-7b", "recurrentgemma-2b")
ARCH_GEN_VS_CPU = 3  # card vs CPU: a prefill and 2 decode steps


def _arch_compare_step(cfg):
    """Phase 14f's train step (fp16, lr ``ARCH_TRAIN_LR``) and its 2 x 32
    tokens."""
    from repro_torch.data.synthetic import TokenStream
    from repro_torch.models import tasks
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.precision import get_policy

    step = tasks.make_train_step(cfg, get_policy("fp16"),
                                 opt_cfg=AdamWConfig(lr=ARCH_TRAIN_LR), ce_chunk=32)
    return step, TokenStream(cfg.vocab_size, 32, 2, seed=3).batch(0)["tokens"]


def _first_layers(cfg, master: dict, n: int | None):
    """``(cfg, master)`` cut to the first ``n`` layers of a homogeneous
    stack (each stacked leaf sliced); as they are for ``n`` None."""
    import dataclasses

    from repro_torch.precision.policy import tree_map

    if n is None:
        return cfg, master
    return dataclasses.replace(cfg, n_layers=n), dict(
        master, layers=tree_map(lambda x: x[:n].clone(), master["layers"]))


def _state_from_master(master: dict, dev):
    """``tasks.init_train_state``'s fp16 state of the f32 masters
    ``master``, on ``dev``: params cast to fp16, zero moments, step 0, the
    policy's loss scale."""
    from repro_torch.optim.adamw import adamw_init, scale_init
    from repro_torch.precision import get_policy
    from repro_torch.precision.policy import tree_map

    policy = get_policy("fp16")
    master = tree_map(lambda x: x.to(dev), master)
    return {"params": tree_map(lambda x: x.to(policy.param_storage), master),
            "master": master, "opt": adamw_init(master),
            "scale": scale_init(policy.loss_scale, device=dev)}


def _arch_prep(arch: str) -> dict:
    """Phase 14's CPU half for one arch: its train state drawn on the CPU
    (``tasks.init_train_state``, fp16, seed 0; its params serve), the CPU
    port's logits and routes over the card-vs-CPU prompt, and for
    ``ARCH_TRAIN_VS_CPU`` one train step there. Keeps the f32 masters (the
    card rebuilds the state from them) and what the card is held to."""
    import numpy as np

    from repro_torch.models import tasks
    from repro_torch.models import transformer as tf
    from repro_torch.precision import get_policy

    t0 = time.perf_counter()
    cfg = _arch_cfg(arch)
    state0 = tasks.init_train_state(cfg, get_policy("fp16"), seed=0, device="cpu")
    prep = {"cfg": cfg, "master": state0["master"], "seconds": {}}
    prep["seconds"]["draw"] = time.perf_counter() - t0
    if cfg.frontend == "vision":
        batch, cap = _vlm_batch(cfg, 2, 24, 53, "cpu"), cfg.n_patches + 32
    else:
        batch = {"tokens": torch.from_numpy(np.random.default_rng(53).integers(
            0, cfg.vocab_size, (2, 32)))}
        cap = 40
    t0 = time.perf_counter()
    fed: list = []
    steps, routes = _arch_routed_steps(tf.params_view(cfg, state0["params"]), cfg, batch, cap,
                                       ARCH_GEN_VS_CPU, fed, torch.device("cpu"))
    prep.update(batch=batch, cap=cap, cpu={"steps": steps, "fed": fed, "routes": routes})
    prep["seconds"]["logits"] = time.perf_counter() - t0
    if arch in ARCH_TRAIN_VS_CPU:
        t0 = time.perf_counter()
        step, toks = _arch_compare_step(cfg)
        cs, cm = step(state0, {"tokens": toks})
        prep["train_cpu"] = ({k: float(cm[k]) for k in ("loss", "grad_norm")}, cs["master"],
                             cs["opt"].m)
        prep["seconds"]["train_step"] = time.perf_counter() - t0
    return prep


def _arch_train_card_vs_cpu(arch, cfg, prep: dict, card_state) -> tuple[dict, dict]:
    """Phase 14f: one fp16 step at full width on the card from the state the
    CPU stepped (2 x 32 tokens): loss and grad norm at ``ARCH_TRAIN_TOL``,
    each leaf's first moment (``(1 - b1) g``, the gradient each leaf got)
    within ``ARCH_TRAIN_TOL["m"]`` of its scale, every new master within 2
    lr_t of the CPU's (Adam's first step moves an entry by about lr_t
    sign(g), so the masters check the gradients' signs only). Returns (the
    result, the card's new state)."""
    from repro_torch.precision.policy import tree_leaves

    step, toks = _arch_compare_step(cfg)
    cm, cpu_master, cpu_m = prep["train_cpu"]
    card_state, gm = step(card_state, {"tokens": toks.to(card_state["params"]["embed"].device)})
    rel = {k: abs(float(gm[k]) - cm[k]) / abs(cm[k]) for k in ("loss", "grad_norm")}
    m_rel = max(max_err(a.cpu(), b) / max(float(b.abs().max()), 1e-30)
                for a, b in zip(tree_leaves(card_state["opt"].m), tree_leaves(cpu_m)))
    lr_t = ARCH_TRAIN_LR * 2 / 100
    leaf_err = max(max_err(a.cpu(), b) for a, b in zip(tree_leaves(card_state["master"]),
                                                       tree_leaves(cpu_master)))
    tol = ARCH_TRAIN_TOL
    require(rel["loss"] <= tol["loss"] and rel["grad_norm"] <= tol["grad_norm"]
            and m_rel <= tol["m"] and leaf_err <= 2 * lr_t + 1e-6,
            f"[archs] train card vs CPU {arch}: {rel}, first moments {m_rel} of scale, "
            f"masters {leaf_err} (2 lr_t {2 * lr_t})")
    log(f"[archs] train card vs CPU port, {arch} full width {cfg.n_layers} layers fp16: loss "
        f"rel {rel['loss']:.3g}, grad norm rel {rel['grad_norm']:.3g}, first moments "
        f"{m_rel:.3g} of a leaf's scale, new masters max abs {leaf_err:.3g} (2 lr_t = "
        f"{2 * lr_t:.3g})")
    return {"rel": rel, "m_rel": m_rel, "master_max_abs": leaf_err,
            "tolerance": ARCH_TRAIN_TOL}, card_state


def phase_archs_prep(threads: int | None = None) -> dict:
    """Phase 14's CPU half for every arch (:func:`_arch_prep`), on
    ``threads`` CPU threads (None: as they are)."""
    prev = torch.get_num_threads()
    if threads:
        torch.set_num_threads(threads)
    try:
        return {arch: _arch_prep(arch) for arch in ARCHS_NEW}
    finally:
        torch.set_num_threads(prev)


def phase_archs(dev, totals: dict, preps: dict) -> tuple[list, dict]:
    """Phase 14's card half: (a) B7 and the attention backward on the new
    families' shapes against their plain versions; per arch at full width
    and cut depth, from :func:`phase_archs_prep`'s masters, (b) served, the
    main path, B7 launches counted, (c) card against the CPU port, (d)
    prefill against decode, (f) for granite-moe, falcon-mamba and
    recurrentgemma a train step against the CPU port's, (e) one timed train
    step with peak memory, the main path too. Returns (the two kernels'
    ``[archs]`` rows, paths)."""
    from repro_torch.configs import count_params
    from repro_torch.models import transformer as tf
    from repro_torch.precision import get_policy
    from repro_torch.precision.policy import tree_leaves, tree_map

    t_all = time.perf_counter()
    seconds = {}
    g = torch.Generator(device="cpu").manual_seed(141)
    t0 = time.perf_counter()
    attn_rows = [_attn_row(name, args, causal, window)
                 for name, args, causal, window in _arch_attn_cases(g, dev)]
    t1 = time.perf_counter()
    bwd_rows = [_bwd_row(name, args, causal, window)
                for name, args, causal, window in _arch_bwd_cases(g, dev)]
    log(f"[archs] phase 14a backward: {time.perf_counter() - t1:.1f} s, of which SDPA under "
        f"an explicit mask {sum(r['added_s'] for r in bwd_rows):.2f} s")
    seconds["kernels"] = time.perf_counter() - t0
    paths = {}
    fp16 = get_policy("fp16").param_storage
    for arch in ARCHS_NEW:
        t0 = time.perf_counter()
        prep = preps[arch]
        cfg, master = prep["cfg"], prep["master"]
        model = tf.params_view(cfg, tree_map(lambda x: x.to(dev).to(fp16), master))
        res = {"layers": cfg.n_layers, "count_params": count_params(cfg),
               "params": sum(x.numel() for x in tree_leaves(master)),
               "cpu_seconds": prep["seconds"]}
        res["serve"] = _arch_serve(arch, cfg, model, dev, totals)
        res["card_vs_cpu"] = _arch_card_vs_cpu(arch, cfg, prep["cpu"], model, prep["batch"],
                                               prep["cap"], ARCH_GEN_VS_CPU)
        res["prefill_vs_decode"] = _arch_prefill_vs_decode(arch, cfg, model, dev)
        del model
        torch.cuda.empty_cache()
        train_cfg, train_master = _first_layers(cfg, master, ARCH_TRAIN_LAYERS.get(arch))
        card_state = _state_from_master(train_master, dev)
        del train_master
        if arch in ARCH_TRAIN_VS_CPU:
            res["train_card_vs_cpu"], card_state = _arch_train_card_vs_cpu(
                arch, train_cfg, prep, card_state)
        preps[arch] = None  # the CPU's tensors are not needed again
        res["train"] = _arch_train(arch, train_cfg, dev, totals, card_state)
        del card_state
        torch.cuda.empty_cache()
        seconds[arch] = time.perf_counter() - t0
        sv, tr = res["serve"], res["train"]
        log(f"[archs] {arch} full width, {cfg.n_layers} layers ({res['params']} parameters): "
            f"serve {sv} ; train {tr['layers']} layers {tr['batch']} x {tr['seq_len']}: "
            f"{tr['ms_per_step']:.1f} ms/step, {tr['tokens_per_s']:.0f} tokens/s, peak "
            f"{tr['peak_device_bytes']} B, losses {tr['losses']}; prefill vs decode "
            f"{res['prefill_vs_decode']['max_abs_err']:.3g}; card {seconds[arch]:.1f} s, CPU "
            f"{ {k: round(v, 1) for k, v in prep['seconds'].items()} }")
        paths[f"archs/{arch}"] = res
    rows = [_entry_row("flash_attention", attn_rows, 1),
            _entry_row("flash_attention_bwd", bwd_rows, 0)]
    seconds["phase"] = time.perf_counter() - t_all
    paths["archs/phase_s"] = seconds
    log(f"[archs] phase 14 card seconds: { {k: round(v, 1) for k, v in seconds.items()} }")
    return rows, paths


# Phase 14's CPU half runs beside the build, whose two attention sources
# keep two of the machine's 8 cores busy for about 85 s after the others
# are built; the CPU port's logits depend on the thread count (sum orders).
ARCH_PREP_THREADS = 6
ARCH_PREP_TIMEOUT = 600


def _archs_main(out: str, go: str | None = None) -> int:
    """``--archs-json PATH [GO]``: phase 14 alone, its rows, paths and
    launch counts written to ``PATH`` as JSON. With ``GO``, its CPU half
    runs first on ``ARCH_PREP_THREADS`` threads (while the parent builds
    the kernels), then the file ``GO.ready`` is written, and its card half
    runs once the file ``GO`` exists: the card is touched only then."""
    t0 = time.perf_counter()
    preps = phase_archs_prep(ARCH_PREP_THREADS if go else None)
    prep_s = time.perf_counter() - t0
    log(f"[archs] phase 14 CPU half in {prep_s:.1f} s")
    if go:
        Path(f"{go}.ready").write_text("ready")
        while not Path(go).exists():
            time.sleep(0.5)
    from repro_torch.kernels import _build, ops

    _build.build()
    totals = {k: 0 for k in ops.LAUNCHES}
    rows, paths = phase_archs(torch.device("cuda", 0), totals, preps)
    paths["archs/cpu_half_s"] = prep_s
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    paths["archs/card"] = smi
    Path(out).write_text(json.dumps({"rows": rows, "paths": paths, "totals": totals},
                                    default=str))
    return 0


# -- the LM mesh (A12d) -------------------------------------------------------------------

MESH_BATCH, MESH_SEQ = 8, 512
# The meshes trained on in turn, each through a save, restore and reshard:
# (name, shape, entries of [card] * n, steps).
MESH_RUNS = (("4x2", (4, 2), 8, 3), ("1x8", (1, 8), 8, 3), ("2x2", (2, 2), 4, 2))
# Sharded against single-device, per step from the same state and batch (the
# data indices' NLL sums added in another order; each data index's gradient
# rounds to fp16 on its own rows; the model ranks' row- and vocab-parallel
# sums flip fp16 roundings of projection inputs, ROADMAP queue C slice 21):
# loss and grad norm at slice 17's card tolerances (TRAIN_CARD_TOL fp16),
# first moments within slice 17's fp16 5e-3 of a leaf's scale, new masters
# within 2 lr_t (Adam's sign-like first moves, ROADMAP queue C).
MESH_TOL = {"loss": 1e-4, "grad_norm": 1e-3, "m": 5e-3}
MESH_SERVE = dict(batch=2, prompt_len=128, gen=8)
# Sharded serving against single-device serving of each data index's rows:
# bit for bit while serving was data-parallel (held at 1e-5); the split
# prefill's row- and vocab-parallel sums flip fp16 roundings of projection
# inputs, compounding over 32 layers (3.57e-3 measured, ROADMAP queue C
# slice 21), so it is held at the full-width fp16 bound of slice 18's hybrid.
MESH_SERVE_TOL = 8e-3


def _mesh_compare(sharded, single, metrics, want, lr_t) -> dict:
    """One sharded step against the single-device step from the same state
    and batch: loss and grad norm (relative), each leaf's first moment (of
    its scale) and each new master (absolute, against 2 lr_t)."""
    from repro_torch.launch import mesh as meshlib
    from repro_torch.launch import sharded as sh
    from repro_torch.precision.policy import tree_leaves

    got = sh.gather_tree(sharded)
    rel = {k: abs(float(metrics[k]) - float(want[k])) / abs(float(want[k]))
           for k in ("loss", "grad_norm")}
    m_rel = max(max_err(a, b) / max(float(b.abs().max()), 1e-30)
                for a, b in zip(tree_leaves(got["opt"].m), tree_leaves(single["opt"].m)))
    master = max(max_err(a, b) for a, b in zip(tree_leaves(got["master"]),
                                                tree_leaves(single["master"])))
    require(rel["loss"] <= MESH_TOL["loss"] and rel["grad_norm"] <= MESH_TOL["grad_norm"],
            f"mesh step: {rel} against {MESH_TOL}")
    require(m_rel <= MESH_TOL["m"], f"mesh step: first moments {m_rel} of scale")
    require(master <= 2 * lr_t + 1e-6, f"mesh step: a new master {master} > 2 lr_t {2 * lr_t}")
    require(float(metrics["skipped"]) == 0.0 and float(want["skipped"]) == 0.0,
            "mesh step: a step was skipped")
    return {"loss": float(metrics["loss"]), "rel": rel, "m_of_scale": m_rel,
            "master_max_abs": master, "two_lr_t": 2 * lr_t}, got


def _mesh_train(dev, totals) -> dict:
    """Phase 15a: smollm-360m fp16 at full width through ``build_task`` on
    each mesh of ``MESH_RUNS`` in turn (``ckpt.save``, ``restore`` and
    ``reshard`` between); after every step the single-device step from the
    same state and batch."""
    import tempfile

    from repro_torch.checkpoint import ckpt
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core import distributed
    from repro_torch.data.synthetic import TokenStream
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh as meshlib
    from repro_torch.launch import sharded as sh
    from repro_torch.models import tasks
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.precision.policy import tree_leaves

    cfg, opt = get_arch(SMOLLM), AdamWConfig()  # build_task's
    shape = ShapeConfig("mesh", MESH_SEQ, MESH_BATCH, "train")
    task = {name: tasks.build_task(cfg, shape, meshlib.make_host_mesh(s, devices=[dev] * n),
                                   "fp16") for name, s, n, _ in MESH_RUNS}
    require(all(t.model_compute == "megatron" for t in task.values()),
            "smollm-360m is not split over the model axis")
    single = tasks.make_train_step(cfg, "fp16", opt_cfg=opt, ce_chunk=512)
    stream = TokenStream(cfg.vocab_size, MESH_SEQ, MESH_BATCH, seed=0)
    t0 = time.perf_counter()
    state = tasks.init_train_state(cfg, "fp16", seed=0, device=dev)
    init_s = time.perf_counter() - t0
    steps, launches, colls, times, single_times, save_s = [], [], [], [], [], []
    i = 0
    for k, (name, mshape, n, n_steps) in enumerate(MESH_RUNS):
        if k:
            t0 = time.perf_counter()
            with tempfile.TemporaryDirectory() as d:
                ckpt.save(d, i, state)
                like = _meta_to(tasks.train_state_specs(cfg, "fp16"), dev)
                restored = ckpt.restore(d, i, like)
            state = ckpt.reshard(restored, task[name].in_shardings[0])
            save_s.append(time.perf_counter() - t0)
            require(all(x.mesh.size == n for x in tree_leaves(state)),
                    "reshard left another mesh")
        plan = meshlib.compute_plan(cfg, mshape[1])
        computing = mshape[0] * sum(pl.n_heads > 0 for pl in plan)
        for _ in range(n_steps):
            batch = {"tokens": stream.batch(i)["tokens"].to(dev)}
            whole = sh.gather_tree(state) if i else state
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            want_state, want = single(whole, batch)
            float(want["loss"])
            single_times.append(time.perf_counter() - t0)
            del whole
            ops.reset_launches()
            distributed.reset_collectives()
            t0 = time.perf_counter()
            state, metrics = task[name].sharded()(state, batch)
            float(metrics["loss"])
            times.append(time.perf_counter() - t0)
            launches.append(dict(ops.LAUNCHES))
            colls.append({k: dict(v) for k, v in distributed.COLLECTIVES.items()})
            _add(totals, ops.LAUNCHES)
            expect = {"flash_attention": 2 * cfg.n_layers * computing,
                      "flash_attention_bwd": cfg.n_layers * computing}
            got = {k: v for k, v in ops.LAUNCHES.items() if v}
            require(got == expect, f"mesh step {i} on {name}: launches {got} != {expect}")
            lr_t = opt.lr * min(1.0, (i + 2) / opt.warmup_steps)  # the warm-up at step i + 1
            row, _ = _mesh_compare(state, want_state, metrics, want, lr_t)
            steps.append({"step": i, "mesh": name, "entries": n, **row})
            del want_state
            log(f"[mesh] step {i} on {name} ({n} entries, {computing} computing): loss "
                f"{row['loss']:.5f}, rel {row['rel']}, first moments {row['m_of_scale']:.3g} "
                f"of scale, masters {row['master_max_abs']:.3g} (2 lr_t {2 * lr_t:.3g}); "
                f"launches {got}; collective bytes per device {colls[-1]}; "
                f"{times[-1] * 1e3:.1f} ms (single-device {single_times[-1] * 1e3:.1f} ms)")
            i += 1
    log(f"[mesh] init {init_s:.1f} s, save + restore + reshard {[round(x, 1) for x in save_s]} s")
    params = sh.gather_tree(state["params"])
    return {"steps": steps, "launches": launches, "collectives": colls,
            "ms_per_step": [t * 1e3 for t in times],
            "single_ms_per_step": [t * 1e3 for t in single_times], "init_s": init_s,
            "save_restore_reshard_s": save_s}, params


# The split lowering of the other layer kinds (A12e part 2): each arch fp16
# at full width on one card's meshes, one step each from a state drawn on
# the card (the single-device step from the same state and batch beside
# it), then the split prefill of the recurrent archs against single-device
# prefill: (arch, layers, mesh, batch, seq). granite-moe's 32 experts split
# EP on 2x2 (32 % 2 = 0) and TP on 1x3 (32 % 3 != 0); falcon-mamba's d_inner
# 8,192 by channel; recurrentgemma one period (two RG-LRU layers and one
# local-attention layer) over its 2,048 window. qwen2-moe's 2-layer step
# alone needs about 60 GB: its TP and shared experts are the CPU tests'.
MESH_LAYER_RUNS = (("granite-moe-1b-a400m", 2, (2, 2), 4, 512),
                   ("granite-moe-1b-a400m", 2, (1, 3), 4, 512),
                   ("falcon-mamba-7b", 2, (2, 2), 4, 512),
                   ("recurrentgemma-2b", 3, (2, 2), 2, 2560))
MESH_LAYER_PREFILL = dict(batch=2, prompt_len=128, gen=8)


def _card_state(cfg, dev, seed: int) -> dict:
    """``tasks.init_train_state``'s fp16 state of ``cfg``, drawn on the card
    from a CUDA generator seeded with ``seed`` (the same modules, shapes and
    scales; another stream of draws than the CPU generator's, a few seconds
    faster per billion weights)."""
    from repro_torch.models import transformer as tf
    from repro_torch.precision import get_policy

    gen = torch.Generator(device=dev).manual_seed(seed)
    with torch.device(dev):
        model = tf.Transformer(cfg, get_policy("fp32"), gen)
    return _state_from_master(tf.params_tree(model), dev)


def _mesh_split_launches(cfg, mshape, steps: int) -> dict:
    """B7 and ``flash_attn_bwd`` launches of a split train step (``steps``
    2: the forward and remat's recompute) or prefill (1): per attention
    layer and data index, one per model rank holding a query head."""
    from repro_torch.launch import mesh as meshlib

    ranks = sum(pl.n_heads > 0 for pl in meshlib.compute_plan(cfg, mshape[1]))
    n = _attn_layers(cfg) * mshape[0] * ranks
    out = {"flash_attention": steps * n}
    if steps == 2:
        out["flash_attention_bwd"] = n
    return {k: v for k, v in out.items() if v}


def _mesh_train_layers(dev, totals) -> tuple[dict, dict]:
    """Phase 15b: each run of ``MESH_LAYER_RUNS`` through ``build_task``
    (split over the model axis) on ``[card] * n``: one step against the
    single-device step from the same state and batch at ``MESH_TOL``,
    launches counted. Returns the paths and each arch's params (their
    split prefill's and decode's)."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core import distributed
    from repro_torch.data.synthetic import TokenStream
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh as meshlib
    from repro_torch.models import tasks
    from repro_torch.optim.adamw import AdamWConfig

    opt = AdamWConfig()  # build_task's
    out, params, states = {}, {}, {}
    for arch, layers, mshape, b, s in MESH_LAYER_RUNS:
        cfg = _arch_cfg(arch, layers)
        name = f"{arch} {mshape[0]}x{mshape[1]}"
        t0 = time.perf_counter()
        if arch not in states:
            states = {arch: _card_state(cfg, dev, seed=0)}  # one arch's state at a time
            torch.cuda.synchronize()
        state = states[arch]
        draw_s = time.perf_counter() - t0
        n = mshape[0] * mshape[1]
        mesh = meshlib.make_host_mesh(mshape, devices=[dev] * n)
        task = tasks.build_task(cfg, ShapeConfig("mesh", s, b, "train"), mesh, "fp16")
        require(task.model_compute == "megatron", f"{name}: not split over the model axis")
        single = tasks.make_train_step(cfg, "fp16", opt_cfg=opt, ce_chunk=512)
        batch = {"tokens": TokenStream(cfg.vocab_size, s, b, seed=0).batch(0)["tokens"].to(dev)}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want_state, want = single(state, batch)
        float(want["loss"])
        single_ms = (time.perf_counter() - t0) * 1e3
        ops.reset_launches()
        distributed.reset_collectives()
        t0 = time.perf_counter()
        got_state, metrics = task.sharded()(state, batch)
        float(metrics["loss"])
        ms = (time.perf_counter() - t0) * 1e3
        got = {k: v for k, v in ops.LAUNCHES.items() if v}
        colls = {k: dict(v) for k, v in distributed.COLLECTIVES.items()}
        _add(totals, ops.LAUNCHES)
        expect = _mesh_split_launches(cfg, mshape, 2)
        require(got == expect, f"{name} split step: launches {got} != {expect}")
        lr_t = opt.lr * 2 / opt.warmup_steps  # the warm-up at step 1
        row, _ = _mesh_compare(got_state, want_state, metrics, want, lr_t)
        ep = meshlib.expert_parallel(cfg, mshape[1]) if cfg.moe is not None else None
        require(("all-to-all" in colls) == bool(ep), f"{name}: collectives {sorted(colls)}")
        del want_state, got_state
        out[name] = {"layers": cfg.n_layers, "batch": b, "seq_len": s, "entries": n,
                     "experts": {True: "EP", False: "TP", None: None}[ep], **row,
                     "launches": got, "collectives": colls, "ms_per_step": ms,
                     "single_ms_per_step": single_ms, "draw_s": draw_s}
        log(f"[mesh] {name} ({cfg.n_layers} layers, {b} x {s}, split"
            f"{'' if ep is None else ', experts ' + out[name]['experts']}): loss "
            f"{row['loss']:.5f}, rel {row['rel']}, first moments {row['m_of_scale']:.3g} of "
            f"scale, masters {row['master_max_abs']:.3g} (2 lr_t {2 * lr_t:.3g}); launches "
            f"{got}; collective bytes per device {colls}; {ms:.1f} ms (single-device "
            f"{single_ms:.1f} ms; state drawn in {draw_s:.1f} s)")
        params[arch] = (cfg, state["params"])  # the split prefill's and decode's
        torch.cuda.empty_cache()
    return out, params


def _mesh_prefill_layers(dev, params: dict, totals) -> dict:
    """Phase 15c: the split prefill (``collect_cache``) of the recurrent
    archs on 2x2 of ``[card] * 4`` against single-device prefill of the same
    params and prompts at ``MESH_SERVE_TOL``: the logits, and the decode
    cache (Mamba's ``conv``/``ssm``, the RG-LRU's ``h``/``conv`` assembled
    from the ranks' channels; the hybrid's KV heads)."""
    from repro_torch.core import distributed
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh as meshlib
    from repro_torch.launch import sharded as sh
    from repro_torch.models import tasks
    from repro_torch.models import transformer as tf
    from repro_torch.precision import get_policy
    from repro_torch.precision.policy import tree_leaves

    pol = get_policy("fp16")
    b, s = MESH_LAYER_PREFILL["batch"], MESH_LAYER_PREFILL["prompt_len"]
    cap = s + MESH_LAYER_PREFILL["gen"]
    mesh = meshlib.make_host_mesh((2, 2), devices=[dev] * 4)
    out = {}
    for arch, (cfg, p) in params.items():
        if arch not in ("falcon-mamba-7b", "recurrentgemma-2b"):
            continue
        g = torch.Generator().manual_seed(7)
        toks = torch.randint(0, cfg.vocab_size, (b, s), generator=g).to(dev)
        with torch.inference_mode():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, cache = tasks.make_prefill_step(cfg, pol, collect_cache=True, cache_len=cap)(
                tf.params_view(cfg, p), {"tokens": toks})
            torch.cuda.synchronize()
            single_ms = (time.perf_counter() - t0) * 1e3
            ops.reset_launches()
            distributed.reset_collectives()
            t0 = time.perf_counter()
            s_logits, s_cache = tasks.make_prefill_step(cfg, pol, mesh=mesh, collect_cache=True,
                                                        cache_len=cap)(p, {"tokens": toks})
            got_logits, got_cache = sh.gather(s_logits), sh.gather_tree(s_cache)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
        launches = {k: v for k, v in ops.LAUNCHES.items() if v}
        _add(totals, ops.LAUNCHES)
        expect = _mesh_split_launches(cfg, (2, 2), 1)
        require(launches == expect, f"{arch} split prefill: launches {launches} != {expect}")
        colls = {k: dict(v) for k, v in distributed.COLLECTIVES.items()}
        err = {"logits": max_err(got_logits, logits)}
        for (keys, a), w in zip(meshlib.key_paths(got_cache), tree_leaves(cache)):
            if keys[-1] != "pos":
                key = keys[-1] if keys[-1] in ("k", "v") else "/".join(keys[-2:])
                err[key] = max(err.get(key, 0.0), max_err(a, w))
        require(max(err.values()) <= MESH_SERVE_TOL,
                f"{arch} split prefill: {err} against {MESH_SERVE_TOL}")
        out[arch] = {"max_abs": err, "launches": launches, "collectives": colls, "ms": ms,
                     "single_ms": single_ms}
        log(f"[mesh] {arch} split prefill on 2x2 ({b} x {s}, cache {cap}): max abs from "
            f"single-device prefill {err}; launches {launches}; collective bytes per device "
            f"{colls}; {ms:.1f} ms (single-device {single_ms:.1f} ms)")
    return out


def _meta_to(tree, dev):
    """A meta tree's leaves as empty tensors on ``dev`` (a restore target)."""
    from repro_torch.precision.policy import tree_map

    return tree_map(lambda x: torch.empty(x.shape, dtype=x.dtype, device=dev), tree)


def _mesh_serve(dev, params, totals) -> dict:
    """Phase 15c: smollm-360m fp16 (the trained params) served on a 2x2
    mesh of ``[card] * 4`` through ``build_task`` (the prefill cell, split
    over the model axis; the cache from the split prefill; 8 split decode
    steps through the decode cell, B7 launches counted), each KV layout,
    against single-device serving on the card of each data index's rows
    (held at ``MESH_SERVE_TOL``) and of the whole batch (printed: a row
    split changes cuBLAS's shapes, and at full width an fp16 ulp of a
    projection input moves a logit by up to about 4e-3, ROADMAP queue C
    slice 4)."""
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh as meshlib
    from repro_torch.launch import sharded as sh
    from repro_torch.models import tasks
    from repro_torch.models import transformer as tf
    from repro_torch.precision import get_policy

    cfg, pol = get_arch(SMOLLM), get_policy("fp16")
    b, s, gen = MESH_SERVE["batch"], MESH_SERVE["prompt_len"], MESH_SERVE["gen"]
    cap = s + gen
    model = tf.params_view(cfg, params)
    mesh = meshlib.make_host_mesh((2, 2), devices=[dev] * 4)
    g = torch.Generator().manual_seed(5)
    toks = torch.randint(0, cfg.vocab_size, (b, s), generator=g).to(dev)
    prefill1 = tasks.make_prefill_step(cfg, pol)
    prefill = tasks.make_prefill_step(cfg, pol, collect_cache=True, cache_len=cap)
    step1 = tasks.make_decode_step(cfg, pol)

    def single(rows, feed=None):
        """Single-device serving of ``rows``: per step the logits, and the
        greedy tokens fed back (``feed``'s, when given)."""
        logits, cache = prefill(model, {"tokens": toks[rows]})
        out = [prefill1(model, {"tokens": toks[rows]})]
        token = torch.argmax(logits, -1)[:, None]
        tokens = []
        for i in range(gen):
            token = token if feed is None else feed[i]
            tokens.append(token)
            logits, cache = step1(model, cache, token, s + i)
            out.append(logits)
            token = torch.argmax(logits, -1)[:, None]
        return out, tokens

    out = {}
    with torch.inference_mode():
        per_row = [single(slice(r, r + 1)) for r in range(b)]
        want = [torch.cat([r[0][i] for r in per_row]) for i in range(gen + 1)]
        feed = [torch.cat([r[1][i] for r in per_row]) for i in range(gen)]
        whole, _ = single(slice(0, b), feed)
        for layout in ("headdim", "seq"):
            meshlib.KV_CACHE_LAYOUT[0] = layout
            try:
                pre = tasks.build_task(cfg, ShapeConfig("p", s, b, "prefill"), mesh,
                                       pol).sharded()
                dec = tasks.build_task(cfg, ShapeConfig("d", cap, b, "decode"), mesh,
                                       pol).sharded()
                got = [sh.gather(pre(params, {"tokens": toks}))]
                _, s_cache = tasks.make_prefill_step(cfg, pol, mesh=mesh, collect_cache=True,
                                                     cache_len=cap)(params, {"tokens": toks})
                expect = _mesh_decode_launches(cfg, mesh, b)
                step_ms = []
                for i in range(gen):
                    ops.reset_launches()
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    s_logits, s_cache = dec(params, s_cache, feed[i], s + i)
                    got.append(sh.gather(s_logits))
                    torch.cuda.synchronize()
                    step_ms.append((time.perf_counter() - t0) * 1e3)
                    launches = {k: v for k, v in ops.LAUNCHES.items() if v}
                    require(launches == expect, f"mesh serve {layout}: split decode step {i} "
                            f"launches {launches} != {expect}")
                    _add(totals, ops.LAUNCHES)
            finally:
                meshlib.KV_CACHE_LAYOUT[0] = "headdim"
            rows = max(max_err(a, w) for a, w in zip(got, want))
            batch = max(max_err(a, w) for a, w in zip(got, whole))
            require(rows <= MESH_SERVE_TOL, f"mesh serve {layout}: logits {rows} from "
                    f"single-device serving of the same rows > {MESH_SERVE_TOL}")
            out[layout] = {"logits_max_abs_rows": rows, "bitwise_rows": rows == 0.0,
                           "logits_max_abs_batch": batch, "decode_ms_per_step": step_ms,
                           "decode_launches_per_step": expect}
            log(f"[mesh] served on 2x2 ({layout}): split prefill and {gen} split decode "
                f"steps ({[round(x, 1) for x in step_ms]} ms, {expect} a step), logits within "
                f"{rows:.3g} of single-device serving of each data index's rows (bit for bit: "
                f"{rows == 0.0}), {batch:.3g} of the whole batch's")
    return out


# Split decode at full width (A12e part 3): each run fp16 through the split
# prefill of a prompt and MESH_DECODE_STEPS decode steps of ``build_task``'s
# decode cell, against single-device decode on the card from the same cache:
# (arch, layers, mesh, batch, prompt, cache slots). smollm-360m (phase 15a's
# trained params) on 1x8 reads its 5 KV heads from 8 ranks of 1-2 query
# heads; granite-moe's experts EP on 2x2 and TP on 1x3; falcon-mamba by
# channel; recurrentgemma over its 2,048-slot ring after a 2,100-token
# prompt, each rank 5 query heads of its one KV head (phase 15b's params);
# qwen2.5-14b (2 layers, params drawn on the card) on 1x9, where ranks 5
# and 7 read two KV heads each by runs of 1 + 3 and 3 + 1 query heads: one
# B7 launch per run, 11 a layer.
MESH_DECODE_RUNS = (("smollm-360m", None, (1, 8), 2, 128, 136),
                    ("qwen2.5-14b", 2, (1, 9), 2, 128, 136),
                    ("granite-moe-1b-a400m", 2, (2, 2), 2, 128, 136),
                    ("granite-moe-1b-a400m", 2, (1, 3), 2, 128, 136),
                    ("falcon-mamba-7b", 2, (2, 2), 2, 128, 136),
                    ("recurrentgemma-2b", 3, (2, 2), 2, 2100, 2048))
MESH_DECODE_STEPS = 4


def _decode_group_run(cfg, mesh):
    """The first data index's ``GroupRun`` of a decode step (each rank's
    attention runs) and the compute plan."""
    from repro_torch.launch import mesh as meshlib
    from repro_torch.models import tasks

    plan = meshlib.compute_plan(cfg, meshlib.model_size(mesh))
    return tasks._group_run(cfg, mesh, tasks._groups(mesh)[0], plan, 1, False, None), plan


def _mesh_decode_launches(cfg, mesh, b: int) -> dict:
    """B7 launches of a split decode step: per attention layer and
    computing data index, one per rank holding a query head, or one per run
    where its heads split unevenly over its KV heads."""
    from repro_torch.models import tasks

    run, plan = _decode_group_run(cfg, mesh)
    per = sum(1 if r is None else len(r) for r, pl in zip(run.kv_runs, plan) if pl.n_heads)
    n = _attn_layers(cfg) * tasks._split(b, mesh) * per
    return {"flash_attention": n} if n else {}


def _rank_paths(cfg, mesh, b: int, cap: int, dev) -> list:
    """B7's path for each launch of a rank (``kernels/flash_attn.plan``):
    its rows, cache slots, query and KV heads per launch."""
    from repro_torch.kernels import flash_attn as fa
    from repro_torch.models import tasks

    if not _attn_layers(cfg):
        return ["no attention layer"]
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    run, plan = _decode_group_run(cfg, mesh)
    bd = b // tasks._split(b, mesh)
    slots = min(cap, cfg.hybrid.window) if cfg.hybrid is not None else cap
    out = []
    for pl, runs in zip(plan, run.kv_runs):
        if not pl.n_heads:
            out.append(f"rank {pl.rank}: no head")
            continue
        calls = [(pl.n_heads, pl.n_kv)] if runs is None else [(hi - lo, 1) for lo, hi, _ in runs]
        paths = []
        for hq, hkv in calls:
            splits, kps = fa.plan(bd, 1, slots, hq, hkv, cfg.head_dim, n_sm)
            paths.append(f"{hq}q/{hkv}kv " + (f"decode {splits} x {kps} keys" if splits
                                                else "prefill"))
        out.append(f"rank {pl.rank}: " + ", ".join(paths))
    return out


def _mesh_decode(dev, cfg, p, mshape, b: int, s: int, cap: int, totals) -> dict:
    """Phase 15f, one run: the split prefill of ``b`` random prompts of
    ``s`` tokens into ``cap`` slots on ``[card] * n``, then
    ``MESH_DECODE_STEPS`` decode steps through ``build_task``'s decode cell
    (split over the model axis, the cache updated in place) against
    single-device decode from the same cache, fed the single-device greedy
    tokens: each step's logits and the final cache within
    ``MESH_SERVE_TOL``, the B7 launches of each step, its ms beside the
    single-device step's, the collective bytes per device by kind."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core import distributed
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh as meshlib
    from repro_torch.launch import sharded as sh
    from repro_torch.models import tasks
    from repro_torch.models import transformer as tf
    from repro_torch.precision import get_policy
    from repro_torch.precision.policy import tree_leaves

    pol = get_policy("fp16")
    n = mshape[0] * mshape[1]
    mesh = meshlib.make_host_mesh(mshape, devices=[dev] * n)
    g = torch.Generator().manual_seed(11)
    toks = torch.randint(0, cfg.vocab_size, (b, s), generator=g).to(dev)
    model = tf.params_view(cfg, p)
    task = tasks.build_task(cfg, ShapeConfig("d", cap, b, "decode"), mesh, pol)
    require(task.model_compute == "megatron", f"{cfg.name}: decode not split over `model`")
    split, one = task.sharded(), tasks.make_decode_step(cfg, pol)
    expect = _mesh_decode_launches(cfg, mesh, b)
    steps = []
    with torch.inference_mode():
        logits, s_cache = tasks.make_prefill_step(cfg, pol, mesh=mesh, collect_cache=True,
                                                  cache_len=cap)(p, {"tokens": toks})
        cache = sh.gather_tree(s_cache)  # single-device decode starts from the same cache
        blocks = [[t.data_ptr() for t in x.blocks.flat] for x in tree_leaves(s_cache)]
        token = torch.argmax(sh.gather(logits), -1)[:, None]
        for i in range(MESH_DECODE_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            want, cache = one(model, cache, token, s + i)
            torch.cuda.synchronize()
            single_ms = (time.perf_counter() - t0) * 1e3
            ops.reset_launches()
            distributed.reset_collectives()
            t0 = time.perf_counter()
            got, s_cache = split(p, s_cache, token, s + i)
            got = sh.gather(got)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            launches = {k: v for k, v in ops.LAUNCHES.items() if v}
            _add(totals, ops.LAUNCHES)
            require(launches == expect, f"{cfg.name} {mshape}: split decode step {i} launches "
                    f"{launches} != {expect}")
            err = max_err(got, want)
            require(err <= MESH_SERVE_TOL, f"{cfg.name} {mshape}: split decode step {i} logits "
                    f"{err} from single-device decode > {MESH_SERVE_TOL}")
            steps.append({"ms": ms, "single_ms": single_ms, "logits_max_abs": err,
                          "launches": launches, "collectives": {
                              k: dict(v) for k, v in distributed.COLLECTIVES.items()}})
            token = torch.argmax(want, -1)[:, None]
        require([[t.data_ptr() for t in x.blocks.flat] for x in tree_leaves(s_cache)] == blocks,
                f"{cfg.name} {mshape}: the decode cache moved (not updated in place)")
        specs = tree_leaves(meshlib.tree_pspecs(cache, mesh, rule=meshlib.cache_pspec))
        require([x.spec for x in tree_leaves(s_cache)] == specs,
                f"{cfg.name} {mshape}: the cache's specs are not cache_pspec's")
        cache_err = {}
        for (keys, a), w in zip(meshlib.key_paths(sh.gather_tree(s_cache)), tree_leaves(cache)):
            if keys[-1] == "pos":
                require(torch.equal(a, w), f"{cfg.name} {mshape}: slot positions differ")
            else:
                key = keys[-1] if keys[-1] in ("k", "v") else "/".join(keys[-2:])
                cache_err[key] = max(cache_err.get(key, 0.0), max_err(a, w))
        require(max(cache_err.values()) <= MESH_SERVE_TOL,
                f"{cfg.name} {mshape}: split decode cache {cache_err} > {MESH_SERVE_TOL}")
    paths = _rank_paths(cfg, mesh, b, cap, dev)
    last = steps[-1]
    log(f"[mesh] {cfg.name} ({cfg.n_layers} layers) split decode on {mshape[0]}x{mshape[1]} "
        f"({b} x {s}, {cap} slots): logits within {max(x['logits_max_abs'] for x in steps):.3g}"
        f", cache {cache_err} of single-device decode; {expect} a step; ms a step "
        f"{[round(x['ms'], 1) for x in steps]} (single-device "
        f"{[round(x['single_ms'], 1) for x in steps]}); collective bytes per device a step "
        f"{last['collectives']}; B7 per rank {paths}")
    return {"layers": cfg.n_layers, "batch": b, "prompt": s, "slots": cap, "entries": n,
            "steps": steps, "cache_max_abs": cache_err, "b7_paths": paths}


def _card_params(cfg, dev, seed: int) -> dict:
    """``cfg``'s fp16 parameter tree drawn on the card from a CUDA generator
    seeded with ``seed`` (as :func:`_card_state`, without the train
    state)."""
    from repro_torch.models import transformer as tf
    from repro_torch.precision import get_policy

    gen = torch.Generator(device=dev).manual_seed(seed)
    with torch.device(dev):
        return tf.params_tree(tf.Transformer(cfg, get_policy("fp16"), gen))


def _mesh_decode_runs(dev, smollm, layer_params: dict, totals) -> dict:
    """Phase 15f: every run of ``MESH_DECODE_RUNS``."""
    out = {}
    for arch, layers, mshape, b, s, cap in MESH_DECODE_RUNS:
        if arch == SMOLLM:
            cfg, p = smollm
        elif arch in layer_params:
            cfg, p = layer_params[arch]
        else:
            cfg = _arch_cfg(arch, layers)
            p = _card_params(cfg, dev, seed=0)
        out[f"{arch} {mshape[0]}x{mshape[1]}"] = _mesh_decode(dev, cfg, p, mshape, b, s, cap,
                                                              totals)
        del p
        torch.cuda.empty_cache()
    return out


def _mesh_decode_kernels(dev) -> list:
    """Phase 15f's B7 cases: the ranks' decode shapes, each against its plain
    version and timed beside SDPA (``_attn_row``): smollm's on 2x2 (9 query
    heads on 3 KV heads, one row) and on 1x8 (2 on 1, two rows),
    granite-moe's on 2x2 (8 on 4) and 1x3 (6 on 3), qwen2.5's run of 3
    query heads on one KV head (1x9), recurrentgemma's on 2x2 (5 on its one
    KV head, D 256, over the wrapped 2,048-slot ring: the decode path,
    where the whole group's 10 passes the decode CTA)."""
    f16 = torch.float16
    g = torch.Generator(device="cpu").manual_seed(151)
    p_now = 2103
    ring = _attn_case(g, 1, 1, 2048, 5, 1, 256, f16, dev)
    slots = torch.arange(2048)
    ring[4] = (p_now - ((p_now - slots) % 2048)).to(torch.int32).to(dev)
    ring[3] = torch.full((1, 1), p_now, dtype=torch.int32, device=dev)
    cases = [
        ("recurrentgemma rank decode on 2x2, D 256 MQA 5:1, wrapped 2,048-slot fp16 ring, "
         "window 2,048", ring, True, 2048),
        ("smollm rank decode on 2x2, D 64 GQA 9:3, fp16 cache",
         _attn_case(g, 1, 1, 136, 9, 3, 64, f16, dev, invalid=4), True, -1),
        ("smollm rank decode on 1x8, D 64 2:1, fp16 cache",
         _attn_case(g, 2, 1, 136, 2, 1, 64, f16, dev, invalid=4), True, -1),
        ("granite rank decode on 2x2, D 64 GQA 8:4, fp16 cache",
         _attn_case(g, 1, 1, 136, 8, 4, 64, f16, dev, invalid=4), True, -1),
        ("granite rank decode on 1x3, D 64 GQA 6:3, fp16 cache",
         _attn_case(g, 2, 1, 136, 6, 3, 64, f16, dev, invalid=4), True, -1),
        ("qwen2.5 rank 5's second run on 1x9, D 128 3:1, fp16 cache",
         _attn_case(g, 2, 1, 136, 3, 1, 128, f16, dev, invalid=4), True, -1),
    ]
    rows = [_attn_row(name, args, causal, window) for name, args, causal, window in cases]
    return [_entry_row("flash_attention", rows, 0, "mesh")]


def _mesh_psum(dev) -> dict:
    """Phase 15d: ``psum_compressed`` over ``[card] * 4`` (None, bf16,
    int8) against the exact mean, within the reference test's bounds."""
    from repro_torch.launch import mesh as meshlib
    from repro_torch.launch import sharded as sh
    from repro_torch.optim.compress import psum_compressed

    mesh = meshlib.make_host_mesh((4,), ("pod",), devices=[dev] * 4)
    g = torch.Generator().manual_seed(0)
    x = torch.randn((4, 1 << 20), generator=g)
    exact = (x[0].double() + x[1] + x[2] + x[3]) / 4
    out = {}
    for method, bound_ in ((None, 1e-6), ("bf16", 0.02), ("int8", 0.05)):
        got = psum_compressed([x[i].to(dev) for i in range(4)], mesh, "pod", method)
        err = max(float((r.double().cpu() - exact).abs().max()) for r in got)
        scale = float(exact.abs().max())
        require(err < bound_ * scale, f"psum_compressed {method}: {err} >= {bound_} of {scale}")
        out[str(method)] = {"max_abs": err, "of_scale": err / scale}
    log(f"[mesh] psum_compressed on [card] * 4: {out}")
    return out


DRYRUN_ENV = "CHIP_SMOKE_DRYRUN"  # where the whole script's dry-run child writes its record


MESH_DRYRUN_SHAPES = ("train_4k", "decode_32k")  # smollm-360m's cells, a process each


def _mesh_dryrun_start(tmp: Path) -> list:
    """Phase 15e: the meta dry-runs of smollm train_4k and decode_32k on the
    16x16 production mesh, each in a process of its own (CPU only): started
    beside the build when the whole script runs, after the card work
    alone."""
    return [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", SMOLLM, "--shape", shape,
         "--mesh", "single", "--out", str(tmp), "--force"],
        env={**__import__("os").environ, "PYTHONPATH": str(ROOT / "src")},
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for shape in MESH_DRYRUN_SHAPES]


def _mesh_dryrun_wait(procs: list, timeout: float) -> None:
    end = time.perf_counter() + timeout
    for proc in procs:
        text, _ = proc.communicate(timeout=max(1.0, end - time.perf_counter()))
        require(proc.returncode == 0, f"the dry-run failed: {text[-2000:]}")


def _mesh_dryrun_finish(procs, tmp: Path) -> dict:
    """The dry-runs' records; each cell's per-device argument bytes held
    against the plan's (each leaf's bytes over the entries its spec divides
    it into: the train state and batch, or the params, cache and token)."""
    import math as _math

    from repro_torch.configs import get_arch, get_shape
    from repro_torch.launch import mesh as meshlib
    from repro_torch.models import tasks
    from repro_torch.models import transformer as tf
    from repro_torch.precision import get_policy
    from repro_torch.precision.policy import tree_leaves

    if procs is not None:
        _mesh_dryrun_wait(procs, 900)
    cfg, mesh = get_arch(SMOLLM), meshlib.make_production_mesh()
    out = {}
    for name in MESH_DRYRUN_SHAPES:
        rec = json.loads((tmp / f"{SMOLLM}__{name}__single.json").read_text())
        require(rec["status"] == "ok", f"dry-run cell {name}: {rec.get('error')}")
        shape = get_shape(name)
        batch = tasks.input_specs(cfg, shape)
        if shape.kind == "train":
            state = tasks.train_state_specs(cfg, "fp16")
            trees = ((state, tasks._state_pspecs(state, mesh)),
                     (batch, meshlib.batch_pspecs(batch, mesh)))
        else:  # the decode position is a host int and holds nothing
            pol = get_policy("fp16")
            params = tf.params_tree(tf.init_params(cfg, pol, device="meta"))
            cache = tf.init_cache(cfg, shape.global_batch, shape.seq_len, pol.state_storage,
                                  "meta")
            token = {"token": batch["token"]}
            trees = ((params, meshlib.tree_pspecs(params, mesh)),
                     (cache, meshlib.tree_pspecs(cache, mesh, rule=meshlib.cache_pspec)),
                     (token, meshlib.batch_pspecs(token, mesh)))
        plan = 0
        for tree, specs in trees:
            for x, spec in zip(tree_leaves(tree), tree_leaves(specs)):
                n = _math.prod(mesh.shape[a] for part in spec for a in meshlib.part_axes(part))
                plan += x.numel() // n * x.element_size()
        prod = rec["production"]
        got = prod["memory"]["argument_bytes"]
        require(got == plan, f"dry-run {name} argument bytes {got} != the plan's {plan}")
        log(f"[mesh] dry-run {SMOLLM} {name} on 16x16 (meta, {rec['model_compute']}): argument "
            f"bytes {got} == the plan's; gathered {prod['gathered_bytes']} B, working "
            f"{rec['working_bytes']} B, {prod['flops']:.4g} FLOPs per compute device, saved "
            f"activations {prod['memory']['activation_bytes']} B, collectives "
            f"{prod['collectives']}, counted in {prod['count_s']:.1f} s")
        out[name] = {"argument_bytes": got, "plan_bytes": plan, "working_bytes":
                     rec["working_bytes"], "record": prod}
    return out


def phase_mesh(dev, totals: dict) -> tuple[list, dict]:
    """Phase 15: the LM mesh lowering on one card: the split training on
    [card] * 8 and [card] * 4 with the reshards between, serving on
    [card] * 4 (split prefill and decode), the split training and prefill
    of the MoE, Mamba and RG-LRU archs on [card] * 4 and [card] * 3, the
    split decode of smollm on [card] * 8 and of the other layer kinds
    (the main path: their launches are counted), B7 at the ranks' decode
    shapes, the compressed all-reduce, and the meta dry-runs of two
    production cells (run beside the card work). Returns (B7's ``[mesh]``
    row, paths)."""
    from repro_torch.configs import get_arch

    t0 = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    train, params = _mesh_train(dev, totals)
    paths = {"mesh/card": smi, "mesh/train": train}
    t1 = time.perf_counter()
    paths["mesh/serve"] = _mesh_serve(dev, params, totals)
    paths["mesh/serve_s"] = time.perf_counter() - t1
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    paths["mesh/train_layers"], layer_params = _mesh_train_layers(dev, totals)
    paths["mesh/prefill_layers"] = _mesh_prefill_layers(dev, layer_params, totals)
    paths["mesh/layers_s"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    paths["mesh/decode"] = _mesh_decode_runs(dev, (get_arch(SMOLLM), params), layer_params,
                                             totals)
    paths["mesh/decode_s"] = time.perf_counter() - t1
    del params, layer_params
    torch.cuda.empty_cache()
    rows = _mesh_decode_kernels(dev)
    paths["mesh/psum_compressed"] = _mesh_psum(dev)
    t1 = time.perf_counter()
    done = os.environ.get(DRYRUN_ENV)  # counted beside the build
    with tempfile.TemporaryDirectory() as tmp:
        where = Path(done) if done else Path(tmp)
        paths["mesh/dryrun"] = _mesh_dryrun_finish(
            None if done else _mesh_dryrun_start(where), where)
    paths["mesh/dryrun_wait_s"] = time.perf_counter() - t1
    ms, one = paths["mesh/train"]["ms_per_step"], paths["mesh/train"]["single_ms_per_step"]
    log(f"[mesh] sharded step ms {[round(x, 1) for x in ms]} against the single-device "
        f"{[round(x, 1) for x in one]} ({smi}); serving {paths['mesh/serve_s']:.1f} s, the "
        f"other layer kinds {paths['mesh/layers_s']:.1f} s, split decode "
        f"{paths['mesh/decode_s']:.1f} s, waited {paths['mesh/dryrun_wait_s']:.1f} s for the "
        f"dry-runs")
    paths["mesh/phase_s"] = time.perf_counter() - t0
    log(f"[mesh] phase 15 in {paths['mesh/phase_s']:.1f} s")
    return rows, paths


def _mesh_main(out: str) -> int:
    """``--mesh-json PATH``: phase 15 alone, its rows, paths and launch
    counts written to ``PATH`` as JSON."""
    from repro_torch.kernels import _build, ops

    _build.build()
    totals = {k: 0 for k in ops.LAUNCHES}
    rows, paths = phase_mesh(torch.device("cuda", 0), totals)
    Path(out).write_text(json.dumps({"rows": rows, "paths": paths, "totals": totals},
                                    default=str))
    return 0


def _run_child(flag: str, timeout: int) -> dict:
    """``chip_smoke.py flag PATH`` in a process of its own, waited for;
    returns the JSON it wrote to PATH. Late in a long process
    ``torch.profiler`` drops kernel records (phase 6e's decode trace once
    held 159 of 160 attention launches in three traces running in turn,
    on an H100 80GB HBM3); a fresh process records every one."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "child.json"
        subprocess.run([sys.executable, str(Path(__file__).resolve()), flag, str(out)],
                       check=True, timeout=timeout)
        return json.loads(out.read_text())


def _lm_main(out: str) -> int:
    """``--lm-json PATH``: phase 6 alone, its row, paths and launch counts
    written to ``PATH`` as JSON."""
    from repro_torch.kernels import _build, ops

    _build.build()
    totals = {k: 0 for k in ops.LAUNCHES}
    row, paths = phase_lm(torch.device("cuda", 0), totals)
    Path(out).write_text(json.dumps({"row": row, "paths": paths, "totals": totals},
                                    default=str))
    return 0


def _profile_main(out: str) -> int:
    """``--profile-json PATH``: phase 7 alone, written to ``PATH`` as JSON."""
    from repro_torch.kernels import _build

    _build.build()
    Path(out).write_text(json.dumps({"paths": phase_profile(torch.device("cuda", 0))},
                                    default=str))
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 1
    if len(sys.argv) == 5 and sys.argv[1] == "--cpu-refs":
        return _refs_main(sys.argv[2], int(sys.argv[3]), int(sys.argv[4]))
    if len(sys.argv) == 3 and sys.argv[1] == "--lanes-json":
        return _lanes_main(sys.argv[2])
    if len(sys.argv) == 3 and sys.argv[1] == "--monitors-json":
        return _monitors_main(sys.argv[2])
    if len(sys.argv) == 3 and sys.argv[1] == "--obs-json":
        return _obs_main(sys.argv[2])
    if len(sys.argv) == 3 and sys.argv[1] == "--partition-json":
        return _partition_main(sys.argv[2])
    if len(sys.argv) == 3 and sys.argv[1] == "--precision-json":
        return _precision_main(sys.argv[2])
    if len(sys.argv) == 3 and sys.argv[1] == "--train-json":
        return _train_main(sys.argv[2])
    if len(sys.argv) in (3, 4) and sys.argv[1] == "--archs-json":
        return _archs_main(*sys.argv[2:])
    if len(sys.argv) == 3 and sys.argv[1] == "--mesh-json":
        return _mesh_main(sys.argv[2])
    if len(sys.argv) == 3 and sys.argv[1] == "--lm-json":
        return _lm_main(sys.argv[2])
    if len(sys.argv) == 3 and sys.argv[1] == "--profile-json":
        return _profile_main(sys.argv[2])
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    log(f"[device] {torch.cuda.get_device_name(0)} | {smi} | torch {torch.__version__} "
        f"CUDA {torch.version.cuda}")
    t_start, clock = time.perf_counter(), {}

    def mark(phase: str) -> None:
        clock[phase] = time.perf_counter() - t_start
        log(f"[clock] {phase} done at {clock[phase]:.1f} s")

    with tempfile.TemporaryDirectory() as tmp, _archs_child(Path(tmp)) as archs_child, \
            _cpu_children(Path(tmp)) as cpu_children:
        build = phase_build()
        mark("1 build")
        # No timed phase runs beside a CPU child: phase 14's CPU half, the
        # CPU references, phase 15's dry-run.
        t0 = time.perf_counter()
        archs_child.ready(ARCH_PREP_TIMEOUT)
        cpu_children.ready(REF_TIMEOUT)
        log(f"[refs] waited {time.perf_counter() - t0:.1f} s after the build for the CPU "
            "children")
        mark("14 CPU half, CPU references, dry-run")
        return _main_phases(dev, smi, build, mark, clock, archs_child.finish)


@contextlib.contextmanager
def _cpu_children(tmp: Path):
    """The CPU work of later phases, started now beside the build: the CPU
    port's references of phases 3-5c in ``REF_PROCS`` processes
    (``--cpu-refs``, read back through :func:`cpu_ref`) and phase 15's meta
    dry-run. Yields ``ready(timeout)``, which waits for them all; they are
    killed if the script ends first."""
    refs, dry = tmp / "refs", tmp / "dryrun"
    refs.mkdir()
    os.environ[REFS_ENV] = str(refs)
    os.environ[DRYRUN_ENV] = str(dry)
    procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--cpu-refs",
                               str(refs), str(i), str(REF_PROCS)]) for i in range(REF_PROCS)]
    dry_procs = _mesh_dryrun_start(dry)

    def ready(timeout: int) -> None:
        end = time.perf_counter() + timeout
        for proc in procs:
            rc = proc.wait(timeout=max(1.0, end - time.perf_counter()))
            require(rc == 0, f"a CPU reference process exited with {rc}")
        _mesh_dryrun_wait(dry_procs, end - time.perf_counter())

    try:
        yield SimpleNamespace(ready=ready)
    finally:
        for proc in (*procs, *dry_procs):
            if proc.poll() is None:
                proc.kill()
                proc.wait()


@contextlib.contextmanager
def _archs_child(tmp: Path):
    """Phase 14 in a process of its own, started now: its CPU half runs
    beside the build, its card half once :func:`_main_phases` writes the
    go file. Yields ``ready(timeout)``, which waits for the CPU half, and
    ``finish(timeout)``, which starts the card half and returns the child's
    JSON; the child is killed if the script ends before it does."""
    out, go = tmp / "archs.json", tmp / "archs.go"
    proc = subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--archs-json",
                             str(out), str(go)])

    def ready(timeout: int) -> None:
        end = time.perf_counter() + timeout
        while not Path(f"{go}.ready").exists():
            require(proc.poll() is None, f"phase 14's process exited with {proc.returncode}")
            require(time.perf_counter() < end, f"phase 14's CPU half took over {timeout} s")
            time.sleep(0.5)

    def finish(timeout: int) -> dict:
        go.write_text("go")
        rc = proc.wait(timeout=timeout)
        require(rc == 0, f"phase 14's process exited with {rc}")
        return json.loads(out.read_text())

    try:
        yield SimpleNamespace(ready=ready, finish=finish)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def _main_phases(dev, smi, build, mark, clock, archs_child) -> int:
    """Phases 2-14 and 7 after the build, the kernel and path lines and
    the last line."""
    from repro_torch.kernels import ops

    rows, designs = phase_kernels(dev)
    mark("2 kernels")
    totals = {k: 0 for k in ops.LAUNCHES}
    paths = phase_synfire(dev, totals)
    mark("3 synfire")
    paths.update(phase_scale(dev, totals))
    mark("4 scale")
    paths.update(phase_plastic(dev, totals))
    mark("5 plastic")
    phase_coba_kernels(dev, rows)
    paths.update(phase_coba(dev, totals))
    mark("5b coba")
    paths.update(phase_a5(dev, totals))
    mark("5c a5")
    paths.update(phase_lanes_fresh(rows, totals))
    mark("8 lanes")
    paths.update(phase_monitors_fresh(rows, totals))
    mark("9 monitors")
    paths.update(phase_obs_fresh(rows, totals))
    mark("10 obs")
    paths.update(phase_partition_fresh(totals))
    mark("11 partition")
    paths.update(phase_precision_fresh(rows, totals))
    mark("12 precision")
    trained = _run_child("--train-json", 600)  # phase 13
    _add(totals, trained["totals"])
    rows.append(trained["row"])
    paths.update(trained["paths"])
    mark("13 train")
    lm = _run_child("--lm-json", 900)  # phases 6 and 7: fresh processes, whole traces
    _add(totals, lm["totals"])
    rows.append(lm["row"])
    paths.update(lm["paths"])
    mark("6 lm")
    archs = archs_child(900)  # phase 14's card half
    _add(totals, archs["totals"])
    by_name = {r["name"]: r for r in rows}

    def entries(child):  # an entry's route, source and TPU kernel are its kernel's
        for r in child["rows"]:
            base = by_name[r["kernel"]]
            rows.append({**{k: base[k] for k in ("route", "source", "replaces")}, **r,
                         "launches": child["totals"][r["kernel"]]})

    entries(archs)
    paths.update(archs["paths"])
    mark("14 archs")
    meshed = _run_child("--mesh-json", 600)  # phase 15
    _add(totals, meshed["totals"])
    entries(meshed)
    paths.update(meshed["paths"])
    mark("15 mesh")
    paths.update(_run_child("--profile-json", 900)["paths"])
    mark("7 profile")
    paths["clock_s"] = clock
    for r in rows:
        if "entry" not in r:  # an entry's launches are its own paths' (phases 12, 14, 15)
            r["launches"] = totals[r["name"]]
        require(r["launches"] > 0, f"{r['name']} never launched on the main path")
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"paths": paths, "fused_designs": designs, "build": build,
                    "card": smi}))
    log(smi.splitlines()[0])
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
