#!/usr/bin/env python3
"""Drive the PyTorch port's synthesis, LM-serving and training paths on
one CUDA card and check them.

Run from the repository root with no arguments::

    python3 chip_smoke.py

(``python3 chip_smoke.py --only 8,24,25`` builds the kernels and runs
only those of phases 7 (its checks), 17, 8, 24, 25, 26, 12, 27, 28, 29,
30, 31 and 32 named: a development run, with no kernels or result
line.)

Phases (any failure exits non-zero; nothing is caught and passed over):

1. device — the card's name and power limit (``nvidia-smi``), CUDA
   version; TF32 matmuls off.
2. build — every ``src/repro_torch/kernels/csrc/*.cu`` with ``nvcc`` into
   ``build/kernels/``, one compiler process per source, all at once; each
   kernel's registers, shared memory (static, and the dynamic share a
   flash, SSD or flash-decode block asks for; the last two must equal what
   their wrappers' ``launch_args`` compute on the host) and spills as
   ``ptxas -v`` reported them.
3. kernels — each ring kernel against its plain PyTorch version on the
   card, exactly.  ``sweep_guards`` (the sweep's control) at the main
   path's tables (gemm at full size: 88 tasks, 192 channels, 2 phases;
   gaussian's 3-phase stencils), with every task dead, with the done flag
   set, at T = 1 and T = 1000, and with the flags a graph with async ports
   gives it, ``SWEEP_STATES`` random carries each and 40
   launches back to back on one carry; with a partition's owner mask and
   heads (phase 26's launches: the head and size moves of the tasks
   fired on other partitions) at gemm's, gaussian's and the T = 1000
   tables, heads and sizes compared too; its times at gemm's tables (per
   call through a prepared handle, device time a launch, plain version),
   without and with the mask, beside its bound.  ``service_ports`` (the async ports' latency queues
   and the sweep's commit) bit for bit on ``SERVICE_STATES`` random port
   carries a case and 40 chained launches (``SERVICE_CASES``: depths 1, 4
   and 8; rows of 8 B, 7 B, 60 B, 39 KiB and 256 KiB; response rings full;
   addresses far out of range; write addresses with no value token; dues
   past and ahead; the done flag set), and its times at gemm's 16 ports of
   256 KiB rows beside its bound.  ``eval_guards`` (the reference API's
   counterpart) at its shapes.  Pop and push at the main path's shapes
   and at the edge cases (wraparound, ``n == cap``, ``cap == 1``, int32
   and bool elements; the bursts that spread over a cluster of blocks: a
   wrap of 2 MiB rows, odd
   row bytes, ``n == cap`` of 256 KiB rows); two chained sequences of
   ``CHAINED_OPS`` pops and pushes on one ring with no sync between
   them, against the same sequence through the plain versions; CUDA-event
   times of an eager call through a prepared ``RingHandle`` that has run
   the op once (the sweep's bodies call it so at capture; the replays
   launch the captured kernels with no host path) in ``TIMING_TURNS``
   turns with one library call (the median of each), the kernels' device
   time a launch under the profiler (profiled again once if it shows
   none, then a failure; every timed call must also show on the kernel's
   own launch counter), through ``ring_pop``/``ring_push`` (a handle
   built a call) and of the plain version, each timed call starting from
   a head/size inside the op's contract.
4. main path — gemm, gaussian and page_rank through ``build_step`` and
   the compiled engine at full size (what ``run_step`` runs), with launch
   counts read just before and just after each app.  The ring kernels
   count their launches on the card, where they run (replayed ones
   included): every ring kernel, ``sweep_guards`` included, must have
   launched in every app's run, ``sweep_guards`` once a replay, and
   ``ring_pop``/``ring_push`` exactly as often as the run's firings
   popped and pushed (``CompiledEngine.ring_ops``: each phase's ring ops
   from the counting pass times its firings); the run must have gone
   through the captured sweep (replays, at most one host sync a block and
   one final read), and its sweep graph must hold the guards, one node a
   (task, phase) body and, with async ports, the port service.  The same
   for the async-port graphs (``FULL_ASYNC``: gemm at full width, 96
   tasks over 280 channels and 16 ports; page_rank cut to 4,096 vertices),
   where ``service_ports`` must also launch once a replay (and never in a
   graph without ports).  Then each app at full size once more,
   held against the reference and against the CPU lowering of the same
   graph, relative to the output's scale (``REF_REL_TOL``,
   ``CPU_REL_TOL``); each async graph again on the card, with CUDA events
   around each block of replays (device time a sweep), and on the CPU:
   sweeps, fires, channel statistics and port counters equal, outputs
   within the same limits.
5. twin vs compiled — each app at a reduced size under the coroutine
   twin and under ``CompiledEngine``, both on the card: bit-identical
   outputs and equal token counts; the sweeps equal those of the CPU
   (plain-version) lowering of the same graph.  The async-port gemm and
   page_rank at the test sizes, at depths 1 and 4: bit-identical to the
   twin, and sweeps, fires, channel statistics and port counters equal
   to the CPU lowering's.
6. breakdown — each app at full size twice more: seconds in the app's
   build, the lowering (wiring + counting pass), the sweep loop and its
   capture, replays and host syncs, host ms a sweep; then with CUDA events
   around every block of replays, the device time in the sweep's graphs
   a replay (over the blocks of 64, where the host runs ahead of the
   card) and the share of the loop (the profiler does not report the
   kernels inside the graph's conditional nodes faithfully on this card,
   so none runs over them); each ring kernel's device time a launch from
   phase 3; the sweep graph's own cost: a graph of 14 and of 152
   one-kernel bodies, all firing and none firing, against a plain graph
   of the same kernels.
   Measurement only: the checks are phases 3-5.
7. attention kernels — flash attention forward and flash-decode against
   their plain versions on the card, in float32 and bfloat16, at the
   serving path's shapes (Qwen3-0.6B: 16 query heads, 8 KV heads of
   width 128; prefill buckets 8-2048, batch 1 and 8, causal, windowed
   and head-width-64 cases; the bf16 kernel's tile edges: Sq < Sk and
   Sq > Sk, a 1,500-token prompt, window 0 (every row hidden: exact
   zeros, lse -1e30), S=2048 with window 100, hd 64 with group 4; decode
   at 8 slots of a 2048-row cache with ragged lengths, 0 and 2048
   included, the edges of its 64-row splits (kv_len and S_max at 63, 64
   and 65) and groups 1, 4 and 8); then Phi-3-vision's head width 96: 32
   query and 32 KV heads, prefill lengths 128-2048 (its 576-patch prefix,
   a 1,500-token prompt), a GQA group of 8 with a window, Sq < Sk; decode
   at 8 slots of 2048 rows with a dead slot and a full row, random
   lengths, groups 8 and 4; then head width 64 at group 1: whisper-small's
   encoder (12/12 heads, non-causal 1500 x 1500, B=1 and 8) and
   cross-attention (1, 37, 64 and 448 queries against 1500 keys),
   zamba2-1.2b's shared block (32/32, causal, 37-1500), flash-decode on
   zamba2's one per-slot row of 2048 (a scalar length expanded) and on
   whisper's 8 ragged rows of 2048; then phase 31's dense models:
   starcoder2-3b's 4,608-token prefill (24 query heads on 2 KV heads of
   128, window 4096), groups 4 and 8 at 32 query heads, flash-decode on
   yi-6b's (group 8), qwen3-4b's (group 4) and a group-12 cache of 8
   slots x 2048 (starcoder2-3b's heads), group 16 at hd 96 and 64, and
   groups over the kernel's 16 (24 and 40: one launch a chunk of each
   KV head's query heads).  Limits, relative to the plain
   output's largest magnitude: ``ATTN_REL_TOL``; flash's ``lse`` within
   ``LSE_ABS_TOL``; exact zeros where ``kv_len == 0``; the largest error
   of each op, head width and dtype is printed.  Flash-decode's ``lse``
   output (``LSE_CASES``: Qwen3's 8 x 2048 cache, zamba2's 32/32 x 64 one
   row and four, rows of length 0; float32 and bf16): ``(out, lse)``
   against the plain version's (``LSE_ABS_TOL``, -inf where no key is
   valid), ``out`` (float32, unrounded) rounded bitwise the call's
   without ``lse``; each cache cut into 2, 4 and 16 sequence pieces, the
   kernel on each piece with its local lengths, the pieces merged in
   float32 as a sequence-split mesh merges them and rounded once: within
   ``ATTN_REL_TOL`` of the whole cache's kernel output, and bf16 within
   one rounding step of it everywhere.  CUDA-event times
   (``FLASH_TIMES``: Qwen3's B=1 S=1024 and 2048, B=8 S=256, B=4 S=1024,
   Phi-3's B=1 S=1024 and 2048, whisper's encoder and its decode step's
   cross-attention, zamba2's shared block at S=1024, phase 29's training
   shapes, starcoder2-3b's windowed 4,608 and qwen3-4b's and yi-6b's
   groups; ``DECODE_TIMES``: Qwen3's and Phi-3's packed caches, zamba2's
   per-slot row, qwen3-4b's, yi-6b's and a group-12 cache) of kernel,
   plain version and
   ``scaled_dot_product_attention`` (the yardstick, never called by the
   port), each kernel's device time a call, reading a different layer's
   tensors on each call as the model does, so the 50 MB L2 holds none of them.
8. serving — Qwen3-0.6B at full width (28 layers, bf16, random weights
   from a seed) through ``ServingEngine`` + ``lm.serving_adapter`` +
   ``serve_requests`` with ``attn_impl="kernel"``: 8 slots of 2048
   positions, 16 requests with prompts of 64-1500 tokens, 32 new tokens
   each.  Launch counts are zeroed just before the requests and read just
   after: flash attention launched once per layer per prefill call,
   flash-decode once per layer per decode step; no logit NaN.  Then
   ``repro_torch.launch.serve.serve(["--full", "--no-cache"])`` at its
   defaults (the eager warmup; phase 24 runs its compiled one).
9. card vs CPU — Qwen3-0.6B at full width cut to 2 layers, float32, the
   same weights on both devices: bucketed prefill of 4 ragged prompts
   (37-512 tokens) and 8 ragged decode steps, logits within
   ``LOGIT_REL_TOL`` of their largest magnitude, equal greedy tokens.
10. serving breakdown — the first wave of phase 8 again under
   ``torch.profiler`` (device activity): its prefill and decode seconds,
   the device's busy share and each attention kernel's mean device time
   per launch; every bf16 flash launch of the wave must show in the
   profile as the tensor-core kernel and none as the float32 one, and
   every flash-decode launch as ``decode_partial_kernel`` (by kernel
   name; the profiler on the card now and then loses kernel records, so
   here and in phases 13 and 15 a profile that misses launches is taken
   again on a new run, ``PROFILE_TRIES`` in all); then the decode step
   alone, ``BREAKDOWN_STEPS`` (8) times over that wave's 8
   live slots: host and device ms per step, the busy share, and the aten
   operations one step dispatches.

11. SSD scan — ``ops.ssd_scan`` (the kernel) against its plain version
   through the same wrapper and against a float64 evaluation, at the
   training shape (B=8, S=2048, 24 heads of P=64, N=128, chunk 256), B=1,
   S=1000 (the pad path), G=2, N=64 and the reduced 16x16, and the
   per-slot prefill's shapes (B=1, chunk = min(256, S)): zamba2's 64
   heads in one group with N=64 at S = 8, 37, 255, 256, 1000 and 1500,
   mamba2's N=128 at S=37; with the model's decays and small ones
   (``SSD_REL_TOL``, y and the final state; at small decays the
   inter-chunk term must be a visible part of y); CUDA-event times of
   kernel and plain version at the training shape and at three per-slot
   prefills (``SSD_TIMES``), the bound (3xTF32 on the tensor cores; the
   float32 CUDA cores' beside it), and each of the three kernels' device
   time per call.
12. training — ``repro_torch.launch.train`` on Mamba2-130M at full width
   (bf16, 8 x 2048, 20 steps, ``--use-kernel``, ``--model-parallel 1``:
   through a (1, 1) mesh of a one-rank NCCL group, parameters, AdamW
   state and batches placed by the sharding rules, the step on DTensors):
   rc 0 (``launch.train``'s own loss-decrease check), exactly 2 x 24 x 20 SSD
   launches (remat runs each layer's forward twice), finite losses and
   gradient norms, the step-20 checkpoint restorable (unsharded), and the
   same command without ``--model-parallel`` (the unsharded driver,
   resuming from the mesh run's checkpoint) runs no step.
13. Qwen3-0.6B at full width, 3 ``make_train_step(use_kernel=True)``
   steps at 4 x 1024: flash launched 2 x 28 x 3 times, all finite; then
   a fourth step under the profiler, whose 56 flash launches must all be
   the tensor-core kernel (flash's device time per launch and per step).
14. card vs CPU — Mamba2-130M cut to 2 layers, float32, the same weights
   and tokens: loss, every gradient leaf and one AdamW step
   (``TRAIN_CPU_TOL``).
15. training breakdown — one step of phase 12's configuration under the
   profiler: the device's busy share, the SSD kernel's device time and
   share (every SSD launch of the step must show as ``ssd_state_mma``, by
   kernel name), the top device operations; the backward's recompute
   alone.
16. recovery — each of phase 4's five graphs at phase 4's size through
   ``repro_torch.ft.run_supervised`` on the card (``RECOVERY``: gemm every
   8 sweeps, gaussian 256, page_rank 4, gemm async 16, page_rank async
   2048), crashed once between two chunks: outputs bit-identical to an
   uninterrupted ``CompiledEngine`` run, the chunks' sweeps equal to its
   sweeps and to the abstract schedule's, the sweep graph captured once
   an attempt, exactly one restart, resumed from the last snapshot saved
   before the crash, ``sweep_guards`` (and ``service_ports``) counted once
   a replay and the ring ops equal to the uninterrupted run's; a snapshot
   with a full channel (gemm) and one with a request in flight (page_rank
   async).  Recorded: chunks, snapshots and their bytes, ms a snapshot
   read (device to host), a store save and a restore, replays and host
   syncs, seconds against the uninterrupted run.  Then at phase 5's sizes
   a crash under ``compiled`` finished under ``coroutine`` and the
   reverse, bit-identical, and a port graph refused under ``coroutine``.
17. codegen — hierarchical code generation on the card: stage graphs
   compiled through ``compile_stages`` into AOTInductor packages (no
   hand-written kernel runs here; the programs run inductor's generated
   code), each store under a temporary ``build/codegen_*``, deleted.
   First the ``CODEGEN_WORKERS`` compile processes start, one compile
   each (their one-time start-up, timed apart); they stay up for phases
   24-25.  Their start-up runs in a thread started before phase 11, on
   the host's cores beside phases 11-16 (the script's time limit); it
   loads its packages only once phase 17 opens its gate, so no CUDA
   module load lands inside phase 16's graph captures.
   Gaussian's chain at phase 4's width (``torch_stages``, 6 instances of
   3 definitions): monolithic 6 compiles; hierarchical cold on an empty
   root 3; warm from a fresh ``python`` process on that root 0, every
   definition from disk; incremental after an in-place edit of the
   stencil's weights with ``prev`` 1 compiled, 2 reused; the program
   within ``GAUSSIAN_TOL`` of the eager stages on the card and of
   ``_stencil_ref`` on the host (in the fresh process too).  The codegen
   benchmark's cache graph (``CODEGEN_GRAPH``: 515 instances of 8
   definitions, 15 in the benchmark): cold 8 compiles, warm 8 disk hits,
   incremental 1 compiled and 7 reused, each definition's output against
   eager.  cnn
   (17 instances, 2 definitions) and gcn (9, 3; a 64 MiB adjacency)
   through ``compile_app``, within ``APP_TOL`` of their ``ref``, and a
   rerun with re-created closures compiling nothing.  Gaussian's
   ``compile_app`` at 64 x 64 (elaboration is the per-pixel simulation)
   and ``invoke(target="compiled")`` on a graph of gaussian's stage
   definitions through the default cache: 3 compiles, then 3 memory
   hits.  Recorded, not gated: per-definition export, compile and load
   seconds, each mode's wall seconds, monolithic/hierarchical and
   cold/warm ratios, package bytes, each program's run ms (CUDA events).
18. granite-moe-1b-a400m at full width (32 experts top-8; 12 of its 24
   layers, ``SERVE_LAYERS``: the script's time limit), bf16,
   random weights from a seed, served as phase 8 serves Qwen3
   (``SERVE``, ``attn_impl="kernel"``), with phase 8's gates: the
   parameter count equal to ``cfg.param_count()``, ``max_new`` tokens a
   request, no NaN logit, flash launches = layers x prefill calls,
   flash-decode launches = layers x decode steps; tok/s, prefill s, ms a
   decode step and peak GB printed.  Then ``launch.serve --full --arch
   granite-moe-1b-a400m`` at its defaults (flash-decode at every layer).
19. phi-3-vision-4.2b at full width (MHA 32 heads of 96; 16 of its 32
   layers, ``SERVE_LAYERS``) the same way, then one bf16 prefill of a ``VLM_PROMPT``-token prompt with
   576 random patches: finite logits that the patches move, flash once a
   layer; then its ``launch.serve --full``.
20. card vs CPU, as phase 9, for both models at 2 float32 layers of full
   width: phi-3's prompts (600-1024 tokens, a 1024 bucket) carry patches;
   granite's expert choices are compared before its logits, layer by
   layer: a choice that differs where the token's K + 1 largest router
   probabilities are closer than ``ROUTE_MARGIN`` is float-class,
   reported, and its row (and any row whose kept copies it displaced) is
   left out of the logit comparison from then on; any other difference
   fails.
21. mamba2-130m and zamba2-1.2b (the shared block after every 6th) at
   full width, 12 layers each (of 24 and 38, ``SERVE_LAYERS``), bf16, random weights from a seed, through the per-slot engine ``launch.serve`` builds for them
   (``per_slot_engine``: the SSD scan, flash and flash-decode kernels) at
   ``SERVE``'s recipe: every request ok with ``max_new`` tokens (the
   per-slot path quarantines a request whose step raises, so an error
   fails here), no NaN logit, the parameter count equal to the leaves,
   SSD launches = layers x prefill calls, flash = 2 x prefill calls and
   flash-decode = 2 x decode calls (zamba2; none for mamba2); tok/s,
   prefill s, ms a decode call and peak GB printed.  Then each model's
   ``launch.serve --full`` at its defaults: rc 0 and ``mode=per-slot``.
22. whisper-small at full width (12 + 12 layers, d 768, bf16, frames
   ``[B, 1500, 768]`` from a seed) through ``make_prefill_step`` and
   ``make_decode_step``: a 448-token prefill and one of 8 x 64, flash 36
   times each (12 encoder, 12 self, 12 cross); other frames move the
   logits; 32 greedy decode steps of the 8, each with 12 flash-decode
   and 12 flash (cross-attention, one query) launches; finite logits.
23. card vs CPU, float32, one prompt a call as the per-slot path runs
   it: mamba2 at 2 layers, zamba2 at 12 (the shared block twice, cache
   blocks 0 and 1), whisper at 2 + 2 with 1500 frames; prompts of 37,
   300 and 512 tokens (below the chunk of 256, not a multiple of it, two
   chunks), 8 decode steps each: logits, and the SSM and conv states
   after prefill, within ``LOGIT_REL_TOL`` of their largest magnitude,
   greedy tokens equal, the card's launches those of the path.
24. serving compiled — Qwen3-0.6B at full width cut to
   ``COMPILED_LAYERS`` (2) layers (bf16, phase 8's seed, 8 slots of
   2048) through the serving engine's compiled
   steps: ``warmup(cache=...)`` into an empty compile cache under a
   temporary ``build/serve_cache_*`` (deleted) at batch sizes 1, 2, 4
   and 8 and phase 8's buckets: the prefill (one AOTInductor package for
   every batch size and bucket), the decode step, the slot write and
   the retire, all ``"compiled"``, their package bytes and export,
   compile and load seconds and the warmup's wall seconds printed; the
   kernels run inside the packages as operators (``repro_torch::
   flash_attention_fwd`` ...), each launch counted by its wrapper, which
   the package calls back.  Phase 8's 16 requests through the compiled
   steps: every request ``max_new`` tokens, flash once a layer a prefill
   call, flash-decode once a layer a decode step; tok/s and ms a step.
   Then the warm half, ``chip_smoke.py --warm-serve`` in a fresh process
   on the same store, warming up as ``launch.serve`` does
   (``default_cache()``): no executable compiled, its warmup seconds,
   one wave of the requests (its tokens against the cold process's,
   printed), the decode step alone on that wave under the profiler (a
   ``decode_partial_kernel`` a layer a step, kernels and device ms a
   step) and one compiled prefill (a ``flash_wgmma_kernel`` a layer):
   the main process's profiler, after phases 10-15's sessions, missed 3
   kernel records a session.
25. compiled card vs CPU — Qwen3-0.6B at full width cut to 2 layers,
   float32, kv_quant off and on: the compiled prefill, slot write and
   decode step against the same graphs run eagerly on the card and on
   the CPU, 4 ragged prompts and 8 decode steps, logits within
   ``LOGIT_REL_TOL`` and greedy tokens equal (flash-decode 16 launches a
   path with kv_quant off, none with it on: the int8 cache's decode is
   ``sdpa`` over the dequantized cache, as in the reference; with it on,
   the card's int8 caches are set to the CPU's before each step, and
   the codes that differed are counted); mamba2-130m at 2 float32 layers
   per slot through the cache: prefill and decode compiled, the eager
   per-slot engine's tokens, no fall-off, the SSD kernel in the profile
   of the compiled prefill.  The three engines warm up together (one
   export at a time, the packages side by side in the compile processes
   phase 17 started, which this phase stops).
26. partitioned synthesis — gemm and page_rank at phase 4's full widths
   (``PARTITIONED``) through ``CompiledEngine(mesh=[cuda:0] * N)`` for N
   in ``MESHES`` (2 and 4 partitions sharing the card, named explicitly),
   placed on the port's own cost probes (``core/cost.py``,
   ``core/floorplan.py``; memoized under a temporary
   ``build/partition_cache_*``, deleted), and gemm over 2 with
   ``MANUAL_PINS``: outputs bitwise equal to the single-device compiled
   run of the same graph on the card, the same sweeps and fires, gemm on
   more than one partition, the pins honoured; the ring kernels' counted
   launches summed over the partitions equal to the firings' pops and
   pushes, ``sweep_guards`` once a partition a replay, each partition's
   sweep graph the guards, one node a (task, phase) it owns and its sweep
   end; the async gemm (``FULL_ASYNC``) refused under a mesh, naming its
   ports and tasks.  Printed: the cost probes' cells and seconds, the
   placement (tasks a partition, cut channels and bytes, objective),
   lowering and capture seconds, graph nodes a partition, host syncs,
   sweeps/s over the sweep loop alone and device us a sweep (CUDA events
   around each replay) against the single-device run, the cut bytes
   copied a sweep.
27. sharded training — (a) Qwen3-0.6B at phase 13's configuration
   (bf16, 4 x 1024, ``use_kernel=True``) through ``make_host_mesh(1)``
   (a one-rank NCCL group): 3 ``make_train_step`` steps on DTensors
   placed by ``param_specs``/``opt_state_specs``/``batch_spec``, and 3
   unsharded steps from the same weights and batches; losses and
   gradient norms equal (``SHARD_LOSS_TOL``, ``SHARD_GNORM_REL``: 0), flash launched 2 x 28 x 3 times in the sharded steps,
   every parameter's local shard on cuda:0, then a fourth sharded step
   under the profiler whose flash launches must all be the tensor-core
   kernel; host ms (the call's return) and device ms (CUDA events) a
   step both ways; the process group destroyed.  (b) is phase 12, now
   through the mesh.  (c) ``launch.dryrun.run_cell`` of ``qwen3-0.6b x
   train_4k x pod16x16`` on a fake 256-rank process group on the host:
   ``ok``, its argument bytes equal to the local shard bytes summed
   from the specs, its argument and temporary bytes (an estimate) within
   the card's memory (the cell runs in a child process started before
   phase 24, on the host's free cores; its own seconds).
28. mesh modules, one rank of an NCCL group (``make_host_mesh(1)``) — (a)
   one train step's bf16 gradients of Qwen3-0.6B at full width (phase
   13's batch, ``use_kernel=True``) through ``ef_compressed_mean`` over
   the ``data`` dim: each leaf's mean bitwise its local ``dequant(q)``,
   its ``(q, scale)`` bitwise ``quantize_int8``'s on the CPU, its
   round-trip error within the rounding bound (``scale / 2`` an element)
   and recorded, and under ``COMPRESS_ERR`` on a 64 x 64 normal matrix;
   (b) all 28 decoder layers (d 1024, 16/8 x 128, bf16, flash) as one
   stage of ``pipeline_apply`` on a one-rank ``stage`` mesh, ``PIPE``'s 4
   microbatches of 1 x 1024 hidden states: outputs bitwise the stage
   applied microbatch by microbatch, ``pipeline_loss_fn``'s gradients (an
   MSE tail against seeded labels) bitwise autograd's through that loop,
   flash launched 28 x 4 times in each forward, a profiled forward's
   every launch ``flash_wgmma_kernel``.  Times: the mean's, and a
   forward's of the pipeline and of the direct loop, each the median of
   ``MESH_TURNS`` calls after an untimed one.
29. the families trained at full width (``FAMILY_TRAIN``; bf16, random
   weights from seed 0, batches of ``make_pipeline(vocab, S, B, seed=0)``,
   AdamW, remat, ``use_kernel``): granite-moe-1b-a400m (4 x 1024, 24
   layers) through ``make_train_step``, its first step's gradients taken
   twice from the same state first, bitwise equal; zamba2-1.2b (2 x 2048,
   38 layers) through ``launch.train --use-kernel`` into a checkpoint
   directory with a metrics file, then the same command again, which must
   restore step 3 and run no step; whisper-small (8 x 448, 12 + 12
   layers) with a batch's ``frames`` [8, 1500, 768] and phi-3-vision-4.2b
   (2 x 2048, cut to 16 layers) with ``patches`` [2, 576, 1024], both
   drawn from ``default_rng(0)``, through ``make_train_step``; 3 steps
   each.  Gates: finite losses, grad norms and parameters, the parameter
   count from the leaves (``FAMILY_TRAIN_PARAMS``), the launches exactly
   ``_train_launches`` (flash 2 x 24, 2 x 6 (+ SSD 2 x 38), 12 + 2 x 2 x
   12, 2 x 16 a step), then one more step under the profiler with host
   and device activity: every flash launch ``flash_wgmma_kernel``, SSD
   launches equal to the counter.  Printed: ms a step (median after step
   1), tokens/s, peak GB, the profiled step's device-busy ms, the kernels'
   device ms and the device ms of the torch-ops backwards of flash and of
   the SSD scan (``BACKWARD_RANGES``), each as a share of the step.
30. the families' float32 step against the CPU (``FAMILY_TRAIN_CPU``, full
   width: granite, whisper (2 + 2, 1500 frames) and phi-3 (576 patches)
   at 2 layers, zamba2 at 6 over 2 x 512): the same weights
   (``init_params(cfg, 1)`` on the CPU) and batch; the loss, every
   gradient leaf and one AdamW step within ``TRAIN_CPU_TOL``, the card's
   launches those of one step.  The CPU halves run in a child process
   started before phase 18 (``family_cpu_child``).  The MoE's expert
   choices are compared first (``_route_diffs``; the card's recompute
   under remat must choose as its forward), and the CPU's gradients are
   taken under the card's choices (``_PinnedRouter``): its card half runs
   first and its comparison last, after the other families'
   (``family_train_vs_cpu_all``).
31. the dense models qwen3-4b (qk-norm, tied, 32/8 heads of 128), yi-6b
   (32/4: flash-decode at group 8, hd 128) and starcoder2-3b (24/2,
   window 4096) at full width, 8 layers each (of 36, 32 and 30,
   ``SERVE_LAYERS``), bf16, random weights from a seed, served as phase 8
   serves Qwen3 (``SERVE``, ``attn_impl="kernel"``), with phase 8's
   gates: every request ok with its ``max_new`` tokens, no NaN logit, the
   parameter count, flash once a layer a prefill call and flash-decode
   once a layer a decode call, none for starcoder2-3b, whose decode goes
   through windowed ``sdpa`` as the reference's does.  starcoder2-3b also
   serves one long request (``LONG_SERVE``: a 4,608-token prompt x 64
   new in a cache of 8192 rows), so its prefill's rows from 4096 on and
   all its decode steps see only the window; that prompt's prefill alone
   is timed, and its logits must differ from the same weights' without a
   window.  Then the decode step alone under the profiler
   (``DECODE_ALONE_STEPS``: host and device ms a step, the busy share),
   and each model's ``launch.serve --full --arch`` at full depth (rc 0,
   ``mode=batched``, flash and flash-decode a whole number of layers a
   call; no flash-decode for starcoder2-3b).  Printed: tok/s, prefill s,
   ms a decode step while serving, the busy share, peak GB, the depth.
32. card vs CPU, as phase 9, for the three models at 2 float32 layers of
   full width (starcoder2-3b's window cut to ``CPU_WINDOW`` 256 on both
   sides, so the prompts and the decode steps cross it): logits within
   ``LOGIT_REL_TOL``, greedy tokens equal, the card's launches those of
   the path.  The CPU halves run in the child process of phase 30
   (``cpu_serving_half``), read from its files.

Each phase's seconds are printed, and their sum.
The last four lines of standard output are the ``nvidia-smi`` line, the
JSON object of per-kernel numbers after the word ``kernels``, the same
object alone, and the result object ``{"ok": true, "device": {...}}``.
Details also go to
``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import atexit
import dataclasses
import gc
import json
import math
import os
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
CSRC = "src/repro_torch/kernels/csrc"
SOURCE = f"{CSRC}/ring.cu"
SOURCES = {"ring": SOURCE,
           "flash_attention": f"{CSRC}/flash_attention.cu",
           "decode_attention": f"{CSRC}/decode_attention.cu",
           "ssd_scan": f"{CSRC}/ssd_scan.cu"}
HBM_BYTES_PER_S = 3.35e12       # H100 SXM data sheet
# The guards' int32 compares run on the CUDA cores.  The data sheet gives
# no integer rate outside the tensor cores; its float32 CUDA-core rate
# stands in (an upper bound on the int32 rate, so the bound stays a bound).
CUDA_CORE_OPS_PER_S = 67e12
# Attention is bounded against the bf16 tensor-core rate: the least time
# the card could take, whatever the kernel does its products on.
TENSOR_BF16_FLOPS = 989e12
# Kernel vs plain version on the card, max |kernel - plain| / max |plain|.
# float32: both sum in float32, in other orders.  bfloat16: both compute
# in float32 from the same bf16 inputs and round the output once; one
# bf16 ulp of an output near its largest magnitude is ~4e-3.
ATTN_REL_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
LSE_ABS_TOL = 1e-5
# Card (kernels, cuBLAS) vs CPU (plain versions) on the same float32
# weights: max |card - cpu| / max |cpu| over the logits.
LOGIT_REL_TOL = 1e-4
# An MoE token's expert choice may differ between the card and the CPU
# only where its probabilities tie within float rounding: the smallest gap
# among its K + 1 largest below this (float32 router logits summed in
# other orders differ by ~1e-7 relative).
ROUTE_MARGIN = 1e-5
ARCH = "qwen3-0.6b"
DEV = "cuda"                # the LM phases' device
SERVE = dict(slots=8, max_seq=2048, requests=16, prompt=(64, 1500),
             max_new=32, seed=0)
# phase 31: starcoder2-3b serves SERVE's requests and one more, whose
# 4,608-token prompt passes its window of 4096 (the prefill's rows from
# 4096 on, and every decode step, see only the last 4096 positions), in
# a cache of 8192 rows
LONG_SERVE = {"starcoder2-3b": dict(max_seq=8192, prompt=4608, max_new=64)}
# phase 32: starcoder2-3b's window cut to 256 on both sides, so the
# prompts of 37-512 tokens and the decode steps cross it at phase 20's
# CPU cost
CPU_WINDOW = {"starcoder2-3b": 256}
# Full-size card run against the CPU (plain-version) lowering of the same
# graph: max |card - cpu| / max |cpu|.  gemm sums its 4096-long dot
# products in another order in cuBLAS than on the CPU; the other two run
# the same elementwise ops in the same order on both.
CPU_REL_TOL = {"gemm": 1e-5, "gaussian": 1e-6, "page_rank": 1e-6}
# max |card - reference| / max |reference|, for every app: well under the
# apps' own check() limits, which are set for the reference's toy sizes.
REF_REL_TOL = 1e-5
FULL = {
    "gemm": dict(P=8, n=256, K=16),
    "gaussian": dict(h=2048, w=2048, iters=4),
    "page_rank": dict(n_vertices=65536, n_edges=1048576, n_pe=4,
                      n_iters=10),
}
# the async-port graphs (build_step_async) through the captured sweep:
# gemm at phase 4's widths, page_rank cut, since its fetcher moves one 8-byte
# edge row a firing (>= 16,384 sweeps here, >= 2.6 M at phase 4's graph)
FULL_ASYNC = {
    "gemm": dict(P=8, n=256, K=16, mem_latency=4, depth=4),
    "page_rank": dict(n_vertices=4096, n_edges=16384, n_pe=4, n_iters=4,
                      edge_latency=4, edge_depth=4),
}
# phase 5's async graphs: the test sizes, at depths 1 and 4
REDUCED_ASYNC = {
    "gemm": dict(P=2, n=4, K=4),
    "page_rank": dict(n_vertices=16, n_edges=48, n_pe=2, n_iters=4),
}
REDUCED = {
    "gemm": dict(P=2, n=32, K=4),
    "gaussian": dict(h=64, w=64, iters=2),
    "page_rank": dict(n_vertices=1024, n_edges=8192, n_pe=2, n_iters=4),
}
# the ring kernels of the synthesis path; sweep_guards is the guards
# kernel the sweep loop runs, eval_guards (phase 3 only) its counterpart
# of the reference's eval_guards API
REPLACES = {
    "ring_pop": "src/repro/kernels/ring.py:84",
    "ring_push": "src/repro/kernels/ring.py:141",
    "sweep_guards": "src/repro/kernels/ring.py:200",
    # no Pallas kernel: the reference's per-sweep port service in XLA ops
    "service_ports": "src/repro/core/synth.py:951",
}
SWEEP_STATES = 100          # random carries a sweep_guards case checks
ATTN_REPLACES = {
    "flash_attention": "src/repro/kernels/flash_attention.py:45",
    "decode_attention": "src/repro/kernels/decode_attention.py:35",
}
# device kernels of each attention op, as the profiler names them; a bf16
# flash launch runs the tensor-core kernel, and the float32 one (the
# checks' dtype) must never appear on the bf16 serving or training paths
ATTN_KERNELS = {"flash_attention": ("flash_wgmma_kernel",),
                "flash_attention_fp32": ("flash_fwd_kernel",),
                "decode_attention": ("decode_partial_kernel",
                                     "decode_merge_kernel")}


def log(*a) -> None:
    print(*a, flush=True)


REPS, WARM = 200, 20
PROFILE_TRIES = 3            # profiles of one run before a lost record fails


def time_ms(fn, reps: int = REPS, warm: int = WARM) -> float:
    """Mean milliseconds per call over ``reps`` back-to-back calls on the
    current stream, after ``warm`` calls; CUDA events, one sync.  ``fn``
    takes the call's index, ``0 .. warm + reps - 1``."""
    for i in range(warm):
        fn(i)
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for i in range(warm, warm + reps):
        fn(i)
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def bound_ms(nbytes: float, ops: float = 0.0,
             ops_per_s: float = CUDA_CORE_OPS_PER_S) -> tuple[float, str]:
    """The larger of bytes over HBM bandwidth and operations over the
    given peak rate, and which of the two it is."""
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_o = ops / ops_per_s * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


class _Counters:
    """One fresh (head, size) pair per timed call: 0-d int32 views into two
    device vectors, so every call of a ring op starts from a state inside
    its contract (``0 <= size``, ``size + n <= cap`` for a push, ``n <=
    size`` for a pop) with no reset launched between calls."""

    def __init__(self, head: int, size: int, k: int = WARM + REPS):
        self.head, self.size = head, size
        self.heads = torch.full((k,), head, dtype=torch.int32, device="cuda")
        self.sizes = torch.full((k,), size, dtype=torch.int32, device="cuda")
        self.h = self.heads.unbind()
        self.s = self.sizes.unbind()

    def handles(self, buf: torch.Tensor, prime) -> list:
        """One prepared ring handle per timed call, over ``buf`` and that
        call's (head, size): what the sweep's stream views call.  Each has
        run ``prime`` (the timed op) once, as a view's handle has after
        its ring's first firing (a handle keeps per-burst-size launch
        arguments); the counters are then reset."""
        from repro_torch.kernels.ring import RingHandle
        hs = [RingHandle(buf, h, s) for h, s in zip(self.h, self.s)]
        for h in hs:
            prime(h)
        self.heads.fill_(self.head)
        self.sizes.fill_(self.size)
        return hs

    def expect(self, op: str, head: int, size: int) -> None:
        """Raise unless every call left the state the op's contract
        gives."""
        if not (bool((self.heads == head).all())
                and bool((self.sizes == size).all())):
            raise AssertionError(f"{op}: timed calls left head/size other "
                                 f"than ({head}, {size})")


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def _ring(cap, elem, dtype, head, size, gen):
    shape = (cap,) + tuple(elem)
    if dtype == torch.bool:
        buf = torch.rand(shape, generator=gen) > 0.5
    elif dtype == torch.int32:
        buf = torch.randint(-2**31, 2**31 - 1, shape, generator=gen,
                            dtype=torch.int32)
    else:
        buf = torch.randn(shape, generator=gen, dtype=dtype)
    mk = lambda v: torch.tensor(v, dtype=torch.int32)   # noqa: E731
    return buf.cuda(), mk(head).cuda(), mk(size).cuda()


def _max_err(*pairs) -> float:
    """Largest absolute difference over (kernel, plain) tensor pairs
    (bool and int compared as numbers)."""
    err = 0.0
    for a, b in pairs:
        if a.numel():
            d = (a.double() - b.double()).abs().max().item()
            err = max(err, float(d))
    return err


def check_pop_push(case: dict, gen) -> tuple[float, float]:
    """One pop and one push case, kernel vs plain on the card; raises on
    any difference, returns the (pop, push) max abs differences."""
    from repro_torch.kernels import ring
    cap, elem, dt = case["cap"], case["elem"], case["dtype"]
    head, size, n, m = case["head"], case["size"], case["n"], case["push_n"]
    # pop n from a ring holding `size` tokens from `head`
    buf, h, s = _ring(cap, elem, dt, head, size, gen)
    kb, kh, ks = buf.clone(), h.clone(), s.clone()
    pb, ph, ps = buf.clone(), h.clone(), s.clone()
    ktoks, _, _ = ring.ring_pop(kb, kh, ks, n)
    ptoks, _, _ = ring.ring_pop_plain(pb, ph, ps, n)
    torch.cuda.synchronize()
    pairs = [(ktoks, ptoks), (kb, pb), (kh, ph), (ks, ps)]
    pop_err = _max_err(*pairs)
    if not all(torch.equal(a, b) for a, b in pairs):
        raise AssertionError(f"ring_pop differs from plain: {case}")
    # push m into a ring with exactly m free slots from the same head
    buf, h, s = _ring(cap, elem, dt, head, cap - m, gen)
    arr = _ring(max(m, 1), elem, dt, 0, 0, gen)[0][:m]
    kb, kh, ks = buf.clone(), h.clone(), s.clone()
    pb, ph, ps = buf.clone(), h.clone(), s.clone()
    ring.ring_push(kb, kh, ks, arr)
    ring.ring_push_plain(pb, ph, ps, arr)
    torch.cuda.synchronize()
    pairs = [(kb, pb), (kh, ph), (ks, ps)]
    push_err = _max_err(*pairs)
    if not all(torch.equal(a, b) for a, b in pairs):
        raise AssertionError(f"ring_push differs from plain: {case}")
    return pop_err, push_err


CHAINED_OPS = 1200
TIMING_TURNS = 3


def check_chained(cap: int, elem: tuple, dtype, seed: int) -> dict:
    """A seeded sequence of ``CHAINED_OPS`` pops and pushes of mixed sizes
    back to back on ONE ring (the same head/size tensors, no sync in
    between) through the kernels, and the same sequence through the plain
    versions on a copy; tokens, buffer, head and size must be equal.  A
    block of one launch reading a head that another block (or the launch
    before) had not yet settled would show here, and only here: the timed
    calls give every call fresh counters.  Half the pushes read rows at a
    4-byte offset, so the kernel narrows its copy word by the pointer."""
    from repro_torch.kernels import ring
    rng = np.random.default_rng(seed)
    gen = torch.Generator().manual_seed(seed)
    buf, h, s = _ring(cap, elem, dtype, 0, 0, gen)
    pb, ph, ps = buf.clone(), h.clone(), s.clone()
    handle = ring.RingHandle(buf, h, s)
    row = handle.row_bytes
    # pushed rows come from a pool, whole or through a view one element
    # (4 bytes at most) past the pool's start
    pool = _ring(2 * cap + 1, elem, dtype, 0, 0, gen)[0]
    flat = pool.reshape(-1)
    row_elems = flat.numel() // pool.shape[0]
    size, got, want, blocks, narrowed = 0, [], [], set(), 0
    for _ in range(CHAINED_OPS):
        free = cap - size
        if size and (free == 0 or rng.random() < 0.5):
            n = int(rng.integers(1, size + 1))
            got.append(handle.pop(n))
            want.append(ring.ring_pop_plain(pb, ph, ps, n)[0])
            size -= n
        else:
            n = int(rng.integers(1, free + 1))
            j = int(rng.integers(0, cap + 1))
            if rng.random() < 0.5:
                arr = pool[j:j + n]
            else:
                arr = flat[j * row_elems + 1:(j + n) * row_elems + 1] \
                    .view((n,) + tuple(elem))
                narrowed += ring.copy_word(row, buf.data_ptr(),
                                           arr.data_ptr()) < \
                    ring.copy_word(row, buf.data_ptr())
            handle.push(arr)
            ring.ring_push_plain(pb, ph, ps, arr)
            size += n
        blocks.add(ring.cluster_blocks(n * row))
    torch.cuda.synchronize()
    pairs = list(zip(got, want)) + [(buf, pb), (h, ph), (s, ps)]
    if not all(torch.equal(a, b) for a, b in pairs) or int(s) != size:
        raise AssertionError(f"chained ring ops differ from plain: cap={cap} "
                             f"elem={elem} {dtype}")
    return dict(cap=cap, elem=list(elem), dtype=str(dtype), ops=CHAINED_OPS,
                pops=len(got), row_bytes=row, cluster_sizes=sorted(blocks),
                narrowed_pushes=narrowed, max_abs_err=_max_err(*pairs))


def check_guards(T: int, C: int, gen) -> float:
    from repro_torch.kernels import ring
    caps = torch.randint(1, 9, (C,), generator=gen, dtype=torch.int32)
    sizes = (torch.rand(C, generator=gen) * (caps + 1)).to(torch.int32)
    need_r = torch.randint(0, 3, (T, C), generator=gen, dtype=torch.int32)
    need_w = torch.randint(0, 3, (T, C), generator=gen, dtype=torch.int32)
    # most rows need nothing on most channels, as in a real graph
    need_r *= (torch.rand(T, C, generator=gen) < 0.02)
    need_w *= (torch.rand(T, C, generator=gen) < 0.02)
    live = torch.rand(T, generator=gen) < 0.9
    args = [x.cuda() for x in (sizes, caps, need_r, need_w, live)]
    kf = ring.eval_guards(*args)
    pf = ring.eval_guards_plain(*args)
    torch.cuda.synchronize()
    if not torch.equal(kf, pf):
        raise AssertionError(f"eval_guards differs from plain at T={T} "
                             f"C={C}")
    return _max_err((kf, pf))


def _counted_device_ms(fn, kernel: str, op: str, n: int) -> float:
    """:func:`_kernel_device_ms` of ``n`` calls of ``fn``, each of which
    must launch ``op``'s kernel once: its launch counter, which the
    kernel advances on the card, must read ``n`` after the calls.  If the
    profiler shows no launch the calls are profiled once more, and a
    second miss fails the run (the counter says the launches ran)."""
    from repro_torch.kernels.dispatch import launch_counts, reset_launches
    for attempt in (1, 2):
        reset_launches()
        try:
            ms = _kernel_device_ms(fn, kernel, n=n, tries=1)
        except AssertionError as e:
            launched = launch_counts().get(op, 0)
            if attempt == 2 or launched != n:
                raise AssertionError(f"{e} in {n} timed calls (the launch "
                                     f"counter read {launched}), attempt "
                                     f"{attempt}") from e
            log(f"kernels: the profiler saw none of {n} {kernel} launches "
                f"(the counter saw them); profiling them again")
            continue
        launched = launch_counts().get(op, 0)
        if launched != n:
            raise AssertionError(f"{n} timed {op} calls launched its "
                                 f"kernel {launched} times")
        return ms


def _random_plan(rng, n_tasks: int, n_chans: int, n_ph_max: int):
    """A plan-shaped table of ``n_tasks`` tasks of 1..``n_ph_max`` phases,
    each phase reading or writing up to 5 of ``n_chans`` channels (what
    ``_guard_tables`` reads)."""
    from types import SimpleNamespace
    caps = rng.integers(1, 9, n_chans)
    tasks = []
    for _ in range(n_tasks):
        phases = []
        for _ in range(int(rng.integers(1, n_ph_max + 1))):
            reads, writes = {}, {}
            for c in rng.choice(n_chans, size=int(rng.integers(
                    0, min(n_chans, 5) + 1)), replace=False):
                side = reads if rng.random() < 0.5 else writes
                side[int(c)] = int(rng.integers(1, caps[c] + 1))
            phases.append(SimpleNamespace(count=int(rng.integers(1, 5)),
                                          reads=reads, writes=writes))
        bounds = list(np.cumsum([p.count for p in phases]))
        tasks.append(SimpleNamespace(phases=phases, bounds=bounds,
                                     total=int(bounds[-1])))
    return SimpleNamespace(tasks=tasks, channels=[
        SimpleNamespace(capacity=int(c)) for c in caps])


def _sweep_tables(plan) -> dict:
    """The sweep program's tables of a plan, as numpy: what
    ``_SweepProgram`` hands ``SweepGuards``."""
    from repro_torch.core.synth import _guard_tables
    from repro_torch.kernels.ring import sparse_needs
    need_r, need_w, bounds, n_ph = _guard_tables(plan)
    n_tasks = len(plan.tasks)
    if bounds is None:
        bounds = np.zeros((n_tasks, 0), np.int32)
    caps = np.asarray([c.capacity for c in plan.channels], np.int32)
    row_ptr, entries = sparse_needs(need_r, need_w, caps)
    return dict(totals=np.asarray([tp.total for tp in plan.tasks], np.int32),
                bounds=bounds, row_ptr=row_ptr, entries=entries, caps=caps,
                n_ph=n_ph)


def _guard_carry(tab: dict, fires, sizes, state) -> list:
    """``SweepGuards``' arguments on the card: the tables, then a carry
    of its own (sizes, fires, state) and fresh outputs."""
    n_tasks = len(tab["totals"])
    on = lambda a: torch.from_numpy(np.asarray(a, np.int32)).cuda()  # noqa
    return [on(tab[k]) for k in ("totals", "bounds", "row_ptr",
                                 "entries")] + [
        on(sizes), on(fires), on(state),
        torch.zeros((n_tasks, tab["n_ph"]), dtype=torch.bool, device="cuda"),
        torch.zeros(n_tasks, dtype=torch.bool, device="cuda"),
        torch.zeros(n_tasks, dtype=torch.int32, device="cuda")]


def _guard_state(rng, tab: dict, how: str) -> tuple:
    how = how.split("+")[0]
    totals, caps = tab["totals"], tab["caps"]
    fires = totals.copy() if how == "dead" else rng.integers(0, totals + 1)
    sizes = rng.integers(0, caps + 1)
    if rng.random() < 0.5:              # rings empty or full, as a run has
        sizes = np.where(rng.random(len(caps)) < 0.5, 0, caps)
    return fires, sizes, [int(how == "done"), int(rng.integers(0, 100))]


def _owner_mask(rng, tab: dict, parts: int = 2) -> tuple:
    """A partition's owner mask (the tasks of partition 0 of ``parts``,
    drawn at random) and heads inside each ring, as numpy."""
    owned = rng.integers(0, parts, len(tab["totals"])) == 0
    return owned, rng.integers(0, np.maximum(tab["caps"], 1))


def _mask_args(mask) -> dict:
    """``owned``/``heads`` keyword arguments of ``sweep_guards`` on the card,
    a copy of their own (none without a mask)."""
    if mask is None:
        return {}
    return dict(owned=torch.from_numpy(mask[0]).cuda(),
                heads=torch.from_numpy(mask[1].astype(np.int32)).cuda())


def check_sweep_guards(tag: str, tab: dict, how: str, seed: int) -> dict:
    """``SWEEP_STATES`` random carries through the kernel and through the
    plain version on the card, every output and the carry compared
    exactly; then one carry through 40 launches back to back (the kernel
    reading what it wrote, no sync between) against 40 plain calls.  With
    ``+owned`` each carry also has a partition's owner mask and heads: the
    heads and sizes the kernel moves for the tasks fired elsewhere are
    compared too."""
    from repro_torch.kernels import ring
    rng = np.random.default_rng(seed)
    fired = 0
    flags = lambda: [torch.zeros(2, dtype=torch.int32, device="cuda")] \
        if how.endswith("+flags") else []     # noqa: E731
    owned = how.endswith("+owned")
    for _ in range(SWEEP_STATES):
        st = _guard_state(rng, tab, how)
        mask = _owner_mask(rng, tab) if owned else None
        k, p = _guard_carry(tab, *st) + flags(), _guard_carry(tab, *st) + \
            flags()
        km, pm = _mask_args(mask), _mask_args(mask)
        ring.sweep_guards(*k, **km)
        ring.sweep_guards_plain(*p, **pm)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(
                k + list(km.values()), p + list(pm.values()))):
            raise AssertionError(f"sweep_guards differs from plain: {tag}, "
                                 f"{how}")
        fired += int(k[8].sum())
    st = _guard_state(rng, tab, how)
    mask = _owner_mask(rng, tab) if owned else None
    k, p = _guard_carry(tab, *st) + flags(), _guard_carry(tab, *st) + flags()
    km, pm = _mask_args(mask), _mask_args(mask)
    handle = ring.SweepGuards(*k, **km)
    for _ in range(40):
        handle()
        ring.sweep_guards_plain(*p, **pm)
    torch.cuda.synchronize()
    k, p = k + list(km.values()), p + list(pm.values())
    if not all(torch.equal(a, b) for a, b in zip(k, p)):
        raise AssertionError(f"40 chained sweep_guards launches differ from "
                             f"plain: {tag}, {how}")
    n_tasks, n_ph = len(tab["totals"]), tab["n_ph"]
    return dict(case=tag, carries=how, tasks=n_tasks, phases=n_ph,
                channels=len(tab["caps"]), nnz=len(tab["entries"]),
                fired=fired, chained_sweeps=int(k[6][1]), max_abs_err=0.0)


def _guard_fire(tab: dict, fires, sizes) -> tuple:
    """The guards on this carry (done not set), as numpy: each task's
    fire predicate and its row's entries ``[chan, need_r, need_w, cap]``."""
    n_ph, row_ptr, ent = tab["n_ph"], tab["row_ptr"], tab["entries"]
    ph = (fires[:, None] >= tab["bounds"]).sum(1)
    rows = [ent[row_ptr[r]:row_ptr[r + 1]]
            for r in np.arange(len(fires)) * n_ph + ph]
    fire = np.array([f < tot and bool(np.all(
        (e[:, 1] <= sizes[e[:, 0]]) & (e[:, 2] <= e[:, 3] - sizes[e[:, 0]])))
        for f, tot, e in zip(fires, tab["totals"], rows)], bool)
    return fire, rows


def _guard_work(tab: dict, fires, sizes, owned=None) -> tuple[int, int]:
    """Bytes and integer operations one ``sweep_guards`` call needs on
    this carry: each live task reads its counter, total, bounds, its
    row's two offsets, entries and the sizes they name; every task writes
    its fire, phase and run row, a fired one its counter.  Under an owner
    mask each task that fires reads its mask byte, and each fired task it
    does not own moves the heads and sizes of its row's entries, as the
    guards on this carry decide: each head it moves read and written
    once, each size it moves written (the guards read it already), an
    add for each head and each size moved and a modulo for each head."""
    n_tasks, n_ph = len(tab["totals"]), tab["n_ph"]
    live = fires < tab["totals"]
    fire, rows = _guard_fire(tab, fires, sizes)
    nnz = sum(len(e) for e, lv in zip(rows, live) if lv)
    nbytes = (n_tasks * (4 + 4 + 4 * (n_ph - 1) + 8) + 20 * nnz + 4
              + n_tasks * (n_ph + 1 + 4) + 4 * n_tasks + 8)
    ops = n_tasks * (n_ph - 1) + 3 * nnz + 3 * n_tasks
    if owned is not None:
        moved = [e for e, away in zip(rows, fire & ~owned) if away]
        moved = np.concatenate(moved) if moved else np.zeros((0, 4), int)
        heads = moved[moved[:, 1] > 0]
        sized = moved[moved[:, 2] != moved[:, 1]]
        nbytes += (int(fire.sum()) + 8 * len(set(heads[:, 0]))
                   + 4 * len(set(sized[:, 0])))
        ops += 2 * len(heads) + len(sized)
    return nbytes, ops


def sweep_guard_phase(timing: dict) -> list:
    """Phase 3's sweep_guards part: the kernel against its plain version
    at the main path's tables (gemm at full size: 88 tasks, 192 channels,
    2 phases; gaussian's 3-phase stencils), with every task dead, with
    the done flag set, at T = 1 and T = 1000; its times at gemm's tables
    (per call through a prepared handle, device time a launch, plain
    version), each timed call on a carry of its own."""
    from repro_torch.apps import APPS
    from repro_torch.core.synth import elaborate_step_graph
    from repro_torch.kernels import ring
    tabs = {}
    for name in ("gemm", "gaussian"):
        top, args, _ = APPS[name].build_step(device="cuda", **FULL[name])
        tabs[name] = _sweep_tables(elaborate_step_graph(top, *args)[0])
    rng = np.random.default_rng(7)
    tabs["T=1"] = _sweep_tables(_random_plan(rng, 1, 3, 3))
    tabs["T=1000"] = _sweep_tables(_random_plan(rng, 1000, 600, 3))
    checks = [check_sweep_guards(tag, tabs[tag], how, seed)
              for seed, (tag, how) in enumerate([
                  ("gemm", "random"), ("gaussian", "random"),
                  ("gemm", "dead"), ("gemm", "done"), ("T=1", "random"),
                  ("T=1000", "random"), ("T=1000", "done"),
                  ("gemm", "random+flags"), ("gemm", "done+flags"),
                  ("gemm", "random+owned"), ("gaussian", "random+owned"),
                  ("T=1000", "random+owned")])]
    for c in checks:
        log(f"kernels: sweep_guards exact at {c['case']} ({c['tasks']} tasks "
            f"x {c['phases']} phases, {c['channels']} channels, {c['nnz']} "
            f"entries), {c['carries']} carries: {SWEEP_STATES} carries "
            f"({c['fired']} firings) and 40 chained launches")
    tab = tabs["gemm"]
    st = _guard_state(np.random.default_rng(11), tab, "random")
    n = WARM + REPS
    hs = [ring.SweepGuards(*_guard_carry(tab, *st)) for _ in range(n)]
    ms = time_ms(lambda i: hs[i]())
    hs = [ring.SweepGuards(*_guard_carry(tab, *st)) for _ in range(n)]
    dev = _counted_device_ms(lambda i: hs[i](), "sweep_guards_kernel",
                             "sweep_guards", n)
    ps = [_guard_carry(tab, *st) for _ in range(60)]
    plain = time_ms(lambda i: ring.sweep_guards_plain(*ps[i]), reps=50,
                    warm=10)
    nb, ops = _guard_work(tab, st[0], st[1])
    bnd, by = bound_ms(nb, ops)
    shape = (f"gemm {len(tab['totals'])} tasks x {tab['n_ph']} phases, "
             f"{len(tab['caps'])} channels")
    timing["sweep_guards"] = [dict(
        shape=shape, ms=ms, device_ms=dev, plain_ms=plain, library_ms=None,
        bound_ms=bnd, bound_by=by, bytes=nb, ops=ops)]
    # with a partition's owner mask (phase 26's launches): the moves of the
    # tasks fired elsewhere on top, each timed call on a carry of its own
    mask = _owner_mask(np.random.default_rng(12), tab)
    hs = [ring.SweepGuards(*_guard_carry(tab, *st), **_mask_args(mask))
          for _ in range(n)]
    ms = time_ms(lambda i: hs[i]())
    hs = [ring.SweepGuards(*_guard_carry(tab, *st), **_mask_args(mask))
          for _ in range(n)]
    dev = _counted_device_ms(lambda i: hs[i](), "sweep_guards_kernel",
                             "sweep_guards", n)
    ps = [(_guard_carry(tab, *st), _mask_args(mask)) for _ in range(60)]
    plain = time_ms(lambda i: ring.sweep_guards_plain(*ps[i][0], **ps[i][1]),
                    reps=50, warm=10)
    nb_m, ops_m = _guard_work(tab, st[0], st[1], mask[0])
    bnd, by = bound_ms(nb_m, ops_m)
    timing["sweep_guards"].append(dict(
        shape=shape + ", owner mask", ms=ms, device_ms=dev, plain_ms=plain,
        library_ms=None, bound_ms=bnd, bound_by=by, bytes=nb_m, ops=ops_m))
    return checks


# (tag, ports as (depth, row shape, dtype, rows), what the carries stress)
SERVICE_CASES = [
    ("8 B rows, depths 1/4/8", [(1, (2,), torch.int32, 32),
                                (4, (2,), torch.int32, 32),
                                (8, (2,), torch.int32, 32)], "random"),
    ("256 KiB rows", [(4, (256, 256), torch.float32, 4),
                      (8, (256, 256), torch.float32, 3)], "random"),
    ("responses full", [(1, (2,), torch.int32, 8),
                        (4, (5, 3), torch.float32, 6),
                        (8, (256, 256), torch.float32, 2)], "full"),
    ("clipped addresses", [(4, (2,), torch.int32, 5),
                           (8, (7,), torch.bool, 9)], "clip"),
    ("no value tokens", [(4, (2,), torch.int32, 8),
                         (1, (256, 256), torch.float32, 2)], "novalue"),
    ("odd rows", [(8, (7,), torch.bool, 9), (1, (5, 3), torch.float32, 6),
                  (4, (3, 13001), torch.bool, 3)], "random"),
    ("done", [(4, (2,), torch.int32, 8), (4, (256, 256), torch.float32, 2)],
     "done"),
]
SERVICE_STATES = 40         # random carries a service_ports case checks
SERVICE_EXTRA_CHANNELS = 3  # channels no port owns (the maxocc sample)


def _rows(rng, shape, dtype) -> torch.Tensor:
    if dtype == torch.bool:
        return torch.from_numpy(rng.random(shape) < 0.5)
    if dtype == torch.int32:
        return torch.from_numpy(rng.integers(-2**31, 2**31 - 1, shape,
                                             dtype=np.int32))
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))


def _service_carry(rng, ports: list, how: str) -> dict:
    """A random carry of ``ports`` ((depth, row, dtype, rows) each) on the
    CPU: the rings of port k are channels 5k .. 5k + 4, then
    ``SERVICE_EXTRA_CHANNELS`` of no port; windows of any size with dues
    from 3 sweeps past to 5 ahead of the counter, addresses a few rows out
    of range (``clip``: a thousand), response rings full (``full``), write
    addresses with no value token (``novalue``), the done flag set
    (``done``)."""
    n_ch = 5 * len(ports) + SERVICE_EXTRA_CHANNELS
    caps = rng.integers(1, 7, n_ch)
    heads = rng.integers(0, caps)
    sizes = rng.integers(0, caps + 1)
    bufs = {c: torch.zeros(int(caps[c]), dtype=torch.int32)
            for c in range(len(ports) * 5, n_ch)}
    sweeps = int(rng.integers(0, 60))
    far = 1000 if how == "clip" else 3
    out = []
    for k, (d, row, dt, nrow) in enumerate(ports):
        ra, rd, wa, wd, wr = range(5 * k, 5 * k + 5)
        if how == "full":
            sizes[rd], sizes[wr] = caps[rd], caps[wr]
        if how == "novalue":
            sizes[wd], sizes[wa] = 0, max(1, sizes[wa])
        addr = lambda *n: torch.from_numpy(   # noqa: E731
            rng.integers(-far, nrow + far, n).astype(np.int32))
        bufs[ra], bufs[wa] = addr(int(caps[ra])), addr(int(caps[wa]))
        bufs[rd] = _rows(rng, (int(caps[rd]), *row), dt)
        bufs[wd] = _rows(rng, (int(caps[wd]), *row), dt)
        bufs[wr] = torch.from_numpy(rng.random(int(caps[wr])) < 0.5)
        st = rng.integers(0, 100, 10).astype(np.int32)
        st[[0, 2]] = rng.integers(0, d, 2)              # heads
        st[[1, 3]] = rng.integers(0, d + 1, 2)          # sizes
        st[[8, 9]] = rng.integers(0, d + 1, 2)          # highwater marks
        win = np.stack([rng.integers(-far, nrow + far, d),
                        sweeps + rng.integers(-3, 6, d),
                        rng.integers(-far, nrow + far, d),
                        sweeps + rng.integers(-3, 6, d)]).astype(np.int32)
        out.append(dict(depth=d, latency=int(rng.integers(0, 6)),
                        chans=(ra, rd, wa, wd, wr),
                        data=_rows(rng, (nrow, *row), dt),
                        wval=_rows(rng, (d, *row), dt),
                        st=torch.from_numpy(st), win=torch.from_numpy(win)))
    i32 = lambda a: torch.from_numpy(np.asarray(a, np.int32))  # noqa: E731
    return dict(ports=out, bufs=bufs, heads=i32(heads), sizes=i32(sizes),
                maxocc=i32(rng.integers(0, 8, n_ch)),
                state=i32([int(how == "done"), sweeps]),
                flags=i32(rng.integers(0, 2, 2)))


def _service_on(carry: dict, device: str = "cuda"):
    """``ServicePorts`` over a copy of ``carry`` on ``device``, and every
    tensor it reads or writes."""
    from repro_torch.kernels import ring
    on = lambda t: t.clone().to(device)  # noqa: E731
    pint = torch.stack([q["st"] for q in carry["ports"]]).to(device)
    qs = []
    for k, q in enumerate(carry["ports"]):
        pq = ring.PortQueue(on(q["data"]), pint[k], q["chans"], q["depth"],
                            q["latency"])
        pq.win.copy_(q["win"])
        pq.wval.copy_(q["wval"])
        qs.append(pq)
    bufs = {c: on(b) for c, b in carry["bufs"].items()}
    args = [on(carry[k]) for k in ("heads", "sizes", "maxocc", "state",
                                   "flags")]
    svc = ring.ServicePorts(qs, bufs, *args)
    tensors = [pint, *args] + [bufs[c] for c in sorted(bufs)] + \
        [x for q in qs for x in (q.data, q.win, q.wval)]
    return svc, tensors


def check_service_ports(tag: str, ports: list, how: str, seed: int) -> dict:
    """``SERVICE_STATES`` random carries through the kernel and through the
    plain version on the card, every tensor compared exactly (and the
    kernel's scratch back at zero); then one carry through 40 launches
    back to back, the kernel reading what it wrote, against 40 plain
    calls."""
    from repro_torch.kernels.ring import service_ports_plain
    rng = np.random.default_rng(seed)
    moved = 0
    for k in range(SERVICE_STATES + 1):
        carry = _service_carry(rng, ports, how)
        chain = k == SERVICE_STATES
        if chain:                           # every sweep fires: no end
            carry["flags"].fill_(1)
        kern, kt = _service_on(carry)
        plain, pt = _service_on(carry)
        for _ in range(40 if chain else 1):
            kern()
            service_ports_plain(plain.ports, plain.bufs, *plain.args)
        torch.cuda.synchronize()
        bad = [i for i, (a, b) in enumerate(zip(kt, pt))
               if not torch.equal(a, b)]
        if bad or kern.scratch.any():
            raise AssertionError(f"service_ports differs from plain: {tag}, "
                                 f"{how}, carry {k}, tensors {bad}, scratch "
                                 f"{kern.scratch.tolist()}")
        moved += int(not torch.equal(kt[0].cpu(), torch.stack(
            [q["st"] for q in carry["ports"]])))
    return dict(case=tag, carries=how, ports=len(ports),
                depths=[d for d, *_ in ports],
                rows=[f"{tuple(r)} {str(dt).split('.')[-1]}"
                      for _, r, dt, _ in ports],
                carries_that_moved=moved, blocks=kern.blocks,
                max_abs_err=0.0)


def _gemm_service_carries(n: int):
    """``n`` carries of gemm's 16 ports at full width (P=8, n=256, K=16,
    depth 4, latency 4; 280 channels), each in the steady state of a
    sweep: every read window full with one request due, one address
    queued; every write window full with one due, one address and one
    value queued.  The buffers are shared, the counters are each call's
    own.  Returns the ``ServicePorts`` and the bytes a call moves."""
    from repro_torch.kernels import ring
    P, nb, K, d, C = 8, 256, 16, 4, 280
    f32, i32 = torch.float32, dict(dtype=torch.int32, device="cuda")
    blk = (nb, nb)
    datas = [torch.randn((K, *blk), device="cuda") for _ in range(P)] + \
        [torch.zeros((P, *blk), device="cuda") for _ in range(P)]
    rows = {5 * k + r: torch.zeros((d, *blk), dtype=f32, device="cuda")
            for k in range(2 * P) for r in (1, 3)}
    toks = {5 * k + r: torch.zeros(d, **i32) for k in range(2 * P)
            for r in (0, 2)}
    acks = {5 * k + 4: torch.zeros(d, dtype=torch.bool, device="cuda")
            for k in range(2 * P)}
    bufs = {**rows, **toks, **acks}
    bufs.update({c: torch.zeros(2, **i32) for c in range(5 * 2 * P, C)})
    wvals = [torch.zeros((d, *blk), dtype=f32, device="cuda")
             for _ in range(2 * P)]
    sweeps = 100
    out = []
    for _ in range(n):
        sizes = torch.zeros(C, **i32)
        pint = torch.zeros((2 * P, ring.PORT_WORDS), **i32)
        qs = []
        for k in range(2 * P):
            q = ring.PortQueue(datas[k], pint[k], range(5 * k, 5 * k + 5), d,
                               4)
            q.wval = wvals[k]
            due = sweeps + torch.arange(d, **i32)
            if k < P:                       # A ports: reads
                pint[k, ring.P_RSIZE] = d
                q.win[0] = torch.arange(d, **i32)
                q.win[1] = due
                sizes[5 * k] = 1
            else:                           # C ports: writes
                pint[k, ring.P_WSIZE] = d
                q.win[2] = torch.arange(d, **i32)
                q.win[3] = due
                sizes[5 * k + 2] = sizes[5 * k + 3] = 1
            qs.append(q)
        out.append(ring.ServicePorts(
            qs, bufs, torch.zeros(C, **i32), sizes, torch.zeros(C, **i32),
            torch.tensor([0, sweeps], **i32), torch.ones(2, **i32)))
    row = nb * nb * 4
    copies = P * 1 + P * 2          # a read delivery; a write delivery and
    #                                 an acceptance
    words = 2 * P * (2 * 10 + 2 * 4 * d + 2 * 2 * 5) + 3 * C + 2 * 2 + 2
    return out, copies * 2 * row + 4 * words


def service_ports_phase(timing: dict) -> list:
    """Phase 3's service_ports part: the kernel against its plain version
    on random carries (``SERVICE_CASES``), and its times at gemm's full
    width (a call through a prepared handle, device time a launch, plain
    version) beside its bound."""
    checks = [check_service_ports(tag, ports, how, seed)
              for seed, (tag, ports, how) in enumerate(SERVICE_CASES)]
    for c in checks:
        log(f"kernels: service_ports exact at {c['case']} ({c['ports']} "
            f"ports, depths {c['depths']}, rows {c['rows']}, clusters of "
            f"{c['blocks']}), {c['carries']} carries: {SERVICE_STATES} "
            f"carries and 40 chained launches")
    n = WARM + REPS
    hs, nb = _gemm_service_carries(n)
    ms = time_ms(lambda i: hs[i]())
    hs, _ = _gemm_service_carries(n)
    dev = _counted_device_ms(lambda i: hs[i](), "service_ports_kernel",
                             "service_ports", n)
    hs, _ = _gemm_service_carries(30)
    from repro_torch.kernels.ring import service_ports_plain
    plain = time_ms(lambda i: service_ports_plain(hs[i].ports, hs[i].bufs,
                                                  *hs[i].args),
                    reps=20, warm=10)
    if not all(int(h.args[3][1]) == 101 for h in hs):
        raise AssertionError("service_ports: a timed call did not count its "
                             "sweep")
    bnd, by = bound_ms(nb)
    timing["service_ports"] = [dict(
        shape="gemm 16 ports of 256 KiB rows, depth 4, 280 channels",
        ms=ms, device_ms=dev, plain_ms=plain, library_ms=None, bound_ms=bnd,
        bound_by=by, bytes=nb)]
    return checks


def kernel_phase() -> tuple[dict, dict, list]:
    from repro_torch.kernels import ring
    gen = torch.Generator().manual_seed(0)
    f32, i32, b = torch.float32, torch.int32, torch.bool
    cases = [
        # main-path shapes: gemm a/b rings, gemm c rings, gaussian rows,
        # page_rank rank vectors
        dict(tag="gemm a/b", cap=2, elem=(256, 256), dtype=f32, head=1,
             size=1, n=1, push_n=1),
        dict(tag="gemm c", cap=1, elem=(256, 256), dtype=f32, head=0,
             size=1, n=1, push_n=1),
        dict(tag="gaussian", cap=4096, elem=(), dtype=f32, head=2048,
             size=2048, n=2048, push_n=2048),
        dict(tag="page_rank", cap=1, elem=(65536,), dtype=f32, head=0,
             size=1, n=1, push_n=1),
        # edge cases the main path never reaches at these sizes
        dict(tag="wrap", cap=5, elem=(3,), dtype=f32, head=3, size=5, n=4,
             push_n=4),
        dict(tag="wrap int32", cap=7, elem=(2, 3), dtype=i32, head=5,
             size=6, n=6, push_n=6),
        dict(tag="wrap bool", cap=7, elem=(2, 3), dtype=b, head=6, size=7,
             n=7, push_n=7),
        dict(tag="n=cap", cap=8, elem=(5,), dtype=f32, head=0, size=8,
             n=8, push_n=8),
        dict(tag="cap=1", cap=1, elem=(), dtype=i32, head=0, size=1, n=1,
             push_n=1),
        dict(tag="bool scalar", cap=9, elem=(), dtype=b, head=4, size=9,
             n=9, push_n=9),
        # bursts that make the blocks of a cluster share the copy: a wrap
        # of 2 MiB rows (8 blocks, many passes), odd row bytes (byte
        # words over 5 blocks), n == cap with 256 KiB rows
        dict(tag="wrap wide", cap=3, elem=(512, 1024), dtype=f32, head=2,
             size=3, n=3, push_n=3),
        dict(tag="odd rows", cap=5, elem=(3, 13001), dtype=b, head=3,
             size=5, n=4, push_n=4),
        dict(tag="n=cap 256K", cap=4, elem=(256, 256), dtype=f32, head=3,
             size=4, n=4, push_n=4),
    ]
    errs = {"ring_pop": 0.0, "ring_push": 0.0, "sweep_guards": 0.0,
            "service_ports": 0.0, "eval_guards": 0.0}
    for c in cases:
        e_pop, e_push = check_pop_push(c, gen)
        errs["ring_pop"] = max(errs["ring_pop"], e_pop)
        errs["ring_push"] = max(errs["ring_push"], e_push)
    log(f"kernels: ring_pop/ring_push exact on {len(cases)} cases "
        f"({', '.join(c['tag'] for c in cases)})")
    chained = [check_chained(8, (64, 256), f32, seed=3),   # 64 KiB rows
               check_chained(6, (7, 1111), b, seed=4)]     # 7,777-byte rows
    for r in chained:
        for op in ("ring_pop", "ring_push"):
            errs[op] = max(errs[op], r["max_abs_err"])
        log(f"kernels: {r['ops']} chained ring ops ({r['pops']} pops) on one "
            f"ring, cap {r['cap']} x {r['elem']} {r['dtype']} "
            f"({r['row_bytes']} B rows; clusters of {r['cluster_sizes']} "
            f"blocks; {r['narrowed_pushes']} pushes at a narrower word): "
            f"exact")
    n_tasks, n_chans = 8 + 8 + 64 + 8, 3 * 64     # gemm P=8
    for T, C in [(n_tasks, n_chans), (6, 5), (1, 1), (33, 70), (4, 0)]:
        errs["eval_guards"] = max(errs["eval_guards"],
                                  check_guards(T, C, gen))
    log(f"kernels: eval_guards exact at T x C = {n_tasks} x {n_chans}, "
        f"6x5, 1x1, 33x70, 4x0")

    # times at the main path's shapes; every timed call gets its own
    # in-contract head/size (a pop from `size` tokens, a push into exactly
    # n free slots), checked again after the timing
    timing = {"ring_pop": [], "ring_push": [], "eval_guards": []}
    guard_checks = sweep_guard_phase(timing)
    service_checks = service_ports_phase(timing)
    for c in cases[:4]:
        cap, head, size, n = c["cap"], c["head"], c["size"], c["n"]
        buf = _ring(cap, c["elem"], c["dtype"], 0, 0, gen)[0]
        row = buf[0].numel() * buf.element_size()
        idx = ((head + torch.arange(n)) % cap).cuda()
        arr = buf[:n].clone()
        nb = 2 * n * row + 16           # rows in + out, head/size r+w
        bnd, by = bound_ms(nb)
        # ring_pop / ring_push eager: a prepared handle per timed call, as
        # the sweep's stream views call them at capture, in turns with the
        # library call (the host's clock drifts within a run: the median of
        # TIMING_TURNS each); *_public: the functions, a handle built a call
        turns = {k: [] for k in ("ring_pop", "index_select", "ring_push",
                                 "index_copy_")}
        for _ in range(TIMING_TURNS):
            st = _Counters(head, size)
            hs = st.handles(buf, lambda h: h.pop(n))
            turns["ring_pop"].append(time_ms(lambda i: hs[i].pop(n)))
            st.expect("ring_pop", (head + n) % cap, size - n)
            turns["index_select"].append(
                time_ms(lambda i: buf.index_select(0, idx)))
            st = _Counters(head, cap - n)
            hs = st.handles(buf, lambda h: h.push(arr))
            turns["ring_push"].append(time_ms(lambda i: hs[i].push(arr)))
            st.expect("ring_push", head, cap)
            turns["index_copy_"].append(
                time_ms(lambda i: buf.index_copy_(0, idx, arr)))
            del hs
        times = {k: float(np.median(v)) for k, v in turns.items()}
        st = _Counters(head, size)
        hs = st.handles(buf, lambda h: h.pop(n))
        times["ring_pop_device"] = _counted_device_ms(
            lambda i: hs[i].pop(n), "ring_pop_kernel", "ring_pop",
            WARM + REPS)
        st = _Counters(head, cap - n)
        hs = st.handles(buf, lambda h: h.push(arr))
        times["ring_push_device"] = _counted_device_ms(
            lambda i: hs[i].push(arr), "ring_push_kernel", "ring_push",
            WARM + REPS)
        del hs
        for op, fn in (("ring_pop_public", ring.ring_pop),
                       ("ring_pop_plain", ring.ring_pop_plain)):
            st = _Counters(head, size)
            times[op] = time_ms(lambda i: fn(buf, st.h[i], st.s[i], n))
            st.expect(op, (head + n) % cap, size - n)
        for op, fn in (("ring_push_public", ring.ring_push),
                       ("ring_push_plain", ring.ring_push_plain)):
            st = _Counters(head, cap - n)
            times[op] = time_ms(lambda i: fn(buf, st.h[i], st.s[i], arr))
            st.expect(op, head, cap)
        blocks = ring.cluster_blocks(n * row)
        for op, lib in (("ring_pop", "index_select"),
                        ("ring_push", "index_copy_")):
            timing[op].append(dict(
                shape=c["tag"], n=n, cap=cap, row_bytes=row, blocks=blocks,
                ms=times[op], device_ms=times[f"{op}_device"],
                public_ms=times[f"{op}_public"],
                plain_ms=times[f"{op}_plain"], library_ms=times[lib],
                turns_ms=turns[op], library_turns_ms=turns[lib],
                bound_ms=bnd, bound_by=by))
    T, C = n_tasks, n_chans
    g = torch.Generator().manual_seed(1)
    caps = torch.full((C,), 2, dtype=torch.int32)
    args = [x.cuda() for x in (
        torch.randint(0, 3, (C,), generator=g, dtype=torch.int32), caps,
        torch.randint(0, 2, (T, C), generator=g, dtype=torch.int32),
        torch.randint(0, 2, (T, C), generator=g, dtype=torch.int32),
        torch.ones(T, dtype=torch.bool))]
    nb = 2 * T * C * 4 + 2 * C * 4 + 2 * T
    bnd, by = bound_ms(nb, ops=4 * T * C)
    timing["eval_guards"].append(dict(
        shape=f"gemm T x C = {T} x {C}",
        ms=time_ms(lambda i: ring.eval_guards(*args)),
        plain_ms=time_ms(lambda i: ring.eval_guards_plain(*args)),
        library_ms=None, bound_ms=bnd, bound_by=by))
    for k, rows in timing.items():
        for r in rows:
            log(f"time {k:11s} {r['shape']:24s} eager {r['ms']*1e3:8.2f} us"
                + (f" (device {r['device_ms']*1e3:.3f} us)"
                   if r.get("device_ms") is not None else "")
                + f"  plain {r['plain_ms']*1e3:8.2f} us  library "
                + (f"{r['library_ms']*1e3:8.2f} us" if r["library_ms"]
                   is not None else "    none")
                + f"  bound {r['bound_ms']*1e3:7.3f} us ({r['bound_by']})"
                + (f"  public fn {r['public_ms']*1e3:8.2f} us, "
                   f"{r['blocks']} block(s)" if "public_ms" in r else ""))
    return timing, errs, dict(chained_ring_ops=chained,
                              sweep_guards=guard_checks,
                              service_ports=service_checks)


# ---------------------------------------------------------------------------
# phases 4 and 5: the main path, and twin vs compiled
# ---------------------------------------------------------------------------

def _graphs() -> list:
    """(tag, app, builder, parameters) of every graph phase 4 runs: the
    step-form apps, then the async-port ones."""
    return [(name, name, "build_step", kw) for name, kw in FULL.items()] + \
        [(f"{name}_async", name, "build_step_async", kw)
         for name, kw in FULL_ASYNC.items()]


def _port_stats(rep) -> list:
    return [(name, stats) for name, kind, stats in rep.interfaces
            if kind == "async_mmap"]


def main_path() -> tuple[dict, dict]:
    """Each graph at full size (the async page_rank cut) through its
    builder and the compiled engine, as ``run_step`` runs it (build, run,
    ``check()``), with the engine kept for its counts: the run must go
    through the captured sweep (replays, at most one host sync a block and
    one final read).  The ring kernels count their own launches on the
    card: ``sweep_guards`` must have launched once a replay,
    ``ring_pop``/``ring_push`` as often as the run's firings popped and
    pushed (``eng.ring_ops``), each at least once, and ``service_ports``
    once a replay in a graph with ports and never in one without."""
    from repro_torch import ENGINES
    from repro_torch.apps import APPS
    from repro_torch.kernels.dispatch import launch_counts, reset_launches
    per_app = {}
    reset_launches()
    for tag, name, builder, kw in _graphs():
        ports = builder == "build_step_async"
        before = launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        top, args, check = getattr(APPS[name], builder)(device="cuda", **kw)
        eng = ENGINES["compiled"](device="cuda")
        rep = eng.run(top, *args)
        correct, max_err = check() if rep.ok else (False, float("nan"))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        after = launch_counts()
        launches = {k: after.get(k, 0) - before.get(k, 0)
                    for k in REPLACES}
        if not (rep.ok and correct):
            raise AssertionError(f"{tag}: run failed or check() failed: "
                                 f"{rep.error} correct={correct} "
                                 f"err={max_err}")
        for k, v in launches.items():
            if v <= 0 and (ports or k != "service_ports"):
                raise AssertionError(f"{tag}: its run never launched {k}: "
                                     f"{launches}")
        if not (eng.n_replays > 0 and eng.n_host_syncs <= eng.n_blocks + 1):
            raise AssertionError(
                f"{tag}: not the captured sweep: {eng.n_replays} replays, "
                f"{eng.n_blocks} blocks, {eng.n_host_syncs} host syncs")
        steps = [inst.fn for inst in eng.instances
                 if getattr(inst.fn, "is_step_task", False)]
        bodies = sum(len(fn.phases()) for fn in steps)
        if eng.n_graph_nodes != 1 + bodies + ports:
            raise AssertionError(f"{tag}: a sweep graph of {eng.n_graph_nodes}"
                                 f" nodes; the guards, {bodies} bodies and "
                                 f"{int(ports)} port service make "
                                 f"{1 + bodies + ports}")
        want = dict(eng.ring_ops, sweep_guards=eng.n_replays,
                    service_ports=eng.n_replays if ports else 0)
        if launches != want:
            raise AssertionError(
                f"{tag}: the kernels counted {launches} launches on the "
                f"card; the run's replays and firings make {want}")
        sweeps = rep.switches
        per_app[tag] = dict(params=kw, check=bool(correct),
                            max_err=max_err, sweeps=sweeps, wall_s=wall,
                            sweeps_per_s=sweeps / wall, launches=launches,
                            capture_s=eng.capture_s, program_s=eng.program_s,
                            host_ms_per_sweep=eng.program_s / sweeps * 1e3,
                            tasks=len(steps), channels=rep.n_channels,
                            replays=eng.n_replays, blocks=eng.n_blocks,
                            host_syncs=eng.n_host_syncs,
                            graph_nodes=eng.n_graph_nodes,
                            port_stats=_port_stats(rep))
        log(f"main {tag}: check {correct} max_err {max_err:.3e} "
            f"sweeps {sweeps} wall {wall:.3f} s "
            f"({sweeps / wall:.1f} sweeps/s; "
            f"{eng.program_s / sweeps * 1e3:.3f} host ms a sweep) capture "
            f"{eng.capture_s:.3f} s, "
            f"{eng.n_replays} replays in {eng.n_blocks} blocks, "
            f"{eng.n_host_syncs} host syncs, a graph of {eng.n_graph_nodes} "
            f"nodes ({len(steps)} tasks, {rep.n_channels} channels); "
            f"launches {launches} (counted on the card; == replays and the "
            f"firings' ring ops)")
    return per_app, launch_counts()


def _async_outputs(name: str, args) -> torch.Tensor:
    if name == "gemm":
        return torch.stack([p.data for p in args[2]])
    return args[1].data


def _schedule(rep, eng) -> tuple:
    """What a compiled run's schedule must equal exactly across devices:
    sweeps, each task's end state, channel tokens and highwater marks, the
    ports' request counters."""
    import re
    return (rep.switches, re.sub(r"#\d+", "", repr(rep.instances)),
            rep.channels, sorted(
        (c.name, c.total_read, c.total_written, c.max_occupancy)
        for c in eng.channel_set), _port_stats(rep))


def async_vs_cpu() -> dict:
    """Each async-port graph of phase 4 again on the card, with the device
    time a sweep in the sweep's graphs (``CompiledEngine.graph_device_s``:
    the program's CUDA events around each block of replays), and on the
    CPU (the plain versions): the schedule (sweeps,
    fires, channel stats, port counters) equal, the outputs within
    ``CPU_REL_TOL`` of the CPU's and ``REF_REL_TOL`` of the reference
    (relative to max |out|)."""
    from repro_torch import ENGINES
    from repro_torch.apps import APPS
    out = {}
    for name, kw in FULL_ASYNC.items():
        runs = {}
        for dev in ("cuda", "cpu"):
            top, args, check = APPS[name].build_step_async(device=dev, **kw)
            eng = ENGINES["compiled"](device=dev)
            rep = eng.run(top, *args)
            if not rep.ok:
                raise AssertionError(f"{name} async on {dev}: {rep.error}")
            runs[dev] = dict(y=_async_outputs(name, args).cpu().double(),
                             schedule=_schedule(rep, eng), eng=eng,
                             err=check()[1])
            if dev == "cuda":
                graph_s = eng.graph_device_s
        c, g = runs["cpu"], runs["cuda"]
        if g["schedule"] != c["schedule"]:
            raise AssertionError(f"{name} async: the card's schedule "
                                 f"{g['schedule'][0]} sweeps, ports "
                                 f"{g['schedule'][4]} differs from the CPU "
                                 f"lowering's {c['schedule'][0]}, "
                                 f"{c['schedule'][4]}")
        scale = float(c["y"].abs().max())
        rel_ref = g["err"] / scale
        rel_cpu = float((g["y"] - c["y"]).abs().max()) / scale
        if not (rel_ref < REF_REL_TOL and rel_cpu <= CPU_REL_TOL[name]):
            raise AssertionError(
                f"{name} async: max err / max |out| = {rel_ref:.3e} against "
                f"the reference (limit {REF_REL_TOL:g}), {rel_cpu:.3e} "
                f"against the CPU lowering (limit {CPU_REL_TOL[name]:g})")
        sweeps, eng = g["schedule"][0], g["eng"]
        out[name] = dict(params=kw, sweeps=sweeps, rel_err_ref=rel_ref,
                         rel_err_cpu=rel_cpu, graph_device_s=graph_s,
                         graph_us_per_sweep=graph_s / sweeps * 1e6,
                         timed_program_s=eng.program_s,
                         timed_capture_s=eng.capture_s,
                         cpu_program_s=c["eng"].program_s,
                         port_stats=g["schedule"][4])
        log(f"async {name}: schedule == CPU lowering ({sweeps} sweeps, "
            f"port counters {g['schedule'][4][0]} ...), card vs reference "
            f"{rel_ref:.3e}, vs CPU {rel_cpu:.3e} of max |out|; device in "
            f"the sweep's graphs {graph_s:.4f} s = "
            f"{graph_s / sweeps * 1e6:.1f} us a sweep (events a block; this "
            f"run's loop {eng.program_s - eng.capture_s:.3f} s)")
    return out


def _outputs(name: str, args) -> torch.Tensor:
    if name == "gemm":
        return torch.cat([m.data for m in args[2]])
    return args[1].data


def full_size_vs_cpu() -> dict:
    """Each app at full size once more on the card, held tightly against
    the reference (relative to the output's scale) and against the CPU
    lowering of the same graph, whose ring ops take their plain
    versions."""
    from repro_torch import ENGINES
    from repro_torch.apps import APPS
    out = {}
    for name, kw in FULL.items():
        ys = {}
        for dev in ("cuda", "cpu"):
            top, args, check = APPS[name].build_step(device=dev, **kw)
            rep = ENGINES["compiled"](device=dev).run(top, *args)
            if not rep.ok:
                raise AssertionError(f"{name} on {dev}: {rep.error}")
            ys[dev] = _outputs(name, args).cpu().double()
            if dev == "cuda":
                _, ref_err = check()
        scale = float(ys["cpu"].abs().max())
        rel_ref = ref_err / scale
        rel_cpu = float((ys["cuda"] - ys["cpu"]).abs().max()) / scale
        if not (rel_ref < REF_REL_TOL and rel_cpu <= CPU_REL_TOL[name]):
            raise AssertionError(
                f"{name}: max err / max |out| = {rel_ref:.3e} against the "
                f"reference (limit {REF_REL_TOL:g}), {rel_cpu:.3e} against "
                f"the CPU lowering (limit {CPU_REL_TOL[name]:g})")
        out[name] = dict(rel_err_ref=rel_ref, rel_err_cpu=rel_cpu,
                         max_abs_out=scale)
        log(f"full {name}: card vs reference {rel_ref:.3e}, card vs CPU "
            f"lowering {rel_cpu:.3e} of max |out| {scale:.4e} (limits "
            f"{REF_REL_TOL:g}, {CPU_REL_TOL[name]:g})")
    return out


def twin_vs_compiled() -> dict:
    from repro_torch import ENGINES
    from repro_torch.apps import APPS
    out = {}
    for name, kw in REDUCED.items():
        mod = APPS[name]
        top, args, _ = mod.build_step(device="cuda", **kw)
        twin = ENGINES["coroutine"](track_stats=True).run(top, *args)
        y_twin = _outputs(name, args).clone()
        top, args, _ = mod.build_step(device="cuda", **kw)
        comp = ENGINES["compiled"](track_stats=True, device="cuda") \
            .run(top, *args)
        y_comp = _outputs(name, args).clone()
        top, args, _ = mod.build_step(device="cpu", **kw)
        comp_cpu = ENGINES["compiled"](device="cpu").run(top, *args)
        if not (twin.ok and comp.ok and comp_cpu.ok):
            raise AssertionError(f"{name}: twin {twin.error} / compiled "
                                 f"{comp.error} / cpu {comp_cpu.error}")
        fires_twin = all(st == "finished" for _, st in twin.instances)
        fires_comp = all(st == "finished" for _, st in comp.instances)
        if not torch.equal(y_twin, y_comp):
            raise AssertionError(f"{name}: twin and compiled outputs differ "
                                 f"on the card")
        if twin.tokens != comp.tokens or not (fires_twin and fires_comp):
            raise AssertionError(f"{name}: tokens {twin.tokens} vs "
                                 f"{comp.tokens}, all fired {fires_twin} "
                                 f"{fires_comp}")
        if comp.switches != comp_cpu.switches:
            raise AssertionError(f"{name}: {comp.switches} sweeps on the "
                                 f"card vs {comp_cpu.switches} on the CPU")
        out[name] = dict(params=kw, bitwise=True, tokens=comp.tokens,
                         sweeps=comp.switches)
        log(f"twin {name}: twin == compiled bitwise on the card, tokens "
            f"{comp.tokens}, sweeps {comp.switches} (== CPU lowering)")
    for name, kw in REDUCED_ASYNC.items():
        mod = APPS[name]
        for depth in (1, 4):
            k = dict(kw, **({"depth": depth} if name == "gemm"
                            else {"edge_depth": depth}))
            top, args, _ = mod.build_step_async(device="cuda", **k)
            twin = ENGINES["coroutine"](track_stats=True).run(top, *args)
            y_twin = _async_outputs(name, args).clone()
            runs = {}
            for dev in ("cuda", "cpu"):
                top, args, check = mod.build_step_async(device=dev, **k)
                eng = ENGINES["compiled"](device=dev)
                rep = eng.run(top, *args)
                if not (rep.ok and check()[0]):
                    raise AssertionError(f"{name} async depth {depth} on "
                                         f"{dev}: {rep.error}")
                runs[dev] = (_async_outputs(name, args).clone(),
                             _schedule(rep, eng), rep.tokens)
            tag = f"{name}_async depth {depth}"
            if not twin.ok or not torch.equal(y_twin, runs["cuda"][0]):
                raise AssertionError(f"{tag}: twin and compiled outputs "
                                     f"differ on the card ({twin.error})")
            if runs["cuda"][1] != runs["cpu"][1] or \
                    twin.tokens != runs["cuda"][2]:
                raise AssertionError(f"{tag}: the card's schedule "
                                     f"{runs['cuda'][1]} vs the CPU "
                                     f"lowering's {runs['cpu'][1]}")
            sched = runs["cuda"][1]
            out[f"{name}_async_d{depth}"] = dict(
                params=k, bitwise=True, sweeps=sched[0], port_stats=sched[4])
            log(f"twin {tag}: twin == compiled bitwise on the card; sweeps "
                f"{sched[0]}, fires, channel stats and port counters == CPU "
                f"lowering")
    return out


# the sweep program's largest block: inside a block the host submits the
# replays back to back and runs ahead of the card, so only a block's first
# replay may wait for the host's submission, and the blocks of TIMED_BLOCK
# replays before a run's last (which replays past the run's end) give the
# device time a replay of a sweep that runs
TIMED_BLOCK = 64


def _graph_time_us(replay, n: int = 200) -> float:
    replay()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(n):
        replay()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / n * 1e3


def graph_node_costs() -> list:
    """The device cost of the sweep graph's structure, apart from any
    app: a ``SweepGraph`` of ``T`` bodies of one small kernel each (as
    many bodies as gaussian's and gemm's sweeps have), every body firing
    and none firing (the done flag set), against one plain graph of the
    same ``T`` kernels; CUDA events over 200 replays."""
    from repro_torch.kernels import ring
    out = []
    i32 = dict(dtype=torch.int32, device="cuda")
    for n in (14, 152):
        x = torch.zeros(1024, device="cuda")
        pool, stream = torch.cuda.graph_pool_handle(), torch.cuda.Stream()
        bodies = []
        for _ in range(n):
            g = torch.cuda.CUDAGraph(keep_graph=True)
            with torch.cuda.stream(stream):
                g.capture_begin(pool=pool)
                x.add_(1)
                g.capture_end()
            bodies.append(g)
        row = dict(bodies=n)
        for done in (0, 1):
            guards = ring.SweepGuards(
                torch.full((n,), 1 << 30, **i32), torch.zeros((n, 0), **i32),
                torch.zeros(n + 1, **i32), torch.zeros((0, 4), **i32),
                torch.zeros(0, **i32), torch.zeros(n, **i32),
                torch.tensor([done, 0], **i32),
                torch.zeros((n, 1), dtype=torch.bool, device="cuda"),
                torch.zeros(n, dtype=torch.bool, device="cuda"),
                torch.zeros(n, **i32))
            sweep = ring.SweepGraph(guards, [(t, g.raw_cuda_graph())
                                             for t, g in enumerate(bodies)])
            row["none_fire_us" if done else "all_fire_us"] = _graph_time_us(
                lambda: sweep.replay(1))
            sweep.close()
        plain = torch.cuda.CUDAGraph()
        with torch.cuda.graph(plain, stream=stream):
            for _ in range(n):
                x.add_(1)
        row["plain_graph_us"] = _graph_time_us(plain.replay)
        out.append(row)
        log(f"breakdown graph nodes: {n} one-kernel bodies, a sweep graph "
            f"{row['all_fire_us']:.1f} us all firing, {row['none_fire_us']:.1f}"
            f" us none firing; a plain graph of the {n} kernels "
            f"{row['plain_graph_us']:.1f} us")
    return out


def breakdown(device_ms: dict) -> dict:
    """Phase 6: each app at full size, twice more.  The first run: host
    ms a sweep two ways (``program_s`` over the sweeps: the sweep loop
    with its capture and the write-back, as earlier trees measured it;
    and without the capture).  From the program's own CUDA events around
    every block of replays (``CompiledEngine.trace.blocks()``,
    ``graph_device_s``): the device time spent in the sweep's graphs, over the sweeps
    and as a share of that run's loop, and a replay's over the blocks of
    :data:`TIMED_BLOCK` (gaussian's; gemm's and page_rank's runs end in
    shorter blocks).  Not under the profiler: on this card it does not
    report the kernels inside the graph's conditional nodes faithfully
    (it both drops and adds records), so the kernels' device times a
    launch come from phase 3 (``device_ms``: eager launches at the main
    path's shapes, each held against the kernel's launch counter)."""
    from repro_torch import ENGINES
    from repro_torch.apps import APPS
    out = {}
    for name, kw in FULL.items():
        t0 = time.perf_counter()
        top, args, _ = APPS[name].build_step(device="cuda", **kw)
        build_s = time.perf_counter() - t0
        eng = ENGINES["compiled"](device="cuda")
        if not eng.run(top, *args).ok:
            raise AssertionError(f"{name}: the run failed")
        sweeps, loop_s = eng.n_sweeps, eng.program_s - eng.capture_s
        top, args, _ = APPS[name].build_step(device="cuda", **kw)
        timed = ENGINES["compiled"](device="cuda")
        if not timed.run(top, *args).ok:
            raise AssertionError(f"{name}: the timed run failed")
        blocks = timed.trace.blocks()
        full = [(k, t) for k, t in blocks[:-1] if k == TIMED_BLOCK]
        graph_s = timed.graph_device_s
        full_s, full_replays = sum(t for _, t in full), sum(k for k, _ in full)
        per_replay = full_s / full_replays * 1e6 if full_replays else None
        timed_loop_s = timed.program_s - timed.capture_s
        out[name] = dict(build_s=build_s, lower_s=eng.lower_s,
                         program_s=eng.program_s, capture_s=eng.capture_s,
                         sweeps=sweeps, replays=eng.n_replays,
                         blocks=eng.n_blocks, host_syncs=eng.n_host_syncs,
                         host_ms_per_sweep=eng.program_s / sweeps * 1e3,
                         host_ms_per_sweep_uncaptured=loop_s / sweeps * 1e3,
                         graph_device_s=graph_s,
                         graph_us_per_sweep=graph_s / sweeps * 1e6,
                         graph_share_of_loop=graph_s / timed_loop_s,
                         graph_us_per_replay_in_blocks_of_64=per_replay,
                         replays_in_blocks_of_64=full_replays,
                         timed_program_s=timed.program_s,
                         timed_capture_s=timed.capture_s,
                         kernel_device_us={
                             k: v * 1e3 for k, v in device_ms.items()})
        log(f"breakdown {name}: build {build_s:.3f} s, lower {eng.lower_s:.3f}"
            f" s, sweep loop {eng.program_s:.3f} s ({sweeps} sweeps, "
            f"{eng.program_s / sweeps * 1e3:.3f} ms each; capture "
            f"{eng.capture_s:.3f} s, {loop_s / sweeps * 1e3:.3f} ms a sweep "
            f"without it; {eng.n_replays} replays, {eng.n_host_syncs} host "
            f"syncs); device in the sweep's graphs (events a block, another "
            f"run) {graph_s:.4f} s = {graph_s / sweeps * 1e6:.1f} us a sweep, "
            f"{graph_s / timed_loop_s:.1%} of its {timed_loop_s:.3f} s loop"
            + (f"; {per_replay:.1f} us a replay in {full_replays} replays in "
               f"blocks of {TIMED_BLOCK}" if per_replay is not None else ""))
    log("breakdown kernels, device time a launch (phase 3): " + ", ".join(
        f"{k} {v * 1e3:.3f} us" for k, v in device_ms.items()))
    out["graph_nodes"] = graph_node_costs()
    return out



# ---------------------------------------------------------------------------
# phase 7: attention kernels against their plain versions
# ---------------------------------------------------------------------------

ATTN_REPS, ATTN_WARM = 50, 5
LAYERS = 28                 # distinct tensors the timed calls cycle through

FLASH_CASES = [             # (B, Sq, Sk, nh, nkv, hd, causal, window)
    (1, 8, 8, 16, 8, 128, True, None), (8, 8, 8, 16, 8, 128, True, None),
    (1, 128, 128, 16, 8, 128, True, None),
    (8, 128, 128, 16, 8, 128, True, None),
    (1, 200, 200, 16, 8, 128, True, None),
    (8, 200, 200, 16, 8, 128, True, None),
    (1, 2048, 2048, 16, 8, 128, True, None),
    (8, 2048, 2048, 16, 8, 128, True, None),
    (2, 300, 300, 16, 8, 128, True, 100),   # sliding window
    (2, 77, 77, 8, 2, 64, False, None),     # head width 64, group 4
    # the edges of the bf16 kernel's 128-row and 128-key tiles
    (1, 100, 300, 16, 8, 128, True, None),  # Sq < Sk (top-left causal)
    (1, 300, 100, 16, 8, 128, True, None),  # Sq > Sk: rows past Sk
    (1, 1500, 1500, 16, 8, 128, True, None),   # not a tile multiple
    (1, 64, 64, 16, 8, 128, True, 0),       # window 0: every row hidden
    (1, 2048, 2048, 16, 8, 128, True, 100),    # tiles skipped both sides
    (2, 333, 333, 8, 2, 64, True, 100),     # hd 64, group 4, window
    (4, 1024, 1024, 16, 8, 128, True, None),   # Qwen3 training shape
    # Phi-3-vision: 32 query and 32 KV heads of width 96 (MHA), prefill
    # buckets 128-2048, its 576-patch prefix, a ragged prompt; hd 96 with
    # GQA (group 8) and a window; Sq < Sk
    (1, 128, 128, 32, 32, 96, True, None),
    (4, 128, 128, 32, 32, 96, True, None),
    (1, 576, 576, 32, 32, 96, True, None),
    (2, 1024, 1024, 32, 32, 96, True, None),
    (1, 1500, 1500, 32, 32, 96, True, None),
    (1, 2048, 2048, 32, 32, 96, True, None),
    (2, 333, 333, 32, 4, 96, True, 100),
    (1, 100, 300, 32, 32, 96, True, None),
    # whisper-small: 12 query and 12 KV heads of 64 (MHA, group 1); the
    # encoder's non-causal 1500 x 1500 (23 key tiles of 64 and a tail of
    # 28); cross-attention from 1 (a decode step), 37 and 448 queries and
    # the 64 of a batch's prompts to the 1500 encoder positions
    (1, 1500, 1500, 12, 12, 64, False, None),
    (8, 1500, 1500, 12, 12, 64, False, None),
    (1, 1, 1500, 12, 12, 64, False, None),
    (8, 1, 1500, 12, 12, 64, False, None),
    (1, 37, 1500, 12, 12, 64, False, None),
    (8, 64, 1500, 12, 12, 64, False, None),
    (1, 448, 1500, 12, 12, 64, False, None),
    # zamba2-1.2b's shared block: 32 query and 32 KV heads of 64, causal,
    # one per-slot prompt of 64-1500 tokens
    (1, 64, 64, 32, 32, 64, True, None),
    (1, 37, 37, 32, 32, 64, True, None),
    (1, 1000, 1000, 32, 32, 64, True, None),
    (1, 1500, 1500, 32, 32, 64, True, None),
    # starcoder2-3b's prefill of phase 31's long request: 24 query heads
    # on 2 KV heads of 128 (group 12) with its window of 4096 over 4,608
    # positions (the window hides keys from row 4096 on); qwen3-4b's and
    # yi-6b's groups 4 and 8 at 32 query heads
    (1, 4608, 4608, 24, 2, 128, True, 4096),
    (2, 1024, 1024, 32, 8, 128, True, None),
    (2, 1024, 1024, 32, 4, 128, True, None),
]
DECODE_CASES = [            # (B, S_max, nh, nkv, hd, kv_len)
    (8, 2048, 16, 8, 128, [0, 1, 255, 256, 257, 2048, 1000, 37]),
    (8, 2048, 16, 8, 128,
     np.random.default_rng(1).integers(0, 2049, 8).tolist()),
    (4, 512, 8, 2, 64, [0, 1, 255, 512]),   # head width 64, group 4
    # the edges of the kernel's 64-row splits: kv_len and S_max at split
    # - 1, split and split + 1
    (8, 2048, 16, 8, 128, [0, 63, 64, 65, 127, 128, 129, 2047]),
    (4, 65, 16, 8, 128, [0, 63, 64, 65]),
    (3, 63, 16, 8, 128, [1, 62, 63]),
    (2, 300, 16, 2, 64, [65, 300]),         # group 8
    (2, 200, 8, 8, 128, [64, 200]),         # group 1
    # Phi-3-vision's cache: 8 slots x 2048, 32 KV heads of 96 (group 1),
    # a dead slot, a full row, the split edges; random lengths; hd 96 at
    # groups 8 and 4
    (8, 2048, 32, 32, 96, [0, 1, 63, 64, 65, 2048, 1000, 577]),
    (8, 2048, 32, 32, 96,
     np.random.default_rng(4).integers(0, 2049, 8).tolist()),
    (4, 512, 16, 2, 96, [0, 5, 511, 512]),
    (2, 300, 16, 4, 96, [65, 300]),
    # head width 64, group 1: zamba2's per-slot cache (one row of 2048, a
    # scalar length expanded to [1]) and whisper's decoder self-attention
    # over 8 ragged rows of 2048
    (1, 2048, 32, 32, 64, [1537]),
    (1, 2048, 32, 32, 64, [64]),
    (8, 2048, 12, 12, 64, [0, 1, 63, 64, 65, 2048, 1000, 97]),
    (8, 2048, 12, 12, 64,
     np.random.default_rng(5).integers(0, 2049, 8).tolist()),
    # the dense models of phase 31 at 8 slots of 2048 rows, hd 128: yi-6b
    # (32 query heads on 4 KV heads, group 8), qwen3-4b (32 on 8, group
    # 4), and group 12 (starcoder2-3b's 24 on 2, which the 16-head
    # instantiation takes); group 16 at hd 96 and 64 (the largest shared
    # memory: float32 tiles 128 wide)
    (8, 2048, 32, 4, 128, [0, 1, 63, 64, 65, 2048, 1000, 577]),
    (8, 2048, 32, 4, 128,
     np.random.default_rng(6).integers(0, 2049, 8).tolist()),
    (8, 2048, 32, 8, 128, [0, 1, 255, 256, 257, 2048, 1000, 37]),
    (8, 2048, 24, 2, 128, [0, 1, 63, 64, 65, 2048, 1000, 577]),
    (8, 2048, 24, 2, 128,
     np.random.default_rng(7).integers(0, 2049, 8).tolist()),
    (2, 300, 32, 2, 96, [65, 300]),
    (4, 200, 32, 2, 64, [0, 1, 64, 200]),
]
# groups over the kernel's 16 query heads a KV head, one launch a chunk
# of a group's heads (decode_attention.head_chunks): 24 (12 + 12) and 40
# (14 + 13 + 13)
DECODE_CHUNKED_CASES = [
    (8, 2048, 48, 2, 128, [0, 1, 63, 64, 65, 2048, 1000, 577]),
    (4, 512, 80, 2, 64, [0, 5, 511, 512]),
]


def _rand(gen, shape, dtype) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device=DEV).to(dtype)


def _errs(got: torch.Tensor, want: torch.Tensor) -> tuple[float, float]:
    """(max |got - want|, the same over max |want|)."""
    err = float((got.float() - want.float()).abs().max())
    scale = float(want.float().abs().max())
    return err, err / scale if scale else err


def check_attention() -> tuple[list, dict]:
    """Each attention kernel against its plain version on the card; raises
    past a limit.  Returns the checked cases and each op's largest
    absolute difference."""
    from repro_torch.kernels.decode_attention import (
        decode_attention_fwd, decode_attention_plain)
    from repro_torch.kernels.flash_attention import (
        NEG_INF, flash_attention_fwd, flash_attention_plain)
    gen = torch.Generator(device=DEV).manual_seed(0)
    rows, worst = [], {"flash_attention": 0.0, "decode_attention": 0.0}
    for dt in (torch.float32, torch.bfloat16):
        tol = ATTN_REL_TOL[dt]
        for B, Sq, Sk, nh, nkv, hd, causal, window in FLASH_CASES:
            q = _rand(gen, (B, Sq, nh, hd), dt)
            k = _rand(gen, (B, Sk, nkv, hd), dt)
            v = _rand(gen, (B, Sk, nkv, hd), dt)
            out, lse = flash_attention_fwd(q, k, v, causal=causal,
                                           window=window)
            p_out, p_lse = flash_attention_plain(q, k, v, causal=causal,
                                                 window=window)
            torch.cuda.synchronize()
            err, rel = _errs(out, p_out)
            lse_err = float((lse - p_lse).abs().max())
            # window 0 hides every key: exact zeros and lse -1e30
            zeros_missing = window == 0 and not (
                bool((out == 0).all()) and bool((lse == NEG_INF).all()))
            rows.append(dict(op="flash_attention", dtype=str(dt), B=B, Sq=Sq,
                             Sk=Sk, nh=nh, nkv=nkv, hd=hd, causal=causal,
                             window=window, max_abs_err=err, rel_err=rel,
                             lse_abs_err=lse_err))
            log(f"attn flash  {str(dt):14s} B={B} Sq={Sq:4d} Sk={Sk:4d} "
                f"{nh}/{nkv}x{hd} causal={causal} window={window}: rel "
                f"{rel:.2e} (limit {tol:g}), lse {lse_err:.2e} (limit "
                f"{LSE_ABS_TOL:g})" + ("; exact zeros, lse -1e30"
                                        if window == 0 and not
                                        zeros_missing else ""))
            if not (rel <= tol and lse_err <= LSE_ABS_TOL) or zeros_missing:
                raise AssertionError(f"flash_attention differs from plain: "
                                     f"{rows[-1]}")
            worst["flash_attention"] = max(worst["flash_attention"], err)
            key = f"flash_attention hd{hd} {dt}"
            worst[key] = max(worst.get(key, 0.0), err)
            del q, k, v, out, lse, p_out, p_lse
        for B, S, nh, nkv, hd, lens in DECODE_CASES + DECODE_CHUNKED_CASES:
            q = _rand(gen, (B, nh, hd), dt)
            k = _rand(gen, (B, S, nkv, hd), dt)
            v = _rand(gen, (B, S, nkv, hd), dt)
            kv_len = torch.tensor(lens, dtype=torch.int32, device=DEV)
            out = decode_attention_fwd(q, k, v, kv_len)
            p_out = decode_attention_plain(q, k, v, kv_len)
            torch.cuda.synchronize()
            err, rel = _errs(out, p_out)
            zeros = bool((out[kv_len == 0] == 0).all())
            rows.append(dict(op="decode_attention", dtype=str(dt), B=B,
                             S_max=S, nh=nh, nkv=nkv, hd=hd, kv_len=lens,
                             max_abs_err=err, rel_err=rel,
                             exact_zeros=zeros))
            log(f"attn decode {str(dt):14s} B={B} S_max={S} {nh}/{nkv}x{hd} "
                f"kv_len={lens}: rel {rel:.2e} (limit {tol:g}), exact "
                f"zeros at kv_len 0: {zeros}")
            if not (rel <= tol and zeros):
                raise AssertionError(f"decode_attention differs from plain: "
                                     f"{rows[-1]}")
            worst["decode_attention"] = max(worst["decode_attention"], err)
            key = f"decode_attention hd{hd} {dt}"
            worst[key] = max(worst.get(key, 0.0), err)
            del q, k, v, out, p_out
    torch.cuda.empty_cache()
    log("attn max |kernel - plain| by head width: " + ", ".join(
        f"{k} {v:.3e}" for k, v in worst.items() if " hd" in k))
    return rows, worst


# flash-decode's lse output and the merge of sequence pieces: (B, S_max,
# nh, nkv, hd, kv_len) — Qwen3-0.6B's packed serving cache (a dead slot,
# a full row, lengths inside every quarter), zamba2-1.2b's per-slot row
# and a packed cache of its heads (rows of length 0 and of one quarter)
LSE_CASES = [
    (8, 2048, 16, 8, 128, [0, 1, 37, 513, 1024, 1537, 2047, 2048]),
    (1, 2048, 32, 32, 64, [1537]),
    (4, 2048, 32, 32, 64, [0, 5, 512, 1100]),
]
LSE_PIECES = (2, 4, 16)      # sequence pieces a cache is cut into (16:
                             # the production long-context cell's data axis)


def _lse_err(lse: torch.Tensor, want: torch.Tensor) -> float:
    """max |lse - want| over the rows with a valid key; the rows without
    one must be -inf in both."""
    dead = want == -math.inf
    if not bool((lse[dead] == -math.inf).all()):
        return math.inf
    return float((lse[~dead] - want[~dead]).abs().max()) if bool(
        (~dead).any()) else 0.0


def _steps(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest |got - want| of two bfloat16 tensors in bfloat16
    rounding steps at the larger of the two magnitudes (2**-7 of it)."""
    g, w = got.float(), want.float()
    mag = torch.maximum(g.abs(), w.abs()).clamp_min(2.0 ** -126)
    return float(((g - w).abs() / torch.exp2(torch.floor(torch.log2(mag))
                                             - 7)).max())


def check_decode_lse() -> list:
    """Phase 7, flash-decode's log-sum-exp: the kernel's ``(out, lse)``
    (``out`` float32 and unrounded) against the plain version's
    (``ATTN_REL_TOL``, ``LSE_ABS_TOL``; -inf and exact zeros where
    ``kv_len == 0``), its ``out`` rounded to the input type bitwise equal
    to the call without ``lse`` (the null-pointer path); then each cache
    cut into ``LSE_PIECES`` sequence pieces, the kernel on each piece with
    its local lengths, the float32 pieces merged as the sequence-split
    mesh merges them (``kernels/ops.merge_partials``) and rounded once:
    the whole cache's kernel output within ``ATTN_REL_TOL``, and in
    bfloat16 within one rounding step everywhere."""
    from repro_torch.kernels.decode_attention import (
        decode_attention_fwd, decode_attention_plain)
    gen = torch.Generator(device=DEV).manual_seed(7)
    rows = []
    for dt in (torch.float32, torch.bfloat16):
        tol = ATTN_REL_TOL[dt]
        for B, S, nh, nkv, hd, lens in LSE_CASES:
            q = _rand(gen, (B, nh, hd), dt)
            k = _rand(gen, (B, S, nkv, hd), dt)
            v = _rand(gen, (B, S, nkv, hd), dt)
            kv_len = torch.tensor(lens, dtype=torch.int32, device=DEV)
            whole = decode_attention_fwd(q, k, v, kv_len)
            out, lse = decode_attention_fwd(q, k, v, kv_len, return_lse=True)
            p_out, p_lse = decode_attention_plain(q, k, v, kv_len,
                                                  return_lse=True)
            torch.cuda.synchronize()
            _, rel = _errs(out, p_out)
            lse_err = _lse_err(lse, p_lse)
            same = bool(torch.equal(out.to(dt), whole))
            zeros = bool((out[kv_len == 0] == 0).all())
            merged, steps = {}, {}
            for n in LSE_PIECES:
                w = S // n
                parts = [decode_attention_fwd(
                    q, k[:, i * w:(i + 1) * w], v[:, i * w:(i + 1) * w],
                    (kv_len - i * w).clamp(0, w).to(torch.int32),
                    return_lse=True) for i in range(n)]
                m = torch.stack([p[1] for p in parts]).amax(0)
                ws = [torch.where(p[1] == -math.inf, 0.0,
                                  torch.exp(p[1] - m)) for p in parts]
                den = sum(ws)
                num = sum(x[..., None] * p[0] for x, p in zip(ws, parts))
                got = (num / torch.where(den > 0, den, 1.0)[..., None]).to(dt)
                torch.cuda.synchronize()
                merged[n] = _errs(got, whole)[1]
                if dt == torch.bfloat16:
                    steps[n] = _steps(got, whole)
            rows.append(dict(dtype=str(dt), B=B, S_max=S, nh=nh, nkv=nkv,
                             hd=hd, kv_len=lens, rel_err=rel,
                             lse_abs_err=lse_err, out_unchanged=same,
                             exact_zeros=zeros, merged_rel_err=merged,
                             merged_steps=steps))
            log(f"attn decode lse {str(dt):14s} B={B} S_max={S} "
                f"{nh}/{nkv}x{hd}: out rel {rel:.2e}, lse {lse_err:.2e} "
                f"(limit {LSE_ABS_TOL:g}), out without lse bitwise equal "
                f"{same}; merged pieces vs whole " + ", ".join(
                    f"{n}: {e:.2e}" + (f" ({steps[n]:g} bf16 steps)"
                                       if n in steps else "")
                    for n, e in merged.items())
                + f" (limit {tol:g}" + ("; 1 step)" if steps else ")"))
            one_step = all(x <= 1.0 for x in steps.values())
            if not (rel <= tol and lse_err <= LSE_ABS_TOL and same and zeros
                    and all(e <= tol for e in merged.values())
                    and one_step):
                raise AssertionError(f"decode_attention lse: {rows[-1]}")
            del q, k, v, out, lse, p_out, p_lse, whole
    torch.cuda.empty_cache()
    return rows


# timed shapes: (B, Sq, Sk, nh, nkv, hd, causal) of flash — Qwen3-0.6B
# (one prompt in the middle and the top prefill bucket, a batch of eight
# short prompts, the training shape of phase 13), Phi-3-vision (hd 96,
# MHA), whisper-small's encoder (non-causal, 1500 x 1500, hd 64) and its
# decode step's cross-attention (B = 8, one query against 1500), and
# zamba2's shared block at one per-slot prompt; phase 29's training
# shapes (granite-moe, zamba2's shared block, whisper's encoder, decoder
# self- and cross-attention, phi-3); phase 31's (starcoder2-3b's long
# prompt with its window as an eighth element, qwen3-4b's and yi-6b's
# groups at one 1024-token prompt); (B, nh, nkv, hd) of flash-decode over
# the serving runs' caches: the packed 8 slots of Qwen3 and Phi-3,
# zamba2's one per-slot row, qwen3-4b's, yi-6b's and a group-12 cache
FLASH_TIMES = [(1, 1024, 1024, 16, 8, 128, True),
               (1, 2048, 2048, 16, 8, 128, True),
               (8, 256, 256, 16, 8, 128, True),
               (4, 1024, 1024, 16, 8, 128, True),
               (1, 1024, 1024, 32, 32, 96, True),
               (1, 2048, 2048, 32, 32, 96, True),
               (1, 1500, 1500, 12, 12, 64, False),
               (8, 1, 1500, 12, 12, 64, False),
               (1, 1024, 1024, 32, 32, 64, True),
               (4, 1024, 1024, 16, 8, 64, True),
               (2, 2048, 2048, 32, 32, 64, True),
               (8, 1500, 1500, 12, 12, 64, False),
               (8, 448, 448, 12, 12, 64, True),
               (8, 448, 1500, 12, 12, 64, False),
               (2, 2048, 2048, 32, 32, 96, True),
               (1, 4608, 4608, 24, 2, 128, True, 4096),
               (1, 1024, 1024, 32, 8, 128, True),
               (1, 1024, 1024, 32, 4, 128, True)]
DECODE_TIMES = [(8, 16, 8, 128), (8, 32, 32, 96), (1, 32, 32, 64),
                (8, 32, 8, 128), (8, 32, 4, 128), (8, 24, 2, 128)]


def _visible_pairs(Sq: int, Sk: int, causal: bool, window) -> float:
    """(query, key) pairs the mask leaves: all of them non-causal, half
    causal (the diagonal's half left out, as the earlier bounds count
    it), and with a window each row's last ``window`` keys at most."""
    if not causal:
        return Sq * Sk
    if window is None:
        return Sq * Sk / 2
    return sum(min(i + 1, window, Sk) for i in range(Sq))


def time_attention() -> dict:
    """CUDA-event times at the serving path's bf16 shapes.  Each call
    reads another of ``LAYERS`` layers' tensors, as a forward pass does,
    so no call finds its inputs in L2."""
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import (
        decode_attention_fwd, decode_attention_plain)
    from repro_torch.kernels.flash_attention import (
        flash_attention_fwd, flash_attention_plain)
    gen = torch.Generator(device=DEV).manual_seed(2)
    bf16, L = torch.bfloat16, LAYERS
    out = {"flash_attention": [], "decode_attention": []}

    def timed(fn):
        return time_ms(fn, reps=ATTN_REPS, warm=ATTN_WARM)

    for B, Sq, Sk, nh, nkv, hd, causal, *win in FLASH_TIMES:
        window = win[0] if win else None
        qs = _rand(gen, (L, B, Sq, nh, hd), bf16)
        ks = _rand(gen, (L, B, Sk, nkv, hd), bf16)
        vs = _rand(gen, (L, B, Sk, nkv, hd), bf16)
        # 4 hd flops a visible (query, key) pair and head: causal (Sq =
        # Sk) half of them, a window fewer
        flops = 4 * B * nh * _visible_pairs(Sq, Sk, causal, window) * hd
        nbytes = (qs[0].numel() + ks[0].numel()) * 2 * 2 + 4 * B * nh * Sq
        bnd, by = bound_ms(nbytes, flops, TENSOR_BF16_FLOPS)
        # SDPA takes a window as a boolean mask (True: attend)
        mask = None if window is None else \
            (torch.arange(Sk, device=DEV)[None, :]
             <= torch.arange(Sq, device=DEV)[:, None]) & \
            (torch.arange(Sk, device=DEV)[None, :]
             > torch.arange(Sq, device=DEV)[:, None] - window)

        def flash(i):
            return flash_attention_fwd(qs[i % L], ks[i % L], vs[i % L],
                                       causal=causal, window=window)
        out["flash_attention"].append(dict(
            shape=f"B={B} Sq={Sq} Sk={Sk} nh={nh} nkv={nkv} hd={hd} bf16 "
                  + ("causal" if causal else "non-causal")
                  + (f" window={window}" if window is not None else ""),
            ms=timed(flash), device_ms=_kernel_device_ms(
                flash, ATTN_KERNELS["flash_attention"][0]),
            plain_ms=timed(lambda i: flash_attention_plain(
                qs[i % L], ks[i % L], vs[i % L], causal=causal,
                window=window)),
            library_ms=timed(lambda i: F.scaled_dot_product_attention(
                qs[i % L].transpose(1, 2), ks[i % L].transpose(1, 2),
                vs[i % L].transpose(1, 2), attn_mask=mask,
                is_causal=causal and mask is None, enable_gqa=True)),
            bound_ms=bnd, bound_by=by, flops=flops, bytes=nbytes))
        del qs, ks, vs, mask
    # decode: the caches of the serving runs, rows of 2048, at lengths such
    # as those runs' (prompt 64-1500 plus up to 32 new): the packed 8 slots
    # of phases 8, 18 and 19, zamba2's one per-slot row of phase 21
    S = SERVE["max_seq"]
    lo, hi = SERVE["prompt"]
    for B, nh, nkv, hd in DECODE_TIMES:
        lens = np.random.default_rng(3).integers(lo, hi + SERVE["max_new"]
                                                 + 1, B)
        kv_len = torch.tensor(lens, dtype=torch.int32, device=DEV)
        mask = (torch.arange(S, device=DEV)[None, :]
                < kv_len[:, None])[:, None, None, :]
        n_tok = int(lens.sum())
        qs = _rand(gen, (L, B, nh, hd), bf16)
        ks = _rand(gen, (L, B, S, nkv, hd), bf16)
        vs = _rand(gen, (L, B, S, nkv, hd), bf16)
        nbytes = 2 * n_tok * nkv * hd * 2 + 2 * B * nh * hd * 2 + 4 * B
        bnd, by = bound_ms(nbytes, 4 * nh * n_tok * hd, TENSOR_BF16_FLOPS)

        def decode(i):
            return decode_attention_fwd(qs[i % L], ks[i % L], vs[i % L],
                                        kv_len)
        out["decode_attention"].append(dict(
            shape=f"B={B} S_max={S} nh={nh} nkv={nkv} hd={hd} bf16 "
                  f"kv_len={lens.tolist()}",
            ms=timed(decode), device_ms=_kernel_device_ms(
                decode, ATTN_KERNELS["decode_attention"]),
            plain_ms=timed(lambda i: decode_attention_plain(
                qs[i % L], ks[i % L], vs[i % L], kv_len)),
            library_ms=timed(lambda i: F.scaled_dot_product_attention(
                qs[i % L][:, :, None], ks[i % L].transpose(1, 2),
                vs[i % L].transpose(1, 2), attn_mask=mask,
                enable_gqa=True)),
            bound_ms=bnd, bound_by=by, bytes=nbytes))
        del qs, ks, vs
        torch.cuda.empty_cache()
    for op, rows in out.items():
        for r in rows:
            log(f"time {op:16s} {r['shape']}: kernel {r['ms']*1e3:9.2f} us  "
                + (f"(device {r['device_ms']*1e3:.2f} us)  "
                   if r.get("device_ms") else "")
                + f"plain {r['plain_ms']*1e3:9.2f} us  sdpa "
                f"{r['library_ms']*1e3:9.2f} us  bound "
                f"{r['bound_ms']*1e3:8.3f} us ({r['bound_by']})")
    return out


def _kernel_device_ms(fn, kernels, n: int = 2 * LAYERS,
                      tries: int = PROFILE_TRIES) -> float:
    """Mean device ms a call of the kernels named in ``kernels`` (one name,
    or a tuple whose first kernel runs once a call) over ``n`` calls of
    ``fn`` (the profiler's kernel time: no host path).  The profiler on
    the card now and then loses kernel records, so a profile that shows
    no launch is taken again on ``n`` new calls, ``tries`` profiles in
    all, and the last miss fails."""
    from torch.profiler import ProfilerActivity, profile
    names = (kernels,) if isinstance(kernels, str) else tuple(kernels)
    for attempt in range(1, tries + 1):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for i in range(n):
                fn(i)
            torch.cuda.synchronize()
        total, calls = 0.0, 0
        for e in prof.key_averages():
            for j, nm in enumerate(names):
                if nm in e.key:
                    total += e.self_device_time_total
                    calls += e.count if j == 0 else 0
        if calls:
            return total / calls / 1e3
        if attempt == tries:
            raise AssertionError(f"the profiler saw no {names[0]} launch")
        log(f"the profiler saw none of {n} calls' {names[0]} launches; "
            f"profiling new calls ({attempt} of {tries} profiles)")


# ---------------------------------------------------------------------------
# phases 8 and 10: serving Qwen3-0.6B at full width, and its breakdown
# ---------------------------------------------------------------------------

class _CallStats:
    """Calls and synchronised wall seconds of the adapter's prefill and
    decode-step functions."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.n = {"prefill": 0, "decode": 0}
        self.s = {"prefill": 0.0, "decode": 0.0}

    def wrap(self, kind: str, fn):
        def call(*args):
            t0 = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            self.n[kind] += 1
            self.s[kind] += time.perf_counter() - t0
            return out
        return call


def _watch_nan(lm):
    """Route the model's prefill and decode step through a check that
    ORs "any logit is NaN" into a device flag (no host sync); returns
    the flag and a function that undoes the routing."""
    flag = torch.zeros((), dtype=torch.bool, device=DEV)
    prefill, decode_step = lm.prefill, lm.decode_step

    def watched(fn):
        def call(*args, **kw):
            logits, cache = fn(*args, **kw)
            flag.logical_or_(torch.isnan(logits).any())
            return logits, cache
        return call

    lm.prefill, lm.decode_step = watched(prefill), watched(decode_step)

    def restore():
        lm.prefill, lm.decode_step = prefill, decode_step
    return flag, restore


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


def _serve_requests(cfg) -> list:
    """``SERVE``'s requests for ``cfg``: prompts of random lengths and
    tokens from ``SERVE["seed"]``, ``max_new`` new tokens each; then, for
    a model ``LONG_SERVE`` names, its one long request."""
    from repro_torch.serve import Request
    rng = np.random.default_rng(SERVE["seed"])
    lo, hi = SERVE["prompt"]
    plens = rng.integers(lo, hi + 1, SERVE["requests"])
    reqs = [Request(i, rng.integers(0, cfg.vocab, int(n)).tolist(),
                    max_new=SERVE["max_new"]) for i, n in enumerate(plens)]
    long = LONG_SERVE.get(cfg.name)
    if long is not None:
        reqs.append(Request(len(reqs), rng.integers(
            0, cfg.vocab, long["prompt"]).tolist(), max_new=long["max_new"]))
    return reqs


def _decode_apps(cfg) -> int:
    """Flash-decode launches of one decode step: an attention application
    each, none under a sliding window (decode then goes through windowed
    ``sdpa``, as the reference's does)."""
    return 0 if cfg.sliding_window is not None else _attn_apps(cfg)


def serving_phase(arch: str = ARCH):
    """Phase 8 (and 18, 19 and 21 at their models): ``arch`` at full width
    served at ``SERVE`` with ``attn_impl="kernel"``: through
    ``serving_adapter``'s batched engine, or for the ssm and hybrid
    families through the per-slot engine ``launch.serve`` builds for them
    (``per_slot_engine``).  Every request must end ok with ``max_new``
    tokens (the per-slot path turns a step's exception into that
    request's error, so an error here is a failure, not a quarantine), no
    logit NaN, flash once an attention application a prefill call,
    flash-decode once one a decode call (none under a sliding window) and
    the SSD kernel once a Mamba2 layer a prefill call.  A model
    ``LONG_SERVE`` names serves with its cache of ``max_seq`` rows and
    its long request among the others (phase 31).  Returns (report,
    engine, requests, call stats, parameters)."""
    from repro_torch.kernels.dispatch import launch_counts, reset_launches
    from repro_torch.launch.serve import per_slot_engine
    from repro_torch.models import lm
    from repro_torch.serve import (Request, ServeConfig, ServingEngine,
                                   serve_requests)
    cfg = _serve_cfg(arch)
    per_slot = cfg.family in lm.PER_SLOT_FAMILIES
    # what earlier phases left allocated: the peak below is this phase's
    # own (weights, caches, activations) above it
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    params = lm.init_params(cfg, SERVE["seed"])        # on the card
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in _leaves(params))
    if n_params != cfg.param_count():
        raise AssertionError(f"{n_params} parameters, config says "
                             f"{cfg.param_count()}")
    stats = _CallStats()
    max_seq = LONG_SERVE.get(arch, {}).get("max_seq", SERVE["max_seq"])
    scfg = ServeConfig(batch_slots=SERVE["slots"], max_seq=max_seq)
    if per_slot:
        eng = per_slot_engine(params, cfg, scfg, torch.device(DEV))
        eng.prefill_fn = stats.wrap("prefill", eng.prefill_fn)
        eng.decode_fn = stats.wrap("decode", eng.decode_fn)
        warm = {}
    else:
        adapter = lm.serving_adapter(params, cfg, max_seq=max_seq)
        adapter = dataclasses.replace(
            adapter, prefill_fn=stats.wrap("prefill", adapter.prefill_fn),
            step_fn=stats.wrap("decode", adapter.step_fn))
        eng = ServingEngine(scfg, batched=adapter)
        warm = dict(batch_sizes=(1, 2, 4, 8))
    t0 = time.perf_counter()
    info = eng.warmup(**warm)
    warm_s = time.perf_counter() - t0
    if not info["ok"]:
        raise AssertionError(f"serving warmup failed: {info}")
    reqs = _serve_requests(cfg)
    plens = np.array([len(r.prompt) for r in reqs])

    nan, restore = _watch_nan(lm)
    stats.reset()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        res = serve_requests(eng, reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launch_counts()
    finally:
        restore()
    peak_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
    bad = {r.rid: res.get(r.rid) for r in reqs
           if not (isinstance(res.get(r.rid), list)
                   and len(res[r.rid]) == r.max_new)}
    if bad:
        raise AssertionError(f"{arch}: requests not ok with their max_new "
                             f"tokens: {bad}")
    if bool(nan):
        raise AssertionError(f"{arch}: a logit of the serving run is NaN")
    n_prefill, n_decode = stats.n["prefill"], stats.n["decode"]
    want = {"flash_attention": _attn_apps(cfg) * n_prefill,
            "decode_attention": _decode_apps(cfg) * n_decode}
    if cfg.ssm is not None:
        want["ssd_scan"] = cfg.n_layers * n_prefill
    if n_prefill == 0 or n_decode == 0 or any(
            counts.get(op, 0) != n for op, n in want.items()):
        raise AssertionError(f"{arch}: launches {counts} in {n_prefill} "
                             f"prefill and {n_decode} decode calls, "
                             f"expected {want}")
    n_tok = sum(len(v) for v in res.values())
    mode = "per-slot" if per_slot else "batched"
    report = dict(
        arch=arch, params=n_params, dtype=cfg.dtype, attn_impl="kernel",
        mode=mode, **{**SERVE, "max_seq": max_seq}, layers=cfg.n_layers,
        sliding_window=cfg.sliding_window, requests_served=len(reqs),
        prompt_tokens=int(plens.sum()), init_s=init_s,
        warmup_s=warm_s, wall_s=wall, tokens=n_tok, tok_per_s=n_tok / wall,
        prefill_calls=n_prefill, prefill_s=stats.s["prefill"],
        decode_steps=n_decode, decode_s=stats.s["decode"],
        decode_ms_per_step=stats.s["decode"] / n_decode * 1e3,
        launches=counts, peak_gb=peak_gb, base_gb=base / 1e9,
        token_lists={r.rid: res[r.rid] for r in reqs})
    log(f"serve {arch} ({mode}): {n_params} params {cfg.dtype}, init "
        f"{init_s:.2f} s, warmup {warm_s:.2f} s; {len(reqs)} requests "
        f"({int(plens.sum())} prompt tokens) -> {n_tok} tokens in "
        f"{wall:.3f} s ({n_tok / wall:.1f} tok/s); prefill {n_prefill} "
        f"calls {stats.s['prefill']:.3f} s, decode {n_decode} calls "
        f"{stats.s['decode']:.3f} s ({report['decode_ms_per_step']:.2f} "
        f"ms a call); launches {counts}; peak {peak_gb:.2f} GB above the "
        f"{base / 1e9:.2f} GB earlier phases left")
    return report, eng, reqs, stats, params


def _device_times(prof) -> tuple[float, dict]:
    """Total device microseconds in a profile, and per attention op
    (launches, device us); one launch of an op is one launch of its first
    kernel."""
    total, per = 0.0, {}
    for e in prof.key_averages():
        us = float(getattr(e, "self_device_time_total", 0.0) or 0.0)
        total += us
        for op, names in ATTN_KERNELS.items():
            for i, nm in enumerate(names):
                if nm in e.key:
                    n, t = per.get(op, (0, 0.0))
                    per[op] = (n + (e.count if i == 0 else 0), t + us)
    return total, per


def _profiled(run, check, where: str, activities=None,
              warm_first: bool = False):
    """``run()`` under ``torch.profiler`` (device activity), then
    ``check(prof, out)`` on the profile and what ``run`` returned, which
    raises AssertionError unless the profile shows every launch the run
    made.  The profiler on the card now and then loses kernel records
    (one serving wave showed 779 of its 868 flash-decode launches, in the
    runs of two trees; on some machines one launch of a kernel short in
    each profile of a process), so a profile that fails the check is
    taken again on a new run, up to ``PROFILE_TRIES`` in all, and the
    last failure fails.  A profile taken again is the second step of a
    profiler schedule whose first step, a warm-up with the profiler on
    and its records dropped, runs the same work once more (the first
    profile too with ``warm_first``).  ``activities`` default to the
    device's alone.  Returns ``(prof, out, check's result)``."""
    from torch.profiler import ProfilerActivity, profile, schedule
    for attempt in range(1, PROFILE_TRIES + 1):
        warm = attempt > 1 or warm_first
        with profile(activities=activities or [ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1)
                     if warm else None) as prof:
            if warm:
                run()
                torch.cuda.synchronize()
                prof.step()
            out = run()
            torch.cuda.synchronize()
            if warm:
                prof.step()
        try:
            return prof, out, check(prof, out)
        except AssertionError as e:
            raw = _raw_kernel_records(prof)
            if attempt == PROFILE_TRIES:
                raise AssertionError(f"{e} (the profile's raw device "
                                     f"records: {raw})") from e
            log(f"{where}: {e} (the profile's raw device records: {raw}); "
                f"profiling a new run ({attempt} of {PROFILE_TRIES} lost "
                f"records)")


def _raw_kernel_records(prof) -> dict:
    """The device records of a profile's raw events (not
    ``key_averages``' table): how many there are, and how many name each
    attention kernel; what a failed route check prints beside its own
    count."""
    from torch.autograd import DeviceType
    names = [n for ns in ATTN_KERNELS.values() for n in ns]
    out = dict.fromkeys(["device_records", *names], 0)
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA:
            continue
        out["device_records"] += 1
        for n in names:
            if n in ev.name:
                out[n] += 1
    return out


def _check_flash_route(kern: dict, launches: int, where: str) -> None:
    """Raise unless the profile shows every one of ``launches`` bf16 flash
    launches as the tensor-core kernel and no float32 FMA kernel."""
    tc = kern.get("flash_attention", (0, 0.0))[0]
    fma = kern.get("flash_attention_fp32", (0, 0.0))[0]
    if launches == 0 or tc != launches or fma:
        raise AssertionError(
            f"{where}: {launches} flash launches, the profiler saw "
            f"{tc} {ATTN_KERNELS['flash_attention'][0]} and {fma} "
            f"{ATTN_KERNELS['flash_attention_fp32'][0]}")
    log(f"{where}: all {launches} flash launches ran "
        f"{ATTN_KERNELS['flash_attention'][0]}, none the float32 kernel")


def _check_decode_route(kern: dict, launches: int, where: str) -> None:
    """Raise unless the profile shows each of ``launches`` flash-decode
    launches as one ``decode_partial_kernel`` and one
    ``decode_merge_kernel``."""
    names = ATTN_KERNELS["decode_attention"]
    seen = kern.get("decode_attention", (0, 0.0))[0]
    if launches == 0 or seen != launches:
        raise AssertionError(f"{where}: {launches} flash-decode launches, the "
                             f"profiler saw {seen} {names[0]}")
    log(f"{where}: all {launches} flash-decode launches ran {names[0]} + "
        f"{names[1]}")


class _OpCount:
    """Counts the aten operations dispatched inside a ``with`` block (views
    included; each is a trip through PyTorch's dispatcher, most of the
    rest a kernel launch)."""

    def __enter__(self):
        from torch.utils._python_dispatch import TorchDispatchMode
        counter = self

        class _Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                counter.n += 1
                return func(*args, **(kwargs or {}))

        self.n, self._mode = 0, _Mode()
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        return self._mode.__exit__(*exc)


def _dev32(x) -> torch.Tensor:
    """A host value as an int32 tensor on the card (what the serving
    engine hands a step function)."""
    return torch.from_numpy(np.asarray(x, np.int32)).to(DEV)


def _decode_loop(adapter, wave: list, steps: int) -> dict:
    """The adapter's decode step alone, ``steps`` times on a packed cache
    whose slots hold ``wave``'s prompts, as the serving loop calls it (one
    ``[slots]`` copy to the host per step), under the profiler."""
    from torch.profiler import ProfilerActivity, profile
    n, bucket = len(wave), SERVE["max_seq"]
    toks = np.zeros((n, bucket), np.int32)
    lens = np.array([len(r.prompt) for r in wave], np.int32)
    for i, r in enumerate(wave):
        toks[i, :len(r.prompt)] = r.prompt
    packed = adapter.init_slots(n)
    first, cache = adapter.prefill_fn(_dev32(toks), _dev32(lens), _dev32(0))
    for i in range(n):
        packed = adapter.write_slot_fn(packed, cache, _dev32(i), _dev32(i))
    del cache
    tok = first.cpu().numpy()
    for s in range(2):                       # warm
        nxt, packed = adapter.step_fn(_dev32(tok), packed, _dev32(s))
        tok = nxt.cpu().numpy()
    with _OpCount() as ops:                  # what one step dispatches
        nxt, packed = adapter.step_fn(_dev32(tok), packed, _dev32(2))
    tok = nxt.cpu().numpy()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for s in range(steps):
            # as the engine moves them: tokens and step to the card
            nxt, packed = adapter.step_fn(_dev32(tok), packed, _dev32(s))
            tok = nxt.cpu().numpy()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy_us, _ = _device_times(prof)
    return dict(steps=steps, slots=n, kv_len_start=(lens + 3).tolist(),
                aten_ops_per_step=ops.n,
                host_ms_per_step=wall / steps * 1e3,
                device_ms_per_step=busy_us / steps / 1e3,
                busy_share=busy_us / 1e6 / wall if busy_us else None)


BREAKDOWN_STEPS = 8         # phase 10: decode steps profiled alone


def serving_breakdown(eng, reqs, stats) -> dict:
    """Phase 10: the first wave of requests again under the profiler
    (device activity only), then the decode step alone on that wave."""
    from repro_torch.kernels.dispatch import launch_counts, reset_launches
    from repro_torch.serve import serve_requests
    wave = reqs[:SERVE["slots"]]

    def run():
        stats.reset()
        reset_launches()
        t0 = time.perf_counter()
        res = serve_requests(eng, wave)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if any(len(res[r.rid]) != SERVE["max_new"] for r in wave):
            raise AssertionError("profiled wave: a request is short of "
                                 "tokens")
        return wall, launch_counts()

    def check(prof, out):
        counts = out[1]
        busy_us, kern = _device_times(prof)
        _check_flash_route(kern, counts.get("flash_attention", 0),
                           "breakdown serve")
        _check_decode_route(kern, counts.get("decode_attention", 0),
                            "breakdown serve")
        return busy_us, kern

    _, (wall, _), (busy_us, kern) = _profiled(run, check, "breakdown serve")
    dev_ms = {op: t / n / 1e3 for op, (n, t) in kern.items() if n}
    n_call, s_call = dict(stats.n), dict(stats.s)
    loop = _decode_loop(eng.batched, wave, BREAKDOWN_STEPS)
    out = dict(requests=len(wave), wall_s=wall,
               prefill_calls=n_call["prefill"], prefill_s=s_call["prefill"],
               decode_steps=n_call["decode"], decode_s=s_call["decode"],
               device_busy_s=busy_us / 1e6,
               busy_share=busy_us / 1e6 / wall if busy_us else None,
               kernel_device_ms=dev_ms, kernel_launches={
                   op: n for op, (n, _) in kern.items()},
               decode_loop=loop)
    share = out["busy_share"]
    log(f"breakdown serve: wave of {len(wave)} in {wall:.3f} s (prefill "
        f"{s_call['prefill']:.3f} s in {n_call['prefill']} calls, decode "
        f"{s_call['decode']:.3f} s in {n_call['decode']} steps), device "
        + (f"busy {busy_us / 1e6:.3f} s = {share:.1%}" if share is not None
           else "time not measured (profiler saw none)")
        + "; decode step alone: "
        + (f"{loop['device_ms_per_step']:.3f} ms device of "
           f"{loop['host_ms_per_step']:.3f} ms = {loop['busy_share']:.1%}"
           if loop["busy_share"] is not None else "not measured")
        + f", {loop['aten_ops_per_step']} aten ops a step"
        + "; per launch: " + ", ".join(f"{k} {v * 1e3:.2f} us"
                                       for k, v in dev_ms.items()))
    return out


class _Tee:
    """Standard output that is also kept (``text``)."""

    def __init__(self, out):
        self.out, self.buf = out, []

    def write(self, s: str) -> int:
        self.buf.append(s)
        return self.out.write(s)

    def flush(self) -> None:
        self.out.flush()

    def text(self) -> str:
        return "".join(self.buf)


def _attn_apps(cfg) -> int:
    """Self-attention applications of one pass through the decoder: a
    layer's each, the hybrid's shared block's, none in the ssm family."""
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.hybrid.attn_period
    return 0 if cfg.family == "ssm" else cfg.n_layers


def cli_phase(arch: str = ARCH) -> dict:
    """``python -m repro_torch.launch.serve --full --arch arch
    --no-cache`` (the eager warmup, as in PRs 12-22; its compiled warmup
    is phase 24's warm half) at its defaults, in this process (its output
    goes to this script's): rc 0,
    the mode its family takes (batched, or per-slot for ssm and hybrid),
    its prefills through flash at every attention application, its
    decode steps through the flash-decode kernel at every attention
    application of every step (never under a sliding window), and its
    prefills through the SSD kernel at every Mamba2 layer."""
    import contextlib
    from repro_torch.configs import get_config
    from repro_torch.kernels.dispatch import launch_counts, reset_launches
    from repro_torch.launch.serve import serve
    from repro_torch.models import lm
    cfg = get_config(arch)
    mode = "per-slot" if cfg.family in lm.PER_SLOT_FAMILIES else "batched"
    per_call = {"flash_attention": _attn_apps(cfg),
                "decode_attention": _decode_apps(cfg),
                "ssd_scan": cfg.n_layers if cfg.ssm is not None else 0}
    reset_launches()
    tee = _Tee(sys.stdout)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(tee):
        # --no-cache: the eager warmup these runs have always had (the
        # compiled path is phase 24's, whose warm half is launch.serve)
        rc = serve(["--full", "--arch", arch, "--no-cache"])
    wall = time.perf_counter() - t0
    counts = launch_counts()
    if rc != 0 or f"mode={mode}" not in tee.text():
        raise AssertionError(f"launch.serve --full --arch {arch} returned "
                             f"{rc}, expected 0 and mode={mode}")
    for op, k in per_call.items():
        n = counts.get(op, 0)
        if k and (n == 0 or n % k) or not k and n:
            raise AssertionError(f"launch.serve --full --arch {arch}: {op} "
                                 f"{n} launches, not a whole number of "
                                 f"{k} a call: {counts}")
    log(f"cli: repro_torch.launch.serve --full --arch {arch} returned 0 in "
        f"{wall:.1f} s, mode={mode}; launches {counts}")
    return dict(arch=arch, rc=rc, mode=mode, wall_s=wall, launches=counts)


# ---------------------------------------------------------------------------
# phase 9: the card against the CPU on the same weights
# ---------------------------------------------------------------------------

class _RouteLog:
    """Records every call of the MoE router (``layers.moe_router``): the
    device, each token's chosen experts in order and the float32
    probabilities they were chosen from, both on the host."""

    def __init__(self):
        from repro_torch.models import layers
        self.layers, self.router = layers, layers.moe_router
        self.calls = []

        def router(p, cfg, x):
            out = self.router(p, cfg, x)
            self.calls.append((x.device.type, out[0].detach().cpu(),
                               out[2].cpu()))
            return out
        layers.moe_router = router

    def take(self) -> list:
        calls, self.calls = self.calls, []
        return calls

    def restore(self) -> None:
        self.layers.moe_router = self.router


def _route_diffs(cfg, calls: list, rows: int, tainted: set,
                 what: str) -> list:
    """Compare the experts the card and the CPU chose, call by call (one
    a layer, CPU first).  A token whose ordered choice differs with a
    decisive gap (the smallest gap between its K + 1 largest CPU
    probabilities) of ``ROUTE_MARGIN`` or more fails; under it the
    difference is float-class: reported, and its row (``rows`` rows of
    ``T / rows`` tokens) is added to ``tainted``, as is every row whose
    kept copies then differ through the shared capacity.  Tokens of
    rows already tainted are not compared."""
    from repro_torch.models import layers as L
    cpu = [c for c in calls if c[0] == "cpu"]
    card = [c for c in calls if c[0] != "cpu"]
    if len(cpu) != cfg.n_layers or len(card) != cfg.n_layers:
        raise AssertionError(f"{what}: {len(cpu)} CPU and {len(card)} card "
                             f"router calls, expected {cfg.n_layers} each")
    E, K = cfg.moe.n_experts, cfg.moe.top_k
    found = []
    for layer, ((_, probs, tope_c), (_, _, tope_g)) in enumerate(
            zip(cpu, card)):
        T = tope_c.shape[0]
        per_row = T // rows
        top = probs.topk(K + 1, dim=-1).values
        gap = (top[:, :-1] - top[:, 1:]).min(dim=-1).values
        flips = []
        for t in torch.nonzero((tope_c != tope_g).any(-1)).flatten().tolist():
            row = t // per_row
            if row in tainted:
                continue
            item = dict(what=what, layer=layer, token=t, row=row,
                        gap=float(gap[t]), cpu=tope_c[t].tolist(),
                        card=tope_g[t].tolist())
            if item["gap"] >= ROUTE_MARGIN:
                raise AssertionError(f"card vs CPU: routing differs beyond "
                                     f"float class: {item}")
            flips.append(item)
        if flips:
            C = L.moe_capacity(T, cfg)
            kept = [torch.where(L.moe_slots(tp, E) < C, tp, -1)
                    for tp in (tope_c, tope_g)]
            knock = torch.nonzero((kept[0] != kept[1]).any(-1)).flatten()
            for it in flips:
                tainted.add(it["row"])
            for t in knock.tolist():
                if t // per_row not in tainted:
                    flips.append(dict(what=what, layer=layer, token=t,
                                      row=t // per_row, capacity=True))
                    tainted.add(t // per_row)
            found.extend(flips)
            log(f"card vs cpu: float-class routing difference at {what}, "
                f"layer {layer}: {flips}; rows {sorted(tainted)} left out "
                f"of the logit comparison from here")
    return found


def _vs_cpu_cfg(arch: str):
    """``arch`` as phases 9, 20 and 32 hold it against the CPU: full width
    cut to 2 layers, float32, the kernels' path, its window cut where
    ``CPU_WINDOW`` names one."""
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config(arch), n_layers=2, dtype="float32",
                              attn_impl="kernel")
    if arch in CPU_WINDOW:
        cfg = dataclasses.replace(cfg, sliding_window=CPU_WINDOW[arch])
    return cfg


def _vs_cpu_inputs(cfg) -> tuple:
    """The card-vs-CPU prompts: 4 ragged lengths, the tokens in their
    bucket, ``max_seq``, and the vlm's patches (host tensors)."""
    rng = np.random.default_rng(1)
    if cfg.vlm is None:
        lens = np.array([37, 512, *rng.integers(38, 512, 2)], np.int32)
        bucket, max_seq = 512, 1024
    else:       # text after the 576 patch positions of every prompt
        lens = np.array([600, 1024, *rng.integers(601, 1024, 2)], np.int32)
        bucket, max_seq = 1024, 2048
    toks = np.zeros((len(lens), bucket), np.int32)
    for i, n in enumerate(lens):
        toks[i, :n] = rng.integers(0, cfg.vocab, n)
    extra = {}
    if cfg.vlm is not None:
        extra["patches"] = torch.from_numpy(rng.standard_normal(
            (len(lens), cfg.vlm.n_patches, cfg.vlm.d_patch))
            .astype(np.float32))
    return lens, toks, bucket, max_seq, extra


def _serve_steps(cfg, params, toks, lens, max_seq: int, extra: dict,
               dev: str = "cpu"):
    """One side of a card-vs-CPU run on ``dev``, a step at a time: yields
    the bucketed prefill's logits, then each of ``CPU_STEPS`` decode
    steps' on the token it is sent (the greedy token of the CPU's
    logits)."""
    from repro_torch.models import lm
    logits, cache = lm.prefill(
        params, cfg, torch.from_numpy(toks).to(dev), extra=extra,
        max_seq=max_seq, true_len=torch.from_numpy(lens).to(dev))
    for _ in range(CPU_STEPS):
        tok = yield logits
        logits, cache = lm.decode_step(params, cfg, tok.to(dev), cache)
    yield logits


def cpu_serving_half(arch: str) -> dict:
    """Phase 32's CPU half of ``arch`` (in the child process): the logits
    of the prefill and of ``CPU_STEPS`` greedy decode steps, from
    ``lm.init_params(cfg, 1)`` on the CPU (plain versions)."""
    from repro_torch.models import lm
    cfg = _vs_cpu_cfg(arch)
    lens, toks, _, max_seq, extra = _vs_cpu_inputs(cfg)
    params = lm.init_params(cfg, 1, device="cpu")
    steps = _serve_steps(cfg, params, toks, lens, max_seq, extra)
    out = [next(steps)]
    with torch.no_grad():
        for _ in range(CPU_STEPS):
            out.append(steps.send(out[-1].argmax(-1).to(torch.int32)))
    return dict(logits=out)


def card_vs_cpu(arch: str = ARCH, cpu: list | None = None,
                p_cpu: dict | None = None) -> dict:
    """Phase 9 (and 20 at the moe and vlm models, 32 at the dense ones):
    ``arch`` at full width cut to 2 layers, float32, the same weights on
    the card and the CPU: bucketed prefill of 4 ragged prompts (the vlm's
    with patches over its first 576 positions), then ``CPU_STEPS`` ragged
    decode steps on the CPU's greedy tokens; logits within
    ``LOGIT_REL_TOL`` of their largest magnitude, greedy tokens equal.
    An MoE's expert choices are compared first (:func:`_route_diffs`).
    The CPU's logits are computed here step by step, or given as
    ``cpu`` (phase 32: the child process's, :func:`cpu_serving_half`);
    ``p_cpu`` are the weights, ``lm.init_params(cfg, 1)`` on the CPU,
    where they were drawn already."""
    from repro_torch.kernels.dispatch import launch_counts, reset_launches
    from repro_torch.models import lm
    cfg = _vs_cpu_cfg(arch)
    lens, toks, bucket, max_seq, extra = _vs_cpu_inputs(cfg)
    if p_cpu is None:
        p_cpu = lm.init_params(cfg, 1, device="cpu")

    def to_card(t):
        return {k: to_card(v) for k, v in t.items()} \
            if isinstance(t, dict) else t.to(DEV)
    p_card = to_card(p_cpu)
    if cpu is None:
        cpu = _serve_steps(cfg, p_cpu, toks, lens, max_seq, extra)
    else:
        del p_cpu
        cpu = iter(cpu)
    card = _serve_steps(cfg, p_card, toks, lens, max_seq,
                      {k: v.to(DEV) for k, v in extra.items()}, DEV)
    routes = _RouteLog() if cfg.moe is not None else None
    tainted, flips = set(), []
    reset_launches()
    logits = {}
    try:
        logits["cpu"], logits[DEV] = next(cpu), next(card)
        steps = []

        def compare(what: str) -> torch.Tensor:
            if routes is not None:
                flips.extend(_route_diffs(cfg, routes.take(), len(lens),
                                          tainted, what))
            keep = [i for i in range(len(lens)) if i not in tainted]
            if not keep:
                raise AssertionError(f"card vs CPU ({arch}) at {what}: "
                                     f"every row left out after "
                                     f"float-class routing differences")
            want = logits["cpu"].double()
            got = logits[DEV].cpu().double()
            rel = float((got - want)[keep].abs().max()
                        / want[keep].abs().max())
            tok_c, tok_g = want.argmax(-1), got.argmax(-1)
            equal = bool(torch.equal(tok_c[keep], tok_g[keep]))
            steps.append(dict(what=what, rel_err=rel, greedy_equal=equal,
                              rows_compared=keep))
            if rel > LOGIT_REL_TOL or not equal:
                raise AssertionError(
                    f"card vs CPU ({arch}) at {what}: rel {rel:.3e} (limit "
                    f"{LOGIT_REL_TOL:g}), greedy {tok_g.tolist()} vs "
                    f"{tok_c.tolist()} (rows {keep})")
            return tok_c.to(torch.int32)

        tok = compare("prefill")
        for s in range(CPU_STEPS):
            logits["cpu"] = cpu.send(tok) if hasattr(cpu, "send") \
                else next(cpu)
            logits[DEV] = card.send(tok)
            tok = compare(f"decode {s}")
    finally:
        if routes is not None:
            routes.restore()
    counts = launch_counts()
    if counts.get("flash_attention", 0) != cfg.n_layers or \
            counts.get("decode_attention", 0) != \
            CPU_STEPS * _decode_apps(cfg):
        raise AssertionError(f"card side did not go through the kernels: "
                             f"{counts}")
    worst = max(s["rel_err"] for s in steps)
    log(f"card vs cpu: {arch} at 2 layers, float32, prompts {lens.tolist()} "
        f"in a {bucket} bucket"
        + (" with patches" if cfg.vlm is not None else "")
        + (f", window {cfg.sliding_window}" if cfg.sliding_window else "")
        + f" + {CPU_STEPS} ragged decode steps: logits within {worst:.2e} "
        f"of max |logit| (limit {LOGIT_REL_TOL:g}), greedy tokens equal"
        + (f"; float-class routing differences: {len(flips)}"
           if routes is not None else "") + f"; launches {counts}")
    return dict(arch=arch, layers=cfg.n_layers, prompt_lens=lens.tolist(),
                bucket=bucket, sliding_window=cfg.sliding_window,
                steps=steps, max_rel_err=worst, launches=counts,
                route_flips=flips, rows_left_out=sorted(tainted))


# ---------------------------------------------------------------------------
# phases 11-15: training — Mamba2-130M through the SSD kernel, Qwen3-0.6B
# through flash attention and its backward
# ---------------------------------------------------------------------------

TRAIN_ARCH = "mamba2-130m"
TRAIN = dict(batch=8, seq=2048, steps=20)
QWEN_TRAIN = dict(batch=4, seq=1024, steps=3)
# Phase 27: the sharded step on a (1, 1) mesh against the unsharded step,
# the same weights and batches.  On one rank every redistribution is a
# no-op and the local ops are the unsharded step's, on the same shapes
# (bitwise equal on the CPU, tests/test_torch_sharded_train.py): any gap
# means the two ran different math.
SHARD_LOSS_TOL = 0.0
SHARD_GNORM_REL = 0.0
SSD_REPLACES = "src/repro/kernels/ssd_scan.py:43"
# the SSD's device kernels, as the profiler names them; the first is
# launched once a call (phase 15 counts calls by it)
SSD_KERNELS = ("ssd_state_mma", "ssd_state_pass", "ssd_scan_mma")
# SSD cases of phase 11: (tag, B, S, H, G, P, N, chunk, decays, s0 scale).
# "model" decays are Mamba2's own (A = -linspace(1, 16, H), dt =
# softplus(N(0, 1))): the running sum of dt * A reaches ~-1e3 within a
# chunk and exp(cum_end) underflows, so the state pass carries ~nothing;
# "small" decays (dt in [1e-3, 1e-1], the published Mamba-2 dt range, A in
# [-1, -0.1]) make the inter-chunk term a visible part of y.
SSD_CASES = [
    ("train", 8, 2048, 24, 1, 64, 128, 256, "model", 0.0),
    ("train small", 8, 2048, 24, 1, 64, 128, 256, "small", 1.0),
    ("B=1", 1, 2048, 24, 1, 64, 128, 256, "model", 1.0),
    ("S=1000 pad", 2, 1000, 24, 1, 64, 128, 256, "small", 1.0),
    ("G=2", 2, 1024, 24, 2, 64, 128, 256, "small", 1.0),
    ("N=64 Q=128", 2, 1024, 8, 1, 64, 64, 128, "small", 1.0),
    ("reduced 16x16 Q=16", 2, 64, 8, 1, 16, 16, 16, "small", 1.0),
    # the per-slot prefill (B = 1, chunk = min(256, S)): zamba2-1.2b's 64
    # heads in one group with N = 64 at prompts below a tile (8, 37: rows
    # and keys past the chunk), one short of the chunk, at it and past it
    # (1000, 1500: the pad path), from a zero state as a prefill starts;
    # mamba2-130m's N = 128 at 37
    ("zamba2 S=8", 1, 8, 64, 1, 64, 64, 8, "model", 0.0),
    ("zamba2 S=37", 1, 37, 64, 1, 64, 64, 37, "model", 0.0),
    ("zamba2 S=37 small", 1, 37, 64, 1, 64, 64, 37, "small", 1.0),
    ("zamba2 S=255", 1, 255, 64, 1, 64, 64, 255, "model", 0.0),
    ("zamba2 S=256", 1, 256, 64, 1, 64, 64, 256, "model", 0.0),
    ("zamba2 S=1000", 1, 1000, 64, 1, 64, 64, 256, "model", 0.0),
    ("zamba2 S=1500 small", 1, 1500, 64, 1, 64, 64, 256, "small", 1.0),
    ("mamba2 S=37", 1, 37, 24, 1, 64, 128, 37, "model", 0.0),
    ("mamba2 S=37 small", 1, 37, 24, 1, 64, 128, 37, "small", 1.0),
]
# timed shapes beside the training shape (SSD_CASES[0]): the per-slot
# prefills of phase 21 and zamba2's training shape of phase 29, (B, S, H,
# G, P, N, chunk)
SSD_TIMES = [(1, 1000, 64, 1, 64, 64, 256), (1, 1000, 24, 1, 64, 128, 256),
             (1, 37, 64, 1, 64, 64, 37), (2, 2048, 64, 1, 64, 64, 256)]
# Kernel vs plain version, max |kernel - plain| / max |y64|, where y64 is
# the plain version evaluated in float64 on the card from the same inputs;
# the kernel against y64 is held to the same limit, and both errors
# against y64 are printed.  The plain version forms the running sum of dA
# in float32 (the kernel in double); at the model's decays (|cum| up to
# ~3e3) that rounding reaches y only through the terms near the diagonal,
# whose exponents are short differences: it measured 1.1e-5 of max |y|
# against float64, the kernel 4.3e-7 (on an H100 80GB HBM3 at 700 W).  At
# small decays both measured ~1e-6 (float32 summation order).  The limits
# are 5x those.
SSD_REL_TOL = {"model": 5e-5, "small": 5e-6}
SSD_MIN_INTER = 1e-2        # small decays: inter-chunk share of max |y|
# Card vs CPU (phase 14), same float32 weights and tokens: loss relative;
# each gradient leaf relative to its largest magnitude; each parameter's
# change after one AdamW step relative to its largest change.  Both sides
# take the SSD's torch-ops recompute in the backward, in float32, summed in
# other orders; the largest difference is A_log's gradient, a sum of
# B * S * P * N terms of both signs (measured 4.1e-4, the step's 7.8e-4,
# on the card above).  AdamW with eps 1e-5, so no gradient element
# sits near eps (Adam's first step moves an element by lr * g / (|g| +
# eps), which turns float32 differences of elements near eps into
# differences of lr size).
TRAIN_CPU_TOL = dict(loss=1e-5, grad=1e-3, step=5e-3)


def _ssd_inputs(gen, B, S, H, G, P, N, decays, s0_scale) -> tuple:
    def r(*shape):
        return torch.randn(shape, generator=gen, device=DEV)

    def u(lo, hi, *shape):
        return lo + (hi - lo) * torch.rand(shape, generator=gen, device=DEV)
    x, Bm, Cm = r(B, S, H, P), r(B, S, G, N), r(B, S, G, N)
    if decays == "model":
        dt = torch.nn.functional.softplus(r(B, S, H))
        A = -torch.linspace(1.0, 16.0, H, device=DEV)
    else:
        dt, A = u(1e-3, 1e-1, B, S, H), -u(0.1, 1.0, H)
    return x, dt, A, Bm, Cm, r(B, H, P, N) * s0_scale


def _ssd_f64(x, dt, A, Bm, Cm, chunk, s0) -> tuple:
    """The model-layout SSD (no D skip) through the plain version in
    float64: padded with dt = 0 to a whole number of chunks, trimmed."""
    from repro_torch.kernels.ssd_scan import ssd_scan_plain
    S = x.shape[1]
    pad = (-S) % chunk
    x, dt, Bm, Cm = (t.double() for t in (x, dt, Bm, Cm))
    if pad:
        x, Bm, Cm = (torch.nn.functional.pad(t, (0, 0, 0, 0, 0, pad))
                     for t in (x, Bm, Cm))
        dt = torch.nn.functional.pad(dt, (0, 0, 0, pad))
    y, s = ssd_scan_plain(x * dt[..., None], dt * A.double(), Bm, Cm,
                          s0.double(), chunk=chunk)
    return y[:, :S], s


def check_ssd() -> tuple[list, float]:
    """Phase 11, checks: ``ops.ssd_scan`` (the kernel on the card) against
    the plain version through the same wrapper, both against float64;
    raises past a limit.  Returns the cases and the largest absolute
    difference."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.ssd_scan import ssd_scan_plain, ssd_sequence
    gen = torch.Generator(device=DEV).manual_seed(11)
    rows, worst = [], 0.0
    for tag, B, S, H, G, P, N, Q, decays, s0s in SSD_CASES:
        x, dt, A, Bm, Cm, s0 = _ssd_inputs(gen, B, S, H, G, P, N, decays,
                                           s0s)
        D = torch.zeros(H, device=DEV)       # y is the scan alone
        y, s = ops.ssd_scan(x, dt, A, Bm, Cm, D, chunk=Q, init_state=s0)
        yp, sp = ssd_sequence(ssd_scan_plain, x, dt, A, Bm, Cm, D, Q, s0)
        y64, s64 = _ssd_f64(x, dt, A, Bm, Cm, Q, s0)
        torch.cuda.synchronize()
        ys, ss = float(y64.abs().max()), float(s64.abs().max())

        def rel(a, b, scale):
            return float((a.double() - b.double()).abs().max()) / scale
        row = dict(case=tag, B=B, S=S, H=H, G=G, P=P, N=N, chunk=Q,
                   decays=decays, s0_scale=s0s, max_abs_y=ys,
                   y_kernel_vs_plain=rel(y, yp, ys),
                   y_kernel_vs_f64=rel(y, y64, ys),
                   y_plain_vs_f64=rel(yp, y64, ys),
                   state_kernel_vs_plain=rel(s, sp, ss),
                   state_kernel_vs_f64=rel(s, s64, ss),
                   state_plain_vs_f64=rel(sp, s64, ss),
                   max_abs_err=max(float((y - yp).abs().max()),
                                   float((s - sp).abs().max())))
        if decays == "small" and S % Q == 0:
            # the same chunks with the state pass cut: each chunk alone
            nb = B * S // Q
            yi, _ = ssd_scan_plain(
                (x * dt[..., None]).reshape(nb, Q, H, P),
                (dt * A).reshape(nb, Q, H), Bm.reshape(nb, Q, G, N),
                Cm.reshape(nb, Q, G, N),
                torch.zeros((nb, H, P, N), device=DEV), chunk=Q)
            row["inter_share"] = rel(yp, yi.reshape(B, S, H, P), ys)
        tol = SSD_REL_TOL[decays]
        log(f"ssd {tag:20s} B={B} S={S} H={H} G={G} P={P} N={N} Q={Q} "
            f"{decays:5s}: y kernel-plain {row['y_kernel_vs_plain']:.2e} "
            f"kernel-f64 {row['y_kernel_vs_f64']:.2e} plain-f64 "
            f"{row['y_plain_vs_f64']:.2e}; state {row['state_kernel_vs_plain']:.2e}"
            f" / {row['state_kernel_vs_f64']:.2e} / "
            f"{row['state_plain_vs_f64']:.2e} (limit {tol:g})"
            + (f"; inter-chunk share {row['inter_share']:.3e}"
               if "inter_share" in row else ""))
        rows.append(row)
        bad = [k for k in ("y_kernel_vs_plain", "y_kernel_vs_f64",
                           "state_kernel_vs_plain", "state_kernel_vs_f64")
               if not row[k] <= tol]
        if bad or not (np.isfinite(ys) and np.isfinite(ss)):
            raise AssertionError(f"ssd_scan differs from plain: {bad} {row}")
        if row.get("inter_share", 1.0) < SSD_MIN_INTER:
            raise AssertionError(f"ssd {tag}: the inter-chunk term is not "
                                 f"visible ({row['inter_share']:.2e})")
        worst = max(worst, row["max_abs_err"])
        del x, dt, Bm, Cm, s0, y, s, yp, sp, y64, s64
    torch.cuda.empty_cache()
    return rows, worst


def _ssd_work(B, S, H, G, P, N, Q) -> tuple[int, int]:
    """(bytes, flops) the SSD scan needs at a shape: inputs read once,
    outputs written once; the causal half of C B^T once per (batch row,
    chunk, group), which the heads of the group share, and per head the
    causal half of its decayed product with xdt, the state read, the
    chunk's own state and the state pass.  A sequence that is not a
    whole number of chunks ends in a short chunk (the pad does no work
    of the function's)."""
    nbytes = 4 * (2 * B * S * H * P + B * S * H + 2 * B * S * G * N
                  + 2 * B * H * P * N)

    def chunk(q):
        tri = q * (q + 1) // 2
        return G * tri * 2 * N + H * (tri * 2 * P + 2 * q * 2 * P * N
                                      + 2 * P * N)
    full, tail = divmod(S, Q)
    return nbytes, B * (full * chunk(Q) + (chunk(tail) if tail else 0))


# the tensor cores' TF32 rate; 3xTF32 (float32 accuracy) takes a third
TF32_FLOPS = 495e12
SSD_3XTF32_FLOPS = TF32_FLOPS / 3


def _time_ssd_shape(gen, B, S, H, G, P, N, Q, reps, warm) -> dict:
    """CUDA-event times of the SSD kernel and its plain version at one
    shape (model decays, zero state), the bound, and the three kernels'
    device time per call from the profiler."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels.ssd_scan import ssd_scan_fwd, ssd_scan_plain
    x, dt, A, Bm, Cm, s0 = _ssd_inputs(gen, B, S, H, G, P, N, "model", 0.0)
    pad = (-S) % Q              # as ssd_sequence pads a prompt
    xdt = torch.nn.functional.pad(x * dt[..., None], (0, 0, 0, 0, 0, pad))
    dA = torch.nn.functional.pad(dt * A, (0, 0, 0, pad))
    Bm, Cm = (torch.nn.functional.pad(t, (0, 0, 0, 0, 0, pad))
              for t in (Bm, Cm))
    del x
    nbytes, flops = _ssd_work(B, S, H, G, P, N, Q)
    # the kernel's products run in 3xTF32 (float32 accuracy): its bound;
    # the float32 CUDA cores' bound beside it
    bnd, by = bound_ms(nbytes, flops, SSD_3XTF32_FLOPS)
    bnd_fp32, _ = bound_ms(nbytes, flops, CUDA_CORE_OPS_PER_S)

    def kern(i):
        return ssd_scan_fwd(xdt, dA, Bm, Cm, s0, chunk=Q)
    ms = time_ms(kern, reps=reps, warm=warm)
    plain_ms = time_ms(lambda i: ssd_scan_plain(xdt, dA, Bm, Cm, s0,
                                                chunk=Q), reps=3, warm=1)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(5):
            kern(i)
        torch.cuda.synchronize()
    # each kernel's mean over the launches the profiler kept (it may keep
    # more of one kernel's than of another's in a short window)
    tot = {}
    for e in prof.key_averages():
        for nm in SSD_KERNELS:
            if nm in e.key and e.count:
                t, n = tot.get(nm, (0.0, 0))
                tot[nm] = (t + float(getattr(e, "self_device_time_total",
                                             0.0) or 0.0), n + e.count)
    per = {k: t / n for k, (t, n) in tot.items()}
    dev_ms = sum(per.values()) / 1e3 if len(per) == len(SSD_KERNELS) \
        else None
    out = dict(shape=f"B={B} S={S} H={H} G={G} P={P} N={N} chunk={Q} f32",
               ms=ms, plain_ms=plain_ms, library_ms=None, bound_ms=bnd,
               bound_by=by, bound_peak="3xTF32 tensor cores, 495 / 3 "
               "TFLOP/s", bound_fp32_ms=bnd_fp32,
               bound_tf32_ms=max(nbytes / HBM_BYTES_PER_S, flops / TF32_FLOPS)
               * 1e3, bytes=nbytes, flops=flops, device_ms=dev_ms,
               device_us_by_kernel=per, tflops=flops / ms / 1e9)
    log(f"time ssd_scan {out['shape']}: kernel {ms * 1e3:9.2f} us "
        f"({out['tflops']:.1f} TFLOP/s), device "
        + (f"{dev_ms * 1e3:.2f} us (" + ", ".join(
            f"{k} {v:.2f}" for k, v in per.items()) + " us)"
           if dev_ms is not None else "not measured")
        + f"; plain {plain_ms * 1e3:9.2f} us; library none; bound "
        f"{bnd * 1e3:.3f} us ({by}: {nbytes / 1e6:.1f} MB, "
        f"{flops / 1e9:.2f} GFLOP at 495 / 3 TFLOP/s 3xTF32; fp32 CUDA "
        f"cores {bnd_fp32 * 1e3:.3f} us; single TF32 "
        f"{out['bound_tf32_ms'] * 1e3:.3f} us)")
    del xdt, dA, Bm, Cm, s0
    torch.cuda.empty_cache()
    return out


def time_ssd() -> dict:
    """Phase 11, times: at the training shape (the head of the result),
    then at the per-slot prefill shapes of ``SSD_TIMES`` (``by_shape``)."""
    gen = torch.Generator(device=DEV).manual_seed(12)
    _, B, S, H, G, P, N, Q, _, _ = SSD_CASES[0]
    out = _time_ssd_shape(gen, B, S, H, G, P, N, Q, reps=10, warm=2)
    out["by_shape"] = [dict(out)] + [
        _time_ssd_shape(gen, *shape, reps=50, warm=5)
        for shape in SSD_TIMES]
    return out


def _finite_tree(tree) -> bool:
    return all(bool(torch.isfinite(t).all()) for t in _leaves(tree)
               if t.is_floating_point())


def train_phase() -> dict:
    """Phase 12: ``repro_torch.launch.train`` at full width through a
    (1, 1) mesh, then the same command without ``--model-parallel`` (the
    unsharded driver), which must resume at the last step and run none."""
    import tempfile
    from repro_torch.ckpt import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.kernels.dispatch import launch_counts, reset_launches
    from repro_torch.launch.train import train
    from repro_torch.models import lm
    from repro_torch.optim import AdamWConfig, adamw_init
    cfg = get_config(TRAIN_ARCH)
    B, S, steps = TRAIN["batch"], TRAIN["seq"], TRAIN["steps"]
    with tempfile.TemporaryDirectory() as tmp:
        ck, mpath = str(Path(tmp) / "ckpt"), Path(tmp) / "metrics.jsonl"
        plain = ["--arch", TRAIN_ARCH, "--use-kernel", "--batch", str(B),
                 "--seq", str(S), "--steps", str(steps), "--ckpt-dir", ck,
                 "--metrics", str(mpath), "--log-every", "5"]
        args = plain + ["--model-parallel", "1"]
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rc = train(args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launch_counts()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        rows = [json.loads(x) for x in mpath.read_text().splitlines()]
        want = {"ssd_scan": 2 * cfg.n_layers * steps}
        if rc != 0 or counts != want:
            raise AssertionError(f"train returned {rc}; launches {counts}, "
                                 f"expected {want} (2 x {cfg.n_layers} "
                                 f"layers x {steps} steps: remat runs each "
                                 f"layer's forward twice)")
        if len(rows) != steps or not all(
                np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"])
                for r in rows):
            raise AssertionError(f"metrics: {rows}")
        like = lm.init_params(cfg, device="meta")
        got = CheckpointManager(ck).restore_latest(
            like, adamw_init(like, AdamWConfig()), device=DEV)
        if got is None or got[0] != steps or not (
                _finite_tree(got[1]) and _finite_tree(got[2])):
            raise AssertionError(f"checkpoint at step {steps} not restorable"
                                 f" ({None if got is None else got[0]})")
        n_params = sum(t.numel() for t in _leaves(got[1]))
        del got
        reset_launches()
        rc2 = train(plain)
        again = launch_counts()
        n_rows = len(mpath.read_text().splitlines())
        if rc2 != 0 or again or n_rows != steps:
            raise AssertionError(f"unsharded rerun: rc {rc2}, launches "
                                 f"{again}, {n_rows} metric rows (expected "
                                 f"0 steps)")
    dts = [r["dt"] for r in rows]
    step_ms = float(np.median(dts[1:])) * 1e3
    out = dict(arch=TRAIN_ARCH, params=n_params, dtype=cfg.dtype, **TRAIN,
               use_kernel=True, remat=True, model_parallel=1, rc=rc,
               wall_s=wall,
               launches=counts, loss_first=rows[0]["loss"],
               loss_last=rows[-1]["loss"],
               losses=[r["loss"] for r in rows],
               grad_norms=[r["grad_norm"] for r in rows],
               first_step_ms=dts[0] * 1e3, median_step_ms=step_ms,
               mean_step_ms=float(np.mean(dts[1:])) * 1e3,
               tok_per_s=B * S / (step_ms / 1e3), peak_gb=peak_gb,
               rerun="unsharded", rerun_rc=rc2)
    log(f"train {TRAIN_ARCH} (--model-parallel 1, a (1, 1) mesh): "
        f"{n_params} params {cfg.dtype}, batch {B} x "
        f"seq {S}, {steps} steps in {wall:.1f} s (final save and checks "
        f"included); step 1 {dts[0] * 1e3:.0f} ms, then median "
        f"{step_ms:.1f} ms ({out['tok_per_s']:,.0f} tokens/s); loss "
        f"{rows[0]['loss']:.4f} -> {rows[-1]['loss']:.4f}; launches "
        f"{counts}; peak {peak_gb:.2f} GB; checkpoint {steps} restored; "
        f"unsharded rerun ran 0 steps")
    return out


def qwen_train_phase() -> dict:
    """Phase 13: Qwen3-0.6B at full width, ``make_train_step`` with the
    flash kernel forward and its autograd backward; then one step under
    the profiler."""
    from repro_torch.configs import get_config
    from repro_torch.data import make_pipeline
    from repro_torch.kernels.dispatch import launch_counts, reset_launches
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import lm
    from repro_torch.optim import AdamWConfig, adamw_init
    cfg = get_config(ARCH)
    B, S, steps = QWEN_TRAIN["batch"], QWEN_TRAIN["seq"], QWEN_TRAIN["steps"]
    params = lm.init_params(cfg, 0)
    opt = AdamWConfig(total_steps=steps, warmup_steps=1)
    state = adamw_init(params, opt)
    step_fn = make_train_step(cfg, opt, use_kernel=True)
    data = make_pipeline(cfg.vocab, S, B, seed=0)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    losses, gnorms, dts = [], [], []
    for _ in range(steps):
        batch = {k: torch.from_numpy(v).to(DEV)
                 for k, v in data.next_batch().items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, m = step_fn(params, state, batch)
        torch.cuda.synchronize()
        dts.append(time.perf_counter() - t0)
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
    counts = launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    want = {"flash_attention": 2 * cfg.n_layers * steps}
    if counts != want:
        raise AssertionError(f"qwen train: launches {counts}, expected "
                             f"{want}")
    if not (np.isfinite(losses).all() and np.isfinite(gnorms).all()
            and _finite_tree(params)):
        raise AssertionError(f"qwen train: losses {losses}, grad norms "
                             f"{gnorms}")
    # one more step, under the profiler and outside the counted run: every
    # flash launch must be the tensor-core kernel; flash's device time
    batch = {k: torch.from_numpy(v).to(DEV)
             for k, v in data.next_batch().items()}
    torch.cuda.synchronize()

    def run():
        nonlocal params, state
        reset_launches()
        t0 = time.perf_counter()
        params, state, _ = step_fn(params, state, batch)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    def check(prof, _):
        busy_us, kern = _device_times(prof)
        _check_flash_route(kern, launch_counts().get("flash_attention", 0),
                           f"train {ARCH}")
        return busy_us, kern

    _, prof_s, (busy_us, kern) = _profiled(run, check, f"train {ARCH}")
    n_flash, flash_us = kern["flash_attention"]
    del params, state
    torch.cuda.empty_cache()
    out = dict(arch=ARCH, dtype=cfg.dtype, **QWEN_TRAIN, losses=losses,
               grad_norms=gnorms, step_ms=[d * 1e3 for d in dts],
               launches=counts, peak_gb=peak_gb,
               profiled_step=dict(
                   wall_ms=prof_s * 1e3, device_busy_ms=busy_us / 1e3,
                   flash_launches=n_flash, flash_device_ms=flash_us / 1e3,
                   flash_device_us_per_launch=flash_us / n_flash))
    log(f"train {ARCH}: batch {B} x seq {S}, {steps} steps of "
        f"make_train_step(use_kernel=True): "
        + ", ".join(f"{d * 1e3:.0f}" for d in dts) + " ms; losses "
        + ", ".join(f"{v:.4f}" for v in losses) + f"; grad norms "
        + ", ".join(f"{v:.3f}" for v in gnorms)
        + f"; launches {counts}; peak {peak_gb:.2f} GB; a profiled step: "
        f"{prof_s * 1e3:.1f} ms, device busy {busy_us / 1e3:.1f} ms, flash "
        f"{n_flash} launches {flash_us / 1e3:.2f} ms "
        f"({flash_us / n_flash:.2f} us each)")
    return out


def _timed_steps(step_fn, params, state, batches) -> tuple:
    """Run ``step_fn`` over ``batches``: the final parameters and state,
    and a row a step (loss, grad norm, host ms until the call returned,
    wall ms until the card finished, device ms between CUDA events)."""
    from repro_torch.dtensor import is_dtensor
    rows = []
    for batch in batches:
        torch.cuda.synchronize()
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0 = time.perf_counter()
        e0.record()
        params, state, m = step_fn(params, state, batch)
        e1.record()
        host = time.perf_counter() - t0
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        val = {k: float(v.to_local() if is_dtensor(v) else v)
               for k, v in m.items()}
        rows.append(dict(loss=val["loss"], grad_norm=val["grad_norm"],
                         host_ms=host * 1e3, wall_ms=wall * 1e3,
                         device_ms=e0.elapsed_time(e1)))
    return params, state, rows


def _spec_bytes(tree, specs, mesh) -> int:
    """Local shard bytes of a tree of (meta) tensors laid out by specs."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.tree import named_leaves
    sp = dict(named_leaves(specs))
    return sum(math.prod(shd.local_shape(tuple(t.shape), sp[n], mesh))
               * t.element_size() for n, t in named_leaves(tree))


DRYRUN_CELL = ("qwen3-0.6b", "train_4k")
# phase 27 (c) in a process of its own on the host, started before phase
# 24 and read in phase 27: the cell runs on fake tensors (no card), its
# ~40 s alongside phase 24's compile processes, which leave cores free
DRYRUN_CHILD = """
import json, sys, time
t0 = time.perf_counter()
from repro_torch.configs import SHAPES, get_config
from repro_torch.launch.dryrun import fake_world, run_cell
from repro_torch.launch.mesh import make_production_mesh
arch, shape = sys.argv[1], sys.argv[2]
with fake_world(256):
    rec = run_cell(get_config(arch), SHAPES[shape], make_production_mesh(),
                   "pod16x16", verbose=False)
print(json.dumps({"record": rec, "seconds": time.perf_counter() - t0}))
"""
_dryrun: dict = {}


def _stop_dryrun() -> None:
    proc = _dryrun.get("proc")
    if proc is not None and proc.poll() is None:
        proc.kill()
        proc.communicate()


def start_dryrun() -> None:
    """Start phase 27's dry-run cell in a child process (once); a child
    still running when the script exits is stopped."""
    if "proc" not in _dryrun:
        atexit.register(_stop_dryrun)
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                   CUDA_VISIBLE_DEVICES="")
        _dryrun["proc"] = subprocess.Popen(
            [sys.executable, "-c", DRYRUN_CHILD, *DRYRUN_CELL],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env)
        _dryrun["t0"] = time.perf_counter()


def finish_dryrun() -> dict:
    """The dry-run child's record and seconds; raises if it failed."""
    start_dryrun()
    proc = _dryrun.pop("proc")
    try:
        out, err = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    if proc.returncode:
        raise AssertionError(f"dry run: rc {proc.returncode}\n"
                             f"{err[-3000:]}")
    got = json.loads(out.strip().splitlines()[-1])
    got["waited_s"] = time.perf_counter() - _dryrun.pop("t0")
    return got


def sharded_train_phase() -> dict:
    """Phase 27 (a) and (c): Qwen3-0.6B's train step through a (1, 1)
    mesh on the card against the unsharded step; the dry run of
    ``qwen3-0.6b x train_4k x pod16x16`` on the host."""
    import torch.distributed as dist
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.core.cost import HW
    from repro_torch.data import make_pipeline
    from repro_torch.distributed import sharding as shd
    from repro_torch.kernels.dispatch import launch_counts, reset_launches
    from repro_torch.launch.mesh import (PRODUCTION, destroy_host_group,
                                         make_host_mesh)
    from repro_torch.launch.steps import abstract_batch, make_train_step
    from repro_torch.models import lm
    from repro_torch.optim import AdamWConfig, adamw_init, opt_state_specs
    from repro_torch.tree import leaves
    cfg = get_config(ARCH)
    B, S, steps = QWEN_TRAIN["batch"], QWEN_TRAIN["seq"], QWEN_TRAIN["steps"]
    opt = AdamWConfig(total_steps=steps, warmup_steps=1)
    data = make_pipeline(cfg.vocab, S, B, seed=0)
    batches = [{k: torch.from_numpy(v).to(DEV)
                for k, v in data.next_batch().items()} for _ in range(steps)]
    params0 = lm.init_params(cfg, 0)
    step_fn = make_train_step(cfg, opt, use_kernel=True)
    reset_launches()
    _, _, plain = _timed_steps(step_fn, params0, adamw_init(params0, opt),
                               batches)
    plain_counts = launch_counts()

    t0 = time.perf_counter()
    mesh = make_host_mesh(1)
    try:
        pol = shd.for_mesh(mesh)
        pspec = shd.param_specs(cfg, mesh, pol)
        ospec = opt_state_specs(cfg, mesh, pol)
        bspec = shd.batch_spec(cfg, mesh, B, pol)
        params = shd.place_tree(params0, pspec, mesh)
        state = shd.place_tree(adamw_init(params0, opt), ospec, mesh)
        placed = [{k: shd.place(v, bspec[k], mesh) for k, v in b.items()}
                  for b in batches]
        setup_s = time.perf_counter() - t0
        reset_launches()
        params, state, sharded = _timed_steps(step_fn, params, state,
                                              placed)
        counts = launch_counts()
        want = {"flash_attention": 2 * cfg.n_layers * steps}
        if counts != want or plain_counts != want:
            raise AssertionError(f"sharded train: launches {counts} (the "
                                 f"unsharded steps {plain_counts}), "
                                 f"expected {want}")
        where = {str(t.to_local().device) for t in leaves(params)}
        if where != {"cuda:0"}:
            raise AssertionError(f"sharded train: local shards on {where}")
        for a, b in zip(plain, sharded):
            if not (np.isfinite(b["loss"]) and np.isfinite(b["grad_norm"])
                    and abs(a["loss"] - b["loss"]) <= SHARD_LOSS_TOL
                    and abs(a["grad_norm"] - b["grad_norm"])
                    <= SHARD_GNORM_REL * a["grad_norm"]):
                raise AssertionError(f"sharded train: unsharded {plain}, "
                                     f"sharded {sharded}")

        def run():
            nonlocal params, state
            reset_launches()
            t = time.perf_counter()
            params, state, _ = step_fn(params, state, placed[0])
            torch.cuda.synchronize()
            return time.perf_counter() - t

        def check(prof, _):
            busy_us, kern = _device_times(prof)
            _check_flash_route(kern, launch_counts().get(
                "flash_attention", 0), f"sharded train {ARCH}")
            return busy_us, kern

        _, prof_s, (busy_us, kern) = _profiled(run, check,
                                               f"sharded train {ARCH}")
        del params, state, placed
    finally:
        destroy_host_group()
    if dist.is_initialized():
        raise AssertionError("sharded train: a process group outlived the "
                             "phase")
    del params0, batches
    torch.cuda.empty_cache()

    # (c) the dry run of one production cell, on the host (a child
    # process); the argument bytes a rank the specs give, on an abstract
    # mesh of the production shape
    dry = finish_dryrun()
    rec, dry_s = dry["record"], dry["seconds"]
    shape = SHAPES[DRYRUN_CELL[1]]
    pmesh = shd.AbstractMesh(*PRODUCTION[False])
    pol = shd.for_mesh(pmesh, fsdp=cfg.param_count() > 5e10)
    like = shd.abstract_params(cfg)
    want_bytes = (
        _spec_bytes(like, shd.param_specs(cfg, pmesh, pol), pmesh)
        + _spec_bytes(adamw_init(like, AdamWConfig()),
                      opt_state_specs(cfg, pmesh, pol), pmesh)
        + _spec_bytes(abstract_batch(cfg, shape.global_batch,
                                     shape.seq_len),
                      shd.batch_spec(cfg, pmesh, shape.global_batch, pol),
                      pmesh))
    got_bytes = rec["memory"]["argument_size_in_bytes"]
    need = got_bytes + rec["memory"]["temp_size_in_bytes"]
    if not rec["ok"] or got_bytes != want_bytes or \
            need >= HW["hbm_capacity"]:
        raise AssertionError(f"dry run: ok {rec['ok']}, argument bytes "
                             f"{got_bytes}, the specs give {want_bytes}; "
                             f"with the temporaries {need} B a rank, the "
                             f"card holds {HW['hbm_capacity']:.0f}")

    def med(rows, k):
        return float(np.median([r[k] for r in rows[1:]]))
    out = dict(
        arch=ARCH, dtype=cfg.dtype, **QWEN_TRAIN, mesh={"data": 1,
                                                        "model": 1},
        setup_s=setup_s, unsharded=plain, sharded=sharded,
        launches=counts, loss_gap=[abs(a["loss"] - b["loss"])
                                   for a, b in zip(plain, sharded)],
        host_ms={"unsharded": med(plain, "host_ms"),
                 "sharded": med(sharded, "host_ms")},
        device_ms={"unsharded": med(plain, "device_ms"),
                   "sharded": med(sharded, "device_ms")},
        wall_ms={"unsharded": med(plain, "wall_ms"),
                 "sharded": med(sharded, "wall_ms")},
        profiled_step=dict(wall_ms=prof_s * 1e3,
                           device_busy_ms=busy_us / 1e3,
                           flash_launches=kern["flash_attention"][0],
                           flash_device_ms=kern["flash_attention"][1] / 1e3),
        dryrun=dict(cell=f"{ARCH}|train_4k|pod16x16", seconds=dry_s,
                    waited_s=dry["waited_s"], record=rec,
                    spec_arg_bytes=want_bytes))
    log(f"sharded train {ARCH}: 3 steps on a (1, 1) mesh vs unsharded: "
        f"losses " + ", ".join(f"{a['loss']:.5f}/{b['loss']:.5f}"
                               for a, b in zip(plain, sharded))
        + f"; grad norms " + ", ".join(
            f"{a['grad_norm']:.4f}/{b['grad_norm']:.4f}"
            for a, b in zip(plain, sharded))
        + f"; host ms a step {out['host_ms']['unsharded']:.1f} unsharded, "
        f"{out['host_ms']['sharded']:.1f} sharded; device ms "
        f"{out['device_ms']['unsharded']:.1f} / "
        f"{out['device_ms']['sharded']:.1f}; wall ms "
        f"{out['wall_ms']['unsharded']:.1f} / {out['wall_ms']['sharded']:.1f}"
        f"; first sharded step {sharded[0]['wall_ms']:.0f} ms; launches "
        f"{counts}; placement {setup_s:.1f} s")
    log(f"dry run {ARCH} x train_4k x pod16x16 (256 fake ranks, a child "
        f"process started before phase 24): {dry_s:.1f} s, argument bytes "
        f"{got_bytes} (= the specs'), "
        f"temp estimate {rec['memory']['temp_size_in_bytes']}, flops "
        f"{rec['cost']['flops']:.4g}, collectives "
        f"{rec['collectives']}")
    return out


PIPE = dict(microbatches=4, seq=1024)   # phase 28 (b): M x [1, S, d]
MESH_TURNS = 5              # phase 28: timed calls after an untimed one
COMPRESS_ERR = 0.01         # the reference's round-trip bound (64 x 64)


def compress_check(grads: dict, mesh) -> dict:
    """Phase 28 (a): ``ef_compressed_mean`` of ``grads`` over the one-rank
    ``data`` group equals each leaf's local ``dequant(q)`` bitwise; each
    leaf's ``(q, scale)`` equals the CPU run of ``quantize_int8`` on the
    same gradient bitwise; each leaf's ``compression_error`` within what
    rounding to the nearest of 255 levels allows (every element off by at
    most ``scale / 2``: ``scale / 2 * sqrt(n) / |g|``), and under
    ``COMPRESS_ERR`` on the reference's case, a seeded 64 x 64 normal
    matrix.  A real gradient's error is recorded, not held to
    ``COMPRESS_ERR``: its heavy tails put ``scale`` (its largest
    magnitude over 127) far above a typical element.  The mean's time is
    the median of ``MESH_TURNS`` calls after the checked one, which sets
    up the group's communicator."""
    from repro_torch.distributed import compress as C
    from repro_torch.tree import named_leaves
    err0 = C.init_error_state(grads)
    mean, _ = C.ef_compressed_mean(grads, err0, mesh, "data")
    means = dict(named_leaves(mean))
    samples = []
    for _ in range(MESH_TURNS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        C.ef_compressed_mean(grads, err0, mesh, "data")
        torch.cuda.synchronize()
        samples.append(time.perf_counter() - t0)
    mean_s = statistics.median(samples)
    bad, errors = [], {}
    for name, g in named_leaves(grads):
        q, scale = C.quantize_int8(g)
        q_cpu, scale_cpu = C.quantize_int8(g.cpu())
        err = errors[name] = C.compression_error(g)
        bound = float(scale) / 2 * math.sqrt(g.numel()) / max(
            float(torch.linalg.norm(g.float())), 1e-30)
        why = [w for w, ok in (
            ("mean", torch.equal(means[name], C.dequantize_int8(q, scale))),
            ("q", torch.equal(q.cpu(), q_cpu)),
            ("scale", float(scale) == float(scale_cpu)),
            ("error", err <= bound)) if not ok]
        if why:
            bad.append((name, why, err, bound))
    gen = torch.Generator(device=DEV).manual_seed(64)
    normal = C.compression_error(torch.randn((64, 64), generator=gen,
                                             device=DEV))
    worst = max(errors.items(), key=lambda t: t[1])
    over = sorted(n for n, e in errors.items() if e >= COMPRESS_ERR)
    out = dict(leaves=len(means), mean_s=mean_s, mean_s_samples=samples,
               errors=errors,
               worst_error=worst, over_limit=over, normal_64x64=normal,
               failed=bad)
    log(f"compress: ef_compressed_mean of {len(means)} bf16 gradient "
        f"leaves over a one-rank data group in {mean_s * 1e3:.1f} ms (median "
        f"of {len(samples)} after the first); the "
        f"local dequant(q), the CPU's (q, scale) and the rounding bound "
        f"{'held for every leaf' if not bad else 'FAILED: ' + str(bad)}; "
        f"round-trip error: worst {worst[1]:.4f} ({worst[0]}), "
        f"{len(over)} of {len(errors)} leaves at or over {COMPRESS_ERR}, "
        f"64 x 64 normal {normal:.5f} (limit {COMPRESS_ERR})")
    if bad or not normal < COMPRESS_ERR:
        raise AssertionError(f"compress: {bad}, 64 x 64 normal {normal}")
    return out


def pipeline_check(cfg, layers: dict, mesh, device) -> dict:
    """Phase 28 (b): every decoder layer as one stage of ``pipeline_apply``
    over the one-rank ``stage`` mesh, ``PIPE`` microbatches of hidden
    states: outputs bitwise those of the stage applied microbatch by
    microbatch; ``pipeline_loss_fn``'s gradients (an MSE tail against
    seeded labels) bitwise autograd's through that direct loop; the
    launch counts of each forward, and the ms of both: the median of
    ``MESH_TURNS`` turns after an untimed one, the two taking turns."""
    from repro_torch.distributed.pipeline import (pipeline_apply,
                                                  pipeline_loss_fn,
                                                  stack_stage_params)
    from repro_torch.kernels.dispatch import launch_counts, reset_launches
    from repro_torch.models import lm
    from repro_torch.tree import leaves, tree_map
    M, S = PIPE["microbatches"], PIPE["seq"]
    positions = torch.arange(S, device=device).expand(1, S)

    def stage_fn(p, x):
        stage = {"layers": tree_map(lambda t: t[0], p)}
        for i in range(cfg.n_layers):
            x = lm._attn_block(lm.layer_params(stage, i), cfg, x, positions,
                               True)[0]
        return x

    def tail(o, y):
        return torch.mean((o.float() - y.float()) ** 2)

    gen = torch.Generator(device=device).manual_seed(28)
    xs, ys = (torch.randn((M, 1, S, cfg.d_model), generator=gen,
                          device=device).to(lm.torch_dtype(cfg))
              for _ in range(2))

    def direct(stacked):
        local = tree_map(lambda t: t[0:1], stacked)
        return torch.stack([stage_fn(local, xs[m]) for m in range(M)])

    def timed(fn):
        torch.cuda.synchronize(device)
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize(device)
        return out, (time.perf_counter() - t) * 1e3

    stacked = stack_stage_params([layers])
    with torch.no_grad():
        counts, samples, outs = {}, {"pipeline": [], "direct": []}, {}
        for turn in range(1 + MESH_TURNS):      # turn 0 untimed
            for name, fn in (
                    ("pipeline", lambda: pipeline_apply(mesh, stage_fn,
                                                        stacked, xs)),
                    ("direct", lambda: direct(stacked))):
                reset_launches()
                out, t = timed(fn)
                counts[name] = launch_counts()
                if turn == 0:
                    outs[name] = out
                else:
                    samples[name].append(t)
                del out
    ms = {k: statistics.median(v) for k, v in samples.items()}
    outputs_equal = bool(torch.equal(outs["pipeline"], outs["direct"]))
    del outs
    live = tree_map(lambda t: t.detach().requires_grad_(), stacked)
    reset_launches()
    loss = pipeline_loss_fn(mesh, stage_fn, tail)(live, xs, ys)
    counts["loss_forward"] = launch_counts()
    g_pipe = torch.autograd.grad(loss, leaves(live))
    live2 = tree_map(lambda t: t.detach().requires_grad_(), stacked)
    loss2 = tail(direct(live2), ys)
    g_direct = torch.autograd.grad(loss2, leaves(live2))
    return dict(outputs_equal=outputs_equal, loss=float(loss.detach()),
                loss_direct=float(loss2.detach()),
                grads_equal=all(torch.equal(a, b)
                                for a, b in zip(g_pipe, g_direct)),
                n_grads=len(g_pipe), launches=counts, ms=ms,
                ms_samples=samples,
                profiled_flash=_profiled_pipeline(
                    lambda: pipeline_apply(mesh, stage_fn, stacked, xs)))


def _profiled_pipeline(forward) -> list:
    """One pipeline forward under the profiler: every flash launch it
    counted must show as the tensor-core kernel."""
    from repro_torch.kernels.dispatch import launch_counts, reset_launches

    def run():
        reset_launches()
        with torch.no_grad():
            forward()

    def check(prof, _):
        _, kern = _device_times(prof)
        _check_flash_route(kern, launch_counts().get("flash_attention", 0),
                           "pipeline")
        return kern["flash_attention"]
    return list(_profiled(run, check, "pipeline")[2])


def mesh_modules_phase() -> dict:
    """Phase 28: the mesh modules on one rank of an NCCL group.  (a) one
    train step's bf16 gradients of Qwen3-0.6B at full width
    (``QWEN_TRAIN``'s batch, ``use_kernel=True``) through
    ``ef_compressed_mean`` over the ``data`` dim of ``make_host_mesh(1)``;
    (b) its decoder layers as one stage of ``pipeline_apply`` on a
    one-rank ``stage`` mesh.  Gates: :func:`compress_check`'s; outputs and
    gradients bitwise, flash launched ``n_layers x M`` times in each
    forward (pipeline, direct loop, the loss's), every launch the
    tensor-core kernel."""
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs import get_config
    from repro_torch.data import make_pipeline
    from repro_torch.launch.mesh import destroy_host_group, make_host_mesh
    from repro_torch.models import lm
    from repro_torch.tree import leaves, tree_map
    cfg = get_config(ARCH)
    params = lm.init_params(cfg, 0)
    batch = {k: torch.from_numpy(v).to(DEV) for k, v in make_pipeline(
        cfg.vocab, QWEN_TRAIN["seq"], QWEN_TRAIN["batch"],
        seed=0).next_batch().items()}
    live = tree_map(lambda p: p.detach().requires_grad_(), params)
    loss = lm.loss_fn(live, cfg, batch, remat=True, use_kernel=True)
    got = iter(torch.autograd.grad(loss, leaves(live)))
    grads = tree_map(lambda _: next(got), params)
    del live, loss, got
    mesh = make_host_mesh(1)
    try:
        comp = compress_check(grads, mesh)
        del grads
        torch.cuda.empty_cache()
        stage_mesh = init_device_mesh("cuda", (1,),
                                      mesh_dim_names=("stage",))
        pipe = pipeline_check(cfg, params["layers"], stage_mesh,
                              torch.device(DEV))
    finally:
        destroy_host_group()
    del params
    torch.cuda.empty_cache()
    want = {"flash_attention": cfg.n_layers * PIPE["microbatches"]}
    counts = pipe["launches"]
    log(f"pipeline {ARCH}: {cfg.n_layers} layers as one stage, "
        f"{PIPE['microbatches']} microbatches of 1 x {PIPE['seq']}: outputs "
        f"bitwise the direct loop's {pipe['outputs_equal']}, loss "
        f"{pipe['loss']:.6f} / {pipe['loss_direct']:.6f}, {pipe['n_grads']} "
        f"gradients bitwise {pipe['grads_equal']}; launches {counts}; ms "
        f"(median of {MESH_TURNS}) pipeline {pipe['ms']['pipeline']:.1f}, "
        f"direct {pipe['ms']['direct']:.1f}")
    if not (pipe["outputs_equal"] and pipe["grads_equal"]
            and all(counts[k] == want for k in
                    ("pipeline", "direct", "loss_forward"))):
        raise AssertionError(f"pipeline: {pipe}, expected launches {want}")
    return dict(arch=ARCH, compress=comp, pipeline=pipe, **PIPE)


def train_vs_cpu() -> dict:
    """Phase 14: Mamba2-130M at full width cut to 2 layers, float32, the
    same weights and tokens on the card (kernel) and the CPU (plain
    versions): loss, every gradient leaf, and one AdamW step."""
    from repro_torch.configs import get_config
    from repro_torch.data import make_pipeline
    from repro_torch.kernels.dispatch import launch_counts, reset_launches
    from repro_torch.models import lm
    from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
    from repro_torch.tree import leaves, named_leaves, tree_map
    cfg = dataclasses.replace(get_config(TRAIN_ARCH), n_layers=2,
                              dtype="float32")
    p_cpu = lm.init_params(cfg, 1, device="cpu")
    opt = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10, eps=1e-5)
    batch = make_pipeline(cfg.vocab, 512, 2, seed=1).next_batch()
    res = {}
    reset_launches()
    for dev in ("cpu", DEV):
        p = tree_map(lambda t: t.to(dev), p_cpu)
        live = tree_map(lambda t: t.detach().requires_grad_(), p)
        loss = lm.loss_fn(live, cfg, {k: torch.from_numpy(v).to(dev)
                                      for k, v in batch.items()},
                          remat=True, use_kernel=True)
        grads = torch.autograd.grad(loss, leaves(live))
        it = iter(grads)
        g_tree = tree_map(lambda _: next(it), p)
        new_p, _, _ = adamw_update(g_tree, adamw_init(p, opt), p, opt)
        res[dev] = dict(loss=float(loss.detach()),
                        grads=dict(named_leaves(g_tree)),
                        step=dict(named_leaves(tree_map(
                            lambda a, b: (a - b).cpu().double(), new_p, p))))
    counts = launch_counts()
    if counts != {"ssd_scan": 2 * cfg.n_layers}:
        raise AssertionError(f"card vs cpu (train): launches {counts}")
    loss_rel = abs(res[DEV]["loss"] - res["cpu"]["loss"]) / \
        abs(res["cpu"]["loss"])

    def worst(key):
        out = {}
        for name, want in res["cpu"][key].items():
            want = want.cpu().double()
            got = res[DEV][key][name].cpu().double()
            out[name] = float((got - want).abs().max()) / \
                max(float(want.abs().max()), 1e-30)
        return out
    grad_rel, step_rel = worst("grads"), worst("step")
    g_name = max(grad_rel, key=grad_rel.get)
    s_name = max(step_rel, key=step_rel.get)
    tol = TRAIN_CPU_TOL
    log(f"card vs cpu (train): {TRAIN_ARCH} at 2 layers, float32, B=2 S=512"
        f" (2 chunks): loss {res['cpu']['loss']:.6f}, rel {loss_rel:.2e} "
        f"(limit {tol['loss']:g}); gradients worst {grad_rel[g_name]:.2e} "
        f"({g_name}; limit {tol['grad']:g}); AdamW step worst "
        f"{step_rel[s_name]:.2e} ({s_name}; limit {tol['step']:g}); "
        f"launches {counts}")
    if not (loss_rel <= tol["loss"] and grad_rel[g_name] <= tol["grad"]
            and step_rel[s_name] <= tol["step"]):
        raise AssertionError("card vs cpu (train) past a limit")
    return dict(layers=cfg.n_layers, batch=2, seq=512, loss=res["cpu"]["loss"],
                loss_rel=loss_rel, grad_rel=grad_rel, step_rel=step_rel,
                launches=counts)


def train_breakdown() -> dict:
    """Phase 15: one step of phase 12's configuration under the profiler:
    the device's busy share of the unprofiled step, the SSD kernel's
    device time per launch and share, the top device operations; then the
    backward's recompute (``ssd_chunked`` in torch ops, forward and
    backward) alone at one layer's shape, times the layers."""
    from repro_torch.configs import get_config
    from repro_torch.data import make_pipeline
    from repro_torch.kernels.dispatch import launch_counts, reset_launches
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import lm
    from repro_torch.models.layers import ssd_chunked
    from repro_torch.optim import AdamWConfig, adamw_init
    cfg = get_config(TRAIN_ARCH)
    B, S = TRAIN["batch"], TRAIN["seq"]
    params = lm.init_params(cfg, 0)
    opt = AdamWConfig(total_steps=TRAIN["steps"], warmup_steps=1)
    state = adamw_init(params, opt)
    step_fn = make_train_step(cfg, opt, use_kernel=True)
    data = make_pipeline(cfg.vocab, S, B, seed=0)
    batches = [{k: torch.from_numpy(v).to(DEV)
                for k, v in data.next_batch().items()} for _ in range(4)]
    params, state, _ = step_fn(params, state, batches[0])     # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for b in batches[1:3]:
        params, state, _ = step_fn(params, state, b)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / 2
    def run():
        nonlocal params, state
        reset_launches()
        params, state, _ = step_fn(params, state, batches[3])

    def check(prof, _):
        launches = launch_counts().get("ssd_scan", 0)
        total, ssd_us, ssd_n, ops = 0.0, 0.0, 0, []
        for e in prof.key_averages():
            us = float(getattr(e, "self_device_time_total", 0.0) or 0.0)
            total += us
            if any(nm in e.key for nm in SSD_KERNELS):
                ssd_us += us
                if SSD_KERNELS[0] in e.key:
                    ssd_n += e.count
            if us:
                ops.append((us, e.key, e.count))
        ops.sort(reverse=True)
        if launches == 0 or ssd_n != launches:
            raise AssertionError(f"breakdown train: {launches} SSD launches, "
                                 f"the profiler saw {ssd_n} {SSD_KERNELS[0]}")
        return launches, total, ssd_us, ssd_n, ops

    launches, total, ssd_us, ssd_n, ops = _profiled(run, check,
                                                     "breakdown train")[2]
    del params, state, batches
    torch.cuda.empty_cache()

    # the backward's recompute alone, at one layer's shapes
    s = cfg.ssm
    H, P, N = s.n_heads(cfg.d_model), s.head_dim, s.d_state
    gen = torch.Generator(device=DEV).manual_seed(15)
    x, dt, A, Bm, Cm, _ = _ssd_inputs(gen, B, S, H, s.n_groups, P, N,
                                      "model", 0.0)
    x = x.to(torch.bfloat16)
    ins = [t.requires_grad_() for t in (x, dt, A, Bm.to(torch.bfloat16),
                                        Cm.to(torch.bfloat16),
                                        torch.ones(H, device=DEV))]

    def recompute(i):
        y, fin = ssd_chunked(*ins, s.chunk)
        torch.autograd.grad((y, fin), ins, (torch.ones_like(y),
                                            torch.zeros_like(fin)))
    rec_ms = time_ms(recompute, reps=3, warm=1)
    del x, dt, A, Bm, Cm, ins
    torch.cuda.empty_cache()
    busy = total / 1e6 / step_s if total else None
    out = dict(step_s=step_s, device_busy_s=total / 1e6, busy_share=busy,
               ssd_launches=ssd_n,
               ssd_device_ms_per_launch=ssd_us / ssd_n / 1e3 if ssd_n else
               None, ssd_share_of_step=ssd_us / 1e6 / step_s,
               recompute_ms_per_layer=rec_ms,
               recompute_s_per_step=rec_ms * cfg.n_layers / 1e3,
               top_device_ops=[dict(name=k[:80], us=us, count=n)
                               for us, k, n in ops[:12]])
    log(f"breakdown train {TRAIN_ARCH}: step {step_s * 1e3:.1f} ms, device "
        + (f"busy {total / 1e3:.1f} ms = {busy:.1%}" if busy is not None
           else "time not measured (profiler saw none)")
        + f"; ssd_scan {ssd_n} launches, "
        + (f"{out['ssd_device_ms_per_launch'] * 1e3:.1f} us each, "
           f"{out['ssd_share_of_step']:.1%} of the step"
           if ssd_n else "device time not measured")
        + f"; backward recompute (ssd_chunked fwd+bwd) {rec_ms:.2f} ms a "
        f"layer, {out['recompute_s_per_step'] * 1e3:.0f} ms a step; top "
        "device ops: " + "; ".join(f"{k[:48]} {us / 1e3:.1f} ms x{n}"
                                   for us, k, n in ops[:6]))
    return out


# ---------------------------------------------------------------------------
# phase 16: crash recovery at full width
# ---------------------------------------------------------------------------

# (tag, app, builder, parameters, snapshot_every, crash): phase 4's five
# graphs at phase 4's sizes, each cut into 4-11 chunks and crashed once
# between two of them
RECOVERY = [
    ("gemm", "gemm", "build_step", FULL["gemm"], 8, {"chunk": 2}),
    ("gaussian", "gaussian", "build_step", FULL["gaussian"], 256,
     {"chunk": 3}),
    ("page_rank", "page_rank", "build_step", FULL["page_rank"], 4,
     {"chunk": 2}),
    ("gemm_async", "gemm", "build_step_async", FULL_ASYNC["gemm"], 16,
     {"chunk": 2}),
    ("page_rank_async", "page_rank", "build_step_async",
     FULL_ASYNC["page_rank"], 2048, {"chunk": 3}),
]


def _buffers(args) -> list:
    """Every mmap's and async port's buffer of a graph's arguments, as
    host copies, in argument order."""
    from repro_torch.core.interface import AsyncMMap, MMap
    out = []

    def walk(v):
        if isinstance(v, (MMap, AsyncMMap)):
            out.append(torch.as_tensor(v.data).detach().cpu().clone())
        elif isinstance(v, (list, tuple)):
            for x in v:
                walk(x)
    walk(args)
    return out


def _recover_graph(tag, name, builder, kw, every, crash, tmp: Path) -> dict:
    """One graph of phase 16: the uninterrupted compiled run on the card,
    then ``run_supervised`` on the card with a snapshot store and one
    crash between chunks; bit-identical outputs, the schedule's sweeps,
    one capture an attempt, one restart from the last snapshot saved
    before the crash, and the launches the sweeps and firings make."""
    from repro_torch import ENGINES
    from repro_torch.apps import APPS
    from repro_torch.core.faults import FaultPlan
    from repro_torch.core.synth import elaborate_step_graph
    from repro_torch.ft.recovery import (RestartPolicy, SnapshotStore,
                                         _abstract_schedule, run_supervised)
    from repro_torch.kernels.dispatch import launch_counts, reset_launches
    build = getattr(APPS[name], builder)
    top, args, _ = build(device="cuda", **kw)
    eng = ENGINES["compiled"](device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rep = eng.run(top, *args)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    if not rep.ok:
        raise AssertionError(f"recovery {tag}: the uninterrupted run "
                             f"failed: {rep.error}")
    golden = _buffers(args)

    top, args, check = build(device="cuda", **kw)
    plan, _, _ = elaborate_step_graph(top, *args)
    cuts, stalled = _abstract_schedule(plan)
    store = SnapshotStore(tmp / tag, keep=3)
    attempts = []
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rec = run_supervised("compiled", top, *args, store=store,
                         snapshot_every=every, faults=FaultPlan(crash=crash),
                         policy=RestartPolicy(max_restarts=1, backoff_s=0.0),
                         device="cuda", log=attempts)
    torch.cuda.synchronize()
    rec_s = time.perf_counter() - t0
    launches = {k: launch_counts().get(k, 0) for k in REPLACES}
    ok, err = check() if rec.ok else (False, float("nan"))
    got = _buffers(args)
    saves = [s for a in attempts for s in a.saves]
    sweeps = sum(sum(a.chunks) for a in attempts)
    replays = sum(a.replays for a in attempts)
    ports = builder == "build_step_async"
    want = dict(eng.ring_ops, sweep_guards=replays,
                service_ports=replays if ports else 0)
    fails = []
    if not (rec.ok and ok):
        fails.append(f"run {rec.error}, check {ok} ({err})")
    if len(got) != len(golden) or not all(
            torch.equal(a, b) for a, b in zip(got, golden)):
        fails.append("outputs differ from the uninterrupted run's")
    if stalled or not sweeps == rep.switches == len(cuts) - 1:
        fails.append(f"{sweeps} sweeps over the chunks, {rep.switches} "
                     f"uninterrupted, the schedule {len(cuts) - 1} "
                     f"(stalled {stalled})")
    if [a.crashed for a in attempts] != [True, False]:
        fails.append(f"attempts crashed {[a.crashed for a in attempts]}")
    elif not attempts[1].start_sweep == attempts[0].saves[-1]["sweep"] > 0:
        fails.append(f"resumed at sweep {attempts[1].start_sweep}, the last "
                     f"snapshot before the crash was at "
                     f"{attempts[0].saves[-1]['sweep']}")
    if [a.captures for a in attempts] != [1] * len(attempts):
        fails.append(f"captures an attempt {[a.captures for a in attempts]}")
    if launches != want:
        fails.append(f"launches counted on the card {launches}; the "
                     f"replays and firings make {want}")
    if tag == "page_rank_async" and not any(s["inflight"] for s in saves):
        fails.append("no snapshot holds an in-flight request")
    if tag == "gemm" and not any(s["full_channels"] for s in saves):
        fails.append("no snapshot holds a full channel")
    if fails:
        raise AssertionError(f"recovery {tag}: " + "; ".join(fails))
    snap = [s for s in saves if s["read_ms"] is not None]
    out = dict(
        params=kw, snapshot_every=every, crash=crash, sweeps=sweeps,
        chunks=[len(a.chunks) for a in attempts],
        start_sweeps=[a.start_sweep for a in attempts],
        snapshots_saved=len(saves), snapshot_bytes=max(
            s["bytes"] for s in saves),
        read_ms=[s["read_ms"] for s in snap],
        save_ms=[s["save_ms"] for s in saves],
        restore_ms=[a.restore_ms for a in attempts],
        replays=[a.replays for a in attempts],
        host_syncs=[a.host_syncs for a in attempts],
        plain_replays=eng.n_replays, plain_host_syncs=eng.n_host_syncs,
        full_channels=max(s["full_channels"] for s in saves),
        inflight=max(s["inflight"] for s in saves),
        launches=launches, recoverable_s=rec_s, uninterrupted_s=plain_s)
    log(f"recovery {tag}: bit-identical after a crash at {crash} and a "
        f"resume from sweep {attempts[1].start_sweep}; {sweeps} sweeps in "
        f"{out['chunks']} chunks; {len(saves)} snapshots of "
        f"{out['snapshot_bytes'] / 2**20:.1f} MiB, read "
        f"{np.median(out['read_ms']):.2f} ms, saved "
        f"{np.median(out['save_ms']):.1f} ms (medians), restore "
        f"{attempts[1].restore_ms:.1f} ms; replays {out['replays']}, host "
        f"syncs {out['host_syncs']} (uninterrupted {eng.n_replays}, "
        f"{eng.n_host_syncs}); {rec_s:.3f} s recoverable against "
        f"{plain_s:.3f} s uninterrupted; launches {launches}")
    return out


def _cross_engine(name: str, kw: dict, tmp: Path) -> dict:
    """At phase 5's reduced size on the card: crash under one engine,
    finish under the other from the same store, both ways; bit-identical
    to the uninterrupted compiled run."""
    from repro_torch import ENGINES
    from repro_torch.apps import APPS
    from repro_torch.core import CrashFault
    from repro_torch.core.faults import FaultPlan
    from repro_torch.ft.recovery import SnapshotStore, run_recoverable
    top, args, _ = APPS[name].build_step(device="cuda", **kw)
    if not ENGINES["compiled"](device="cuda").run(top, *args).ok:
        raise AssertionError(f"recovery {name}: the uninterrupted run failed")
    golden = _buffers(args)
    out = {}
    for first, second in (("compiled", "coroutine"),
                          ("coroutine", "compiled")):
        store = SnapshotStore(tmp / f"{name}_{first}", keep=3)
        top, args, _ = APPS[name].build_step(device="cuda", **kw)
        try:
            run_recoverable(first, top, *args, store=store, snapshot_every=2,
                            faults=FaultPlan(crash={"chunk": 2}),
                            device="cuda")
        except CrashFault:
            pass
        else:
            raise AssertionError(f"recovery {name}: {first} did not crash")
        top, args, check = APPS[name].build_step(device="cuda", **kw)
        attempts = []
        rep = run_recoverable(second, top, *args, store=store,
                              snapshot_every=2, device="cuda", log=attempts)
        same = all(torch.equal(a, b) for a, b in zip(_buffers(args), golden))
        if not (rep.ok and check()[0] and same
                and attempts[0].start_sweep == 4):
            raise AssertionError(
                f"recovery {name}: crash under {first}, finish under "
                f"{second}: ok {rep.ok} ({rep.error}), bit-identical {same}, "
                f"resumed at {attempts[0].start_sweep}")
        out[f"{first}_then_{second}"] = dict(params=kw, bitwise=True,
                                             resumed_at=4)
        log(f"recovery {name}: crash under {first}, finish under {second} "
            f"from sweep 4: bit-identical on the card")
    return out


def recovery_phase() -> dict:
    """Phase 16: each of phase 4's five graphs through ``run_supervised``
    on the card with one crash (:func:`_recover_graph`), then the
    cross-engine restores at phase 5's sizes and the refusal of a port
    graph under a Python engine.  The stores live in a temporary
    directory under ``build/``, deleted at the end."""
    import shutil
    import tempfile
    from repro_torch.apps import APPS
    from repro_torch.core import SynthesisError
    from repro_torch.ft.recovery import SnapshotStore, run_recoverable
    (ROOT / "build").mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="recovery_", dir=ROOT / "build"))
    try:
        out = {tag: _recover_graph(tag, *rest, tmp)
               for tag, *rest in RECOVERY}
        out["cross_engine"] = {name: _cross_engine(name, REDUCED[name], tmp)
                               for name in ("gemm", "page_rank")}
        top, args, _ = APPS["gemm"].build_step_async(
            device="cuda", **REDUCED_ASYNC["gemm"])
        try:
            run_recoverable("coroutine", top, *args,
                            store=SnapshotStore(tmp / "refused"),
                            device="cuda")
        except SynthesisError as e:
            if "async_mmap ports" not in str(e):
                raise
        else:
            raise AssertionError("recovery: a port graph under coroutine "
                                 "was not refused")
        log("recovery: a port graph under coroutine refused")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


# ---------------------------------------------------------------------------
# phase 17: hierarchical code generation on the card
# ---------------------------------------------------------------------------

# gaussian's stage chain at phase 4's width (6 instances of 3 definitions)
CODEGEN_GAUSSIAN = dict(h=2048, w=2048, iters=4)
# the codegen benchmark's cache graph (benchmarks/codegen_time.py
# cache_bench: 515 instances of 15 definitions on a 96 x 96 input), cut
# to 8 definitions since the families' training was added (the script's
# time limit; 15 compiled cold in 37.7-64.4 s)
CODEGEN_GRAPH = dict(n_instances=515, n_defs=8, dim=96)
# compile processes of a hierarchical compile: a process's first compile
# took 134-136 s with 8 starting at once on the H100 host's 8 cores and
# 92-103 s with 4 (PERF.md §6), so 4 keep the phase near 5 minutes
CODEGEN_WORKERS = 4
CODEGEN_APPS = {"cnn": dict(ci=64, co=64, hw=32, k=3, P=4),
                "gcn": dict(n_vertices=4096, n_edges=16384, n_parts=4)}
# max |out - ref| / max |ref| of gaussian's chain: the reference test's
# bar; max |out - ref| of cnn and gcn: the reference test's atol
GAUSSIAN_TOL = 1e-4
APP_TOL = 1e-3
RUN_REPS = 20               # timed calls of a compiled program

# a fresh process warm-starting gaussian's chain from the store: every
# definition from disk, and the chain's output against its eager stages
WARM_START = """
import json, sys, time, torch
from repro_torch.apps import gaussian
from repro_torch.core.hier_compile import build_dataflow, compile_stages
kw = json.loads(sys.argv[1])
t0 = time.perf_counter()
insts, wiring = gaussian.torch_stages(**kw)
rep = compile_stages(insts, device="cuda")
wall = time.perf_counter() - t0
gen = torch.Generator().manual_seed(1)
img = torch.randn((kw["h"], kw["w"]), generator=gen).cuda()
out = build_dataflow(insts, wiring)(img)
want = img
for i in insts:
    want = i.fn(want)
err = float((out - want).abs().max() / want.abs().max())
print(json.dumps({"n_compiled": rep.n_compiled,
                  "n_cache_hits": rep.n_cache_hits,
                  "sources": sorted(set(rep.sources.values())), "wall_s": wall,
                  "load_ms": [e.timing["load_s"] * 1e3
                              for e in rep.executables.values()],
                  "rel_err": err}))
"""


def _counts(rep) -> dict:
    return dict(wall_s=rep.wall_s, n_instances=rep.n_instances,
                n_unique=rep.n_unique, n_compiled=rep.n_compiled,
                n_cache_hits=rep.n_cache_hits, n_reused=rep.n_reused,
                sources=sorted(set(rep.sources.values())))


def _expect(what: str, rep, **want) -> dict:
    got = _counts(rep)
    bad = {k: (got[k], v) for k, v in want.items() if got[k] != v}
    if bad:
        raise AssertionError(f"codegen {what}: (got, want) {bad}")
    log(f"codegen {what}: {rep.wall_s:.2f} s, {rep.n_instances} instances, "
        f"{rep.n_unique} unique, compiled {rep.n_compiled}, hits "
        f"{rep.n_cache_hits}, reused {rep.n_reused}")
    return got


def _per_def(rep) -> list:
    """Each definition's export, package compile and load seconds and its
    package's bytes (a compiled one), or its probe's seconds (a hit)."""
    rows = []
    for key, src in rep.sources.items():
        exe = rep.executables[key]
        rows.append(dict(key=key[:12], source=src, s=rep.per_key_s[key],
                         bytes=len(exe.payload), **exe.timing))
    log("codegen   per definition (source, export s, compile s, load ms, "
        "bytes): " + "; ".join(
            f"{r['source']} {r['export_s']:.2f} {r['compile_s']:.2f} "
            f"{r['load_s'] * 1e3:.1f} {r['bytes']}" for r in rows))
    return rows


def _run_ms(prog, *inputs) -> float:
    return time_ms(lambda i: prog(*inputs), reps=RUN_REPS, warm=2)


def _rel(out: torch.Tensor, want) -> float:
    want = torch.as_tensor(want, device=out.device)
    return float((out - want).abs().max() / want.abs().max())


def _codegen_gaussian(tmp: Path) -> dict:
    """Gaussian's chain at phase 4's width: monolithic, hierarchical cold
    on an empty root, warm from a fresh process, incremental after an
    edit of the stencil's weights; the output against the eager stages on
    the card and against ``_stencil_ref`` on the host."""
    import inspect
    from repro_torch.apps import gaussian
    from repro_torch.core.compile_cache import CompileCache
    from repro_torch.core.hier_compile import build_dataflow, compile_stages
    kw = CODEGEN_GAUSSIAN
    n = kw["iters"] + 2
    insts, wiring = gaussian.torch_stages(**kw)
    mono = compile_stages(insts, mode="monolithic", device="cuda")
    out = dict(monolithic=_expect("gaussian monolithic", mono, n_instances=n,
                                  n_unique=3, n_compiled=n))
    out["monolithic"]["per_instance_s"] = mono.per_key_s
    root = tmp / "gaussian"
    insts, wiring = gaussian.torch_stages(**kw)
    cold = compile_stages(insts, cache=CompileCache(root=root),
                          max_workers=CODEGEN_WORKERS, device="cuda")
    out["cold"] = _expect("gaussian cold", cold, n_unique=3, n_compiled=3)
    out["cold"]["per_def"] = _per_def(cold)
    out["monolithic_over_hierarchical"] = mono.wall_s / cold.wall_s

    def eager(t):
        for inst in insts:
            t = inst.fn(t)
        return t

    prog = build_dataflow(insts, wiring)
    img = np.random.default_rng(0).standard_normal(
        (kw["h"], kw["w"])).astype(np.float32)
    x = torch.from_numpy(img).cuda()
    got, want = prog(x), eager(x)
    ref = img
    for _ in range(kw["iters"]):
        ref = gaussian._stencil_ref(ref)
    errs = dict(vs_eager=_rel(got, want), vs_stencil_ref=_rel(got, ref))
    if max(errs.values()) > GAUSSIAN_TOL:
        raise AssertionError(f"codegen gaussian: {errs} over {GAUSSIAN_TOL}")
    out["rel_err"] = errs
    out["run_ms"] = _run_ms(prog, x)
    out["eager_ms"] = _run_ms(eager, x)
    log(f"codegen gaussian: monolithic / hierarchical "
        f"{out['monolithic_over_hierarchical']:.2f}x; program "
        f"{out['run_ms']:.3f} ms a call (eager stages {out['eager_ms']:.3f}"
        f" ms); errors {errs}")

    r = subprocess.run(
        [sys.executable, "-c", WARM_START, json.dumps(kw)],
        capture_output=True, text=True, timeout=600,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src"),
             "REPRO_TORCH_COMPILE_CACHE": str(root)})
    if r.returncode != 0:
        raise AssertionError(f"codegen warm start failed:\n{r.stderr[-3000:]}")
    warm = json.loads(r.stdout.strip().splitlines()[-1])
    if warm["n_compiled"] != 0 or warm["sources"] != ["disk"] or \
            warm["rel_err"] > GAUSSIAN_TOL:
        raise AssertionError(f"codegen gaussian warm start: {warm}")
    log(f"codegen gaussian warm (fresh process): {warm['wall_s']:.2f} s, "
        f"compiled 0, all {warm['n_cache_hits']} from disk, load ms "
        f"{[round(v, 2) for v in warm['load_ms']]}, err {warm['rel_err']:.2e}")
    out["warm"] = warm
    out["cold_over_warm"] = cold.wall_s / warm["wall_s"]
    log(f"codegen gaussian: cold / fresh-process warm "
        f"{out['cold_over_warm']:.2f}x")

    edited, _ = gaussian.torch_stages(**kw)
    KJ = inspect.getclosurevars(edited[1].fn).nonlocals["KJ"]
    KJ[1][1] += 1.0 / 64          # the QoR loop's in-place weight edit
    inc = compile_stages(edited, cache=CompileCache(root=tmp / "gauss_inc"),
                         prev=cold, max_workers=CODEGEN_WORKERS,
                         device="cuda")
    out["incremental"] = _expect("gaussian incremental", inc, n_compiled=1,
                                 n_reused=2)
    out["incremental"]["per_def"] = _per_def(inc)
    return out


def _codegen_defs(n_defs: int, edit: int = -1) -> list:
    """``benchmarks/codegen_time.py``'s ``_gaussian_style_defs`` in torch:
    ``n_defs`` definitions differing in closure constants, re-created on
    every call; ``edit`` bumps one definition's coefficient."""
    def make(i: int, coef: float):
        def stage(x):
            y = torch.tanh(x @ x.T) * coef
            return y + torch.roll(x, (i % 3) + 1, dims=0) * (0.1 * (i + 1))
        return stage
    return [make(i, 0.5 + 0.1 * i + (1.0 if i == edit else 0.0))
            for i in range(n_defs)]


def _codegen_cache_graph(tmp: Path) -> dict:
    """The codegen benchmark's cold / warm / incremental cycle on the card:
    a compile a definition, then a disk hit each after the memory level is
    dropped and the closures re-created, then one edited definition
    compiled with the others reused from the warm report."""
    from repro_torch.core.compile_cache import CompileCache
    from repro_torch.core.hier_compile import StageInstance, compile_stages
    n, k, dim = (CODEGEN_GRAPH[f] for f in ("n_instances", "n_defs", "dim"))
    x = torch.ones((dim, dim), dtype=torch.float32, device="cuda")

    def instances(defs):
        return [StageInstance(fn=defs[i % len(defs)], args=(x,),
                              name=f"inst{i}") for i in range(n)]

    cache = CompileCache(root=tmp / "graph")
    out = {}
    cold = compile_stages(instances(_codegen_defs(k)), cache=cache,
                          max_workers=CODEGEN_WORKERS, device="cuda")
    out["cold"] = _expect("cache graph cold", cold, n_instances=n,
                          n_unique=k, n_compiled=k)
    out["cold"]["per_def"] = _per_def(cold)
    cache.clear_memory()
    defs = _codegen_defs(k)
    warm = compile_stages(instances(defs), cache=cache, device="cuda")
    out["warm"] = _expect("cache graph warm", warm, n_compiled=0,
                          n_cache_hits=k, sources=["disk"])
    out["warm"]["per_def"] = _per_def(warm)
    errs = [_rel(warm.executables[key](x), fn(x)) for key, fn in
            zip(warm.sources, defs)]
    if max(errs) > GAUSSIAN_TOL:
        raise AssertionError(f"codegen cache graph: errors {errs}")
    out["rel_err_max"] = max(errs)
    inc = compile_stages(instances(_codegen_defs(k, edit=0)),
                         cache=CompileCache(root=tmp / "graph_inc"),
                         prev=warm, max_workers=CODEGEN_WORKERS,
                         device="cuda")
    out["incremental"] = _expect("cache graph incremental", inc,
                                 n_compiled=1, n_reused=k - 1)
    out["incremental"]["per_def"] = _per_def(inc)
    out["cold_over_warm"] = cold.wall_s / warm.wall_s
    out["cold_over_incremental"] = cold.wall_s / inc.wall_s
    log(f"codegen cache graph: cold / warm {out['cold_over_warm']:.1f}x, "
        f"cold / incremental {out['cold_over_incremental']:.2f}x, max error "
        f"{out['rel_err_max']:.2e}")
    return out


def _codegen_apps(tmp: Path) -> dict:
    """cnn and gcn through ``compile_app`` on the card: outputs against
    their ``ref``, then a rerun with re-created closures from the same
    root that compiles nothing."""
    from repro_torch.apps import cnn, gcn
    from repro_torch.core.compile_cache import CompileCache
    out = {}
    for name, mod, n_inst, n_uniq in (("cnn", cnn, 17, 2),
                                      ("gcn", gcn, 9, 3)):
        kw = CODEGEN_APPS[name]
        root = tmp / name
        rep, prog, ref = mod.compile_app(cache=CompileCache(root=root),
                                         device="cuda", **kw)
        row = _expect(f"{name} cold", rep, n_instances=n_inst,
                      n_unique=n_uniq, n_compiled=n_uniq)
        got = prog()
        err = float((got - torch.as_tensor(ref, device="cuda")).abs().max())
        if err > APP_TOL:
            raise AssertionError(f"codegen {name}: max |out - ref| {err}")
        rep2, _, _ = mod.compile_app(cache=CompileCache(root=root),
                                     device="cuda", **kw)
        _expect(f"{name} rerun", rep2, n_compiled=0, sources=["disk"])
        out[name] = dict(params=kw, cold=row, per_def=_per_def(rep),
                         rerun=_counts(rep2), max_abs_err=err,
                         run_ms=_run_ms(prog))
        log(f"codegen {name}: max |out - ref| {err:.2e}, program "
            f"{out[name]['run_ms']:.3f} ms a call")
    return out


def _codegen_invoke(tmp: Path) -> dict:
    """``gaussian.compile_app`` at 64 x 64 (elaboration: the per-pixel
    coroutine simulation) and ``invoke(target="compiled")`` on a graph
    whose leaf tasks are gaussian's stage definitions, through the
    process's default cache: 3 compiles, then none."""
    import repro_torch
    from repro_torch.apps import gaussian
    from repro_torch.core.compile_cache import (CompileCache,
                                                set_default_cache)
    h = w = 64
    graph, rep, prog = gaussian.compile_app(
        h=h, w=w, cache=CompileCache(root=tmp / "g64"), device="cuda")
    out = dict(compile_app=_expect("gaussian 64x64 compile_app", rep,
                                   n_instances=6, n_unique=3, n_compiled=3))
    if not graph.report.ok:
        raise AssertionError(f"codegen: elaboration failed "
                             f"{graph.report.error}")
    img = np.random.default_rng(0).standard_normal((h, w)).astype(np.float32)
    ref = img
    for _ in range(4):
        ref = gaussian._stencil_ref(ref)
    out["compile_app"]["rel_err"] = _rel(prog(img), ref)
    if out["compile_app"]["rel_err"] > GAUSSIAN_TOL:
        raise AssertionError(f"codegen gaussian 64x64: {out['compile_app']}")

    insts, _ = gaussian.torch_stages(h=h, w=w)
    x = torch.from_numpy(img).cuda()

    def Top(t):
        b = repro_torch.task()
        for inst in insts:
            b = b.invoke(inst.fn, t, name=inst.name)
        return "done"

    cache = CompileCache(root=tmp / "invoke")
    set_default_cache(cache)
    try:
        for turn, want in enumerate((3, 0)):
            t0 = time.perf_counter()
            res = repro_torch.invoke(Top, x, target="compiled",
                                     device="cuda")
            dt = time.perf_counter() - t0
            if res != "done" or cache.stats.puts != 3:
                raise AssertionError(f"codegen invoke: result {res!r}, "
                                     f"stats {cache.stats}")
            out[f"invoke_{turn}"] = dict(s=dt, **cache.stats.as_dict())
            log(f"codegen invoke(target='compiled') turn {turn}: {dt:.2f} s, "
                f"{cache.stats.as_dict()}")
    finally:
        set_default_cache(None)
    if cache.stats.misses != 3 or cache.stats.mem_hits != 3:
        raise AssertionError(f"codegen invoke: {cache.stats}")
    return out


def _codegen_workers(x: torch.Tensor):
    """Start the ``CODEGEN_WORKERS`` package-compile processes with one
    compile each (distinct definitions of ``x``'s shape, no store): their
    one-time start-up (imports, the toolchain's probes) is measured here,
    apart from the modes' compiles, which then run in warm processes.
    Returns the compile's report."""
    from repro_torch.core.hier_compile import StageInstance, compile_stages

    def make(c):
        def stage(t):
            return t * c
        return stage

    return compile_stages([StageInstance(fn=make(float(i)), args=(x,))
                           for i in range(CODEGEN_WORKERS)], cache=False,
                          max_workers=CODEGEN_WORKERS, device="cuda")


_codegen_start: dict = {}


def start_codegen_workers() -> None:
    """Run :func:`_codegen_workers` in a thread, once, so the compile
    processes' one-time start-up runs on the host's cores while the card
    works through phases 11-16.  The thread loads no package before phase
    17 opens its gate (a load is a CUDA module load, which must not land
    inside phase 16's CUDA-graph captures): ``compile_cache.Executable``
    waits for it in that thread, and the wait is kept apart."""
    import threading
    from repro_torch.core import compile_cache as cc
    if "thread" in _codegen_start:
        return
    go, waits, plain = threading.Event(), [], cc.Executable

    class Gated(plain):
        def __init__(self, *a, **kw):
            if threading.current_thread() is _codegen_start["thread"]:
                t0 = time.perf_counter()
                go.wait()
                waits.append(time.perf_counter() - t0)
            super().__init__(*a, **kw)

    x = torch.ones((8, 8), device="cuda")

    def run():
        try:
            _codegen_start["rep"] = _codegen_workers(x)
        except Exception as e:              # noqa: BLE001 - phase 17 raises
            _codegen_start["error"] = e

    cc.Executable = Gated
    _codegen_start.update(
        go=go, waits=waits, thread=threading.Thread(target=run, daemon=True),
        restore=lambda: setattr(cc, "Executable", plain))
    _codegen_start["thread"].start()


def _codegen_started(_tmp: Path) -> dict:
    """Phase 17's first part: the compile processes' start-up, as
    :func:`start_codegen_workers` ran it (started now if it was not): its
    report, whose seconds leave out the wait at the gate, and this
    phase's wait for it (``waited_s``)."""
    start_codegen_workers()
    t0 = time.perf_counter()
    _codegen_start["go"].set()
    _codegen_start["thread"].join()
    _codegen_start["restore"]()
    if "error" in _codegen_start:
        raise _codegen_start["error"]
    rep = _codegen_start["rep"]
    gate_s = sum(_codegen_start["waits"])
    rep.wall_s -= gate_s
    return dict(_expect("worker start-up", rep, n_compiled=CODEGEN_WORKERS),
                per_def=_per_def(rep), gate_s=gate_s,
                waited_s=time.perf_counter() - t0)


def codegen_phase() -> dict:
    """Phase 17: hierarchical code generation on the card (AOTInductor
    packages through the compile cache, roots under a temporary
    ``build/codegen_*``, deleted).  Its compile processes stay up for
    phases 24-25, which stop them: their start-up is paid once, in a
    thread started before phase 11 (``workers``: ``phase_s`` is the wait
    for it here, ``wall_s`` its own seconds less the wait at its gate)."""
    import shutil
    import tempfile
    (ROOT / "build").mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="codegen_", dir=ROOT / "build"))
    out = {}
    try:
        for name, fn in (("workers", _codegen_started),
                         ("gaussian", _codegen_gaussian),
                         ("cache_graph", _codegen_cache_graph),
                         ("apps", _codegen_apps),
                         ("invoke", _codegen_invoke)):
            t0 = time.perf_counter()
            out[name] = fn(tmp)
            out[name]["phase_s"] = time.perf_counter() - t0
            log(f"codegen {name}: {out[name]['phase_s']:.1f} s")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


# ---------------------------------------------------------------------------
# phases 18-20: the moe and vlm families at full width
# ---------------------------------------------------------------------------

FAMILY_ARCHS = ("granite-moe-1b-a400m", "phi-3-vision-4.2b")
# phases 18, 19, 21 and 31 at full width and a cut depth (the script's
# time limit, with phases 24-25 added; the decode steps are host-bound,
# so their ms scale with the layers): granite 24 -> 12, phi-3 32 -> 16,
# mamba2 24 -> 12, zamba2 38 -> 12 (its shared block twice, both cache
# blocks), qwen3-4b 36 -> 8, yi-6b 32 -> 8, starcoder2-3b 30 -> 8;
# each command line (launch.serve --full) keeps full depth
SERVE_LAYERS = {"granite-moe-1b-a400m": 12, "phi-3-vision-4.2b": 16,
                "mamba2-130m": 12, "zamba2-1.2b": 12,
                "qwen3-4b": 8, "yi-6b": 8, "starcoder2-3b": 8}


def _serve_cfg(arch: str):
    """``arch`` as phases 8, 18, 19, 21 and 31 serve it: full width, flash
    attention, at ``SERVE_LAYERS``' depth where it names one."""
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config(arch), attn_impl="kernel")
    return dataclasses.replace(cfg, n_layers=SERVE_LAYERS.get(
        arch, cfg.n_layers))


VLM_PROMPT = 1024           # tokens of phase 19's prefill with patches


def _patch_prefill(params, cfg) -> dict:
    """One bf16 prefill of a ``VLM_PROMPT``-token prompt whose first
    ``n_patches`` positions are random patch embeddings, on the card:
    finite logits that the patches change, flash once a layer."""
    from repro_torch.kernels.dispatch import launch_counts, reset_launches
    from repro_torch.models import lm
    gen = torch.Generator(device=DEV).manual_seed(5)
    toks = torch.randint(0, cfg.vocab, (1, VLM_PROMPT), generator=gen,
                         device=DEV, dtype=torch.int32)
    patches = torch.randn((1, cfg.vlm.n_patches, cfg.vlm.d_patch),
                          generator=gen, device=DEV).to(torch.bfloat16)
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, _ = lm.prefill(params, cfg, toks, extra={"patches": patches},
                           max_seq=VLM_PROMPT)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    text_only, _ = lm.prefill(params, cfg, toks, max_seq=VLM_PROMPT)
    finite = bool(torch.isfinite(logits).all())
    moved = float((logits.float() - text_only.float()).abs().max())
    if not finite or tuple(logits.shape) != (1, cfg.vocab) or moved == 0:
        raise AssertionError(f"prefill with patches: finite {finite}, "
                             f"shape {tuple(logits.shape)}, max change "
                             f"from the patches {moved}")
    if counts.get("flash_attention", 0) != cfg.n_layers:
        raise AssertionError(f"prefill with patches: {counts}, expected "
                             f"{cfg.n_layers} flash launches")
    log(f"serve {cfg.name}: prefill of {VLM_PROMPT} tokens with "
        f"{cfg.vlm.n_patches} patches in {wall:.3f} s, finite logits "
        f"(max change from the patches {moved:.3g}); launches {counts}")
    return dict(prompt=VLM_PROMPT, patches=cfg.vlm.n_patches, wall_s=wall,
                launches=counts, max_change=moved)


def family_serving(arch: str) -> dict:
    """Phases 18 (granite-moe-1b-a400m), 19 (phi-3-vision-4.2b) and 21
    (mamba2-130m, zamba2-1.2b, per slot): the model at full width
    (``SERVE_LAYERS``' depth) served at ``SERVE`` through the port's entry
    points, with phase 8's gates;
    the vlm's prefill with patches; then ``launch.serve --full --arch
    arch``."""
    report, eng, reqs, stats, params = serving_phase(arch)
    cfg = _serve_cfg(arch)
    if cfg.vlm is not None:
        report["patch_prefill"] = _patch_prefill(params, cfg)
    del eng, reqs, stats, params
    torch.cuda.empty_cache()
    report["cli"] = cli_phase(arch)
    return report


# ---------------------------------------------------------------------------
# phases 21-23: the recurrent and encoder-decoder families at full width
# ---------------------------------------------------------------------------

RECURRENT_ARCHS = ("mamba2-130m", "zamba2-1.2b")
AUDIO_ARCH = "whisper-small"
# phase 22: a batch of 8 prompts of 64 tokens and one prompt of 448, each
# with its own frames; 32 greedy decode steps of the batch
AUDIO = dict(batch=8, prompt=64, long_prompt=448, steps=32, seed=0)
# phase 23: decoder layers of each model against the CPU (zamba2: two
# applications of the shared block, cache blocks 0 and 1; whisper: 2
# encoder layers too), prompts below the chunk of 256, not a multiple of
# it, and two chunks, each followed by CPU_STEPS greedy decode steps
FAMILY_CPU_LAYERS = {"mamba2-130m": 2, "zamba2-1.2b": 12,
                     "whisper-small": 2}
CPU_PROMPTS = (37, 300, 512)
CPU_STEPS = 8


def whisper_phase() -> dict:
    """Phase 22: whisper-small at full width (12 + 12 layers, bf16, random
    weights from a seed) through ``make_prefill_step`` and
    ``make_decode_step`` with frames from a seed: one prefill of a
    ``long_prompt``-token prompt, one of ``batch`` prompts of ``prompt``
    tokens, each with flash once an encoder layer, once a decoder layer's
    self-attention and once its cross-attention; the batch's logits
    moved by other frames; then ``steps`` greedy decode steps, each with
    flash-decode (self-attention) and flash (cross-attention, one query)
    once a layer; every logit finite."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.dispatch import launch_counts, reset_launches
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models import lm
    cfg = dataclasses.replace(get_config(AUDIO_ARCH), attn_impl="kernel")
    a = AUDIO
    params = lm.init_params(cfg, a["seed"])
    n_params = sum(t.numel() for t in _leaves(params))
    if n_params != cfg.param_count():
        raise AssertionError(f"{n_params} parameters, config says "
                             f"{cfg.param_count()}")
    gen = torch.Generator(device=DEV).manual_seed(a["seed"])
    ctx = cfg.encdec.n_audio_ctx
    B, S = a["batch"], a["prompt"]
    frames = torch.randn((B, ctx, cfg.d_model), generator=gen,
                         device=DEV).to(torch.bfloat16)
    flash_per_prefill = cfg.encdec.n_encoder_layers + 2 * cfg.n_layers
    decode = make_decode_step(cfg)
    out, logits = {}, None
    for b, n in ((1, a["long_prompt"]), (B, S)):
        toks = torch.randint(0, cfg.vocab, (b, n), generator=gen,
                             device=DEV, dtype=torch.int32)
        prefill = make_prefill_step(cfg, max_seq=n + a["steps"])
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = prefill(params, {"tokens": toks,
                                         "frames": frames[:b]})
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launch_counts()
        finite = bool(torch.isfinite(logits).all())
        if not finite or tuple(logits.shape) != (b, cfg.vocab) or \
                counts != {"flash_attention": flash_per_prefill}:
            raise AssertionError(
                f"whisper prefill of {b} x {n}: finite {finite}, shape "
                f"{tuple(logits.shape)}, launches {counts}, expected "
                f"{flash_per_prefill} flash")
        out[f"prefill {b}x{n}"] = dict(wall_s=wall, launches=counts)
    other, _ = prefill(params, {"tokens": toks, "frames": frames.flip(0)})
    moved = float((other.float() - logits.float()).abs().max())
    if moved == 0:
        raise AssertionError("whisper: other frames leave the logits as "
                             "they were")
    tok = logits.argmax(-1).to(torch.int32)
    bad = torch.zeros((), dtype=torch.bool, device=DEV)
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(a["steps"]):
        step_logits, cache = decode(params, tok, cache)
        bad.logical_or_(~torch.isfinite(step_logits).all())
        tok = step_logits.argmax(-1).to(torch.int32)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    want = {"decode_attention": cfg.n_layers * a["steps"],
            "flash_attention": cfg.n_layers * a["steps"]}
    if bool(bad) or counts != want or int(cache["len"]) != S + a["steps"]:
        raise AssertionError(f"whisper decode: a logit not finite "
                             f"({bool(bad)}), launches {counts}, expected "
                             f"{want}, len {int(cache['len'])}")
    out["decode"] = dict(batch=B, steps=a["steps"], wall_s=wall,
                         ms_per_step=wall / a["steps"] * 1e3,
                         launches=counts)
    log(f"whisper {cfg.name}: {n_params} params {cfg.dtype}; prefill "
        + ", ".join(f"{k} in {v['wall_s']:.3f} s" for k, v in out.items()
                    if k.startswith("prefill"))
        + f" ({flash_per_prefill} flash launches each); other frames move "
        f"the logits by up to {moved:.3g}; {a['steps']} decode steps of "
        f"{B} in {wall:.3f} s ({out['decode']['ms_per_step']:.2f} ms/step),"
        f" launches {counts}")
    del params, cache
    torch.cuda.empty_cache()
    return dict(arch=AUDIO_ARCH, params=n_params, **a, max_change=moved,
                **out)


def family_vs_cpu(arch: str) -> dict:
    """Phase 23: ``arch`` at full width cut to ``FAMILY_CPU_LAYERS``,
    float32, the same weights on the card (kernels) and the CPU (their
    plain versions), one prompt a call as the per-slot path runs it: each
    of ``CPU_PROMPTS`` prefilled (whisper with 1500 frames), its SSM and
    conv states and logits held against the CPU's, then ``CPU_STEPS``
    greedy decode steps; logits within ``LOGIT_REL_TOL`` of their largest
    magnitude, greedy tokens equal, and the card's launches those of the
    path."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.dispatch import launch_counts, reset_launches
    from repro_torch.models import lm
    base = get_config(arch)
    cfg = dataclasses.replace(base, n_layers=FAMILY_CPU_LAYERS[arch],
                              dtype="float32", attn_impl="kernel")
    if cfg.encdec is not None:
        cfg = dataclasses.replace(cfg, encdec=dataclasses.replace(
            cfg.encdec, n_encoder_layers=FAMILY_CPU_LAYERS[arch]))
    p_cpu = lm.init_params(cfg, 1, device="cpu")

    def to_card(t):
        return {k: to_card(v) for k, v in t.items()} \
            if isinstance(t, dict) else t.to(DEV)
    p_card = to_card(p_cpu)
    rng = np.random.default_rng(2)
    extra = {"cpu": {}, DEV: {}}
    if cfg.encdec is not None:
        f = torch.from_numpy(rng.standard_normal(
            (1, cfg.encdec.n_audio_ctx, cfg.d_model)).astype(np.float32))
        extra = {"cpu": {"frames": f}, DEV: {"frames": f.to(DEV)}}
    steps = []

    def rel(got, want) -> float:
        want = want.double()
        return float((got.cpu().double() - want).abs().max()
                     / want.abs().max())

    def compare(what: str, logits: dict) -> torch.Tensor:
        r = rel(logits[DEV], logits["cpu"])
        tok_c = logits["cpu"].argmax(-1)
        equal = bool(torch.equal(tok_c, logits[DEV].argmax(-1).cpu()))
        steps.append(dict(what=what, rel_err=r, greedy_equal=equal))
        if r > LOGIT_REL_TOL or not equal:
            raise AssertionError(f"card vs CPU ({arch}) at {what}: rel "
                                 f"{r:.3e} (limit {LOGIT_REL_TOL:g}), "
                                 f"greedy equal {equal}")
        return tok_c.to(torch.int32)

    reset_launches()
    for S in CPU_PROMPTS:
        toks = torch.from_numpy(rng.integers(0, cfg.vocab, (1, S))
                                .astype(np.int32))
        logits, caches = {}, {}
        for dev, p in (("cpu", p_cpu), (DEV, p_card)):
            logits[dev], caches[dev] = lm.prefill(
                p, cfg, toks.to(dev), extra=extra[dev],
                max_seq=S + CPU_STEPS, use_kernel=True)
        for key in ("ssm", "conv"):
            if key in caches["cpu"]:
                r = rel(caches[DEV][key], caches["cpu"][key])
                steps.append(dict(what=f"S={S} {key} state", rel_err=r))
                if r > LOGIT_REL_TOL:
                    raise AssertionError(f"card vs CPU ({arch}) S={S}: "
                                         f"{key} state rel {r:.3e}")
        tok = compare(f"S={S} prefill", logits)
        for s in range(CPU_STEPS):
            for dev, p in (("cpu", p_cpu), (DEV, p_card)):
                logits[dev], caches[dev] = lm.decode_step(
                    p, cfg, tok.to(dev), caches[dev])
            tok = compare(f"S={S} decode {s}", logits)
    counts = launch_counts()
    n = len(CPU_PROMPTS)
    apps = _attn_apps(cfg)
    want = {"ssd_scan": cfg.n_layers * n if cfg.ssm is not None else 0,
            "flash_attention": apps * n,
            "decode_attention": apps * CPU_STEPS * n}
    if cfg.encdec is not None:      # encoder, cross-attention a step
        want["flash_attention"] += (cfg.encdec.n_encoder_layers
                                    + cfg.n_layers) * n \
            + cfg.n_layers * CPU_STEPS * n
    if {k: v for k, v in counts.items() if v} != \
            {k: v for k, v in want.items() if v}:
        raise AssertionError(f"card vs CPU ({arch}): launches {counts}, "
                             f"expected {want}")
    worst = max(s["rel_err"] for s in steps)
    log(f"card vs cpu: {arch} at {cfg.n_layers} layers, float32, prompts "
        f"{list(CPU_PROMPTS)} one a call + {CPU_STEPS} decode steps each: "
        f"logits and states within {worst:.2e} of max |cpu| (limit "
        f"{LOGIT_REL_TOL:g}), greedy tokens equal; launches {counts}")
    return dict(arch=arch, layers=cfg.n_layers, prompt_lens=CPU_PROMPTS,
                steps=steps, max_rel_err=worst, launches=counts)


# ---------------------------------------------------------------------------
# phases 24-25: the serving engine's compiled steps through the compile
# cache
# ---------------------------------------------------------------------------

COMPILED_BATCH_SIZES = (1, 2, 4, 8)
# phase 24 at full width and a cut depth (the script's time limit, with
# phase 27 added): its cold warmup exports and compiles the
# model's graphs, whose seconds scale with the layers (a 28-layer run on
# a slow host: 72 s of export and 151 s of compile of a 219 s warmup,
# the script 1322 s; 8 layers, 82.0 s of warmup, until the families'
# training was added; 4 layers, 81.1 s of warmup on a slow host, until
# the dense models were served); phase 8 serves all 28
COMPILED_LAYERS = 2
COMPILED_STEPS = 16         # decode steps profiled alone
# phase 25: Qwen3 at 2 float32 layers, 4 ragged prompts in a 512 bucket,
# 8 decode steps; mamba2 at 2 float32 layers per slot, prompts of
# COMPILED_PROMPT tokens (the compiled prefill's) and one other
COMPILED_PROMPT = 300
MAMBA_CPU_ARCH = "mamba2-130m"


def _exe_report(eng) -> dict:
    """Each compiled executable of an engine: its package bytes and its
    export, compile and load seconds."""
    return {kind: dict(bytes=len(exe.payload), kind=exe.kind,
                       **{k: round(v, 3) for k, v in exe.timing.items()})
            for kind, exe in eng.executables.items()}


def _device_kernels(prof) -> tuple[int, float]:
    """Kernel launches and their device microseconds in a profile (copies
    and memsets left out)."""
    n, us = 0, 0.0
    for e in prof.key_averages():
        t = float(getattr(e, "self_device_time_total", 0.0) or 0.0)
        if t > 0 and not e.key.startswith(("Memcpy", "Memset")):
            n, us = n + e.count, us + t
    return n, us


def _compiled_cfg():
    """Phase 24's model: Qwen3-0.6B at full width, ``COMPILED_LAYERS``
    deep, attention on the kernels (the cold and the warm process)."""
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(ARCH), attn_impl="kernel",
                               n_layers=COMPILED_LAYERS)


def compiled_serving_phase() -> dict:
    """Phase 24: Qwen3-0.6B at full width cut to ``COMPILED_LAYERS`` layers
    (bf16, phase 8's seed and requests) served through the engine's
    compiled steps:
    ``warmup(cache=...)`` into an empty store under a temporary
    ``build/serve_cache_*`` (deleted) at batch sizes
    ``COMPILED_BATCH_SIZES`` and phase 8's buckets — every (batch size,
    bucket) and the decode step ``"compiled"`` — then phase 8's 16
    requests (every request ``max_new`` tokens; flash once a layer a
    prefill call and flash-decode once a layer a step, counted by the
    wrappers the packages call back); then the warm half in a fresh
    process on the same store (:func:`warm_serving`): no
    executable ``"compiled"``, its warmup seconds, one wave, and the
    decode step alone under the
    profiler (every flash-decode launch a ``decode_partial_kernel``: one
    a layer a step; kernels and device ms a step) and one compiled
    prefill (a ``flash_wgmma_kernel`` a layer)."""
    import shutil
    import tempfile
    from repro_torch.core.compile_cache import CompileCache
    from repro_torch.kernels.dispatch import launch_counts, reset_launches
    from repro_torch.models import lm
    from repro_torch.serve import ServeConfig, ServingEngine, serve_requests
    cfg = _compiled_cfg()
    params = lm.init_params(cfg, SERVE["seed"])
    scfg = ServeConfig(batch_slots=SERVE["slots"], max_seq=SERVE["max_seq"])
    (ROOT / "build").mkdir(exist_ok=True)
    root = Path(tempfile.mkdtemp(prefix="serve_cache_", dir=ROOT / "build"))
    try:
        eng = ServingEngine(scfg, batched=lm.serving_adapter(
            params, cfg, max_seq=SERVE["max_seq"]))
        from repro_torch.core import compile_cache
        up = sum(w.proc.poll() is None for w in compile_cache._workers)
        t0 = time.perf_counter()
        info = eng.warmup(cache=CompileCache(root=root, max_bytes=8 << 30),
                          batch_sizes=COMPILED_BATCH_SIZES)
        warm_s = time.perf_counter() - t0
        if not info["ok"]:
            raise AssertionError(f"compiled warmup failed: {info}")
        sources = {s for _, _, s in eng.compile_log}
        if sources != {"compiled"} or info["decode"] != "compiled":
            raise AssertionError(f"cold warmup sources {sources}: {info}")
        exes = _exe_report(eng)
        log(f"compiled serve: cold warmup {warm_s:.1f} s into an empty "
            f"store ({up} compile processes already up, from phase 17), "
            f"{len(info['buckets'])} (batch size, bucket) prefills "
            f"and the decode step all compiled; executables "
            + "; ".join(f"{k} {v['bytes'] / 1e6:.2f} MB export "
                        f"{v['export_s']:.1f} s compile {v['compile_s']:.1f}"
                        f" s load {v['load_s']:.2f} s"
                        for k, v in exes.items()))

        reqs = _serve_requests(cfg)                    # phase 8's
        stats = _CallStats()
        for key, fn in list(eng._exe.items()):
            if key[0] in ("prefill", "step"):
                eng._exe[key] = stats.wrap(
                    "prefill" if key[0] == "prefill" else "decode", fn)
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = serve_requests(eng, reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launch_counts()
        bad = {r.rid: res.get(r.rid) for r in reqs
               if not (isinstance(res.get(r.rid), list)
                       and len(res[r.rid]) == SERVE["max_new"])}
        n_pre, n_dec = stats.n["prefill"], stats.n["decode"]
        want = {"flash_attention": cfg.n_layers * n_pre,
                "decode_attention": cfg.n_layers * n_dec}
        if bad or n_pre == 0 or n_dec == 0 or any(
                counts.get(k, 0) != v for k, v in want.items()):
            raise AssertionError(f"compiled serve: requests not ok {bad}; "
                                 f"launches {counts} in {n_pre} prefill and "
                                 f"{n_dec} decode calls, expected {want}")
        n_tok = sum(len(v) for v in res.values())
        tokens = {r.rid: res[r.rid] for r in reqs}
        log(f"compiled serve: {len(reqs)} requests -> {n_tok} tokens in "
            f"{wall:.3f} s ({n_tok / wall:.1f} tok/s); prefill {n_pre} "
            f"calls {stats.s['prefill']:.3f} s, decode {n_dec} steps "
            f"{stats.s['decode'] / n_dec * 1e3:.2f} ms a step; launches "
            f"{counts}")
        del eng
        torch.cuda.empty_cache()

        t0 = time.perf_counter()
        r = subprocess.run(
            [sys.executable, str(ROOT / "chip_smoke.py"), "--warm-serve"],
            capture_output=True, text=True, timeout=900,
            env={**os.environ, "REPRO_TORCH_COMPILE_CACHE": str(root),
                 "REPRO_TORCH_COMPILE_CACHE_MAX_MB": "8192"})
        warm_proc_s = time.perf_counter() - t0
        if r.returncode != 0:
            raise AssertionError(f"warm serving process (rc {r.returncode})"
                                 f":\n{r.stdout[-2000:]}\n"
                                 f"{r.stderr[-3000:]}")
        warm = json.loads(r.stdout.strip().splitlines()[-1])
        warm["process_s"] = warm_proc_s
        same = [rid for rid, t in warm.pop("token_lists").items()
                if t == tokens[int(rid)]]
        warm["wave_tokens_equal_cold"] = len(same)
        st = warm["step_alone"]
        log(f"compiled serve, warm process (a fresh python on the same "
            f"store): warmup {warm['warmup_s']:.2f} s, sources "
            f"{sorted(set(warm['sources']))}; one wave of "
            f"{warm['requests']} requests in {warm['wall_s']:.3f} s "
            f"({warm['tok_per_s']:.1f} tok/s), {len(same)} of them with "
            f"the cold process's tokens; the decode step alone "
            f"{st['host_ms_per_step']:.3f} ms, device "
            f"{st['device_ms_per_step']:.3f} ms ({st['busy_share']:.1%}), "
            f"{st['kernels_per_step']} kernels ({cfg.n_layers} "
            f"decode_partial_kernel, "
            f"{st['decode_partial_per_launch_us']:.2f} us a launch); a "
            f"1024-token prefill {st['prefill_1024']['device_ms']:.3f} ms "
            f"device, {st['prefill_1024']['kernels']} kernels "
            f"({cfg.n_layers} "
            f"flash_wgmma_kernel, "
            f"{st['prefill_1024']['flash_per_launch_us']:.2f} us a "
            f"launch); process {warm_proc_s:.1f} s")
        return dict(
            arch=ARCH, layers=cfg.n_layers, dtype=cfg.dtype,
            batch_sizes=COMPILED_BATCH_SIZES, buckets=list(info["buckets"]),
            cold_warmup_s=warm_s, compile_processes_up=up, sources=info,
            executables=exes, wall_s=wall, tokens_out=n_tok,
            tok_per_s=n_tok / wall, prefill_calls=n_pre,
            prefill_s=stats.s["prefill"], decode_steps=n_dec,
            decode_s=stats.s["decode"],
            decode_ms_per_step=stats.s["decode"] / n_dec * 1e3,
            launches=counts,
            step_alone=warm["step_alone"], warm_process=warm,
            token_lists=tokens)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def warm_serving() -> dict:
    """Phase 24's warm half, run as ``chip_smoke.py --warm-serve`` in a
    fresh process on phase 24's store (``$REPRO_TORCH_COMPILE_CACHE``):
    phase 24's engine warmed up through ``default_cache()``, as
    ``launch.serve`` warms up (no executable ``"compiled"``), one wave of
    phase 8's requests through the compiled steps, then
    :func:`_compiled_step_profile` (a fresh process: the profiler there
    has seen no earlier session; in the long main process it missed 3
    kernel records of each one).  Returns what it measured."""
    from repro_torch.core.compile_cache import default_cache
    from repro_torch.models import lm
    from repro_torch.serve import ServeConfig, ServingEngine, serve_requests
    cfg = _compiled_cfg()
    params = lm.init_params(cfg, SERVE["seed"])
    eng = ServingEngine(
        ServeConfig(batch_slots=SERVE["slots"], max_seq=SERVE["max_seq"]),
        batched=lm.serving_adapter(params, cfg, max_seq=SERVE["max_seq"]))
    t0 = time.perf_counter()
    info = eng.warmup(cache=default_cache(), batch_sizes=COMPILED_BATCH_SIZES)
    warm_s = time.perf_counter() - t0
    sources = [s for _, _, s in eng.compile_log]
    if not info["ok"] or "compiled" in sources:
        raise AssertionError(f"warm process: {info}")
    wave = _serve_requests(cfg)[:SERVE["slots"]]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = serve_requests(eng, wave)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n_tok = sum(len(v) for v in res.values())
    if n_tok != SERVE["max_new"] * len(wave):
        raise AssertionError(f"warm process: tokens {res}")
    return dict(warmup_s=warm_s, sources=sources, requests=len(wave),
                wall_s=wall, tok_per_s=n_tok / wall,
                token_lists={r.rid: res[r.rid] for r in wave},
                step_alone=_compiled_step_profile(eng, wave, cfg))


def _compiled_step_profile(eng, wave: list, cfg) -> dict:
    """The engine's compiled decode step alone on a packed cache holding
    ``wave`` (written by the compiled prefill and slot write), as the
    serving loop calls it (tokens to the card and back a step):
    ``COMPILED_STEPS`` steps timed, then one under the profiler (kernels
    launched and device ms a step, each flash-decode launch one
    ``decode_partial_kernel``); then one compiled prefill of a
    1024-token prompt: one ``flash_wgmma_kernel`` a layer."""
    n, bucket = len(wave), SERVE["max_seq"]
    pre = eng._compiled["prefill"][0]
    step = eng._compiled["decode_step"][0]
    write = eng._compiled["write_slot"][0]
    toks = np.zeros((n, bucket), np.int32)
    lens = np.array([len(r.prompt) for r in wave], np.int32)
    for i, r in enumerate(wave):
        toks[i, :len(r.prompt)] = r.prompt
    packed = eng.batched.init_slots(n)
    first, cache = pre(_dev32(toks), _dev32(lens), _dev32(0))
    for i in range(n):
        write(packed, cache, _dev32(i), _dev32(i))
    del cache
    tok = first.cpu().numpy()

    def step_once(s: int) -> None:
        nonlocal tok
        nxt, _ = step(_dev32(tok), packed, _dev32(s))
        tok = nxt.cpu().numpy()

    for s in range(2):                      # warm
        step_once(s)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for s in range(COMPILED_STEPS):
        step_once(s)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0

    def run():
        step_once(0)
        torch.cuda.synchronize()

    def check(prof, _):
        _, kern = _device_times(prof)
        _check_decode_route(kern, cfg.n_layers, "compiled decode step")
        return kern, _device_kernels(prof)

    # one step under the profiler (a long profile loses records on this
    # card now and then), the steps above timed without it
    _, _, (kern, (n_kern, us)) = _profiled(run, check,
                                          "compiled decode step")
    one = torch.from_numpy(np.random.default_rng(7).integers(
        0, cfg.vocab, (1, 1024)).astype(np.int32))

    def run_prefill():
        return pre(one.to(DEV), _dev32([1024]), _dev32(0))

    def check_prefill(prof, out):
        _, k = _device_times(prof)
        _check_flash_route(k, cfg.n_layers, "compiled prefill")
        return k, _device_kernels(prof)

    _, _, (pkern, (p_n, p_us)) = _profiled(run_prefill, check_prefill,
                                           "compiled prefill")
    host_ms = wall / COMPILED_STEPS * 1e3
    out = dict(
        steps=COMPILED_STEPS, slots=n, host_ms_per_step=host_ms,
        device_ms_per_step=us / 1e3, kernels_per_step=n_kern,
        busy_share=us / 1e3 / host_ms if us else None,
        decode_partial_per_launch_us=kern["decode_attention"][1]
        / kern["decode_attention"][0],
        prefill_1024=dict(kernels=p_n, device_ms=p_us / 1e3,
                          flash_per_launch_us=pkern["flash_attention"][1]
                          / pkern["flash_attention"][0]))
    log(f"compiled decode step alone ({n} slots, {COMPILED_STEPS} steps "
        f"timed, one profiled): {out['host_ms_per_step']:.3f} ms a step, "
        f"device {out['device_ms_per_step']:.3f} ms "
        f"({out['busy_share']:.1%}), {out['kernels_per_step']} kernels a "
        f"step, flash-decode "
        f"{out['decode_partial_per_launch_us']:.2f} us device a launch; "
        f"compiled prefill of 1024 tokens: {p_n} kernels, "
        f"{p_us / 1e3:.3f} ms device, flash "
        f"{out['prefill_1024']['flash_per_launch_us']:.2f} us a launch")
    return out


def _qwen_case(kv_quant: bool, root: Path) -> dict:
    """Phase 25's Qwen3 case: full width cut to 2 layers, float32, the
    same weights on the card and the CPU, an adapter on each (sampling:
    its graphs return logits) and the card's engine, with the warmup
    through the compile cache (``warm``) still to run."""
    from repro_torch.configs import get_config
    from repro_torch.core.compile_cache import CompileCache
    from repro_torch.models import lm
    from repro_torch.serve import ServeConfig, ServingEngine
    cfg = dataclasses.replace(get_config(ARCH), n_layers=2, dtype="float32",
                              attn_impl="kernel", kv_quant=kv_quant)
    p_cpu = lm.init_params(cfg, 1, device="cpu")

    def to_card(t):
        return {k: to_card(v) for k, v in t.items()} \
            if isinstance(t, dict) else t.to(DEV)
    p_card = to_card(p_cpu)
    n, bucket, max_seq = 4, 512, 1024
    ad = {dev: lm.serving_adapter(p, cfg, max_seq=max_seq, temperature=1.0,
                                  device=dev)
          for dev, p in (("cpu", p_cpu), (DEV, p_card))}
    eng = ServingEngine(ServeConfig(batch_slots=n, max_seq=max_seq,
                                    prefill_buckets=(bucket,)),
                        batched=ad[DEV])
    cc = CompileCache(root=root / f"qwen_kvq{int(kv_quant)}")
    return dict(kind="qwen", kv_quant=kv_quant, cfg=cfg, n=n, bucket=bucket,
                par={"compiled": p_card, "eager": p_card, "cpu": p_cpu},
                ad=ad, eng=eng,
                warm=lambda: eng.warmup(cache=cc, batch_sizes=(n,)))


def _qwen_check(case: dict, info: dict, warm_s: float) -> dict:
    """Phase 25, Qwen3: the engine's compiled prefill, slot write and
    decode step against the same graphs run eagerly on the card and on
    the CPU: 4 ragged prompts in a 512 bucket, then 8 decode steps on
    the CPU's greedy tokens; logits within ``LOGIT_REL_TOL`` of their
    largest magnitude and greedy tokens equal, compiled and eager card
    each against the CPU.  With kv_quant the card's caches are set to
    the CPU's int8 cache before each step (``resync``), and the codes
    that differed are counted."""
    from repro_torch.kernels.dispatch import launch_counts, reset_launches
    from repro_torch.models import lm
    kv_quant, cfg, eng, ad = (case[k] for k in ("kv_quant", "cfg", "eng",
                                                "ad"))
    n, bucket, par = case["n"], case["bucket"], case["par"]
    if not info["ok"] or {s for _, _, s in eng.compile_log} != {"compiled"}:
        raise AssertionError(f"compiled warmup (kv_quant={kv_quant}): "
                             f"{info}")
    exe = eng.executables
    rng = np.random.default_rng(3)
    lens = np.array([37, 512, *rng.integers(38, 512, 2)], np.int32)
    toks = np.zeros((n, bucket), np.int32)
    for i, k in enumerate(lens):
        toks[i, :k] = rng.integers(0, cfg.vocab, k)
    paths = ("compiled", "eager", "cpu")
    dev_of = {"compiled": DEV, "eager": DEV, "cpu": "cpu"}

    def t32(x, dev):
        return torch.from_numpy(np.asarray(x, np.int32)).to(dev)

    reset_launches()
    logits, packed = {}, {}
    for pth in paths:
        dev = dev_of[pth]
        args = (par[pth], t32(toks, dev), t32(lens, dev), t32(0, dev))
        logits[pth], cache = exe["prefill"](*args) if pth == "compiled" \
            else ad[dev].prefill_graph(*args)
        packed[pth] = ad[dev].init_slots(n)
        for i in range(n):
            if pth == "compiled":
                exe["write_slot"](packed[pth], cache, t32(i, dev),
                                  t32(i, dev))
            else:
                lm.write_slot(packed[pth], cache, t32(i, dev), t32(i, dev))
    steps = []
    flips = {"compiled": 0, "eager": 0}

    def resync() -> None:
        """kv_quant: the card's packed caches take the CPU's (int8 codes
        and fp16 scales) before a step, so the three paths decode from
        one cache: a float difference of ~1e-7 moves a value across a
        rounding boundary now and then, and its code by one step, ~1% of
        that row's largest magnitude (counted, float-class)."""
        for pth in flips:
            for key in ("k", "v"):
                flips[pth] += int((packed[pth][key].cpu()
                                   != packed["cpu"][key]).sum())
            for key, t in packed["cpu"].items():
                packed[pth][key].copy_(t)

    def compare(what: str) -> torch.Tensor:
        want = logits["cpu"].double()
        row = dict(what=what)
        for pth in ("compiled", "eager"):
            got = logits[pth].cpu().double()
            rel = float((got - want).abs().max() / want.abs().max())
            equal = bool(torch.equal(got.argmax(-1), want.argmax(-1)))
            row[pth] = dict(rel_err=rel, greedy_equal=equal)
            if rel > LOGIT_REL_TOL or not equal:
                raise AssertionError(
                    f"compiled vs CPU (kv_quant={kv_quant}) at {what}: "
                    f"{pth} rel {rel:.3e} (limit {LOGIT_REL_TOL:g}), greedy "
                    f"equal {equal}")
        row["compiled_vs_eager"] = float(
            (logits["compiled"] - logits["eager"]).abs().max().cpu()
            / logits["eager"].abs().max().cpu())
        steps.append(row)
        return logits["cpu"].argmax(-1).to(torch.int32)

    tok = compare("prefill")
    for s in range(8):
        if kv_quant:
            resync()
        for pth in paths:
            dev = dev_of[pth]
            args = (par[pth], tok.to(dev), packed[pth], t32(s + 1, dev))
            logits[pth] = exe["decode_step"](*args) if pth == "compiled" \
                else ad[dev].step_graph(*args)
        tok = compare(f"decode {s}")
    counts = launch_counts()
    want = {"flash_attention": 2 * cfg.n_layers,
            "decode_attention": 0 if kv_quant else 2 * 8 * cfg.n_layers}
    if any(counts.get(k, 0) != v for k, v in want.items()):
        raise AssertionError(f"compiled vs CPU (kv_quant={kv_quant}): "
                             f"launches {counts}, expected {want}")
    worst = {pth: max(r[pth]["rel_err"] for r in steps)
             for pth in ("compiled", "eager")}
    log(f"compiled vs cpu: {ARCH} at 2 float32 layers, kv_quant={kv_quant}, "
        f"prompts {lens.tolist()} + 8 ragged decode steps through the "
        f"compiled prefill, slot write and step ({warm_s:.1f} s to warm "
        f"up): compiled within {worst['compiled']:.2e}, eager card within "
        f"{worst['eager']:.2e} of max |cpu logit| (limit "
        f"{LOGIT_REL_TOL:g}), greedy tokens equal; compiled vs eager "
        f"{max(r['compiled_vs_eager'] for r in steps):.2e}; launches "
        f"{counts}" + (f"; int8 codes that differed from the CPU's before "
                       f"a step's resync: {flips}" if kv_quant else ""))
    return dict(kv_quant=kv_quant, layers=cfg.n_layers, code_flips=flips,
                prompt_lens=lens.tolist(), warmup_s=warm_s,
                executables=_exe_report(eng), steps=steps,
                max_rel_err=worst, launches=counts)


def _mamba2_case(root: Path) -> dict:
    """Phase 25's mamba2-130m case: full width cut to 2 float32 layers,
    per slot (``launch.serve``'s ``per_slot_engine``): the eager engine's
    tokens for 4 requests of ``COMPILED_PROMPT`` tokens (the compiled
    prefill's shape) and one of 37, and a second engine whose warmup
    through the compile cache (``warm``) is still to run."""
    from repro_torch.configs import get_config
    from repro_torch.core.compile_cache import CompileCache
    from repro_torch.launch.serve import per_slot_engine
    from repro_torch.models import lm
    from repro_torch.serve import Request, ServeConfig, serve_requests
    cfg = dataclasses.replace(get_config(MAMBA_CPU_ARCH), n_layers=2,
                              dtype="float32")
    params = lm.init_params(cfg, 1)
    scfg = ServeConfig(batch_slots=2, max_seq=COMPILED_PROMPT + 16)
    rng = np.random.default_rng(4)
    reqs = [Request(i, rng.integers(0, cfg.vocab, k).tolist(), max_new=8)
            for i, k in enumerate([COMPILED_PROMPT] * 4 + [37])]
    eager = per_slot_engine(params, cfg, scfg, torch.device(DEV))
    eager.warmup()
    want = serve_requests(eager, reqs)
    eng = per_slot_engine(params, cfg, scfg, torch.device(DEV))
    cc = CompileCache(root=root / "mamba2")
    return dict(kind="mamba2", cfg=cfg, reqs=reqs, want=want, eng=eng,
                warm=lambda: eng.warmup(prompt_len=COMPILED_PROMPT,
                                        cache=cc))


def _mamba2_check(case: dict, info: dict, warm_s: float) -> dict:
    """Phase 25, mamba2 per slot through the compile cache: prefill and
    decode ``"compiled"``; the requests give the eager engine's tokens
    (the one of 37 tokens: an eager prefill, then the compiled decode),
    with no fall-off to eager decode; the SSD kernel inside the compiled
    prefill (the profile of one call: one ``ssd_state_mma`` a layer)."""
    from repro_torch.kernels.dispatch import launch_counts, reset_launches
    from repro_torch.serve import serve_requests
    cfg, reqs, want, eng = (case[k] for k in ("cfg", "reqs", "want", "eng"))
    if info != {"ok": True, "prefill": "compiled", "decode": "compiled"}:
        raise AssertionError(f"mamba2 per-slot compiled warmup: {info}")
    reset_launches()
    got = serve_requests(eng, reqs)
    counts = launch_counts()
    if got != want or eng.fall_offs:
        raise AssertionError(f"mamba2 compiled per slot: tokens {got} vs "
                             f"eager {want}; fall-offs {eng.fall_offs}")
    if counts.get("ssd_scan", 0) != cfg.n_layers * len(reqs):
        raise AssertionError(f"mamba2 compiled per slot: launches {counts}")
    pre = eng._aot_prefill[(1, COMPILED_PROMPT)]
    prompt = np.asarray(reqs[0].prompt, np.int32)[None]

    def check(prof, out):
        n = us = 0
        for e in prof.key_averages():
            if any(k in e.key for k in SSD_KERNELS):
                n += e.count if SSD_KERNELS[0] in e.key else 0
                us += float(e.self_device_time_total)
        if n != cfg.n_layers:
            raise AssertionError(f"compiled mamba2 prefill: the profiler "
                                 f"saw {n} {SSD_KERNELS[0]}, expected "
                                 f"{cfg.n_layers}")
        return n, us

    _, _, (n_ssd, us) = _profiled(lambda: pre(prompt), check,
                                  "compiled mamba2 prefill")
    log(f"compiled mamba2 per slot: 2 float32 layers, prefill and decode "
        f"compiled ({warm_s:.1f} s to warm up); {len(reqs)} requests (4 of "
        f"{COMPILED_PROMPT} tokens, one of 37) give the eager engine's "
        f"tokens, no fall-off; SSD launches {counts.get('ssd_scan')}; the "
        f"compiled prefill ran {n_ssd} SSD launches ({us / n_ssd:.2f} us "
        f"device each, its three kernels)")
    return dict(layers=cfg.n_layers, prompt=COMPILED_PROMPT,
                warmup_s=warm_s, executables=_exe_report(eng),
                tokens_equal=True, fall_offs=len(eng.fall_offs),
                launches=counts, ssd_in_prefill=n_ssd,
                ssd_device_us=us / n_ssd)


def compiled_vs_cpu() -> dict:
    """Phase 25: the compiled steps at float32 against the eager ones and
    the CPU (Qwen3, kv_quant off and on) and mamba2 per slot compiled;
    the three engines warm up together (their exports one at a time,
    their packages side by side in the free compile processes), then each
    is checked; stores under a temporary ``build/serve_cache_*``,
    deleted."""
    import shutil
    import tempfile
    (ROOT / "build").mkdir(exist_ok=True)
    root = Path(tempfile.mkdtemp(prefix="serve_cache_", dir=ROOT / "build"))
    try:
        def warm(make):         # a case set up, then warmed up
            case = make()
            t0 = time.perf_counter()
            info = case["warm"]()
            return case, info, time.perf_counter() - t0

        t0 = time.perf_counter()
        with ThreadPoolExecutor(3) as pool:
            warmed = list(pool.map(warm, (
                lambda: _qwen_case(False, root),
                lambda: _qwen_case(True, root),
                lambda: _mamba2_case(root))))
        warm_s = time.perf_counter() - t0
        log(f"compiled vs cpu: the three engines set up and warmed up "
            f"together in {warm_s:.1f} s")
        checks = [(_qwen_check if c["kind"] == "qwen" else _mamba2_check)(
            c, info, s) for c, info, s in warmed]
        return {"warmup_s": warm_s, "qwen3": checks[:2],
                "mamba2": checks[2]}
    finally:
        shutil.rmtree(root, ignore_errors=True)


# ---------------------------------------------------------------------------
# phase 26: partitioned synthesis, partitions sharing the card
# ---------------------------------------------------------------------------

# gemm and page_rank at phase 4's full widths, placed over 2 and 4
# partitions of one card (an explicit device list: nothing picks a shared
# card silently), and gemm over 2 with two tasks pinned
PARTITIONED = {"gemm": FULL["gemm"], "page_rank": FULL["page_rank"]}
MESHES = (2, 4)
MANUAL_PINS = {"PE0_0": 0, "PE1_1": 1}


def _partitioned_run(name: str, built: tuple, mesh, pins, cache) -> dict:
    """One run of ``name``'s graph (``built``: what ``build_step`` returned)
    through the compiled engine on the card (``mesh=None``: the
    single-device run), its outputs zeroed first, its launch counts zeroed
    just before and read just after, the device time in the sweep graphs
    (``graph_device_s``: the program's CUDA events around each block of
    replays over every partition); its outputs, as the engine left them."""
    from repro_torch import ENGINES
    from repro_torch.kernels.dispatch import launch_counts, reset_launches
    top, args, check = built
    for m in (args[2] if name == "gemm" else [args[1]]):
        m.data.zero_()
    eng = ENGINES["compiled"](device="cuda", mesh=mesh, placement=pins,
                              cache=cache)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    rep = eng.run(top, *args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: launch_counts().get(k, 0) for k in REPLACES}
    graph_s = eng.graph_device_s
    correct, err = check() if rep.ok else (False, float("nan"))
    if not (rep.ok and correct):
        raise AssertionError(f"partitioned {name} mesh={mesh}: the run or "
                             f"check() failed: {rep.error} err={err}")
    return dict(eng=eng, rep=rep, out=_outputs(name, args).clone(),
                wall_s=wall, launches=launches, graph_s=graph_s,
                max_err=err)


def _fired(r: dict) -> tuple:
    """A run's sweeps, each task's end state, each channel's tokens read
    and written (the firing counters times each phase's rates) and the
    ring ops the firings made."""
    import re
    rep, eng = r["rep"], r["eng"]
    return (rep.switches, rep.tokens,
            [(re.sub(r"#\d+", "", n), st) for n, st in rep.instances],
            sorted((c.name, c.total_read, c.total_written)
                   for c in eng.channel_set), eng.ring_ops)


def _partition_gates(tag: str, r: dict, gold: dict, n: int, plan) -> None:
    """Phase 26's gates on one partitioned run against the single-device
    run of the same graph on the card."""
    eng = r["eng"]
    if not torch.equal(r["out"], gold["out"]):
        raise AssertionError(f"{tag}: outputs differ from the single-device "
                             f"run: max |d| "
                             f"{(r['out'] - gold['out']).abs().max():.3e}")
    if _fired(r) != _fired(gold):
        raise AssertionError(f"{tag}: sweeps {r['rep'].switches} or fires "
                             f"differ from the single-device run's "
                             f"{gold['rep'].switches}")
    want = dict(eng.ring_ops, sweep_guards=n * eng.n_replays,
                service_ports=0)
    if r["launches"] != want:
        raise AssertionError(f"{tag}: the kernels counted {r['launches']} "
                             f"launches on the card; the partitions' "
                             f"replays and the firings make {want}")
    pl = eng.placement_used
    bodies = [sum(len(tp.phases) for tp, o in zip(plan.tasks, pl.owners)
                  if o == p) for p in range(n)]
    if eng.partition_nodes != [1 + b + 1 for b in bodies]:
        raise AssertionError(f"{tag}: sweep graphs of {eng.partition_nodes} "
                             f"nodes; the guards, {bodies} bodies and the "
                             f"sweep end make {[b + 2 for b in bodies]}")
    if not (eng.n_replays > 0 and eng.n_host_syncs <= eng.n_blocks + 1):
        raise AssertionError(f"{tag}: {eng.n_replays} replays, "
                             f"{eng.n_host_syncs} host syncs in "
                             f"{eng.n_blocks} blocks")


def partitioned_phase() -> dict:
    """Phase 26: gemm and page_rank at full width, each placed over 2 and
    4 partitions sharing the card on the port's own cost probes, and
    gemm over 2 with ``MANUAL_PINS``: bit-identical to the single-device
    run on the card, the same sweeps and fires, the counted ring launches
    summed over the partitions equal to the firings' pops and pushes,
    ``sweep_guards`` once a partition a replay, each partition's graph
    the guards, its own bodies and its sweep end; gemm over more than one
    partition, the pins honoured; the async gemm refused under a mesh.
    Recorded: the cost probes' cells and seconds, the placement, lowering
    and capture seconds, host syncs, sweeps/s over the sweep loop alone
    (host seconds from the first sweep to the last done-flag read:
    ``loop_s``) and device us a sweep (``graph_device_s``)
    against the single-device run, and the cut bytes copied a sweep.
    Each app is built once (page_rank's build takes seconds) and its
    outputs zeroed before each run.  The
    placements are memoized in a compile cache under a temporary
    ``build/partition_cache_*`` (deleted)."""
    import shutil
    from repro_torch import ENGINES, SynthesisError
    from repro_torch.apps import APPS
    from repro_torch.core import cost
    from repro_torch.core.compile_cache import CompileCache
    from repro_torch.core.synth import elaborate_step_graph
    root = ROOT / "build" / f"partition_cache_{os.getpid()}"
    cc = CompileCache(root=root)
    card = [torch.device("cuda", torch.cuda.current_device())]
    out = {}
    try:
        for name, kw in PARTITIONED.items():
            built = APPS[name].build_step(device="cuda", **kw)
            plan, _, _ = elaborate_step_graph(built[0], *built[1])
            cost.clear_cost_cells()
            t0 = time.perf_counter()
            costs = [cost.task_cost(plan, tp, cache=cc)["seconds"]
                     for tp in plan.tasks]
            probe_s = time.perf_counter() - t0
            cells = len(cost._CELLS)
            log(f"partitioned {name}: cost probes {cells} cells in "
                f"{probe_s:.3f} s for {len(plan.tasks)} tasks (roofline "
                f"{min(costs) * 1e6:.3f}-{max(costs) * 1e6:.3f} us a task)")
            rows = {}
            runs = [("single", None, None)] + [
                (f"mesh={n}", n, None) for n in MESHES]
            if name == "gemm":
                runs.append(("mesh=2 manual", 2, MANUAL_PINS))
            runs.append(("single again", None, None))
            for tag, n, pins in runs:
                r = _partitioned_run(name, built, n and card * n, pins, cc)
                eng = r["eng"]
                if n is None:       # the single-device run, before and after
                    if tag == "single":
                        gold = r
                    if not (torch.equal(r["out"], gold["out"])
                            and _fired(r) == _fired(gold)):
                        raise AssertionError(f"partitioned {name}: two "
                                             f"single-device runs differ")
                    rows[tag] = dict(
                        sweeps=eng.n_sweeps, wall_s=r["wall_s"],
                        program_s=eng.program_s, lower_s=eng.lower_s,
                        capture_s=eng.capture_s, replays=eng.n_replays,
                        host_syncs=eng.n_host_syncs,
                        graph_nodes=eng.n_graph_nodes,
                        loop_s=eng.loop_s,
                        sweeps_per_s=eng.n_sweeps / eng.loop_s,
                        device_us_per_sweep=r["graph_s"] / eng.n_sweeps * 1e6,
                        launches=r["launches"])
                    log(f"partitioned {name} {tag}: {eng.n_sweeps} sweeps, "
                        f"{rows[tag]['sweeps_per_s']:.1f} sweeps/s (sweep "
                        f"loop {eng.loop_s:.4f} s), device "
                        f"{rows[tag]['device_us_per_sweep']:.1f} us a sweep"
                        f", lower {eng.lower_s:.3f} s, capture "
                        f"{eng.capture_s:.3f} s, {eng.n_graph_nodes} graph "
                        f"nodes, {eng.n_host_syncs} host syncs")
                    continue
                _partition_gates(f"partitioned {name} {tag}", r, gold, n,
                                 plan)
                pl = eng.placement_used
                if name == "gemm" and len(set(pl.owners)) < 2:
                    raise AssertionError(f"partitioned gemm {tag}: every "
                                         f"task on one partition")
                byname = dict(zip(pl.task_names, pl.owners))
                if pins and any(byname[k] != v for k, v in pins.items()):
                    raise AssertionError(f"partitioned gemm {tag}: pins "
                                         f"{pins} not honoured: "
                                         f"{ {k: byname[k] for k in pins} }")
                per = [int(sum(1 for o in pl.owners if o == p))
                       for p in range(n)]
                ob = pl.objective
                row = dict(
                    partitions=n, pins=pins, source=eng.partition_source,
                    tasks_per_partition=per, owners=list(pl.owners),
                    cut_channels=len(ob["cut_channels"]),
                    cut_bytes_run=ob["cut_bytes"],
                    objective_s=ob["objective_s"],
                    max_load_s=ob["max_load_s"], loads_s=ob["loads_s"],
                    place_s=eng.place_s, lower_s=eng.lower_s,
                    capture_s=eng.capture_s, program_s=eng.program_s,
                    wall_s=r["wall_s"], sweeps=eng.n_sweeps,
                    replays=eng.n_replays, blocks=eng.n_blocks,
                    host_syncs=eng.n_host_syncs,
                    graph_nodes=eng.partition_nodes,
                    loop_s=eng.loop_s,
                    sweeps_per_s=eng.n_sweeps / eng.loop_s,
                    device_us_per_sweep=r["graph_s"] / eng.n_sweeps * 1e6,
                    cut_bytes_per_sweep=eng.cut_bytes,
                    launches=r["launches"])
                rows[tag] = row
                single = rows["single"]
                log(f"partitioned {name} {tag}: bit-identical to the "
                    f"single-device run; placed ({eng.partition_source}, "
                    f"{eng.place_s:.3f} s) {per} tasks a partition, "
                    f"{row['cut_channels']} cut channels, "
                    f"{ob['cut_bytes']} cut bytes over the run, objective "
                    f"{ob['objective_s'] * 1e6:.3f} us (max load "
                    f"{ob['max_load_s'] * 1e6:.3f} us); lower "
                    f"{eng.lower_s:.3f} s, capture {eng.capture_s:.3f} s, "
                    f"graph nodes {eng.partition_nodes}; {eng.n_sweeps} "
                    f"sweeps, {eng.n_replays} replays, {eng.n_host_syncs} "
                    f"host syncs; {row['sweeps_per_s']:.1f} sweeps/s "
                    f"over the sweep loop's {eng.loop_s:.4f} s (single "
                    f"{single['sweeps_per_s']:.1f}), device "
                    f"{row['device_us_per_sweep']:.1f} us a sweep (single "
                    f"{single['device_us_per_sweep']:.1f}); "
                    f"{eng.cut_bytes} cut bytes copied a sweep; launches "
                    f"{r['launches']} (counted on the card)")
                del r, eng
            out[name] = dict(cost_cells=cells, cost_probe_s=probe_s,
                             tasks=len(plan.tasks),
                             channels=len(plan.channels), runs=rows)
            del built
        top, args, _ = APPS["gemm"].build_step_async(device="cuda",
                                                      **FULL_ASYNC["gemm"])
        ports = [p.name for p in (*args[1], *args[2])]
        try:
            ENGINES["compiled"](device="cuda", mesh=card * 2,
                                cache=False).run(top, *args)
        except SynthesisError as e:
            msg = str(e)
        else:
            raise AssertionError("partitioned gemm async: not refused")
        P = FULL_ASYNC["gemm"]["P"]
        named = [f"AFetch{i}" for i in range(P)] + \
            [f"CStore{i}" for i in range(P)]
        if not ("does not cover async_mmap ports" in msg
                and all(f"'{t}'" in msg for t in named + ports)):
            raise AssertionError(f"partitioned gemm async: refused without "
                                 f"naming its ports and tasks: {msg}")
        out["async_refused"] = msg
        log(f"partitioned gemm async: refused under mesh=[cuda]*2: "
            f"{msg[:160]}...")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return out


def owner_mask_checks() -> list:
    """Phase 3's owner-mask cases of ``sweep_guards`` alone (``--only
    26``): the kernel against its plain version at gemm's full-size
    tables, exactly."""
    from repro_torch.apps import APPS
    from repro_torch.core.synth import elaborate_step_graph
    top, args, _ = APPS["gemm"].build_step(device="cuda", **FULL["gemm"])
    tab = _sweep_tables(elaborate_step_graph(top, *args)[0])
    c = check_sweep_guards("gemm", tab, "random+owned", 9)
    log(f"kernels: sweep_guards exact at gemm with an owner mask: "
        f"{SWEEP_STATES} carries ({c['fired']} firings) and 40 chained "
        f"launches")
    return [c]


# ---------------------------------------------------------------------------
# phases 29-30: the moe, hybrid, audio and vlm families trained at full
# width, and each family's float32 step against the CPU
# ---------------------------------------------------------------------------

# phase 29, (batch, seq, steps) at published widths, bf16, AdamW, remat,
# use_kernel; phi-3-vision cut 32 -> 16 layers as phase 19 serves it, its
# first 576 positions patches; whisper's decoder at its published context
# of 448 over 1500 frames; zamba2 through launch.train
FAMILY_TRAIN = {
    "granite-moe-1b-a400m": dict(batch=4, seq=1024, steps=3),
    "zamba2-1.2b": dict(batch=2, seq=2048, steps=3),
    "whisper-small": dict(batch=8, seq=448, steps=3),
    "phi-3-vision-4.2b": dict(batch=2, seq=2048, steps=3, layers=16),
}
# parameters from the leaves at those depths (the full-depth counts are
# pinned in tests/test_torch_moe_vlm.py and test_torch_recurrent_audio.py)
FAMILY_TRAIN_PARAMS = {"granite-moe-1b-a400m": 1_334_628_352,
                       "zamba2-1.2b": 1_170_473_856,
                       "whisper-small": 279_184_128,
                       "phi-3-vision-4.2b": 2_012_187_648}
# phase 30, (layers, batch, seq) at full width and float32: zamba2 at 6
# layers, so the shared block is applied once (after layer 5), over two
# chunks of 256; whisper with as many encoder layers over its 1500
# frames; phi-3's 576 patches and 448 text positions.  The CPU halves run
# in one child process started before phase 18, on two of the host's
# cores, so it is done before phase 29, whose steps' host side it would
# share the cores with, the MoE's first: the CPU's
# own expert choices are compared with the card's, and its gradients are
# taken under the card's choices (_PinnedRouter), which the child waits
# for.
FAMILY_TRAIN_CPU = {
    "granite-moe-1b-a400m": dict(layers=2, batch=2, seq=512),
    "zamba2-1.2b": dict(layers=6, batch=2, seq=512),
    "whisper-small": dict(layers=2, batch=2, seq=448),
    "phi-3-vision-4.2b": dict(layers=2, batch=2, seq=1024),
}
FAMILY_CPU_THREADS = 2      # the child's torch threads (8 host cores)
FAMILY_CPU_WAIT_S = 900     # the longest phase 30 waits for a CPU half
FAMILY_CHILD_WAIT_S = 3600  # the longest the child waits for the card's
                            # expert choices (phase 30 comes last)
# profiler ranges around the two torch-ops backwards in phase 29's
# profiled step (chip_smoke's own wrappers, _BackwardRanges)
BACKWARD_RANGES = {"flash": "chip_smoke.flash_backward",
                   "ssd": "chip_smoke.ssd_backward"}


def _family_train_cfg(arch: str):
    """``arch`` as phase 29 trains it: full width, FAMILY_TRAIN's depth
    where it names one."""
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    return dataclasses.replace(cfg, n_layers=FAMILY_TRAIN[arch].get(
        "layers", cfg.n_layers))


def _family_cpu_cfg(arch: str):
    """``arch`` as phase 30 compares it: full width, float32, cut to
    FAMILY_TRAIN_CPU's layers (whisper's encoder too)."""
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    n = FAMILY_TRAIN_CPU[arch]["layers"]
    kw = dict(n_layers=n, dtype="float32")
    if cfg.encdec is not None:
        kw["encdec"] = dataclasses.replace(cfg.encdec, n_encoder_layers=n)
    return dataclasses.replace(cfg, **kw)


def _train_launches(cfg, steps: int) -> dict:
    """The kernels' launches in ``steps`` train steps (remat on), from
    the forward's structure.  Remat runs each decoder layer's forward
    twice, once in the forward and once as the backward's recompute, and
    both backwards are torch ops (no launch):

    * moe, vlm, dense: flash once a layer, so 2 x layers a step;
    * hybrid: the SSD scan once a Mamba2 layer (2 x layers) and flash
      once a shared-block application, after each layer ``i`` with ``i %
      attn_period == attn_period - 1`` (zamba2-1.2b: 6 of 38, 2 x 6);
    * audio: flash once an encoder layer, which runs once outside remat,
      and twice a decoder layer (self- and cross-attention), each under
      remat: encoder layers + 2 x 2 x layers (whisper-small: 12 + 48).
    """
    L = cfg.n_layers
    if cfg.family in ("ssm", "hybrid"):
        p = cfg.hybrid.attn_period if cfg.hybrid is not None else 0
        shared = sum(1 for i in range(L) if p and i % p == p - 1)
        out = {"ssd_scan": 2 * L * steps}
        if shared:
            out["flash_attention"] = 2 * shared * steps
        return out
    if cfg.family == "audio":
        return {"flash_attention":
                (cfg.encdec.n_encoder_layers + 2 * 2 * L) * steps}
    return {"flash_attention": 2 * L * steps}


def _extra_inputs(cfg, B: int, rng, dev, dtype) -> dict:
    """The vlm's ``patches`` or the audio family's ``frames`` of a batch
    of ``B``, standard normal from the numpy generator ``rng``, in
    ``dtype`` on ``dev``; nothing for the other families."""
    if cfg.vlm is not None:
        shape, key = (B, cfg.vlm.n_patches, cfg.vlm.d_patch), "patches"
    elif cfg.encdec is not None:
        shape, key = (B, cfg.encdec.n_audio_ctx, cfg.d_model), "frames"
    else:
        return {}
    return {key: torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(dev, dtype)}


def _family_batch(cfg, B: int, S: int, seed: int, dev) -> dict:
    """A batch of ``make_pipeline(cfg.vocab, S, B, seed)``'s first draw on
    ``dev``, with the vlm's ``patches`` or the audio family's ``frames``
    drawn from ``numpy.random.default_rng(seed)`` in the model's dtype."""
    from repro_torch.data import make_pipeline
    from repro_torch.models.lm import torch_dtype
    batch = {k: torch.from_numpy(v).to(dev) for k, v in
             make_pipeline(cfg.vocab, S, B, seed=seed).next_batch().items()}
    return {**batch, **_extra_inputs(cfg, B, np.random.default_rng(seed),
                                     dev, torch_dtype(cfg))}


def _loss_grads(cfg, params: dict, batch: dict) -> tuple:
    """The training loss (remat, use_kernel) and its gradient tree."""
    from repro_torch.models import lm
    from repro_torch.tree import leaves, tree_map
    live = tree_map(lambda t: t.detach().requires_grad_(), params)
    loss = lm.loss_fn(live, cfg, batch, remat=True, use_kernel=True)
    grads = iter(torch.autograd.grad(loss, leaves(live)))
    return loss.detach(), tree_map(lambda _: next(grads), params)


class _PinnedRouter:
    """Gives the MoE router (``layers.moe_router``) of a run the expert
    choices ``topes[layer]`` of another: a layer is told by its router
    weight's storage, numbered in the order the forward first calls it,
    so both calls a layer makes under remat (the forward and the
    backward's recompute) get that layer's choices.  The probabilities,
    the top-k weights (the pinned experts' probabilities renormalised)
    and the load-balancing term are this run's own, from those choices.
    ``own`` collects this run's own choices a call."""

    def __init__(self, topes: list):
        from repro_torch.models import layers
        self.layers, self.router = layers, layers.moe_router
        self.topes, self.seen, self.own = topes, {}, []

        def router(p, cfg, x):
            probs, _, own, _ = self.router(p, cfg, x)
            i = self.seen.setdefault(p["router"].data_ptr(), len(self.seen))
            tope = self.topes[i].to(own.device)
            topw = probs.gather(-1, tope)
            topw = topw / topw.sum(dim=-1, keepdim=True)
            E = cfg.moe.n_experts
            ce = torch.nn.functional.one_hot(tope, E).float().sum(1).mean(0)
            aux = E * (probs.mean(dim=0) * ce).sum() * \
                cfg.moe.load_balance_coef
            self.own.append(own.cpu())
            return probs, topw, tope, aux
        layers.moe_router = router

    def restore(self) -> None:
        self.layers.moe_router = self.router


def _cpu_half(arch: str, step: bool = True, pinned: list | None = None
              ) -> dict:
    """Phase 30's CPU half of ``arch``: the loss, every gradient leaf and
    one AdamW step from ``lm.init_params(cfg, 1)`` on the CPU (plain
    versions), or, with ``step=False``, only the expert choices of a
    forward."""
    from repro_torch.models import lm
    from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
    from repro_torch.tree import named_leaves, tree_map
    cfg = _family_cpu_cfg(arch)
    c = FAMILY_TRAIN_CPU[arch]
    params = lm.init_params(cfg, 1, device="cpu")
    batch = _family_batch(cfg, c["batch"], c["seq"], 1, "cpu")
    if not step:
        routes = _RouteLog()
        try:
            with torch.no_grad():
                lm.loss_fn(params, cfg, batch, use_kernel=True)
        finally:
            routes.restore()
        return dict(routes=routes.take())
    pin = _PinnedRouter(pinned) if pinned is not None else None
    try:
        loss, grads = _loss_grads(cfg, params, batch)
    finally:
        if pin is not None:
            pin.restore()
    opt = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10, eps=1e-5)
    new_p, _, _ = adamw_update(grads, adamw_init(params, opt), params, opt)
    return dict(loss=float(loss), grads=dict(named_leaves(grads)),
                step=dict(named_leaves(tree_map(lambda a, b: a - b, new_p,
                                                params))),
                own_routes=None if pin is None else pin.own)


def _save_atomic(obj, path: Path) -> None:
    tmp = path.with_suffix(".part")
    torch.save(obj, tmp)
    tmp.rename(path)


def _wait_file(path: Path, proc=None, timeout: float = FAMILY_CPU_WAIT_S):
    """Wait for ``path`` to appear (written whole by ``_save_atomic``);
    raise if ``proc`` exits first or the wait times out."""
    t0 = time.perf_counter()
    while not path.exists():
        if proc is not None and proc.poll() is not None and \
                not path.exists():
            err = proc.stderr.read() if proc.stderr else ""
            raise AssertionError(f"the CPU child exited {proc.returncode} "
                                 f"before writing {path.name}:\n"
                                 f"{err[-3000:]}")
        if time.perf_counter() - t0 > timeout:
            raise AssertionError(f"{path.name}: not written in {timeout} s")
        time.sleep(0.2)


def family_cpu_child(out_dir: str, parts: str = "train,serve") -> None:
    """The child process of phases 30 and 32 (``FAMILY_CPU_CHILD``), which
    computes the CPU halves named in ``parts``: for phase 30 (``train``)
    the MoE's own expert choices, then the CPU halves of the families
    that need nothing from the card; for phase 32 (``serve``) each dense
    model's prefill and decode logits (``<arch>.serve_cpu.pt``); then,
    for phase 30, the MoE's under the card's choices (written by phase 30
    as ``<arch>.card_routes.pt``); each phase 30 result written to
    ``<arch>.cpu.pt`` in ``out_dir``."""
    torch.set_num_threads(FAMILY_CPU_THREADS)
    out, parts = Path(out_dir), parts.split(",")
    moe = [a for a in FAMILY_TRAIN_CPU
           if _family_cpu_cfg(a).moe is not None] if "train" in parts \
        else []
    for arch in moe:
        _save_atomic(_cpu_half(arch, step=False),
                     out / f"{arch}.cpu_routes.pt")
    for arch in FAMILY_TRAIN_CPU if "train" in parts else ():
        if arch not in moe:
            _save_atomic(_cpu_half(arch), out / f"{arch}.cpu.pt")
    for arch in DENSE_ARCHS if "serve" in parts else ():
        _save_atomic(cpu_serving_half(arch), out / f"{arch}.serve_cpu.pt")
    for arch in moe:
        path = out / f"{arch}.card_routes.pt"
        _wait_file(path, timeout=FAMILY_CHILD_WAIT_S)
        _save_atomic(_cpu_half(arch, pinned=torch.load(path)),
                     out / f"{arch}.cpu.pt")


FAMILY_CPU_CHILD = """
import sys
import chip_smoke
chip_smoke.family_cpu_child(*sys.argv[1:])
"""
_family_cpu: dict = {}


def _stop_family_cpu() -> None:
    import shutil
    proc = _family_cpu.get("proc")
    if proc is not None and proc.poll() is None:
        proc.kill()
        proc.communicate()
    if "dir" in _family_cpu:
        shutil.rmtree(_family_cpu["dir"], ignore_errors=True)


def start_family_cpu(parts: tuple = ("train", "serve")) -> None:
    """Start the CPU child of phases 30 and 32 (once), off the card, for
    the halves ``parts`` names (``family_cpu_child``); a child still
    running when the script exits is stopped and its files removed."""
    import tempfile
    if "proc" not in _family_cpu:
        atexit.register(_stop_family_cpu)
        _family_cpu["dir"] = Path(tempfile.mkdtemp(prefix="train_cpu_"))
        env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
                   PYTHONPATH=os.pathsep.join([str(ROOT),
                                               str(ROOT / "src")]))
        _family_cpu["proc"] = subprocess.Popen(
            [sys.executable, "-c", FAMILY_CPU_CHILD,
             str(_family_cpu["dir"]), ",".join(parts)],
            stdout=subprocess.DEVNULL,
            stderr=subprocess.PIPE, text=True, env=env)


class _BackwardRanges:
    """Wraps the two torch-ops backwards, ``ops.flash_backward`` and
    ``ops._SSD.backward``, in a profiler range each
    (``BACKWARD_RANGES``), inside a ``with`` block."""

    def __enter__(self):
        from torch.profiler import record_function
        from repro_torch.kernels import ops
        self.ops = ops
        self.flash, self.ssd = ops.flash_backward, ops._SSD.__dict__[
            "backward"]
        flash, ssd = self.flash, self.ssd.__func__

        def flash_backward(*a, **kw):
            with record_function(BACKWARD_RANGES["flash"]):
                return flash(*a, **kw)

        def ssd_backward(ctx, *a):
            with record_function(BACKWARD_RANGES["ssd"]):
                return ssd(ctx, *a)
        ops.flash_backward = flash_backward
        ops._SSD.backward = staticmethod(ssd_backward)
        return self

    def __exit__(self, *exc):
        self.ops.flash_backward = self.flash
        self.ops._SSD.backward = self.ssd


def _train_profile_times(prof) -> dict:
    """A profile with host and device activity of one train step: the
    device's busy us (every device record but the ranges' own spans), each
    kernel's (launches, us) by the names ``ATTN_KERNELS`` and
    ``SSD_KERNELS`` give (a launch is one of the first name), and the
    device us under each of ``BACKWARD_RANGES`` (the kernels of the torch
    ops launched inside it)."""
    from torch.autograd import DeviceType
    names = {**ATTN_KERNELS, "ssd_scan": SSD_KERNELS}
    ranges = {v: 0.0 for v in BACKWARD_RANGES.values()}
    busy, kern = 0.0, {}
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            # a range's (and the profiler schedule's step's) span on the
            # device timeline is no device work of its own
            if getattr(ev, "is_user_annotation", False) or \
                    ev.name in ranges or ev.name.startswith("ProfilerStep"):
                continue
            us = float(ev.time_range.elapsed_us())
            busy += us
            for op, ks in names.items():
                for i, nm in enumerate(ks):
                    if nm in ev.name:
                        n, t = kern.get(op, (0, 0.0))
                        kern[op] = (n + (i == 0), t + us)
        elif ev.name in ranges:
            ranges[ev.name] += float(ev.device_time_total)
    return dict(busy_us=busy, kern=kern, ranges=ranges)


def _train_cli_run(arch: str, cfg, B: int, S: int, steps: int) -> dict:
    """zamba2's counted run: ``launch.train --use-kernel`` into a
    checkpoint directory with a metrics file, then the same command
    again, which must restore the checkpoint and run no step (it says so
    on its standard output, and the metrics file keeps its rows)."""
    import contextlib
    import io
    import tempfile
    from repro_torch.kernels.dispatch import launch_counts, reset_launches
    from repro_torch.launch.train import train
    with tempfile.TemporaryDirectory() as tmp:
        ck, mpath = str(Path(tmp) / "ckpt"), Path(tmp) / "metrics.jsonl"
        args = ["--arch", arch, "--use-kernel", "--batch", str(B), "--seq",
                str(S), "--steps", str(steps), "--ckpt-dir", ck,
                "--metrics", str(mpath), "--log-every", "1"]
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rc = train(args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launch_counts()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        rows = [json.loads(x) for x in mpath.read_text().splitlines()]
        if rc != 0 or len(rows) != steps:
            raise AssertionError(f"train {arch}: rc {rc}, {len(rows)} metric "
                                 f"rows (expected 0 and {steps})")
        reset_launches()
        out = io.StringIO()
        t1 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc2 = train(args)
        rerun_s = time.perf_counter() - t1
        log(out.getvalue().rstrip())
        again = launch_counts()
        n_rows = len(mpath.read_text().splitlines())
        if rc2 != 0 or again or n_rows != steps or \
                f"resumed from checkpoint step {steps}" not in out.getvalue():
            raise AssertionError(f"train {arch}: rerun rc {rc2}, launches "
                                 f"{again}, {n_rows} metric rows (expected "
                                 f"a restore of step {steps} and 0 steps)")
    return dict(counts=counts, peak_gb=peak_gb,
                losses=[r["loss"] for r in rows],
                grad_norms=[r["grad_norm"] for r in rows],
                dts=[r["dt"] for r in rows], wall_s=wall,
                entry="launch.train --use-kernel", restored_step=steps,
                rerun_rc=rc2, rerun_s=rerun_s, rerun_steps=0)


def _train_steps_run(arch: str, cfg, B: int, S: int, steps: int) -> dict:
    """The counted run of ``make_train_step`` (bf16, AdamW, remat,
    use_kernel), batches of ``make_pipeline(cfg.vocab, S, B, seed=0)`` with
    the vlm's patches or the audio family's frames from
    ``default_rng(0)``; for the MoE first its first step's gradients twice
    from the same state, which must be bitwise equal."""
    from repro_torch.data import make_pipeline
    from repro_torch.kernels.dispatch import launch_counts, reset_launches
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import lm
    from repro_torch.optim import AdamWConfig, adamw_init
    params = lm.init_params(cfg, 0)
    opt = AdamWConfig(total_steps=steps, warmup_steps=1)
    state = adamw_init(params, opt)
    step_fn = make_train_step(cfg, opt, use_kernel=True)
    data = make_pipeline(cfg.vocab, S, B, seed=0)
    rng = np.random.default_rng(0)

    batches = [{**{k: torch.from_numpy(v).to(DEV)
                   for k, v in data.next_batch().items()},
                **_extra_inputs(cfg, B, rng, DEV, torch.bfloat16)}
               for _ in range(steps + 1)]
    out = {}
    if cfg.moe is not None:
        # the dispatch's backward scatters into each kept slot from one
        # token copy only (a dropped copy adds an exact zero), so the
        # gradients of one state and batch are the same bits every time
        g = [_loss_grads(cfg, params, batches[0])[1] for _ in range(2)]
        from repro_torch.tree import named_leaves
        a, b = dict(named_leaves(g[0])), dict(named_leaves(g[1]))
        diff = [n for n in a if not torch.equal(a[n], b[n])]
        if diff:
            raise AssertionError(f"train {arch}: the first step's gradients "
                                 f"differ between two runs in {diff}")
        out["repeat_bitwise"] = dict(leaves=len(a), differing=0)
        del g, a, b
        torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    losses, gnorms, dts = [], [], []
    for b in batches[:steps]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, m = step_fn(params, state, b)
        torch.cuda.synchronize()
        dts.append(time.perf_counter() - t0)
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
    return dict(out, params=params, state=state, step_fn=step_fn,
                counts=launch_counts(),
                peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                losses=losses, grad_norms=gnorms, dts=dts,
                entry="make_train_step", next_batch=batches[steps])


def family_train_phase(arch: str) -> dict:
    """Phase 29 for one family: ``FAMILY_TRAIN[arch]`` steps at full width
    (bf16, random weights from seed 0, AdamW, remat, ``use_kernel``)
    through the entry the reference trains it with; the gates: finite
    losses, grad norms and parameters, the parameter count from the
    leaves, the kernels' launches exactly ``_train_launches``; then one
    more step under the profiler (host and device activity), outside the
    counted run, whose every flash launch must be ``flash_wgmma_kernel``
    and whose SSD launches must equal the counter: its device-busy ms, the
    kernels' device ms and the device ms of the two torch-ops backwards
    (``BACKWARD_RANGES``), each as a share of the step."""
    from torch.profiler import ProfilerActivity
    from repro_torch.kernels.dispatch import launch_counts, reset_launches
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import lm
    from repro_torch.optim import AdamWConfig, adamw_init
    cfg = _family_train_cfg(arch)
    c = FAMILY_TRAIN[arch]
    B, S, steps = c["batch"], c["seq"], c["steps"]
    if cfg.family == "hybrid":
        # the profiled step starts from new weights (the rerun above
        # restored the trained ones and checked them)
        run = _train_cli_run(arch, cfg, B, S, steps)
        opt = AdamWConfig(total_steps=steps, warmup_steps=1)
        run["params"] = lm.init_params(cfg, 0)
        run["state"] = adamw_init(run["params"], opt)
        run["step_fn"] = make_train_step(cfg, opt, use_kernel=True)
        run["next_batch"] = _family_batch(cfg, B, S, 1, DEV)
    else:
        run = _train_steps_run(arch, cfg, B, S, steps)
    params, state = run.pop("params"), run.pop("state")
    step_fn, nb = run.pop("step_fn"), run.pop("next_batch")
    counts, want = run["counts"], _train_launches(cfg, steps)
    n_params = sum(t.numel() for t in _leaves(params))
    if counts != want:
        raise AssertionError(f"train {arch}: launches {counts}, expected "
                             f"{want} (_train_launches)")
    if n_params != FAMILY_TRAIN_PARAMS[arch]:
        raise AssertionError(f"train {arch}: {n_params} parameters, expected "
                             f"{FAMILY_TRAIN_PARAMS[arch]}")
    if not (np.isfinite(run["losses"]).all()
            and np.isfinite(run["grad_norms"]).all()
            and _finite_tree(params) and _finite_tree(state)):
        raise AssertionError(f"train {arch}: losses {run['losses']}, grad "
                             f"norms {run['grad_norms']}, or a parameter, "
                             f"not finite")
    where = f"train {arch}"

    def profiled():
        nonlocal params, state
        reset_launches()
        t0 = time.perf_counter()
        with _BackwardRanges():
            params, state, _ = step_fn(params, state, nb)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    def check(prof, _):
        t = _train_profile_times(prof)
        got = launch_counts()
        _check_flash_route(t["kern"], got.get("flash_attention", 0), where)
        n_ssd = t["kern"].get("ssd_scan", (0, 0.0))[0]
        if n_ssd != got.get("ssd_scan", 0):
            raise AssertionError(f"{where}: {got.get('ssd_scan', 0)} SSD "
                                 f"launches, the profiler saw {n_ssd} "
                                 f"{SSD_KERNELS[0]}")
        return t

    # a warm-up step first: the profiler lost one record in each first
    # profile of a process late in the script (calls 2-3)
    _, prof_s, t = _profiled(profiled, check, where,
                             [ProfilerActivity.CPU, ProfilerActivity.CUDA],
                             warm_first=True)
    del params, state, step_fn, nb
    torch.cuda.empty_cache()
    dts = run.pop("dts")
    step_ms = float(np.median(dts[1:])) * 1e3
    kern_ms = {k: t["kern"][k][1] / 1e3 for k in ("flash_attention",
                                                   "ssd_scan")
               if k in t["kern"]}
    bwd_ms = {k: t["ranges"][v] / 1e3 for k, v in BACKWARD_RANGES.items()}
    out = dict(arch=arch, layers=cfg.n_layers, params=n_params,
               dtype=cfg.dtype, batch=B, seq=S, steps=steps, **run,
               expected_launches=want, launches=counts,
               step_ms=[d * 1e3 for d in dts], median_step_ms=step_ms,
               tok_per_s=B * S / (step_ms / 1e3),
               profiled_step=dict(
                   wall_ms=prof_s * 1e3, device_busy_ms=t["busy_us"] / 1e3,
                   kernel_device_ms=kern_ms,
                   kernel_launches={k: v[0] for k, v in t["kern"].items()},
                   kernel_share_of_step={k: v / step_ms
                                         for k, v in kern_ms.items()},
                   backward_device_ms=bwd_ms,
                   backward_share_of_step={k: v / step_ms
                                           for k, v in bwd_ms.items()}))
    log(f"train {arch} ({run['entry']}): {cfg.n_layers} layers, {n_params} "
        f"params bf16, batch {B} x seq {S}, {steps} steps: "
        + ", ".join(f"{d * 1e3:.0f}" for d in dts) + f" ms (median after "
        f"step 1 {step_ms:.1f} ms, {out['tok_per_s']:,.0f} tokens/s); "
        f"losses " + ", ".join(f"{v:.4f}" for v in run["losses"])
        + "; grad norms " + ", ".join(f"{v:.3f}" for v in run["grad_norms"])
        + f"; launches {counts}; peak {run['peak_gb']:.2f} GB"
        + (f"; first step's gradients bitwise equal twice "
           f"({run['repeat_bitwise']['leaves']} leaves)"
           if "repeat_bitwise" in run else "")
        + (f"; checkpoint {run['restored_step']} restored, rerun ran 0 "
           f"steps" if "rerun_rc" in run else "")
        + f"; a profiled step {prof_s * 1e3:.1f} ms, device busy "
        f"{t['busy_us'] / 1e3:.1f} ms; kernels "
        + ", ".join(f"{k} {v:.2f} ms ({v / step_ms:.1%})"
                    for k, v in kern_ms.items())
        + "; torch-ops backwards "
        + ", ".join(f"{k} {v:.2f} ms ({v / step_ms:.1%})"
                    for k, v in bwd_ms.items()))
    return out


def family_train_vs_cpu(arch: str, defer: bool = False):
    """Phase 30 for one family: ``FAMILY_TRAIN_CPU[arch]`` at full width
    and float32, the same weights (``init_params(cfg, 1)`` on the CPU)
    and batch on the card (kernels) and the CPU (plain versions, in the
    child process): the loss, every gradient leaf and one AdamW step
    within ``TRAIN_CPU_TOL``.  An MoE's expert choices are compared first
    (``_route_diffs``: a decisive difference fails, a float-class one is
    reported with its gap), the card's recompute under remat must choose
    as its forward did, and the CPU's gradients are taken under the
    card's choices.  With ``defer`` the card's half runs now and the
    comparison is returned as a function, to be called later (the MoE's:
    its CPU half starts from the card's expert choices, and the other
    families' card halves run meanwhile)."""
    from repro_torch.kernels.dispatch import launch_counts, reset_launches
    from repro_torch.models import lm
    from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
    from repro_torch.tree import named_leaves, tree_map
    start_family_cpu()
    out_dir, proc = _family_cpu["dir"], _family_cpu["proc"]
    cfg = _family_cpu_cfg(arch)
    c = FAMILY_TRAIN_CPU[arch]
    p = tree_map(lambda t: t.to(DEV), lm.init_params(cfg, 1, device="cpu"))
    batch = _family_batch(cfg, c["batch"], c["seq"], 1, DEV)
    routes = _RouteLog() if cfg.moe is not None else None
    reset_launches()
    try:
        loss, grads = _loss_grads(cfg, p, batch)
    finally:
        if routes is not None:
            routes.restore()
    counts = launch_counts()
    want = _train_launches(cfg, 1)
    if counts != want:
        raise AssertionError(f"train card vs cpu {arch}: launches {counts}, "
                             f"expected {want}")
    flips = []
    if routes is not None:
        calls, L = routes.take(), cfg.n_layers
        if len(calls) != 2 * L or any(
                not torch.equal(calls[i][2], calls[2 * L - 1 - i][2])
                for i in range(L)):
            raise AssertionError(f"train card vs cpu {arch}: {len(calls)} "
                                 f"router calls, or the backward's "
                                 f"recompute chose other experts than the "
                                 f"forward")
        _save_atomic([tope for _, _, tope in calls[:L]],
                     out_dir / f"{arch}.card_routes.pt")
        path = out_dir / f"{arch}.cpu_routes.pt"
        _wait_file(path, proc)
        flips = _route_diffs(cfg, torch.load(path)["routes"] + calls[:L],
                             c["batch"], set(), f"train {arch}")
    opt = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10, eps=1e-5)
    new_p, _, _ = adamw_update(grads, adamw_init(p, opt), p, opt)
    step = dict(named_leaves(tree_map(lambda a, b: a - b, new_p, p)))
    grads = dict(named_leaves(grads))
    del new_p, p

    def finish() -> dict:
        path = out_dir / f"{arch}.cpu.pt"
        t0 = time.perf_counter()
        _wait_file(path, proc)
        waited = time.perf_counter() - t0
        cpu = torch.load(path, mmap=True)

        def worst(got: dict, want: dict) -> dict:
            if sorted(got) != sorted(want):
                raise AssertionError(f"train card vs cpu {arch}: leaves "
                                     f"differ")
            rel = {}
            for name, w in want.items():
                w = w.to(DEV, torch.float64)
                rel[name] = float((got[name].double() - w).abs().max()) / \
                    max(float(w.abs().max()), 1e-30)
            return rel
        grad_rel = worst(grads, cpu["grads"])
        step_rel = worst(step, cpu["step"])
        loss_rel = abs(float(loss) - cpu["loss"]) / abs(cpu["loss"])
        pinned_flips = 0
        if routes is not None:
            # the forward's calls (the first of each layer's two)
            pinned_flips = sum(int((o != t).any(-1).sum()) for o, t in zip(
                cpu["own_routes"], torch.load(out_dir /
                                              f"{arch}.card_routes.pt")))
        del cpu
        path.unlink()
        g_name = max(grad_rel, key=grad_rel.get)
        s_name = max(step_rel, key=step_rel.get)
        tol = TRAIN_CPU_TOL
        log(f"train card vs cpu: {arch} at {cfg.n_layers} layers, float32, B="
            f"{c['batch']} S={c['seq']}: loss {float(loss):.6f}, rel "
            f"{loss_rel:.2e} (limit {tol['loss']:g}); gradients worst "
            f"{grad_rel[g_name]:.2e} ({g_name}; limit {tol['grad']:g}); AdamW "
            f"step worst {step_rel[s_name]:.2e} ({s_name}; limit "
            f"{tol['step']:g}); launches {counts}"
            + (f"; float-class routing differences {len(flips)}"
               + "".join(f" (layer {f['layer']} token {f['token']} gap "
                         f"{f['gap']:.2e})" for f in flips if "gap" in f)
               + f"; tokens whose CPU choice the card's replaced under remat: "
               f"{pinned_flips}" if routes is not None else "")
            + f"; waited {waited:.1f} s for the CPU half")
        if not (loss_rel <= tol["loss"] and grad_rel[g_name] <= tol["grad"]
                and step_rel[s_name] <= tol["step"]):
            raise AssertionError(f"train card vs cpu {arch}: past a limit")
        return dict(arch=arch, layers=cfg.n_layers, batch=c["batch"],
                    seq=c["seq"], loss=float(loss), loss_rel=loss_rel,
                    grad_rel=grad_rel, step_rel=step_rel, launches=counts,
                    route_flips=flips, pinned_replacements=pinned_flips,
                    waited_s=waited)

    return finish if defer else finish()


def family_train_vs_cpu_all(phase) -> dict:
    """Phase 30 over ``FAMILY_TRAIN_CPU``, through ``phase``: the MoE's
    card half first (its expert choices start its CPU half in the child),
    then the other families, then the MoE's comparison, whose CPU half the
    child computed meanwhile."""
    moe = [a for a in FAMILY_TRAIN_CPU if _family_cpu_cfg(a).moe is not None]
    later = {arch: phase(f"30 train card vs cpu {arch}", family_train_vs_cpu,
                         arch, True) for arch in moe}
    out = {arch: phase(f"30 train card vs cpu {arch}", family_train_vs_cpu,
                       arch) for arch in FAMILY_TRAIN_CPU if arch not in moe}
    return {**out, **{arch: phase(f"30 train card vs cpu {arch} (compared)",
                                  finish) for arch, finish in later.items()}}


# ---------------------------------------------------------------------------
# phases 31-32: the dense models qwen3-4b, yi-6b and starcoder2-3b served
# at full width, and each at 2 float32 layers against the CPU
# ---------------------------------------------------------------------------

DENSE_ARCHS = ("qwen3-4b", "yi-6b", "starcoder2-3b")
DECODE_ALONE_STEPS = 8      # phase 31: decode steps profiled alone


def _long_prefill(params, cfg) -> dict:
    """Phase 31's long prompt (``LONG_SERVE``) alone, as the engine
    prefills it: padded to its bucket of ``max_seq`` positions with its
    true length given; its seconds (warm: the engine's warmup ran that
    bucket), flash once a layer, finite logits, and the window shown to
    bind: the same weights and tokens without a window give other
    logits."""
    from repro_torch.kernels.dispatch import launch_counts, reset_launches
    from repro_torch.models import lm
    long = LONG_SERVE[cfg.name]
    n, bucket = long["prompt"], long["max_seq"]
    gen = torch.Generator(device=DEV).manual_seed(6)
    toks = torch.zeros((1, bucket), dtype=torch.int32, device=DEV)
    toks[0, :n] = torch.randint(0, cfg.vocab, (n,), generator=gen,
                                device=DEV, dtype=torch.int32)
    true_len = torch.tensor([n], dtype=torch.int32, device=DEV)
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = lm.prefill(params, cfg, toks, max_seq=bucket,
                               true_len=true_len)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    del cache
    full, _ = lm.prefill(params, dataclasses.replace(cfg, sliding_window=None),
                         toks, max_seq=bucket, true_len=true_len)
    finite = bool(torch.isfinite(logits).all())
    moved = float((logits.float() - full.float()).abs().max())
    if not finite or moved == 0 or \
            counts.get("flash_attention", 0) != cfg.n_layers:
        raise AssertionError(f"{cfg.name} long prefill: finite {finite}, "
                             f"moved by the window {moved}, launches "
                             f"{counts} (expected {cfg.n_layers} flash)")
    log(f"serve {cfg.name}: prefill of {n} tokens (bucket {bucket}, window "
        f"{cfg.sliding_window}) in {wall:.3f} s, finite logits, max change "
        f"against no window {moved:.3g}; launches {counts}")
    return dict(prompt=n, bucket=bucket, wall_s=wall, launches=counts,
                max_change_without_window=moved)


def dense_serving(arch: str) -> dict:
    """Phase 31 for one dense model: ``serving_phase`` at ``SERVE`` (at
    ``SERVE_LAYERS``' depth; starcoder2-3b with its long request in a
    cache of ``LONG_SERVE``'s rows) with its gates, the decode step alone
    under the profiler (``_decode_loop``: the device's busy share), the
    long prompt alone (``_long_prefill``), then ``launch.serve --full
    --arch arch`` at full depth (``cli_phase``)."""
    from repro_torch.configs import get_config
    report, eng, reqs, stats, params = serving_phase(arch)
    cfg = _serve_cfg(arch)
    loop = report["decode_alone"] = _decode_loop(
        eng.batched, reqs[:SERVE["slots"]], steps=DECODE_ALONE_STEPS)
    if arch in LONG_SERVE:
        report["long_prefill"] = _long_prefill(params, cfg)
    del eng, reqs, stats, params
    torch.cuda.empty_cache()
    share = loop["busy_share"]
    log(f"serve {arch}: {cfg.n_layers} of {get_config(arch).n_layers} "
        f"layers, {report['tok_per_s']:.1f} tok/s, prefill "
        f"{report['prefill_s']:.3f} s, {report['decode_ms_per_step']:.2f} "
        f"ms a decode step while serving; the step alone "
        f"{loop['host_ms_per_step']:.2f} ms, device busy "
        + (f"{share:.1%}" if share is not None else "not measured")
        + f"; peak {report['peak_gb']:.2f} GB")
    report["cli"] = cli_phase(arch)
    # the command line's full-depth engine holds its weights in reference
    # cycles: freed here, not under the next phase
    gc.collect()
    torch.cuda.empty_cache()
    return report


_dense_params: dict = {}


def prefetch_dense_params() -> None:
    """Draw phase 32's float32 weights on the host (``init_params(cfg, 1)``
    on the CPU, as the child's CPU halves do), one model after another in
    a thread, beside phase 31: the card's copy comes from them."""
    from repro_torch.models import lm
    if _dense_params:
        return
    pool = ThreadPoolExecutor(1)
    for arch in DENSE_ARCHS:
        _dense_params[arch] = pool.submit(lm.init_params, _vs_cpu_cfg(arch),
                                          1, device="cpu")
    pool.shutdown(wait=False)


def dense_vs_cpu(arch: str) -> dict:
    """Phase 32 for one dense model: ``card_vs_cpu`` (2 float32 layers at
    full width; starcoder2-3b's window ``CPU_WINDOW``), the CPU half
    computed in the child process (``cpu_serving_half``) and read from
    its file, the weights those :func:`prefetch_dense_params` drew."""
    prefetch_dense_params()
    p_cpu = _dense_params.pop(arch).result()
    start_family_cpu()
    path = _family_cpu["dir"] / f"{arch}.serve_cpu.pt"
    t0 = time.perf_counter()
    _wait_file(path, _family_cpu["proc"])
    waited = time.perf_counter() - t0
    cpu = torch.load(path)["logits"]
    path.unlink()
    out = card_vs_cpu(arch, cpu, p_cpu)
    log(f"card vs cpu {arch}: waited {waited:.1f} s for the CPU half")
    return {**out, "waited_s": waited}


def run_only(phases: set, phase) -> int:
    """``--only 8,24,25``: the build, then only the named phases among
    4a (phase 4's async graphs against the CPU), 6 (without phase 3's
    kernel times), 7 (its checks), 17, 8, 24, 25, 26, 12, 27, 28, 29, 30,
    31 and 32 (26
    with phase 3's owner-mask checks of ``sweep_guards`` first; 30 and 32
    start their CPU child first, for their own halves; a development
    run: no kernels line, no result line);
    what they return goes to ``chiprun_out/chip_smoke_only.json``."""
    from repro_torch.core.compile_cache import shutdown_workers
    out = {}
    try:
        if "4a" in phases:
            out["async_vs_cpu"] = phase("4 async vs cpu", async_vs_cpu)
        if "6" in phases:       # without phase 3's kernel times
            out["breakdown"] = phase("6 breakdown", breakdown, {})
        if "7" in phases:
            out["attention_checks"] = phase("7 attention checks",
                                            check_attention)[0]
            out["decode_lse"] = phase("7 decode lse", check_decode_lse)
        if "17" in phases:
            out["codegen"] = phase("17 codegen", codegen_phase)
        if "8" in phases:
            out["serving"] = phase("8 serving", serving_phase)[0]
        if "24" in phases:
            out["compiled_serving"] = phase("24 serving compiled",
                                            compiled_serving_phase)
        if "25" in phases:
            out["compiled_vs_cpu"] = phase("25 compiled card vs cpu",
                                           compiled_vs_cpu)
        if "26" in phases:
            out["owner_mask"] = phase("26 owner mask", owner_mask_checks)
            out["partitioned"] = phase("26 partitioned", partitioned_phase)
        if "12" in phases:
            out["training"] = phase("12 train mamba2", train_phase)
        if "27" in phases:
            out["sharded_training"] = phase("27 sharded train",
                                            sharded_train_phase)
        if "28" in phases:
            out["mesh_modules"] = phase("28 mesh modules",
                                        mesh_modules_phase)
        if {"30", "32"} & phases:
            start_family_cpu(tuple(part for part, ph in (("train", "30"),
                                                         ("serve", "32"))
                                   if ph in phases))
        if "29" in phases:
            out["family_training"] = {
                arch: phase(f"29 train {arch}", family_train_phase, arch)
                for arch in FAMILY_TRAIN}
        if "30" in phases:
            out["family_train_card_vs_cpu"] = family_train_vs_cpu_all(phase)
        if "32" in phases:
            prefetch_dense_params()
        if "31" in phases:
            out["dense_serving"] = {
                arch: phase(f"31 serve {arch}", dense_serving, arch)
                for arch in DENSE_ARCHS}
        if "32" in phases:
            out["dense_card_vs_cpu"] = {
                arch: phase(f"32 card vs cpu {arch}", dense_vs_cpu, arch)
                for arch in DENSE_ARCHS}
    finally:
        shutdown_workers()
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke_only.json").write_text(json.dumps(
        out, indent=1, default=str))
    return 0


def kernel_resources() -> list:
    """Phase 2: each kernel's registers, shared memory and spills as
    ``ptxas -v`` reported them, and the dynamic shared memory a block asks
    for: a flash block's (``flash_attention_smem_bytes``), an SSD block's
    at the training shape's chunk and heads a block, a flash-decode
    partial block's; the last two must equal what the wrappers'
    ``launch_args`` compute on the host."""
    import re
    from repro_torch.kernels import _build
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.kernels.flash_attention import _SIGNATURES
    flash = _build.bind("flash_attention", _SIGNATURES)
    ssd_lib = _build.bind("ssd_scan", ssd._SIGNATURES)
    dec_lib = _build.bind("decode_attention", dec._SIGNATURES)
    _, B, S, H, G, _, _, Q, _, _ = SSD_CASES[0]
    nc = S // Q
    heads = {"ssd_state_mma": ssd.heads_per_block(H // G, H, nc * B,
                                                  ssd.MAX_STATE_HEADS),
             "ssd_scan_mma": ssd.heads_per_block(
                 H // G, H, nc * -(-Q // ssd.ROWS) * B)}
    dtypes = {"f": (0, torch.float32), "13__nv_bfloat16": (1, torch.bfloat16)}
    rows = []
    for name in SOURCES:
        for r in _build.resources(name):
            k = r["kernel"]
            dyn, host = None, None
            m = re.search(r"flash_(wgmma|fwd)_kernelIf?Li(\d+)E", k)
            if m:
                dyn = flash.flash_attention_smem_bytes(
                    int(m.group(1) == "wgmma"), int(m.group(2)))
            m = re.search(r"(ssd_state_mma|ssd_scan_mma)ILi(\d+)ELi(\d+)E", k)
            if m:
                P, N, hb = int(m.group(2)), int(m.group(3)), heads[m.group(1)]
                which = int(m.group(1) == "ssd_scan_mma")
                dyn = ssd_lib.ssd_scan_smem_bytes(which, P, N, Q, hb)
                host = ssd.smem_bytes(P, N, Q, hb)[which]
            m = re.search(r"decode_partial_kernelI(f|13__nv_bfloat16)Li(\d+)"
                          r"ELi(\d+)E", k)
            if m:
                code, dt = dtypes[m.group(1)]
                hd, grp = int(m.group(2)), int(m.group(3))
                dyn = dec_lib.decode_attention_smem_bytes(code, hd, grp)
                host = dec.smem_bytes(dt, hd, grp)
            if host is not None and host != dyn:
                raise AssertionError(f"{k}: the host computes {host} B of "
                                     f"dynamic shared memory, the kernel "
                                     f"asks {dyn}")
            rows.append(dict(source=name, **r, smem_dynamic=dyn))
            log(f"build: {k}: {r['registers']} registers, smem "
                f"{r['smem_static']} B static"
                + (f" + {dyn} B dynamic" if dyn is not None else "")
                + f", stack {r['stack']} B, spills {r['spill_stores']} B "
                f"stored / {r['spill_loads']} B loaded")
    return rows


def main() -> int:
    start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    missing = [src for src in SOURCES.values() if not (ROOT / src).is_file()]
    if missing:
        print(f"chip_smoke: {missing} not found next to this script; run it "
              f"from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    if sys.argv[1:] == ["--warm-serve"]:        # phase 24's warm half
        print(json.dumps(warm_serving()))
        return 0

    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"device: {smi}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}; matmul.allow_tf32="
        f"{torch.backends.cuda.matmul.allow_tf32} cudnn.allow_tf32="
        f"{torch.backends.cudnn.allow_tf32}")

    # 2. build: one nvcc per source, all started together
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(SOURCES)) as pool:
        list(pool.map(_build.build, SOURCES))
    for name in SOURCES:
        _build.load(name)
    log(f"build: {', '.join(SOURCES.values())} built and loaded in "
        f"{time.perf_counter() - t0:.1f} s")
    resources = kernel_resources()

    seconds = {}

    def phase(name: str, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t
        log(f"phase {name}: {seconds[name]:.1f} s")
        return out

    if len(sys.argv) > 2 and sys.argv[1] == "--only":
        return run_only(set(sys.argv[2].split(",")), phase)

    # 3-6: the synthesis path
    timing, errs, kernel_checks = phase("3 kernels", kernel_phase)
    per_app, counts = phase("4 main path", main_path)
    full = phase("4 full size vs cpu", full_size_vs_cpu)
    full_async = phase("4 async vs cpu", async_vs_cpu)
    twin = phase("5 twin vs compiled", twin_vs_compiled)
    dev_ms = {k: timing[k][0]["device_ms"] for k in REPLACES}
    brk = phase("6 breakdown", breakdown, dev_ms)

    # 7-10: the LM serving path
    attn_checks, attn_errs = phase("7 attention checks", check_attention)
    decode_lse = phase("7 decode lse", check_decode_lse)
    attn_timing = phase("7 attention times", time_attention)
    serving, eng, reqs, stats, params = phase("8 serving", serving_phase)
    serve_brk = phase("10 serving breakdown", serving_breakdown, eng, reqs,
                      stats)
    del eng, reqs, stats, params
    torch.cuda.empty_cache()
    cli = phase("8 serve cli", cli_phase)
    vs_cpu = phase("9 card vs cpu", card_vs_cpu)

    # 11-15: the training path (phase 17's compile processes start up
    # beside it, and beside 16)
    start_codegen_workers()
    ssd_checks, ssd_err = phase("11 ssd checks", check_ssd)
    ssd_time = phase("11 ssd times", time_ssd)
    training = phase("12 train mamba2", train_phase)
    qwen = phase("13 train qwen3", qwen_train_phase)
    train_cpu = phase("14 train card vs cpu", train_vs_cpu)
    train_brk = phase("15 train breakdown", train_breakdown)

    # 16: crash recovery on the synthesis path
    recovery = phase("16 recovery", recovery_phase)

    # 17: hierarchical code generation
    codegen = phase("17 codegen", codegen_phase)

    # 18-20: the moe and vlm families at full width, and at 2 float32
    # layers against the CPU
    start_family_cpu()                  # phase 30's CPU halves, on the host
    families = {arch: phase(f"{18 + i} serve {arch}", family_serving, arch)
                for i, arch in enumerate(FAMILY_ARCHS)}
    families_cpu = {arch: phase(f"20 card vs cpu {arch}", card_vs_cpu, arch)
                    for arch in FAMILY_ARCHS}

    # 21-23: the recurrent families served per slot and whisper's prefill
    # and decode at full width, and all three against the CPU
    recurrent = {arch: phase(f"21 serve {arch}", family_serving, arch)
                 for arch in RECURRENT_ARCHS}
    whisper = phase("22 whisper", whisper_phase)
    recurrent_cpu = {arch: phase(f"23 card vs cpu {arch}", family_vs_cpu,
                                 arch)
                     for arch in (*RECURRENT_ARCHS, AUDIO_ARCH)}
    # 24-25: the serving engine's compiled steps through the compile cache
    start_dryrun()                      # phase 27 (c), on the host
    compiled = phase("24 serving compiled", compiled_serving_phase)
    compiled_cpu = phase("25 compiled card vs cpu", compiled_vs_cpu)
    from repro_torch.core.compile_cache import shutdown_workers
    shutdown_workers()
    # 26: partitioned synthesis, partitions sharing the card
    partitioned = phase("26 partitioned", partitioned_phase)
    # 27: sharded training through a mesh, and the dry run of a cell
    sharded = phase("27 sharded train", sharded_train_phase)
    # 28: the mesh modules (compressed mean, pipeline) on one rank
    mesh_modules = phase("28 mesh modules", mesh_modules_phase)
    # 29-30: the moe, hybrid, audio and vlm families trained at full
    # width, and each family's float32 step against the CPU
    fam_train = {arch: phase(f"29 train {arch}", family_train_phase, arch)
                 for arch in FAMILY_TRAIN}
    fam_train_cpu = family_train_vs_cpu_all(phase)
    # 31-32: the dense models qwen3-4b, yi-6b and starcoder2-3b served at
    # full width, and at 2 float32 layers against the CPU (the CPU halves
    # from the child started before phase 18; the card's copy of the
    # weights drawn on the host beside phase 31)
    prefetch_dense_params()
    dense = {arch: phase(f"31 serve {arch}", dense_serving, arch)
             for arch in DENSE_ARCHS}
    dense_cpu = {arch: phase(f"32 card vs cpu {arch}", dense_vs_cpu, arch)
                 for arch in DENSE_ARCHS}
    part_launches = {k: sum(r["launches"][k] for app in PARTITIONED
                            for t, r in partitioned[app]["runs"].items()
                            if t.startswith("mesh")) for k in REPLACES}
    compiled_dev_us = {
        "flash_attention": compiled["step_alone"]["prefill_1024"][
            "flash_per_launch_us"],
        "decode_attention": compiled["step_alone"][
            "decode_partial_per_launch_us"]}

    by_model = {**{arch: r["launches"] for arch, r in families.items()},
                **{arch: r["launches"] for arch, r in recurrent.items()},
                AUDIO_ARCH: whisper["decode"]["launches"],
                **{arch: r["launches"] for arch, r in dense.items()}}

    kernels = []
    for name in REPLACES:
        rows = timing[name]
        head = rows[0]
        kernels.append(dict(
            name=name, route="cuda", source=SOURCE, replaces=REPLACES[name],
            launches=counts.get(name, 0), max_abs_err=errs[name],
            ms=head["ms"], plain_ms=head["plain_ms"],
            bound_ms=head["bound_ms"],
            bound_by=head["bound_by"], library_ms=head["library_ms"],
            device_ms=head["device_ms"], shape=head["shape"], by_shape=rows,
            launches_partitioned=part_launches[name]))
    for name, rows in attn_timing.items():
        head = rows[0]
        kernels.append(dict(
            name=name, route="cuda", source=SOURCES[name],
            replaces=ATTN_REPLACES[name],
            launches=serving["launches"].get(name, 0),
            max_abs_err=attn_errs[name], ms=head["ms"],
            plain_ms=head["plain_ms"], bound_ms=head["bound_ms"],
            bound_by=head["bound_by"], library_ms=head["library_ms"],
            device_ms=serve_brk["kernel_device_ms"].get(name),
            shape=head["shape"], by_shape=rows,
            train_launches=qwen["launches"].get(name, 0),
            sharded_train_launches=sharded["launches"].get(name, 0),
            train_launches_by_model={
                arch: r["launches"].get(name, 0)
                for arch, r in fam_train.items()
                if name in r["launches"]} or None,
            pipeline_launches=mesh_modules["pipeline"]["launches"][
                "pipeline"].get(name, 0),
            launches_by_model={arch: c.get(name, 0)
                               for arch, c in by_model.items()},
            launches_compiled=compiled["launches"].get(name, 0),
            device_us_compiled=compiled_dev_us[name],
            max_abs_err_by_hd={k: v for k, v in attn_errs.items()
                               if k.startswith(f"{name} hd")}))
    kernels.append(dict(
        name="ssd_scan", route="cuda", source=SOURCES["ssd_scan"],
        replaces=SSD_REPLACES, launches=training["launches"]["ssd_scan"],
        max_abs_err=ssd_err, ms=ssd_time["ms"],
        plain_ms=ssd_time["plain_ms"], bound_ms=ssd_time["bound_ms"],
        bound_by=ssd_time["bound_by"], library_ms=None,
        device_ms=ssd_time["device_ms"], shape=ssd_time["shape"],
        timing=ssd_time,
        launches_by_model={arch: r["launches"]["ssd_scan"]
                           for arch, r in recurrent.items()},
        train_launches_by_model={arch: r["launches"]["ssd_scan"]
                                 for arch, r in fam_train.items()
                                 if "ssd_scan" in r["launches"]},
        launches_compiled=compiled_cpu["mamba2"]["launches"]["ssd_scan"],
        device_us_compiled=compiled_cpu["mamba2"]["ssd_device_us"]))
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(dict(
        device=smi, torch=torch.__version__, cuda=torch.version.cuda,
        kernels=kernels, kernel_checks=kernel_checks,
        eval_guards=dict(replaces=REPLACES["sweep_guards"],
                         max_abs_err=errs["eval_guards"],
                         timing=timing["eval_guards"]),
        main_path=per_app, full_size_vs_cpu=full,
        async_vs_cpu=full_async,
        twin_vs_compiled=twin, breakdown=brk, attention_checks=attn_checks,
        serving=serving, serving_breakdown=serve_brk, serve_cli=cli,
        card_vs_cpu=vs_cpu, ssd_checks=ssd_checks, training=training,
        qwen_training=qwen, train_card_vs_cpu=train_cpu,
        train_breakdown=train_brk, recovery=recovery, codegen=codegen,
        family_serving=families, family_card_vs_cpu=families_cpu,
        recurrent_serving=recurrent, whisper=whisper,
        recurrent_audio_card_vs_cpu=recurrent_cpu,
        compiled_serving=compiled, compiled_card_vs_cpu=compiled_cpu,
        partitioned=partitioned, sharded_training=sharded,
        decode_lse=decode_lse, mesh_modules=mesh_modules,
        kernel_resources=resources, family_training=fam_train,
        family_train_card_vs_cpu=fam_train_cpu, dense_serving=dense,
        dense_card_vs_cpu=dense_cpu, phase_seconds=seconds), indent=1))
    log(f"phases: {sum(seconds.values()):.1f} s of {len(seconds)} phases, "
        f"{time.perf_counter() - start:.1f} s since the script started")
    print(smi)
    line = json.dumps({"kernels": kernels})
    print(f"kernels {line}")
    print(line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
