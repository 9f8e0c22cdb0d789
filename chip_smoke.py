#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --plant-faults

Run from the root of a checkout on a machine with a CUDA device. Phases, in
order; any failure raises and the script exits nonzero:

1. Environment: the card's name and power limit (``nvidia-smi``), then the
   kernels built from ``src/repro_torch/csrc`` (one ``nvcc`` per source, in
   parallel) with the build time, and per source the number of compiled
   kernels, their registers and spill stores (``ptxas -v``).
2. Kernels against their plain versions on the card, tolerance 0
   (``torch.equal``). The VTA GEMM (gather, product and add into acc in one
   launch) on every GEMM entry the main path launches, at the batch it
   launches it (both trunks at 2 and 8, resnet18-small and mobilenet-small
   at 4: ``SERVE_RUNS``), with random int8
   scratchpads and an acc within 2^24 of +-2^31 so that the add wraps, the
   whole acc compared; besides, at N = 3, an entry with prime g and R, one
   with K = 4608, the int8 extremes, per-image weights (Nw = N), the
   per-group fc form (w_d = g), duplicate acc targets (the atomic path),
   and the entries of ResNet-18's C8 3x3 conv lowered at block 32 and 64
   and at batch 2 (``gemm_cases``). Its row times one trunk forward's 609
   entries as one CUDA graph, against the fused function's bound
   (``gemm_bound_s``) and ``torch._int_mm`` on pre-gathered operands (the
   product only). The ALU stage-program kernel on every chain and sweep the
   main path launches (MobileNet's: its 13 depthwise layers' MAC sweeps,
   the fused ``mbn.dw11`` -> ``mbn.pw11`` segment and the global average
   pool; slab tensors drawn once per model and batch), and on the real
   chains and sweeps of a depthwise and
   two pool programs, forced scatter stores, a store with duplicate and
   masked lanes, and integer edge cases at N = 3 (``sweep_cases``), each at
   its planned tap split (``kernels/alu_sweep.py::sweep_plan``), at 1 and
   at its largest; the time per launch of each program kind (the trunk's
   pool1 tile and global average pool) at every split.
3. The main path: ``VTAServeEngine(backend="torch")`` serves the full-width
   ResNet-18 and MobileNet-1.0 trunks (``serve/model.py``'s
   ``resnet18_trunk_graph`` and ``mobilenet_trunk_graph``, both under
   ``live_weights``; ``SERVE_REPS`` full dispatches each of buckets 2 and
   8) and the resnet18-small and mobilenet-small served models
   (``SERVE_REPS`` full dispatches of bucket 4), each a tenant of its own,
   through the captured path: each trace runs as chunks
   (``TorchBackend.chunks``), each chunk one CUDA graph captured on the
   first dispatch of its (trace, bucket) and replayed after. That first
   dispatch of each (model, bucket) runs before the serve run, uncounted,
   and is timed as capture cost (the eager run plus the captures). Launch
   counts, dispatches (``fsim_torch.kernel_launch_log``) and the capture log
   are zeroed just before the serve run and read just after
   (``serve_checks``): each kernel must have launched once per entry of each
   forward, each forward must have taken as many dispatches as its chunk
   plan has chunks, each capture-log key must hold 1 and the serve run must
   capture nothing. Every output must equal the same image on
   ``"torch-cpu"``, and request 0 of each trunk must hash to its digest
   (``TRUNK_DIGEST``, ``MBN_DIGEST``), the JAX package's numpy-backend
   result under the same weights (tests/test_torch_serve.py and
   tests/test_torch_mobilenet_serve.py pin the same digests). The
   ``live:`` lines: each trunk's least nonzero share and greatest share at
   the int8 limits over its segments' outputs on images 0-1, read from the
   ``"torch-cpu"`` reference run segment by segment (``segment_shares``;
   the card's outputs equal it by bits), each segment held to
   ``LIVE_NONZERO`` and ``LIVE_SATURATED``: ``ServedModel.compile``'s own
   weights zero MobileNet from ``mbn.pw0`` on and saturate the ResNet
   trunk, which a bit-exact check cannot see. ``accumulate_program``, whose ADD reads acc rows no
   instruction of it wrote, runs three times in a row on the card against
   the port's numpy backend, which a dispatch that skips zeroing the
   scratchpads fails. The ``profile:`` lines give one forward of each trunk
   at batch 8 on the captured path under ``torch.profiler``: host wall
   (profiled and not), device busy, idle share, device kernels and
   ``torch.cuda.memory_reserved``.
4. The float layer ops at full width, through ``repro_torch.kernels.ops``
   at batch ``LAYER_BATCH`` (NHWC), shapes from the port's layer tables:
   the 13 MobileNet-1.0 depthwise layers, each followed by its relu_shift
   post-op ``alu(op="max", imm=0, shift=8, clip=127)``; the 13 pointwise
   convs as GEMMs with ``act="relu", clip=6``; both fc layers with bias;
   ResNet-18's 8 residual adds (``clip=127``); ``resnet18.pool1`` (max),
   ``resnet18.gap`` and ``mbn.gap`` (avg); besides, the (4096, 1024) @
   (1024, 4096) bf16 product of benchmarks/bench_kernels.py, gelu and silu
   epilogues, a bf16 product with K = 1020 and an unclipped multiply. Each
   op also runs in bf16 on at least one shape (``mbn.fc`` at M = 8). A GEMM
   case runs on ``csrc/gemm_bf16_sm90.cu`` (``wgmma``, launch key
   ``gemm_bf16``) when it is bf16 with K and N multiples of 8, else on
   ``csrc/gemm_f32.cu`` (``gemm_float``): ``LAYER_OPS``, ``layer_key``.
   Launch counts are zeroed just before the cases are driven once and read
   just after; each of the five kernels must have launched exactly once per
   case of its route, and ``gemm_float_reduce`` (the second kernel of
   ``csrc/gemm_f32.cu``) once per ``gemm_float`` case whose plan
   (``kernels/gemm.py::gemm_float_plan``) splits K. Then each output is
   held against the plain version on the same inputs: alu, depthwise and
   pool2d exactly (the same bits, signed zeros included, and max_abs_err
   0); the GEMM, whose sums run in another
   order, by its error against a float64 product, which may be at most 2x
   the plain version's plus 1e-6*K, and a second run must give the same
   bytes (split K reduces in a fixed order, with no atomics). The reduce
   kernel is also held alone against its plain version on the split
   kernel's partial sums. Then ``layer_edge_cases`` (odd M, K and N; M = 3
   with K = 1024; a depthwise with C = 36, 5x5, stride 2, and one on signed
   zeros; pooling on signed zeros at 15x15 k3 s2 p1, k2 s2 p0 and k3 s1 p1,
   max also with NaN, C = 36 and C = 3, windows that see only padding, and
   views off a 16-byte boundary, with ``kernels/pool2d.py::pool_plan``
   beside each) run through the same checks, on lines of their own and
   outside the rows (-inf and NaN allowed where the plain version has
   them), and ``alu_edge_cases`` (an odd element count in f32 and bf16,
   views 4 bytes past a 16-byte boundary in f32 and 2, 6 and 10 in bf16,
   NaN in x for max and min, signed zeros for max and min; each with y and
   with an immediate; y at another offset than x) exactly against the
   ALU's plain version (the same bits, NaN by position), with the kernel's
   plan (``kernels/alu.py::alu_plan``) beside each.
5. Attention at full width, through ``repro_torch.kernels.ops.
   flash_attention``, at the head counts, head_dim, windows, softcap and
   query scale of ``configs/archs.py`` (written out in ``ATTENTION_CASES``;
   this script imports nothing of ``repro``): Gemma-2 27B local and global
   layers at prefill (8192 x 8192) and decode (one row against a 32768-key
   cache, or the 4096-key window), Qwen3-0.6B prefill and decode, Mixtral
   8x22B's windowed prefill and RecurrentGemma-9B's MQA at head_dim 256, in
   bf16 and some in f32; MusicGen-Large's 32 heads of 64 (prefill in bf16
   and f32, decode) and Qwen2-VL-2B's GQA group of 6 (prefill, decode),
   whose earlier cases' kernel time is also printed on a line of its own
   (``VLM_AUDIO_ATTENTION``); besides, the shapes of tests/test_kernels.py's
   attention tests, a case with tails in both tiles, causal rows that see
   no key (``edge.empty_rows``), and the f32 prefill at head_dim 8 (Sq 9)
   and 256 (ragged tiles, window, softcap). A case takes one of three
   routes (``kernels/flash_attention.py::attention_route``): Sq <= 8 the
   split-K decode kernel and its combine (``csrc/flash_decode.cu``), bf16
   prefill the tensor-core kernel (``csrc/flash_attention_mma.cu``), f32
   prefill the 3xTF32 tensor-core kernel (``csrc/flash_attention.cu``,
   bound at three products on the TF32 rate; its per-case lines and one
   total line also give the CUDA-core f32 bound, which the kernels JSON
   line leaves out). Launch counts are zeroed
   just before the cases are driven once and read just after:
   ``flash_attention`` once per case, ``flash_attention.<route>`` once per
   case of the route, ``flash_attention_combine`` once per decode case. Each
   output must have the plain version's shape and dtype and be finite; on
   ``ATTENTION_ROWS`` sampled query rows (first, last, the window's edge and
   the rest spread evenly) over all heads, the kernel's error against a
   float64 attention of the same operands may be at most 2x the plain
   version's plus 1e-6 in f32 (logged beside the error); in bf16, element by element, the plain
   version's error there plus one bf16 step at that element (2^-7 |out|)
   plus 2^-7 * 1e-2 of the row's largest value; ``edge.empty_rows`` must be
   exactly 0 in rows 0-31 from both. The combine kernel is also held alone
   against its plain version on the decode kernel's partials (one step of
   the output type, plus 1e-6).
6. The worker pool (``pool_checks``). Scale-out: the trunk through
   ``VTAServeEngine(buckets=(2, 8), workers=WorkerPool(models, n,
   transport="thread"))`` with the default ladder, for n = 1 and then 2;
   each bucket's first dispatch runs alone and untimed (``warm_pool``: the
   eager run and the capture, its ``memory_reserved`` growth given to the
   worker that owns the bucket), then ``POOL_ROUNDS`` rounds of 8 then 2
   trunk images (``round_images``), launch counts, dispatches and metrics
   zeroed just before and read just after. Checks, each a count of what
   failed: every answer equal to ``"torch-cpu"`` and request 0 to
   ``TRUNK_DIGEST``; the affinity map (bucket 8 on worker 0, bucket 2 on
   worker n-1), hit rate 1.0, nothing reassigned; every capture-log key
   once, in the scope of its bucket's owner, none during the rounds;
   kernel launches and dispatches per forward equal to phase 3's; no step
   down the ladder and no breaker transition; each worker on a stream of
   its own, not the default stream. Images/s is all the images of the
   rounds over their summed wall time; the speedup of 2 workers over 1 is
   the ratio of images/s. Cold race (``cold_race``): a fresh 2-worker pool
   takes bucket 8 and bucket 2 together, cold, so that both workers run
   eagerly and capture at once on their own streams, then a replayed
   round; both rounds bit-equal to ``"torch-cpu"`` and the digest, each
   capture-log key once in its owner's scope, each round's launches and
   dispatches those of two forwards, no worker's executor raising.
   Worker-death drill: a seeded ``worker.die`` on worker 1 at its
   dispatch ``DEATH_AFTER + 1``; every ticket ok and bit-exact, bucket 2
   moves to worker 0, which captures it once in its own scope. Ladder
   drill (resnet18-small, one inline worker, ``FakeClock``): a
   ``kernel.impl`` fault keyed ``gemm:cuda`` fires 3 times with
   ``fail_threshold=2``; the batches go down to ``"torch-cpu"`` and back
   (``LADDER_SERVED``), bit-exact, each step down counted in ``fallbacks``,
   and the ``"torch"`` rung's log runs closed->open, open->half_open, ...,
   half_open->closed; a fault of the card that is not injected (a launch
   error) is raised to the caller, with no step down and no breaker moved
   (``card_error_errors``). Process transport: one spawned worker on backend
   ``"torch"`` and resnet18-small from the registry, its answers equal to
   ``"torch-cpu"``, and the child reports the card's name. Two pools
   (``two_pools``): two fresh 2-worker pools alive at once, both cold,
   each engine given a round and the two drained at once, then a replayed
   round; the cold race's checks over both, each key captured once per
   pool (a worker's capture scope is ``pool<k>.worker<id>``), and the four
   workers' streams distinct (the process's stream registry,
   ``fsim_torch.claim_stream``); then the first pool shuts down and the
   second's next round replays with no new capture. Two tenants
   (``two_tenants``): both trunks on one 2-worker pool, each (model,
   bucket)'s first dispatch alone, then ``TENANT_ROUNDS`` rounds of 8 then
   2 images of each: affinity sticky by (model, bucket) (both bucket 8s
   on worker 0, both bucket 2s on worker 1), each model's keys captured
   once in its owner's scope, every answer equal to ``"torch-cpu"``, each
   tenant's request 0 to its digest, launches and dispatches those of
   the forwards served. Every trunk here runs under ``live_weights``.
7. The language-model session (``lm_checks``), through the entry points a
   user calls: ``build_model``, ``ServeSession(model, params).generate``
   on the card, every attention layer on the port's kernels, the RWKV-6
   and RG-LRU blocks in PyTorch. The golden runs (``golden_errors``), in
   f32 against ``tests/golden/lm_session_f32.json``,
   ``lm_session_recurrent_f32.json``, ``lm_session_moe_f32.json`` and
   ``lm_session_vlm_audio_f32.json``,
   which ``tests/make_lm_golden.py`` writes from the JAX package's
   ``ServeSession`` on the CPU: Qwen3-0.6B at full width (its depth cut
   to the file's 4 layers), Gemma-2 27B's smoke config (local layers with
   a window of 8 against 32-token prompts), RWKV-6 1.6B at full width cut
   to 2 layers (2048-token prompts: two chunks of 1024, the state carried
   between) and its smoke config (40 tokens: one padded chunk),
   RecurrentGemma-9B at full width cut to one pattern group of 3 layers,
   and its smoke config (window 8, 32 tokens), Moonshot-v1-16B-A3B at full
   width (64 experts, top-6) cut to 1 layer, and the Moonshot and Mixtral
   smoke configs (each row carries the golden's smallest router margin),
   Qwen2-VL-2B at full width cut to 4 layers and its smoke config (fed
   seeded embeddings at the M-RoPE positions of one image then text, and
   teacher-forced in decode: ``vlm_generate``, since ``generate`` takes
   tokens; held to ``LM_MROPE_TOL``), MusicGen-Large at full width cut to
   4 layers and its smoke config (4 and 2 codebooks: the top 8 held per
   sequence and codebook, ``logit_rows``);
   weights from ``numpy_params`` and the file's seed (their
   sha256 must be the file's, and every weight the reference reads in f32
   must stay f32), 2 prompts, 8 greedy steps: the tokens equal, the
   logits at the file's top 8 of every step within ``LM_F32_TOL``, and
   the attention launches exactly one prefill per attention layer and one
   decode and combine per attention layer and step
   (``lm_launches_want``). The bf16 runs (``lm_bf16``, ``LM_BF16_RUNS``),
   each at full width and depth, weights drawn from a seeded generator on
   the card straight in their serving dtypes (``ServeSession.from_seed``;
   ``init_session``: init's peak within ``INIT_PEAK_SLACK`` of what it
   holds, which is the params' size, and the weights the reference reads
   in f32 kept f32), launch counts zeroed just before and read just
   after: Qwen3-0.6B, 4 prompts of 1024 tokens, 32 steps (28
   ``flash_attention.mma``, 28 x 32 ``flash_attention.decode`` and
   ``flash_attention_combine``); RecurrentGemma-9B, 2 prompts of 2560
   tokens (past its 2048 window), 32 steps (12 ``mma`` per prefill, 12
   ``decode`` and 12 ``combine`` a step); Moonshot-v1-16B-A3B, 4 prompts
   of 1024 tokens, 32 steps (48 ``mma``, 48 ``decode`` and 48 ``combine``
   a step; 56.1 GB of params, freed before the next phase); Qwen2-VL-2B,
   4 sequences of one 32 x 32 image and 1024 text positions, 32
   teacher-forced steps (28 ``mma``, 28 ``decode`` and 28 ``combine`` a
   step); MusicGen-Large, 4 x 4 codebooks x 1024 prompt tokens, 32 steps
   (48 ``mma``, 48 ``decode`` and 48 ``combine`` a step); each step's
   logits of the five against the same model on
   ``flash_attention_plain`` fed the kernels' tokens (Moonshot's also the
   kernels' routing, each MoE layer's top-k indices recorded in the
   kernels' run by ``routing``; the choices the plain run would have made
   otherwise counted, not held), within ``LM_BF16_TOL``, every argmax
   equal, per codebook for MusicGen (Moonshot's but where one run's
   largest logit is held by two
   tokens, the other run's choice one of them: ``exact_tie``, listed).
   Each times its prefill after one uncounted generation at the timed
   shape (``warm_prefill``: its prefill ms and ``cudaMalloc`` calls, and
   the timed run's, recorded). RWKV-6
   1.6B, 4 prompts of 2048 tokens, 32 steps, no kernel: finite logits;
   then, in f32 at full width and depth, a decode step of its first token
   against its forward pass over the prompt and that token, within
   ``LM_FORWARD_TOL`` (the bf16 pair's gap recorded). Each prints prefill
   and decode times (host clock between synchronizes), tokens/s,
   attention's share of device time and the idle share under
   ``torch.profiler``, the params' size, the peak of init and cast,
   ``memory_reserved``.
8. Training (``train_checks``), through the entry points a user calls:
   ``make_train_step`` and the ``Trainer`` on the card, every attention
   layer's forward on the port's kernels (the op
   ``repro_torch::flash_attention``), its
   backward ``flash_attention_backward`` in PyTorch (the reference has no
   backward kernel either). The golden runs (``train_golden_errors``), in
   f32 against ``tests/golden/train_f32.json``, which
   ``tests/make_train_golden.py`` writes from the JAX package's
   ``make_train_step`` on the CPU: Qwen3-0.6B at full width cut to 4
   layers, 2 x 256 tokens, and Gemma-2 27B's smoke config (window 8, both
   softcaps, its query scale), 2 x 32; and against
   ``tests/golden/train_families_f32.json`` (``--families``): the smoke
   configs of Mixtral 8x22B (the MoE dispatch and aux loss), RWKV-6 (64
   tokens: two WKV chunks), RecurrentGemma-9B (RG-LRU and local
   attention), Qwen2-VL-2B (embeddings and positions) and MusicGen-Large
   (codebooks), and Qwen3-0.6B at full width cut to 4 layers with
   ``grad_accum`` 2, 4 x 256 (two microbatches a step, the reference's
   ``lax.scan`` against the port's loop); weights from ``numpy_params`` (the
   file's sha256), the file's batches, three AdamW steps: each step's
   loss within ``TRAIN_LOSS_RTOL`` and grad_norm within
   ``TRAIN_GNORM_RTOL`` (1e-4 on the first step, 5e-3 after: AdamW
   carries rounding into the weights) of the golden's, and the attention
   launches exactly ``train_launches_want`` (``tf32x3``: one per
   attention layer in the forward and one more in its group's
   recompute, per microbatch). The bf16 run
   (``train_bf16``, ``TRAIN_BF16``): Qwen3-0.6B at full width and depth
   (28 layers, f32 master weights from a seeded generator on the card,
   bf16 compute, remat ``"full"``, the loss in 8 chunks), the ``Trainer``
   4 steps of 4 x 2048 tokens from ``DataLoader`` with a checkpoint at
   step 2: each step 56 ``flash_attention.mma`` launches (28 x (1 + 1)),
   counts zeroed just before it and read just after; the step-2
   checkpoint restored equal by bits; step 1 again on the kernels and on
   ``flash_attention_plain``: every gradient leaf finite and nonzero on
   the kernels, each within ``TRAIN_GRAD_TOL`` of the plain run's by norm,
   the losses within ``TRAIN_BF16_LOSS_TOL``. It prints ms per step (the
   median of steps 2-4), tokens/s, the peak of
   ``torch.cuda.max_memory_allocated`` in a step, and from one profiled
   step the attention forward's share of device time, the backward's (the
   kernels inside the attention backward's profiler range) and the idle
   share.
9. The design-space sweep (``dse_checks``), through ``run_sweep`` and
   the CLI a user calls: ``DSE_GRID`` (ResNet-18 and MobileNet-1.0 at
   published widths, log blocks 4 and 5, memory widths 8 and 32,
   scratchpad scale 1, ``--tune full``, one worker, ``--profile``) swept
   cold on the numpy FSim and then on the card, where every winning tile
   is verified once on ``TorchBackend(capture=False)`` through the VTA
   GEMM and sweep kernels. Launch counts, the capture log and the
   uncaptured-run count are zeroed and ``memory_allocated`` noted just
   before the card sweep. Checks, each a count of what failed: the two
   reports byte-identical without ``wall_s``, ``cache`` and ``profile``;
   the numpy report's sha256 ``DSE_DIGEST``, the JAX package's
   (tests/test_torch_dse.py pins the same digest); the VTA GEMM and the
   sweep kernel launched, and as many uncaptured runs as the tuner's
   verifications; no capture; no executor memo on any trace the
   ScheduleStore or the tuner holds (``device_memos``); memory back within
   ``DSE_MEMORY_SLACK``; the card-fault drill (``dse_drill``: a CUDA
   error on the card backend's ``DSE_DRILL_CALL``-th ``run_batched`` ends
   the sweep in ``CardFault``, nothing of that point cached); and
   ``python -m repro_torch.core.dse`` on MobileNet over
   ``DSE_POOL_GRID`` with ``--backend torch --workers 2`` (two groups, so
   its pool spawns two workers on the card) exiting 0 with the numpy
   report of that grid. It prints each sweep's wall and stage seconds,
   verifications and ms per verification, where ``run_batched``'s time
   goes (lowering, device entries, the rest), programs scheduled, the
   Pareto fronts (``analysis/dse_report.py``), each beside the card's name
   and power limit.
10. The mesh layer (``mesh_checks``), on a one-rank ``nccl`` process group
   it starts (after phase 6's spawned worker has exited) and destroys,
   over the mesh ``make_mesh((1, 1), ("data", "model"))`` on the card,
   where every placement is ``Replicate()``. 10a (``mesh_serve``): each
   run of ``MESH_SERVE_RUNS`` (phase 7's Qwen3-0.6B run, 4 x 1024, 32
   steps; RWKV-6 1.6B at full width and depth, 4 x 2048, 8 steps; Moonshot
   at full width cut to 4 layers, 4 x 1024, 8 steps, its params from the
   init in the serving dtypes with that init's checks; all bf16) twice on
   the same seeded params, as phase 7 runs it and with the params
   distributed by the logical rules and ``generate`` under ``use_rules``:
   tokens and every step's logits equal by bits, the attention launches
   under the rules exactly phase 7's; prefill and decode ms of both, and
   phase 7's, recorded. 10b (``mesh_train``): one train step at phase 8's
   configuration from its starting params and first batch, plain and
   under the rules: loss and grad_norm equal by bits, every updated param
   and AdamW moment equal by bits and in its param's placements, every
   gradient in its param's placements, 56 ``mma`` launches. 10c
   (``mesh_restore``): 10b's starting params checkpointed and restored by
   ``elastic_remesh`` onto ``surviving_mesh(0)``: every leaf a DTensor on
   the card with the rules' placements, equal by bits. 10d
   (``mesh_dryrun``): ``python -m repro_torch.launch.dryrun --shape
   train_4k`` for qwen3-0.6b, moonshot-v1-16b-a3b and rwkv6-1.6b
   (``MESH_DRYRUN``), single-pod and ``--multi-pod``, each a subprocess
   (a fake process group cannot share a process with the nccl one), all
   six at once: each ends, its ``peak_est_bytes`` below the card's memory,
   the 16x16 run counts collectives, per-device flops times the ranks over
   ``model_flops`` within the arch's band on that mesh of
   ``MESH_FLOP_BANDS`` (qwen3 and moonshot; recorded for all); the
   per-device numbers, roofline terms
   and wall time printed.

Output: one line per kernel (and per phase-4 case), ms per dispatch per
bucket (median, min, max), then a JSON line of serving numbers (per model
and bucket, the capture cost per model and bucket, the ``live:`` numbers
and the ``profile:`` numbers by trunk), a JSON line of
the pool's numbers (``{"pool": ...}``: per n, ms per round, images/s and per
worker batches, busy ms and reserved MB; the speedup), a JSON line of the
language-model runs (``{"lm": ...}``), one of the training runs
(``{"train": ...}``), one of the sweep (``{"dse": ...}``), one of the
mesh layer (``{"mesh": ...}``), a JSON line of
kernel numbers (the VTA rows also give ``launches_pool``, their launches
in the 2-worker rounds, ``launches_tenants``, the two-tenant rounds',
``launches_per_forward_by_model``, one forward of each served model, and
``launches_dse``, phase 9's card sweep; the
attention rows' ``launches`` are phase 7's, ``launches_train`` phase 8's
and ``launches_cases`` phase 5's), the ``nvidia-smi`` line, and last the
device line. Kernel
times are medians of CUDA-event timings. Each VTA kernel row sums its
launches over one forward of the model named in ``per``
(``launches_per_forward``), while ``launches`` is the count over the whole
serve run. Each layer-op row (``gemm_float``, ``alu``, ``depthwise``,
``pool2d``) sums one pass over its phase-4 cases (``cases``): the kernel by
CUDA-graph replay, the plain version eagerly, and the one PyTorch call that
computes the same function (``torch.matmul``/``addmm``, ``torch.mul``,
``F.conv2d(groups=C)`` on channels-last, ``F.max_pool2d``/``avg_pool2d``;
cuDNN's TF32 off) by CUDA-graph replay over the ``library_cases`` that have
one, beside the kernel's time on those same cases (``ms_library_cases``).
The ``flash_attention.<route>`` rows sum one pass over the phase-5 cases of
their route the same way (the decode route with its combine; the
``flash_attention_combine`` row times the combine alone); the library call is one ``scaled_dot_product_attention`` with
``enable_gqa=True`` where that computes the same function (no softcap; its
``is_causal`` is aligned top-left, so it stands in only where Sq = Sk, and a
boolean mask carries a window). The call is a yardstick here only: the port
never makes it.

``--plant-faults`` runs none of the phases. It shows that the limits of
phases 2-10 fail a wrong kernel, executor, pool, gradient, sweep or mesh
path: the
checkout
is copied into a
temporary directory once as it is and once per fault of ``PLANTED_FAULTS``
(a text substitution: a key tile from 4096 skipped, or the window 64 keys
too wide, in each of the three attention routes; the f32 prefill's score
from the hi . hi product alone (one-term TF32); the ALU kernel's scalar tail
not written; the last K split of the
f32 GEMM dropped; the depthwise halo read one column to the right, by TMA
and on the scalar path; the pooling halo read one column to the right, and
the last tap of every compiled pooling window not taken; the last
reduction row of every VTA GEMM group
dropped; one thread's partial of a split tap reduction dropped; a captured
dispatch that does not zero the scratchpads, and one that replays every
chunk of a trace but the last; MobileNet served under
``ServedModel.compile``'s weights (``load_params`` installing nothing for
it), the last tap of each depthwise MAC dropped from the sweep kernel
where a sweep has 112 rows (MobileNet's 112 x 112 and 56 x 56 layers),
and the fused ``mbn.dw11`` -> ``mbn.pw11`` chunk not replayed; plans shared by every worker,
``pool.shared_plans``, a card rung that steps down for a fault of the
card, ``ladder.card_error_steps_down``, a step down the ladder left
uncounted, ``ladder.uncounted_step_down``, and in the language model a
decode that attends to one slot fewer than are valid, a cache slot
written one off, a prefill that drops the sliding window, a WKV chunk
without its inter-sub-block term, an RG-LRU decode step that ignores its
state, a cast at load that rounds the RG-LRU gates to bf16, M-RoPE
reading row 0 for every section, and a codebook head that reads the next
codebook's weights; in training, an attention forward whose result has
no ``grad_fn``, a backward whose dK and dV keep one query head of each
GQA group, and a ``grad_accum`` loop that drops its last microbatch; in the
sweep, ``CardFault`` caught at ``eval_job`` as an infeasible point, a
verification on the captured route, and one that resolves the card to
``"torch-cpu"``; in the mesh layer, a DTensor attention that takes the
plain version on the card, a restore that ignores its sharding tree, a
dry-run that reports global flops as per-device, one that counts every
product twice, a MoE capacity from a rank's own tokens and a token shift
under the rules one position off; a MoE combine that drops expert 0's
rows; an init in the serving dtypes that rounds the router to bf16, and
one that keeps the f32 tree beside its cast), the
unchanged sources are built once into a build directory the copies share,
and each copy builds its changed source and runs the cases of its route
through their limit checks (``--case-errors``, three copies at a time): the
phase-5 cases and those of ``FAULT_CASES`` through ``attention_error``, the
phase-4 and edge cases of the float GEMM, depthwise, ALU or pooling kernel
(the exact ones by value and by bits), phase 2's
cases of the VTA GEMM or the ALU stage-program kernel, phase 3's checks
(``serve_checks``, one line a check), or phase 6's (``pool_checks``: the
scale-out, the cold race, the two pools and the drill for route
``pool``, the ladder drill for ``ladder``), or the golden runs of phase
7 (``lm_errors``) or phase 8 (``train_errors``), or the init in the
serving dtypes of Moonshot cut to 4 layers (``init_errors``: its peak,
what it holds, its f32 leaves), or phase 9's checks
(``dse_errors``), or the part of phase 10 the fault lies in
(``mesh_errors``: 10a, 10c or 10d); the unchanged copy runs
all of them. One JSON line per (fault, case) gives the kernel's error
and its limit (attention: the kernel's and the plain version's largest
error against float64, the largest |out| and the elements over the limit).
It exits 0 only if the unchanged kernels pass every case and each fault
fails at least one, and prints how many faults were caught of how many
were planted.
"""
from __future__ import annotations

import contextlib
import gc
import hashlib
import json
import math
import os
import re
import statistics
import shutil
import subprocess
import sys
import tempfile
import time
import traceback
import zlib

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

TRUNK = "resnet18-trunk"
SMALL = "resnet18-small"
MBN = "mobilenet1.0-trunk"
MBN_SMALL = "mobilenet-small"

# sha256 of each trunk's output for image 0 of random_images(8, seed=0) under
# live_weights(model, LIVE_SEED), from the JAX package's numpy backend
# (tests/test_torch_serve.py and tests/test_torch_mobilenet_serve.py assert
# the same digests)
TRUNK_DIGEST = \
    "6686d447b6462e98295895df574545f567ad7c023acafb6972bc3de923d1dbf1"
MBN_DIGEST = \
    "b926952d3de5609b1cb1a733bf7817fd1656544bf665a6046dee0058af096e0d"
DIGESTS = {TRUNK: TRUNK_DIGEST, MBN: MBN_DIGEST}

# ServedModel.compile draws int8 weights in [-8, 8) and every post-op shifts
# right by 8: under them MobileNet-1.0 is zero from mbn.pw0 on and the
# ResNet-18 trunk's deep layers sit at +-127, so a bit-exact check of either
# sees little. ``live_weights`` draws each layer's weights from [-r, r], r
# from LIVE_RANGES: on images 0-1 of random_images(8, seed=0) every segment's
# output is then at least LIVE_NONZERO nonzero and at most LIVE_SATURATED at
# the int8 limits (|v| >= 127). The ranges were picked layer by layer in
# segment order, r stepping through 1, 2, 3, 4, 6, 8, 12, ..., 96, 127: the
# largest that left its segment at most 10% saturated; then the layers that
# feed the fc (ResNet-18's stage 3, MobileNet's pw12) cut until the fc,
# whose output is not shifted, sat inside the band with r = 1.
LIVE_SEED = 0
LIVE_NONZERO = 0.10
LIVE_SATURATED = 0.25
LIVE_RANGES = {
    TRUNK: {f"resnet18.{k}": r for k, r in (
        ("s0b0.a", 48), ("s0b0.b", 24), ("s0b1.a", 16), ("s0b1.b", 8),
        ("s1b0.a", 16), ("s1b0.b", 16), ("s1b0.ds", 24), ("s1b1.a", 12),
        ("s1b1.b", 4), ("s2b0.a", 12), ("s2b0.b", 8), ("s2b0.ds", 24),
        ("s2b1.a", 8), ("s2b1.b", 4), ("s3b0.a", 1), ("s3b0.b", 1),
        ("s3b0.ds", 1), ("s3b1.a", 1), ("s3b1.b", 1), ("fc", 1))},
    MBN: {**{f"mbn.dw{i}": 127 for i in range(13)},
          **{f"mbn.pw{i}": 127 if i < 6 else 64 for i in range(12)},
          "mbn.pw12": 2, "mbn.fc": 1},
}

HBM_BYTES_PER_S = 3.35e12        # H100 SXM, NVIDIA data sheet
INT8_TENSOR_OPS_PER_S = 1979e12  # dense int8 tensor-core rate
SCALAR_OPS_PER_S = 67e12         # float32 rate outside the tensor cores
BF16_TENSOR_OPS_PER_S = 989e12   # dense bf16 tensor-core rate
TF32_TENSOR_OPS_PER_S = 495e12   # dense TF32 tensor-core rate
TRUNK_BUCKETS = (2, 8)
SMALL_BUCKET = 4
# (model, bucket) of each batch size the serve run dispatches
SERVE_RUNS = tuple((m, b) for m in (TRUNK, MBN) for b in TRUNK_BUCKETS) + (
    (SMALL, SMALL_BUCKET), (MBN_SMALL, SMALL_BUCKET))
SERVE_REPS = 5           # full dispatches timed per bucket
LAYER_BATCH = 8          # batch of the phase-4 layer-op cases
# phase-4 kernels: launch key -> (op, CUDA source, the TPU kernel it
# replaces, the cases its row sums over). A gemm case goes to the key
# kernels/gemm.py::gemm_route names for its dtype and shape.
LAYER_OPS = {
    "gemm_float": ("gemm", "gemm_f32.cu", "src/repro/kernels/gemm.py:21",
                   "13 MobileNet-1.0 pointwise convs (relu, clip 6), mbn.fc "
                   "and resnet18.fc with bias, gelu and silu 392x1024x1008, "
                   "bf16 392x1020x1008 (K % 8 != 0)"),
    "gemm_bf16": ("gemm", "gemm_bf16_sm90.cu", "src/repro/kernels/gemm.py:21",
                  "mbn.pw12 bf16 (relu, clip 6), mbn.fc bf16 with bias (M 8), "
                  "qkv 4096x1024x4096 bf16"),
    "alu": ("alu", "alu.cu", "src/repro/kernels/alu.py:44",
            "relu_shift post-op on the 14 depthwise outputs, 8 ResNet-18 "
            "residual adds (clip 127; s0b0 also bf16), one mul 56x56x64"),
    "depthwise": ("depthwise_conv", "depthwise.cu",
                  "src/repro/kernels/depthwise.py:38",
                  "13 MobileNet-1.0 depthwise layers (dw1 also bf16)"),
    "pool2d": ("pool2d", "pool2d.cu", "src/repro/kernels/pool2d.py:41",
               "resnet18.pool1 max (also bf16), resnet18.gap avg, mbn.gap "
               "avg (also bf16)"),
}


def layer_key(case) -> str:
    """The launch key of the kernel a phase-4 case runs on the card."""
    from repro_torch.kernels.gemm import gemm_route
    op, _, args, _ = case
    if op == "gemm":
        return gemm_route(args[0].dtype, args[0].shape[1], args[1].shape[1])
    return next(k for k, v in LAYER_OPS.items() if v[0] == op)


# phase-5 cases: (name, B, H, KV, D, Sq, Sk, causal, window, softcap, scale,
# dtypes, library call). Widths from src/repro/configs/archs.py: gemma2-27b
# (:39-47; query scale (4608 / 32) ** -0.5 = 1/12; its local layers decode
# against a cache of the window's length, models/attention.py:144-148),
# qwen3-0.6b (:21-25), mixtral-8x22b (:79-84), recurrentgemma-9b (:65-70).
# Library: "causal" is SDPA's is_causal (top-left, so only where Sq = Sk),
# "none" no mask (every key visible), "mask" a boolean mask.
BF, F32 = "bfloat16", "float32"
ATTENTION_CASES = [
    ("g2.local.prefill", 1, 32, 16, 128, 8192, 8192, True, 4096, 50.0,
     1 / 12, (BF, F32), None),
    ("g2.global.prefill", 1, 32, 16, 128, 8192, 8192, True, None, 50.0,
     1 / 12, (BF,), None),
    ("g2.global.decode", 8, 32, 16, 128, 1, 32768, True, None, 50.0, 1 / 12,
     (BF, F32), None),
    ("g2.local.decode", 8, 32, 16, 128, 1, 4096, True, 4096, 50.0, 1 / 12,
     (BF,), None),
    ("qwen3.prefill", 1, 16, 8, 128, 8192, 8192, True, None, None, None,
     (BF, F32), "causal"),
    ("qwen3.decode", 8, 16, 8, 128, 1, 32768, True, None, None, None, (BF,),
     "none"),
    ("mixtral.local.prefill", 1, 48, 8, 128, 8192, 8192, True, 4096, None,
     None, (BF,), "mask"),
    ("rgemma.local.prefill", 1, 16, 1, 256, 8192, 8192, True, 2048, None,
     None, (BF, F32), "mask"),
]
# tests/test_kernels.py:77-110: gqa 1 and 4 x four masks, and decode (whose
# q and k are not scaled by 0.4 there, nor here)
ATTENTION_CASES += [
    (f"edge.gqa{g}.{m}", 2, 4, 4 // g, 32, 128, 128, c, w, sc, None, (F32,),
     None)
    for g in (1, 4)
    for m, c, w, sc in (("causal", True, None, None),
                        ("window32", True, 32, None),
                        ("softcap15", True, None, 15.0),
                        ("full", False, None, None))]
ATTENTION_CASES += [
    ("edge.decode", 2, 4, 4, 32, 1, 256, True, None, None, None, (F32,),
     None),
    # partial q and key tiles, a head_dim that is not a multiple of 32
    ("edge.tails", 1, 4, 2, 40, 37, 101, True, 50, 15.0, None, (F32, BF),
     None),
    # causal with Sq > Sk: rows 0-31 see no key
    ("edge.empty_rows", 1, 2, 1, 16, 64, 32, True, None, None, None, (F32,),
     None),
    # the f32 prefill kernel at its smallest head and shortest prefill, and
    # ragged q and key tiles at its widest head
    ("edge.f32.d8", 2, 4, 4, 8, 9, 300, True, None, None, None, (F32,), None),
    ("edge.f32.d256", 1, 8, 2, 256, 200, 333, True, 100, 30.0, None, (F32,),
     None),
]
# musicgen-large (:87-91: 32 heads of 64, no GQA) and qwen2-vl-2b (:50-55:
# 12 query heads over 2 KV heads, a GQA group of 6): head_dim 64 at full
# length in both prefill kernels, and the decode kernel's row and lane
# split for D = 64 and for a group of 6. Phase 5 prints the earlier cases'
# total apart from these
VLM_AUDIO_ATTENTION = [
    ("mgen.prefill", 1, 32, 32, 64, 8192, 8192, True, None, None, None,
     (BF, F32), "causal"),
    ("mgen.decode", 8, 32, 32, 64, 1, 32768, True, None, None, None, (BF,),
     "none"),
    ("qwen2vl.prefill", 1, 12, 2, 128, 8192, 8192, True, None, None, None,
     (BF,), "causal"),
    ("qwen2vl.decode", 8, 12, 2, 128, 1, 32768, True, None, None, None,
     (BF,), "none"),
]
ATTENTION_CASES += VLM_AUDIO_ATTENTION
ATTENTION_ROWS = 256     # query rows per case held against float64


def log(*a) -> None:
    print(*a, flush=True)


def median_ms(fn, reps: int = 20, trials: int = 3) -> float:
    """Median over ``trials`` of the mean per-call time of ``reps`` calls,
    by CUDA events, after one warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(trials):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(reps):
            fn()
        e.record()
        e.synchronize()
        out.append(s.elapsed_time(e) / reps)
    return statistics.median(out)


def graph_ms(fn, reps: int = 20, trials: int = 3) -> float:
    """Device time per call: ``reps`` calls captured in one CUDA graph and
    replayed, so host launch overhead is not counted. Median of ``trials``
    replays timed with CUDA events, after one warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    out = []
    for _ in range(trials):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        g.replay()
        e.record()
        e.synchronize()
        out.append(s.elapsed_time(e) / reps)
    return statistics.median(out)


# ---------------------------------------------------------------------------
# the served models and their weights
# ---------------------------------------------------------------------------
def live_weights(model, seed: int = LIVE_SEED) -> dict:
    """New weights for a full-width trunk (``model.name`` a key of
    ``LIVE_RANGES``), by name as ``model.weights`` holds them: each weight
    tensor int8 in [-r, r] with its layer's r, each bias int32 in [-100,
    100), every tensor from a generator of its own, seeded by ``seed`` and
    its name. Install them with ``serve.model.load_params``."""
    ranges = LIVE_RANGES[model.name]
    layers = {k.rsplit(".", 1)[0] for k in model.weights if k.endswith(".wgt")}
    if layers != set(ranges):
        raise KeyError(f"{model.name}: LIVE_RANGES names "
                       f"{sorted(set(ranges) ^ layers)} wrongly")
    out = {}
    for name, w in model.weights.items():
        rng = np.random.default_rng([seed, zlib.crc32(name.encode())])
        layer, role = name.rsplit(".", 1)
        if role == "wgt":
            r = ranges[layer]
            out[name] = rng.integers(-r, r + 1, w.shape, dtype=np.int8)
        else:
            out[name] = rng.integers(-100, 100, w.shape, dtype=w.dtype)
    return out


def shares(a) -> tuple:
    """(nonzero share, share at the int8 limits) of an int8 array."""
    a = np.asarray(a).astype(np.int32)
    return float(np.mean(a != 0)), float(np.mean(np.abs(a) >= 127))


def segment_shares(model, imgs, backend: str = "torch-cpu",
                   first: int = 2) -> tuple:
    """One ``run_batch`` of ``imgs`` on ``backend``: (its output, {tensor:
    ``shares`` over the first ``first`` images} of every tensor a segment
    of ``model`` stores)."""
    out = {}

    def note(seg, outs):
        out.update({t: shares(v[:first].cpu().numpy())
                    for t, v in outs.items()})
    return model.run_batch(imgs, backend, on_segment=note), out


def live_line(name: str, seg: dict) -> tuple:
    """The ``live:`` line of one trunk from its ``segment_shares``, and the
    segments outside the bands (0 passes)."""
    nz = min(seg, key=lambda t: seg[t][0])
    sat = max(seg, key=lambda t: seg[t][1])
    bad = sum(a < LIVE_NONZERO or b > LIVE_SATURATED for a, b in seg.values())
    log(f"live: {name} on images 0-1, {len(seg)} segment outputs: least "
        f"nonzero share {seg[nz][0]:.4f} ({nz}, band >= {LIVE_NONZERO}), "
        f"greatest saturated share {seg[sat][1]:.4f} ({sat}, band <= "
        f"{LIVE_SATURATED}); {bad} outside the bands")
    return bad, dict(model=name, segments=len(seg), least_nonzero=seg[nz][0],
                     least_nonzero_at=nz, most_saturated=seg[sat][1],
                     most_saturated_at=sat)


# ---------------------------------------------------------------------------
# what the main path launches
# ---------------------------------------------------------------------------
def vta_main_path(models: dict, device) -> list:
    """(model, batch, device entries, tensor shapes, {shared tensor: dtype})
    for each model and batch the serve run launches (``SERVE_RUNS``)."""
    out = []
    for name, model in models.items():
        ops, shapes = model_ops(model, device)
        shared = {k: v.dtype.type for k, v in model.weights.items()}
        out += [(name, b, ops, shapes, shared)
                for key, b in SERVE_RUNS if key == name]
    return out


def serve_models(hw) -> dict:
    """The models of the serve run, compiled for ``hw``: both full-width
    trunks with ``live_weights`` installed, and the two serving-scale
    models of the registry."""
    from repro_torch.serve.model import (ServedModel, load_params,
                                         mobilenet_trunk_graph,
                                         resnet18_trunk_graph, served_model)
    out = {}
    for name, graph in ((TRUNK, resnet18_trunk_graph()),
                        (MBN, mobilenet_trunk_graph())):
        m = ServedModel.compile(name, graph, hw)
        out[name] = load_params(m, live_weights(m))
    out[SMALL] = served_model("resnet18", "small", hw)
    out[MBN_SMALL] = served_model("mobilenet", "small", hw)
    return out


def model_ops(model, device):
    """(device entries, tensor shapes) of every segment of ``model``."""
    from repro_torch.vta.fsim_torch import _device_ops
    from repro_torch.vta.lowering import lower_cached
    shapes = dict(model.shapes)
    shapes.update({k: v.shape for k, v in model.weights.items()})
    out = []
    for seg in model.segments:
        tr = lower_cached(seg.program, model.hw, shapes)
        out.extend(_device_ops(tr, device))
    return out, shapes


def gemm_shapes(ops, hw) -> dict:
    """{(w_d, M, K): launches per forward} of the GEMM entries."""
    counts: dict = {}
    for e in ops:
        if e[0] == "gemm":
            _, R, w_d, uidx = e[:4]
            g = len(uidx)
            key = (w_d, (g // w_d) * hw.batch, R * hw.block_in)
            counts[key] = counts.get(key, 0) + 1
    return counts


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------
def gemm_entries(ops) -> list:
    """The GEMM entries of ``_device_ops``, as the wrapper's arguments after
    the three scratchpads: (uidx, inp_idx, wrows, R, w_d, unique)."""
    return [(e[3], e[4], e[5], e[1], e[2], e[6]) for e in ops
            if e[0] == "gemm"]


def gemm_scratchpads(hw, n: int, nw: int, dev, rng, fill=None) -> tuple:
    """(acc, inp, wgt) of one batch: int8 scratchpads drawn from the whole
    int8 range (or all ``fill``), wgt with ``nw`` images, and an int32 acc
    within 2^24 of +-2^31, so that adding a product wraps about half the
    time."""
    import torch
    shape_i = (n, hw.inp_depth, hw.batch, hw.block_in)
    shape_w = (nw, hw.wgt_depth, hw.block_out, hw.block_in)
    if fill is None:
        inp = rng.integers(-128, 128, shape_i, dtype=np.int8)
        wgt = rng.integers(-128, 128, shape_w, dtype=np.int8)
    else:
        inp, wgt = np.full(shape_i, fill[0], np.int8), \
            np.full(shape_w, fill[1], np.int8)
    shape_a = (n, hw.acc_depth, hw.batch, hw.block_out)
    mag = 2**31 - rng.integers(1, 2**24, shape_a, dtype=np.int64)
    acc = np.where(rng.random(shape_a) < 0.5, mag, -mag).astype(np.int32)
    return tuple(torch.from_numpy(a).to(dev) for a in (acc, inp, wgt))


def synthetic_gemm(hw, rng, dev, g: int, R: int, w_d: int,
                   dup: bool = False) -> tuple:
    """One GEMM entry with random rows inside ``hw``'s scratchpads: distinct
    acc targets, or (``dup``) each target named about three times."""
    import torch
    if dup:
        uidx = rng.integers(0, max(1, g // 3), g)
    else:
        uidx = rng.choice(hw.acc_depth, g, replace=False)
    inp_idx = rng.integers(0, hw.inp_depth, g * R)
    wrows = rng.integers(0, hw.wgt_depth, w_d * R)
    return tuple(torch.from_numpy(a.astype(np.int32)).to(dev)
                 for a in (uidx, inp_idx, wrows)) + (R, w_d, not dup)


def conv_gemm_entries(hw, dev) -> list:
    """The GEMM entries of ResNet-18's C8 3x3 conv (14x14, 256 -> 256)
    lowered at ``hw``, at an image batch of ``hw.batch``."""
    from repro_torch.core.tps import ConvWorkload, tps_search
    from repro_torch.vta.fsim_torch import _device_ops
    from repro_torch.vta.lowering import lower
    from repro_torch.vta.scheduler import schedule_conv
    wl = ConvWorkload("r18.C8", hw.batch, 14, 14, 3, 3, 256, 256, 1, 1, 1, 1)
    res = tps_search(wl, hw, require_db=True)
    if not res.feasible:
        res = tps_search(wl, hw)
    prog = schedule_conv(wl, res.tiling, hw).program
    shapes = {"inp": (hw.batch, 256, 14, 14), "wgt": (256, 256, 3, 3),
              "out": (hw.batch, 256, 14, 14)}
    return gemm_entries(_device_ops(lower(prog, hw, shapes), dev))


def gemm_cases(dev, rng, hw, main_path: list) -> list:
    """Phase 2's GEMM cases: (name, hw, scratchpads (acc, inp, wgt),
    entries). Every entry ``main_path`` ((model, batch, entries)) launches
    at its batch, then the edge cases at N = 3."""
    import dataclasses
    cases = [(f"{model}.b{nb}", hw, gemm_scratchpads(hw, nb, 1, dev, rng),
              entries) for model, nb, entries in main_path]

    def one(name, entry, nw=1, fill=None, at=hw):
        cases.append((name, at, gemm_scratchpads(at, 3, nw, dev, rng, fill),
                      [entry]))
    syn = (lambda *a, **k: synthetic_gemm(hw, rng, dev, *a, **k))
    one("edge.prime g13 R7", syn(13, 7, 1))
    one("edge.odd g15 R9 w_d3", syn(15, 9, 3))
    one("edge.K4608 g37", syn(37, 288, 1))
    one("edge.int8 -128 x -128 K4608", syn(21, 288, 3), fill=(-128, -128))
    one("edge.int8 127 x -128 K4608", syn(5, 288, 1), fill=(127, -128))
    one("edge.per-image weights Nw=N", syn(45, 6, 3), nw=3)
    one("edge.per-group fc w_d=g", syn(21, 32, 21))
    one("edge.duplicate uidx (atomics)", syn(48, 9, 4, dup=True))
    for lb, lbat in ((5, 0), (6, 0), (4, 1)):
        at = dataclasses.replace(hw, log_block_in=lb, log_block_out=lb,
                                 log_batch=lbat)
        cases.append((f"edge.r18.C8 log_block {lb} batch_log {lbat}", at,
                      gemm_scratchpads(at, 3, 1, dev, rng),
                      conv_gemm_entries(at, dev)))
    return cases


def gemm_case_error(case) -> int:
    """Largest |kernel - plain| over the whole acc, across the case's
    entries, each run on a fresh copy of the case's acc."""
    import torch
    from repro_torch.kernels.vta_gemm import gemm_acc_plain, vta_gemm
    _, _, (acc, inp, wgt), entries = case
    err = 0
    for e in entries:
        a = vta_gemm(acc.clone(), inp, wgt, *e)
        b = gemm_acc_plain(acc.clone(), inp, wgt, *e)
        torch.cuda.synchronize()
        if not torch.equal(a, b):
            err = max(err, int((a.long() - b.long()).abs().max()))
    return err


def gemm_bound_s(entry, hw, n: int, nw: int) -> tuple:
    """(bytes time, operations time) of one fused entry in seconds: the
    distinct inp and weight rows it reads, its acc rows read and written,
    its int32 index vectors, over the memory rate; 2 x its products at the
    int8 tensor rate."""
    uidx, inp_idx, wrows, R, w_d, _ = entry
    g = uidx.numel()
    rows = [np.unique(t.cpu().numpy()).size for t in (uidx, inp_idx, wrows)]
    nbytes = (n * rows[1] * hw.batch * hw.block_in
              + nw * rows[2] * hw.block_out * hw.block_in
              + 2 * n * rows[0] * hw.batch * hw.block_out * 4
              + 4 * (g + g * R + w_d * R))
    ops = 2 * n * g * hw.batch * R * hw.block_in * hw.block_out
    return nbytes / HBM_BYTES_PER_S, ops / INT8_TENSOR_OPS_PER_S


def check_gemm(dev, rng, hw, main_path: list, timed: tuple) -> dict:
    """``main_path``: (model, batch, GEMM entries) the serve run launches;
    ``timed`` (batch, entries, {(w_d, M, K): launches}): one trunk forward,
    timed by CUDA-graph replay of all its entries."""
    import torch
    from repro_torch.kernels.vta_gemm import gemm_acc_plain, vta_gemm
    cases = gemm_cases(dev, rng, hw, main_path)
    err = 0
    for case in cases:
        e = gemm_case_error(case)
        err = max(err, e)
        log(f"  gemm {case[0]}: {len(case[3])} entries, whole acc "
            f"{'equal' if not e else f'DIFFERS by up to {e}'}")
        if e:
            raise AssertionError(f"gemm differs from its plain version in "
                                 f"{case[0]}")

    n, entries, trunk_shapes = timed
    acc, inp, wgt = gemm_scratchpads(hw, n, 1, dev, rng)

    def forward(fn):
        return lambda: [fn(acc, inp, wgt, *e) for e in entries]
    ms = graph_ms(forward(vta_gemm), reps=1, trials=5)
    eager = median_ms(forward(vta_gemm), reps=1, trials=5)
    # one entry of each shape alone: is a launch's time set by its size?
    shapes: dict = {}
    for e in entries:
        shapes.setdefault((e[0].numel(), e[3], e[4]), e)
    for (g, R, w_d), e in sorted(shapes.items()):
        one = graph_ms(lambda: vta_gemm(acc, inp, wgt, *e), reps=20)
        tb, to = gemm_bound_s(e, hw, n, 1)
        log(f"  gemm entry g {g} R {R} w_d {w_d} (M {g // w_d * hw.batch}, "
            f"K {R * hw.block_in}) at batch {n}: {1e3 * one:.2f} us a "
            f"launch, bound {1e6 * max(tb, to):.2f} us")
    plain = median_ms(forward(gemm_acc_plain), reps=1, trials=1)
    bound = t_bytes = t_ops = 0.0
    for e in entries:
        tb, to = gemm_bound_s(e, hw, n, 1)
        bound += 1e3 * max(tb, to)
        t_bytes += tb
        t_ops += to
    # the product alone on pre-gathered operands, one torch._int_mm per
    # weight block: the library call nearest to the fused function
    lib = 0.0
    for (w_d, m, k), cnt in sorted(trunk_shapes.items()):
        rows = max(n * m, 17)        # torch._int_mm takes > 16 rows
        xs = [torch.from_numpy(rng.integers(-128, 128, (rows, k),
                                            dtype=np.int8)).to(dev)
              for _ in range(w_d)]
        ws = [torch.from_numpy(rng.integers(-128, 128, (k, hw.block_out),
                                            dtype=np.int8)).to(dev)
              for _ in range(w_d)]

        def library():
            for j in range(w_d):
                torch._int_mm(xs[j], ws[j])
        lib += cnt * graph_ms(library, reps=5)
    by = "bytes" if t_bytes >= t_ops else "operations"
    log(f"gemm: {sum(len(c[3]) for c in cases)} entries in {len(cases)} "
        f"cases equal; trunk forward at batch {n} ({len(entries)} entries, "
        f"gather + product + add): kernel {ms:.3f} ms "
        f"({1e3 * ms / len(entries):.2f} us a launch; eager launches "
        f"{eager:.3f} ms), plain {plain:.3f} ms, bound {bound:.4f} ms ({by}); "
        f"torch._int_mm {lib:.3f} ms (product only, on pre-gathered "
        f"operands)")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain,
            "library_ms": lib, "bound_ms": bound, "bound_by": by,
            "eager_ms": eager, "launches_per_forward": len(entries),
            "library": "torch._int_mm, product only, on pre-gathered "
                       "operands"}


def sweep_inputs(prog, shapes, shared: dict, n: int, dev, rng, hw,
                 slabs: dict = None):
    """Random full-range inputs for one program at batch ``n``; ``shared``
    maps the tensors the batch shares to their dtype. ``slabs``, if given,
    keeps each slab tensor drawn, by (name, n), for the next program that
    reads it (the kernel never writes a slab)."""
    import torch
    acc = torch.from_numpy(rng.integers(
        -2**31, 2**31, (n, hw.acc_depth, hw.batch, hw.block_out),
        dtype=np.int32)).to(dev)
    flats = []
    for t in prog.slab_tensors:
        if slabs is not None and (t, n) in slabs:
            flats.append(slabs[(t, n)])
            continue
        size = int(np.prod(shapes[t]))
        shp = (size,) if t in shared else (n, size)
        dtype = shared.get(t, np.int8)
        info = np.iinfo(dtype)
        flats.append(torch.from_numpy(rng.integers(
            info.min, int(info.max) + 1, shp, dtype=dtype)).to(dev))
        if slabs is not None:
            slabs[(t, n)] = flats[-1]
    out = None
    if prog.store is not None:
        size = int(np.prod(shapes[prog.store_tensor]))
        out = torch.from_numpy(rng.integers(-128, 128, (n, size),
                                            dtype=np.int8)).to(dev)
    return acc, flats, out


def run_sweep_pair(prog, acc, flats, out, split=None) -> int:
    """Largest |kernel - plain| over acc and the output tensor, the kernel
    at tap split ``split`` (None: ``sweep_plan``)."""
    import torch
    from repro_torch.kernels.alu_sweep import (alu_chain, alu_sweep,
                                               chain_plain, sweep_plain)
    clone = (lambda t: None if t is None else t.clone())
    if prog.slabs or prog.store is not None:
        a1, o1 = alu_sweep(acc.clone(), prog, flats, clone(out), split=split)
        a2, o2 = sweep_plain(acc.clone(), prog, flats, clone(out))
    else:
        a1, o1 = alu_chain(acc.clone(), prog, split=split), None
        a2, o2 = chain_plain(acc.clone(), prog), None
    torch.cuda.synchronize()
    err = int((a1.long() - a2.long()).abs().max())
    if o1 is not None:
        err = max(err, int((o1.long() - o2.long()).abs().max()))
    return err


def sweep_bound_s(prog, shared: dict, n: int) -> tuple:
    """(bytes time, operations time) of one launch in seconds: each input
    byte read once, each output byte written once, over the memory rate;
    one int32 operation per stage tap and lane over the scalar rate."""
    lanes = prog.lanes
    nbytes = 0
    for t, index, mask, _ in prog.slabs:
        live = index.size if mask is None else int(mask.sum())
        esize = np.dtype(shared.get(t, np.int8)).itemsize
        nbytes += live * esize * (1 if t in shared else n)
    acc_rows = set()
    for kind, rows in prog.operands:
        if kind == "acc":
            acc_rows.update(np.asarray(rows).reshape(-1).tolist())
    if any(s[0] == "read_dst" for s in prog.stages):
        acc_rows.update(prog.dst.tolist())
    nbytes += len(acc_rows) * lanes * 4 * n
    if prog.write_acc:
        nbytes += prog.g * lanes * 4 * n
    if prog.store is not None:
        nbytes += int((prog.meta[prog.offsets["off_store"]:
                                 prog.offsets["off_store"]
                                 + prog.g * lanes] >= 0).sum()) * n
    taps = sum(int(s[1]) if s[0] == "mac" else int(s[2]) if s[0] == "red"
               else 1 for s in prog.stages)
    ops = n * prog.g * lanes * taps
    return nbytes / HBM_BYTES_PER_S, ops / SCALAR_OPS_PER_S


def real_sweep_cases(hw):
    """(program, tensor shapes, shared tensors) of the chains and sweeps
    lowered from a depthwise and two pool programs."""
    from repro_torch.core.tps import ConvWorkload
    from repro_torch.vta.fsim_torch import _device_ops
    from repro_torch.vta.lowering import lower
    from repro_torch.vta.scheduler import schedule_depthwise, schedule_pool
    progs = []
    dw = ConvWorkload("dw", 1, 8, 8, 3, 3, 16, 16, 1, 1, 1, 1,
                      depthwise=True)
    progs.append((schedule_depthwise(dw, hw).program,
                  {"inp": (1, 16, 8, 8), "dw_wgt": (16, 3, 3),
                   "out": (1, 16, 8, 8)}, {"dw_wgt": np.int8}))
    for mode, wl in (("max", ConvWorkload("p", 1, 14, 14, 3, 3, 16, 16, 1,
                                          1, 2, 2)),
                     ("avg", ConvWorkload("gap", 1, 7, 7, 7, 7, 64, 64, 0,
                                          0, 7, 7))):
        progs.append((schedule_pool(wl, hw, mode=mode).program,
                      {"inp": (1, wl.fi, wl.h, wl.w),
                       "out": (1, wl.fo, wl.oh, wl.ow)}, {}))
    out = []
    for prog, shapes, shared in progs:
        tr = lower(prog, hw, shapes)
        for e in _device_ops(tr, "cpu"):
            if e[0] in ("aluchain", "alusweep"):
                out.append((e[1], shapes, shared))
    return out


def edge_cases(hw, rng):
    """Synthetic programs: int32 wrap, SHR counts outside [0, 31], CLIP of a
    negative bound, a MAC/reduce chain, and a store with duplicate and
    masked lanes (last writer wins)."""
    from repro_torch.kernels.alu_sweep import SweepProgram
    g, lanes = 24, (hw.batch, hw.block_out)
    dst = np.arange(g, dtype=np.int32)
    rows = (lambda k: np.arange(100 + 40 * k, 100 + 40 * k + g,
                                dtype=np.int32))
    p1 = SweepProgram(
        (("seed_copy",), ("src", "mul"), ("src", "shr"), ("src", "add"),
         ("imm", "clip", -70000), ("imm", "mul", 3)),
        dst, [("acc", rows(0)), ("acc", rows(1)), ("acc", rows(2)),
              ("acc", rows(3))], lane_shape=lanes)
    p2 = SweepProgram(
        (("read_dst",), ("mac", 3), ("red", "max", 2), ("imm", "shr", 35),
         ("imm", "add", -5)),
        dst, [("acc", np.stack([rows(k) for k in range(3)])),
              ("acc", np.array([90, 91, 92], np.int32)),
              ("acc", np.stack([rows(k) for k in (4, 5)]))],
        lane_shape=lanes)
    size = 300
    index = rng.integers(0, 60, (g,) + lanes).astype(np.int32)
    mask = rng.random((g,) + lanes) < 0.7
    p3 = SweepProgram(
        (("seed_copy",), ("imm", "shr", 20)), dst, [("acc", rows(0))],
        lane_shape=lanes, write_acc=False,
        store=("out", index, mask, False, None, None))
    shapes = {"out": (size,)}
    return [(p, shapes, {}) for p in (p1, p2, p3)]


def shift_rows(acc, rng):
    """Put shift counts in [-40, 40] where the edge programs read SHR."""
    import torch
    acc[:, 180:204] = torch.from_numpy(rng.integers(
        -40, 41, (acc.shape[0], 24) + tuple(acc.shape[2:]),
        dtype=np.int32)).to(acc.device)


def kernel_of(p) -> str:
    return "alu_sweep" if (p.slabs or p.store is not None) else "alu_chain"


def program_kind(p, nb: int) -> str:
    """A sweep's stage signature, rows and batch, e.g. the trunk's pool1
    tile ``seed_copy,red max 8 g112 n8`` or its global average pool
    ``seed_copy,red add 48,imm shr 6 g1 n8``."""
    sig = ",".join(" ".join(str(x) for x in s) for s in p.stages)
    return f"[{sig} g{p.g} n{nb}]"


def splits_of(p, nb: int) -> tuple:
    """The tap splits a program is held at: planned, 1 and its largest."""
    from repro_torch.kernels.alu_sweep import max_split, sweep_plan
    return tuple(sorted({sweep_plan(p, nb), 1, max_split(p)}))


def sweep_cases(dev, rng, hw, main_path: list) -> list:
    """Phase 2's ALU stage-program cases: (name, program, batch, inputs,
    splits). Coverage programs at N = 3 (real depthwise and pool chains and
    sweeps, forced scatter stores, the synthetic edge programs), then every
    program of ``main_path`` ((model, batch, entries, tensor shapes, shared
    tensors)) at its batch; every case at each of ``splits_of``."""
    from repro_torch.kernels.alu_sweep import SweepProgram
    cov = real_sweep_cases(hw)
    forced = []
    for p, shapes, shared in cov + [(e[1], shapes, shared)
                                    for _, _, ops, shapes, shared in main_path
                                    for e in ops if e[0] == "alusweep"]:
        st = p.store
        if st is not None and st[4] is not None:
            forced.append((SweepProgram(
                p.stages, p.dst, p.operands, lane_shape=p.lane_shape,
                slabs=p.slabs, write_acc=p.write_acc,
                store=(st[0], st[1], st[2], st[3], None, None)),
                shapes, shared))
    cov += forced[:8]
    edges = edge_cases(hw, rng)
    cases = []
    for p, shapes, shared in cov + edges:
        acc, flats, out = sweep_inputs(p, shapes, shared, 3, dev, rng, hw)
        if any(p is e[0] for e in edges):
            shift_rows(acc, rng)
        cases.append(("coverage", p, 3, (acc, flats, out), splits_of(p, 3)))
    slabs: dict = {}        # {model: its slab tensors drawn}
    for model, nb, ops, shapes, shared in main_path:
        for e in ops:
            if e[0] in ("aluchain", "alusweep"):
                p = e[1]
                cases.append((f"{model}.b{nb}", p, nb, sweep_inputs(
                    p, shapes, shared, nb, dev, rng, hw,
                    slabs.setdefault(model, {})), splits_of(p, nb)))
    return cases


def check_sweeps(dev, rng, hw, main_path: list, timed: dict) -> tuple:
    """Every case of ``sweep_cases`` bit-exact against its plain version at
    each of its splits; then the programs of the ``main_path`` index
    ``timed`` names for each kernel timed at their planned split, and for
    the first program of each kind the time at every split."""
    from repro_torch.kernels.alu_sweep import (alu_chain, alu_sweep,
                                               chain_plain, sweep_plain,
                                               sweep_plan)
    err = {"alu_chain": 0, "alu_sweep": 0}
    seen = {"chain": 0, "sweep": 0, "affine": 0, "scatter": 0,
            "masked": 0, "no_acc_write": 0, "split": 0}
    cases = sweep_cases(dev, rng, hw, main_path)
    by_group: dict = {}
    for group, p, nb, (acc, flats, out), splits in cases:
        name = kernel_of(p)
        for s in splits:
            e = run_sweep_pair(p, acc, flats, out, s)
            err[name] = max(err[name], e)
            if e:
                raise AssertionError(f"{name} differs from its plain version "
                                     f"({group}, batch {nb}, split {s}) on "
                                     f"stages {p.stages}")
        by_group[group] = by_group.get(group, 0) + 1
        if group != "coverage":
            continue
        seen["sweep" if name == "alu_sweep" else "chain"] += 1
        seen["split"] += max(splits) > 1
        if p.store is not None:
            seen["affine" if p.store[4] is not None else "scatter"] += 1
            if p.store[2] is not None:
                seen["masked"] += 1
        if not p.write_acc:
            seen["no_acc_write"] += 1
    for k, v in seen.items():
        if v == 0:
            raise AssertionError(f"no {k} case among the kernel checks")
    log(f"alu_sweep kernel: programs equal at their planned, minimal and "
        f"maximal tap split: {by_group}; coverage {seen}")

    rows = {k: {"ms": 0.0, "eager_ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                "t_bytes": 0.0, "t_ops": 0.0, "launches_per_forward": 0}
            for k in err}
    per_prog: dict = {}          # program kind -> [ms per launch]
    for group, p, nb, (acc, flats, out), splits in cases:
        name = kernel_of(p)
        model = main_path[timed[name]]
        if group != f"{model[0]}.b{model[1]}":
            continue
        r = rows[name]
        if name == "alu_sweep":
            def run(s=None):
                return alu_sweep(acc, p, flats, out, split=s)

            def plain():
                return sweep_plain(acc, p, flats, out)
        else:
            def run(s=None):
                return alu_chain(acc, p, split=s)

            def plain():
                return chain_plain(acc, p)
        ms = graph_ms(run, reps=5)
        r["ms"] += ms
        r["eager_ms"] += median_ms(run, reps=5)
        r["plain_ms"] += median_ms(plain, reps=2, trials=1)
        kind = program_kind(p, nb)
        if kind not in per_prog:
            log(f"{name} program {kind}: ms per launch by tap split "
                + ", ".join(f"S={s} {graph_ms(lambda: run(s), reps=5):.4f}"
                            for s in (1, 2, 4, 8, 16, 32) if s <= splits[-1])
                + f" (planned S={sweep_plan(p, nb)})")
        per_prog.setdefault(kind, []).append(ms)
        tb, to = sweep_bound_s(p, model[4], nb)
        r["bound_ms"] += 1e3 * max(tb, to)
        r["t_bytes"] += tb
        r["t_ops"] += to
        r["launches_per_forward"] += 1
    for kind, ms in sorted(per_prog.items()):
        log(f"program {kind}: {len(ms)} launches, ms per launch "
            f"mean {statistics.mean(ms):.4f} (min {min(ms):.4f}, max "
            f"{max(ms):.4f}), CUDA-graph replay")
    out = []
    for name in ("alu_chain", "alu_sweep"):
        r = rows[name]
        r["bound_by"] = "bytes" if r.pop("t_bytes") >= r.pop("t_ops") \
            else "operations"
        r["max_abs_err"] = err[name]
        r["library_ms"] = None
        if not r["launches_per_forward"]:
            raise AssertionError(f"the timed model launches no {name}")
        log(f"{name}: {r['launches_per_forward']} launches per forward at "
            f"batch {main_path[timed[name]][1]}: kernel {r['ms']:.3f} ms "
            f"(eager launches {r['eager_ms']:.3f} ms), plain "
            f"{r['plain_ms']:.3f} ms, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']})")
        out.append(r)
    return tuple(out)


# ---------------------------------------------------------------------------
# phase 3: serve
# ---------------------------------------------------------------------------
def serve(models: dict, imgs: dict):
    """The main path: ``SERVE_REPS`` full dispatches of each (model, bucket)
    of ``SERVE_RUNS``, each model a tenant of its own, ``imgs[model]`` its
    images. Returns (outputs with the model and image index each answers,
    launch counts, per-dispatch timings)."""
    import torch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serve.engine import BackendExecutor, VTAServeEngine

    inner = BackendExecutor(models, "torch")
    timings = []

    def timed(key, images, bucket):
        t0 = time.perf_counter()
        out = inner(key, images, bucket)
        torch.cuda.synchronize()
        timings.append((key, bucket, len(images), time.perf_counter() - t0))
        return out

    eng = VTAServeEngine(models, executor=timed)
    tenant = {k: f"t{i}" for i, k in enumerate(models)}
    tickets = []                                # (model, image index, ticket)

    def submit(key, idx):
        tickets.extend((key, i, eng.submit(tenant[key], key, imgs[key][i]))
                       for i in idx)

    reset_launch_counts()
    small = min(TRUNK_BUCKETS)
    for r in range(SERVE_REPS):         # the smallest trunk bucket alone
        for key, b in SERVE_RUNS:
            if b == small:
                submit(key, [(b * r + j) % len(imgs[key]) for j in range(b)])
        eng.drain()
    for r in range(SERVE_REPS):
        for key, b in SERVE_RUNS:
            if b != small:
                submit(key, range(b))
        eng.drain()
    counts = dict(launch_counts())
    outs = [(key, i, t.result(timeout=0)) for key, i, t in tickets]
    return outs, counts, timings


def profile_forward(model, imgs) -> dict:
    """Where one forward of ``model`` goes on the captured path: device
    time by kernel name (``torch.profiler``, which attributes the kernels
    inside CUDA-graph replays), device busy time against host wall time,
    profiled and not (the profiler slows the host), and
    ``torch.cuda.memory_reserved`` (graph pools, the keys' buffers and all
    else the run holds; ``serve_checks`` gives what each first dispatch
    added). Where the profiler shows no device kernel, device time comes
    from CUDA events around the forward instead, and the line says so."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    walls = []
    for _ in range(3):                  # the same forward, not profiled
        t0 = time.perf_counter()
        model.run_batch(imgs, "torch")
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    plain_wall = statistics.median(walls)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        start.record()
        model.run_batch(imgs, "torch")
        end.record()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = []
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue                    # host ops: their kernels are rows
        dev_us = ev.self_device_time_total
        if dev_us:
            rows.append((dev_us, ev.count, ev.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows) / 1e6
    source = "torch.profiler"
    if not rows:
        busy = start.elapsed_time(end) / 1e3
        source = "CUDA events around the forward (the profiler saw no kernel)"
    out = dict(model=model.name, batch=len(imgs), wall_ms=wall * 1e3,
               busy_ms=busy * 1e3,
               idle_share=1 - busy / wall,
               wall_unprofiled_ms=plain_wall * 1e3,
               idle_share_unprofiled=1 - busy / plain_wall,
               device_kernels=sum(r[1] for r in rows), busy_from=source,
               memory_reserved_mb=torch.cuda.memory_reserved() / 1e6)
    log(f"profile: {model.name} forward at batch {len(imgs)} on the "
        f"captured path: "
        f"wall {out['wall_ms']:.1f} ms (profiled), device busy "
        f"{out['busy_ms']:.2f} ms ({source}), device idle share "
        f"{out['idle_share']:.3f}; unprofiled wall "
        f"{out['wall_unprofiled_ms']:.1f} ms (median of 3), idle share "
        f"against it {out['idle_share_unprofiled']:.3f}; device kernels "
        f"{out['device_kernels']}; memory reserved "
        f"{out['memory_reserved_mb']:.1f} MB")
    for dev_us, cnt, key in rows[:12]:
        log(f"  {dev_us / 1e3:9.3f} ms  {cnt:6d}x  {key[:90]}")
    return out


def plan_length(model, be) -> int:
    """Chunks of one forward of ``model`` on backend ``be``: its
    dispatches."""
    from repro_torch.vta.lowering import lower_cached
    shapes = dict(model.shapes)
    shapes.update({k: v.shape for k, v in model.weights.items()})
    return sum(len(be.chunks(lower_cached(s.program, model.hw, shapes)))
               for s in model.segments)


def accumulate_program(hw):
    """A residual add whose loads of operand ``a`` are dropped: its ADD
    accumulates ``b`` into acc rows that only the zeroing of the
    scratchpads at the start of a dispatch clears (the served programs
    write every row before they read it, so they cannot show a stale
    scratchpad). The numpy FSim answers clip(b)."""
    from repro_torch.core.tps import ConvWorkload
    from repro_torch.vta.isa import Buffer, LoadInsn
    from repro_torch.vta.runtime import Program
    from repro_torch.vta.scheduler import schedule_add
    wl = ConvWorkload("acc", 1, 8, 8, 1, 1, 32, 32, 0, 0, 1, 1)
    prog = schedule_add(wl, hw, tensors={"add_a": "a", "add_b": "b",
                                         "out": "out"}).program
    order = [i for i in prog.order if not (
        isinstance(i, LoadInsn) and i.buffer == Buffer.ACC
        and getattr(i, "meta", {}).get("tensor") == "a")]
    return Program(hw=prog.hw, order=order, uop_mem=prog.uop_mem,
                   n_ctx=prog.n_ctx)


def zeroing_errors(hw) -> int:
    """Dispatches of ``accumulate_program`` on the card, three in a row on
    other inputs at batch 2, that differ from the numpy backend."""
    from repro_torch.vta.backend import get_backend
    prog = accumulate_program(hw)
    bad = 0
    for seed in range(3):
        b = np.random.default_rng(seed).integers(-100, 100, (2, 1, 32, 8, 8),
                                                 dtype=np.int8)
        batched = {"b": b, "out": np.zeros_like(b)}
        got = get_backend("torch").run_batched(prog, hw, shared={},
                                               batched=batched)["out"]
        want = get_backend("numpy").run_batched(prog, hw, shared={},
                                                batched=batched)["out"]
        bad += not np.array_equal(got.cpu().numpy(), want.numpy())
    return bad


def trace_keys(model) -> set:
    """The capture-log trace keys of ``model``'s segments: of the Traces
    ``run_batch`` dispatches, each keyed at its first dispatch."""
    from repro_torch.vta.backend import lowered
    keys = set()
    for seg in model.segments:
        shapes = {t: model.shapes[t] for t in set(seg.reads) | set(seg.writes)
                  if t not in model.weights}
        shapes.update({t: model.weights[t].shape for t in seg.reads
                       if t in model.weights})
        key = lowered(seg.program, model.hw, shapes).__dict__.get(
            "_torch_key")
        if key is not None:
            keys.add(key)
    return keys


def per_forward(models: dict, device) -> dict:
    """{model: {kernel: launches in one forward}}: each VTA entry launches
    its kernel once."""
    out = {}
    for key, m in models.items():
        ops = model_ops(m, device)[0]
        out[key] = {k: sum(e[0] == kind for e in ops) for k, kind in (
            ("gemm", "gemm"), ("alu_chain", "aluchain"),
            ("alu_sweep", "alusweep"))}
    return out


def serve_checks(models: dict) -> tuple:
    """Phase 3 on the captured path, over the models of ``serve_models``.
    The first dispatch of each (model, bucket) runs apart, uncounted: it
    runs each trace eagerly and captures its chunks (timed as capture
    cost). Then ``serve``, then the checks, each a count of what failed:
    every capture-log key once and none during the serve run
    (``captures``), dispatches equal to the chunk plan per forward
    (``dispatches``), each kernel once per entry per forward
    (``launches``), full dispatches of every bucket (``buckets``), requests
    that differ from ``"torch-cpu"`` (``outputs``), request 0 of each trunk
    against its digest (``digest``), the trunks' segment outputs outside
    the live bands (``live``, from ``segment_shares`` on ``"torch-cpu"``:
    the card's outputs equal those by bits) and ``zeroing_errors``
    (``zeroing``). Returns (errors, serve rows, capture rows, launch
    counts, live rows, launches per forward)."""
    import torch
    from repro_torch.vta import fsim_torch
    from repro_torch.vta.backend import get_backend
    be = get_backend("torch")
    imgs = {k: m.random_images(8 if k in DIGESTS else SMALL_BUCKET, seed=0)
            for k, m in models.items()}
    plans = {k: plan_length(m, be) for k, m in models.items()}
    fsim_torch.reset_capture_log()
    capture_rows = []
    for key, b in SERVE_RUNS:
        m = models[key]
        torch.cuda.synchronize()
        held = torch.cuda.memory_reserved()
        t0 = time.perf_counter()
        m.run_batch(imgs[key][:b], "torch")
        torch.cuda.synchronize()
        capture_rows.append(dict(
            model=key, bucket=b, graphs=plans[key], traces=len(m.segments),
            ms=(time.perf_counter() - t0) * 1e3,
            reserved_mb=(torch.cuda.memory_reserved() - held) / 1e6))
        log(f"capture {key} bucket {b}: first dispatch of its "
            f"{len(m.segments)} traces (eager run plus the capture of "
            f"{plans[key]} graphs) {capture_rows[-1]['ms']:.1f} ms; memory "
            f"reserved +{capture_rows[-1]['reserved_mb']:.1f} MB")
    captured = fsim_torch.capture_log()
    fsim_torch.reset_kernel_launch_log()
    outs, counts, timings = serve(models, imgs)
    dispatches = fsim_torch.kernel_launch_log()
    errs = {}
    errs["captures"] = sum(v != 1 for v in captured.values()) + abs(
        len(captured) - sum(plans[k] for k, _ in SERVE_RUNS)) + \
        (fsim_torch.capture_log() != captured)
    fwd = SERVE_REPS * sum(plans[k] for k, _ in SERVE_RUNS)
    log(f"dispatches: {dispatches} in the serve run; chunk plan per forward "
        f"{plans}, {fwd} for its {SERVE_REPS * len(SERVE_RUNS)} forwards")
    errs["dispatches"] = abs(dispatches - fwd)
    serve_rows = []
    for key, bucket in sorted({(k, b) for k, b, _, _ in timings}):
        ts = [(f, t) for k, b, f, t in timings if (k, b) == (key, bucket)]
        ms = [t * 1e3 for f, t in ts if f == bucket]
        med = statistics.median(ms) if ms else float("nan")
        serve_rows.append(dict(
            model=key, bucket=bucket, dispatches=len(ms), ms_median=med,
            ms_min=min(ms, default=med), ms_max=max(ms, default=med),
            images_per_s=bucket * 1e3 / med,
            chunk_dispatches_per_forward=plans[key]))
        log(f"serve {key} bucket {bucket}: {len(ms)} full dispatches, ms per "
            f"batch median {med:.1f} (min {min(ms, default=med):.1f}, max "
            f"{max(ms, default=med):.1f}), {bucket * 1e3 / med:.2f} images/s")
    errs["buckets"] = int({(r["model"], r["bucket"]) for r in serve_rows}
                          != set(SERVE_RUNS)) + sum(
        r["dispatches"] != SERVE_REPS for r in serve_rows)
    log(f"launches on the main path: {counts}")
    per_fwd = per_forward(models, be.device)
    log(f"launches per forward: {per_fwd}")
    errs["launches"] = 0
    for k in ("gemm", "alu_chain", "alu_sweep"):
        want = SERVE_REPS * sum(per_fwd[m][k] for m, _ in SERVE_RUNS)
        errs["launches"] += not want or counts.get(k, 0) != want
    t0 = time.perf_counter()
    ref, seg = {}, {}
    for k, m in models.items():
        ref[k], seg[k] = segment_shares(m, imgs[k])
    log(f"torch-cpu reference: {time.perf_counter() - t0:.1f} s")
    errs["outputs"] = sum(
        o.shape != models[key].output_shape or o.dtype != np.int8
        or not np.array_equal(o, ref[key][i]) for key, i, o in outs)
    firsts = {}
    for key, i, o in outs:
        firsts.setdefault(key, (i, hashlib.sha256(o.tobytes()).hexdigest()))
    errs["digest"] = sum(firsts.get(k) != (0, d) for k, d in DIGESTS.items())
    errs["live"], live_rows = 0, []
    for key in DIGESTS:
        bad, row = live_line(key, seg[key])
        errs["live"] += bad
        live_rows.append(row)
    errs["zeroing"] = zeroing_errors(models[TRUNK].hw)
    log(f"serve checks (count of what failed, 0 passes): {errs}; "
        f"{len(outs)} outputs against torch-cpu, digests of request 0 "
        f"{ {k: firsts.get(k) for k in DIGESTS} }")
    return errs, serve_rows, capture_rows, counts, live_rows, per_fwd


# ---------------------------------------------------------------------------
# phase 4: the float layer ops at full width
# ---------------------------------------------------------------------------
def layer_op_cases(dev, rng, n: int) -> list:
    """The phase's cases at batch ``n``, in the order they are driven: each
    (op, name, args, kwargs); an arg that is a string names the case whose
    output it takes. Shapes come from the port's layer tables, NHWC."""
    import torch
    from repro_torch.vta.workloads import mobilenet_graph, resnet_graph

    def t(shape, scale=1.0, dtype=torch.float32):
        a = rng.standard_normal(shape, dtype=np.float32) * np.float32(scale)
        return torch.from_numpy(a).to(dev, dtype)

    bf16 = torch.bfloat16
    mbn = mobilenet_graph(n).layers()
    r18 = resnet_graph(18, n).layers()
    cases = []
    for ly in mbn:
        wl = ly.wl
        if ly.kind == "depthwise":
            for dt in ((torch.float32, bf16) if wl.name == "mbn.dw1"
                       else (torch.float32,)):
                tag = "" if dt == torch.float32 else "/bf16"
                cases.append(("depthwise_conv", wl.name + tag,
                              (t((n, wl.h, wl.w, wl.fi), 2 ** 13, dt),
                               t((wl.kh, wl.kw, wl.fi), 1.0, dt)),
                              dict(stride=wl.sh, pad=wl.ph)))
                # the layer's relu_shift post-op on the depthwise output
                cases.append(("alu", wl.name + ".post" + tag,
                              (wl.name + tag,),
                              dict(op="max", imm=0.0, shift=8, clip=127.0)))
        elif ly.kind == "conv" and not ly.on_cpu:
            k, m = wl.fi, n * wl.h * wl.w
            for dt in ((torch.float32, bf16) if wl.name == "mbn.pw12"
                       else (torch.float32,)):
                tag = "" if dt == torch.float32 else "/bf16"
                cases.append(("gemm", wl.name + tag,
                              (t((m, k), 1.0, dt),
                               t((k, wl.fo), 3.0 / k ** 0.5, dt)),
                              dict(act="relu", clip=6.0)))
    for ly in mbn + r18:
        wl = ly.wl
        if ly.kind == "dense":
            for dt in ((torch.float32, bf16) if wl.name == "mbn.fc"
                       else (torch.float32,)):
                tag = "" if dt == torch.float32 else "/bf16"
                cases.append(("gemm", wl.name + tag,
                              (t((n, wl.fi), 1.0, dt),
                               t((wl.fi, wl.fo), wl.fi ** -0.5, dt),
                               t((wl.fo,), 1.0, dt)), {}))
        elif ly.kind in ("maxpool", "avgpool"):
            mode = "max" if ly.kind == "maxpool" else "avg"
            kw = dict(k=wl.kh, stride=wl.sh, pad=wl.ph, mode=mode)
            for dt in ((torch.float32, bf16) if wl.name != "resnet18.gap"
                       else (torch.float32,)):
                tag = "" if dt == torch.float32 else "/bf16"
                cases.append(("pool2d", wl.name + tag,
                              (t((n, wl.h, wl.w, wl.fi), 1.0, dt),), kw))
        elif ly.kind == "add":
            shape = (n, wl.h, wl.w, wl.fi)
            cases.append(("alu", wl.name, (t(shape, 64.0), t(shape, 64.0)),
                          dict(op="add", clip=127.0)))
    shape = (n, 56, 56, 64)
    cases.append(("alu", "resnet18.s0b0.add/bf16",
                  (t(shape, 64.0, bf16), t(shape, 64.0, bf16)),
                  dict(op="add", clip=127.0)))
    cases.append(("alu", "mul (56x56x64)", (t(shape), t(shape)),
                  dict(op="mul")))
    # bench_kernels.py's "qwen3 qkv" product, and the two other activations
    cases.append(("gemm", "qkv 4096x1024x4096/bf16",
                  (t((4096, 1024), 1.0, bf16), t((1024, 4096), 1 / 32, bf16)),
                  {}))
    x, w = t((n * 49, 1024)), t((1024, 1008), 3 / 32)
    cases.append(("gemm", "gelu (392x1024x1008)", (x, w, t((1008,))),
                  dict(act="gelu", clip=4.0)))
    cases.append(("gemm", "silu (392x1024x1008)", (x, w), dict(act="silu")))
    # a bf16 product whose K is not a multiple of 8 (gemm_f32.cu's route)
    cases.append(("gemm", "relu (392x1020x1008)/bf16",
                  (t((n * 49, 1020), 1.0, bf16), t((1020, 1008), 3 / 32, bf16),
                   t((1008,), 1.0, bf16)), dict(act="relu")))
    return cases


def layer_edge_cases(dev, rng) -> list:
    """Phase 4's edge cases, held to the same limits as its main cases but
    driven and reported apart from them: an f32 product with odd M, K and N
    (ragged tiles, element copies of the w rows), one with M = 3 and K =
    1024 (the thin tile, split K, N odd), a depthwise conv with C = 36,
    15x15 input, 5x5 kernel, stride 2, pad 2 (a ragged channel chunk, the
    kernel's run-time tap loop; bf16 on its scalar path) and one on signed
    zeros; and pooling, in f32 and bf16: 15x15 k3 s2 p1, k2 s2 p0 and k3 s1
    p1 on signed zeros (max also with NaN), C = 36 and C = 3, windows that
    see only padding (k2 s2 p2: -inf), a window of no compiled kind (k5
    s1 p2), one whose halo passes 48 KB (60x60), and views 4 (f32) or 6
    (bf16) bytes past a 16-byte boundary. Outputs may be -inf or NaN only
    where the plain version's are."""
    import torch

    def t(shape, scale=1.0, dtype=torch.float32):
        a = rng.standard_normal(shape, dtype=np.float32) * np.float32(scale)
        return torch.from_numpy(a).to(dev, dtype)

    def zeros(shape, dtype, nan=False, off=0):
        a = signed_zeros(rng, rng.standard_normal(
            int(np.prod(shape)) + off, dtype=np.float32))
        if nan:
            a[rng.random(a.shape) < 0.03] = np.nan
        return torch.from_numpy(a).to(dev, dtype)[off:].view(shape)

    cases = [("gemm", "edge.odd 1001x257x999",
              (t((1001, 257)), t((257, 999), 1 / 16), t((999,))),
              dict(act="relu")),
             ("gemm", "edge.thin 3x1024x1001",
              (t((3, 1024)), t((1024, 1001), 1 / 32), t((1001,))), {})]
    for dt in (torch.float32, torch.bfloat16):
        tag = "" if dt == torch.float32 else "/bf16"
        cases.append(("depthwise_conv", "edge.dw C36 15x15 5x5 s2" + tag,
                      (t((LAYER_BATCH, 15, 15, 36), 2 ** 13, dt),
                       t((5, 5, 36), 1.0, dt)), dict(stride=2, pad=2)))
        # sums of -0s stay -0, as the reference's (weights of both signs)
        w = torch.from_numpy(rng.integers(1, 4, (3, 3, 32)).astype(
            np.float32) * np.where(np.arange(32) < 8, -1, 1)).to(dev, dt)
        cases.append(("depthwise_conv", "edge.dw signed zeros 15x15 3x3 s1"
                      + tag, (zeros((2, 15, 15, 32), dt), w),
                      dict(stride=1, pad=1)))
        # pooling: the three compiled windows on signed zeros (max with
        # NaN), the scalar path (C 3, C 36 in bf16, views off a 16-byte
        # boundary), ragged channel chunks (C 36 in f32), and windows that
        # see only padding (max gives -inf)
        for k, s, p in ((3, 2, 1), (2, 2, 0), (3, 1, 1)):
            for mode in ("max", "avg"):
                cases.append((
                    "pool2d", f"edge.pool {mode} 15x15 k{k} s{s} p{p} signed "
                    f"zeros{' NaN' if mode == 'max' else ''}" + tag,
                    (zeros((2, 15, 15, 32), dt, nan=mode == "max"),),
                    dict(k=k, stride=s, pad=p, mode=mode)))
        for c, mode in ((36, "max"), (3, "avg")):
            cases.append(("pool2d", f"edge.pool {mode} C{c} 15x15 k3 s2 p1"
                          + tag, (t((2, 15, 15, c), 1.0, dt),),
                          dict(k=3, stride=2, pad=1, mode=mode)))
        cases.append(("pool2d", "edge.pool max pad-only windows k2 s2 p2"
                      + tag, (t((2, 15, 15, 32), 1.0, dt),),
                      dict(k=2, stride=2, pad=2, mode="max")))
        # the run-time window ("any": k and stride not compiled), and one
        # whose halo passes 48 KB of shared memory
        cases += [("pool2d", "edge.pool avg 15x15 k5 s1 p2 signed zeros" + tag,
                   (zeros((2, 15, 15, 32), dt),),
                   dict(k=5, stride=1, pad=2, mode="avg")),
                  ("pool2d", "edge.pool max 60x60 k60" + tag,
                   (t((2, 60, 60, 16), 1.0, dt),),
                   dict(k=60, stride=1, pad=0, mode="max"))]
        off = 1 if dt == torch.float32 else 3
        size = 4 if dt == torch.float32 else 2
        for mode in ("max", "avg"):
            cases.append(("pool2d", f"edge.pool {mode} view {off * size} B "
                          f"off 16 B, 15x15 k3 s2 p1" + tag,
                          (zeros((2, 15, 15, 32), dt, off=off),),
                          dict(k=3, stride=2, pad=1, mode=mode)))
    return cases


def signed_zeros(rng, a):
    """a with most elements set to zeros of either sign (two thirds of
    those -0), the rest kept."""
    u = rng.random(a.shape)
    a = np.where(u < 0.6, np.float32(-0.0), a)
    return np.where((u >= 0.6) & (u < 0.9), np.float32(0.0), a).astype(
        np.float32)


def alu_edge_cases(dev, rng) -> list:
    """The ALU kernel's edge cases, held exactly to ``alu_plain`` and
    reported apart from phase 4's rows: an odd element count (a scalar
    tail after the 16-byte vectors) in f32 and bf16; NaN in every 7th
    element of x for max and min; signed zeros for max and min (clipped
    against y; against the immediate zero whose sign loses the tie);
    views whose data pointer lies off a
    16-byte boundary (a scalar head), 4 bytes in f32 and 2, 6 and 10 in
    bf16; each with y and with an immediate; and y at another offset than
    x, which the wrapper copies to x's."""
    import torch
    n = 100003

    def t(count, dtype, off=0, nan=False, zeros=False):
        a = rng.standard_normal(count + off, dtype=np.float32) * np.float32(8)
        if zeros:
            a = signed_zeros(rng, a)
        if nan:
            a[off::7] = np.nan
        return torch.from_numpy(a).to(dev, dtype)[off:]

    cases = []
    for dt in (torch.float32, torch.bfloat16):
        tag = "f32" if dt == torch.float32 else "bf16"
        cases += [
            ("alu", f"edge.alu odd {n} y/{tag}", (t(n, dt), t(n, dt)),
             dict(op="add", shift=1, clip=20.0)),
            ("alu", f"edge.alu odd {n} imm/{tag}", (t(n, dt),),
             dict(op="mul", imm=-1.5, clip=20.0))]
        for op in ("max", "min"):
            cases += [
                ("alu", f"edge.alu NaN {op} y/{tag}",
                 (t(n, dt, nan=True), t(n, dt)), dict(op=op, clip=10.0)),
                ("alu", f"edge.alu NaN {op} imm/{tag}", (t(n, dt, nan=True),),
                 dict(op=op, imm=0.5, shift=2)),
                # ties of -0 and +0: jnp.maximum and jnp.minimum order them
                ("alu", f"edge.alu signed zeros {op} y/{tag}",
                 (t(n, dt, nan=True, zeros=True), t(n, dt, zeros=True)),
                 dict(op=op, clip=0.5)),
                ("alu", f"edge.alu signed zeros {op} imm/{tag}",
                 (t(n, dt, zeros=True),),
                 dict(op=op, imm=-0.0 if op == "max" else 0.0))]
    # offsets in elements: x's alone, then (x's, y's)
    for dt, offs, pairs in ((torch.float32, (1,), ((1, 2), (0, 3))),
                            (torch.bfloat16, (1, 3, 5), ((1, 5), (7, 0)))):
        tag = "f32" if dt == torch.float32 else "bf16"
        size = torch.empty((), dtype=dt).element_size()
        for off in offs:
            cases += [
                ("alu", f"edge.alu offset {off * size} B y/{tag}",
                 (t(n - off, dt, off), t(n - off, dt, off)), dict(op="add")),
                ("alu", f"edge.alu offset {off * size} B imm/{tag}",
                 (t(n - off, dt, off),),
                 dict(op="max", imm=0.0, shift=8, clip=127.0))]
        for xo, yo in pairs:
            cases.append(
                ("alu", f"edge.alu x at {xo * size} B, y at {yo * size} B/"
                 f"{tag}", (t(n, dt, xo), t(n, dt, yo)),
                 dict(op="mul", shift=1, clip=30.0)))
    return cases


def bits_differ(got, want) -> int:
    """Elements whose bits differ, NaN compared by position (a NaN's bits
    are not compared: a bf16 NaN rounds to another payload in each). An
    equal bit pattern is what "exact" means: a -0 where the plain version
    has +0 differs, though |got - want| is 0 there."""
    import torch
    nan = torch.isnan(want)
    ints = {torch.float32: torch.int32, torch.bfloat16: torch.int16}
    same = (got.view(ints[got.dtype]) == want.view(ints[want.dtype])) \
        | (nan & torch.isnan(got))
    return int((~same).sum())


def exact_error(got, want) -> float:
    """Largest |got - want| where want is finite, inf where the two differ
    in which elements are not finite (which are NaN and which +-inf is left
    to ``bits_differ``)."""
    import torch
    finite = torch.isfinite(want)
    if not torch.equal(finite, torch.isfinite(got)):
        return float("inf")
    if not bool(finite.any()):
        return 0.0
    return float((got.float()[finite] - want.float()[finite]).abs().max())


def check_alu_edges(cases, outs: dict) -> None:
    """Each ALU edge case exact against ``alu_plain`` (``exact_error`` 0
    and no element's bits differ, NaN by position), with the kernel's plan
    beside it."""
    from repro_torch.kernels.alu import alu_plain, alu_plan
    for op, name, args, kw in cases:
        x = args[0]
        want = alu_plain(*args, **kw)
        got = outs[name]
        err, nbits = exact_error(got, want), bits_differ(got, want)
        head, _, _, blocks, tail = alu_plan(x.numel(), x.element_size(),
                                            x.data_ptr() % 16)
        at = "".join(f", {w} at {t.data_ptr() % 16} B"
                     for w, t in zip("xy", args))
        log(f"  alu {name}: max|kernel - plain| {err:.3g} (NaN where plain "
            f"is NaN), {nbits} elements differ in bits{at}; head {head}, "
            f"tail {tail}, {blocks} blocks")
        if err != 0 or nbits:
            raise AssertionError(f"{name}: alu differs from its plain "
                                 f"version by {err}, in {nbits} elements")


def resolve(case, outs: dict) -> tuple:
    return tuple(outs[a] if isinstance(a, str) else a for a in case[2])


def drive_layer_ops(cases) -> tuple:
    """The main path of the phase: every case once through
    ``repro_torch.kernels.ops``, launch counts zeroed just before and read
    just after. Returns (outputs by case name, launch counts)."""
    import torch
    from repro_torch.kernels import launch_counts, ops, reset_launch_counts
    outs = {}
    reset_launch_counts()
    for case in cases:
        op, name, _, kw = case
        outs[name] = getattr(ops, op)(*resolve(case, outs), **kw)
    torch.cuda.synchronize()
    return outs, dict(launch_counts())


def gemm_err64(out, x, w, bias, act, clip) -> float:
    """Largest |out - the same function in float64| over the output."""
    import torch
    import torch.nn.functional as F
    r = x.double() @ w.double()
    if bias is not None:
        r = r + bias.double()
    if act == "relu":
        r = torch.relu(r)
    elif act == "silu":
        r = F.silu(r)
    elif act == "gelu":
        r = F.gelu(r, approximate="tanh")
    if clip is not None:
        r = torch.clamp(r, -clip, clip)
    return float((out.double() - r).abs().max())


def op_cost(op, args, kw, out) -> tuple:
    """(bytes, operations, operations per second) of one case: each input
    and output byte once; the GEMM's 2MNK at the f32 or bf16 tensor rate,
    the others' f32 operations at the scalar rate."""
    import torch
    nbytes = sum(a.numel() * a.element_size() for a in args if a is not None)
    nbytes += out.numel() * out.element_size()
    if op == "gemm":
        (m, k), nn = args[0].shape, args[1].shape[1]
        rate = SCALAR_OPS_PER_S if args[0].dtype == torch.float32 \
            else BF16_TENSOR_OPS_PER_S
        return nbytes, 2 * m * nn * k, rate
    if op == "alu":
        steps = 1 + bool(kw.get("shift")) + 2 * (kw.get("clip") is not None)
        return nbytes, steps * out.numel(), SCALAR_OPS_PER_S
    if op == "depthwise_conv":
        kh, kw_, _ = args[1].shape
        return nbytes, 2 * kh * kw_ * out.numel(), SCALAR_OPS_PER_S
    return nbytes, kw["k"] ** 2 * out.numel(), SCALAR_OPS_PER_S


def library_call(op, args, kw):
    """One PyTorch call computing the same function, or None."""
    import torch
    import torch.nn.functional as F
    if op == "gemm":
        if kw.get("act") or kw.get("clip") is not None:
            return None
        if len(args) > 2 and args[2] is not None:
            return lambda: torch.addmm(args[2], args[0], args[1])
        return lambda: torch.matmul(args[0], args[1])
    if op == "alu":
        if kw.get("shift") or kw.get("clip") is not None or len(args) < 2:
            return None
        fn = {"add": torch.add, "mul": torch.mul, "max": torch.maximum,
              "min": torch.minimum}[kw["op"]]
        return lambda: fn(args[0], args[1])
    x = args[0].permute(0, 3, 1, 2)             # NCHW view, channels-last
    if op == "depthwise_conv":
        w = args[1].permute(2, 0, 1).unsqueeze(1).contiguous(
            memory_format=torch.channels_last)
        return lambda: F.conv2d(x, w, stride=kw["stride"], padding=kw["pad"],
                                groups=x.shape[1])
    if kw["pad"] > kw["k"] // 2:               # F.*_pool2d refuse it
        return None
    if kw["mode"] == "max":
        return lambda: F.max_pool2d(x, kw["k"], kw["stride"], kw["pad"])
    return lambda: F.avg_pool2d(x, kw["k"], kw["stride"], kw["pad"],
                                count_include_pad=True)


def check_reduce(args, kw, rows: dict) -> None:
    """A split-K case's reduce kernel alone against its plain version, on
    the partial sums of the split kernel (the same sums in the same order:
    exact, but for the activations' exp and tanh, one step of the output
    type at the element plus 1e-6), timed and added to its row."""
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels.gemm import (gemm_float_plan, gemm_float_reduce,
                                          gemm_float_reduce_plain,
                                          gemm_partials)
    x, w = _build.aligned(args[0]), _build.aligned(args[1])
    bias = args[2] if len(args) > 2 else None
    plan = gemm_float_plan(x.shape[0], w.shape[1], x.shape[1])
    parts = gemm_partials(x, w, plan)
    red = (parts, bias, kw.get("act"), kw.get("clip"), x.dtype)
    got, want = gemm_float_reduce(*red), gemm_float_reduce_plain(*red)
    torch.cuda.synchronize()
    diff = (got.float() - want.float()).abs()
    err = float(diff.max())
    step = 0.0
    if kw.get("act") not in (None, "relu"):
        step = 2.0 ** -7 if x.dtype == torch.bfloat16 else 2.0 ** -20
    if bool((diff > step * want.float().abs() + (1e-6 if step else 0.0)
             ).any()):
        raise AssertionError(f"gemm_float_reduce differs from its plain "
                             f"version by {err:.3g}")
    ms = graph_ms(lambda: gemm_float_reduce(*red), reps=5)
    pms = median_ms(lambda: gemm_float_reduce_plain(*red), reps=3)
    nbytes = sum(a.numel() * a.element_size() for a in (parts, bias, got)
                 if a is not None)
    r = rows["gemm_float_reduce"]
    r["cases"] += 1
    r["max_abs_err"] = max(r["max_abs_err"], err)
    r["ms"] += ms
    r["plain_ms"] += pms
    r["bound_ms"] += 1e3 * nbytes / HBM_BYTES_PER_S
    r["t_bytes"] += nbytes / HBM_BYTES_PER_S
    log(f"    gemm_float_reduce: {plan[2]} splits of {plan[0]}x{plan[1]} "
        f"tiles, max|kernel - plain| {err:.3g}; kernel {ms:.4f} ms, plain "
        f"{pms:.4f} ms, bound {1e3 * nbytes / HBM_BYTES_PER_S:.4f} ms "
        f"(bytes)")


def check_layer_ops(cases, outs: dict, tag: str = "") -> dict:
    """Each case's output against its plain version on the same inputs
    (alu, depthwise, pool: max_abs_err 0 and the same bits, NaN by
    position; outputs finite, but for -inf and NaN where the plain
    version's are in the edge cases; GEMM: error against float64 at
    most 2x the plain version's plus 1e-6*K, and a second run's output
    equal byte for byte), then the kernel (CUDA-graph replay), the plain
    version (eager) and the library call (CUDA-graph replay) timed; a
    split-K case's reduce kernel also alone (``check_reduce``). Returns
    {launch key: row of sums over its cases}; ``tag`` prefixes the row
    lines."""
    import torch
    from repro_torch.kernels import alu, depthwise, gemm, pool2d
    impl = {"gemm": (gemm.gemm, gemm.gemm_plain),
            "alu": (alu.alu, alu.alu_plain),
            "depthwise_conv": (depthwise.depthwise_conv,
                               depthwise.depthwise_plain),
            "pool2d": (pool2d.pool2d, pool2d.pool2d_plain)}
    rows = {key: {"cases": 0, "max_abs_err": 0.0, "ms": 0.0,
                  "plain_ms": 0.0, "bound_ms": 0.0, "t_bytes": 0.0,
                  "t_ops": 0.0, "library_ms": None, "library_cases": 0,
                  "ms_library_cases": 0.0}
            for key in (*LAYER_OPS, "gemm_float_reduce")}
    for key in ("gemm_float", "gemm_bf16"):
        rows[key].update(max_err_vs_f64=0.0, plain_max_err_vs_f64=0.0)
    for case in cases:
        op, name, _, kw = case
        key = layer_key(case)
        args = resolve(case, outs)
        kernel, plain = impl[op]
        got = outs[name]
        want = plain(*args, **kw)
        torch.cuda.synchronize()
        if got.shape != want.shape or got.dtype != want.dtype:
            raise AssertionError(f"{name}: kernel gives {tuple(got.shape)} "
                                 f"{got.dtype}, plain {tuple(want.shape)} "
                                 f"{want.dtype}")
        finite = torch.isfinite(got)
        if (op == "gemm" or not tag) and not bool(finite.all()):
            raise AssertionError(f"{name}: non-finite output")
        both = finite & torch.isfinite(want)
        err = float((got.float() - want.float())[both].abs().max()) \
            if bool(both.any()) else 0.0
        r = rows[key]
        r["max_abs_err"] = max(r["max_abs_err"], err)
        nbits = 0 if op == "gemm" else bits_differ(got, want)
        note = f"err {err:.3g}, {nbits} elements differ in bits"
        if op == "pool2d":
            x = args[0]
            plan = pool2d.pool_plan(
                *x.shape, kw["k"], kw["stride"], kw["pad"], *got.shape[1:3],
                x.element_size(), x.data_ptr() % 16)
            note += (f" (plan {pool2d.KINDS[plan.kind]}, tile {plan.th}x"
                     f"{plan.tw}x{plan.groups} groups of {plan.vec}, "
                     f"{plan.threads} threads, {plan.smem} B)")
        if op == "gemm":
            bias = args[2] if len(args) > 2 else None
            ek = gemm_err64(got, args[0], args[1], bias, kw.get("act"),
                            kw.get("clip"))
            ep = gemm_err64(want, args[0], args[1], bias, kw.get("act"),
                            kw.get("clip"))
            k = args[0].shape[1]
            if ek > 2 * ep + 1e-6 * k:
                raise AssertionError(f"{name}: error vs float64 {ek:.3g} > "
                                     f"2 x plain's {ep:.3g} + 1e-6 K")
            r["max_err_vs_f64"] = max(r["max_err_vs_f64"], ek)
            r["plain_max_err_vs_f64"] = max(r["plain_max_err_vs_f64"], ep)
            again = kernel(*args, **kw)
            torch.cuda.synchronize()
            if not torch.equal(again.view(torch.uint8),
                               got.view(torch.uint8)):
                raise AssertionError(f"{name}: a second run gives other "
                                     f"bytes")
            note = f"err vs f64 {ek:.3g} (plain {ep:.3g}), rerun equal"
        elif err != 0 or nbits:
            raise AssertionError(f"{name}: kernel differs from its plain "
                                 f"version, max |diff| {err}, in {nbits} "
                                 f"elements' bits")
        ms = graph_ms(lambda: kernel(*args, **kw), reps=5)
        pms = median_ms(lambda: plain(*args, **kw), reps=3)
        lib = library_call(op, args, kw)
        lms = None if lib is None else graph_ms(lib, reps=5)
        nbytes, nops, rate = op_cost(op, args, kw, got)
        tb, to = nbytes / HBM_BYTES_PER_S, nops / rate
        r["cases"] += 1
        r["ms"] += ms
        r["plain_ms"] += pms
        r["bound_ms"] += 1e3 * max(tb, to)
        r["t_bytes"] += tb
        r["t_ops"] += to
        if lms is not None:
            r["library_ms"] = (r["library_ms"] or 0.0) + lms
            r["library_cases"] += 1
            r["ms_library_cases"] += ms
        log(f"  {key} {name} {str(got.dtype)[6:]}: {note}; kernel {ms:.4f} "
            f"ms, plain {pms:.4f} ms, library "
            f"{'none' if lms is None else f'{lms:.4f} ms'}, bound "
            f"{1e3 * max(tb, to):.4f} ms")
        if key == "gemm_float" and gemm.gemm_float_plan(
                args[0].shape[0], args[1].shape[1], args[0].shape[1])[2] > 1:
            check_reduce(args, kw, rows)
    for key, r in rows.items():
        r["bound_by"] = "bytes" if r.pop("t_bytes") >= r.pop("t_ops") \
            else "operations"
        if tag and not r["cases"]:
            continue
        log(f"{tag}{key}: {r['cases']} cases, max_abs_err vs plain "
            f"{r['max_abs_err']:.3g}; kernel {r['ms']:.3f} ms, plain "
            f"{r['plain_ms']:.3f} ms, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}); library {r['library_ms']} ms on "
            f"{r['library_cases']} cases (kernel {r['ms_library_cases']:.3f}"
            f" ms on those)")
    return rows


# ---------------------------------------------------------------------------
# phase 5: attention at full width
# ---------------------------------------------------------------------------
def attention_cases(dev, specs=ATTENTION_CASES) -> list:
    """One dict per (case, dtype) of ``specs``, inputs drawn on the
    card from one ``torch.Generator`` seeded 0: q, k, v standard normal, q
    and k times 0.4 as in tests/test_kernels.py (not for ``edge.decode``)."""
    import torch
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    out = []
    for (name, b, h, kv, d, sq, sk, causal, window, softcap, scale, dtypes,
         lib) in specs:
        qk = 1.0 if name == "edge.decode" else 0.4
        for dt in dtypes:
            dtype = getattr(torch, dt)

            def draw(*shape, mul=1.0):
                t = torch.randn(shape, generator=gen, device=dev,
                                dtype=torch.float32)
                return (t * mul if mul != 1.0 else t).to(dtype)
            out.append(dict(
                name=f"{name}/{'bf16' if dt == BF else 'f32'}",
                q=draw(b, h, sq, d, mul=qk), k=draw(b, kv, sk, d, mul=qk),
                v=draw(b, kv, sk, d), library=lib,
                kw=dict(causal=causal, window=window, softcap=softcap,
                        scale=scale)))
    return out


def drive_attention(cases) -> tuple:
    """The main path of the phase: every case once through
    ``repro_torch.kernels.ops.flash_attention``, launch counts zeroed just
    before and read just after. Returns (outputs by name, launch counts)."""
    import torch
    from repro_torch.kernels import launch_counts, ops, reset_launch_counts
    outs = {}
    reset_launch_counts()
    for c in cases:
        outs[c["name"]] = ops.flash_attention(c["q"], c["k"], c["v"],
                                              **c["kw"])
    torch.cuda.synchronize()
    return outs, dict(launch_counts())


def visible(sq: int, sk: int, causal: bool, window) -> tuple:
    """(rows that see no key, visible (query, key) pairs) of one head under
    the bottom-right-aligned mask."""
    qpos = np.arange(sq, dtype=np.int64) + (sk - sq)
    hi = np.minimum(qpos, sk - 1) if causal else np.full(sq, sk - 1)
    lo = np.maximum(qpos - window + 1, 0) if window is not None \
        else np.zeros(sq, np.int64)
    n = np.maximum(hi - lo + 1, 0)
    return int((n == 0).sum()), int(n.sum())


def sample_rows(sq: int, sk: int, window) -> list:
    """First and last row, the rows at the window's edge, the rest spread
    evenly: ``ATTENTION_ROWS`` rows, or all of them."""
    rows = set(np.linspace(0, sq - 1, min(ATTENTION_ROWS, sq))
               .round().astype(int).tolist())
    if window is not None:
        edge = window - (sk - sq)         # the first row whose window cuts
        rows.update(r for r in range(edge - 2, edge + 2) if 0 <= r < sq)
    return sorted(rows)


def key_mask(rows, sq: int, sk: int, causal: bool, window, device):
    """(len(rows), Sk) booleans: the keys each query row sees."""
    import torch
    qpos = torch.as_tensor(rows, device=device).view(-1, 1) + (sk - sq)
    kpos = torch.arange(sk, device=device).view(1, -1)
    mask = torch.ones((len(rows), sk), dtype=torch.bool, device=device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    return mask


def attention64(q, k, v, rows, *, causal, window, softcap, scale):
    """The same attention in float64 on query ``rows`` (B, H, R, D); a row
    that sees no key is 0, as in the kernel."""
    import torch
    b, h, sq, d = q.shape
    kv, sk = k.shape[1], k.shape[2]
    scale = d ** -0.5 if scale is None else scale
    idx = torch.tensor(rows, device=q.device)
    mask = key_mask(rows, sq, sk, causal, window, q.device)
    out = []
    for i in range(b):
        qb = q[i][:, idx].double().reshape(kv, h // kv, len(rows), d) * scale
        s = qb @ k[i].double().unsqueeze(1).transpose(-1, -2)
        if softcap is not None:
            s = softcap * torch.tanh(s / softcap)
        s = s.masked_fill(~mask, float("-inf"))
        mx = s.amax(dim=-1, keepdim=True)
        w = torch.exp(s - torch.where(torch.isfinite(mx), mx, 0.0))
        den = w.sum(dim=-1, keepdim=True)
        o = (w @ v[i].double().unsqueeze(1)) / torch.where(den > 0, den, 1.0)
        out.append(o.reshape(h, len(rows), d))
    return torch.stack(out)


def attention_library(c):
    """One ``scaled_dot_product_attention`` call computing the case's
    function, or None (a softcap, or no call named for the case)."""
    import torch.nn.functional as F
    q, k, v, kw = c["q"], c["k"], c["v"], c["kw"]
    if c["library"] is None or kw["softcap"] is not None:
        return None
    if c["library"] == "causal":
        if q.shape[2] != k.shape[2]:
            raise AssertionError(f"{c['name']}: is_causal is top-left")
        return lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, scale=kw["scale"], enable_gqa=True)
    if c["library"] == "none":
        if visible(q.shape[2], k.shape[2], kw["causal"], kw["window"])[1] \
                != q.shape[2] * k.shape[2]:
            raise AssertionError(f"{c['name']}: not every key is visible")
        return lambda: F.scaled_dot_product_attention(
            q, k, v, scale=kw["scale"], enable_gqa=True)
    sq, sk = q.shape[2], k.shape[2]
    mask = key_mask(range(sq), sq, sk, kw["causal"], kw["window"], q.device)
    return lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=mask, scale=kw["scale"], enable_gqa=True)


def attention_error(got, want, r64) -> tuple:
    """(kernel's largest error, plain version's largest error, what broke the
    limit or "") against float64 on the sampled rows. f32: the kernel's
    largest error at most 2x the plain version's plus 1e-6. bf16, element by
    element: at most the plain version's error there plus one bf16 step at
    that element (2^-7 |plain|), since the two round nearly equal f32 values
    to the same or neighbouring bf16 values, plus 2^-7 * 1e-2 of the row's
    largest |float64| value for the f32 sums' own order near 0."""
    import torch
    ek = (got.double() - r64).abs()
    ep = (want.double() - r64).abs()
    emax, pmax = float(ek.max()), float(ep.max())
    if got.dtype == torch.float32:
        limit = 2 * pmax + 1e-6
        return emax, pmax, "" if emax <= limit else f"limit {limit:.3g}"
    row = r64.abs().amax(dim=-1, keepdim=True)
    limit = ep + 2.0 ** -7 * want.double().abs() + 2.0 ** -7 * 1e-2 * row
    over = ek > limit
    if not bool(over.any()):
        return emax, pmax, ""
    i = int((ek - limit).flatten().argmax())
    return emax, pmax, (f"{int(over.sum())} elements, worst "
                        f"{float(ek.flatten()[i]):.3g} > "
                        f"{float(limit.flatten()[i]):.3g} at |float64| "
                        f"{float(r64.abs().flatten()[i]):.3g}")


ATTENTION_KEYS = ("flash_attention.mma", "flash_attention.decode",
                  "flash_attention.tf32x3", "flash_attention_combine")


def check_attention(cases, outs: dict) -> dict:
    """Each case's output against the plain version on the same inputs and
    both against float64 on sampled rows (``attention_error``),
    ``edge.empty_rows`` exactly 0 where no key is seen; then the kernel
    (CUDA-graph replay), the plain version (eager) and the library call
    (CUDA-graph replay) timed. For the decode cases, the combine kernel
    alone as well, on the partials of the decode kernel, against
    ``decode_combine_plain``. Returns {launch key: row of sums over the
    cases of its route}."""
    import torch
    from repro_torch.kernels.flash_attention import (
        attention_route, decode_combine, decode_combine_plain,
        decode_partials, flash_attention, flash_attention_plain)
    rows = {key: {"cases": 0, "max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
                  "bound_ms": 0.0, "t_bytes": 0.0, "t_ops": 0.0,
                  "library_ms": None, "library_cases": 0,
                  "ms_library_cases": 0.0} for key in ATTENTION_KEYS}
    for key in ATTENTION_KEYS[:3]:      # the routes, held to float64
        rows[key].update(max_err_vs_f64=0.0, plain_max_err_vs_f64=0.0)
    cuda_cores_ms = 0.0   # the f32 prefill's bound at the CUDA cores' rate
    newer = {spec[0] for spec in VLM_AUDIO_ATTENTION}
    earlier = {"cases": 0, "ms": 0.0}    # the cases before VLM_AUDIO_ATTENTION
    for c in cases:
        name, q, k, v, kw = c["name"], c["q"], c["k"], c["v"], c["kw"]
        got = outs[name]
        want = flash_attention_plain(q, k, v, **kw)
        torch.cuda.synchronize()
        if got.shape != want.shape or got.dtype != want.dtype:
            raise AssertionError(f"{name}: kernel gives {tuple(got.shape)} "
                                 f"{got.dtype}, plain {tuple(want.shape)} "
                                 f"{want.dtype}")
        if not bool(torch.isfinite(got).all()):
            raise AssertionError(f"{name}: non-finite output")
        err = float((got.float() - want.float()).abs().max())
        b, h, sq, d = q.shape
        sk = k.shape[2]
        empty, pairs = visible(sq, sk, kw["causal"], kw["window"])
        if name.startswith("edge.empty_rows"):
            if empty != 32 or bool(got[:, :, :empty].any()) or \
                    bool(want[:, :, :empty].any()):
                raise AssertionError(f"{name}: rows that see no key are not "
                                     f"exactly 0")
        rows_ = sample_rows(sq, sk, kw["window"])
        r64 = attention64(q, k, v, rows_, **kw)
        idx = torch.tensor(rows_, device=q.device)
        ek, ep, bad = attention_error(got[:, :, idx], want[:, :, idx], r64)
        if bad:
            raise AssertionError(f"{name}: error vs float64 {ek:.3g} (plain's "
                                 f"{ep:.3g}) over its limit: {bad}")
        reps = 2 if sq * sk >= 2 ** 24 else 5 if b * sk >= 2 ** 15 else 20
        ms = graph_ms(lambda: flash_attention(q, k, v, **kw), reps=reps)
        pms = median_ms(lambda: flash_attention_plain(q, k, v, **kw), reps=1,
                        trials=1)
        lib = attention_library(c)
        lms = lib_err = None
        if lib is not None:
            lib_err = float((lib().float() - want.float()).abs().max())
            lms = graph_ms(lib, reps=reps)
            lib_note = f"{lms:.4f} ms (max|lib - plain| {lib_err:.3g})"
        nbytes = sum(t.numel() * t.element_size() for t in (q, k, v, got))
        route = attention_route(q.dtype, sq)
        # 4 D operations a visible pair: the f32 prefill issues them three
        # times over (3xTF32) on the TF32 tensor cores; f32 decode runs on
        # the CUDA cores; bf16 on the bf16 tensor cores
        nops = 4 * b * h * d * pairs
        cuda_core_ms = 1e3 * nops / SCALAR_OPS_PER_S
        if route == "tf32x3":
            to = 3 * nops / TF32_TENSOR_OPS_PER_S
        elif q.dtype == torch.float32:
            to = nops / SCALAR_OPS_PER_S
        else:
            to = nops / BF16_TENSOR_OPS_PER_S
        tb = nbytes / HBM_BYTES_PER_S
        row = rows[f"flash_attention.{route}"]
        row["cases"] += 1
        if name.split("/")[0] not in newer:
            earlier["cases"] += 1
            earlier["ms"] += ms
        row["max_abs_err"] = max(row["max_abs_err"], err)
        row["max_err_vs_f64"] = max(row["max_err_vs_f64"], ek)
        row["plain_max_err_vs_f64"] = max(row["plain_max_err_vs_f64"], ep)
        row["ms"] += ms
        row["plain_ms"] += pms
        row["bound_ms"] += 1e3 * max(tb, to)
        row["t_bytes"] += tb
        row["t_ops"] += to
        if route == "tf32x3":
            cuda_cores_ms += max(1e3 * tb, cuda_core_ms)
        if lms is not None:
            row["library_ms"] = (row["library_ms"] or 0.0) + lms
            row["library_cases"] += 1
            row["ms_library_cases"] += ms
        log(f"  flash_attention.{route} {name} B{b} H{h}/{k.shape[1]} D{d} "
            f"{sq}x{sk}: max|kernel - plain| {err:.3g}; vs f64 on "
            f"{len(rows_)} rows {ek:.3g} (plain {ep:.3g}"
            + (f", limit {2 * ep + 1e-6:.3g}" if q.dtype == torch.float32
               else "") + f"); kernel {ms:.4f} "
            f"ms, plain {pms:.4f} ms, library "
            f"{'none' if lms is None else lib_note}"
            f", bound {1e3 * max(tb, to):.4f} ms "
            f"({'bytes' if tb >= to else 'operations'})"
            + (f"; f32 CUDA-core bound {max(1e3 * tb, cuda_core_ms):.4f} ms"
               if route == "tf32x3" else ""))
        if route != "decode":
            continue
        parts = decode_partials(q, k, v, kw["causal"], kw["window"],
                                kw["softcap"], d ** -0.5 if kw["scale"] is None
                                else kw["scale"])
        cg = decode_combine(*parts, q.dtype)
        cp = decode_combine_plain(*parts, q.dtype)
        torch.cuda.synchronize()
        # sums over the chunks in another order: one step of the output
        # type at the element (2^-7 in bf16, 2^-20 for f32 sums), plus 1e-6
        diff = (cg.float() - cp.float()).abs()
        step = 2.0 ** -7 if q.dtype == torch.bfloat16 else 2.0 ** -20
        cerr = float(diff.max())
        if bool((diff > step * cp.float().abs() + 1e-6).any()):
            raise AssertionError(f"{name}: combine kernel differs from its "
                                 f"plain version by {cerr:.3g}")
        cr = rows["flash_attention_combine"]
        cr["max_abs_err"] = max(cr["max_abs_err"], cerr)
        cms = graph_ms(lambda: decode_combine(*parts, q.dtype), reps=20)
        cpms = median_ms(lambda: decode_combine_plain(*parts, q.dtype),
                         reps=3)
        cb = sum(t.numel() * t.element_size() for t in (*parts, cg))
        cr["cases"] += 1
        cr["ms"] += cms
        cr["plain_ms"] += cpms
        cr["bound_ms"] += 1e3 * cb / HBM_BYTES_PER_S
        cr["t_bytes"] += cb / HBM_BYTES_PER_S
        log(f"  flash_attention_combine {name}: {parts[0].shape[1]} chunks, "
            f"max|kernel - plain| {cerr:.3g}; kernel {cms:.4f} ms, plain "
            f"{cpms:.4f} ms, bound {1e3 * cb / HBM_BYTES_PER_S:.4f} ms (bytes)")
    for key, row in rows.items():
        row["bound_by"] = "bytes" if row.pop("t_bytes") >= row.pop("t_ops") \
            else "operations"
        log(f"{key}: {row['cases']} cases, max_abs_err vs plain "
            f"{row['max_abs_err']:.3g}; kernel {row['ms']:.3f} ms, plain "
            f"{row['plain_ms']:.3f} ms, bound {row['bound_ms']:.4f} ms "
            f"({row['bound_by']}); library {row['library_ms']} ms on "
            f"{row['library_cases']} cases (kernel "
            f"{row['ms_library_cases']:.3f} ms on those)")
    log(f"flash_attention.tf32x3: bound at the CUDA cores' f32 rate "
        f"{cuda_cores_ms:.4f} ms over its {rows['flash_attention.tf32x3']['cases']} "
        f"cases (its row's bound_ms takes the TF32 tensor cores' rate)")
    log(f"flash_attention: {len(cases)} cases, kernels "
        f"{sum(rows[k]['ms'] for k in ATTENTION_KEYS[:3]):.3f} ms in all")
    log(f"flash_attention: the {earlier['cases']} cases before the "
        f"musicgen-large and qwen2-vl-2b ones, kernels "
        f"{earlier['ms']:.3f} ms in all")
    return rows


# ---------------------------------------------------------------------------
# phase 6: the worker pool, its ladder and its transports
# ---------------------------------------------------------------------------
POOL_ROUNDS = 10         # rounds of the scale-out burst, each 8 then 2 images
DRILL_ROUNDS = 6         # rounds of the worker-death drill
DEATH_AFTER = 3          # worker 1's dispatches before the drill kills it
LADDER_DISPATCHES = 8    # batches of the ladder drill
LADDER_SERVED = ("torch-cpu",) * 5 + ("torch",) * 3   # rung of each batch
TENANT_ROUNDS = 3        # rounds of the two-tenant pool, 8 + 2 images a tenant


def round_images(r: int) -> list:
    """The trunk images (indices into ``random_images(8, seed=0)``) of
    burst round ``r``: all 8, then 2 of them, so that the 8 fill bucket 8
    and the 2 bucket 2."""
    return list(range(8)) + [(2 * r) % 8, (2 * r + 1) % 8]


def spy_streams(pool, seen: dict) -> None:
    """Wrap each worker's ``"torch"`` rung so that every batch it computes
    records the stream current on its thread: ``seen[worker id]``."""
    import torch
    for w in pool.workers:
        for rung in w.executor.rungs:
            if rung.name != "torch":
                continue

            def spy(key, images, bucket, _inner=rung.executor, _wid=w.id):
                seen.setdefault(_wid, set()).add(
                    torch.cuda.current_stream().cuda_stream)
                return _inner(key, images, bucket)
            rung.executor = spy


def stream_errors(pool, seen: dict) -> int:
    """Workers that ran on no stream of their own, on the default stream,
    or on a stream another worker ran on."""
    import torch
    default = torch.cuda.default_stream().cuda_stream
    mine = [w.stream.cuda_stream if w.stream is not None else None
            for w in pool.workers]
    bad = sum(s is None or s == default for s in mine)
    bad += len(mine) - len(set(mine))
    return bad + sum(seen.get(w.id, set()) != {mine[w.id]}
                     for w in pool.workers if w.live)


def owner_scopes(pool, owners: dict) -> set:
    """{(batch, capture scope)} of ``owners`` ({batch: worker id}) in
    ``pool``: the scope each bucket's captures must carry."""
    return {(b, pool.workers[w].scope) for b, w in owners.items()}


def capture_errors(log: dict, owners: set, graphs: int) -> int:
    """Capture-log keys away from ``owners`` ({(batch, capture scope)}: each
    (trace, chunk) of a bucket captured once in each scope it is owned in,
    and nothing else): keys captured more than once, scopes that are not
    an owner's, and (batch, scope) pairs short of ``graphs`` keys."""
    bad = sum(v != 1 for v in log.values())
    want = set(owners)
    got: dict = {}
    for sig in log:
        got[(sig[3], sig[4])] = got.get((sig[3], sig[4]), 0) + 1
    bad += sum(k not in want for k in got)
    return bad + sum(abs(got.get(k, 0) - graphs) for k in want)


def served_errors(results, ref) -> int:
    """Answers (image index, output) that differ from ``"torch-cpu"``."""
    return sum(o.dtype != np.int8 or not np.array_equal(o, ref[i])
               for i, o in results)


def warm_pool(eng, pool, imgs) -> tuple:
    """Each bucket's first dispatch alone, untimed: bucket 8 then bucket 2,
    each an eager run plus the capture of its chunks on the worker that
    cold placement gives it. Returns (answers, {worker id: MB of
    ``memory_reserved`` growth over its first dispatches})."""
    import gc
    import torch
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    grown = {w.id: 0.0 for w in pool.workers}
    results = []
    for b in (8, 2):
        torch.cuda.synchronize()
        held = torch.cuda.memory_reserved()
        tks = [(i, eng.submit("t0", TRUNK, imgs[i])) for i in range(b)]
        eng.drain()
        torch.cuda.synchronize()
        grown[pool.affinity[(TRUNK, b)]] += \
            (torch.cuda.memory_reserved() - held) / 1e6
        results += [(i, t.result(timeout=0)) for i, t in tks]
    return results, grown


def burst(eng, imgs, rounds: int) -> tuple:
    """``rounds`` rounds of ``round_images``, each drained before the next.
    Returns (answers in submission order, seconds per round)."""
    results, secs = [], []
    for r in range(rounds):
        t0 = time.perf_counter()
        tks = [(i, eng.submit("t0", TRUNK, imgs[i])) for i in round_images(r)]
        eng.drain()
        secs.append(time.perf_counter() - t0)
        results += [(i, t.result(timeout=0)) for i, t in tks]
    return results, secs


def kernel_spans(prof) -> list:
    """(start, end, name) of every device kernel a profile saw, in order."""
    from torch.autograd import DeviceType
    return sorted((e.time_range.start, e.time_range.end, e.name)
                  for e in prof.events()
                  if e.device_type == DeviceType.CUDA
                  and e.time_range.end > e.time_range.start)


def spans_union(spans: list) -> float:
    """The length of the union of ``kernel_spans``' intervals: device busy
    time, where kernels that overlap count once."""
    union, (lo, hi) = 0, spans[0][:2]
    for a, b, _ in spans[1:]:
        if a > hi:
            union, lo, hi = union + hi - lo, a, b
        else:
            hi = max(hi, b)
    return union + hi - lo


def profile_round(eng, imgs) -> tuple:
    """One more burst round under ``torch.profiler``: host wall, the device
    kernels' summed time, the union of their intervals (busy time: what
    the two workers' kernels overlap counts once), the overlap factor
    (sum over union; 1.0 is no overlap) and the idle share (1 - union over
    wall). Returns (answers, numbers); the numbers are None where the
    profiler saw no device kernel."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        results, secs = burst(eng, imgs, 1)
    spans = kernel_spans(prof)
    if not spans:
        return results, None
    union = spans_union(spans)
    total = sum(b - a for a, b, _ in spans)
    return results, dict(wall_ms=secs[0] * 1e3, kernels=len(spans),
                         kernel_sum_ms=total / 1e3, busy_ms=union / 1e3,
                         overlap=total / union,
                         idle_share=1 - union / 1e3 / (secs[0] * 1e3))


def scale_out(trunk, n: int, imgs, ref, per_fwd: dict, graphs: int) -> tuple:
    """The trunk through ``VTAServeEngine(buckets=(2, 8), workers=
    WorkerPool(models, n, transport="thread"))`` with the default ladder:
    ``warm_pool``, then ``POOL_ROUNDS`` rounds with launch counts,
    dispatches and metrics zeroed just before and read just after. Returns
    (row, errors)."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serve.engine import VTAServeEngine
    from repro_torch.serve.workers import WorkerPool
    from repro_torch.vta import fsim_torch
    models = {TRUNK: trunk}
    pool = WorkerPool(models, n, transport="thread")
    seen: dict = {}
    spy_streams(pool, seen)
    eng = VTAServeEngine(models, buckets=(2, 8), workers=pool)
    errs = {}
    try:
        fsim_torch.reset_capture_log()
        warm, grown = warm_pool(eng, pool, imgs)
        warm_log = fsim_torch.capture_log()
        metrics = eng.reset_metrics()
        reset_launch_counts()
        fsim_torch.reset_kernel_launch_log()
        results, secs = burst(eng, imgs, POOL_ROUNDS)
        counts = launch_counts()
        dispatches = fsim_torch.kernel_launch_log()
        snap = metrics.snapshot()
        captured = fsim_torch.capture_log()
        profiled, prof = profile_round(eng, imgs)
        owners = {b: pool.affinity[(TRUNK, b)] for b in (8, 2)}
        errs["outputs"] = served_errors(warm + results + profiled, ref)
        errs["digest"] = int(results[0][0] != 0 or hashlib.sha256(
            results[0][1].tobytes()).hexdigest() != TRUNK_DIGEST)
        errs["affinity"] = int(owners != {8: 0, 2: n - 1}) + int(
            snap["workers"]["affinity"]["hit_rate"] != 1.0) + \
            snap["workers"]["affinity"]["reassigned"]
        errs["captures"] = capture_errors(
            warm_log, owner_scopes(pool, owners), graphs) + int(
            captured != warm_log)
        fwd = 2 * POOL_ROUNDS
        errs["launches"] = sum(counts.get(k, 0) != fwd * v
                               for k, v in per_fwd.items()) + \
            abs(dispatches - fwd * graphs)
        errs["ladder"] = len(metrics.fallbacks) + sum(
            len(v) for w in pool.workers
            for v in w.executor.breaker_log().values()) + sum(
            len(v) for v in pool.breaker_log().values())
        errs["streams"] = stream_errors(pool, seen)
    finally:
        eng.close()
    ms = [s * 1e3 for s in secs]
    med = statistics.median(ms)
    row = dict(workers=n, rounds=POOL_ROUNDS, images_per_round=10,
               ms_per_round_median=med, ms_per_round_min=min(ms),
               ms_per_round_max=max(ms), wall_ms=sum(ms),
               images_per_s=10 * POOL_ROUNDS * 1e3 / sum(ms),
               per_worker={w: dict(batches=v["dispatches"],
                                   busy_ms=v["busy_s"] * 1e3,
                                   reserved_mb=grown[int(w)])
                           for w, v in snap["workers"]["per_worker"].items()},
               launches=counts, dispatches=dispatches, profile=prof)
    log(f"pool n={n}: {POOL_ROUNDS} rounds of 8 + 2 trunk images, ms per "
        f"round median {med:.1f} (min {min(ms):.1f}, max {max(ms):.1f}), "
        f"{row['images_per_s']:.2f} images/s ({10 * POOL_ROUNDS} images "
        f"over {sum(ms):.1f} ms); per worker "
        + "; ".join(f"worker{w}: {v['batches']} batches, busy "
                    f"{v['busy_ms']:.1f} ms, captures reserved "
                    f"{v['reserved_mb']:.1f} MB"
                    for w, v in row["per_worker"].items())
        + f"; checks {errs}")
    if prof is None:
        log(f"pool n={n} profile: the profiler saw no device kernel")
    else:
        log(f"pool n={n} profile of one more round: wall "
            f"{prof['wall_ms']:.1f} ms, {prof['kernels']} device kernels, "
            f"their sum {prof['kernel_sum_ms']:.2f} ms, device busy (union) "
            f"{prof['busy_ms']:.2f} ms, overlap {prof['overlap']:.3f}, idle "
            f"share {prof['idle_share']:.3f}")
    return row, errs


def cold_race(trunk, imgs, ref, per_fwd: dict, graphs: int) -> dict:
    """A fresh pool of two thread workers takes its first round cold:
    bucket 8 and bucket 2 submitted together, so that each worker runs its
    key eagerly and captures it while the other does the same on its own
    stream (memos built, weights uploaded, graphs captured at once). A
    second round replays. Both rounds' answers must be bit-equal to
    ``"torch-cpu"`` and request 0 to ``TRUNK_DIGEST``; bucket 8 on worker 0
    and bucket 2 on worker 1, each capture-log key once in its owner's
    scope; each round's launches and dispatches those of two forwards; no
    worker's executor raised."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serve.engine import VTAServeEngine
    from repro_torch.serve.workers import WorkerPool
    from repro_torch.vta import fsim_torch
    models = {TRUNK: trunk}
    pool = WorkerPool(models, 2, transport="thread")
    raised: list = []
    for w in pool.workers:
        def watch(key, images, bucket, _inner=w.executor, _wid=w.id):
            try:
                return _inner(key, images, bucket)
            except Exception as e:                      # noqa: BLE001
                raised.append(f"worker{_wid} bucket {bucket}: "
                              f"{type(e).__name__}: {e}")
                log("".join(traceback.format_exception(e)))
                raise
        w.executor = watch
    eng = VTAServeEngine(models, buckets=(2, 8), workers=pool)
    rounds = []
    try:
        fsim_torch.reset_capture_log()
        for _ in range(2):
            reset_launch_counts()
            fsim_torch.reset_kernel_launch_log()
            results, secs = burst(eng, imgs, 1)
            rounds.append((results, launch_counts(),
                           fsim_torch.kernel_launch_log(), secs[0]))
        owners = {b: pool.affinity.get((TRUNK, b)) for b in (8, 2)}
        log_ = fsim_torch.capture_log()
    finally:
        eng.close()
    results = rounds[0][0] + rounds[1][0]
    errs = {"race.outputs": served_errors(results, ref) + abs(
                len(results) - 20),
            "race.digest": int(results[0][0] != 0 or hashlib.sha256(
                results[0][1].tobytes()).hexdigest() != TRUNK_DIGEST),
            "race.raised": len(raised),
            "race.affinity": int(owners != {8: 0, 2: 1}),
            "race.captures": capture_errors(
                log_, owner_scopes(pool, {8: 0, 2: 1}), graphs),
            "race.launches": sum(
                sum(c.get(k, 0) != 2 * v for k, v in per_fwd.items())
                + abs(d - 2 * graphs) for _, c, d, _ in rounds)}
    log(f"cold race: bucket 8 and bucket 2 placed together on a fresh "
        f"2-worker pool, owners {owners}; cold round {rounds[0][3]:.2f} s "
        f"(eager runs and captures), replay round {rounds[1][3] * 1e3:.1f} "
        f"ms; launches per round {rounds[0][1]} then {rounds[1][1]}; "
        f"raised {raised}; checks {errs}")
    return errs


def two_pools(trunk, imgs, ref, per_fwd: dict, graphs: int) -> dict:
    """Two fresh pools of two thread workers alive at once, both cold,
    serving the trunk together: each engine takes a round (bucket 8 and
    bucket 2) and the two are drained at once from two threads, so that
    four workers run eagerly and capture together, each on a stream of the
    process's registry (``fsim_torch.claim_stream``); then a replayed
    round. ``cold_race``'s checks over both pools: every answer bit-equal
    to ``"torch-cpu"`` and each engine's request 0 to ``TRUNK_DIGEST``; no
    worker's executor raising; bucket 8 on worker 0 and bucket 2 on worker
    1 in each pool; each capture-log key once per pool, in its owner's
    scope (``pool<k>.worker<id>``: no plan is shared across pools); each
    round's launches and dispatches those of four forwards. Besides, the
    four workers' streams differ and none is the default stream. Then the
    first pool shuts down, and the second takes one more round alone: it
    must replay, bit-exact, with no new capture (the first pool's
    ``shutdown`` released only its own scopes)."""
    import threading
    import torch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serve.engine import VTAServeEngine
    from repro_torch.serve.workers import WorkerPool
    from repro_torch.vta import fsim_torch
    models = {TRUNK: trunk}
    raised: list = []
    pools, engines = [], []
    for p in range(2):
        pool = WorkerPool(models, 2, transport="thread")
        for w in pool.workers:
            def watch(key, images, bucket, _inner=w.executor, _tag=f"pool{p}."
                      f"worker{w.id}"):
                try:
                    return _inner(key, images, bucket)
                except Exception as e:                  # noqa: BLE001
                    raised.append(f"{_tag} bucket {bucket}: "
                                  f"{type(e).__name__}: {e}")
                    log("".join(traceback.format_exception(e)))
                    raise
            w.executor = watch
        pools.append(pool)
        engines.append(VTAServeEngine(models, buckets=(2, 8), workers=pool))
    streams = [w.stream.cuda_stream for p in pools for w in p.workers]
    rounds = []
    try:
        fsim_torch.reset_capture_log()
        for _ in range(2):
            reset_launch_counts()
            fsim_torch.reset_kernel_launch_log()
            t0 = time.perf_counter()
            tks = [[(i, eng.submit("t0", TRUNK, imgs[i]))
                    for i in round_images(0)] for eng in engines]
            drains = [threading.Thread(target=eng.drain) for eng in engines]
            for th in drains:
                th.start()
            for th in drains:
                th.join(timeout=600)
            secs = time.perf_counter() - t0
            rounds.append(([[(i, t.result(timeout=0)) for i, t in ts]
                            for ts in tks], launch_counts(),
                           fsim_torch.kernel_launch_log(), secs,
                           sum(th.is_alive() for th in drains)))
        owners = [{b: p.affinity.get((TRUNK, b)) for b in (8, 2)}
                  for p in pools]
        log_ = fsim_torch.capture_log()
        engines[0].close()
        fsim_torch.reset_capture_log()
        tks = [(i, engines[1].submit("t0", TRUNK, imgs[i]))
               for i in round_images(0)]
        engines[1].drain()
        after = [(i, t.result(timeout=0)) for i, t in tks]
        recaptured = sum(fsim_torch.capture_log().values())
    finally:
        for eng in engines:
            eng.close()
    answers = [r for rnd in rounds for per_eng in rnd[0] for r in per_eng]
    default = torch.cuda.default_stream().cuda_stream
    errs = {"pools2.outputs": served_errors(answers, ref) + abs(
                len(answers) - 40),
            "pools2.digest": sum(
                per_eng[0][0] != 0 or hashlib.sha256(
                    per_eng[0][1].tobytes()).hexdigest() != TRUNK_DIGEST
                for rnd in rounds for per_eng in rnd[0]),
            "pools2.raised": len(raised) + sum(r[4] for r in rounds),
            "pools2.affinity": sum(o != {8: 0, 2: 1} for o in owners),
            "pools2.captures": capture_errors(log_, set().union(*(
                owner_scopes(p, {8: 0, 2: 1}) for p in pools)), graphs),
            "pools2.after_shutdown": recaptured + served_errors(after, ref)
            + abs(len(after) - 10),
            "pools2.launches": sum(
                sum(c.get(k, 0) != 4 * v for k, v in per_fwd.items())
                + abs(d - 4 * graphs) for _, c, d, _, _ in rounds),
            "pools2.streams": len(streams) - len(set(streams)) + sum(
                s == default for s in streams)}
    log(f"two pools: two fresh 2-worker pools take a round each at once, "
        f"cold, owners {owners}, worker streams {streams}; cold round "
        f"{rounds[0][3]:.2f} s, replay round {rounds[1][3] * 1e3:.1f} ms; "
        f"launches per round {rounds[0][1]} then {rounds[1][1]}; after the "
        f"first pool's shutdown the second's round captured {recaptured}; "
        f"raised {raised}; checks {errs}")
    return errs


def death_drill(trunk, imgs, ref, graphs: int) -> dict:
    """Two thread workers on the trunk; a seeded ``worker.die`` on worker 1
    at its dispatch ``DEATH_AFTER + 1`` (warm-up included). Every ticket
    must resolve ok and bit-exact, worker 1's bucket move to worker 0,
    which captures it once in its own scope."""
    from repro_torch.serve.engine import VTAServeEngine
    from repro_torch.serve.faults import FaultInjector, FaultPlan, FaultSpec
    from repro_torch.serve.workers import WorkerPool
    from repro_torch.vta import fsim_torch
    inj = FaultInjector(FaultPlan(seed=20, specs=(
        FaultSpec("worker.die", key="1", after=DEATH_AFTER, times=1),)))
    models = {TRUNK: trunk}
    pool = WorkerPool(models, 2, transport="thread", faults=inj)
    eng = VTAServeEngine(models, buckets=(2, 8), workers=pool, faults=inj)
    errs = {}
    try:
        fsim_torch.reset_capture_log()
        warm, _ = warm_pool(eng, pool, imgs)
        results, _ = burst(eng, imgs, DRILL_ROUNDS)
        snap = eng.metrics.snapshot()
        errs["drill.outputs"] = served_errors(warm + results, ref) + abs(
            len(warm + results) - 10 * (DRILL_ROUNDS + 1))
        errs["drill.death"] = int(
            [e["site"] for e in inj.events()] != ["worker.die"]
            or pool.workers[1].live or not pool.workers[0].live
            or snap["workers"]["per_worker"]["1"]["deaths"] != 1
            or snap["workers"]["affinity"]["reassigned"] != 1)
        log_ = fsim_torch.capture_log()
        w0, w1 = (w.scope for w in pool.workers)
        errs["drill.captures"] = capture_errors(
            {k: v for k, v in log_.items() if k[4] == w1},
            owner_scopes(pool, {2: 1}), graphs) + capture_errors(
            {k: v for k, v in log_.items() if k[4] == w0},
            owner_scopes(pool, {8: 0, 2: 0}), graphs) + int(
            pool.affinity != {(TRUNK, 8): 0, (TRUNK, 2): 0})
    finally:
        eng.close()
    log(f"worker-death drill: worker 1 died at its dispatch "
        f"{DEATH_AFTER + 1}, {10 * (DRILL_ROUNDS + 1)} tickets, affinity "
        f"after {pool.affinity_map()}, events {inj.events()}; checks {errs}")
    return errs


def ladder_drill(small) -> dict:
    """resnet18-small on one inline worker, FakeClock: a ``kernel.impl``
    fault keyed ``gemm:cuda`` fires 3 times with ``fail_threshold=2`` and
    ``cooldown_s=0.5``, the clock 0.3 s on after each batch. The batches
    must move down to ``"torch-cpu"`` and back (``LADDER_SERVED``), stay
    bit-exact, every step down counted in ``fallbacks``; the ``"torch"``
    rung's log must run closed->open, open->half_open, ... half_open->closed."""
    from repro_torch.serve.breaker import DegradingBackendExecutor
    from repro_torch.serve.clock import FakeClock
    from repro_torch.serve.engine import VTAServeEngine
    from repro_torch.serve.faults import FaultInjector, FaultPlan, FaultSpec
    from repro_torch.serve.metrics import ServeMetrics
    from repro_torch.serve.workers import WorkerPool
    from repro_torch.vta.backend import DEGRADATION_LADDER
    clock, metrics = FakeClock(), ServeMetrics()
    inj = FaultInjector(FaultPlan(seed=4, specs=(
        FaultSpec("kernel.impl", key="gemm:cuda", times=3),)), clock=clock)
    models = {SMALL: small}
    pool = WorkerPool(models, 1, transport="inline", clock=clock, faults=inj,
                      metrics=metrics,
                      executor_factory=lambda wid: DegradingBackendExecutor(
                          models, DEGRADATION_LADDER, clock=clock,
                          faults=inj, metrics=metrics, fail_threshold=2,
                          cooldown_s=0.5, key_prefix=f"w{wid}:"))
    served: list = []
    for rung in pool.workers[0].executor.rungs:
        def record(key, images, bucket, _inner=rung.executor, _name=rung.name):
            out = _inner(key, images, bucket)
            served.append(_name)
            return out
        rung.executor = record
    seen: dict = {}
    spy_streams(pool, seen)
    eng = VTAServeEngine(models, clock=clock, buckets=(SMALL_BUCKET,),
                         workers=pool, metrics=metrics, faults=inj)
    imgs = small.random_images(SMALL_BUCKET, seed=0)
    ref = small.run_batch(imgs, "torch-cpu")
    results = []
    try:
        for _ in range(LADDER_DISPATCHES):
            tks = [(i, eng.submit("t1", SMALL, img))
                   for i, img in enumerate(imgs)]
            eng.drain()
            clock.advance(0.3)
            results += [(i, t.result(timeout=0)) for i, t in tks]
    finally:
        eng.close()
    log_ = pool.workers[0].executor.breaker_log()["torch"]
    want = ["closed->open", "open->half_open", "half_open->closed"]
    it = iter(log_)
    errs = {"ladder.outputs": served_errors(results, ref) + abs(
                len(results) - SMALL_BUCKET * LADDER_DISPATCHES),
            "ladder.rungs": int(tuple(served) != LADDER_SERVED),
            "ladder.fallbacks": int(metrics.fallbacks != {
                "torch-cpu": sum(s != "torch" for s in served)}),
            "ladder.breaker": int(not all(w in it for w in want)
                                  or log_[-1] != "half_open->closed"),
            "ladder.stream": stream_errors(pool, seen),
            "ladder.card_error": card_error_errors(models)}
    log(f"ladder drill: rungs served {served}; fallbacks "
        f"{metrics.fallbacks}; torch rung log {log_}; faults "
        f"{inj.summary()}; checks {errs}")
    return errs


def card_error_errors(models: dict) -> int:
    """A fault of the card that is not injected (here the error a kernel
    that fails to launch raises) must leave the ladder as it is: raised to
    the caller, no step down counted, no breaker moved. Counts what
    failed."""
    from repro_torch.serve.breaker import DegradingBackendExecutor
    from repro_torch.serve.clock import FakeClock
    from repro_torch.serve.metrics import ServeMetrics
    from repro_torch.vta.backend import DEGRADATION_LADDER
    metrics = ServeMetrics()
    ladder = DegradingBackendExecutor(models, DEGRADATION_LADDER,
                                      clock=FakeClock(), metrics=metrics,
                                      fail_threshold=1)

    def launch_fails(key, images, bucket):
        raise RuntimeError("gemm: CUDA error 700 at launch")
    ladder.rungs[0].executor = launch_fails
    img = models[SMALL].random_images(1, seed=2)
    try:
        ladder(SMALL, [img[0]], SMALL_BUCKET)
        raised = False
    except RuntimeError as e:
        raised = "CUDA error 700" in str(e)
    bad = int(not raised) + int(bool(metrics.fallbacks)) + len(
        metrics.breaker_log)
    log(f"card error on the torch rung: raised {raised}, fallbacks "
        f"{metrics.fallbacks}, breaker log {ladder.breaker_log()}")
    return bad


def process_check(small) -> dict:
    """One spawned worker (``transport="process"``, backend ``"torch"``) on
    resnet18-small from the registry: its answers bit-equal to
    ``"torch-cpu"``, and the child's own report of its device."""
    import torch
    from repro_torch.serve.engine import VTAServeEngine
    from repro_torch.serve.workers import WorkerPool
    pool = WorkerPool(n=1, transport="process", backend="torch",
                      process_specs={SMALL: ("resnet18", "small")})
    eng = VTAServeEngine({SMALL: small}, buckets=(SMALL_BUCKET,),
                         workers=pool)
    imgs = small.random_images(SMALL_BUCKET, seed=1)
    try:
        t0 = time.perf_counter()
        tks = [(i, eng.submit("t1", SMALL, img)) for i, img in enumerate(imgs)]
        eng.drain()
        results = [(i, t.result(timeout=300)) for i, t in tks]
        secs = time.perf_counter() - t0
        about = pool.workers[0].executor.describe()
    finally:
        eng.close()
    errs = {"process.outputs": served_errors(
                results, small.run_batch(imgs, "torch-cpu")),
            "process.device": int(
                about["device_name"] != torch.cuda.get_device_name(0)
                or about["pid"] == os.getpid())}
    log(f"process transport: child {about}, first batch (spawn, build, "
        f"capture) {secs:.1f} s; checks {errs}")
    return errs


def two_tenants(models: dict, imgs: dict, refs: dict, per_fwd: dict,
                graphs: dict) -> tuple:
    """The two full-width trunks, each a tenant of its own, on one pool of
    two thread workers (the JAX package's ``bench_serve`` scale-out with
    its two tenants): each (model, bucket)'s first dispatch alone, bucket 8
    then 2 of the ResNet trunk and then of MobileNet (cold placement gives
    both bucket 8s to worker 0 and both bucket 2s to worker 1), then
    ``TENANT_ROUNDS`` rounds of ``round_images`` of both tenants, drained
    together, with launch counts, dispatches and metrics zeroed just before
    and read just after. Checks, each a count of what failed: every answer
    equal to ``"torch-cpu"`` and each tenant's request 0 to its digest;
    the affinity map sticky by (model, bucket), hit rate 1.0, nothing
    reassigned; each model's capture-log keys once, in the scope of its
    bucket's owner, none during the rounds; launches and dispatches those
    of two forwards of each model a round. Returns (row, errors)."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serve.engine import VTAServeEngine
    from repro_torch.serve.workers import WorkerPool
    from repro_torch.vta import fsim_torch
    pool = WorkerPool(models, 2, transport="thread")
    eng = VTAServeEngine(models, buckets=(2, 8), workers=pool)

    def answers(idx: dict) -> list:
        tks = [(k, i, eng.submit(k, k, imgs[k][i]))
               for k in models for i in idx[k]]
        eng.drain()
        return [(k, i, t.result(timeout=0)) for k, i, t in tks]
    try:
        fsim_torch.reset_capture_log()
        warm = []
        for key in models:
            for b in (8, 2):
                warm += answers({k: range(b) if k == key else ()
                                 for k in models})
        warm_log = fsim_torch.capture_log()
        metrics = eng.reset_metrics()
        reset_launch_counts()
        fsim_torch.reset_kernel_launch_log()
        results, secs = [], []
        for r in range(TENANT_ROUNDS):
            t0 = time.perf_counter()
            results += answers({k: round_images(r) for k in models})
            secs.append(time.perf_counter() - t0)
        counts = launch_counts()
        dispatches = fsim_torch.kernel_launch_log()
        snap = metrics.snapshot()
        captured = fsim_torch.capture_log()
        owners = dict(pool.affinity)
    finally:
        eng.close()
    want = {(k, b): w for k in models for b, w in ((8, 0), (2, 1))}
    keys = {k: trace_keys(m) for k, m in models.items()}
    firsts = {}
    for k, i, o in results:
        firsts.setdefault(k, (i, hashlib.sha256(o.tobytes()).hexdigest()))
    fwd = 2 * TENANT_ROUNDS
    errs = {"tenants.outputs": sum(
                o.dtype != np.int8 or not np.array_equal(o, refs[k][i])
                for k, i, o in warm + results) + abs(
                len(results) - 10 * TENANT_ROUNDS * len(models)),
            "tenants.digest": sum(firsts.get(k) != (0, DIGESTS[k])
                                  for k in models),
            "tenants.affinity": int(owners != want) + int(
                snap["workers"]["affinity"]["hit_rate"] != 1.0)
            + snap["workers"]["affinity"]["reassigned"],
            "tenants.captures": sum(capture_errors(
                {s: v for s, v in warm_log.items() if s[0] in keys[key]},
                {(b, pool.workers[w].scope) for (k, b), w in want.items()
                 if k == key}, graphs[key]) for key, m in models.items())
            + int(captured != warm_log),
            "tenants.launches": sum(
                counts.get(k, 0) != fwd * sum(per_fwd[m][k] for m in models)
                for k in ("gemm", "alu_chain", "alu_sweep")) + abs(
                dispatches - fwd * sum(graphs[m] for m in models))}
    ms = [t * 1e3 for t in secs]
    row = dict(tenants=list(models), workers=2, rounds=TENANT_ROUNDS,
               images_per_round=10 * len(models),
               ms_per_round_median=statistics.median(ms),
               images_per_s=10 * len(models) * TENANT_ROUNDS * 1e3 / sum(ms),
               owners={f"{k}/{b}": w for (k, b), w in owners.items()},
               per_worker={w: dict(batches=v["dispatches"],
                                   busy_ms=v["busy_s"] * 1e3)
                           for w, v in snap["workers"]["per_worker"].items()},
               launches=counts, dispatches=dispatches)
    log(f"two tenants: {' and '.join(models)} on 2 thread workers, owners "
        f"{row['owners']}; {TENANT_ROUNDS} rounds of 8 + 2 images a tenant, "
        f"ms per round {', '.join(f'{x:.1f}' for x in ms)}, "
        f"{row['images_per_s']:.2f} images/s; per worker "
        f"{row['per_worker']}; launches {counts}; checks {errs}")
    return row, errs


def pool_checks(models: dict, route: str = "all") -> tuple:
    """Phase 6 over the models of ``serve_models`` (``route`` "pool": the
    scale-out, the cold race, the two pools, the drill and the two
    tenants; "ladder": the ladder drill; "all": both and the process
    transport). Returns (errors, rows)."""
    from repro_torch.vta.backend import get_backend
    trunk, small = models[TRUNK], models[SMALL]
    errs, rows = {}, []
    if route in ("all", "pool"):
        be = get_backend("torch")
        imgs = trunk.random_images(8, seed=0)
        ref = trunk.run_batch(imgs, "torch-cpu")
        graphs = plan_length(trunk, be)
        per_fwd = per_forward({TRUNK: trunk}, be.device)[TRUNK]
        for n in (1, 2):
            row, e = scale_out(trunk, n, imgs, ref, per_fwd, graphs)
            rows.append(row)
            errs.update({f"n{n}.{k}": v for k, v in e.items()})
        speedup = rows[1]["images_per_s"] / rows[0]["images_per_s"]
        log(f"pool: 2 workers take the burst {speedup:.3f}x as fast as 1 "
            f"(images/s {rows[1]['images_per_s']:.2f} / "
            f"{rows[0]['images_per_s']:.2f}; median ms per round "
            f"{rows[0]['ms_per_round_median']:.1f} / "
            f"{rows[1]['ms_per_round_median']:.1f})")
        rows.append(dict(speedup_2_over_1=speedup))
        errs.update(cold_race(trunk, imgs, ref, per_fwd, graphs))
        errs.update(two_pools(trunk, imgs, ref, per_fwd, graphs))
        errs.update(death_drill(trunk, imgs, ref, graphs))
        pair = {k: models[k] for k in (TRUNK, MBN)}
        t_imgs = {k: m.random_images(8, seed=0) for k, m in pair.items()}
        t_refs = {TRUNK: ref, MBN: pair[MBN].run_batch(t_imgs[MBN],
                                                       "torch-cpu")}
        row, e = two_tenants(pair, t_imgs, t_refs,
                             per_forward(pair, be.device),
                             {k: plan_length(m, be) for k, m in pair.items()})
        rows.append(row)
        errs.update(e)
    if route in ("all", "ladder"):
        errs.update(ladder_drill(small))
    if route == "all":
        errs.update(process_check(small))
    log(f"pool checks (count of what failed, 0 passes): {errs}")
    return errs, rows


# ---------------------------------------------------------------------------
# phase 7: the language-model session at full width
# ---------------------------------------------------------------------------
LM_GOLDEN = os.path.join(ROOT, "tests", "golden", "lm_session_f32.json")
LM_GOLDEN_RECURRENT = os.path.join(ROOT, "tests", "golden",
                                   "lm_session_recurrent_f32.json")
LM_GOLDEN_MOE = os.path.join(ROOT, "tests", "golden",
                             "lm_session_moe_f32.json")
LM_GOLDEN_VLM_AUDIO = os.path.join(ROOT, "tests", "golden",
                                   "lm_session_vlm_audio_f32.json")
LM_GOLDENS = (LM_GOLDEN, LM_GOLDEN_RECURRENT, LM_GOLDEN_MOE,
              LM_GOLDEN_VLM_AUDIO)
# f32 against the JAX package (CPU): |logit - golden| on the golden's 8
# largest logits of every step. Both sides are f32 (TF32 off in the
# matmuls, the prefill kernel at 3xTF32, ~2^-22 per product) summed in
# other orders, a few 1e-6 over four layers; one key missed of 64, or one
# slot written off, moves a logit by ~1e-2
LM_F32_TOL = 1e-3
# f32, the vlm runs (M-RoPE), by the same derivation: M-RoPE's height and
# width rows rotate only the slow half of each head (rope_theta 1e6), by
# at most 0.16 rad over the golden's 6 x 8 image, so M-RoPE reading row 0
# for every section moves the top logits by 7.9e-5 at full width (8.2e-5
# on the smoke config), under LM_F32_TOL, where the port lies 1.9e-6 from
# the JAX package on the CPU. Their limit is 2e-5, between the two
LM_MROPE_TOL = 2e-5
# bf16: the kernels' run against the same model on flash_attention_plain,
# teacher-forced with the kernels' tokens: per step and sequence, the norm
# of the logits' difference over the norm of the plain run's. The two
# differ in each attention output's summation order, so by one bf16 step
# (2^-8) on some elements per layer; 28 layers summed in quadrature give
# sqrt(28) * 2^-8 = 0.021 (38 layers: 0.024); the limit is 3x that
LM_BF16_TOL = 2.0 ** -4
# a model with no attention layer (RWKV-6) holds one decode step to its
# forward pass over the prompt and that token, at full width and depth in
# f32: two orders of summation, ~2e-6 relative over 4 layers and ~4e-6
# over 8 (full width, CPU). In bf16 the same pair drifts apart with depth
# (0.013 over 4 layers and 0.029 over 8 on the CPU, 0.10 over 24 on an
# H100): rounding noise through 2048 steps of a data-dependent decay,
# recorded, not held
LM_FORWARD_TOL = 1e-3
# init in the serving dtypes (``ServeSession.from_seed``): the peak of
# allocated memory over the params it leaves may be one stacked leaf's
# slice drawn in f32 (738 MB for a Moonshot expert slice), or one unsliced
# leaf of up to ``transformer.SLICE_BYTES`` in f32, and its cast: under
# 2.5 GB. Keeping the f32 tree beside its cast costs twice the params
INIT_PEAK_SLACK = 2.5e9
# bf16 at full width and depth, weights from a seeded generator on the card
LM_BF16_RUNS = (
    dict(name="qwen3-0.6b", seed=0, batch=4, prompt_len=1024, steps=32),
    dict(name="rwkv6-1.6b", seed=0, batch=4, prompt_len=2048, steps=32),
    # 2560 > the 2048 window: the window bites in prefill, and the ring of
    # every local layer wraps from the first decode step
    dict(name="recurrentgemma-9b", seed=0, batch=2, prompt_len=2560,
         steps=32),
    # 28.06 B parameters, 56.1 GB in bf16: fits one card only through the
    # init in the serving dtypes. ``exact_ties``: an argmax that differs
    # from the plain run's where one run's largest logit is held by two
    # tokens, the other run's choice one of them, is listed, not counted
    # (this run's steps 6 and 9 on the card: the kernels' 3.78125 and
    # 3.875, each held twice)
    dict(name="moonshot-v1-16b-a3b", seed=0, batch=4, prompt_len=1024,
         steps=32, exact_ties=True),
    # 1.77 B parameters, 3.5 GB: one image of 32 x 32 patches (1024
    # positions), then 1024 positions of text; each decode step fed the
    # next seeded embedding (``vlm_generate``)
    dict(name="qwen2-vl-2b", seed=0, batch=4, image=(1, 32, 32),
         prompt_len=2048, steps=32),
    # 3.3 B parameters, 6.6 GB: 4 codebooks of 1024 prompt tokens each
    # (about 20 s of audio at 50 frames a second). Its argmaxes are held in
    # 528 rows of 2048 logits near 3 in bf16, where a step is 2^-6: on the
    # card 12 rows differed from the plain run's, at an exact tie in one run
    # (8) or with the two tokens one bf16 step apart in both runs, in
    # opposite order (4), the relative error 0.0092. LM_BF16_TOL's
    # derivation takes the two runs to differ by one bf16 step on some
    # elements, so ``step_ties``: such a row is listed, not counted
    # (``step_tie``)
    dict(name="musicgen-large", seed=0, batch=4, prompt_len=1024, steps=32,
         exact_ties=True, step_ties=True),
)


def lm_golden(path: str = LM_GOLDEN) -> list:
    with open(path) as f:
        return json.load(f)["runs"]


def run_tag(run: dict) -> str:
    """A golden run's name in the checks: its config's, with ``-smoke``
    for a smoke config and ``-grad_accum<n>`` where it overrides that."""
    n = run.get("overrides", {}).get("grad_accum")
    return run["name"] + ("-smoke" if run["smoke"] else "") + (
        f"-grad_accum{n}" if n else "")


def lm_config(run: dict):
    """The port's config of a run: its name, smoke or not, with the run's
    overrides (a golden run has both keys; a serving run may give either)."""
    from repro_torch.configs import ARCHS, SMOKE_ARCHS
    return (SMOKE_ARCHS if run.get("smoke") else ARCHS)[run["name"]].replace(
        **run.get("overrides", {}))


def attention_layers(cfg) -> int:
    """The attention layers of ``cfg`` (global and local)."""
    from repro_torch.configs.base import ATTN_GLOBAL, ATTN_LOCAL
    return sum(k in (ATTN_GLOBAL, ATTN_LOCAL) for k in cfg.layer_kinds)


def f32_cast_errors(params, cfg) -> int:
    """Weights the reference reads in f32 (``transformer._read_in_f32``:
    norms, router, codebook embeddings, RWKV-6's decay weights, bonus and
    group-norm affine, the RG-LRU's gates and Lambda) that a session's
    params hold in another dtype."""
    import torch
    from repro_torch.models.transformer import _read_in_f32

    def walk(tree, path):
        if isinstance(tree, dict):
            return sum(walk(v, path + (k,)) for k, v in tree.items())
        return int(_read_in_f32(path, cfg) and tree.dtype != torch.float32)
    return walk(params, ())


def logit_rows(logits):
    """A step's logits as rows of the vocabulary, in f32: (B, V), or (B *
    K, V) for a model of K codebooks, one row per sequence and codebook
    (as ``tests/make_lm_golden.py`` keeps them)."""
    return logits.reshape(-1, logits.shape[-1]).float()


def record_steps(sess, times: list = None) -> list:
    """Wrap ``sess``'s prefill and decode steps: each step's logits
    (``logit_rows``) go into the returned list; with ``times``, each step
    is also timed on the host clock, from a synchronize before it to one
    after it (seconds)."""
    import torch
    seen = []

    def keep(step):
        def wrapped(*args):
            if times is not None:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            out = step(*args)
            if times is not None:
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
            seen.append(logit_rows(out[0]))
            return out
        return wrapped
    sess._prefill, sess._decode = keep(sess._prefill), keep(sess._decode)
    return seen


def image_text_positions(batch: int, image: tuple, length: int):
    """M-RoPE positions (3, batch, length), int32, as Qwen2-VL lays out one
    image of ``image`` = (t, h, w) patches followed by text: patch (i, j,
    k) at (i, j, k), then the text on all three rows from the largest
    image position + 1 (``tests/make_lm_golden.py`` lays out its vlm runs
    the same way and records the result)."""
    grid = np.stack([g.ravel() for g in np.meshgrid(
        *(np.arange(n) for n in image), indexing="ij")])
    start = int(grid.max()) + 1
    text = np.arange(start, start + length - grid.shape[1])
    pos = np.concatenate([grid, np.broadcast_to(text, (3, text.size))], 1)
    return np.ascontiguousarray(np.broadcast_to(
        pos[:, None], (3, batch, length)), dtype=np.int32)


def vlm_generate(sess, embeds, positions, steps: int):
    """The vlm family's generation on ``sess``'s prefill and decode steps
    (``make_prefill_step``, ``make_decode_step``; ``generate`` takes
    tokens only), teacher-forced: the prefill of the first S of
    ``embeds`` (B, S + steps, d) at ``positions`` (3, B, S), then
    ``steps`` decode steps, each fed the next embedding at position S +
    step (the reference's ``decode_step`` gives it all three M-RoPE
    rows). Returns the greedy token of each step's logits but the last,
    (B, steps), as ``tests/make_lm_golden.py::vlm_generate``."""
    import torch
    from repro_torch.serve.session import greedy_token
    S = positions.shape[-1]
    with torch.inference_mode():
        logits, caches = sess._prefill(sess.params, {
            "embeds": embeds[:, :S], "positions": positions})
        out = []
        for step in range(steps):
            out.append(greedy_token(logits).reshape(logits.shape[0], -1))
            logits, caches = sess._decode(
                sess.params, {"embeds": embeds[:, S + step:S + step + 1]},
                caches, S + step)
    return torch.cat(out, dim=-1)


def lm_launches_want(n_layers: int, dtype: str, prompt_len: int,
                     steps: int) -> dict:
    """The attention launches of one ``generate`` over ``n_layers``
    attention layers: each layer's prefill on its route, each layer's
    decode step on the decode route and its combine."""
    import torch
    from repro_torch.kernels.flash_attention import ROUTES, attention_route
    route = attention_route(getattr(torch, dtype), prompt_len)
    want = {f"flash_attention.{r}": 0 for r in ROUTES}
    want[f"flash_attention.{route}"] += n_layers
    want["flash_attention.decode"] += n_layers * steps
    want["flash_attention_combine"] = n_layers * steps
    want["flash_attention"] = n_layers * (1 + steps)
    return want


def golden_errors(run: dict, device) -> tuple:
    """One run of the golden file (``tests/make_lm_golden.py``: the JAX
    package's ``ServeSession`` in f32 on the CPU) through the port's
    ``ServeSession`` on ``device``, its attention on the port's kernels
    (on the card; the plain version on the CPU), weights from
    ``numpy_params`` with the golden's seed. A vlm run is fed the
    golden's embeddings (numpy's draws from its ``embed_seed``) and
    positions through ``vlm_generate``; the others their prompts through
    ``generate``. Counts, each 0 to pass: weights (and a vlm run's
    embeddings) whose sha256 is not the golden's, tokens that differ,
    logits at the golden's top 8 of every row (a sequence, or a sequence
    and codebook: ``logit_rows``) more than ``LM_F32_TOL`` away
    (``LM_MROPE_TOL`` for a model with M-RoPE), and on the
    card attention launches other than ``lm_launches_want``. A step whose
    golden top-1 margin is under that limit in some row is reported;
    its token and all after it are not compared (a tie may break either
    way), nor are the logits after it. ``weights`` also counts the weights
    the reference reads in f32 that the session holds in another dtype
    (``f32_cast_errors``). Returns (errors, row)."""
    import torch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import build_model
    from repro_torch.models.convert import (numpy_params, params_from_numpy,
                                            tree_sha256)
    from repro_torch.serve.session import ServeSession
    cfg = lm_config(run)
    weights = numpy_params(cfg, run["seed"])
    errs = {"weights": int(tree_sha256(weights) != run["weights_sha256"])}
    sess = ServeSession(build_model(cfg), params_from_numpy(weights, device),
                        device=device)
    del weights
    errs["weights"] += f32_cast_errors(sess.params, cfg)
    if cfg.family == "vlm":
        embeds = np.random.default_rng(run["embed_seed"]).standard_normal(
            (run["batch"], run["prompt_len"] + run["steps"], cfg.d_model),
            dtype=np.float32)
        errs["weights"] += int(tree_sha256(embeds) != run["embeds_sha256"])
        embeds = torch.as_tensor(embeds, device=device)
        positions = torch.as_tensor(np.array(run["positions"], np.int32),
                                    device=device)
    seen = record_steps(sess)
    reset_launch_counts()
    t0 = time.perf_counter()
    if cfg.family == "vlm":
        got = vlm_generate(sess, embeds, positions, run["steps"])
    else:
        got = sess.generate(np.array(run["prompts"], np.int32), run["steps"])
    got = got.cpu().numpy()
    secs = time.perf_counter() - t0
    counts = launch_counts()
    limit = LM_MROPE_TOL if cfg.mrope_sections else LM_F32_TOL
    low = [s for s, top in enumerate(run["top"])
           if min(v[0] - v[1] for v in top["value"]) < limit]
    upto = min(low, default=len(run["top"]) - 1)
    worst, over = 0.0, 0
    for logits, top in list(zip(seen, run["top"]))[:upto + 1]:
        idx = torch.tensor(top["index"], device=logits.device)
        err = np.abs(logits.gather(1, idx).cpu().numpy()
                     - np.array(top["value"], np.float32))
        worst, over = max(worst, float(err.max())), over + int(
            (err > limit).sum())
    want_tokens = np.array(run["tokens"])
    cols = upto * max(1, cfg.n_codebooks)      # a step's tokens, step-major
    errs["tokens"] = int(got.shape != want_tokens.shape) or int(
        (got[:, :cols] != want_tokens[:, :cols]).sum())
    errs["logits"] = over + int(len(seen) != len(run["top"]))
    want = lm_launches_want(attention_layers(cfg), cfg.dtype,
                            run["prompt_len"], run["steps"])
    if torch.device(device).type == "cuda":
        errs["launches"] = sum(counts.get(k, 0) != v for k, v in want.items())
    row = dict(config=cfg.name, layers=cfg.n_layers, d_model=cfg.d_model,
               batch=run["batch"], prompt_len=run["prompt_len"],
               steps=run["steps"], max_err=worst, limit=limit,
               low_margin_steps=low, tokens_compared=upto, seconds=secs,
               launches={k: counts.get(k, 0) for k in want})
    if "router_margin" in run:
        row["router_margin"] = run["router_margin"]
    return errs, row


def profiled_shares(fn) -> dict:
    """``fn()`` once on the host clock, then once more under
    ``torch.profiler``: the device kernels' summed time and their union
    (busy), attention's share of the summed time (kernels named
    ``flash_*``), the idle share (1 - busy over wall) against the profiled
    wall and against the unprofiled one (the profiler slows the host), the
    five kernels that take the most time, and the attention backward's
    device time and share of the summed time: the kernels that start
    inside the device spans of the attention backward's profiler range
    ``BACKWARD_RANGE`` (0 where no backward ran). None where the profiler
    saw no device kernel."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels.flash_attention import BACKWARD_RANGE
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    plain_wall = (time.perf_counter() - t0) * 1e6
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e6
    # the range's own device spans are annotations, not kernels
    spans = [x for x in kernel_spans(prof) if x[2] != BACKWARD_RANGE]
    if not spans:
        return None
    union = spans_union(spans)
    total = sum(b - a for a, b, _ in spans)
    attn = sum(b - a for a, b, n in spans if "flash_" in n)
    ranges = [(e.time_range.start, e.time_range.end) for e in prof.events()
              if e.name == BACKWARD_RANGE
              and e.device_type == DeviceType.CUDA]
    backward = sum(b - a for a, b, _ in spans
                   if any(lo <= a <= hi for lo, hi in ranges))
    by_name: dict = {}
    for a, b, n in spans:
        t, c = by_name.get(n, (0, 0))
        by_name[n] = (t + b - a, c + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:5]
    return dict(wall_ms=wall / 1e3, wall_unprofiled_ms=plain_wall / 1e3,
                kernels=len(spans), kernel_sum_ms=total / 1e3,
                busy_ms=union / 1e3, attention_ms=attn / 1e3,
                attention_share=attn / total, idle_share=1 - union / wall,
                idle_share_unprofiled=max(0.0, 1 - union / plain_wall),
                top=[dict(kernel=n[:80], ms=t / 1e3, count=c)
                     for n, (t, c) in top],
                attention_backward_ms=backward / 1e3,
                attention_backward_share=backward / total)


def exact_tie(g, r) -> bool:
    """Whether two logits rows ``g`` and ``r`` whose first argmaxes differ
    agree on a greedy choice all the same: one row's largest logit is held
    by several tokens, the other row's argmax among them. ``argmax`` then
    takes the lower index of an exact tie, a choice the numerics did not
    make."""
    i, j = int(g.argmax()), int(r.argmax())
    return bool(g[j] == g[i]) or bool(r[i] == r[j])


def bf16_step(x: float) -> float:
    """The distance between bf16 values at the magnitude of ``x`` (8
    significant bits)."""
    return 2.0 ** (math.frexp(abs(x))[1] - 8) if x else 0.0


def step_tie(g, r) -> bool:
    """Whether two logits rows ``g`` and ``r`` whose first argmaxes i and
    j differ hold the two tokens at most one bf16 step apart in each row:
    an order one bf16 step of difference between the runs can reverse."""
    i, j = int(g.argmax()), int(r.argmax())
    return all(abs(float(x[i]) - float(x[j]))
               <= bf16_step(max(abs(float(x[i])), abs(float(x[j]))))
               for x in (g, r))


def segments() -> int:
    """The caching allocator's ``cudaMalloc`` calls so far."""
    import torch
    return torch.cuda.memory_stats().get("segment.all.allocated", 0)


def warm_prefill(sess, generate) -> dict:
    """One uncounted ``generate(1)``, a generation of one step through
    ``sess`` at the shape the run then times, so that the caching
    allocator's ``cudaMalloc`` calls for that shape fall here: its prefill
    on the host clock between synchronizes and the ``cudaMalloc`` calls of
    the generation."""
    import torch
    steps, times = (sess._prefill, sess._decode), []
    record_steps(sess, times)
    torch.cuda.synchronize()
    before = segments()
    generate(1)
    torch.cuda.synchronize()
    sess._prefill, sess._decode = steps
    return dict(warmup_prefill_ms=times[0] * 1e3,
                warmup_segments=segments() - before)


def rel_err(got, ref) -> float:
    """The largest, over sequences, norm of got - ref over the norm of ref
    (logits (B, V))."""
    return float(((got - ref).norm(dim=-1) / ref.norm(dim=-1)).max())


def decode_and_forward(model, params, prompts, tok) -> tuple:
    """(logits of one decode step of ``tok`` after a prefill of
    ``prompts``, logits of the forward pass over ``prompts`` and ``tok`` at
    its last position), each (B, V) in f32."""
    import torch
    B, S = prompts.shape
    with torch.inference_mode():
        _, caches = model.prefill(params, {"tokens": prompts}, last_only=True)
        got = model.decode(params, {"tokens": tok}, caches, S)[0]
        del caches
        ref = model.prefill(params, {"tokens": torch.cat([prompts, tok], 1)},
                            last_only=True)[0]
    return got.reshape(B, -1).float(), ref.reshape(B, -1).float()


def tree_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    return tree.numel() * tree.element_size()


def init_session(model, seed: int, device) -> tuple:
    """``ServeSession.from_seed(model, seed)`` on ``device``: the params
    drawn from a seeded generator on the card straight in their serving
    dtypes. Returns (session, memory: the params' MB, the MB init leaves
    allocated and the peak it allocated, both above what was allocated
    before, errors: ``init_peak`` the peak above what init holds plus
    ``INIT_PEAK_SLACK``, ``freed`` what it holds above the params plus 64
    MB, ``cast`` the weights the reference reads in f32 held in another
    dtype (``f32_cast_errors``))."""
    import torch
    from repro_torch.serve.session import ServeSession
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sess = ServeSession.from_seed(model, seed, device=device)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    peak, held = torch.cuda.max_memory_allocated() - base, \
        torch.cuda.memory_allocated() - base
    weights = tree_bytes(sess.params)
    errs = {"init_peak": int(peak > held + INIT_PEAK_SLACK),
            "freed": int(held > weights + (64 << 20)),
            "cast": f32_cast_errors(sess.params, model.cfg)}
    return sess, dict(params_mb=weights / 1e6, held_mb=held / 1e6,
                      peak_allocated_mb=peak / 1e6, init_s=secs), errs


@contextlib.contextmanager
def routing(kept: list, differ: list = None):
    """``repro_torch.models.moe.top_k`` wrapped for the block: without
    ``differ``, each call's expert indices appended to ``kept``; with it,
    each call answers the next indices of ``kept`` (and the probabilities
    at them) and appends to ``differ`` how many of its own top-k choices
    are not among them (a tensor, summed over the tokens)."""
    import torch
    from repro_torch.models import moe
    real = moe.top_k
    nxt = iter(kept)

    def top_k(x, k):
        vals, idx = real(x, k)
        if differ is None:
            kept.append(idx)
            return vals, idx
        want = next(nxt)
        differ.append((idx[..., :, None] != want[..., None, :]).all(-1)
                      .sum())
        return torch.gather(x, -1, want), want
    moe.top_k = top_k
    try:
        yield
    finally:
        moe.top_k = real


def lm_bf16(device, spec: dict) -> tuple:
    """One run of ``LM_BF16_RUNS``: the model at full width and depth in
    its own dtype (bf16 activations; params drawn from a seeded generator
    on the card straight in their serving dtypes, ``init_session``: the
    peak of init within ``INIT_PEAK_SLACK`` of what it holds, and that the
    params' size), ``batch`` prompts of ``prompt_len`` seeded tokens (of
    each of a codebook model's K codebooks), ``steps`` greedy steps
    through ``ServeSession``, after one short warm-up generation and one
    at the timed shape (``warm_prefill``; the timed run's ``cudaMalloc``
    calls recorded). A vlm run takes embeddings drawn on the card from
    the seed, at the positions of one image of ``image`` patches then
    text (``image_text_positions``), through ``vlm_generate``,
    teacher-forced.
    Launch counts are zeroed just before the run and read just after
    (``lm_launches_want``). Each step is timed (``record_steps``); then
    one prefill and 8 decode steps run under ``torch.profiler``
    (``profiled_shares``). A model with attention layers then runs again on
    ``flash_attention_plain``, fed the kernels' tokens (a MoE model also
    the kernels' run's routing, ``routing``: a bf16 step apart can send a
    token to another expert, a jump no tolerance bounds; the choices the
    plain run would have made otherwise are counted, not held), and each
    step's logits are held to ``LM_BF16_TOL``, every argmax equal (each
    row of ``logit_rows``: per codebook for a codebook model); a run
    with ``exact_ties`` lists, and does not count, an argmax that differs
    at an exact tie (``exact_tie``), one with ``step_ties`` one that
    differs where both runs hold the two tokens within one bf16 step
    (``step_tie``). One without
    (RWKV-6) holds a decode step of its first token to its forward pass
    over the prompt and that token, in f32 at full width and depth (the
    same seed's weights), within ``LM_FORWARD_TOL``, the argmaxes equal;
    the bf16 pair's gap is recorded. Returns (errors, row)."""
    import torch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import build_model
    cfg = lm_config(spec)
    B, S, steps = (spec[k] for k in ("batch", "prompt_len", "steps"))
    tag = f"bf16.{cfg.name}"
    n_attn = attention_layers(cfg)
    moe = cfg.family == "moe"
    K = max(1, cfg.n_codebooks)
    model = build_model(cfg)
    sess, mem, init_errs = init_session(model, spec["seed"], device)
    params = sess.params
    if cfg.family == "vlm":
        gen = torch.Generator(device=device).manual_seed(spec["seed"])
        embeds = torch.randn((B, S + steps, cfg.d_model), generator=gen,
                             device=device)
        positions = torch.as_tensor(image_text_positions(
            B, spec["image"], S), device=device)
        batch = {"embeds": embeds[:, :S], "positions": positions}

        def generate(n, upto=S):
            return vlm_generate(sess, embeds, positions[..., :upto], n)

        def step_batch(s):
            return {"embeds": embeds[:, S + s:S + s + 1]}
    else:
        prompts = np.random.default_rng(spec["seed"]).integers(
            0, cfg.vocab_size, (B, cfg.n_codebooks, S) if cfg.n_codebooks
            else (B, S), dtype=np.int32)
        batch = {"tokens": torch.as_tensor(prompts, device=device)}

        def generate(n, upto=S):
            return sess.generate(prompts[..., :upto], n)

        def step_batch(s):      # step s's tokens, (B, 1) or (B, K, 1)
            return {"tokens": toks[:, s * K:(s + 1) * K].reshape(
                (B, K, 1) if cfg.n_codebooks else (B, 1))}
    generate(2, 64)                                     # warm-up, uncounted
    warm = warm_prefill(sess, generate)
    times: list = []
    seen = record_steps(sess, times)
    kept: list = []
    before = segments()
    reset_launch_counts()
    with routing(kept) if moe else contextlib.nullcontext():
        toks = generate(steps)
    torch.cuda.synchronize()
    counts = launch_counts()
    run_segments = segments() - before
    want = lm_launches_want(n_attn, cfg.dtype, S, steps)
    errs = {f"{tag}.launches": sum(counts.get(k, 0) != v
                                   for k, v in want.items()),
            f"{tag}.shape": int(tuple(toks.shape) != (B, steps * K)
                                or len(seen) != steps + 1),
            f"{tag}.finite": sum(not bool(torch.isfinite(x).all())
                                 for x in seen),
            **{f"{tag}.{k}": v for k, v in init_errs.items()}}
    with torch.inference_mode():
        def prefill():
            return model.prefill(params, batch, last_only=True)
        _, caches = prefill()

        def decode8():
            c = caches
            for s in range(min(8, steps)):
                c = model.decode(params, step_batch(s), c, S + s)[1]
        prof = {"prefill": profiled_shares(prefill),
                "decode_8_steps": profiled_shares(decode8)}
        del caches
        differ: list = []
        if n_attn:
            compared = "flash_attention_plain" + (
                ", the kernels' routing" if moe else "")
            plain = build_model(cfg, attention="torch")
            with routing(kept, differ) if moe else contextlib.nullcontext():
                ref, caches = plain.prefill(params, batch, last_only=True)
                refs = [logit_rows(ref)]
                for s in range(steps):
                    ref, caches = plain.decode(params, step_batch(s), caches,
                                               S + s)
                    refs.append(logit_rows(ref))
            del caches
            got = seen
        else:
            # bf16: recorded; the gate runs in f32 (see LM_FORWARD_TOL)
            got, ref = decode_and_forward(model, params, batch["tokens"],
                                          toks[:, :1])
            bf16_rel = rel_err(got, ref)
            f32 = build_model(cfg.replace(dtype="float32"))
            gen = torch.Generator(device=device).manual_seed(spec["seed"])
            got, ref = decode_and_forward(f32, f32.init(gen, device),
                                          batch["tokens"], toks[:, :1])
            compared = ("forward over the prompt and the first token, in "
                        f"f32 (in bf16: {bf16_rel:.4f})")
            got, refs = [got], [ref]
    limit = LM_BF16_TOL if n_attn else LM_FORWARD_TOL
    rel = [rel_err(g, r) for g, r in zip(got, refs)]
    agree = sum(int((g.argmax(-1) == r.argmax(-1)).sum())
                for g, r in zip(got, refs))
    differ_at = []
    for step, (g, r) in enumerate(zip(got, refs)):
        ga, ra = g.argmax(-1), r.argmax(-1)
        for b in (ga != ra).nonzero().flatten().tolist():
            i, j = int(ga[b]), int(ra[b])
            differ_at.append(dict(
                step=step, seq=b // K, codebook=b % K, tokens=[i, j],
                kernels=(float(g[b, i]), float(g[b, j])),
                plain=(float(r[b, i]), float(r[b, j])),
                tie=bool(spec.get("exact_ties") and exact_tie(g[b], r[b])
                         or spec.get("step_ties") and step_tie(g[b], r[b]))))
    errs[f"{tag}.logits"] = sum(x > limit for x in rel) + sum(
        not d["tie"] for d in differ_at)
    decode_s = statistics.median(times[1:])
    row = dict(config=cfg.name, layers=cfg.n_layers, dtype=cfg.dtype,
               attention_layers=n_attn, batch=B, prompt_len=S, steps=steps,
               prefill_ms=times[0] * 1e3,
               prefill_tokens_per_s=B * S / times[0],
               decode_ms_per_step_median=decode_s * 1e3,
               decode_ms_per_step_min=min(times[1:]) * 1e3,
               decode_ms_per_step_max=max(times[1:]) * 1e3,
               decode_tokens_per_s=B / decode_s, compared_with=compared,
               rel_err_max=max(rel), rel_err_first=rel[0], limit=limit,
               argmax_agree=f"{agree}/{sum(r.shape[0] for r in refs)}",
               argmax_differ_at=differ_at, profile=prof, **mem, **warm,
               run_segments=run_segments,
               memory_reserved_mb=torch.cuda.memory_reserved() / 1e6,
               launches={k: counts.get(k, 0) for k in want})
    if moe:
        row.update(routing_calls=len(kept), routing_choices=sum(
            k.numel() for k in kept), routing_choices_differ=int(sum(
                int(d) for d in differ)))
    return errs, row


def lm_checks(device, route: str = "all") -> tuple:
    """Phase 7: every golden run of both golden files (``golden_errors``)
    then, for route "all", each bf16 run of ``LM_BF16_RUNS``
    (``lm_bf16``). Returns (errors, rows, launches: the attention launches
    summed over the runs)."""
    import torch
    errs, rows, launches = {}, [], {}
    for path in LM_GOLDENS:
        for run in lm_golden(path):
            e, row = golden_errors(run, device)
            errs.update({f"{run_tag(run)}.{k}": v for k, v in e.items()})
            rows.append(row)
            log(f"lm golden {row['config']} ({row['layers']} layers, d_model "
                f"{row['d_model']}, f32): {row['batch']} prompts of "
                f"{row['prompt_len']} tokens, {row['steps']} steps in "
                f"{row['seconds']:.2f} s; largest |logit - JAX| "
                f"{row['max_err']:.3g} (limit {row['limit']}); steps with a "
                f"top-1 margin under the limit {row['low_margin_steps']}; "
                f"launches {row['launches']}; checks {e}")
    for spec in LM_BF16_RUNS if route == "all" else ():
        gc.collect()
        torch.cuda.empty_cache()
        e, row = lm_bf16(device, spec)
        errs.update(e)
        rows.append(row)
        log(f"lm bf16 {row['config']} ({row['layers']} layers, "
            f"{row['attention_layers']} of attention): {row['batch']} x "
            f"{row['prompt_len']} prompt tokens, prefill "
            f"{row['prefill_ms']:.2f} ms ({row['prefill_tokens_per_s']:.0f} "
            f"tokens/s); decode {row['steps']} steps, ms per step median "
            f"{row['decode_ms_per_step_median']:.2f} (min "
            f"{row['decode_ms_per_step_min']:.2f}, max "
            f"{row['decode_ms_per_step_max']:.2f}), "
            f"{row['decode_tokens_per_s']:.1f} tokens/s; against "
            f"{row['compared_with']}, relative error of the logits max "
            f"{row['rel_err_max']:.4g} (limit {row['limit']}), argmax agrees "
            f"{row['argmax_agree']}, differs at {row['argmax_differ_at']}"
            + (f", routing choices the plain run would have made otherwise "
               f"{row['routing_choices_differ']} of "
               f"{row['routing_choices']} in {row['routing_calls']} layer "
               f"calls" if "routing_calls" in row else "")
            + f"; first prefill at this shape (uncounted) "
            f"{row['warmup_prefill_ms']:.2f} ms with "
            f"{row['warmup_segments']} cudaMalloc calls, "
            f"{row['run_segments']} in the timed run"
            + f"; params {row['params_mb']:.1f} MB, init "
            f"{row['init_s']:.2f} s, held {row['held_mb']:.1f} MB, peak "
            f"allocated {row['peak_allocated_mb']:.1f} MB in init; memory "
            f"reserved {row['memory_reserved_mb']:.1f} MB; launches "
            f"{row['launches']}; checks {e}")
        for part, p in row["profile"].items():
            log(f"lm bf16 {row['config']} profile, {part}: " + (
                "the profiler saw no device kernel" if p is None else
                f"wall {p['wall_ms']:.2f} ms, {p['kernels']} device kernels "
                f"summing {p['kernel_sum_ms']:.3f} ms (busy "
                f"{p['busy_ms']:.3f}), attention {p['attention_ms']:.3f} ms "
                f"= share {p['attention_share']:.3f}, idle share "
                f"{p['idle_share']:.3f}; unprofiled wall "
                f"{p['wall_unprofiled_ms']:.2f} ms, idle share against it "
                f"{p['idle_share_unprofiled']:.3f}; most time: " + "; ".join(
                    f"{k['kernel']} {k['ms']:.3f} ms in {k['count']}"
                    for k in p["top"])))
    gc.collect()
    torch.cuda.empty_cache()
    for row in rows:
        for k, v in row["launches"].items():
            launches[k] = launches.get(k, 0) + v
    log(f"lm checks (count of what failed, 0 passes): {errs}")
    return errs, rows, launches


def lm_errors(fault: str) -> None:
    """Phase 7's golden checks on the card, one line per check, limit 0."""
    import torch
    errs = lm_checks(torch.device("cuda"), route="golden")[0]
    for check, err in errs.items():
        print(json.dumps({"fault": fault, "case": f"lm {check}",
                          "err": err, "limit": 0, "over": err > 0}),
              flush=True)


# ---------------------------------------------------------------------------
# phase 8: training at full width
# ---------------------------------------------------------------------------
TRAIN_GOLDEN = os.path.join(ROOT, "tests", "golden", "train_f32.json")
TRAIN_GOLDEN_FAMILIES = os.path.join(ROOT, "tests", "golden",
                                     "train_families_f32.json")
TRAIN_GOLDENS = (TRAIN_GOLDEN, TRAIN_GOLDEN_FAMILIES)
# a batch's keys and dtypes in the golden files (a vlm's embeddings,
# positions and labels; the others' tokens and labels)
BATCH_DTYPES = {"tokens": np.int32, "labels": np.int32,
                "positions": np.int32, "embeds": np.float32}
# f32 against the JAX package's make_train_step (CPU), per step, relative.
# The loss at the reference's own limit for grad_accum (tests/
# test_train.py), 1e-5: the port lies within 1.9e-7 of the golden on the
# CPU and 1.14e-6 on an H100 (full width and smoke). grad_norm at the
# reference's 1e-4 on the first step, which compares the gradients
# alone: the golden's own f32 sum over 218 M squared gradients at full
# width is 1.14e-5 off their norm in float64 (the port's f32 sum 1.2e-8),
# and the port lies 1.1e-5 from it on the CPU and on an H100. After a
# step, AdamW moves each weight by about lr * g / (|g| + eps), so a weight
# whose gradient is within rounding of 0 moves by up to 2 lr in one
# correct run against another, and the gradients drift apart: at step 3
# the port lies 1.18e-4 (CPU) and 5.28e-4 (H100) from the golden's
# grad_norm. The limit after the first step is 5e-3, ~10x that. A
# gradient that misses the attention projections, or a GQA group's sum,
# moves grad_norm by 0.1-0.5 from the first step on
TRAIN_LOSS_RTOL = 1e-5
TRAIN_GNORM_RTOL = (1e-4, 5e-3)     # the first step, the later ones
# bf16, the kernels' path against flash_attention_plain (autograd) on the
# same weights and batch, per parameter leaf: the norm of the gradients'
# difference over the norm of the plain run's. The two backward passes
# differ in rounding only (0.8% on the worst leaf over 4 layers at full
# width on the CPU, where both take the same forward), the forward by one
# bf16 step on some attention outputs per layer; over 28 layers ~2%
# expected, 0.61% measured on an H100 (the embedding, then wk and wq).
# The limit is 2^-4; a dropped GQA-group sum or a gradient that never
# reaches the attention projections is off by order 1
TRAIN_GRAD_TOL = 2.0 ** -4
# the same two runs' losses, relative: each is the mean over 8192 tokens
# of a loss near 12, which one bf16 step on some attention outputs moves
# by far less (7.8e-6 on an H100)
TRAIN_BF16_LOSS_TOL = 2.0 ** -8
# bf16 at full width and depth: Qwen3-0.6B, 28 layers, f32 master weights
# from a seeded generator on the card, remat "full", loss in 8 chunks;
# 4 Trainer steps of 4 x 2048 tokens, a checkpoint at step 2
TRAIN_BF16 = dict(name="qwen3-0.6b", seed=0, batch=4, seq_len=2048, steps=4,
                  ckpt_every=2,
                  opt=dict(lr=1e-4, warmup_steps=2, total_steps=100))


def train_golden(path: str = TRAIN_GOLDEN) -> list:
    with open(path) as f:
        return json.load(f)["runs"]


def train_attention_launches(cfg) -> int:
    """The attention kernel's launches in one train step of ``cfg``
    (forward and backward): one per attention layer in the forward, and
    one more per attention layer of a checkpointed pattern group, whose
    recompute in the backward runs its forward again (remat ``"full"``
    or ``"dots"``; the trailing layers are not checkpointed). The backward
    itself launches none. Qwen3-0.6B, 28 attention layers under remat
    ``"full"``: 28 x (1 + 1) = 56 a step. Every smoke config trains
    under remat ``"full"`` too, so the golden runs' remat doubles their
    launches: 4 a step for the Mixtral, RecurrentGemma (two local layers,
    both in pattern groups), Qwen2-VL and MusicGen smoke configs, 0 for
    RWKV-6's."""
    from repro_torch.configs.base import ATTN_GLOBAL, ATTN_LOCAL
    attn = [k in (ATTN_GLOBAL, ATTN_LOCAL) for k in cfg.layer_kinds]
    grouped = sum(attn[:cfg.n_groups * len(cfg.pattern)])
    remat = cfg.remat and cfg.remat_policy != "none"
    return sum(attn) + (grouped if remat else 0)


def train_launches_want(cfg, seq_len: int, steps: int) -> dict:
    """The attention launches of ``steps`` train steps of ``cfg`` at
    ``seq_len``, each step ``cfg.grad_accum`` forward and backward passes
    (one a microbatch): all on the prefill route of ``cfg.dtype``."""
    import torch
    from repro_torch.kernels.flash_attention import ROUTES, attention_route
    n = steps * cfg.grad_accum * train_attention_launches(cfg)
    want = {f"flash_attention.{r}": 0 for r in ROUTES}
    want[f"flash_attention.{attention_route(getattr(torch, cfg.dtype), seq_len)}"] = n
    want["flash_attention_combine"] = 0
    want["flash_attention"] = n
    return want


def train_golden_errors(run: dict, device) -> tuple:
    """One run of the golden file (``tests/make_train_golden.py``: the JAX
    package's ``make_train_step`` in f32 on the CPU) through the port's
    ``make_train_step`` on ``device`` (``grad_accum`` from the run's
    config: the reference's ``lax.scan`` over microbatches against the
    port's loop), its attention on the port's kernels
    (on the card; the plain version's forward on the CPU), weights from
    ``numpy_params`` with the golden's seed, the batches the golden
    recorded (``make_batch``'s on the machine that wrote it: numpy's
    ``Generator.zipf`` draws other tokens under other numpy versions, so
    whether this machine's ``make_batch`` gives the same ones is only
    reported). Counts, each 0 to pass: weights whose sha256 is not the
    golden's, steps whose loss lies more than ``TRAIN_LOSS_RTOL``, or
    grad_norm more than ``TRAIN_GNORM_RTOL`` (the first step's, the later
    steps'), from the golden's (relative), or whose lr is not the
    golden's, and on the card attention launches other than
    ``train_launches_want``. Returns (errors, row)."""
    import torch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import build_model
    from repro_torch.models.convert import (numpy_params, params_from_numpy,
                                            tree_sha256)
    from repro_torch.train.data import DataConfig, make_batch
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state
    from repro_torch.train.step import make_train_step
    cfg = lm_config(run)
    weights = numpy_params(cfg, run["seed"])
    errs = {"weights": int(tree_sha256(weights) != run["weights_sha256"])}
    params = params_from_numpy(weights, device)
    del weights
    opt_state = init_opt_state(params)
    step = make_train_step(build_model(cfg), AdamWConfig(**run["opt"]))
    dcfg = DataConfig(**run["data"])
    batches = [{k: np.array(g[k], dt) for k, dt in BATCH_DTYPES.items()
                if k in g} for g in run["per_step"]]
    same_data = all(all(np.array_equal(v, b[k]) for k, v in make_batch(
        dcfg, cfg, s).items()) for s, b in enumerate(batches))
    batches = [{k: torch.as_tensor(v, device=device) for k, v in b.items()}
               for b in batches]
    reset_launch_counts()
    t0 = time.perf_counter()
    got = []
    for batch in batches:
        params, opt_state, m = step(params, opt_state, batch)
        got.append({k: float(m[k]) for k in ("loss", "grad_norm", "lr")})
    secs = time.perf_counter() - t0
    counts = launch_counts()
    want_steps = run["per_step"]
    rel = {k: [abs(g[k] - w[k]) / abs(w[k]) for g, w in zip(got, want_steps)]
           for k in ("loss", "grad_norm", "lr")}
    errs["loss"] = sum(e > TRAIN_LOSS_RTOL for e in rel["loss"]) + int(
        len(got) != len(want_steps))
    errs["grad_norm"] = sum(e > TRAIN_GNORM_RTOL[min(i, 1)]
                            for i, e in enumerate(rel["grad_norm"]))
    errs["lr"] = sum(e > 1e-6 for e in rel["lr"])
    want = train_launches_want(cfg, dcfg.seq_len, run["steps"])
    if torch.device(device).type == "cuda":
        errs["launches"] = sum(counts.get(k, 0) != v for k, v in want.items())
    row = dict(config=cfg.name, layers=cfg.n_layers, d_model=cfg.d_model,
               vocab=cfg.vocab_size, batch=dcfg.batch, seq_len=dcfg.seq_len,
               grad_accum=cfg.grad_accum, steps=run["steps"], loss=[g["loss"] for g in got],
               grad_norm=[g["grad_norm"] for g in got],
               loss_rel_err=rel["loss"], grad_norm_rel_err=rel["grad_norm"],
               limits=dict(loss=TRAIN_LOSS_RTOL,
                           grad_norm=TRAIN_GNORM_RTOL), seconds=secs,
               make_batch_matches_golden=same_data,
               launches={k: counts.get(k, 0) for k in want})
    return errs, row


def train_bf16(device, spec: dict = TRAIN_BF16) -> tuple:
    """Phase 8's run at full width and depth (``TRAIN_BF16``): the
    ``Trainer`` on the card, its data from ``DataLoader``, with a
    checkpoint at step ``ckpt_every``. Each step is timed on the host
    clock between synchronizes, its attention launches zeroed just before
    it and read just after (``train_launches_want``). Checks, each a count
    of what failed: launches per step; every step's loss and grad_norm
    finite; the checkpoint of step ``ckpt_every`` restored
    (``CheckpointManager.restore``) equal by bits to that step's params
    and optimizer state; then step 1 again on its weights and batch
    (``loss_and_grads``), on the kernels and on ``flash_attention_plain``
    (``build_model(cfg, attention="torch")``): every parameter leaf's
    gradient on the kernels' path finite and not all zero, within
    ``TRAIN_GRAD_TOL`` of the plain run's by norm, the losses within
    ``TRAIN_BF16_LOSS_TOL``, the repeat's launches those of one step.
    Last, one more step under ``torch.profiler`` (``profiled_shares``):
    the attention forward's and backward's shares of device time and the
    idle share. Memory: ``torch.cuda.max_memory_allocated`` in each step,
    over what was allocated before the Trainer was built; step 1's is the
    training's own (later steps also hold what this check keeps: step 1's
    weights, the checkpointed step's state). Returns (errors, row)."""
    import torch
    from repro_torch.configs import ARCHS
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import build_model
    from repro_torch.train.checkpoint import CheckpointManager
    from repro_torch.train.data import DataConfig
    from repro_torch.train.loop import Trainer, TrainerConfig
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.step import compute_params, loss_and_grads
    from repro_torch.utils.tree import flatten_dict, tree_leaves
    cfg = ARCHS[spec["name"]].replace(remat=True, remat_policy="full",
                                      loss_chunks=8)
    B, S, steps, at = (spec[k] for k in ("batch", "seq_len", "steps",
                                         "ckpt_every"))
    tag, dt = f"train.{cfg.name}", getattr(torch, cfg.dtype)
    want1 = train_launches_want(cfg, S, 1)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        tr = Trainer(cfg, DataConfig(seed=spec["seed"], batch=B, seq_len=S),
                     AdamWConfig(**spec["opt"]),
                     TrainerConfig(num_steps=steps, log_every=1,
                                   ckpt_every=at, ckpt_dir=ckpt_dir,
                                   seed=spec["seed"]), device=device)
        inner, seen, kept = tr.step_fn, [], {}

        def step_fn(params, opt_state, batch):
            if not seen:
                kept["first"] = (params, batch)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_launch_counts()
            t0 = time.perf_counter()
            out = inner(params, opt_state, batch)
            torch.cuda.synchronize()
            seen.append((time.perf_counter() - t0, launch_counts()))
            peaks.append(torch.cuda.max_memory_allocated() - base)
            if len(seen) == at:
                kept["ckpt"] = out[:2]
            return out
        tr.step_fn, peaks = step_fn, []
        torch.cuda.synchronize()
        params, opt_state, hist = tr.run(steps)
        restored, rstep = CheckpointManager(ckpt_dir).restore(
            kept["ckpt"], step=at, device=device)
        pairs = list(zip(tree_leaves(restored), tree_leaves(kept["ckpt"])))
        errs = {f"{tag}.launches": sum(
                    any(c.get(k, 0) != v for k, v in want1.items())
                    for _, c in seen) + int(len(seen) != steps),
                f"{tag}.finite": sum(
                    not (math.isfinite(h["loss"])
                         and math.isfinite(h["grad_norm"])) for h in hist),
                f"{tag}.checkpoint": int(rstep != at) + sum(
                    a.dtype != b.dtype or not torch.equal(a, b)
                    for a, b in pairs)}
        del restored, pairs, kept["ckpt"]
        p0, b0 = kept.pop("first")
        reset_launch_counts()
        lk, _, gk = loss_and_grads(tr.model, compute_params(p0, dt), b0)
        torch.cuda.synchronize()
        repeat = launch_counts()
        lp, _, gp = loss_and_grads(build_model(cfg, attention="torch"),
                                   compute_params(p0, dt), b0)
        fk, fp = flatten_dict(gk), flatten_dict(gp)
        del gk, gp
        rel = {k: float((fk[k].float() - fp[k].float()).norm()
                        / fp[k].float().norm()) for k in fp}
        bad = [k for k, g in fk.items() if not bool(torch.isfinite(g).all())
               or not bool((g != 0).any())]
        loss_rel = abs(float(lk) - float(lp)) / abs(float(lp))
        errs[f"{tag}.grads_nonzero"] = len(bad) + int(sorted(fk) != sorted(fp))
        errs[f"{tag}.grads"] = sum(not r <= TRAIN_GRAD_TOL
                                   for r in rel.values())
        errs[f"{tag}.loss"] = int(not loss_rel <= TRAIN_BF16_LOSS_TOL)
        errs[f"{tag}.repeat_launches"] = int(any(
            repeat.get(k, 0) != v for k, v in want1.items()))
        del fk, fp
        prof = profiled_shares(lambda: inner(params, opt_state, b0))
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    secs = [s for s, _ in seen]
    step_s = statistics.median(secs[1:])
    worst = sorted(rel.items(), key=lambda kv: -kv[1])[:3]
    row = dict(config=cfg.name, layers=cfg.n_layers, dtype=cfg.dtype,
               remat=cfg.remat_policy, loss_chunks=cfg.loss_chunks, batch=B,
               seq_len=S, steps=steps, loss=[h["loss"] for h in hist],
               grad_norm=[h["grad_norm"] for h in hist],
               step_ms=[s * 1e3 for s in secs],
               step_ms_median_2_on=step_s * 1e3,
               tokens_per_s=B * S / step_s,
               peak_allocated_mb=peaks[0] / 1e6,
               peak_allocated_mb_per_step=[x / 1e6 for x in peaks],
               memory_reserved_mb=torch.cuda.memory_reserved() / 1e6,
               launches_per_step=[c.get("flash_attention", 0) for _, c in seen],
               launches={k: sum(c.get(k, 0) for _, c in seen) for k in want1},
               grad_rel_err_max=max(rel.values()),
               grad_rel_err_worst=worst, grad_limit=TRAIN_GRAD_TOL,
               zero_or_nonfinite_grads=bad, loss_kernels=float(lk),
               loss_plain=float(lp), loss_rel_err=loss_rel,
               loss_limit=TRAIN_BF16_LOSS_TOL, profile=prof)
    return errs, row


def train_checks(device, route: str = "all") -> tuple:
    """Phase 8: every golden run of both golden files
    (``train_golden_errors``) then, for route "all", the bf16 run
    (``train_bf16``). Returns (errors, rows, launches: the attention
    launches summed over the runs)."""
    import torch
    errs, rows, launches = {}, [], {}
    for run in (r for path in TRAIN_GOLDENS for r in train_golden(path)):
        e, row = train_golden_errors(run, device)
        errs.update({f"{run_tag(run)}.{k}": v for k, v in e.items()})
        rows.append(row)
        log(f"train golden {row['config']} ({row['layers']} layers, d_model "
            f"{row['d_model']}, vocab {row['vocab']}, f32): {row['steps']} "
            f"steps of {row['batch']} x {row['seq_len']} tokens in "
            f"{row['grad_accum']} microbatches, in "
            f"{row['seconds']:.2f} s; loss {row['loss']}, relative error "
            f"{max(row['loss_rel_err']):.3g} (limit {TRAIN_LOSS_RTOL}); "
            f"grad_norm {row['grad_norm']}, relative error by step "
            f"{[float(f'{e:.3g}') for e in row['grad_norm_rel_err']]} "
            f"(limits {TRAIN_GNORM_RTOL[0]} on the first step, "
            f"{TRAIN_GNORM_RTOL[1]} after); this machine's make_batch gives "
            f"the golden's batches: {row['make_batch_matches_golden']}; "
            f"launches {row['launches']}; checks {e}")
    if route == "all":
        torch.cuda.empty_cache()
        e, row = train_bf16(device)
        errs.update(e)
        rows.append(row)
        p = row["profile"]
        log(f"train bf16 {row['config']} ({row['layers']} layers, remat "
            f"{row['remat']}, loss in {row['loss_chunks']} chunks): "
            f"{row['steps']} steps of {row['batch']} x {row['seq_len']} "
            f"tokens, ms per step {[round(x, 2) for x in row['step_ms']]}, "
            f"median of steps 2-{row['steps']} "
            f"{row['step_ms_median_2_on']:.2f} ms, "
            f"{row['tokens_per_s']:.0f} tokens/s; peak allocated "
            f"{row['peak_allocated_mb']:.1f} MB, reserved "
            f"{row['memory_reserved_mb']:.1f} MB; loss {row['loss']}; "
            f"step 1 against flash_attention_plain: loss "
            f"{row['loss_kernels']:.6f} vs {row['loss_plain']:.6f} "
            f"(relative {row['loss_rel_err']:.3g}, limit "
            f"{row['loss_limit']}), gradients by norm worst "
            f"{row['grad_rel_err_worst']} (limit {row['grad_limit']}); "
            f"launches {row['launches']}; checks {e}")
        log(f"train bf16 {row['config']} profile, one step: " + (
            "the profiler saw no device kernel" if p is None else
            f"wall {p['wall_ms']:.2f} ms, {p['kernels']} device kernels "
            f"summing {p['kernel_sum_ms']:.3f} ms (busy "
            f"{p['busy_ms']:.3f}); attention forward {p['attention_ms']:.3f}"
            f" ms = share {p['attention_share']:.3f}; attention backward "
            f"{p['attention_backward_ms']:.3f} ms = share "
            f"{p['attention_backward_share']:.3f}; idle share "
            f"{p['idle_share']:.3f}; unprofiled wall "
            f"{p['wall_unprofiled_ms']:.2f} ms, idle share against it "
            f"{p['idle_share_unprofiled']:.3f}; most time: " + "; ".join(
                f"{k['kernel']} {k['ms']:.3f} ms in {k['count']}"
                for k in p["top"])))
    for row in rows:
        for k, v in row["launches"].items():
            launches[k] = launches.get(k, 0) + v
    log(f"train checks (count of what failed, 0 passes): {errs}")
    return errs, rows, launches


def train_errors(fault: str) -> None:
    """Phase 8's golden checks on the card, one line per check, limit 0."""
    import torch
    errs = train_checks(torch.device("cuda"), route="golden")[0]
    for check, err in errs.items():
        print(json.dumps({"fault": fault, "case": f"train {check}",
                          "err": err, "limit": 0, "over": err > 0}),
              flush=True)


# ---------------------------------------------------------------------------
# phase 9: the design-space sweep on the card
# ---------------------------------------------------------------------------
# sha256 of the JAX package's numpy-backend report.json on DSE_GRID (without
# wall_s, cache and profile; JSON with sorted keys); tests/test_torch_dse.py
# asserts the same digest
DSE_DIGEST = \
    "88321c259756792203249701f2542fe63c937255d931b2bb0fbcfae9a3a9a1e2"
DSE_NETWORKS = ["resnet18", "mobilenet"]
DSE_GRID = dict(log_blocks=(4, 5), mem_widths=(8, 32), spad_scales=(1,),
                tune="full", workers=1, profile=True)
# the CLI through its pool: two groups (log blocks 4 and 5; one group would
# run serially), so the pool opens, its two workers spawned on the card
DSE_POOL_GRID = dict(log_blocks=(4, 5), mem_widths=(8,), spad_scales=(1,))
DSE_DRILL_CALL = 3           # the card backend's run_batched call that fails
DSE_MEMORY_SLACK = 64 << 20  # bytes memory_allocated may stay above its start


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def report_text(rep: dict) -> str:
    """A sweep report as the backends are compared (the CI's
    backend-equivalence rule): wall_s, cache and profile dropped, JSON with
    sorted keys."""
    rep = {k: v for k, v in rep.items()
           if k not in ("wall_s", "cache", "profile")}
    return json.dumps(rep, sort_keys=True)


def report_file_text(out: str) -> str:
    with open(os.path.join(out, "report.json")) as f:
        return report_text(json.load(f))


def reset_sweep_state() -> None:
    """A cold sweep process: the per-process layer cache, schedule stores
    and tuners of ``core/dse`` emptied (a warm layer cache would skip the
    tuner, and with it every verification)."""
    import gc
    from repro_torch.core import dse
    dse._LAYER_CACHE.clear()
    dse._SCHEDULE_STORES.clear()
    dse._TUNERS.clear()
    gc.collect()


def dse_sweep(backend: str, out: str) -> tuple:
    """One sweep of ``DSE_GRID`` in this process, cold, into ``out``:
    (SweepResult, wall seconds, its ScheduleStore, its tuner)."""
    from repro_torch.core import dse
    reset_sweep_state()
    t0 = time.perf_counter()
    res = dse.run_sweep(DSE_NETWORKS, out_dir=out, backend=backend,
                        **DSE_GRID)
    wall = time.perf_counter() - t0
    sched = os.path.join(out, "schedules")
    return (res, wall, dse._SCHEDULE_STORES[sched],
            dse._TUNERS[("full", os.path.join(out, "autotune"), sched)])


def device_memos(store, tuner) -> int:
    """Executor memos the port keeps on a Trace (entries, chunks, plans,
    capture keys) on the traces of every program the ScheduleStore and the
    tuner's verification memo hold."""
    progs = [getattr(e, "program", None) for e in store._lru.values()]
    progs += [p for p, _ in tuner._verify_memo.values()]
    n = 0
    for prog in progs:
        for trace in getattr(prog, "__dict__", {}).get("_lowered",
                                                       {}).values():
            n += sum(len(trace.__dict__.get(k, ()))
                     for k in ("_torch_ops", "_torch_chunks", "_torch_plans"))
            n += "_torch_key" in trace.__dict__
    return n


def dse_drill(tmp: str) -> int:
    """The card-fault drill: the card backend's ``run_batched`` raises a
    CUDA error on its ``DSE_DRILL_CALL``-th call during a sweep of
    ``DSE_GRID``. The sweep must end in ``CardFault`` carrying the error,
    and its result cache must hold no record of the point being evaluated
    (the first job) and no infeasible record. Returns the count of what
    failed."""
    from repro_torch.core import dse
    from repro_torch.vta.backend import CardFault
    from repro_torch.vta.fsim_torch import TorchBackend
    calls = [0]
    run_batched = TorchBackend.run_batched

    def planted(self, prog, hw, **kw):
        calls[0] += 1
        if calls[0] == DSE_DRILL_CALL:
            raise RuntimeError("CUDA error: planted")
        return run_batched(self, prog, hw, **kw)

    out = os.path.join(tmp, "drill")
    reset_sweep_state()
    TorchBackend.run_batched = planted
    try:
        dse.run_sweep(DSE_NETWORKS, out_dir=out, backend="torch",
                      **DSE_GRID)
        raised = ""
    except CardFault as e:
        raised = str(e)
    finally:
        TorchBackend.run_batched = run_batched
    first = dse.make_jobs(DSE_NETWORKS, backend="torch", **{
        k: DSE_GRID[k] for k in ("log_blocks", "mem_widths", "spad_scales",
                                 "tune")})[0]
    cache = dse.ResultCache(os.path.join(out, "cache"))
    recs = []
    for name in sorted(os.listdir(cache.root)):
        with open(os.path.join(cache.root, name)) as f:
            recs.append(json.load(f))
    errs = int("CUDA error: planted" not in raised) + \
        int(os.path.exists(cache.path(first.key()))) + \
        sum(not r.get("feasible") for r in recs)
    log(f"card-fault drill: {calls[0]} run_batched calls, CardFault "
        f"{'raised' if raised else 'NOT raised'} ({raised[:120]}), "
        f"{len(recs)} cached records, {errs} failed")
    return errs


def dse_pool_cli(tmp: str, numpy_out: str) -> tuple:
    """``python -m repro_torch.core.dse --networks mobilenet`` on
    ``DSE_POOL_GRID`` with ``--tune full --backend torch --workers 2`` in
    a subprocess (the pool spawned, its workers on the card), against the
    numpy sweep's report of the same grid (read back from its cache).
    Returns (count of what failed, wall seconds)."""
    from repro_torch.core import dse
    out = os.path.join(tmp, "pool")
    args = ["--networks", "mobilenet", "--tune", "full", "--backend",
            "torch", "--workers", "2", "--out", out]
    for k, v in DSE_POOL_GRID.items():
        args += ["--" + k.replace("_", "-"), ",".join(map(str, v))]
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.core.dse", *args],
        env=dict(os.environ, PYTHONPATH=SRC), capture_output=True,
        text=True, timeout=600)
    wall = time.perf_counter() - t0
    for line in (proc.stdout + proc.stderr).strip().splitlines()[-6:]:
        log(f"  dse cli: {line}")
    want = dse.run_sweep(["mobilenet"], out_dir=numpy_out, backend="numpy",
                         tune="full", workers=1, **DSE_POOL_GRID)
    errs = int(proc.returncode != 0)
    if not errs:
        errs = int(report_file_text(out) != report_text(want.report()))
    return errs, wall


class timed_calls:
    """Within the block, every call of ``owner.attr`` adds its wall time
    (with the card synchronized at its end) to ``spent[key]``."""

    def __init__(self, owner, attr: str, spent: dict, key: str):
        self.owner, self.attr, self.spent, self.key = owner, attr, spent, key

    def __enter__(self):
        import torch
        fn = self.fn = getattr(self.owner, self.attr)
        spent, key = self.spent, self.key

        def wrapper(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                torch.cuda.synchronize()
                spent[key] = spent.get(key, 0.0) + time.perf_counter() - t0
        setattr(self.owner, self.attr, wrapper)
        return self

    def __exit__(self, *exc):
        setattr(self.owner, self.attr, self.fn)


def dse_checks(tmp: str) -> tuple:
    """Phase 9: ``DSE_GRID`` swept on the numpy FSim, then on the card,
    the card-fault drill and the CLI through its spawned pool. Returns
    (count of what failed per check, the numbers to print, the card
    sweep's launches)."""
    import gc
    import torch
    from repro_torch.analysis.dse_report import render
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.vta import fsim_torch
    smi = card_line()
    numpy_out = os.path.join(tmp, "numpy")
    res_np, wall_np, _, tuner_np = dse_sweep("numpy", numpy_out)
    torch.cuda.synchronize()
    gc.collect()
    mem0 = torch.cuda.memory_allocated()
    reset_launch_counts()
    fsim_torch.reset_capture_log()
    fsim_torch.reset_uncaptured_runs()
    # where a verification's time goes: lowering the Program to its trace,
    # building the trace's device entries (index maps copied to the card)
    # and the whole backend call, kernels and the copy back included
    spent: dict = {}
    with timed_calls(fsim_torch, "lowered", spent, "lower"), \
            timed_calls(fsim_torch, "_build_ops", spent, "entries"), \
            timed_calls(fsim_torch.TorchBackend, "run_batched", spent,
                        "run_batched"):
        res, wall, store, tuner = dse_sweep("torch",
                                            os.path.join(tmp, "torch"))
    torch.cuda.synchronize()
    counts = launch_counts()
    captures = fsim_torch.capture_log()
    runs = fsim_torch.uncaptured_runs()
    memos = device_memos(store, tuner)
    verifications = tuner.verifications
    del store, tuner
    reset_sweep_state()
    mem1 = torch.cuda.memory_allocated()
    text_np = report_file_text(numpy_out)
    text = report_file_text(os.path.join(tmp, "torch"))
    errs = {
        "reports_equal": int(text != text_np),
        "digest": int(hashlib.sha256(text_np.encode()).hexdigest()
                      != DSE_DIGEST),
        "launches": sum(counts.get(k, 0) == 0 for k in ("gemm", "alu_sweep")),
        "verifications": int(verifications == 0 or runs != verifications),
        "captures": len(captures),
        "device_memos": memos,
        "memory": int(mem1 - mem0 > DSE_MEMORY_SLACK),
    }
    errs["drill"] = dse_drill(tmp)
    errs["pool_cli"], wall_cli = dse_pool_cli(tmp, numpy_out)
    st_np, st = res_np.profile["stages"], res.profile["stages"]
    verify_s = st.get("fsim_verify", 0.0)
    rows = {
        "card": smi,
        "numpy": {"wall_s": wall_np, "stages_s": st_np,
                  "verifications": tuner_np.verifications},
        "torch": {"wall_s": wall, "stages_s": st,
                  "verifications": verifications,
                  "ms_per_verification": 1e3 * verify_s / max(verifications,
                                                               1),
                  "uncaptured_runs": runs, "host_split_s": spent,
                  "launches": {
                      k: counts.get(k, 0)
                      for k in ("gemm", "alu_chain", "alu_sweep")},
                  "memory_allocated_delta": mem1 - mem0},
        "programs_scheduled": res.profile["schedule_store"].get("misses", 0),
        "cli_pool_wall_s": wall_cli,
    }
    for name, r in (("numpy", rows["numpy"]), ("torch", rows["torch"])):
        log(f"dse sweep on {name}: wall {r['wall_s']:.3f} s, fsim_verify "
            f"{r['stages_s'].get('fsim_verify', 0.0):.3f} s, "
            f"{r['verifications']} verifications; stages {r['stages_s']} "
            f"({smi})")
    call_s, lower_s, entries_s = (spent.get(k, 0.0) for k in (
        "run_batched", "lower", "entries"))
    log(f"dse on the card: {verifications} verifications, "
        f"{rows['torch']['ms_per_verification']:.3f} ms each; of "
        f"fsim_verify {verify_s:.3f} s, run_batched {call_s:.3f} s: "
        f"lowering {lower_s:.3f} s, device entries {entries_s:.3f} s, the "
        f"rest (chunks, kernels, the copy back) "
        f"{call_s - lower_s - entries_s:.3f} s; "
        f"{runs} uncaptured runs, launches {rows['torch']['launches']}, "
        f"{rows['programs_scheduled']} programs scheduled, "
        f"{len(captures)} captures, {memos} device memos, memory_allocated "
        f"{mem0} -> {mem1} bytes; CLI with 2 spawned workers "
        f"{wall_cli:.1f} s ({smi})")
    for line in render(res.report(), chart=False).splitlines():
        log(f"  {line}")
    log(f"dse checks (count of what failed, 0 passes): {errs}")
    return errs, rows, {k: counts.get(k, 0)
                        for k in ("gemm", "alu_chain", "alu_sweep")}


def dse_errors(fault: str) -> None:
    """Phase 9's checks, one line per check, limit 0; a phase that raises
    (a fault may end it early) fails the check ``ran_to_end``."""
    tmp = tempfile.mkdtemp(prefix="chip_smoke_dse_")
    try:
        errs = dse_checks(tmp)[0]
    except Exception:
        traceback.print_exc()
        errs = {"ran_to_end": 1}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for check, err in errs.items():
        print(json.dumps({"fault": fault, "case": f"dse {check}",
                          "err": err, "limit": 0, "over": err > 0}),
              flush=True)


# ---------------------------------------------------------------------------
# --plant-faults: the checks of phases 2-9 against wrong kernels and code
# ---------------------------------------------------------------------------
# ---------------------------------------------------------------------------
# phase 10: the mesh layer
# ---------------------------------------------------------------------------
MESH_SERVE = LM_BF16_RUNS[0]     # Qwen3-0.6B, 4 x 1024, 32 steps, as phase 7
# 10a: serving under the rules against without. RWKV-6 at full width and
# depth: the token shift across shard edges, the WKV on (batch, head)
# blocks, the group norm; Moonshot at full width cut to 4 layers (5.9 GB
# in bf16, its params from the init in the serving dtypes): the MoE
# dispatch on shards
MESH_SERVE_RUNS = (
    MESH_SERVE,
    dict(name="rwkv6-1.6b", seed=0, batch=4, prompt_len=2048, steps=8),
    dict(name="moonshot-v1-16b-a3b", seed=0, batch=4, prompt_len=1024,
         steps=8, overrides=dict(n_layers=4)),
)
# 10d: the dry-run cells, each on both meshes
MESH_DRYRUN = (("qwen3-0.6b", "train_4k"),
               ("moonshot-v1-16b-a3b", "train_4k"),
               ("rwkv6-1.6b", "train_4k"))
# per-device flops times the ranks over model_flops, in a train cell: the
# band of the CPU tests' smoke cells (tests/test_torch_dryrun.py
# TRAIN_FLOP_BAND). Remat "full" runs each group's forward twice (8 of
# model_flops' 6 * N * tokens, 1.33), and the ops the rules leave
# replicated over "model" count whole on each of its ranks: 1.698 measured
# for qwen3-0.6b train_4k on both meshes. Every product counted twice
# gives 3.4, a count on global shapes 256 or 512 times the per-device one
MESH_FLOP_BAND = (1.2, 2.5)
# moonshot-v1-16b-a3b train_4k: 1.436 on 16x16 and 2.385 on 2x16x16 (the
# card's host, torch 2.11; 1.436 also from 1 and 2 scanned layers on torch
# 2.13, while ``--depth d1|d2`` unrolls the layers out of the remat groups
# and gives 1.107): the rules shard the dispatch buffer over "model"
# (experts) and "data" (d_model), not "pod", so each pod computes the
# experts' products whole. A band for each mesh, between the sound reading
# and the reading with every product counted twice (2.87, 4.77); a
# capacity from a rank's own tokens gives 0.398 on 16x16
MESH_FLOP_BANDS = {
    "qwen3-0.6b": {"16x16": MESH_FLOP_BAND, "2x16x16": MESH_FLOP_BAND},
    "moonshot-v1-16b-a3b": {"16x16": (1.2, 2.0), "2x16x16": (1.8, 3.2)}}
MESH_DRYRUN_TIMEOUT = 600


def whole(t):
    """A DTensor's full value; a plain tensor as it is."""
    from torch.distributed.tensor import DTensor
    return t.full_tensor() if isinstance(t, DTensor) else t


def distributed(tree, names, mesh, rules):
    """``tree``'s tensors as DTensors of the rules' placements for their
    logical ``names`` (each rank keeps its own shard)."""
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.utils.tree import tree_map
    return tree_map(lambda t, n: distribute_tensor(
        t, mesh, rules.sharding(n, t.shape).placements(),
        src_data_rank=None), tree, names)


def placement_errors(tree, names, rules) -> int:
    """Leaves of ``tree`` that are not DTensors of the rules' placements
    for their ``names``."""
    from torch.distributed.tensor import DTensor
    from repro_torch.utils.tree import flatten_dict
    flat, want = flatten_dict(tree), flatten_dict(names)
    return sum(not isinstance(t, DTensor) or list(t.placements) !=
               rules.sharding(want[k], t.shape).placements()
               for k, t in flat.items()) + int(sorted(flat) != sorted(want))


def mesh_serve(device, mesh, rules, lm_row=None) -> tuple:
    """10a: each run of ``MESH_SERVE_RUNS`` twice on the same params, once
    as phase 7 runs it and once with the params distributed by the rules'
    shardings of their logical names and ``generate`` under the rules.
    Checks, per run: the tokens, and every step's logits, equal by bits;
    the attention launches of the run under rules exactly phase 7's
    (``lm_launches_want``); for the MoE run, its init in the serving
    dtypes (``init_session``: peak, memory held, f32 leaves). Prefill and
    decode ms of both (and of phase 7, given its row), each after an
    uncounted generation at the timed shape (``warm_prefill``, its prefill
    ms recorded), are recorded, not gated: DTensor's host cost on a
    host-bound decode."""
    errs, rows = {}, []
    for spec in MESH_SERVE_RUNS:
        e, row = mesh_serve_run(device, mesh, rules, spec, lm_row)
        errs.update(e)
        rows.append(row)
    return errs, rows


def mesh_serve_run(device, mesh, rules, spec: dict, lm_row=None) -> tuple:
    """One run of ``mesh_serve``."""
    import torch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import build_model
    from repro_torch.serve.session import ServeSession
    from repro_torch.sharding.logical import use_rules
    cfg = lm_config(spec)
    B, S, steps = (spec[k] for k in ("batch", "prompt_len", "steps"))
    tag = f"mesh.serve.{cfg.name}"
    model = build_model(cfg)
    errs, mem = {}, {}
    if cfg.family == "moe":
        sess, mem, e = init_session(model, spec["seed"], device)
        errs.update({f"{tag}.{k}": v for k, v in e.items()})
        params = sess.params
        del sess
    else:
        gen = torch.Generator(device=device).manual_seed(spec["seed"])
        params = model.init(gen, device)
    prompts = np.random.default_rng(spec["seed"]).integers(
        0, cfg.vocab_size, (B, S), dtype=np.int32)
    want = lm_launches_want(attention_layers(cfg), cfg.dtype, S, steps)
    runs, warm = {}, {}
    for name, p, ctx in (
            ("plain", params, None),
            ("rules", distributed(params, model.logical_names(), mesh, rules),
             rules)):
        sess = ServeSession(model, p, device=device)
        with use_rules(ctx):
            sess.generate(prompts[:, :64], 2)           # warm-up, uncounted
            warm[name] = warm_prefill(
                sess, lambda n: sess.generate(prompts, n))[
                    "warmup_prefill_ms"]
            times: list = []
            seen = record_steps(sess, times)
            reset_launch_counts()
            toks = sess.generate(prompts, steps)
            torch.cuda.synchronize()
        runs[name] = (whole(toks), [whole(x) for x in seen], times,
                      launch_counts())
        del sess, p
    del params
    (ta, la, tma, _), (tb, lb, tmb, cb) = runs["plain"], runs["rules"]
    errs.update({
        f"{tag}.tokens": int(not torch.equal(ta, tb)),
        f"{tag}.logits": sum(not torch.equal(a, b) for a, b in zip(la, lb))
        + int(len(la) != len(lb) or len(la) != steps + 1),
        f"{tag}.launches": sum(cb.get(k, 0) != v for k, v in want.items())})
    row = dict(config=cfg.name, layers=cfg.n_layers, batch=B, prompt_len=S,
               steps=steps, mesh="1x1", **mem,
               launches={k: cb.get(k, 0) for k in want},
               prefill_ms_plain=tma[0] * 1e3, prefill_ms_rules=tmb[0] * 1e3,
               warmup_prefill_ms_plain=warm["plain"],
               warmup_prefill_ms_rules=warm["rules"],
               decode_ms_per_step_plain=statistics.median(tma[1:]) * 1e3,
               decode_ms_per_step_rules=statistics.median(tmb[1:]) * 1e3)
    if lm_row is not None and lm_row["config"] == cfg.name \
            and spec is MESH_SERVE:
        row.update(prefill_ms_phase7=lm_row["prefill_ms"],
                   decode_ms_per_step_phase7=lm_row[
                       "decode_ms_per_step_median"])
    return errs, row


def init_errors(fault: str) -> None:
    """``init_session`` on the MoE run of ``MESH_SERVE_RUNS`` (Moonshot at
    full width cut to 4 layers), one line per check, limit 0: init's peak,
    the memory it holds, the weights it keeps in f32."""
    import torch
    from repro_torch.models import build_model
    (spec,) = [r for r in MESH_SERVE_RUNS
               if lm_config(r).family == "moe"]
    model = build_model(lm_config(spec))
    _, mem, errs = init_session(model, spec["seed"], torch.device("cuda"))
    log(f"init {model.cfg.name} ({model.cfg.n_layers} layers): {mem}")
    for check, err in errs.items():
        print(json.dumps({"fault": fault, "case": f"init {check}",
                          "err": err, "limit": 0, "over": err > 0}),
              flush=True)


def mesh_train(device, mesh, rules) -> tuple:
    """10b: one bf16 train step at phase 8's configuration (``TRAIN_BF16``)
    from its starting params and first batch, once plain and once with
    params and optimizer state distributed by the rules and the step under
    them. Checks: loss and grad_norm equal by bits; every updated param
    and AdamW moment equal by bits to the plain step's and in its param's
    placements; every gradient (``loss_and_grads`` under the rules, after
    the step) in its param's placements; the step's attention launches
    exactly one step's (``train_launches_want``: 56 ``mma``)."""
    import torch
    from torch.distributed.tensor import Replicate, distribute_tensor
    from repro_torch.configs import ARCHS
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.sharding.logical import use_rules
    from repro_torch.train.data import DataConfig, DataLoader
    from repro_torch.train.loop import Trainer, TrainerConfig
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.step import compute_params, loss_and_grads
    from repro_torch.utils.tree import flatten_dict
    spec = TRAIN_BF16
    cfg = ARCHS[spec["name"]].replace(remat=True, remat_policy="full",
                                      loss_chunks=8)
    tr = Trainer(cfg, DataConfig(seed=spec["seed"], batch=spec["batch"],
                                 seq_len=spec["seq_len"]),
                 AdamWConfig(**spec["opt"]), TrainerConfig(seed=spec["seed"]),
                 device=device)
    params, opt_state, _ = tr.init_or_resume()
    loader = DataLoader(tr.data_cfg, cfg)
    try:
        batch = {k: torch.as_tensor(v, device=device)
                 for k, v in next(loader).items()}
    finally:
        loader.close()
    names = tr.model.logical_names()
    p1, s1, m1 = tr.step_fn(params, opt_state, batch)
    dparams = distributed(params, names, mesh, rules)
    dopt = {"step": distribute_tensor(opt_state["step"], mesh,
                                      [Replicate()] * 2, src_data_rank=None),
            "mu": distributed(opt_state["mu"], names, mesh, rules),
            "nu": distributed(opt_state["nu"], names, mesh, rules)}
    want = train_launches_want(cfg, spec["seq_len"], 1)
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    with use_rules(rules):
        p2, s2, m2 = tr.step_fn(dparams, dopt, batch)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    counts = launch_counts()
    errs = {f"mesh.train.{k}": int(not torch.equal(whole(m2[k]), m1[k]))
            for k in ("loss", "grad_norm")}
    errs["mesh.train.launches"] = sum(counts.get(k, 0) != v
                                      for k, v in want.items())
    errs["mesh.train.placements"] = sum(
        placement_errors(t, names, rules) for t in (p2, s2["mu"], s2["nu"]))
    errs["mesh.train.values"] = sum(
        sum(not torch.equal(whole(t), flatten_dict(ref)[k])
            for k, t in flatten_dict(got).items())
        for got, ref in ((p2, p1), (s2["mu"], s1["mu"]), (s2["nu"], s1["nu"])))
    del p1, s1, p2, s2, dopt
    with use_rules(rules):
        _, _, grads = loss_and_grads(
            tr.model, compute_params(dparams, getattr(torch, cfg.dtype)),
            batch)
    errs["mesh.train.grad_placements"] = placement_errors(grads, names, rules)
    row = dict(config=cfg.name, batch=spec["batch"], seq_len=spec["seq_len"],
               mesh="1x1", loss=float(m1["loss"]),
               grad_norm=float(m1["grad_norm"]), step_ms_rules=step_s * 1e3,
               launches={k: counts.get(k, 0) for k in want})
    return errs, row, (tr.model, params)


def mesh_restore(device, rules, model, params) -> tuple:
    """10c: ``params`` checkpointed, then restored through
    ``elastic_remesh(mgr, abstract_params(model), surviving_mesh(0),
    model.logical_names())``. Checks: every leaf a DTensor on the card
    with the rules' placements, equal by bits to what was saved."""
    import torch
    from repro_torch.train.checkpoint import CheckpointManager
    from repro_torch.train.fault_tolerance import elastic_remesh, surviving_mesh
    from repro_torch.train.step import abstract_params
    from repro_torch.utils.tree import flatten_dict
    tmp = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    try:
        mgr = CheckpointManager(tmp)
        mgr.save(0, params)
        t0 = time.perf_counter()
        restored, step = elastic_remesh(
            mgr, abstract_params(model), surviving_mesh(0), model.logical_names())
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    saved = flatten_dict(params)
    got = flatten_dict(restored)
    errs = {"mesh.restore.placements": placement_errors(
                restored, model.logical_names(), rules),
            "mesh.restore.device": sum(t.device.type != "cuda"
                                       for t in got.values()),
            "mesh.restore.values": int(step != 0) + sum(
                not torch.equal(whole(t), saved[k]) for k, t in got.items())}
    return errs, dict(leaves=len(got), restore_s=secs)


def mesh_dryrun() -> tuple:
    """10d: ``python -m repro_torch.launch.dryrun`` on each cell of
    ``MESH_DRYRUN``, single-pod and ``--multi-pod``, each in a subprocess
    of its own (a fake process group cannot share a process with the
    ``nccl`` one), all at once. Checks per cell and mesh: it runs to the
    end; ``peak_est_bytes`` below the card's memory; on 16x16 it counts
    collectives; per-device flops times the ranks over ``model_flops``
    within ``MESH_FLOP_BANDS`` where the arch has a band on the mesh
    (recorded for every cell). Prints flops, bytes and collective bytes
    per device, the
    roofline terms (``core/roofline.py::h100_terms``, the H100 data
    sheet's rates) and the wall time."""
    import torch
    from repro_torch.analysis.roofline import model_flops
    from repro_torch.configs import ARCHS
    from repro_torch.core.roofline import h100_terms
    tmp = tempfile.mkdtemp(prefix="chip_smoke_dryrun_")
    env = dict(os.environ, PYTHONPATH=SRC)
    procs = {}
    try:
        for arch, shape in MESH_DRYRUN:
            for mp in (False, True):
                out = os.path.join(tmp, f"{arch}.{shape}.{int(mp)}.json")
                cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                       "--arch", arch, "--shape", shape, "--out", out] + (
                           ["--multi-pod"] if mp else [])
                procs[arch, shape, mp] = (subprocess.Popen(
                    cmd, env=env, cwd=ROOT, stdout=subprocess.PIPE,
                    stderr=subprocess.STDOUT, text=True), out,
                    time.perf_counter())
        res, errs = {}, {}
        total = torch.cuda.get_device_properties(0).total_memory
        for (arch, shape, mp), (proc, out, t0) in procs.items():
            text, _ = proc.communicate(timeout=MESH_DRYRUN_TIMEOUT)
            wall = time.perf_counter() - t0
            mesh = "2x16x16" if mp else "16x16"
            tag = f"mesh.dryrun.{arch}.{shape}.{mesh}"
            for line in text.splitlines():
                log(f"  {line}")
            r = json.load(open(out)) if os.path.exists(out) else {
                "error": f"exit {proc.returncode}"}
            errs[f"{tag}.ran"] = int(proc.returncode != 0 or "error" in r)
            if "error" in r:
                continue
            mf = model_flops(ARCHS[arch], shape)
            ratio = r["flops_per_device"] * r["chips"] / mf
            errs[f"{tag}.memory"] = int(
                not r["memory"]["peak_est_bytes"] < total)
            band = MESH_FLOP_BANDS.get(arch, {}).get(mesh)
            if band is not None:
                errs[f"{tag}.flops"] = int(not band[0] <= ratio <= band[1])
            if not mp:
                errs[f"{tag}.collectives"] = int(
                    not r["collectives"]["total_bytes"] > 0)
            t = h100_terms(r["flops_per_device"], r["hbm_bytes_per_device"],
                           r["collectives"]["total_bytes"],
                           n_devices=r["chips"])
            row = res[f"{arch} {shape} {r['mesh']}"] = dict(
                flops_per_device=r["flops_per_device"],
                hbm_bytes_per_device=r["hbm_bytes_per_device"],
                collective_bytes_per_device=r["collectives"]["total_bytes"],
                collectives=r["collectives"], memory=r["memory"],
                model_flops=mf, flops_ratio=ratio, flops_band=band,
                compute_s=t.compute_s, memory_s=t.memory_s,
                collective_s=t.collective_s, dominant=t.dominant,
                bound_s=t.bound_s, step_s=r["compile_s"], wall_s=wall,
                card_memory_bytes=total)
            log(f"dryrun {arch} x {shape} on {r['mesh']} ({r['chips']} "
                f"ranks, the card's host): {json.dumps(row)}")
    finally:
        for proc, _, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(tmp, ignore_errors=True)
    return errs, res


MESH_PARTS = ("serve", "train", "restore", "dryrun")


def mesh_checks(device, parts=MESH_PARTS, lm_row=None) -> tuple:
    """Phase 10: the mesh layer on the card. Starts a one-rank ``nccl``
    process group and the (1, 1) mesh over ("data", "model") and runs
    ``parts`` in order: 10a ``mesh_serve``, 10b ``mesh_train``, 10c
    ``mesh_restore`` (on 10b's model and starting params, or a fresh init
    of Qwen3-0.6B without 10b), 10d ``mesh_dryrun``; destroys the group.
    Returns (errors, rows)."""
    import torch
    from repro_torch.launch.mesh import (destroy_process_group,
                                         init_process_group, make_mesh)
    from repro_torch.sharding.logical import LogicalRules
    errs, rows, kept = {}, {}, None
    init_process_group("nccl")
    try:
        mesh = make_mesh((1, 1), ("data", "model"))
        rules = LogicalRules(mesh)
        for part in parts:
            t0 = time.perf_counter()
            if part == "serve":
                e, rows[part] = mesh_serve(device, mesh, rules, lm_row)
            elif part == "train":
                e, rows[part], kept = mesh_train(device, mesh, rules)
            elif part == "restore":
                if kept is None:
                    from repro_torch.configs import ARCHS
                    from repro_torch.models import build_model
                    model = build_model(ARCHS[TRAIN_BF16["name"]])
                    kept = (model, model.init(torch.Generator(
                        device=device).manual_seed(0), device))
                e, rows[part] = mesh_restore(device, rules, *kept)
            else:
                e, rows[part] = mesh_dryrun()
            errs.update(e)
            log(f"phase 10{'abcd'[MESH_PARTS.index(part)]} ({part}): "
                f"{time.perf_counter() - t0:.1f} s, errors {e}")
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        destroy_process_group()
    return errs, rows


def mesh_errors(fault: str, route: str) -> None:
    """Phase 10's checks of ``route`` (``mesh_serve``, ``mesh_restore``,
    ``mesh_dryrun``; "all": every part, each on a group of its own), one
    line per check, limit 0; a part that raises (a fault may end it early)
    fails the check ``mesh.<part>.raised``."""
    import torch
    errs = {}
    for part in MESH_PARTS if route == "all" else (route[len("mesh_"):],):
        try:
            errs.update(mesh_checks(torch.device("cuda"), (part,))[0])
        except Exception:
            traceback.print_exc()
            errs[f"mesh.{part}.raised"] = 1
    for check, err in errs.items():
        print(json.dumps({"fault": fault, "case": check, "err": err,
                          "limit": 0, "over": err > 0}), flush=True)


PLANTED_FAULTS = {  # name: (route, file under src/repro_torch, text, stand-in)
    "mma.skip_tile_4096": (
        "mma", "csrc/flash_attention_mma.cu", "|| j0 + BK <= wbeg) continue;",
        "|| j0 + BK <= wbeg || j0 == 4096) continue;"),
    "mma.window_plus_64": (
        "mma", "csrc/flash_attention_mma.cu",
        "           (int)window, softcap, scale};",
        "           (int)window + 64, softcap, scale};"),
    "decode.skip_tile_4096": (
        "decode", "csrc/flash_decode.cu", "gr < rows && key < bend &&",
        "gr < rows && key < bend && (key < 4096 || key >= 4096 + BK) &&"),
    "decode.window_plus_64": (
        "decode", "kernels/flash_attention.py",
        "parts = decode_partials(q, k, v, causal, window, softcap, scale)",
        "parts = decode_partials(q, k, v, causal, None if window is None "
        "else window + 64, softcap, scale)"),
    "tf32x3.skip_tile_4096": (
        "tf32x3", "csrc/flash_attention.cu", "|| j0 + BK <= wbeg) continue;",
        "|| j0 + BK <= wbeg || j0 == 4096) continue;"),
    "tf32x3.window_plus_64": (
        "tf32x3", "csrc/flash_attention.cu",
        "           (int)window, softcap, scale};",
        "           (int)window + 64, softcap, scale};"),
    # the score takes only the hi . hi product: one-term TF32
    "tf32x3.hi_only": (
        "tf32x3", "csrc/flash_attention.cu",
        "n < NT; ++n) mma(part[mi][n], al[mi], bh[n][0], bh[n][1]);\n"
        "#pragma unroll\n"
        "        for (int mi = 0; mi < MT; ++mi)\n"
        "#pragma unroll\n"
        "          for (int n = 0; n < NT; ++n) mma(part[mi][n], ah[mi], bl[n][0], "
        "bl[n][1]);", "n < NT; ++n) {}"),
    # the scalar tail after the last whole vector is not written
    "alu.skip_tail": (
        "alu", "csrc/alu.cu",
        "else if (t >= 32 && t - 32 < tail)", "else if (false)"),
    # the last K split of every split-K product adds nothing
    "gemm_float.drop_last_split": (
        "gemm_float", "csrc/gemm_f32.cu",
        "  const int tiles = (k1 - k0 + BK - 1) / BK;",
        "  const int tiles = split > 0 && split == a.splits - 1 ? 0\n"
        "                    : (k1 - k0 + BK - 1) / BK;"),
    # every halo read one column to the right of where it lies
    "depthwise.halo_one_column_right": (
        "depthwise", "csrc/depthwise.cu",
        "tma_halo(halo, &map, c0, ix0, iy0, b, &bar,",
        "tma_halo(halo, &map, c0, ix0 + 1, iy0, b, &bar,"),
    # every pooling halo read one column to the right of where it lies
    "pool2d.halo_one_column_right": (
        "pool2d", "csrc/pool2d.cu",
        "const int iy = iy0 + hy, ix = ix0 + hx, c = c0 + g * V;",
        "const int iy = iy0 + hy, ix = ix0 + hx + 1, c = c0 + g * V;"),
    # the last tap of every compiled pooling window is not taken
    "pool2d.skip_last_tap": (
        "pool2d", "csrc/pool2d.cu",
        "for (int dx = 0; dx < KF; ++dx) tap(dy, dx);",
        "for (int dx = 0; dx < KF; ++dx)\n"
        "        if (dy < KF - 1 || dx < KF - 1) tap(dy, dx);"),
    # the same on the scalar path, which stages its halo itself
    "depthwise.scalar_one_column_right": (
        "depthwise", "csrc/depthwise.cu",
        "const int iy = iy0 + hy, ix = ix0 + hx;",
        "const int iy = iy0 + hy, ix = ix0 + hx + 1;"),
    # the last reduction row of every group adds nothing
    "gemm.skip_last_r": (
        "gemm", "csrc/vta_gemm.cu",
        "const bool ok = m0 + row < a.M && rr < rn;",
        "const bool ok = m0 + row < a.M && rr < rn && r0 + rr != a.R - 1;"),
    # the partial of the last thread of a split tap reduction is dropped
    "alu_sweep.drop_one_split": (
        "alu_sweep", "csrc/alu_sweep.cu", "  int mine = part;",
        "  int mine = threadIdx.x % S == S - 1 ? identity(op) : part;"),
    # a captured dispatch starts from the scratchpads the last one left
    "serve.skip_zeroing": (
        "serve", "vta/fsim_torch.py", "                st[k].zero_()",
        "                pass"),
    # every chunk of a trace but its last is replayed
    "serve.skip_last_chunk": (
        "serve", "vta/fsim_torch.py",
        "for g, launches in plan.graphs:",
        "for g, launches in plan.graphs[:-1]:"),
    # MobileNet served under ServedModel.compile's weights: load_params
    # installs nothing for it
    "serve.mbn_model_rng_weights": (
        "serve", "serve/model.py",
        "    for k, v in params.items():\n        v = np.asarray(v)",
        "    for k, v in (() if model.name.startswith(\"mobilenet\")\n"
        "                 else params.items()):\n        v = np.asarray(v)"),
    # the last tap of each depthwise MAC dropped where a sweep has 112 rows
    # (MobileNet-1.0's 112 x 112 and 56 x 56 layers, on the captured path)
    "serve.mbn_dw_tap_dropped": (
        "serve", "csrc/alu_sweep.cu",
        "            if (u < cnt)\n              part = mac ?",
        "            if (u < cnt && !(mac && g == 112 && t0 + u * S == t_n - 1))"
        "\n              part = mac ?"),
    # the chunk of the fused mbn.dw11 -> mbn.pw11 segment not replayed
    "serve.mbn_fused_chunk_skipped": (
        "serve", "vta/fsim_torch.py", "                    g.replay()\n",
        "                    if \"mbn.pw11\" not in trace.tensors_written:\n"
        "                        g.replay()\n"),
    # plans no longer per capture scope: every worker shares one
    "pool.shared_plans": (
        "pool", "vta/fsim_torch.py",
        "sig = (capture_scope(), str(self.device),",
        "sig = (None, str(self.device),"),
    # a card rung that steps down for a fault of the card
    "ladder.card_error_steps_down": (
        "ladder", "serve/breaker.py",
        "if rung.on_card and not isinstance(e, InjectedFault):",
        "if False:"),
    # a step down the ladder that is not counted
    "ladder.uncounted_step_down": (
        "ladder", "serve/breaker.py",
        "                self.metrics.on_fallback(rung.name)",
        "                pass"),
    # a decode step that attends to one slot fewer than are valid
    "lm.decode_one_slot_short": (
        "lm", "models/attention.py", "valid = min(pos + 1, L)",
        "valid = min(pos + 1, L) - 1"),
    # a decode step that writes its K/V one slot past its own
    "lm.cache_slot_off_by_one": (
        "lm", "models/attention.py", "slot = pos % L", "slot = (pos + 1) % L"),
    # a prefill that drops the sliding window on local layers
    "lm.prefill_drops_window": (
        "lm", "models/attention.py",
        "window=cfg.sliding_window if local else None,", "window=None,"),
    # a WKV chunk whose sub-blocks do not see the state before them
    "lm.wkv_drops_inter_block": (
        "lm", "models/rwkv6.py",
        "    y = (y_intra + y_inter).reshape(B, L, H, N)",
        "    y = y_intra.reshape(B, L, H, N)"),
    # an RG-LRU decode step that forgets the state before it
    "lm.rglru_decode_drops_h_prev": (
        "lm", "models/griffin.py",
        "h = torch.exp(log_a[:, 0]) * h_prev + gated[:, 0]",
        "h = gated[:, 0]"),
    # a cast at load that rounds the RG-LRU gates to bf16
    "lm.cast_rglru_gates_bf16": (
        "lm", "models/transformer.py",
        "        return tree if _read_in_f32(path, cfg) else tree.to(dt)",
        "        if path[-1].startswith(\"gate_\"):\n"
        "            return tree.to(torch.bfloat16)\n"
        "        return tree if _read_in_f32(path, cfg) else tree.to(dt)"),
    # a forward whose result has no grad_fn (the wrapper before the op had
    # an autograd formula): the attention projections get no gradient
    "train.no_grad_fn": (
        "train", "kernels/flash_attention.py",
        "    return attention_op(q, k, v, causal, window, softcap, scale, "
        "block_q,\n                        block_k)",
        "    return attention_forward(\n        q, k, v, causal=causal, "
        "window=window, softcap=softcap, scale=scale,\n        "
        "block_q=block_q, block_k=block_k).detach()"),
    # a backward whose dK and dV take the first query head of each GQA
    # group only, not the sum over the group
    "train.drops_gqa_sum": (
        "train", "kernels/flash_attention.py",
        '        dk[:, :, k0:k1] += torch.einsum("bkgcl,bkgcd->bkld", ds, qc)\n'
        '        dv[:, :, k0:k1] += torch.einsum("bkgcl,bkgcd->bkld", p, doc)',
        '        dk[:, :, k0:k1] += torch.einsum("bkcl,bkcd->bkld", ds[:, :, 0],'
        ' qc[:, :, 0])\n        dv[:, :, k0:k1] += torch.einsum('
        '"bkcl,bkcd->bkld", p[:, :, 0], doc[:, :, 0])'),
    # the sweep records a fault of the card as an infeasible point (the
    # reference's handler at eval_job, with CardFault put back into it)
    "dse.card_fault_absorbed": (
        "dse", "core/dse.py",
        "    except (AssertionError, RuntimeError, ValueError) as e:",
        "    except (AssertionError, RuntimeError, ValueError, CardFault) "
        "as e:"),
    # a verification on the captured route: a plan and CUDA graphs kept
    # for every candidate
    "dse.captured": (
        "dse", "vta/autotune.py", "        be = be.uncaptured()\n",
        "        be = be\n"),
    # a verification that resolves the card to the CPU
    "dse.verify_on_cpu": (
        "dse", "vta/autotune.py", "    be = get_backend(backend)\n",
        '    be = get_backend("torch-cpu" if backend == "torch" else '
        'backend)\n'),
    # a DTensor attention that takes the plain version on the card
    "mesh_serve.dtensor_plain_attention": (
        "mesh_serve", "kernels/flash_attention.py",
        "    return attention_op(q, k, v, causal, window, softcap, scale, "
        "block_q,\n                        block_k)",
        "    from torch.distributed.tensor import DTensor\n"
        "    if isinstance(q, DTensor):\n"
        "        return flash_attention_plain(q, k, v, causal=causal, "
        "window=window,\n            softcap=softcap, scale=scale)\n"
        "    return attention_op(q, k, v, causal, window, softcap, scale, "
        "block_q,\n                        block_k)"),
    # a restore that ignores its sharding tree
    "mesh_restore.ignores_sharding_tree": (
        "mesh_restore", "train/checkpoint.py",
        "            if flat_s.get(k) is not None:\n",
        "            if False:\n"),
    # a dry-run that reports global flops as per-device
    "mesh_dryrun.global_flops": (
        "mesh_dryrun", "launch/dryrun.py",
        "                self.flops += f(*args, **kwargs, out_val=out)\n",
        "                self.flops += f(*args, **kwargs, out_val=out) * \\\n"
        "                    torch.distributed.get_world_size()\n"),
    # a dry-run that counts every product twice (2x, inside the old band)
    "mesh_dryrun.flops_counted_twice": (
        "mesh_dryrun", "launch/dryrun.py",
        "                self.flops += f(*args, **kwargs, out_val=out)\n",
        "                self.flops += 2 * f(*args, **kwargs, out_val=out)\n"),
    # a MoE dispatch whose capacity counts a rank's own tokens, not the
    # step's (invisible on one rank: the 16x16 cell's expert flops fall)
    "mesh_dryrun.moe_per_rank_capacity": (
        "mesh_dryrun", "models/moe.py", "    C = capacity(cfg, T)\n",
        "    C = capacity(cfg, x.to_local().shape[0] * x.to_local().shape[1]"
        "\n                 if isinstance(x, DTensor) else T)\n"),
    # a combine that drops expert 0's rows
    "lm.moe_combine_drops_expert": (
        "lm", "models/moe.py",
        "        (ye * gate_ec[..., None].to(dt), tabs[0]),",
        "        (ye * gate_ec[..., None].to(dt) * (torch.arange(\n"
        "            E, device=ye.device) > 0)[:, None, None].to(dt),"
        " tabs[0]),"),
    # the init in the serving dtypes rounds the MoE router to bf16
    "lm_init.router_cast_bf16": (
        "lm_init", "models/transformer.py",
        "        lambda path: None if _read_in_f32(path, cfg) else dt,",
        "        lambda path: None if _read_in_f32(path, cfg)\n"
        "        and path[-1] != \"router\" else dt,"),
    # an init that draws the f32 tree and casts it whole
    "lm_init.keeps_f32_tree": (
        "lm_init", "models/transformer.py",
        "    dt = getattr(torch, cfg.dtype)\n    return init_tree(",
        "    dt = getattr(torch, cfg.dtype)\n    if dt:\n        return "
        "cast_params(init_params(cfg, generator, device), cfg)\n"
        "    return init_tree("),
    # M-RoPE taking row 0 (time) for every section
    "lm.mrope_row0": (
        "lm", "models/layers.py",
        "pos_per_band = pos[torch.as_tensor(sec_id, device=pos.device)]",
        "pos_per_band = pos[torch.zeros(len(sec_id), dtype=torch.long,\n"
        "                                        device=pos.device)]"),
    # each codebook's head reads the next codebook's weights
    "lm.codebook_head_next": (
        "lm", "models/transformer.py",
        'logits = torch.einsum("bsd,kdv->bskv", x, params["head"].to('
        'x.dtype))',
        'logits = torch.einsum("bsd,kdv->bskv", x,\n'
        '                              params["head"].roll(-1, 0).to('
        'x.dtype))'),
    # a grad_accum loop that drops its last microbatch
    "train.grad_accum_drops_last": (
        "train", "train/step.py", "            for i in range(grad_accum):\n",
        "            for i in range(grad_accum - 1):\n"),
    # the token shift under the rules one position off (no shift)
    "mesh_serve.shift_off_by_one": (
        "mesh_serve", "sharding/logical.py",
        "    out = on_shards(lambda t: F.pad(t, pad).narrow(dim, 0, "
        "t.shape[dim]),",
        "    out = on_shards(lambda t: F.pad(t, pad).narrow(dim, 1, "
        "t.shape[dim]),"),
}
LAYER_FAULT_KEYS = ("gemm_float", "depthwise", "alu", "pool2d")
VTA_FAULT_KEYS = ("gemm", "alu_sweep")
SERVE_FAULT_KEYS = ("serve",)
POOL_FAULT_KEYS = ("pool", "ladder")
LM_FAULT_KEYS = ("lm",)
INIT_FAULT_KEYS = ("lm_init",)
TRAIN_FAULT_KEYS = ("train",)
DSE_FAULT_KEYS = ("dse",)
MESH_FAULT_KEYS = ("mesh_serve", "mesh_restore", "mesh_dryrun")
# --plant-faults runs these besides ATTENTION_CASES: the only windowed
# decode case there, g2.local.decode, sees its whole 4096-key cache, so a
# window 64 too wide is invisible to it. Gemma-2 27B local layers decoding
# 4 rows (a draft of 4 tokens) against an 8192-key cache see 4096 keys.
FAULT_CASES = [
    ("g2.local.decode.sq4", 8, 32, 16, 128, 4, 8192, True, 4096, 50.0,
     1 / 12, (BF, F32), None),
]


def case_errors(fault: str, route: str) -> int:
    """``--case-errors FAULT ROUTE``: the cases of ``route`` ("all": every
    route that has a planted fault) through their limit checks, one JSON
    line per case: the attention cases of ``ATTENTION_CASES`` and
    ``FAULT_CASES`` (``attention_errors``), the phase-4 cases, edge cases
    included, of the kernels of ``LAYER_FAULT_KEYS`` (``layer_errors``),
    phase 2's cases of the kernels of ``VTA_FAULT_KEYS`` (``vta_errors``),
    phase 3's checks of the captured path (``serve_errors``), phase 6's
    checks of the worker pool or the ladder (``pool_errors``), the
    golden checks of phases 7 and 8 (``lm_errors``, ``train_errors``),
    the init in the serving dtypes (``init_errors``),
    phase 9's checks of the sweep (``dse_errors``) and phase 10's of the
    mesh layer (``mesh_errors``)."""
    if route == "all" or route not in LAYER_FAULT_KEYS + VTA_FAULT_KEYS \
            + SERVE_FAULT_KEYS + POOL_FAULT_KEYS + LM_FAULT_KEYS \
            + INIT_FAULT_KEYS + TRAIN_FAULT_KEYS + DSE_FAULT_KEYS \
            + MESH_FAULT_KEYS:
        attention_errors(fault, route)
    if route == "all" or route in LAYER_FAULT_KEYS:
        layer_errors(fault, route)
    if route == "all" or route in VTA_FAULT_KEYS:
        vta_errors(fault, route)
    if route == "all" or route in SERVE_FAULT_KEYS:
        serve_errors(fault)
    if route == "all" or route in POOL_FAULT_KEYS:
        pool_errors(fault, route)
    if route == "all" or route in LM_FAULT_KEYS:
        lm_errors(fault)
    if route == "all" or route in INIT_FAULT_KEYS:
        init_errors(fault)
    if route == "all" or route in TRAIN_FAULT_KEYS:
        train_errors(fault)
    if route == "all" or route in DSE_FAULT_KEYS:
        dse_errors(fault)
    if route == "all" or route in MESH_FAULT_KEYS:
        mesh_errors(fault, route)
    return 0


def pool_errors(fault: str, route: str) -> None:
    """Phase 6's checks (``pool_checks`` of ``route``), one line per check,
    limit 0."""
    from repro_torch.vta.isa import DEFAULT_VTA
    errs = pool_checks(serve_models(DEFAULT_VTA), route)[0]
    for check, err in errs.items():
        print(json.dumps({"fault": fault, "case": f"pool {check}",
                          "err": err, "limit": 0, "over": err > 0}),
              flush=True)


def serve_errors(fault: str) -> None:
    """Phase 3's checks (``serve_checks``) on the captured path, one line
    per check, limit 0."""
    from repro_torch.vta.isa import DEFAULT_VTA
    errs = serve_checks(serve_models(DEFAULT_VTA))[0]
    for check, err in errs.items():
        print(json.dumps({"fault": fault, "case": f"serve {check}",
                          "err": err, "limit": 0, "over": err > 0}),
              flush=True)


def vta_errors(fault: str, route: str) -> None:
    """Phase 2's cases of the VTA kernels ``route`` names ("all": both),
    each held to its plain version, limit 0: the GEMM's ``gemm_cases`` (one
    line per main-path model and batch, one per edge case), and every
    program of ``sweep_cases`` at each of its tap splits (one line per
    group and split)."""
    import torch
    from repro_torch.vta.isa import DEFAULT_VTA
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    hw = DEFAULT_VTA
    main_path = vta_main_path(serve_models(hw), dev)

    def emit(case, err):
        print(json.dumps({"fault": fault, "case": case, "err": err,
                          "limit": 0, "over": err > 0}), flush=True)
    if route in ("all", "gemm"):
        for case in gemm_cases(dev, rng, hw, [
                (m, b, gemm_entries(ops)) for m, b, ops, _, _ in main_path]):
            emit(f"gemm {case[0]}", gemm_case_error(case))
    if route in ("all", "alu_sweep"):
        errs: dict = {}
        for group, p, nb, (acc, flats, out), splits in sweep_cases(
                dev, rng, hw, main_path):
            for s in splits:
                key = f"{kernel_of(p)} {group} split {s}"
                errs[key] = max(errs.get(key, 0),
                                run_sweep_pair(p, acc, flats, out, s))
        for key, err in errs.items():
            emit(key, err)


def layer_errors(fault: str, route: str) -> None:
    """The phase-4 cases, and the edge cases, that run on the kernel
    ``route`` names ("all": each of ``LAYER_FAULT_KEYS``) once through
    ``repro_torch.kernels.ops``, each held to phase 4's limit (a case whose
    input is another case's output runs after it): the GEMM against float64,
    the exact kernels by ``exact_error`` (NaN and inf by position) and
    ``bits_differ``, both 0."""
    import torch
    from repro_torch.kernels import alu, depthwise, gemm, ops, pool2d
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    plain = {"alu": alu.alu_plain, "depthwise_conv": depthwise.depthwise_plain,
             "pool2d": pool2d.pool2d_plain}
    keys = LAYER_FAULT_KEYS if route == "all" else (route,)
    cases = layer_op_cases(dev, rng, LAYER_BATCH) + \
        layer_edge_cases(dev, rng) + alu_edge_cases(dev, rng)
    kept = {c[1] for c in cases if layer_key(c) in keys}
    needed = {a for c in cases if c[1] in kept for a in c[2]
              if isinstance(a, str)}
    outs = {}
    for case in cases:
        op, name, _, kw = case
        if name not in kept and name not in needed:
            continue
        args = resolve(case, outs)
        got = outs[name] = getattr(ops, op)(*args, **kw)
        if name not in kept:
            continue
        if op == "gemm":
            want = gemm.gemm_plain(*args, **kw)
            bias = args[2] if len(args) > 2 else None
            err = gemm_err64(got, args[0], args[1], bias, kw.get("act"),
                             kw.get("clip"))
            limit = 2 * gemm_err64(want, args[0], args[1], bias,
                                   kw.get("act"), kw.get("clip")) \
                + 1e-6 * args[0].shape[1]
            nbits = 0
        else:
            want = plain[op](*args, **kw)
            err, limit = exact_error(got, want), 0.0
            nbits = bits_differ(got, want)
        print(json.dumps({"fault": fault, "case": name, "err": err,
                          "limit": limit, "bits_differ": nbits,
                          "over": err > limit or nbits > 0}), flush=True)


def attention_errors(fault: str, route: str) -> None:
    """The cases of ``ATTENTION_CASES`` and ``FAULT_CASES`` that take
    ``route`` ("all": every case) once through ``ops.flash_attention``,
    each held to float64 by ``attention_error``."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import (attention_route,
                                                     flash_attention_plain)
    for c in attention_cases(torch.device("cuda"),
                             ATTENTION_CASES + FAULT_CASES):
        q, k, v, kw = c["q"], c["k"], c["v"], c["kw"]
        if route != "all" and attention_route(q.dtype, q.shape[2]) != route:
            continue
        got = ops.flash_attention(q, k, v, **kw)
        want = flash_attention_plain(q, k, v, **kw)
        rows = sample_rows(q.shape[2], k.shape[2], kw["window"])
        idx = torch.tensor(rows, device=q.device)
        ek, ep, bad = attention_error(got[:, :, idx], want[:, :, idx],
                                      attention64(q, k, v, rows, **kw))
        print(json.dumps({"fault": fault, "case": c["name"], "err_f64": ek,
                          "plain_err_f64": ep, "out_max": float(
                              want.float().abs().max()), "over": bad}),
              flush=True)


def plant_faults() -> int:
    """``--plant-faults``: see the module's docstring."""
    tmp = tempfile.mkdtemp(prefix="chip_smoke_faults_")
    env = dict(os.environ, REPRO_TORCH_BUILD_DIR=os.path.join(tmp, "build"))
    procs, failed = {}, {}
    try:
        # the unchanged sources build once, into the directory every copy
        # shares; a copy then builds only the source its fault changed
        os.environ["REPRO_TORCH_BUILD_DIR"] = env["REPRO_TORCH_BUILD_DIR"]
        from repro_torch.kernels import _build
        t0 = time.perf_counter()
        _build.build_all()
        log(f"build: {time.perf_counter() - t0:.1f} s")
        jobs = [("none", "all", None)] + [
            (f, spec[0], spec[1:]) for f, spec in PLANTED_FAULTS.items()]
        for fault, route, sub in jobs:
            dst = os.path.join(tmp, fault)
            shutil.copytree(ROOT, dst, ignore=shutil.ignore_patterns(
                "build", "chiprun_out", ".git", "__pycache__"))
            if sub is not None:
                path = os.path.join(dst, "src", "repro_torch", sub[0])
                text = open(path).read()
                if text.count(sub[1]) != 1:
                    raise AssertionError(f"{fault}: its text is not in "
                                         f"{sub[0]} once")
                with open(path, "w") as f:
                    f.write(text.replace(sub[1], sub[2]))
        # three copies at a time hold the card's memory well inside 80 GB
        pending = list(jobs)
        while pending or procs:
            while pending and len(procs) < 3:
                fault, route, _ = pending.pop(0)
                procs[fault] = subprocess.Popen(
                    [sys.executable, "chip_smoke.py", "--case-errors",
                     fault, route], cwd=os.path.join(tmp, fault), env=env,
                    stdout=subprocess.PIPE, text=True)
            fault = next(iter(procs))
            proc = procs.pop(fault)
            out, _ = proc.communicate(timeout=900)
            if proc.returncode:
                raise AssertionError(f"{fault}: exit {proc.returncode}")
            lines = [json.loads(x) for x in out.splitlines()
                     if x.startswith("{")]
            for x in lines:
                log(json.dumps(x))
            failed[fault] = [x["case"] for x in lines if x["over"]]
            log(f"{fault}: {len(lines)} cases, over the limit in "
                f"{len(failed[fault])}: {failed[fault]}")
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(tmp, ignore_errors=True)
    caught = sum(bool(failed[f]) for f in PLANTED_FAULTS)
    log(f"planted faults caught: {caught} of {len(PLANTED_FAULTS)}; the "
        f"unchanged copy over the limit in {len(failed['none'])} cases")
    if failed["none"] or not all(failed[f] for f in PLANTED_FAULTS):
        raise AssertionError("the unchanged kernels failed, or a fault "
                             "passed")
    return 0


def main(argv: list) -> int:
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print("chip_smoke.py: src/repro_torch not found beside this script; "
              "run it from the root of a checkout", file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False     # library convolutions in f32
    torch.set_float32_matmul_precision("highest")
    if argv[1:2] == ["--plant-faults"]:
        return plant_faults()
    if argv[1:2] == ["--case-errors"]:
        return case_errors(argv[2], argv[3])

    # -- phase 1 ----------------------------------------------------------
    smi = card_line()
    log(f"card: {smi}")
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    _build.build_all()
    each = ", ".join(f"{k} {v['seconds']:.1f} s"
                     for k, v in _build.BUILD_LOG.items())
    log(f"build: {time.perf_counter() - t0:.1f} s ({each})")
    for k, v in _build.BUILD_LOG.items():       # ptxas, one line a source
        regs = [int(x) for x in re.findall(r"Used (\d+) registers",
                                           v["ptxas"])]
        spill = sum(int(x) for x in re.findall(r"(\d+) bytes spill stores",
                                               v["ptxas"]))
        if regs:
            log(f"  {k}: {len(regs)} kernels, registers {min(regs)}-"
                f"{max(regs)}, spill stores {spill} bytes in all")

    # -- phase 2 ----------------------------------------------------------
    from repro_torch.vta.isa import DEFAULT_VTA
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    hw = DEFAULT_VTA
    t0 = time.perf_counter()
    models = serve_models(hw)
    log(f"compile: " + ", ".join(f"{k} {len(m.segments)} segments"
                                 for k, m in models.items())
        + f" in {time.perf_counter() - t0:.2f} s (live_weights drawn for "
          f"both trunks)")
    t0 = time.perf_counter()
    main_path = vta_main_path(models, dev)
    where = {(m, b): i for i, (m, b, *_) in enumerate(main_path)}
    n = max(TRUNK_BUCKETS)
    trunk_ops = main_path[where[(TRUNK, n)]][2]
    trunk_entries = gemm_entries(trunk_ops)
    gemm_row = check_gemm(
        dev, rng, hw, [(m, b, gemm_entries(ops))
                       for m, b, ops, _, _ in main_path],
        (n, trunk_entries, gemm_shapes(trunk_ops, hw)))
    chain_row, sweep_row = check_sweeps(
        dev, rng, hw, main_path,
        {"alu_sweep": where[(TRUNK, n)],
         "alu_chain": where[(SMALL, SMALL_BUCKET)]})
    log(f"phase 2: {time.perf_counter() - t0:.1f} s")

    # -- phase 3 ----------------------------------------------------------
    t0 = time.perf_counter()
    errs, serve_rows, capture_rows, counts, live_rows, per_fwd = \
        serve_checks(models)
    if any(errs.values()):
        raise AssertionError(f"phase 3 failed: {errs}")
    log("serve: every output equals torch-cpu; both trunks' digests match "
        "the JAX numpy backend; every trunk segment inside the live bands")
    prof = {k: profile_forward(models[k], models[k].random_images(8, seed=0))
            for k in (TRUNK, MBN)}
    log(f"phase 3: {time.perf_counter() - t0:.1f} s")

    # -- phase 4 ----------------------------------------------------------
    t0 = time.perf_counter()
    cases = layer_op_cases(dev, rng, LAYER_BATCH)
    outs4, counts4 = drive_layer_ops(cases)
    log(f"layer ops: {len(cases)} cases through repro_torch.kernels.ops at "
        f"batch {LAYER_BATCH}; launches {counts4}")
    from repro_torch.kernels.gemm import gemm_float_plan
    want4 = {key: sum(layer_key(c) == key for c in cases) for key in LAYER_OPS}
    want4["gemm_float_reduce"] = sum(
        layer_key(c) == "gemm_float" and gemm_float_plan(
            c[2][0].shape[0], c[2][1].shape[1], c[2][0].shape[1])[2] > 1
        for c in cases)
    for key, want in want4.items():
        if not want or counts4.get(key) != want:
            raise AssertionError(f"{counts4.get(key)} launches of {key} for "
                                 f"{want} cases of its route")
    rows4 = check_layer_ops(cases, outs4)
    edge = layer_edge_cases(dev, rng)
    outs_edge, _ = drive_layer_ops(edge)
    check_layer_ops(edge, outs_edge, tag="edge cases, ")
    edge = alu_edge_cases(dev, rng)
    outs_edge, _ = drive_layer_ops(edge)
    check_alu_edges(edge, outs_edge)
    del edge, outs_edge
    log(f"phase 4: {time.perf_counter() - t0:.1f} s")

    # -- phase 5 ----------------------------------------------------------
    t0 = time.perf_counter()
    cases5 = attention_cases(dev)
    outs5, counts5 = drive_attention(cases5)
    log(f"attention: {len(cases5)} cases through "
        f"repro_torch.kernels.ops.flash_attention; launches {counts5}")
    from repro_torch.kernels.flash_attention import attention_route
    routes = [attention_route(c["q"].dtype, c["q"].shape[2]) for c in cases5]
    want5 = {"flash_attention": len(cases5),
             "flash_attention_combine": routes.count("decode"),
             **{f"flash_attention.{r}": routes.count(r)
                for r in ("decode", "mma", "tf32x3")}}
    for key, want in want5.items():
        if not want or counts5.get(key) != want:
            raise AssertionError(f"{counts5.get(key)} launches of {key}, "
                                 f"want {want}")
    row5 = check_attention(cases5, outs5)
    del cases5, outs5
    log(f"phase 5: {time.perf_counter() - t0:.1f} s")

    # -- phase 6 ----------------------------------------------------------
    t0 = time.perf_counter()
    errs6, pool_rows = pool_checks(models)
    if any(errs6.values()):
        raise AssertionError(f"phase 6 failed: {errs6}")
    log(f"phase 6: {time.perf_counter() - t0:.1f} s")

    # -- phase 7 ----------------------------------------------------------
    t0 = time.perf_counter()
    errs7, lm_rows, lm_launches = lm_checks(dev)
    if any(errs7.values()):
        raise AssertionError(f"phase 7 failed: {errs7}")
    log(f"phase 7: {time.perf_counter() - t0:.1f} s")

    # -- phase 8 ----------------------------------------------------------
    t0 = time.perf_counter()
    errs8, train_rows, train_launches = train_checks(dev)
    if any(errs8.values()):
        raise AssertionError(f"phase 8 failed: {errs8}")
    log(f"phase 8: {time.perf_counter() - t0:.1f} s")

    # -- phase 9 ----------------------------------------------------------
    t0 = time.perf_counter()
    tmp9 = tempfile.mkdtemp(prefix="chip_smoke_dse_")
    try:
        errs9, dse_rows, dse_launches = dse_checks(tmp9)
    finally:
        shutil.rmtree(tmp9, ignore_errors=True)
    if any(errs9.values()):
        raise AssertionError(f"phase 9 failed: {errs9}")
    log(f"phase 9: {time.perf_counter() - t0:.1f} s")

    # -- phase 10 ---------------------------------------------------------
    t0 = time.perf_counter()
    lm_row = next(r for r in lm_rows if r.get("config") == MESH_SERVE["name"]
                  and r.get("dtype") == "bfloat16")
    errs10, mesh_rows = mesh_checks(dev, lm_row=lm_row)
    if any(errs10.values()):
        raise AssertionError(f"phase 10 failed: {errs10}")
    log(f"phase 10: {time.perf_counter() - t0:.1f} s")

    src = "src/repro_torch/csrc/"
    kernels = [
        dict(name="gemm", route="cuda", source=src + "vta_gemm.cu",
             replaces="src/repro/kernels/vta_gemm.py:89",
             launches=counts["gemm"], **gemm_row,
             launches_pool=pool_rows[1]["launches"]["gemm"],
             launches_tenants=pool_rows[-1]["launches"]["gemm"],
             launches_dse=dse_launches["gemm"],
             per=f"resnet18-trunk forward, batch {n}"),
        dict(name="alu_chain", route="cuda", source=src + "alu_sweep.cu",
             replaces="src/repro/kernels/alu_sweep.py:300",
             launches=counts["alu_chain"], **chain_row,
             launches_dse=dse_launches["alu_chain"],
             per=f"resnet18-small forward, batch {SMALL_BUCKET}"),
        dict(name="alu_sweep", route="cuda", source=src + "alu_sweep.cu",
             replaces="src/repro/kernels/alu_sweep.py:225",
             launches=counts["alu_sweep"], **sweep_row,
             launches_pool=pool_rows[1]["launches"]["alu_sweep"],
             launches_tenants=pool_rows[-1]["launches"]["alu_sweep"],
             launches_dse=dse_launches["alu_sweep"],
             per=f"resnet18-trunk forward, batch {n}"),
    ]
    for row, key in zip(kernels, ("gemm", "alu_chain", "alu_sweep")):
        row["launches_per_forward_by_model"] = {
            m: v[key] for m, v in per_fwd.items()}
    for key, (_, source, replaces, per) in LAYER_OPS.items():
        kernels.append(dict(
            name=key, route="cuda", source=src + source, replaces=replaces,
            launches=counts4[key], **rows4[key],
            per=f"one pass over the phase-4 cases at batch {LAYER_BATCH}: "
                f"{per}" + ("; the split-K cases' time includes their "
                            "reduce kernel" if key == "gemm_float" else "")))
    kernels.append(dict(
        name="gemm_float_reduce", route="cuda", source=src + "gemm_f32.cu",
        replaces=LAYER_OPS["gemm_float"][2],
        launches=counts4["gemm_float_reduce"], **rows4["gemm_float_reduce"],
        per=f"alone, on the split-K cases of the gemm_float row "
            f"({rows4['gemm_float_reduce']['cases']})"))
    for key, source in zip(ATTENTION_KEYS, (
            "flash_attention_mma.cu", "flash_decode.cu", "flash_attention.cu",
            "flash_decode.cu")):
        kernels.append(dict(
            name=key, route="cuda", source=src + source,
            replaces="src/repro/kernels/flash_attention.py:77",
            launches=lm_launches[key], launches_cases=counts5[key],
            launches_train=train_launches.get(key, 0), **row5[key],
            launches_by_lm_run={
                f"{r['config']} {r.get('dtype', 'float32')}":
                    r["launches"][key] for r in lm_rows},
            launches_by_train_run={
                f"{r['config']} {r.get('dtype', 'float32')}"
                + (f" grad_accum {r['grad_accum']}"
                   if r.get("grad_accum", 1) > 1 else ""):
                    r["launches"][key] for r in train_rows},
            per=f"one pass over the phase-5 cases of its route "
                f"({row5[key]['cases']}): Gemma-2 27B, Qwen3-0.6B, Mixtral "
                f"8x22B, RecurrentGemma-9B, MusicGen-Large and Qwen2-VL-2B "
                f"attention at prefill 8192 and decode 1 x 32768 / 4096, "
                f"and the edge cases"
                + ("; the decode route's time includes its combine"
                   if key == "flash_attention.decode" else "")
                + "; launches: phase 7's language-model runs (the golden "
                  "f32 runs and the bf16 runs of Qwen3-0.6B, "
                  "RecurrentGemma-9B, Moonshot-v1-16B-A3B, Qwen2-VL-2B and "
                  "MusicGen-Large; by run in launches_by_lm_run), "
                  "launches_train: phase 8's training "
                  "runs (the f32 golden runs and the bf16 Qwen3-0.6B "
                  "Trainer steps; by run in launches_by_train_run), "
                  "launches_cases: phase 5's"))
    log(json.dumps({"serve": serve_rows, "capture": capture_rows,
                    "live": live_rows, "profile": prof}))
    log(json.dumps({"pool": pool_rows}))
    log(json.dumps({"lm": lm_rows}))
    log(json.dumps({"train": train_rows}))
    log(json.dumps({"dse": dse_rows}))
    log(json.dumps({"mesh": mesh_rows}))
    log(json.dumps({"kernels": kernels}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
