#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it.

    python3 chip_smoke.py            # from the repository root, one GPU

Phases, each of which fails the run (nonzero exit, no result line):

1. Header: the card's name and power limit, torch and CUDA versions, the
   TF32 flags, and the build of every CUDA kernel from ``src/repro_torch/csrc``
   (fifteen sources: K1-K4, K7, K6, K8, K9, K10a-c, K5 and the backwards
   of K7, K8 and K9; one ``nvcc`` per source, all started together; K9 and
   K9's backward include the shared bf16 ``mma.sync`` staging
   ``csrc/mma_bf16.cuh``; K1, K2, K4 and K10a include the shared
   3xTF32 products mainloop ``csrc/conv_tf32.cuh``, K3 and K10c the int8
   products and epilogue ``csrc/q8_mma.cuh``), with each build's seconds and
   its ptxas register and spill lines, each under its kernel's name.
2. K1 vs plain, serving: every distinct lane-aligned (shape, fused
   epilogue) signature of ResNet-50 at 224x224, batch 16, on random
   weights, BN scale, shift and residual: K1 against its plain PyTorch
   version (max |diff| / max |plain| <= 1e-5), each signature run twice on
   the same inputs (the same bits), with its route (``conv2d_direct.route``:
   "mma", 3xTF32 on the tensor cores, for every one of them) and plan
   (tile, splits of the reduction, chunk, blocks), K1's CUDA-event and
   profiler device times (a split's sum pass included), the plain
   version's, the library yardstick's (cuDNN ``F.conv2d`` in true f32 plus
   the epilogue), and both bounds: f32 SIMT (the larger of FLOPs / 67
   TFLOP/s and bytes / 3.35 TB/s) and 3xTF32 (3 x the FLOPs at the TF32
   rate, or the bytes).
3. Serving: full ResNet-50 (1000 classes, 224x224) with random BN running
   statistics through ``CnnInferenceEngine`` and ``ImageServer`` at
   max_batch 16 (warmup with ``autotune="off"``, the requests under the
   engine's "cache" scope on a cold plan cache: every launch takes the
   kernel's default plan, as in phases 6, 7b, 10 and 23): an untimed pass
   of 64 requests, then a window of 512
   requests in bursts that reach every bucket (1 to 16), with every image
   made before the window opens.  Images/s is over the window's wall time;
   p50/p99 are enqueue-to-result.  K1's launch count is reset just before
   the window and read just after: it must be 52 per forward, every one on
   the mma route (``launches_mma``).  Then the
   time of one batch-16 step by host clock: the copy to the card, the
   forward, and K1's share.
4. Serving parity: a batch of 2 images on the card against the port's CPU
   forward (the plain versions): max |diff| <= 1e-4 * max |logit| and the
   same top-1 on every image.
5. K3 vs plain: the same 23 signatures at batch 16, int8 operands from
   ``quantize_conv_inputs`` on random f32, random BN scale, shift and
   residual: K3 against its plain version, max |diff| = 0 on every one on
   both routes (``conv2d_q8.route``: "ring" for all of them, and "sync"
   forced), the ring route the same bits twice, plus an integer-exact case
   on both routes; per signature the route, ``ring_plan``'s tile, stage
   channels, stages, splits and CTAs, and both routes' CUDA-event and
   profiler device times; the 52-conv sums against the aims and the six
   small-grid signatures' speedups; CUDA-event times of K3, the plain version,
   K1's f32 time from phase 2 and, on the 1x1 signatures, the library
   yardstick ``torch._int_mm`` with the dequant and epilogue in torch (for
   stride 2 on the strided slice); the bound is the larger of int8 ops /
   1979 TOP/s and bytes / 3.35 TB/s.
6. int8 serving: the same ResNet-50, params and BN statistics as phase 3
   through ``CnnInferenceEngine(quantized=True)`` at max_batch 16; warmup
   calibrates on the reference's default synthetic batches.  The window of
   phase 3 (64 untimed, then 512 in bursts), with images/s, p50 and p99
   beside phase 3's f32 figures; K3 must launch exactly 52 times per
   forward, every one on the ring route (``launches_ring``), and K1 not at
   all.  Then one batch-16 step by host clock (H2D,
   forward), K3's device time per forward, and the device time of the
   ``quantize_act`` glue on that forward's 53 conv inputs.
7. int8 parity: a batch of 2 on the card against the port's CPU int8
   forward on the same quantized params tree: max |diff| <= 1e-3 *
   max |logit| and the same top-1; it prints how many quantized
   activations differ by one step between the two, and the int8-vs-f32
   logit gap and top-1 agreement on the card (printed, not gated: a
   property of the quantization scheme).
7b. Inception-v3 serving: Inception-v3 (1000 classes, 299x299, random
    weights and BN statistics from seed 7) through the same engine and
    window as phase 3, f32 and then int8 (its own calibration), tiled:
    images/s and p50/p99 beside ResNet-50's from phases 3 and 6; K1 (f32)
    or K3 (int8) exactly 23 launches per forward, all on the mma or ring
    route, the other kernel none; a batch of 2 on the card against the
    port's CPU forward (int8: the card's quantized tree) within 1e-4 (f32)
    or 1e-3 (int8) * max |logit|, the same top-1.
8. K1 in training: every distinct lane-aligned signature one ResNet-50
   training step at batch 32 launches on K1, the bare forwards and the
   backward-data dual convs of ``dual_conv_signatures`` (31 distinct, 61
   launches), against the plain version (<= 1e-5), with phase 2's route,
   plan, same-bits check, event and device times, the cuDNN yardstick and
   both bounds.
9. K2 vs plain: the 22 distinct lane-aligned weight-update signatures of
   ResNet-50 at batch 32 (<= 1e-5), each run twice on the same inputs (the
   same bits), with its route (``conv2d_wu.route``: "mma", 3xTF32 on the
   tensor cores, for every one of them), tile, ``splits`` and chunk, its
   time by CUDA events and by profiler device time (the reduction pass
   included), both bounds (f32 SIMT; 3 x the FLOPs at the TF32 rate), and
   the library yardstick: cuDNN's f32 weight gradient
   (``aten.convolution_backward``, output mask [False, True, False], TF32
   off), which the port never calls.
10. Training: full ResNet-50 (224x224, 1000 classes, batch 32, lr 0.1)
    through ``launch.train_cnn.build_trainer`` on ``SyntheticImageData``
    batches put on the card before timing: 2 untimed steps, 10 timed steps
    (median step ms, images/s, every loss finite), one step with the launch
    counts set to 0 just before it and read just after (K1 = forward +
    dual launches, K2 = one per lane-aligned conv, both derived from the
    port's ETG, every K1 and every K2 launch on the mma route by each
    module's ``launches_mma``), then
    3 steps under ``torch.profiler``: device time by kernel, the device's
    busy and idle share, K1 and K2 per step.
11. Training parity: one step of full ResNet-50 at batch 2 on the card
    against the same step on the port's CPU path (the plain versions) from
    the same params and batch: the loss within 1e-4 relative; every
    trainable leaf's update (old - new) / lr, and the change of every
    running mean and variance, within 1e-3 * max |CPU|.  ReLU and max-pool
    are discontinuous: a pre-activation within f32 rounding of zero, or two
    pooled values within rounding of each other, may be decided differently
    by two summation orders, and then a whole pixel's gradient moves.  So
    the CPU step takes the card's ReLU masks and max-pool choices, and the
    script prints how many of them the CPU would have decided otherwise.
    A ReLU mask is taken both ways: the forward's (x > 0) and the
    backward's (``clamp_min`` passes the gradient where x >= 0, so a
    pre-activation of exactly 0 passes it).
12. K4 vs plain: the same 23 serving signatures at batch 16 with random
    bias, ReLU where the signature fuses it, under the analytic "streams"
    blocking (``core.blocking``, autotune off): K4 against its plain
    replay of the same schedule (max |diff| / max |plain| <= 1e-5) under
    order nkpc and one other order, and once on a schedule whose runs are
    shuffled (``core.streams.permute_runs``), which must give the same
    bits as the runs in order; every one of these launches on the mma
    route (``conv2d_streams.route``; held by ``launches_mma``); per
    signature the route, the mma CTA sub-tile (``mma_tile_config``), the
    steps and RLE segments, K4's CUDA-event and profiler device times on
    the mma route and with the SIMT route forced, the plain replay's, K1's
    with the same bias and ReLU, the library yardstick (cuDNN
    ``F.conv2d`` in true f32 plus bias and ReLU) and both bounds (f32
    SIMT; 3 x the FLOPs at the TF32 rate).
13. Tuned replay, the slice's main path: ``tune.warmup_convs`` on every
    serving shape at batch 16, kind "streams", mode "tune", into a cache
    in a temporary directory (``REPRO_TUNE_CACHE``): the cost model's 8
    best candidates of each (ranked by the model of the route K4 takes)
    are timed on the card, every launch on the mma route; every entry must
    say "measured".  Then ``conv2d_streams_auto(autotune="cache")`` runs
    each signature once with K4's counts set to 0 just before and read
    just after (one launch each, all on the mma route), no candidate timed
    and every lookup a hit; each result within 1e-5 of the plain replay;
    per signature the route, the tile, the tuned times on the mma route
    and with the SIMT route forced, the analytic ones and K1's, and per
    52-conv forward.
13b. The plan tuner (§II-D over K1, K2 and K3), into a cache in a
    temporary directory: ``CnnInferenceEngine.warmup(autotune="tune")``
    on an f32 and an int8 ResNet-50 engine (kinds "fwd" and "q8", every
    bucket) and ``warmup_cnn_train`` at batch 32 (kinds "fwd", "bwd" on
    the 31 distinct dual convs, "wu" on the 22 weight updates); at most 8
    plans timed a signature by device time (``tune.measure.device_us``),
    the kernel's default among them, every launch on the mma or ring
    route.  Per signature at batch 16 (serving) and 32 (training): the
    tuned launch against the plain version (K1, K2 <= 1e-5; K3 the same
    bits), the tuning pass's default and tuned times and candidates timed,
    and both plans timed again in turns on one set of inputs, the tuned
    no more than 3 % above the default; the sums per 52-conv forward (f32,
    int8) and per step (forward, dual, weight update).  Then the f32 and
    int8 windows of phases 3 and 6 and ten training steps, each with the
    default plans (autotune "off") and under "cache" in turns: images/s,
    p50/p99, step ms, 52 K1 or K3 launches a forward and 113 K1 + 52 K2 a
    step on the mma or ring route, no candidate timed.
14. K7 vs plain: flash attention at Qwen2-1.5B's prefill shapes (12 query
    and 2 KV heads, Dh 128; L 128, 333 and 1024 at batch 1 and 8; causal,
    and one non-causal case) and one SmolLM-360M shape (15 / 5 heads, Dh
    64), in f32 and bf16: max |diff| / max |plain| <= 1e-5 (f32) and
    <= 1e-2 (bf16); K7 by CUDA events and by profiler device time, the
    plain version, the library yardstick ``F.scaled_dot_product_attention``
    (used only here) and the bound, the larger of FLOPs (4 B Hq Dh L(L+1)/2
    when causal) over the dtype's peak (989 TFLOP/s bf16 tensor cores, 67
    TFLOP/s f32 SIMT) and bytes over 3.35 TB/s.  Each shape's route
    (``attention.route``) is printed and held: bf16 through the TMA +
    wgmma kernel, f32 through the SIMT one, with one wgmma launch for each
    bf16 call; each bf16 shape is also timed (profiler device time) at
    both key blocks of the wgmma kernel, 64 and 128, the measurement
    behind ``attention.wgmma_key_block``, and SDPA by device time too;
    each bf16 shape's output must be the same bits when the kernel also
    writes each row's log-sum-exp for the backward, and that lse must
    come within 1e-4 of max |lse| of ``attention.lse_plain``.
15. K6 vs plain: the fused matmul at Qwen2-1.5B's projections at M = 4096
    tokens (1536->1536 + bias, 1536->256 + bias, 1536->8960 silu,
    8960->1536 + residual, one gelu and one relu case), f32 and bf16, and
    two ragged bf16 cases (M 1000, N 1000; K 1528 on the wgmma route with
    tails, K 1530 on the SIMT route), with the same limits, times and
    bound; the yardstick is ``torch.matmul`` in the input dtype with the
    epilogue in torch (TF32 off).  Each shape's route is printed and held
    (bf16 through the wgmma kernel, f32 through the SIMT one), and the
    wgmma launches of the first pass over the six bf16 shapes must be 6;
    then the bf16 sum beside the library's and the bound.  Then each of
    the twelve M = 4096 shapes is tuned (``tune.autotune_matmul`` into a
    temporary cache: every ``MatmulPlan`` of its route timed by device
    time, the default kept unless another is 2 % faster), every candidate
    plan's output held to the same limit, and the default plan's device
    time printed beside the tuned one's.  No model path calls K6, in the
    reference either: its launches are this phase's.
16. LM serving, the slice's main path: full Qwen2-1.5B (28 layers, bf16,
    random weights from ``init_lm`` with seed 0) through
    ``launch.serve.serve_continuous`` with 8 lanes, max_len 2048, 32 new
    tokens per request: an untimed pass of 8 requests, then a window of 32
    requests whose prompt lengths are uniform in 128-1024
    (``numpy.random.default_rng(0)``), all made before the window opens.
    Generated tokens/s over the window's wall time; K7's count, set to 0
    just before the window and read just after, must be 28 x 32 (one
    launch per layer of each prefill; decode launches none), all of them
    through the wgmma route (``launches_wgmma``).  Then,
    through ``forward`` and ``decode_step``: a batch-8 prefill at 512
    tokens by host clock and CUDA events, 16 decode steps (p50 / p99 ms per
    step, K7 launched 0 times), and both under ``torch.profiler``: device
    time by kernel, K7's share of the prefill, the busy share, and the
    traced prefill's K7 launches by route (kernel name): 28 through wgmma.
17. LM parity: full Qwen2-1.5B in f32, the same params on the card and on
    the CPU (plain versions): two 64-token prompts, prefill logits within
    1e-4 * max |logit| and the same last argmax, then 4 teacher-forced
    decode steps (both fed the CPU's tokens) within the same limit, with
    the argmax agreement printed.
18. K8 vs plain: the depthwise causal conv1d at the Jamba cut's Mamba
    shapes (d_inner 16384, 4 taps, bias and SiLU: L 1, 333 and 1024 at
    batch 1, 512 at batch 8; the last two also on x read in place as the
    mixer passes it, half of a (B, L, 32768) projection, the layout the
    kernels line is timed on) and one tail case (2, 77, 1003), f32 and
    bf16, with the limits of phase 14, on both routes: the route taken
    (``conv1d_causal.route``: "tile" for every D = 16384 shape, "thread"
    for the tail) and the thread route forced; K8 by CUDA events and
    profiler on each, the device time with ``act="none"`` on each at bf16,
    the plain version, cuDNN's depthwise ``F.conv1d`` as the yardstick, the
    bound (bytes over 3.35 TB/s).
18b. K9 vs plain: the grouped MoE matmul at (a) the cut's decode, 16
    routed rows of batch 8 spread over the 8 held experts in tiles of 16,
    and (b) a batch-8 x 512 prefill's rows from the layer's router on
    random activations (its groups, capacity, drops and layout), each at
    D 8192 -> F 24576 (gate/up) and 24576 -> 8192 (down), f32 and bf16,
    and (b') one 256-token prompt's rows (tiles of 64), bf16, both shapes;
    (c) ``benchmarks/moe_streams_bench.py``'s shapes (T 512, D 128, F 256,
    E 8, cap 128, bm 64) through ``route_dryrun``, f32; (d) T, D, F that
    are multiples of no block, with a -1 tile, f32 and bf16; with the
    limits of phase 14; K9 by CUDA events and profiler, the plain version,
    the library yardstick (one ``torch.bmm`` over the capacity-padded (E,
    C, D) x (E, D, F), the port's replay before K9), for (c) the bench's
    dense every-expert einsum, and the bound (FLOPs of the rows with a
    token over the dtype's peak, bytes of the rows, the weights of the
    experts that have rows and the output over 3.35 TB/s) with K9's share
    of it.  Held: the bf16 decode with all 16 rows on one expert takes
    under half the time of 16 rows over 8 (empty experts' weights are not
    read); each case gives the same bits on a second run.  Each case's
    route (``moe_gmm.route``) is printed and held: the bf16 prefill cases
    through the TMA + wgmma kernel, the bf16 decode through the TMA weight
    stream (its sum pass timed with it), f32 and the tail through the mma
    one.
19. Hybrid serving, the slice's main path: ``jamba-1.5-large-398b-1chip``
    (one 8-layer period of Jamba-1.5-Large at full width, 8 of each MoE
    layer's 16 experts, bf16, 51.8 GB) through ``serve_continuous`` with
    phase 16's lanes, lengths and window: K8's count must be 7 x 32, every
    one on the tile route (``launches_tile``, and 7 a traced prefill by
    kernel name), K7's
    1 x 32 and K9's 12 x the forward and decode_step calls the scheduler
    counted (3 per MoE layer, 4 MoE layers), K7's and K9's forward
    launches all through the wgmma route (every K9 call with bm >= 64,
    counted by bm in the window; every decode call, bm 16, counted by
    route and held to the stream route by ``launches_stream``);
    then a batch-8 prefill at 512
    tokens and 16 decode steps (K9 12 a step, K7 and K8 none), with the
    held experts that receive rows per MoE layer and step, K9's device ms
    per traced decode step beside its bytes bound (the weights of the held
    experts with rows in every MoE layer the trace ran), one prefill and
    one decode step with ``moe.apply`` under
    ``torch.cuda.set_sync_debug_mode("error")`` (a host synchronisation
    in the layer fails the run), and both under ``torch.profiler`` with
    K8's, K7's, K9's, the selective scan's and the MoE replay's
    (``moe.experts``) shares, launches per decode step and the busy share;
    the parameter bytes and ``torch.cuda.max_memory_allocated()``.
20. Hybrid decode vs forward on the card, capacity factor 16 (dropless,
    as ``tests/test_decode_parity.py``): ``launch/decode_parity.measure``
    prefills 96 tokens at batch 2 and runs 8 decode steps, against
    ``forward`` over all 104, K8 launched 0 times by decode.  On the served
    bf16 params it is printed; on the f32 params of phase 21 it is held to
    1e-3 * max |logit|.  The bf16 model is not held to a limit: this
    random-weight model moves its logits by more than 2e-2 of their
    maximum under any other rounding of its bf16 activations, in the JAX
    reference too (``tests/torch_bf16_witness.py``; the diagnosis with the
    routing pinned is ``python -m repro_torch.launch.decode_parity``).
21. Hybrid parity: the cut in f32 holding 2 experts of 16 (45.7 GB on
    each side; 1 expert if the host has not 55 GB available, which
    ``free -g`` and the script print), card vs CPU: a 64-token and a
    100-token prompt (whole scan chunks, a ragged one), prefill and 4
    teacher-forced decode steps within 1e-4 * max |logit|, the same last
    argmax.  Phases 20 and 21 run K9 on the card (its f32 instance here).
22. K10a vs plain and vs K1: the 23 serving signatures of phase 2 with
    their epilogues at batch 16, under the reference's whole-plane blocking
    (``core.conv.whole_blocking``: ``conv_blocking`` at the reference's
    budget, kind "fwd"): K10a against its plain version (max |diff| /
    max |plain| <= 1e-5), its difference from K1 printed; K10a by CUDA
    events and profiler device time, the plain version, K1's time, cuDNN
    plus epilogue and both bounds from phase 2; per signature its route
    (``route_whole``: "mma" for every one), rb_p, k_blk, the rows a pass
    takes, the shared memory, and the CTA-floor question: the CTAs of the
    reference's grid and of the grid with each reference block's rows cut
    across CTAs (``whole_slices``), both run twice (the same bits, and the
    same bits as each other) and timed by events and device time, and the
    side ``whole_split`` takes, whose times are the signature's.
23. Whole-plane f32 serving: phase 3's engine on phase 3's params and BN
    statistics under ``use_conv_tiling("whole")``: 32 untimed requests,
    then a window of 128 (cut from 512: it keeps the script within its time
    limit); images/s and p50/p99 beside phase 3's; K10a exactly 52 per
    forward, all on the mma route (``launches_whole_mma``), K1 none; a
    batch-16 forward's logits within 1e-4 * max |logit|
    of the tiled engine's on the same batch, the same top-1; that forward
    under the profiler.
24. K10c vs plain and vs K3 on the 23 signatures (int8 operands as phase
    5, the reference's q8 blocking), max |diff| 0 to each; per signature
    its route (``conv2d_q8.route_whole``: "mma" for every one), the CTAs of
    the reference's grid and of its cut (rows, ``whole_rows_cta``, and
    output channels, ``whole_k_cta``), the ring's stages, and K10c run
    three ways, twice each, all with the same bits: the mma route uncut
    and cut, and the ``__dp4a`` route
    forced, each timed by CUDA events and profiler device time (the
    record's time is the side ``whole_split`` takes), K3's from phase 5 and
    the bound; the sums per forward and on the 1x1 convs beside
    ``torch._int_mm``'s; then one int8 forward at batch 16 on phase 6's
    quantized tree under ``whole``: 52 K10c launches, all on the mma route
    (``launches_whole_mma``), no K3, logits equal bit for bit to the tiled
    int8 forward's, and that forward under the profiler.
24b. Chains (``REPRO_CHAIN_FUSION``, ``chains_phase``): full ResNet-50 at
    batch 16 on phase 3's params, the knob on against off under both
    tilings, at the default chain budget (16 MiB: all 16 chains fused, one
    band each) and at the reference's 1 MiB (``chain_budget_forced``: its 7
    chains in 4-10 bands, the other 9 layer by layer), each from one
    forward with the counts set to 0 just before it and read just after:
    the logits bit for bit, the chains fused and unfused, K1's (K10a's)
    launches, all on the mma route; each fused chain run again fused and
    layer by layer on its recorded input (bit for bit, one launch a band
    and lane-aligned layer, all mma), with its rb, bands, largest hand-off
    band and intermediate activation beside the 50 MB L2; tiled, the
    forward off, on and on at 1 MiB timed in turns by host clock and once
    each under the profiler.  Then phase 6's int8 tree with the knob on (no
    chain fuses: the same bits, 52 K3 launches on the ring) and
    Inception-v3 at 299x299 (phase 7b's params) at both budgets: 7 and 5
    chains fused; the stem chain's C=3 layer takes cuDNN on each band, so
    it and the logits are held to the f32 limits (1e-5 of max |out|, 1e-4
    of max |logit|, the same top-1) where the bits differ.
24c. The whole-plane blockings tuned (``whole_plan_tuning``), phase 13b
    under ``whole``: the serving warmups ("fwd_whole", "q8_whole" at every
    bucket) and ``warmup_cnn_train`` ("fwd_whole", "bwd_whole",
    "wu_whole" at batch 32) into a temporary cache, at most 8 blockings
    timed a signature, the analytic one among them; per signature the
    tuned launch against its plain version (K10a, K10b <= 1e-5, K10c the
    same bits) and the analytic and tuned blockings timed again in turns
    (the tuned at most 1.03x the analytic), the sums per forward and per
    step; whole serving (f32, int8) and the whole training step with the
    analytic blockings and under "cache", in turns, and once each under
    the profiler.
25. K10b vs plain and vs K2 on the 22 weight-update signatures at batch 32,
    b_p from ``conv_blocking(require_divisor=True, kind="wu")`` (<= 1e-5),
    run twice on the same inputs (the same bits), with each signature's
    split (``plan_whole``: runs of whole (n, p_b) steps, blocks a grid),
    times (device time of the split kernel and the sum pass), K2's, cuDNN
    dW and the bound from phase 9.
26. Whole-plane training: full ResNet-50 at batch 32 under ``whole``: one
    untimed step, then 3 timed steps with the launch counts set to 0 just
    before each and read just after (K10a 113 = 52 forward + 61 dual, all
    on the mma route, K10b 52, K1 and K2 none), step ms and images/s beside
    phase 10's, the same steps timed with every reference block whole and
    with every one cut as ``whole_slices`` cuts it (the CTA-floor question
    at the step), 2 steps under the profiler (K10b's time holds its sum
    pass); then phase 11's
    card-vs-CPU step and limits under
    ``whole``, ReLU and max-pool decisions pinned as there.
27. K5's entry point at the stem pool (16, 112, 112, 64) f32, 3x3 s2 p1,
    and on the reference test's three cases (3,2,1,12), (2,2,0,8),
    (3,1,1,7), its count set to 0 just before the four calls and read
    just after (4); each against its plain version and ``F.max_pool2d``
    (max |diff| 0); the times of K5 (events, profiler), the plain version
    and ``F.max_pool2d`` at the stem pool against the bytes bound (51.4 MB
    read, 12.8 MB written: 0.0192 ms at 3.35 TB/s).
28. K7's backward (``flash_attention_bwd``, ``csrc/flash_attention_bwd.cu``)
    against ``flash_attention_bwd_plain`` at Qwen2-1.5B's training shape
    (batch 8, 512 tokens, Hq 12, Hkv 2, Dh 128, causal), SmolLM-360M's
    (Hq 15, Hkv 5, Dh 64), a tail (L 333), a non-causal case and the
    smoke configs' Dh 16, each in f32 and bf16: max |diff| / max |plain|
    of dq, dk and dv (<= 1e-5 f32, <= 1e-2 bf16), the same bits on a second
    call; each row's route (``attention.route_bwd``, held: bf16 at Dh 64
    and 128 on the TMA + wgmma kernels, the rest on SIMT) and, on the wgmma
    route, its plan (``attention.wgmma_bwd_plan``: splits of the query
    heads); each call made as training makes it, with the
    forward's log-sum-exp; CUDA-event and profiler device times (every
    kernel of a call, the dq, dk/dv and split-sum kernels apart; the dk/dv
    kernel's records held to ``launches_bwd``), the plain version, the
    library yardstick (the backward of ``F.scaled_dot_product_attention``
    with K and V expanded, used only here) and both bounds (the FLOPs at
    989 TFLOP/s bf16 and at 67 f32 SIMT, or the bytes).  At each wgmma
    shape three more ways, each within the limit and the same bits twice,
    by profiler device time: the dk/dv kernel unsplit (when the plan
    splits), the dq kernel rebuilding lse (no lse given) and the SIMT route
    forced (``returning``).
29. LM training, this slice's main path: ``qwen2-1.5b`` (bf16, uncut,
    remat as configured) through ``launch.train.build`` (AdamW, f32 state,
    clip 1.0) on 8 x 512 ``SyntheticLMData`` tokens: one untimed step in
    which every attention layer's wq, wk and wv gradient must hold a
    nonzero, then 5 timed steps on the same batch with K7's counts set to
    0 just before and read just after (forward 56 a step under remat,
    backward 28, every forward and backward on wgmma), step ms p50 and max,
    tokens/s,
    each loss (finite, the last below the first), one step under the
    profiler (K7's backward device ms, matmuls, the rest, busy share) and
    the peak memory; then the Qwen2 family in f32 at Dh 64, 2 layers,
    vocab 1024, one step card vs CPU with ``accum_steps`` 1 and 2 through
    ``make_train_step`` with plain SGD at lr 1 (an update far above one
    f32 ulp of the params): the loss within 1e-4 relative,
    every update within 1e-3 * max |CPU update| (as phase 11's SGD step;
    AdamW's step printed beside, not held: it divides each element by
    its own gradient, so a nearly cancelling gradient's rounding sets the
    sign of its update).
30. RWKV-6 served: ``rwkv6-1.6b`` (bf16, uncut) through
    ``serve_continuous`` (8 lanes, 8 untimed then 16 requests of 128-512
    tokens, 32 new each; no port kernel on its path, K7 held to 0), a
    batch-8 prefill at 512 tokens and 16 decode steps with their
    profiles; then an f32 RWKV at d_model 1024, Dh 64, 2 layers, vocab
    1024, its bonus ``u`` drawn: card vs CPU prefill and 4 decode steps
    within 1e-4 * max |logit|, decode vs forward within 1e-3, and one
    training step within phase 29's limits.
31. Hybrid and MoE training, this slice's main path.  (a) K8's backward
    (``conv1d_causal_bwd``, ``csrc/conv1d_causal_bwd.cu``) against
    ``conv1d_causal_bwd_plain`` on dx, dw and db at the training cut's
    Mamba shape (2, 512, 16384), x read in place from the input
    projection, SiLU and "none", with and without a bias, bf16, and on a
    reduced f32 shape and a ragged D in f32 and bf16 (the thread route):
    <= 1e-2 (bf16), <= 1e-5 (f32) of max |plain|, the same bits twice;
    each shape's route held ("tile" where rows start on 16-byte
    boundaries) and, on each tile case, the vec route forced on the same
    inputs and held the same way; events and device ms on both routes, the
    plain version, autograd of cuDNN's depthwise ``F.conv1d`` + SiLU and
    the bytes bound, with the tile route's share of it.  (b) K9's backward
    (``moe_gmm_bwd``, ``csrc/moe_gmm_bwd.cu``) against
    ``moe_gmm_bwd_plain`` on dtokens and dweights with the ``tile_eid``
    ``nn/moe.replay_plan`` gives one MoE layer of the cut for a 2 x 512
    batch (-1 tiles and a held expert without rows, forced if none), at
    the gate/up and down shapes in bf16, the same rows in tiles of 64
    (bf16, D 1032 -> F 1544), a reduced f32 shape and K9's tail case: the
    same limits, -1 rows and the empty expert exactly zero; each case's
    route held ("wgmma" for bf16 at bm 64 and 128, "mma" for the bf16
    tail, "simt" for f32) and, on each wgmma case, the mma route forced on
    the same inputs and held the same way; events and device ms on both
    routes (dtokens and dweights kernels apart), the plain version,
    ``torch.bmm`` over capacity-padded experts and the bound (the larger
    of 4 x routed rows x D x F at 989 TFLOP/s and the bytes), with the
    wgmma route's share of it and its verdict against its aim.  (c)
    ``jamba-1.5-large-398b-train-1chip`` (bf16, 2 layers at the published
    widths, 4 of 16 experts held, remat) through ``launch.train.build``
    (factored AdamW, bf16 ``m``) on 2 x 512 ``SyntheticLMData`` tokens: one
    untimed step (the Mamba layer's conv_w and conv_b gradients and every
    held expert's with rows nonzero), 3 timed steps with K7, K8, K9 and
    their backwards' counts set to 0 just before and read just after (K8
    3 and K9 9 forward launches a step, K7 2: the forward, the block's
    checkpoint and, but for the period's last block, the period's; K8' 1,
    K9' 3 and K7's backward 1; K8 and K8' on their tile routes, K9 and
    K9' on wgmma, K7 and its backward on wgmma), step ms p50 and max,
    tokens/s, losses finite and falling; one step under the profiler (each
    kernel's records held to its count; device ms by kernel group, busy
    share) and the peak memory (at most 72 GB).  (d) f32 card-vs-CPU steps
    of Jamba (its Mamba + MoE and attention + dense period) and
    Phi-3.5-MoE reduced to 2 layers at d_model 256 through ``twin_step``
    with plain SGD at lr 1, the CPU taking the card's MoE routing (the
    overridden decisions printed and held to at most PIN_MAX_OVERRIDDEN,
    2): loss within 1e-4 relative, updates
    within 1e-3 of max |CPU update|.
32. Data-parallel and resilient training, this slice's main path: two
    rank processes share the card over a gloo group (``launch.ranks``, a
    ``file://`` rendezvous; NCCL refuses two ranks on one device), each
    building full ResNet-50 (1000 classes, 224x224, params from seed 0)
    with cuDNN's deterministic algorithms for the stem conv.  (a) Identical
    shards (16 images on both ranks), the f32 reduction: one step with
    K1 and K2's counts set to 0 just before and read just after (113 and
    52 a rank, all on the mma route, the single-device step's at batch 16)
    and each rank's params and loss equal to the single-device
    ``make_cnn_train_step`` bit for bit; the step's ms p50 by host clock.
    (b) Distinct shards (phase 10's batch of 32 as 2 x 16): the step
    against the reference's semantics computed on the card (each half's
    loss, gradients and BN statistics from ``GxM.local_grads``, the first
    half of the single-device ``GxM.sgd_train_step``, averaged, then its
    second half ``apply_sgd``: one SGD step, ``apply_bn_updates``) within
    1e-6 of max |expected
    update| and 1e-6 relative on the loss, the bits' equality printed.
    The f32 and int8 reductions of one gradient tree alone: ms by host
    clock and bytes.  (c) The int8 reduction, 4 steps: each step's reduced
    gradient equal, bit for bit, to ``compressed_psum``'s formula applied
    on the card to both ranks' gathered gradients and residuals; n x mean
    + the new residuals within 1e-6 of max |g| of the gradients plus the
    old residuals, leaf by leaf; losses finite.  A checkpoint of the
    gathered int8 state: save and restore seconds.  (d) Resilience: the
    int8 run through ``ResilientLoop`` (checkpoints every 2 steps, rank 0
    writes) for 6 steps, uninterrupted and under a ``ChaosSchedule`` that
    corrupts the newest checkpoint and faults the step at step 5: one
    restart from step 2 past step 4, and the final params and residual
    equal to the uninterrupted run's bit for bit.  (e) A 2 -> 1 elastic
    re-scale (``elastic_reshard_cnn`` onto a one-rank group) from the last
    checkpoint keeps the residual's sum exactly.  (f) The data-parallel LM
    step of phase 29's reduced f32 Qwen2 (Dh 64, 2 layers, vocab 1024) on
    2 x 128 tokens a rank against the single-device step on 4 x 128,
    plain SGD at lr 1: loss within 1e-4 relative, updates within 1e-3 of
    max |update|.  A rank that fails a check fails the phase.  The
    phase's working directory (the ranks' logs and the checkpoints of
    full ResNet-50) is removed at its end.
33. The whole-plane, Inception-v3, plan-tuning, chains, whole-plane
    tuning, LM serving, LM training, RWKV serving, hybrid training,
    data-parallel training and hybrid serving summary lines, the int8 serving and training summary
    lines, every phase's seconds and the run's against its 1200 s budget
    (each phase's also printed as it ends), the kernels line (K1, K2, K3,
    K4, K7, K6, K7's backward, K8, K9, K8's and K9's backwards, K10a, K10b,
    K10c, K5; K1, K2 and K3 with their launches under tuned plans, K1 and
    K2 with both ranks' data-parallel step, K6 with its tuned device
    times), then the device line last.

Device times by kernel come from ``trace_device``: a ``torch.profiler``
trace with one warm-up step, whose recorded launches of each port kernel
must equal the wrapper's count over the traced iterations (a short trace
fails the run).  Each model is freed before the next is built: Qwen2-1.5B
3.1 GB (with its training state 18.5 GB), the Jamba cut 51.8 GB, the
parity pair 45.7 GB, RWKV-6 3.0 GB, the Jamba training cut 9.3 GB (with
its gradients, AdamW state and activations at most 72 GB).

It imports nothing of JAX or of the JAX package ``repro``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

T_IMPORT = time.perf_counter()
ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")
SEED = 0
BATCH = 16
IMAGE = 224
REQUESTS = 512
TRAIN_BATCH = 32            # torchvision's ResNet-50 recipe, per GPU
TRAIN_LR = 0.1
PARITY_BATCH = 2
KERNEL_REL_TOL = 1e-5
LOGIT_REL_TOL = 1e-4
INT8_LOGIT_REL_TOL = 1e-3   # card vs CPU int8 forward, one quantized params tree
LOSS_REL_TOL = 1e-4
UPDATE_REL_TOL = 1e-3
PINNED_SHARE_TOL = 1e-5     # ReLU / max-pool decisions the CPU takes from the card


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` launches, warm, by CUDA
    events around the whole run."""
    import torch
    fn()
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


RUN_BUDGET_S = 1200          # the whole run, the kernels' builds included
PHASE_SECONDS = {}           # phase -> seconds, in the order they ran


@contextlib.contextmanager
def phase(name: str):
    """Times the block as phase ``name``: its seconds go into
    PHASE_SECONDS and on a line of their own as it ends."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        PHASE_SECONDS[name] = time.perf_counter() - t0
        print(f"  phase {name} in {PHASE_SECONDS[name]:.1f}s", flush=True)


@contextlib.contextmanager
def returning(module, name: str, value):
    """``module.name`` replaced, for the block, by a function that returns
    ``value``: a route or a rule forced, to time the side it does not take.
    Only this script calls it."""
    rule = getattr(module, name)
    setattr(module, name, lambda *a, **kw: value)
    try:
        yield
    finally:
        setattr(module, name, rule)


def header():
    import torch
    from repro_torch.backend import resolve_device
    from repro_torch.kernels import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    check(bool(smi), "nvidia-smi printed no card")
    print("card (nvidia-smi name, power.limit):")
    print(smi[0])
    device = resolve_device(None)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}, "
          f"{torch.cuda.device_count()} device(s)")
    print(f"tf32: cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
          f"cuda.matmul.allow_tf32="
          f"{torch.backends.cuda.matmul.allow_tf32}")
    check(not torch.backends.cudnn.allow_tf32
          and not torch.backends.cuda.matmul.allow_tf32, "TF32 still on")
    t0 = time.perf_counter()
    seconds = _build.build_all()
    print(f"kernel build: {len(seconds)} sources in parallel in "
          f"{time.perf_counter() - t0:.1f}s")
    for name, sec in seconds.items():
        print(f"  {name}: {sec:.1f}s")
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print("    ptxas:", line.strip())
    return smi[0], device


def bound(flops: float, nbytes: float, int8: bool = False) -> tuple[float, str]:
    """The least time the card could take, ms, and what bounds it: the
    H100 peaks of ``repro_torch.launch.roofline`` (f32 SIMT, or int8 tensor
    cores), the ones the tuner's cost model uses."""
    from repro_torch.launch import roofline
    return roofline.bound_ms(flops, nbytes, roofline.INT8_PEAK_OPS if int8
                             else roofline.F32_PEAK_FLOPS)


K1_NEEDLE = "conv2d_direct_kernel"      # both routes' kernel names hold it
K1_SPLIT_SUM = "direct_split_sum"       # the mma route's split sum pass


def k1_case(args: dict, *, n: int, p: int, q: int, c: int, k: int, r: int,
            s: int, flops: float, nbytes: float, what: str) -> dict:
    """K1 on one signature (phases 2 and 8): its route and, on the mma
    route, its plan; two runs on the same inputs, which must give the same
    bits; CUDA-event and profiler device times (a split's sum pass
    included), both bounds (f32 SIMT; 3 x the FLOPs at the TF32 rate, or
    the bytes).  Returns the record and the first run's output."""
    import torch
    from repro_torch.kernels import conv2d_direct as k1
    from repro_torch.launch import roofline

    path = k1.route(args["x"], args["w"])
    plan = k1.mma_plan(n=n, p=p, q=q, c=c, k=k, r=r, s=s) \
        if path == "mma" else None
    out = k1.conv2d_direct(**args)
    again = k1.conv2d_direct(**args)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(out).all()), f"K1 non-finite at {what}")
    check(torch.equal(out, again), f"K1 ({path} route) gave other bits on a "
          f"second run at {what}")
    ms = cuda_ms(lambda: k1.conv2d_direct(**args), 20)
    device_ms, _ = kernel_device_ms(lambda: k1.conv2d_direct(**args),
                                    K1_NEEDLE, k1, also=(K1_SPLIT_SUM,))
    bound_ms, bound_by = bound(flops, nbytes)
    mma_bound_ms, mma_bound_by = roofline.bound_ms(
        3 * flops, nbytes, roofline.TF32_PEAK_FLOPS)
    rec = dict(route=path, tile=plan.tile if plan else None,
               splits=plan.splits if plan else 1,
               chunk=plan.chunk if plan else None,
               blocks=plan.blocks if plan else None, ms=ms,
               device_ms=device_ms, bound_ms=bound_ms, bound_by=bound_by,
               mma_bound_ms=mma_bound_ms, mma_bound_by=mma_bound_by,
               flops=flops)
    del again
    return rec, out


def serving_signatures() -> dict[tuple, int]:
    """Every distinct lane-aligned (shape, fused epilogue) signature of one
    ResNet-50 forward at IMAGE x IMAGE, with how many conv tasks share it."""
    from repro_torch.core.conv import lane_ok
    from repro_torch.graph import build_etg, resnet50
    from repro_torch.graph.serving import conv_shapes

    etg = build_etg(resnet50())
    by_name = {t.name: t for t in etg.tasks}
    sigs: dict[tuple, int] = {}
    for sh in conv_shapes(etg, (IMAGE, IMAGE)):
        if not lane_ok(sh["c"], sh["k"]):
            continue
        fused = tuple(kind for kind, _ in by_name[sh["name"]].fused)
        key = (sh["h"], sh["w"], sh["c"], sh["k"], sh["r"], sh["s"],
               sh["stride"], sh["padding"], fused)
        sigs[key] = sigs.get(key, 0) + 1
    return sigs


def kernel_signatures(device, sigs):
    """Phase 2.  Returns per-signature records, each with ``count``: how
    many conv tasks of one ResNet-50 forward share it."""
    import torch
    from repro_torch.kernels import conv2d_direct as k1
    from repro_torch.kernels import ref

    gen = torch.Generator(device=device).manual_seed(SEED)
    rows = []
    print(f"\nK1 vs plain, ResNet-50 {IMAGE}x{IMAGE} batch {BATCH} "
          f"({len(sigs)} signatures, {sum(sigs.values())} convs):")
    print("  h  w    c    k r st fused         count route tile splits "
          "chunk blocks  max_rel    max_abs        ms device_ms  plain_ms "
          "library_ms  bound_ms mma_bound_ms")
    for (h, w, c, k, r, s, st, pad, fused), count in sigs.items():
        p = (h + 2 * pad - r) // st + 1
        q = (w + 2 * pad - s) // st + 1

        def randn(*shape, std=1.0):
            return torch.randn(shape, generator=gen, device=device) * std

        args = dict(
            x=randn(BATCH, h, w, c),
            w=randn(r, s, c, k, std=math.sqrt(2.0 / (r * s * c))),
            stride=st, padding=pad,
            scale=torch.rand(k, generator=gen, device=device) + 0.5,
            shift=randn(k, std=0.1),
            residual=randn(BATCH, p, q, k) if "add" in fused else None,
            relu="relu" in fused)
        flops = 2.0 * BATCH * p * q * k * c * r * s
        nbytes = 4.0 * (BATCH * h * w * c + r * s * c * k + BATCH * p * q * k
                        + 2 * k
                        + (BATCH * p * q * k if "add" in fused else 0))
        rec, out = k1_case(args, n=BATCH, p=p, q=q, c=c, k=k, r=r, s=s,
                           flops=flops, nbytes=nbytes,
                           what=str((h, c, k, r, st, fused)))
        plain = k1.conv2d_direct_plain(**args)
        torch.cuda.synchronize()
        max_abs = float((out - plain).abs().max())
        max_rel = max_abs / float(plain.abs().max())
        plain_ms = cuda_ms(lambda: k1.conv2d_direct_plain(**args), 10)
        library_ms = cuda_ms(lambda: ref.conv2d_fused(**args), 50)
        rec = dict(h=h, w=w, c=c, k=k, r=r, s=s, stride=st, padding=pad,
                   fused=list(fused), count=count, max_rel_err=max_rel,
                   max_abs_err=max_abs, plain_ms=plain_ms,
                   library_ms=library_ms, **rec)
        rows.append(rec)
        print(f"{h:3d}{w:3d}{c:5d}{k:5d}{r:2d}{st:3d} "
              f"{'+'.join(fused):14s}{count:5d} {rec['route']:5s}"
              f"{rec['tile'] if rec['tile'] is not None else '-':>5}"
              f"{rec['splits']:7d}{rec['chunk'] or 0:6d}"
              f"{rec['blocks'] or 0:7d}  {max_rel:.2e}  {max_abs:.2e} "
              f"{rec['ms']:9.4f} {rec['device_ms']:9.4f} {plain_ms:9.4f} "
              f"{library_ms:10.4f} {rec['bound_ms']:9.4f} "
              f"{rec['mma_bound_ms']:12.4f}")
        check(max_rel <= KERNEL_REL_TOL,
              f"K1 disagrees with its plain version at {(h, c, k, r, st)}: "
              f"max_rel {max_rel:.3e} > {KERNEL_REL_TOL}")
    print(f"  per forward (x count): K1 {totals(rows)['ms']:.4f} ms by "
          f"events, {sum(r_['device_ms'] * r_['count'] for r_ in rows):.4f} "
          f"device; cuDNN + epilogue {totals(rows)['library_ms']:.4f}; "
          f"bounds {totals(rows)['bound_ms']:.4f} (f32 SIMT) and "
          f"{sum(r_['mma_bound_ms'] * r_['count'] for r_ in rows):.4f} "
          f"(3xTF32); launches by route "
          f"{ {path: sum(r_['count'] for r_ in rows if r_['route'] == path) for path in ('mma', 'simt')} }")
    print("  per-signature JSON:", json.dumps(rows))
    return rows


def random_bn_stats(params, gen):
    """Random BN running statistics and affine leaves, so the folded
    epilogue is not the identity."""
    import torch
    for p in params.values():
        if "var" not in p:
            continue
        k = p["var"].shape[0]
        dev = p["var"].device
        p["mean"] = (torch.randn(k, generator=gen) * 0.1).to(dev)
        p["var"] = (torch.rand(k, generator=gen) + 0.5).to(dev)
        p["scale"] = (torch.rand(k, generator=gen) + 0.5).to(dev)
        p["shift"] = (torch.randn(k, generator=gen) * 0.1).to(dev)


def serving(device):
    """Phase 3: the main path.  Returns (engine, K1 launches in it, the
    window's stats)."""
    import torch
    from repro_torch.core.conv import lane_ok
    from repro_torch.graph.serving import CnnInferenceEngine
    from repro_torch.kernels import conv2d_direct as k1
    from repro_torch.launch.serve_cnn import build_model, serve_window

    gxm, image = build_model(smoke=False, device=device)
    check(image == IMAGE and gxm.num_classes == 1000,
          f"ResNet-50 image {image}, {gxm.num_classes} classes")
    gen = torch.Generator().manual_seed(SEED)
    params = gxm.init(gen)
    random_bn_stats(params, gen)
    engine = CnnInferenceEngine(gxm, params, image_hw=(image, image),
                                max_batch=BATCH)
    t0 = time.perf_counter()
    report = engine.warmup(autotune="off")
    print(f"\nserving: warmup of buckets {report['buckets']} in "
          f"{time.perf_counter() - t0:.2f}s "
          f"({report['kernel_path_signatures']} of "
          f"{report['conv_signatures']} conv signatures on K1)")

    # serve_window sets the K1 count to 0 just before the measured window
    server, results = serve_window(engine, requests=REQUESTS, seed=SEED)
    launches, mma = k1.launches, k1.launches_mma
    st = server.stats()
    check(len(results) == REQUESTS, f"served {len(results)} of {REQUESTS}")
    check(all(0 <= c < 1000 and math.isfinite(v)
              for c, v in results.values()), "non-finite or bad top-1")
    convs = sum(1 for t in gxm.etg.tasks if t.op == "conv")
    per_fwd = sum(1 for t in gxm.etg.tasks if t.op == "conv"
                  and lane_ok(t.attrs["c"], t.attrs["k"]))
    print(f"  {REQUESTS} requests in {st['batches']} batches "
          f"{st['by_bucket']}, {st['padded_lanes']} padded lanes")
    print(f"  images/s {st['images_per_s']:.2f} over {st['wall_s']:.3f} s "
          f"wall  p50 {st['latency']['p50_ms']:.3f} ms  "
          f"p99 {st['latency']['p99_ms']:.3f} ms  (queue wait included)")
    check(set(st["by_bucket"]) == set(engine.buckets),
          f"buckets served {sorted(st['by_bucket'])}, not {engine.buckets}")
    print(f"  K1 launches {launches} = {per_fwd} of {convs} convs x "
          f"{st['batches']} forwards")
    check(per_fwd == 52, f"{per_fwd} lane-aligned convs per forward, not 52")
    check(launches == per_fwd * st["batches"],
          f"K1 launched {launches} times, expected {per_fwd * st['batches']}")
    print(f"  K1 launches on the mma route (launches_mma): {mma} of "
          f"{launches}")
    check(mma == launches, f"{mma} of the window's {launches} K1 launches "
          f"took the mma route, expected all")
    return engine, launches, st


def wall_ms(fn) -> float:
    """Median host-clock ms of 5 runs of ``fn``, each ending in a
    synchronise."""
    import numpy as np
    import torch
    times = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def breakdown(engine, k1_ms: float) -> None:
    """Where a batch-16 request step spends its time, by host clock around
    work that ends in a synchronise (median of 5, after the main path):
    the host-to-device copy of the images, the forward of a batch already
    on the card, and K1's device time per forward from phase 2."""
    import numpy as np
    import torch

    host = np.random.default_rng(SEED + 2).standard_normal(
        (BATCH, IMAGE, IMAGE, 3), dtype=np.float32)
    on_card = torch.as_tensor(host, device=engine.device)
    step = wall_ms(lambda: engine.infer(host))
    h2d = wall_ms(lambda: torch.as_tensor(host, device=engine.device))
    fwd = wall_ms(lambda: engine.gxm.infer(engine.params, on_card))
    print(f"  batch {BATCH} step {step:.3f} ms: H2D {h2d:.3f} ms, forward "
          f"{fwd:.3f} ms (wall), K1 device time {k1_ms:.3f} ms "
          f"({100 * k1_ms / step:.1f}% of the step)")


def parity(engine):
    """Phase 4: the card's logits against the port's CPU forward."""
    import numpy as np
    import torch
    from repro_torch.graph import GxM, resnet50

    images = np.random.default_rng(SEED + 1).standard_normal(
        (2, IMAGE, IMAGE, 3), dtype=np.float32)
    on_card = engine.infer(images).cpu()
    cpu_params = {name: {leaf: v.cpu() for leaf, v in p.items()}
                  for name, p in engine.params.items()}
    t0 = time.perf_counter()
    on_cpu = GxM(resnet50(), device="cpu").infer(cpu_params,
                                                 torch.from_numpy(images))
    cpu_s = time.perf_counter() - t0
    check(on_card.shape == (2, 1000) and bool(torch.isfinite(on_card).all()),
          f"logits {tuple(on_card.shape)} not finite (2, 1000)")
    max_abs = float((on_card - on_cpu).abs().max())
    scale = float(on_cpu.abs().max())
    same_top1 = bool((on_card.argmax(-1) == on_cpu.argmax(-1)).all())
    print(f"\nparity: card vs CPU forward (batch 2, {cpu_s:.1f}s on CPU): "
          f"max|diff| {max_abs:.3e}, max|logit| {scale:.3e}, "
          f"ratio {max_abs / scale:.3e}, same top-1 {same_top1}")
    check(max_abs <= LOGIT_REL_TOL * scale,
          f"logits differ by {max_abs:.3e} > {LOGIT_REL_TOL} * {scale:.3e}")
    check(same_top1, "top-1 differs between the card and the CPU")


# K3's aims for the ring route (PERF.md, PR 25): the 52-conv sums, and
# the six small-grid signatures (h, w, c, k, r, s, stride) that lost most on
# the sync route, each to run at least 2x faster on the device
K3_AIM_DEVICE_MS, K3_AIM_EVENTS_MS = 1.0, 1.6
K3_SMALL_GRID = [(14, 14, 256, 256, 3, 3, 1), (7, 7, 512, 512, 3, 3, 1),
                 (14, 14, 1024, 256, 1, 1, 1), (14, 14, 512, 512, 3, 3, 2),
                 (7, 7, 2048, 512, 1, 1, 1), (28, 28, 256, 256, 3, 3, 2)]


def q8_signatures(device, sigs, k1_rows):
    """Phase 5: K3 against its plain version on every serving signature,
    bit for bit, with K1's f32 time from phase 2 beside it.  Returns
    per-signature records with ``count``."""
    import torch
    from repro_torch.kernels import conv2d_direct as k1
    from repro_torch.kernels import conv2d_q8 as k3

    gen = torch.Generator(device=device).manual_seed(SEED + 3)
    k1_ms = {(r["h"], r["w"], r["c"], r["k"], r["r"], r["s"], r["stride"],
              r["padding"], tuple(r["fused"])): r["ms"] for r in k1_rows}
    rows = []
    print(f"\nK3 vs plain, ResNet-50 {IMAGE}x{IMAGE} batch {BATCH} "
          f"({len(sigs)} signatures, {sum(sigs.values())} convs), int8 "
          f"operands; library = torch._int_mm + dequant/epilogue in torch "
          f"(1x1 only); route: conv2d_q8.route, plan: ring_plan's BMxBN "
          f"tile, BK channels a stage, stages, splits of the reduction and "
          f"CTAs; ev = CUDA events, dev = kernel device time by the "
          f"profiler, on the ring route and with the sync route forced:")
    print("  h  w    c    k r st fused         count route tile    bk stg "
          "spl ctas ring_abs sync_abs  ev_ring dev_ring  ev_sync dev_sync "
          " plain_ms k1_f32_ms library_ms bound_ms bound_by   k1_dev")
    for key, count in sigs.items():
        h, w, c, k, r, s, st, pad, fused = key
        p = (h + 2 * pad - r) // st + 1
        q = (w + 2 * pad - s) // st + 1

        def randn(*shape, std=1.0):
            return torch.randn(shape, generator=gen, device=device) * std

        x_q, w_q, x_scale, w_scale = k3.quantize_conv_inputs(
            randn(BATCH, h, w, c),
            randn(r, s, c, k, std=math.sqrt(2.0 / (r * s * c))))
        args = dict(
            x_q=x_q, w_q=w_q, x_scale=x_scale, w_scale=w_scale,
            stride=st, padding=pad,
            scale=torch.rand(k, generator=gen, device=device) + 0.5,
            shift=randn(k, std=0.1),
            residual=randn(BATCH, p, q, k) if "add" in fused else None,
            relu="relu" in fused)
        path = k3.route(x_q, w_q)
        plan = k3.ring_plan(BATCH, p, q, c, k, r, s, st)
        out = k3.conv2d_q8(**args)
        again = k3.conv2d_q8(**args)
        with returning(k3, "route", "sync"):
            sync_out = k3.conv2d_q8(**args)
        plain = k3.conv2d_q8_plain(**args)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(out).all()), f"K3 non-finite at {h, c, k}")
        check(torch.equal(out, again), f"K3 ({path} route) gave other bits "
              f"on a second run at {key}")
        max_abs = float((out - plain).abs().max())
        sync_abs = float((sync_out - plain).abs().max())
        ms = cuda_ms(lambda: k3.conv2d_q8(**args), 50)
        with returning(k3, "route", "sync"):
            ms_sync = cuda_ms(lambda: k3.conv2d_q8(**args), 50)
        plain_ms = cuda_ms(lambda: k3.conv2d_q8_plain(**args), 5)
        library_ms = library_exact = None
        if r == s == 1 and pad == 0:
            xs = x_q[:, ::st, ::st, :].reshape(BATCH * p * q, c)
            deq = x_scale.reshape(()) * w_scale

            def library():
                acc = torch._int_mm(xs, w_q[0, 0])
                y = (acc.to(torch.float32) * deq * args["scale"]
                     + args["shift"])
                if args["residual"] is not None:
                    y = y + args["residual"].reshape(-1, k)
                return torch.clamp_min(y, 0) if args["relu"] else y
            library_exact = bool(torch.equal(library().reshape(out.shape),
                                             plain))
            library_ms = cuda_ms(library, 50)
        # device time alone: the CUDA-event times above include the host's
        # launch gaps wherever the kernel is shorter than its wrapper
        k3_dev = device_ms_of(trace_device(
            lambda i: k3.conv2d_q8(**args), 20, {"conv2d_q8_kernel": k3},
            sync_each=True),
            "conv2d_q8_kernel")
        with returning(k3, "route", "sync"):
            k3_dev_sync = device_ms_of(trace_device(
                lambda i: k3.conv2d_q8(**args), 20,
                {"conv2d_q8_kernel": k3}, sync_each=True),
                "conv2d_q8_kernel")
        f32 = dict(x=x_q.float(), w=w_q.float(), stride=st, padding=pad,
                   scale=args["scale"], shift=args["shift"],
                   residual=args["residual"], relu=args["relu"])
        trace = trace_device(lambda i: k1.conv2d_direct(**f32), 20,
                             {K1_NEEDLE: k1}, sync_each=True)
        k1_dev = device_ms_of(trace, K1_NEEDLE) \
            + device_ms_of(trace, K1_SPLIT_SUM)
        ops = 2.0 * BATCH * p * q * k * c * r * s
        nbytes = (BATCH * h * w * c + r * s * c * k + 4.0 * BATCH * p * q * k
                  + 4.0 * (3 * k + 1)
                  + (4.0 * BATCH * p * q * k if "add" in fused else 0))
        bound_ms, bound_by = bound(ops, nbytes, int8=True)
        rec = dict(h=h, w=w, c=c, k=k, r=r, s=s, stride=st, padding=pad,
                   fused=list(fused), count=count, route=path,
                   tile=f"{plan.bm}x{plan.bn}", bk=plan.bk,
                   stages=plan.stages, splits=plan.splits, ctas=plan.ctas,
                   max_abs_err=max_abs, sync_abs_err=sync_abs,
                   ms=ms, ms_sync=ms_sync, plain_ms=plain_ms,
                   k1_f32_ms=k1_ms[key],
                   library_ms=library_ms, library_exact=library_exact,
                   bound_ms=bound_ms, bound_by=bound_by, ops=ops,
                   k3_device_ms=k3_dev, k3_device_ms_sync=k3_dev_sync,
                   k1_device_ms=k1_dev)
        rows.append(rec)
        lib = "—" if library_ms is None else f"{library_ms:.4f}"
        print(f"{h:3d}{w:3d}{c:5d}{k:5d}{r:2d}{st:3d} "
              f"{'+'.join(fused):14s}{count:5d} {path:5s}"
              f"{rec['tile']:>8s}{plan.bk:5d}{plan.stages:4d}"
              f"{plan.splits:4d}{plan.ctas:5d}  {max_abs:.1e}  "
              f"{sync_abs:.1e} {ms:8.4f} {k3_dev:8.4f} {ms_sync:8.4f} "
              f"{k3_dev_sync:8.4f} {plain_ms:9.4f} {k1_ms[key]:9.4f} "
              f"{lib:>10s} {bound_ms:8.4f} {bound_by:10s}{k1_dev:7.4f}")
        check(path == "ring", f"K3 takes the {path} route at {key}")
        check(max_abs == 0.0 and sync_abs == 0.0,
              f"K3 differs from its plain version at {(h, c, k, r, st)}: "
              f"max |diff| {max_abs:.3e} (ring), {sync_abs:.3e} (sync), "
              f"not 0")
        del x_q, w_q, args, out, again, sync_out, plain, f32

    def weighted_(key_, only=lambda r_: True):
        return sum(r_[key_] * r_["count"] for r_ in rows if only(r_))
    ring_dev, sync_dev = weighted_("k3_device_ms"), \
        weighted_("k3_device_ms_sync")
    print(f"  per {sum(sigs.values())}-conv forward (x count): ring "
          f"{weighted_('ms'):.4f} ms by events, {ring_dev:.4f} device; "
          f"sync route forced {weighted_('ms_sync'):.4f} / {sync_dev:.4f}; "
          f"bound {weighted_('bound_ms'):.4f} (aims: <= "
          f"{K3_AIM_EVENTS_MS} by events, <= {K3_AIM_DEVICE_MS} device)")
    slower = [(_sig(r_), r_["k3_device_ms"], r_["k3_device_ms_sync"])
              for r_ in rows if r_["k3_device_ms"] > r_["k3_device_ms_sync"]]
    print(f"  signatures slower on the ring route than on sync (device): "
          f"{slower if slower else 'none'}")
    for sig in K3_SMALL_GRID:
        r_ = next(r_ for r_ in rows if _sig(r_)[:7] == sig)
        print(f"  small grid {sig}: device {r_['k3_device_ms_sync']:.4f} "
              f"(sync) -> {r_['k3_device_ms']:.4f} (ring), "
              f"{r_['k3_device_ms_sync'] / r_['k3_device_ms']:.2f}x "
              f"(aim >= 2x)")
    # integer-valued inputs, unit scales, no epilogue: the exact conv, on
    # both routes
    xi = torch.randint(-127, 128, (BATCH, 14, 14, 256), generator=gen,
                       device=device, dtype=torch.int8)
    wi = torch.randint(-127, 128, (3, 3, 256, 256), generator=gen,
                       device=device, dtype=torch.int8)
    exact = torch.nn.functional.conv2d(
        xi.double().permute(0, 3, 1, 2), wi.double().permute(3, 2, 0, 1),
        padding=1).permute(0, 2, 3, 1).to(torch.float32).double()
    for path in ("ring", "sync"):
        with returning(k3, "route", path):
            out = k3.conv2d_q8(xi, wi, x_scale=torch.ones((), device=device),
                               w_scale=torch.ones(256, device=device),
                               padding=1)
        exact_ok = bool(torch.equal(out.double(), exact))
        print(f"  integer-exact case (16x14x14x256, 3x3, values +-127, unit "
              f"scales) on the {path} route equals the float64 conv: "
              f"{exact_ok}")
        check(exact_ok, f"K3 ({path} route) is not exact on integer inputs "
              f"with unit scales")
    print("  per-signature JSON:", json.dumps(rows))
    return rows


def int8_serving(device, params, f32_stats):
    """Phase 6: the int8 main path.  Returns (engine, K3 launches in it)."""
    import torch
    from repro_torch.core.conv import lane_ok
    from repro_torch.graph.serving import CnnInferenceEngine
    from repro_torch.kernels import conv2d_direct as k1
    from repro_torch.kernels import conv2d_q8 as k3
    from repro_torch.launch.serve_cnn import build_model, serve_window

    gxm, image = build_model(smoke=False, device=device)
    engine = CnnInferenceEngine(gxm, params, image_hw=(image, image),
                                max_batch=BATCH, quantized=True)
    check(gxm.quantized and engine.quantized, "the int8 engine is not int8")
    t0 = time.perf_counter()
    report = engine.warmup(autotune="off")
    print(f"\nint8 serving: warmup (calibration of "
          f"{len(engine.act_scales)} activation scales on the default "
          f"synthetic batches, then buckets {report['buckets']}) in "
          f"{time.perf_counter() - t0:.2f}s")
    check(report["quantized"] and engine.qparams is not None,
          "warmup did not calibrate")
    # serve_window sets the K1 and K3 counts to 0 just before the window
    server, results = serve_window(engine, requests=REQUESTS, seed=SEED)
    launches, k1_launches = k3.launches, k1.launches
    ring = k3.launches_ring
    st = server.stats()
    check(len(results) == REQUESTS, f"served {len(results)} of {REQUESTS}")
    check(all(0 <= c < 1000 and math.isfinite(v)
              for c, v in results.values()), "non-finite or bad top-1")
    per_fwd = sum(1 for t in gxm.etg.tasks if t.op == "conv"
                  and lane_ok(t.attrs["c"], t.attrs["k"]))
    print(f"  {REQUESTS} requests in {st['batches']} batches "
          f"{st['by_bucket']}, {st['padded_lanes']} padded lanes")
    for name, x in (("int8", st), ("f32 ", f32_stats)):
        print(f"  {name}: images/s {x['images_per_s']:.2f} over "
              f"{x['wall_s']:.3f} s wall  p50 {x['latency']['p50_ms']:.3f} "
              f"ms  p99 {x['latency']['p99_ms']:.3f} ms")
    print(f"  K3 launches {launches} = {per_fwd} x {st['batches']} forwards "
          f"({ring} on the ring route); K1 launches {k1_launches}")
    check(set(st["by_bucket"]) == set(engine.buckets),
          f"buckets served {sorted(st['by_bucket'])}, not {engine.buckets}")
    check(per_fwd == 52 and launches == per_fwd * st["batches"],
          f"K3 launched {launches} times, expected 52 x {st['batches']}")
    check(k1_launches == 0, f"K1 launched {k1_launches} times in the int8 "
          f"window, expected 0")
    check(ring == launches, f"{launches - ring} of the window's K3 launches "
          f"took the sync route, expected none")
    return engine, launches, st


def int8_breakdown(engine, k3_ms: float) -> dict:
    """One batch-16 int8 step by host clock (H2D, forward), K3's device
    time per forward from phase 5, and the device time of ``quantize_act``
    on that forward's conv inputs (CUDA events)."""
    import numpy as np
    import torch
    from repro_torch.core.quantize import quantize_act
    from repro_torch.kernels import conv2d_direct as k1
    from repro_torch.kernels import conv2d_q8 as k3

    host = np.random.default_rng(SEED + 2).standard_normal(
        (BATCH, IMAGE, IMAGE, 3), dtype=np.float32)
    on_card = torch.as_tensor(host, device=engine.device)
    step = wall_ms(lambda: engine.infer(host))
    h2d = wall_ms(lambda: torch.as_tensor(host, device=engine.device))
    fwd = wall_ms(lambda: engine.gxm.infer(engine.qparams, on_card))
    inputs = []
    with torch.inference_mode():
        engine.gxm.forward(engine.qparams, on_card, train=False,
                           tap=lambda name, v: inputs.append(
                               (v, engine.qparams[name]["x_scale"])))
    glue = cuda_ms(lambda: [quantize_act(v, sc) for v, sc in inputs], 5)
    out = dict(step_ms=step, h2d_ms=h2d, forward_ms=fwd, k3_ms=k3_ms,
               quantize_act_ms=glue, quantized_inputs=len(inputs))
    del inputs
    print(f"  batch {BATCH} int8 step {step:.3f} ms: H2D {h2d:.3f} ms, "
          f"forward {fwd:.3f} ms (wall), K3 {k3_ms:.3f} ms by CUDA events "
          f"({100 * k3_ms / step:.1f}% of the step), quantize_act on the 53 "
          f"conv inputs {glue:.3f} ms by CUDA events "
          f"({100 * glue / step:.1f}%)")
    # the same forward, int8 and f32 (the q8-marked GxM with the f32 tree
    # runs K1), 5 each under the profiler: device time by kernel name
    for name, params in (("int8", engine.qparams), ("f32", engine.params)):
        with torch.inference_mode():
            trace = trace_device(lambda i: engine.gxm.forward(
                params, on_card, train=False), 5,
                {"conv2d_q8_kernel": k3, "conv2d_direct_kernel": k1})
        out[name] = dict(
            wall_ms=trace["wall_ms"], device_ms=trace["device_ms"],
            busy_share=trace["busy_share"],
            k3_ms=device_ms_of(trace, "conv2d_q8_kernel"),
            k1_ms=device_ms_of(trace, "conv2d_direct_kernel"),
            top=[dict(ms=ms, launches=n, name=kname[:100])
                 for ms, n, kname in trace["by_name"][:10]])
        r = out[name]
        busy = "n/a" if r["busy_share"] is None else f"{r['busy_share']:.4f}"
        print(f"  {name} forward under the profiler: {r['wall_ms']:.3f} ms "
              f"host clock, device {r['device_ms']:.3f} ms (K3 "
              f"{r['k3_ms']:.3f}, K1 {r['k1_ms']:.3f}), busy share {busy}")
        for rec in r["top"]:
            print(f"    {rec['ms']:8.3f} ms  x{rec['launches']:5.1f}  "
                  f"{rec['name']}")
    return out


def int8_parity(engine) -> dict:
    """Phase 7: the card's int8 logits against the port's CPU int8 forward
    on the same quantized params tree, counting quantized activations that
    land a step apart; then the int8-vs-f32 gap on the card."""
    import numpy as np
    import torch
    from repro_torch.core.quantize import quantize_act
    from repro_torch.graph import GxM, resnet50

    images = np.random.default_rng(SEED + 1).standard_normal(
        (PARITY_BATCH, IMAGE, IMAGE, 3), dtype=np.float32)
    q = engine.qparams
    card_q = []
    with torch.inference_mode():
        on_card = engine.gxm.forward(
            q, torch.as_tensor(images, device=engine.device), train=False,
            tap=lambda name, v: card_q.append(
                quantize_act(v, q[name]["x_scale"]).cpu())).cpu()
    cpu_q = {name: {leaf: v.cpu() for leaf, v in p.items()}
             for name, p in q.items()}
    flips = dict(values=0, one_step=0, more=0, first_layers=[])
    replay = iter(card_q)

    def count(name, v):
        theirs = next(replay)
        diff = (quantize_act(v, cpu_q[name]["x_scale"]).int()
                - theirs.int()).abs()
        flips["values"] += diff.numel()
        flips["one_step"] += int((diff == 1).sum())
        flips["more"] += int((diff > 1).sum())
        if int((diff > 0).sum()) and len(flips["first_layers"]) < 3:
            flips["first_layers"].append((name, int((diff > 0).sum())))

    t0 = time.perf_counter()
    with torch.inference_mode():
        on_cpu = GxM(resnet50(), device="cpu", quantized=True).forward(
            cpu_q, torch.from_numpy(images), train=False, tap=count)
    cpu_s = time.perf_counter() - t0
    check(on_card.shape == (PARITY_BATCH, 1000)
          and bool(torch.isfinite(on_card).all()), "int8 logits not finite")
    max_abs = float((on_card - on_cpu).abs().max())
    scale = float(on_cpu.abs().max())
    same_top1 = bool((on_card.argmax(-1) == on_cpu.argmax(-1)).all())
    print(f"\nint8 parity: card vs CPU int8 forward (batch {PARITY_BATCH}, "
          f"one quantized params tree, {cpu_s:.1f}s on CPU): max|diff| "
          f"{max_abs:.3e}, max|logit| {scale:.3e}, ratio "
          f"{max_abs / scale:.3e} (limit {INT8_LOGIT_REL_TOL}), same top-1 "
          f"{same_top1}")
    print(f"  quantized activations: {flips['one_step']} of "
          f"{flips['values']} one step apart, {flips['more']} further; "
          f"first layers that differ: {flips['first_layers']}")
    with torch.inference_mode():
        f32 = engine.gxm.infer(engine.params, torch.as_tensor(
            images, device=engine.device)).cpu()
    gap = float((on_card - f32).abs().max()) / float(f32.abs().max())
    agree = int((on_card.argmax(-1) == f32.argmax(-1)).sum())
    print(f"  int8 vs f32 on the card (scheme property, not gated): max|diff|"
          f" / max|f32| {gap:.3e}, top-1 agrees on {agree} of "
          f"{PARITY_BATCH}")
    check(max_abs <= INT8_LOGIT_REL_TOL * scale,
          f"int8 logits differ by {max_abs:.3e} > {INT8_LOGIT_REL_TOL} * "
          f"{scale:.3e}")
    check(same_top1, "int8 top-1 differs between the card and the CPU")
    return dict(max_abs=max_abs, ratio=max_abs / scale, flips=flips,
                int8_vs_f32_gap=gap, int8_vs_f32_top1_agree=agree)


def training_signatures(etg):
    """The kernel launches of one ResNet-50 training step at IMAGE x IMAGE,
    from the port's ETG: distinct K1 forward, K1 dual and K2 signatures,
    each with how many launches of one step share it."""
    from repro_torch.core.conv import lane_ok
    from repro_torch.core.duality import dual_conv_signatures
    from repro_torch.graph.serving import conv_shapes

    reads = {t.name: t.inputs[0] for t in etg.tasks if t.op == "conv"}
    fwd: dict[tuple, int] = {}
    dual: dict[tuple, int] = {}
    wu: dict[tuple, int] = {}

    def add(table, key):
        table[key] = table.get(key, 0) + 1

    for sh in conv_shapes(etg, (IMAGE, IMAGE)):
        if not lane_ok(sh["c"], sh["k"]):
            continue
        geo = (sh["h"], sh["w"], sh["c"], sh["k"], sh["r"], sh["s"],
               sh["stride"], sh["padding"])
        add(fwd, geo)
        add(wu, geo)
        if reads[sh["name"]] == "input":     # the image needs no gradient
            continue
        for d in dual_conv_signatures(
                r=sh["r"], s=sh["s"], c=sh["c"], k=sh["k"],
                stride=sh["stride"], padding=sh["padding"],
                input_hw=(sh["h"], sh["w"]), unique=False):
            if lane_ok(d["c"], d["k"]):
                add(dual, (d["h"], d["w"], d["c"], d["k"], d["r"], d["s"],
                           d["stride"], d["padding"]))
    return fwd, dual, wu


def train_k1_signatures(device, fwd, dual):
    """Phase 8: K1 on every bare forward and dual signature of a training
    step at TRAIN_BATCH.  Returns records with ``role`` and ``count``."""
    import torch
    from repro_torch.kernels import conv2d_direct as k1
    from repro_torch.kernels import ref

    gen = torch.Generator(device=device).manual_seed(SEED + 5)
    rows = []
    print(f"\nK1 in training, batch {TRAIN_BATCH}: {len(fwd)} forward "
          f"signatures ({sum(fwd.values())} launches), {len(dual)} dual "
          f"({sum(dual.values())} launches), bare conv:")
    print("  role   h   w    c    k r s st pad count route tile splits "
          "chunk blocks  max_rel    max_abs        ms device_ms  plain_ms "
          "library_ms  bound_ms mma_bound_ms")
    for role, table in (("fwd", fwd), ("dual", dual)):
        for (h, w, c, k, r, s, st, pad), count in table.items():
            p = (h + 2 * pad - r) // st + 1
            q = (w + 2 * pad - s) // st + 1
            x = torch.randn((TRAIN_BATCH, h, w, c), generator=gen,
                            device=device)
            wt = torch.randn((r, s, c, k), generator=gen, device=device) \
                * math.sqrt(2.0 / (r * s * c))
            args = dict(x=x, w=wt, stride=st, padding=pad)
            flops = 2.0 * TRAIN_BATCH * p * q * k * c * r * s
            nbytes = 4.0 * (TRAIN_BATCH * (h * w * c + p * q * k)
                            + r * s * c * k)
            rec, out = k1_case(args, n=TRAIN_BATCH, p=p, q=q, c=c, k=k, r=r,
                               s=s, flops=flops, nbytes=nbytes,
                               what=f"{role} {(h, c, k, r, s, st, pad)}")
            plain = k1.conv2d_direct_plain(**args)
            torch.cuda.synchronize()
            max_abs = float((out - plain).abs().max())
            max_rel = max_abs / float(plain.abs().max())
            plain_ms = cuda_ms(lambda: k1.conv2d_direct_plain(**args), 5)
            library_ms = cuda_ms(lambda: ref.conv2d(**args), 20)
            rec = dict(role=role, h=h, w=w, c=c, k=k, r=r, s=s, stride=st,
                       padding=pad, count=count, max_rel_err=max_rel,
                       max_abs_err=max_abs, plain_ms=plain_ms,
                       library_ms=library_ms, **rec)
            rows.append(rec)
            print(f"  {role:5s}{h:4d}{w:4d}{c:5d}{k:5d}{r:2d}{s:2d}{st:3d}"
                  f"{pad:4d}{count:6d} {rec['route']:5s}"
                  f"{rec['tile'] if rec['tile'] is not None else '-':>5}"
                  f"{rec['splits']:7d}{rec['chunk'] or 0:6d}"
                  f"{rec['blocks'] or 0:7d}  {max_rel:.2e}  {max_abs:.2e} "
                  f"{rec['ms']:9.4f} {rec['device_ms']:9.4f} "
                  f"{plain_ms:9.4f} {library_ms:10.4f} "
                  f"{rec['bound_ms']:9.4f} {rec['mma_bound_ms']:12.4f}")
            check(max_rel <= KERNEL_REL_TOL,
                  f"K1 disagrees with its plain version at {role} "
                  f"{(h, c, k, r, s, st, pad)}: max_rel {max_rel:.3e} > "
                  f"{KERNEL_REL_TOL}")
            del x, wt, args, out, plain
    for role in ("fwd", "dual"):
        part = [r_ for r_ in rows if r_["role"] == role]
        print(f"  per step, {role} (x count): K1 {totals(part)['ms']:.4f} ms "
              f"by events, "
              f"{sum(r_['device_ms'] * r_['count'] for r_ in part):.4f} "
              f"device; cuDNN {totals(part)['library_ms']:.4f}; bounds "
              f"{totals(part)['bound_ms']:.4f} (f32 SIMT) and "
              f"{sum(r_['mma_bound_ms'] * r_['count'] for r_ in part):.4f} "
              f"(3xTF32)")
    print("  per-signature JSON:", json.dumps(rows))
    return rows


def wu_signatures(device, wu):
    """Phase 9: K2 against its plain version on every weight-update
    signature of a training step at TRAIN_BATCH, each run twice on the same
    inputs (the same bits), with its route and plan, its time by CUDA
    events and by profiler device time (the split kernel and its reduction
    pass), cuDNN's, and both bounds: the f32 SIMT one and the mma route's
    (3 x the FLOPs at the TF32 tensor-core rate, or the bytes)."""
    import torch
    from repro_torch.kernels import conv2d_wu as k2
    from repro_torch.launch import roofline

    gen = torch.Generator(device=device).manual_seed(SEED + 6)
    rows = []
    print(f"\nK2 vs plain, ResNet-50 {IMAGE}x{IMAGE} batch {TRAIN_BATCH} "
          f"({len(wu)} signatures, {sum(wu.values())} convs):")
    print("  h   w    c    k r st pad count route tile splits chunk  max_rel"
          "    max_abs        ms device_ms  plain_ms  library_ms  bound_ms "
          "bound_by mma_bound_ms")
    for (h, w, c, k, r, s, st, pad), count in wu.items():
        p = (h + 2 * pad - r) // st + 1
        q = (w + 2 * pad - s) // st + 1
        x = torch.randn((TRAIN_BATCH, h, w, c), generator=gen, device=device)
        do = torch.randn((TRAIN_BATCH, p, q, k), generator=gen,
                         device=device)
        args = dict(x=x, do=do, stride=st, padding=pad, filter_rs=(r, s))
        path = k2.route(x, do)
        plan = k2.plan(n=TRAIN_BATCH, p=p, q=q, c=c, k=k, r=r, s=s,
                       route=path)
        out = k2.conv2d_wu(**args)
        again = k2.conv2d_wu(**args)
        plain = k2.conv2d_wu_plain(**args)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(out).all()), f"K2 non-finite at {h, c, k}")
        check(torch.equal(out, again), f"K2 ({path} route) gave other bits "
              f"on a second run at {(h, c, k, r, st)}")
        max_abs = float((out - plain).abs().max())
        max_rel = max_abs / float(plain.abs().max())
        # cuDNN's weight gradient on the same NHWC tensors (channels-last
        # views), TF32 off: the yardstick, never called by the port
        x_nchw, do_nchw = x.permute(0, 3, 1, 2), do.permute(0, 3, 1, 2)
        w_shape = torch.empty((k, c, r, s), device=device).to(
            memory_format=torch.channels_last)

        def library():
            with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
                return torch.ops.aten.convolution_backward(
                    do_nchw, x_nchw, w_shape, None, [st, st], [pad, pad],
                    [1, 1], False, [0, 0], 1, [False, True, False])[1]
        lib_abs = float((library().permute(2, 3, 1, 0) - plain).abs().max())
        ms = cuda_ms(lambda: k2.conv2d_wu(**args), 20)
        device_ms, _ = kernel_device_ms(lambda: k2.conv2d_wu(**args),
                                        "conv2d_wu_kernel", k2,
                                        also=("wu_reduce",))
        plain_ms = cuda_ms(lambda: k2.conv2d_wu_plain(**args), 5)
        library_ms = cuda_ms(library, 20)
        flops = 2.0 * TRAIN_BATCH * p * q * k * c * r * s
        nbytes = 4.0 * (TRAIN_BATCH * (h * w * c + p * q * k) + r * s * c * k)
        bound_ms, bound_by = bound(flops, nbytes)
        mma_bound_ms, mma_bound_by = roofline.bound_ms(
            3 * flops, nbytes, roofline.TF32_PEAK_FLOPS)
        rows.append(dict(h=h, w=w, c=c, k=k, r=r, s=s, stride=st,
                         padding=pad, count=count, route=path, tile=plan.tile,
                         splits=plan.splits, chunk=plan.chunk,
                         max_rel_err=max_rel, max_abs_err=max_abs,
                         library_rel_err=lib_abs / float(plain.abs().max()),
                         ms=ms, device_ms=device_ms, plain_ms=plain_ms,
                         library_ms=library_ms, bound_ms=bound_ms,
                         bound_by=bound_by, mma_bound_ms=mma_bound_ms,
                         mma_bound_by=mma_bound_by))
        print(f"{h:3d}{w:4d}{c:5d}{k:5d}{r:2d}{st:3d}{pad:4d}{count:6d} "
              f"{path:5s}{plan.tile:5d}{plan.splits:7d}{plan.chunk:6d}  "
              f"{max_rel:.2e}  {max_abs:.2e} {ms:9.4f} {device_ms:9.4f} "
              f"{plain_ms:9.4f} {library_ms:11.4f} {bound_ms:9.4f} "
              f"{bound_by:10s}{mma_bound_ms:9.4f} {mma_bound_by}")
        check(max_rel <= KERNEL_REL_TOL,
              f"K2 disagrees with its plain version at {(h, c, k, r, st)}: "
              f"max_rel {max_rel:.3e} > {KERNEL_REL_TOL}")
        del x, do, args, out, again, plain, x_nchw, do_nchw
    step = totals(rows)
    per_route = {path: sum(r_["count"] for r_ in rows if r_["route"] == path)
                 for path in k2.ROUTES}
    print(f"  per step (x count): K2 {step['ms']:.4f} ms by events, "
          f"{sum(r_['device_ms'] * r_['count'] for r_ in rows):.4f} device; "
          f"cuDNN dW {step['library_ms']:.4f}; bounds {step['bound_ms']:.4f} "
          f"(f32 SIMT) and "
          f"{sum(r_['mma_bound_ms'] * r_['count'] for r_ in rows):.4f} "
          f"(3xTF32); launches by route {per_route}")
    print("  per-signature JSON:", json.dumps(rows))
    return rows


def _device_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        value = getattr(evt, attr, None)
        if value is not None:
            return float(value)
    return 0.0


TRACE_WARMUP_MS = 50.0      # the profiler's warm-up step runs fn this long
TRACE_ATTEMPTS = 10         # traces taken before a short one fails the run
TRACE_SETTLE_MS = (100.0, 10.0, 1000.0)   # idle edge: floor, x a call, cap
TRACES = []                 # (s since import, traces refused, clock lag ms)


def trace_device(fn, iters: int, counters: dict,
                 sync_each: bool = False) -> dict:
    """``fn(i)`` for i in range(iters) under ``torch.profiler``, after a
    warm-up step (a profiler ``schedule`` with warmup=1) that calls
    ``fn(0)`` for at least TRACE_WARMUP_MS and whose events are discarded,
    so the profiler is recording when the traced iterations start.  With
    ``sync_each`` the host waits for the device after every iteration, so
    no launch is queued behind another while the profiler records.

    The device is idle on each side of the warm-up step's end and before
    the profiler stops, for ``attempt`` x (10 x one warm-up call, at least
    100 ms, at most 1 s: TRACE_SETTLE_MS).  On the card the profiler lost
    the kernel records of the first launches of a window, up to 4 of 5 of
    K10b's 10-20 ms launches in 10 traces in a row; with idle edges of
    100 ms they were still lost in some traces, and with 300 ms in none.
    A refused trace names which of its launch calls lost their records,
    and every trace reports the least kernel-start minus launch-call time
    (``clock_lag_ms``, negative when a kernel is dated before its launch).

    A trace is complete when every kernel launch call the profiler
    recorded on the host (``cudaLaunchKernel``, ``cuLaunchKernelEx`` and
    the like: CUPTI's callback records) has the kernel record of the same
    correlation id (CUPTI's activity records, which the profiler drops at
    random), and when, for each needle of ``counters`` (a kernel-name
    needle mapped to the port module whose ``launches`` counter its wrapper
    keeps), the launches recorded under names that hold the needle equal
    what the counter counted over the same traced iterations.  A trace
    that is not complete is refused with a message and not read, since its
    device times would read low; after TRACE_ATTEMPTS refused traces the
    run fails, and so does a trace with no launch calls recorded at all.

    Returns device time by kernel name per iteration (ms, launches, name;
    largest first), the launches recorded by name over the whole trace,
    their sum (``device_ms``), the device's busy share (the union of kernel
    intervals over the span from the first to the last; None when the trace
    shows no device time), the host-clock ms per iteration, the device ms
    per iteration inside each ``record_function`` range of the port
    (``ranges``: "mamba.scan", "moe.experts"), the traces refused and
    ``clock_lag_ms``; each trace also goes into TRACES."""
    import torch
    from torch.profiler import ProfilerActivity, schedule

    cuda = torch.autograd.DeviceType.CUDA

    def kernel(e):
        return e.device_type == cuda and not getattr(
            e, "is_user_annotation", False)
    floor_ms, per_call, cap_ms = TRACE_SETTLE_MS
    for attempt in range(1, TRACE_ATTEMPTS + 1):
        torch.cuda.synchronize()
        with torch.profiler.profile(
                activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                schedule=schedule(wait=0, warmup=1, active=iters,
                                  repeat=1)) as prof:
            t0, warm_calls = time.perf_counter(), 0
            while True:
                fn(0)
                torch.cuda.synchronize()
                warm_calls += 1
                warm_ms = (time.perf_counter() - t0) * 1e3
                if warm_ms >= TRACE_WARMUP_MS:
                    break
            settle_s = attempt * min(cap_ms, max(
                floor_ms, per_call * warm_ms / warm_calls)) / 1e3
            time.sleep(settle_s)
            prof.step()
            time.sleep(settle_s)
            before = {needle: mod.launches
                      for needle, mod in counters.items()}
            t0 = time.perf_counter()
            for i in range(iters):
                fn(i)
                if sync_each or i == iters - 1:
                    torch.cuda.synchronize()
                if i == iters - 1:
                    wall_ms = (time.perf_counter() - t0) * 1e3
                    time.sleep(settle_s)
                prof.step()
        averages = prof.key_averages()
        launches = {e.key: e.count for e in averages if kernel(e)}
        # every host-side launch call (cudaLaunchKernel, cuLaunchKernelEx)
        # must have its kernel record, matched by their shared correlation id
        events = prof.events()
        starts = {e.id: e.time_range.start for e in events if kernel(e)}
        calls = sorted((e.time_range.start, e.id) for e in events
                       if e.device_type != cuda and "LaunchKernel" in e.name)
        lost = [k for k, (_, i) in enumerate(calls) if i not in starts]
        lags = [starts[i] - t for t, i in calls if i in starts]
        clock_lag_ms = min(lags) / 1e3 if lags else None
        short = [f"{len(lost)} of {len(calls)} recorded launch calls have no "
                 f"kernel record (calls {lost[:8]} in host order; least "
                 f"kernel-start minus launch-call time "
                 f"{clock_lag_ms if lags else 'n/a'} ms)"] if lost else []
        for needle, mod in counters.items():
            counted = mod.launches - before[needle]
            recorded = sum(n for name, n in launches.items()
                           if needle in name)
            if recorded != counted:
                short.append(f"{recorded} launches of {needle} recorded, "
                             f"{counted} counted")
        if not short:
            break
        print(f"  profiler trace {attempt} of {TRACE_ATTEMPTS} refused "
              f"({iters} iterations, {sum(launches.values())} kernel "
              f"launches recorded): {'; '.join(short)}")
    TRACES.append((time.perf_counter() - T_IMPORT, attempt - 1 if not short
                   else attempt, clock_lag_ms))
    check(not short, f"{TRACE_ATTEMPTS} profiler traces in a row recorded "
          f"other launch counts than the wrappers counted: {short}")
    check(len(calls) > 0, "the profiler recorded no kernel launch calls, "
          "so a trace's completeness cannot be checked")
    by_name = sorted(((_device_us(e) / 1e3 / iters, e.count / iters, e.key)
                      for e in averages if kernel(e)), reverse=True)
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in events if kernel(e))
    # a range's kernels run inside its device-side span (one stream); the
    # CPU-side range's device_time_total counts some kernels twice
    ranges = {}
    for e in events:
        if e.name in ("mamba.scan", "moe.experts") and e.device_type == cuda:
            a, b = e.time_range.start, e.time_range.end
            ranges[e.name] = ranges.get(e.name, 0.0) + sum(
                end - start for start, end in spans if a <= start < b) \
                / 1e3 / iters
    busy_us = 0.0
    if spans:
        cur_s, cur_e = spans[0]
        for s, e in spans[1:]:
            if s > cur_e:
                busy_us += cur_e - cur_s
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        busy_us += cur_e - cur_s
    span_us = spans[-1][1] - spans[0][0] if spans else 0.0
    return dict(by_name=by_name, launches=launches,
                device_ms=sum(ms for ms, _, _ in by_name),
                busy_share=busy_us / span_us if span_us else None,
                wall_ms=wall_ms / iters, ranges=ranges,
                refused=attempt - 1, clock_lag_ms=clock_lag_ms)


def device_ms_of(trace: dict, needle: str) -> float:
    """Device ms per iteration of the kernels whose name holds ``needle``."""
    return sum(ms for ms, _, name in trace["by_name"] if needle in name)


def profile_steps(step, params, batches) -> dict:
    """Device time by kernel name and the device's busy share over
    ``len(batches)`` training steps under ``torch.profiler``."""
    from repro_torch.kernels import conv2d_direct as k1
    from repro_torch.kernels import conv2d_wu as k2
    state = [params]

    def run(i):
        state[0], _ = step(state[0], batches[i])
    trace = trace_device(run, len(batches), {"conv2d_direct_kernel": k1,
                                             "conv2d_wu_kernel": k2})
    steps = len(batches)
    by_name, device_ms = trace["by_name"], trace["device_ms"]

    def named(needle):
        return device_ms_of(trace, needle)
    out = dict(wall_ms_per_step=trace["wall_ms"],
               device_ms_per_step=device_ms,
               device_busy_share=trace["busy_share"],
               k1_ms_per_step=named(K1_NEEDLE) + named(K1_SPLIT_SUM),
               k1_split_sum_ms_per_step=named(K1_SPLIT_SUM),
               k2_ms_per_step=named("conv2d_wu_kernel") + named("wu_reduce"),
               k2_reduce_ms_per_step=named("wu_reduce"),
               top=[dict(ms=ms, launches=n, name=name[:120])
                    for ms, n, name in by_name[:15]])
    print(f"  profile of {steps} steps: {out['wall_ms_per_step']:.3f} ms/step "
          f"by host clock under the profiler, device {device_ms:.3f} ms/step "
          f"over {len(by_name)} kernel names")
    if device_ms == 0.0 or trace["busy_share"] is None:
        print("  profiler: key_averages() shows no device time; the CUDA-"
              "event numbers of phases 8 and 9 stand alone")
        return out
    print(f"  device busy share {out['device_busy_share']:.4f}, idle "
          f"{1 - out['device_busy_share']:.4f} (first to last device event)")
    print(f"  K1 {out['k1_ms_per_step']:.3f} ms/step (its split sum pass "
          f"{out['k1_split_sum_ms_per_step']:.3f}), K2 "
          f"{out['k2_ms_per_step']:.3f} ms/step (its reduction "
          f"{out['k2_reduce_ms_per_step']:.3f}), by kernel name")
    for rec in out["top"]:
        print(f"    {rec['ms']:9.3f} ms  x{rec['launches']:6.1f}  "
              f"{rec['name']}")
    return out


def training(device, fwd, dual, wu):
    """Phase 10: the training main path.  Returns (launch counts of one
    step, summary)."""
    import numpy as np
    import torch
    from repro_torch.kernels import conv2d_direct as k1
    from repro_torch.kernels import conv2d_wu as k2
    from repro_torch.launch.train_cnn import build_trainer
    from repro_torch.train.step import to_device

    gxm, params, step, data = build_trainer(
        full=True, num_classes=1000, image=IMAGE, batch=TRAIN_BATCH,
        lr=TRAIN_LR, device=device, seed=SEED)
    check(gxm.num_classes == 1000 and len(
        [t for t in gxm.etg.tasks if t.op == "conv"]) == 53,
        "not the full ResNet-50")
    batches = [to_device(data.batch_at(i), device) for i in range(16)]
    torch.cuda.synchronize()
    print(f"\ntraining: ResNet-50 {IMAGE}x{IMAGE}, 1000 classes, batch "
          f"{TRAIN_BATCH}, lr {TRAIN_LR}, SyntheticImageData (16 batches "
          f"on the card before timing)")
    losses = []
    t0 = time.perf_counter()
    for batch in batches[:2]:
        params, loss = step(params, batch)
        losses.append(float(loss))
    print(f"  2 untimed steps in {time.perf_counter() - t0:.2f}s, losses "
          f"{losses}")
    times = []
    for batch in batches[2:12]:
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        params, loss = step(params, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t1) * 1e3)
        losses.append(float(loss))
    step_ms = float(np.median(times))
    print(f"  10 timed steps: median {step_ms:.3f} ms/step (min "
          f"{min(times):.3f}, max {max(times):.3f}), "
          f"{TRAIN_BATCH / step_ms * 1e3:.2f} images/s")
    print(f"  losses: {[round(v, 4) for v in losses]}")
    check(all(math.isfinite(v) for v in losses), f"non-finite loss {losses}")

    expect_k1 = sum(fwd.values()) + sum(dual.values())
    expect_k2 = sum(wu.values())
    k1.launches = k1.launches_mma = k2.launches = k2.launches_mma = 0
    params, loss = step(params, batches[12])
    torch.cuda.synchronize()
    counts = {"conv2d_direct": k1.launches, "conv2d_wu": k2.launches,
              "conv2d_wu_mma": k2.launches_mma,
              "conv2d_direct_mma": k1.launches_mma}
    print(f"  launches in one step: K1 {counts['conv2d_direct']} (expected "
          f"{sum(fwd.values())} forward + {sum(dual.values())} dual = "
          f"{expect_k1}), K2 {counts['conv2d_wu']} (expected {expect_k2}), "
          f"{counts['conv2d_wu_mma']} of them on the mma route (expected "
          f"all)")
    check(counts["conv2d_direct"] == expect_k1 == 113,
          f"K1 launched {counts['conv2d_direct']} times in a step, expected "
          f"{expect_k1} (113)")
    check(counts["conv2d_wu"] == expect_k2 == 52,
          f"K2 launched {counts['conv2d_wu']} times in a step, expected "
          f"{expect_k2} (52)")
    check(counts["conv2d_wu_mma"] == counts["conv2d_wu"],
          f"{counts['conv2d_wu_mma']} of the step's {counts['conv2d_wu']} K2 "
          f"launches took the mma route, expected all")
    print(f"  K1 launches on the mma route (launches_mma): "
          f"{counts['conv2d_direct_mma']} of {counts['conv2d_direct']}")
    check(counts["conv2d_direct_mma"] == counts["conv2d_direct"],
          f"{counts['conv2d_direct_mma']} of the step's "
          f"{counts['conv2d_direct']} K1 launches took the mma route, "
          f"expected all")
    prof = profile_steps(step, params, batches[13:16])
    return counts, dict(step_ms=step_ms, step_times_ms=times,
                        images_per_s=TRAIN_BATCH / step_ms * 1e3,
                        losses=losses, profile=prof)


def train_parity(device, tiling: str = "tiled"):
    """Phase 11 (and 26 with ``tiling="whole"``): one training step on the
    card against the port's CPU step under the same conv input strategy,
    with the CPU taking the card's ReLU masks and max-pool choices."""
    import torch
    import torch.nn.functional as F
    from repro_torch.backend import use_conv_tiling
    from repro_torch.data.pipeline import SyntheticImageData
    from repro_torch.graph import GxM, executor, resnet50
    from repro_torch.train.step import to_device

    on_card = GxM(resnet50(), device=device)
    on_cpu = GxM(resnet50(), device="cpu")
    params = on_card.init(torch.Generator().manual_seed(SEED + 8))
    cpu_params = {name: {leaf: v.cpu() for leaf, v in p.items()}
                  for name, p in params.items()}
    batch = SyntheticImageData(hw=IMAGE, n_classes=1000,
                               global_batch=PARITY_BATCH,
                               seed=SEED + 8).batch_at(0)
    masks, pools = [], []
    relu, maxpool = executor._relu, executor._maxpool

    def record_relu(x):
        # the card's decision both ways: its forward mask and its backward
        # one (clamp_min passes the gradient where x >= 0, so an input of
        # exactly 0 passes it and outputs 0)
        masks.append(((x > 0).cpu(), (x >= 0).cpu()))
        return relu(x)

    def record_pool(x, window, stride, padding):
        y, idx = F.max_pool2d(x.permute(0, 3, 1, 2), window, stride,
                              padding, return_indices=True)
        pools.append(idx.cpu())
        return y.permute(0, 2, 3, 1).contiguous()

    flips = dict(relu=0, relu_values=0, pool=0, pool_windows=0)
    replay_m, replay_p = iter(masks), iter(pools)

    def pinned_relu(x):
        m, g = next(replay_m)
        flips["relu"] += int(((m != (x > 0)) | (g != (x >= 0))).sum())
        flips["relu_values"] += m.numel()
        # forward x * m; backward the gradient times g
        return x * m + (x - x.detach()) * (g.to(x.dtype) - m.to(x.dtype))

    def pinned_pool(x, window, stride, padding):
        idx = next(replay_p)
        xn = x.permute(0, 3, 1, 2)
        _, own = F.max_pool2d(xn, window, stride, padding,
                              return_indices=True)
        flips["pool"] += int((own != idx).sum())
        flips["pool_windows"] += idx.numel()
        y = xn.reshape(*xn.shape[:2], -1).gather(
            2, idx.reshape(*idx.shape[:2], -1)).reshape(idx.shape)
        return y.permute(0, 2, 3, 1).contiguous()

    try:
        executor._relu, executor._maxpool = record_relu, record_pool
        with use_conv_tiling(tiling):
            new_card, loss_card = on_card.sgd_train_step(
                params, to_device(batch, device), TRAIN_LR)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            executor._relu, executor._maxpool = pinned_relu, pinned_pool
            new_cpu, loss_cpu = on_cpu.sgd_train_step(
                cpu_params, to_device(batch, "cpu"), TRAIN_LR)
            cpu_s = time.perf_counter() - t0
    finally:
        executor._relu, executor._maxpool = relu, maxpool
    loss_rel = abs(float(loss_card) - float(loss_cpu)) / abs(float(loss_cpu))
    print(f"\ntraining parity ({tiling}): one step, batch {PARITY_BATCH}, "
          f"card vs CPU ({cpu_s:.1f}s on CPU): loss {float(loss_card):.6f} vs "
          f"{float(loss_cpu):.6f}, rel {loss_rel:.3e}")
    print(f"  the CPU would have decided {flips['relu']} of "
          f"{flips['relu_values']} ReLU inputs and {flips['pool']} of "
          f"{flips['pool_windows']} max-pool windows otherwise (pinned to "
          f"the card's); limit {PINNED_SHARE_TOL} of each")
    check(flips["relu"] <= PINNED_SHARE_TOL * flips["relu_values"],
          f"{flips['relu']} of {flips['relu_values']} ReLU decisions differ "
          f"from the CPU's, more than {PINNED_SHARE_TOL} of them")
    check(flips["pool"] <= PINNED_SHARE_TOL * flips["pool_windows"],
          f"{flips['pool']} of {flips['pool_windows']} max-pool choices "
          f"differ from the CPU's, more than {PINNED_SHARE_TOL} of them")
    check(math.isfinite(float(loss_card)), "non-finite training loss")
    check(loss_rel <= LOSS_REL_TOL,
          f"loss differs by {loss_rel:.3e} > {LOSS_REL_TOL}")
    worst = (0.0, "")
    leaves = 0
    for name, p in cpu_params.items():
        for leaf, old in p.items():
            if leaf in executor.RUNNING_STATS:
                card = new_card[name][leaf].cpu() - old
                cpu = new_cpu[name][leaf] - old
            else:
                card = (old - new_card[name][leaf].cpu()) / TRAIN_LR
                cpu = (old - new_cpu[name][leaf]) / TRAIN_LR
            err = float((card - cpu).abs().max())
            scale = float(cpu.abs().max())
            leaves += 1
            ratio = err / scale if scale else (0.0 if err == 0 else math.inf)
            worst = max(worst, (ratio, f"{name}.{leaf}"))
            check(err <= UPDATE_REL_TOL * scale,
                  f"{name}.{leaf}: update differs by {err:.3e} > "
                  f"{UPDATE_REL_TOL} * {scale:.3e}")
    print(f"  {leaves} leaves: worst max|diff| / max|CPU| {worst[0]:.3e} "
          f"({worst[1]}); limit {UPDATE_REL_TOL}")
    return dict(loss_rel=loss_rel, worst=worst, flips=flips)


STREAM_ORDERS = ("npkc", "knpc", "pknc")   # the second order, in turn


def stream_inputs(device, gen, key):
    """Random x, w and bias of one serving signature at BATCH, and its
    ``conv2d_streams_auto`` arguments (bias, and ReLU as the signature
    fuses it)."""
    import torch
    h, w, c, k, r, s, st, pad, fused = key
    x = torch.randn((BATCH, h, w, c), generator=gen, device=device)
    wt = torch.randn((r, s, c, k), generator=gen, device=device) \
        * math.sqrt(2.0 / (r * s * c))
    bias = torch.randn(k, generator=gen, device=device) * 0.1
    return x, wt, dict(stride=st, padding=pad, bias=bias,
                       relu="relu" in fused)


def stream_schedule(x, wt, blk, order, relu, stride, padding):
    """The dryrun of one conv under ``blk`` with ``order``."""
    from repro_torch.core.streams import build_conv_schedule
    n, h, _, c = x.shape
    r, _, _, k = wt.shape
    p = (h + 2 * padding - r) // stride + 1
    return build_conv_schedule(n=n, k_b=k // blk.k_blk,
                               p_b=math.ceil(p / min(blk.rb_p, p)),
                               c_b=c // blk.c_blk, order=order, relu=relu)


def rel_err(out, plain) -> tuple[float, float]:
    max_abs = float((out - plain).abs().max())
    return max_abs, max_abs / float(plain.abs().max())


def row_rel_err(out, plain) -> float:
    """The worst row's max |diff| / max |plain| along the last axis (one
    query row of an attention output)."""
    return float(((out - plain).abs().amax(-1)
                  / plain.abs().amax(-1).clamp_min(1e-30)).max())


K4_NEEDLE = "conv2d_streams_kernel"     # both routes' kernel names hold it


def streams_signatures(device, sigs):
    """Phase 12: K4 against its plain replay on every serving signature
    under the analytic "streams" blocking, with order nkpc and one other
    order, and once on a schedule whose runs are shuffled, every launch on
    the mma route (``launches_mma``); per signature its route and mma tile,
    times of K4 on the mma route and with the SIMT route forced (CUDA
    events and profiler), the plain replay, K1 with the same bias and
    ReLU, cuDNN, and both bounds (f32 SIMT, 3xTF32).  Returns
    per-signature records."""
    import numpy as np
    import torch
    from repro_torch.core.blocking import conv_blocking
    from repro_torch.core.streams import permute_runs, run_starts
    from repro_torch.kernels import conv2d_direct as k1
    from repro_torch.kernels import conv2d_streams as k4
    from repro_torch.kernels import ref
    from repro_torch.launch import roofline

    gen = torch.Generator(device=device).manual_seed(SEED + 12)
    rows = []
    print(f"\nK4 vs plain replay, ResNet-50 {IMAGE}x{IMAGE} batch {BATCH} "
          f"({len(sigs)} signatures, {sum(sigs.values())} convs), analytic "
          f"'streams' blocking, bias + ReLU as fused; ev = CUDA events, dev "
          f"= profiler device time; mma = the route taken (conv2d_streams."
          f"route), tile its CTA sub-tile (mma_tile_config); simt = the SIMT "
          f"route forced; k1 = K1 with the same bias/ReLU; library = cuDNN "
          f"f32 + bias/ReLU; bounds f32 SIMT and 3xTF32:")
    print("  h  w    c    k r st relu count rb_p k_blk c_blk order route "
          "tile     steps  segs  max_rel  mma_ev mma_dev simt_ev simt_dev "
          " plain_ms   k1_ev  k1_dev  library  bound mma_bound bound_by")
    routed = [0, 0]     # K4 launches of the checks, and those on mma
    for i, (key, count) in enumerate(sigs.items()):
        h, w, c, k, r, s, st, pad, fused = key
        p = (h + 2 * pad - r) // st + 1
        q = (w + 2 * pad - s) // st + 1
        x, wt, kw = stream_inputs(device, gen, key)
        blk = conv_blocking(h=h, w=w, c=c, k=k, r=r, s=s, stride=st,
                            padding=pad, kind="streams", autotune="off")
        knobs = dict(stride=st, padding=pad, bias=kw["bias"], rb_p=blk.rb_p,
                     k_blk=blk.k_blk, c_blk=blk.c_blk)
        path = k4.route(x, wt, blk.c_blk, blk.k_blk)
        check(path == "mma", f"K4 at {key} takes the {path} route")
        k4.launches = k4.launches_mma = 0
        worst = (0.0, 0.0)
        for order in ("nkpc", STREAM_ORDERS[i % len(STREAM_ORDERS)]):
            sched = stream_schedule(x, wt, blk, order, kw["relu"], st, pad)
            out = k4.conv2d_streams(x, wt, schedule=sched, **knobs)
            plain = k4.conv2d_streams_plain(x, wt, schedule=sched, **knobs)
            torch.cuda.synchronize()
            check(bool(torch.isfinite(out).all()), f"K4 non-finite at {key}")
            err = rel_err(out, plain)
            worst = max(worst, err, key=lambda e: e[1])
            check(err[1] <= KERNEL_REL_TOL,
                  f"K4 disagrees with its plain replay at {key} order "
                  f"{order}: max_rel {err[1]:.3e} > {KERNEL_REL_TOL}")
        sched = stream_schedule(x, wt, blk, blk.order, kw["relu"], st, pad)
        shuffled = None
        if i == 1:
            perm = np.random.default_rng(SEED).permutation(
                len(run_starts(sched))).tolist()
            shuf = permute_runs(sched, perm)
            base = k4.conv2d_streams(x, wt, schedule=sched, **knobs)
            out = k4.conv2d_streams(x, wt, schedule=shuf, **knobs)
            plain = k4.conv2d_streams_plain(x, wt, schedule=sched, **knobs)
            torch.cuda.synchronize()
            shuffled = dict(runs=len(perm), equal_bits=bool(torch.equal(
                out, base)), max_rel_err=rel_err(out, plain)[1])
            print(f"  shuffled runs ({len(perm)} runs permuted, {key}): same "
                  f"bits as in order {shuffled['equal_bits']}, max_rel "
                  f"{shuffled['max_rel_err']:.2e}")
            check(shuffled["max_rel_err"] <= KERNEL_REL_TOL,
                  "K4 on shuffled runs disagrees with the plain replay")
            check(shuffled["equal_bits"], "K4 on shuffled runs gave other "
                  "bits than on the runs in order")

        def run():
            return k4.conv2d_streams(x, wt, schedule=sched, **knobs)

        def k1_run():
            return k1.conv2d_direct(x, wt, stride=st, padding=pad,
                                    bias=kw["bias"], relu=kw["relu"])
        routed = [routed[0] + k4.launches, routed[1] + k4.launches_mma]
        check(k4.launches == k4.launches_mma,
              f"{k4.launches - k4.launches_mma} of {k4.launches} K4 launches "
              f"at {key} took the SIMT route, expected none")
        ms, dev = k4_times(run)
        with returning(k4, "route", "simt"):
            simt_ms, simt_dev = k4_times(run)
        plain_ms = cuda_ms(lambda: k4.conv2d_streams_plain(
            x, wt, schedule=sched, **knobs), 1)
        k1_ms = cuda_ms(k1_run, 30)
        trace = trace_device(lambda i: k1_run(), 10, {K1_NEEDLE: k1},
                             sync_each=True)
        k1_dev = device_ms_of(trace, K1_NEEDLE) \
            + device_ms_of(trace, K1_SPLIT_SUM)
        library_ms = cuda_ms(lambda: ref.conv2d_fused(
            x, wt, stride=st, padding=pad, bias=kw["bias"],
            relu=kw["relu"]), 30)
        flops = 2.0 * BATCH * p * q * k * c * r * s
        nbytes = 4.0 * (BATCH * h * w * c + r * s * c * k + k
                        + BATCH * p * q * k)
        bound_ms, bound_by = bound(flops, nbytes)
        mma_bound_ms, _ = roofline.bound_ms(3 * flops, nbytes,
                                            roofline.TF32_PEAK_FLOPS)
        tile = k4.MMA_TILES[k4.mma_tile_config(
            tile_m=min(blk.rb_p, p) * q, k_blk=blk.k_blk,
            runs=len(run_starts(sched)))[0]]
        rec = dict(h=h, w=w, c=c, k=k, r=r, s=s, stride=st, padding=pad,
                   relu=kw["relu"], count=count,
                   blocking=dict(rb_p=blk.rb_p, k_blk=blk.k_blk,
                                 c_blk=blk.c_blk, order=blk.order),
                   route=path, tile=tile, steps=len(sched),
                   segments=len(sched.segments), max_abs_err=worst[0],
                   max_rel_err=worst[1], ms=ms, device_ms=dev,
                   simt_ms=simt_ms, simt_device_ms=simt_dev,
                   plain_ms=plain_ms, k1_ms=k1_ms, k1_device_ms=k1_dev,
                   library_ms=library_ms, bound_ms=bound_ms,
                   mma_bound_ms=mma_bound_ms,
                   bound_by=bound_by, flops=flops, shuffled=shuffled)
        rows.append(rec)
        print(f"{h:3d}{w:3d}{c:5d}{k:5d}{r:2d}{st:3d} {int(kw['relu']):4d}"
              f"{count:6d}{blk.rb_p:5d}{blk.k_blk:6d}{blk.c_blk:6d} "
              f"{blk.order:5s} {path:5s} {tile[0]:3d}x{tile[1]:<3d}"
              f"{len(sched):7d}{len(sched.segments):6d}  {worst[1]:.2e} "
              f"{ms:7.4f} {dev:7.4f} {simt_ms:7.4f} {simt_dev:8.4f} "
              f"{plain_ms:9.3f} {k1_ms:7.4f} {k1_dev:7.4f} {library_ms:8.4f} "
              f"{bound_ms:6.4f} {mma_bound_ms:9.4f} {bound_by}")
        del x, wt, kw, out, plain, sched
    print(f"  K4 launches of the checks on the mma route (launches_mma): "
          f"{routed[1]} of {routed[0]}")

    def weighted_(key_):
        return sum(r_[key_] * r_["count"] for r_ in rows)
    print(f"  per forward (x count): K4 mma {weighted_('ms'):.4f} ms by "
          f"events, {weighted_('device_ms'):.4f} device; SIMT forced "
          f"{weighted_('simt_ms'):.4f} / {weighted_('simt_device_ms'):.4f}; "
          f"K1 {weighted_('k1_ms'):.4f} / {weighted_('k1_device_ms'):.4f}; "
          f"bounds {weighted_('bound_ms'):.4f} (f32 SIMT), "
          f"{weighted_('mma_bound_ms'):.4f} (3xTF32)")
    print("  per-signature JSON:", json.dumps(rows))
    return rows


def k4_times(run) -> tuple[float, float]:
    """K4's time for ``run()``: CUDA events over 30 launches and profiler
    device time over 10."""
    from repro_torch.kernels import conv2d_streams as k4
    ms = cuda_ms(run, 30)
    dev = device_ms_of(trace_device(lambda i: run(), 10, {K4_NEEDLE: k4},
                                    sync_each=True), K4_NEEDLE)
    return ms, dev


def tuned_replay(device, sigs, rows):
    """Phase 13, the slice's main path: ``tune.warmup_convs`` times the
    cost model's shortlist of "streams" blockings for every serving shape
    on the card into a cache in a temporary directory
    (``REPRO_TUNE_CACHE``); then ``conv2d_streams_auto(autotune="cache")``
    (dryrun with the cached blocking, replay through K4) runs every
    signature once, with K4's count set to 0 just before and read just
    after, and no measurement may happen in that pass.  Each result is held
    against the plain replay of the same schedule."""
    import tempfile

    import torch
    from repro_torch import tune
    from repro_torch.core.blocking import conv_blocking
    from repro_torch.core.streams import run_starts
    from repro_torch.kernels import conv2d_streams as k4
    from repro_torch.tune import measure

    shapes = []
    for key in sigs:
        sh = dict(zip(("h", "w", "c", "k", "r", "s", "stride", "padding"),
                      key[:8]))
        if sh not in shapes:
            shapes.append(sh)
    gen = torch.Generator(device=device).manual_seed(SEED + 13)
    inputs = {key: stream_inputs(device, gen, key) for key in sigs}
    prev = os.environ.get("REPRO_TUNE_CACHE")
    with tempfile.TemporaryDirectory() as tmp:
        os.environ["REPRO_TUNE_CACHE"] = os.path.join(tmp, "blockings.json")
        try:
            k4.launches = k4.launches_mma = measure.measurements = 0
            t0 = time.perf_counter()
            report = tune.warmup_convs(shapes, minibatches=(BATCH,),
                                       kinds=("streams",), mode="tune",
                                       backend="cuda")
            torch.cuda.synchronize()
            tune_s = time.perf_counter() - t0
            tuning = dict(launches=k4.launches, launches_mma=k4.launches_mma,
                          timed=measure.measurements, seconds=tune_s,
                          shapes=len(shapes))
            print(f"\ntuned replay: warmup_convs tuned {len(shapes)} shapes "
                  f"at batch {BATCH} in {tune_s:.2f}s wall: "
                  f"{measure.measurements} candidates timed, {k4.launches} K4 "
                  f"launches ({k4.launches_mma} on the mma route)")
            check(k4.launches_mma == k4.launches,
                  f"{k4.launches - k4.launches_mma} of the tuner's K4 "
                  f"launches took the SIMT route, expected none")
            check(len(report) == len(shapes) and all(
                e["cached"] and e["source"] == "measured" for e in report),
                f"warmup did not leave a measured entry for every shape: "
                f"{report}")
            check(os.path.isfile(os.environ["REPRO_TUNE_CACHE"]),
                  "the tuned cache was not written")

            k4.launches = k4.launches_mma = measure.measurements = 0
            outs = {}
            for key, (x, wt, kw) in inputs.items():
                outs[key] = k4.conv2d_streams_auto(x, wt, autotune="cache",
                                                   **kw)
            torch.cuda.synchronize()
            replay_launches, replay_mma = k4.launches, k4.launches_mma
            cache_timed = measure.measurements
            blocks = {key: conv_blocking(
                **dict(zip(("h", "w", "c", "k", "r", "s", "stride",
                            "padding"), key[:8])),
                kind="streams", autotune="cache", backend="cuda",
                minibatch=BATCH) for key in sigs}
            hits = sum(tune.lookup_conv(
                **dict(zip(("h", "w", "c", "k", "r", "s", "stride",
                            "padding"), key[:8])),
                kind="streams", backend="cuda", minibatch=BATCH) is not None
                for key in sigs)
        finally:
            if prev is None:
                del os.environ["REPRO_TUNE_CACHE"]
            else:
                os.environ["REPRO_TUNE_CACHE"] = prev
    print(f"  cache pass: {replay_launches} K4 launches for {len(sigs)} "
          f"signatures ({replay_mma} on the mma route), {cache_timed} "
          f"candidates timed, {hits} cache hits")
    check(replay_launches == len(sigs),
          f"K4 launched {replay_launches} times in the cache pass, expected "
          f"{len(sigs)}")
    check(replay_mma == replay_launches,
          f"{replay_launches - replay_mma} of the cache pass's K4 launches "
          f"took the SIMT route, expected none")
    check(cache_timed == 0, f"the cache pass timed {cache_timed} candidates")
    check(hits == len(sigs), f"{hits} of {len(sigs)} cache hits")

    analytic = dict(zip(sigs, rows))     # phase 12's rows, in sigs' order
    out_rows = []
    print("  tuned: the cached blocking on its route (mma) and with the SIMT "
          "route forced; analytic: phase 12's mma route; k1: phase 12's K1 "
          "with the same bias/ReLU")
    print("  h  w    c    k r st count  tuned rb_p k_blk c_blk order route "
          "tile      steps  max_rel  tuned_ev tuned_dev  simt_ev simt_dev "
          "analytic_ev analytic_dev   k1_dev  plain_ms")
    for key, count in sigs.items():
        x, wt, kw = inputs[key]
        blk = blocks[key]
        sched = stream_schedule(x, wt, blk, blk.order, kw["relu"],
                                kw["stride"], kw["padding"])
        knobs = dict(stride=kw["stride"], padding=kw["padding"],
                     bias=kw["bias"], rb_p=blk.rb_p, k_blk=blk.k_blk,
                     c_blk=blk.c_blk)
        plain = k4.conv2d_streams_plain(x, wt, schedule=sched, **knobs)
        max_abs, max_rel = rel_err(outs[key], plain)
        check(max_rel <= KERNEL_REL_TOL,
              f"tuned K4 disagrees with its plain replay at {key}: max_rel "
              f"{max_rel:.3e}")

        def run():
            return k4.conv2d_streams_auto(x, wt, blocking=blk, **kw)
        path = k4.route(x, wt, blk.c_blk, blk.k_blk)
        p = (key[0] + 2 * key[7] - key[4]) // key[6] + 1
        q = (key[1] + 2 * key[7] - key[5]) // key[6] + 1
        tile = k4.MMA_TILES[k4.mma_tile_config(
            tile_m=min(blk.rb_p, p) * q, k_blk=blk.k_blk,
            runs=len(run_starts(sched)))[0]]
        ms, dev = k4_times(run)
        with returning(k4, "route", "simt"):
            simt_ms, simt_dev = k4_times(run)
        plain_ms = cuda_ms(lambda: k4.conv2d_streams_plain(
            x, wt, schedule=sched, **knobs), 1)
        a = analytic[key]
        rec = dict(a, blocking=dict(rb_p=blk.rb_p, k_blk=blk.k_blk,
                                    c_blk=blk.c_blk, order=blk.order),
                   route=path, tile=tile,
                   steps=len(sched), segments=len(sched.segments),
                   max_abs_err=max_abs, max_rel_err=max_rel, ms=ms,
                   device_ms=dev, simt_ms=simt_ms, simt_device_ms=simt_dev,
                   plain_ms=plain_ms,
                   analytic_ms=a["ms"], analytic_device_ms=a["device_ms"])
        out_rows.append(rec)
        h, w, c, k, r, s, st, pad, fused = key
        print(f"{h:3d}{w:3d}{c:5d}{k:5d}{r:2d}{st:3d}{count:6d}       "
              f"{blk.rb_p:4d}{blk.k_blk:6d}{blk.c_blk:6d} {blk.order:5s} "
              f"{path:5s} {tile[0]:3d}x{tile[1]:<3d}"
              f"{len(sched):7d}  {max_rel:.2e} {ms:9.4f} {dev:9.4f} "
              f"{simt_ms:8.4f} {simt_dev:8.4f} {a['ms']:11.4f} "
              f"{a['device_ms']:12.4f} {a['k1_device_ms']:8.4f} "
              f"{plain_ms:9.3f}")
        del plain, sched
    print("  per-signature JSON:", json.dumps(out_rows))
    return out_rows, dict(tuning, replay_launches=replay_launches,
                          replay_mma=replay_mma, cache_timed=cache_timed,
                          hits=hits)


# ---------------------------------------------------------------------------
# Phase 7b: Inception-v3 served on the card; phase 13b: the plan tuner
# ---------------------------------------------------------------------------

INCEPTION_IMAGE = 299
GEO = ("h", "w", "c", "k", "r", "s", "stride", "padding")


def inception_serving(device, f32_stats, q8_stats) -> dict:
    """Phase 7b: Inception-v3 (1000 classes, 299x299, random weights and BN
    statistics from seed 7) through ``CnnInferenceEngine`` and
    ``ImageServer`` at max_batch 16, f32 and then int8 (its own
    calibration), with the tiled kernels and default plans (warmup
    autotune "off"): phase 3's window (64 untimed, then 512 requests in
    bursts), images/s and p50/p99 beside ResNet-50's from phases 3 and 6;
    K1 (f32) or K3 (int8) exactly 23 launches per forward, every one on
    the mma or ring route; then a batch of 2 on the card against the
    port's CPU forward (the int8 one on the card's quantized tree): max
    |diff| <= 1e-4 (f32) or 1e-3 (int8) * max |logit| and the same
    top-1."""
    import numpy as np
    import torch
    from repro_torch.core.conv import lane_ok
    from repro_torch.graph import GxM, inception_v3
    from repro_torch.graph.serving import CnnInferenceEngine
    from repro_torch.kernels import conv2d_direct as k1
    from repro_torch.kernels import conv2d_q8 as k3
    from repro_torch.launch.serve_cnn import build_model, serve_window

    gxm, image = build_model(smoke=False, device=device, arch="inception")
    check(image == INCEPTION_IMAGE and gxm.num_classes == 1000,
          f"Inception-v3 image {image}, {gxm.num_classes} classes")
    gen = torch.Generator().manual_seed(SEED + 7)
    params = gxm.init(gen)
    random_bn_stats(params, gen)
    per_fwd = sum(1 for t in gxm.etg.tasks if t.op == "conv"
                  and lane_ok(t.attrs["c"], t.attrs["k"]))
    convs = sum(1 for t in gxm.etg.tasks if t.op == "conv")
    check(per_fwd == 23, f"{per_fwd} lane-aligned Inception-v3 convs, not 23")
    images = np.random.default_rng(SEED + 1).standard_normal(
        (PARITY_BATCH, image, image, 3), dtype=np.float32)
    out = {}
    for quantized, resnet in ((False, f32_stats), (True, q8_stats)):
        name = "int8" if quantized else "f32"
        net = build_model(smoke=False, device=device, arch="inception")[0] \
            if quantized else gxm
        engine = CnnInferenceEngine(net, params, image_hw=(image, image),
                                    max_batch=BATCH, quantized=quantized)
        t0 = time.perf_counter()
        report = engine.warmup(autotune="off")
        warm_s = time.perf_counter() - t0
        server, results = serve_window(engine, requests=REQUESTS, seed=SEED)
        launches = k3.launches if quantized else k1.launches
        routed = k3.launches_ring if quantized else k1.launches_mma
        other = k1.launches if quantized else k3.launches
        st = server.stats()
        print(f"\nInception-v3 {name} serving: {image}x{image}, warmup of "
              f"buckets {report['buckets']} in {warm_s:.2f}s; {REQUESTS} "
              f"requests in {st['batches']} batches {st['by_bucket']}")
        print(f"  images/s {st['images_per_s']:.2f}  p50 "
              f"{st['latency']['p50_ms']:.3f} ms  p99 "
              f"{st['latency']['p99_ms']:.3f} ms; ResNet-50 {name} (phase "
              f"{6 if quantized else 3}): images/s "
              f"{resnet['images_per_s']:.2f}  p50 "
              f"{resnet['latency']['p50_ms']:.3f} ms  p99 "
              f"{resnet['latency']['p99_ms']:.3f} ms")
        kname, rname = ("K3", "ring") if quantized else ("K1", "mma")
        print(f"  {kname} launches {launches} = {per_fwd} of {convs} convs x "
              f"{st['batches']} forwards, {routed} on the {rname} route; "
              f"{'K1' if quantized else 'K3'} {other}")
        check(len(results) == REQUESTS and all(
            0 <= c < 1000 and math.isfinite(v) for c, v in results.values()),
            f"Inception-v3 {name}: bad results")
        check(set(st["by_bucket"]) == set(engine.buckets),
              f"buckets served {sorted(st['by_bucket'])}")
        check(launches == per_fwd * st["batches"] and routed == launches
              and other == 0,
              f"Inception-v3 {name}: {kname} {launches} launches ({routed} "
              f"on the {rname} route), expected {per_fwd} x "
              f"{st['batches']} all on it")
        run = engine.qparams if quantized else params
        card = engine.infer(images).cpu()
        cpu_run = {n_: {leaf: v.cpu() for leaf, v in p.items()}
                   for n_, p in run.items()}
        t0 = time.perf_counter()
        cpu = GxM(inception_v3(), device="cpu", quantized=quantized).infer(
            cpu_run, torch.from_numpy(images))
        cpu_s = time.perf_counter() - t0
        max_abs = float((card - cpu).abs().max())
        scale = float(cpu.abs().max())
        top1 = bool((card.argmax(-1) == cpu.argmax(-1)).all())
        tol = INT8_LOGIT_REL_TOL if quantized else LOGIT_REL_TOL
        print(f"  parity: card vs CPU (batch {PARITY_BATCH}, {cpu_s:.1f}s on "
              f"CPU): max|diff| {max_abs:.3e}, max|logit| {scale:.3e}, ratio "
              f"{max_abs / scale:.3e} (limit {tol}), same top-1 {top1}")
        check(card.shape == (PARITY_BATCH, 1000)
              and bool(torch.isfinite(card).all()), "logits not finite")
        check(max_abs <= tol * scale, f"Inception-v3 {name} logits differ "
              f"by {max_abs:.3e} > {tol} * {scale:.3e}")
        check(top1, f"Inception-v3 {name} top-1 differs from the CPU")
        out[name] = dict(images_per_s=st["images_per_s"],
                         p50_ms=st["latency"]["p50_ms"],
                         p99_ms=st["latency"]["p99_ms"],
                         launches=launches, batches=st["batches"],
                         parity_ratio=max_abs / scale, same_top1=top1,
                         resnet50_images_per_s=resnet["images_per_s"],
                         resnet50_p50_ms=resnet["latency"]["p50_ms"])
        del engine, net
    torch.cuda.empty_cache()
    return out


PLAN_REL_TOL = 1.03     # a tuned plan's device time against its default's


def plan_row(kind: str, geo: tuple, n: int, count: int, cache) -> dict:
    """One tuned signature: its cache entry (the tuning pass's default and
    tuned times, candidates timed), the tuned launch against the kernel's
    plain version (K1, K2, K10a, K10b <= 1e-5; K3, K10c the same bits), and
    both plans timed again on one set of inputs, in turns (default, tuned,
    tuned, default, twice over; device time, ``tune.measure.device_us``).
    A whole-plane kind's plan is its ``ConvBlocking``, its default the
    analytic blocking."""
    import numpy as np
    import torch
    from repro_torch import tune
    from repro_torch.kernels import conv2d_direct as k1
    from repro_torch.kernels import conv2d_q8 as k3
    from repro_torch.kernels import conv2d_wu as k2
    from repro_torch.tune import measure, space

    sh = dict(zip(GEO, geo))
    db = tune.plan_dtype_bytes(kind)
    entry = cache.lookup(tune.conv_key(kind=kind, **sh, dtype_bytes=db,
                                       backend="cuda", minibatch=n))
    plan = tune.lookup_plan(kind=kind, **sh, minibatch=n, cache=cache)
    default = space.default_plan(kind, n=n, **sh)
    check(plan is not None and entry["source"] == "measured",
          f"no measured {kind} plan for {geo} at batch {n}: {entry}")
    check(entry["timed"] <= 8 and entry["default_us"] >= entry["score_us"],
          f"{kind} {geo}: {entry['timed']} timed, tuned "
          f"{entry['score_us']} us against the default's "
          f"{entry['default_us']}")
    whole = kind in space.WHOLE_KINDS
    base = space.whole_base(kind) if whole else kind
    args = measure.conv_inputs(base, sh, n)
    out = measure.kernel_call(kind, sh, args, plan)()
    torch.cuda.synchronize()
    geo_kw = dict(stride=sh["stride"], padding=sh["padding"])
    blk_kw = {} if not whole else dict(b_p=plan.rb_p, k_blk=plan.k_blk) \
        if base == "wu" else dict(rb_p=plan.rb_p, k_blk=plan.k_blk)
    if base == "q8":
        exp = (k3.conv2d_q8_whole_plain if whole else k3.conv2d_q8_plain)(
            **args, **geo_kw, **blk_kw)
        err = float((out - exp).abs().max())
        check(err == 0, f"tuned {kind} {plan} at {geo}: max |diff| {err}")
    else:
        if base == "wu":
            exp = (k2.conv2d_wu_whole_plain if whole else k2.conv2d_wu_plain)(
                **args, **geo_kw, filter_rs=(sh["r"], sh["s"]), **blk_kw)
        else:
            exp = (k1.conv2d_direct_whole_plain if whole
                   else k1.conv2d_direct_plain)(**args, **geo_kw, **blk_kw)
        err = float((out - exp).abs().max()) / float(exp.abs().max())
        check(err <= KERNEL_REL_TOL, f"tuned {kind} {plan} at {geo}: "
              f"max_rel {err:.3e}")
    del out, exp
    run_d = measure.kernel_call(kind, sh, args, default)
    run_t = measure.kernel_call(kind, sh, args, plan)
    if plan == default:         # one plan: one series of readings
        d_us = t_us = float(np.median([measure.device_us(run_d)
                                       for _ in range(4)]))
    else:
        ds, ts = [], []
        for _ in range(2):
            ds.append(measure.device_us(run_d))
            ts.append(measure.device_us(run_t))
            ts.append(measure.device_us(run_t))
            ds.append(measure.device_us(run_d))
        d_us, t_us = float(np.median(ds)), float(np.median(ts))
    check(t_us <= PLAN_REL_TOL * d_us,
          f"tuned {kind} plan {plan} at {geo}, batch {n}: {t_us:.2f} us "
          f"against the default's {d_us:.2f} us")
    del args
    return dict(kind=kind, geo=geo, n=n, count=count,
                default=dataclasses.asdict(default),
                plan=dataclasses.asdict(plan), same=plan == default,
                tuning_default_us=entry["default_us"],
                tuning_tuned_us=entry["score_us"], timed=entry["timed"],
                candidates=entry["candidates"], default_us=d_us,
                tuned_us=t_us, err=err)


def _plan_text(kind: str, p: dict) -> str:
    if kind.endswith("_whole"):
        return f"rb_p {p['rb_p']} k_blk {p['k_blk']}"
    if kind == "q8":
        return f"{p['bm']}x{p['bn']}/{p['bk']} s{p['splits']}"
    return f"t{p['tile']} s{p['splits']} c{p['chunk']}"


def serve_window_timed(engine, label: str, requests: int = REQUESTS,
                       warm_requests: int = 64) -> dict:
    """``serve_window`` (``warm_requests`` untimed, then ``requests``) with
    the counts of K1, K3 and their whole-plane forms K10a and K10c read
    just after and ``tune.measure.measurements`` held at 0 over both
    passes."""
    from repro_torch.kernels import conv2d_direct as k1
    from repro_torch.kernels import conv2d_q8 as k3
    from repro_torch.launch.serve_cnn import serve_window
    from repro_torch.tune import measure

    measure.measurements = 0
    server, results = serve_window(engine, requests=requests, seed=SEED,
                                   warm_requests=warm_requests)
    st = server.stats()
    check(len(results) == requests, f"{label}: served {len(results)}")
    check(measure.measurements == 0, f"{label}: the serving window timed "
          f"{measure.measurements} candidates")
    return dict(images_per_s=st["images_per_s"],
                p50_ms=st["latency"]["p50_ms"],
                p99_ms=st["latency"]["p99_ms"], batches=st["batches"],
                k1=k1.launches, k1_mma=k1.launches_mma, k3=k3.launches,
                k3_ring=k3.launches_ring, k10a=k1.launches_whole,
                k10a_mma=k1.launches_whole_mma, k10c=k3.launches_whole,
                k10c_mma=k3.launches_whole_mma)


def plan_tuning(device, sigs, fwd, dual, wu, serve_params) -> dict:
    """Phase 13b: the §II-D tuner over K1's, K2's and K3's plans, into a
    cache in a temporary directory (``REPRO_TUNE_CACHE``).

    ``CnnInferenceEngine.warmup(autotune="tune")`` tunes ResNet-50's
    serving signatures at every bucket ("fwd" on an f32 engine, "q8" at 1
    byte on an int8 one), ``warmup_cnn_train`` its training signatures at
    batch 32 ("fwd", "bwd" on the 31 distinct dual convs, "wu" on the 22
    weight updates): at most 8 plans timed a signature, the kernel's
    default among them, every launch on the mma or ring route.  Per
    signature at batch 16 (serving) and 32 (training): the tuned launch
    against the plain version, the default and tuned plans with the
    tuning pass's times and the candidates timed, and both timed again in
    turns on one set of inputs (the tuned no more than 3 % above the
    default); the sums per 52-conv forward and per step.  Then the f32 and
    int8 windows of phases 3 and 6 (two each way) and ten training steps,
    each with the default plans (autotune "off") and under "cache", in
    turns: images/s, p50 and step ms, the launch counts, no candidate
    timed."""
    import tempfile

    import numpy as np
    import torch
    from repro_torch import tune
    from repro_torch.graph.serving import CnnInferenceEngine
    from repro_torch.kernels import conv2d_direct as k1
    from repro_torch.kernels import conv2d_q8 as k3
    from repro_torch.kernels import conv2d_wu as k2
    from repro_torch.launch.serve_cnn import build_model
    from repro_torch.launch.train_cnn import build_trainer
    from repro_torch.train.step import make_cnn_train_step, warmup_cnn_train
    from repro_torch.tune import measure

    serve_geo: dict[tuple, int] = {}
    for key, count in sigs.items():
        serve_geo[key[:8]] = serve_geo.get(key[:8], 0) + count
    prev = os.environ.get("REPRO_TUNE_CACHE")
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        os.environ["REPRO_TUNE_CACHE"] = os.path.join(tmp, "plans.json")
        try:
            cache = tune.default_cache()
            k1.launches = k1.launches_mma = k2.launches = 0
            k2.launches_mma = k3.launches = k3.launches_ring = 0
            measure.measurements = 0
            t0 = time.perf_counter()
            engines = {}
            for quantized in (False, True):
                gxm = build_model(smoke=False, device=device)[0]
                eng = CnnInferenceEngine(gxm, serve_params,
                                         image_hw=(IMAGE, IMAGE),
                                         max_batch=BATCH,
                                         quantized=quantized)
                rep = eng.warmup(autotune="tune")
                engines["int8" if quantized else "f32"] = (eng, rep)
            serve_s = time.perf_counter() - t0
            gxm_t, params_t, step_cache, data = build_trainer(
                full=True, num_classes=1000, image=IMAGE, batch=TRAIN_BATCH,
                lr=TRAIN_LR, device=device, seed=SEED, autotune="cache")
            t1 = time.perf_counter()
            rep_t = warmup_cnn_train(gxm_t, image_hw=(IMAGE, IMAGE),
                                     minibatch=TRAIN_BATCH)
            torch.cuda.synchronize()
            train_s = time.perf_counter() - t1
            tuning = dict(serve_seconds=serve_s, train_seconds=train_s,
                          timed=measure.measurements,
                          k1=k1.launches, k1_mma=k1.launches_mma,
                          k2=k2.launches, k2_mma=k2.launches_mma,
                          k3=k3.launches, k3_ring=k3.launches_ring,
                          entries=len(cache))
            print(f"\nplan tuning: serving warmups (f32 'fwd' "
                  f"{engines['f32'][1]['tune_entries']} entries, int8 'q8' "
                  f"{engines['int8'][1]['tune_entries']}, buckets "
                  f"{engines['f32'][1]['buckets']}) in {serve_s:.2f}s, "
                  f"warmup_cnn_train ({len({e['key'] for e in rep_t if e['cached']})} "
                  f"distinct plans of {len(rep_t)} keys) in {train_s:.2f}s; "
                  f"{measure.measurements} candidates timed; launches K1 "
                  f"{k1.launches} ({k1.launches_mma} mma), K2 {k2.launches} "
                  f"({k2.launches_mma} mma), K3 {k3.launches} "
                  f"({k3.launches_ring} ring)")
            check(k1.launches == k1.launches_mma and k2.launches ==
                  k2.launches_mma and k3.launches == k3.launches_ring,
                  "a tuning launch left the mma or ring route")
            cached = len({e["key"] for e in rep_t if e["cached"]})
            check(cached == len(fwd) + len(dual) + len(wu),
                  f"warmup_cnn_train cached {cached} distinct plans, "
                  f"expected {len(fwd) + len(dual) + len(wu)}")

            rows = []
            for kind, table, n in (("fwd", serve_geo, BATCH),
                                   ("q8", serve_geo, BATCH),
                                   ("fwd", fwd, TRAIN_BATCH),
                                   ("bwd", dual, TRAIN_BATCH),
                                   ("wu", wu, TRAIN_BATCH)):
                for geo, count in table.items():
                    rows.append(plan_row(kind, geo, n, count, cache))
            print("  per signature: the tuning pass's default and tuned "
                  "device us, candidates timed; then both plans timed again "
                  "in turns (device us); plans: K1/K2 tile code, splits, "
                  "chunk; K3 tile/stage channels, splits")
            print("  kind  n   h   w    c    k r st count  timed  tuning: "
                  "default -> tuned   again: default   tuned   default plan"
                  "       tuned plan")
            for r_ in rows:
                h, w, c, k, r, s, st, pd = r_["geo"]
                print(f"  {r_['kind']:4s}{r_['n']:3d}{h:4d}{w:4d}{c:5d}"
                      f"{k:5d}{r:2d}{st:3d}{r_['count']:6d}{r_['timed']:4d}/"
                      f"{r_['candidates']:<4d}{r_['tuning_default_us']:9.2f}"
                      f" ->{r_['tuning_tuned_us']:9.2f}  "
                      f"{r_['default_us']:9.2f}{r_['tuned_us']:9.2f}   "
                      f"{_plan_text(r_['kind'], r_['default']):18s} "
                      f"{'same' if r_['same'] else _plan_text(r_['kind'], r_['plan'])}")

            def total(pick, key):
                return sum(r_[key] * r_["count"] for r_ in rows
                           if pick(r_)) / 1e3
            sums = {}
            for name, pick in (
                    ("forward_f32", lambda r_: r_["kind"] == "fwd"
                     and r_["n"] == BATCH),
                    ("forward_int8", lambda r_: r_["kind"] == "q8"),
                    ("step_forward", lambda r_: r_["kind"] == "fwd"
                     and r_["n"] == TRAIN_BATCH),
                    ("step_dual", lambda r_: r_["kind"] == "bwd"),
                    ("step_wu", lambda r_: r_["kind"] == "wu")):
                sums[name] = dict(default_ms=total(pick, "default_us"),
                                  tuned_ms=total(pick, "tuned_us"),
                                  changed=sum(1 for r_ in rows if pick(r_)
                                              and not r_["same"]),
                                  signatures=sum(1 for r_ in rows
                                                 if pick(r_)))
            sums["step"] = {key: sum(sums[p][key] for p in (
                "step_forward", "step_dual", "step_wu"))
                for key in ("default_ms", "tuned_ms", "changed",
                            "signatures")}
            for name, v in sums.items():
                print(f"  {name}: default plans {v['default_ms']:.4f} ms, "
                      f"tuned {v['tuned_ms']:.4f} ms device (x count); "
                      f"{v['changed']} of {v['signatures']} signatures "
                      f"changed plan")

            # the main paths with the default plans and under "cache"
            for name in ("f32", "int8"):
                eng, _ = engines[name]
                off = CnnInferenceEngine(eng.gxm, serve_params,
                                         image_hw=(IMAGE, IMAGE),
                                         max_batch=BATCH,
                                         quantized=eng.quantized,
                                         autotune="off")
                off.qparams, off.act_scales = eng.qparams, eng.act_scales
                off.warmup(autotune="off")
                # in turns (off, cache, cache, off): the host a call gets
                # moves a window's images/s by more than the plans do
                runs = {"off": [], "cache": []}
                for mode in ("off", "cache", "cache", "off"):
                    runs[mode].append(serve_window_timed(
                        off if mode == "off" else eng, f"{name} {mode}"))
                res = {mode: dict(v[-1], **{key: float(np.mean(
                    [x[key] for x in v])) for key in (
                        "images_per_s", "p50_ms", "p99_ms")},
                    windows=[x["images_per_s"] for x in v])
                    for mode, v in runs.items()}
                for mode, v in res.items():
                    n_ = v["k3"] if name == "int8" else v["k1"]
                    on = v["k3_ring"] if name == "int8" else v["k1_mma"]
                    other = v["k1"] if name == "int8" else v["k3"]
                    print(f"  {name} serving, plans {mode:5s}: images/s "
                          f"{v['images_per_s']:.2f} (windows "
                          f"{', '.join(f'{x:.2f}' for x in v['windows'])})"
                          f"  p50 {v['p50_ms']:.3f} ms  p99 "
                          f"{v['p99_ms']:.3f} ms (means of two); "
                          f"{'K3' if name == 'int8' else 'K1'} {n_} "
                          f"launches ({on} on the "
                          f"{'ring' if name == 'int8' else 'mma'} route)")
                    check(n_ == 52 * v["batches"] and on == n_
                          and other == 0, f"{name} serving under {mode}: "
                          f"{n_} launches, {on} routed, {other} other")
                out[f"serving_{name}"] = res
                del off
            engines.clear()
            torch.cuda.empty_cache()

            step_off = make_cnn_train_step(gxm_t, lr=TRAIN_LR,
                                           autotune="off")
            batches = [data.batch_at(i) for i in range(4)]
            batches = [{key: torch.as_tensor(v, device=device)
                        for key, v in b.items()} for b in batches]
            for st_ in (step_off, step_cache):
                for b in batches[:2]:
                    st_(params_t, b)
            times = {"off": [], "cache": []}
            measure.measurements = 0
            pair = (("off", step_off), ("cache", step_cache))
            for i in range(10):     # in turns, the order reversed each round
                for mode, st_ in (pair if i % 2 == 0 else pair[::-1]):
                    torch.cuda.synchronize()
                    t2 = time.perf_counter()
                    _, loss = st_(params_t, batches[2 + i % 2])
                    torch.cuda.synchronize()
                    times[mode].append((time.perf_counter() - t2) * 1e3)
                    check(math.isfinite(float(loss)), "non-finite loss")
            check(measure.measurements == 0, "a cache step timed candidates")
            k1.launches = k1.launches_mma = k2.launches = 0
            k2.launches_mma = 0
            step_cache(params_t, batches[2])
            torch.cuda.synchronize()
            counts = dict(k1=k1.launches, k1_mma=k1.launches_mma,
                          k2=k2.launches, k2_mma=k2.launches_mma)
            check(counts == dict(k1=113, k1_mma=113, k2=52, k2_mma=52),
                  f"one cache step launched {counts}")
            train = {mode: float(np.median(v)) for mode, v in times.items()}
            for mode in ("off", "cache"):
                print(f"  training, plans {mode:5s}: {train[mode]:.3f} ms a "
                      f"step (median of 10, in turns), "
                      f"{TRAIN_BATCH / train[mode] * 1e3:.2f} images/s")
            print(f"  one cache step: K1 {counts['k1']} ({counts['k1_mma']} "
                  f"mma), K2 {counts['k2']} ({counts['k2_mma']} mma)")
            out["training"] = dict(step_ms=train, counts=counts)
        finally:
            if prev is None:
                del os.environ["REPRO_TUNE_CACHE"]
            else:
                os.environ["REPRO_TUNE_CACHE"] = prev
    out.update(tuning=tuning, sums=sums, rows=rows)
    print("  per-signature JSON:", json.dumps(rows))
    return out


# ---------------------------------------------------------------------------
# Phases 14-17: the dense-LM serving slice (Qwen2-1.5B, K7 and K6)
# ---------------------------------------------------------------------------

LM_ARCH = "qwen2-1.5b"
LM_LANES = 8
LM_MAX_LEN = 2048
LM_MAX_NEW = 32
LM_REQUESTS = 32
LM_WARM_REQUESTS = 8
LM_PROMPT_LEN = (128, 1024)       # uniform, both ends included
LM_PREFILL = (8, 512)             # batch, tokens of the direct prefill
LM_DECODE_STEPS = 16
LM_PARITY_PROMPTS = [(2, 64)]       # (batch, tokens) of each parity batch
LM_PARITY_STEPS = 4
BF16_REL_TOL = 1e-2               # K6, K7 vs plain on bf16 inputs
LSE_REL_TOL = 1e-4                # K7's saved lse vs lse_plain, of max |lse|
MATMUL_M = 4096                   # tokens of the K6 shapes
# K7: b, hq, hkv, l, dh, causal (Qwen2-1.5B's prefill, one SmolLM-360M)
ATTN_SHAPES = [(b, 12, 2, l, 128, True) for b in (1, 8)
               for l in (128, 333, 1024)] + [(1, 12, 2, 1024, 128, False),
                                             (1, 15, 5, 512, 64, True)]
# K6: k, n, act, bias, residual (Qwen2-1.5B's projections, gelu, relu)
MATMUL_SHAPES = [(1536, 1536, "none", True, False),
                 (1536, 256, "none", True, False),
                 (1536, 8960, "silu", False, False),
                 (8960, 1536, "none", False, True),
                 (1536, 8960, "gelu", True, False),
                 (1536, 1536, "relu", True, True)]
# K6, bf16: m, k, n, act, bias, residual, and the route each must take:
# tails of every tile dimension on the wgmma route, and a K off the
# multiples of 8 on the SIMT route
MATMUL_RAGGED = [(1000, 1528, 1000, "gelu", True, True, "wgmma"),
                 (1000, 1530, 1000, "silu", True, True, "simt")]


def auto_ms(fn, target_ms: float = 60.0) -> float:
    """``cuda_ms`` over enough launches to fill about ``target_ms``."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    once = (time.perf_counter() - t0) * 1e3
    return cuda_ms(fn, max(3, min(200, int(target_ms / max(once, 1e-3)))))


def kernel_device_ms(fn, needle: str, module, iters: int = 5,
                     also: tuple = ()) -> tuple[float, int]:
    """Device ms per launch of the kernels named ``needle`` over ``iters``
    calls of ``fn`` under ``torch.profiler`` (``trace_device``, which holds
    the launches it recorded to ``module.launches``), and that count; the
    device time of the kernels named by the needles in ``also`` (a
    wrapper's second pass) is added in.  The host waits for each call to
    end before the next, which leaves each kernel's device time as it is
    and keeps the profiler's records whole."""
    trace = trace_device(lambda i: fn(), iters, {needle: module},
                         sync_each=True)
    launches = sum(n for name, n in trace["launches"].items()
                   if needle in name)
    ms = sum(device_ms_of(trace, key) for key in (needle, *also))
    return ms * iters / launches, launches


def attention_signatures(device):
    """Phase 14: K7 against its plain version at Qwen2-1.5B's prefill
    shapes (Hq 12, Hkv 2, Dh 128; L 128, 333, 1024; batch 1 and 8; causal,
    and one non-causal case) and one SmolLM-360M shape (Hq 15, Hkv 5, Dh
    64), in f32 and bf16: error, K7 by CUDA events and profiler, the plain
    version, the library yardstick (``F.scaled_dot_product_attention``,
    used only here) and the bound."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import attention as k7

    shapes = ATTN_SHAPES
    gen = torch.Generator(device=device).manual_seed(SEED)
    rows = []
    k7.launches = k7.launches_wgmma = 0
    print(f"\nK7 vs plain ({len(shapes)} shapes x f32, bf16; limits "
          f"{KERNEL_REL_TOL} f32 of max |plain|, {BF16_REL_TOL} bf16 of "
          f"max |plain| per query row; bf16 through the wgmma route, f32 "
          f"through the SIMT one):")
    print("  dtype  b  hq hkv    l  dh causal route  max_rel    max_abs      "
          "  ms  device_ms    plain_ms  library_ms  bound_ms bound_by")
    for dtype in (torch.float32, torch.bfloat16):
        for b, hq, hkv, l, dh, causal in shapes:
            q = torch.randn((b, hq, l, dh), generator=gen,
                            device=device).to(dtype)
            k = torch.randn((b, hkv, l, dh), generator=gen,
                            device=device).to(dtype)
            v = torch.randn((b, hkv, l, dh), generator=gen,
                            device=device).to(dtype)
            path = k7.route(q, k, v)
            want = "wgmma" if dtype == torch.bfloat16 else "simt"
            check(path == want, f"K7 takes the {path} route at "
                  f"{(b, hq, hkv, l, dh)} {dtype}, expected {want}")
            before = k7.launches_wgmma
            out = k7.flash_attention(q, k, v, causal=causal)
            wgmma = k7.launches_wgmma - before
            check(wgmma == (path == "wgmma"), f"{wgmma} wgmma launches for "
                  f"one {path} call at {(b, hq, l, dh)}")
            lse_rec = {}
            if path == "wgmma":
                # the forward as training calls it: each row's log-sum-exp
                # written beside the output, whose bits must not change
                out_lse, lse = k7._launch_forward(q, k, v, causal,
                                                  dh ** -0.5, want_lse=True)
                lse_ref = k7.lse_plain(q, k, causal=causal)
                torch.cuda.synchronize()
                lse_rec = dict(
                    lse_same_bits=bool(torch.equal(out_lse, out)),
                    lse_max_abs_err=float((lse - lse_ref).abs().max()))
                lse_lim = LSE_REL_TOL * float(lse_ref.abs().max())
                check(lse_rec["lse_same_bits"], f"K7's output changes when "
                      f"it writes lse at {(b, hq, hkv, l, dh, causal)}")
                check(bool(torch.isfinite(lse).all())
                      and lse_rec["lse_max_abs_err"] <= lse_lim,
                      f"K7's lse disagrees with lse_plain at "
                      f"{(b, hq, hkv, l, dh, causal)}: max |diff| "
                      f"{lse_rec['lse_max_abs_err']:.3e} > {lse_lim:.3e} "
                      f"({LSE_REL_TOL} of max |lse|)")
                del out_lse, lse, lse_ref
            plain = k7.flash_attention_plain(q, k, v, causal=causal)
            torch.cuda.synchronize()
            check(bool(torch.isfinite(out).all()),
                  f"K7 non-finite at {(b, hq, l, dh)}")
            max_abs, max_rel = rel_err(out.float(), plain.float())
            if dtype == torch.bfloat16:
                # per query row: a late causal row's outputs are far below
                # max |plain|, which row 0 (a copy of v[0]) sets
                max_rel = row_rel_err(out.float(), plain.float())
            tol = KERNEL_REL_TOL if dtype == torch.float32 else BF16_REL_TOL
            ms = auto_ms(lambda: k7.flash_attention(q, k, v, causal=causal))
            device_ms, recorded = kernel_device_ms(
                lambda: k7.flash_attention(q, k, v, causal=causal),
                "flash_attention_kernel", k7)
            plain_ms = auto_ms(lambda: k7.flash_attention_plain(
                q, k, v, causal=causal), 30.0)
            library_ms = auto_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=causal, enable_gqa=True))
            pairs = l * (l + 1) / 2 if causal else l * l
            flops = 4.0 * b * hq * dh * pairs
            nbytes = q.element_size() * (2 * b * hq + 2 * b * hkv) * l * dh
            bound_ms, bound_by = bound_for(flops, nbytes, dtype)
            by_block = {}
            if path == "wgmma":
                # both key blocks by device time (the wrapper's rule picks
                # one by shape; this is the measurement behind it)
                pick = k7.wgmma_key_block
                try:
                    for kb in k7.KEY_BLOCKS:
                        k7.wgmma_key_block = lambda *_, kb_=kb: kb_
                        by_block[kb] = kernel_device_ms(
                            lambda: k7.flash_attention(q, k, v,
                                                       causal=causal),
                            "flash_attention_kernel", k7)[0]
                finally:
                    k7.wgmma_key_block = pick
            library_device_ms = trace_device(
                lambda i: F.scaled_dot_product_attention(
                    q, k, v, is_causal=causal, enable_gqa=True), 5, {},
                sync_each=True)["device_ms"]
            rec = dict(dtype=str(dtype).removeprefix("torch."), b=b, hq=hq,
                       hkv=hkv, l=l, dh=dh, causal=causal, route=path,
                       count=1, max_abs_err=max_abs, max_rel_err=max_rel,
                       ms=ms, device_ms=device_ms, plain_ms=plain_ms,
                       library_ms=library_ms, bound_ms=bound_ms,
                       bound_by=bound_by, flops=flops,
                       tflops=flops / ms / 1e9, traced_launches=recorded,
                       launches_wgmma=wgmma,
                       library_device_ms=library_device_ms,
                       key_block=(k7.wgmma_key_block(b, hq, l, causal)
                                  if path == "wgmma" else None),
                       device_ms_by_key_block=by_block, **lse_rec)
            rows.append(rec)
            print(f"  {rec['dtype']:8s}{b:2d}{hq:4d}{hkv:4d}{l:5d}{dh:4d} "
                  f"{causal!s:6s} {path:6s}{max_rel:.2e}  {max_abs:.2e} "
                  f"{ms:9.4f} {device_ms:10.4f} {plain_ms:11.4f} "
                  f"{library_ms:11.4f} {bound_ms:9.4f} {bound_by}  "
                  f"({rec['tflops']:.2f} TFLOP/s; launches_wgmma +{wgmma} "
                  f"for its first call; {recorded} of 5 launches "
                  f"traced; SDPA device {library_device_ms:.4f} ms"
                  + (f"; key block {rec['key_block']}, device ms by key "
                     f"block " + ", ".join(f"{kb_}: {ms_:.4f}" for kb_, ms_
                                          in by_block.items())
                     if by_block else "")
                  + (f"; the same bits with lse written: "
                     f"{lse_rec['lse_same_bits']}, lse vs lse_plain max "
                     f"|diff| {lse_rec['lse_max_abs_err']:.3e}"
                     if lse_rec else "") + ")")
            check(max_rel <= tol, f"K7 disagrees with its plain version at "
                  f"{(b, hq, hkv, l, dh, causal, rec['dtype'])}: max_rel "
                  f"{max_rel:.3e} > {tol}")
            del q, k, v, out, plain
    print(f"  K7 launches in this phase: {k7.launches} ({k7.launches_wgmma} "
          f"through wgmma)")
    print("  per-shape JSON:", json.dumps(rows))
    return rows


def bound_for(flops: float, nbytes: float, dtype) -> tuple[float, str]:
    """``bound`` at the peak of the function's dtype: bf16 tensor cores or
    f32 SIMT (``repro_torch.launch.roofline``)."""
    import torch
    from repro_torch.launch import roofline
    return roofline.bound_ms(flops, nbytes, roofline.BF16_PEAK_FLOPS
                             if dtype == torch.bfloat16
                             else roofline.F32_PEAK_FLOPS)


def matmul_tuned(a, b, kw, plain, tol, cache) -> dict:
    """Phase 15's tuning of one shape: ``tune.autotune_matmul`` (every
    candidate plan of the route timed by device time, the default kept
    unless another is 2 % faster) into ``cache``; then every candidate
    plan's output on the shape's inputs held against the plain version
    within ``tol``.  Returns the plans, their device us and the worst
    max_rel."""
    import torch
    from repro_torch import tune
    from repro_torch.kernels import matmul_fused as k6
    m, kk = a.shape
    n = b.shape[1]
    db = a.element_size()
    plan = tune.autotune_matmul(m, n, kk, dtype_bytes=db, backend="cuda",
                                cache=cache, persist=False)
    entry = cache.lookup(tune.matmul_key(m=m, n=n, k=kk, dtype_bytes=db,
                                         backend="cuda"))
    check(entry["source"] == "measured", f"K6's tuning at {(m, kk, n)} was "
          f"not timed on the card")
    cands = tune.plan_candidates("matmul", m=m, n=n, k=kk, dtype_bytes=db)
    worst = 0.0
    for pl in cands:
        out = k6.matmul_fused(a, b, plan=pl, **kw)
        torch.cuda.synchronize()
        _, rel = rel_err(out.float(), plain.float())
        check(rel <= tol, f"K6 under plan {pl} disagrees with its plain "
              f"version at {(m, kk, n)}: max_rel {rel:.3e} > {tol}")
        worst = max(worst, rel)
    return dict(plan=dataclasses.asdict(plan),
                default_plan=dataclasses.asdict(cands[0]),
                default_us=entry["default_us"], tuned_us=entry["score_us"],
                candidates=len(cands), max_rel=worst)


def matmul_signatures(device):
    """Phase 15: K6 against its plain version at Qwen2-1.5B's projections
    at M = 4096 tokens (q/o 1536->1536 + bias, k/v 1536->256 + bias, gate
    1536->8960 silu, down 8960->1536 + residual, and one gelu and one relu
    case), in f32 and bf16, and two ragged bf16 cases (MATMUL_RAGGED):
    each shape's route (``matmul_fused.route``: bf16 takes the wgmma
    kernel, f32 and a K off the multiples of 8 the SIMT one), error, K6 by
    CUDA events and profiler, the plain version, the library yardstick
    (``torch.matmul`` in the input dtype with the epilogue in torch, TF32
    off) and the bound.  The first call of each shape counts its wgmma
    launches: one per bf16 shape, 6 a pass.  Returns (records of the
    twelve shapes, K6 launches in this phase, records of the ragged
    cases)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import matmul_fused as k6
    from repro_torch.tune import TuneCache

    cache = TuneCache(os.path.join(tempfile.mkdtemp(), "matmul.json"))
    acts = {"none": lambda x: x, "relu": torch.relu, "silu": F.silu,
            "gelu": lambda x: F.gelu(x, approximate="tanh")}
    cases = [(dtype, MATMUL_M, kk, n, act, has_bias, has_res,
              "wgmma" if dtype == torch.bfloat16 else "simt")
             for dtype in (torch.float32, torch.bfloat16)
             for kk, n, act, has_bias, has_res in MATMUL_SHAPES]
    cases += [(torch.bfloat16, *case) for case in MATMUL_RAGGED]
    gen = torch.Generator(device=device).manual_seed(SEED)
    rows, ragged = [], []
    k6.launches = k6.launches_wgmma = 0
    pass_wgmma = 0
    print(f"\nK6 vs plain, M = {MATMUL_M} ({len(MATMUL_SHAPES)} shapes x f32, "
          f"bf16) and {len(MATMUL_RAGGED)} ragged bf16 cases; limits "
          f"{KERNEL_REL_TOL} f32, {BF16_REL_TOL} bf16:")
    print("  dtype       m     k     n act  bias  res   route max_rel    "
          "max_abs        ms  device_ms  plain_ms  library_ms  bound_ms "
          "bound_by")
    for dtype, m, kk, n, act, has_bias, has_res, want in cases:
        a = torch.randn((m, kk), generator=gen, device=device).to(dtype)
        b = (torch.randn((kk, n), generator=gen, device=device)
             / math.sqrt(kk)).to(dtype)
        bias = (torch.randn(n, generator=gen, device=device).to(dtype)
                if has_bias else None)
        res = (torch.randn((m, n), generator=gen, device=device).to(dtype)
               if has_res else None)
        kw = dict(bias=bias, act=act, residual=res)
        path = k6.route(a, b)
        check(path == want, f"K6 takes the {path} route at {(m, kk, n)} "
              f"{dtype}, expected {want}")
        before = k6.launches_wgmma
        out = k6.matmul_fused(a, b, **kw)
        wgmma = k6.launches_wgmma - before
        check(wgmma == (path == "wgmma"), f"{wgmma} wgmma launches for one "
              f"{path} call at {(m, kk, n)}")
        if m == MATMUL_M and dtype == torch.bfloat16:
            pass_wgmma += wgmma
        plain = k6.matmul_fused_plain(a, b, **kw)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(out).all()), f"K6 non-finite at {kk, n}")
        max_abs, max_rel = rel_err(out.float(), plain.float())
        tol = KERNEL_REL_TOL if dtype == torch.float32 else BF16_REL_TOL

        def library():
            y = torch.matmul(a, b)
            if bias is not None:
                y = y + bias
            if res is not None:
                y = y + res
            return acts[act](y)
        # 20 ms of launches, not auto_ms's 60: K6 is on no model path and
        # the run's 1200 s budget is tight
        ms = auto_ms(lambda: k6.matmul_fused(a, b, **kw), target_ms=20.0)
        device_ms, recorded = kernel_device_ms(
            lambda: k6.matmul_fused(a, b, **kw), "matmul_fused_kernel",
            k6)
        plain_ms = auto_ms(lambda: k6.matmul_fused_plain(a, b, **kw))
        library_ms = auto_ms(library)
        flops = 2.0 * m * kk * n
        nbytes = a.element_size() * (m * kk + kk * n + m * n
                                     + (n if has_bias else 0)
                                     + (m * n if has_res else 0))
        bound_ms, bound_by = bound_for(flops, nbytes, dtype)
        rec = dict(dtype=str(dtype).removeprefix("torch."), m=m,
                   k=kk, n=n, act=act, bias=has_bias, residual=has_res,
                   route=path, count=1, max_abs_err=max_abs,
                   max_rel_err=max_rel, ms=ms, device_ms=device_ms,
                   plain_ms=plain_ms, library_ms=library_ms,
                   bound_ms=bound_ms, bound_by=bound_by, flops=flops,
                   tflops=flops / ms / 1e9, traced_launches=recorded)
        (rows if m == MATMUL_M else ragged).append(rec)
        print(f"  {rec['dtype']:8s}{m:6d}{kk:6d}{n:6d} {act:5s}"
              f"{has_bias!s:6s}{has_res!s:6s}{path:6s} {max_rel:.2e}  "
              f"{max_abs:.2e} {ms:9.4f} {device_ms:10.4f} {plain_ms:9.4f} "
              f"{library_ms:11.4f} {bound_ms:9.4f} {bound_by}  "
              f"({rec['tflops']:.2f} TFLOP/s; {recorded} of 5 launches "
              f"traced)")
        check(max_rel <= tol, f"K6 disagrees with its plain version at "
              f"{(m, kk, n, act, rec['dtype'])}: max_rel {max_rel:.3e} > "
              f"{tol}")
        if m == MATMUL_M:
            rec["tuned"] = matmul_tuned(a, b, kw, plain, tol, cache)
        del a, b, bias, res, out, plain
    check(pass_wgmma == len(MATMUL_SHAPES), f"{pass_wgmma} wgmma launches in "
          f"one pass over the {len(MATMUL_SHAPES)} bf16 shapes")
    print("  K6 tuned (tune.autotune_matmul, every candidate timed by device "
          "time; each candidate plan held to the limit above):")
    for r_ in rows:
        t_ = r_["tuned"]
        print(f"    {r_['dtype']:8s}{r_['k']:6d}{r_['n']:6d} default "
              f"{t_['default_plan']} {t_['default_us']:.2f} us, tuned "
              f"{t_['plan']} {t_['tuned_us']:.2f} us; {t_['candidates']} "
              f"candidates, worst max_rel {t_['max_rel']:.2e}")
    launches = k6.launches
    bf16 = [r_ for r_ in rows if r_["dtype"] == "bfloat16"]
    wide = [r_ for r_ in bf16 if 8960 in (r_["k"], r_["n"])]
    print(f"  K6 bf16 over the {len(bf16)} shapes: "
          f"{sum(r_['ms'] for r_ in bf16):.4f} ms by events, "
          f"{sum(r_['device_ms'] for r_ in bf16):.4f} device; torch.matmul "
          f"+ epilogue {sum(r_['library_ms'] for r_ in bf16):.4f}; bound "
          f"{sum(r_['bound_ms'] for r_ in bf16):.4f}; the 1536<->8960 "
          f"shapes at {[round(r_['tflops'], 1) for r_ in wide]} TFLOP/s")
    print(f"  K6 launches in this phase: {launches} ({k6.launches_wgmma} "
          f"through wgmma; {pass_wgmma} in the first pass over the bf16 "
          f"shapes)")
    print("  per-shape JSON:", json.dumps(rows + ragged))
    return rows, launches, ragged


def lm_prompts(n: int, vocab: int, seed: int, lengths=LM_PROMPT_LEN):
    """``n`` prompts with lengths uniform in ``lengths`` (both ends
    included) and random token ids, from
    ``numpy.random.default_rng(seed)``."""
    import numpy as np
    rng = np.random.default_rng(seed)
    lengths = rng.integers(lengths[0], lengths[1] + 1, size=n)
    return [rng.integers(0, vocab, size=int(m)) for m in lengths]


def lm_serving(device, arch: str, widths: tuple, kernels: dict,
               wgmma: dict, route_counts: dict | None = None, *,
               requests: int = LM_REQUESTS, prompt_len=LM_PROMPT_LEN):
    """Phase 16 (Qwen2-1.5B), phase 19 (the Jamba cut) and phase 30
    (RWKV-6), each a slice's
    main path: ``arch`` in bf16 (random weights from ``init_lm``, seed 0;
    ``widths`` = (n_layers, d_model, n_heads, n_kv_heads, head_dim, d_ff,
    vocab, dtype) are checked) through ``serve_continuous``: an untimed
    pass of LM_WARM_REQUESTS requests, then a window of ``requests`` with
    prompts of ``prompt_len`` tokens, every prompt made before it opens.  ``kernels`` maps a kernel's name to
    (module, kernel-name needle, launches per forward, launches per decode
    step): each count is set to 0 just before the window and read just
    after, and must be its launches per forward and per decode step times
    the ``forward`` and ``decode_step`` calls the scheduler counted in the
    window (one forward per request).  ``wgmma`` maps a kernel's name to
    its wgmma-route launches per forward and per decode step, held the same
    way on ``launches_wgmma``; for K9 every call with bm >= 64 is counted
    in the window and must have taken that route.  ``route_counts`` maps a
    kernel's name to (its route's counter, the kernel-name suffix of that
    route, launches per forward, launches per decode step), held the same
    way (K8's tile route).  Then a batch-8 prefill
    at 512 tokens
    and 16 decode steps through ``forward`` / ``decode_step``, and both
    under ``torch.profiler`` (``trace_device``, each kernel's recorded
    launches held to its counter).  For a model with MoE layers, the decode
    steps count the held experts that receive rows per layer and step, and
    one prefill and one decode step run with ``moe.apply`` under
    ``torch.cuda.set_sync_debug_mode("error")``, so a host synchronisation
    in the layer fails the run.  Returns (launches in the window by kernel
    name, summary, params, cfg)."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import moe_gmm as k9
    from repro_torch.launch.serve import serve_continuous
    from repro_torch.nn import moe
    from repro_torch.nn import transformer as T

    cfg = get_config(arch)
    check((cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
           cfg.head_dim, cfg.d_ff, cfg.vocab, cfg.dtype) == widths,
          f"{arch} does not have the widths {widths}: {cfg}")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = T.init_lm(cfg, torch.Generator(device=device).manual_seed(SEED),
                       device=device)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    param_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    print(f"\nLM serving: {arch}, {n_params / 1e9:.3f} B params in "
          f"{cfg.dtype} ({param_bytes / 1e9:.2f} GB), random from seed "
          f"{SEED} in {time.perf_counter() - t0:.1f}s; lanes {LM_LANES}, "
          f"max_len {LM_MAX_LEN}, max_new {LM_MAX_NEW}, prompts of "
          f"{prompt_len[0]}-{prompt_len[1]} tokens")
    window = lm_prompts(requests, cfg.vocab, SEED, prompt_len)
    warm = lm_prompts(LM_WARM_REQUESTS, cfg.vocab, SEED + 1, prompt_len)
    kw = dict(lanes=LM_LANES, max_len=LM_MAX_LEN, max_new=LM_MAX_NEW, eos=-1)
    t0 = time.perf_counter()
    serve_continuous(params, cfg, warm, **kw)
    torch.cuda.synchronize()
    print(f"  untimed pass: {LM_WARM_REQUESTS} requests in "
          f"{time.perf_counter() - t0:.2f}s")
    calls = {}
    for mod, _, _, _ in kernels.values():
        mod.launches = 0
    for name in wgmma:
        kernels[name][0].launches_wgmma = 0
    route_counts = route_counts or {}
    for name, (attr, _, _, _) in route_counts.items():
        setattr(kernels[name][0], attr, 0)
    k9_calls = []      # (bm, route) of every K9 call in the window
    k9.launches_stream = 0
    gmm = k9.moe_gmm

    def recording_gmm(tokens, weights, tile_eid, *, bm):
        k9_calls.append((bm, k9.route(tokens, weights, bm)))
        return gmm(tokens, weights, tile_eid, bm=bm)
    k9.moe_gmm = recording_gmm
    torch.cuda.synchronize()
    try:
        t0 = time.perf_counter()
        results = serve_continuous(params, cfg, window, calls=calls, **kw)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    finally:
        k9.moe_gmm = gmm
    launches = {name: mod.launches
                for name, (mod, _, _, _) in kernels.items()}
    launches_wgmma = {name: kernels[name][0].launches_wgmma
                      for name in wgmma}
    launches_route = {name: getattr(kernels[name][0], attr)
                      for name, (attr, _, _, _) in route_counts.items()}
    launches_stream = k9.launches_stream
    tokens = sum(len(r) for r in results.values())
    prompt_tokens = int(sum(len(p) for p in window))
    print(f"  window: {requests} requests ({prompt_tokens} prompt "
          f"tokens), {tokens} generated in {wall_s:.3f}s: "
          f"{tokens / wall_s:.2f} generated tokens/s, "
          f"{(tokens + prompt_tokens) / wall_s:.2f} tokens/s with the "
          f"prompts")
    check(len(results) == requests and all(
        len(r) == LM_MAX_NEW for r in results.values()),
        f"served {len(results)} requests, not {requests} x {LM_MAX_NEW} "
        f"tokens")
    print(f"  the scheduler's calls in the window: {calls['forward']} "
          f"forward, {calls['decode_step']} decode_step")
    check(calls["forward"] == requests,
          f"{calls['forward']} prefills for {requests} requests")
    for name, (_, _, per_fwd, per_dec) in kernels.items():
        expected = per_fwd * calls["forward"] + per_dec * calls["decode_step"]
        print(f"  {name} launches in the window: {launches[name]} (expected "
              f"{per_fwd} x {calls['forward']} + {per_dec} x "
              f"{calls['decode_step']} = {expected})")
        check(launches[name] == expected,
              f"{name} launched {launches[name]} times in the window, "
              f"expected {expected}")
    for name, (per_fwd, per_dec) in wgmma.items():
        expected = per_fwd * calls["forward"] + per_dec * calls["decode_step"]
        print(f"  {name} launches through the wgmma route in the window: "
              f"{launches_wgmma[name]} of {launches[name]} (expected "
              f"{per_fwd} x {calls['forward']} + {per_dec} x "
              f"{calls['decode_step']} = {expected})")
        check(launches_wgmma[name] == expected,
              f"{name} took the wgmma route {launches_wgmma[name]} times in "
              f"the window, expected {expected}")
    for name, (attr, _, per_fwd, per_dec) in route_counts.items():
        expected = per_fwd * calls["forward"] + per_dec * calls["decode_step"]
        print(f"  {name} launches counted by {attr} in the window: "
              f"{launches_route[name]} of {launches[name]} (expected "
              f"{per_fwd} x {calls['forward']} + {per_dec} x "
              f"{calls['decode_step']} = {expected})")
        check(launches_route[name] == expected,
              f"{name}'s {attr} counted {launches_route[name]} in the "
              f"window, expected {expected}")
    if k9_calls:
        bms = [bm for bm, _ in k9_calls]
        big = sum(bm >= 64 for bm in bms)
        small = len(bms) - big
        print(f"  moe_gmm calls in the window by bm: "
              + ", ".join(f"{bm}: {bms.count(bm)}" for bm in sorted(set(bms)))
              + f"; {big} with bm >= 64, {k9.launches_wgmma} wgmma launches")
        check(big == k9.launches_wgmma == launches_wgmma.get("moe_gmm", -1),
              f"{big} K9 calls with bm >= 64 but {k9.launches_wgmma} wgmma "
              f"launches in the window")
        by_route = {r_: sum(route_ == r_ for _, route_ in k9_calls)
                    for r_ in ("stream", "wgmma", "mma")}
        decode_routes = {route_ for bm, route_ in k9_calls if bm < 64}
        print(f"  moe_gmm calls in the window by route: {by_route}; the "
              f"{small} decode calls (bm < 64) on {sorted(decode_routes)}, "
              f"{k9.launches_stream} stream launches")
        check(small == k9.launches_stream == by_route["stream"]
              and decode_routes <= {"stream"},
              f"{small} K9 decode calls, {by_route['stream']} routed to the "
              f"stream kernel and {k9.launches_stream} stream launches in "
              f"the window: every bf16 decode call must take it")

    b, l = LM_PREFILL
    toks = torch.from_numpy(np.random.default_rng(SEED + 2).integers(
        0, cfg.vocab, (b, l))).to(device)

    def prefill():
        return T.forward(params, cfg, tokens=toks, return_cache=True,
                         cache_len=LM_MAX_LEN)
    logits, _, cache = prefill()
    torch.cuda.synchronize()
    check(bool(torch.isfinite(logits[:, -1].float()).all()),
          "non-finite prefill logits")
    host, events = [], []
    for _ in range(3):
        del logits, cache
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        logits, _, cache = prefill()
        end.record()
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t0) * 1e3)
        events.append(start.elapsed_time(end))
    prefill_ms = float(np.median(host))
    print(f"  prefill, batch {b} x {l} tokens: {prefill_ms:.3f} ms by host "
          f"clock, {float(np.median(events)):.3f} by CUDA events (median of "
          f"3); {b * l / prefill_ms * 1e3:.0f} tokens/s")
    last = logits[:, -1:].argmax(dim=-1)
    step_ms = []
    before = {name: mod.launches for name, (mod, _, _, _) in kernels.items()}
    routes = []
    route = moe.route

    def recording_route(probs, k):
        out = route(probs, k)
        routes.append(out[1])
        return out
    moe.route = recording_route
    try:
        for t in range(LM_DECODE_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out, cache = T.decode_step(params, cfg, last, cache,
                                       torch.full((b,), l + t, device=device))
            last = out.argmax(dim=-1)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
    finally:
        moe.route = route
    for name, (mod, _, _, per_dec) in kernels.items():
        check(mod.launches - before[name] == per_dec * LM_DECODE_STEPS,
              f"decode launched {name} {mod.launches - before[name]} times, "
              f"expected {per_dec} x {LM_DECODE_STEPS}")
    check(bool(torch.isfinite(out.float()).all()), "non-finite decode logits")
    p50, p99 = (float(np.percentile(step_ms, q)) for q in (50, 99))
    print(f"  decode, batch {b} at {l}+ tokens: p50 {p50:.3f} ms, p99 "
          f"{p99:.3f} ms per step over {LM_DECODE_STEPS} steps "
          f"({b / p50 * 1e3:.1f} tokens/s); launches per step: "
          + ", ".join(f"{name} {per_dec}" for name, (_, _, _, per_dec)
                      in kernels.items()))
    experts_read = None
    if cfg.moe is not None:
        e0, e1 = cfg.moe.held_experts()
        with_rows = [int(torch.unique(gi[(gi >= e0) & (gi < e1)]).numel())
                     for gi in routes]
        experts_read = dict(mean=float(np.mean(with_rows)),
                            min=min(with_rows), max=max(with_rows),
                            held=e1 - e0, layer_steps=len(with_rows))
        print(f"  held experts with rows per MoE layer per decode step: mean "
              f"{experts_read['mean']:.3f} (min {experts_read['min']}, max "
              f"{experts_read['max']}) of {e1 - e0}, over {len(with_rows)} "
              f"layer-steps")
        strict_moe_step(params, cfg, prefill, b, l, device)

    counters = {needle: mod for mod, needle, _, _ in kernels.values()}

    def show(name, trace, iters):
        device_ms = trace["device_ms"]
        busy = trace["busy_share"]
        n_launch = sum(trace["launches"].values()) / iters
        shares = {kname: device_ms_of(trace, needle)
                  for kname, (_, needle, _, _) in kernels.items()}
        shares.update(trace["ranges"])
        print(f"  profile of {name}: {trace['wall_ms']:.3f} ms by host clock,"
              f" device {device_ms:.3f} ms in {n_launch:.0f} kernel "
              f"launches, busy {'n/a' if busy is None else f'{busy:.4f}'}; "
              + ", ".join(f"{kname} {ms:.3f} ms "
                          f"({ms / max(device_ms, 1e-9):.4f} of device time)"
                          for kname, ms in shares.items()))
        for ms, n, kname in trace["by_name"][:8]:
            print(f"    {ms:9.3f} ms  x{n:6.1f}  {kname[:100]}")
        return dict(wall_ms=trace["wall_ms"], device_ms=device_ms,
                    launches=n_launch, busy_share=busy, kernel_ms=shares,
                    top=[dict(ms=ms, launches=n, name=kname[:120])
                         for ms, n, kname in trace["by_name"][:8]])
    del logits, cache
    pre_trace = trace_device(lambda i: prefill(), 1, counters)
    for name, (per_fwd, _) in wgmma.items():
        needle = kernels[name][1]
        traced = {kname: n for kname, n in pre_trace["launches"].items()
                  if needle in kname}
        on_wgmma = sum(n for kname, n in traced.items() if "_wgmma" in kname)
        print(f"  {name} launches in the traced prefill: "
              f"{sum(traced.values())}, {on_wgmma} through the wgmma route "
              f"(by kernel name; expected {per_fwd})")
        check(on_wgmma == per_fwd, f"{on_wgmma} {name} wgmma launches in the "
              f"traced prefill, expected {per_fwd}")
    for name, (_, suffix, per_fwd, _) in route_counts.items():
        needle = kernels[name][1]
        on_route = sum(n for kname, n in pre_trace["launches"].items()
                       if needle + suffix in kname)
        print(f"  {name} launches in the traced prefill through "
              f"{needle + suffix}: {on_route} (by kernel name; expected "
              f"{per_fwd})")
        check(on_route == per_fwd, f"{on_route} {name} launches of "
              f"{needle + suffix} in the traced prefill, expected {per_fwd}")
    logits, _, cache = prefill()
    last = logits[:, -1:].argmax(dim=-1)
    del logits
    traced_routes = []   # the routing of every MoE layer the trace ran
    steps = [0]          # decode_step calls the trace made, warm-up included

    def tracing_route(probs, k):
        out = route(probs, k)
        traced_routes.append(out)
        return out
    if cfg.moe is not None:
        moe.route = tracing_route

    def decode(i):
        steps[0] += 1
        return T.decode_step(params, cfg, last, cache,
                             torch.full((b,), l + i, device=device))
    try:
        dec_trace = trace_device(decode, 8, counters)
    finally:
        moe.route = route
    k9_decode = None
    if cfg.moe is not None:
        # K9's bytes bound of a decode step: for each MoE layer the trace
        # ran, the weights of the held experts with rows (one tile each at
        # decode), gate and up (D x F) and down (F x D), once each, over
        # 3.35 TB/s; per decode_step call
        from repro_torch.launch import roofline
        e0, e1 = cfg.moe.held_experts()
        used = [int(torch.unique(gi[(gi >= e0) & (gi < e1)]).numel())
                for _, gi in traced_routes]
        layers = len(used) / steps[0]
        step_bytes = sum(3 * u * cfg.d_model * cfg.d_ff * 2
                         for u in used) / steps[0]
        bound_ms = step_bytes / roofline.HBM_BYTES_PER_S * 1e3
        ms = device_ms_of(dec_trace, "moe_gmm_kernel") \
            + device_ms_of(dec_trace, "moe_stream_sum")
        stream_n = sum(n for kname, n in dec_trace["launches"].items()
                       if "moe_gmm_kernel_stream" in kname) / 8
        k9_decode = dict(device_ms=ms, bound_ms=bound_ms,
                         bound_share=bound_ms / ms if ms else None,
                         experts_with_rows=float(np.mean(used)),
                         moe_layers=layers, stream_launches_per_step=stream_n)
        print(f"  K9 per decode step (device, sum pass included): {ms:.3f} ms "
              f"against its bytes bound {bound_ms:.3f} ms "
              f"({k9_decode['experts_with_rows']:.3f} held experts with rows "
              f"in each of {layers:.0f} MoE layers, 3 weights each): "
              f"{bound_ms / max(ms, 1e-9):.3f} of it; "
              f"{stream_n:.1f} stream launches a step (by kernel name)")
    peak = torch.cuda.max_memory_allocated()
    print(f"  parameters {param_bytes / 1e9:.3f} GB; "
          f"torch.cuda.max_memory_allocated {peak / 1e9:.3f} GB")
    summary = dict(
        arch=arch, params=n_params, param_bytes=param_bytes,
        max_memory_allocated=peak,
        window=dict(requests=requests, prompt_tokens=prompt_tokens,
                    generated_tokens=tokens, wall_s=wall_s,
                    generated_tokens_per_s=tokens / wall_s,
                    launches=launches, launches_wgmma=launches_wgmma,
                    launches_route=launches_route,
                    launches_stream=launches_stream),
        prefill=dict(batch=b, tokens=l, host_ms=prefill_ms,
                     event_ms=float(np.median(events)),
                     profile=show(f"one batch-{b} prefill", pre_trace, 1)),
        decode=dict(batch=b, p50_ms=p50, p99_ms=p99, step_ms=step_ms,
                    held_experts_with_rows=experts_read, k9=k9_decode,
                    profile=show("8 decode steps (per step)", dec_trace, 8)))
    del cache
    return launches, summary, params, cfg


def strict_moe_step(params, cfg, prefill, b: int, l: int, device) -> None:
    """One prefill and one decode step with every ``moe.apply`` under
    ``torch.cuda.set_sync_debug_mode("error")``: a host synchronisation in
    the MoE layer raises and fails the run."""
    import torch
    from repro_torch.nn import moe
    from repro_torch.nn import transformer as T

    apply = moe.apply

    def strict_apply(*args, **kwargs):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return apply(*args, **kwargs)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    moe.apply = strict_apply
    try:
        logits, _, cache = prefill()
        last = logits[:, -1:].argmax(dim=-1)
        del logits
        T.decode_step(params, cfg, last, cache,
                      torch.full((b,), l, device=device))
        torch.cuda.synchronize()
    except RuntimeError as err:
        check(False, f"the MoE layer synchronised with the host: {err}")
    finally:
        moe.apply = apply
    print("  one prefill and one decode step with moe.apply under "
          "set_sync_debug_mode('error'): no host synchronisation")


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def lm_parity(params, cfg, prompts) -> dict:
    """Phase 17 (Qwen2-1.5B) and phase 21 (the Jamba cut): ``cfg`` (f32),
    the same params on the card (``params``, drawn there) and on the CPU
    (copied to the host; the plain versions).  For each (batch, length) of
    ``prompts``: prefill logits within LOGIT_REL_TOL * max |logit| and the
    same argmax at the last position, then LM_PARITY_STEPS teacher-forced
    decode steps (both sides fed the CPU's greedy tokens) within the same
    limit.  Frees the CPU copy; the caller frees ``params``."""
    import numpy as np
    import torch
    from repro_torch.convert import params_to
    from repro_torch.nn import transformer as T

    device = params["embed"].device
    t0 = time.perf_counter()
    cpu = params_to(params, "cpu")
    n_bytes = sum(t.numel() * t.element_size() for t in _leaves(cpu))
    print(f"\nLM parity: {cfg.name} in f32 ({n_bytes / 1e9:.2f} GB on each "
          f"side, copied in {time.perf_counter() - t0:.1f}s), card vs CPU")
    out = []
    for i, (b, l) in enumerate(prompts):
        toks = torch.from_numpy(np.random.default_rng(SEED + 3 + i).integers(
            0, cfg.vocab, (b, l)))
        cache_len = l + LM_PARITY_STEPS + 1
        t0 = time.perf_counter()
        lg, _, cache_g = T.forward(params, cfg, tokens=toks.to(device),
                                   return_cache=True, cache_len=cache_len)
        lc, _, cache_c = T.forward(cpu, cfg, tokens=toks, return_cache=True,
                                   cache_len=cache_len)
        rels = [rel_err(lg.cpu(), lc)[1]]
        same_last = bool((lg[:, -1].argmax(-1).cpu() == lc[:, -1].argmax(-1))
                         .all())
        print(f"  {b} prompt(s) of {l} tokens: prefill max |diff| / max "
              f"|logit| {rels[0]:.3e}, same last argmax {same_last}")
        agree = []
        last = lc[:, -1:].argmax(dim=-1)
        for t in range(LM_PARITY_STEPS):
            og, cache_g = T.decode_step(params, cfg, last.to(device),
                                        cache_g, l + t)
            oc, cache_c = T.decode_step(cpu, cfg, last, cache_c, l + t)
            rels.append(rel_err(og.cpu(), oc)[1])
            agree.append(bool((og.argmax(-1).cpu() == oc.argmax(-1)).all()))
            last = oc.argmax(dim=-1)
        print(f"  {LM_PARITY_STEPS} teacher-forced decode steps: max |diff| "
              f"/ max |logit| {[f'{r:.3e}' for r in rels[1:]]}, argmax "
              f"agrees {agree} ({time.perf_counter() - t0:.1f}s)")
        check(all(r <= LOGIT_REL_TOL for r in rels),
              f"card vs CPU LM logits apart by {max(rels):.3e} > "
              f"{LOGIT_REL_TOL} of max |logit|")
        check(same_last, "card and CPU disagree on the last prefill argmax")
        out.append(dict(batch=b, tokens=l, prefill_rel=rels[0],
                        decode_rel=rels[1:], same_last_argmax=same_last,
                        decode_argmax_agree=agree))
        del cache_g, cache_c
    del cpu
    return dict(bytes_per_side=n_bytes, prompts=out)


def init_on_card(cfg):
    """``init_lm`` of ``cfg`` on the card from seed SEED."""
    import torch
    from repro_torch.nn import transformer as T
    device = torch.device("cuda")
    return T.init_lm(cfg, torch.Generator(device=device).manual_seed(SEED),
                     device=device)


# ---------------------------------------------------------------------------
# Phases 18-21: hybrid Mamba + MoE serving (the Jamba cut, K8 and K9)
# ---------------------------------------------------------------------------

HYBRID_ARCH = "jamba-1.5-large-398b-1chip"
HYBRID_WIDTHS = (8, 8192, 64, 8, 128, 24576, 65536, "bfloat16")
HYBRID_PARITY_PROMPTS = [(1, 64), (1, 100)]   # whole chunks; a ragged one
HYBRID_PARITY_SHARE = (0, 8)                  # 2 of 16 experts: 45.7 GB f32
HYBRID_PARITY_SHARE_SMALL = (0, 16)           # 1 expert, if the host is short
HYBRID_DECODE = (2, 96, 8)                    # batch, prefill, decode steps
DECODE_REL_TOL = 1e-3              # f32 decode vs forward (~9e-5 on an H100)
BF16_DECODE_REL_TOL = 2e-2         # bf16 decode vs forward: printed only
# K8: b, l, d, kw, and whether x is read in place as the mixer passes it
# (the first half of the input projection's (B, L, 2 d) rows); the cut's
# Mamba prefills at d_inner 16384, L = 1; a tail
CONV1D_SHAPES = [(1, 1, 16384, 4, False), (1, 333, 16384, 4, False),
                 (1, 1024, 16384, 4, False), (8, 512, 16384, 4, False),
                 (1, 1024, 16384, 4, True), (8, 512, 16384, 4, True),
                 (2, 77, 1003, 4, False)]


def conv1d_signatures(device):
    """Phase 18: K8 against its plain version at the Mamba mixer's shapes
    (d_inner 16384: L 1, 333, 1024 at batch 1 and 512 at batch 8; the last
    two also on x read in place as the mixer passes it, the first half of
    a (B, L, 32768) input projection, rows 32768 apart) and one tail case
    (D and L not multiples of 8 or of a block), f32 and bf16:
    max |diff| / max |plain| <= 1e-5 (f32), <= 1e-2 (bf16); K8 by CUDA
    events and by profiler device time, the plain version, the library
    yardstick (cuDNN's depthwise ``F.conv1d`` with padding KW - 1, sliced
    to L, bias and SiLU in torch; used only here) and the bound, the larger
    of bytes (x read and y written once, w and bias) over 3.35 TB/s and
    2 KW multiply-adds per output over the dtype's peak."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import conv1d_causal as k8

    gen = torch.Generator(device=device).manual_seed(SEED + 18)
    rows = []
    print(f"\nK8 vs plain ({len(CONV1D_SHAPES)} shapes x f32, bf16, SiLU "
          f"and bias; limits {KERNEL_REL_TOL} f32, {BF16_REL_TOL} bf16 of "
          f"max |plain|); route: conv1d_causal.route, with tile_plan's "
          f"threads and run; ev = CUDA events, dev = profiler device time, "
          f"on the route taken and on the thread route forced; none: the "
          f"device time with act='none' on each route (bf16, the "
          f"arithmetic's share of the gap):")
    print("  dtype  b     l     d kw x        route thr run   max_rel "
          "thr_rel       ev      dev  ev_thr  dev_thr none_dev none_thr "
          "   plain_ms  library_ms  bound_ms bound_by   GB/s")
    for dtype in (torch.float32, torch.bfloat16):
        for b, l, d, kw, in_place in CONV1D_SHAPES:
            x = torch.randn((b, l, 2 * d if in_place else d), generator=gen,
                            device=device).to(dtype)
            if in_place:
                x = x.chunk(2, dim=-1)[0]
            w = (torch.randn((kw, d), generator=gen, device=device)
                 * kw ** -0.5).to(dtype)
            bias = torch.randn((d,), generator=gen, device=device).to(dtype)
            path = k8.route(x, w, bias)
            plan = k8.tile_plan(b, l, d, kw, 16 // x.element_size())
            out = k8.conv1d_causal(x, w, bias=bias)
            with returning(k8, "route", "thread"):
                thread = k8.conv1d_causal(x, w, bias=bias)
            plain = k8.conv1d_causal_plain(x, w, bias=bias)
            torch.cuda.synchronize()
            check(bool(torch.isfinite(out).all()),
                  f"K8 non-finite at {(b, l, d, kw)}")
            max_abs, max_rel = rel_err(out.float(), plain.float())
            thread_rel = rel_err(thread.float(), plain.float())[1]
            tol = KERNEL_REL_TOL if dtype == torch.float32 else BF16_REL_TOL
            w_lib = w.t().unsqueeze(1).contiguous()            # (D,1,KW)

            def library():
                y = F.conv1d(x.transpose(1, 2), w_lib, bias, padding=kw - 1,
                             groups=d)[..., :l]
                return F.silu(y).transpose(1, 2)
            lib_rel = rel_err(library().float(), plain.float())[1]
            ms = auto_ms(lambda: k8.conv1d_causal(x, w, bias=bias))
            device_ms, recorded = kernel_device_ms(
                lambda: k8.conv1d_causal(x, w, bias=bias),
                "conv1d_causal_kernel", k8)
            with returning(k8, "route", "thread"):
                ms_thread = auto_ms(lambda: k8.conv1d_causal(x, w,
                                                             bias=bias))
                device_thread, _ = kernel_device_ms(
                    lambda: k8.conv1d_causal(x, w, bias=bias),
                    "conv1d_causal_kernel", k8)
            none_ms = none_thread = None
            if dtype == torch.bfloat16:
                none_ms, _ = kernel_device_ms(
                    lambda: k8.conv1d_causal(x, w, bias=bias, act="none"),
                    "conv1d_causal_kernel", k8)
                with returning(k8, "route", "thread"):
                    none_thread, _ = kernel_device_ms(
                        lambda: k8.conv1d_causal(x, w, bias=bias,
                                                 act="none"),
                        "conv1d_causal_kernel", k8)
            plain_ms = auto_ms(lambda: k8.conv1d_causal_plain(
                x, w, bias=bias), 30.0)
            library_ms = auto_ms(library)
            flops = 2.0 * kw * b * l * d
            nbytes = x.element_size() * (2 * b * l * d + (kw + 1) * d)
            bound_ms, bound_by = bound_for(flops, nbytes, dtype)
            rec = dict(dtype=str(dtype).removeprefix("torch."), b=b, l=l, d=d,
                       kw=kw, x="in place" if in_place else "contiguous",
                       count=1, route=path, threads=plan.threads,
                       run=plan.run, max_abs_err=max_abs,
                       max_rel_err=max_rel, thread_rel_err=thread_rel,
                       ms=ms, device_ms=device_ms, ms_thread=ms_thread,
                       device_ms_thread=device_thread,
                       none_device_ms=none_ms,
                       none_device_ms_thread=none_thread,
                       plain_ms=plain_ms, library_ms=library_ms,
                       library_rel_err=lib_rel, bound_ms=bound_ms,
                       bound_by=bound_by, gb_per_s=nbytes / ms / 1e6,
                       traced_launches=recorded)
            rows.append(rec)

            def col(v):
                return "       —" if v is None else f"{v:8.4f}"
            print(f"  {rec['dtype']:8s}{b:2d}{l:6d}{d:6d}{kw:3d} "
                  f"{rec['x']:10s} {path:6s}{plan.threads:4d}{plan.run:4d}"
                  f"  {max_rel:.1e} {thread_rel:.1e} {ms:8.4f} "
                  f"{device_ms:8.4f} {ms_thread:8.4f} {device_thread:8.4f}"
                  f" {col(none_ms)} {col(none_thread)} {plain_ms:11.4f} "
                  f"{library_ms:11.4f} {bound_ms:9.4f} "
                  f"{bound_by:9s}{rec['gb_per_s']:7.0f}  (library vs plain "
                  f"{lib_rel:.1e}; {recorded} of 5 launches traced)")
            check(max_rel <= tol and thread_rel <= tol,
                  f"K8 disagrees with its plain version at "
                  f"{(b, l, d, kw, rec['dtype'])}: max_rel {max_rel:.3e} "
                  f"({path} route), {thread_rel:.3e} (thread route) > "
                  f"{tol}")
            check(path == ("tile" if d % 8 == 0 else "thread"),
                  f"K8 takes the {path} route at {(b, l, d, kw)}")
            del x, w, bias, out, thread, plain
    print("  per-shape JSON:", json.dumps(rows))
    return rows


# K9: the cut's MoE layer has D 8192, F 24576 and holds 8 of 16 experts,
# top-2; decode routes batch 8 (16 entries), prefill batch 8 x 512
MOE_D, MOE_F, MOE_E, MOE_HELD, MOE_K = 8192, 24576, 16, 8, 2
MOE_PREFILL = (8, 512)
MOE_PREFILL_SHORT = (1, 256)     # one lane's prompt: tiles of 64
MOE_BENCH = (512, 128, 256, 8, 128, 64)   # moe_streams_bench: T D F E cap bm
MOE_TAIL = (77, 1003, 517, 3, 16, [0, 2, -1, 1, 0])   # T D F E bm tile_eid
MOE_ONE_EXPERT_RATIO = 0.5    # one expert's 16 rows vs 16 over 8, at most
# the profiler loses most kernel records of launches this long (K9's f32
# prefill, 60+ ms each: 10 traces of 5 refused in a row on an H100), so
# their device time is left to the CUDA events
TRACE_MAX_MS = 20.0


def moe_cases(device, gen):
    """Phase 18b's inputs, each (name, tokens f32, weights-shape, tile_eid,
    bm, rows with a token, capacity C of the library's (E, C, D) bmm)."""
    import torch
    from repro_torch.kernels import moe_gmm as k9
    from repro_torch.nn import moe

    def plan(gate_idx, keep, cap):
        bm, tile_eid, _, source = moe.replay_plan(gate_idx, keep, 0,
                                                  MOE_HELD, cap)
        return bm, tile_eid, source

    cases = []
    # (a) decode: 16 entries of batch 8, spread 2 a held expert or all on
    # one, through the layer's own layout (capacity 1 per one-token group)
    b = MOE_PREFILL[0]
    spread = torch.stack([torch.arange(b), (torch.arange(b) + 1) % b],
                         dim=-1).reshape(b, 1, MOE_K).to(device)
    for name, gate_idx in (("decode", spread),
                           ("decode, one expert", torch.zeros_like(spread))):
        bm, tile_eid, source = plan(gate_idx, torch.ones_like(
            gate_idx, dtype=torch.bool), 1)
        x = torch.randn((b, MOE_D), generator=gen, device=device)
        x_rows = torch.where((source > 0)[:, None],
                             x[(source - 1).clamp_min(0)], 0)
        cases.append((name, x_rows, tile_eid, bm, b * MOE_K, b))
    # (b) prefill: batch 8 x 512 through a random router, the layer's
    # groups, capacity, drops and layout
    b, l = MOE_PREFILL
    x = torch.randn((b * l, MOE_D), generator=gen, device=device)
    router = torch.randn((MOE_D, MOE_E), generator=gen, device=device) \
        * MOE_D ** -0.5
    gate_vals, gate_idx = moe.route(torch.softmax(x @ router, dim=-1)
                                    .reshape(b, l, MOE_E), MOE_K)
    cap = max(int(1.25 * l * MOE_K / MOE_E), 1)
    bm, tile_eid, source = plan(gate_idx, moe.kept(gate_idx, MOE_E, cap),
                                cap)
    x_rows = torch.where((source > 0)[:, None],
                         x[(source - 1).clamp_min(0)], 0)
    cases.append(("prefill", x_rows, tile_eid, bm, int((source > 0).sum()),
                  b * cap))
    # (b') one 256-token prompt, as the scheduler prefills a lane: the
    # layer's plan gives tiles of 64
    b, l = MOE_PREFILL_SHORT
    xs = x[:b * l]
    gate_vals, gate_idx = moe.route(torch.softmax(xs @ router, dim=-1)
                                    .reshape(b, l, MOE_E), MOE_K)
    cap = max(int(1.25 * l * MOE_K / MOE_E), 1)
    bm, tile_eid, source = plan(gate_idx, moe.kept(gate_idx, MOE_E, cap),
                                cap)
    x_rows = torch.where((source > 0)[:, None],
                         xs[(source - 1).clamp_min(0)], 0)
    cases.append(("prefill, 1 x 256", x_rows, tile_eid, bm,
                  int((source > 0).sum()), b * cap))
    del x, xs, router, gate_vals, gate_idx
    # (c) benchmarks/moe_streams_bench.py through route_dryrun
    t, d, f, e, cap, bm = MOE_BENCH
    tok = torch.randn((t, d), generator=gen, device=device)
    eid = torch.randint(0, e, (t,), generator=gen, device=device)
    gi, tile_eid, keep = k9.route_dryrun(eid, e, cap, bm)
    cases.append(("bench", tok[gi.long()] * keep[:, None], tile_eid, bm,
                  int(keep.sum()), cap, (tok, eid)))
    # (d) tails of T, D, F and an empty tile
    t, d, f, e, bm, ids = MOE_TAIL
    cases.append(("tail", torch.randn((t, d), generator=gen, device=device),
                  torch.tensor(ids, dtype=torch.int32, device=device), bm,
                  t - bm, 2 * bm))
    return cases


def moe_signatures(device):
    """Phase 18b: K9 against its plain version at (a) the cut's decode (16
    routed rows over the 8 held experts) and (b) a batch-8 x 512 prefill's
    rows from the layer's router on random activations, each at the
    gate/up shape D 8192 -> F 24576 and the down shape 24576 -> 8192, in
    f32 and bf16; (c) benchmarks/moe_streams_bench.py's shapes through
    ``route_dryrun`` (f32); (d) T, D, F that are multiples of no block with
    a -1 tile (f32 and bf16).  Limits: max |diff| / max |plain| <= 1e-5
    (f32), <= 1e-2 (bf16).  K9 by CUDA events and profiler device time,
    the plain version (profiler time only below TRACE_MAX_MS a launch),
    the library yardstick (one ``torch.bmm`` over the
    capacity-padded (E, C, D) x (E, D, F), the port's replay until K9; used
    only here), for (c) the bench's dense every-expert einsum, and the
    bound: the larger of 2 x rows x D x F over the dtype's peak and the
    bytes of the rows, the weights of the experts that have rows and the
    output, over 3.35 TB/s, with the share of it K9 reaches by events.
    Each case runs twice on the same inputs (the same bits) and its route
    (``moe_gmm.route``) is held: bf16 decode on the stream kernel (its
    device time holds its sum pass), bf16 prefill on the wgmma one, f32 and
    the ragged tail on the mma one.  Holds the bf16 decode with one
    expert's rows under MOE_ONE_EXPERT_RATIO of the spread case's time:
    empty experts' weights are not read."""
    import torch
    from repro_torch.kernels import moe_gmm as k9

    gen = torch.Generator(device=device).manual_seed(SEED + 19)
    cases = moe_cases(device, gen)
    rows = []
    print(f"\nK9 vs plain (decode and prefill of the cut's MoE layer at "
          f"D {MOE_D}, F {MOE_F}, {MOE_HELD} of {MOE_E} experts held; the "
          f"moe_streams bench; a tail; limits {KERNEL_REL_TOL} f32, "
          f"{BF16_REL_TOL} bf16 of max |plain|):")
    print("  case                dtype    route  shape (T x D -> F)  bm used"
          "  max_rel        ms  device_ms    plain_ms  library_ms  bound_ms "
          "bound_by")
    one_vs_spread = {}
    for case in cases:
        name, tokens, tile_eid, bm, n_rows, cap = case[:6]
        ids = tile_eid.tolist()
        used = sorted({i for i in ids if i >= 0})
        if name in ("bench",):
            shapes, dtypes = [(MOE_BENCH[1], MOE_BENCH[2], MOE_BENCH[3])], \
                (torch.float32,)
        elif name == "tail":
            shapes, dtypes = [MOE_TAIL[1:4]], (torch.float32, torch.bfloat16)
        elif name == "decode, one expert":
            shapes, dtypes = [(MOE_D, MOE_F, MOE_HELD)], (torch.bfloat16,)
        elif name == "prefill, 1 x 256":
            shapes = [(MOE_D, MOE_F, MOE_HELD), (MOE_F, MOE_D, MOE_HELD)]
            dtypes = (torch.bfloat16,)
        else:
            shapes = [(MOE_D, MOE_F, MOE_HELD), (MOE_F, MOE_D, MOE_HELD)]
            dtypes = (torch.float32, torch.bfloat16)
        for d, f, e in shapes:
            for dtype in dtypes:
                x = tokens if tokens.shape[1] == d else torch.randn(
                    (tokens.shape[0], d), generator=gen, device=device) \
                    * (tokens.abs().sum(1, keepdim=True) > 0)
                x = x.to(dtype)
                w = (torch.randn((e, d, f), generator=gen, device=device)
                     * d ** -0.5).to(dtype)
                path = k9.route(x, w, bm)
                want = "mma" if dtype == torch.float32 or name == "tail" \
                    else "wgmma" if name.startswith("prefill") else "stream"
                check(path == want, f"K9 takes the {path} route at {name} "
                      f"{(d, f, bm)} {dtype}, expected {want}")
                before = (k9.launches_wgmma, k9.launches_stream)
                out = k9.moe_gmm(x, w, tile_eid, bm=bm)
                check((k9.launches_wgmma - before[0],
                       k9.launches_stream - before[1])
                      == (path == "wgmma", path == "stream"),
                      f"{k9.launches_wgmma - before[0]} wgmma and "
                      f"{k9.launches_stream - before[1]} stream launches for "
                      f"one {path} call at {name}")
                again = k9.moe_gmm(x, w, tile_eid, bm=bm)
                plain = k9.moe_gmm_plain(x, w, tile_eid, bm=bm)
                torch.cuda.synchronize()
                check(bool(torch.isfinite(out).all()),
                      f"K9 non-finite at {name} {(d, f)}")
                check(torch.equal(out, again), f"K9 ({path} route) gave "
                      f"other bits on a second run at {name} {(d, f)}")
                max_abs, max_rel = rel_err(out.float(), plain.float())
                tol = KERNEL_REL_TOL if dtype == torch.float32 \
                    else BF16_REL_TOL
                ms = auto_ms(lambda: k9.moe_gmm(x, w, tile_eid, bm=bm))
                # the stream route's time holds its sum pass
                device_ms, recorded = (None, 0) if ms > TRACE_MAX_MS \
                    else kernel_device_ms(
                        lambda: k9.moe_gmm(x, w, tile_eid, bm=bm),
                        "moe_gmm_kernel", k9, also=("moe_stream_sum",))
                plain_ms = auto_ms(lambda: k9.moe_gmm_plain(
                    x, w, tile_eid, bm=bm), 30.0)
                xc = torch.zeros((e, cap, d), dtype=dtype, device=device)
                library_ms = auto_ms(lambda: torch.bmm(xc, w))
                del xc
                bench_ms = None
                if name == "bench":
                    tok, eid = (a.to(dtype) if a.is_floating_point() else a
                                for a in case[6])
                    mask = torch.nn.functional.one_hot(eid, e).to(dtype) \
                        .t()[:, :, None]

                    def dense_all_experts():
                        y = torch.einsum("td,edf->etf", tok, w)
                        return (y * mask).sum(0)
                    bench_ms = auto_ms(dense_all_experts)
                flops = 2.0 * n_rows * d * f
                nbytes = x.element_size() * (n_rows * d + len(used) * d * f
                                             + x.shape[0] * f)
                bound_ms, bound_by = bound_for(flops, nbytes, dtype)
                rec = dict(case=name, dtype=str(dtype).removeprefix("torch."),
                           route=path, t=x.shape[0], d=d, f=f, experts=e,
                           bm=bm,
                           rows=n_rows, experts_used=len(used), count=1,
                           max_abs_err=max_abs, max_rel_err=max_rel, ms=ms,
                           device_ms=device_ms, plain_ms=plain_ms,
                           library_ms=library_ms, library_capacity=cap,
                           bench_dense_ms=bench_ms, bound_ms=bound_ms,
                           bound_by=bound_by, traced_launches=recorded,
                           tflops=flops / ms / 1e9,
                           gb_per_s=nbytes / ms / 1e6)
                rec["bound_share"] = bound_ms / ms
                rows.append(rec)
                print(f"  {name:19s} {rec['dtype']:8s} {path:6s} "
                      f"{x.shape[0]:5d} x "
                      f"{d:5d} -> {f:5d} {bm:4d} {len(used):4d} "
                      f"{max_rel:.2e} {ms:9.4f} "
                      + (f"{device_ms:10.4f} " if device_ms is not None
                         else "       n/a ") +
                      f"{plain_ms:11.4f} {library_ms:11.4f} {bound_ms:9.4f} "
                      f"{bound_by}  ({bound_ms / ms:.3f} of the {bound_by} "
                      f"bound by events; {rec['tflops']:.1f} TFLOP/s, "
                      f"{rec['gb_per_s']:.0f} GB/s; {recorded} of 5 "
                      f"launches traced"
                      + (f"; bench dense einsum {bench_ms:.4f} ms"
                         if bench_ms is not None else "") + ")")
                check(max_rel <= tol, f"K9 disagrees with its plain version "
                      f"at {name} {(x.shape[0], d, f, rec['dtype'])}: "
                      f"max_rel {max_rel:.3e} > {tol}")
                check(not any(out[i * bm:(i + 1) * bm].any()
                              for i, eid in enumerate(ids) if eid < 0),
                      f"K9 wrote a -1 tile at {name}")
                if name.startswith("decode") and dtype == torch.bfloat16 \
                        and d == MOE_D:
                    one_vs_spread[name] = ms
                del x, w, out, again, plain
    ratio = one_vs_spread["decode, one expert"] / one_vs_spread["decode"]
    print(f"  bf16 decode, gate shape: 16 rows on one expert "
          f"{one_vs_spread['decode, one expert']:.4f} ms against 16 over 8 "
          f"{one_vs_spread['decode']:.4f} ms: {ratio:.3f} of it (limit "
          f"{MOE_ONE_EXPERT_RATIO})")
    check(ratio < MOE_ONE_EXPERT_RATIO, f"K9 with one expert's rows takes "
          f"{ratio:.3f} of the eight-expert time: empty experts are read")
    print("  per-case JSON:", json.dumps(rows))
    return rows, ratio


def decode_vs_forward(params, cfg) -> dict:
    """Phase 20: ``decode_parity.measure`` on the card at full width, in the
    reference's dropless regime: prefill HYBRID_DECODE's 96 tokens, 8
    ``decode_step``s, against ``forward`` over all 104 tokens.  Prints and
    returns max |diff| / max |logit| of the decode logits (``rel``, per
    step), the argmax agreement and the prefill's own logits against
    forward's.  Fails if decode launches K8 or gives non-finite logits;
    the caller holds ``rel`` to its limit."""
    from repro_torch.launch import decode_parity

    b, lp, steps = HYBRID_DECODE
    toks = decode_parity.tokens(cfg, b, lp + steps, SEED,
                                params["embed"].device)
    out = decode_parity.measure(params, cfg, toks, lp)
    print(f"\ndecode vs forward ({cfg.name}, {cfg.dtype}, capacity factor "
          f"{decode_parity.CAPACITY_FACTOR:g}, batch {b}): prefill {lp} "
          f"tokens, then {steps} decode steps against forward over "
          f"{lp + steps}: max |diff| / max |logit| {out['rel']:.3e} (per "
          f"step {[f'{r:.2e}' for r in out['per_step']]}), argmax agrees on "
          f"{out['argmax_agree']:.3f}; the prefill's own logits vs forward's "
          f"{out['prefill_rel']:.3e}; K8 launches in decode "
          f"{out['decode_k8_launches']}")
    check(math.isfinite(out["rel"]), "non-finite decode logits")
    check(out["decode_k8_launches"] == 0,
          f"decode launched K8 {out['decode_k8_launches']} times")
    return out


def hybrid_parity_cfg():
    """Phase 21's config: the cut in f32 holding HYBRID_PARITY_SHARE (2 of
    16 experts, 45.7 GB on each side), or one expert when the host has not
    that much memory free.  ``free -g``'s total is printed."""
    import dataclasses

    from repro_torch.configs import get_config

    free = subprocess.run(["free", "-g"], capture_output=True, text=True,
                          timeout=60).stdout.splitlines()
    print("\nhost memory (free -g):", " | ".join(line.strip()
                                                for line in free[:2]))
    with open("/proc/meminfo") as f:
        info = dict(line.split(":", 1) for line in f)
    available_gb = int(info["MemAvailable"].split()[0]) * 1024 / 1e9
    share = (HYBRID_PARITY_SHARE if available_gb >= 55.0
             else HYBRID_PARITY_SHARE_SMALL)
    print(f"  {available_gb:.1f} GB available: the parity model holds "
          f"expert share {share}")
    cfg = get_config(HYBRID_ARCH)
    return dataclasses.replace(cfg, dtype="float32", moe=dataclasses.replace(
        cfg.moe, expert_share=share)), available_gb


# ---------------------------------------------------------------------------
# Phases 22-27: the whole-plane path (REPRO_CONV_TILING=whole: K10a, K10c,
# K10b) and the max-pool K5
# ---------------------------------------------------------------------------

WHOLE_REQUESTS = 128        # cut from phase 3's 512: keeps the script in its limit
WHOLE_WARM_REQUESTS = 32
WHOLE_TRAIN_STEPS = 3
WU_WHOLE_SUM = "wu_whole_sum_kernel"   # K10b's second pass, timed with it
POOL_SHAPE = (BATCH, 112, 112, 64)   # the stem pool's input at batch 16
POOL_CASES = [(3, 2, 1, 12), (2, 2, 0, 8), (3, 1, 1, 7)]   # the reference's


class Counter:
    """A wrapper's launch count kept under another name than ``launches``
    (the whole-plane kernels' ``launches_whole``), read as ``launches`` by
    ``trace_device``."""

    def __init__(self, module, attr: str):
        self.module, self.attr = module, attr

    @property
    def launches(self) -> int:
        return getattr(self.module, self.attr)


def _sig(r: dict) -> tuple:
    return (r["h"], r["w"], r["c"], r["k"], r["r"], r["s"], r["stride"],
            r["padding"], tuple(r.get("fused", ())))


def whole_split_forced(split: bool):
    """K10a's mma route with every reference block's rows cut into
    ``whole_slices`` slices (True) or none (False), in place of the rule
    ``conv2d_direct.whole_split``: the two sides of the CTA-floor
    question."""
    from repro_torch.kernels import conv2d_direct as k1
    return returning(k1, "whole_split", split)


def whole_signatures(device, sigs, k1_rows):
    """Phase 22: K10a against its plain version and against K1 on the 23
    serving signatures at batch 16, with the reference's blocking; on the
    mma route each signature unsplit and with its reference blocks' rows
    cut across CTAs (``whole_slices``), the same bits both ways and twice,
    each timed by CUDA events and profiler device time; the record's own
    time is that of the side ``conv2d_direct.whole_split`` takes."""
    import torch
    from repro_torch.core.conv import whole_blocking
    from repro_torch.kernels import conv2d_direct as k1

    gen = torch.Generator(device=device).manual_seed(SEED + 22)
    k1_by = {_sig(r): r for r in k1_rows}
    needle = "conv2d_direct_whole_kernel"
    counter = Counter(k1, "launches_whole")
    rows = []
    print(f"\nK10a vs plain and K1, ResNet-50 {IMAGE}x{IMAGE} batch {BATCH} "
          f"({len(sigs)} signatures), the reference's whole-plane blocking; "
          f"ev = CUDA events, dev = profiler device time, library = cuDNN + "
          f"epilogue (phase 2); unsplit / split: the reference's blocks "
          f"whole, or their rows cut across CTAs; rule: the side "
          f"whole_split takes:")
    print("  h  w    c    k r st fused         count route rb_p k_blk rows "
          "pass  smem ctas split_ctas  max_rel  vs_k1  ev_unsplit "
          "dev_unsplit ev_split dev_split rule  plain_ms  k1_ms library_ms "
          "bound_ms mma_bound_ms")
    for key, count in sigs.items():
        h, w, c, k, r, s, st, pad, fused = key
        p = (h + 2 * pad - r) // st + 1
        q = (w + 2 * pad - s) // st + 1

        def randn(*shape, std=1.0):
            return torch.randn(shape, generator=gen, device=device) * std

        args = dict(
            x=randn(BATCH, h, w, c),
            w=randn(r, s, c, k, std=math.sqrt(2.0 / (r * s * c))),
            stride=st, padding=pad,
            scale=torch.rand(k, generator=gen, device=device) + 0.5,
            shift=randn(k, std=0.1),
            residual=randn(BATCH, p, q, k) if "add" in fused else None,
            relu="relu" in fused)
        blk = whole_blocking((BATCH, h, w, c), (r, s, c, k), stride=st,
                             padding=pad, kind="fwd")
        bk = dict(rb_p=blk.rb_p, k_blk=blk.k_blk)
        rb_p = min(blk.rb_p, p)
        geo = dict(n=BATCH, p=p, q=q, k=k, rb_p=rb_p, k_blk=blk.k_blk)
        path = k1.route_whole(args["x"], args["w"])
        check(path == "mma", f"K10a at {key} takes the {path} route")
        rule = k1.whole_split(**geo)
        slices = k1.whole_slices(n=BATCH, p=p, k=k, rb_p=rb_p,
                                 k_blk=blk.k_blk)
        plan = k1.whole_mma_plan(p=p, q=q, k_blk=blk.k_blk, rb_p=rb_p, r=r,
                                 s=s, stride=st, rows_cta=rb_p)
        blocks = BATCH * (k // blk.k_blk) * -(-p // rb_p)
        timed = {}
        outs = []
        for split in (False, True):
            with whole_split_forced(split):
                outs.append(k1.conv2d_direct_whole(**args, **bk))
                outs.append(k1.conv2d_direct_whole(**args, **bk))
                torch.cuda.synchronize()
                ev = cuda_ms(lambda: k1.conv2d_direct_whole(**args, **bk), 20)
                dev = device_ms_of(trace_device(
                    lambda i: k1.conv2d_direct_whole(**args, **bk), 10,
                    {needle: counter}, sync_each=True), needle)
            timed[split] = (ev, dev)
        out = outs[0]
        check(bool(torch.isfinite(out).all()), f"K10a non-finite at {key}")
        check(all(torch.equal(out, o) for o in outs[1:]),
              f"K10a (mma route) gave other bits on a second run or with "
              f"its rows cut across CTAs at {key}")
        plain = k1.conv2d_direct_whole_plain(**args, **bk)
        tiled = k1.conv2d_direct(**args)
        torch.cuda.synchronize()
        scale = float(plain.abs().max())
        max_abs = float((out - plain).abs().max())
        max_rel = max_abs / scale
        k1_rel = float((out - tiled).abs().max()) / scale
        plain_ms = cuda_ms(lambda: k1.conv2d_direct_whole_plain(**args, **bk),
                           3)
        ref = k1_by[key]
        rec = dict(h=h, w=w, c=c, k=k, r=r, s=s, stride=st, padding=pad,
                   fused=list(fused), count=count, route=path,
                   rb_p=blk.rb_p, k_blk=blk.k_blk, rows_pass=plan.rows_pass,
                   smem=plan.smem, blocks=blocks,
                   split_blocks=blocks * slices, slices=slices,
                   split_taken=rule, max_abs_err=max_abs,
                   max_rel_err=max_rel, k1_rel_err=k1_rel,
                   ms_unsplit=timed[False][0],
                   device_ms_unsplit=timed[False][1],
                   ms_split=timed[True][0], device_ms_split=timed[True][1],
                   ms=timed[rule][0], device_ms=timed[rule][1],
                   plain_ms=plain_ms, k1_ms=ref["ms"],
                   library_ms=ref["library_ms"], bound_ms=ref["bound_ms"],
                   bound_by=ref["bound_by"],
                   mma_bound_ms=ref["mma_bound_ms"])
        rows.append(rec)
        print(f"{h:3d}{w:3d}{c:5d}{k:5d}{r:2d}{st:3d} "
              f"{'+'.join(fused):14s}{count:5d} {path:5s}{blk.rb_p:4d}"
              f"{blk.k_blk:6d}{rb_p:5d}{plan.rows_pass:5d}{plan.smem:7d}"
              f"{blocks:5d}{blocks * slices:11d}  {max_rel:.2e} "
              f"{k1_rel:.2e} {timed[False][0]:10.4f} {timed[False][1]:11.4f} "
              f"{timed[True][0]:8.4f} {timed[True][1]:9.4f} "
              f"{'split' if rule else 'whole':6s}{plain_ms:9.4f} "
              f"{ref['ms']:7.4f} {ref['library_ms']:10.4f} "
              f"{ref['bound_ms']:8.4f} {ref['mma_bound_ms']:12.4f}")
        check(max_rel <= KERNEL_REL_TOL,
              f"K10a disagrees with its plain version at {key}: max_rel "
              f"{max_rel:.3e} > {KERNEL_REL_TOL}")
        del args, out, outs, plain, tiled

    def weighted_(key):
        return sum(r_[key] * r_["count"] for r_ in rows)
    print(f"  per forward (x count): K10a unsplit {weighted_('ms_unsplit'):.4f}"
          f" ms by events, {weighted_('device_ms_unsplit'):.4f} device; split "
          f"{weighted_('ms_split'):.4f} / {weighted_('device_ms_split'):.4f}; "
          f"the rule {weighted_('ms'):.4f} / {weighted_('device_ms'):.4f}; "
          f"K1 {weighted_('k1_ms'):.4f}; cuDNN + epilogue "
          f"{weighted_('library_ms'):.4f}; bounds {weighted_('bound_ms'):.4f} "
          f"(f32 SIMT), {weighted_('mma_bound_ms'):.4f} (3xTF32)")
    print("  per-signature JSON:", json.dumps(rows))
    return rows


def whole_serving(device, params):
    """Phase 23: the whole-plane serving path.  ``CnnInferenceEngine`` and
    ``ImageServer`` under ``use_conv_tiling("whole")`` on phase 3's params:
    WHOLE_WARM_REQUESTS untimed, then a window of WHOLE_REQUESTS; K10a
    exactly 52 per forward and K1 none; one batch-16 forward's logits
    against the tiled engine's on the same batch; that forward under the
    profiler.  Returns (K10a launches in the window, summary)."""
    import numpy as np
    import torch
    from repro_torch.backend import use_conv_tiling
    from repro_torch.graph.serving import CnnInferenceEngine
    from repro_torch.kernels import conv2d_direct as k1
    from repro_torch.launch.serve_cnn import build_model, serve_window

    gxm, image = build_model(smoke=False, device=device)
    engine = CnnInferenceEngine(gxm, params, image_hw=(image, image),
                                max_batch=BATCH)
    with use_conv_tiling("whole"):
        t0 = time.perf_counter()
        report = engine.warmup(autotune="off")
        print(f"\nwhole-plane serving: warmup of buckets {report['buckets']} "
              f"in {time.perf_counter() - t0:.2f}s, conv_tiling "
              f"{report['conv_tiling']!r}")
        check(report["conv_tiling"] == "whole", "warmup not under whole")
        # serve_window sets the K1 and K10a counts to 0 as the window opens
        server, results = serve_window(engine, requests=WHOLE_REQUESTS,
                                       seed=SEED,
                                       warm_requests=WHOLE_WARM_REQUESTS)
        launches, k1_launches = k1.launches_whole, k1.launches
        mma = k1.launches_whole_mma
    st = server.stats()
    check(len(results) == WHOLE_REQUESTS,
          f"served {len(results)} of {WHOLE_REQUESTS}")
    check(all(0 <= c < 1000 and math.isfinite(v)
              for c, v in results.values()), "non-finite or bad top-1")
    print(f"  {WHOLE_REQUESTS} requests (cut from {REQUESTS}) in "
          f"{st['batches']} batches {st['by_bucket']}")
    print(f"  images/s {st['images_per_s']:.2f} over {st['wall_s']:.3f} s "
          f"wall  p50 {st['latency']['p50_ms']:.3f} ms  p99 "
          f"{st['latency']['p99_ms']:.3f} ms")
    print(f"  K10a launches {launches} = 52 x {st['batches']} forwards; K1 "
          f"launches {k1_launches}")
    check(launches == 52 * st["batches"],
          f"K10a launched {launches} times, expected 52 x {st['batches']}")
    check(k1_launches == 0, f"K1 launched {k1_launches} times under whole")
    print(f"  K10a launches on the mma route (launches_whole_mma): {mma} of "
          f"{launches}")
    check(mma == launches, f"{mma} of the window's {launches} K10a launches "
          f"took the mma route, expected all")

    images = np.random.default_rng(SEED + 23).standard_normal(
        (BATCH, IMAGE, IMAGE, 3), dtype=np.float32)
    with use_conv_tiling("tiled"):
        tiled = engine.infer(images).cpu()
    with use_conv_tiling("whole"):
        whole = engine.infer(images).cpu()
    max_abs = float((whole - tiled).abs().max())
    scale = float(tiled.abs().max())
    same_top1 = bool((whole.argmax(-1) == tiled.argmax(-1)).all())
    print(f"  batch {BATCH} logits, whole vs tiled engine: max|diff| "
          f"{max_abs:.3e}, max|logit| {scale:.3e}, ratio "
          f"{max_abs / scale:.3e} (limit {LOGIT_REL_TOL}), same top-1 "
          f"{same_top1}")
    check(max_abs <= LOGIT_REL_TOL * scale,
          f"whole-plane logits differ by {max_abs:.3e} > {LOGIT_REL_TOL} * "
          f"{scale:.3e} from the tiled engine's")
    check(same_top1, "whole-plane top-1 differs from the tiled engine's")

    on_card = torch.as_tensor(images, device=device)
    with torch.inference_mode(), use_conv_tiling("whole"):
        trace = trace_device(lambda i: engine.gxm.forward(
            engine.params, on_card, train=False), 3,
            {"conv2d_direct_whole_kernel": Counter(k1, "launches_whole"),
             "conv2d_direct_kernel": k1})
    prof = dict(wall_ms=trace["wall_ms"], device_ms=trace["device_ms"],
                busy_share=trace["busy_share"],
                k10a_ms=device_ms_of(trace, "conv2d_direct_whole_kernel"),
                k1_ms=device_ms_of(trace, "conv2d_direct_kernel"))
    busy = "n/a" if prof["busy_share"] is None else \
        f"{prof['busy_share']:.4f}"
    print(f"  batch {BATCH} whole-plane forward under the profiler: "
          f"{prof['wall_ms']:.3f} ms host clock, device "
          f"{prof['device_ms']:.3f} ms (K10a {prof['k10a_ms']:.3f}, K1 "
          f"{prof['k1_ms']:.3f}), busy share {busy}")
    summary = dict(requests=WHOLE_REQUESTS,
                   images_per_s=st["images_per_s"],
                   p50_ms=st["latency"]["p50_ms"],
                   p99_ms=st["latency"]["p99_ms"], batches=st["batches"],
                   logits_rel=max_abs / scale, same_top1=same_top1,
                   profile=prof)
    del engine
    return launches, summary


Q8_SIDES = ("uncut", "cut", "simt")     # phase 24's three ways to run K10c


def q8_side_forced(side: str):
    """K10c with each reference block whole in one CTA ("uncut") or cut
    across CTAs as ``whole_k_cta`` and ``whole_rows_cta`` cut it ("cut") on
    the mma route, or on the SIMT route ("simt"), in place of
    ``conv2d_q8.whole_split`` and ``route_whole``."""
    from repro_torch.kernels import conv2d_q8 as k3
    if side == "simt":
        return returning(k3, "route_whole", "simt")
    return returning(k3, "whole_split", side == "cut")


# K10c's 52-conv sum by CUDA events in PR 24's final run on an H100
# (PERF.md section 6), when its wrapper re-laid the weights on every call
K10C_PR24_EVENTS_MS = 6.6261


def whole_q8(device, sigs, q8_rows, q8_gxm, qparams):
    """Phase 24: K10c against its plain version and K3 on the 23 serving
    signatures (max |diff| 0 each), each run three ways (the mma route with
    each reference block whole in one CTA and cut across CTAs, and the SIMT
    route forced), twice each, all with the same bits, each timed by CUDA
    events and profiler device time; the record's own time is that of the
    mma route on the side ``conv2d_q8.whole_split`` takes.  Then one int8
    forward at batch 16 on phase 6's quantized tree under ``whole``: 52
    K10c launches, all on the mma route, no K3, logits equal bit for bit to
    the tiled int8 forward's; that forward under the profiler.  Returns
    (the records, K10c launches in that forward, its summary)."""
    import numpy as np
    import torch
    from repro_torch.backend import use_conv_tiling
    from repro_torch.core.conv import whole_blocking
    from repro_torch.kernels import conv2d_q8 as k3

    gen = torch.Generator(device=device).manual_seed(SEED + 24)
    k3_by = {_sig(r): r for r in q8_rows}
    needle = "conv2d_q8_whole_kernel"     # both routes' kernel names hold it
    counter = Counter(k3, "launches_whole")
    rows = []
    print(f"\nK10c vs plain and K3, ResNet-50 {IMAGE}x{IMAGE} batch {BATCH} "
          f"({len(sigs)} signatures), int8 operands, the reference's q8 "
          f"blocking; route: route_whole ('mma' for all); k_cta, rows: a "
          f"cut CTA's output channels (whole_k_cta) and rows "
          f"(whole_rows_cta); pass: rows of a pass, stages and smem: its "
          f"ring under the rule; ctas: the reference grid's blocks, cut: "
          f"the CTAs of the cut; ev = CUDA events, dev = profiler device "
          f"time, uncut / cut on the mma route, simt: the __dp4a route "
          f"forced; rule: the side whole_split takes; library = "
          f"torch._int_mm (phase 5, 1x1 only):")
    print("  h  w    c    k r st fused         count route rb_p k_blk k_cta "
          "rows pass stg   smem ctas  cut vs_plain vs_k3 ev_uncut dev_uncut "
          "  ev_cut  dev_cut  ev_simt dev_simt rule   plain_ms   k3_ms "
          "library_ms bound_ms")
    k3.launches_whole = k3.launches_whole_mma = 0
    for key, count in sigs.items():
        h, w, c, k, r, s, st, pad, fused = key
        p = (h + 2 * pad - r) // st + 1
        q = (w + 2 * pad - s) // st + 1

        def randn(*shape, std=1.0):
            return torch.randn(shape, generator=gen, device=device) * std

        x_q, w_q, x_scale, w_scale = k3.quantize_conv_inputs(
            randn(BATCH, h, w, c),
            randn(r, s, c, k, std=math.sqrt(2.0 / (r * s * c))))
        args = dict(
            x_q=x_q, w_q=w_q, x_scale=x_scale, w_scale=w_scale,
            stride=st, padding=pad,
            scale=torch.rand(k, generator=gen, device=device) + 0.5,
            shift=randn(k, std=0.1),
            residual=randn(BATCH, p, q, k) if "add" in fused else None,
            relu="relu" in fused)
        blk = whole_blocking((BATCH, h, w, c), (r, s, c, k), stride=st,
                             padding=pad, kind="q8")
        bk = dict(rb_p=blk.rb_p, k_blk=blk.k_blk)
        rb_p = min(blk.rb_p, p)
        geo = dict(n=BATCH, p=p, q=q, k=k, rb_p=rb_p, k_blk=blk.k_blk)
        path = k3.route_whole(x_q, w_q)
        check(path == "mma", f"K10c at {key} takes the {path} route")
        rule = k3.whole_split(**geo)
        with q8_side_forced("cut"):     # the cut, taken or not
            k_cta = k3.whole_k_cta(**geo)
            rows_cta = k3.whole_rows_cta(**geo)
        plan = k3.whole_mma_plan(
            p=p, q=q, k_blk=k_cta if rule else blk.k_blk, rb_p=rb_p, r=r,
            s=s, stride=st, rows_cta=rows_cta if rule else rb_p)
        blocks = BATCH * (k // blk.k_blk) * -(-p // rb_p)
        cut_ctas = BATCH * (k // k_cta) * -(-p // rb_p) * -(-rb_p // rows_cta)
        timed, outs = {}, []
        for side in Q8_SIDES:
            with q8_side_forced(side):
                outs.append(k3.conv2d_q8_whole(**args, **bk))
                outs.append(k3.conv2d_q8_whole(**args, **bk))
                torch.cuda.synchronize()
                ev = cuda_ms(lambda: k3.conv2d_q8_whole(**args, **bk), 20)
                dev = device_ms_of(trace_device(
                    lambda i: k3.conv2d_q8_whole(**args, **bk), 10,
                    {needle: counter}, sync_each=True), needle)
            timed[side] = (ev, dev)
        out = outs[0]
        plain = k3.conv2d_q8_whole_plain(**args, **bk)
        tiled = k3.conv2d_q8(**args)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(out).all()), f"K10c non-finite at {key}")
        check(all(torch.equal(out, o) for o in outs[1:]),
              f"K10c gave other bits on a second run, with its rows cut "
              f"across CTAs or on the SIMT route at {key}")
        vs_plain = float((out - plain).abs().max())
        vs_k3 = float((out - tiled).abs().max())
        plain_ms = cuda_ms(lambda: k3.conv2d_q8_whole_plain(**args, **bk), 3)
        ref = k3_by[key]
        side = "cut" if rule else "uncut"
        rec = dict(h=h, w=w, c=c, k=k, r=r, s=s, stride=st, padding=pad,
                   fused=list(fused), count=count, route=path,
                   rb_p=blk.rb_p, k_blk=blk.k_blk, cut_k_blk=k_cta,
                   cut_rows=rows_cta, rows_pass=plan.rows_pass,
                   stages=plan.stages, smem=plan.smem, blocks=blocks,
                   cut_blocks=cut_ctas, cut_taken=rule,
                   max_abs_err=vs_plain, k3_abs_err=vs_k3,
                   ms=timed[side][0], device_ms=timed[side][1],
                   ms_uncut=timed["uncut"][0],
                   device_ms_uncut=timed["uncut"][1],
                   ms_cut=timed["cut"][0], device_ms_cut=timed["cut"][1],
                   ms_simt=timed["simt"][0], device_ms_simt=timed["simt"][1],
                   plain_ms=plain_ms, k3_ms=ref["ms"],
                   k3_device_ms=ref["k3_device_ms"],
                   library_ms=ref["library_ms"], bound_ms=ref["bound_ms"],
                   bound_by=ref["bound_by"])
        rows.append(rec)
        lib = "—" if ref["library_ms"] is None else f"{ref['library_ms']:.4f}"
        print(f"{h:3d}{w:3d}{c:5d}{k:5d}{r:2d}{st:3d} "
              f"{'+'.join(fused):14s}{count:5d} {path:5s}{blk.rb_p:4d}"
              f"{blk.k_blk:6d}{k_cta:6d}{rows_cta:5d}{plan.rows_pass:5d}"
              f"{plan.stages:4d}{plan.smem:7d}{blocks:5d}{cut_ctas:5d} "
              f"{vs_plain:8.1e} "
              f"{vs_k3:5.1e} {timed['uncut'][0]:8.4f} {timed['uncut'][1]:9.4f}"
              f" {timed['cut'][0]:8.4f} {timed['cut'][1]:8.4f} "
              f"{timed['simt'][0]:8.4f} {timed['simt'][1]:8.4f} {side:5s}"
              f"{plain_ms:10.4f} {ref['ms']:7.4f} {lib:>10s} "
              f"{ref['bound_ms']:8.4f}")
        check(vs_plain == 0.0 and vs_k3 == 0.0,
              f"K10c differs at {key}: max |diff| {vs_plain:.3e} from its "
              f"plain version, {vs_k3:.3e} from K3; not 0")
        del x_q, w_q, args, out, outs, plain, tiled

    def weighted_(key_, only=lambda r_: True):
        return sum(r_[key_] * r_["count"] for r_ in rows if only(r_))

    def one_by_one(r_):
        return r_["r"] == r_["s"] == 1
    print(f"  per forward (x count): K10c under the rule "
          f"{weighted_('ms'):.4f} ms by events (PR 24's final run, weights "
          f"re-laid each call: {K10C_PR24_EVENTS_MS}), "
          f"{weighted_('device_ms'):.4f} device; mma uncut {weighted_('ms_uncut'):.4f} / "
          f"{weighted_('device_ms_uncut'):.4f}; mma cut "
          f"{weighted_('ms_cut'):.4f} / {weighted_('device_ms_cut'):.4f}; "
          f"SIMT {weighted_('ms_simt'):.4f} / "
          f"{weighted_('device_ms_simt'):.4f}; K3 {weighted_('k3_ms'):.4f}; "
          f"bound {weighted_('bound_ms'):.4f}")
    print(f"  the 1x1 convs (x count): K10c under the rule "
          f"{weighted_('ms', one_by_one):.4f} ms by events, "
          f"{weighted_('device_ms', one_by_one):.4f} device; torch._int_mm + "
          f"epilogue {weighted_('library_ms', one_by_one):.4f}; K3 "
          f"{weighted_('k3_ms', one_by_one):.4f}")
    print("  per-signature JSON:", json.dumps(rows))

    images = np.random.default_rng(SEED + 24).standard_normal(
        (BATCH, IMAGE, IMAGE, 3), dtype=np.float32)
    x = torch.as_tensor(images, device=device)
    with torch.inference_mode():
        with use_conv_tiling("whole"):
            k3.launches = k3.launches_whole = k3.launches_whole_mma = 0
            whole = q8_gxm.infer(qparams, x)
            torch.cuda.synchronize()
            launches, k3_launches = k3.launches_whole, k3.launches
            mma = k3.launches_whole_mma
        with use_conv_tiling("tiled"):
            tiled = q8_gxm.infer(qparams, x)
    equal = bool(torch.equal(whole, tiled))
    print(f"  int8 forward at batch {BATCH} on phase 6's quantized tree under "
          f"whole: K10c {launches} launches ({mma} on the mma route), K3 "
          f"{k3_launches}; logits equal to the tiled int8 forward's bit for "
          f"bit: {equal}")
    check(launches == 52 and k3_launches == 0,
          f"K10c launched {launches} and K3 {k3_launches} times in one int8 "
          f"forward, expected 52 and 0")
    check(mma == launches, f"{launches - mma} of the int8 forward's K10c "
          f"launches took the SIMT route, expected none")
    check(equal, "whole-plane int8 logits differ from the tiled int8 "
          "forward's")
    with torch.inference_mode(), use_conv_tiling("whole"):
        trace = trace_device(lambda i: q8_gxm.infer(qparams, x), 3,
                             {needle: counter, "conv2d_q8_kernel": k3})
    prof = dict(wall_ms=trace["wall_ms"], device_ms=trace["device_ms"],
                busy_share=trace["busy_share"],
                k10c_ms=device_ms_of(trace, needle),
                k3_ms=device_ms_of(trace, "conv2d_q8_kernel"))
    busy = "n/a" if prof["busy_share"] is None else \
        f"{prof['busy_share']:.4f}"
    print(f"  that int8 forward under the profiler: {prof['wall_ms']:.3f} ms "
          f"host clock, device {prof['device_ms']:.3f} ms (K10c "
          f"{prof['k10c_ms']:.3f}, K3 {prof['k3_ms']:.3f}), busy share "
          f"{busy}")
    return rows, launches, dict(k10c_launches=launches,
                                k10c_launches_mma=mma,
                                k3_launches=k3_launches,
                                equal_to_tiled=equal, profile=prof)


# ---------------------------------------------------------------------------
# Phases 24b and 24c: depth-first chains; the whole-plane blockings tuned
# ---------------------------------------------------------------------------

CHAIN_PRESSURE = 1 << 20    # the reference's pressure budget (its CI, bench)
L2_BYTES = 50 * 10 ** 6       # the H100 SXM's L2 (NVIDIA: 50 MB)
CHAIN_TIMED = 6             # forwards timed a way, in turns, by host clock
# the ResNet-50 chains the reference fuses at 1 MiB, batch 16: (rb, bands)
RESNET_PRESSURE_PLAN = {"s0b0_c1": (14, 4), "s0b1_c1": (9, 7),
                        "s0b2_c1": (9, 7), "s1b0_c1": (3, 10),
                        "s1b1_c1": (7, 4), "s1b2_c1": (7, 4),
                        "s1b3_c1": (7, 4)}
WHOLE_TUNE_STEPS = 10       # whole training steps timed a way, in turns


@contextlib.contextmanager
def chain_budget_forced(budget):
    """``core.blocking.CHAIN_BUDGET``, which ``chain_blocking`` reads at each
    call, set to ``budget`` for the block (None: left as it is): the
    reference's 1 MiB pressure budget forced, as ``whole_split_forced``
    forces a rule."""
    from repro_torch.core import blocking
    prev = blocking.CHAIN_BUDGET
    if budget is not None:
        blocking.CHAIN_BUDGET = budget
    try:
        yield
    finally:
        blocking.CHAIN_BUDGET = prev


def conv_counts(reset: bool = False) -> dict:
    """The launch counts of K1, K10a, K3 and K10c (each with its tensor-core
    route's) and the executor's chain counts; with ``reset``, all set to 0
    first."""
    from repro_torch.graph import executor
    from repro_torch.kernels import conv2d_direct as k1
    from repro_torch.kernels import conv2d_q8 as k3
    if reset:
        k1.launches = k1.launches_mma = k1.launches_whole = 0
        k1.launches_whole_mma = k3.launches = k3.launches_ring = 0
        k3.launches_whole = k3.launches_whole_mma = 0
        executor.chains_fused = executor.chains_unfused = 0
    return dict(k1=k1.launches, k1_mma=k1.launches_mma,
                k10a=k1.launches_whole, k10a_mma=k1.launches_whole_mma,
                k3=k3.launches, k3_ring=k3.launches_ring,
                k10c=k3.launches_whole, k10c_mma=k3.launches_whole_mma,
                fused=executor.chains_fused, unfused=executor.chains_unfused)


def chain_forward(gxm, params, x, mode: str):
    """One inference forward under ``REPRO_CHAIN_FUSION`` ``mode``, the
    counts set to 0 just before it and read just after.  Returns (logits,
    counts, the chains it ran fused as (x, layers, rb), the arguments the
    executor passed ``conv2d_chain_fwd``)."""
    import torch
    from repro_torch.backend import use_chain_fusion
    from repro_torch.graph import executor

    ran, fused_fn = [], executor.conv2d_chain_fwd

    def recording(x_, layers, *, rb, **kw):
        ran.append((x_, layers, rb))
        return fused_fn(x_, layers, rb=rb, **kw)
    executor.conv2d_chain_fwd = recording
    try:
        torch.cuda.synchronize()
        conv_counts(reset=True)
        with use_chain_fusion(mode):
            out = gxm.infer(params, x)
        torch.cuda.synchronize()
        counts = conv_counts()
    finally:
        executor.conv2d_chain_fwd = fused_fn
    return out, counts, ran


def chain_rows(gxm, params, image: int, ran, tiling: str) -> list[dict]:
    """Each chain of ``gxm`` under the chain budget in force: its plan
    (``tune.measure.chain_traffic`` at batch ``BATCH``: fused, rb, bands),
    its largest hand-off band (N x band rows x Q x K x 4 bytes) and
    intermediate activation (N x P x Q x K x 4); for each chain the forward
    ran fused, its recorded input run again fused, its launches counted
    (K1's, or K10a's under ``whole``, all on the mma route, one a band and
    lane-aligned layer), then layer by layer (``core.conv.conv2d_fwd``),
    and the two compared: the same bits, or max |diff| / max |out|."""
    import torch
    from repro_torch.core.conv import conv2d_chain_fwd, conv2d_fwd, lane_ok
    from repro_torch.core.streams import FLAG_HANDOFF, build_chain_schedule
    from repro_torch.graph.serving import conv_shapes
    from repro_torch.tune.measure import chain_traffic

    by = {sh["name"]: sh for sh in conv_shapes(gxm.etg, (image, image))}
    key = "k1" if tiling == "tiled" else "k10a"
    rows = []
    for ch in gxm.etg.chains:
        shapes = [{f: by[name][f] for f in GEO} for name in ch.names]
        t = chain_traffic(shapes, minibatch=BATCH)
        outs = [(((sh["h"] + 2 * sh["padding"] - sh["r"]) // sh["stride"]
                  + 1), (sh["w"] + 2 * sh["padding"] - sh["s"])
                 // sh["stride"] + 1, sh["k"]) for sh in shapes]
        sched = build_chain_schedule(
            rs=[(sh["r"], sh["stride"], sh["padding"]) for sh in shapes],
            h_in=shapes[0]["h"], rb=t["rb"])
        handoff = max(BATCH * int(o1 - o0) * outs[l][1] * outs[l][2] * 4
                      for l, o0, o1, f in zip(sched.layer_ids, sched.o0,
                                              sched.o1, sched.flags)
                      if f & FLAG_HANDOFF)
        lanes = sum(lane_ok(sh["c"], sh["k"]) for sh in shapes)
        row = dict(name=ch.names[0], layers=len(shapes), lanes=lanes,
                   fused=t["fused"], fits=t["fits_vmem"], rb=t["rb"],
                   bands=t["n_bands"], handoff_bytes=handoff,
                   intermediate_bytes=max(BATCH * p * q * k * 4
                                          for p, q, k in outs[:-1]))
        rec = [r_ for r_ in ran if r_[1][0]["w"] is params[ch.names[0]]["w"]]
        check(len(rec) == int(t["fused"]), f"chain {ch.names[0]}: planned "
              f"fused={t['fused']}, the forward ran it fused {len(rec)} "
              f"times")
        if rec:
            x_, layers, rb = rec[0]
            check(rb == t["rb"], f"chain {ch.names[0]} ran at rb {rb}, "
                  f"planned {t['rb']}")
            conv_counts(reset=True)
            got = conv2d_chain_fwd(x_, layers, rb=rb)
            torch.cuda.synchronize()
            c = conv_counts()
            want = x_
            for L in layers:
                want = conv2d_fwd(want, L["w"], stride=L["stride"],
                                  padding=L["padding"], bias=L.get("bias"),
                                  scale=L.get("scale"), shift=L.get("shift"),
                                  residual=L.get("residual"),
                                  relu=L.get("relu", False))
            row.update(equal=bool(torch.equal(got, want)),
                       rel=float((got - want).abs().max())
                       / float(want.abs().max()),
                       launches=c[key], launches_mma=c[f"{key}_mma"])
            check(c[key] == c[f"{key}_mma"] == lanes * t["n_bands"],
                  f"chain {ch.names[0]} under {tiling}: {c[key]} launches, "
                  f"{c[f'{key}_mma']} on the mma route, expected "
                  f"{lanes} x {t['n_bands']} bands")
            # a chain of lane-aligned layers runs only the port's kernels:
            # the same bits; a ref-path layer runs cuDNN on each band
            check(row["equal"] or (lanes < len(shapes)
                                   and row["rel"] <= KERNEL_REL_TOL),
                  f"chain {ch.names[0]} under {tiling}, rb {rb}: fused "
                  f"differs from unfused by {row['rel']:.3e} of max |out|")
            del got, want
        rows.append(row)
    return rows


def _chain_table(rows: list[dict]) -> None:
    print("    chain      layers fused   rb bands hand-off MB intermediate MB"
          "  same bits (max rel)  launches (mma)")
    for r_ in rows:
        if not r_["fused"]:         # layer by layer: no band, no hand-off
            print(f"    {r_['name']:11s}{r_['layers']:4d}  False"
                  f"{'-':>5s}{'-':>6s}{'-':>12s}"
                  f"{r_['intermediate_bytes'] / 1e6:15.3f}")
            continue
        print(f"    {r_['name']:11s}{r_['layers']:4d}  True "
              f"{r_['rb']:5d}{r_['bands']:6d}{r_['handoff_bytes'] / 1e6:12.3f}"
              f"{r_['intermediate_bytes'] / 1e6:15.3f}  {str(r_['equal']):5s}"
              f" ({r_['rel']:.3e})       {r_['launches']} "
              f"({r_['launches_mma']})")


def chains_phase(device, serve_params, q8_gxm, qparams) -> dict:
    """Phase 24b: depth-first chains (``REPRO_CHAIN_FUSION``).

    Full ResNet-50 (224x224, batch 16, phase 3's params): the knob on
    against off under both tilings, at the default chain budget (16 MiB:
    all 16 chains fused, one band each) and at the reference's 1 MiB
    (``chain_budget_forced``: the 7 chains the reference fuses, 3 to 14 rows
    a band, the other 9 layer by layer): logits by ``torch.equal``, the
    launches by kernel (K1 or K10a, all on the mma route) and chain counts
    from one forward each, every chain run again fused and layer by layer
    (``chain_rows``) with its rb, bands and hand-off bytes beside the 50 MB
    L2; tiled, the three ways (off, on, on at 1 MiB) timed in turns by host
    clock and once each under the profiler.  Then phase 6's int8 tree with
    the knob on (no chain fuses: the same bits and launches as off), and
    Inception-v3 (299x299, batch 16, phase 7b's params) at both budgets:
    the stem chain's first layer (C=3) takes cuDNN on each band, so its
    chain and the logits are held to the f32 limits where the bits differ.
    Returns the summary."""
    import numpy as np
    import torch
    from repro_torch.backend import use_chain_fusion, use_conv_tiling
    from repro_torch.kernels import conv2d_direct as k1
    from repro_torch.launch.serve_cnn import build_model

    gxm, image = build_model(smoke=False, device=device)
    check(len(gxm.etg.chains) == 16, f"ResNet-50 has {len(gxm.etg.chains)} "
          f"chains, expected 16")
    x = torch.as_tensor(np.random.default_rng(SEED + 24).standard_normal(
        (BATCH, image, image, 3), dtype=np.float32), device=device)
    print(f"\nchains: ResNet-50 {image}x{image}, batch {BATCH}, phase 3's "
          f"params; {len(gxm.etg.chains)} chains of 3 convs; L2 "
          f"{L2_BYTES / 1e6:.1f} MB")
    out = {"resnet50": {}}
    for tiling in ("tiled", "whole"):
        key = "k1" if tiling == "tiled" else "k10a"
        other = "k10a" if tiling == "tiled" else "k1"
        for label, budget in (("16MiB", None), ("1MiB", CHAIN_PRESSURE)):
            with use_conv_tiling(tiling), chain_budget_forced(budget):
                off, c_off, _ = chain_forward(gxm, serve_params, x, "off")
                on, c_on, ran = chain_forward(gxm, serve_params, x, "on")
                rows = chain_rows(gxm, serve_params, image, ran, tiling)
            del ran
            fused = {r_["name"]: (r_["rb"], r_["bands"]) for r_ in rows
                     if r_["fused"]}
            want = RESNET_PRESSURE_PLAN if budget else {
                r_["name"]: (r_["rb"], 1) for r_ in rows}
            check(fused == want, f"{tiling} {label}: fused chains {fused}, "
                  f"expected the reference's plan {want}")
            launches = 4 + sum(r_["layers"] * (r_["bands"] if r_["fused"]
                                               else 1) for r_ in rows)
            same = bool(torch.equal(on, off))
            print(f"  {tiling}, chain budget {label}: knob on vs off, the "
                  f"same bits {same}; chains fused {c_on['fused']}, unfused "
                  f"{c_on['unfused']}; {key.upper()} launches on "
                  f"{c_on[key]} ({c_on[key + '_mma']} mma), off "
                  f"{c_off[key]} ({c_off[key + '_mma']} mma)")
            _chain_table(rows)
            check(same, f"{tiling} {label}: logits with the chain knob on "
                  f"differ from off by {float((on - off).abs().max()):.3e}")
            check((c_on["fused"], c_on["unfused"]) == (len(fused),
                                                       16 - len(fused)),
                  f"{tiling} {label}: counted {c_on['fused']} fused, "
                  f"{c_on['unfused']} unfused chains")
            check(c_on[key] == c_on[key + "_mma"] == launches
                  and c_off[key] == c_off[key + "_mma"] == 52
                  and c_on[other] == c_off[other] == 0,
                  f"{tiling} {label}: launches on {c_on}, off {c_off}; "
                  f"expected {launches} on, 52 off, all mma")
            out["resnet50"][f"{tiling}_{label}"] = dict(
                same_bits=same, launches_on=c_on[key], launches_off=52,
                chains_fused=c_on["fused"], chains_unfused=c_on["unfused"],
                rows=rows)

    # tiled: off, on, on at 1 MiB, timed in turns, then each traced
    ways = (("off", "off", None), ("on", "on", None),
            ("on_1MiB", "on", CHAIN_PRESSURE))
    times = {name: [] for name, _, _ in ways}
    with use_conv_tiling("tiled"):
        for i in range(CHAIN_TIMED):
            for name, mode, budget in (ways if i % 2 == 0 else ways[::-1]):
                with use_chain_fusion(mode), chain_budget_forced(budget):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    gxm.infer(serve_params, x)
                    torch.cuda.synchronize()
                    times[name].append((time.perf_counter() - t0) * 1e3)
        timing = {}
        for name, mode, budget in ways:
            with use_chain_fusion(mode), chain_budget_forced(budget):
                trace = trace_device(lambda i: gxm.infer(serve_params, x), 3,
                                     {K1_NEEDLE: k1})
            k1_ms = device_ms_of(trace, K1_NEEDLE) + device_ms_of(
                trace, K1_SPLIT_SUM)
            timing[name] = dict(wall_ms=float(np.median(times[name])),
                                walls=times[name],
                                device_ms=trace["device_ms"], k1_ms=k1_ms,
                                other_ms=trace["device_ms"] - k1_ms,
                                busy_share=trace["busy_share"],
                                k1_launches=sum(
                                    n for name_, n in trace["launches"].items()
                                    if K1_NEEDLE in name_) / 3)
            print(f"  tiled forward, chains {name:8s}: wall {timing[name]['wall_ms']:.3f} "
                  f"ms (median of {CHAIN_TIMED}, in turns), device "
                  f"{trace['device_ms']:.4f} ms (K1 {k1_ms:.4f} in "
                  f"{timing[name]['k1_launches']:.0f} launches, the rest "
                  f"{timing[name]['other_ms']:.4f}: the stem, pools, fc, "
                  f"glue and the bands' pad copies), busy share "
                  f"{trace['busy_share'] or 0:.4f}")
    out["resnet50"]["timing"] = timing

    # int8: chains never fuse over w_q
    with use_conv_tiling("tiled"):
        off, c_off, _ = chain_forward(q8_gxm, qparams, x, "off")
        on, c_on, ran = chain_forward(q8_gxm, qparams, x, "on")
    same = bool(torch.equal(on, off))
    print(f"  int8 (phase 6's tree), knob on vs off: the same bits {same}; "
          f"K3 launches on {c_on['k3']} ({c_on['k3_ring']} ring), off "
          f"{c_off['k3']}; chains fused {c_on['fused']}, unfused "
          f"{c_on['unfused']}")
    check(same and not ran and c_on == dict(c_off, unfused=16)
          and c_on["k3"] == c_on["k3_ring"] == 52,
          f"int8 with the chain knob on: same bits {same}, counts on "
          f"{c_on}, off {c_off}")
    out["int8"] = dict(same_bits=same, k3_launches=c_on["k3"],
                       chains_unfused=c_on["unfused"])
    del gxm, off, on, x
    torch.cuda.empty_cache()

    # Inception-v3: 7 chains, the stem chain's first layer on cuDNN
    inc, image = build_model(smoke=False, device=device, arch="inception")
    gen = torch.Generator().manual_seed(SEED + 7)
    params = inc.init(gen)
    random_bn_stats(params, gen)
    x = torch.as_tensor(np.random.default_rng(SEED + 25).standard_normal(
        (BATCH, image, image, 3), dtype=np.float32), device=device)
    check(len(inc.etg.chains) == 7, f"Inception-v3 has {len(inc.etg.chains)}"
          f" chains, expected 7")
    out["inception"] = {}
    for label, budget in (("16MiB", None), ("1MiB", CHAIN_PRESSURE)):
        with use_conv_tiling("tiled"), chain_budget_forced(budget):
            off, c_off, _ = chain_forward(inc, params, x, "off")
            on, c_on, ran = chain_forward(inc, params, x, "on")
            rows = chain_rows(inc, params, image, ran, "tiled")
        del ran
        same = bool(torch.equal(on, off))
        rel = float((on - off).abs().max()) / float(off.abs().max())
        top1 = bool((on.argmax(-1) == off.argmax(-1)).all())
        n_fused = sum(r_["fused"] for r_ in rows)
        print(f"  Inception-v3 {image}x{image}, chain budget {label}: knob on "
              f"vs off, the same bits {same} (max rel {rel:.3e}, limit "
              f"{LOGIT_REL_TOL}), same top-1 {top1}; chains fused "
              f"{c_on['fused']}, unfused {c_on['unfused']}; K1 launches on "
              f"{c_on['k1']} ({c_on['k1_mma']} mma), off {c_off['k1']}")
        _chain_table(rows)
        check(n_fused == (7 if budget is None else 5)
              and c_on["fused"] == n_fused
              and c_on["unfused"] == 7 - n_fused,
              f"Inception-v3 {label}: {n_fused} chains planned fused, "
              f"counted {c_on['fused']} fused, {c_on['unfused']} unfused")
        check(c_on["k1"] == c_on["k1_mma"] and c_off["k1"] == c_off["k1_mma"],
              f"Inception-v3 {label}: a K1 launch left the mma route")
        check(same or (rel <= LOGIT_REL_TOL and top1),
              f"Inception-v3 {label}: logits with the knob on differ from "
              f"off by {rel:.3e} of max |logit| (limit {LOGIT_REL_TOL}), "
              f"same top-1 {top1}")
        out["inception"][label] = dict(same_bits=same, rel=rel, top1=top1,
                                       chains_fused=c_on["fused"], rows=rows)
    del inc, params, x, off, on
    torch.cuda.empty_cache()
    return out


def whole_plan_tuning(device, sigs, fwd, dual, wu, serve_params) -> dict:
    """Phase 24c: the §II-D tuner over the whole-plane blockings, phase
    13b's shape under ``use_conv_tiling("whole")``, into a cache in a
    temporary directory.

    ``CnnInferenceEngine.warmup(autotune="tune")`` tunes "fwd_whole" (f32)
    and "q8_whole" (int8) on ResNet-50's serving signatures at every
    bucket, ``warmup_cnn_train`` "fwd_whole", "bwd_whole" (the 31 distinct
    dual convs) and "wu_whole" (the 22 weight updates) at batch 32: at most
    8 blockings timed a signature, the analytic one among them and kept
    unless another measured ``tune.measure.MIN_GAIN`` faster; K10a and
    K10c on the mma route.  Per signature at batch 16 (serving) and 32
    (training): the tuned launch against its plain version (``plan_row``:
    K10a, K10b <= 1e-5, K10c the same bits), the analytic and tuned
    blockings timed again in turns (the tuned no more than 3 % above the
    analytic); the sums per forward and per step.  Then whole serving
    (f32 and int8, WHOLE_REQUESTS after WHOLE_WARM_REQUESTS) and the whole
    training step, each with the analytic blockings (autotune "off") and
    under "cache", in turns, and once each under the profiler (device ms
    a batch-16 forward and a step, K10a, K10b and K10c's shares)."""
    import numpy as np
    import torch
    from repro_torch import tune
    from repro_torch.backend import use_conv_tiling
    from repro_torch.graph.serving import CnnInferenceEngine
    from repro_torch.kernels import conv2d_direct as k1
    from repro_torch.kernels import conv2d_q8 as k3
    from repro_torch.kernels import conv2d_wu as k2
    from repro_torch.launch.serve_cnn import build_model
    from repro_torch.launch.train_cnn import build_trainer
    from repro_torch.train.step import make_cnn_train_step, warmup_cnn_train
    from repro_torch.tune import measure

    serve_geo: dict[tuple, int] = {}
    for key, count in sigs.items():
        serve_geo[key[:8]] = serve_geo.get(key[:8], 0) + count
    prev = os.environ.get("REPRO_TUNE_CACHE")
    out = {}
    with tempfile.TemporaryDirectory() as tmp, use_conv_tiling("whole"):
        os.environ["REPRO_TUNE_CACHE"] = os.path.join(tmp, "whole.json")
        try:
            cache = tune.default_cache()
            conv_counts(reset=True)
            k2.launches = k2.launches_whole = 0
            measure.measurements = 0
            t0 = time.perf_counter()
            engines = {}
            for quantized in (False, True):
                gxm = build_model(smoke=False, device=device)[0]
                eng = CnnInferenceEngine(gxm, serve_params,
                                         image_hw=(IMAGE, IMAGE),
                                         max_batch=BATCH,
                                         quantized=quantized)
                rep = eng.warmup(autotune="tune")
                engines["int8" if quantized else "f32"] = (eng, rep)
            serve_s = time.perf_counter() - t0
            gxm_t, params_t, step_cache, data = build_trainer(
                full=True, num_classes=1000, image=IMAGE, batch=TRAIN_BATCH,
                lr=TRAIN_LR, device=device, seed=SEED, autotune="cache")
            t1 = time.perf_counter()
            rep_t = warmup_cnn_train(gxm_t, image_hw=(IMAGE, IMAGE),
                                     minibatch=TRAIN_BATCH)
            torch.cuda.synchronize()
            train_s = time.perf_counter() - t1
            c = conv_counts()
            tuning = dict(serve_seconds=serve_s, train_seconds=train_s,
                          timed=measure.measurements, k10a=c["k10a"],
                          k10a_mma=c["k10a_mma"], k10c=c["k10c"],
                          k10c_mma=c["k10c_mma"], k10b=k2.launches_whole,
                          tiled=c["k1"] + c["k3"] + k2.launches,
                          entries=len(cache))
            cached = len({e["key"] for e in rep_t if e["cached"]})
            print(f"\nwhole-plane blockings tuned: serving warmups (f32 "
                  f"'fwd_whole' {engines['f32'][1]['tune_entries']} entries, "
                  f"int8 'q8_whole' {engines['int8'][1]['tune_entries']}, "
                  f"buckets {engines['f32'][1]['buckets']}) in {serve_s:.2f}s,"
                  f" warmup_cnn_train ({cached} distinct blockings of "
                  f"{len(rep_t)} keys) in {train_s:.2f}s; "
                  f"{measure.measurements} candidates timed; launches K10a "
                  f"{c['k10a']} ({c['k10a_mma']} mma), K10c {c['k10c']} "
                  f"({c['k10c_mma']} mma), K10b {k2.launches_whole}; K1, K2, "
                  f"K3 {tuning['tiled']}")
            check(c["k10a"] == c["k10a_mma"] and c["k10c"] == c["k10c_mma"]
                  and tuning["tiled"] == 0, "a whole-plane tuning launch left "
                  "the mma route, or a tiled kernel ran under whole")
            check(cached == len(fwd) + len(dual) + len(wu),
                  f"warmup_cnn_train cached {cached} distinct blockings, "
                  f"expected {len(fwd) + len(dual) + len(wu)}")

            rows = []
            for kind, table, n in (("fwd_whole", serve_geo, BATCH),
                                   ("q8_whole", serve_geo, BATCH),
                                   ("fwd_whole", fwd, TRAIN_BATCH),
                                   ("bwd_whole", dual, TRAIN_BATCH),
                                   ("wu_whole", wu, TRAIN_BATCH)):
                for geo, count in table.items():
                    rows.append(plan_row(kind, geo, n, count, cache))
            print("  per signature: the tuning pass's analytic and tuned "
                  "device us, candidates timed; then both timed again in "
                  "turns (device us)")
            print("  kind       n   h   w    c    k r st count  timed  "
                  "tuning: analytic -> tuned   again: analytic   tuned   "
                  "analytic blocking   tuned")
            for r_ in rows:
                h, w, c_, k, r, s, st, pd = r_["geo"]
                print(f"  {r_['kind']:9s}{r_['n']:3d}{h:4d}{w:4d}{c_:5d}"
                      f"{k:5d}{r:2d}{st:3d}{r_['count']:6d}{r_['timed']:4d}/"
                      f"{r_['candidates']:<4d}{r_['tuning_default_us']:9.2f}"
                      f" ->{r_['tuning_tuned_us']:9.2f}  "
                      f"{r_['default_us']:9.2f}{r_['tuned_us']:9.2f}   "
                      f"{_plan_text(r_['kind'], r_['default']):18s} "
                      f"{'same' if r_['same'] else _plan_text(r_['kind'], r_['plan'])}")

            def total(pick, key):
                return sum(r_[key] * r_["count"] for r_ in rows
                           if pick(r_)) / 1e3
            sums = {}
            for name, pick in (
                    ("forward_f32", lambda r_: r_["kind"] == "fwd_whole"
                     and r_["n"] == BATCH),
                    ("forward_int8", lambda r_: r_["kind"] == "q8_whole"),
                    ("step_forward", lambda r_: r_["kind"] == "fwd_whole"
                     and r_["n"] == TRAIN_BATCH),
                    ("step_dual", lambda r_: r_["kind"] == "bwd_whole"),
                    ("step_wu", lambda r_: r_["kind"] == "wu_whole")):
                sums[name] = dict(analytic_ms=total(pick, "default_us"),
                                  tuned_ms=total(pick, "tuned_us"),
                                  changed=sum(1 for r_ in rows if pick(r_)
                                              and not r_["same"]),
                                  signatures=sum(1 for r_ in rows
                                                 if pick(r_)))
            sums["step"] = {key: sum(sums[p][key] for p in (
                "step_forward", "step_dual", "step_wu"))
                for key in ("analytic_ms", "tuned_ms", "changed",
                            "signatures")}
            for name, v in sums.items():
                print(f"  {name}: analytic {v['analytic_ms']:.4f} ms, tuned "
                      f"{v['tuned_ms']:.4f} ms device (x count); "
                      f"{v['changed']} of {v['signatures']} signatures "
                      f"changed blocking")

            for name in ("f32", "int8"):
                eng, _ = engines[name]
                off = CnnInferenceEngine(eng.gxm, serve_params,
                                         image_hw=(IMAGE, IMAGE),
                                         max_batch=BATCH,
                                         quantized=eng.quantized,
                                         autotune="off")
                off.qparams, off.act_scales = eng.qparams, eng.act_scales
                off.warmup(autotune="off")
                runs = {"off": [], "cache": []}
                for mode in ("off", "cache", "cache", "off"):
                    runs[mode].append(serve_window_timed(
                        off if mode == "off" else eng, f"whole {name} {mode}",
                        requests=WHOLE_REQUESTS,
                        warm_requests=WHOLE_WARM_REQUESTS))
                res = {mode: dict(v[-1], **{key: float(np.mean(
                    [x_[key] for x_ in v])) for key in (
                        "images_per_s", "p50_ms", "p99_ms")},
                    windows=[x_["images_per_s"] for x_ in v])
                    for mode, v in runs.items()}
                key = "k10c" if name == "int8" else "k10a"
                # one batch-16 forward each way under the profiler: the
                # device time the tuned blockings take off a forward
                x = torch.as_tensor(np.random.default_rng(SEED + 26)
                                    .standard_normal((BATCH, IMAGE, IMAGE, 3),
                                                     dtype=np.float32),
                                    device=device)
                needle = "conv2d_q8_whole_kernel" if name == "int8" \
                    else "conv2d_direct_whole_kernel"
                mod = k3 if name == "int8" else k1
                for mode, e in (("off", off), ("cache", eng)):
                    trace = trace_device(
                        lambda i: e.infer(x), 3,
                        {needle: Counter(mod, "launches_whole")})
                    res[mode].update(device_ms=trace["device_ms"],
                                     kernel_ms=device_ms_of(trace, needle),
                                     busy_share=trace["busy_share"],
                                     traced_wall_ms=trace["wall_ms"])
                for mode, v in res.items():
                    print(f"  whole {name} serving, blockings {mode:5s}: "
                          f"images/s {v['images_per_s']:.2f} (windows "
                          f"{', '.join(f'{x_:.2f}' for x_ in v['windows'])})"
                          f"  p50 {v['p50_ms']:.3f} ms  p99 "
                          f"{v['p99_ms']:.3f} ms (means of two); "
                          f"{key.upper()} {v[key]} launches ({v[key + '_mma']}"
                          f" on the mma route), K1 {v['k1']}, K3 {v['k3']}; "
                          f"a traced batch-{BATCH} forward: device "
                          f"{v['device_ms']:.4f} ms ({key.upper()} "
                          f"{v['kernel_ms']:.4f}), busy share "
                          f"{v['busy_share'] or 0:.4f}")
                    check(v[key] == 52 * v["batches"] == v[key + "_mma"]
                          and v["k1"] == v["k3"] == 0,
                          f"whole {name} serving under {mode}: {v}")
                out[f"serving_{name}"] = res
                del off
            engines.clear()
            torch.cuda.empty_cache()

            step_off = make_cnn_train_step(gxm_t, lr=TRAIN_LR,
                                           autotune="off")
            batches = [data.batch_at(i) for i in range(4)]
            batches = [{key: torch.as_tensor(v, device=device)
                        for key, v in b.items()} for b in batches]
            for st_ in (step_off, step_cache):
                for b in batches[:2]:
                    st_(params_t, b)
            times = {"off": [], "cache": []}
            measure.measurements = 0
            pair = (("off", step_off), ("cache", step_cache))
            for i in range(WHOLE_TUNE_STEPS):
                for mode, st_ in (pair if i % 2 == 0 else pair[::-1]):
                    torch.cuda.synchronize()
                    t2 = time.perf_counter()
                    _, loss = st_(params_t, batches[2 + i % 2])
                    torch.cuda.synchronize()
                    times[mode].append((time.perf_counter() - t2) * 1e3)
                    check(math.isfinite(float(loss)), "non-finite loss")
            check(measure.measurements == 0, "a cache step timed candidates")
            traced = {}
            for mode, st_ in pair:
                trace = trace_device(
                    lambda i: st_(params_t, batches[2 + i % 2]), 2,
                    {"conv2d_direct_whole_kernel": Counter(k1,
                                                           "launches_whole"),
                     "conv2d_wu_whole_kernel": Counter(k2, "launches_whole")})
                traced[mode] = dict(
                    wall_ms=trace["wall_ms"], device_ms=trace["device_ms"],
                    busy_share=trace["busy_share"],
                    k10a_ms=device_ms_of(trace, "conv2d_direct_whole_kernel"),
                    k10b_ms=device_ms_of(trace, "conv2d_wu_whole_kernel")
                    + device_ms_of(trace, WU_WHOLE_SUM))
            conv_counts(reset=True)
            k2.launches = k2.launches_whole = 0
            step_cache(params_t, batches[2])
            torch.cuda.synchronize()
            c = conv_counts()
            counts = dict(k10a=c["k10a"], k10a_mma=c["k10a_mma"],
                          k10b=k2.launches_whole, k1=c["k1"], k2=k2.launches)
            check(counts == dict(k10a=113, k10a_mma=113, k10b=52, k1=0, k2=0),
                  f"one whole cache step launched {counts}")
            train = {mode: float(np.median(v)) for mode, v in times.items()}
            for mode in ("off", "cache"):
                print(f"  whole training, blockings {mode:5s}: "
                      f"{train[mode]:.3f} ms a step (median of "
                      f"{WHOLE_TUNE_STEPS}, in turns), "
                      f"{TRAIN_BATCH / train[mode] * 1e3:.2f} images/s; "
                      f"traced: device {traced[mode]['device_ms']:.3f} ms a "
                      f"step (K10a {traced[mode]['k10a_ms']:.3f}, K10b "
                      f"{traced[mode]['k10b_ms']:.3f}), busy share "
                      f"{traced[mode]['busy_share'] or 0:.4f}")
            print(f"  one cache step: K10a {counts['k10a']} "
                  f"({counts['k10a_mma']} mma), K10b {counts['k10b']}, K1 "
                  f"{counts['k1']}, K2 {counts['k2']}")
            out["training"] = dict(step_ms=train, steps=times, counts=counts,
                                   traced=traced)
        finally:
            if prev is None:
                del os.environ["REPRO_TUNE_CACHE"]
            else:
                os.environ["REPRO_TUNE_CACHE"] = prev
    out.update(tuning=tuning, sums=sums, rows=rows)
    print("  per-signature JSON:", json.dumps(rows))
    return out


def whole_wu(device, wu, wu_rows):
    """Phase 25: K10b against its plain version and K2 on the 22 weight-
    update signatures at batch 32, b_p from the reference's
    ``conv_blocking(require_divisor=True, kind="wu")``; twice on the same
    inputs, which must give the same bits; each signature's split
    (``plan_whole``: splits, steps a run, blocks) beside its time, whose
    device part holds both of K10b's kernels (the split one and the sum
    pass, WU_WHOLE_SUM)."""
    import torch
    from repro_torch.core.conv import whole_blocking
    from repro_torch.kernels import conv2d_wu as k2

    gen = torch.Generator(device=device).manual_seed(SEED + 25)
    k2_by = {_sig(r): r for r in wu_rows}
    needle = "conv2d_wu_whole_kernel"
    counter = Counter(k2, "launches_whole")
    rows = []
    print(f"\nK10b vs plain and K2, ResNet-50 {IMAGE}x{IMAGE} batch "
          f"{TRAIN_BATCH} ({len(wu)} signatures), the reference's b_p | P "
          f"blocking; library = cuDNN dW (phase 9):")
    print("  h   w    c    k r st pad count  b_p k_blk tile splits run "
          "blocks  max_rel   vs_k2  same       ev      dev  plain_ms   k2_ms "
          "library_ms bound_ms")
    for (h, w, c, k, r, s, st, pad), count in wu.items():
        p = (h + 2 * pad - r) // st + 1
        q = (w + 2 * pad - s) // st + 1
        x = torch.randn((TRAIN_BATCH, h, w, c), generator=gen, device=device)
        do = torch.randn((TRAIN_BATCH, p, q, k), generator=gen,
                         device=device)
        args = dict(x=x, do=do, stride=st, padding=pad, filter_rs=(r, s))
        blk = whole_blocking(x.shape, (r, s, c, k), stride=st, padding=pad,
                             kind="wu")
        bk = dict(b_p=blk.rb_p, k_blk=blk.k_blk)
        out = k2.conv2d_wu_whole(**args, **bk)
        again = k2.conv2d_wu_whole(**args, **bk)
        plain = k2.conv2d_wu_whole_plain(**args, **bk)
        tiled = k2.conv2d_wu(**args)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(out).all()), f"K10b non-finite at "
              f"{h, c, k}")
        scale = float(plain.abs().max())
        max_abs = float((out - plain).abs().max())
        max_rel = max_abs / scale
        k2_rel = float((out - tiled).abs().max()) / scale
        same = bool(torch.equal(out, again))
        ms = auto_ms(lambda: k2.conv2d_wu_whole(**args, **bk))
        dev = None if ms > TRACE_MAX_MS else kernel_device_ms(
            lambda: k2.conv2d_wu_whole(**args, **bk), needle, counter,
            also=(WU_WHOLE_SUM,))[0]
        plain_ms = cuda_ms(lambda: k2.conv2d_wu_whole_plain(**args, **bk), 2)
        ref = k2_by[(h, w, c, k, r, s, st, pad, ())]
        pl = k2.plan_whole(n=TRAIN_BATCH, p=p, q=q, c=c, k=k, r=r, s=s,
                           **bk)
        tile, blocks = pl.tile, pl.blocks
        rows.append(dict(h=h, w=w, c=c, k=k, r=r, s=s, stride=st,
                         padding=pad, count=count, b_p=blk.rb_p,
                         k_blk=blk.k_blk, tile=tile, splits=pl.splits,
                         run=pl.run, blocks=blocks,
                         max_abs_err=max_abs, max_rel_err=max_rel,
                         k2_rel_err=k2_rel, same_bits=same, ms=ms,
                         device_ms=dev, plain_ms=plain_ms, k2_ms=ref["ms"],
                         library_ms=ref["library_ms"],
                         bound_ms=ref["bound_ms"], bound_by=ref["bound_by"]))
        dev_s = "     n/a" if dev is None else f"{dev:8.4f}"
        print(f"{h:3d}{w:4d}{c:5d}{k:5d}{r:2d}{st:3d}{pad:4d}{count:6d}"
              f"{blk.rb_p:5d}{blk.k_blk:6d}{tile:5d}{pl.splits:7d}"
              f"{pl.run:4d}{blocks:7d}  "
              f"{max_rel:.2e} {k2_rel:.1e} {same!s:5s} {ms:8.4f} {dev_s} "
              f"{plain_ms:9.4f} {ref['ms']:7.4f} {ref['library_ms']:10.4f} "
              f"{ref['bound_ms']:8.4f}")
        check(max_rel <= KERNEL_REL_TOL,
              f"K10b disagrees with its plain version at {(h, c, k, r, st)}: "
              f"max_rel {max_rel:.3e} > {KERNEL_REL_TOL}")
        check(same, f"K10b gave other bits on a second run at {(h, c, k)}")
        del x, do, args, out, again, plain, tiled
    print("  per-signature JSON:", json.dumps(rows))
    return rows


def whole_training(device, fwd, dual, wu, tiled_summary):
    """Phase 26: full ResNet-50 training under ``whole`` at batch 32: one
    untimed step, then WHOLE_TRAIN_STEPS timed steps, each with the launch
    counts set to 0 just before it and read just after (K10a = 52 forward +
    61 dual, K10b = 52, K1 and K2 none), beside phase 10's step; 2 steps
    under the profiler.  Returns (launch counts of one step, summary)."""
    import numpy as np
    import torch
    from repro_torch.backend import use_conv_tiling
    from repro_torch.kernels import conv2d_direct as k1
    from repro_torch.kernels import conv2d_wu as k2
    from repro_torch.launch.train_cnn import build_trainer
    from repro_torch.train.step import to_device

    gxm, params, step, data = build_trainer(
        full=True, num_classes=1000, image=IMAGE, batch=TRAIN_BATCH,
        lr=TRAIN_LR, device=device, seed=SEED)
    batches = [to_device(data.batch_at(i), device)
               for i in range(1 + WHOLE_TRAIN_STEPS + 3)]
    torch.cuda.synchronize()
    expect = {"conv2d_direct_whole": sum(fwd.values()) + sum(dual.values()),
              "conv2d_direct_whole_mma": sum(fwd.values())
              + sum(dual.values()),
              "conv2d_wu_whole": sum(wu.values()), "conv2d_direct": 0,
              "conv2d_wu": 0}
    print(f"\nwhole-plane training: ResNet-50 {IMAGE}x{IMAGE}, 1000 classes, "
          f"batch {TRAIN_BATCH}, lr {TRAIN_LR}, under whole")
    losses, times = [], []
    with use_conv_tiling("whole"):
        t0 = time.perf_counter()
        params, loss = step(params, batches[0])
        losses.append(float(loss))
        print(f"  1 untimed step in {time.perf_counter() - t0:.2f}s")
        for batch in batches[1:1 + WHOLE_TRAIN_STEPS]:
            torch.cuda.synchronize()
            k1.launches = k1.launches_whole = k1.launches_whole_mma = 0
            k2.launches = k2.launches_whole = 0
            t1 = time.perf_counter()
            params, loss = step(params, batch)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t1) * 1e3)
            counts = {"conv2d_direct_whole": k1.launches_whole,
                      "conv2d_direct_whole_mma": k1.launches_whole_mma,
                      "conv2d_wu_whole": k2.launches_whole,
                      "conv2d_direct": k1.launches,
                      "conv2d_wu": k2.launches}
            losses.append(float(loss))
            check(counts == expect, f"launches in a whole-plane step "
                  f"{counts}, expected {expect}")
        # the CTA-floor question at the step: every reference block whole,
        # and every one cut across CTAs where whole_slices cuts it
        floor = {}
        for split in (False, True):
            with whole_split_forced(split):
                split_times = []
                for batch in batches[1:1 + WHOLE_TRAIN_STEPS]:
                    torch.cuda.synchronize()
                    t1 = time.perf_counter()
                    step(params, batch)
                    torch.cuda.synchronize()
                    split_times.append((time.perf_counter() - t1) * 1e3)
            floor["split" if split else "unsplit"] = split_times
        trace = trace_device(
            lambda i: step(params, batches[1 + WHOLE_TRAIN_STEPS + i]), 2,
            {"conv2d_direct_whole_kernel": Counter(k1, "launches_whole"),
             "conv2d_wu_whole_kernel": Counter(k2, "launches_whole")})
    step_ms = float(np.median(times))
    check(all(math.isfinite(v) for v in losses), f"non-finite loss {losses}")
    prof = dict(wall_ms_per_step=trace["wall_ms"],
                device_ms_per_step=trace["device_ms"],
                device_busy_share=trace["busy_share"],
                k10a_ms_per_step=device_ms_of(trace,
                                              "conv2d_direct_whole_kernel"),
                k10b_ms_per_step=device_ms_of(trace, "conv2d_wu_whole_kernel")
                + device_ms_of(trace, WU_WHOLE_SUM))
    print(f"  {WHOLE_TRAIN_STEPS} timed steps: median {step_ms:.3f} ms/step "
          f"({[round(t, 3) for t in times]}), "
          f"{TRAIN_BATCH / step_ms * 1e3:.2f} images/s; tiled (phase 10) "
          f"{tiled_summary['step_ms']:.3f} ms/step, "
          f"{tiled_summary['images_per_s']:.2f} images/s")
    print(f"  launches in each timed step: {counts}")
    for side, side_times in floor.items():
        print(f"  K10a {side} everywhere: median "
              f"{float(np.median(side_times)):.3f} ms/step "
              f"({[round(t, 3) for t in side_times]})")
    print(f"  losses {[round(v, 4) for v in losses]}")
    busy = "n/a" if prof["device_busy_share"] is None else \
        f"{prof['device_busy_share']:.4f}"
    print(f"  profile of 2 steps: {prof['wall_ms_per_step']:.3f} ms/step host "
          f"clock, device {prof['device_ms_per_step']:.3f} ms/step (K10a "
          f"{prof['k10a_ms_per_step']:.3f}, K10b "
          f"{prof['k10b_ms_per_step']:.3f}), busy share {busy}")
    return counts, dict(step_ms=step_ms, step_times_ms=times,
                        images_per_s=TRAIN_BATCH / step_ms * 1e3,
                        losses=losses, profile=prof,
                        floor={side: float(np.median(t))
                               for side, t in floor.items()})


def pool_phase(device):
    """Phase 27: K5's entry point at the stem pool (16, 112, 112, 64) f32,
    3x3 s2 p1, and on the reference test's three cases, with the launch
    count set to 0 just before those four calls and read just after; then
    each against its plain version and ``F.max_pool2d`` (max |diff| 0), and
    the times of K5, the plain version and ``F.max_pool2d`` at the stem
    pool against the bytes bound.  Returns (record, K5 launches in the four
    calls)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import pool2d as k5

    gen = torch.Generator(device=device).manual_seed(SEED + 27)

    def library(x, window=3, stride=2, pad=1):
        return F.max_pool2d(x.permute(0, 3, 1, 2), window, stride,
                            pad).permute(0, 2, 3, 1)

    x = torch.randn(POOL_SHAPE, generator=gen, device=device)
    cases = [(case, torch.randn((2, case[3], case[3], 8), generator=gen,
                                device=device)) for case in POOL_CASES]
    k5.launches = 0
    out = k5.maxpool2d(x)
    outs = [k5.maxpool2d(xs, window=window, stride=stride, padding=pad)
            for (window, stride, pad, _), xs in cases]
    torch.cuda.synchronize()
    launches = k5.launches
    check(launches == 1 + len(POOL_CASES),
          f"K5 launched {launches} times in {1 + len(POOL_CASES)} calls")
    vs_plain = float((out - k5.maxpool2d_plain(x)).abs().max())
    vs_lib = float((out - library(x)).abs().max())
    ms = cuda_ms(lambda: k5.maxpool2d(x), 100)
    dev = kernel_device_ms(lambda: k5.maxpool2d(x), "maxpool2d_kernel", k5,
                           20)[0]
    plain_ms = cuda_ms(lambda: k5.maxpool2d_plain(x), 10)
    library_ms = cuda_ms(lambda: library(x), 100)
    nbytes = 4.0 * (x.numel() + out.numel())
    bound_ms, bound_by = bound(9.0 * out.numel(), nbytes)
    print(f"\nK5 vs plain and F.max_pool2d at the stem pool {POOL_SHAPE} f32, "
          f"3x3 s2 p1: max |diff| {vs_plain} and {vs_lib}; K5 {ms:.4f} ms by "
          f"events, {dev:.4f} device; plain {plain_ms:.4f}; F.max_pool2d "
          f"{library_ms:.4f}; bound {bound_ms:.4f} ms ({bound_by}: "
          f"{nbytes / 1e6:.1f} MB read once and written once), "
          f"{nbytes / dev / 1e6:.1f} GB/s by device time")
    check(vs_plain == 0.0 and vs_lib == 0.0,
          f"K5 differs at the stem pool: {vs_plain} from plain, {vs_lib} "
          f"from F.max_pool2d")
    for ((window, stride, pad, h), xs), got in zip(cases, outs):
        ok = bool(torch.equal(got, k5.maxpool2d_plain(
            xs, window=window, stride=stride, padding=pad))) and \
            bool(torch.equal(got, library(xs, window, stride, pad)))
        print(f"  case window {window} stride {stride} pad {pad} (2, {h}, "
              f"{h}, 8): equal to plain and F.max_pool2d: {ok}")
        check(ok, f"K5 differs on the case {(window, stride, pad, h)}")
    return dict(shape=list(POOL_SHAPE), max_abs_err=max(vs_plain, vs_lib),
                ms=ms, device_ms=dev, plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=bound_ms,
                bound_by=bound_by), launches


# ---------------------------------------------------------------------------
# Phases 28-30: LM training on the card (K7's backward) and RWKV-6
# ---------------------------------------------------------------------------

TRAIN_ARCH = "qwen2-1.5b"
TRAIN_WIDTHS = (28, 1536, 12, 2, 128, 8960, 151936, "bfloat16")
TRAIN_LM_BATCH = (8, 512)       # sequences x tokens of phase 29's batch
TRAIN_LM_STEPS = 5              # timed steps, after one untimed
TRAIN_LM_LR = 3e-4
TRAIN_PARITY_BATCH = (4, 128)
# the SGD parity steps' learning rate: at 3e-4 an update moves a param of
# 0.1 by about 40 f32 ulps, so the rounding of p - lr g alone would read
# 2.5 % of an update; at 1.0 it reads under 1e-6
PARITY_LR = 1.0
# routing decisions of the card's step that the CPU's may override: near-
# ties only (phase 31's f32 Jamba and Phi-3.5-MoE steps overrode none of
# their 768 and 1024)
PIN_MAX_OVERRIDDEN = 2
TRAIN_PARITY = dict(n_layers=2, vocab=1024, d_head=64, dtype="float32")
# K7's backward: b, hq, hkv, l, dh, causal
BWD_SHAPES = [(8, 12, 2, 512, 128, True),    # Qwen2-1.5B's training shape
              (8, 15, 5, 512, 64, True),     # SmolLM-360M's
              (2, 12, 2, 333, 128, True),    # a tail
              (1, 12, 2, 512, 128, False),   # non-causal
              (8, 4, 2, 128, 16, True)]      # the smoke configs' Dh 16
K7_BWD_NEEDLE = "flash_attention_bwd_dkdv"   # one a call on either route
K7_BWD_DQ = "flash_attention_bwd_dq"         # the dq kernel, either route
K7_BWD_SUM = "flash_attention_bwd_split_sum"  # the wgmma route's split sum
RWKV_ARCH = "rwkv6-1.6b"
RWKV_WIDTHS = (24, 2048, 32, 32, 64, 7168, 65536, "bfloat16")
RWKV_REQUESTS = 16
RWKV_PROMPT_LEN = (128, 512)
RWKV_PARITY = dict(n_layers=2, d_model=1024, n_heads=16, n_kv_heads=16,
                   d_head=64, d_ff=3584, vocab=1024, dtype="float32")
RWKV_PARITY_PROMPTS = [(2, 100)]    # a chunk of 64 tokens and a ragged one
RWKV_TRAIN_BATCH = (2, 96)


class _BwdCount:
    """K7's backward counter (``attention.launches_bwd``) under the name
    ``trace_device`` reads."""

    @property
    def launches(self):
        from repro_torch.kernels import attention as k7
        return k7.launches_bwd


K7_BWD = _BwdCount()


class Sgd:
    """Plain SGD (p -= lr g, in place), the optimizer of the card-vs-CPU
    step parities: an update linear in the gradient, so "updates within
    1e-3 * max |CPU update|" means what it means for phase 11's SGD step.
    AdamW divides each element by its own gradient's size, which turns the
    rounding of a nearly cancelling gradient (Qwen2's key bias, added
    before RoPE at theta 1e6; RWKV's group norm near zero variance) into
    updates of either sign; its step is printed beside, not held
    (PERF.md section 2)."""

    def init(self, params) -> dict:
        return {}

    def update(self, grads, state, params, lr):
        import torch
        from repro_torch.optim.adamw import tree_map
        with torch.no_grad():
            tree_map(lambda g, p: p.sub_(lr * g.float()), grads, params)
        return params, state


def _bwd_device(run) -> dict:
    """Device ms per call of K7's backward by profiler (``trace_device``,
    its dk/dv kernel's records held to ``launches_bwd``): all its kernels,
    and the dq, dk/dv and split-sum kernels apart."""
    trace = trace_device(lambda i: run(), 5, {K7_BWD_NEEDLE: K7_BWD},
                         sync_each=True)
    parts = {key: device_ms_of(trace, needle) for key, needle in (
        ("dq_ms", K7_BWD_DQ), ("dkdv_ms", K7_BWD_NEEDLE),
        ("sum_ms", K7_BWD_SUM))}
    recorded = sum(n for name, n in trace["launches"].items()
                   if K7_BWD_NEEDLE in name)
    return dict(device_ms=sum(parts.values()), traced_launches=recorded,
                **parts)


def attention_bwd_signatures(device):
    """Phase 28: K7's backward (``flash_attention_bwd``) against
    ``flash_attention_bwd_plain`` at BWD_SHAPES in f32 and bf16: each row's
    route (``route_bwd``, held: bf16 at Dh 64/128 on wgmma, the rest on
    SIMT) and, on wgmma, its plan; the call made as training makes it,
    with the forward's lse on the wgmma route; max |diff| / max |plain| of
    dq, dk and dv (<= 1e-5 f32, <= 1e-2 bf16), the same bits on a second
    call, CUDA-event and profiler device times (every kernel of a call, and
    the dq, dk/dv and split-sum kernels apart), the plain version's time,
    the library yardstick (the backward of ``F.scaled_dot_product_attention``
    with K and V expanded to Hq heads; used only here) and the bounds: the
    FLOPs (10 Dh per unmasked (query, key) pair and query head) at the bf16
    tensor cores' 989 TFLOP/s and at the SIMT cores' 67, or the bytes.  At
    each wgmma shape, also by device time and each held to the same limit
    and to the same bits twice: the dk/dv kernel unsplit where the plan
    splits, the dq kernel rebuilding lse (none given) and the SIMT route
    forced."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import attention as k7
    from repro_torch.launch import roofline

    gen = torch.Generator(device=device).manual_seed(SEED + 28)
    rows = []
    print(f"\nK7 backward vs plain ({len(BWD_SHAPES)} shapes x f32, bf16; "
          f"limits {KERNEL_REL_TOL} f32, {BF16_REL_TOL} bf16 of max |plain| "
          f"on each of dq, dk, dv; route by route_bwd, the wgmma route with "
          f"the forward's lse; device ms: dq + dk/dv + split sum):")
    print("  dtype     b  hq hkv    l  dh causal route plan     dq_rel   "
          "dk_rel   dv_rel  same      ms  device_ms (dq, dkdv, sum)   "
          "plain_ms  sdpa_bwd_ms  bound_bf16  bound_simt")
    for dtype in (torch.float32, torch.bfloat16):
        for b, hq, hkv, l, dh, causal in BWD_SHAPES:
            def rnd(*shape):
                return torch.randn(shape, generator=gen,
                                   device=device).to(dtype)
            q, k, v = rnd(b, hq, l, dh), rnd(b, hkv, l, dh), rnd(b, hkv, l, dh)
            do = rnd(b, hq, l, dh)
            tol = KERNEL_REL_TOL if dtype == torch.float32 else BF16_REL_TOL
            path = k7.route_bwd(q, k, v)
            want = ("wgmma" if dtype == torch.bfloat16
                    and dh in k7.WGMMA_HEAD_DIMS else "simt")
            check(path == want, f"K7's backward takes the {path} route at "
                  f"{(b, hq, hkv, l, dh)} {dtype}, expected {want}")
            if path == "wgmma":
                o, lse = k7._launch_forward(q, k, v, causal, dh ** -0.5,
                                            want_lse=True)
            else:
                o, lse = k7.flash_attention(q, k, v, causal=causal), None
            plan = k7.wgmma_bwd_plan(b, hq, hkv, l, dh) \
                if path == "wgmma" else None
            plain = k7.flash_attention_bwd_plain(q, k, v, o, do,
                                                 causal=causal)
            shape = (b, hq, hkv, l, dh, causal, str(dtype))

            def held(run, what):
                """Two calls: their errors against plain (held to the
                limit) and whether their bits agree (held)."""
                got, again = run(), run()
                torch.cuda.synchronize()
                rels = [rel_err(g.float(), p_.float())[1]
                        for g, p_ in zip(got, plain)]
                abss = [rel_err(g.float(), p_.float())[0]
                        for g, p_ in zip(got, plain)]
                same = all(bool(torch.equal(a, a2))
                           for a, a2 in zip(got, again))
                check(all(bool(torch.isfinite(g).all()) for g in got),
                      f"K7 backward ({what}) non-finite at {shape}")
                check(same, f"K7 backward ({what}) gave other bits on a "
                      f"second call at {shape}")
                check(max(rels) <= tol, f"K7 backward ({what}) disagrees "
                      f"with its plain version at {shape}: {rels} > {tol}")
                return rels, abss, same

            def run():
                return k7.flash_attention_bwd(q, k, v, o, do, causal=causal,
                                              lse=lse)
            before = (k7.launches_bwd, k7.launches_bwd_wgmma)
            rels, abss, same = held(run, path)
            check((k7.launches_bwd - before[0],
                   k7.launches_bwd_wgmma - before[1])
                  == (2, 2 if path == "wgmma" else 0),
                  f"{k7.launches_bwd - before[0]} backward launches "
                  f"({k7.launches_bwd_wgmma - before[1]} wgmma) for 2 "
                  f"{path} calls")
            ms = auto_ms(run)
            dev = _bwd_device(run)
            variants = {}
            if path == "wgmma":
                if plan > 1:
                    with returning(k7, "wgmma_bwd_plan", 1):
                        held(run, "unsplit")
                        variants["unsplit"] = dict(plan=1,
                                                   **_bwd_device(run))

                def run_no_lse():
                    return k7.flash_attention_bwd(q, k, v, o, do,
                                                  causal=causal)
                held(run_no_lse, "no lse")
                variants["no_lse"] = _bwd_device(run_no_lse)
                with returning(k7, "route_bwd", "simt"):
                    held(run, "simt forced")
                    variants["simt"] = _bwd_device(run)
            plain_ms = auto_ms(lambda: k7.flash_attention_bwd_plain(
                q, k, v, o, do, causal=causal), 30.0)
            rep = hq // hkv
            leaves = [q.detach().requires_grad_(),
                      k.repeat_interleave(rep, 1).requires_grad_(),
                      v.repeat_interleave(rep, 1).requires_grad_()]
            lib_out = F.scaled_dot_product_attention(*leaves,
                                                     is_causal=causal)
            library_ms = auto_ms(lambda: torch.autograd.grad(
                lib_out, leaves, do, retain_graph=True))
            library_device_ms = trace_device(
                lambda i: torch.autograd.grad(lib_out, leaves, do,
                                              retain_graph=True), 5, {},
                sync_each=True)["device_ms"]
            pairs = l * (l + 1) / 2 if causal else float(l * l)
            flops = 10.0 * dh * pairs * b * hq
            nbytes = q.element_size() * (4 * b * hq + 4 * b * hkv) * l * dh
            bound_ms, bound_by = roofline.bound_ms(
                flops, nbytes, roofline.BF16_PEAK_FLOPS)
            simt_ms, simt_by = roofline.bound_ms(flops, nbytes,
                                                 roofline.F32_PEAK_FLOPS)
            rec = dict(dtype=str(dtype).removeprefix("torch."), b=b, hq=hq,
                       hkv=hkv, l=l, dh=dh, causal=causal, route=path,
                       plan=plan,
                       lse_given=lse is not None,
                       rel_err=dict(zip(("dq", "dk", "dv"), rels)),
                       max_rel_err=max(rels), max_abs_err=max(abss),
                       same_bits=same, ms=ms, **dev,
                       plain_ms=plain_ms, library_ms=library_ms,
                       library_device_ms=library_device_ms,
                       bound_ms=bound_ms, bound_by=bound_by,
                       simt_bound_ms=simt_ms, simt_bound_by=simt_by,
                       flops=flops, tflops=flops / dev["device_ms"] / 1e9,
                       variants=variants)
            rows.append(rec)
            plan_s = str(plan) if plan else "-"
            print(f"  {rec['dtype']:8s}{b:2d}{hq:4d}{hkv:4d}{l:5d}{dh:4d} "
                  f"{causal!s:6s} {path:5s} {plan_s:6s} {rels[0]:.2e} "
                  f"{rels[1]:.2e} {rels[2]:.2e} {same!s:5s} {ms:8.4f} "
                  f"{dev['device_ms']:10.4f} ({dev['dq_ms']:.4f}, "
                  f"{dev['dkdv_ms']:.4f}, {dev['sum_ms']:.4f}) "
                  f"{plain_ms:10.4f} {library_ms:12.4f} {bound_ms:11.4f} "
                  f"{simt_ms:11.4f}  ({rec['tflops']:.2f} TFLOP/s by "
                  f"device time; {dev['traced_launches']} of 5 calls traced; "
                  f"SDPA backward device {library_device_ms:.4f} ms)")
            for name, var in variants.items():
                print(f"      {name:8s} device {var['device_ms']:.4f} ms (dq "
                      f"{var['dq_ms']:.4f}, dk/dv {var['dkdv_ms']:.4f}, sum "
                      f"{var['sum_ms']:.4f})"
                      + (f", plan {var['plan']}" if "plan" in var else "")
                      + "; within the limit, the same bits twice")
            del q, k, v, do, o, lse, plain, leaves, lib_out
    print("  per-shape JSON:", json.dumps(rows))
    return rows


def _attention_grads_seen(cfg, seen):
    """An ``AdamW.update`` stand-in that records, in its first call, for
    each attention position's wq, wk and wv gradient whether each layer's
    slice holds a nonzero, then updates as ever."""
    from repro_torch.optim.adamw import AdamW
    update = AdamW.update

    def recording(self, grads, state, params, lr):
        if not seen:
            for pos, (mixer, _) in enumerate(cfg.block_pattern):
                if mixer != "attn":
                    continue
                for name in ("wq", "wk", "wv"):
                    g = grads["blocks"][str(pos)]["mixer"][name]
                    seen[f"{pos}/{name}"] = (
                        g.float().flatten(1).abs().amax(1) > 0).tolist()
        return update(self, grads, state, params, lr)
    return recording


def lm_training(device):
    """Phase 29, this slice's main path: ``qwen2-1.5b`` (bf16, uncut,
    ``cfg.remat`` as configured) through ``launch.train.build`` (AdamW with
    f32 state, clip 1.0) on a batch of TRAIN_LM_BATCH ``SyntheticLMData``
    tokens: one untimed step (every attention layer's wq, wk and wv
    gradient must hold a nonzero), then TRAIN_LM_STEPS timed steps on the
    same batch with K7's counts set to 0 just before and read just after
    (K7 forward 28 a step, twice that under remat, which runs each forward
    again in the backward; K7's backward 28), step ms (p50, max), tokens/s
    and the loss of each step (finite, the last below the first); one step
    under the profiler (K7's and its backward's recorded launches held to
    the counts; device time by kernel, grouped into attention, matmuls and
    the rest; the busy share) and the peak memory.  Returns (K7 forward and
    backward launches in the timed steps, summary)."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLMData
    from repro_torch.kernels import attention as k7
    from repro_torch.launch.train import build
    from repro_torch.optim.adamw import AdamW

    cfg = get_config(TRAIN_ARCH)
    check((cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
           cfg.head_dim, cfg.d_ff, cfg.vocab, cfg.dtype) == TRAIN_WIDTHS,
          f"{TRAIN_ARCH} does not have the widths {TRAIN_WIDTHS}")
    b, l = TRAIN_LM_BATCH
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, step = build(cfg, lr=TRAIN_LM_LR, seed=SEED, device=device)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(state["params"]))
    print(f"\nLM training: {cfg.name}, {n_params / 1e9:.3f} B params in "
          f"{cfg.dtype}, remat {cfg.remat}, AdamW f32 state, clip 1.0, lr "
          f"{TRAIN_LM_LR}; batch {b} x {l} SyntheticLMData tokens; built in "
          f"{time.perf_counter() - t0:.1f}s")
    batch = SyntheticLMData(cfg.vocab, l, b, seed=SEED).batch_at(0)
    seen = {}
    update = AdamW.update
    AdamW.update = _attention_grads_seen(cfg, seen)
    try:
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        first_loss = float(metrics["loss"])
    finally:
        AdamW.update = update
    print(f"  untimed step: loss {first_loss:.4f}, grad norm "
          f"{float(metrics['grad_norm']):.4f}, "
          f"{(time.perf_counter() - t0) * 1e3:.1f} ms")
    layers = cfg.pattern_repeats
    zero = {name: [i for i, nz in enumerate(flags) if not nz]
            for name, flags in seen.items()}
    print(f"  first step's attention gradients: wq, wk, wv of "
          f"{len(seen) // 3} position(s) x {layers} layers, layers with an "
          f"all-zero gradient: "
          f"{ {name: z for name, z in zero.items() if z} or 'none'}")
    check(len(seen) == 3 and all(len(f) == layers for f in seen.values())
          and not any(zero.values()), f"an attention layer's wq, wk or wv "
          f"gradient is all zero in the first step: {zero}")
    per_fwd = 28 * (2 if cfg.remat else 1)
    k7.launches = k7.launches_bwd = k7.launches_wgmma = 0
    k7.launches_bwd_wgmma = 0
    losses, step_ms = [], []
    for _ in range(TRAIN_LM_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    fwd, bwd, fwd_wgmma = k7.launches, k7.launches_bwd, k7.launches_wgmma
    bwd_wgmma = k7.launches_bwd_wgmma
    p50 = float(np.median(step_ms))
    print(f"  {TRAIN_LM_STEPS} timed steps: p50 {p50:.3f} ms, max "
          f"{max(step_ms):.3f} ms ({[f'{x:.1f}' for x in step_ms]}); "
          f"{b * l / p50 * 1e3:.0f} tokens/s; losses "
          f"{[f'{x:.4f}' for x in losses]}")
    print(f"  K7 launches in the timed steps: {fwd} forward ({fwd_wgmma} "
          f"through wgmma; expected {per_fwd} x {TRAIN_LM_STEPS}), {bwd} "
          f"backward ({bwd_wgmma} through wgmma; expected 28 x "
          f"{TRAIN_LM_STEPS})")
    check(fwd == fwd_wgmma == per_fwd * TRAIN_LM_STEPS,
          f"K7 launched {fwd} times ({fwd_wgmma} wgmma) in "
          f"{TRAIN_LM_STEPS} steps, expected {per_fwd} a step")
    check(bwd == bwd_wgmma == 28 * TRAIN_LM_STEPS, f"K7's backward launched "
          f"{bwd} times ({bwd_wgmma} wgmma) in {TRAIN_LM_STEPS} steps, "
          f"expected 28 a step, all on the wgmma route")
    check(all(math.isfinite(x) for x in losses), f"non-finite loss {losses}")
    check(losses[-1] < losses[0], f"the loss did not fall over "
          f"{TRAIN_LM_STEPS} steps on one batch: {losses}")
    trace = trace_device(lambda i: step(state, batch), 1,
                         {"flash_attention_kernel": k7,
                          K7_BWD_NEEDLE: K7_BWD})
    bwd_ms = device_ms_of(trace, "flash_attention_bwd_")
    fwd_ms = device_ms_of(trace, "flash_attention_kernel")
    gemm_ms = sum(ms for ms, _, name in trace["by_name"]
                  if any(key in name.lower() for key in (
                      "gemm", "xmma", "nvjet", "cutlass", "sm90_")))
    device_ms = trace["device_ms"]
    peak = torch.cuda.max_memory_allocated()
    rest_ms = device_ms - bwd_ms - fwd_ms - gemm_ms
    print(f"  profile of one step: {trace['wall_ms']:.3f} ms by host clock, "
          f"device {device_ms:.3f} ms in "
          f"{sum(trace['launches'].values())} kernel launches, busy "
          f"{trace['busy_share']:.4f}; K7 backward {bwd_ms:.3f} ms (28 "
          f"calls), K7 forward {fwd_ms:.3f} ms, matmuls (cuBLAS) "
          f"{gemm_ms:.3f} ms, the rest {rest_ms:.3f} ms; "
          f"torch.cuda.max_memory_allocated {peak / 1e9:.3f} GB")
    for ms, n, name in trace["by_name"][:12]:
        print(f"    {ms:9.3f} ms  x{n:6.1f}  {name[:100]}")
    summary = dict(
        arch=cfg.name, params=n_params, remat=cfg.remat, batch=b, tokens=l,
        lr=TRAIN_LM_LR, first_step_loss=first_loss, losses=losses,
        step_ms=step_ms, step_p50_ms=p50, step_max_ms=max(step_ms),
        tokens_per_s=b * l / p50 * 1e3,
        k7_launches_per_step=fwd / TRAIN_LM_STEPS,
        k7_bwd_launches_per_step=bwd / TRAIN_LM_STEPS,
        k7_bwd_wgmma_launches=bwd_wgmma,
        attention_grads_nonzero=seen,
        profile=dict(wall_ms=trace["wall_ms"], device_ms=device_ms,
                     busy_share=trace["busy_share"], k7_bwd_ms=bwd_ms,
                     k7_fwd_ms=fwd_ms, matmul_ms=gemm_ms,
                     rest_ms=rest_ms,
                     top=[dict(ms=ms, launches=n, name=name[:120])
                          for ms, n, name in trace["by_name"][:12]]),
        max_memory_allocated=peak)
    del state, step
    torch.cuda.empty_cache()
    return (fwd, bwd), summary


def _draw_bonus(params, cfg) -> None:
    """RWKV's bonus ``u`` drawn uniform in [0.5, 1.5) from a numpy seed, in
    place: at init it is 0, which puts the group norm at zero variance on
    the first token and rank one on the second, where the f32 gradients of
    the CPU and of the JAX reference alike sit about 1e-3 from a float64
    evaluation (``tests/test_torch_lm_train.py``)."""
    import numpy as np
    import torch
    for pos, (mixer, _) in enumerate(cfg.block_pattern):
        if mixer == "rwkv":
            u = params["blocks"][str(pos)]["mixer"]["u"]
            u.copy_(torch.from_numpy(np.random.default_rng(SEED).uniform(
                0.5, 1.5, tuple(u.shape))))


def twin_step(cfg, base, batch, opt, *, lr: float,
              accum_steps: int = 1) -> dict:
    """One ``make_train_step`` step (clip 1.0) of ``cfg`` from a copy of
    ``base`` on the card and another on the CPU, on the same batch:
    {"card", "cpu"} -> (metrics as floats, the params after the step).
    For a config with MoE layers every routing decision of the card's step
    is recorded and the CPU's step takes them
    (``launch/decode_parity.Router``, as ``--pin-routing`` does), so a
    near-tied top-k choice cannot flip between the two; "routing" then
    holds (decisions the pin overrode, decisions), and the overridden
    decisions must stay at or below PIN_MAX_OVERRIDDEN, so that the pin
    absorbs near-ties and cannot hide a routing fault of the card.  Phases
    29-31 and ``tests/test_torch_lm_train_cuda.py`` take it."""
    import torch
    from repro_torch.convert import params_to
    from repro_torch.launch.decode_parity import Router, _with_router
    from repro_torch.train.step import make_train_step

    out = {"routing": None}
    router = Router() if cfg.moe is not None else None
    for side, device in (("card", "cuda"), ("cpu", "cpu")):
        p = params_to(base, device)
        state = {"params": p, "opt": opt.init(p),
                 "step": torch.zeros((), dtype=torch.int32,
                                     device=p["embed"].device)}
        step = make_train_step(cfg, opt, lr=lr, clip=1.0,
                               accum_steps=accum_steps)
        if router is None:
            state, m = step(state, batch)
        else:
            if side == "cpu":
                router = Router([r.cpu() for r in router.recorded])
            state, m = _with_router(router, lambda: step(state, batch))
        out[side] = ({key: float(v) for key, v in m.items()},
                     state["params"])
    if router is not None:
        out["routing"] = (router.differ, router.decisions)
        check(router.differ <= PIN_MAX_OVERRIDDEN, f"the CPU's step took "
              f"the card's routing in {router.differ} of {router.decisions} "
              f"decisions, more than the {PIN_MAX_OVERRIDDEN} near-ties "
              f"allowed")
    return out


PARITY_RUNS = ((1, "sgd"), (2, "sgd"), (1, "adamw"))


def lm_train_parity(cfg, batch_shape, *, rwkv_bonus: bool = False,
                    runs=PARITY_RUNS) -> dict:
    """One train step of ``cfg`` (f32) on the card against the same step on
    the CPU (the plain versions, autograd), from the same params (drawn on
    the card, copied) and the same ``SyntheticLMData`` batch, for each of
    ``runs`` (accum_steps, optimizer): through ``make_train_step`` with
    ``Sgd`` at PARITY_LR, the
    loss within LOSS_REL_TOL relative, the gradient norm printed, and
    every updated param within UPDATE_REL_TOL * max |CPU update| (the
    largest over the tree, as in phase 11); the worst leaf is named; with
    AdamW (its defaults, lr TRAIN_LM_LR), printed and not held.  An MoE
    config's CPU step takes the card's routing (``twin_step``)."""
    import torch
    from repro_torch.convert import params_to
    from repro_torch.data import SyntheticLMData
    from repro_torch.nn import transformer as T
    from repro_torch.optim.adamw import AdamW

    device = torch.device("cuda")
    base = T.init_lm(cfg, torch.Generator(device=device).manual_seed(SEED),
                     device=device)
    if rwkv_bonus:
        _draw_bonus(base, cfg)
    base_cpu = params_to(base, "cpu")
    b, l = batch_shape
    batch = SyntheticLMData(cfg.vocab, l, b, seed=SEED + 29).batch_at(0)
    print(f"\ntraining step, card vs CPU: {cfg.name} in f32 at d_model "
          f"{cfg.d_model}, Dh {cfg.head_dim}, {cfg.n_layers} layers, vocab "
          f"{cfg.vocab}; batch {b} x {l}")
    out = []
    for accum, kind in runs:
        opt, lr, held = ((Sgd(), PARITY_LR, True) if kind == "sgd"
                         else (AdamW(), TRAIN_LM_LR, False))
        t0 = time.perf_counter()
        twins = twin_step(cfg, base, batch, opt, lr=lr, accum_steps=accum)
        routing = twins.pop("routing")
        metrics = {side: m for side, (m, _) in twins.items()}
        new = {side: p for side, (_, p) in twins.items()}
        del twins
        loss_rel = abs(metrics["card"]["loss"] - metrics["cpu"]["loss"]) \
            / abs(metrics["cpu"]["loss"])
        gn_rel = abs(metrics["card"]["grad_norm"]
                     - metrics["cpu"]["grad_norm"]) \
            / metrics["cpu"]["grad_norm"]
        diffs, upds = {}, {}
        for (name, g), c, c0 in zip(_named(new["card"]), _leaves(new["cpu"]),
                                    _leaves(base_cpu)):
            diffs[name] = float((g.detach().cpu() - c.detach()).abs().max())
            upds[name] = float((c.detach() - c0).abs().max())
        max_upd = max(upds.values())
        worst = max(diffs, key=diffs.get)
        rel = diffs[worst] / max_upd
        name_opt = type(opt).__name__
        print(f"  accum_steps {accum}, {name_opt}, lr {lr:g}: loss card "
              f"{metrics['card']['loss']:.6f} CPU {metrics['cpu']['loss']:.6f}"
              f" ({loss_rel:.3e} relative), grad norm {gn_rel:.3e} "
              f"relative; max |update diff| / max |CPU update| {rel:.3e} "
              f"(worst leaf {worst}: {diffs[worst]:.3e}, its own max CPU "
              f"update {upds[worst]:.3e}) in "
              f"{time.perf_counter() - t0:.1f}s"
              + ("" if routing is None else
                 f"; the CPU took the card's routing: {routing[0]} of "
                 f"{routing[1]} decisions overridden")
              + ("" if held else "; printed, not held"))
        if held:
            check(loss_rel <= LOSS_REL_TOL, f"card vs CPU training loss "
                  f"{loss_rel:.3e} > {LOSS_REL_TOL} relative")
            check(rel <= UPDATE_REL_TOL, f"card vs CPU update {rel:.3e} > "
                  f"{UPDATE_REL_TOL} of max |CPU update| (leaf {worst})")
        out.append(dict(accum_steps=accum, optimizer=name_opt, lr=lr,
                        held=held,
                        loss_card=metrics["card"]["loss"],
                        loss_cpu=metrics["cpu"]["loss"], loss_rel=loss_rel,
                        grad_norm_rel=gn_rel, update_rel=rel,
                        worst_leaf=worst, routing_pinned=routing))
        del new
    del base, base_cpu
    torch.cuda.empty_cache()
    return dict(arch=cfg.name, d_model=cfg.d_model, head_dim=cfg.head_dim,
                layers=cfg.n_layers, vocab=cfg.vocab, batch=[b, l],
                steps=out)


def _named(tree, prefix=""):
    for key, v in tree.items():
        if isinstance(v, dict):
            yield from _named(v, f"{prefix}/{key}")
        else:
            yield f"{prefix}/{key}", v


def rwkv_phase(device) -> dict:
    """Phase 30: ``rwkv6-1.6b`` (bf16, uncut) through ``serve_continuous``
    (phase 16's lanes and lengths, RWKV_REQUESTS requests of
    RWKV_PROMPT_LEN tokens; no port kernel on its path: K7 held to 0), the
    batch-8 prefill and decode steps with their profiles; then a reduced
    f32 RWKV (RWKV_PARITY) card vs CPU: prefill and 4 decode steps within
    1e-4 * max |logit|, decode vs forward within 1e-3, and one training
    step within the step limits."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import attention as k7

    launches, summary, params, _ = lm_serving(
        device, RWKV_ARCH, RWKV_WIDTHS,
        {"flash_attention": (k7, "flash_attention_kernel", 0, 0)}, {},
        requests=RWKV_REQUESTS, prompt_len=RWKV_PROMPT_LEN)
    del params
    torch.cuda.empty_cache()
    cfg = dataclasses.replace(get_config(RWKV_ARCH), **RWKV_PARITY)
    params = init_on_card(cfg)
    _draw_bonus(params, cfg)
    summary["parity"] = lm_parity(params, cfg, RWKV_PARITY_PROMPTS)
    dvf = decode_vs_forward(params, cfg)
    check(dvf["rel"] <= DECODE_REL_TOL, f"RWKV f32 decode differs from "
          f"forward by {dvf['rel']:.3e} > {DECODE_REL_TOL} of max |logit|")
    summary["decode_vs_forward"] = dvf
    del params
    torch.cuda.empty_cache()
    summary["train_parity"] = lm_train_parity(cfg, RWKV_TRAIN_BATCH,
                                              rwkv_bonus=True)
    return summary


# ---------------------------------------------------------------------------
# Phase 31: hybrid and MoE training on the card (K8' and K9')
# ---------------------------------------------------------------------------

HYBRID_TRAIN_ARCH = "jamba-1.5-large-398b-train-1chip"
HYBRID_TRAIN_WIDTHS = (2, 8192, 64, 8, 128, 24576, 65536, "bfloat16")
HYBRID_TRAIN_BATCH = (2, 512)       # sequences x tokens
HYBRID_TRAIN_STEPS = 3              # timed steps, after one untimed
HYBRID_PEAK_GB = 72.0
# a step's forward launches of K7, K8 and K9.  Under cfg.remat the period
# runs under one checkpoint and each of its blocks under another
# (nn/transformer.forward): a block runs in the forward, in its own
# checkpoint's recompute and, unless it is the period's last block, in the
# period's recompute, which stops once the inputs it saved for the inner
# checkpoints exist again; so the Mamba + MoE block (K8 once, K9 three
# times) runs 3 times and the attention block (K7) twice
HYBRID_FORWARDS = {"k7": 2, "k8": 3, "k9": 9}
# K8': b, l, d, kw, x read in place (the mixer's half of its projection),
# act, bias, dtype
CONV1D_BWD_CASES = [(2, 512, 16384, 4, True, "silu", True, "bfloat16"),
                    (2, 512, 16384, 4, True, "silu", False, "bfloat16"),
                    (2, 512, 16384, 4, True, "none", True, "bfloat16"),
                    (2, 512, 16384, 4, True, "none", False, "bfloat16"),
                    (2, 100, 1024, 4, True, "silu", True, "float32"),
                    (2, 77, 1002, 4, False, "silu", True, "float32"),
                    (1, 77, 1002, 4, False, "none", True, "bfloat16")]
K8_BWD_NEEDLE = "conv1d_causal_bwd_kernel"   # one a call on every route
K8_BWD_SUM = "conv1d_causal_bwd_sum"         # its second pass
K8_BWD_TILE = "conv1d_causal_bwd_kernel_tile"  # the tile route's alone
K9_BWD_NEEDLE = "moe_gmm_bwd_dx_kernel"      # one a call on every route
K9_BWD_DW = "moe_gmm_bwd_dw_kernel"          # its second kernel
K9_BWD_WGMMA = "moe_gmm_bwd_dw_kernel_wgmma"   # the wgmma route's alone
MOE_TRAIN_HELD = 4                           # the cut holds 4 of 16 experts
MOE_TRAIN_SMALL = (256, 512)                 # D, F of the f32 case
MOE_TRAIN_BM64 = (1032, 1544)                # D, F of the bf16 case at bm 64
JAMBA_TRAIN_PERIOD = (("mamba", "moe"), ("attn", "dense"))
HYBRID_PARITY = dict(n_layers=2, d_model=256, n_heads=4, n_kv_heads=2,
                     d_head=64, d_ff=512, vocab=1024, dtype="float32")
HYBRID_PARITY_ARCHS = (("jamba-1.5-large-398b",
                        dict(block_pattern=JAMBA_TRAIN_PERIOD)),
                       ("phi3.5-moe-42b-a6.6b", {}))
HYBRID_PARITY_BATCH = (2, 128)


def _held_twice(run, plain, tol, what):
    """Two calls of ``run``: finite, within ``tol`` of ``plain`` on every
    gradient (max |diff| / max |plain|), and the same bits.  Returns (first
    result, each gradient's relative error, each one's max |diff|)."""
    import torch
    got, again = run(), run()
    torch.cuda.synchronize()
    check(all(bool(torch.isfinite(g).all()) for g in got),
          f"{what}: a non-finite gradient")
    check(all(bool(torch.equal(a, b)) for a, b in zip(got, again)),
          f"{what}: other bits on a second call")
    errs = [rel_err(g.float(), p.float()) for g, p in zip(got, plain)]
    abss, rels = [e[0] for e in errs], [e[1] for e in errs]
    check(max(rels) <= tol, f"{what} disagrees with its plain version: "
          f"{[f'{r:.3e}' for r in rels]} > {tol}")
    return got, rels, abss


def conv1d_bwd_signatures(device):
    """Phase 31a: K8' (``conv1d_causal_bwd``) against
    ``conv1d_causal_bwd_plain`` on dx, dw and db (max |diff| / max |plain|
    <= 1e-2 bf16, <= 1e-5 f32; the same bits on a second call): the cut's
    training shape (2, 512, 16384), x read in place from the mixer's
    projection, SiLU and "none", with and without a bias, bf16; a reduced
    f32 shape and a ragged D (1002) in f32 and bf16 (``route_bwd``, held:
    "tile" wherever rows start on 16-byte boundaries, "thread" at D 1002).
    On every tile case the vec route it took over is forced on the same
    inputs and held the same way.  At the first shape, on both routes:
    CUDA-event ms, profiler device ms (each route's kernel and the sum
    pass), the share of the bound; then the plain version's ms, the library
    yardstick (autograd of cuDNN's depthwise ``F.conv1d`` and SiLU; used
    only here) and the bound: x and dy read and dx written once, w, bias,
    dw and db, over 3.35 TB/s, or (6 KW + 8) operations an element over the
    dtype's peak.  The tile route's verdict against its aim (at least half
    its bound) is printed, not held."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import conv1d_causal as k8

    gen = torch.Generator(device=device).manual_seed(SEED + 31)
    counter = Counter(k8, "launches_bwd")
    rows = []
    print(f"\nK8' (conv1d_causal_bwd) vs plain (limits {BF16_REL_TOL} bf16, "
          f"{KERNEL_REL_TOL} f32 of max |plain| on dx, dw, db; the same bits "
          f"twice; route by route_bwd, vec forced beside each tile case):")
    print("  dtype     b    l     d kw x        act  bias route  run  dx_rel "
          "  dw_rel   db_rel        ms  device_ms   plain_ms  library_ms "
          " bound_ms bound_by")
    for b, l, d, kw, in_place, act, with_bias, dname in CONV1D_BWD_CASES:
        dtype = getattr(torch, dname)
        x = torch.randn((b, l, 2 * d if in_place else d), generator=gen,
                        device=device).to(dtype)
        if in_place:
            x = x.chunk(2, dim=-1)[0]
        w = (torch.randn((kw, d), generator=gen, device=device)
             * kw ** -0.5).to(dtype)
        bias = torch.randn((d,), generator=gen, device=device).to(dtype) \
            if with_bias else None
        dy = torch.randn((b, l, d), generator=gen, device=device).to(dtype)
        path = k8.route_bwd(x, w, bias, dy)
        want = "tile" if d % (16 // x.element_size()) == 0 else "thread"
        check(path == want, f"K8' takes the {path} route at {(b, l, d)}, "
              f"expected {want}")
        tol = BF16_REL_TOL if dtype == torch.bfloat16 else KERNEL_REL_TOL
        shape = (b, l, d, kw, act, with_bias, dname)
        plain = k8.conv1d_causal_bwd_plain(x, w, dy, bias=bias, act=act)
        plain = [p for p in plain if p is not None]

        def run():
            out = k8.conv1d_causal_bwd(x, w, dy, bias=bias, act=act)
            return [o for o in out if o is not None]
        before = (k8.launches_bwd, k8.launches_bwd_vec, k8.launches_bwd_tile)
        got, rels, abss = _held_twice(run, plain, tol, f"K8' at {shape}")
        check((k8.launches_bwd - before[0], k8.launches_bwd_vec - before[1],
               k8.launches_bwd_tile - before[2])
              == (2, 0, 2 if path == "tile" else 0), "K8' launch counts")
        if path == "tile":
            plan = k8.bwd_tile_plan(b, l, d, kw, 16 // x.element_size())
            run_len = plan.run
        else:
            run_len = k8.bwd_run_length(b, l, d, 1)
        rec = dict(dtype=dname, b=b, l=l, d=d, kw=kw,
                   x="in place" if in_place else "contiguous", act=act,
                   bias=with_bias, route=path, run=run_len,
                   rel_err=dict(zip(("dx", "dw", "db"), rels)),
                   max_rel_err=max(rels), max_abs_err=max(abss),
                   same_bits=True)
        if path == "tile":
            rec["plan"] = dataclasses.asdict(plan)
            with returning(k8, "route_bwd", "vec"):
                before = k8.launches_bwd_vec
                _, vrels, vabss = _held_twice(run, plain, tol,
                                              f"K8' vec forced at {shape}")
                check(k8.launches_bwd_vec - before == 2,
                      "K8' vec forced: launch counts")
            rec["vec_rel_err"] = dict(zip(("dx", "dw", "db"), vrels))
            rec["max_rel_err"] = max(max(rels), max(vrels))
            rec["max_abs_err"] = max(max(abss), max(vabss))
        timed = not rows
        if timed:
            rec["ms"] = auto_ms(run)
            rec["device_ms"], rec["traced_launches"] = kernel_device_ms(
                run, K8_BWD_NEEDLE, counter, also=(K8_BWD_SUM,))
            with returning(k8, "route_bwd", "vec"):
                rec["vec_ms"] = auto_ms(run)
                rec["vec_device_ms"], _ = kernel_device_ms(
                    run, K8_BWD_NEEDLE, counter, also=(K8_BWD_SUM,))
            rec["plain_ms"] = auto_ms(lambda: k8.conv1d_causal_bwd_plain(
                x, w, dy, bias=bias, act=act), 30.0)
            xl = x.transpose(1, 2).contiguous().requires_grad_()
            wl = w.t().unsqueeze(1).contiguous().requires_grad_()
            leaves = [xl, wl] + ([bias.detach().clone().requires_grad_()]
                                 if with_bias else [])
            y = F.conv1d(xl, wl, leaves[2] if with_bias else None,
                         padding=kw - 1, groups=d)[..., :l]
            y = F.silu(y) if act == "silu" else y
            dyl = dy.transpose(1, 2)
            lib = torch.autograd.grad(y, leaves, dyl, retain_graph=True)
            rec["library_rel_err"] = rel_err(
                lib[0].transpose(1, 2).float(), plain[0].float())[1]
            rec["library_ms"] = auto_ms(lambda: torch.autograd.grad(
                y, leaves, dyl, retain_graph=True))
            nbytes = x.element_size() * (3 * b * l * d + (2 * kw + 2) * d)
            flops = (6.0 * kw + 8.0) * b * l * d
            rec["bound_ms"], rec["bound_by"] = bound_for(flops, nbytes,
                                                         dtype)
            rec["bound_share"] = rec["bound_ms"] / rec["device_ms"]
            rec["vec_bound_share"] = rec["bound_ms"] / rec["vec_device_ms"]
            rec["gb_per_s"] = nbytes / rec["device_ms"] / 1e6
            rec["aim_met"] = rec["bound_share"] >= 0.5
            del xl, wl, leaves, y, dyl, lib
        rows.append(rec)

        def col(key, fmt="10.4f"):
            return format(rec[key], fmt) if key in rec else " " * 9 + "—"
        print(f"  {dname:8s}{b:2d}{l:5d}{d:6d}{kw:3d} {rec['x']:10s}"
              f"{act:5s}{with_bias!s:6s}{path:6s}{rec['run']:4d}  "
              + "  ".join(f"{r:.1e}" for r in rels).ljust(26)
              + f" {col('ms')} {col('device_ms')} {col('plain_ms')} "
              f"{col('library_ms')} {col('bound_ms')} "
              f"{rec.get('bound_by', '')}"
              + (f"  (vec forced {'  '.join(f'{r:.1e}' for r in vrels)})"
                 if path == "tile" else "")
              + (f"  ({rec['gb_per_s']:.0f} GB/s by device time; cuDNN's "
                 f"dx vs plain {rec['library_rel_err']:.1e}; "
                 f"{rec['traced_launches']} of 5 calls traced)"
                 if timed else ""))
        if timed:
            print(f"    tile {rec['plan']}: {rec['ms']:.4f} ms by events, "
                  f"{rec['device_ms']:.4f} device, {rec['bound_share']:.3f} "
                  f"of the bound; vec forced {rec['vec_ms']:.4f} / "
                  f"{rec['vec_device_ms']:.4f}, {rec['vec_bound_share']:.3f}"
                  f"; aim (at least half the bound, <= "
                  f"{2 * rec['bound_ms']:.4f} ms device): "
                  f"{'met' if rec['aim_met'] else 'not met'}")
        del x, w, bias, dy, plain, got
    print("  per-shape JSON:", json.dumps(rows))
    return rows


def moe_train_plan(device, gen):
    """K9's rows of one MoE layer of the cut at HYBRID_TRAIN_BATCH: random
    activations through a random router over 16 experts, the layer's
    groups, capacity and drops, ``replay_plan`` for the held 4.  Where
    every held expert receives rows, the last one's choices go to the first
    expert not held, so one held expert has none.  Returns (x (T, D) f32,
    bm, tile_eid, source, the forced expert or None)."""
    import torch
    from repro_torch.nn import moe

    b, l = HYBRID_TRAIN_BATCH
    s = min(moe.GROUP_SIZE, l)
    x = torch.randn((b * l, MOE_D), generator=gen, device=device)
    router = torch.randn((MOE_D, MOE_E), generator=gen, device=device) \
        * MOE_D ** -0.5
    _, gate_idx = moe.route(torch.softmax(x @ router, dim=-1)
                            .reshape(b * l // s, s, MOE_E), MOE_K)
    forced = None
    if all(bool((gate_idx == h).any()) for h in range(MOE_TRAIN_HELD)):
        forced = MOE_TRAIN_HELD - 1
        gate_idx = torch.where(gate_idx == forced, MOE_TRAIN_HELD, gate_idx)
    cap = max(int(1.25 * s * MOE_K / MOE_E), 1)
    bm, tile_eid, _, source = moe.replay_plan(
        gate_idx, moe.kept(gate_idx, MOE_E, cap), 0, MOE_TRAIN_HELD, cap)
    x_rows = torch.where((source > 0)[:, None],
                         x[(source - 1).clamp_min(0)], 0)
    return x_rows, bm, tile_eid, source, forced


def moe_bwd_signatures(device):
    """Phase 31b: K9' (``moe_gmm_bwd``) against ``moe_gmm_bwd_plain`` on
    dtokens and dweights (limits as K8'; the same bits twice) with the
    ``tile_eid`` that ``nn/moe.replay_plan`` gives one MoE layer of the cut
    for a random 2 x 512 batch (``moe_train_plan``: -1 tail tiles and an
    expert with no rows, forced where the batch has none), at the cut's
    gate/up shape (D 8192 -> F 24576; gate and up share it) and down shape
    (24576 -> 8192) in bf16, at the same rows in tiles of 64 (each tile of
    128 halved; D 1032 -> F 1544, ragged against the dweights boxes), at D
    256 -> F 512 in f32, and at K9's tail case (T, D, F multiples of no
    block, bm 16, a -1 tile) in both dtypes: route (``route_bwd``, held:
    "wgmma" for the bf16 cases at bm 64 and 128, "mma" for the bf16 tail,
    "simt" for f32), rows of -1 tiles and the empty expert's dweights
    exactly zero.  On every wgmma case the mma route it took over is forced
    on the same inputs and held the same way.  At the cut's shapes, on both
    routes: CUDA-event ms and profiler device ms (the dtokens and dweights
    kernels apart) and the share of the bound; then the plain version, the
    library yardstick (``torch.bmm`` over the capacity-padded experts for
    both products, (E, C, F) x (E, F, D) and (E, D, C) x (E, C, F); used
    only here) and the bound: 4 x routed rows x D x F operations at 989
    TFLOP/s, or the bytes (tokens and dout read on the rows of tiles with
    an expert, dtokens written on every row, the weights of the experts
    that have tiles read, every expert's dweights written), whichever is
    larger.  The wgmma route's verdict at gate/up against its aim (no
    slower than ``torch.bmm``, at least half its bound) is printed, not
    held."""
    import torch
    from repro_torch.kernels import moe_gmm as k9
    from repro_torch.nn import moe

    gen = torch.Generator(device=device).manual_seed(SEED + 32)
    x_rows, bm, tile_eid, source, forced = moe_train_plan(device, gen)
    ids = tile_eid.tolist()
    t = x_rows.shape[0]
    routed = int((source > 0).sum())
    empty = [h for h in range(MOE_TRAIN_HELD) if h not in ids]
    print(f"\nK9' (moe_gmm_bwd) vs plain: one MoE layer of the cut at batch "
          f"{HYBRID_TRAIN_BATCH[0]} x {HYBRID_TRAIN_BATCH[1]}, "
          f"{MOE_TRAIN_HELD} of {MOE_E} experts held: {t} rows in tiles of "
          f"{bm}, tile_eid {ids}, {routed} routed rows; experts without rows "
          f"{empty}" + (f" (expert {forced}'s choices moved to expert "
                        f"{MOE_TRAIN_HELD} to make one)" if forced is not None
                        else "") + f"; limits {BF16_REL_TOL} bf16, "
          f"{KERNEL_REL_TOL} f32 of max |plain| on dtokens and dweights; "
          f"mma forced beside each wgmma case:")
    check(-1 in ids and bool(empty), f"the plan has no -1 tile or no empty "
          f"expert: {ids}")
    check(bm == 128, f"the plan's tiles are of {bm} rows, not 128")
    counter = Counter(k9, "launches_bwd")
    halved = tile_eid.repeat_interleave(2)[:-(-t // (bm // 2))]
    cases = [("gate/up", t, MOE_D, MOE_F, MOE_TRAIN_HELD, bm, tile_eid,
              torch.bfloat16),
             ("down", t, MOE_F, MOE_D, MOE_TRAIN_HELD, bm, tile_eid,
              torch.bfloat16),
             ("bm64", t, *MOE_TRAIN_BM64, MOE_TRAIN_HELD, bm // 2, halved,
              torch.bfloat16),
             ("small", t, *MOE_TRAIN_SMALL, MOE_TRAIN_HELD, bm, tile_eid,
              torch.float32)]
    tt, td, tf, te, tbm, tids = MOE_TAIL
    tail_eid = torch.tensor(tids, dtype=torch.int32, device=device)
    for dtype in (torch.float32, torch.bfloat16):
        cases.append(("tail", tt, td, tf, te, tbm, tail_eid, dtype))
    rows = []
    print("  case      dtype     route shape (T x D -> F)     bm  dtok_rel "
          " dw_rel        ms  device_ms (dx, dw)       plain_ms  library_ms "
          " bound_ms bound_by")
    for name, t_, d, f, e, bm_, eid, dtype in cases:
        keep = (source > 0)[:, None] if name != "tail" else torch.ones(
            (t_, 1), dtype=torch.bool, device=device)
        tokens = (x_rows if d == MOE_D and name != "tail" else torch.randn(
            (t_, d), generator=gen, device=device)) * keep
        tokens = tokens.to(dtype)
        weights = (torch.randn((e, d, f), generator=gen, device=device)
                   * d ** -0.5).to(dtype)
        dout = (torch.randn((t_, f), generator=gen, device=device)
                * keep).to(dtype)
        path = k9.route_bwd(tokens, weights, bm_, dout)
        want = "simt" if dtype == torch.float32 else \
            "mma" if name == "tail" else "wgmma"
        check(path == want, f"K9' takes the {path} route at {name} {dtype}, "
              f"expected {want}")
        tol = BF16_REL_TOL if dtype == torch.bfloat16 else KERNEL_REL_TOL
        what = f"K9' at {name} {dtype}"
        plain = k9.moe_gmm_bwd_plain(tokens, weights, eid, dout, bm=bm_)
        eid_l = eid.tolist()
        dead = [r for r in range(t_) if eid_l[r // bm_] < 0]

        def run():
            return k9.moe_gmm_bwd(tokens, weights, eid, dout, bm=bm_)

        def held(label, route):
            before = (k9.launches_bwd, k9.launches_bwd_mma,
                      k9.launches_bwd_wgmma)
            got_, rels_, abss_ = _held_twice(run, plain, tol, label)
            check((k9.launches_bwd - before[0],
                   k9.launches_bwd_mma - before[1],
                   k9.launches_bwd_wgmma - before[2])
                  == (2, 2 * (route == "mma"), 2 * (route == "wgmma")),
                  f"{label}: launch counts")
            check(not bool(got_[0][dead].any()) if dead else True,
                  f"{label}: rows of -1 tiles got a nonzero dtokens")
            for h in range(e):
                if h not in eid_l:
                    check(not bool(got_[1][h].any()), f"{label}: expert {h} "
                          f"has no rows but a nonzero dweights")
            return got_, rels_, abss_
        got, rels, abss = held(what, path)
        rec = dict(case=name, dtype=str(dtype).removeprefix("torch."), t=t_,
                   d=d, f=f, e=e, bm=bm_, route=path, tile_eid=eid_l,
                   rel_err=dict(dtokens=rels[0], dweights=rels[1]),
                   max_rel_err=max(rels), max_abs_err=max(abss),
                   same_bits=True)
        if path == "wgmma":
            with returning(k9, "route_bwd", "mma"):
                _, mrels, mabss = held(f"{what}, mma forced", "mma")
            rec["mma_rel_err"] = dict(dtokens=mrels[0], dweights=mrels[1])
            rec["max_rel_err"] = max(max(rels), max(mrels))
            rec["max_abs_err"] = max(max(abss), max(mabss))

        def traced(key):
            trace = trace_device(lambda i: run(), 5, {
                K9_BWD_NEEDLE: counter,
                K9_BWD_DW: Counter(k9, key)}, sync_each=True)
            dx_ms = device_ms_of(trace, K9_BWD_NEEDLE)
            dw_ms = device_ms_of(trace, K9_BWD_DW)
            return dx_ms + dw_ms, dx_ms, dw_ms
        if name in ("gate/up", "down"):
            rec["ms"] = auto_ms(run)
            rec["device_ms"], rec["dx_ms"], rec["dw_ms"] = traced(
                "launches_bwd")
            with returning(k9, "route_bwd", "mma"):
                rec["mma_ms"] = auto_ms(run)
                rec["mma_device_ms"], rec["mma_dx_ms"], rec["mma_dw_ms"] = \
                    traced("launches_bwd_mma")
            rec["plain_ms"] = auto_ms(lambda: k9.moe_gmm_bwd_plain(
                tokens, weights, eid, dout, bm=bm_), 30.0)
            # the layer's groups of min(GROUP_SIZE, L) tokens, 2 of them
            s = min(moe.GROUP_SIZE, HYBRID_TRAIN_BATCH[1])
            cap_rows = HYBRID_TRAIN_BATCH[0] * HYBRID_TRAIN_BATCH[1] // s \
                * max(int(1.25 * s * MOE_K / MOE_E), 1)
            tok_p = torch.randn((e, cap_rows, d), generator=gen,
                                device=device).to(dtype)
            dout_p = torch.randn((e, cap_rows, f), generator=gen,
                                 device=device).to(dtype)

            def library():
                return (torch.bmm(dout_p, weights.transpose(1, 2)),
                        torch.bmm(tok_p.transpose(1, 2), dout_p))
            rec["library_ms"] = auto_ms(library)
            rec["library_capacity"] = cap_rows
            flops = 4.0 * routed * d * f
            # tokens and dout read on the rows of tiles with an expert,
            # dtokens written on every row, the weights of the experts
            # that have tiles read and every expert's dweights written
            live = bm_ * sum(0 <= h < e for h in eid_l)
            used = len({h for h in eid_l if 0 <= h < e})
            nbytes = tokens.element_size() * (live * (d + f) + t_ * d
                                              + (used + e) * d * f)
            rec["bound_ms"], rec["bound_by"] = bound_for(flops, nbytes, dtype)
            rec["ops_bound_ms"] = flops / 989e12 * 1e3
            rec["bytes_bound_ms"] = nbytes / 3.35e12 * 1e3
            rec["routed_rows"] = routed
            rec["tflops"] = flops / rec["device_ms"] / 1e9
            rec["bound_share"] = rec["bound_ms"] / rec["device_ms"]
            rec["mma_bound_share"] = rec["bound_ms"] / rec["mma_device_ms"]
            rec["aim_met"] = (rec["device_ms"] <= rec["library_ms"]
                              and rec["bound_share"] >= 0.5)
            del tok_p, dout_p
        rows.append(rec)

        def col(key):
            return f"{rec[key]:10.4f}" if key in rec else " " * 9 + "—"
        dev = (f"{rec['device_ms']:9.4f} ({rec['dx_ms']:.4f}, "
               f"{rec['dw_ms']:.4f})" if "device_ms" in rec
               else " " * 8 + "—".ljust(19))
        print(f"  {name:9s} {rec['dtype']:9s} {path:5s} "
              f"{t_:5d} x {d:5d} -> {f:5d} {bm_:4d}  {rels[0]:.1e}  "
              f"{rels[1]:.1e} {col('ms')} {dev} {col('plain_ms')} "
              f"{col('library_ms')} {col('bound_ms')} "
              f"{rec.get('bound_by', '')}"
              + (f"  (mma forced {mrels[0]:.1e}  {mrels[1]:.1e})"
                 if path == "wgmma" else "")
              + (f"  (operations {rec['ops_bound_ms']:.4f} ms, bytes "
                 f"{rec['bytes_bound_ms']:.4f} ms; {rec['tflops']:.1f} "
                 f"TFLOP/s by device time on {routed} routed rows)"
                 if "ms" in rec else ""))
        if "ms" in rec:
            print(f"    wgmma {rec['ms']:.4f} ms by events, "
                  f"{rec['device_ms']:.4f} device, {rec['bound_share']:.3f} "
                  f"of the bound; mma forced {rec['mma_ms']:.4f} / "
                  f"{rec['mma_device_ms']:.4f} (dtokens "
                  f"{rec['mma_dx_ms']:.4f}, dweights {rec['mma_dw_ms']:.4f})"
                  f", {rec['mma_bound_share']:.3f}"
                  + (f"; aim (no slower than torch.bmm's "
                     f"{rec['library_ms']:.4f} ms, at least half the bound: "
                     f"<= {2 * rec['bound_ms']:.4f} ms device): "
                     f"{'met' if rec['aim_met'] else 'not met'}"
                     if name == "gate/up" else ""))
        del tokens, weights, dout, plain, got
    print("  per-case JSON:", json.dumps(rows))
    return rows


def _hybrid_grads_seen(cfg, seen):
    """An ``AdamW.update`` stand-in that records, in its first call, for
    each Mamba layer whether its conv_w and conv_b gradients hold a nonzero
    and, for each MoE layer, which held experts' w_gate, w_up and w_down
    gradients do.  Then it updates as ever."""
    from repro_torch.optim.adamw import AdamW
    update = AdamW.update

    def recording(self, grads, state, params, lr):
        if not seen:
            for pos, (mixer, mlp) in enumerate(cfg.block_pattern):
                blk = grads["blocks"][str(pos)]
                if mixer == "mamba":
                    for name in ("conv_w", "conv_b"):
                        seen[f"{pos}/{name}"] = (
                            blk["mixer"][name].flatten(1).abs().amax(1)
                            > 0).tolist()
                if mlp == "moe":
                    for name in ("w_gate", "w_up", "w_down"):
                        g = blk["mlp"][name]            # (layers, E, ...)
                        seen[f"{pos}/{name}"] = (
                            g.flatten(2).abs().amax(2) > 0).tolist()
        return update(self, grads, state, params, lr)
    return recording


def hybrid_training(device):
    """Phase 31c, this slice's main path: ``jamba-1.5-large-398b-train-1chip``
    (bf16, remat) through ``launch.train.build`` (factored AdamW with bf16
    ``m``, clip 1.0) on HYBRID_TRAIN_BATCH ``SyntheticLMData`` tokens: one
    untimed step (every Mamba layer's conv_w and conv_b gradient and every
    gradient of each held expert that received rows must hold a nonzero),
    then HYBRID_TRAIN_STEPS timed steps on the same batch with the counts of
    K7, K8, K9 and their backwards set to 0 just before and read just after
    (the forwards HYBRID_FORWARDS times a step under remat, each backward
    once a call; K9 on its wgmma route, K7 and its backward on theirs, K8
    on its tile route, K8' on its tile route, K9' on its wgmma route), step
    ms (p50, max), tokens/s and each loss (finite, the last below the
    first); one
    step under the profiler (each kernel's recorded launches held to its
    count; device ms by kernel group, the busy share) and the peak memory
    (at most HYBRID_PEAK_GB).  Returns (launches in the timed steps by
    kernel, summary)."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLMData
    from repro_torch.kernels import attention as k7
    from repro_torch.kernels import conv1d_causal as k8
    from repro_torch.kernels import moe_gmm as k9
    from repro_torch.launch.train import build
    from repro_torch.nn import moe
    from repro_torch.optim.adamw import AdamW

    cfg = get_config(HYBRID_TRAIN_ARCH)
    check((cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
           cfg.head_dim, cfg.d_ff, cfg.vocab, cfg.dtype)
          == HYBRID_TRAIN_WIDTHS, f"{HYBRID_TRAIN_ARCH} does not have the "
          f"widths {HYBRID_TRAIN_WIDTHS}")
    b, l = HYBRID_TRAIN_BATCH
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, step = build(cfg, lr=TRAIN_LM_LR, seed=SEED, device=device)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(state["params"]))
    e0, e1 = cfg.moe.held_experts()
    print(f"\nhybrid training: {cfg.name}, {n_params / 1e9:.3f} B params in "
          f"{cfg.dtype} (experts {e0}-{e1 - 1} of {cfg.moe.n_experts} held), "
          f"remat {cfg.remat}, AdamW factored with bf16 m, clip 1.0, lr "
          f"{TRAIN_LM_LR}; batch {b} x {l} SyntheticLMData tokens; built in "
          f"{time.perf_counter() - t0:.1f}s; "
          f"{torch.cuda.memory_allocated() / 1e9:.3f} GB allocated")
    batch = SyntheticLMData(cfg.vocab, l, b, seed=SEED).batch_at(0)
    seen, received = {}, set()
    plan = moe.replay_plan

    def recording_plan(*args, **kwargs):
        out = plan(*args, **kwargs)
        received.update(i for i in out[1].tolist() if i >= 0)
        return out
    update = AdamW.update
    AdamW.update = _hybrid_grads_seen(cfg, seen)
    moe.replay_plan = recording_plan
    try:
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        first_loss = float(metrics["loss"])
    finally:
        AdamW.update = update
        moe.replay_plan = plan
    print(f"  untimed step: loss {first_loss:.4f}, grad norm "
          f"{float(metrics['grad_norm']):.4f}, "
          f"{(time.perf_counter() - t0) * 1e3:.1f} ms")
    print(f"  first step's gradients, nonzero per layer (and per held "
          f"expert): {seen}; held experts that received rows: "
          f"{sorted(received)}")
    for key, flags in seen.items():
        name = key.split("/")[1]
        if name.startswith("conv"):
            check(all(flags), f"a Mamba layer's {name} gradient is all zero")
        else:
            for layer in flags:
                check(all(layer[h] for h in received), f"a held expert "
                      f"with rows has an all-zero {name} gradient: {layer}")
    check(any(k.endswith("conv_w") for k in seen) and any(
        k.endswith("w_gate") for k in seen) and received,
        "no Mamba or MoE gradient was seen")
    mods = {"k7": k7, "k8": k8, "k9": k9}
    names = ("launches", "launches_bwd", "launches_wgmma",
             "launches_bwd_wgmma", "launches_tile", "launches_bwd_vec",
             "launches_bwd_tile", "launches_bwd_mma")
    for mod in mods.values():
        for name in names:
            if hasattr(mod, name):
                setattr(mod, name, 0)
    losses, step_ms = [], []
    for _ in range(HYBRID_TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    counts = {f"{key}.{name}": getattr(mod, name)
              for key, mod in mods.items() for name in names
              if hasattr(mod, name)}
    n = HYBRID_TRAIN_STEPS
    want = {}
    for key, fwd in HYBRID_FORWARDS.items():
        want[f"{key}.launches"] = fwd * n
        want[f"{key}.launches_bwd"] = (3 if key == "k9" else 1) * n
    want["k7.launches_wgmma"] = want["k7.launches"]
    want["k7.launches_bwd_wgmma"] = want["k7.launches_bwd"]
    want["k8.launches_tile"] = want["k8.launches"]
    want["k8.launches_bwd_tile"] = want["k8.launches_bwd"]
    want["k8.launches_bwd_vec"] = 0
    want["k9.launches_wgmma"] = want["k9.launches"]
    want["k9.launches_bwd_wgmma"] = want["k9.launches_bwd"]
    want["k9.launches_bwd_mma"] = 0
    p50 = float(np.median(step_ms))
    print(f"  {n} timed steps: p50 {p50:.3f} ms, max {max(step_ms):.3f} ms "
          f"({[f'{x:.1f}' for x in step_ms]}); {b * l / p50 * 1e3:.0f} "
          f"tokens/s; losses {[f'{x:.4f}' for x in losses]}")
    print(f"  launches in the timed steps (expected a step: forward "
          f"{HYBRID_FORWARDS} under remat, backward K7 1, K8 1, K9 3): "
          f"{counts}")
    for key, value in want.items():
        check(counts[key] == value, f"{key} counted {counts[key]} in {n} "
              f"steps, expected {value}")
    check(all(math.isfinite(x) for x in losses), f"non-finite loss {losses}")
    check(losses[-1] < losses[0], f"the loss did not fall over {n} steps on "
          f"one batch: {losses}")
    trace = trace_device(lambda i: step(state, batch), 1, {
        "conv1d_causal_kernel": k8,
        K8_BWD_NEEDLE: Counter(k8, "launches_bwd"),
        K8_BWD_TILE: Counter(k8, "launches_bwd_tile"),
        "moe_gmm_kernel": k9,
        K9_BWD_NEEDLE: Counter(k9, "launches_bwd"),
        K9_BWD_WGMMA: Counter(k9, "launches_bwd_wgmma"),
        "flash_attention_kernel": k7,
        K7_BWD_NEEDLE: K7_BWD})
    groups = {"k8_fwd": device_ms_of(trace, "conv1d_causal_kernel"),
              "k8_bwd": device_ms_of(trace, "conv1d_causal_bwd"),
              "k9_fwd": device_ms_of(trace, "moe_gmm_kernel"),
              "k9_bwd": device_ms_of(trace, "moe_gmm_bwd_"),
              "k7_fwd": device_ms_of(trace, "flash_attention_kernel"),
              "k7_bwd": device_ms_of(trace, "flash_attention_bwd_")}
    groups["matmuls"] = sum(ms for ms, _, name in trace["by_name"]
                            if any(key in name.lower() for key in (
                                "gemm", "xmma", "nvjet", "cutlass", "sm90_")))
    device_ms = trace["device_ms"]
    groups["rest"] = device_ms - sum(groups.values())
    peak = torch.cuda.max_memory_allocated()
    print(f"  profile of one step: {trace['wall_ms']:.3f} ms by host clock, "
          f"device {device_ms:.3f} ms in {sum(trace['launches'].values())} "
          f"kernel launches, busy {trace['busy_share']:.4f}; by group (ms): "
          + ", ".join(f"{k} {v:.3f}" for k, v in groups.items())
          + f"; the Mamba scan's range {trace['ranges'].get('mamba.scan', 0):.3f}"
          f", the experts' range {trace['ranges'].get('moe.experts', 0):.3f};"
          f" torch.cuda.max_memory_allocated {peak / 1e9:.3f} GB")
    for ms, cnt, name in trace["by_name"][:12]:
        print(f"    {ms:9.3f} ms  x{cnt:6.1f}  {name[:100]}")
    check(peak <= HYBRID_PEAK_GB * 1e9, f"peak memory {peak / 1e9:.3f} GB > "
          f"{HYBRID_PEAK_GB} GB")
    summary = dict(
        arch=cfg.name, params=n_params, held_experts=[e0, e1], remat=cfg.remat,
        batch=b, tokens=l, lr=TRAIN_LM_LR, first_step_loss=first_loss,
        losses=losses, step_ms=step_ms, step_p50_ms=p50,
        step_max_ms=max(step_ms), tokens_per_s=b * l / p50 * 1e3,
        launches=counts, launches_per_step={k: v / n for k, v in
                                            counts.items()},
        grads_nonzero=seen, experts_with_rows=sorted(received),
        profile=dict(wall_ms=trace["wall_ms"], device_ms=device_ms,
                     busy_share=trace["busy_share"], groups_ms=groups,
                     ranges=trace["ranges"],
                     top=[dict(ms=ms, launches=cnt, name=name[:120])
                          for ms, cnt, name in trace["by_name"][:12]]),
        max_memory_allocated=peak)
    del state, step
    torch.cuda.empty_cache()
    return counts, summary


def hybrid_training_phase(device) -> dict:
    """Phase 31: K8' and K9' against their plain versions (31a, 31b), the
    cut's training steps (31c), and (31d) an f32 step card vs CPU for
    Jamba and Phi-3.5-MoE reduced (HYBRID_PARITY: 2 layers, d_model 256,
    Jamba's period of one Mamba + MoE and one attention + dense block)
    through ``twin_step`` with plain SGD at lr 1, the CPU's MoE routing
    pinned to the card's (``twin_step``; the overridden decisions printed
    and held to at most PIN_MAX_OVERRIDDEN): loss within 1e-4 relative,
    updates within 1e-3 of max |CPU update|."""
    import torch
    from repro_torch.configs import get_config

    t0 = time.perf_counter()
    conv_rows = conv1d_bwd_signatures(device)
    moe_rows = moe_bwd_signatures(device)
    torch.cuda.empty_cache()
    counts, summary = hybrid_training(device)
    parity = []
    for arch, extra in HYBRID_PARITY_ARCHS:
        cfg = dataclasses.replace(get_config(arch), **HYBRID_PARITY, **extra)
        parity.append(lm_train_parity(cfg, HYBRID_PARITY_BATCH,
                                      runs=((1, "sgd"),)))
    summary["parity"] = parity
    summary["phase_s"] = time.perf_counter() - t0
    return dict(conv_rows=conv_rows, moe_rows=moe_rows, counts=counts,
                summary=summary)


# ---------------------------------------------------------------------------
# Phase 32: data-parallel and resilient training, two ranks on one card
# ---------------------------------------------------------------------------

DP_RANKS = 2
DP_LOCAL_BATCH = TRAIN_BATCH // DP_RANKS      # phase 10's 32, as 2 x 16
DP_TIMED_STEPS = 5
DP_INT8_STEPS = 4
DP_LOOP_STEPS = 6
DP_CKPT_EVERY = 2
DP_FAULT_STEP = 5          # the newest checkpoint (step 4) is corrupted,
                           # then the step faults: walk back to step 2
DP_UPDATE_TOL = 1e-6       # of max |expected update|, distinct shards
DP_LOSS_TOL = 1e-6         # relative, distinct shards
DP_MASS_TOL = 1e-6         # of max |g|, the int8 reduction's mass
DP_TIMEOUT_S = 600         # one deadline for both rank processes


def _dp_gather(tensors, group) -> list:
    """Each rank's ``tensors`` (a list), concatenated flat and gathered
    over ``group``: one flat f32 tensor per rank."""
    import torch
    import torch.distributed as dist
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    parts = [torch.empty_like(flat) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, flat, group=group)
    return parts


def _dp_split(flat, like) -> list:
    out, at = [], 0
    for t in like:
        out.append(flat[at:at + t.numel()].reshape(t.shape))
        at += t.numel()
    return out


def _dp_differ(got, want) -> list[str]:
    """The leaves of two params trees that differ, each as "task/leaf max
    |diff|"."""
    import torch
    return [f"{name}/{leaf} {float((got[name][leaf] - v).abs().max()):.3e}"
            for name in want for leaf, v in want[name].items()
            if not torch.equal(got[name][leaf], v)]


def _dp_counts(reset: bool = False) -> dict:
    from repro_torch.kernels import conv2d_direct as k1
    from repro_torch.kernels import conv2d_wu as k2
    if reset:
        k1.launches = k1.launches_mma = k2.launches = k2.launches_mma = 0
    return {"k1": k1.launches, "k1_mma": k1.launches_mma,
            "k2": k2.launches, "k2_mma": k2.launches_mma}


def dp_rank(rank, group, *, workdir, device="cuda", full=True,
            image=IMAGE, classes=1000) -> dict:
    """One rank of phase 32 (``launch.ranks.run_ranks`` starts both, each
    on the one card): full ResNet-50 under the data-parallel step at 16
    images a rank, the checks of PERF.md section 2 held on this rank, and
    the reduced Qwen2 data-parallel step.  Returns this rank's numbers.
    ``device="cpu", full=False`` and a small ``image`` rehearse it on the
    CPU (one block a stage; no kernel launches to count)."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.backend import resolve_device
    from repro_torch.configs import get_config
    from repro_torch.convert import params_to
    from repro_torch.data import SyntheticImageData, SyntheticLMData
    from repro_torch.graph import GxM, resnet50
    from repro_torch.nn import transformer as T
    from repro_torch.optim import compress
    from repro_torch.optim.adamw import tree_leaves, tree_map
    from repro_torch.train import checkpoint as ckpt_lib
    from repro_torch.train import distributed as D
    from repro_torch.train.chaos import (ChaosEngine, ChaosSchedule,
                                         CorruptCheckpoint, StepFault)
    from repro_torch.train.fault_tolerance import (ResilientLoop,
                                                   elastic_reshard_cnn)
    from repro_torch.train.step import (make_cnn_train_step, make_train_step,
                                        to_device)

    def say(msg):
        print(f"  [rank {rank}] {msg}", flush=True)

    device = resolve_device(device)
    # the stem conv (C = 3) and its gradient are cuDNN's (kernels/ref.py),
    # whose default weight-gradient algorithms may sum in another order on
    # each call: the bit-for-bit checks below (identical shards, the chaos
    # replay) need one order, so this phase asks cuDNN for its
    # deterministic algorithms
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize()

    backend = dist.get_backend(group)
    probe = torch.full((4,), float(rank + 1), device=device)
    dist.all_reduce(probe, group=group)
    check(bool((probe == 3.0).all()), f"{backend} did not reduce a CUDA "
          f"tensor: {probe.tolist()}")
    say(f"backend {backend} (tensors on {device} reduced), {DP_RANKS} ranks"
        + (f" on {torch.cuda.get_device_name(0)}" if device.type == "cuda"
           else ""))
    gxm = GxM(resnet50(classes, stages=(3, 4, 6, 3) if full
                       else (1, 1, 1, 1)), device=device, num_classes=classes)
    params = gxm.init(torch.Generator().manual_seed(SEED))
    shards = [SyntheticImageData(hw=image, n_classes=classes,
                                 global_batch=TRAIN_BATCH, seed=SEED,
                                 n_shards=DP_RANKS, shard=s)
              for s in range(DP_RANKS)]
    mine = shards[rank]
    out = {"backend": backend}

    # -- identical shards, f32: the single-device step's bits ---------------
    same = to_device(shards[0].batch_at(0), device)
    dp = D.make_cnn_train_step_dp(gxm, group, lr=TRAIN_LR,
                                  grad_compress="off")
    state0 = D.init_cnn_train_state_dp(params, group, grad_compress="off")
    dp(state0, same)
    sync()
    times = []
    for _ in range(DP_TIMED_STEPS):
        sync()
        t0 = time.perf_counter()
        got, metrics = dp(state0, same)
        sync()
        times.append((time.perf_counter() - t0) * 1e3)
    _dp_counts(reset=True)
    got, metrics = dp(state0, same)
    sync()
    dp_counts = _dp_counts()
    single = make_cnn_train_step(gxm, lr=TRAIN_LR)
    _dp_counts(reset=True)
    ref_params, ref_loss = single(params, same)
    sync()
    single_counts = _dp_counts()
    say(f"identical shards: launches per rank {dp_counts}, single-device "
        f"step at batch {DP_LOCAL_BATCH} {single_counts}")
    expect = (113, 52) if device.type == "cuda" and full else \
        (dp_counts["k1"], dp_counts["k2"])
    check(dp_counts == single_counts and dp_counts["k1"] == expect[0]
          and dp_counts["k2"] == expect[1]
          and dp_counts["k1_mma"] == expect[0]
          and dp_counts["k2_mma"] == expect[1], f"the data-parallel step "
          f"launched {dp_counts}, the single-device step {single_counts}; expected "
          f"K1 113 and K2 52, all on the mma route")
    diff = _dp_differ(got["params"], ref_params)
    same_loss = float(metrics["loss"]) == float(ref_loss)
    say(f"identical shards: params equal bit for bit "
        f"{not diff}, loss {float(metrics['loss'])!r} vs single "
        f"{float(ref_loss)!r}")
    check(not diff and same_loss, f"identical shards differ from the "
          f"single-device step: {len(diff)} params leaves ({diff[:4]}), "
          f"loss equal {same_loss}")
    out.update(step_ms=times, step_ms_p50=float(np.median(times)),
               counts=dp_counts)
    del got, ref_params

    # -- distinct shards, f32: the reference's semantics ---------------------
    # each half's loss, statistics and gradients from the single-device
    # step's own first half (GxM.sgd_train_step is local_grads, then
    # apply_sgd), averaged here, then that step's SGD and BN update
    halves = [to_device(s_.batch_at(0), device) for s_ in shards]
    got, metrics = dp(state0, halves[rank])
    sync()
    parts = [gxm.local_grads(params, h) for h in halves]
    gavg = tree_map(lambda a, b: (a + b) / 2, parts[0][2], parts[1][2])
    savg = {k: tuple((a + b) / 2 for a, b in zip(parts[0][1][k],
                                                   parts[1][1][k]))
            for k in parts[0][1]}
    exp = gxm.apply_sgd(params, gavg, savg, TRAIN_LR, bn_momentum=0.9)
    max_upd = max(float((exp[n][k] - params[n][k]).abs().max())
                  for n in exp for k in exp[n])
    max_diff = max(float((got["params"][n][k] - exp[n][k]).abs().max())
                   for n in exp for k in exp[n])
    bits = all(torch.equal(got["params"][n][k], exp[n][k])
               for n in exp for k in exp[n])
    loss_exp = (float(parts[0][0]) + float(parts[1][0])) / 2
    loss_rel = abs(float(metrics["loss"]) - loss_exp) / abs(loss_exp)
    say(f"distinct shards: max |diff| {max_diff:.3e} of max |expected "
        f"update| {max_upd:.3e} ({max_diff / max_upd:.3e}; limit "
        f"{DP_UPDATE_TOL}), bits equal {bits}; loss {loss_rel:.3e} relative "
        f"(limit {DP_LOSS_TOL})")
    check(max_diff <= DP_UPDATE_TOL * max_upd, f"distinct shards: params "
          f"{max_diff:.3e} from the reference's semantics, over "
          f"{DP_UPDATE_TOL} x {max_upd:.3e}")
    check(loss_rel <= DP_LOSS_TOL, f"distinct shards: loss {loss_rel:.3e} "
          f"relative from the mean of the halves'")
    out.update(distinct=dict(rel=max_diff / max_upd, bits_equal=bits,
                             loss_rel=loss_rel))

    # -- the reductions alone, by host clock ---------------------------------
    grads = parts[rank][2]
    leaves = tree_leaves(grads)
    reduce_ms = {}
    for name_, fn in (
            ("f32", lambda: D.allreduce_mean(leaves, group)),
            ("int8", lambda: compress.compressed_psum_tree(
                grads, group, tree_map(torch.zeros_like, grads)))):
        fn()
        ts = []
        for _ in range(3):
            sync()
            t0 = time.perf_counter()
            fn()
            sync()
            ts.append((time.perf_counter() - t0) * 1e3)
        reduce_ms[name_] = float(np.median(ts))
    wire = {"f32": 4 * sum(t.numel() for t in leaves),
            "int8": compress.wire_bytes(grads)}
    say(f"reduction of {len(leaves)} leaves, {sum(t.numel() for t in leaves)}"
        f" values: f32 {reduce_ms['f32']:.3f} ms, {wire['f32']} bytes; int8 "
        f"{reduce_ms['int8']:.3f} ms, {wire['int8']} bytes (int32 codes)")
    out.update(reduce_ms=reduce_ms, wire_bytes=wire)
    del got, parts, gavg, savg, exp, grads, leaves, halves, same

    # -- int8: the formula on the card, and no gradient mass lost -----------
    dp8 = D.make_cnn_train_step_dp(gxm, group, lr=TRAIN_LR,
                                   grad_compress="int8", return_grads=True)
    st = D.init_cnn_train_state_dp(params, group, grad_compress="int8")
    losses, worst_mass, formula_bits = [], 0.0, True
    for i in range(DP_INT8_STEPS):
        old_r = [r[0] for r in tree_leaves(st["residual"])]
        new, metrics = dp8(st, mine.batch_at(1 + i))
        g_loc = tree_leaves(metrics["local_grads"])
        red = tree_leaves(metrics["grads"])
        new_r = [r[0] for r in tree_leaves(new["residual"])]
        gs = [_dp_split(f, g_loc) for f in _dp_gather(g_loc, group)]
        rs = [_dp_split(f, old_r) for f in _dp_gather(old_r, group)]
        nrs = [_dp_split(f, new_r) for f in _dp_gather(new_r, group)]
        for j, want in enumerate(red):
            g32 = [gs[r_][j] + rs[r_][j] for r_ in range(DP_RANKS)]
            scale = torch.stack([x.abs().max() / 127.0 + 1e-12
                                 for x in g32]).max()
            acc = sum(torch.clamp(torch.round(x / scale), -127, 127)
                      .to(torch.int8).to(torch.int32) for x in g32)
            formula = acc.to(torch.float32) * scale / float(DP_RANKS)
            formula_bits &= torch.equal(formula, want)
            lhs = DP_RANKS * want + sum(nrs[r_][j] for r_ in range(DP_RANKS))
            rhs = sum(g32)
            gmax = max(float(gs[r_][j].abs().max()) for r_ in range(DP_RANKS))
            err = float((lhs - rhs).abs().max())
            check(err <= DP_MASS_TOL * gmax, f"int8 step {i}: leaf {j} lost "
                  f"gradient mass: {err:.3e} > {DP_MASS_TOL} x {gmax:.3e}")
            worst_mass = max(worst_mass, err / gmax if gmax else err)
        losses.append(float(metrics["loss"]))
        st = new
        del gs, rs, nrs, metrics
    say(f"int8: {DP_INT8_STEPS} steps, losses {losses}, reduced gradients "
        f"equal compressed_psum's formula on the gathered gradients bit for "
        f"bit {formula_bits}, worst mass error {worst_mass:.3e} of max |g| "
        f"(limit {DP_MASS_TOL})")
    check(formula_bits, "the int8 step's reduced gradient differs from "
          "compressed_psum's formula on the gathered gradients")
    check(all(math.isfinite(v) for v in losses), f"int8 losses {losses}")
    out.update(int8=dict(losses=losses, mass_rel=worst_mass))
    del st, new

    # -- checkpoint I/O of the gathered state ---------------------------------
    st = D.init_cnn_train_state_dp(params, group, grad_compress="int8")
    io_dir = os.path.join(workdir, "ckpt_io")
    sync()
    t0 = time.perf_counter()
    snap = D.gather_cnn_state(st, group)
    if rank == 0:
        ckpt_lib.save(io_dir, 1, snap)
    save_s = time.perf_counter() - t0
    dist.barrier(group=group)
    t0 = time.perf_counter()
    back, _ = ckpt_lib.restore_latest(io_dir, snap)
    back = D.reshard_cnn_state(back, group)
    sync()
    restore_s = time.perf_counter() - t0
    nbytes = sum(t.numel() * t.element_size() for t in tree_leaves(snap))
    say(f"checkpoint of the gathered int8 state ({nbytes} bytes): save "
        f"{save_s:.3f} s (gather + write by rank 0), restore {restore_s:.3f}"
        f" s (read + this rank's row)")
    out.update(ckpt=dict(bytes=nbytes, save_s=save_s, restore_s=restore_s))
    del st, snap, back

    # -- resilience: a chaos replay against an uninterrupted run ------------
    class Shard:
        def batch_at(self, step):
            return mine.batch_at(100 + step)

    finals, loops = [], []
    for name_, chaos in (("clean", False), ("chaos", True)):
        ckpt_dir = os.path.join(workdir, f"ckpt_{name_}")
        engine = None
        if chaos:
            engine = ChaosEngine(
                ChaosSchedule((CorruptCheckpoint(DP_FAULT_STEP),
                               StepFault(DP_FAULT_STEP))),
                hosts=["host0", "host1"], ckpt_dir=ckpt_dir,
                writer=rank == 0)
        kw = D.cnn_dp_resilience(ckpt_dir, group)
        loop = ResilientLoop(
            step_fn=D.make_cnn_train_step_dp(gxm, group, lr=TRAIN_LR,
                                             grad_compress="int8"),
            state=D.init_cnn_train_state_dp(params, group,
                                            grad_compress="int8"),
            data=Shard(), ckpt_dir=ckpt_dir, ckpt_every=DP_CKPT_EVERY,
            policy_every=0, chaos=engine,
            heartbeat=engine.make_heartbeat() if engine else None, **kw)
        t0 = time.perf_counter()
        finals.append(loop.run(DP_LOOP_STEPS))
        sync()
        loops.append((loop, time.perf_counter() - t0, kw["restore_fn"]))
    (clean, clean_s, _), (hit, hit_s, restore_fn) = loops
    diff = _dp_differ(finals[1]["params"], finals[0]["params"])
    rdiff = [i for i, (a, b) in enumerate(zip(
        tree_leaves(finals[0]["residual"]),
        tree_leaves(finals[1]["residual"]))) if not torch.equal(a, b)]
    skipped = [s_ for s_, _ in restore_fn.skipped]
    summary = hit.resilience_summary()
    say(f"resilience: {DP_LOOP_STEPS} int8 steps, checkpoints every "
        f"{DP_CKPT_EVERY}; under chaos {summary} in {hit_s:.2f} s "
        f"(uninterrupted {clean_s:.2f} s), walked past checkpoints "
        f"{skipped}; params equal bit for bit {not diff}, residual "
        f"{not rdiff}")
    check(summary["restarts"] == 1 and summary["lost_steps"] == 3
          and skipped == [4], f"the chaos run recovered otherwise than by "
          f"one restart from step 2 past the corrupted step 4: {summary}, "
          f"skipped {skipped}")
    check(not diff and not rdiff, f"the chaos replay's state differs from "
          f"the uninterrupted run's: params {diff[:4]}, "
          f"{len(rdiff)} residual leaves")
    out.update(resilience=dict(summary, skipped=skipped, seconds=hit_s,
                               clean_seconds=clean_s))

    # -- elastic 2 -> 1 from the chaos run's last checkpoint -----------------
    ckpt_dir = os.path.join(workdir, "ckpt_chaos")
    last = ckpt_lib.latest_step(ckpt_dir)
    one = dist.new_group([0])
    if rank == 0:
        full_t = dict(finals[1], residual=tree_map(
            lambda r: torch.zeros((DP_RANKS, *r.shape[1:]), device=device),
            finals[1]["residual"]))
        whole = ckpt_lib.restore(ckpt_dir, last, full_t)
        folded = elastic_reshard_cnn(ckpt_dir, last, full_t, one)
        kept = all(torch.equal(f[0], w[0] + w[1]) for f, w in zip(
            tree_leaves(folded["residual"]), tree_leaves(whole["residual"])))
        mass = sum(float(w.abs().sum()) for w in
                   tree_leaves(whole["residual"]))
        say(f"elastic 2 -> 1 from checkpoint step {last}: the residual's "
            f"rows fold to one, their sum kept exactly {kept} (total |r| "
            f"{mass:.3e})")
        check(kept and mass > 0, "the 2 -> 1 fold did not keep the residual's "
              "sum exactly (or the residual was empty)")
        out.update(elastic=dict(step=last, kept=kept))
    dist.barrier(group=group)
    del finals, loops, clean, hit
    torch.cuda.empty_cache()

    # -- the LM: reduced f32 Qwen2, data-parallel step vs the full batch -----
    cfg = dataclasses.replace(get_config(TRAIN_ARCH), **TRAIN_PARITY)
    base = T.init_lm(cfg, torch.Generator(device=device).manual_seed(SEED),
                     device=device)
    b, l = TRAIN_PARITY_BATCH
    full = SyntheticLMData(cfg.vocab, l, b, seed=SEED + 29).batch_at(0)
    half = {k: v[rank * b // DP_RANKS:(rank + 1) * b // DP_RANKS]
            for k, v in full.items()}
    runs = {}
    for name_, batch, grp in (("single", full, None), ("dp", half, group)):
        p = params_to(base, device)
        state = {"params": p, "opt": {}, "step": torch.zeros(
            (), dtype=torch.int32, device=device)}
        step = make_train_step(cfg, Sgd(), lr=PARITY_LR, clip=1.0, group=grp)
        state, m = step(state, batch)
        runs[name_] = (float(m["loss"]), state["params"])
    loss_rel = abs(runs["dp"][0] - runs["single"][0]) / abs(runs["single"][0])
    upd = max(float((a.detach() - c.detach()).abs().max()) for a, c in zip(
        tree_leaves(runs["single"][1]), tree_leaves(base)))
    dif = max(float((a.detach() - c.detach()).abs().max()) for a, c in zip(
        tree_leaves(runs["dp"][1]), tree_leaves(runs["single"][1])))
    say(f"LM: {cfg.name} f32 (Dh {cfg.head_dim}, {cfg.n_layers} layers, "
        f"vocab {cfg.vocab}), 2 ranks of {b // DP_RANKS} x {l} against one "
        f"step on {b} x {l}, SGD lr {PARITY_LR}: loss {loss_rel:.3e} "
        f"relative (limit {LOSS_REL_TOL}), update {dif / upd:.3e} of max "
        f"|update| (limit {UPDATE_REL_TOL})")
    check(loss_rel <= LOSS_REL_TOL and dif <= UPDATE_REL_TOL * upd,
          f"the data-parallel LM step differs from the full-batch step: loss "
          f"{loss_rel:.3e}, update {dif / upd:.3e}")
    out.update(lm=dict(loss_rel=loss_rel, update_rel=dif / upd))
    return out


def dp_phase(card: str) -> dict:
    """Phase 32: two rank processes on the one card over a gloo group
    (``launch.ranks.run_ranks``, a ``file://`` rendezvous), each running
    ``dp_rank``; a rank that fails a check fails the phase.  ``card`` is
    the header's name and power limit, printed beside the phase's
    numbers.  Returns both ranks' numbers."""
    from repro_torch.launch.ranks import run_ranks
    print(f"\ndata-parallel and resilient training: full ResNet-50 "
          f"{IMAGE}x{IMAGE}, 1000 classes, {DP_RANKS} ranks of "
          f"{DP_LOCAL_BATCH} on one card over gloo (NCCL refuses two ranks "
          f"on one device)", flush=True)
    workdir = tempfile.mkdtemp()
    t0 = time.perf_counter()
    try:
        results, _ = run_ranks(
            "chip_smoke:dp_rank", DP_RANKS, workdir=workdir,
            args={"workdir": workdir}, timeout_s=DP_TIMEOUT_S,
            env={"PYTHONPATH": os.pathsep.join([SRC, ROOT])}, echo=True)
    finally:
        # the phase's checkpoints of full ResNet-50 and the ranks' logs
        shutil.rmtree(workdir, ignore_errors=True)
    seconds = time.perf_counter() - t0
    r0 = results[0]
    p50 = [round(r["step_ms_p50"], 3) for r in results]
    print(f"  ranks done in {seconds:.1f}s (start-up included); step p50 by "
          f"host clock per rank {p50} ms; reduction {r0['reduce_ms']} ms for {r0['wire_bytes']} bytes;"
          f" checkpoint save {r0['ckpt']['save_s']:.3f} s, restore "
          f"{r0['ckpt']['restore_s']:.3f} s ({r0['ckpt']['bytes']} bytes); "
          f"card {card}")
    return {"seconds": seconds, "card": card, "ranks": results}


def totals(rows) -> dict:
    """Per-pass sums over signature records (each time x its count; a
    library time only where one exists), and what bounds most of the
    bound."""
    out = {key: sum(r[key] * r["count"] for r in rows
                    if r[key] is not None)
           for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
    by = {}
    for r in rows:
        by[r["bound_by"]] = by.get(r["bound_by"], 0.0) \
            + r["bound_ms"] * r["count"]
    out["bound_by"] = max(by, key=by.get)
    return out


def main() -> int:
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print("chip_smoke: src/repro_torch not found beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only",
              file=sys.stderr)
        return 1
    from repro_torch.graph import build_etg, resnet50

    # every phase reads a cold plan cache of its own (a phase that tunes
    # points REPRO_TUNE_CACHE elsewhere and back), so the main paths run
    # the kernels' default plans
    cold = tempfile.TemporaryDirectory()
    os.environ["REPRO_TUNE_CACHE"] = os.path.join(cold.name, "cold.json")
    t_start = time.perf_counter()
    with phase("1 (header, kernel builds)"):
        card, device = header()
    sigs = serving_signatures()
    with phase("2 (K1 serving signatures)"):
        rows = kernel_signatures(device, sigs)
    with phase("3 (ResNet-50 serving)"):
        engine, serve_launches, f32_stats = serving(device)
        serve = totals(rows)
        breakdown(engine, serve["ms"])
    with phase("4 (serving parity)"):
        parity(engine)
    params = serve_params = engine.params
    del engine
    torch.cuda.empty_cache()

    with phase("5 (K3 signatures)"):
        q8_rows = q8_signatures(device, sigs, rows)
    k3 = totals(q8_rows)
    k3_lib_convs_ms = sum(r["ms"] * r["count"] for r in q8_rows
                          if r["library_ms"] is not None)
    with phase("6 (int8 serving)"):
        engine, q8_launches, q8_stats = int8_serving(device, params,
                                                     f32_stats)
        q8_step = int8_breakdown(engine, k3["ms"])
    with phase("7 (int8 parity)"):
        q8_parity = int8_parity(engine)
    # phase 3's params and phase 6's quantized tree serve phases 23 and 24
    q8_gxm, qparams = engine.gxm, engine.qparams
    del engine
    torch.cuda.empty_cache()
    with phase("7b (Inception-v3 serving)"):
        inception = inception_serving(device, f32_stats, q8_stats)

    fwd, dual, wu = training_signatures(build_etg(resnet50()))
    check((sum(fwd.values()), sum(dual.values()), len(dual), len(wu)) ==
          (52, 61, 31, 22), "ResNet-50's training signatures are not the "
          "52 forward, 61 (31 distinct) dual and 22 weight-update ones")
    with phase("8 (K1 training signatures)"):
        k1_rows = train_k1_signatures(device, fwd, dual)
    with phase("9 (K2 signatures)"):
        wu_rows = wu_signatures(device, wu)
    with phase("10 (ResNet-50 training)"):
        train_counts, summary = training(device, fwd, dual, wu)
    k1_fwd = totals([r for r in k1_rows if r["role"] == "fwd"])
    k1_dual = totals([r for r in k1_rows if r["role"] == "dual"])
    k2 = totals(wu_rows)
    print(f"  per step from the CUDA-event times x launches: K1 forward "
          f"{k1_fwd['ms']:.3f} ms + dual {k1_dual['ms']:.3f} ms, K2 "
          f"{k2['ms']:.3f} ms; of a {summary['step_ms']:.3f} ms step")
    with phase("11 (training parity)"):
        summary["parity"] = train_parity(device)
    torch.cuda.empty_cache()

    with phase("12 (K4 signatures)"):
        k4_rows = streams_signatures(device, sigs)
    with phase("13 (tuned replay)"):
        tuned_rows, tuned = tuned_replay(device, sigs, k4_rows)
    k4_analytic = totals(k4_rows)
    k4_tuned = totals(tuned_rows)

    def weighted(rows_, key):
        return sum(r_[key] * r_["count"] for r_ in rows_)
    print(f"  per {sum(sigs.values())}-conv forward (x count): tuned K4 "
          f"{k4_tuned['ms']:.3f} ms by events, "
          f"{weighted(tuned_rows, 'device_ms'):.3f} device (SIMT route "
          f"forced {weighted(tuned_rows, 'simt_ms'):.3f} / "
          f"{weighted(tuned_rows, 'simt_device_ms'):.3f}); analytic K4 "
          f"{k4_analytic['ms']:.3f} / "
          f"{weighted(k4_rows, 'device_ms'):.3f} (SIMT route forced "
          f"{weighted(k4_rows, 'simt_ms'):.3f} / "
          f"{weighted(k4_rows, 'simt_device_ms'):.3f}); K1 with bias+ReLU "
          f"{weighted(k4_rows, 'k1_ms'):.3f} / "
          f"{weighted(k4_rows, 'k1_device_ms'):.3f}; cuDNN "
          f"{k4_analytic['library_ms']:.3f}; plain replay "
          f"{k4_tuned['plain_ms']:.3f} (tuned schedules), "
          f"{k4_analytic['plain_ms']:.3f} (analytic); bounds "
          f"{k4_analytic['bound_ms']:.3f} ({k4_analytic['bound_by']}, f32 "
          f"SIMT), {weighted(k4_rows, 'mma_bound_ms'):.3f} (3xTF32)")
    torch.cuda.empty_cache()
    with phase("13b (plan tuning)"):
        planned = plan_tuning(device, sigs, fwd, dual, wu, serve_params)
    torch.cuda.empty_cache()

    from repro_torch.configs import get_config
    from repro_torch.kernels import attention as k7
    from repro_torch.kernels import conv1d_causal as k8
    from repro_torch.kernels import moe_gmm as k9

    with phase("14 (K7 signatures)"):
        attn_rows = attention_signatures(device)
    with phase("15 (K6 signatures)"):
        mm_rows, mm_launches, mm_ragged = matmul_signatures(device)
    with phase("16 (Qwen2-1.5B serving)"):
        lm_launches, lm_summary, params, _ = lm_serving(
            device, LM_ARCH,
            (28, 1536, 12, 2, 128, 8960, 151936, "bfloat16"),
            {"flash_attention": (k7, "flash_attention_kernel", 28, 0)},
            {"flash_attention": (28, 0)})
        del params
    torch.cuda.empty_cache()
    with phase("17 (Qwen2-1.5B parity)"):
        cfg = dataclasses.replace(get_config(LM_ARCH), dtype="float32")
        lm_summary["parity"] = lm_parity(init_on_card(cfg), cfg,
                                         LM_PARITY_PROMPTS)
    torch.cuda.empty_cache()

    with phase("18 (K8 signatures)"):
        conv_rows = conv1d_signatures(device)
    with phase("18b (K9 signatures)"):
        moe_rows, one_expert_ratio = moe_signatures(device)
    torch.cuda.empty_cache()
    # the cut's period: 7 Mamba + 1 attention mixers, 4 MoE MLPs of 3 K9
    # products each, in every forward and every decode step
    with phase("19 (hybrid serving)"):
        hy_launches, hy_summary, params, cfg = lm_serving(
            device, HYBRID_ARCH, HYBRID_WIDTHS,
            {"conv1d_causal": (k8, "conv1d_causal_kernel", 7, 0),
             "flash_attention": (k7, "flash_attention_kernel", 1, 0),
             "moe_gmm": (k9, "moe_gmm_kernel", 12, 12)},
            {"flash_attention": (1, 0), "moe_gmm": (12, 0)},
            {"conv1d_causal": ("launches_tile", "_tile", 7, 0)})
    with phase("20 (decode vs forward)"):
        bf16 = decode_vs_forward(params, cfg)
        print(f"  bf16: {bf16['rel']:.3e} of max |logit|, printed and not "
              f"held to {BF16_DECODE_REL_TOL}: this random-weight model "
              f"moves its logits by more than that under any other rounding "
              f"of its bf16 activations (PERF.md section 5); the f32 model "
              f"below is held to {DECODE_REL_TOL}")
        del params
        torch.cuda.empty_cache()
        cfg, available_gb = hybrid_parity_cfg()
        params = init_on_card(cfg)
        f32 = decode_vs_forward(params, cfg)
        check(f32["rel"] <= DECODE_REL_TOL,
              f"f32 decode differs from forward by {f32['rel']:.3e} > "
              f"{DECODE_REL_TOL} of max |logit|")
    hy_summary["decode_vs_forward"] = dict(bfloat16=bf16, float32=f32)
    with phase("21 (hybrid parity)"):
        hy_summary["parity"] = dict(
            lm_parity(params, cfg, HYBRID_PARITY_PROMPTS),
            expert_share=cfg.moe.expert_share,
            host_available_gb=available_gb)
        del params
    torch.cuda.empty_cache()

    with phase("22 (K10a signatures)"):
        whole_rows = whole_signatures(device, sigs, rows)
    with phase("23 (whole-plane serving)"):
        whole_launches, whole_summary = whole_serving(device, serve_params)
    with phase("24 (K10c signatures)"):
        k10c_rows, k10c_launches, k10c_summary = whole_q8(
            device, sigs, q8_rows, q8_gxm, qparams)
    with phase("24b (chains)"):
        chains = chains_phase(device, serve_params, q8_gxm, qparams)
    with phase("24c (whole blockings tuned)"):
        whole_planned = whole_plan_tuning(device, sigs, fwd, dual, wu,
                                          serve_params)
    del serve_params, q8_gxm, qparams
    torch.cuda.empty_cache()
    with phase("25 (K10b signatures)"):
        k10b_rows = whole_wu(device, wu, wu_rows)
    with phase("26 (whole-plane training)"):
        whole_counts, whole_train = whole_training(device, fwd, dual, wu,
                                                   summary)
        whole_train["parity"] = train_parity(device, "whole")
    torch.cuda.empty_cache()
    with phase("27 (K5)"):
        pool, pool_launches = pool_phase(device)
    torch.cuda.empty_cache()

    with phase("28 (K7 backward signatures)"):
        bwd_rows = attention_bwd_signatures(device)
    with phase("29 (Qwen2-1.5B training)"):
        (train_fwd, train_bwd), lm_train = lm_training(device)
        lm_train["parity"] = lm_train_parity(
            dataclasses.replace(get_config(TRAIN_ARCH), **TRAIN_PARITY),
            TRAIN_PARITY_BATCH)
    with phase("30 (RWKV-6)"):
        rwkv = rwkv_phase(device)
    with phase("31 (hybrid and MoE training)"):
        hybrid_train = hybrid_training_phase(device)
    hy_train = hybrid_train["counts"]
    torch.cuda.empty_cache()
    with phase("32 (data-parallel and resilient training)"):
        dp_train = dp_phase(card)
    dp_k1 = sum(r_["counts"]["k1"] for r_ in dp_train["ranks"])
    dp_k1_mma = sum(r_["counts"]["k1_mma"] for r_ in dp_train["ranks"])
    dp_k2 = sum(r_["counts"]["k2"] for r_ in dp_train["ranks"])
    dp_k2_mma = sum(r_["counts"]["k2_mma"] for r_ in dp_train["ranks"])
    k10a = totals(whole_rows)
    k10b = totals(k10b_rows)
    k10c = totals(k10c_rows)
    print(f"\nwhole plane against tiled, per 52-conv forward at batch {BATCH} "
          f"(x count, CUDA events): K10a {k10a['ms']:.3f} ms vs K1 "
          f"{weighted(whole_rows, 'k1_ms'):.3f}; K10c {k10c['ms']:.3f} vs K3 "
          f"{weighted(k10c_rows, 'k3_ms'):.3f}; per 52-launch weight "
          f"gradient at batch {TRAIN_BATCH}: K10b {k10b['ms']:.3f} vs K2 "
          f"{weighted(k10b_rows, 'k2_ms'):.3f}")
    lags = [lag for _, _, lag in TRACES if lag is not None]
    print(f"\nprofiler: {len(TRACES)} traces kept, "
          f"{sum(n for _, n, _ in TRACES)} refused and retaken; least "
          f"kernel-start minus launch-call time {TRACES[0][2]} ms in the "
          f"first ({TRACES[0][0]:.0f} s in), {TRACES[-1][2]} ms in the last "
          f"({TRACES[-1][0]:.0f} s in), {min(lags)} ms at least")
    total_s = time.perf_counter() - t_start
    print(f"all phases in {total_s:.1f}s of the {RUN_BUDGET_S} s budget "
          f"({total_s / RUN_BUDGET_S:.3f}); by phase: "
          + ", ".join(f"{name} {sec:.1f}s"
                      for name, sec in PHASE_SECONDS.items()))

    def timing(d):
        return {key: d[key] for key in ("ms", "plain_ms", "library_ms",
                                        "bound_ms", "bound_by")}
    chain_k1 = chains["resnet50"]["tiled_16MiB"]["launches_on"]
    chain_k10a = chains["resnet50"]["whole_16MiB"]["launches_on"]
    kernels = [{
        "name": "conv2d_direct",
        "route": "cuda",
        "source": "src/repro_torch/csrc/conv2d_direct.cu",
        "replaces": "src/repro/kernels/conv2d_direct.py:295",
        "launches": serve_launches + train_counts["conv2d_direct"]
        + chain_k1 + dp_k1,
        "launches_mma": serve_launches + train_counts["conv2d_direct_mma"]
        + chain_k1 + dp_k1_mma,
        "launches_by_path": {"serving": serve_launches,
                             "training_step": train_counts["conv2d_direct"],
                             "chains": chain_k1,
                             "dp_training_step_both_ranks": dp_k1},
        "launches_by_path_chains_1MiB": chains["resnet50"][
            "tiled_1MiB"]["launches_on"],
        "max_abs_err": max(r["max_abs_err"] for r in rows + k1_rows),
        "max_rel_err": max(r["max_rel_err"] for r in rows + k1_rows),
        **timing(serve),
        "device_ms": weighted(rows, "device_ms"),
        "mma_bound_ms": weighted(rows, "mma_bound_ms"),
        "bound_is": "f32 on the SIMT cores; mma_bound_ms: 3 x the FLOPs at "
                    "the TF32 tensor-core rate (3xTF32), or the bytes",
        "routes": {"C and K multiples of 4, 16-byte aligned": "mma "
                   "(3xTF32 on mma.sync m16n8k8, csrc/conv_tf32.cuh)",
                   "the rest": "simt (f32 FMA)"},
        "per": f"the 52 K1 convs of one ResNet-50 forward, batch {BATCH}, "
               f"{IMAGE}x{IMAGE}, by CUDA events (device_ms: profiler, a "
               f"split's sum pass included)",
        "training": {"forward": timing(k1_fwd), "dual": timing(k1_dual),
                     "forward_device_ms": weighted(
                         [r_ for r_ in k1_rows if r_["role"] == "fwd"],
                         "device_ms"),
                     "dual_device_ms": weighted(
                         [r_ for r_ in k1_rows if r_["role"] == "dual"],
                         "device_ms"),
                     "forward_mma_bound_ms": weighted(
                         [r_ for r_ in k1_rows if r_["role"] == "fwd"],
                         "mma_bound_ms"),
                     "dual_mma_bound_ms": weighted(
                         [r_ for r_ in k1_rows if r_["role"] == "dual"],
                         "mma_bound_ms"),
                     "per": f"one ResNet-50 training step, batch "
                            f"{TRAIN_BATCH}: 52 bare forwards and 61 dual "
                            f"convs"},
        "launches_tuned": {
            "serving": planned["serving_f32"]["cache"]["k1"],
            "training_step": planned["training"]["counts"]["k1"]},
        "tuned_plans": {key: planned["sums"][key] for key in (
            "forward_f32", "step_forward", "step_dual")},
        "launches_by_path_inception": {
            "serving": inception["f32"]["launches"]},
        "card": card,
    }, {
        "name": "conv2d_wu",
        "route": "cuda",
        "source": "src/repro_torch/csrc/conv2d_wu.cu",
        "replaces": "src/repro/kernels/conv2d_wu.py:159",
        "launches": train_counts["conv2d_wu"] + dp_k2,
        "launches_mma": train_counts["conv2d_wu_mma"] + dp_k2_mma,
        "launches_by_path": {"training_step": train_counts["conv2d_wu"],
                             "dp_training_step_both_ranks": dp_k2},
        "max_abs_err": max(r["max_abs_err"] for r in wu_rows),
        "max_rel_err": max(r["max_rel_err"] for r in wu_rows),
        **timing(k2),
        "device_ms": weighted(wu_rows, "device_ms"),
        "mma_bound_ms": weighted(wu_rows, "mma_bound_ms"),
        "bound_is": "f32 on the SIMT cores; mma_bound_ms: 3 x the FLOPs at "
                    "the TF32 tensor-core rate (3xTF32), or the bytes",
        "routes": {"C and K multiples of 4, 16-byte aligned": "mma "
                   "(3xTF32 on mma.sync m16n8k8)", "the rest": "simt "
                   "(f32 FMA)"},
        "per": f"the 52 K2 launches of one ResNet-50 training step, batch "
               f"{TRAIN_BATCH}, by CUDA events (device_ms: profiler, the "
               f"reduction pass included)",
        "launches_tuned": {
            "training_step": planned["training"]["counts"]["k2"]},
        "tuned_plans": {"step_wu": planned["sums"]["step_wu"]},
        "card": card,
    }, {
        "name": "conv2d_q8",
        "route": "cuda",
        "source": "src/repro_torch/csrc/conv2d_q8.cu",
        "replaces": "src/repro/kernels/conv2d_q8.py:204",
        "launches": q8_launches,
        "launches_ring": q8_launches,
        "launches_by_path": {"serving_int8": q8_launches},
        "max_abs_err": max(max(r["max_abs_err"], r["sync_abs_err"])
                           for r in q8_rows),
        "ms": k3["ms"], "device_ms": weighted(q8_rows, "k3_device_ms"),
        "sync_forced": {"ms": weighted(q8_rows, "ms_sync"),
                        "device_ms": weighted(q8_rows, "k3_device_ms_sync")},
        "routes": {"C % 16 == 0 and K % 8 == 0": "ring (weights laid out "
                   "once as (R, S, K, C), a cp.async ring of (r, s) x 64 or "
                   "128 channels, ldmatrix + mma.sync m16n8k32 s8, the "
                   "reduction split across CTAs where ring_plan takes it, "
                   "the output staged through shared memory)",
                   "the rest": "sync (mma.sync m16n8k32 s8, one 32-channel "
                   "step a barrier through registers)"},
        "plain_ms": k3["plain_ms"],
        "library_ms": k3["library_ms"],
        "library_covers": "the 1x1 convs only (torch._int_mm + dequant and "
                          "epilogue in torch); K3 on the same convs: "
                          f"{k3_lib_convs_ms:.4f} ms",
        "bound_ms": k3["bound_ms"], "bound_by": k3["bound_by"],
        "k1_f32_ms": serve["ms"],
        "per": f"the 52 K3 convs of one int8 ResNet-50 forward, batch "
               f"{BATCH}, {IMAGE}x{IMAGE}",
        "launches_tuned": {
            "serving_int8": planned["serving_int8"]["cache"]["k3"]},
        "tuned_plans": {"forward_int8": planned["sums"]["forward_int8"]},
        "launches_by_path_inception": {
            "serving_int8": inception["int8"]["launches"]},
        "card": card,
    }, {
        "name": "conv2d_streams",
        "route": "cuda",
        "source": "src/repro_torch/csrc/conv2d_streams.cu",
        "replaces": "src/repro/kernels/conv2d_streams.py:104",
        "launches": tuned["replay_launches"],
        "launches_mma": tuned["replay_mma"],
        "launches_by_path": {"replay": tuned["replay_launches"],
                             "tuning": tuned["launches"]},
        "max_abs_err": max(r_["max_abs_err"] for r_ in k4_rows + tuned_rows),
        "max_rel_err": max(r_["max_rel_err"] for r_ in k4_rows + tuned_rows),
        **timing(k4_tuned),
        "device_ms": weighted(tuned_rows, "device_ms"),
        "mma_bound_ms": weighted(k4_rows, "mma_bound_ms"),
        "bound_is": "f32 on the SIMT cores; mma_bound_ms: 3 x the FLOPs at "
                    "the TF32 tensor-core rate, or the bytes",
        "simt_forced": {"ms": weighted(tuned_rows, "simt_ms"),
                        "device_ms": weighted(tuned_rows, "simt_device_ms"),
                        "analytic_ms": weighted(k4_rows, "simt_ms"),
                        "analytic_device_ms": weighted(k4_rows,
                                                       "simt_device_ms")},
        "routes": {"C, K, c_blk, k_blk multiples of 4, 16-byte aligned":
                   "mma (3xTF32 on mma.sync m16n8k8, csrc/conv_tf32.cuh)",
                   "the rest": "simt (f32 FMA)"},
        "analytic_ms": k4_analytic["ms"],
        "analytic_device_ms": weighted(k4_rows, "device_ms"),
        "k1_bias_relu_ms": weighted(k4_rows, "k1_ms"),
        "k1_bias_relu_device_ms": weighted(k4_rows, "k1_device_ms"),
        "tuning_seconds": tuned["seconds"],
        "candidates_timed": tuned["timed"],
        "per": f"the {sum(sigs.values())} lane-aligned convs of one "
               f"ResNet-50 forward, batch {BATCH}, {IMAGE}x{IMAGE}, with "
               f"bias and ReLU as fused, tuned 'streams' blockings (the "
               f"replay pass launches each of the {len(sigs)} signatures "
               f"once)",
        "card": card,
    }]
    k7_row = next(r_ for r_ in attn_rows if (r_["dtype"], r_["b"], r_["l"],
                                              r_["causal"]) ==
                  ("bfloat16", 1, 1024, True))
    k7_f32 = next(r_ for r_ in attn_rows if (r_["dtype"], r_["b"], r_["l"],
                                              r_["causal"]) ==
                  ("float32", 1, 1024, True))
    mm_bf16 = totals([r_ for r_ in mm_rows if r_["dtype"] == "bfloat16"])
    mm_f32 = totals([r_ for r_ in mm_rows if r_["dtype"] == "float32"])
    lm_wgmma = lm_summary["window"]["launches_wgmma"]
    hy_wgmma = hy_summary["window"]["launches_wgmma"]
    kernels += [{
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/attention.py:87",
        "launches": lm_launches["flash_attention"]
        + hy_launches["flash_attention"] + train_fwd
        + hy_train["k7.launches"],
        "launches_wgmma": lm_wgmma["flash_attention"]
        + hy_wgmma["flash_attention"] + train_fwd
        + hy_train["k7.launches_wgmma"],
        "launches_by_path": {
            "lm_serving": lm_launches["flash_attention"],
            "hybrid_serving": hy_launches["flash_attention"],
            "lm_training": train_fwd,
            "hybrid_training": hy_train["k7.launches"]},
        "max_abs_err": max(r_["max_abs_err"] for r_ in attn_rows),
        "max_rel_err": max(r_["max_rel_err"] for r_ in attn_rows),
        **{key: k7_row[key] for key in ("ms", "plain_ms", "library_ms",
                                        "bound_ms", "bound_by",
                                        "device_ms", "library_device_ms",
                                        "key_block",
                                        "device_ms_by_key_block")},
        "f32": {key: k7_f32[key] for key in ("ms", "plain_ms", "library_ms",
                                             "bound_ms", "bound_by")},
        "routes": {"bfloat16, Dh 64 and 128": "wgmma (TMA + wgmma bf16)",
                   "float32; bfloat16 at Dh 16": "simt (f32 FMA)"},
        "per": "one launch at Qwen2-1.5B's prefill shape: batch 1, 1024 "
               "tokens, 12 query / 2 KV heads, Dh 128, causal, bf16 through "
               "the wgmma route (28 launches per prefill); library: "
               "F.scaled_dot_product_attention",
        "card": card,
    }, {
        "name": "matmul_fused",
        "route": "cuda",
        "source": "src/repro_torch/csrc/matmul_fused.cu",
        "replaces": "src/repro/kernels/matmul_fused.py:85",
        "launches": mm_launches,
        "launches_by_path": {"matmul_check": mm_launches},
        "max_abs_err": max(r_["max_abs_err"] for r_ in mm_rows + mm_ragged),
        "max_rel_err": max(r_["max_rel_err"] for r_ in mm_rows + mm_ragged),
        **timing(mm_bf16),
        "device_ms": sum(r_["device_ms"] for r_ in mm_rows
                         if r_["dtype"] == "bfloat16"),
        "tuned": {dt: {"default_device_us": sum(
                          r_["tuned"]["default_us"] for r_ in mm_rows
                          if r_["dtype"] == dt),
                       "tuned_device_us": sum(
                          r_["tuned"]["tuned_us"] for r_ in mm_rows
                          if r_["dtype"] == dt),
                       "plans": [r_["tuned"]["plan"] for r_ in mm_rows
                                 if r_["dtype"] == dt]}
                  for dt in ("bfloat16", "float32")},
        "f32": timing(mm_f32),
        "routes": {"bfloat16": "wgmma (TMA + wgmma bf16)",
                   "float32": "simt (f32 FMA)"},
        "per": f"the six Qwen2-1.5B projection shapes of phase 15 at M = "
               f"{MATMUL_M} tokens, one launch each, bf16 through the wgmma "
               f"route; library: torch.matmul plus the epilogue in torch.  "
               f"No model path calls K6, in the reference either (its nn/ "
               f"modules use plain matmuls), so its launches are phase 15's",
        "card": card,
    }]
    bwd_key = ("bfloat16",) + BWD_SHAPES[0]
    k7_bwd = next(r_ for r_ in bwd_rows if (r_["dtype"], r_["b"], r_["hq"],
                                             r_["hkv"], r_["l"], r_["dh"],
                                             r_["causal"]) == bwd_key)
    k7_bwd_f32 = next(r_ for r_ in bwd_rows if (
        r_["dtype"], r_["b"], r_["hq"], r_["hkv"], r_["l"], r_["dh"],
        r_["causal"]) == ("float32",) + BWD_SHAPES[0])
    kernels.append({
        "name": "flash_attention_bwd",
        "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention_bwd.cu",
        "replaces": "src/repro/kernels/ref.py:173",
        "replaces_is": "no pallas_call: the JAX package trains through "
                       "XLA's autodiff of ref.attention_chunked "
                       "(src/repro/kernels/ref.py:173), the function K7 "
                       "(src/repro/kernels/attention.py:87) computes",
        "launches": train_bwd + hy_train["k7.launches_bwd"],
        "launches_wgmma": lm_train["k7_bwd_wgmma_launches"]
        + hy_train["k7.launches_bwd_wgmma"],
        "launches_by_path": {"lm_training": train_bwd,
                             "per_training_step": 28,
                             "hybrid_training": hy_train["k7.launches_bwd"]},
        "max_abs_err": max(r_["max_abs_err"] for r_ in bwd_rows),
        "max_rel_err": max(r_["max_rel_err"] for r_ in bwd_rows),
        **{key: k7_bwd[key] for key in ("ms", "plain_ms", "library_ms",
                                        "bound_ms", "bound_by", "device_ms",
                                        "simt_bound_ms", "plan", "dq_ms",
                                        "dkdv_ms", "sum_ms",
                                        "library_device_ms", "variants")},
        "kernel_route": k7_bwd["route"],
        "training_step_device_ms": lm_train["profile"]["k7_bwd_ms"],
        "f32": {"kernel_route": k7_bwd_f32["route"],
                **{key: k7_bwd_f32[key] for key in (
                    "ms", "device_ms", "plain_ms", "library_ms", "bound_ms",
                    "bound_by")}},
        "routes": {"bfloat16, Dh 64 and 128": "wgmma (TMA + wgmma bf16: a "
                   "dq kernel reading the forward's log-sum-exp, a dk/dv "
                   "kernel, a split sum where wgmma_bwd_plan splits)",
                   "float32; bfloat16 at Dh 16": "simt (f32 FMA: a dq "
                   "kernel that writes each row's log-sum-exp and delta, "
                   "then a dk/dv kernel)"},
        "bound_is": "bound_ms: the FLOPs at the bf16 tensor cores' 989 "
                    "TFLOP/s, or the bytes; simt_bound_ms: at the SIMT "
                    "cores' 67 TFLOP/s",
        "per": "one call at Qwen2-1.5B's training shape: batch 8, 512 "
               "tokens, 12 query / 2 KV heads, Dh 128, causal, bf16 through "
               "the wgmma route with the forward's lse (28 calls per "
               "training step); variants: unsplit dk/dv, no lse, SIMT "
               "forced (device ms); library: the backward of "
               "F.scaled_dot_product_attention with K and V expanded to 12 "
               "heads",
        "card": card,
    })
    k8_row = next(r_ for r_ in conv_rows if (r_["dtype"], r_["b"], r_["l"],
                                             r_["x"])
                  == ("bfloat16", 1, 1024, "in place"))
    kernels.append({
        "name": "conv1d_causal",
        "route": "cuda",
        "source": "src/repro_torch/csrc/conv1d_causal.cu",
        "replaces": "src/repro/kernels/conv1d_causal.py:43",
        "launches": hy_launches["conv1d_causal"] + hy_train["k8.launches"],
        "launches_tile": hy_summary["window"]["launches_route"][
            "conv1d_causal"] + hy_train["k8.launches_tile"],
        "thread_forced": {key: k8_row[key] for key in (
            "ms_thread", "device_ms_thread")},
        "act_none_device_ms": {"tile": k8_row["none_device_ms"],
                               "thread": k8_row["none_device_ms_thread"]},
        "routes": {"rows on 16-byte boundaries (f32, bf16)": "tile (a "
                   "(run + KW - 1)-row tile through a cp.async ring in "
                   "shared memory, packed bf16 conversions, SiLU with "
                   "__expf and rcp.approx)", "the rest": "thread (a thread "
                   "walks its channels' tokens from registers)"},
        "launches_by_path": {
            "hybrid_serving": hy_launches["conv1d_causal"],
            "decode_step": 0,
            "hybrid_training": hy_train["k8.launches"]},
        "max_abs_err": max(r_["max_abs_err"] for r_ in conv_rows),
        "max_rel_err": max(max(r_["max_rel_err"], r_["thread_rel_err"])
                           for r_ in conv_rows),
        **{key: k8_row[key] for key in ("ms", "plain_ms", "library_ms",
                                        "bound_ms", "bound_by",
                                        "device_ms")},
        "per": "one launch at the Jamba cut's Mamba prefill shape: batch 1, "
               "1024 tokens, d_inner 16384, 4 taps, bias and SiLU, bf16, x "
               "read in place from the input projection's rows as the "
               "mixer passes it (7 "
               "launches per prefill, 0 per decode step); library: cuDNN's "
               "depthwise F.conv1d with bias and SiLU in torch",
        "card": card,
    })
    k9_rows = {(r_["case"], r_["dtype"], r_["d"]): r_ for r_ in moe_rows}
    k9_decode = k9_rows[("decode", "bfloat16", MOE_D)]
    kernels.append({
        "name": "moe_gmm",
        "route": "cuda",
        "source": "src/repro_torch/csrc/moe_gmm.cu",
        "replaces": "src/repro/kernels/moe_gmm.py:61",
        "launches": hy_launches["moe_gmm"] + hy_train["k9.launches"],
        "launches_wgmma": hy_wgmma["moe_gmm"] + hy_train["k9.launches_wgmma"],
        "launches_stream": hy_summary["window"]["launches_stream"],
        "launches_by_path": {
            "hybrid_serving": hy_launches["moe_gmm"],
            "per_forward": 12, "per_decode_step": 12,
            "hybrid_training": hy_train["k9.launches"]},
        "max_abs_err": max(r_["max_abs_err"] for r_ in moe_rows),
        "max_rel_err": max(r_["max_rel_err"] for r_ in moe_rows),
        **{key: k9_decode[key] for key in ("ms", "plain_ms", "library_ms",
                                           "bound_ms", "bound_by",
                                           "device_ms")},
        "prefill": {key: k9_rows[("prefill", "bfloat16", MOE_D)][key]
                    for key in ("route", "ms", "plain_ms", "library_ms",
                                "bound_ms", "bound_by", "device_ms")},
        "prefill_down": {key: k9_rows[("prefill", "bfloat16", MOE_F)][key]
                         for key in ("route", "ms", "plain_ms", "library_ms",
                                     "bound_ms", "bound_by", "device_ms")},
        "decode_down": {key: k9_rows[("decode", "bfloat16", MOE_F)][key]
                        for key in ("route", "ms", "plain_ms", "library_ms",
                                    "bound_ms", "bound_by", "device_ms")},
        "decode_step": hy_summary["decode"]["k9"],
        "routes": {"bfloat16, bm a multiple of 64": "wgmma (TMA + wgmma "
                   "bf16)", "bfloat16, bm 16, 32 or 48": "stream (TMA "
                   "weight stream, mma.sync bf16)", "float32, ragged D or F":
                   "mma (mma.sync bf16; SIMT f32)"},
        "one_expert_over_spread": one_expert_ratio,
        "per": f"one launch at the Jamba cut's decode gate/up shape: 16 "
               f"routed rows of batch 8 over the {MOE_HELD} held experts "
               f"(tiles of 16), D {MOE_D} -> F {MOE_F}, bf16, the stream "
               f"route, its sum pass included (12 launches per forward, "
               f"through the wgmma route, and 12 per decode step, through "
               f"the stream route); prefill: "
               f"batch 8 x 512 at the same shape and at the down shape, the "
               f"wgmma route; library: torch.bmm over the "
               f"capacity-padded (E, C, D) x (E, D, F)",
        "card": card,
    })
    hy_sum = hybrid_train["summary"]
    k8_bwd = hybrid_train["conv_rows"][0]
    kernels.append({
        "name": "conv1d_causal_bwd",
        "route": "cuda",
        "source": "src/repro_torch/csrc/conv1d_causal_bwd.cu",
        "replaces": "src/repro/kernels/ref.py:134",
        "replaces_is": "no pallas_call: the JAX package trains through "
                       "XLA's autodiff of ref.conv1d_causal "
                       "(src/repro/kernels/ref.py:134), the function K8 "
                       "(src/repro/kernels/conv1d_causal.py:43) computes",
        "launches": hy_train["k8.launches_bwd"],
        "launches_tile": hy_train["k8.launches_bwd_tile"],
        "launches_vec": hy_train["k8.launches_bwd_vec"],
        "launches_by_path": {"hybrid_training": hy_train["k8.launches_bwd"],
                             "per_training_step": 1},
        "max_abs_err": max(r_["max_abs_err"]
                           for r_ in hybrid_train["conv_rows"]),
        "max_rel_err": max(r_["max_rel_err"]
                           for r_ in hybrid_train["conv_rows"]),
        **{key: k8_bwd[key] for key in ("ms", "plain_ms", "library_ms",
                                        "bound_ms", "bound_by",
                                        "device_ms", "bound_share",
                                        "plan")},
        "kernel_route": k8_bwd["route"],
        "vec_forced": {"ms": k8_bwd["vec_ms"],
                       "device_ms": k8_bwd["vec_device_ms"]},
        "training_step_device_ms": hy_sum["profile"]["groups_ms"]["k8_bwd"],
        "routes": {"rows on 16-byte boundaries (f32, bf16)": "tile (32 "
                   "threads along D x warps along L, each warp's walk "
                   "streamed through a cp.async ring, the warps' dw and db "
                   "added in shared memory in warp order)", "D and x's "
                   "strides multiples of 4, operands aligned": "vec (4 "
                   "channels a thread)", "the rest": "thread (one channel a "
                   "thread)"},
        "per": "one call at the training cut's Mamba shape: batch 2, 512 "
               "tokens, d_inner 16384, 4 taps, bias and SiLU, bf16, x read "
               "in place from the input projection, the tile route (both "
               "kernels: the walk and the fixed-order sum of dw and db; 1 "
               "call per training step); vec_forced: the first kernel on "
               "the same inputs; library: autograd of cuDNN's depthwise "
               "F.conv1d and SiLU",
        "card": card,
    })
    k9_bwd = {r_["case"]: r_ for r_ in hybrid_train["moe_rows"]
              if r_["dtype"] == "bfloat16"}
    kernels.append({
        "name": "moe_gmm_bwd",
        "route": "cuda",
        "source": "src/repro_torch/csrc/moe_gmm_bwd.cu",
        "replaces": "src/repro/kernels/ref.py:217",
        "replaces_is": "no pallas_call: the JAX package trains through "
                       "XLA's autodiff of ref.moe_gmm "
                       "(src/repro/kernels/ref.py:217), the function K9 "
                       "(src/repro/kernels/moe_gmm.py:61) computes",
        "launches": hy_train["k9.launches_bwd"],
        "launches_wgmma": hy_train["k9.launches_bwd_wgmma"],
        "launches_mma": hy_train["k9.launches_bwd_mma"],
        "launches_by_path": {"hybrid_training": hy_train["k9.launches_bwd"],
                             "per_training_step": 3},
        "max_abs_err": max(r_["max_abs_err"]
                           for r_ in hybrid_train["moe_rows"]),
        "max_rel_err": max(r_["max_rel_err"]
                           for r_ in hybrid_train["moe_rows"]),
        **{key: k9_bwd["gate/up"][key] for key in (
            "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
            "device_ms", "dx_ms", "dw_ms", "ops_bound_ms", "bytes_bound_ms",
            "routed_rows", "bound_share", "aim_met")},
        "kernel_route": k9_bwd["gate/up"]["route"],
        "mma_forced": {key: k9_bwd["gate/up"][f"mma_{key}"] for key in (
            "ms", "device_ms", "dx_ms", "dw_ms")},
        "down": {key: k9_bwd["down"][key] for key in (
            "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
            "device_ms", "dx_ms", "dw_ms", "mma_ms", "mma_device_ms")},
        "training_step_device_ms": hy_sum["profile"]["groups_ms"]["k9_bwd"],
        "routes": {"bfloat16, bm a multiple of 64, D and F multiples of 8, "
                   "16-byte aligned": "wgmma (TMA + wgmma bf16: a dtokens "
                   "kernel reading the weights K-major through a 3-D tensor "
                   "map, a persistent dweights kernel walking (expert, D "
                   "box, F box) items built on the card, its TMA stores "
                   "overlapping the next item)",
                   "other bfloat16": "mma (mma.sync m16n8k16 bf16: a "
                   "dtokens kernel reading the weights as they lie, a "
                   "dweights kernel walking each expert's tiles)",
                   "float32": "simt (f32 FMA)"},
        "per": "one call at the training cut's gate/up shape: the rows of "
               "one MoE layer for a 2 x 512 batch (tiles of 128, 4 of 16 "
               "experts held, -1 tiles and an expert with no rows), D 8192 "
               "-> F 24576, bf16, the wgmma route, dtokens and dweights (3 "
               "calls per training step: gate, up, down); mma_forced: the "
               "first kernels on the same inputs; library: torch.bmm over "
               "the capacity-padded experts for both products",
        "card": card,
    })
    def dev_sum(rows_):
        return sum(r_["device_ms"] * r_["count"] for r_ in rows_
                   if r_["device_ms"] is not None)
    per_fwd = (f"the 52 convs of one ResNet-50 forward, batch {BATCH}, "
               f"{IMAGE}x{IMAGE}")
    kernels += [{
        "name": "conv2d_direct_whole",
        "route": "cuda",
        "source": "src/repro_torch/csrc/conv2d_direct_whole.cu",
        "replaces": "src/repro/kernels/conv2d_direct.py:338",
        "launches": whole_launches + whole_counts["conv2d_direct_whole"]
        + chain_k10a,
        "launches_mma": whole_launches
        + whole_counts["conv2d_direct_whole_mma"] + chain_k10a,
        "launches_by_path": {
            "whole_serving": whole_launches,
            "whole_training": whole_counts["conv2d_direct_whole"],
            "chains": chain_k10a},
        "launches_by_path_chains_1MiB": chains["resnet50"][
            "whole_1MiB"]["launches_on"],
        "tuned_blockings": {key: whole_planned["sums"][key] for key in (
            "forward_f32", "step_forward", "step_dual")},
        "max_abs_err": max(r_["max_abs_err"] for r_ in whole_rows),
        "max_rel_err": max(r_["max_rel_err"] for r_ in whole_rows),
        **timing(k10a),
        "device_ms": dev_sum(whole_rows),
        "mma_bound_ms": weighted(whole_rows, "mma_bound_ms"),
        "unsplit": {"ms": weighted(whole_rows, "ms_unsplit"),
                    "device_ms": weighted(whole_rows, "device_ms_unsplit")},
        "split": {"ms": weighted(whole_rows, "ms_split"),
                  "device_ms": weighted(whole_rows, "device_ms_split")},
        "training_step_ms": {"rule": whole_train["step_ms"],
                             **whole_train["floor"]},
        "k1_ms": weighted(whole_rows, "k1_ms"),
        "routes": {"C and K multiples of 4, 16-byte aligned": "mma "
                   "(3xTF32 on mma.sync m16n8k8, csrc/conv_tf32.cuh)",
                   "the rest": "simt (f32 FMA)"},
        "per": per_fwd + " (K10a, the reference's whole-plane blocking, "
               "each reference block whole or its rows cut across CTAs as "
               "whole_split decides); library: cuDNN + epilogue",
        "card": card,
    }, {
        "name": "conv2d_wu_whole",
        "route": "cuda",
        "source": "src/repro_torch/csrc/conv2d_wu_whole.cu",
        "replaces": "src/repro/kernels/conv2d_wu.py:200",
        "launches": whole_counts["conv2d_wu_whole"],
        "launches_by_path": {
            "whole_training": whole_counts["conv2d_wu_whole"]},
        "tuned_blockings": {"step_wu": whole_planned["sums"]["step_wu"]},
        "max_abs_err": max(r_["max_abs_err"] for r_ in k10b_rows),
        "max_rel_err": max(r_["max_rel_err"] for r_ in k10b_rows),
        **timing(k10b),
        "device_ms": dev_sum(k10b_rows),
        "device_ms_covers": sum(r_["count"] for r_ in k10b_rows
                                if r_["device_ms"] is not None),
        "k2_ms": weighted(k10b_rows, "k2_ms"),
        "per": f"the 52 weight gradients of one ResNet-50 training step, "
               f"batch {TRAIN_BATCH}, each a split kernel over runs of whole "
               f"(n, p_b) steps (cp.async staging) and its sum pass (device "
               f"time only for launches under {TRACE_MAX_MS} ms); library: "
               f"cuDNN dW",
        "card": card,
    }, {
        "name": "conv2d_q8_whole",
        "route": "cuda",
        "source": "src/repro_torch/csrc/conv2d_q8_whole.cu",
        "replaces": "src/repro/kernels/conv2d_q8.py:246",
        "launches": k10c_launches,
        "launches_mma": k10c_summary["k10c_launches_mma"],
        "launches_by_path": {"whole_int8": k10c_launches},
        "tuned_blockings": {
            "forward_int8": whole_planned["sums"]["forward_int8"]},
        "max_abs_err": max(r_["max_abs_err"] for r_ in k10c_rows),
        **timing(k10c),
        "device_ms": dev_sum(k10c_rows),
        "uncut": {"ms": weighted(k10c_rows, "ms_uncut"),
                  "device_ms": weighted(k10c_rows, "device_ms_uncut")},
        "cut": {"ms": weighted(k10c_rows, "ms_cut"),
                "device_ms": weighted(k10c_rows, "device_ms_cut")},
        "simt_forced": {"ms": weighted(k10c_rows, "ms_simt"),
                        "device_ms": weighted(k10c_rows, "device_ms_simt")},
        "one_by_one": {key_: sum(r_[key_] * r_["count"] for r_ in k10c_rows
                                 if r_["r"] == r_["s"] == 1)
                       for key_ in ("ms", "device_ms", "library_ms")},
        "forward_device_ms": k10c_summary["profile"]["k10c_ms"],
        "k3_ms": weighted(k10c_rows, "k3_ms"),
        "routes": {"C a multiple of 16": "mma (mma.sync m16n8k32 s8, "
                   "csrc/q8_mma.cuh; the reference's grid cut across CTAs, "
                   "by rows and output channels, where whole_split takes "
                   "it)", "the other multiples of 8": "simt (__dp4a)"},
        "library_covers": "the 1x1 convs only (torch._int_mm + dequant and "
                          "epilogue in torch)",
        "per": per_fwd + " (K10c, int8, the reference's q8 blocking)",
        "card": card,
    }, {
        "name": "maxpool2d",
        "route": "cuda",
        "source": "src/repro_torch/csrc/pool2d.cu",
        "replaces": "src/repro/kernels/pool2d.py:46",
        "launches": pool_launches,
        "launches_by_path": {"chip_smoke": pool_launches},
        **{key: pool[key] for key in ("max_abs_err", "ms", "device_ms",
                                      "plain_ms", "library_ms", "bound_ms",
                                      "bound_by")},
        "per": f"one launch at the ResNet-50 stem pool {POOL_SHAPE} f32, 3x3 "
               f"stride 2 pad 1; library: F.max_pool2d.  No model path calls "
               f"K5, in the reference either (its executor pools with "
               f"lax.reduce_window), so its launches are phase 27's four "
               f"calls of its entry point",
        "card": card,
    }]
    print(json.dumps({"whole_plane": {
        "serving": whole_summary, "int8": k10c_summary,
        "training": {key: whole_train[key] for key in (
            "step_ms", "images_per_s", "losses", "profile", "parity")},
        "tiled_training_step_ms": summary["step_ms"],
        "tiled_serving_images_per_s": f32_stats["images_per_s"]}}))
    print(json.dumps({"inception_serving": inception}))
    print(json.dumps({"plan_tuning": {key: v for key, v in planned.items()
                                      if key != "rows"}}))
    print(json.dumps({"chains": chains}))
    print(json.dumps({"whole_plan_tuning": {
        key: v for key, v in whole_planned.items() if key != "rows"}}))
    print(json.dumps({"lm_serving": lm_summary}))
    print(json.dumps({"lm_training": lm_train}))
    print(json.dumps({"rwkv_serving": rwkv}))
    print(json.dumps({"hybrid_training": hybrid_train["summary"]}))
    print(json.dumps({"dp_training": dp_train}))
    print(json.dumps({"hybrid_serving": hy_summary}))
    print(json.dumps({"serving_int8": {
        "images_per_s": q8_stats["images_per_s"],
        "p50_ms": q8_stats["latency"]["p50_ms"],
        "p99_ms": q8_stats["latency"]["p99_ms"],
        "f32_images_per_s": f32_stats["images_per_s"],
        "f32_p50_ms": f32_stats["latency"]["p50_ms"],
        "f32_p99_ms": f32_stats["latency"]["p99_ms"],
        "step": q8_step, "parity": q8_parity}}))
    print(json.dumps({"training": {
        key: summary[key] for key in ("step_ms", "images_per_s", "losses")},
        "profile": {key: v for key, v in summary["profile"].items()
                    if key != "top"},
        "parity": summary["parity"]}))
    print(json.dumps({"phases_s": PHASE_SECONDS, "total_s": total_s,
                      "budget_s": RUN_BUDGET_S}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
