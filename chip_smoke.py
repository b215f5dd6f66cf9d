"""Drive the port's Swin-3D, ViT-3D, MedViT-3D and ResNet-3D training steps
and inference paths on one NVIDIA GPU.

    python3 chip_smoke.py

Needs a CUDA device, nvcc (on PATH or under CUDA_HOME) and the checkout;
it imports torch and the port (``vsn_tpu_torch``), never JAX. It runs on
one card (CUDA_VISIBLE_DEVICES defaults to 0). Models are built on the card
(``build_model``). Phases:

1. build the hand-written kernels from ``vsn_tpu_torch/csrc`` (one nvcc per
   source, in parallel, into build/), and beside them the ptxas report of
   the window-attention, GEMM, K1, stem, row-kernel and K3 sources
   (``python -m vsn_tpu_torch.probes.ptxas``);
2. print the card's name and power limit (nvidia-smi);
2a. the GEMM and weight-gradient bodies of K1 / K2 alone (``gemm_launch``
   / ``wgrad_launch``, csrc/gemm.cu): every launch that one training
   forward and backward of Swin-T 5c at micro-batch 8 (each stage) and of
   ViT-S 5c at micro-batch 24 make (the K1 / K2 calls recorded on zero
   volumes of their input size), on seeded operands with GEMM_TAIL nonzero
   rows past M, against their plain versions: bf16 outputs within 2e-2 of
   their scale, f32 outputs and the weight gradients' sums within 1e-3,
   and ViT's launches once more in f32 within 1e-4; then the GEMM path,
   each launch once through its entry point with every counter at 0
   before and one launch per call after; then per launch the tensor-core
   body's device time (CUDA events, the calls queued behind a spin kernel)
   beside the FMA body's on the same call (the body
   every bf16 GEMM took before), ``torch.matmul`` on the same rounded
   operands (a yardstick), the plain version and the bound;
2b. the row kernels of K1 / K2 alone (csrc/row_kernels.cu): the LayerNorm
   backward of K1b / K2b (``ln_bwd_launch``, ``postnorm_bwd_launch``: one
   CUDA body in two modes, csrc/common.cuh) at every K1b / K2b call of those
   training passes, in bf16 and f32, pre-norm (lam PATH_LAM) and post-norm
   (with gamma, the arms' mode; the parameter vectors views 4 bytes into a
   buffer, as training's), against their plain versions
   (``ln_backward_rows_reference``, ``postnorm_backward_rows_reference``):
   dx / dbranch within TOL of their scale, dw / db / dgamma within
   LN_BWD_TOL (1e-3 bf16, 1e-4 f32); a second launch on the same inputs
   must give the same bits in every output; then the LN-backward path, each
   launch as often as a micro-batch pass makes it, with every counter at 0
   before and exactly those launches after; then each launch's device time
   (``launch_ms``) beside its plain version's, one
   ``aten.native_layer_norm_backward`` call on the same rows (a yardstick:
   bf16 pre-norm, f32 post-norm, the residual line and gamma outside it)
   and its bound (bytes, or 13 / 20 f32 operations an element), summed per
   micro-batch pass (the result line's LN-backward entries: both passes, the
   launches the path counts); then the other row kernels
   (``ROW_KERNEL_ENTRIES``, ``sbk.ROW_KERNELS``): LN's rows, the bias
   gradients' column sums, the post-norm forward's finish and the pre-norm
   LayerScale gradients (``ln_rows_launch``, ``colsum_launch``,
   ``postnorm_fwd_launch``, ``layerscale_grads_launch``; the post-norm
   forward with gamma at lam PATH_LAM, its LN scale, shift and gamma and
   the LayerScale gradients' W views 4 bytes into a buffer, as training's)
   at every call of those passes, bf16 and f32, against their plain
   versions (``ln_rows_reference``, ``colsum_reference``,
   ``postnorm_fwd_reference``, ``layerscale_grads_reference``: bf16
   outputs within TOL of their scale, f32 ones within LN_BWD_TOL), a second
   launch on the same inputs giving the same bits; their path, each launch
   as often as a pass makes it, counters at 0 before and exactly those
   launches after; then each at the same calls, held to its plain version
   once and timed beside it (``launch_ms``; the LayerScale gradients in
   place through their C entry, ``row_timed_call``), the library call
   (``native_layer_norm``, ``Tensor.sum(0)``) where one exists, and its
   bound, summed per micro-batch pass (the result line's four entries: both
   passes); then the wide rows
   (``WIDE_ROWS``): one K1 and one K2 call, bf16, at Swin-T's stage-4 rows
   of micro-batch 8 at C = 1536 (EMBED_DIM 192, hidden 6144) and at C =
   300 (not a multiple of 8), in the default mode and post-norm +
   LayerScale, forward and every gradient through the kernels against the
   plain route to TOL;
3. K1's key-tiled attention body, and K2, on ViT-S's calls
   (vit-5c-no_seed-baseline: N = 811 tokens, 6 heads of 64, no bias, no
   region ids): every K1/K2 call of an eval forward at batch 2 in f32 and in
   bf16 (seeded 144x168x144 volumes, resized to 144x160x144 on the card)
   and of the flagship training forward at micro-batch 24 in bf16, with
   seeded parameters and gains as in phase 6; forward at lam 0 and 1 and
   every gradient (lam 0 and 1) against the plain versions, to TOL; then K1
   and K1b on an f32 call at saturated logits: bias 8 z + 45, + 200 and
   - 200 with the keys of the last, ragged key tile (768-810) 12 higher, so
   each row's running max grows at its last tile (at -200 every exp
   underflows under the max(rowmax, 0) shift and the attention output is
   0), forward and every gradient; then the tiled body's launches alone
   (``attention_tiled_launch``: qkv -> ao, the row statistics and f32 o;
   ``attention_tiled_backward_launch``: qkv, dao, o, statistics -> dqkv,
   dbqkv) against their plain versions (``attention_tiled_reference`` and
   its backward) on every K1 call of those sets and at the three saturated
   logits: ao, o, dq, dk, dv and dbqkv to TOL of their scale, the
   statistics elementwise;
3a. the same ViT calls in K1/K2's residual modes (``residual_parity_phase``):
   in-band LayerScale (gamma = 0.5 + 0.1 z), post-norm, and both, with the
   seeded parameters of phase 6; the forward at lam 0, 0.9129 (DeepScaleLM's
   lambda at depth 12) and 1, every gradient, dgamma included, at lam 0 and
   0.9129, against the plain versions to TOL; then K1b in every mode at
   saturated logits (bias 8 z + 45 and + 200, f32);
4. K4 parity: every K4 call (window attention on packed qkv, on the
   key-tiled tensor-core body under K4's softmax) of a DynamicTanh Swin-T
   eval forward at batch 2 in f32 and in bf16, and of its DROPOUT 0.1
   training forward at micro-batch 8 in bf16, the unfused blocks' attention
   at every stage shape (shifted, unshifted, padded with -1 pad ids,
   clamped N = 150). qkv is replaced by a seeded unit normal (O(1) logits)
   and the bias by z. K4f against its plain forward and K4b's dqkv and
   dbias against the plain backward for one seeded cotangent, to TOL of
   each output's scale; then K4f and K4b at saturated logits (bias 8 z +
   45, + 200 and - 200, f32) on a shifted call, and with the keys of the
   last, ragged key tile 12 higher on the first call of each N (252 = 3 x
   64 + 60, 150 = 2 x 64 + 22): at -200 K4's plain row max gives the
   softmax where K1's max(rowmax, 0) shift would give 0; then K4f's launch
   with its kept state (``window_attention_qkv_launch``: out, the row
   statistics and f32 o) and K4b from that state
   (``window_attention_qkv_backward_launch``) against their plain versions
   (``window_attention_qkv_kept_reference`` and its backward) on every
   call: out, o, dq, dk, dv and dbias to TOL of their scale, the
   statistics elementwise to an f32 limit (STATS_RTOL of each plus
   STATS_ATOL, in either activation type);
5. V1 and V3 on the same K4 calls, each with qkv = z and bias = z: V1
   (``window_attention``) on the split heads [BW, H, N, d] at the call's N
   and once more per set at N padded to 256 (zero q/k/v rows, pad ids -1,
   zero bias columns); V3 (``window_attention_windows``) on the block's
   rolled, padded map [B, D, H, W, 3C] (the call's window_reverse), and one
   synthetic call per set whose 3 id rows do not divide its 8 windows per
   sample. V1f/V3f against their plain versions, V1b's dq, dk, dv, dbias
   and V3b's dqkv, dbias against the plain backward, to TOL of each
   output's scale; V1b/V3b at saturated logits (f32); then, on every call
   of those sets, V1f's and V3f's launches with their kept state
   (``window_attention_launch``, ``window_attention_windows_launch``) and
   V1b / V3b from that state against their plain versions as phase 4
   holds K4's. Then the V path: the 12 calls of the training forward
   through both entry points, forward and backward, with every launch
   counter at 0 before and exactly one launch of each V kernel per call
   after. On every set, V1f (heads merged) and V3f (windows partitioned)
   must equal K4f on the same values bit for bit, out, row statistics and
   o (V1, V3 and K4 run one tiled body on three layouts); V1b's and V3b's
   dq, dk, dv from their kept state against K4b's (logged) and dbias
   within TOL["float32"] of its scale. The ptxas report of phase 1: every
   window-attention, GEMM, weight-gradient, K1, stem, row and K3 kernel's
   registers, none spilling but K5f's f32 FMA body (every K1, K4, V and
   probe attention body on the key-tiled body included), and K5's
   tensor-core bodies, the row bodies (``ROW_BODIES``:
   every instantiation of the LN backward, LN's rows, the post-norm
   forward's finish, the column sums and the LayerScale gradients) and
   K3's three gathers there. The V kernels'
   times per micro-batch beside their plain versions', SDPA's forward and
   backward on the same calls and their bounds; their launches alone
   (CUDA events, the calls queued behind a spin kernel: V1f, V3f, V1b and
   V3b, whose phases A and B the profiler's shares split); V3 beside
   partition + K4 + reverse; the kept state's bytes, apart from the
   bounds;
6. forward parity: every K1/K2/K3 call of a Swin-T eval forward at batch 2
   in f32 and in bf16, and at the eval path's batch 4 in bf16 (all four
   stages: shifted, unshifted, padded with -1 pad ids, clamped N = 150).
   K1/K2 parameters are replaced by seeded non-trivial ones (LayerNorm scale
   1 + 0.1 z, shifts and biases 0.1 z, projections fan_in^-0.5 z, an O(1)
   relative-position bias) and the samples get distinct forward and
   backward gains (gf != gb). Each K1/K2 call is checked with lam = 0 (the
   gained branch alone) and lam = 1 (the residual); f32 max|d| <= 1e-4 of
   the output scale (TF32 off), bf16 <= 2e-2; the movers bit-exact;
7. K1's route at Swin's calls: through its entry point (``attn_half``),
   one recorded K1 call of every Swin stage shape (N = 252 shifted,
   unshifted and padded with -1 pad ids, the clamped N = 150; f32 at batch
   2, bf16 at batch 4) and the shifted call cut to its first 37 tokens (N
   below one key tile), forward and backward against the plain versions,
   with every launch counter at 0 before and only the key-tiled body's
   launches after; K1 and K1b at saturated
   logits (bias 8 z + 45, + 200, - 200, f32) on the N = 150 call with the
   keys of its ragged last key tile (128-149) 12 higher; the tiled
   launches alone on those calls against their plain versions, dbias
   included; then head dims that are not multiples of 16 or above 128,
   which no preset's call takes (``odd_head_dim_phase``): the same calls
   re-headed to d = 24 and 12 (a bf16 row of 24 bytes: staged by plain
   loads) and, where the head dim divides their width, to 192 and 768 (the
   tiled body's slab kernels; K4 on each such call's windows too), one K1
   call at d = 24 and N = 450 in f32 and bf16, one K1 and one K4 call at d
   = 40 (C = 120, 3 heads) over Swin-T's 1728 stage-1 windows of
   micro-batch 8 with bias and region ids in bf16, and one K4, V1 and V3
   call at d = 192 (2 heads) over 2 samples of Swin-T's shifted stage-2
   map in f32 and bf16, through ``attn_half``, ``window_attention_qkv``,
   ``window_attention`` and ``window_attention_windows``, forward and
   every gradient against the plain versions, with only the tiled body's
   launches after the counters' reset (its slab kernels' counters,
   ``..._slabs``, above 128); then their launches alone (CUDA events)
   beside ``F.scaled_dot_product_attention`` with the float mask on the
   same q, k, v (above 128, the backend its dispatcher picks) and the
   bound, and K1f / K1b whole above 128;
8. backward parity: the K1/K2/K3 calls of a training forward (ShakeDrop
   draws), f32 and bf16 at batch 2 and the training path's bf16 calls at
   micro-batch 8, with the same seeded parameters and gains, lam 0 and 1.
   Every gradient of K1b (dx, LN w/b, qkv w/b, bias, proj w/b) and K2b (dx,
   LN w/b, fc1 w/b, fc2 w/b) is held to the plain backward for one seeded
   cotangent, each relative to its own scale (f32 1e-4, bf16 2e-2); K1b
   also at saturated logits (bias 8 z + 45 and 8 z + 200, f32, as
   tests/test_swin_block_kernels.py saturates them): finite and within
   tolerance; the movers' adjoints bit-exact;
8a. phase 3a on the Swin calls: the eval calls of phase 6 at batch 2 (f32
   and bf16) and the training calls at micro-batch 8 (bf16), and K1b's
   saturated logits on a shifted, masked f32 call;
9. the attention probes P1-P5 (``ops/attn_probe.py``, the ports of
   scripts/perf_probe_attn_ablate{,2}.py; P1 / P5's attention on K1's
   key-tiled body under the probes' policies) at one stage-1 K1 call: every P1
   variant, P5 run and copy against its plain version at the scripts'
   inputs (x [1728, 252, 96] bf16 from default_rng(0); copies bit-exact,
   bf16 out to 2e-2 of its scale), and every P1 variant and P5 run with f32
   x and out at seeded inputs where each ablated piece matters (x = 3 z + 1
   + a per-row offset, weights fan_in^-0.5 z, bias z), on the branch out -
   x: max within 8e-3 of its largest value and RMS within 1e-3 of its RMS,
   the plain version run on the run's own qkv (its launch 1 alone, held to
   its plain version within 2e-2 of its scale: a q or k rounded the other
   way by the order of the GEMM's sums moves ``noln``'s branch, whose
   logits are O(30), past that limit);
   the probe path (``python -m vsn_tpu_torch.probes.attn_ablate[2]``'s
   ``main``) with every launch counter at 0 before and exactly 3 launches
   per call of a whole half-block, 2 of ``linear_only`` / ``attn_only`` /
   ``lin``, 1 of a copy after (the copies P2-P4, and ``Tensor.copy_`` into
   a preallocated tensor beside them, then timed alone by ``launch_ms`` on
   the same x); each run's time beside its plain version's,
   its bound, ``Tensor.copy_``'s for the copies, and K1f's on the same x;
10. K5 parity: the stem conv K5f and its weight gradient K5w against their
   plain versions (the f32 conv of dtype-rounded operands, and its VJP) in
   f32 (1e-4 of scale, TF32 off) and bf16 (2e-2) at batch 2 on the
   geometries of tests/test_stem_im2col.py (ResNet and MedViT stems,
   stride 1, the odd 9x11x13 extent) and the ResNet stem at 16x18x16 x 64,
   then in bf16 at the slice's shape, x [12, 144, 168, 144, 1] (2e-2);
   bf16 runs the tensor-core bodies, f32 the FMA bodies. Then two K5w
   launches on the same inputs must give the same dW bits at every bf16
   case (the tensor-core body adds its block partials in a fixed order);
   their times at the slice's shape by CUDA events beside the FMA bodies'
   on the same bf16 inputs (``_fma=True``), the plain versions', the
   library calls' (cuDNN conv3d in bf16, channels-last, and conv3d_weight)
   and their bounds;
11. the Swin eval path: Swin-T 5c with the flagship recipe's ShakeDrop eval
   gains, ``Evaluator`` over 8 seeded float16 144x168x144 volumes in
   batches of 4, launch counters 0 before and exactly 12 (K1) / 12 (K2) /
   7 (K3) per forward after, none of K5; probs finite, rows summing to 1,
   within 1e-2 of the plain path, argmax agreeing wherever the plain top
   two are further apart than twice that difference; one batch's logits
   within 2e-2 of the plain path's largest |logit|; ms per batch and vol/s
   of both paths;
12. the Swin training path: ``init_train_state`` -> ``make_train_step`` for
   Swin-T 5c in bf16 with the flagship recipe (SAM, EMA of 3, MixUp p = 0.5,
   ShakeDrop, label smoothing 0.1), micro-batch 8, two micro-batches per
   step, on 16 seeded float16 volumes and their MixUp partners laid out as
   bench.py lays them out. After one backward every parameter has a finite,
   non-zero gradient. Then one warm-up step and 3 timed steps on the kernel
   route with every launch counter at 0 before and exact after (per
   micro-batch and SAM pass: 12 K1f, 12 K1b, 12 K2f, 12 K2b, 7 movers and 7
   adjoints); losses and grad norms finite, nothing skipped, parameters
   finite and moved by the second step (lr is 0 at step 0 under LR_WARMUP
   50), EMA weights apart from the live ones; the EMA weights through
   ``Evaluator``; then the same initial state, batches and injected draws
   for 2 steps on the plain route: per-step loss within 2e-2 and grad norm
   within 5e-2 (relative) of the kernel route;
13. the DynamicTanh eval path: phase 11 for Swin-T 5c with NORM_LAYER
   DynamicTanh, whose blocks all run unfused: exactly 12 K4f launches per
   forward and none of K1/K2/K3/K5;
14. the DynamicTanh training path: phase 12 for that model with DROPOUT 0.1
   (keep masks after the patch embed, proj, GELU and fc2, injected with the
   ShakeDrop gains): exactly 12 K4f and 12 K4b per micro-batch and SAM
   pass and no other launch; every parameter, DyT's 0-d alpha included,
   reached by one backward; the plain route's 2 steps within TRAIN_RTOL;
   every training phase logs its peak memory, of the kernel route's part
   alone and of the whole phase;
14a. the Swin stabilizer paths, the convergence run's arms on the flagship
   recipe: LAYER_SCALE (phases 11 and 12, with 12 K1f / K1b / K2f / K2b in
   the "_ls" mode per forward or micro-batch and SAM pass and none in the
   default one; gamma among the parameters every backward reaches),
   ENABLE_STABLE (phase 12: lam = 0.9129, beta folded into the gains, the
   default mode) and POST_NORM + LAYER_SCALE (phases 11 and 12 in the
   "_post_ls" mode);
15. the ViT eval path: phase 11 for ViT-S 5c (vit-5c-no_seed-baseline,
   bf16, random weights from its ``init_weights``): the 144x168x144 volumes
   resized to 144x160x144 on the card by the eval transform; exactly 12
   tiled K1f and 12 K2f launches per forward and no other launch;
16. the ViT training path: phase 12 for ViT-S 5c with the flagship recipe
   (SAM, EMA of 3, MixUp p = 0.5, USE_SHAKEDROP, which ViT reads as
   DropPath 0.15, label smoothing 0.1) at the preset's micro-batch 24 x 2:
   exactly 12 tiled K1f, 12 tiled K1b, 12 K2f and 12 K2b per micro-batch
   and SAM pass (as on every Swin path: 12 tiled K1f and 12 tiled K1b
   per micro-batch and SAM pass in phases 12 and 14a); then the times per
   micro-batch of 24 of K1f/K1b (tiled), K2f and K2b at ViT's calls beside
   their plain versions and bounds, and the tiled attention launches alone
   (CUDA events; K1b's phases A and B split by the profiler's shares)
   beside ``F.scaled_dot_product_attention``
   on the same q, k, v [24, 6, 811, 64] in bf16 and its backward (a
   yardstick) and beside their bound (4 N^2 d per window and head forward,
   10 N^2 d backward, at 989 TFLOP/s); then ViT's
   K1/K2 in the "_post_ls" mode beside their plain versions and bounds;
16a. the ViT stabilizer path: phases 15 and 16 for ViT-S with POST_NORM,
   LAYER_SCALE and ENABLE_STABLE (12 tiled K1f / K1b and 12 K2f / K2b in
   the "_post_ls" mode per forward or micro-batch and SAM pass);
16b. heads above 128 (``wide_head_run``): Swin-T 5c at HEADS [1, 1, 1, 1]
   (d = 96, 192, 384, 768) and ViT-S's widths at 2 heads of 192
   (``wide_vit_model``: the configs fix ViT's dim_head at 64), each through
   ``Evaluator.predict`` on 4 volumes (exactly 2 tiled and 10 slab K1f
   launches per Swin forward, 12 slab K1f per ViT forward) against the
   plain route's probs and logits, and 2 flagship training steps (micro 8
   x 2, 24 x 2; the first with exact launch counts) against 2 plain-route
   steps within TRAIN_RTOL; then K1's times per stage at the wide Swin's
   training calls (``swin_k1_times``) and the attention launches alone at
   the wide ViT's (``tiled_launch_times``), both beside SDPA;
17. K3 at Swin's training calls at micro-batch 8: each mover call and its
   adjoint alone (``mover_launch_times``: CUDA events over LAUNCH_REPS calls
   queued behind a spin kernel), the bandwidth each reaches (its bytes and
   its row map's, over that time) and its share of 3.35 TB/s, summed per
   micro-batch and logged beside the K3 entries' times (through their
   wrappers, as every block kernel's entry) and beside one
   ``Tensor.index_select(0, index)`` over the same row map (its library
   time, ``mover_library_times``); K1 at Swin's training calls at
   micro-batch 8, per stage and summed
   (``swin_k1_times``): K1f and K1b whole; their attention launches alone
   (CUDA events over 10 calls queued behind a spin kernel: K1f's launch
   2, K1b's phases A and B, split by the profiler's shares) beside K4f's
   launch on the same values, beside one
   ``F.scaled_dot_product_attention`` call per K1 call on its split heads
   with the float mask bias[h] + mask(ids), and its backward (a yardstick),
   and beside their bound (the attention's own bytes and products); the
   bytes of K1f's kept state (ao, row statistics, f32 o; apart from the
   bounds); each Swin kernel's time
   per micro-batch at the training shapes beside its plain version's (the
   eval phase times the forwards at batch 4), and
   for K4f / K4b the library's: one ``F.scaled_dot_product_attention`` call
   per K4 call on the split heads with the additive float mask bias[h] +
   mask(ids), and that call's backward (phase 5 times it on V1's own
   calls, V1f / V1b's yardstick; V3 has no single call), K4f's
   and K4b's launches alone (CUDA events; phases A and B split by the
   profiler's shares), K4b with and
   without dbias's f32 atomics, the bytes of K4f's kept state (logged
   apart: the bounds count only the function's own inputs and outputs),
   and K1/K2 in the "_ls" and "_post_ls"
   modes beside their plain versions;
18. the ResNet eval path: ResNet-18 5c (resnet-5c-no_seed-baseline: head
   dropout 0.1, bf16), seeded weights whose BatchNorm statistics are
   re-estimated by ``make_bn_refresh_step`` over 8 volumes, ``Evaluator``
   over the 8 volumes in batches of 4: exactly 1 K5f and no other launch
   per forward; probs as in phase 11 against the plain stem;
19. the ResNet training path: the same recipe
   without ShakeDrop (the ResNet has no residual gains), micro-batch 12 x
   2, injected head-dropout masks: every parameter reached by one
   backward; 1 + 3 steps with exactly 1 K5f and 1 K5w per micro-batch and
   SAM pass and no other launch; parameters and EMA as in phase 12; the
   BatchNorm statistics moved and the EMA's apart from the live ones; the
   EMA weights and statistics through ``Evaluator``; 2 plain-stem steps
   from the same state within 2e-2 / 5e-2;
19a. Swin-T 5c training with ATTENTION_DROPOUT 0.1 (the flagship recipe,
   micro 8 x 2): every block unfused on the JAX package's XLA attention
   branch (``WindowAttention3D.attention``: f32 scores, the region mask at
   -100, dropout on the probabilities), which no kernel computes. Its
   calls of one training forward (shifted, unshifted, padded with -1 pad
   ids, clamped N = 150) with no keep mask, qkv and bias replaced by z,
   against K4's launch on the same values to TOL (``branch_gate``: every
   counter at 0 before and one K4 launch per call after); the attention
   keep masks of one forward kept at 1 - rate within 0.1% per stage; then
   2 steps with drawn masks (``short_train_path``: no launch, losses and
   grad norms finite, vol/s of the second step, peak memory);
19b. ViT-S 5c's unfused arms: NORM_LAYER DynamicTanh (eval of the 8
   volumes: no launch; 2 steps at micro 24 x 2: none), HEADS 2 (2 x 64 !=
   384: the unfused attention half beside K2; eval 12 K2f a forward, 2
   steps with 12 K2f and 12 K2b a pass), LayerNorm with DROPOUT and
   ATTENTION_DROPOUT 0.1 (2 steps, both halves unfused: no launch); then
   the LayerNorm ViT-S's attention half unfused with no masks
   (``fused_attn_gate`` off) against its K1 half on the same weights,
   volumes and gains (``vit_unfused_gate``): eval probs within 1e-2, one
   batch's logits within 2e-2 of the largest |logit|, one step's loss and
   grad norm within TRAIN_RTOL;
19d. the stabilizers on unfused blocks: DynamicTanh Swin-T and DynamicTanh
   ViT-S with LAYER_SCALE, ENABLE_STABLE and POST_NORM, 2 steps each (Swin:
   12 K4f and 12 K4b a pass, held to 2 plain-route steps within
   TRAIN_RTOL as phase 14; ViT: no launch);
19c. MedViT-S 5c (medvit-5c-no_seed-baseline: DEPTH [3,4,10,3], head dim
   32, MLP 3; no kernel: its 3^3 stem takes the plain conv): eval of the 8
   volumes in batches of 4 after a BN refresh; the card's bf16 eval against
   its f32 eval (probs within 1e-2, logits within 2e-2); the card's f32
   forward and one f32 training micro-step at batch 2 (TF32 off) against
   the CPU's on the same weights, volumes and gains (``medvit_f32_gate``,
   MEDVIT_F32); 2 steps at micro 8 x 2 with the flagship recipe (ShakeDrop
   gains), no launch;
   then MedViT's stem.0 conv weight gradient in f64 on the card (cuDNN)
   and on the CPU from that step's input and output cotangent, and the
   card's f32 gradient's gap to it in f32 ulps (``medvit_stem_f64``: a
   reading, logged);
20a. the uncertainty eval chain (``eval_chain_phase``) on Swin-T 5c with
   seeded weights: a synthetic cohort at 144x168x144 (12 subjects in 3
   folds, split [1, 1, 1]) and an OD cohort of 8 by the port's
   ``generate_synthetic_dataset``; a checkpoint in the JAX package's
   format, whose loaded model's logits equal the saved model's bit for
   bit; ``evaluate_checkpoint`` plain and with TTA (8 views; the OD cohort
   fills one batch at the default cap of 8 volumes, 64 rows), each with
   exactly 12 / 12 / 7 launches per batch, its peak memory, and its CSVs
   (rows summing to 1 within 1e-4) and metrics JSON read back; one TTA
   batch at the cap timed, with its launches and peak memory; its
   probabilities within 1e-2 of the plain route's on the same views and
   draws; the card's warp within 1e-4 of the CPU's; plain and TTA vol/s
   and each stage's seconds;
20b. Swin-T 5c eval at batch 4 with USE_PALLAS_ATTENTION off
   (``flag_off_phase``): no launch, probs within 1e-2 and logits within
   2e-2 of the kernel route's;
21. each kernel's time beside its bound: the larger of the bytes its calls
   move (inputs read once, outputs written once) over 3.35 TB/s and the
   products they compute over 989 TFLOP/s (bf16), from this run's shapes.
torch.profiler runs over one eval pass and one train step of each Swin
and ViT path and one ResNet train step: device time by kernel and the device's
idle share (traces in build/).

Every failure raises (exit code 1). The last lines are one JSON object of
per-kernel results and then {"ok": true, "device": {...}}.

    python3 chip_smoke.py --k3-alone [PORT]

times only K3's launches alone at the mover calls of one Swin-T training
micro-batch (phase 17's ``mover_launch_times``) for the port in the
directory PORT (an unpacked checkout of another commit; this checkout's by
default), so that two commits' movers are held to one measure in one call;
it prints the card's line and then {"k3_alone_ms": {name: ms}}.

    python3 chip_smoke.py --rows-alone [PORT]

likewise times only the post-norm forward's finish and the LayerScale
gradients alone (phase 2b's ``row_kernel_times``) at the row calls of one
Swin-T and one ViT-S training micro-batch pass, for the port at PORT or
this checkout's; it prints the card's line and then {"rows_alone_ms":
{"<set> <kernel>": ms per pass}}.

    python3 chip_smoke.py --odd-heads-alone [PORT]

likewise times K1f and K1b whole, through their entry points (CUDA events),
at the calls of phase 7 re-headed to ODD_HEAD_DIMS (Swin-T's eval calls at
batch 4 in bf16, one of each stage case), for the port at PORT or this
checkout's, whatever attention body that port runs there; it prints the
card's line and then {"odd_heads_alone_ms": {"K1f d=24": ms, ...}}.
"""

from __future__ import annotations

import collections
import json
import math
import os
import subprocess
import sys
import time
from contextlib import contextmanager
from pathlib import Path
from unittest import mock

import numpy as np

BATCH, N_VOLUMES, SEED = 4, 8, 0
TRAIN_MICRO, TRAIN_ACCUM, TIMED_STEPS, PLAIN_STEPS = 8, 2, 3, 2
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# K4f's kept row statistics (max, 1 / sum), f32 on both sides
STATS_RTOL, STATS_ATOL = 1e-5, 1e-6
TRAIN_RTOL = {"loss": 2e-2, "grad_norm": 5e-2}  # kernel vs plain route, bf16
PATH_LAM = 1.0  # the residual x-gain every block of the main path passes

KERNELS = {  # name -> (source, TPU kernel it replaces)
    # K1 at Swin's calls (d = 32, N = 252 and 150, bias and region ids): the
    # key-tiled attention body, whose launch counters on a Swin path feed
    # these entries (``entry_name``)
    "attn_half": ("vsn_tpu_torch/csrc/attn_half.cu",
                  "vsn_tpu/ops/swin_block_kernels.py:525"),
    "attn_half_bwd": ("vsn_tpu_torch/csrc/attn_half_bwd.cu",
                      "vsn_tpu/ops/swin_block_kernels.py:560"),
    # K1 at ViT's calls (d = 64, N = 811, no bias): the same body
    "attn_half_tiled": ("vsn_tpu_torch/csrc/attn_half.cu",
                        "vsn_tpu/ops/swin_block_kernels.py:525"),
    "attn_half_bwd_tiled": ("vsn_tpu_torch/csrc/attn_half_bwd.cu",
                            "vsn_tpu/ops/swin_block_kernels.py:560"),
    "ln_mlp": ("vsn_tpu_torch/csrc/ln_mlp.cu",
               "vsn_tpu/ops/swin_block_kernels.py:1025"),
    "ln_mlp_bwd": ("vsn_tpu_torch/csrc/ln_mlp_bwd.cu",
                   "vsn_tpu/ops/swin_block_kernels.py:1049"),
    "spatial_to_windows": ("vsn_tpu_torch/csrc/window_relayout.cu",
                           "vsn_tpu/ops/window_relayout.py:184"),
    "windows_to_windows": ("vsn_tpu_torch/csrc/window_relayout.cu",
                           "vsn_tpu/ops/window_relayout.py:257"),
    "windows_to_spatial": ("vsn_tpu_torch/csrc/window_relayout.cu",
                           "vsn_tpu/ops/window_relayout.py:335"),
    "spatial_to_windows_adjoint": ("vsn_tpu_torch/csrc/window_relayout.cu",
                                   "vsn_tpu/ops/window_relayout.py:141"),
    "windows_to_windows_adjoint": ("vsn_tpu_torch/csrc/window_relayout.cu",
                                   "vsn_tpu/ops/window_relayout.py:176"),
    "windows_to_spatial_adjoint": ("vsn_tpu_torch/csrc/window_relayout.cu",
                                   "vsn_tpu/ops/window_relayout.py:151"),
    "stem_im2col": ("vsn_tpu_torch/csrc/stem_im2col.cu",
                    "vsn_tpu/ops/stem_im2col.py:249"),
    "stem_im2col_dw": ("vsn_tpu_torch/csrc/stem_im2col.cu",
                       "vsn_tpu/ops/stem_im2col.py:291"),
    "attention": ("vsn_tpu_torch/csrc/window_attention_qkv.cu",
                  "vsn_tpu/ops/window_attention.py:244"),
    "attention_bwd": ("vsn_tpu_torch/csrc/window_attention_qkv.cu",
                      "vsn_tpu/ops/window_attention.py:315"),
    "attention_split": ("vsn_tpu_torch/csrc/window_attention_qkv.cu",
                        "vsn_tpu/ops/window_attention.py:79"),
    "attention_split_bwd": ("vsn_tpu_torch/csrc/window_attention_qkv.cu",
                            "vsn_tpu/ops/window_attention.py:153"),
    "attention_windows": ("vsn_tpu_torch/csrc/window_attention_qkv.cu",
                          "vsn_tpu/ops/window_attention.py:422"),
    "attention_windows_bwd": ("vsn_tpu_torch/csrc/window_attention_qkv.cu",
                              "vsn_tpu/ops/window_attention.py:528"),
}
# The slab kernels of the tiled body (head dims above 128), launched by the
# same entry points and counted apart (``window_attention.body_key``,
# ``swin_block_kernels.k1_body``), each a result-line entry: K1 on the
# wide-head model runs, K4 / V1 / V3 on phase 7's calls
SLAB_BASES = ("attn_half", "attn_half_bwd", "attention", "attention_bwd",
              "attention_split", "attention_split_bwd", "attention_windows",
              "attention_windows_bwd")
SLAB_NAME = {base: f"{base}_slabs" for base in SLAB_BASES}
KERNELS.update({SLAB_NAME[base]: ("vsn_tpu_torch/csrc/attn_tiled.cuh",
                                  KERNELS[base][1]) for base in SLAB_BASES})
# The attention probes, one entry per run of the two scripts: launch key
# (ops/attn_probe.py launch_key) -> (the script's run name, source, TPU
# kernel it replaces). P1 and P5 are variants of K1f's body.
_P1 = "scripts/perf_probe_attn_ablate.py"
_P2 = "scripts/perf_probe_attn_ablate2.py"
_K1_SRC, _COPY_SRC = ("vsn_tpu_torch/csrc/attn_half.cu",
                      "vsn_tpu_torch/csrc/probe_copy.cu")
PROBES = {
    **{f"attn_ablate.{v}": (v, _K1_SRC, f"{_P1}:106")
       for v in ("full2d", "noln", "nosm", "nobias", "linear_only",
                 "attn_only")},
    "copy_windows.wb1": ("copy_only", _COPY_SRC, f"{_P2}:128"),
    "copy_windows.wb1.ops": ("copy_ops", _COPY_SRC, f"{_P2}:135"),
    "copy_windows.wb8": ("copy_only_wb8", _COPY_SRC, f"{_P2}:145"),
    "attn_slot.lin.wb8": ("lin2d_wb8", _K1_SRC, f"{_P2}:152"),
    "attn_slot.full.wb8": ("full2d_wb8", _K1_SRC, f"{_P2}:152"),
    "attn_slot.full.wb8.f32": ("full2d_wb8_f32", _K1_SRC, f"{_P2}:152"),
    "attn_slot.full.wb1": ("full2d_wb1", _K1_SRC, f"{_P2}:152"),
}
KERNELS.update({key: (src, rep) for key, (_, src, rep) in PROBES.items()})
# K1/K2 in their residual modes, as the stabilizer paths launch them:
# Swin's LayerScale arm (pre-norm + gamma, "_ls") and post-norm + LayerScale
# ("_post_ls"), ViT with all three options ("_tiled_post_ls"). Entries are
# named as K1's (above): the ``_tiled`` ones are K1 at ViT's calls, the
# others at Swin's, whose launch counters are the key-tiled body's too
# (``entry_name``). name -> base kernel.
RESIDUAL_KERNELS = {
    **{f"{base}{mode}": base for mode in ("_ls", "_post_ls")
       for base in ("attn_half", "attn_half_bwd", "ln_mlp", "ln_mlp_bwd")},
    **{f"{base}_post_ls": base for base in ("attn_half_tiled",
                                            "attn_half_bwd_tiled")},
}
KERNELS.update({name: KERNELS[base]
                for name, base in RESIDUAL_KERNELS.items()})
# The GEMM and weight-gradient bodies of K1 / K2 (csrc/common.cuh), which
# K1f / K1b / K2f / K2b launch inside their calls; the GEMM phase drives
# them through their own entry points (csrc/gemm.cu). name -> (source, the
# TPU kernels' products they replace: _mmw, and the weight gradient over
# the token rows)
GEMM_KERNELS = {
    "gemm": ("vsn_tpu_torch/csrc/common.cuh",
             "vsn_tpu/ops/swin_block_kernels.py:246"),
    "wgrad": ("vsn_tpu_torch/csrc/common.cuh",
              "vsn_tpu/ops/swin_block_kernels.py:434"),
}
KERNELS.update(GEMM_KERNELS)
# The LayerNorm backward of K1b / K2b (csrc/common.cuh, one body in two
# modes), which they launch inside their calls; the row-kernel phase drives
# it through its own entry points (csrc/row_kernels.cu). name -> (source,
# the TPU kernels' _ln_bwd, which all four call sites share)
LN_BWD_KERNELS = {
    "ln_bwd": ("vsn_tpu_torch/csrc/common.cuh",
               "vsn_tpu/ops/swin_block_kernels.py:85"),
    "postnorm_bwd": ("vsn_tpu_torch/csrc/common.cuh",
                     "vsn_tpu/ops/swin_block_kernels.py:85"),
}
KERNELS.update(LN_BWD_KERNELS)
# LN's rows and the bias gradients' column sums (csrc/common.cuh
# ``ln_rows_kernel``, ``colsum_kernel`` + ``ordered_sum_kernel``), which
# K1b / K2b launch inside their calls, the post-norm forward's finish
# (``postnorm_fwd_kernel``) of K1f / K2f and the pre-norm LayerScale
# gradients (``layerscale_grads_kernel``) of K1b / K2b; phase 2b drives them
# through their own entry points (csrc/row_kernels.cu) as it drives the LN
# backward. name (their launch counter) -> (source, the TPU function they
# replace: _ln_fwd in _attn_bwd_kernel / _mlp_bwd_kernel; the bias
# gradients' sums, dbproj at :401, db2 and db1 at :943-963; the post-norm
# finish of _attn_fwd_kernel :284-288 and _mlp_fwd_kernel :874-878; the
# LayerScale gradients of _attn_bwd_kernel :404-415 and _mlp_bwd_kernel
# :936-950)
ROW_KERNEL_ENTRIES = {
    "ln_rows": ("vsn_tpu_torch/csrc/common.cuh",
                "vsn_tpu/ops/swin_block_kernels.py:75"),
    "colsum": ("vsn_tpu_torch/csrc/common.cuh",
               "vsn_tpu/ops/swin_block_kernels.py:401"),
    "postnorm_fwd": ("vsn_tpu_torch/csrc/common.cuh",
                     "vsn_tpu/ops/swin_block_kernels.py:284"),
    "layerscale_grads": ("vsn_tpu_torch/csrc/common.cuh",
                         "vsn_tpu/ops/swin_block_kernels.py:404"),
}
KERNELS.update(ROW_KERNEL_ENTRIES)
# phase 2b's wide rows: (C, heads) of one K1 and one K2 call over Swin-T's
# stage-4 rows at micro-batch 8 (8 windows of 5 x 6 x 5 tokens, clamped):
# the stage at EMBED_DIM 192 (24 heads of 64; hidden 6144), and a width
# that is not a multiple of 8 (12 heads of 25, whose bf16 rows the tiled
# body stages by plain loads; hidden 1200)
WIDE_ROWS = ((1536, 24), (300, 12))
WIDE_WINDOWS, WIDE_N = TRAIN_MICRO, 150
# dw / db / dgamma of the LN backward against its plain version, relative to
# their scale: bf16 launches 1e-3 (the same f32 terms of rounded inputs
# summed in another order), f32 1e-4
LN_BWD_TOL = {"bfloat16": 1e-3, "float32": 1e-4}
# The GEMM phase's tolerances, relative to each output's scale: bf16
# outputs 2e-2 (one bf16 step where the f32 sums round apart); the f32
# outputs of bf16 launches (out32, and the weight gradients' sums, added by
# atomics in an order that varies) 1e-3 (the same rounded products summed
# in another order, on the tensor cores); f32 launches 1e-4.
GEMM_TOL = {"bfloat16": 2e-2, "out32": 1e-3, "float32": 1e-4}
# nonzero rows past M behind every row operand of the GEMM phase: a kernel
# that reads past its M rows (a weight gradient's contraction) sums them
GEMM_TAIL = 64
# the stabilizer path (STABILIZER_PATHS key) whose launch count the result
# line gives each RESIDUAL_KERNELS entry: the Swin arm of its mode, ViT's
# for the tiled ones (ln_mlp(_bwd)_post_ls, which both launch, takes Swin's)
RESIDUAL_PATH = {name: "vit_all" if "tiled" in name
                 else name.removeprefix(base + "_")
                 for name, base in RESIDUAL_KERNELS.items()}
# the modes the residual parity phase holds to the plain versions:
# suffix -> (LayerScale gamma, post-norm)
RESIDUAL_MODES = {"_ls": (True, False), "_post": (False, True),
                  "_post_ls": (True, True)}
# DeepScaleLM's lambda at Swin-T's total depth 12: sqrt(1 - 2 / 12)
STABLE_LAM = 0.9129
MODE_LAMS = (0.0, STABLE_LAM, 1.0)   # forward; the gradients at the first two
# the stabilizer paths: (label, config overrides, the mode their K1/K2 run)
STABILIZER_PATHS = {
    "ls": (dict(LAYER_SCALE=True), "_ls"),
    "stable": (dict(ENABLE_STABLE=True), ""),
    "post_ls": (dict(POST_NORM=True, LAYER_SCALE=True), "_post_ls"),
    "vit_all": (dict(POST_NORM=True, LAYER_SCALE=True, ENABLE_STABLE=True),
                "_post_ls"),
}
# The probes' f32-out check, on the branch out - x: its largest difference
# within P_MAX_TOL of the branch's largest value, and its RMS difference
# within P_RMS_TOL of the branch's RMS. Both sides round q, k, v, p, y and
# ao to bf16 at the same points, so they differ by a bf16 step of one of
# those wherever an f32 difference of a few ulps (exp, the order of sums)
# crosses a rounding boundary: attn_only's branch is p v with v = bf16(y),
# so one flipped y moves it by up to two steps (2^-7) of its largest value
# (1.08 of a 4e-3 limit on the H100). The RMS sees the systematic errors
# that such a max hides: a kernel that rounds p before normalizing it
# moves every p by up to a step (RMS ~2.7e-3 of the branch's on the CPU).
P_MAX_TOL, P_RMS_TOL = 8e-3, 1e-3
STEM = ("stem_im2col", "stem_im2col_dw")
BLOCK_KERNELS = ("attn_half", "ln_mlp")
# V1 (split q, k, v) and V3 (the unpartitioned map): K4's function on other
# layouts, driven through their entry points on the K4 calls (no model
# calls them)
V_KERNELS = ("attention_split", "attention_windows")
# kernels held to a tolerance (the rest, the movers, are bit-exact)
TOLERANT = (*BLOCK_KERNELS, "attention", *V_KERNELS)
# kernel name -> the name models/swin3d.py calls it by, where they differ
MODEL_NAME = {"attention": "window_attention_qkv"}
MOVERS = ("spatial_to_windows", "windows_to_windows", "windows_to_spatial")
# Launches per Swin-T forward: 12 blocks (depths 2+2+6+2), one K1 (its
# key-tiled body, d = 32) and one K2 each; the window-resident stages 1, 2
# and 4 enter through
# spatial_to_windows (3), stages 1 and 2 glue one shifted junction each
# (windows_to_windows, 2) and leave in the shifted layout
# (windows_to_spatial, 2); stage 4 is unshifted and leaves through a plain
# reshape, stage 3 (padded) uses no mover.
PER_FORWARD = {"attn_half_tiled": 12, "ln_mlp": 12, "spatial_to_windows": 3,
               "windows_to_windows": 2, "windows_to_spatial": 2}
# per micro-batch and SAM pass of training: the forward's launches, and the
# backward's mirror (K1b, K2b, one adjoint per mover call)
PER_PASS = {**PER_FORWARD, "attn_half_bwd_tiled": 12, "ln_mlp_bwd": 12,
            **{f"{m}_adjoint": PER_FORWARD[m] for m in MOVERS}}
# ResNet-18 launches per forward (the 7^3 stem conv) and per micro-batch and
# SAM pass of training (the stem and its weight gradient; dx is not taken)
RESNET_PER_FORWARD = {"stem_im2col": 1}
RESNET_PER_PASS = {"stem_im2col": 1, "stem_im2col_dw": 1}
# DynamicTanh Swin-T: every block unfused, one K4 call each (and one K4b in
# training); no K1/K2 and no mover
DYT = dict(NORM_LAYER="DynamicTanh")
DYT_PER_FORWARD = {"attention": 12}
DYT_PER_PASS = {"attention": 12, "attention_bwd": 12}
DYT_DROPOUT = 0.1
# the V path: one launch of each V kernel per K4 call, forward and backward
V_PER_CALL = {name: 1 for v in V_KERNELS for name in (v, f"{v}_bwd")}
# V1's padded layout (fused_window_attention's callers pad N to 256), and
# the synthetic V3 call whose 3 id rows do not divide its 8 windows per
# sample: (batch, map dims, window, C, heads, id rows)
PAD_N = 256
W_NOT_DIVIDING = (2, (12, 14, 12), (6, 7, 6), 96, 3, 3)
RESNET_PRESET, RESNET_MICRO = "resnet-5c-no_seed-baseline", 12
# Swin-T 5c training with ATTENTION_DROPOUT: every block unfused on the XLA
# attention branch (no kernel); its gate against K4 must see these cases
ATTN_DROPOUT = 0.1
SHORT_STEPS = 2   # train steps of each path of phases 19a-19d
BRANCH_CASES = {"shifted ids", "padded ids", "no mask", "N=150"}
KEEP_RTOL = 1e-3   # each stage's kept share within 0.1% of 1 - rate
# ViT-S's unfused arms: overrides -> (per eval forward, per training pass)
VIT_UNFUSED_ARMS = {
    "vit_dyt": (dict(NORM_LAYER="DynamicTanh"), {}, {}),
    "vit_heads2": (dict(HEADS=2), {"ln_mlp": 12},
                   {"ln_mlp": 12, "ln_mlp_bwd": 12}),
    "vit_ln_dropout": (dict(DROPOUT=0.1, ATTENTION_DROPOUT=0.1), None, {}),
}
# the stabilizers on unfused blocks: DynamicTanh with all three
UNFUSED_STABILIZERS = dict(NORM_LAYER="DynamicTanh", LAYER_SCALE=True,
                           ENABLE_STABLE=True, POST_NORM=True)
# MedViT-S 5c (medvit-5c-no_seed-baseline: DEPTH [3,4,10,3], head dim 32,
# MLP 3): no kernel; the card's f32 forward and training micro-step against
# the CPU's at batch 2 within these limits (PERF.md gives the reasons: a
# conv's weight gradient sums up to 1.7M voxel terms in f32, with
# cancellation, in cuDNN's order on the card and another on the CPU: the
# stem's gradients part by ~1.6e-3 of the largest gradient and all of them
# together by ~7e-4, where the logits and statistics agree to ~3e-7)
MEDVIT_PRESET, MEDVIT_MICRO = "medvit-5c-no_seed-baseline", 8
MEDVIT_F32 = {"logits": 1e-3, "loss": 1e-4, "grads": 1e-3, "grad_max": 1e-2,
              "stats": 1e-3}
# Phase 20a, the uncertainty eval chain on Swin-T 5c: a synthetic cohort at
# raw shape IMG_SIZE (3 folds of 4: val and test 4 volumes each) and an
# out-of-domain cohort of 8 (one TTA batch at the Evaluator's default cap,
# 8 volumes x 8 views = 64 rows), the checkpoint's config (KFOLD / SPLIT /
# FOLD as the JAX trainer stores them), the bootstrap's resamples
CHAIN_SUBJECTS, CHAIN_OD_SUBJECTS, CHAIN_BOOTSTRAP = 12, 8, 1000
TTA_CAP = 8            # the Evaluator's TTA batch (VSN_TTA_BATCH's default)
CHAIN_CONFIG = dict(KFOLD=3, SPLIT=[1, 1, 1], FOLD=0)
CHAIN_SUM_TOL = 1e-4   # each CSV row's probabilities sum to 1
WARP_TOL = 1e-4        # the card's warp against the CPU's, of |volume|
# ViT-S 5c (vit-5c-no_seed-baseline: 144x160x144 / 16^3 + CLS = 811 tokens,
# 12 blocks of 384, 6 heads of 64): one K1 (its key-tiled body) and one K2
# a block; the eval volumes (144x168x144) are resized on the card
VIT_PRESET, VIT_MICRO = "vit-5c-no_seed-baseline", 24
VIT_PER_FORWARD = {"attn_half_tiled": 12, "ln_mlp": 12}
VIT_PER_PASS = {**VIT_PER_FORWARD, "attn_half_bwd_tiled": 12,
                "ln_mlp_bwd": 12}
VIT_CASES = {"no mask", "no bias", "N=811"}
# K1's names for ViT's calls, and the key-tiled body's launch counters
TILED_NAME = {"attn_half": "attn_half_tiled",
              "attn_half_bwd": "attn_half_bwd_tiled"}
# The head dims that phase 7 re-heads Swin's calls to, each call whose width
# it divides: 24 and 12, not multiples of the tiled body's mma depth of 16
# (a bf16 row of 12 channels, 24 bytes, is staged by plain loads); 192 and
# 768, above the body's 128, on its slab kernels (2 and 6 slabs; the padded
# C = 384 and N = 150 C = 768 calls, and K4 on the same windows). Its other
# calls' geometries (map dims, window, shift, C, heads): d = 24 at N = 450
# (2 samples of 8 windows), d = 40 over Swin-T's stage-1 windows (a
# sample's 216 windows of 252 tokens; TRAIN_MICRO samples), and the V1 / V3
# calls at WIDE_V_HEAD_DIM (K4 calls over 2 samples of Swin-T's shifted
# stage-2 map, 8 windows of 252 tokens, 2 heads of 192)
ODD_HEAD_DIMS = (24, 12, 192, 768)
ODD_N_GEOMETRY = ((18, 20, 10), (9, 10, 5), (4, 5, 2), 96, 4)
ODD_WIDE = ((36, 42, 36), (6, 7, 6), (3, 3, 3), 120, 3)
TILED_HEAD_DIM = 128   # the tiled body's widest head; above it its slabs
WIDE_V_HEAD_DIM = 192
WIDE_V = ((12, 14, 12), (6, 7, 6), (3, 3, 3), 384, 2)
# The wide-head model runs (phase 16b): Swin-T LN 5c with one head a stage
# (d = 96, 192, 384, 768: stage 1 on the tiled body, 2-4 on its slabs) and
# ViT-S's widths at 2 heads of 192 (ViT3D(dim_head=192): the configs fix
# dim_head at 64, as the reference does), eval of BATCH volumes and one
# training step each, against the plain route
WIDE_SWIN_HEADS = [1, 1, 1, 1]
WIDE_VIT_HEADS = (2, 192)   # heads, dim_head
WIDE_SWIN_PER_FORWARD = {"attn_half_tiled": 2, "attn_half_slabs": 10,
                         "ln_mlp": 12, "spatial_to_windows": 3,
                         "windows_to_windows": 2, "windows_to_spatial": 2}
WIDE_SWIN_PER_PASS = {**WIDE_SWIN_PER_FORWARD, "attn_half_bwd_tiled": 2,
                      "attn_half_bwd_slabs": 10, "ln_mlp_bwd": 12,
                      **{f"{m}_adjoint": WIDE_SWIN_PER_FORWARD[m]
                         for m in ("spatial_to_windows", "windows_to_windows",
                                   "windows_to_spatial")}}
WIDE_VIT_PER_FORWARD = {"attn_half_slabs": 12, "ln_mlp": 12}
WIDE_VIT_PER_PASS = {**WIDE_VIT_PER_FORWARD, "attn_half_bwd_slabs": 12,
                     "ln_mlp_bwd": 12}
# calls a launch-alone time of phase 17 averages over (CUDA events)
LAUNCH_REPS = 10
KEY_TILE = 64   # keys per shared-memory tile of the tiled body (kTileK)
# logits of the tiled saturation phase: 45 and 200 (exp exact under the
# row-max shift), -200 (every exp underflows under the max(rowmax, 0)
# shift: the clamp decides the output)
TILED_LOGITS = (45.0, 200.0, -200.0)
# K5 parity geometries, (shape DHW, kernel, strides, C_out): those of
# tests/test_stem_im2col.py (the ResNet and MedViT stems, stride 1, odd
# extents) and the ResNet stem at 16x18x16 with 64 channels; then the
# slice's own stem call at micro-batch 12
STEM_GEOMS = [((12, 14, 12), (7, 7, 7), (1, 2, 2), 16),
              ((12, 14, 12), (3, 3, 3), (2, 2, 2), 16),
              ((8, 10, 8), (3, 3, 3), (1, 1, 1), 16),
              ((9, 11, 13), (3, 5, 3), (2, 2, 1), 16),
              ((16, 18, 16), (7, 7, 7), (1, 2, 2), 64)]
RESNET_STEM = ((144, 168, 144), (7, 7, 7), (1, 2, 2), 64)
# K5's tensor-core bodies (csrc/stem_im2col.cu), each at x-strides 1 and 2,
# and its f32 FMA forward, whose 24 bytes of spills predate them
STEM_MMA = ("stem_fwd_mma_kernel", "stem_dw_mma_kernel")
STEM_F32_FMA = "stem_fwd_kernel<float"
# The row bodies, as the ptxas report of row_kernels.cu and
# window_relayout.cu lists them: the LN backward (2 types x 2 modes x 13
# plans: 8-column units at K = 1-3 in a warp and K = 2-4 across warps,
# single columns at K = 1, 2, 4, 8 and K = 8, 16, 32 across warps), LN's
# rows (bf16, f32 and f32 -> bf16 x the 13 plans), the post-norm forward's
# finish (2 types x the 13 plans), the column sums (2 types x 7 plans), the
# ordered sum, the LayerScale gradients (4- and 1-column units, a row in a
# warp or across warps), and K3's gather (16-, 4- and 1-byte chunks)
ROW_BODIES = {"ln_bwd_rows_kernel": 52, "ln_rows_kernel": 39,
              "postnorm_fwd_kernel": 26, "colsum_kernel": 14,
              "ordered_sum_kernel": 1, "layerscale_grads_kernel": 4,
              "relayout_map_kernel": 3}
# H100 SXM datasheet peaks: HBM bytes/s and dense FLOP/s
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
# the forward call whose arguments set a kernel's work (bound_ms)
FORWARD_OF = {**{f"{base}_slabs": base.removesuffix("_bwd")
                 for base in SLAB_BASES},
              "attn_half_bwd": "attn_half", "ln_mlp_bwd": "ln_mlp",
              "attn_half_tiled": "attn_half",
              "attn_half_bwd_tiled": "attn_half",
              "stem_im2col_dw": "stem_im2col", "attention_bwd": "attention",
              **{f"{m}_adjoint": m for m in MOVERS},
              **{f"{v}_bwd": v for v in V_KERNELS},
              **{name: "ln_mlp" if base.startswith("ln_mlp") else "attn_half"
                 for name, base in RESIDUAL_KERNELS.items()}}
# attn_half cases the parity sets must cover at the flagship geometry
ATTN_CASES = {"shifted ids", "padded ids", "no mask", "N=150"}
# and the V sets besides: V1 at the padded N, V3 with W not dividing nW
V_CASES = {"attention_split": ATTN_CASES | {f"N={PAD_N}"},
           "attention_windows": ATTN_CASES | {"W not dividing nW"}}
# differentiable arguments of the block kernels: (index, gradient name)
DIFF = {
    "attn_half": ((0, "dx"), (1, "dnorm_w"), (2, "dnorm_b"), (3, "dqkv_w"),
                  (4, "dqkv_b"), (5, "dbias"), (7, "dproj_w"),
                  (8, "dproj_b")),
    "ln_mlp": ((0, "dx"), (1, "dnorm_w"), (2, "dnorm_b"), (3, "dfc1_w"),
               (4, "dfc1_b"), (5, "dfc2_w"), (6, "dfc2_b")),
    "attention": ((0, "dqkv"), (1, "dbias")),
    "attention_split": ((0, "dq"), (1, "dk"), (2, "dv"), (3, "dbias")),
    "attention_windows": ((0, "dqkv"), (1, "dbias")),
}


def log(*parts):
    print(*parts, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def kernel_table():
    """name -> (kernel wrapper, plain version) of the forward wrappers the
    model calls; the block kernels' plain versions carry the plain
    backward."""
    from vsn_tpu_torch.ops import swin_block_kernels as sbk
    from vsn_tpu_torch.ops import window_relayout as wr

    return {
        "attn_half": (sbk.attn_half, sbk.attn_half_reference),
        "ln_mlp": (sbk.ln_mlp, sbk.ln_mlp_reference),
        "spatial_to_windows": (wr.spatial_to_windows,
                               wr.spatial_to_windows_reference),
        "windows_to_windows": (wr.windows_to_windows,
                               wr.windows_to_windows_reference),
        "windows_to_spatial": (wr.windows_to_spatial,
                               wr.windows_to_spatial_reference),
    }


def attention_table():
    """name -> (kernel wrapper, plain version) of K4, the unfused blocks'
    attention; the plain version carries the plain backward."""
    from vsn_tpu_torch.ops import window_attention as wa

    return {"attention": (wa.window_attention_qkv,
                          wa.window_attention_qkv_reference)}


def v_table():
    """name -> (kernel wrapper, plain version) of V1 and V3, the window
    attention entry points on split heads and on the unpartitioned map; the
    plain versions carry the plain backward."""
    from vsn_tpu_torch.ops import window_attention as wa

    return {"attention_split": (wa.window_attention,
                                wa.window_attention_split_reference),
            "attention_windows": (wa.window_attention_windows,
                                  wa.window_attention_windows_reference)}


@contextmanager
def patched_model_ops(replace):
    """Route the models' kernel calls (models/swin3d.py and models/vit3d.py
    names) through ``replace(name, kernel, plain)``."""
    from vsn_tpu_torch.models import swin3d, vit3d

    table = {**kernel_table(), **attention_table()}
    new = {MODEL_NAME.get(name, name): replace(name, *fns)
           for name, fns in table.items()}
    with mock.patch.multiple(swin3d, **new), mock.patch.multiple(
            vit3d, **{k: new[k] for k in BLOCK_KERNELS}):
        yield


def record_calls(model, images, blocks=None, **kwargs):
    """Every kernel call of one forward, run through the plain versions:
    [(name, args)], the positional arguments (a block's lam, gamma and
    post_norm keywords are left out). No graph is kept, and the tensors are ordinary ones, so
    the backward phase can differentiate through them. ``blocks``, a list,
    receives the (window, padded grid dims) of every unfused block in call
    order, one per K4 call (models/swin3d.py SwinBlock3D.forward_unfused)."""
    import torch
    from vsn_tpu_torch.models import swin3d

    calls = []

    def recorder(name, kernel, plain):
        def fn(*args, **kw):
            calls.append((name, args))
            return plain(*args, **kw)
        return fn

    unfused = swin3d.SwinBlock3D.forward_unfused

    def block(blk, x, *args):
        blocks.append((blk.window, tuple(x.shape[1:4])))
        return unfused(blk, x, *args)

    with torch.no_grad(), patched_model_ops(recorder), mock.patch.object(
            swin3d.SwinBlock3D, "forward_unfused",
            unfused if blocks is None else block):
        model(images, **kwargs)
    return calls


def sample_gains(b, device):
    """Distinct per-sample forward and backward gains, gf != gb in every
    sample, so a wrong sample index or a backward using gf shows."""
    import torch

    return (torch.linspace(0.6, 1.4, b, device=device),
            torch.linspace(1.25, 0.35, b, device=device))


def seeded_params(name, args, gen):
    """A K1/K2 call with its parameters and gains replaced by seeded
    non-trivial ones.

    Init-scale weights (trunc-normal 0.02, zero biases, unit LayerNorm) make
    the branches tiny against the residual, so a kernel missing a term could
    still agree. Here LayerNorm scale is 1 + 0.1 z, shifts and biases are
    0.1 z, projections are fan_in^-0.5 z (O(1) activations and logits at
    every width) and the relative-position bias is z: each term moves the
    output by far more than the tolerance. Activations and ids stay as the
    forward gave them; the movers' calls are returned as they are. A K4
    call gets qkv = z in its dtype (O(1) logits at a head dim of 32) and
    bias = z; the V calls are made from seeded K4 calls (``v_calls``) and
    are returned as they are."""
    import torch

    if name not in TOLERANT or name in V_KERNELS:
        return args
    x = args[0]
    c = x.shape[-1]

    def r(*shape, k=1.0):
        return (torch.randn(*shape, generator=gen) * k).to(x.device)

    if name == "attention":
        qkv, bias, ids, scale, heads = args
        return r(*qkv.shape).to(qkv.dtype), r(*bias.shape), ids, scale, heads
    if name == "attn_half":
        (x, _, _, _, qkv_b, bias, ids, _, _, gf, _, scale, heads) = args
        return (x, 1 + r(c, k=0.1), r(c, k=0.1), r(3 * c, c, k=c ** -0.5),
                None if qkv_b is None else r(3 * c, k=0.1),
                None if bias is None else r(*bias.shape), ids,
                r(c, c, k=c ** -0.5), r(c, k=0.1),
                *sample_gains(gf.shape[0], x.device), scale, heads)
    (x, _, _, fc1_w, _, _, _, gf, _) = args
    hid = fc1_w.shape[0]
    return (x, 1 + r(c, k=0.1), r(c, k=0.1), r(hid, c, k=c ** -0.5),
            r(hid, k=0.1), r(c, hid, k=hid ** -0.5), r(c, k=0.1),
            *sample_gains(gf.shape[0], x.device))


def case_kind(name, args):
    """The case a call exercises, e.g. 'shifted ids' or 'N=150'."""
    if name == "attn_half":
        ids = args[6]
        kinds = {"no mask" if ids is None else
                 "padded ids" if bool((ids < 0).any()) else "shifted ids",
                 f"N={args[0].shape[1]}"}
        return kinds if args[5] is not None else kinds | {"no bias"}
    if name in ("attention", *V_KERNELS):
        # an unshifted block passes one row of zeros
        ids = args[4] if name == "attention_split" else args[2]
        kind = ("padded ids" if bool((ids < 0).any()) else
                "no mask" if ids.shape[0] == 1 and not bool(ids.any()) else
                "shifted ids")
        kinds = {kind, f"N={ids.shape[1]}"}
        if name == "attention_windows" and windows_per_sample(
                args[0], args[5]) % ids.shape[0]:
            kinds.add("W not dividing nW")
        return kinds
    if name == "ln_mlp":
        return {f"C={args[0].shape[-1]}"}
    return {f"roll={tuple(args[-1])}"}


def compare(name, kernel, plain, args, lam=None, **mode):
    """(max|d|, limit, ok) of one forward call of ``kernel`` against
    ``plain`` (``mode``: a block kernel's gamma and post_norm)."""
    import torch

    kw = ({} if lam is None else {"lam": lam}) | mode
    with torch.inference_mode():
        got, want = kernel(*args, **kw), plain(*args, **kw)
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{name}: {tuple(got.shape)}/{got.dtype} vs "
                             f"{tuple(want.shape)}/{want.dtype}")
    err = (got.float() - want.float()).abs().max().item()
    if name not in TOLERANT:
        return err, 0.0, bool(torch.equal(got, want))
    dtype = str(want.dtype).removeprefix("torch.")
    limit = TOL[dtype] * max(1.0, want.float().abs().max().item())
    return err, limit, err <= limit


def _grads(fn, args, lam, dout, index, gamma=None, post_norm=False):
    """Gradients of <fn(*args, lam), dout> w.r.t. the arguments at ``index``
    that are not None: {index: grad}; with a block kernel's ``gamma`` (and
    ``post_norm``) also {"gamma": dgamma}."""
    import torch

    args = list(args)
    leaves = [i for i in index if args[i] is not None]
    for i in leaves:
        args[i] = args[i].detach().clone().requires_grad_()
    kw = {} if lam is None else {"lam": lam}
    tensors = [args[i] for i in leaves]
    if gamma is not None or post_norm:
        kw["post_norm"] = post_norm
    if gamma is not None:
        kw["gamma"] = gamma.detach().clone().requires_grad_()
        tensors.append(kw["gamma"])
        leaves = [*leaves, "gamma"]
    out = fn(*args, **kw)
    if out.grad_fn is None:
        raise AssertionError("the output carries no graph")
    grads = torch.autograd.grad(out, tensors, dout)
    return out, dict(zip(leaves, grads))


def cotangent(name, args, gen):
    """A seeded cotangent for the output of one call of the tolerant
    kernel ``name`` (K4 and V3 take qkv's 3C channels to C; K1, K2 and V1
    keep their input's shape), in the input's dtype."""
    import torch

    x = args[0]
    shape = ((*x.shape[:-1], x.shape[-1] // 3)
             if name in ("attention", "attention_windows") else x.shape)
    return torch.randn(shape, generator=gen).to(x.device, x.dtype)


def grad_compare(name, kernel, plain, args, lam, gen, gamma=None,
                 post_norm=False):
    """[(grad name, max|d|, limit, ok)] of the VJP of one call of ``kernel``
    against ``plain``'s for one seeded cotangent: block kernels to TOL of
    each gradient's own scale (and finite), dgamma too in a LayerScale mode
    (``gamma``, ``post_norm``: a block kernel's residual mode), movers
    bit-exact."""
    import torch

    x = args[0]
    if name in MOVERS:
        with torch.no_grad():
            shape = plain(*args).shape
        dout = torch.randn(shape, generator=gen).to(x.device, x.dtype)
    else:
        dout = cotangent(name, args, gen)
    if name in MOVERS:
        out, got = _grads(kernel, args, None, dout, (0,))
        ref, want = _grads(plain, args, None, dout, (0,))
        ok = torch.equal(out, ref) and torch.equal(got[0], want[0])
        err = (got[0].float() - want[0].float()).abs().max().item()
        return [("adjoint", err, 0.0, bool(ok))]
    index = [i for i, _ in DIFF[name]]
    _, got = _grads(kernel, args, lam, dout, index, gamma, post_norm)
    _, want = _grads(plain, args, lam, dout, index, gamma, post_norm)
    dtype = str(x.dtype).removeprefix("torch.")
    rows = []
    for i, gname in (*DIFF[name], ("gamma", "dgamma")):
        if i not in want:
            continue
        g, w = got[i].float(), want[i].float()
        if got[i].dtype != want[i].dtype or g.shape != w.shape:
            raise AssertionError(f"{name} {gname}: {got[i].dtype} "
                                 f"{tuple(g.shape)} vs {want[i].dtype} "
                                 f"{tuple(w.shape)}")
        err = (g - w).abs().max().item()
        limit = TOL[dtype] * w.abs().max().item()
        rows.append((gname, err, limit,
                     bool(torch.isfinite(g).all()) and err <= limit))
    return rows


def _report(label, groups, kinds, failed):
    for (name, check), g in groups.items():
        limit = ("bit-exact" if g["exact"] else
                 f"worst {g['ratio']:.3f} of the limit")
        log(f"parity {label} {name} {check}: {g['n']} calls "
            f"({', '.join(sorted(kinds[name]))}), max|d| "
            f"{g['err']:.3e} ({limit}) "
            f"{'ok' if not g['bad'] else 'FAIL in %d' % g['bad']}")
        if g["bad"]:
            failed.append(f"{label} {name} {check}")


def _group(groups, key, err, limit, ok):
    g = groups.setdefault(key, {"n": 0, "err": 0.0, "ratio": 0.0, "bad": 0,
                                "exact": not limit})
    g["n"] += 1
    g["err"] = max(g["err"], err)
    g["ratio"] = max(g["ratio"], err / limit if limit else 0.0)
    g["bad"] += not ok


def parity_phase(sets, table, gen):
    """Hold every recorded call of every set against its plain version.

    sets: {label: [(name, args)]}; table: kernel_table(). Logs one line per
    (set, kernel, check) and raises AssertionError naming every group that
    failed. Returns ({name: worst max|d|}, {label: {name: case kinds}})."""
    worst = collections.defaultdict(float)
    kinds = {}
    failed = []
    for label, calls in sets.items():
        kinds[label] = collections.defaultdict(set)
        groups = {}
        for name, args in calls:
            kernel, plain = table[name]
            args = seeded_params(name, args, gen)
            kinds[label][name] |= case_kind(name, args)
            checks = ((("branch", 0.0), ("residual", PATH_LAM))
                      if name in BLOCK_KERNELS else
                      (("out" if name in TOLERANT else "exact", None),))
            for check, lam in checks:
                err, limit, ok = compare(name, kernel, plain, args, lam)
                _group(groups, (name, check), err, limit, ok)
                worst[name] = max(worst[name], err)
        _report(label, groups, kinds[label], failed)
    if failed:
        raise AssertionError("kernels disagree with their plain versions: "
                             + "; ".join(failed))
    return dict(worst), kinds


def backward_name(name):
    return f"{name}_bwd" if name in TOLERANT else f"{name}_adjoint"


def grad_parity_phase(sets, table, gen):
    """Hold the VJP of every recorded call against its plain version's, as
    ``parity_phase`` holds the forwards (lam 0 and 1 for the block kernels;
    one line per (set, backward kernel, check)). Returns ({backward kernel
    name: worst max|d|}, {label: {name: case kinds}})."""
    worst = collections.defaultdict(float)
    all_kinds = {}
    failed = []
    for label, calls in sets.items():
        kinds = all_kinds[label] = collections.defaultdict(set)
        groups = {}
        for name, args in calls:
            kernel, plain = table[name]
            args = seeded_params(name, args, gen)
            bname = backward_name(name)
            kinds[bname] |= case_kind(name, args)
            lams = (0.0, PATH_LAM) if name in BLOCK_KERNELS else (None,)
            for lam in lams:
                for gname, err, limit, ok in grad_compare(name, kernel, plain,
                                                          args, lam, gen):
                    check = gname if lam is None else f"{gname} lam={lam:g}"
                    _group(groups, (bname, check), err, limit, ok)
                    worst[bname] = max(worst[bname], err)
        _report(label, groups, kinds, failed)
    if failed:
        raise AssertionError("backward kernels disagree with their plain "
                             "versions: " + "; ".join(failed))
    return dict(worst), all_kinds


def saturation_phase(calls, table, gen, name="attn_half",
                     logits=(45.0, 200.0)):
    """K1b (or K4b, V1b, V3b: ``name`` "attention", "attention_split",
    "attention_windows") at saturated logits: a shifted, masked call of
    ``calls`` (f32) with its bias set to 8 z + logit (z the seeded bias), so
    the logits sit near ``logit``; every gradient finite and within
    tolerance of the plain backward."""
    kernel, plain = table[name]
    at = {"attn_half": 5, "attention": 1, "attention_split": 3,
          "attention_windows": 1}[name]   # the bias argument
    lam = PATH_LAM if name in BLOCK_KERNELS else None
    args = next(a for n, a in calls if n == name
                and "shifted ids" in case_kind(n, a)
                and "no bias" not in case_kind(n, a))
    args = list(seeded_params(name, args, gen))
    bias = args[at]
    for logit in logits:
        args[at] = bias * 8 + logit
        rows = grad_compare(name, kernel, plain, args, lam, gen)
        ratio = max(err / limit for _, err, limit, _ in rows)
        bad = [g for g, _, _, ok in rows if not ok]
        log(f"parity saturated logits {logit:g}: {backward_name(name)} "
            f"{len(rows)} grads, worst {ratio:.3f} of the limit "
            f"{'ok' if not bad else 'FAIL'}")
        if bad:
            raise AssertionError(f"{backward_name(name)} at logits "
                                 f"{logit:g}: {bad}")


def k4_saturation_phase(calls, gen, logits=TILED_LOGITS):
    """K4f and K4b at saturated logits on the f32 K4 calls of ``calls``: a
    shifted call with its bias set to 8 z + logit (z the seeded bias), and
    the first call of each N with the keys of its last, ragged key tile 12
    higher besides, so the top logits of every row lie there and the
    running max grows at the last tile. At -200 K4's plain row max gives
    the softmax (K1's max(rowmax, 0) shift would underflow every exp). The
    forward and every gradient finite and within tolerance of the plain
    versions. Returns the worst max|d| of the forward and the backward."""
    kernel, plain = attention_table()["attention"]
    k4 = [a for n, a in calls if n == "attention"]
    shifted = next(a for a in k4 if "shifted ids" in case_kind("attention", a))
    by_n = {}
    for a in k4:
        by_n.setdefault(a[0].shape[1], a)
    cases = [(shifted, False)] + [(a, True) for a in by_n.values()]
    worst = [0.0, 0.0]
    for args, ragged in cases:
        args = list(seeded_params("attention", args, gen))
        n = args[0].shape[1]
        last = (n - 1) // KEY_TILE * KEY_TILE   # first key of the last tile
        z = args[1]
        for logit in logits:
            bias = z * 8 + logit
            if ragged:
                bias[:, :, last:] += 12.0
            args[1] = bias
            err, limit, ok = compare("attention", kernel, plain, args)
            rows = [("out", err, limit, ok)] + grad_compare(
                "attention", kernel, plain, args, None, gen)
            worst[0] = max(worst[0], err)
            worst[1] = max([worst[1]] + [e for _, e, _, _ in rows[1:]])
            ratio = max(_ratio(e, lim) for _, e, lim, _ in rows)
            bad = [g for g, _, _, ok in rows if not ok]
            where = f", top in keys {last}-{n - 1}" if ragged else ""
            log(f"parity K4 saturated logits {logit:g} (N = {n}{where}): "
                f"attention and attention_bwd {len(rows)} outputs, worst "
                f"{ratio:.3f} of the limit {'ok' if not bad else 'FAIL'}")
            if bad:
                raise AssertionError(f"K4 at logits {logit:g} (N = {n}"
                                     f"{where}): {bad}")
    return worst


def kept_launches(name):
    """(forward launch with its kept state, its plain version, backward
    launch from that state, its plain version) of window-attention kernel
    ``name``: K4 ("attention"), V1 ("attention_split") or V3
    ("attention_windows")."""
    from vsn_tpu_torch.ops import window_attention as wa

    stem = {"attention": "window_attention_qkv", "attention_split":
            "window_attention", "attention_windows":
            "window_attention_windows"}[name]
    return tuple(getattr(wa, stem + suffix) for suffix in (
        "_launch", "_kept_reference", "_backward_launch",
        "_kept_backward_reference"))


def kept_backward_args(name, args, dout, o, stats):
    """The backward launch's arguments for the forward call ``args`` of
    ``name``: its inputs (q, k, v or qkv), dout, the kept o and row
    statistics, then the rest of ``args``."""
    n_in = 3 if name == "attention_split" else 1
    return (*args[:n_in], dout, o, stats, *args[n_in:])


def _qkv_grads(name, grads):
    """(dq, dk, dv, dbias) of a backward launch's returns (K4 and V3 give
    dqkv, whose thirds of the channels are dq, dk, dv)."""
    if name == "attention_split":
        return grads
    dqkv, dbias = grads
    return (*dqkv.chunk(3, dim=-1), dbias)


def launch_compare(name, args, dout):
    """[(output, max|d|, limit, ok)] of the forward launch of ``name`` with
    its kept state and the backward launch from that state against their
    plain versions on one call: out and o to TOL of their scale; each row
    statistic (the max and 1 / the sum) elementwise to an f32 limit,
    STATS_RTOL of itself plus STATS_ATOL (the entry is the worst ratio, the
    limit 1); the backward from the plain o and statistics, dq, dk, dv and
    dbias each to TOL of its own scale."""
    import torch

    launch, kept_plain, backward, backward_plain = kept_launches(name)
    tol = TOL[str(args[0].dtype).removeprefix("torch.")]
    with torch.no_grad():
        got = launch(*args)
        want = kept_plain(*args)
        b_args = kept_backward_args(name, args, dout, want[2], want[1])
        bgot = _qkv_grads(name, backward(*b_args))
        bwant = _qkv_grads(name, backward_plain(*b_args))
    rows = []

    def add(label, g, w, limit):
        g, w = g.float(), w.float()
        err = (g - w).abs().max().item()
        rows.append((label, err, limit,
                     bool(torch.isfinite(g).all()) and err <= limit))

    for label, i in (("out", 0), ("o", 2)):
        add(label, got[i], want[i],
            tol * max(1.0, want[i].float().abs().max().item()))
    for label, col in (("max", 0), ("1/sum", 1)):
        # both sides form the statistics in f32, whatever the activation
        # type: each element to STATS_RTOL of itself plus STATS_ATOL
        g, w = got[1][..., col], want[1][..., col]
        r = ((g - w).abs() / (STATS_RTOL * w.abs() + STATS_ATOL)).max()
        rows.append((label, r.item(), 1.0,
                     bool(torch.isfinite(g).all()) and r.item() <= 1.0))
    for label, g, w in zip(("dq", "dk", "dv", "dbias"), bgot, bwant):
        add(label, g, w, tol * w.float().abs().max().item())
    return rows


def launch_parity_phase(sets, gen, names=("attention",), what="K4"):
    """The forward launches with their kept state and the backward launches
    from that state against their plain versions (``launch_compare``) on
    every call of ``names`` in ``sets`` (K4's seeded as ``parity_phase``
    seeds them; one seeded cotangent each). Logs one line per set and
    kernel; raises on any output beyond its limit. Returns the worst ratio
    to the limit."""
    worst, failed = 0.0, []
    for label, calls in sets.items():
        for name in names:
            ratio, bad, outputs = 0.0, 0, set()
            todo = [seeded_params(name, a, gen) for n, a in calls
                    if n == name]
            for args in todo:
                rows = launch_compare(name, args, cotangent(name, args, gen))
                ratio = max([ratio] + [_ratio(e, lim)
                                       for _, e, lim, _ in rows])
                bad += sum(not ok for *_, ok in rows)
                outputs |= {out for out, *_ in rows}
            log(f"parity {what} launches with the kept state {label} {name}: "
                f"{len(todo)} calls, {'/'.join(sorted(outputs))} worst "
                f"{ratio:.3f} of the limit "
                f"{'ok' if not bad else 'FAIL in %d' % bad}")
            worst = max(worst, ratio)
            if bad:
                failed.append(f"{label} {name}")
    if failed:
        raise AssertionError(f"kernels disagree with their plain versions: "
                             f"the {what} launches on {failed}")
    return worst


def kept_state(name, args):
    """What the backward reads of the forward's call on the card, for a
    direct backward call (``window_attention_qkv_backward``, ...) on the
    arguments ``args`` of ``name``: the f32 o and row statistics of one
    forward launch ({} on the CPU, where the plain backward recomputes the
    softmax)."""
    if not args[0].is_cuda:
        return {}
    _, stats, o = kept_launches(name)[0](*args)
    return dict(o=o, stats=stats)


def windows_per_sample(qkv, window):
    """Windows per sample of a V3 map qkv [B, D, H, W, 3C]."""
    return math.prod(m // w for m, w in zip(qkv.shape[1:4], window))


def split_call(args):
    """A K4 call (qkv [BW, N, 3C], bias, ids, scale, heads) as a V1 call
    on contiguous split heads: (q, k, v [BW, H, N, d], bias, ids, scale)."""
    qkv, bias, ids, scale, heads = args
    bw, n, c3 = qkv.shape
    q, k, v = (t.contiguous() for t in qkv.reshape(
        bw, n, 3, heads, c3 // (3 * heads)).permute(2, 0, 3, 1, 4))
    return q, k, v, bias, ids, scale


def padded_split_call(args, n_to=PAD_N):
    """A V1 call with N padded to ``n_to``, the layout
    fused_window_attention documents: zero q, k, v rows, pad ids -1, zero
    bias rows and columns."""
    import torch.nn.functional as F

    q, k, v, bias, ids, scale = args
    pad = n_to - q.shape[2]
    rows = lambda t: F.pad(t, (0, 0, 0, pad))
    return (rows(q), rows(k), rows(v), F.pad(bias, (0, pad, 0, pad)),
            F.pad(ids, (0, pad), value=-1), scale)


def windows_call(args, window, dims):
    """A K4 call of an unfused block (its window and padded grid dims) as
    a V3 call on the block's rolled, padded map: (qkv [B, D, H, W, 3C],
    bias, ids, scale, heads, window)."""
    from vsn_tpu_torch.models.swin3d import window_reverse

    qkv, bias, ids, scale, heads = args
    return (window_reverse(qkv, window, dims).contiguous(), bias, ids, scale,
            heads, tuple(window))


def synthetic_windows_call(dtype, device, gen):
    """The V3 call no model makes (W_NOT_DIVIDING): 3 id rows over 8
    windows per sample at B = 2, so a window's ids row (its flat index
    within its sample mod W) differs from the global bw % W in the second
    sample; qkv = z, bias = z, region ids drawn from {0, 1, 2}."""
    import torch

    b, dims, window, c, heads, rows = W_NOT_DIVIDING
    n = math.prod(window)
    ids = torch.randint(0, 3, (rows, n), generator=gen, dtype=torch.int32)
    return (torch.randn(b, *dims, 3 * c, generator=gen).to(device, dtype),
            torch.randn(heads, n, n, generator=gen).to(device),
            ids.to(device), (c // heads) ** -0.5, heads, window)


def v_calls(calls, blocks, gen):
    """The K4 calls of one recorded forward (``blocks``: record_calls'
    windows and grid dims), each seeded (``seeded_params``) and taken to
    V1 and V3: [(K4 args, V1 args, V3 args)]."""
    k4 = [args for name, args in calls if name == "attention"]
    if len(k4) != len(blocks):
        raise AssertionError(f"{len(k4)} K4 calls from {len(blocks)} blocks")
    out = []
    for args, (window, dims) in zip(k4, blocks):
        args = seeded_params("attention", args, gen)
        out.append((args, split_call(args), windows_call(args, window, dims)))
    return out


def v_main_calls(triples):
    """[(name, args)]: the V1 calls, then the V3 calls, of ``triples``."""
    return ([("attention_split", v1) for _, v1, _ in triples]
            + [("attention_windows", v3) for _, _, v3 in triples])


def v_sets(triples, gen):
    """{label: [(name, args)]}: each set's V1 and V3 calls, one more V1
    call at N padded to PAD_N (the set's first call's, N = 252 at Swin-T
    stage 1) and the synthetic V3 call in the set's dtype."""
    sets = {}
    for label, t in triples.items():
        first = t[0][1]
        sets[label] = v_main_calls(t) + [
            ("attention_split", padded_split_call(first)),
            ("attention_windows", synthetic_windows_call(
                first[0].dtype, first[0].device, gen))]
    return sets


def v_parity_phase(sets, table, gen, required=V_CASES):
    """Hold V1f/V3f and V1b/V3b on every call of ``sets`` against their
    plain versions (``parity_phase``, ``grad_parity_phase``), check that
    every set covers the ``required`` cases, and V1b/V3b at saturated
    logits on an f32 set. Returns {kernel name: worst max|d|}."""
    import torch

    worst, kinds = parity_phase(sets, table, gen)
    bworst, bkinds = grad_parity_phase(sets, table, gen)
    worst.update(bworst)
    for label in sets:
        for name, cases in required.items():
            bname = backward_name(name)
            for kname, found in ((name, kinds[label][name]),
                                 (bname, bkinds[label][bname])):
                if not cases <= found:
                    raise AssertionError(f"V set {label} lacks {kname} cases "
                                         f"{cases - found}")
    f32 = [calls for calls in sets.values()
           if calls[0][1][0].dtype == torch.float32]
    if not f32:
        raise AssertionError("no f32 V set for the saturated logits")
    for name in V_KERNELS:
        saturation_phase(f32[0], table, gen, name)
    return worst


def v_path(calls, gen):
    """The V path: every call of ``calls`` [(name, args)] through V1's or
    V3's entry point, forward and backward for one seeded cotangent, with
    every launch counter at 0 before; outputs and gradients finite.
    Returns the launch counts after."""
    import torch
    from vsn_tpu_torch.ops import _build

    table = v_table()
    _build.launches.clear()
    for name, args in calls:
        out, grads = _grads(table[name][0], args, None,
                            cotangent(name, args, gen),
                            [i for i, _ in DIFF[name]])
        if not all(bool(torch.isfinite(t).all())
                   for t in (out, *grads.values())):
            raise AssertionError(f"V path {name}: non-finite values")
    torch.cuda.synchronize()
    return {name: _build.launches[name] for name in KERNELS}


def start_ptxas():
    """``python -m vsn_tpu_torch.probes.ptxas`` on the window-attention
    source (K4, V1, V3), the GEMM source (every GEMM and weight-gradient
    instantiation of K1 / K2, tensor-core and FMA bodies, bf16 and f32),
    K1's two sources (its tiled launches and the probes'), the stem's
    (K5f / K5w, tensor-core and FMA bodies), the row kernels' (the
    LN-backward body, LN's rows and the column sums in every
    instantiation) and K3's, which compiles them
    once more with ``-Xptxas -v``: the process, to be read by
    ``ptxas_phase``."""
    import atexit
    import signal

    root = Path(__file__).resolve().parent
    proc = subprocess.Popen(
        [sys.executable, "-m", "vsn_tpu_torch.probes.ptxas",
         str(root / "vsn_tpu_torch" / "csrc"), "window_attention_qkv.cu",
         "gemm.cu", "attn_half.cu", "attn_half_bwd.cu", "stem_im2col.cu",
         "row_kernels.cu", "window_relayout.cu"],
        cwd=root, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        start_new_session=True)

    def stop():  # it and its nvcc, if a phase fails before phase 5
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()

    atexit.register(stop)
    return proc


def ptxas_phase(proc):
    """Log the registers of every kernel of the window-attention, GEMM, K1
    and stem sources (``start_ptxas``'s report: source, registers, spill
    stores, spill loads, name) and fail if one spills, if no V1 / V3
    instantiation (layout ``Split`` / ``MapRows``) is there, if a
    tensor-core GEMM or weight-gradient body is missing, if K5's
    tensor-core bodies (``STEM_MMA``) are not there at both x-strides, or if
    row_kernels.cu and window_relayout.cu do not compile the row bodies
    and K3's gather as ``ROW_BODIES`` counts them.
    K5f's f32 FMA body (``STEM_F32_FMA``), which keeps its statements and
    registers, is logged and not held to the spill gate: it has spilled
    since it was written."""
    out, err = proc.communicate(timeout=900)
    if proc.returncode:
        raise AssertionError(f"ptxas report failed: {err[-2000:]}")
    rows = [line.split(None, 4) for line in out.splitlines() if line.strip()]
    for _, regs, st, ld, name in rows:
        log(f"ptxas {regs} registers, spills {st} / {ld} bytes: {name}")
    spills = [r[4] for r in rows
              if (int(r[2]) or int(r[3])) and STEM_F32_FMA not in r[4]]
    layouts = {lay for r in rows for lay in ("Split", "MapRows")
               if lay in r[4]}
    bodies = {body for r in rows for body in ("gemm_mma_kernel",
                                              "wgrad_mma_kernel")
              if body in r[4]}
    stem = collections.Counter(body for r in rows for body in STEM_MMA
                               if body in r[4])
    redesigned = collections.Counter(
        body for r in rows for body in ROW_BODIES
        if body in r[4] and r[0] in ("row_kernels.cu", "window_relayout.cu"))
    if spills or layouts != {"Split", "MapRows"} or len(bodies) != 2 or \
            stem != dict.fromkeys(STEM_MMA, 2) or redesigned != ROW_BODIES:
        raise AssertionError(f"window attention, GEMM, K1, stem, row and K3 "
                             f"kernels that spill: {spills}; V layouts "
                             f"compiled: {sorted(layouts)}; tensor-core GEMM "
                             f"bodies: {sorted(bodies)}; K5 tensor-core "
                             f"bodies (x-strides 1 and 2): {dict(stem)}; the "
                             f"row and K3 bodies of row_kernels.cu "
                             f"and window_relayout.cu: {dict(redesigned)}, "
                             f"expected {ROW_BODIES}")


def k4_agreement(triples, gen):
    """V1 (heads merged) and V3 (windows partitioned) against K4 on the same
    values: the forward launches' out, row statistics and o must equal
    K4f's bit for bit (one body stages the same tiles and runs the same
    products on every layout); then, from each one's own kept state and one
    seeded cotangent, V1b's and V3b's dq, dk, dv against K4b's (their
    largest difference, logged) and dbias within TOL["float32"] of its
    scale (its f32 atomics add in an order that varies). Raises where they
    differ; returns {what: largest |difference|}."""
    import torch
    from vsn_tpu_torch.models.swin3d import window_partition, window_reverse
    from vsn_tpu_torch.ops import window_attention as wa

    diff = dict.fromkeys(("V1f", "V3f", "V1b", "V3b", "V1b dbias",
                          "V3b dbias"), 0.0)
    unequal, loose = [], []

    def merged(t):  # [BW, H, N, d] -> [BW, N, H d]
        return t.transpose(1, 2).reshape(t.shape[0], t.shape[2], -1)

    with torch.no_grad():
        for k4, v1, v3 in triples:
            window, dims = v3[5], v3[0].shape[1:4]
            ref = wa.window_attention_qkv_launch(*k4)
            g = cotangent("attention", k4, gen)
            want = wa.window_attention_qkv_backward_launch(
                k4[0], g, ref[2], ref[1], *k4[1:])
            out, stats, o = wa.window_attention_launch(*v1)
            got1 = (merged(out), stats, merged(o))
            d1 = wa.window_attention_backward_launch(
                *v1[:3], g.reshape(out.shape[0], out.shape[2], out.shape[1],
                                   -1).transpose(1, 2).contiguous(), o,
                stats, *v1[3:])
            b1 = (torch.cat([merged(t) for t in d1[:3]], dim=-1), d1[3])
            out, stats, o = wa.window_attention_windows_launch(*v3)
            got3 = (window_partition(out, window), stats,
                    window_partition(o, window))
            d3 = wa.window_attention_windows_backward_launch(
                v3[0], window_reverse(g, window, dims).contiguous(), o, stats,
                *v3[1:])
            b3 = (window_partition(d3[0], window), d3[1])
            for label, got, grads in (("V1", got1, b1), ("V3", got3, b3)):
                for g_, w_ in zip(got, ref):
                    diff[label + "f"] = max(diff[label + "f"], (
                        g_.float() - w_.float()).abs().max().item())
                    if not torch.equal(g_, w_):
                        unequal.append(label + "f")
                diff[label + "b"] = max(diff[label + "b"], (
                    grads[0].float() - want[0].float()).abs().max().item())
                err = (grads[1] - want[1]).abs().max().item()
                diff[label + "b dbias"] = max(diff[label + "b dbias"], err)
                if err > TOL["float32"] * want[1].abs().max().item():
                    loose.append(label + "b dbias")
    if unequal or loose:
        raise AssertionError(f"V1 / V3 differ from K4 on the same values: "
                             f"{sorted(set(unequal))} not bit-equal to K4f, "
                             f"{sorted(set(loose))} beyond the f32 limit")
    return diff


def composite_times(calls):
    """(forward ms, backward ms) of what V3 replaces, summed over the V3
    calls of ``calls``: window_partition -> K4f -> window_reverse, and the
    cotangent's partition -> K4b -> dqkv's reverse."""
    import torch
    from vsn_tpu_torch.models.swin3d import window_partition, window_reverse
    from vsn_tpu_torch.ops import window_attention as wa

    fwd = bwd = 0.0
    with torch.no_grad():
        for name, (qkv, bias, ids, scale, heads, window) in calls:
            if name != "attention_windows":
                continue
            dims = qkv.shape[1:4]
            rows = wa.window_ids(ids, windows_per_sample(qkv, window))
            fwd += cuda_ms(lambda: window_reverse(wa.window_attention_qkv(
                window_partition(qkv, window), bias, rows, scale, heads),
                window, dims))
            g = torch.randn(*qkv.shape[:4], qkv.shape[4] // 3,
                            device=qkv.device).to(qkv.dtype)
            # K4f's kept state, as the forward of a training step leaves it
            kept = kept_state("attention", (window_partition(qkv, window),
                                            bias, rows, scale, heads))
            bwd += cuda_ms(lambda: window_reverse(
                wa.window_attention_qkv_backward(
                    window_partition(qkv, window), bias, rows,
                    window_partition(g, window), scale, heads, **kept)[0],
                window, dims))
            del kept
    return fwd, bwd


def volumes(n, seed):
    """Seeded float16 MRI-sized volumes [n, 144, 168, 144, 1]."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, 144, 168, 144, 1), np.float32) * 50
            + 100).astype(np.float16)


def train_batch(cfg, device, seed):
    """One step's batch as bench.py lays it out: [A, micro, D, H, W, 1]
    float16 images and MixUp partners, one-hot labels, lam ~ Beta(0.3,
    0.3), apply with p = 0.5."""
    import torch

    rng = np.random.default_rng(seed)
    a, micro, k = TRAIN_ACCUM, cfg.BATCH_SIZE, cfg.num_classes
    shape = (a, micro, *cfg.input_size, 1)
    eye = np.eye(k, dtype=np.float32)
    batch = {
        "image": rng.standard_normal(shape, np.float32).astype(np.float16),
        "image2": rng.standard_normal(shape, np.float32).astype(np.float16),
        "label": eye[rng.integers(0, k, (a, micro))],
        "label2": eye[rng.integers(0, k, (a, micro))],
        "mix_lam": rng.beta(0.3, 0.3, (a, micro)).astype(np.float32),
        "mix_apply": rng.random((a, micro)) < cfg.MIXUP_PROB,
        "mix_bounds": np.zeros((a, micro, 6), np.int32),
    }
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


class Draws:
    """The random draws of each (step, micro-batch, pass) (``model.draw``:
    Swin's residual gains and dropout keep masks, the ResNet's head-dropout
    mask), drawn at each call from a generator seeded by ``draw_seed``, so
    every route gets the same ones without holding them all."""

    def __init__(self, model, micro, device, seed):
        self.model, self.micro, self.device, self.seed = (model, micro,
                                                          device, seed)

    def __call__(self, step, idx, pass_idx):
        import torch
        from vsn_tpu_torch.train.step import draw_seed

        gen = torch.Generator(device=self.device)
        gen.manual_seed(draw_seed(self.seed, step, idx, pass_idx))
        return self.model.draw(self.micro, self.device, gen)


def train_route(model, cfg, state, batch, draws, steps, sync):
    """Run ``steps`` train steps; returns ([metrics as floats], [seconds
    each])."""
    from vsn_tpu_torch.train.schedules import lr_wd_schedules
    from vsn_tpu_torch.train.step import make_batch_transform, make_train_step

    lr, wd = lr_wd_schedules(cfg)
    step = make_train_step(model, cfg, lr, wd, make_batch_transform(cfg),
                           draws)
    metrics, secs = [], []
    for _ in range(steps):
        sync()
        t0 = time.perf_counter()
        m = step(state, batch)
        sync()
        secs.append(time.perf_counter() - t0)
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, secs


def first_backward_grads(model, cfg, state, batch, draws):
    """One accumulation pass; returns the names of parameters whose gradient
    is zero or not finite (every one must be reached)."""
    import torch
    from vsn_tpu_torch.train.step import make_batch_transform, make_grad_fn

    make_grad_fn(model, cfg, make_batch_transform(cfg), draws)(state, batch,
                                                               0)
    return [name for name, g in state.params.tree(state.params.grad).items()
            if not bool(torch.isfinite(g).all()) or not bool((g != 0).any())]


@contextmanager
def plain_stem():
    """Route the ResNet stem (ops/conv_unfold.py's call) through the plain
    conv, whose backward is autograd's conv VJP."""
    from vsn_tpu_torch.ops import conv_unfold, stem_im2col

    with mock.patch.object(conv_unfold, "stem_conv_im2col",
                           stem_im2col.stem_conv_reference):
        yield


def check_probs(probs, n, k):
    """[n, k] finite probabilities whose rows sum to 1."""
    if probs.shape != (n, k):
        raise AssertionError(f"probs shape {probs.shape}")
    if not np.isfinite(probs).all():
        raise AssertionError("non-finite probs")
    row_err = np.abs(probs.sum(1) - 1).max()
    if row_err > 1e-3:
        raise AssertionError(f"prob rows sum off by {row_err}")


def compare_probs(label, probs, plain):
    """The kernel path's probs within 1e-2 of the plain path's, and the
    same argmax for every volume whose top two plain probs are further
    apart than twice the largest difference (elsewhere the order is within
    rounding)."""
    d = float(np.abs(probs - plain).max())
    top2 = np.sort(plain, axis=1)[:, -2:]
    decided = (top2[:, 1] - top2[:, 0]) > 2 * d
    agree = probs.argmax(1) == plain.argmax(1)
    log(f"{label} vs plain path: max|d probs| {d:.3e} (<= 1e-2), argmax "
        f"agrees on {int(agree.sum())}/{len(probs)} ({int(decided.sum())} "
        f"decided), probs range [{probs.min():.4f}, {probs.max():.4f}]")
    if d > 1e-2 or not agree[decided].all():
        raise AssertionError(f"{label}: kernel path probs differ from the "
                             f"plain path's by {d}, argmax {agree}")


def eval_rates(evaluator, images, plain, n_batches, label, card):
    """Eval vol/s of the kernel and the plain route (``plain()`` a context
    manager), in the order kernel, plain, plain, kernel."""
    import torch

    def timed():
        torch.cuda.synchronize()
        t = time.perf_counter()
        evaluator.predict(images)
        torch.cuda.synchronize()
        return time.perf_counter() - t

    runs = {"kernel": [], "plain": []}
    for which in ("kernel", "plain", "plain", "kernel"):
        if which == "plain":
            with plain():
                runs[which].append(timed())
        else:
            runs[which].append(timed())
    for which, secs in runs.items():
        mean = sum(secs) / len(secs)
        log(f"[{card}] {label} {which} path: {1e3 * mean / n_batches:.1f} ms "
            f"per batch of {evaluator.batch_size} (transfer + z-score + "
            f"forward + softmax), {len(images) / mean:.2f} vol/s")


def reach_every_parameter(model, cfg, state, batch, draws, label):
    """After one backward every parameter has a finite, non-zero
    gradient."""
    missing = first_backward_grads(model, cfg, state, batch, draws)
    n_params = len(state.params.names)
    log(f"{label} path: first backward reached {n_params - len(missing)} of "
        f"{n_params} parameters (non-zero, finite)")
    if missing:
        raise AssertionError(f"{label}: no gradient reached {missing}")


def params_moved(state, initial, after0, label):
    """Finite parameters that step 0 (lr 0 under LR_WARMUP) left alone and
    the later steps moved, every parameter tensor, and EMA weights apart
    from the live ones."""
    import torch

    flat = state.params.flat
    if not bool(torch.isfinite(flat).all()):
        raise AssertionError(f"{label}: non-finite parameters")
    if not torch.equal(after0, initial):
        raise AssertionError(f"{label}: step 0 (lr 0 under LR_WARMUP) moved "
                             "the parameters")
    moved = (flat - after0).abs().max().item()
    still = [name for name, d in state.params.tree(flat - after0).items()
             if not bool((d != 0).any())]
    ema_gap = (state.ema.ema[:flat.numel()] - flat).abs().max().item()
    log(f"{label} path: parameters moved by {moved:.3e} after step 1 "
        f"({len(state.params.names) - len(still)} of "
        f"{len(state.params.names)} tensors), EMA {ema_gap:.3e} from the "
        f"live weights, skipped {int(state.skipped)}")
    if not moved > 0 or not ema_gap > 0 or still:
        raise AssertionError(f"{label}: parameters did not move ({still}) or "
                             "the EMA equals them")


def report_routes(label, kernel, plain, kernel_secs, plain_secs, vols,
                  recipe, card):
    """Check the plain route's steps against the kernel route's and log
    both routes' rates."""
    rel = check_train_metrics(kernel, plain)
    for i, (k, p) in enumerate(zip(kernel, plain)):
        log(f"{label} step {i}: loss {k['loss']:.5f} / plain {p['loss']:.5f}, "
            f"grad_norm {k['grad_norm']:.5f} / plain {p['grad_norm']:.5f}, "
            f"lr {k['lr']:.3e}")
    log(f"{label} path vs plain route: worst rel loss {rel['loss']:.3e} "
        f"(<= {TRAIN_RTOL['loss']}), grad_norm {rel['grad_norm']:.3e} "
        f"(<= {TRAIN_RTOL['grad_norm']})")
    for which, s in (("kernel", kernel_secs), ("plain", plain_secs)):
        mean = sum(s) / len(s)
        log(f"[{card}] {label} {which} route: {1e3 * mean:.1f} ms per step "
            f"of {vols} volumes ({recipe}), {vols / mean:.2f} vol/s (steps "
            f"{', '.join(f'{1e3 * t:.1f}' for t in s)} ms)")


def check_train_metrics(kernel, plain):
    """Finite losses and grad norms, nothing skipped, and the plain route's
    first steps within TRAIN_RTOL of the kernel route's."""
    for route, metrics in (("kernel", kernel), ("plain", plain)):
        for i, m in enumerate(metrics):
            if not (np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"])):
                raise AssertionError(f"{route} step {i}: {m}")
            if m["skipped"]:
                raise AssertionError(f"{route} step {i} skipped: {m}")
    worst = {}
    for i, (k, p) in enumerate(zip(kernel, plain)):
        for key, rtol in TRAIN_RTOL.items():
            rel = abs(k[key] - p[key]) / abs(p[key])
            worst[key] = max(worst.get(key, 0.0), rel)
            if rel > rtol:
                raise AssertionError(f"step {i} {key}: kernel {k[key]} vs "
                                     f"plain {p[key]} (rel {rel:.3e} > "
                                     f"{rtol})")
    return worst


# the window-attention kernels' backward and its plain version (attributes
# of ops/window_attention.py), whose arguments put the cotangent after
# (q, k, v, bias, ids) for V1 and after (qkv, bias, ids) for K4 and V3
KEPT_BACKWARD = {
    "attention": ("window_attention_qkv_backward",
                  "window_attention_qkv_backward_reference"),
    "attention_split": ("window_attention_backward",
                        "window_attention_backward_reference"),
    "attention_windows": ("window_attention_windows_backward",
                          "window_attention_windows_backward_reference"),
}


def cuda_ms(fn, reps=3, queued=False):
    """ms per call of ``fn`` by CUDA events over ``reps`` calls after a
    warm-up call. ``queued``: the calls wait on the stream behind a spin
    kernel (``torch.cuda._sleep``) that outlasts their host work, so that
    the events bracket the device's time alone, not a wrapper's host time
    where that exceeds its launches'."""
    import torch

    fn()
    torch.cuda.synchronize()
    if queued:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        host = time.perf_counter() - t0
        torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if queued:  # cycles at <= 2 GHz: at least 1.5 x the host time + 1 ms
        torch.cuda._sleep(int(2e9 * (1.5 * host + 1e-3)))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def launch_ms(fn):
    """Device ms per call of ``fn``, a kernel's launches alone: CUDA events
    over LAUNCH_REPS calls queued behind a spin kernel (``cuda_ms``)."""
    return cuda_ms(fn, LAUNCH_REPS, queued=True)


def phase_shares(fn, label, tags):
    """{tag: the share of ``fn``'s device kernel time spent in kernels whose
    name holds ``tag``}, from a torch.profiler trace of 3 calls after a
    warm-up (trace in build/): the split of an events-timed sum into its
    launches (K1b's, K4b's, V1b's, V3b's phases A and B), which only the
    profiler can make. Short traces lose kernel time unevenly between runs
    (0.4-2x below CUDA events), so only the shares are used; a short trace
    has also come back with no kernel at all (once in a full run on the
    H100), so the trace is taken up to three times before that raises."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    trace = Path(__file__).resolve().parent / "build" / f"{label}_trace.json"
    trace.parent.mkdir(exist_ok=True)
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                fn()
            torch.cuda.synchronize()
        prof.export_chrome_trace(str(trace))
        by_tag, total = collections.Counter(), 0.0
        for e in json.loads(trace.read_text())["traceEvents"]:
            if e.get("cat") == "kernel":
                total += e["dur"]
                for tag in tags:
                    if tag in e["name"]:
                        by_tag[tag] += e["dur"]
        if total:
            return {tag: by_tag[tag] / total for tag in tags}
    raise AssertionError(f"{label}: the profiler recorded no kernel")


def mover_adjoints():
    """mover -> (its adjoint's kernel, the plain adjoint), each a function
    of (g, the mover call's arguments): the opposite move with the roll
    negated."""
    from vsn_tpu_torch.ops import window_relayout as wr

    neg = lambda roll: tuple(-r for r in roll)
    return {
        "spatial_to_windows": (
            lambda g, a: wr.windows_to_spatial(g, a[1], a[0].shape[1:4],
                                               neg(a[2])),
            lambda g, a: wr.windows_to_spatial_reference(
                g, a[1], a[0].shape[1:4], neg(a[2]))),
        "windows_to_windows": (
            lambda g, a: wr.windows_to_windows(g, a[1], a[2], neg(a[3])),
            lambda g, a: wr.windows_to_windows_reference(g, a[1], a[2],
                                                         neg(a[3]))),
        "windows_to_spatial": (
            lambda g, a: wr.spatial_to_windows(g, a[1], neg(a[3])),
            lambda g, a: wr.spatial_to_windows_reference(g, a[1],
                                                         neg(a[3]))),
    }


def mover_launch_times(calls, card):
    """The K3 launches alone at the mover calls of ``calls`` (one training
    micro-batch's: Swin-T's stages 1, 2 and 4), each forward and its
    adjoint: device ms by ``launch_ms``, the bandwidth reached (the bytes
    read and written and the map's 4 a row, ``call_work``, over that time)
    and its share of the HBM rate; one line per call. Returns {name: ms
    summed over the calls}."""
    import torch

    table = kernel_table()
    adjoints = mover_adjoints()
    out = collections.Counter()
    with torch.no_grad():
        for name, args in calls:
            if name not in MOVERS:
                continue
            g = table[name][1](*args)
            for kname, fn in ((name, lambda: table[name][0](*args)),
                              (f"{name}_adjoint",
                               lambda: adjoints[name][0](g, args))):
                t = launch_ms(fn)
                nbytes = call_work(kname, args)[1]
                rate = nbytes / t / 1e6  # GB/s
                out[kname] += t
                log(f"[{card}] {kname} alone at x {tuple(args[0].shape)} "
                    f"{args[0].dtype}, roll {tuple(args[-1])}: {t:.4f} ms, "
                    f"{rate:.0f} GB/s ({rate * 1e9 / HBM_BYTES_PER_S:.1%} "
                    f"of {HBM_BYTES_PER_S / 1e12:.2f} TB/s; {nbytes / 1e6:.1f}"
                    " MB moved)")
            del g
    log(f"[{card}] K3 alone, summed over a micro-batch of {TRAIN_MICRO}: "
        + ", ".join(f"{k} {v:.4f} ms" for k, v in out.items())
        + f"; all six {sum(out.values()):.4f} ms")
    return out


# K3 entry -> the layouts of its move (source in windows, destination in
# windows) and the sign of its roll against the mover call's (an adjoint is
# the opposite move, its roll negated: ``mover_adjoints``)
MOVER_MAPS = {
    "spatial_to_windows": (False, True, 1),
    "windows_to_windows": (True, True, 1),
    "windows_to_spatial": (True, False, 1),
    "spatial_to_windows_adjoint": (True, False, -1),
    "windows_to_windows_adjoint": (True, True, -1),
    "windows_to_spatial_adjoint": (False, True, -1),
}


def mover_gather(kname, args, src):
    """(src's rows [R, C], the row index [R] int64 on src's device) of the
    gather that K3 entry ``kname`` (a mover, or its adjoint with ``src`` a
    cotangent the size of the mover's output) makes on the mover call
    ``args``: ``relayout_map``'s host-built row map of one sample, the K3
    kernel's own, laid over the batch. ``rows.index_select(0, index)`` is
    the entry's output."""
    import torch
    from vsn_tpu_torch.ops import window_relayout as wr

    name = kname.removesuffix("_adjoint")
    x, window = args[0], tuple(int(w) for w in args[1])
    dims = tuple(int(d) for d in (x.shape[1:4] if name == "spatial_to_windows"
                                  else args[2]))
    src_windows, dst_windows, sign = MOVER_MAPS[kname]
    roll = tuple(int(sign * r) % d for r, d in zip(args[-1], dims))
    rows = torch.from_numpy(wr.relayout_map(dims, window, roll, src_windows,
                                            dst_windows)).long()
    per = rows.numel()
    flat = src.reshape(-1, src.shape[-1])
    index = (torch.arange(flat.shape[0] // per)[:, None] * per
             + rows[None]).flatten()
    return flat, index.to(src.device)


def mover_library_times(calls, card):
    """{K3 entry: ms summed over the mover calls of ``calls``} of the
    library's gather beside each K3 launch: one ``Tensor.index_select(0,
    index)`` a call over the same row map (``mover_gather``), by
    ``launch_ms``, a forward and its adjoint each; a yardstick the port
    never calls."""
    import torch

    table = kernel_table()
    out = collections.Counter()
    with torch.no_grad():
        for name, args in calls:
            if name not in MOVERS:
                continue
            g = table[name][1](*args)
            for kname, src in ((name, args[0]), (f"{name}_adjoint", g)):
                flat, index = mover_gather(kname, args, src)
                out[kname] += launch_ms(lambda: flat.index_select(0, index))
                del flat, index
            del g
    log(f"[{card}] K3's gather as Tensor.index_select over its row map, "
        f"summed over a micro-batch of {TRAIN_MICRO}: "
        + ", ".join(f"{k} {v:.4f} ms" for k, v in out.items()))
    return out


def kernel_times(calls, backward=True):
    """Per-kernel (ms, plain ms) summed over one forward's calls and (with
    ``backward``) their backward: the forward wrappers and K1b/K2b/K4b on
    the recorded arguments with one cotangent, the movers' adjoints as the
    opposite move."""
    import torch
    from vsn_tpu_torch.ops import swin_block_kernels as sbk
    from vsn_tpu_torch.ops import window_attention as wa

    table = {**kernel_table(), **attention_table(), **v_table()}
    ms = collections.defaultdict(float)
    plain_ms = collections.defaultdict(float)
    adjoints = mover_adjoints()
    with torch.no_grad():
        for name, args in calls:
            kernel, plain = table[name]
            ms[name] += cuda_ms(lambda: kernel(*args))
            plain_ms[name] += cuda_ms(lambda: plain(*args))
            if not backward:
                continue
            out = plain(*args)
            g = torch.randn(out.shape, device=out.device).to(out.dtype)
            bname = backward_name(name)
            if name == "attn_half":
                b_args = (*args[:8], args[10], g, *args[11:13])
                kept = k1_kept(args)
                ms[bname] += cuda_ms(lambda: sbk.attn_half_backward(*b_args,
                                                                    **kept))
                plain_ms[bname] += cuda_ms(
                    lambda: sbk.attn_half_backward_reference(*b_args))
            elif name == "ln_mlp":
                b_args = (*args[:6], args[8], g)
                ms[bname] += cuda_ms(lambda: sbk.ln_mlp_backward(*b_args))
                plain_ms[bname] += cuda_ms(
                    lambda: sbk.ln_mlp_backward_reference(*b_args))
            elif name in KEPT_BACKWARD:
                # the backward reads the kept state of its forward's call
                kernel_b, plain_b = (getattr(wa, f) for f in
                                     KEPT_BACKWARD[name])
                n_in = 5 if name == "attention_split" else 3
                b_args = (*args[:n_in], g, *args[n_in:])
                kept = kept_state(name, args)
                ms[bname] += cuda_ms(lambda: kernel_b(*b_args, **kept))
                plain_ms[bname] += cuda_ms(lambda: plain_b(*b_args))
                del kept
            else:
                adj, plain_adj = adjoints[name]
                ms[bname] += cuda_ms(lambda: adj(g, args))
                plain_ms[bname] += cuda_ms(lambda: plain_adj(g, args))
    return ms, plain_ms


def phase_tags(d):
    """The kernel names of a backward's phases A and B at head dim ``d``,
    as ``phase_shares`` finds them: the tiled body's, or its slab kernels'
    above TILED_HEAD_DIM."""
    if d > TILED_HEAD_DIM:
        return ("attention_slab_rows", "attention_slab_keys")
    return ("attention_bwd_rows", "attention_bwd_keys")


def slab_times(calls):
    """({slab entry: ms}, {slab entry: plain ms}, {slab entry: (bound ms,
    by)}) of the calls of ``calls`` above TILED_HEAD_DIM, under the slab
    kernels' entries (SLAB_NAME): ``kernel_times`` and ``bound_ms`` of each
    entry that the calls launch, forward and backward."""
    ms, plain = kernel_times(calls)
    bounds = {SLAB_NAME[base]: bound_ms(SLAB_NAME[base], calls)
              for base in ms}
    return ({SLAB_NAME[base]: t for base, t in ms.items()},
            {SLAB_NAME[base]: t for base, t in plain.items()}, bounds)


def sdpa_operands(qkv, bias, ids, heads):
    """q, k, v [BW, H, N, d] of a K4 call's packed qkv, and its additive
    float mask bias[h] + mask(ids) [BW, H, N, N] (bias[h] alone, [1, H, N,
    N], where ids is None) in qkv's dtype: the operands of the SDPA call
    that stands beside the kernels."""
    import torch
    from vsn_tpu_torch.ops.window_attention import mask_from_ids

    bw, n, c3 = qkv.shape
    q, k, v = (t.contiguous() for t in
               qkv.reshape(bw, n, 3, heads, -1).permute(2, 0, 3, 1, 4))
    mask = bias[None]
    if ids is not None:
        rows = torch.arange(bw, device=qkv.device) % ids.shape[0]
        mask = mask + mask_from_ids(ids)[rows][:, None]
    return q, k, v, mask.to(qkv.dtype)


def sdpa_times(calls):
    """(forward ms, backward ms) of the library's attention on K4's work,
    summed over the K4 calls of ``calls``: one
    ``F.scaled_dot_product_attention`` call per K4 call on its split heads
    [BW, H, N, d] with the additive float mask bias[h] + mask(ids) [BW, H,
    N, N] (bias[h] alone, [1, H, N, N], where ids is None: K1's unshifted
    calls) in qkv's dtype (made outside the timing), and that call's
    backward to q, k, v and the mask. A yardstick the port never calls."""
    import torch
    import torch.nn.functional as F

    fwd = bwd = 0.0
    for name, (qkv, bias, ids, scale, heads) in calls:
        if name != "attention":
            continue
        q, k, v, mask = sdpa_operands(qkv, bias, ids, heads)
        fwd += cuda_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, scale=scale))
        leaves = [t.detach().requires_grad_() for t in (q, k, v, mask)]
        out = F.scaled_dot_product_attention(*leaves[:3], attn_mask=leaves[3],
                                             scale=scale)
        g = torch.randn_like(out)
        bwd += cuda_ms(lambda: torch.autograd.grad(out, leaves, g,
                                                   retain_graph=True))
        del q, k, v, mask, leaves, out, g
    return fwd, bwd


def profile_phase(fn, label, per, n_units, card):
    """Device time by kernel and device idle share of one call of ``fn``
    (after a warm-up call outside the trace); trace in build/."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()  # warm-up outside the trace
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    trace = Path(__file__).resolve().parent / "build" / f"{label}_trace.json"
    trace.parent.mkdir(exist_ok=True)
    prof.export_chrome_trace(str(trace))
    events = [e for e in json.loads(trace.read_text())["traceEvents"]
              if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    if not events:
        raise AssertionError("profiler recorded no device activity")
    by_name = collections.Counter()
    spans = []
    for e in events:
        by_name[e["name"][:72]] += e["dur"]
        spans.append((e["ts"], e["ts"] + e["dur"]))
    busy, end = 0.0, -1.0
    for s, e in sorted(spans):  # union of device intervals
        if e > end:
            busy += e - max(s, end)
            end = e
    log(f"[{card}] profile {label}: device busy {busy / 1e3:.1f} ms of "
        f"{wall_us / 1e3:.1f} ms wall, idle share {1 - busy / wall_us:.3f} "
        f"(trace {trace.name}, profiler on)")
    for name, us in by_name.most_common(14):
        log(f"[{card}] profile {label}: {us / 1e3 / n_units:9.3f} ms per "
            f"{per} {100 * us / busy:5.1f}% of busy  {name}")


def stem_table():
    """name -> (K5 wrapper, plain version), with the signatures
    (x, kernel, strides, padding, dtype) and (x, g, kernel_shape, strides,
    padding, dtype)."""
    from vsn_tpu_torch.ops import stem_im2col as stem

    return {"stem_im2col": (stem.stem_conv_im2col, stem.stem_conv_reference),
            "stem_im2col_dw": (stem.stem_conv_dw, stem.stem_dw_reference)}


def stem_case(geom, batch, dtype, device, gen):
    """Seeded arguments of one stem call, (x, kernel, strides, padding, g):
    x [B, D, H, W, 1] in ``dtype``, an f32 kernel of O(1) outputs, and a
    cotangent g of the output's shape."""
    import torch
    from vsn_tpu_torch.ops.stem_im2col import output_shape

    shape, ks, strides, c_out = geom
    pad = tuple(k // 2 for k in ks)
    r = lambda *sh: torch.randn(*sh, generator=gen, device=device)
    taps = ks[0] * ks[1] * ks[2]
    x = r(batch, *shape, 1).to(dtype)
    kernel = r(*ks, 1, c_out) * taps ** -0.5
    g = r(batch, *output_shape(shape, ks, strides, pad), c_out).to(dtype)
    return x, kernel, strides, pad, g


def stem_calls(x, kernel, strides, pad, g, table):
    """{name: (kernel result, plain result)} of K5f and K5w on one case."""
    import torch

    dt = x.dtype
    out = {}
    with torch.no_grad():
        for name, args in (("stem_im2col", (x, kernel, strides, pad, dt)),
                           ("stem_im2col_dw", (x, g, tuple(kernel.shape[:3]),
                                               strides, pad, dt))):
            kernel_fn, plain = table[name]
            out[name] = (kernel_fn(*args), plain(*args))
    return out


def stem_parity_phase(cases, table):
    """Hold K5f and K5w against their plain versions on every case
    ({label: stem_case(...)}), each to TOL of the plain result's scale (f32
    with TF32 off, or bf16). Logs one line per case and kernel; raises
    naming every failure. Returns {name: worst max|d|}."""
    import torch

    worst = collections.defaultdict(float)
    failed = []
    for label, case in cases.items():
        for name, (got, want) in stem_calls(*case, table).items():
            if got.shape != want.shape or got.dtype != want.dtype:
                raise AssertionError(f"{label} {name}: {got.dtype} "
                                     f"{tuple(got.shape)} vs {want.dtype} "
                                     f"{tuple(want.shape)}")
            dtype = str(case[0].dtype).removeprefix("torch.")
            err = (got.float() - want.float()).abs().max().item()
            limit = TOL[dtype] * want.float().abs().max().item()
            ok = bool(torch.isfinite(got).all()) and err <= limit
            log(f"parity stem {label} {name}: max|d| {err:.3e} "
                f"({err / limit:.3f} of the limit) {'ok' if ok else 'FAIL'}")
            worst[name] = max(worst[name], err)
            if not ok:
                failed.append(f"{label} {name}")
    if failed:
        raise AssertionError("stem kernels disagree with their plain "
                             "versions: " + "; ".join(failed))
    return dict(worst)


def stem_dw_bits(cases, table):
    """Two K5w launches on the same inputs give the same dW bits (the
    tensor-core body sums fixed runs of rows into a scratch of block
    partials and adds them in order, as the TPU's one revisited output
    block does), on every case of ``cases`` ({label: stem_case(...)});
    raises naming each case whose two dW differ."""
    import torch

    differ = []
    with torch.no_grad():
        for label, (x, kernel, strides, pad, g) in cases.items():
            args = (x, g, tuple(kernel.shape[:3]), strides, pad, x.dtype)
            a = table["stem_im2col_dw"][0](*args)
            b = table["stem_im2col_dw"][0](*args)
            d = (a - b).abs().max().item()
            log(f"stem_im2col_dw {label}: two launches on the same inputs "
                f"{'equal bit for bit' if torch.equal(a, b) else 'DIFFER'}"
                f" (max|d| {d:.3e})")
            if not torch.equal(a, b):
                differ.append(label)
    if differ:
        raise AssertionError("stem_im2col_dw: two launches on the same "
                             "inputs give other dW bits: " + "; ".join(differ))


def stem_times(x, kernel, strides, pad, g, table):
    """{name: (ms, FMA ms, plain ms, library ms)} of K5f and K5w on one
    case, each by CUDA events over LAUNCH_REPS calls: the wrapper's call,
    the same call through the FMA bodies on the same bf16 inputs
    (``_fma=True``, the bodies bf16 took before), the plain version, and
    the library calls (cuDNN conv3d in bf16, channels-last, and its weight
    gradient), yardsticks the port never calls."""
    import torch
    import torch.nn.functional as F
    from vsn_tpu_torch.ops import stem_im2col as stem

    dt = x.dtype
    xc = x[..., 0][:, None].contiguous(memory_format=torch.channels_last_3d)
    wc = kernel.to(dt).permute(4, 3, 0, 1, 2).contiguous(
        memory_format=torch.channels_last_3d)
    gc = g.permute(0, 4, 1, 2, 3)
    library = {
        "stem_im2col": lambda: F.conv3d(xc, wc, stride=strides,
                                        padding=pad),
        "stem_im2col_dw": lambda: torch.nn.grad.conv3d_weight(
            xc, wc.shape, gc, stride=strides, padding=pad),
    }
    fma = {"stem_im2col": lambda *a: stem.stem_conv_im2col(*a, _fma=True),
           "stem_im2col_dw": lambda *a: stem.stem_conv_dw(*a, _fma=True)}
    out = {}
    with torch.no_grad():
        for name, args in (("stem_im2col", (x, kernel, strides, pad, dt)),
                           ("stem_im2col_dw", (x, g, tuple(kernel.shape[:3]),
                                               strides, pad, dt))):
            kernel_fn, plain = table[name]
            out[name] = (cuda_ms(lambda: kernel_fn(*args), LAUNCH_REPS),
                         cuda_ms(lambda: fma[name](*args), LAUNCH_REPS),
                         cuda_ms(lambda: plain(*args), reps=1),
                         cuda_ms(library[name], LAUNCH_REPS))
    return out


def _nbytes(*tensors):
    import torch

    return sum(t.numel() * t.element_size() for t in tensors
               if isinstance(t, torch.Tensor))


def call_work(name, args):
    """(FLOP, bytes) of one call of kernel ``name`` on the forward
    arguments ``args`` (a backward kernel: on its forward call's arguments,
    with a cotangent and a data gradient the size of the output). Bytes
    count each input read once and each output written once; FLOP count
    the products the kernel computes from those inputs (the backward
    kernels recompute the forward's products they need); K1's tiled body
    is counted by K1's work, the function's own (its backward reads K1f's
    ao, row statistics and f32 o instead of recomputing ao: the port's
    design, which ``kept_bytes`` counts apart); a residual mode does its
    kernel's, and reads gamma (and writes dgamma) besides."""
    x = args[0]
    if name in RESIDUAL_KERNELS:
        base = RESIDUAL_KERNELS[name]
        flops, nbytes = call_work(base, args)
        return flops, nbytes + 4 * x.shape[-1] * (2 if "_bwd" in base else 1)
    name = {v: k for k, v in TILED_NAME.items()}.get(name, name)
    name = name.removesuffix("_slabs")   # the slab kernels: the same work
    if name in PROBES:
        return probe_work(name, *args)
    if name in ("attention", "attention_bwd"):
        # K4f: q k^T and p v from packed qkv (qkv, bias, ids in; out);
        # K4b: s, dp, dv, dq, dk (qkv, bias, ids, dout in; dqkv, dbias out).
        # The state K4f keeps for K4b is the port's design, not the
        # function's work: kept_bytes counts it apart.
        qkv, bias, ids = args[:3]
        bw, n, c3 = qkv.shape
        work = bw * n * n * (c3 // 3)
        out = _nbytes(qkv) // 3
        if name == "attention":
            return 4 * work, _nbytes(qkv, bias, ids) + out
        return 10 * work, 2 * _nbytes(qkv, bias) + _nbytes(ids) + out
    if name in ("attention_split", "attention_split_bwd"):
        # V1f / V1b: K4's products on split q, k, v [BW, H, N, d]
        q, k, v, bias, ids = args[:5]
        work = q.numel() * q.shape[2]
        if name == "attention_split":
            return 4 * work, _nbytes(q, k, v, bias, ids) + _nbytes(q)
        return 10 * work, 2 * _nbytes(q, k, v, bias) + _nbytes(ids, q)
    if name in ("attention_windows", "attention_windows_bwd"):
        # V3f / V3b: K4's products read from the map [B, D, H, W, 3C]
        qkv, bias, ids = args[:3]
        work = qkv.numel() // 3 * math.prod(args[5])
        out = _nbytes(qkv) // 3
        if name == "attention_windows":
            return 4 * work, _nbytes(qkv, bias, ids) + out
        return 10 * work, 2 * _nbytes(qkv, bias) + _nbytes(ids) + out
    if name in ("attn_half", "attn_half_bwd"):
        bw, n, c = x.shape
        rows = bw * n
        params = _nbytes(*args[1:9])
        if name == "attn_half":  # qkv, proj; q k^T and p v
            return 8 * rows * c * c + 4 * rows * n * c, 2 * _nbytes(x) + \
                params + _nbytes(*args[9:11])
        # recomputed qkv, dWproj, dao, dWqkv, dy; s, ao, dp, dv, dq, dk
        return 22 * rows * c * c + 12 * rows * n * c, 3 * _nbytes(x) + \
            2 * params + _nbytes(args[10])
    if name in ("ln_mlp", "ln_mlp_bwd"):
        rows, c = x.shape
        hid = args[3].shape[0]
        params = _nbytes(*args[1:7])
        if name == "ln_mlp":  # fc1, fc2
            return 4 * rows * c * hid, 2 * _nbytes(x) + params + \
                _nbytes(*args[7:9])
        # recomputed fc1, dW2, dh, dW1, dy
        return 10 * rows * c * hid, 3 * _nbytes(x) + 2 * params + \
            _nbytes(args[8])
    if name in STEM:  # args: (x, kernel, strides, padding, g)
        kernel, g = args[1], args[4]
        taps = kernel.shape[0] * kernel.shape[1] * kernel.shape[2]
        tokens = g.numel() // g.shape[-1]
        flops = 2 * taps * g.shape[-1] * tokens
        out = g if name == "stem_im2col" else kernel  # y like g, dW like W
        return flops, _nbytes(x, kernel if name == "stem_im2col" else g, out)
    # a mover or its adjoint: every byte read and written, and the row
    # map's 4 bytes a row (csrc/window_relayout.cu)
    return 0, 2 * _nbytes(x) + 4 * (x.numel() // x.shape[-1])


def kept_bytes(name, args):
    """Bytes of the state that the forward of kernel ``name`` keeps for its
    backward on its call ``args``: the row statistics [BW, H, N, 2] f32
    and, bf16, the f32 o (in f32 the backward reads out itself as o); the
    key-tiled K1f (``attn_half``, at Swin's calls and ViT's) keeps ao
    besides. The forward writes them once and the backward reads them once;
    the function's bound (``call_work``) does not count them."""
    x = args[0]
    if name == "attention_split":      # q [BW, H, N, d]
        out, d = x.numel(), x.shape[-1]
    elif name == "attn_half":          # x [BW, N, C], heads
        out, d = x.numel(), x.shape[-1] // args[12]
    else:                              # qkv [..., 3C], heads
        out, d = x.numel() // 3, x.shape[-1] // (3 * args[4])
    o32 = 4 * out if x.element_size() == 2 else 0
    ao = out * x.element_size() if name == "attn_half" else 0
    return 8 * (out // d) + o32 + ao


def bound_ms(name, calls, dtype="bfloat16"):
    """(least ms, "bytes" or "operations") of kernel ``name`` over
    ``calls`` [(forward name, args)] on this card: the larger of the bytes
    over the HBM rate and the FLOP over the peak rate for ``dtype``."""
    base = FORWARD_OF.get(name, name)
    flops = nbytes = 0
    if name in LN_BWD_KERNELS:  # the launches of the K1b / K2b calls, f32
        for launch, times in row_launch_set(calls).items():
            f, b = ln_bwd_work(name, launch, dtype)
            flops, nbytes = flops + times * f, nbytes + times * b
        return work_bound_ms(flops, nbytes, "float32")
    if name in ROW_KERNEL_ENTRIES:  # likewise
        for launch, times in row_launch_set(calls).items():
            for kname, _, shape in row_kernel_calls(launch):
                if kname == name:
                    f, b = row_shape_work(kname, shape,
                                          launch.rows_per_sample, dtype)
                    flops, nbytes = flops + times * f, nbytes + times * b
        return work_bound_ms(flops, nbytes, "float32")
    if name in GEMM_KERNELS:  # the launches that the K1 / K2 calls make
        for launch, times in gemm_launch_set(calls).items():
            if launch.kind == name:
                f, b = gemm_work(launch, dtype)
                flops, nbytes = flops + times * f, nbytes + times * b
    for cname, args in calls:
        if cname == base:
            f, b = call_work(name, args)
            flops, nbytes = flops + f, nbytes + b
    return work_bound_ms(flops, nbytes, dtype)


def launch_counts():
    """The launch counters of every kernel in KERNELS, and of any other key
    a wrapper counted (a residual mode no path should launch)."""
    from vsn_tpu_torch.ops import _build

    others = sorted(set(_build.launches) - set(KERNELS))
    return {name: _build.launches[name] for name in [*KERNELS, *others]}


def check_counts(counts, expected, units, what):
    """Every kernel's launches in ``counts`` equal ``expected[name] *
    units`` (0 for a kernel the path must not launch, and for any key
    outside KERNELS)."""
    for name in [*KERNELS, *sorted(set(counts) - set(KERNELS))]:
        want = expected.get(name, 0) * units
        if counts.get(name, 0) != want:
            raise AssertionError(f"{what} {name}: {counts.get(name, 0)} "
                                 f"launches, expected {want} "
                                 f"({expected.get(name, 0)} x {units})")


def refresh_statistics(model, cfg, images, micro):
    """Re-estimate the BatchNorm statistics of ``model``'s weights over
    ``images`` (float16, [N, D, H, W, 1], z-scored as for eval) in
    micro-batches of ``micro`` (make_bn_refresh_step) and load them into
    the model."""
    import torch
    from vsn_tpu_torch.data.augment import build_eval_transform
    from vsn_tpu_torch.train.step import make_bn_refresh_step

    device = next(model.parameters()).device
    x = torch.from_numpy(images).to(device)
    x = x.reshape(-1, micro, *x.shape[1:])
    batch = {"image": x, "label": torch.zeros(x.shape[0], micro,
                                              cfg.num_classes, device=device)}
    transform = build_eval_transform(cfg)
    variables = model.state_dict()
    stats = make_bn_refresh_step(
        model, cfg, lambda m, gen: (transform(m["image"]), m["label"]))(
        variables, batch)
    model.load_state_dict({**variables, **stats}, strict=True)
    return stats


def statistics_checks(state, initial_stats):
    """The BatchNorm statistics moved from ``initial_stats``, are finite,
    and the EMA's statistics differ from the live ones. Returns (moved,
    EMA gap) as max |d|."""
    import torch

    stats = state.model_state.flat
    ema = state.ema.ema[state.params.flat.numel():]
    if not bool(torch.isfinite(stats).all()):
        raise AssertionError("non-finite BatchNorm statistics")
    moved = (stats - initial_stats).abs().max().item()
    gap = (ema - stats).abs().max().item()
    if not moved > 0 or not gap > 0:
        raise AssertionError(f"BatchNorm statistics moved by {moved}, EMA "
                             f"statistics {gap} from the live ones")
    return moved, gap


def compare_logits(label, model, x, plain):
    """The kernel route's logits of one batch ``x`` within TOL of the
    largest |logit| of the plain route's (``plain()`` a context manager).
    Probs alone can hide a wrong kernel when every logit is near 0, as with
    DynamicTanh at its init (probs 0.2000)."""
    import torch

    with torch.inference_mode():
        got = model(x).float()
        with plain():
            want = model(x).float()
    dtype = str(model.dtype).removeprefix("torch.")
    err, scale = (got - want).abs().max().item(), want.abs().max().item()
    log(f"{label} logits vs plain path: max|d| {err:.3e} of max|logit| "
        f"{scale:.3e} (<= {TOL[dtype]} of it)")
    if not err <= TOL[dtype] * scale:
        raise AssertionError(f"{label}: kernel path logits differ from the "
                             f"plain path's by {err} (max|logit| {scale})")


def model_eval_path(cfg, model, images, per_forward, label, card):
    """One eval path through ``Evaluator`` at batch BATCH: every launch
    counter at 0 before and exactly ``per_forward`` per batch after (0 for
    every other kernel); probs checked and held to the plain route's
    (``compare_probs``), and one batch's logits (``compare_logits``); the
    rates of both routes and the peak memory; a profile pass."""
    import torch
    from vsn_tpu_torch.eval.evaluate import Evaluator
    from vsn_tpu_torch.ops import _build

    evaluator = Evaluator(cfg, model, batch_size=BATCH)
    n_batches = -(-len(images) // evaluator.batch_size)
    torch.cuda.reset_peak_memory_stats()
    _build.launches.clear()
    t0 = time.perf_counter()
    probs = evaluator.predict(images)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    counts = launch_counts()
    log(f"{label} path: {len(images)} volumes in {n_batches} batches of "
        f"{evaluator.batch_size}, first run {first_s:.2f} s, launches "
        f"{counts}")
    check_counts(counts, per_forward, n_batches, label)
    check_probs(probs, len(images), cfg.num_classes)
    plain = lambda: patched_model_ops(lambda name, kernel, p: p)
    with plain():
        probs_plain = evaluator.predict(images)
    compare_probs(f"{label} path", probs, probs_plain)
    x = torch.from_numpy(images[:BATCH]).to(evaluator.device)
    compare_logits(f"{label} path", model, evaluator.transform(x), plain)
    eval_rates(evaluator, images, plain, n_batches, label, card)
    log(f"[{card}] {label} path: peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB (both routes)")
    profile_phase(lambda: evaluator.predict(images), label, "forward",
                  n_batches, card)


def model_train_path(cfg, batch, images, per_pass, passes, label, recipe,
                     card):
    """One training path: ``init_train_state`` -> ``make_train_step``
    for a model of ``cfg`` with seeded weights (``seeded_model``), on
    ``batch`` with draws
    injected from ``Draws``. Every parameter reached by one backward; 1 +
    TIMED_STEPS steps with every launch counter at 0 before and exactly
    ``per_pass`` times ``passes`` after; the parameters and EMA
    (``params_moved``), the EMA weights through ``Evaluator``; a profile
    pass; then PLAIN_STEPS plain-route steps from the same initial state on
    the same draws, within TRAIN_RTOL (``report_routes``). Logs the peak
    memory of the kernel route's steps and of the whole phase. Returns the
    launch counts."""
    import torch
    from vsn_tpu_torch.eval.evaluate import Evaluator
    from vsn_tpu_torch.ops import _build
    from vsn_tpu_torch.train.step import eval_params, init_train_state

    sync = torch.cuda.synchronize
    torch.cuda.reset_peak_memory_stats()
    micro = cfg.BATCH_SIZE
    model = seeded_model(cfg)
    state = init_train_state(cfg, model)
    initial = state.params.flat.clone()
    draws = Draws(model, micro, batch["image"].device, SEED)
    reach_every_parameter(model, cfg, state, batch, draws, label)
    _build.launches.clear()
    kernel_metrics, secs = train_route(model, cfg, state, batch, draws, 1,
                                       sync)
    after0 = state.params.flat.clone()
    more, more_secs = train_route(model, cfg, state, batch, draws,
                                  TIMED_STEPS, sync)
    counts = launch_counts()
    kernel_metrics += more
    log(f"{label} path: {1 + TIMED_STEPS} steps of {TRAIN_ACCUM} x {micro} "
        f"volumes (SAM: 2 passes), launches {counts}")
    check_counts(counts, per_pass, passes, label)
    params_moved(state, initial, after0, label)
    ema_probs = Evaluator(cfg, model, batch_size=BATCH).predict(
        images[:BATCH], eval_params(state, use_ema=True))
    check_probs(ema_probs, BATCH, cfg.num_classes)
    log(f"{label} path: EMA weights through Evaluator, probs range "
        f"[{ema_probs.min():.4f}, {ema_probs.max():.4f}]")
    profile_phase(lambda: train_route(model, cfg, state, batch, draws, 1,
                                      sync), label, "step", 1, card)
    kernel_peak = torch.cuda.max_memory_allocated()
    with torch.no_grad():
        state.params.flat.copy_(initial)
    del state
    pstate = init_train_state(cfg, model)
    with patched_model_ops(lambda name, kernel, plain: plain):
        plain_metrics, plain_secs = train_route(model, cfg, pstate, batch,
                                                draws, PLAIN_STEPS, sync)
    report_routes(label, kernel_metrics, plain_metrics, more_secs,
                  plain_secs, TRAIN_ACCUM * micro, recipe, card)
    log(f"[{card}] {label} kernel route warm-up step {1e3 * secs[0]:.1f} "
        f"ms; peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} "
        f"GiB (the kernel route's steps alone {kernel_peak / 2**30:.3f})")
    return counts


def wide_vit_model(cfg, device=None):
    """ViT-S of ``cfg`` at WIDE_VIT_HEADS (2 heads of 192): ``seeded_model``
    (``build_model``) with ViT3D's dim_head set to 192, which the configs
    fix at 64 as the reference does (vsn_tpu/models/vit3d.py:399)."""
    import functools
    from vsn_tpu_torch.models import vit3d

    heads, dim_head = WIDE_VIT_HEADS
    with mock.patch.object(vit3d, "ViT3D", functools.partial(
            vit3d.ViT3D, dim_head=dim_head)):
        return seeded_model(cfg.replace(HEADS=heads), device)


def wide_head_run(cfg, train_cfg, build, batch, images, per_forward,
                  per_pass, label, card):
    """One wide-head model run (phase 16b), the model from ``build(cfg)``:
    the eval path through ``Evaluator.predict`` on BATCH volumes, every
    launch counter at 0 before and exactly ``per_forward`` after, probs and
    one batch's logits against the plain route (``compare_probs``,
    ``compare_logits``); one training step through ``make_train_step``
    (``train_route``) on ``batch``, every counter at 0 before and exactly
    ``per_pass`` times its passes after, then a second step, both against
    two plain-route steps from the same state on the same draws
    (``report_routes``: TRAIN_RTOL; the rates from each route's second
    step, the first holding the warm-up). Then the K1 calls of one
    training micro-batch (``record_calls``). Returns (the eval and first
    step's launch counts summed, those calls)."""
    import torch
    from vsn_tpu_torch.eval.evaluate import Evaluator
    from vsn_tpu_torch.ops import _build
    from vsn_tpu_torch.train.step import init_train_state, make_batch_transform

    sync = torch.cuda.synchronize
    model = build(cfg)
    evaluator = Evaluator(cfg, model, batch_size=BATCH)
    imgs = images[:BATCH]
    _build.launches.clear()
    probs = evaluator.predict(imgs)
    sync()
    counts = collections.Counter(launch_counts())
    log(f"{label} eval path: {BATCH} volumes, launches "
        f"{ {k: v for k, v in counts.items() if v} }")
    check_counts(counts, per_forward, 1, f"{label} eval")
    check_probs(probs, BATCH, cfg.num_classes)
    plain = lambda: patched_model_ops(lambda name, kernel, p: p)
    with plain():
        probs_plain = evaluator.predict(imgs)
    compare_probs(f"{label} eval path", probs, probs_plain)
    x = torch.from_numpy(imgs).to(evaluator.device)
    compare_logits(f"{label} eval path", model, evaluator.transform(x), plain)
    del model, evaluator, x

    torch.cuda.reset_peak_memory_stats()
    micro = train_cfg.BATCH_SIZE
    model = build(train_cfg)
    state = init_train_state(train_cfg, model)
    initial = state.params.flat.clone()
    draws = Draws(model, micro, batch["image"].device, SEED)
    _build.launches.clear()
    kernel, secs = train_route(model, train_cfg, state, batch, draws, 1, sync)
    train_counts = launch_counts()
    passes = TRAIN_ACCUM * (2 if train_cfg.USE_SAM else 1)
    log(f"{label} train path: 1 step of {TRAIN_ACCUM} x {micro} volumes "
        f"(SAM: 2 passes), launches "
        f"{ {k: v for k, v in train_counts.items() if v} }")
    check_counts(train_counts, per_pass, passes, f"{label} train")
    more, more_secs = train_route(model, train_cfg, state, batch, draws, 1,
                                  sync)
    kernel += more
    peak = torch.cuda.max_memory_allocated()
    with torch.no_grad():
        state.params.flat.copy_(initial)
    del state
    pstate = init_train_state(train_cfg, model)
    with patched_model_ops(lambda name, kernel, plain: plain):
        plain_metrics, plain_secs = train_route(model, train_cfg, pstate,
                                                batch, draws, 2, sync)
    report_routes(f"{label} train", kernel, plain_metrics, more_secs,
                  plain_secs[1:], TRAIN_ACCUM * micro,
                  "the second step, the flagship recipe", card)
    log(f"[{card}] {label} train first steps (warm-up): kernel route "
        f"{1e3 * secs[0]:.1f} ms, plain {1e3 * plain_secs[0]:.1f} ms")
    log(f"[{card}] {label} train kernel route: peak memory "
        f"{peak / 2**30:.3f} GiB")
    del pstate
    micro0 = {k: v[0] for k, v in batch.items()}
    x = make_batch_transform(train_cfg)(micro0)[0].to(model.dtype)
    calls = record_calls(model.train(), x,
                         generator=torch.Generator(x.device).manual_seed(6))
    counts.update(train_counts)
    return counts, [(n, a) for n, a in calls if n == "attn_half"]


def seeded_model(cfg, device=None):
    """``build_model(cfg, device)`` (the card by default) with weights from
    its architecture's ``init_weights`` at seed SEED."""
    import torch
    from vsn_tpu_torch.models import build_model
    from vsn_tpu_torch.models.medvit3d import init_weights as medvit_init
    from vsn_tpu_torch.models.swin3d import init_weights as swin_init
    from vsn_tpu_torch.models.vit3d import init_weights as vit_init

    init = {"ViT": vit_init, "MedViT": medvit_init}.get(cfg.ARCHITECTURE,
                                                         swin_init)
    return init(build_model(cfg, device), torch.Generator().manual_seed(SEED))


# ---------------------------------------------------------------------------
# K1's key-tiled body and the ViT paths
# ---------------------------------------------------------------------------

def tiled_names(worst):
    """A {kernel: value} of ViT's K1 calls under the tiled body's names."""
    return {TILED_NAME.get(name, name): v for name, v in worst.items()}


def k1_kept(args, **mode):
    """What K1b reads of K1f's call on the card, for a direct
    ``attn_half_backward`` call on the recorded arguments ``args``: ao and
    the tiled body's row statistics and f32 o, from one K1f launch ({} on
    the CPU, where the plain backward recomputes them)."""
    from vsn_tpu_torch.ops import swin_block_kernels as sbk

    if not args[0].is_cuda:
        return {}
    _, ao, stats, o32 = sbk._attn_half_kernel(*args, 1.0, **mode)
    return dict(ao=ao, stats=stats, o32=o32)


def tiled_launch_inputs(args, gen):
    """(qkv [BW, N, 3C], dao [BW, N, C]) of one K1 call as the tiled
    attention launches see them: qkv from the call's x and parameters as
    K1's launch 1 rounds it, dao seeded, both in x's dtype."""
    import torch
    from vsn_tpu_torch.ops import swin_block_kernels as sbk

    x = args[0]
    bw, n, c = x.shape
    with torch.no_grad():
        qkv = sbk._qkv_parts(*args[:5])[3].reshape(bw, n, 3 * c).to(x.dtype)
    dao = torch.randn(x.shape, generator=gen).to(x.device, x.dtype)
    return qkv, dao


def tiled_launch_compare(args, qkv, dao):
    """[(output, max|d|, limit, ok)] of K1's tiled attention launches alone
    (``attention_tiled_launch`` and its backward) against their plain
    versions on one call's bias, ids, scale and heads: ao and o to TOL of
    their scale, the row statistics elementwise to TOL relative; the
    backward from the plain o and statistics, dq, dk, dv, dbqkv and dbias
    each to TOL of its own scale."""
    import torch
    from vsn_tpu_torch.ops import swin_block_kernels as sbk

    bias, ids, scale, heads = args[5], args[6], args[11], args[12]
    tol = TOL[str(qkv.dtype).removeprefix("torch.")]
    c = qkv.shape[-1] // 3
    with torch.no_grad():
        got = sbk.attention_tiled_launch(qkv, bias, ids, scale, heads)
        want = sbk.attention_tiled_reference(qkv, bias, ids, scale, heads)
        bgot = sbk.attention_tiled_backward_launch(
            qkv, dao, want[2], want[1], bias, ids, scale, heads)
        bwant = sbk.attention_tiled_backward_reference(
            qkv, dao, want[2], want[1], bias, ids, scale, heads)
    rows = []

    def add(label, g, w, limit):
        g, w = g.float(), w.float()
        err = (g - w).abs().max().item()
        rows.append((label, err, limit,
                     bool(torch.isfinite(g).all()) and err <= limit))

    for label, i in (("ao", 0), ("o", 2)):
        add(label, got[i], want[i], tol * max(1.0, want[i].float().abs().max()
                                              .item()))
    for label, col in (("max", 0), ("1/sum", 1)):
        # both sides form the statistics in f32, whatever the activation
        # type: each element to STATS_RTOL of itself plus STATS_ATOL
        g, w = got[1][..., col], want[1][..., col]
        r = ((g - w).abs() / (STATS_RTOL * w.abs() + STATS_ATOL)).max()
        rows.append((label, r.item(), 1.0,
                     bool(torch.isfinite(g).all()) and r.item() <= 1.0))
    for label, i, part in (("dq", 0, 0), ("dk", 0, 1), ("dv", 0, 2),
                           ("dbqkv", 2, None), ("dbias", 1, None)):
        if bwant[i] is None:
            continue
        g, w = bgot[i], bwant[i]
        if part is not None:
            g, w = g[..., part * c:(part + 1) * c], w[..., part * c:(part + 1)
                                                       * c]
        add(label, g, w, tol * w.float().abs().max().item())
    return rows


def tiled_launch_parity_phase(sets, gen, logits=()):
    """K1's tiled attention launches alone against their plain versions
    (``tiled_launch_compare``) on every K1 call of ``sets`` (seeded
    parameters), and at each of ``logits`` on the first call of the first
    set (bias 8 z + logit, the keys of the last, ragged key tile 12 higher,
    as ``tiled_saturation_phase``). Logs one line per set; raises on any
    output beyond its limit. Returns the worst ratio to the limit."""
    import torch

    worst, failed = 0.0, []
    for label, calls in sets.items():
        cases = [seeded_params("attn_half", a, gen) for n, a in calls
                 if n == "attn_half"]
        if logits and label == next(iter(sets)):
            args = list(cases[0])
            n = args[0].shape[1]
            z = torch.randn(args[12], n, n, generator=gen).to(args[0].device)
            for logit in logits:
                bias = z * 8 + logit
                bias[:, :, (n - 1) // KEY_TILE * KEY_TILE:] += 12.0
                cases.append(tuple(args[:5] + [bias] + args[6:]))
        ratio, bad, outputs = 0.0, 0, set()
        for args in cases:
            rows = tiled_launch_compare(args, *tiled_launch_inputs(args, gen))
            ratio = max([ratio] + [_ratio(e, lim) for _, e, lim, _ in rows])
            bad += sum(not ok for *_, ok in rows)
            outputs |= {name for name, *_ in rows}
        log(f"parity tiled launches {label}: {len(cases)} calls, "
            f"{'/'.join(sorted(outputs))} worst {ratio:.3f} of the limit "
            f"{'ok' if not bad else 'FAIL in %d' % bad}")
        worst = max(worst, ratio)
        if bad:
            failed.append(label)
    if failed:
        raise AssertionError(f"kernels disagree with their plain versions: "
                             f"the tiled attention launches on {failed}")
    return worst


def vit_parity_phase(sets, gen, table=None, cases=VIT_CASES):
    """K1 (its tiled body) and K2 on every recorded ViT call of ``sets``:
    forward at lam 0 and 1, every gradient at lam 0 and 1, against the
    plain versions (``parity_phase``, ``grad_parity_phase``; ``table``
    defaults to ``kernel_table()``); each set covers ``cases``. Returns
    {kernel: worst max|d|} under the tiled body's names."""
    table = table or kernel_table()
    worst, kinds = parity_phase(sets, table, gen)
    bworst, bkinds = grad_parity_phase(sets, table, gen)
    for label in sets:
        for name, found in (("attn_half", kinds[label]["attn_half"]),
                            ("attn_half_bwd",
                             bkinds[label]["attn_half_bwd"])):
            if not cases <= found:
                raise AssertionError(f"ViT set {label} lacks {name} cases "
                                     f"{cases - found}")
    return tiled_names({**worst, **bworst})


def _ratio(err, limit):
    return err / limit if limit else (0.0 if err == 0 else math.inf)


def tiled_saturation_phase(calls, gen, table=None, logits=TILED_LOGITS):
    """K1 and K1b (tiled body) at saturated logits on the first K1 call of
    ``calls`` (f32, seeded parameters: ViT's in phase 3, Swin's last stage
    in phase 7), its bias set to 8 z + logit with the keys of the last,
    ragged key tile 12 higher, so the top logits of every row lie there and
    its running max grows at its last tile: the forward at lam 0 and 1 and
    every gradient finite and within tolerance of the plain versions.
    Returns the worst max|d| of the forward and the backward (``table`` as
    in ``vit_parity_phase``)."""
    import torch

    kernel, plain = (table or kernel_table())["attn_half"]
    args = list(seeded_params("attn_half", next(
        a for n, a in calls if n == "attn_half"), gen))
    x, heads = args[0], args[12]
    n = x.shape[1]
    last = (n - 1) // KEY_TILE * KEY_TILE   # first key of the last tile
    if n % KEY_TILE == 0:
        raise AssertionError(f"N = {n}: no ragged key tile")
    z = torch.randn(heads, n, n, generator=gen).to(x.device)
    worst = [0.0, 0.0]
    for logit in logits:
        bias = z * 8 + logit
        bias[:, :, last:] += 12.0
        args[5] = bias
        rows = [("out" if lam else "branch", *compare("attn_half", kernel,
                                                       plain, args, lam))
                for lam in (0.0, PATH_LAM)]
        grads = grad_compare("attn_half", kernel, plain, args, PATH_LAM, gen)
        for i, group in enumerate((rows, grads)):
            worst[i] = max([worst[i]] + [err for _, err, _, _ in group])
        ratio = max(_ratio(err, limit) for _, err, limit, _ in rows + grads)
        bad = [g for g, _, _, ok in rows + grads if not ok]
        log(f"parity tiled saturated logits {logit:g} (top in keys "
            f"{last}-{n - 1} of {tuple(x.shape)}): K1 and K1b "
            f"{len(rows) + len(grads)} outputs, worst {ratio:.3f} of the "
            f"limit {'ok' if not bad else 'FAIL'}")
        if bad:
            raise AssertionError(f"tiled K1 at logits {logit:g}: {bad}")
    return worst


def swin_route_calls(calls, n_small=37):
    """One recorded Swin K1 call of each case that the stages give
    (``case_kind``: at Swin-T's, N = 252 shifted, unshifted and padded, and
    the clamped N = 150), in call order, then the first shifted call cut to
    its first ``n_small`` tokens (N below one key tile)."""
    picked = {}
    for name, args in calls:
        if name == "attn_half":
            picked.setdefault(frozenset(case_kind(name, args)), args)
    call = next(a for kind, a in picked.items() if "shifted ids" in kind)
    x, bias, ids = call[0], call[5], call[6]
    small = list(call)
    small[0] = x[:, :n_small].contiguous()
    small[5] = bias[:, :n_small, :n_small].contiguous()
    small[6] = ids[:, :n_small].contiguous()
    return [("attn_half", a) for a in (*picked.values(), tuple(small))]


def swin_route_phase(sets, gen):
    """K1's route at Swin's calls (phase 7): the calls of
    ``swin_route_calls`` of every set through K1's entry point, forward and
    backward against the plain versions, with every launch counter at 0
    before and, after, only the key-tiled body's launches (4 K1f and 2 K1b
    a call: lam 0 and 1, as ``parity_phase`` and ``grad_parity_phase`` run
    them); K1 and K1b at saturated logits on the f32 set's last-stage call
    (N = 150 at Swin-T's) with its top keys in the ragged last key tile
    (``tiled_saturation_phase``); and the tiled launches alone on every
    call (``tiled_launch_parity_phase``, dbias included). Returns {kernel:
    worst max|d|} under the result line's Swin names."""
    import torch
    from vsn_tpu_torch.ops import _build

    route = {f"Swin route {label}": swin_route_calls(calls)
             for label, calls in sets.items()}
    table = kernel_table()
    _build.launches.clear()
    worst, _ = parity_phase(route, table, gen)
    bworst, _ = grad_parity_phase(route, table, gen)
    counts = {name: n for name, n in _build.launches.items() if n}
    n_calls = sum(len(calls) for calls in route.values())
    want = {TILED_NAME["attn_half"]: 4 * n_calls,
            TILED_NAME["attn_half_bwd"]: 2 * n_calls}
    log(f"Swin route: {n_calls} K1 calls through attn_half, launches "
        f"{counts}")
    if counts != want:
        raise AssertionError(f"Swin route launches {counts}, expected "
                             f"{want}")
    worst.update(bworst)
    f32 = next(calls for calls in route.values()
               if calls[0][1][0].dtype == torch.float32)
    last = min(f32[:-1], key=lambda call: call[1][0].shape[0])
    for name, err in zip(TILED_NAME, tiled_saturation_phase([last], gen)):
        worst[name] = max(worst[name], err)
    tiled_launch_parity_phase(route, gen)
    return worst


def reheaded(args, head_dim):
    """K1 call ``args`` cut into heads of ``head_dim`` channels: C /
    head_dim heads, its scale head_dim^-0.5 and a zero bias of that many
    heads (``seeded_params`` seeds it)."""
    import torch

    x = args[0]
    bw, n, c = x.shape
    if c % head_dim:
        raise ValueError(f"width {c} does not split into heads of {head_dim}")
    args = list(args)
    heads = c // head_dim
    if args[5] is not None:
        args[5] = torch.zeros(heads, n, n, device=x.device)
    args[11], args[12] = head_dim ** -0.5, heads
    return tuple(args)


def odd_k1_call(geometry, samples, dtype, device, gen):
    """A K1 call over the shifted windows of ``samples`` samples of one map
    (``geometry``: map dims, window, shift, C, heads): x = z [samples nW, N,
    C] in ``dtype``, the windows' region ids, gains 1 and placeholder
    parameters and bias, which the parity phases seed
    (``seeded_params``)."""
    import torch
    from vsn_tpu_torch.models.swin3d import shifted_window_region_ids

    dims, window, shift, c, heads = geometry
    ids = torch.from_numpy(shifted_window_region_ids(dims, window, shift)).to(
        device)
    nw, n = ids.shape
    x = torch.randn(samples * nw, n, c, generator=gen).to(device, dtype)
    ones = torch.ones(samples, device=device)
    return (x, None, None, None, torch.empty(0),
            torch.empty(heads, n, n, device=device), ids, None, None, ones,
            ones, (c // heads) ** -0.5, heads)


def odd_k4_call(k1):
    """K4's call (qkv [BW, N, 3C] in x's dtype, bias, ids, scale, heads) on
    the windows of K1 call ``k1``: qkv and bias placeholders, which the
    parity phases seed (``seeded_params``); one row of zero ids where K1's
    call has none (an unshifted block's)."""
    import torch

    x, bias, ids, scale, heads = k1[0], k1[5], k1[6], k1[11], k1[12]
    bw, n, c = x.shape
    if ids is None:
        ids = torch.zeros(1, n, dtype=torch.int32, device=x.device)
    return (torch.empty(bw, n, 3 * c, dtype=x.dtype, device=x.device), bias,
            ids, scale, heads)


def head_dim(name, args):
    """The head dim of a call of K1 ("attn_half"), K4, V1 or V3."""
    if name == "attn_half":
        return args[0].shape[-1] // args[12]
    if name == "attention_split":
        return args[0].shape[-1]
    return args[0].shape[-1] // (3 * args[4])


def body_counter(name, d):
    """The launch counter of a call of ``name`` (a forward or ``_bwd``) at
    head dim ``d``: K1's key-tiled body's (TILED_NAME) or, above
    TILED_HEAD_DIM, the slab kernels' (SLAB_NAME)."""
    if d > TILED_HEAD_DIM:
        return SLAB_NAME[name]
    return TILED_NAME.get(name, name)


def wide_v_calls(dtype, device, gen):
    """K4, V1 and V3 calls at WIDE_V_HEAD_DIM: a K4 call over the shifted
    windows of WIDE_V (2 samples; qkv and bias placeholders, which the
    parity phases seed), the same call on split heads (V1) and on the map
    (V3)."""
    dims, window = WIDE_V[:2]
    k4 = odd_k4_call(odd_k1_call(WIDE_V, 2, dtype, device, gen))
    k4 = seeded_params("attention", k4, gen)
    return [("attention", k4), ("attention_split", split_call(k4)),
            ("attention_windows", windows_call(k4, window, dims))]


def odd_head_dim_sets(sets, device, gen):
    """The calls of the odd-head-dim phase: ``swin_route_calls`` of every
    set of ``sets`` re-headed to each of ODD_HEAD_DIMS (``reheaded``), each
    call whose width the head dim divides, and K4 on each such call's
    windows above TILED_HEAD_DIM; K1 at ODD_N (``ODD_N_GEOMETRY``) in f32
    and bf16; K1 and K4 at ODD_WIDE over Swin-T's stage-1 windows of
    micro-batch TRAIN_MICRO in bf16; where WIDE_V_HEAD_DIM is one of
    ODD_HEAD_DIMS, K4, V1 and V3 at it in f32 and bf16
    (``wide_v_calls``)."""
    import torch

    out = {}
    for d in ODD_HEAD_DIMS:
        for label, calls in sets.items():
            k1 = [reheaded(args, d) for _, args in swin_route_calls(calls)
                  if args[0].shape[-1] % d == 0]
            route = [("attn_half", a) for a in k1]
            if d > TILED_HEAD_DIM:
                route += [("attention", odd_k4_call(a)) for a in k1]
            if route:
                out[f"d={d} {label}"] = route
    for dtype in (torch.float32, torch.bfloat16):
        k1 = odd_k1_call(ODD_N_GEOMETRY, 2, dtype, device, gen)
        out[f"d={ODD_N_GEOMETRY[3] // ODD_N_GEOMETRY[4]} N={k1[0].shape[1]} "
            f"{str(dtype).removeprefix('torch.')}"] = [("attn_half", k1)]
    k1 = odd_k1_call(ODD_WIDE, TRAIN_MICRO, torch.bfloat16, device, gen)
    out[f"d={ODD_WIDE[3] // ODD_WIDE[4]} stage 1 micro {TRAIN_MICRO} "
        "bfloat16"] = [("attn_half", k1), ("attention", odd_k4_call(k1))]
    if WIDE_V_HEAD_DIM in ODD_HEAD_DIMS:
        for dtype in (torch.float32, torch.bfloat16):
            out[f"d={WIDE_V_HEAD_DIM} K4 V1 V3 "
                f"{str(dtype).removeprefix('torch.')}"] = wide_v_calls(
                dtype, device, gen)
    return out


def odd_head_dim_phase(sets, device, gen, card):
    """K1, K4, V1 and V3 at head dims that are not multiples of 16 or that
    are above the tiled body's 128 (phase 7): the calls of
    ``odd_head_dim_sets`` through their entry points (``attn_half``,
    ``window_attention_qkv``, ``window_attention``,
    ``window_attention_windows``), forward and every gradient against the
    plain versions, with every launch counter at 0 before and, after, only
    the tiled body's launches up to 128 and its slab kernels' above (4 K1f
    and 2 K1b a K1 call: lam 0 and 1, as ``parity_phase`` and
    ``grad_parity_phase`` run them; 2 forward and 1 backward a K4, V1 or V3
    call); then the launches alone beside SDPA, and K1 whole above 128
    (``odd_head_times``). Returns ({kernel: worst max|d|} up to 128,
    {slab entry: worst max|d|} above, the launch counts, the calls)."""
    from vsn_tpu_torch.ops import _build

    route = odd_head_dim_sets(sets, device, gen)
    table = {**kernel_table(), **attention_table(), **v_table()}
    wide = lambda calls: any(head_dim(n, a) > TILED_HEAD_DIM
                             for n, a in calls)
    _build.launches.clear()
    worst, slabs = {}, {}
    for part, out in ((False, worst), (True, slabs)):
        sub = {label: calls for label, calls in route.items()
               if wide(calls) == part}
        if not sub:
            continue
        fworst, _ = parity_phase(sub, table, gen)
        bworst, _ = grad_parity_phase(sub, table, gen)
        for name, err in {**fworst, **bworst}.items():
            out[SLAB_NAME[name] if part else name] = err
    counts = {name: n for name, n in _build.launches.items() if n}
    want = collections.Counter()
    for calls in route.values():
        for name, args in calls:
            d, fwd = head_dim(name, args), 4 if name == "attn_half" else 2
            want[body_counter(name, d)] += fwd
            want[body_counter(backward_name(name), d)] += fwd // 2
    dims = sorted({head_dim(n, a) for calls in route.values()
                   for n, a in calls})
    n_calls = collections.Counter(n for calls in route.values()
                                  for n, _ in calls)
    log(f"odd and wide head dims {dims}: calls {dict(n_calls)} through their "
        f"entry points, launches {counts}")
    if counts != dict(want):
        raise AssertionError(f"odd-head-dim launches {counts}, expected "
                             f"{dict(want)}")
    odd_head_times(route, gen, card)
    return worst, slabs, counts, route


def sdpa_backend(qkv, bias, ids, scale, heads):
    """The backend that PyTorch's dispatcher picks for
    ``F.scaled_dot_product_attention`` with the float mask on K4 call
    (qkv, bias, ids, scale, heads)'s q, k, v (``torch._fused_sdp_choice``):
    "flash_attention", "efficient_attention", "cudnn_attention" or
    "math"."""
    import torch
    from torch.nn.attention import SDPBackend

    q, k, v, mask = sdpa_operands(qkv, bias, ids, heads)
    return SDPBackend(torch._fused_sdp_choice(
        q, k, v, attn_mask=mask, scale=scale)).name.lower()


def odd_head_times(route, gen, card):
    """The tiled body's launches alone at the odd and wide head dims, by
    CUDA events (``launch_ms``), for each bf16 set of ``route``
    (``odd_head_dim_sets``): K1f's attention launch and K1b's phases A + B
    (``attention_tiled_launch`` and its backward on each K1 call's qkv as
    K1's launch 1 rounds it, from the forward's kept o and statistics), K4f's
    launch and K4b's from its kept state; beside
    ``F.scaled_dot_product_attention`` with the float mask bias[h] +
    mask(ids) on the same q, k, v and its backward (``sdpa_times``, a
    yardstick the port never calls; above TILED_HEAD_DIM the backend it
    takes, ``sdpa_backend``), and the bound of the attention alone (K4's
    work on the same q, k, v: ``call_work``); above TILED_HEAD_DIM K1f and
    K1b whole too (``cuda_ms``). Logs one line per set and kernel; returns
    {(set, kernel): {"forward", "backward", "SDPA", "SDPA backward"[,
    "K1f whole", "K1b whole", "SDPA backend"]: ms or name}}."""
    import torch
    from vsn_tpu_torch.ops import swin_block_kernels as sbk
    from vsn_tpu_torch.ops import window_attention as wa

    out = {}
    for label, calls in route.items():
        if calls[0][1][0].dtype != torch.bfloat16:
            continue
        calls = [(n, seeded_params(n, a, gen)) for n, a in calls]
        wide = max(head_dim(n, a) for n, a in calls) > TILED_HEAD_DIM
        with torch.no_grad():
            k1 = []   # (qkv, dao, o, stats, bias, ids, scale, heads)
            for a in (a for n, a in calls if n == "attn_half"):
                qkv, dao = tiled_launch_inputs(a, gen)
                _, stats, o = sbk.attention_tiled_launch(qkv, a[5], a[6],
                                                         a[11], a[12])
                k1.append((qkv, dao, o, stats, a[5], a[6], a[11], a[12]))
            k4 = [a for n, a in calls if n == "attention"]
            k4b = [kept_backward_args("attention", a,
                                      cotangent("attention", a, gen), o, st)
                   for a in k4
                   for _, st, o in [wa.window_attention_qkv_launch(*a)]]
            # kernel -> (its calls as K4's (qkv, bias, ids, scale, heads),
            # forward launches, backward launches)
            kernels = {
                "K1": ([(la[0], *la[4:]) for la in k1],
                       lambda: [sbk.attention_tiled_launch(la[0], *la[4:])
                                for la in k1],
                       lambda: [sbk.attention_tiled_backward_launch(*la)
                                for la in k1]),
                "K4": (k4, lambda: [wa.window_attention_qkv_launch(*a)
                                    for a in k4],
                       lambda: [wa.window_attention_qkv_backward_launch(*b)
                                for b in k4b])}
            times = {kernel: (launch_ms(fwd), launch_ms(bwd))
                     for kernel, (k, fwd, bwd) in kernels.items() if k}
            whole = {}
            if wide and k1:   # K1f and K1b whole, their GEMMs and rows too
                k1_args = [a for n, a in calls if n == "attn_half"]
                b_args = [(*a[:8], a[10], torch.randn(
                    a[0].shape, device=a[0].device).to(a[0].dtype),
                    *a[11:13]) for a in k1_args]
                kept = [k1_kept(a) for a in k1_args]
                whole["K1f whole"] = cuda_ms(lambda: [sbk.attn_half(*a)
                                                      for a in k1_args])
                whole["K1b whole"] = cuda_ms(lambda: [
                    sbk.attn_half_backward(*a, **kk)
                    for a, kk in zip(b_args, kept)])
                del b_args, kept
        for kernel, (fwd, bwd) in times.items():
            k = kernels[kernel][0]
            lib, lib_bwd = sdpa_times([("attention", a) for a in k])
            bounds = [work_bound_ms(*map(sum, zip(*(call_work(name, a)
                                                   for a in k))))
                      for name in ("attention", "attention_bwd")]
            out[(label, kernel)] = {"forward": fwd, "backward": bwd,
                                    "SDPA": lib, "SDPA backward": lib_bwd}
            extra = ""
            if wide:
                backend = sdpa_backend(*k[0])
                out[(label, kernel)]["SDPA backend"] = backend
                extra = f" (SDPA's backend: {backend})"
                if kernel == "K1":
                    out[(label, kernel)].update(whole)
                    extra += (f"; K1f whole {whole['K1f whole']:.3f} ms, K1b "
                              f"whole {whole['K1b whole']:.3f} ms")
            log(f"[{card}] odd head dims {label} {kernel} launches alone "
                f"(CUDA events, {len(k)} calls): forward {fwd:.3f} ms, "
                f"backward {bwd:.3f} ms; SDPA with the float mask on the "
                f"same q, k, v {lib:.3f} ms, its backward {lib_bwd:.3f} ms "
                f"({_ratio(fwd, lib):.2f}x, {_ratio(bwd, lib_bwd):.2f}x); "
                f"bound forward {bounds[0][0]:.3f} ms by {bounds[0][1]}, "
                f"backward {bounds[1][0]:.3f} ms by {bounds[1][1]}{extra}")
        del calls, k1, k4, k4b, kernels
    return out


def tiled_launch_times(calls, card):
    """Device ms per micro-batch of the tiled attention launches alone
    (K1f's launch 2, K1b's phases A and B: ``attention_tiled_launch`` and
    its backward on each call's qkv as K1's launch 1 rounds it, a seeded
    dao, and the forward's kept o and statistics) over ViT's K1 calls, by
    CUDA events (``launch_ms``; the profiler splits the backward into its
    phases), beside ``F.scaled_dot_product_attention`` on the calls' q, k,
    v [B, H, N, d] in bf16 (forward, and its backward to q, k, v): the
    same attention at ordinary logits, a yardstick the port never calls.
    Returns (forward ms, phase A + B ms, SDPA ms, SDPA backward ms)."""
    import torch
    import torch.nn.functional as F
    from vsn_tpu_torch.ops import swin_block_kernels as sbk

    k1 = [args for name, args in calls if name == "attn_half"]
    gen = torch.Generator().manual_seed(SEED + 27)
    with torch.no_grad():
        launch = []
        for a in k1:
            qkv, dao = tiled_launch_inputs(a, gen)
            _, stats, o = sbk.attention_tiled_launch(qkv, a[5], a[6], a[11],
                                                     a[12])
            launch.append((qkv, dao, o, stats, a[5], a[6], a[11], a[12]))
        fwd = launch_ms(lambda: [sbk.attention_tiled_launch(la[0], *la[4:])
                                 for la in launch])
        bwd_launch = lambda: [sbk.attention_tiled_backward_launch(*la)
                              for la in launch]
        bwd = launch_ms(bwd_launch)
        tags = phase_tags(head_dim("attn_half", k1[0]))
        shares = phase_shares(bwd_launch, "vit_k1b", tags)
    del launch
    phase_a, phase_b = (bwd * shares[tag] for tag in tags)
    lib = lib_bwd = 0.0
    for a in k1:
        parts = sbk._attention_parts(*a[:7], a[11], a[12])
        q, k, v = (t.to(torch.bfloat16).contiguous() for t in parts[3:6])
        shape = tuple(q.shape)
        lib += cuda_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, scale=a[11]))
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        out = F.scaled_dot_product_attention(*leaves, scale=a[11])
        g = torch.randn_like(out)
        lib_bwd += cuda_ms(lambda: torch.autograd.grad(out, leaves, g,
                                                       retain_graph=True))
        del parts, q, k, v, leaves, out, g
    # the attention alone: 4 N^2 d per (window, head) forward, five
    # products (s, dp, dv, dq, dk) backward, over the bf16 peak
    work = sum(a[0].shape[0] * a[0].shape[1] ** 2 * a[0].shape[2] for a in k1)
    bound_f, bound_b = (k * work / PEAK_FLOPS["bfloat16"] * 1e3
                        for k in (4, 10))
    log(f"[{card}] vit attention launches alone (CUDA events), per "
        f"micro-batch of {VIT_MICRO} ({len(k1)} calls): tiled forward "
        f"{fwd:.3f} ms, tiled backward {bwd:.3f} ms (the profiler's split: "
        f"phase A {phase_a:.3f}, phase B {phase_b:.3f}); "
        f"F.scaled_dot_product_attention on the same q, "
        f"k, v {shape} bf16 {lib:.3f} ms, its backward {lib_bwd:.3f} ms; "
        f"bound (the attention alone at {PEAK_FLOPS['bfloat16'] / 1e12:g} "
        f"TFLOP/s) forward {bound_f:.3f} ms, backward {bound_b:.3f} ms; "
        f"tiled / SDPA forward {fwd / lib:.2f}x, backward "
        f"{bwd / lib_bwd:.2f}x")
    kept = sum(kept_bytes("attn_half", a) for a in k1)
    log(f"[{card}] vit K1f's kept state (ao, row statistics, f32 o) "
        f"{kept / 1e6:.1f} MB per micro-batch, written by K1f and read by "
        f"K1b, {kept / HBM_BYTES_PER_S * 1e3:.3f} ms each way at the HBM "
        "rate (outside K1b's bound)")
    return fwd, bwd, lib, lib_bwd


def k4_launch_times(calls, card):
    """Device ms per micro-batch of K4f's launch and K4b's phases A and B
    over the K4 calls of ``calls``, by CUDA events (``launch_ms``; the
    profiler splits K4b into its phases), and of K4b launched without dbias
    (a null dbias: phase A's f32 atomics skipped, the same instantiation),
    which reads what the atomics cost. Logs one line; returns {label:
    ms}."""
    import torch
    from vsn_tpu_torch.ops import window_attention as wa

    k4 = [a for name, a in calls if name == "attention"]
    out = collections.Counter()
    with torch.no_grad():
        kept = [kept_state("attention", a) for a in k4]
        douts = [torch.randn(a[0].shape[:2] + (a[0].shape[2] // 3,),
                             device=a[0].device).to(a[0].dtype) for a in k4]
        out["forward"] = launch_ms(lambda: [wa.window_attention_qkv_launch(*a)
                                            for a in k4])
        for with_dbias in (True, False):
            key = "with dbias" if with_dbias else "without dbias"
            bwd = lambda: [
                wa._backward_kernel(a[0], a[1], a[2], g, kk["o"],
                                    kk["stats"], a[3], a[4], with_dbias)
                for a, g, kk in zip(k4, douts, kept)]
            ms = launch_ms(bwd)
            shares = phase_shares(bwd, "k4b_" + key.replace(" ", "_"), (
                "attention_bwd_rows", "attention_bwd_keys"))
            for phase, tag in (("A", "attention_bwd_rows"),
                               ("B", "attention_bwd_keys")):
                out[f"phase {phase} {key}"] = ms * shares[tag]
        del kept, douts
    kept = sum(kept_bytes("attention", a) for a in k4)
    log(f"[{card}] K4 launches alone (CUDA events; the profiler's split of "
        f"K4b's phases), device ms per micro-batch of "
        f"{TRAIN_MICRO} ({len(k4)} calls): K4f {out['forward']:.3f}; K4b "
        f"phase A {out['phase A with dbias']:.3f} (without dbias's atomics "
        f"{out['phase A without dbias']:.3f}), phase B "
        f"{out['phase B with dbias']:.3f} ("
        f"{out['phase B without dbias']:.3f}); the kept state "
        f"{kept / 1e6:.1f} MB, written by K4f and read by K4b, "
        f"{kept / HBM_BYTES_PER_S * 1e3:.3f} ms each way at the HBM rate "
        "(outside the bounds)")
    return out


def v_launch_times(calls, card):
    """Device ms per micro-batch of V1f's, V3f's and K4f's launches and of
    V1b's, V3b's and K4b's phases A and B (from their kept state) over the
    V and K4 calls of ``calls`` (the same values), by CUDA events
    (``launch_ms``; the profiler splits each backward into its phases).
    Logs one line; returns {label: ms}."""
    import torch

    out = {}
    with torch.no_grad():
        for name in ("attention", *V_KERNELS):
            launch, _, backward, _ = kept_launches(name)
            vc = [a for n, a in calls if n == name]
            kept = [launch(*a) for a in vc]
            douts = [torch.randn(k[0].shape, device=k[0].device).to(
                k[0].dtype) for k in kept]
            out[name] = launch_ms(lambda: [launch(*a) for a in vc])
            bwd = lambda: [
                backward(*kept_backward_args(name, a, g, k[2], k[1]))
                for a, g, k in zip(vc, douts, kept)]
            ms = launch_ms(bwd)
            shares = phase_shares(bwd, f"{name}_bwd_launch", (
                "attention_bwd_rows", "attention_bwd_keys"))
            for phase, tag in (("A", "attention_bwd_rows"),
                               ("B", "attention_bwd_keys")):
                out[f"{name}_bwd {phase}"] = ms * shares[tag]
            del kept, douts
    log(f"[{card}] V launches alone (CUDA events; the profiler's split of "
        f"the phases), device ms per micro-batch of "
        f"{TRAIN_MICRO}: V1f {out['attention_split']:.3f}, V1b phase A "
        f"{out['attention_split_bwd A']:.3f} + B "
        f"{out['attention_split_bwd B']:.3f}; V3f "
        f"{out['attention_windows']:.3f}, V3b phase A "
        f"{out['attention_windows_bwd A']:.3f} + B "
        f"{out['attention_windows_bwd B']:.3f}; K4f on the same values "
        f"{out['attention']:.3f}, K4b phase A "
        f"{out['attention_bwd A']:.3f} + B {out['attention_bwd B']:.3f}")
    return out


def attention_work(k1_args, backward=False):
    """(FLOP, bytes) of the attention alone of one K1 call (its launch 2, or
    K1b's phases A and B): 4 N^2 d per window and head forward, 10 backward
    (s, dp, dv, dq, dk); bytes qkv, the bias and ids in and ao out, or qkv,
    dao, the bias and ids in and dqkv and dbias out, in x's dtype."""
    x, bias, ids = k1_args[0], k1_args[5], k1_args[6]
    bw, n, c = x.shape
    act = bw * n * c * x.element_size()   # one [BW, N, C] in x's dtype
    if backward:
        return 10 * bw * n * n * c, 7 * act + 2 * _nbytes(bias) + _nbytes(ids)
    return 4 * bw * n * n * c, 4 * act + _nbytes(bias, ids)


def swin_k1_times(calls, card):
    """K1 at Swin's training calls (``calls``: one micro-batch's), per stage
    (the calls of one x shape) and summed, ms per micro-batch: K1f and K1b
    whole (CUDA events); their attention launches alone (CUDA events over
    LAUNCH_REPS calls: K1f's launch 2, K1b's phases A and B, split by the
    profiler) beside K4f's launch on the same q, k, v, bias and ids in the
    same phase (the same body under K4's softmax), beside one
    ``F.scaled_dot_product_attention``
    call per K1 call on its split heads with the float mask bias[h] +
    mask(ids), and that call's backward (``sdpa_times``: a yardstick the
    port never calls), and beside their bound (``attention_work``); the
    bytes of K1f's kept state (apart from the bounds). Logs one line per
    stage and one for the sums; returns the sums {label: ms}."""
    import torch
    from vsn_tpu_torch.ops import swin_block_kernels as sbk
    from vsn_tpu_torch.ops import window_attention as wa

    k1 = [a for name, a in calls if name == "attn_half"]
    stages = collections.defaultdict(list)
    for a in k1:
        stages[tuple(a[0].shape)].append(a)
    gen = torch.Generator().manual_seed(SEED + 25)
    total = collections.Counter()
    for shape, stage in stages.items():
        out = collections.Counter()
        label = "swin_k1_" + "x".join(map(str, shape))
        with torch.no_grad():
            b_args = [(*a[:8], a[10], torch.randn(
                a[0].shape, device=a[0].device).to(a[0].dtype), *a[11:13])
                for a in stage]
            kept = [k1_kept(a) for a in stage]
            fwd = lambda: [sbk.attn_half(*a) for a in stage]
            bwd = lambda: [sbk.attn_half_backward(*a, **kk)
                           for a, kk in zip(b_args, kept)]
            out["K1f"], out["K1b"] = cuda_ms(fwd), cuda_ms(bwd)
            del kept, b_args
            launch = []
            for a in stage:
                qkv, dao = tiled_launch_inputs(a, gen)
                _, stats, o = sbk.attention_tiled_launch(qkv, a[5], a[6],
                                                         a[11], a[12])
                launch.append((qkv, dao, o, stats, a[5], a[6], a[11], a[12]))
            # K4's ids: one row of zeros where K1's call has none
            k4 = [(la[0], la[4], torch.zeros(
                1, la[0].shape[1], dtype=torch.int32, device=la[0].device)
                if la[5] is None else la[5], *la[6:]) for la in launch]
            bwd_launch = lambda: [sbk.attention_tiled_backward_launch(*la)
                                  for la in launch]
            out["forward"] = launch_ms(lambda: [sbk.attention_tiled_launch(
                la[0], *la[4:]) for la in launch])
            out["K4f"] = launch_ms(lambda: [wa.window_attention_qkv_launch(*a)
                                            for a in k4])
            out["backward"] = launch_ms(bwd_launch)
            tags = phase_tags(head_dim("attn_half", stage[0]))
            shares = phase_shares(bwd_launch, label + "_bwd", tags)
            out["phase A"], out["phase B"] = (out["backward"] * shares[tag]
                                              for tag in tags)
        out["SDPA"], out["SDPA backward"] = sdpa_times(
            [("attention", (la[0], *la[4:])) for la in launch])
        del launch, k4
        kept = sum(kept_bytes("attn_half", a) for a in stage)
        log(f"[{card}] swin K1 at {len(stage)} training calls of x {shape} "
            f"{stage[0][0].dtype}, ms per micro-batch of {TRAIN_MICRO}: "
            f"{_k1_times_line(out, stage)}; K1f's kept state "
            f"{kept / 1e6:.1f} MB")
        total.update(out)
        total["kept bytes"] += kept
    log(f"[{card}] swin K1 at the {len(k1)} training calls of a micro-batch "
        f"of {TRAIN_MICRO}, summed: {_k1_times_line(total, k1)}; K1f's kept "
        f"state {total['kept bytes'] / 1e6:.1f} MB, written by K1f and read "
        f"by K1b, {total['kept bytes'] / HBM_BYTES_PER_S * 1e3:.3f} ms each "
        "way at the HBM rate (outside the bounds)")
    return total


def _k1_times_line(out, k1):
    """The numbers of ``swin_k1_times``'s log line for the K1 calls ``k1``."""
    bounds = []
    for backward in (False, True):
        flops = sum(attention_work(a, backward)[0] for a in k1)
        nbytes = sum(attention_work(a, backward)[1] for a in k1)
        bounds.append(work_bound_ms(flops, nbytes))
    back = out["backward"]
    return (f"K1f {out['K1f']:.3f}, K1b {out['K1b']:.3f}; the attention "
            f"launches alone forward {out['forward']:.3f} (K4f's launch on "
            f"the same values {out['K4f']:.3f}, "
            f"{_ratio(out['forward'], out['K4f']):.2f}x), backward "
            f"{back:.3f} (the profiler's split: phase A {out['phase A']:.3f}, "
            f"phase B "
            f"{out['phase B']:.3f}); SDPA on the same q, k, v with the float "
            f"mask {out['SDPA']:.3f}, its backward {out['SDPA backward']:.3f}"
            f" (launches / SDPA {_ratio(out['forward'], out['SDPA']):.2f}x, "
            f"{_ratio(back, out['SDPA backward']):.2f}x); bound forward "
            f"{bounds[0][0]:.3f} by {bounds[0][1]}, backward "
            f"{bounds[1][0]:.3f} by {bounds[1][1]}")


# ---------------------------------------------------------------------------
# The residual modes of K1/K2: in-band LayerScale and post-norm
# ---------------------------------------------------------------------------

def seeded_gamma(x, gen):
    """A LayerScale gamma [C] f32 of 0.5 + 0.1 z: a constant one would hide
    an index transposed between rows and columns."""
    import torch

    c = x.shape[-1]
    return (0.5 + 0.1 * torch.randn(c, generator=gen)).to(x.device)


def entry_name(counter, path):
    """The result line's entry that launch counter ``counter`` feeds on a
    ``path`` ("swin" or "vit"). K1's counters name its body
    (``attn_half_tiled...``, the key-tiled one), its entries the call site:
    ``attn_half...`` K1 at Swin's calls, ``attn_half_tiled...`` K1 at ViT's.
    Every other counter is its own entry."""
    if path == "swin" and counter.startswith("attn_half"):
        return counter.replace("_tiled", "", 1)
    return counter


def path_entries(counts, path):
    """The launch counts ``counts`` of a run on ``path`` under the result
    line's entries (``entry_name``); counters at 0 are left out."""
    return {entry_name(name, path): n for name, n in counts.items() if n}


def mode_name(name, mode, path):
    """The result line's entry of block kernel ``name`` (or its backward,
    with ``_bwd`` in ``name``) in residual ``mode`` (a suffix of
    RESIDUAL_MODES) on ``path``: its launch counter (K1's key-tiled body's)
    in the mode, under ``entry_name``."""
    return entry_name(TILED_NAME.get(name, name) + mode, path)


def residual_parity_phase(sets, gen, path, table=None,
                          logits=(45.0, 200.0)):
    """K1/K2 in every residual mode (RESIDUAL_MODES: pre-norm + gamma,
    post-norm, post-norm + gamma) on every recorded K1/K2 call of ``sets``
    (the calls of ``path``, "swin" or "vit", which names their kernels:
    ``mode_name``),
    with the seeded parameters of ``seeded_params`` and gamma = 0.5 + 0.1 z:
    the forward at lam 0, STABLE_LAM and 1, every gradient (dgamma
    included) at lam 0 and STABLE_LAM, against the plain versions to TOL of
    each output's scale; then K1b in every mode at saturated logits (bias
    8 z + ``logits``) on the first f32 set's first shifted, masked K1 call
    (else its first K1 call, given that bias). Logs one
    line per (set, kernel in its mode, check) and raises AssertionError
    naming every group that failed. Returns {mode kernel: worst max|d|}."""
    import torch

    table = table or kernel_table()
    worst = collections.defaultdict(float)
    failed = []
    for label, calls in sets.items():
        groups, kinds = {}, collections.defaultdict(set)
        for name, args in calls:
            if name not in BLOCK_KERNELS:
                continue
            kernel, plain = table[name]
            args = seeded_params(name, args, gen)
            gamma = seeded_gamma(args[0], gen)
            for mode, (ls, post) in RESIDUAL_MODES.items():
                kw = dict(gamma=gamma if ls else None, post_norm=post)
                fname = mode_name(name, mode, path)
                bname = mode_name(f"{name}_bwd", mode, path)
                kinds[fname] |= case_kind(name, args)
                kinds[bname] |= case_kind(name, args)
                for lam in MODE_LAMS:
                    err, limit, ok = compare(name, kernel, plain, args, lam,
                                             **kw)
                    _group(groups, (fname, f"lam={lam:g}"), err, limit, ok)
                    worst[fname] = max(worst[fname], err)
                for lam in MODE_LAMS[:2]:
                    for gname, err, limit, ok in grad_compare(
                            name, kernel, plain, args, lam, gen, **kw):
                        _group(groups, (bname, f"{gname} lam={lam:g}"), err,
                               limit, ok)
                        worst[bname] = max(worst[bname], err)
        _report(label, groups, kinds, failed)
    if failed:
        raise AssertionError("residual modes disagree with their plain "
                             "versions: " + "; ".join(failed))
    f32 = next(calls for calls in sets.values()
               if calls[0][1][0].dtype.is_floating_point
               and calls[0][1][0].element_size() == 4)
    kernel, plain = table["attn_half"]
    k1 = [a for n, a in f32 if n == "attn_half"]
    args = next((a for a in k1 if "shifted ids" in case_kind("attn_half", a)),
                k1[0])
    args = list(seeded_params("attn_half", args, gen))
    x, heads = args[0], args[12]
    z = torch.randn(heads, x.shape[1], x.shape[1], generator=gen).to(x.device)
    gamma = seeded_gamma(x, gen)
    for logit in logits:
        args[5] = z * 8 + logit
        for mode, (ls, post) in RESIDUAL_MODES.items():
            rows = grad_compare("attn_half", kernel, plain, args, STABLE_LAM,
                                gen, gamma=gamma if ls else None,
                                post_norm=post)
            bname = mode_name("attn_half_bwd", mode, path)
            ratio = max(_ratio(err, limit) for _, err, limit, _ in rows)
            bad = [g for g, _, _, ok in rows if not ok]
            log(f"parity saturated logits {logit:g}: {bname} {len(rows)} "
                f"grads, worst {ratio:.3f} of the limit "
                f"{'ok' if not bad else 'FAIL'}")
            if bad:
                raise AssertionError(f"{bname} at logits {logit:g}: {bad}")
            worst[bname] = max([worst[bname]] + [e for _, e, _, _ in rows])
    return dict(worst)


def mode_times(calls, mode, path):
    """Per-kernel (ms, plain ms) in residual ``mode`` summed over the K1/K2
    calls of ``calls`` (one micro-batch's of ``path``) and their backward,
    on the recorded arguments with gamma = 0.5 (the timing does not read
    its values) and one cotangent, under the mode's entries
    (``mode_name``). K1b reads
    what K1f kept of the call (``k1_kept``), made before the timing (the
    plain backward recomputes it, as the TPU kernel does)."""
    import torch
    from vsn_tpu_torch.ops import swin_block_kernels as sbk

    ls, post = RESIDUAL_MODES[mode]
    table = kernel_table()
    ms = collections.defaultdict(float)
    plain_ms = collections.defaultdict(float)
    with torch.no_grad():
        for name, args in calls:
            if name not in BLOCK_KERNELS:
                continue
            x = args[0]
            gamma = (torch.full((x.shape[-1],), 0.5, device=x.device)
                     if ls else None)
            kw = dict(gamma=gamma, post_norm=post)
            kernel, plain = table[name]
            fname = mode_name(name, mode, path)
            bname = mode_name(f"{name}_bwd", mode, path)
            ms[fname] += cuda_ms(lambda: kernel(*args, **kw))
            plain_ms[fname] += cuda_ms(lambda: plain(*args, **kw))
            g = torch.randn(x.shape, device=x.device).to(x.dtype)
            if name == "attn_half":
                b_args = (*args[:8], args[10], g, *args[11:13])
                bkw = dict(kw, proj_b=args[8])
                kbkw = dict(bkw, **k1_kept(args, **kw))
                bwd, plain_bwd = (sbk.attn_half_backward,
                                  sbk.attn_half_backward_reference)
            else:
                b_args = (*args[:6], args[8], g)
                bkw = kbkw = dict(kw, fc2_b=args[6])
                bwd, plain_bwd = (sbk.ln_mlp_backward,
                                  sbk.ln_mlp_backward_reference)
            ms[bname] += cuda_ms(lambda: bwd(*b_args, **kbkw))
            plain_ms[bname] += cuda_ms(lambda: plain_bwd(*b_args, **bkw))
    return ms, plain_ms


def key_label(over):
    """The config overrides of a stabilizer path, for its log lines."""
    return " + ".join(k for k, v in over.items() if v)


def residual_launches(path_counts):
    """The result line's launches of every RESIDUAL_KERNELS entry: the
    count that its path in RESIDUAL_PATH measured ({STABILIZER_PATHS key:
    launch counts}, under ``path_entries``; ViT's path is ``vit_all``).
    Raises AssertionError for an entry whose path launched it no time."""
    entries = {key: path_entries(counts, "vit" if key == "vit_all" else
                                 "swin")
               for key, counts in path_counts.items()}
    launches = {name: entries[RESIDUAL_PATH[name]].get(name, 0)
                for name in RESIDUAL_KERNELS}
    idle = [name for name, n in launches.items() if not n]
    if idle:
        raise AssertionError(f"residual modes no path launched: {idle}")
    return launches


def in_mode(expected, mode):
    """Launch counts ``expected`` with K1/K2 (and their backward) renamed to
    residual ``mode``'s counters."""
    return {(name + mode if name.startswith(("attn_half", "ln_mlp"))
             else name): n for name, n in expected.items()}


# ---------------------------------------------------------------------------
# The attention probes P1-P5 (ops/attn_probe.py, vsn_tpu_torch/probes)
# ---------------------------------------------------------------------------

def probe_runs():
    """The runs of both probe scripts, in their order
    (``vsn_tpu_torch.probes``' ``Run``)."""
    from vsn_tpu_torch.probes import attn_ablate, attn_ablate2

    return attn_ablate.RUNS + attn_ablate2.RUNS


def probe_table(runs):
    """launch key -> (kernel, plain version) of each run, both taking (x,
    wqkv, bias, wproj)."""
    return {run.key: (run.kernel, run.plain) for run in runs}


def _probe_variant(name):
    """The P1 variant a probe run computes (P5's "full" / "lin" are P1's
    full2d / linear_only), or None for a copy."""
    from vsn_tpu_torch.ops.attn_probe import SLOT_VARIANTS

    run = {r.key: r for r in probe_runs()}[name]
    if run.kind == "copy_windows":
        return None
    return SLOT_VARIANTS.get(run.variant, run.variant)


def probe_work(name, x, wqkv, bias, wproj):
    """(FLOP, bytes) of one probe call: x read and out written once, the
    weights the variant reads (a copy reads none: P3's are declared, not
    read); the qkv and proj products (8 rows C^2) unless ``attn_only``,
    q k^T and p v (4 rows N C) unless ``linear_only``."""
    variant = _probe_variant(name)
    if variant is None:
        return 0, 2 * _nbytes(x)
    bw, n, c = x.shape
    rows = bw * n
    gemms = variant != "attn_only"
    attention = variant != "linear_only"
    flops = 8 * rows * c * c * gemms + 4 * rows * n * c * attention
    weights = _nbytes(wqkv, wproj) * gemms + _nbytes(bias) * (
        attention and variant != "nobias")
    return flops, 2 * _nbytes(x) + weights


def probe_inputs(shape, device, gen):
    """Seeded f32 inputs under which every ablated piece moves the branch:
    x = 3 z + 1 + a per-row offset 2 z (LayerNorm removes both), weights
    fan_in^-0.5 z (O(1) activations and logits), bias z. The scripts' own
    (x a unit normal, weights 0.05 z, bias 0.1 z) make the branch ~0.01 of
    a bf16 x, below one bf16 step of it."""
    import torch

    bw, n, c = shape
    z = lambda *s: torch.randn(*s, generator=gen, device=device)
    x = 3 * z(bw, n, c) + 1 + 2 * z(bw, n, 1)
    return x, z(c, 3 * c) * c ** -0.5, z(3, n, n), z(c, c) * c ** -0.5


def probe_compare(name, x, got, want):
    """(max|d|, [ratio to each limit], ok) of one probe call: a copy
    bit-exact (no ratio); an f32 out on the branch out - x, [max over
    P_MAX_TOL of the branch's largest value, RMS over P_RMS_TOL of its
    RMS]; a bf16 out, [max over TOL of its scale]."""
    import torch

    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{name}: {tuple(got.shape)}/{got.dtype} vs "
                             f"{tuple(want.shape)}/{want.dtype}")
    d = got.float() - want.float()
    err = d.abs().max().item()
    if _probe_variant(name) is None:
        return err, [], bool(torch.equal(got, want))
    if want.dtype == torch.float32:
        branch = want - x
        d = (got - x) - branch
        err = d.abs().max().item()
        ratios = [err / (P_MAX_TOL * branch.abs().max().item()),
                  d.pow(2).mean().sqrt().item()
                  / (P_RMS_TOL * branch.pow(2).mean().sqrt().item())]
    else:
        ratios = [err / (TOL["bfloat16"] * max(1.0, want.float().abs().max()
                                                .item()))]
    return err, ratios, bool(torch.isfinite(got).all()) and max(ratios) <= 1


def probe_qkv(variant, x, wqkv):
    """Launch 1 of a P1 / P5 run with f32 x alone (``gemm_launch``: the same
    GEMM instantiation on the same operands as the run's own, so the same
    bits): (qkv [BW, N, 3C] bf16, whether it is within the GEMM phase's
    bf16 limit of its plain version)."""
    import torch
    from vsn_tpu_torch.ops import swin_block_kernels as sbk

    bw, n, c = x.shape
    ln = None if variant == "noln" else (
        torch.ones(c, device=x.device), torch.zeros(c, device=x.device))
    args = (x.reshape(bw * n, c), wqkv, "bias", torch.bfloat16)
    got = sbk.gemm_launch(*args, w_kn=True, ln=ln)[0]
    want = sbk.gemm_reference(*args, w_kn=True, ln=ln)[0].float()
    err = (got.float() - want).abs().max().item()
    ok = err <= GEMM_TOL["bfloat16"] * max(1.0, want.abs().max().item())
    return got.reshape(bw, n, 3 * c), ok


def probe_parity_phase(sets, table, runs):
    """Hold every probe run's kernel against its plain version on each set
    of ``sets`` {label: (x bf16, wqkv, bias, wproj)}: a set whose x is bf16
    runs every run at its own dtype (the scripts' inputs: copies bit-exact,
    ``out`` to TOL), an f32 set every P1 and P5 run with f32 x and out
    (``probe_compare``'s branch check). In an f32 set the plain version
    runs on the run's own qkv (``probe_qkv``), which must be within the
    GEMM phase's bf16 limit of its plain version: a single bf16 rounding of
    q or k that the
    order of the qkv sums decides moves the branch of ``noln`` (no
    LayerNorm, logits O(30)) by more than the branch limit, and the
    tensor-core GEMM sums in another order than the plain version's f32
    product. Logs one line per (set, run); raises naming every failure.
    Returns {launch key: worst max|d|}."""
    import torch

    worst = collections.defaultdict(float)
    failed = []
    for label, (xs, *weights) in sets.items():
        for run in runs:
            if xs.dtype == torch.float32:
                if run.kind == "copy_windows":
                    continue
                x = xs
            else:
                x = run.x(xs)
            kernel, plain = table[run.key]
            qkv, qkv_ok = None, True
            variant = _probe_variant(run.key)
            with torch.inference_mode():
                if xs.dtype == torch.float32 and variant != "attn_only":
                    qkv, qkv_ok = probe_qkv(variant, x, weights[0])
                got, want = kernel(x, *weights), plain(x, *weights, qkv=qkv)
            err, ratios, ok = probe_compare(run.key, x, got, want)
            ok = ok and qkv_ok
            worst[run.key] = max(worst[run.key], err)
            limit = ("max " + " / RMS ".join(f"{r:.3f}" for r in ratios)
                     + " of the limit" if ratios else "bit-exact")
            log(f"parity probes {label} {run.name} ({run.key}, "
                f"{str(x.dtype).removeprefix('torch.')}): max|d| {err:.3e} "
                f"({limit}{'' if qkv is None else ', on its own qkv'}"
                f"{'' if qkv_ok else ', qkv off its plain version'})"
                f" {'ok' if ok else 'FAIL'}")
            if not ok:
                failed.append(f"{label} {run.key}")
            del got, want
    if failed:
        raise AssertionError("probe kernels disagree with their plain "
                             "versions: " + "; ".join(failed))
    return dict(worst)


def probe_path(runs):
    """The probes' main path: both entry points
    (``python -m vsn_tpu_torch.probes.attn_ablate[2]``) with every launch
    counter at 0 before; each run's launches exactly its launches per call
    times the warm-up and timed calls after. Returns (counts, {launch key:
    ms per call measured by the entry point})."""
    import torch
    from vsn_tpu_torch.ops import _build
    from vsn_tpu_torch.probes import REPS, WARMUP, attn_ablate, attn_ablate2

    _build.launches.clear()
    ms = attn_ablate.main()
    ms.update(attn_ablate2.main())
    torch.cuda.synchronize()
    counts = launch_counts()
    log(f"probe path: {len(runs)} runs x {WARMUP + REPS} calls, launches "
        f"{ {k: n for k, n in counts.items() if n} }")
    check_counts(counts, {run.key: run.launches for run in runs},
                 WARMUP + REPS, "probe path")
    return counts, {run.key: ms[run.name] for run in runs}


def k1f_stage1_args(xw, wqkv, bias, wproj, samples):
    """K1f's arguments for the probes' call: LayerNorm scale 1 and shift 0,
    zero qkv and proj biases, the weights in the torch Linear layout, no
    ids, gains 1 for the ``samples`` samples: K1f's function with the
    probes' parameters (the softmax shift and the output scale stay
    K1f's)."""
    import torch

    c, heads = xw.shape[-1], bias.shape[0]
    dev = xw.device
    ones = torch.ones(samples, device=dev)
    zeros = lambda k: torch.zeros(k, device=dev)
    return (xw, torch.ones(c, device=dev), zeros(c), wqkv.t().contiguous(),
            zeros(3 * c), bias, None, wproj.t().contiguous(), zeros(c), ones,
            ones, (c // heads) ** -0.5, heads)


def probe_times(runs, inputs, samples, card):
    """({key: plain ms}, {key: library ms or None}, K1f's ms, {copy key:
    its kernel's ms}) at the scripts' inputs: each run's plain version; for
    a copy (P2-P4) its kernel alone and the library's ``Tensor.copy_`` into
    a preallocated tensor (a yardstick the port never calls), both by
    ``launch_ms`` on the same x; K1f on the same x with the probes'
    parameters (``k1f_stage1_args``)."""
    import torch
    from vsn_tpu_torch.ops import swin_block_kernels as sbk

    xw, *weights = inputs
    plain_ms, library_ms, copies = {}, {}, {}
    with torch.no_grad():
        for run in runs:
            x = run.x(xw)
            plain_ms[run.key] = cuda_ms(lambda: run.plain(x, *weights),
                                        reps=1)
            library_ms[run.key] = None
            if run.kind == "copy_windows":
                out = torch.empty_like(x)
                copies[run.key] = launch_ms(lambda: run.kernel(x, *weights))
                library_ms[run.key] = launch_ms(lambda: out.copy_(x))
            del x
        k1 = k1f_stage1_args(xw, *weights, samples)
        k1f = cuda_ms(lambda: sbk.attn_half(*k1))
    log(f"[{card}] K1f at the probes' stage-1 call (x {tuple(xw.shape)} "
        f"bf16, LN 1/0, zero biases, gains 1, no ids): {k1f:.3f} ms")
    return plain_ms, library_ms, k1f, copies


def probe_phase(device, card):
    """The probes P1-P5 (phase 7): parity at the scripts' inputs and at
    ``probe_inputs``' f32 ones, the probe path (``probe_path``), plain and
    library times and K1f beside them, bounds. Returns {launch key:
    (launches, max|d|, ms, plain ms, (bound ms, by), library ms)}."""
    import torch
    from vsn_tpu_torch.probes import MICRO, script_inputs

    runs = probe_runs()
    if {run.key for run in runs} != set(PROBES) or any(
            PROBES[run.key][0] != run.name for run in runs):
        raise AssertionError("PROBES does not list the probe runs")
    inputs = script_inputs(device)
    gen = torch.Generator(device).manual_seed(SEED + 13)
    sets = {"scripts' inputs": inputs,
            "f32 sensitive": probe_inputs(inputs[0].shape, device, gen)}
    worst = probe_parity_phase(sets, probe_table(runs), runs)
    del sets
    torch.cuda.empty_cache()
    counts, ms = probe_path(runs)
    plain_ms, library_ms, k1f, copies = probe_times(runs, inputs, MICRO,
                                                    card)
    for key, t in copies.items():   # the copies by launch_ms, as copy_
        log(f"[{card}] probe copy {key}: {t:.4f} ms alone (launch_ms; the "
            f"entry point's unqueued events {ms[key]:.4f} ms), copy_ "
            f"{library_ms[key]:.4f} ms alone")
        ms[key] = t
    out = {}
    for run in runs:
        bound = bound_ms(run.key, [(run.key, (run.x(inputs[0]),
                                              *inputs[1:]))])
        lib = ("" if library_ms[run.key] is None
               else f", copy_ {library_ms[run.key]:.3f} ms")
        log(f"[{card}] probe {run.probe} {run.name}: {ms[run.key]:.3f} ms "
            f"({ms[run.key] / k1f:.3f} of K1f's {k1f:.3f}; plain "
            f"{plain_ms[run.key]:.3f} ms{lib}, bound {bound[0]:.3f} ms by "
            f"{bound[1]})")
        out[run.key] = (counts[run.key], worst[run.key], ms[run.key],
                        plain_ms[run.key], bound, library_ms[run.key])
    return out


# ---------------------------------------------------------------------------
# The GEMM and weight-gradient bodies of K1 / K2 alone
# ---------------------------------------------------------------------------

GemmLaunch = collections.namedtuple(
    "GemmLaunch", "label kind mode m k n rows_per_sample")


def block_gemm_launches(name, args):
    """The GEMM and weight-gradient launches that one K1 (``attn_half``) or
    K2 (``ln_mlp``) call of the main path makes, forward and backward, in
    the default mode (pre-norm, no LayerScale), as csrc/attn_half.cu,
    attn_half_bwd.cu, ln_mlp.cu and ln_mlp_bwd.cu launch them:
    [GemmLaunch]. A GEMM's mode is (epilogue, LayerScale flag, W read as [K,
    N], A's prologue: "ln", "gain", "f32" or "plain"), k its depth, n its
    width; a weight gradient's (A's type "T" or "f32", A gained), k = N1 and
    n = N2, over m rows."""
    x = args[0]
    if name == "attn_half":
        bw, n, c = x.shape
        m, nsamp = bw * n, args[9].shape[0]
        return [GemmLaunch(*launch, m // nsamp) for launch in (
            ("K1f qkv", "gemm", ("bias", None, False, "ln"), m, c, 3 * c),
            ("K1f proj", "gemm", ("residual", None, False, "plain"), m, c,
             c),
            ("K1b qkv", "gemm", ("bias", None, False, "plain"), m, c, 3 * c),
            ("K1b dao", "gemm", ("bias", None, True, "gain"), m, c, c),
            ("K1b dWproj", "wgrad", ("T", True), m, c, c),
            ("K1b dWqkv", "wgrad", ("T", False), m, 3 * c, c),
            ("K1b dy", "gemm", ("f32", None, True, "plain"), m, 3 * c, c))]
    m, c = x.shape
    hid, nsamp = args[3].shape[0], args[7].shape[0]
    return [GemmLaunch(*launch, m // nsamp) for launch in (
        ("K2f fc1", "gemm", ("gelu", None, False, "ln"), m, c, hid),
        ("K2f fc2", "gemm", ("residual", None, False, "plain"), m, hid, c),
        ("K2b fc1", "gemm", ("gelu_grad", None, False, "plain"), m, c, hid),
        ("K2b dh1", "gemm", ("mul_f32", None, True, "gain"), m, c, hid),
        ("K2b dW2", "wgrad", ("T", True), m, c, hid),
        ("K2b dW1", "wgrad", ("f32", False), m, hid, c),
        ("K2b dy", "gemm", ("f32", None, True, "f32"), m, hid, c))]


def gemm_launch_set(calls):
    """{GemmLaunch: how many of the calls make it}, in first-call order,
    for the K1 / K2 calls among ``calls`` [(name, args)]."""
    out = collections.Counter()
    for name, args in calls:
        if name in BLOCK_KERNELS:
            out.update(block_gemm_launches(name, args))
    return out


def gemm_work(launch, dtype="bfloat16"):
    """(FLOP, bytes) of one launch: its products, and each input read once
    (A, the f32 W, the small vectors, the residual, out32 of "mul_f32") and
    each output written once."""
    el = 2 if dtype == "bfloat16" else 4
    m, k, n = launch.m, launch.k, launch.n
    if launch.kind == "wgrad":
        a_el = 4 if launch.mode[0] == "f32" else el
        return 2 * m * k * n, m * k * a_el + m * n * el + 4 * k * n
    epi, _, _, a_kind = launch.mode
    a_el = 4 if a_kind == "f32" else el
    nbytes = m * k * a_el + 4 * (n * k + n + 2 * k) + m * n * {
        "bias": el, "gelu": el, "residual": 2 * el, "gelu_grad": el + 4,
        "f32": 4, "mul_f32": 8, "add_resid": 2 * el}[epi]
    return 2 * m * k * n, nbytes


def work_bound_ms(flops, nbytes, dtype="bfloat16"):
    """(least ms, "bytes" or "operations") of ``flops`` and ``nbytes`` on
    this card: the larger of the bytes over the HBM rate and the FLOP over
    the peak rate for ``dtype``."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), "operations" if t_ops >= t_bytes else "bytes"


def gemm_table():
    """name -> (launch wrapper, plain version) of the GEMM bodies alone."""
    from vsn_tpu_torch.ops import swin_block_kernels as sbk

    return {"gemm": (sbk.gemm_launch, sbk.gemm_reference),
            "wgrad": (sbk.wgrad_launch, sbk.wgrad_reference)}


def gemm_call(launch, dtype, device, gen):
    """Seeded operands of one launch in ``dtype``: (args, keywords) of its
    wrapper. Row operands are the first M rows of a buffer with GEMM_TAIL
    nonzero rows past them; weights fan_in^-0.5 z, biases and shifts 0.1 z,
    LayerNorm scales 1 + 0.1 z, per-sample gains 0.6 .. 1.4 (distinct in
    every sample)."""
    import torch

    cdt = getattr(torch, dtype)
    f32 = torch.float32
    z = lambda *s: torch.randn(*s, generator=gen, device=device)
    rows = lambda k, dt, scale=1.0, shift=0.0: (
        scale * z(launch.m + GEMM_TAIL, k) + shift).to(dt)[:launch.m]
    gains = torch.linspace(0.6, 1.4, -(-launch.m // launch.rows_per_sample),
                           device=device)
    if launch.kind == "wgrad":
        a_type, gained = launch.mode
        a = rows(launch.k, f32 if a_type == "f32" else cdt)
        kw = dict(a_gain=gains, rows_per_sample=launch.rows_per_sample) \
            if gained else {}
        return (a, rows(launch.n, cdt), cdt), kw
    epi, ls, w_kn, a_kind = launch.mode
    a = rows(launch.k, f32 if a_kind == "f32" else cdt,
             *((3.0, 1.0) if a_kind == "ln" else ()))
    w = launch.k ** -0.5 * (z(launch.k, launch.n) if w_kn
                            else z(launch.n, launch.k))
    kw = dict(w_kn=w_kn, bias=0.1 * z(launch.n),
              rows_per_sample=launch.rows_per_sample, lam=PATH_LAM)
    if a_kind == "ln":
        kw["ln"] = (1 + 0.1 * z(launch.k), 0.1 * z(launch.k))
    if a_kind == "gain":
        kw["a_gain"] = gains
    if epi in ("residual", "add_resid"):
        kw["resid"] = rows(launch.n, cdt)
    if epi == "residual":
        kw["gains"] = gains
    if epi == "mul_f32":
        kw["out32"] = rows(launch.n, f32)
    return (a, w, epi, cdt), kw


def _fresh(kw):
    """The keywords with a fresh copy of out32, which "mul_f32" updates in
    place."""
    return {**kw, "out32": kw["out32"].clone()} if "out32" in kw else kw


def gemm_compare(launch, args, kw, table):
    """One launch against its plain version on the same operands: (the
    largest max|d| of its outputs, the largest as a share of its limit,
    GEMM_TOL of each output's scale: a weight gradient's f32 sums and a
    GEMM's out32 under bf16 to GEMM_TOL["out32"])."""
    kernel, plain = table[launch.kind]
    got, want = kernel(*args, **_fresh(kw)), plain(*args, **_fresh(kw))
    f32 = str(args[-1]) == "torch.float32"   # the launch's operand type
    if launch.kind == "wgrad":
        got, want = (got,), (want,)
    err_max = ratio_max = 0.0
    for g, w in zip(got, want):
        if (g is None) != (w is None):
            raise AssertionError(f"{launch.label}: an output is missing")
        if g is None:
            continue
        limit = GEMM_TOL["float32" if f32 else
                         "out32" if g.dtype.itemsize == 4 else "bfloat16"]
        err = (g.float() - w.float()).abs().max().item()
        scale = max(1.0, w.float().abs().max().item())
        err_max = max(err_max, err) if math.isfinite(err) else math.inf
        ratio_max = max(ratio_max, err / (limit * scale)) \
            if math.isfinite(err) else math.inf
    return err_max, ratio_max


def gemm_parity_phase(sets, device, table=None, seed=SEED + 24):
    """Every launch of ``sets`` {label: (launches, dtype)} against its
    plain version (``gemm_compare``); logs each set's worst, raises naming
    the launches over their limit. Returns {"gemm": worst max|d|, "wgrad":
    ...}."""
    import torch

    table = table or gemm_table()
    gen = torch.Generator(device).manual_seed(seed)
    worst, failed = dict.fromkeys(GEMM_KERNELS, 0.0), []
    for label, (launches, dtype) in sets.items():
        ratios = dict.fromkeys(GEMM_KERNELS, 0.0)
        for launch in launches:
            args, kw = gemm_call(launch, dtype, device, gen)
            err, ratio = gemm_compare(launch, args, kw, table)
            worst[launch.kind] = max(worst[launch.kind], err)
            ratios[launch.kind] = max(ratios[launch.kind], ratio)
            if not ratio <= 1.0:
                failed.append(f"{label} {launch.label} {launch.m}x{launch.k}"
                              f"x{launch.n}: {ratio:.2f} of its limit")
        log(f"GEMM parity {label} ({dtype}): {len(launches)} launch shapes, "
            + ", ".join(f"{k} worst {v:.3f} of the limit"
                        for k, v in ratios.items()))
    if failed:
        raise AssertionError("GEMM launches disagree with their plain "
                             f"versions: {failed}")
    return worst


def gemm_path(launches, device, dtype="bfloat16"):
    """Every launch of ``launches`` once through ``gemm_launch`` /
    ``wgrad_launch`` with every launch counter at 0 before: the counters
    after, which must be one per launch of each body and nothing else."""
    import torch
    from vsn_tpu_torch.ops import _build

    gen = torch.Generator(device).manual_seed(SEED + 25)
    calls = [gemm_call(launch, dtype, device, gen) for launch in launches]
    table = gemm_table()
    _build.launches.clear()
    for launch, (args, kw) in zip(launches, calls):
        table[launch.kind][0](*args, **_fresh(kw))
    torch.cuda.synchronize()
    counts = launch_counts()
    want = collections.Counter(launch.kind for launch in launches)
    check_counts(counts, want, 1, "GEMM path")
    return counts


def gemm_times(launch_sets, device, card):
    """Per launch of each set {label: Counter(GemmLaunch)}, bf16: the
    tensor-core body's ms, the FMA body's on the same call (the body every
    bf16 GEMM took before), torch.matmul's on the same operands already
    rounded to bf16 (A' and W', or round(g A)^T and B: a yardstick the port
    never calls), all three by CUDA events with the calls queued behind a
    spin kernel (``launch_ms``: the wrapper's host time, which can exceed a
    small launch's, left out), the plain version's (CUDA events), and the
    bound; logged. Returns, per
    set, {name: (ms, FMA ms, plain ms, (bound ms, by), matmul ms)} summed
    over the set's launches, each by how many calls make it."""
    import torch
    from vsn_tpu_torch.ops import swin_block_kernels as sbk

    gen = torch.Generator(device).manual_seed(SEED + 26)
    table = gemm_table()
    out = {}
    for label, launches in launch_sets.items():
        tot = {name: collections.Counter() for name in GEMM_KERNELS}
        for launch, times in launches.items():
            args, kw = gemm_call(launch, "bfloat16", device, gen)
            kernel, plain = table[launch.kind]
            bf = torch.bfloat16
            if launch.kind == "wgrad":
                g = (sbk._gain_rows(kw["a_gain"], launch.rows_per_sample,
                                    launch.m) if kw else 1.0)
                at, bt = (g * args[0].float()).to(bf).t(), args[1]
            else:
                epi, ls, w_kn, a_kind = launch.mode
                a32 = args[0].float()
                if a_kind == "ln":
                    a32 = sbk._ln_parts(a32, *kw["ln"])[0]
                elif a_kind == "gain":
                    a32 = sbk._gain_rows(kw["a_gain"], launch.rows_per_sample,
                                         launch.m) * a32
                at, bt = a32.to(bf), (args[1] if w_kn else args[1].t()).to(bf)
                del a32
            t = dict(ms=launch_ms(lambda: kernel(*args, **kw)),
                     fma=launch_ms(lambda: kernel(*args, **kw, _fma=True)),
                     matmul=launch_ms(lambda: torch.matmul(at, bt)),
                     plain=cuda_ms(lambda: plain(*args, **kw)))
            bound, by = work_bound_ms(*gemm_work(launch))
            log(f"[{card}] GEMM {label} {launch.label} {launch.m}x{launch.k}"
                f"x{launch.n} (x{times} a micro-batch): {t['ms']:.4f} ms, "
                f"FMA body {t['fma']:.4f} ms, torch.matmul {t['matmul']:.4f}"
                f" ms, plain {t['plain']:.4f} ms, bound {bound:.4f} ms by "
                f"{by}")
            flops, nbytes = gemm_work(launch)
            tot[launch.kind].update({k: times * v for k, v in (
                *t.items(), ("flops", flops), ("bytes", nbytes))})
            del args, kw, at, bt
        out[label] = {}
        for name, t in tot.items():
            bound = work_bound_ms(t["flops"], t["bytes"])
            out[label][name] = (t["ms"], t["fma"], t["plain"], bound,
                                t["matmul"])
            log(f"[{card}] GEMM {label} {name}: {t['ms']:.3f} ms per "
                f"micro-batch (FMA body {t['fma']:.3f} ms, torch.matmul "
                f"{t['matmul']:.3f} ms, plain {t['plain']:.3f} ms, bound "
                f"{bound[0]:.3f} ms by {bound[1]})")
        torch.cuda.empty_cache()
    return out


def block_shapes(device):
    """The K1 / K2 calls of one training forward of the Swin-T 5c flagship
    model at micro-batch TRAIN_MICRO and of ViT-S 5c at VIT_MICRO, recorded
    on zero volumes of their input size (only the shapes are read): their
    GEMM launches {label: Counter(GemmLaunch)} and their LN-backward
    launches {label: Counter(RowLaunch)}."""
    import torch
    from vsn_tpu_torch.config import load_config

    out, rows = {}, {}
    for label, cfg in (
            (f"Swin-T micro {TRAIN_MICRO}", load_config(dict(
                USE_SHAKEDROP=True, BATCH_SIZE=TRAIN_MICRO))),
            (f"ViT-S micro {VIT_MICRO}", load_config(dict(
                USE_SHAKEDROP=True, BATCH_SIZE=VIT_MICRO),
                preset=VIT_PRESET))):
        model = seeded_model(cfg).train()
        x = torch.zeros((cfg.BATCH_SIZE, *cfg.input_size, 1),
                        dtype=torch.bfloat16, device=device)
        calls = record_calls(model, x,
                             generator=torch.Generator(device).manual_seed(4))
        out[label] = gemm_launch_set(calls)
        rows[label] = row_launch_set(calls)
        del model, x, calls
    torch.cuda.empty_cache()
    return out, rows


# ---------------------------------------------------------------------------
# Phase 2b: the row kernels of K1 / K2 alone (csrc/common.cuh, entry points
# csrc/row_kernels.cu): the LayerNorm backward of K1b / K2b in its two modes
# (``ln_bwd_launch``, ``postnorm_bwd_launch``), and the row kernels it
# leaves as they are (``sbk.ROW_KERNELS``), timed beside it
# ---------------------------------------------------------------------------

RowLaunch = collections.namedtuple("RowLaunch",
                                   "label m c rows_per_sample hidden")


def block_row_launches(name, args):
    """The LN-backward launch that one K1 (``attn_half``) or K2
    (``ln_mlp``) call makes in its backward: K1b's LN1 or K2b's LN2 over the
    call's rows, as a RowLaunch (hidden: K2's hidden width, 0 for K1)."""
    x = args[0]
    if name == "attn_half":
        m, c = x.shape[0] * x.shape[1], x.shape[2]
        return RowLaunch("K1b LN1", m, c, m // args[9].shape[0], 0)
    m, c = x.shape
    return RowLaunch("K2b LN2", m, c, m // args[7].shape[0],
                     args[3].shape[0])


def row_launch_set(calls):
    """{RowLaunch: how many of the calls make it} for the K1 / K2 calls
    among ``calls`` [(name, args)]."""
    return collections.Counter(block_row_launches(name, args)
                               for name, args in calls
                               if name in BLOCK_KERNELS)


def ln_bwd_table():
    """name -> (launch wrapper, plain version) of the LN backward alone."""
    from vsn_tpu_torch.ops import swin_block_kernels as sbk

    return {"ln_bwd": (sbk.ln_bwd_launch, sbk.ln_backward_rows_reference),
            "postnorm_bwd": (sbk.postnorm_bwd_launch,
                             sbk.postnorm_backward_rows_reference)}


def ln_bwd_call(name, launch, dtype, device, gen):
    """Seeded arguments of the LN-backward launch ``name`` at ``launch``'s
    rows and width in ``dtype``. Pre-norm (``ln_bwd``): x = 3 z + 1 and its
    own row statistics, LN scale 1 + 0.1 z, dy = z (f32), do_res = z, lam
    PATH_LAM. Post-norm (``postnorm_bwd``, as the arms launch it, with
    LayerScale): the f32 branch 2 z - 0.5, do_res = z, per-sample gains 0.6
    .. 1.4, LN scale and shift 0.1 z, gamma 0.5 + 0.1 z. The parameter
    vectors are views 4 bytes into a buffer, as training's are views into
    its flat parameter buffer."""
    import torch
    from vsn_tpu_torch.ops import swin_block_kernels as sbk

    cdt = getattr(torch, dtype)
    z = lambda *s: torch.randn(*s, generator=gen, device=device)
    vec = lambda v: torch.cat([v.new_zeros(1), v])[1:]
    m, c = launch.m, launch.c
    w = vec(1 + 0.1 * z(c))
    do_res = z(m, c).to(cdt)
    if name == "ln_bwd":
        x = (3 * z(m, c) + 1).to(cdt)
        stats = sbk.ln_rows_reference(x, torch.ones_like(w),
                                      torch.zeros_like(w))[1]
        return x, stats, w, z(m, c), do_res, PATH_LAM
    gains = torch.linspace(0.6, 1.4, m // launch.rows_per_sample,
                           device=device)
    return (2 * z(m, c) - 0.5, do_res, gains, launch.rows_per_sample, w,
            vec(0.1 * z(c)), vec(0.5 + 0.1 * z(c)))


def _ln_outputs(name, fn, args):
    """The outputs of ``fn`` (a launch or its plain version) on ``args``;
    the post-norm kernel overwrites its branch, so it gets a copy."""
    if name == "postnorm_bwd":
        args = (args[0].clone(), *args[1:])
    return [t for t in fn(*args) if t is not None]


def ln_bwd_compare(name, args, table):
    """One LN-backward launch against its plain version on the same
    arguments: (the largest max|d| of its outputs, the largest as a share
    of its limit, whether a second launch gave the same bits in every
    output). dx / dbranch are held to TOL of the activation type, dw, db and
    dgamma to LN_BWD_TOL, each relative to its scale."""
    import torch

    kernel, plain = table[name]
    got = _ln_outputs(name, kernel, args)
    again = _ln_outputs(name, kernel, args)
    want = _ln_outputs(name, plain, args)
    dtype = str(args[1 if name == "postnorm_bwd" else 0].dtype).split(".")[-1]
    if len(got) != len(want):
        raise AssertionError(f"{name}: {len(got)} outputs, expected "
                             f"{len(want)}")
    err_max = ratio_max = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        limit = TOL[dtype] if i == 0 else LN_BWD_TOL[dtype]
        err = (g.float() - w.float()).abs().max().item()
        scale = max(1.0, w.float().abs().max().item())
        if not math.isfinite(err):
            err = math.inf
        err_max = max(err_max, err)
        ratio_max = max(ratio_max, err / (limit * scale))
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    return err_max, ratio_max, same


def ln_bwd_parity_phase(sets, device, table=None, seed=SEED + 27):
    """Every LN-backward launch of ``sets`` {label: (Counter(RowLaunch),
    dtype)} in both modes against its plain version, and a second launch
    for the same bits (``ln_bwd_compare``); logs each set's worst; raises
    naming the launches over their limit or whose bits differ. Returns
    {name: worst max|d|}."""
    import torch

    table = table or ln_bwd_table()
    gen = torch.Generator(device).manual_seed(seed)
    worst, failed, unequal = dict.fromkeys(LN_BWD_KERNELS, 0.0), [], []
    for label, (launches, dtype) in sets.items():
        ratios = dict.fromkeys(LN_BWD_KERNELS, 0.0)
        for name in LN_BWD_KERNELS:
            for launch in launches:
                args = ln_bwd_call(name, launch, dtype, device, gen)
                err, ratio, same = ln_bwd_compare(name, args, table)
                worst[name] = max(worst[name], err)
                ratios[name] = max(ratios[name], ratio)
                what = f"{label} {name} {launch.label} {launch.m}x{launch.c}"
                if not ratio <= 1.0:
                    failed.append(f"{what}: {ratio:.2f} of its limit")
                if not same:
                    unequal.append(what)
                del args
        log(f"LN-backward parity {label} ({dtype}): {len(launches)} launch "
            "shapes a mode, " + ", ".join(
                f"{k} worst {v:.3f} of the limit" for k, v in ratios.items())
            + ", two launches bit-equal" * (not unequal))
    if failed:
        raise AssertionError("LN-backward launches disagree with their "
                             f"plain versions: {failed}")
    if unequal:
        raise AssertionError("LN-backward launches differ between two runs "
                             f"on the same inputs: {unequal}")
    return worst


def ln_bwd_path(sets, device):
    """Every LN-backward launch of ``sets`` {label: Counter(RowLaunch)} as
    often as a training micro-batch pass makes it, through
    ``ln_bwd_launch`` (the default mode) and ``postnorm_bwd_launch`` (the
    post-norm arms'), with every launch counter at 0 before: the counters
    after, which must be one per launch and nothing else."""
    import torch
    from vsn_tpu_torch.ops import _build

    gen = torch.Generator(device).manual_seed(SEED + 28)
    table = ln_bwd_table()
    want = collections.Counter()
    _build.launches.clear()
    for name in LN_BWD_KERNELS:
        for launches in sets.values():
            for launch, times in launches.items():
                args = ln_bwd_call(name, launch, "bfloat16", device, gen)
                for _ in range(times):
                    table[name][0](*args)
                want[name] += times
                del args
    torch.cuda.synchronize()
    counts = launch_counts()
    check_counts(counts, want, 1, "LN-backward path")
    return counts


def ln_bwd_work(name, launch, dtype="bfloat16"):
    """(f32 operations, bytes) of one LN-backward launch: each input read
    once and each output written once (pre-norm x, do_res, dx in the
    activation type, dy f32, the row statistics, w, dw, db; post-norm the
    f32 branch read and dbranch written, do_res, the gains, w, b, gamma, dw,
    db, dgamma); 13 operations an element pre-norm (xhat, dxhat, the two row
    sums, dw, db, dx), 20 post-norm (the statistics, the gain and gamma and
    dgamma besides)."""
    el = 2 if dtype == "bfloat16" else 4
    m, c = launch.m, launch.c
    if name == "ln_bwd":
        return 13 * m * c, m * c * (3 * el + 4) + 8 * m + 12 * c
    return 20 * m * c, m * c * (8 + el) + 4 * (m // launch.rows_per_sample) \
        + 24 * c


def ln_library_call(name, args):
    """One PyTorch call that computes the LN backward on the same rows, a
    yardstick the port never calls: ``aten.native_layer_norm_backward``,
    pre-norm in the activation type (dy rounded to it, LN's scale and a zero
    shift in it; the residual line lies outside it), post-norm in f32 on
    the branch with do = gb * do_res (gamma outside it). Its mean and rstd
    come from ``native_layer_norm`` on the same rows."""
    import torch
    from vsn_tpu_torch.ops import swin_block_kernels as sbk

    if name == "ln_bwd":
        x, _, w, dy, _, _ = args
        grad, w = dy.to(x.dtype), w.to(x.dtype)
        b = torch.zeros_like(w)
    else:
        x, do_res, gains, rps, w, b, _ = args
        grad = sbk._gain_rows(gains, rps, x.shape[0]) * do_res.float()
    c = x.shape[1]
    _, mean, rstd = torch.ops.aten.native_layer_norm(x, [c], w, b, 1e-5)
    return lambda: torch.ops.aten.native_layer_norm_backward(
        grad, x, [c], mean, rstd, w, b, [True, True, True])


def ln_bwd_times(sets, device, card):
    """Per launch of each set {label: Counter(RowLaunch)}, bf16, in both
    modes: the launches' device ms (``launch_ms``: the rows and the sum,
    queued behind a spin kernel), the plain version's (``cuda_ms``),
    ``ln_library_call``'s (``launch_ms``) and the bound (``ln_bwd_work`` at
    the f32 rate); logged. Returns {(label, name): (ms, plain ms, (bound
    ms, by), library ms)} summed over the set's launches, each times the
    calls that make it in a micro-batch pass."""
    import torch

    gen = torch.Generator(device).manual_seed(SEED + 29)
    table = ln_bwd_table()
    out = {}
    for label, launches in sets.items():
        for name in LN_BWD_KERNELS:
            kernel, plain = table[name]
            tot = collections.Counter()
            for launch, times in launches.items():
                args = ln_bwd_call(name, launch, "bfloat16", device, gen)
                lib = ln_library_call(name, args)
                t = dict(ms=launch_ms(lambda: kernel(*args)),
                         plain=cuda_ms(lambda: plain(*args)),
                         library=launch_ms(lib))
                flops, nbytes = ln_bwd_work(name, launch)
                bound, by = work_bound_ms(flops, nbytes, "float32")
                log(f"[{card}] {name} {label} {launch.label} {launch.m}x"
                    f"{launch.c} (x{times} a micro-batch pass): "
                    f"{t['ms']:.4f} ms ({t['ms'] / bound:.2f}x the bound), "
                    f"plain {t['plain']:.4f} ms, native_layer_norm_backward"
                    f" {t['library']:.4f} ms, bound {bound:.4f} ms by {by} "
                    f"({nbytes / t['ms'] / 1e6:.0f} GB/s)")
                tot.update({k: times * v for k, v in (
                    *t.items(), ("flops", flops), ("bytes", nbytes))})
                del args, lib
            bound = work_bound_ms(tot["flops"], tot["bytes"], "float32")
            out[(label, name)] = (tot["ms"], tot["plain"], bound,
                                  tot["library"])
            log(f"[{card}] {name} {label}: {tot['ms']:.3f} ms per "
                f"micro-batch pass ({tot['ms'] / bound[0]:.2f}x the bound; "
                f"plain {tot['plain']:.3f} ms, native_layer_norm_backward "
                f"{tot['library']:.3f} ms, bound {bound[0]:.3f} ms by "
                f"{bound[1]})")
        torch.cuda.empty_cache()
    return out


def ln_bwd_entries(times, sets):
    """The result line's LN-backward entries {name: (ms, plain ms, (bound
    ms, by), library ms)}: ``ln_bwd_times``' sums added over every set of
    ``sets`` (the launches that ``ln_bwd_path`` counts), the bound that of
    the summed work."""
    out = {}
    for name in LN_BWD_KERNELS:
        per = [times[(label, name)] for label in sets]
        work = [sum(t * ln_bwd_work(name, launch)[i]
                    for launches in sets.values()
                    for launch, t in launches.items()) for i in (0, 1)]
        out[name] = (sum(p[0] for p in per), sum(p[1] for p in per),
                     work_bound_ms(*work, "float32"),
                     sum(p[3] for p in per))
    return out


def row_kernel_calls(launch):
    """The row kernels other than the LN backward (``sbk.ROW_KERNELS``) that
    the K1 / K2 call of ``launch`` makes in its training pass, by mode:
    [(kernel, what, shape)]: LN's rows and statistics in the pre-norm
    backward; the bias gradients' column sums (K1b's dbproj and K2b's dfc2_b
    over the gated do_res, K2b's dfc1_b over the f32 dh1 [M, hidden]); the
    post-norm forward's finish (K1f / K2f, post-norm arms); the pre-norm
    LayerScale gradients (K1b / K2b, the LayerScale arm) of proj [C, C] or
    fc2 [C, hidden]."""
    m, c, k1 = launch.m, launch.c, launch.label.startswith("K1")
    out = [("ln_rows", "LN rows", (m, c)),
           ("colsum", "dbproj" if k1 else "dfc2_b", (m, c, "gated")),
           ("postnorm_fwd", "post-norm forward", (m, c)),
           ("layerscale_grads", "proj" if k1 else "fc2",
            (c, c if k1 else launch.hidden))]
    if not k1:
        out.append(("colsum", "dfc1_b", (m, launch.hidden, "f32")))
    return out


def row_kernel_args(kname, shape, launch, device, gen, dtype="bfloat16"):
    """Seeded arguments of one row-kernel launch (``row_kernel_calls``).
    The post-norm forward's LN scale, shift and gamma and the LayerScale
    gradients' W are views 4 bytes into a buffer, as training's parameters
    are views into its flat parameter buffer."""
    import torch

    cdt = getattr(torch, dtype)
    z = lambda *s: torch.randn(*s, generator=gen, device=device)
    view = lambda v: torch.cat([v.new_zeros(1), v.flatten()])[1:].view(
        v.shape)
    rps = launch.rows_per_sample
    gains = torch.linspace(0.6, 1.4, launch.m // rps, device=device)
    if kname == "ln_rows":
        m, c = shape
        return (3 * z(m, c) + 1).to(cdt), 1 + 0.1 * z(c), 0.1 * z(c)
    if kname == "colsum":
        m, n, kind = shape
        if kind == "f32":
            return (z(m, n),)
        return z(m, n).to(cdt), gains, rps
    if kname == "postnorm_fwd":
        m, c = shape
        return (2 * z(m, c) - 0.5, z(m, c).to(cdt), view(1 + 0.1 * z(c)),
                view(0.1 * z(c)), view(0.5 + 0.1 * z(c)), gains, rps,
                PATH_LAM)
    n, k = shape
    return (view(k ** -0.5 * z(n, k)), 0.1 * z(n), 0.5 + 0.1 * z(n),
            z(n, k), z(n), z(n))


def row_kernel_work(kname, args):
    """(f32 operations, bytes) of one row-kernel launch: each input read
    once and each output written once."""
    if kname == "ln_rows":
        x = args[0]
        return 5 * x.numel(), 2 * _nbytes(x) + 8 * x.shape[0] + \
            _nbytes(*args[1:])
    if kname == "colsum":
        a = args[0]
        return 2 * a.numel(), _nbytes(*args[:2]) + 4 * a.shape[1]
    if kname == "postnorm_fwd":
        branch, x = args[:2]
        return 8 * x.numel(), _nbytes(branch) + 2 * _nbytes(x) + \
            _nbytes(*args[2:6])
    w = args[0]   # layerscale_grads: w and dw read, dw written
    return 3 * w.numel(), 3 * _nbytes(w) + 5 * _nbytes(args[1])


def row_shape_work(kname, shape, rows_per_sample, dtype="bfloat16"):
    """(f32 operations, bytes) of one row-kernel launch at its ``shape``
    (``row_kernel_calls``), as ``row_kernel_work`` counts them on its
    arguments."""
    el = 2 if dtype == "bfloat16" else 4
    if kname == "ln_rows":
        m, c = shape
        return 5 * m * c, 2 * m * c * el + 8 * m + 8 * c
    if kname == "postnorm_fwd":
        m, c = shape
        return 8 * m * c, m * c * (4 + 2 * el) + 12 * c + \
            4 * (m // rows_per_sample)
    if kname == "layerscale_grads":
        n, k = shape
        return 3 * n * k, 12 * n * k + 20 * n
    m, n, kind = shape
    if kind == "f32":
        return 2 * m * n, 4 * m * n + 4 * n
    return 2 * m * n, m * n * el + 4 * (m // rows_per_sample) + 4 * n


def row_library_call(kname, args):
    """The one PyTorch call computing a row kernel's function, a yardstick
    the port never calls (``native_layer_norm`` for LN's rows, in the
    activation type, ``Tensor.sum(0)`` for the column sums, without the
    gain), or None."""
    import torch

    if kname == "ln_rows":
        x, w, b = args
        return lambda: torch.ops.aten.native_layer_norm(
            x, [x.shape[1]], w.to(x.dtype), b.to(x.dtype), 1e-5)
    if kname == "colsum":
        return lambda: args[0].sum(0)
    return None


def row_timed_call(kname, args, kernel):
    """A call that launches row kernel ``kname`` on ``args``, for
    ``launch_ms``: its wrapper (``kernel``), but for the LayerScale
    gradients on the card, whose wrapper copies dw, db and dgamma before
    each launch: their C entry point on copies made once here, updated in
    place call after call (dw and db scaled by gamma each time)."""
    if kname != "layerscale_grads" or args[0].device.type != "cuda":
        return lambda: kernel(*args)
    from vsn_tpu_torch.ops import _build

    w, bias, gamma, dw, db, dgamma = args
    dw, db, dgamma = dw.clone(), db.clone(), dgamma.clone()
    n, k = w.shape
    lib, stream = _build.library(), _build.stream_of(w)

    def call():
        _build.check(lib.vsn_layerscale_grads(
            w.data_ptr(), bias.data_ptr(), gamma.data_ptr(), dw.data_ptr(),
            db.data_ptr(), dgamma.data_ptr(), n, k, stream),
            "layerscale_grads")
    return call


def row_table():
    """name -> (launch wrapper, plain version) of the row kernels besides
    the LN backward (``sbk.ROW_KERNELS``)."""
    from vsn_tpu_torch.ops import swin_block_kernels as sbk

    return dict(sbk.ROW_KERNELS)


def _row_outputs(fn, args):
    out = fn(*args)
    return out if isinstance(out, tuple) else (out,)


def row_compare(kname, args, table, dtype="bfloat16"):
    """One row-kernel launch against its plain version on the same
    arguments (a set of activation type ``dtype``): (the largest max|d| of
    its outputs, the largest as a share of its limit, whether a second
    launch gave the same bits in every output). bf16 outputs are held to
    TOL, f32 ones (the statistics, the column sums, f32 y) to LN_BWD_TOL,
    each relative to its scale."""
    import torch

    kernel, plain = table[kname]
    got = _row_outputs(kernel, args)
    again = _row_outputs(kernel, args)
    want = _row_outputs(plain, args)
    err_max = ratio_max = 0.0
    for g, w in zip(got, want):
        limit = (TOL["bfloat16"] if g.dtype == torch.bfloat16
                 else LN_BWD_TOL[dtype])
        err = (g.float() - w.float()).abs().max().item()
        if not math.isfinite(err):
            err = math.inf
        err_max = max(err_max, err)
        ratio_max = max(ratio_max, err / (limit * max(
            1.0, w.float().abs().max().item())))
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    return err_max, ratio_max, same


def row_parity_phase(sets, device, table=None, names=tuple(ROW_KERNEL_ENTRIES),
                     seed=SEED + 31):
    """Every launch of the row kernels ``names`` that the K1b / K2b calls of
    ``sets`` {label: (Counter(RowLaunch), dtype)} make (``row_kernel_calls``)
    against its plain version, and a second launch for the same bits
    (``row_compare``); logs each set's worst; raises naming the launches
    over their limit or whose bits differ. Returns {name: worst max|d|}."""
    import torch

    table = table or row_table()
    gen = torch.Generator(device).manual_seed(seed)
    worst, failed, unequal = dict.fromkeys(names, 0.0), [], []
    for label, (launches, dtype) in sets.items():
        ratios = dict.fromkeys(names, 0.0)
        for launch in launches:
            for kname, what, shape in row_kernel_calls(launch):
                if kname not in names:
                    continue
                args = row_kernel_args(kname, shape, launch, device, gen,
                                       dtype)
                err, ratio, same = row_compare(kname, args, table, dtype)
                worst[kname] = max(worst[kname], err)
                ratios[kname] = max(ratios[kname], ratio)
                where = f"{label} {kname} {launch.label} {what} {shape}"
                if not ratio <= 1.0:
                    failed.append(f"{where}: {ratio:.2f} of its limit")
                if not same:
                    unequal.append(where)
                del args
        log(f"row parity {label} ({dtype}): {len(launches)} launch shapes, "
            + ", ".join(f"{k} worst {v:.3f} of the limit"
                        for k, v in ratios.items())
            + ", two launches bit-equal" * (not unequal))
    if failed:
        raise AssertionError("row kernels disagree with their plain versions:"
                             f" {failed}")
    if unequal:
        raise AssertionError("row kernel launches differ between two runs on"
                             f" the same inputs: {unequal}")
    return worst


def row_path(sets, device, names=tuple(ROW_KERNEL_ENTRIES)):
    """Every launch of the row kernels ``names`` that the K1b / K2b calls of
    ``sets`` {label: Counter(RowLaunch)} make in a training micro-batch
    pass, as often as the pass makes it, through their wrappers, with every
    launch counter at 0 before: the counters after, which must be one per
    launch and nothing else."""
    import torch
    from vsn_tpu_torch.ops import _build

    gen = torch.Generator(device).manual_seed(SEED + 33)
    table = row_table()
    want = collections.Counter()
    _build.launches.clear()
    for launches in sets.values():
        for launch, times in launches.items():
            for kname, _, shape in row_kernel_calls(launch):
                if kname not in names:
                    continue
                args = row_kernel_args(kname, shape, launch, device, gen)
                for _ in range(times):
                    table[kname][0](*args)
                want[kname] += times
                del args
    torch.cuda.synchronize()
    counts = launch_counts()
    check_counts(counts, want, 1, "row path")
    return counts


def row_kernel_times(sets, device, card, names=None):
    """The row kernels other than the LN backward (``sbk.ROW_KERNELS``, or
    those of ``names``) at the calls of ``sets`` {label: Counter(RowLaunch)},
    bf16: each distinct launch once against its plain version (outputs in
    the activation type to TOL, f32 ones to LN_BWD_TOL of their scale), then
    its device ms (``launch_ms``), the plain version's, the library call's
    where one exists and the bound, with its launches a micro-batch pass in
    its mode; logged. Raises if a launch disagrees with its plain version.
    Returns {(label, kernel): Counter of ms, plain, library, flops, bytes
    and launches} summed over the set's launches, each times the calls that
    make it in a micro-batch pass."""
    import torch
    from vsn_tpu_torch.ops import swin_block_kernels as sbk

    gen = torch.Generator(device).manual_seed(SEED + 30)
    failed, out = [], {}
    for label, launches in sets.items():
        tot = collections.defaultdict(collections.Counter)
        for launch, times in launches.items():
            for kname, what, shape in row_kernel_calls(launch):
                if names is not None and kname not in names:
                    continue
                kernel, plain = sbk.ROW_KERNELS[kname]
                args = row_kernel_args(kname, shape, launch, device, gen)
                _, ratio, _ = row_compare(kname, args, sbk.ROW_KERNELS)
                if not ratio <= 1.0:
                    failed.append(f"{label} {kname} {launch.label} {what}: "
                                  f"{ratio:.2f} of its limit")
                lib = row_library_call(kname, args)
                t = dict(ms=launch_ms(row_timed_call(kname, args, kernel)),
                         plain=cuda_ms(lambda: plain(*args)),
                         library=launch_ms(lib) if lib else 0.0)
                flops, nbytes = row_kernel_work(kname, args)
                bound, by = work_bound_ms(flops, nbytes, "float32")
                lib_text = (f"{t['library']:.4f} ms" if lib
                            else "no single call")
                log(f"[{card}] row {kname} {label} {launch.label} {what} "
                    f"{shape} (x{times} a micro-batch pass in its mode): "
                    f"{t['ms']:.4f} ms ({t['ms'] / bound:.2f}x the bound), "
                    f"plain {t['plain']:.4f} ms, library {lib_text}, bound "
                    f"{bound:.4f} ms by {by}; worst {ratio:.3f} of the limit")
                tot[kname].update({k: times * v for k, v in (
                    *t.items(), ("flops", flops), ("bytes", nbytes),
                    ("launches", 1))})
                del args
        for kname, t in tot.items():
            bound = work_bound_ms(t["flops"], t["bytes"], "float32")
            lib = (f"{t['library']:.3f} ms" if t["library"]
                   else "no single call")
            log(f"[{card}] row {kname} {label}: {t['launches']} launches, "
                f"{t['ms']:.3f} ms per micro-batch pass in its mode "
                f"({t['ms'] / bound[0]:.2f}x the bound; plain "
                f"{t['plain']:.3f} ms, library {lib}, bound {bound[0]:.3f} "
                f"ms by {bound[1]})")
            out[(label, kname)] = t
        torch.cuda.empty_cache()
    if failed:
        raise AssertionError("row kernels disagree with their plain versions:"
                             f" {failed}")
    return out


def row_entries(times, sets, names=tuple(ROW_KERNEL_ENTRIES)):
    """The result line's entries of the row kernels ``names`` {name: (ms,
    plain ms, (bound ms, by), library ms or None where no single call
    computes the function)}: ``row_kernel_times``' sums added over every set
    of ``sets`` (the launches that ``row_path`` counts), the bound that of
    the summed work."""
    out = {}
    for name in names:
        tot = sum((times[(label, name)] for label in sets),
                  collections.Counter())
        out[name] = (tot["ms"], tot["plain"],
                     work_bound_ms(tot["flops"], tot["bytes"], "float32"),
                     tot["library"] or None)
    return out


def wide_calls(device, gen, c, heads, dtype="bfloat16"):
    """A K1 and a K2 call [(name, args)] of width ``c`` over Swin-T's
    stage-4 rows at micro-batch 8 (WIDE_WINDOWS windows of WIDE_N tokens, one
    a sample, unshifted: no region ids), x = z in ``dtype``, with the seeded
    parameters and gains of ``seeded_params`` (an O(1) relative-position
    bias; K2's hidden width 4C)."""
    import torch

    x = torch.randn(WIDE_WINDOWS, WIDE_N, c, generator=gen).to(
        device, getattr(torch, dtype))
    gains = torch.ones(WIDE_WINDOWS, device=device)
    none = torch.empty(0)
    k1 = (x, None, None, None, none, torch.empty(heads, WIDE_N, WIDE_N), None,
          None, None, gains, gains, (c // heads) ** -0.5, heads)
    k2 = (x.reshape(-1, c), None, None, torch.empty(4 * c, 0), None, None,
          None, gains, gains)
    return [("attn_half", seeded_params("attn_half", k1, gen)),
            ("ln_mlp", seeded_params("ln_mlp", k2, gen))]


def wide_row_phase(device, gen, table=None):
    """K1 and K2 at the wide rows (``WIDE_ROWS``, ``wide_calls``), bf16,
    in the default mode and post-norm + LayerScale at lam PATH_LAM: every
    gradient of one seeded cotangent through the kernels (K1b / K2b: LN's
    rows, the column sums and the LN backward at these widths) against the
    plain route, each to TOL of its scale (``grad_compare``); logged;
    raises naming the gradients over their limit. Returns {backward kernel
    name: worst max|d|}."""
    import torch

    table = table or kernel_table()
    worst, failed = collections.defaultdict(float), []
    for c, heads in WIDE_ROWS:
        for name, args in wide_calls(device, gen, c, heads):
            kernel, plain = table[name]
            for mode, post_norm in (("", False), ("_post_ls", True)):
                gamma = seeded_gamma(args[0], gen) if post_norm else None
                rows = grad_compare(name, kernel, plain, args, PATH_LAM, gen,
                                    gamma, post_norm)
                ratio = max(err / limit for _, err, limit, _ in rows)
                bad = [g for g, _, _, ok in rows if not ok]
                worst[backward_name(name)] = max(
                    worst[backward_name(name)], *(e for _, e, _, _ in rows))
                log(f"wide rows C={c} {backward_name(name)}{mode} "
                    f"({args[0].numel() // c} rows): {len(rows)} grads, worst"
                    f" {ratio:.3f} of the limit {'ok' if not bad else 'FAIL'}")
                if bad:
                    failed.append(f"C={c} {backward_name(name)}{mode}: {bad}")
        torch.cuda.empty_cache()
    if failed:
        raise AssertionError("backward kernels disagree with their plain "
                             f"versions at the wide rows: {failed}")
    return dict(worst)


# ---------------------------------------------------------------------------
# The paths without a kernel: Swin's attention dropout, ViT's unfused
# halves, MedViT-3D, the stabilizers on unfused blocks (phases 19a-19d)
# ---------------------------------------------------------------------------

def branch_calls(model, images, generator):
    """The XLA attention branch's calls of one training forward of a Swin
    with ATTENTION_DROPOUT > 0 (models/swin3d.py WindowAttention3D.
    attention): [(attention module, qkv, ids)] in block order. No graph is
    kept."""
    import torch
    from vsn_tpu_torch.models import swin3d

    calls = []
    real = swin3d.WindowAttention3D.attention

    def record(attn, qkv, ids, mask=None):
        calls.append((attn, qkv, ids))
        return real(attn, qkv, ids, mask)

    with torch.no_grad(), mock.patch.object(swin3d.WindowAttention3D,
                                            "attention", record):
        model(images, generator=generator)
    return calls


def branch_cases(qkv, ids):
    """A branch call's cases: its region ids (shifted, padded with -1 pad
    ids, none) and its N."""
    kind = ("no mask" if ids is None else "padded ids"
            if bool((ids < 0).any()) else "shifted ids")
    return {kind, f"N={qkv.shape[1]}"}


def branch_gate(calls, gen, required=BRANCH_CASES):
    """Hold the XLA attention branch with no keep mask against K4 on the
    same values, call by call: qkv replaced by a seeded unit normal (O(1)
    logits) and the bias by z, ``WindowAttention3D.attention`` (f32 scores
    and softmax, the region mask at -100) against K4's launch
    (``window_attention_qkv``, -1e9) under K4's gate: TOL of its largest
    output in the activation type. Every launch counter at 0 before and
    exactly one K4 launch per call after. Returns the worst error over its
    limit; raises past 1 or where a case is missing."""
    import torch
    from vsn_tpu_torch.ops import _build
    from vsn_tpu_torch.ops.window_attention import window_attention_qkv

    _build.launches.clear()
    worst, kinds = 0.0, set()
    with torch.no_grad():
        for attn, qkv, ids in calls:
            q = torch.randn(qkv.shape, generator=gen).to(qkv)
            bias = torch.randn(attn.bias().shape, generator=gen).to(
                qkv.device)
            with mock.patch.object(attn, "bias", lambda: bias):
                got = attn.attention(q, ids).float()
            k4_ids = ids if ids is not None else torch.zeros(
                (1, q.shape[1]), dtype=torch.int32, device=q.device)
            want = window_attention_qkv(q, bias, k4_ids, attn.scale,
                                        attn.num_heads).float()
            limit = TOL[str(q.dtype).removeprefix("torch.")]
            err = (got - want).abs().max().item() / want.abs().max().item()
            worst = max(worst, err / limit)
            kinds |= branch_cases(q, ids)
            if not err <= limit:
                raise AssertionError(
                    f"XLA branch vs K4 on a {tuple(q.shape)} call "
                    f"({branch_cases(q, ids)}): {err:.3e} > {limit}")
    check_counts(launch_counts(), {"attention": 1}, len(calls),
                 "branch gate")
    if not required <= kinds:
        raise AssertionError(f"branch gate lacks cases {required - kinds}")
    return worst


def stage_keep_shares(model, draws):
    """The kept share of the attention keep masks of each Swin stage in
    one forward's ``draws`` (the model's ``draw_plan`` order)."""
    blocks, out = model.blocks(), {}
    stage_of = {id(blk): i for i, layer in enumerate(model.backbone.layers)
                for blk in layer.blocks}
    for (key, _), got in zip(model.draw_plan(1), draws):
        if key[1:] == ("attn",):
            kept, n = out.get(stage_of[id(blocks[key[0]])], (0, 0))
            out[stage_of[id(blocks[key[0]])]] = (
                kept + int(got.sum().item()), n + got.numel())
    return {stage: kept / n for stage, (kept, n) in sorted(out.items())}


def short_train_path(cfg, batch, per_pass, label, card, plain=None,
                     profile=False):
    """SHORT_STEPS train steps of a model of ``cfg`` with seeded weights
    (``seeded_model``) on ``batch`` with injected
    ``Draws``: every launch counter at 0 before and exactly ``per_pass``
    times the passes after (0 for a path without kernels), losses and grad
    norms finite and nothing skipped (``check_train_metrics``); the rate
    from the steps after the first, and the peak memory. With ``plain``, a
    context manager, as many steps from the same initial state on the same
    draws under it, held to TRAIN_RTOL. With ``profile``, one more step
    under the profiler (``profile_phase``). Returns (metrics, the
    model)."""
    import torch
    from vsn_tpu_torch.ops import _build
    from vsn_tpu_torch.train.step import init_train_state

    sync, steps = torch.cuda.synchronize, SHORT_STEPS
    torch.cuda.reset_peak_memory_stats()
    micro = cfg.BATCH_SIZE
    model = seeded_model(cfg)
    state = init_train_state(cfg, model)
    initial = state.params.flat.clone()
    draws = Draws(model, micro, batch["image"].device, SEED)
    _build.launches.clear()
    metrics, secs = train_route(model, cfg, state, batch, draws, steps, sync)
    counts = launch_counts()
    passes = steps * TRAIN_ACCUM * (2 if cfg.USE_SAM else 1)
    log(f"{label} path: {steps} steps of {TRAIN_ACCUM} x {micro} volumes, "
        f"launches { {k: v for k, v in counts.items() if v} }")
    check_counts(counts, per_pass, passes, label)
    peak = torch.cuda.max_memory_allocated()
    if profile:
        profile_phase(lambda: train_route(model, cfg, state, batch, draws, 1,
                                          sync), label, "step", 1, card)
    if plain is None:
        check_train_metrics(metrics, [])
    else:
        with torch.no_grad():
            state.params.flat.copy_(initial)
        del state
        pstate = init_train_state(cfg, model)
        with plain():
            plain_metrics, _ = train_route(model, cfg, pstate, batch, draws,
                                           steps, sync)
        del pstate
        rel = check_train_metrics(metrics, plain_metrics)
        log(f"{label} path vs plain route: worst rel loss {rel['loss']:.3e} "
            f"(<= {TRAIN_RTOL['loss']}), grad_norm {rel['grad_norm']:.3e} "
            f"(<= {TRAIN_RTOL['grad_norm']})")
    vols = TRAIN_ACCUM * micro
    for i, (m, t) in enumerate(zip(metrics, secs)):
        log(f"{label} step {i}: loss {m['loss']:.5f}, grad_norm "
            f"{m['grad_norm']:.5f}, {1e3 * t:.1f} ms")
    rate = vols * (steps - 1) / sum(secs[1:])
    log(f"[{card}] {label}: {rate:.2f} vol/s (the steps after the first, "
        f"{vols} volumes a step, SAM: 2 passes), first step "
        f"{1e3 * secs[0]:.1f} ms; peak memory {peak / 2**30:.3f} GiB")
    return metrics, model


@contextmanager
def unfused_vit_attention():
    """Every ViT attention half unfused (``fused_attn_gate`` false): the
    LayerNorm model's attention on the plain branch, its MLP on K2."""
    from vsn_tpu_torch.models import vit3d

    with mock.patch.object(vit3d, "fused_attn_gate",
                           lambda *args, **kwargs: False):
        yield


def vit_unfused_gate(cfg, train_cfg, images, batch, card):
    """The LayerNorm ViT-S's attention half unfused (no masks) against its
    fused K1 half on the same weights, volumes and gains: eval probs within
    1e-2 (``compare_probs``), one batch's logits within TOL of the largest
    |logit| (``compare_logits``), one training step from the same state on
    the same draws within TRAIN_RTOL."""
    import torch
    from vsn_tpu_torch.eval.evaluate import Evaluator
    from vsn_tpu_torch.train.step import init_train_state

    model = seeded_model(cfg)
    evaluator = Evaluator(cfg, model, batch_size=BATCH)
    probs = evaluator.predict(images)
    with unfused_vit_attention():
        probs_unfused = evaluator.predict(images)
    compare_probs("vit unfused attention (probs: K1's; plain: the branch)",
                  probs, probs_unfused)
    x = torch.from_numpy(images[:BATCH]).to(evaluator.device)
    compare_logits("vit unfused attention", model, evaluator.transform(x),
                   unfused_vit_attention)
    del model, evaluator
    model = seeded_model(train_cfg)
    state = init_train_state(train_cfg, model)
    initial = state.params.flat.clone()
    draws = Draws(model, train_cfg.BATCH_SIZE, batch["image"].device, SEED)
    fused, _ = train_route(model, train_cfg, state, batch, draws, 1,
                           torch.cuda.synchronize)
    with torch.no_grad():
        state.params.flat.copy_(initial)
    del state
    state = init_train_state(train_cfg, model)
    with unfused_vit_attention():
        unfused, _ = train_route(model, train_cfg, state, batch, draws, 1,
                                 torch.cuda.synchronize)
    rel = check_train_metrics(fused, unfused)
    log(f"vit unfused attention vs K1, a step: loss {unfused[0]['loss']:.5f}"
        f" / {fused[0]['loss']:.5f} (rel {rel['loss']:.3e} <= "
        f"{TRAIN_RTOL['loss']}), grad_norm {unfused[0]['grad_norm']:.5f} / "
        f"{fused[0]['grad_norm']:.5f} (rel {rel['grad_norm']:.3e} <= "
        f"{TRAIN_RTOL['grad_norm']})")
    return rel


def medvit_step_outputs(model, x, labels, draws):
    """One f32 training micro-step of a MedViT: (loss, {name: gradient},
    the updated statistics); the model's statistics are left as they
    were."""
    import torch
    from vsn_tpu_torch.train.losses import label_smoothing_loss

    before = {k: v.clone() for k, v in model.state_dict().items()
              if "running" in k}
    model.train()
    model.zero_grad()
    loss = label_smoothing_loss(model(x, draws=draws), labels, 0.1)
    loss.backward()
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
    stats = {k: v.clone() for k, v in model.state_dict().items()
             if "running" in k}
    model.load_state_dict(before, strict=False)
    model.eval()
    return loss.detach(), grads, stats


def medvit_f32_gate(card_model, cpu_model, x, labels, draws_of):
    """A MedViT's f32 eval logits and one f32 training micro-step on the
    card (TF32 off) against the CPU's, on the same weights, volumes and
    draws (``draws_of(device)``): logits within MEDVIT_F32["logits"] of the
    largest |logit|, the loss within MEDVIT_F32["loss"] (relative), all
    gradients together within MEDVIT_F32["grads"] (the norm of the
    difference over the norm), each element within MEDVIT_F32["grad_max"]
    of the largest gradient, every updated statistic within
    MEDVIT_F32["stats"] of its BatchNorm's largest (PERF.md says why).
    Returns each error over its limit; raises past 1."""
    import torch

    dev = next(card_model.parameters()).device
    with torch.no_grad():
        got = card_model.eval()(x.to(dev)).cpu()
        want = cpu_model.eval()(x.cpu())
    errs = {"logits": (got - want).abs().max().item()
            / want.abs().max().item()}
    loss, grads, stats = medvit_step_outputs(card_model, x.to(dev),
                                             labels.to(dev), draws_of(dev))
    wloss, wgrads, wstats = medvit_step_outputs(
        cpu_model, x.cpu(), labels.cpu(), draws_of(torch.device("cpu")))
    errs["loss"] = abs(loss.item() - wloss.item()) / abs(wloss.item())
    diff = {n: grads[n].cpu() - g for n, g in wgrads.items()}
    errs["grads"] = math.sqrt(
        sum(d.square().sum().item() for d in diff.values())
        / sum(g.square().sum().item() for g in wgrads.values()))
    gscale = max(g.abs().max().item() for g in wgrads.values())
    leaf = max(diff, key=lambda n: diff[n].abs().max().item())
    errs["grad_max"] = diff[leaf].abs().max().item() / gscale
    errs["stats"] = max(
        (stats[n].cpu() - w).abs().max().item()
        / wstats[n.rsplit(".", 1)[0] + ".running_var"].max().item() ** (
            0.5 if n.endswith("mean") else 1.0)
        for n, w in wstats.items())
    worst = {k: e / MEDVIT_F32[k] for k, e in errs.items()}
    log("medvit f32 card vs CPU: " + ", ".join(
        f"{k} {e:.3e} (<= {MEDVIT_F32[k]})" for k, e in errs.items())
        + f"; the largest gradient difference in {leaf}")
    if max(worst.values()) > 1:
        raise AssertionError(f"medvit f32 card vs CPU past the limits: {errs}")
    return worst


def medvit_bf16_gate(model, model32, images, cfg):
    """The card's bf16 MedViT eval against its f32 eval (same weights and
    statistics): probs within 1e-2 (``compare_probs``), one batch's logits
    within TOL["bfloat16"] of the largest f32 |logit|."""
    import torch
    from vsn_tpu_torch.eval.evaluate import Evaluator

    ev, ev32 = (Evaluator(cfg, m, batch_size=BATCH) for m in (model, model32))
    compare_probs("medvit bf16 eval (plain: the f32 eval)",
                  ev.predict(images), ev32.predict(images))
    x = ev.transform(torch.from_numpy(images[:BATCH]).to(ev.device))
    with torch.inference_mode():
        got, want = model(x).float(), model32(x).float()
    err, scale = (got - want).abs().max().item(), want.abs().max().item()
    log(f"medvit bf16 eval logits vs f32: max|d| {err:.3e} of max|logit| "
        f"{scale:.3e} (<= {TOL['bfloat16']} of it)")
    if not err <= TOL["bfloat16"] * scale:
        raise AssertionError(f"medvit bf16 logits differ from f32 by {err}")
    return err / scale / TOL["bfloat16"]


def unfused_paths(device, card, images, train_cfg, vit_cfg, vit_train_cfg):
    """Phases 19a-19d: Swin-T training with ATTENTION_DROPOUT (the XLA
    branch, its gate against K4, the keep masks' shares), ViT-S's unfused
    arms and the gate of its unfused attention half against K1, the
    stabilizers on unfused blocks, MedViT-S 5c (eval after a BN refresh,
    the f32 gate against the CPU and the bf16 gate, training); ``images``
    are the eval volumes, the configs the flagship Swin and ViT ones."""
    import torch
    from vsn_tpu_torch.config import load_config
    from vsn_tpu_torch.eval.evaluate import Evaluator
    from vsn_tpu_torch.models import build_model
    from vsn_tpu_torch.train.step import make_batch_transform

    # 19a. Swin-T training with ATTENTION_DROPOUT: the XLA branch ----------
    adrop_cfg = train_cfg.replace(ATTENTION_DROPOUT=ATTN_DROPOUT)
    batch = train_batch(train_cfg, device, SEED + 5)   # phase 12's
    model = seeded_model(adrop_cfg).train()
    x = make_batch_transform(adrop_cfg)(
        {k: v[0] for k, v in batch.items()})[0].to(torch.bfloat16)
    calls = branch_calls(model, x, torch.Generator(device).manual_seed(7))
    branch_worst = branch_gate(calls, torch.Generator().manual_seed(SEED + 33))
    log(f"attention-dropout branch vs K4: {len(calls)} calls of a training "
        f"micro-batch of {TRAIN_MICRO} (no keep mask, qkv and bias z, cases "
        f"{sorted(BRANCH_CASES)}), worst {branch_worst:.3f} of the limit")
    shares = stage_keep_shares(model, Draws(model, TRAIN_MICRO, device,
                                            SEED)(0, 0, 0))
    log(f"attention-dropout keep masks of one forward, kept share by stage: "
        f"{ {st: round(sh, 6) for st, sh in shares.items()} } (within "
        f"{KEEP_RTOL:.0e} of {1 - ATTN_DROPOUT} relative)")
    if any(abs(sh / (1 - ATTN_DROPOUT) - 1) > KEEP_RTOL
           for sh in shares.values()):
        raise AssertionError(f"attention keep shares {shares}")
    del model, calls, x
    torch.cuda.empty_cache()
    short_train_path(adrop_cfg, batch, {}, "swin_attn_dropout_train", card)
    torch.cuda.empty_cache()

    # 19b. ViT-S's unfused arms, and the unfused half against K1 -----------
    vit_batch = train_batch(vit_train_cfg, device, SEED + 14)   # phase 16's
    for arm, (over, per_forward, per_pass) in VIT_UNFUSED_ARMS.items():
        if per_forward is not None:
            acfg = vit_cfg.replace(**over)
            model_eval_path(acfg, seeded_model(acfg), images, per_forward,
                            f"{arm}_eval", card)
        short_train_path(vit_train_cfg.replace(**over), vit_batch, per_pass,
                         f"{arm}_train", card)
        torch.cuda.empty_cache()
    vit_gate = vit_unfused_gate(vit_cfg, vit_train_cfg, images, vit_batch,
                                card)
    torch.cuda.empty_cache()

    # 19d. the stabilizers on unfused blocks (DynamicTanh) ----------------
    plain = lambda: patched_model_ops(lambda name, kernel, p: p)
    short_train_path(train_cfg.replace(**UNFUSED_STABILIZERS), batch,
                     DYT_PER_PASS, "swin_dyt_stabilizers_train", card,
                     plain=plain)
    short_train_path(vit_train_cfg.replace(**UNFUSED_STABILIZERS), vit_batch,
                     {}, "vit_dyt_stabilizers_train", card)
    del batch, vit_batch
    torch.cuda.empty_cache()

    # 19c. MedViT-S 5c: eval, the f32 and bf16 gates, training ------------
    mcfg = load_config(preset=MEDVIT_PRESET)
    mtrain_cfg = load_config(dict(
        USE_SAM=True, USE_EMA=True, USE_MIXUP=True, MIXUP_PROB=0.5,
        USE_SHAKEDROP=True, LABEL_SMOOTHING=0.1, SEED=SEED,
        BATCH_SIZE=MEDVIT_MICRO, EFFECTIVE_BATCH_SIZE=MEDVIT_MICRO *
        TRAIN_ACCUM), preset=MEDVIT_PRESET)
    model = seeded_model(mcfg)
    refresh_statistics(model, mcfg, volumes(2 * BATCH, seed=SEED + 7), BATCH)
    model_eval_path(mcfg, model, images, {}, "medvit_eval", card)
    cfg32 = mcfg.replace(FP16=False)
    model32 = build_model(cfg32)
    model32.load_state_dict(model.state_dict(), strict=True)
    medvit_bf16 = medvit_bf16_gate(model, model32, images, mcfg)
    del model
    cpu32 = build_model(cfg32, device="cpu")
    cpu32.load_state_dict(model32.state_dict(), strict=True)
    x = Evaluator(cfg32, model32, batch_size=2).transform(
        torch.from_numpy(images[:2]).to(device)).float()
    labels = torch.eye(mcfg.num_classes)[[0, 1]]
    gains = model32.draw(2, torch.device("cpu"),
                         torch.Generator().manual_seed(SEED + 34))
    medvit_f32 = medvit_f32_gate(
        model32, cpu32, x, labels,
        lambda dev: [tuple(g.to(dev) for g in pair) for pair in gains])
    medvit_stem_f64(model32, x, labels.to(device),
                    [tuple(g.to(device) for g in pair) for pair in gains],
                    card)
    del model32, cpu32, x
    torch.cuda.empty_cache()
    mbatch = train_batch(mtrain_cfg, device, SEED + 35)
    short_train_path(mtrain_cfg, mbatch, {}, "medvit_train", card,
                     profile=True)
    del mbatch
    torch.cuda.empty_cache()
    log(f"phases 19a-19d: the branch gate {branch_worst:.3f}, the ViT gate "
        f"loss {vit_gate['loss'] / TRAIN_RTOL['loss']:.3f} / grad_norm "
        f"{vit_gate['grad_norm'] / TRAIN_RTOL['grad_norm']:.3f}, MedViT f32 "
        f"{max(medvit_f32.values()):.3f}, bf16 {medvit_bf16:.3f} of their "
        "limits")


# ---------------------------------------------------------------------------
# The uncertainty eval chain, USE_PALLAS_ATTENTION off, MedViT's stem in f64
# ---------------------------------------------------------------------------

def chain_cohort(root, cfg, n_subjects=CHAIN_SUBJECTS,
                 od_subjects=CHAIN_OD_SUBJECTS):
    """The eval chain's cohorts, by the port's ``generate_synthetic_dataset``
    at raw shape IMG_SIZE: the fold CSVs' directory, and one out-of-domain
    CSV of a second cohort whose subjects are renamed ``od-*`` (the
    generator names every cohort's subjects synth-NNNN, and the volume
    cache is keyed by subject)."""
    from vsn_tpu_torch.data.folds import read_csv, write_csv
    from vsn_tpu_torch.data.synthetic import generate_synthetic_dataset

    shape, diseases = tuple(cfg.IMG_SIZE), tuple(cfg.DISEASES)
    _, csv_dir = generate_synthetic_dataset(
        root / "cohort", n_subjects, shape, diseases, int(cfg.KFOLD), SEED)
    _, od_dir = generate_synthetic_dataset(
        root / "od_cohort", od_subjects, shape, diseases, 1, SEED + 1, "OD")
    rows = [{**r, "Subject": "od-" + r["Subject"]}
            for r in read_csv(od_dir / "fold_0.csv")]
    write_csv(rows, root / "od.csv")
    return csv_dir, root / "od.csv"


def read_predictions(path, diseases):
    """(rows, probs [N, K]) of a prediction CSV, its probabilities finite
    and each row's within CHAIN_SUM_TOL of 1."""
    from vsn_tpu_torch.data.folds import read_csv

    rows = read_csv(path)
    probs = np.array([[float(r[f"pred_{d}"]) for d in diseases]
                      for r in rows]).reshape(len(rows), len(diseases))
    check_probs(probs, len(rows), len(diseases))
    err = float(np.abs(probs.sum(1) - 1).max()) if len(rows) else 0.0
    if not len(rows) or err > CHAIN_SUM_TOL:
        raise AssertionError(f"{path.name}: {len(rows)} rows, probabilities "
                             f"sum to 1 within {err}")
    return rows, probs


def _sync(device):
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def eval_chain_phase(cfg, root, card, device, per_forward=PER_FORWARD,
                     n_bootstrap=CHAIN_BOOTSTRAP):
    """Phase 20a: the uncertainty eval chain through its entry points on a
    model of ``cfg`` with seeded weights. A synthetic cohort and an OD
    cohort (``chain_cohort``); a checkpoint in the JAX package's format
    (``save_checkpoint`` of ``jax_params_from_state_dict``) whose loaded
    model's logits equal the saved model's bit for bit; ``evaluate_
    checkpoint`` plain, then with TTA (its batch at the default cap of
    TTA_CAP volumes, which the OD cohort fills), each with every counter
    at 0 before and ``per_forward`` launches per batch after, its peak
    memory, its prediction CSVs and metrics JSON read back; one TTA batch
    of the OD cohort at the cap (``predict``, TTA_CAP x 8 views), timed,
    with its launches and peak memory; its probabilities against the
    plain route's (kernels off) on the same views and draws
    (``compare_probs``), and the logits of its views (``compare_logits``);
    the card's warp against the CPU's on one volume within WARP_TOL of its
    scale; plain and TTA eval vol/s and each stage's seconds (the warp and
    the forward of that TTA batch apart). Files under ``root``."""
    import shutil

    import torch
    from vsn_tpu_torch.convert import jax_params_from_state_dict
    from vsn_tpu_torch.data.augment import affine_warp_matmul
    from vsn_tpu_torch.data.folds import get_train_val_test, read_csv
    from vsn_tpu_torch.data.pipeline import InMemoryDataset
    from vsn_tpu_torch.eval import evaluate as ev
    from vsn_tpu_torch.eval.tta import make_tta_views
    from vsn_tpu_torch.ops import _build
    from vsn_tpu_torch.train.checkpoint import save_checkpoint

    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    diseases = list(cfg.DISEASES)
    t0 = time.perf_counter()
    csv_dir, od_csv = chain_cohort(root, cfg)
    cohort_s = time.perf_counter() - t0
    model = seeded_model(cfg, device)
    ckpt = root / "model_chip_0_best0.ckpt"
    t0 = time.perf_counter()
    save_checkpoint(ckpt, {"variables": jax_params_from_state_dict(
        model.state_dict())}, {"config": dict(cfg), "fold": cfg.FOLD})
    save_s = time.perf_counter() - t0
    _, loaded, _, _ = ev.load_model_from_checkpoint(ckpt, device)
    x = torch.from_numpy(volumes(2, seed=SEED + 40)).to(device)
    x = ev.Evaluator(cfg, model).transform(x)
    with torch.inference_mode():
        if not torch.equal(model(x), loaded(x)):
            raise AssertionError("eval chain: the loaded checkpoint's logits "
                                 "differ from the saved model's")
    log(f"eval chain: cohort of {CHAIN_SUBJECTS} + {CHAIN_OD_SUBJECTS} "
        f"subjects at {tuple(cfg.IMG_SIZE)} in {cohort_s:.1f} s; checkpoint "
        f"{ckpt.stat().st_size / 1e6:.1f} MB written in {save_s:.2f} s; the "
        "loaded model's logits equal the saved model's bit for bit")
    del loaded, x
    n_val = len(get_train_val_test(csv_dir, cfg.FOLD, cfg.KFOLD,
                                   tuple(cfg.SPLIT))[1])
    cuda = torch.device(device).type == "cuda"

    def peak_gib():
        return torch.cuda.max_memory_allocated() / 2**30 if cuda else 0.0

    n_vols = {}
    for label, tta in (("plain", False), ("tta", True)):
        out = root / label
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        _build.launches.clear()
        res = ev.evaluate_checkpoint(
            ckpt, csv_dir, root / "cache", out, eval_csv=str(od_csv),
            use_tta=tta, n_bootstrap=n_bootstrap, skip_if_exists=False,
            device=device)
        _sync(device)
        counts = launch_counts()
        stem = ckpt.stem
        rows_id, _ = read_predictions(out / f"prediction_{stem}_id.csv",
                                      diseases)
        rows_od, _ = read_predictions(out / f"prediction_{stem}_od.csv",
                                      diseases)
        metrics = json.loads((out / f"metrics_{stem}.json").read_text())
        if set(metrics) != {"checkpoint", "fold", "use_tta", "model_index",
                            "val", "test_id", "test_od"} or (
                metrics["use_tta"] is not tta):
            raise AssertionError(f"eval chain {label}: metrics keys "
                                 f"{sorted(metrics)}")
        for split in ("val", "test_id", "test_od"):
            ece = metrics[split]["ece"]
            if not all(math.isfinite(ece[k]) for k in ("mean", "lower",
                                                       "upper")):
                raise AssertionError(f"eval chain {label}: {split} ECE {ece}")
        sizes = [n_val, len(rows_id), len(rows_od)]
        batch = ev.Evaluator(cfg, model, use_tta=tta).batch_size
        if tta and (batch != TTA_CAP or len(rows_od) < batch):
            raise AssertionError(
                f"eval chain tta: batch {batch}, OD cohort {len(rows_od)}: "
                f"no batch at the default cap of {TTA_CAP} volumes")
        n_batches = sum(-(-n // max(1, min(batch, n))) for n in sizes)
        check_counts(counts, per_forward, n_batches, f"eval chain {label}")
        n_vols[label] = sum(sizes)
        secs = res["seconds"]
        log(f"[{card}] eval chain {label}: {n_vols[label]} volumes "
            f"(val, test, OD: {sizes}) in {n_batches} batches, "
            f"{n_vols[label] / secs['predict']:.2f} vol/s through "
            f"evaluate_checkpoint's predict stage; stages (s): "
            + ", ".join(f"{k} {v:.3f}" for k, v in secs.items())
            + f"; launches {dict((k, v) for k, v in counts.items() if v)}; "
            f"peak memory {peak_gib():.2f} GiB; "
            f"test ECE {metrics['test_id']['ece']['mean']:.4f}")
    # one TTA batch of the OD cohort at the cap, then the plain route on the
    # same views and draws
    images = InMemoryDataset(root / "cache", read_csv(od_csv),
                             diseases).images[:TTA_CAP]
    tta_ev = ev.Evaluator(cfg, model, use_tta=True, seed=SEED)
    rows = len(images) * tta_ev.n_views
    secs = []
    for _ in range(3):
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        _sync(device)
        _build.launches.clear()
        t0 = time.perf_counter()
        probs = tta_ev.predict(images)
        _sync(device)
        secs.append(time.perf_counter() - t0)
        check_counts(launch_counts(), per_forward, 1,
                     f"eval chain TTA batch of {rows} rows")
    log(f"[{card}] eval chain TTA batch at the cap: {len(images)} volumes x "
        f"{tta_ev.n_views} views = {rows} rows a forward, predict "
        + " / ".join(f"{1e3 * t:.1f}" for t in secs) + " ms, "
        + " / ".join(f"{len(images) / t:.2f}" for t in secs)
        + f" vol/s; peak memory {peak_gib():.2f} GiB")
    with patched_model_ops(lambda name, kernel, plain: plain):
        plain = tta_ev.predict(images)
    compare_probs("eval chain TTA", probs, plain)
    views_fn, n_views = make_tta_views()
    x = torch.from_numpy(images).to(device)
    flat = views_fn(x, torch.Generator().manual_seed(SEED))
    flat = tta_ev.transform(flat.reshape(-1, *flat.shape[2:]))
    compare_logits("eval chain TTA views", model, flat,
                   lambda: patched_model_ops(lambda name, kernel, p: p))
    del flat
    # the card's warp against the CPU's on one volume
    vol = torch.from_numpy(images[:1, ..., 0].astype(np.float32))
    g = torch.Generator().manual_seed(SEED + 41)
    angles = (torch.rand(1, 3, generator=g) * 2 - 1) * math.radians(3.0)
    trans = (torch.rand(1, 3, generator=g) * 2 - 1) * 5.0
    got = affine_warp_matmul(vol.to(device), angles, trans).cpu()
    want = affine_warp_matmul(vol, angles, trans)
    scale = vol.abs().max().item()
    err = (got - want).abs().max().item()
    log(f"eval chain warp, card vs CPU: max|d| {err:.3e} of max|volume| "
        f"{scale:.3e} (<= {WARP_TOL} of it)")
    if not err <= WARP_TOL * scale:
        raise AssertionError(f"eval chain: the card's warp differs from the "
                             f"CPU's by {err} (max|volume| {scale})")
    # one TTA batch's warp and forward apart
    split = {"warp": [], "forward": []}
    for _ in range(3):
        _sync(device)
        t0 = time.perf_counter()
        views = views_fn(x, torch.Generator().manual_seed(SEED))
        _sync(device)
        t1 = time.perf_counter()
        flat = views.reshape(-1, *views.shape[2:])
        tta_ev.eval_step(tta_ev.transform(flat))
        _sync(device)
        split["warp"].append(t1 - t0)
        split["forward"].append(time.perf_counter() - t1)
    log(f"[{card}] eval chain TTA batch of {len(images)} volumes x "
        f"{n_views} views: views (flip, {n_views - 3} warps, crop-resize) "
        + " / ".join(f"{1e3 * t:.1f}" for t in split["warp"])
        + " ms, transform + forward + softmax "
        + " / ".join(f"{1e3 * t:.1f}" for t in split["forward"]) + " ms")
    del model, tta_ev, x
    return n_vols


def flag_off_phase(cfg, images, card, device):
    """Phase 20b: eval of ``images`` at batch BATCH with USE_PALLAS_ATTENTION
    off: with every counter at 0 before, no launch after (every block on
    the XLA branch); probs within 1e-2 of the kernel route's on the same
    weights (``compare_probs``) and one batch's logits within TOL of its
    largest |logit|."""
    import torch
    from vsn_tpu_torch.eval.evaluate import Evaluator
    from vsn_tpu_torch.ops import _build

    off_cfg = cfg.replace(USE_PALLAS_ATTENTION=False)
    model_off, model_on = seeded_model(off_cfg, device), seeded_model(
        cfg, device)
    if model_off.fused() or not all(blk.attn.xla_branch()
                                    for blk in model_off.blocks()):
        raise AssertionError("USE_PALLAS_ATTENTION off: a block is fused")
    ev_off = Evaluator(off_cfg, model_off, batch_size=BATCH)
    _sync(device)
    _build.launches.clear()
    t0 = time.perf_counter()
    probs_off = ev_off.predict(images)
    _sync(device)
    secs = time.perf_counter() - t0
    counts = launch_counts()
    check_counts(counts, {}, 1, "USE_PALLAS_ATTENTION off eval")
    probs_on = Evaluator(cfg, model_on, batch_size=BATCH).predict(images)
    compare_probs("USE_PALLAS_ATTENTION off eval (plain: the kernel route)",
                  probs_off, probs_on)
    x = ev_off.transform(torch.from_numpy(images[:BATCH]).to(device))
    with torch.inference_mode():
        got, want = model_off(x).float(), model_on(x).float()
    dtype = str(model_on.dtype).removeprefix("torch.")
    err, scale = (got - want).abs().max().item(), want.abs().max().item()
    log(f"[{card}] USE_PALLAS_ATTENTION off: {len(images)} volumes, no "
        f"launch, {len(images) / secs:.2f} vol/s (first run); logits vs the "
        f"kernel route max|d| {err:.3e} of max|logit| {scale:.3e} (<= "
        f"{TOL[dtype]} of it)")
    if not err <= TOL[dtype] * scale:
        raise AssertionError(f"USE_PALLAS_ATTENTION off: logits differ from "
                             f"the kernel route's by {err}")
    return err / scale / TOL[dtype]


def medvit_stem_f64(model, x, labels, draws, card):
    """MedViT's stem.0 conv weight gradient in f64 on the card (cuDNN) and
    on the CPU, from the input and output cotangent of one f32 training
    micro-step on the card (``medvit_step_outputs``): their relative gap,
    and the card's f32 gradient against the f64 one in f32 ulps of each
    element and in units of the summation's own scale, eps32 * sum |x dy|
    (an f32 sum of n terms in any order stays within n - 1 such units, a
    pairwise or blocked one within about log2 n). Logs and returns them;
    a reading, not a gate."""
    import torch

    conv = model.stem[0].conv
    seen = {}

    def hook(mod, args, out):
        seen["x"] = args[0].detach()
        out.register_hook(lambda g: seen.__setitem__("dy", g.detach()))

    handle = conv.register_forward_hook(hook)
    try:
        _, grads, _ = medvit_step_outputs(model, x, labels, draws)
    finally:
        handle.remove()
    g32 = grads["stem.0.conv.weight"].double().cpu()
    # [B, D, H, W, C] -> NCDHW, as the conv computes
    xs = seen["x"].double().permute(0, 4, 1, 2, 3).contiguous()
    dy = seen["dy"].double().permute(0, 4, 1, 2, 3).contiguous()
    shape, stride, pad = tuple(conv.weight.shape), conv.stride, conv.padding

    def wgrad(a, b):
        return torch.nn.grad.conv3d_weight(a, shape, b, stride, pad)

    card64 = wgrad(xs, dy).cpu()
    cpu64 = wgrad(xs.cpu(), dy.cpu())
    mag = wgrad(xs.abs().cpu(), dy.abs().cpu())
    rel = ((card64 - cpu64).abs().max() / cpu64.abs().max()).item()
    eps32 = float(np.finfo(np.float32).eps)
    ulp = torch.from_numpy(np.spacing(cpu64.abs().float().numpy())).double()
    ulps = ((g32 - cpu64).abs() / ulp)
    cond = ((g32 - cpu64).abs() / (eps32 * mag)).max().item()
    terms = seen["dy"][..., 0].numel()
    log(f"[{card}] medvit stem.0 conv dW in f64, card (cuDNN) vs CPU: "
        f"relative gap {rel:.3e}; the card's f32 dW vs f64: max "
        f"{ulps.max().item():.1f} / median {ulps.median().item():.1f} f32 "
        f"ulps of each element, max {cond:.3f} x eps32 * sum|x dy| "
        f"({terms} terms a weight, log2 {math.log2(terms):.1f}); max|dW| "
        f"{cpu64.abs().max().item():.3e}")
    return {"f64_rel_gap": rel, "f32_ulps_max": ulps.max().item(),
            "f32_ulps_median": ulps.median().item(), "f32_of_scale": cond,
            "terms": terms}


def main() -> int:
    os.environ.setdefault("CUDA_VISIBLE_DEVICES", "0")
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available()"
                         " is false)")
    if torch.cuda.device_count() != 1:
        raise SystemExit("chip_smoke: runs on one card; set "
                         "CUDA_VISIBLE_DEVICES to one device")
    from vsn_tpu_torch.config import load_config
    from vsn_tpu_torch.data.augment import resize_batch, zscore
    from vsn_tpu_torch.eval.evaluate import Evaluator
    from vsn_tpu_torch.models import build_model
    from vsn_tpu_torch.models.swin3d import init_weights
    from vsn_tpu_torch.ops import _build
    from vsn_tpu_torch.train.step import (
        eval_params,
        init_train_state,
        make_batch_transform,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    sync = torch.cuda.synchronize
    t_start = time.perf_counter()

    # 1. build ------------------------------------------------------------
    t0 = time.perf_counter()
    ptxas = start_ptxas()   # beside the build; read in phase 5
    so = _build.build()
    _build.library()
    log(f"build: {time.perf_counter() - t0:.1f} s -> "
        f"{so.relative_to(_build.BUILD_DIR.parent)}")

    # 2. card -------------------------------------------------------------
    card = card_line()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    # 2a. the GEMM and weight-gradient bodies alone -----------------------
    gemm_sets, row_sets = block_shapes(device)
    swin_gemm, vit_gemm = gemm_sets
    gemm_worst = gemm_parity_phase(
        {**{label: (list(launches), "bfloat16")
            for label, launches in gemm_sets.items()},
         f"{vit_gemm} f32": (list(gemm_sets[vit_gemm]), "float32")}, device)
    gemm_counts = gemm_path([*gemm_sets[swin_gemm], *gemm_sets[vit_gemm]],
                            device)
    log(f"GEMM path: {sum(gemm_counts.values())} launches, "
        f"{ {k: v for k, v in gemm_counts.items() if v} }")
    gemm_ms = gemm_times(gemm_sets, device, card)

    # 2b. the row kernels of K1 / K2 alone: the LN backward, LN's rows and
    # the column sums; the other row kernels' times; the wide rows
    typed_sets = {**{label: (launches, "bfloat16")
                     for label, launches in row_sets.items()},
                  **{f"{label} f32": (launches, "float32")
                     for label, launches in row_sets.items()}}
    ln_worst = ln_bwd_parity_phase(typed_sets, device)
    row_worst = row_parity_phase(typed_sets, device)
    ln_counts = ln_bwd_path(row_sets, device)
    log(f"LN-backward path: {sum(ln_counts.values())} launches, "
        f"{ {k: v for k, v in ln_counts.items() if v} }")
    row_counts = row_path(row_sets, device)
    log(f"row path: {sum(row_counts.values())} launches, "
        f"{ {k: v for k, v in row_counts.items() if v} }")
    ln_entries = ln_bwd_entries(ln_bwd_times(row_sets, device, card),
                                row_sets)
    ln_entries.update(row_entries(row_kernel_times(row_sets, device, card),
                                  row_sets))
    wide_row_phase(device, torch.Generator().manual_seed(SEED + 32))
    del row_sets, typed_sets

    # 3. K1's tiled body and K2 on ViT-S's calls ------------------------
    vit_cfg = load_config(preset=VIT_PRESET)
    vit_train_cfg = load_config(dict(
        USE_SAM=True, USE_EMA=True, USE_MIXUP=True, MIXUP_PROB=0.5,
        USE_SHAKEDROP=True, LABEL_SMOOTHING=0.1, SEED=SEED,
        BATCH_SIZE=VIT_MICRO, EFFECTIVE_BATCH_SIZE=VIT_MICRO * TRAIN_ACCUM),
        preset=VIT_PRESET)
    if vit_train_cfg.gradient_accumulation_steps() != TRAIN_ACCUM:
        raise AssertionError("the ViT training config must accumulate "
                             f"{TRAIN_ACCUM} micro-batches")
    vit_batch = train_batch(vit_train_cfg, device, SEED + 14)
    vit_sets = {}
    for dtype_name, fp16 in (("float32", False), ("bfloat16", True)):
        m = seeded_model(vit_cfg.replace(FP16=fp16))
        x = torch.from_numpy(volumes(2, seed=SEED + 15)).to(device)
        x = zscore(resize_batch(x, vit_cfg.input_size))  # the eval transform
        vit_sets[f"ViT {dtype_name} B=2"] = record_calls(m, x)
    vit_micro0 = {k: v[0] for k, v in vit_batch.items()}
    vit_images = make_batch_transform(vit_train_cfg)(vit_micro0)[0].to(
        torch.bfloat16)
    vit_label = f"ViT bfloat16 B={VIT_MICRO} train"
    vit_sets[vit_label] = record_calls(
        seeded_model(vit_train_cfg).train(), vit_images,
        generator=torch.Generator(device).manual_seed(4))
    vgen = torch.Generator().manual_seed(SEED + 16)
    vit_worst = vit_parity_phase(vit_sets, vgen)   # merged in phase 21
    sat = tiled_saturation_phase(vit_sets["ViT float32 B=2"], vgen)
    for name, err in zip(TILED_NAME.values(), sat):
        vit_worst[name] = max(vit_worst[name], err)
    tiled_launch_parity_phase(vit_sets, torch.Generator().manual_seed(
        SEED + 20), TILED_LOGITS)
    # 3a. the same calls in K1/K2's residual modes -------------------------
    mode_worst = residual_parity_phase(vit_sets, vgen, "vit")  # phase 21
    vit_calls = vit_sets.pop(vit_label)  # timed in phase 16
    del vit_sets, vit_micro0, vit_images, m, x
    torch.cuda.empty_cache()

    # 4. K4 parity on the DynamicTanh model's calls ------------------------
    cfg = load_config(dict(USE_SHAKEDROP=True))  # flagship: bf16, ShakeDrop
    train_cfg = load_config(dict(
        USE_SAM=True, USE_EMA=True, USE_MIXUP=True, MIXUP_PROB=0.5,
        USE_SHAKEDROP=True, LABEL_SMOOTHING=0.1, SEED=SEED,
        BATCH_SIZE=TRAIN_MICRO, EFFECTIVE_BATCH_SIZE=TRAIN_MICRO * TRAIN_ACCUM))
    if train_cfg.gradient_accumulation_steps() != TRAIN_ACCUM:
        raise AssertionError("the training config must accumulate "
                             f"{TRAIN_ACCUM} micro-batches")
    dyt_train_cfg = train_cfg.replace(DROPOUT=DYT_DROPOUT, **DYT)
    batch = train_batch(train_cfg, device, SEED + 5)
    micro0 = {k: v[0] for k, v in batch.items()}
    images8 = make_batch_transform(train_cfg)(micro0)[0].to(torch.bfloat16)
    k4sets, blocks = {}, collections.defaultdict(list)
    for dtype_name, fp16 in (("float32", False), ("bfloat16", True)):
        m = init_weights(build_model(cfg.replace(FP16=fp16, **DYT)),
                         torch.Generator().manual_seed(SEED))
        x = zscore(torch.from_numpy(volumes(2, seed=SEED + 10)).to(device))
        label = f"DyT {dtype_name} B=2"
        k4sets[label] = record_calls(m, x, blocks[label])
    m = init_weights(build_model(dyt_train_cfg),
                     torch.Generator().manual_seed(SEED))
    train_label = f"DyT bfloat16 B={TRAIN_MICRO} train"
    k4sets[train_label] = record_calls(
        m.train(), images8, blocks[train_label],
        generator=torch.Generator(device).manual_seed(3))
    atable = attention_table()
    kgen = torch.Generator().manual_seed(SEED + 11)
    worst, kinds = parity_phase(k4sets, atable, kgen)
    bworst, bkinds = grad_parity_phase(k4sets, atable, kgen)
    worst.update(bworst)
    for label in k4sets:
        for name, found in (("attention", kinds[label]["attention"]),
                            ("attention_bwd", bkinds[label]["attention_bwd"])):
            if not ATTN_CASES <= found:
                raise AssertionError(f"K4 set {label} lacks {name} cases "
                                     f"{ATTN_CASES - found}")
    sat = k4_saturation_phase(k4sets["DyT float32 B=2"], kgen)
    for name, err in zip(("attention", "attention_bwd"), sat):
        worst[name] = max(worst[name], err)
    launch_parity_phase(k4sets, torch.Generator().manual_seed(SEED + 21))

    # 5. V1 and V3 on the K4 calls ----------------------------------------
    vgen = torch.Generator().manual_seed(SEED + 12)
    triples = {label: v_calls(calls, blocks[label], vgen)
               for label, calls in k4sets.items()}
    vsets = v_sets(triples, vgen)
    worst.update(v_parity_phase(vsets, v_table(), vgen))
    launch_parity_phase(vsets, torch.Generator().manual_seed(SEED + 22),
                        V_KERNELS, "V")
    del vsets
    v_main = v_main_calls(triples[train_label])
    v_counts = v_path(v_main, vgen)
    launched = {name: n for name, n in v_counts.items() if n}
    log(f"V path: {len(triples[train_label])} K4 calls of a micro-batch of "
        f"{TRAIN_MICRO} through window_attention and "
        f"window_attention_windows, forward and backward, launches "
        f"{launched}")
    check_counts(v_counts, V_PER_CALL, len(triples[train_label]), "V path")
    agen = torch.Generator().manual_seed(SEED + 23)
    for label, t in triples.items():
        diff = k4_agreement(t, agen)
        log(f"V vs K4 {label}: V1f and V3f equal K4f bit for bit (out, row "
            f"statistics, o) over {len(t)} calls; from their kept state "
            f"max|V1b - K4b| {diff['V1b']:.3e}, max|V3b - K4b| "
            f"{diff['V3b']:.3e} (dq, dk, dv), dbias {diff['V1b dbias']:.3e}"
            f" / {diff['V3b dbias']:.3e}")
    ptxas_phase(ptxas)
    vms, vplain = kernel_times(v_main)
    vbounds = {name: bound_ms(name, v_main) for name in V_PER_CALL}
    vsdpa = sdpa_times([("attention", k4) for k4, _, _ in
                        triples[train_label]])
    for name in V_PER_CALL:
        log(f"[{card}] {name}: {vms[name]:.3f} ms per micro-batch of "
            f"{TRAIN_MICRO} (plain {vplain[name]:.3f} ms; SDPA on the same "
            f"calls {vsdpa['_bwd' in name]:.3f} ms; bound "
            f"{vbounds[name][0]:.3f} ms by {vbounds[name][1]})")
    v_launch_times(v_main + [("attention", k4) for k4, _, _ in
                             triples[train_label]], card)
    composite = composite_times(v_main)
    for what, t, name in (("forward", composite[0], "attention_windows"),
                          ("backward", composite[1],
                           "attention_windows_bwd")):
        log(f"[{card}] V3 {what}: {vms[name]:.3f} ms per micro-batch of "
            f"{TRAIN_MICRO} against partition + K4 + reverse {t:.3f} ms")
    for name in V_KERNELS:
        kept = sum(kept_bytes(name, a) for n, a in v_main if n == name)
        log(f"[{card}] {name}: the kept state {kept / 1e6:.1f} MB, written "
            f"by the forward and read by the backward, "
            f"{kept / HBM_BYTES_PER_S * 1e3:.3f} ms each way at the HBM rate "
            "(outside the bounds)")
    k4_calls = k4sets.pop(train_label)  # phase 17
    del k4sets, triples, v_main, m, x
    torch.cuda.empty_cache()

    # 6. forward parity at every stage shape ------------------------------
    models = {}
    for dtype_name, fp16 in (("float32", False), ("bfloat16", True)):
        m = build_model(cfg.replace(FP16=fp16))
        models[dtype_name] = init_weights(m,
                                          torch.Generator().manual_seed(SEED))
    model = models["bfloat16"]
    evaluator = Evaluator(cfg, model, batch_size=BATCH)
    table = kernel_table()
    sets = {}
    for dtype_name, m in models.items():
        x = zscore(torch.from_numpy(volumes(2, seed=SEED + 1)).to(device))
        sets[f"{dtype_name} B=2"] = record_calls(m, x)
    x = torch.from_numpy(volumes(BATCH, seed=SEED + 2)).to(device)
    sets[f"bfloat16 B={BATCH}"] = record_calls(model, evaluator.transform(x))
    fworst, kinds = parity_phase(sets, table,
                                 torch.Generator().manual_seed(SEED + 3))
    worst.update(fworst)
    for label, by_name in kinds.items():
        if not ATTN_CASES <= by_name["attn_half"]:
            raise AssertionError(f"parity set {label} lacks attn_half cases "
                                 f"{ATTN_CASES - by_name['attn_half']}")
    eval_calls = sets.pop(f"bfloat16 B={BATCH}")  # timed in phase 11

    # 7. K1's route at every Swin stage shape ------------------------------
    for name, err in swin_route_phase(
            {"float32 B=2": sets["float32 B=2"],
             f"bfloat16 B={BATCH}": eval_calls},
            torch.Generator().manual_seed(SEED + 17)).items():
        worst[name] = max(worst.get(name, 0.0), err)
    _, slab_worst, slab_counts, odd_route = odd_head_dim_phase(
        {"float32 B=2": sets["float32 B=2"],
         f"bfloat16 B={BATCH}": eval_calls}, device,
        torch.Generator().manual_seed(SEED + 19), card)
    # K4, V1 and V3 on their slab kernels: phase 7's bf16 calls, timed here
    # (none held past the phase: the training phases' peak memory is the
    # parent's)
    slab_calls = [(n, a) for calls in odd_route.values() for n, a in calls
                  if n != "attn_half" and a[0].dtype == torch.bfloat16
                  and head_dim(n, a) > TILED_HEAD_DIM]
    slab_ms, slab_plain, slab_bounds = slab_times(slab_calls)
    slab_sdpa = {  # K4's calls; V1's: the K4 call of its own values
        "attention": sdpa_times([c for c in slab_calls
                                 if c[0] == "attention"]),
        "attention_split": sdpa_times(odd_route.get(
            f"d={WIDE_V_HEAD_DIM} K4 V1 V3 bfloat16", [])[:1])}
    del odd_route, slab_calls
    torch.cuda.empty_cache()

    # 8. backward parity on training forwards -----------------------------
    gsets = {}
    for dtype_name, m in models.items():
        x = zscore(torch.from_numpy(volumes(2, seed=SEED + 4)).to(device))
        gsets[f"{dtype_name} B=2"] = record_calls(
            m.train(), x, generator=torch.Generator(device).manual_seed(1))
    gsets[f"bfloat16 B={TRAIN_MICRO}"] = record_calls(
        model.train(), images8,
        generator=torch.Generator(device).manual_seed(2))
    for m in models.values():
        m.eval()
    gen = torch.Generator().manual_seed(SEED + 6)
    bworst, bkinds = grad_parity_phase(gsets, table, gen)
    worst.update(bworst)
    for label, by_name in bkinds.items():
        if not ATTN_CASES <= by_name["attn_half_bwd"]:
            raise AssertionError(f"backward set {label} lacks attn_half cases "
                                 f"{ATTN_CASES - by_name['attn_half_bwd']}")
    saturation_phase(gsets["float32 B=2"], table, gen)
    train_calls = gsets.pop(f"bfloat16 B={TRAIN_MICRO}")  # timed in phase 17

    # 8a. the Swin calls in K1/K2's residual modes -------------------------
    for name, err in residual_parity_phase(
            {**sets, f"bfloat16 B={TRAIN_MICRO} train": train_calls},
            torch.Generator().manual_seed(SEED + 18), "swin").items():
        mode_worst[name] = max(mode_worst.get(name, 0.0), err)
    del sets, gsets, models, x, images8
    torch.cuda.empty_cache()

    # 9. the attention probes P1-P5 at one stage-1 call -------------------
    probes = probe_phase(device, card)
    torch.cuda.empty_cache()

    # 10. K5f / K5w parity and timings -------------------------------------
    stable = stem_table()
    sgen = torch.Generator(device).manual_seed(SEED + 9)
    cases = {f"{dt} {geom[0]} k{geom[1]} s{geom[2]} C{geom[3]}":
             stem_case(geom, 2, getattr(torch, dt), device, sgen)
             for dt in ("float32", "bfloat16") for geom in STEM_GEOMS}
    full = f"bfloat16 micro {RESNET_MICRO} (the ResNet stem)"
    cases[full] = stem_case(RESNET_STEM, RESNET_MICRO, torch.bfloat16,
                            device, sgen)
    worst.update(stem_parity_phase(cases, stable))
    stem_dw_bits({label: case for label, case in cases.items()
                  if case[0].dtype == torch.bfloat16}, stable)
    stem_call = [("stem_im2col", cases[full])]
    stem_ms = stem_times(*cases[full], stable)
    stem_bound = {name: bound_ms(name, stem_call) for name in STEM}
    for name in STEM:
        t, fma, plain_t, lib = stem_ms[name]
        log(f"[{card}] {name} at x {tuple(cases[full][0].shape)} bf16: "
            f"{t:.3f} ms per micro-batch of {RESNET_MICRO} (the FMA body on "
            f"the same inputs {fma:.3f} ms, {fma / t:.2f}x; plain "
            f"{plain_t:.3f} ms; cuDNN {lib:.3f} ms; bound "
            f"{stem_bound[name][0]:.3f} ms by {stem_bound[name][1]})")
    del cases, stem_call
    torch.cuda.empty_cache()

    # 11. the Swin eval path -----------------------------------------------
    images = volumes(N_VOLUMES, seed=SEED)
    n_batches = -(-N_VOLUMES // BATCH)
    model_eval_path(cfg, model, images, PER_FORWARD, "eval", card)
    ems, eplain = kernel_times(eval_calls, backward=False)
    for name in PER_FORWARD:
        log(f"[{card}] eval {name}: {ems[name]:.3f} ms per forward at batch "
            f"{BATCH} (plain {eplain[name]:.3f} ms)")
    del evaluator, model, eval_calls

    # 12. the Swin training path -------------------------------------------
    steps = 1 + TIMED_STEPS
    passes = steps * TRAIN_ACCUM * (2 if train_cfg.USE_SAM else 1)
    recipe = (f"SAM + EMA + MixUp + ShakeDrop, micro {TRAIN_MICRO} x "
              f"{TRAIN_ACCUM}")
    path_counts = path_entries(model_train_path(
        train_cfg, batch, images, PER_PASS, passes, "train", recipe, card),
        "swin")

    # 13. the DynamicTanh eval path ---------------------------------------
    dyt_cfg = cfg.replace(**DYT)
    model = init_weights(build_model(dyt_cfg),
                         torch.Generator().manual_seed(SEED))
    model_eval_path(dyt_cfg, model, images, DYT_PER_FORWARD, "dyt_eval", card)
    del model

    # 14. the DynamicTanh training path, DROPOUT 0.1 ----------------------
    counts = model_train_path(dyt_train_cfg, batch, images, DYT_PER_PASS,
                              passes, "dyt_train",
                              f"{recipe}, DynamicTanh, DROPOUT {DYT_DROPOUT}",
                              card)
    path_counts.update({name: counts[name] for name in DYT_PER_PASS})

    # 14a. the Swin stabilizer paths: LayerScale, DeepScaleLM, post-norm --
    stabilizer_counts = {}
    for key in ("ls", "stable", "post_ls"):
        over, mode = STABILIZER_PATHS[key]
        if key != "stable":
            scfg = cfg.replace(**over)
            model = seeded_model(scfg)
            model_eval_path(scfg, model, images, in_mode(PER_FORWARD, mode),
                            f"{key}_eval", card)
            del model
        stabilizer_counts[key] = model_train_path(
            train_cfg.replace(**over), batch, images, in_mode(PER_PASS, mode),
            passes, f"{key}_train", f"{recipe}, {key_label(over)}", card)
    torch.cuda.empty_cache()

    # 15. the ViT eval path: 144x168x144 volumes resized on the card ------
    model = seeded_model(vit_cfg)
    model_eval_path(vit_cfg, model, images, VIT_PER_FORWARD, "vit_eval", card)
    del model

    # 16. the ViT training path, micro 24 x 2 ----------------------------
    counts = model_train_path(
        vit_train_cfg, vit_batch, images, VIT_PER_PASS, passes, "vit_train",
        f"SAM + EMA + MixUp + DropPath (USE_SHAKEDROP, which ViT reads as "
        f"DropPath), micro {VIT_MICRO} x {TRAIN_ACCUM}", card)
    path_counts.update({name: counts[name] for name in TILED_NAME.values()})

    # 16a. the ViT stabilizer path: post-norm + LayerScale + DeepScaleLM --
    over, mode = STABILIZER_PATHS["vit_all"]
    scfg = vit_cfg.replace(**over)
    model = seeded_model(scfg)
    model_eval_path(scfg, model, images, in_mode(VIT_PER_FORWARD, mode),
                    "vit_all_eval", card)
    del model
    stabilizer_counts["vit_all"] = model_train_path(
        vit_train_cfg.replace(**over), vit_batch, images,
        in_mode(VIT_PER_PASS, mode), passes, "vit_all_train",
        f"SAM + EMA + MixUp + DropPath, micro {VIT_MICRO} x {TRAIN_ACCUM}, "
        f"{key_label(over)}", card)
    path_counts.update(residual_launches(stabilizer_counts))

    # 16b. heads above 128: Swin-T with one head a stage, ViT-S at 2 heads
    # of 192 (the tiled body's slab kernels) ------------------------------
    counts, wide_calls = wide_head_run(
        cfg.replace(HEADS=WIDE_SWIN_HEADS),
        train_cfg.replace(HEADS=WIDE_SWIN_HEADS), seeded_model, batch, images,
        WIDE_SWIN_PER_FORWARD, WIDE_SWIN_PER_PASS, "wide_swin", card)
    # K1 on its slab kernels: the wide Swin's training calls above 128 (its
    # stages 2-4)
    k1_times = slab_times([(n, a) for n, a in wide_calls
                           if head_dim(n, a) > TILED_HEAD_DIM])
    for got, more in zip((slab_ms, slab_plain, slab_bounds), k1_times):
        got.update(more)
    swin_k1_times(wide_calls, card)
    del wide_calls, k1_times
    torch.cuda.empty_cache()
    vit_counts, wide_vit_calls = wide_head_run(
        vit_cfg, vit_train_cfg, wide_vit_model, vit_batch, images,
        WIDE_VIT_PER_FORWARD, WIDE_VIT_PER_PASS, "wide_vit", card)
    tiled_launch_times(wide_vit_calls, card)
    counts.update(vit_counts)
    path_counts.update({SLAB_NAME[name]: counts[SLAB_NAME[name]]
                        for name in ("attn_half", "attn_half_bwd")})
    path_counts.update({SLAB_NAME[name]: slab_counts[SLAB_NAME[name]]
                        for name in SLAB_BASES[2:]})
    del batch, vit_batch, wide_vit_calls
    torch.cuda.empty_cache()
    vms_vit, vplain_vit = kernel_times(vit_calls)
    vit_bounds = {name: bound_ms(name, vit_calls)
                  for name in ("ln_mlp", "ln_mlp_bwd", *TILED_NAME.values())}
    for name in ("attn_half", "attn_half_bwd", "ln_mlp", "ln_mlp_bwd"):
        tname = TILED_NAME.get(name, name)
        log(f"[{card}] vit {tname}: {vms_vit[name]:.3f} ms per micro-batch "
            f"of {VIT_MICRO} (plain {vplain_vit[name]:.3f} ms, bound "
            f"{vit_bounds[tname][0]:.3f} ms by {vit_bounds[tname][1]})")
    tiled_launch_times(vit_calls, card)
    vms_mode, vplain_mode = mode_times(vit_calls, "_post_ls", "vit")
    for name in sorted(vms_mode):
        bound = bound_ms(name, vit_calls)
        log(f"[{card}] vit {name}: {vms_mode[name]:.3f} ms per micro-batch "
            f"of {VIT_MICRO} (plain {vplain_mode[name]:.3f} ms, bound "
            f"{bound[0]:.3f} ms by {bound[1]})")
        if "tiled" in name:
            vit_bounds[name] = bound
    del vit_calls
    torch.cuda.empty_cache()

    # 17. Swin kernel timings at the training shapes ----------------------
    swin_k1_times(train_calls, card)
    ms, plain_ms = kernel_times(train_calls + k4_calls)
    # K3's launches alone beside its entries' times through the wrappers
    # (kernel_times' events, the yardstick of every block kernel's entry)
    # and the library's gather over the same row map
    k3_library = mover_library_times(train_calls, card)
    for name, t in mover_launch_times(train_calls, card).items():
        log(f"[{card}] {name}: {t:.4f} ms per micro-batch of {TRAIN_MICRO} "
            f"alone, {ms[name]:.4f} ms through its wrapper, index_select "
            f"{k3_library[name]:.4f} ms")
    bounds = {name: bound_ms(name, train_calls + k4_calls) for name in KERNELS
              if name not in STEM and name not in V_PER_CALL
              and name not in PROBES}
    ms.update(vms)
    plain_ms.update(vplain)
    bounds.update(vbounds)
    library_ms = dict.fromkeys(KERNELS)
    library_ms.update(k3_library)
    library_ms["attention"], library_ms["attention_bwd"] = sdpa_times(
        k4_calls)
    k4_launch_times(k4_calls, card)
    # V1 computes K4's function on the split heads that the SDPA call takes
    library_ms["attention_split"], library_ms["attention_split_bwd"] = vsdpa
    for name in TILED_NAME:  # K1's tiled body: ViT's calls
        tname = TILED_NAME[name]
        ms[tname], plain_ms[tname] = vms_vit[name], vplain_vit[name]
        bounds[tname] = vit_bounds[tname]
    # the slab kernels: K1 at the wide Swin's training calls above 128 (its
    # stages 2-4, 16b), K4 / V1 / V3 at phase 7's bf16 calls
    ms.update(slab_ms)
    plain_ms.update(slab_plain)
    bounds.update(slab_bounds)
    for base, lib in slab_sdpa.items():
        library_ms[SLAB_NAME[base]], library_ms[SLAB_NAME[f"{base}_bwd"]] = \
            lib
    worst.update(slab_worst)
    for mode in ("_ls", "_post_ls"):   # the Swin stabilizer paths' modes
        mms, mplain = mode_times(train_calls, mode, "swin")
        ms.update(mms)
        plain_ms.update(mplain)
    for name in RESIDUAL_KERNELS:      # the tiled ones: ViT's calls
        if "tiled" in name:
            ms[name], plain_ms[name] = vms_mode[name], vplain_mode[name]
            bounds[name] = vit_bounds[name]
        else:
            bounds[name] = bound_ms(name, train_calls)
    del train_calls, k4_calls
    torch.cuda.empty_cache()

    # 18. the ResNet eval path --------------------------------------------
    from vsn_tpu_torch.models.resnet3d import init_weights as resnet_init

    rcfg = load_config(preset=RESNET_PRESET)
    rmodel = resnet_init(build_model(rcfg), torch.Generator().manual_seed(SEED))
    refresh_statistics(rmodel, rcfg, volumes(2 * BATCH, seed=SEED + 7), BATCH)
    revaluator = Evaluator(rcfg, rmodel, batch_size=BATCH)
    _build.launches.clear()
    rprobs = revaluator.predict(images)
    sync()
    counts = launch_counts()
    log(f"resnet eval path: {N_VOLUMES} volumes in {n_batches} batches of "
        f"{BATCH}, launches {counts}")
    check_counts(counts, RESNET_PER_FORWARD, n_batches, "resnet eval")
    check_probs(rprobs, N_VOLUMES, rcfg.num_classes)
    with plain_stem():
        rprobs_plain = revaluator.predict(images)
    compare_probs("resnet eval path", rprobs, rprobs_plain)
    eval_rates(revaluator, images, plain_stem, n_batches, "resnet eval",
               card)
    del revaluator, rmodel

    # 19. the ResNet training path ----------------------------------------
    rtrain_cfg = load_config(dict(
        USE_SAM=True, USE_EMA=True, USE_MIXUP=True, MIXUP_PROB=0.5,
        LABEL_SMOOTHING=0.1, SEED=SEED, BATCH_SIZE=RESNET_MICRO,
        EFFECTIVE_BATCH_SIZE=RESNET_MICRO * TRAIN_ACCUM), preset=RESNET_PRESET)
    if rtrain_cfg.gradient_accumulation_steps() != TRAIN_ACCUM:
        raise AssertionError("the ResNet training config must accumulate "
                             f"{TRAIN_ACCUM} micro-batches")
    torch.cuda.reset_peak_memory_stats()
    model = resnet_init(build_model(rtrain_cfg),
                        torch.Generator().manual_seed(SEED))
    state = init_train_state(rtrain_cfg, model)
    initial = state.params.flat.clone()
    initial_stats = state.model_state.flat.clone()
    rbatch = train_batch(rtrain_cfg, device, SEED + 8)
    draws = Draws(model, RESNET_MICRO, device, SEED)
    reach_every_parameter(model, rtrain_cfg, state, rbatch, draws,
                          "resnet train")
    with torch.no_grad():  # that pass moved the statistics
        state.model_state.flat.copy_(initial_stats)
    _build.launches.clear()
    kernel_metrics, secs = train_route(model, rtrain_cfg, state, rbatch,
                                       draws, 1, sync)
    after0 = state.params.flat.clone()
    more, more_secs = train_route(model, rtrain_cfg, state, rbatch, draws,
                                  TIMED_STEPS, sync)
    counts = launch_counts()
    kernel_metrics += more
    log(f"resnet train path: {steps} steps of {TRAIN_ACCUM} x {RESNET_MICRO} "
        f"volumes (SAM: 2 passes), launches {counts}")
    check_counts(counts, RESNET_PER_PASS, passes, "resnet train")
    path_counts.update({name: counts[name] for name in STEM})
    params_moved(state, initial, after0, "resnet train")
    moved, gap = statistics_checks(state, initial_stats)
    log(f"resnet train path: BatchNorm statistics moved by {moved:.3e}, EMA "
        f"statistics {gap:.3e} from the live ones")
    ema_probs = Evaluator(rtrain_cfg, model, batch_size=BATCH).predict(
        images[:BATCH], eval_params(state, use_ema=True))
    check_probs(ema_probs, BATCH, rtrain_cfg.num_classes)
    log(f"resnet train path: EMA weights and statistics through Evaluator, "
        f"probs range [{ema_probs.min():.4f}, {ema_probs.max():.4f}]")
    profile_phase(lambda: train_route(model, rtrain_cfg, state, rbatch, draws,
                                      1, sync), "resnet_train", "step", 1,
                  card)
    with torch.no_grad():
        state.params.flat.copy_(initial)
        state.model_state.flat.copy_(initial_stats)
    del state
    pstate = init_train_state(rtrain_cfg, model)
    with plain_stem():
        plain_metrics, plain_secs = train_route(model, rtrain_cfg, pstate,
                                                rbatch, draws, PLAIN_STEPS,
                                                sync)
    report_routes("resnet train", kernel_metrics, plain_metrics, more_secs,
                  plain_secs, TRAIN_ACCUM * RESNET_MICRO,
                  f"SAM + EMA + MixUp + head dropout, micro {RESNET_MICRO} x "
                  f"{TRAIN_ACCUM}", card)
    log(f"[{card}] resnet train kernel route warm-up step "
        f"{1e3 * secs[0]:.1f} ms; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del pstate, rbatch, model, draws

    # 19a-19d. the paths without a kernel --------------------------------
    unfused_paths(device, card, images, train_cfg, vit_cfg, vit_train_cfg)

    # 20a. the uncertainty eval chain on Swin-T 5c ------------------------
    t0 = time.perf_counter()
    eval_chain_phase(cfg.replace(**CHAIN_CONFIG), _build.BUILD_DIR /
                     "eval_chain", card, device)
    torch.cuda.empty_cache()
    log(f"phase 20a: {time.perf_counter() - t0:.1f} s")

    # 20b. Swin-T 5c eval with USE_PALLAS_ATTENTION off -------------------
    flag_off_phase(cfg, images[:BATCH], card, device)
    torch.cuda.empty_cache()

    # 21. per-kernel times beside their bounds ----------------------------
    for name in GEMM_KERNELS:  # the Swin training micro-batch's launches
        ms[name], _, plain_ms[name], bounds[name], library_ms[name] = \
            gemm_ms[swin_gemm][name]
        path_counts[name], worst[name] = gemm_counts[name], gemm_worst[name]
    for name in STEM:
        ms[name], _, plain_ms[name], library_ms[name] = stem_ms[name]
        bounds[name] = stem_bound[name]
    for name in LN_BWD_KERNELS:  # both sets' launches, as the path counts
        ms[name], plain_ms[name], bounds[name], library_ms[name] = \
            ln_entries[name]
        path_counts[name], worst[name] = ln_counts[name], ln_worst[name]
    for name in ROW_KERNEL_ENTRIES:  # likewise
        ms[name], plain_ms[name], bounds[name], library_ms[name] = \
            ln_entries[name]
        path_counts[name], worst[name] = row_counts[name], row_worst[name]
    path_counts.update({name: v_counts[name] for name in V_PER_CALL})
    for key, (n, err, t, plain_t, bound, lib) in probes.items():
        path_counts[key], worst[key], ms[key] = n, err, t
        plain_ms[key], bounds[key], library_ms[key] = plain_t, bound, lib
    for name, err in vit_worst.items():   # K1's tiled body; K2 on ViT's calls
        worst[name] = max(worst.get(name, 0.0), err)
    for name, err in mode_worst.items():  # the residual modes (3a, 8a)
        worst[name] = max(worst.get(name, 0.0), err)
    for name in KERNELS:
        per = (f"micro-batch of {RESNET_MICRO}" if name in STEM
               else f"wide Swin micro-batch of {TRAIN_MICRO}, stages 2-4"
               if name in ("attn_half_slabs", "attn_half_bwd_slabs")
               else "phase 7's bf16 calls above 128"
               if name.endswith("_slabs")
               else f"stage-1 call (micro-batch of {TRAIN_MICRO})"
               if name in PROBES else f"micro-batch of {VIT_MICRO} (ViT)"
               if "tiled" in name
               else f"micro-batch pass of {TRAIN_MICRO} (Swin-T) and of "
               f"{VIT_MICRO} (ViT-S)"
               if name in LN_BWD_KERNELS or name in ROW_KERNEL_ENTRIES
               else f"micro-batch of {TRAIN_MICRO}")
        lib = ("no single call" if library_ms[name] is None
               else f"{library_ms[name]:.3f} ms")
        log(f"[{card}] {name}: {ms[name]:.3f} ms per {per} (plain "
            f"{plain_ms[name]:.3f} ms, library {lib}, bound "
            f"{bounds[name][0]:.3f} ms by {bounds[name][1]})")
    log(f"total {time.perf_counter() - t_start:.1f} s")

    idle = [name for name in KERNELS if not path_counts.get(name)]
    if idle:
        raise AssertionError(f"kernels that no path launched: {idle}")
    result = {"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": path_counts[name], "max_abs_err": worst[name],
         "ms": ms[name], "plain_ms": plain_ms[name],
         "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
         "library_ms": library_ms[name]}
        for name, (src, rep) in KERNELS.items()]}
    print(json.dumps(result))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": 1}}))
    return 0


def k3_alone(port=None) -> int:
    """``--k3-alone [PORT]`` (see the module's docstring): K3's launches
    alone at the mover calls that ``block_shapes`` records for Swin-T at
    micro-batch TRAIN_MICRO, for the port at ``port`` (put first on the
    import path) or this checkout's."""
    os.environ.setdefault("CUDA_VISIBLE_DEVICES", "0")
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available()"
                         " is false)")
    if port is not None:
        sys.path.insert(0, str(Path(port).resolve()))
    from vsn_tpu_torch.config import load_config

    device = torch.device("cuda", 0)
    card = card_line()
    log(card)
    cfg = load_config(dict(USE_SHAKEDROP=True, BATCH_SIZE=TRAIN_MICRO))
    x = torch.zeros((cfg.BATCH_SIZE, *cfg.input_size, 1),
                    dtype=torch.bfloat16, device=device)
    calls = record_calls(seeded_model(cfg).train(), x,
                         generator=torch.Generator(device).manual_seed(4))
    out = mover_launch_times(calls, card)
    print(json.dumps({"k3_alone_ms": dict(out)}))
    return 0


def rows_alone(port=None) -> int:
    """``--rows-alone [PORT]`` (see the module's docstring): phase 2b's
    times of the post-norm forward's finish and the LayerScale gradients
    (``row_kernel_times``) at the calls that ``block_shapes`` records for
    Swin-T at micro-batch TRAIN_MICRO and ViT-S at VIT_MICRO, for the port
    at ``port`` (put first on the import path) or this checkout's."""
    os.environ.setdefault("CUDA_VISIBLE_DEVICES", "0")
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available()"
                         " is false)")
    if port is not None:
        sys.path.insert(0, str(Path(port).resolve()))
    device = torch.device("cuda", 0)
    card = card_line()
    log(card)
    _, row_sets = block_shapes(device)
    times = row_kernel_times(row_sets, device, card,
                             names=("postnorm_fwd", "layerscale_grads"))
    print(json.dumps({"rows_alone_ms": {f"{label} {kname}": t["ms"]
                                        for (label, kname), t in
                                        times.items()}}))
    return 0


def odd_heads_alone(port=None) -> int:
    """``--odd-heads-alone [PORT]`` (see the module's docstring): K1f and
    K1b whole, through their entry points, at Swin-T's route calls
    (``swin_route_calls`` of an eval forward at batch BATCH in bf16, seeded
    parameters) re-headed to each of ODD_HEAD_DIMS, for the port at
    ``port`` (put first on the import path) or this checkout's."""
    os.environ.setdefault("CUDA_VISIBLE_DEVICES", "0")
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available()"
                         " is false)")
    if port is not None:
        sys.path.insert(0, str(Path(port).resolve()))
    from vsn_tpu_torch.config import load_config
    from vsn_tpu_torch.ops import swin_block_kernels as sbk

    device = torch.device("cuda", 0)
    log(card_line())
    cfg = load_config(dict(USE_SHAKEDROP=True))
    x = torch.randn((BATCH, *cfg.input_size, 1),
                    generator=torch.Generator().manual_seed(SEED)).to(
        device, torch.bfloat16)
    calls = swin_route_calls(record_calls(seeded_model(cfg).eval(), x))
    gen = torch.Generator().manual_seed(SEED + 33)
    out = {}
    for d in ODD_HEAD_DIMS:
        k1 = [seeded_params("attn_half", reheaded(a, d), gen) for _, a in calls]
        with torch.no_grad():
            b_args = [(*a[:8], a[10], torch.randn(
                a[0].shape, device=device).to(a[0].dtype), *a[11:13])
                for a in k1]
            kept = [k1_kept(a) for a in k1]
            out[f"K1f d={d}"] = cuda_ms(lambda: [sbk.attn_half(*a)
                                                 for a in k1])
            out[f"K1b d={d}"] = cuda_ms(lambda: [
                sbk.attn_half_backward(*a, **kk) for a, kk in zip(b_args,
                                                                   kept)])
        del b_args, kept
    print(json.dumps({"odd_heads_alone_ms": out}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--odd-heads-alone"]:
        sys.exit(odd_heads_alone(*sys.argv[2:3]))
    if sys.argv[1:2] == ["--k3-alone"]:
        sys.exit(k3_alone(*sys.argv[2:3]))
    if sys.argv[1:2] == ["--rows-alone"]:
        sys.exit(rows_alone(*sys.argv[2:3]))
    sys.exit(main())
