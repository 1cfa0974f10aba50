#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA H100.

    python3 chip_smoke.py                 # the whole check, one card
    python3 chip_smoke.py --kernels-only  # build + kernel checks only
    python3 chip_smoke.py --paged-only    # build + the paged kernels' checks only (its int8 too)
    python3 chip_smoke.py --spot-only     # build + the spot provisioner's phase only
    python3 chip_smoke.py --serve-plan-only  # build + the spot serving phase only
    python3 chip_smoke.py --moe-only      # build + the flash kernels at mixtral's shape + phase 10
    python3 chip_smoke.py --dense-variants-only  # build + the kernels at phase 11's shapes + phase 11
    python3 chip_smoke.py --gemma-only    # build + the kernels at head dim 256 + phase 12
    python3 chip_smoke.py --whisper-only  # build + the flash kernels at whisper's shapes + phase 13
    python3 chip_smoke.py --hybrid-train-only  # build + hymba's training kernels + phase 14
    python3 chip_smoke.py --xlstm-train-only   # build + the tensor-core mLSTM's designs, the
                                               # mLSTM's backward, the sLSTM (wide too) + phase 15
    python3 chip_smoke.py --whisper-plan-only  # build + the flash kernels at whisper's + phase 16
    python3 chip_smoke.py --vlm-train-only     # build + the flash kernels at S3073 G6 + phase 17
    python3 chip_smoke.py --xlstm-dots-only    # build + phase 18
    python3 chip_smoke.py --dryrun-only        # build + phase 19
    python3 chip_smoke.py --multi-device-only  # build + phase 20 on 4 cards (fails on fewer)
    python3 chip_smoke.py --multi-serve-only   # build + phase 21 on 4 cards (fails on fewer)

Phases, each of which raises on a failed check (so the exit code is not 0):

1. device: the card's name and power limit (``nvidia-smi``); TF32 off;
2. build: compile ``src/repro_torch/csrc/*.cu`` for sm_90a (``kernels/_build.py``),
   one nvcc per source, all in parallel;
3. kernels: each hand-written kernel (flash forward, paged decode, the two
   flash backward kernels, the selective scan and its backward, the
   chunkwise mLSTM and its backward, the sLSTM recurrence and its
   backward) against
   its plain PyTorch version on the card, on the reference's test shapes
   and at the main paths' shapes, with times (CUDA events, L2 flushed
   between launches) beside the bound. The flash forward, dk/dv and dq
   have two variants each, by dtype: bf16 on tensor cores (wgmma fed by
   TMA); f32 on tensor cores as split TF32 (hi + lo halves of every
   operand, three mma.sync products, fed by cp.async); every feature case
   runs in both dtypes; the f32 forward is timed at its four shapes with
   its spread beside SDPA's f32 forward, and the f32 forward's and
   backward's outputs at S1000 hd 128 and 256 are logged as digests. The paged
   kernel (split over positions, then merged) has two: bf16 scores and P.V
   on tensor cores (mma.sync), f32 on FMAs; in bf16 at the main path its
   mean error against f32 on the same inputs is within
   PAGED_MEAN_ERR_MARGIN of the plain split form's (p's lo half shows
   there). Its int8 variants (one per dtype; int8 codes staged by cp.async
   and dequantized a tile at a time) give, on the same cases, at the main
   path and at qwen1.5-32b's decode, the bits of the bf16 or f32 kernel on
   the pool ``_dequantize_kv`` makes, twice, within tolerance of the plain
   gather path on live lanes, exact zeros on dead lanes, and the same mean
   error hold; timed at qwen1.5-32b's shape. The scan has a prefill kernel
   and a decode kernel (S <= 4), picked by S. The mLSTM's model calls go
   to a one-pass decode step (S <= 8) or a chunkwise kernel: bf16 on
   tensor cores, f32 (and what the tensor-core kernel does not take) on
   tensor cores as split TF32, both held in both dtypes, the split-TF32
   one also in f32 at xlstm-350m's prefill shape and timed there. The
   tensor-core kernel's two designs (a carry pass over C's tiles and an
   output pass over chunks; the single pass) are each held on every case
   and at xlstm-350m's prefill (B8) and training (B1) shapes keeping their
   chunk states, each kept tensor against the plain split form, and timed
   there in turns (``check_mlstm_tc_designs``; B1's record joins the
   kernels line as ``mlstm_tc_train``). The
   flash forward, dk/dv and dq are
   also held at mixtral-8x7b's training shape (B1 S8192 H32/8 hd128,
   window 4096, bf16), timed beside SDPA with the band as a boolean mask.
   Two calls on the same inputs give the
   same bits for the bf16 dq, the f32 forward, dk/dv and dq (hd 128 and
   256), the paged kernel, the scan and its backward (over many segments
   too), both chunkwise mLSTM kernels and the step, and both sLSTM kernels;
   the kernels NO_SPILL_KERNELS names build with no spilled registers. The
   sLSTM's forward and backward (one persistent cooperative grid each; h
   and dpre exchanged as step-tagged words) are held against
   ``slstm_ref`` and ``slstm_bwd_ref`` in f32 at d 128 (atol 1e-5, rtol 1e-4; the
   backward's dr, and all its outputs at S 200, against an f64 witness,
   within 2x the plain f32 version's own error), at decode's shape (B8 S1
   d1024 from a start state) at atol 1e-5, rtol 1e-4, and at xlstm-350m's
   other shapes (prefill B8 S4096, training B1 S4096) against an f64
   witness, within 2x the plain f32 version's own error; keeping what
   the gradient needs leaves the forward's bits as they are. Past d 1056,
   where d / 8 blocks cannot all be resident, the wide grids (16-64
   units a block, r's share in registers, shared memory and the rest read
   from device memory each step) and at a d that 32 does not divide the
   padded path are held the same way at d 200, 1152, 2048 and 4096
   (SLSTM_WIDE_CASES; the units each launch takes equal the dry run's
   H100 rule) and timed beside their bounds; a 4-layer ``BlockKind.SLSTM``
   model at d 1152 in f32 gives the CPU's prefill logits and 16-token
   greedy stream on the card;
4. serving: full-width qwen3-4b (random bf16 weights from a seeded
   generator) through ``DecodeEngine`` on 16 requests; launch counters
   prove prefill went through the flash kernel (36 launches per prefill)
   and decode through the paged kernel (36 per step); the flash prefill's
   logits agree with the plain masked path; a reduced model's f32 streams
   on the card equal the plain CPU engine's;
5. hybrid serving: full-width hymba-1.5b (random bf16 weights, the Mamba
   block's f32 leaves kept f32) through the serve launcher's loop, 8
   prompts x 4096 tokens and 32 new tokens each; launch counters prove
   the prefill went through the flash kernel (32 launches) and every
   prefill and decode step through the scan kernel (32 x 32); the kernel
   path's prefill logits agree with the plain path's (masked attention,
   sequential scan); a reduced model's f32 streams on the card equal the
   CPU's;
6. xLSTM serving: full-width xlstm-350m (random bf16 weights, the
   blocks' f32 leaves kept f32) through the serve launcher's loop, 8
   prompts x 4096 tokens and 32 new tokens each; launch counters prove
   the prefill went through the tensor-core mLSTM (20 launches) and every
   decode step through the one-pass step (20 x 31), the prefill and every
   decode step through the sLSTM kernel (4 x 32), and nothing else; on
   one prompt, every mLSTM call of the bf16 prefill gives the same h and
   state as the plain chunkwise form on its own inputs; the bf16 prefill
   of all 8 prompts' first 32 tokens is no farther from an f32 reference
   than 1.5 x two plain bf16 orders are, and its mLSTM h no farther from
   an f64 recurrence than the plain form's (``compare_xlstm_paths``; the
   split-TF32 kernel's path is measured beside it); f32 prefill logits on 4096
   tokens agree with the plain path's (every plain route runs ``slstm_ref``);
   a reduced model's f32 streams on the card equal the CPU's;
7. training: full-width qwen3-4b (f32 params from a seeded generator,
   AdamW, seq 4096, global batch 2 in 2 microbatches, remat per layer)
   through ``run_segment`` for 4 steps: finite losses and grad norms, no
   param change at step 0 (learning rate 0) and a change after step 1,
   and launch counters of 144 flash forwards and 72 of each backward
   kernel per step; then a reduced f32 model's 5 steps on the card match
   the plain CPU trainer's losses and grad norms (rtol 1e-4) and params
   (atol 1e-5);
8. spot provisioner: full-width qwen3-4b (as in 7) through
   ``SpotTrainingOrchestrator`` in siwoft mode on the orchestrator bench's
   split scenario (a 400 GB job on two 8-device legs, one step a trace
   hour, leg B revoked at future hour 2), a pool of 8 slots on cuda:0, 12
   steps in segments of 3: B's revocation cuts a segment after 2 of its
   steps, one leg is repaired, the job completes; 0 < reshard_bytes <
   train_state_bytes, the leg costs sum to the bill, 144 flash forwards
   and 72 of each backward kernel per executed step, and the re-executed
   steps' losses equal the first attempt's bit for bit (the host snapshot
   of the segment-start state restored it); peak memory, the snapshot's
   GB and seconds, the host's seconds per provisioning decision and ms per
   step are logged. Then reduced f32 qwen3-4b (tests/test_orchestrator.py's
   config) in siwoft, checkpoint and hybrid mode on the card and on the
   CPU: the deterministic report columns equal, losses at rtol 1e-4 (the
   checkpoint mode restores onto the card); and the training launcher's
   three spot modes on the card, reduced, with ``--trace``, each trace
   read back with ``read_jsonl``;
9. spot serving: full-width qwen3-4b (bf16 weights from a seeded
   generator) through the serve launcher's plan modes (``serve_plan``) on
   a pool of 8 slots on cuda:0, 8 prompts x 2000 tokens and 32 new tokens:
   dense uninterrupted, dense revoked after 16 steps (plans 8 -> 4) under
   ``drop`` and ``migrate``, the engine uninterrupted and revoked (its
   pool released, its streams drained onto a fresh engine). Held: the
   byte columns equal the CPU's prediction (``serve_plan_predicted``) and
   params stay below the training path's bytes; the migrate stream equals
   the uninterrupted one, drop's first 17 tokens do, and the engine's
   rows are equal or first diverge at a near-tie of the uninterrupted
   run's logits (top-2 gap <= 2 bf16 ulps of the top logit, correlation
   > 0.99), and at the replacement's first decode call each lane's
   ``seq_lens`` equals the uninterrupted engine's (prompt + committed
   tokens but the newest) and every K/V row below it correlates with the
   uninterrupted row above 0.99; 36 flash launches a prefill and 36 paged
   ones a decode step;
   reduced f32 in the five runs on the card equals the CPU in every
   column but the timings. Then ``FleetSimulator`` in engine mode, priced
   by the engine's tokens/s and the revoked run's tracker, runs the serve
   bench's policies on its markets and quick traces: token conservation,
   every migration below the training path's bytes, and a replay of its
   trace with 0 mismatches are held; the CSV rows are printed;
10. the MoE family, full layer width with the depth cut to fit the card:
   mixtral-8x7b (16 of 32 layers, 8 experts top-2, window 4096; 4 prompts
   x 8192 tokens) and phi3.5-moe (16 of 32 layers, 16 experts; 4 x 4096)
   through the serve launcher's loop, 32 new tokens (bf16 matrices, the
   router f32): one flash launch a layer and nothing else; the flash
   prefill's last top-1 equal to the masked one's and its logits, over
   every position of one prompt, no farther from an f32 reference (the
   weights upcast, masked attention) than 1.5 x the masked bf16 path's in
   two chunk orders (random-weight bf16 MoE is chaotic: near-tie routing
   flips move the capacity drops); and the last decode step against a
   fresh prefill over the prompt and the 31 fed tokens (top-1 equal, or
   phase 9's near-tie; the expert counters that agree are logged);
   mixtral (2 of 32
   layers, f32 params + AdamW, seq 8192, batch 2 in 2 microbatches)
   through ``run_segment`` for 4 steps: finite losses, aux loss > 0,
   params unmoved at step 0 and moved after, 8 flash forwards and 4 of
   each backward kernel a step; reduced f32 mixtral and phi3.5 serving and
   3 mixtral training steps on the card equal the CPU's (streams, logits,
   every expert counter; loss, aux loss and grad norm rtol 1e-4, params
   atol 1e-5);
11. the dense variants, each at full width and depth, the attention
   biases drawn N(0, 0.5) (``init`` leaves them at zero, as the reference
   does): qwen1.5-32b (64 layers, 70.39 GB of bf16 weights, QKV bias)
   through ``DecodeEngine`` with the int8 pool (769 pages, 8.19 GB; the
   bf16 pool of that size would not fit, which is held) on phase 4's
   requests: one flash forward a layer a prefill and one int8 paged launch
   a layer a decode step, and nothing else; on one layer the int8 kernel's
   attention equals the bf16 kernel's on the dequantized pool bit for bit
   and the plain gather path's within PAGED_MAIN_BF16_TOL, the plain path's
   scoped dequantization equals the whole pool's bit for bit, and the
   kernel, the plain attend and the bf16 kernel there are timed;
   then its first 2 requests through a bf16 pool (64 paged launches a
   step), fed the int8 streams, held by the reference's rule (top-1 equal
   or correlation > 0.98) at every step; qwen1.5-4b trained 4 steps as in
   7 (160 / 80 / 80 launches a step, the biases' gradients nonzero) and
   served as in 4 (40 launches a prefill and a step); internvl2-26b (48
   layers) through the serve launcher's loop, 4 prompts of 2048 tokens
   after 1025 patch rows (S = 3073), 32 new tokens: 48 flash forwards,
   none in decode; the flash prefill against the masked one, the last
   decode step against a fresh prefill over patches, prompt and fed
   tokens (top-1 equal or phase 9's near-tie), ``pos_ids`` without a
   hole; reduced f32 int8 qwen1.5-32b serving (the int8 FMA variant
   launched), qwen1.5-4b training and
   serving, internvl2 serving and the ``triangular`` schedule's prefill
   and 3 training steps on the card equal the CPU's. The kernel phase
   holds the forward at G=1 (B1 S2000 H40/40) and G=6 (B4 S3073 H48/8,
   a last tile of one row), the forward and both backward kernels at
   B1 S4096 H20/20, and the paged kernel at 8 lanes, H20/20 and H40/40;
12. gemma-7b (head dim 256, GeGLU, tied embeddings scaled by sqrt(d_model)
   in f32, which makes the residual stream f32): served at full width and
   depth (28 layers, 8.538 B params, bf16) through ``DecodeEngine`` on
   phase 4's requests: 28 flash forwards a prefill and 28 paged launches a
   step; the flash prefill against the masked one as in 4; trained at full
   width with GEMMA_TRAIN_LAYERS of its 28 layers as in 7 (4N flash
   forwards and 2N of each backward kernel a step); reduced f32 gemma with
   head dim 256 serving and 3 training steps on the card equal the CPU's.
   The kernel phase holds the forward, dk/dv, dq and paged kernels at head
   dim 256 in both dtypes on the reference's feature cases and at gemma's
   shapes (prefill B1 S2000, training B1 S4096, H16/16; paged 8 lanes),
   and every hd-256 instantiation builds with no spilled registers;
13. whisper-tiny (LayerNorm, the biased GELU MLP, a 4-layer encoder over
   1500 stub frames, cross-attention, the ``memory`` cache entry), bf16
   with every bias and norm drawn off its default: served at full width
   and depth through the serve launcher's loop (16 rows, 64-token prompts
   and their frames, 128 new tokens): 4 flash forwards a prefill (the
   decoder's self-attention) and no kernel in decode (the encoder and
   cross-attention are plain, as in the reference); the flash prefill
   against the masked one (top-1 equal, correlation > 0.99); trained at
   full width and depth through ``build_train_step`` (``run_segment``
   refuses it: the data path makes no frames), 8 rows of 448 tokens with
   frames in 2 microbatches, f32 params + AdamW, 4 steps: 16 flash
   forwards and 8 of each backward kernel a step; reduced f32 serving and
   3 training steps on the card equal the CPU's;
14. hymba-1.5b trained at full width and depth (32 layers, 1.662 B f32
   params + AdamW) as in 7: 4 flash forwards, 2 of each flash backward
   kernel, 4 scan forwards (keeping their states) and 2 scan backwards a
   layer a step; reduced f32 hymba's 3 steps on the card equal the CPU's.
   The kernel phase holds the flash forward and both backward kernels at
   whisper's shapes (G=1 hd 64) and hymba's training shape (B1 S4096
   H25/5, G=5, window 1024) in both dtypes, and the scan's backward (time
   split into segments: ``ssm_scan_bwd_carry_kernel``'s local carries, then
   ``ssm_scan_bwd_kernel`` per segment from the states the forward kept
   after each 16-step tile, then its partial sums) against
   ``ssm_scan_bwd_ref`` on the reference's cases, over many segments with a
   ragged end and at hymba's training shape, in both u dtypes, with the
   same bits twice; the forward keeping its states gives the bits it gives
   without;
15. xlstm-350m trained at full width and depth (24 layers, 0.527 B f32
   params + AdamW, global batch 2 in 2 microbatches, each group under
   remat) for 3 steps at seq 4096: per layer and microbatch a step two
   tensor-core mLSTM forwards keeping their chunk states (the pass and its
   recompute) and one mLSTM backward, two sLSTM forwards keeping their
   steps' gates and states and one sLSTM backward, and nothing else; one
   more step profiled; reduced f32 xlstm's 3 steps on the card (the
   split-TF32 forward keeping its states, the backward, both sLSTM kernels)
   equal the CPU's.
   The kernel phase holds the mLSTM's backward (``csrc/mlstm_bwd.cu``: a
   reverse pass over chunks carrying dC, a pass parallel over (chunk,
   value-row tile, b.h), fixed-order sums) against
   ``mlstm_chunkwise_bwd_ref`` on the reference's cases in both dtypes,
   with and without a start state, ragged, mostly and rarely clamped, and
   at xlstm's training microbatch (B1 S4096 H4 hd512) in both dtypes, the
   same bits twice;
16. whisper-tiny on the serve launcher's dense plans (``serve_plan`` with
   frames; f32 params, biases and norms drawn off their defaults), full
   width and depth: phase 13's 16 prompts x 64 tokens with their frames,
   128 new tokens, uninterrupted and revoked after 32 steps (plans 8 -> 4)
   under drop (the re-prefill re-runs the encoder) and migrate (the cache
   moves with the encoder's memory in it): 4 flash forwards a prefill;
   the byte columns equal the CPU's prediction (``whisper_plan_predicted``,
   which tests/test_torch_whisper_plan.py holds to the reference's
   placement arithmetic), the memory's share of ``cache_bytes`` printed;
   the migrate stream equals the uninterrupted one, drop's rows are equal
   or first diverge after the revocation at a near-tie (phase 9's rule);
   reduced f32 runs on the card equal the CPU's in every column but the
   timings;
17. internvl2-26b's training step at full width with VLM_TRAIN_LAYERS of
   its 48 layers (f32 params + AdamW): 2 rows of 1025 patch rows + 2048
   tokens (the flash kernels see S = 3073, G = 6) in 2 microbatches,
   ``remat="full"``, through ``build_train_step`` for 3 steps: finite
   losses and grad norms, params (vision_proj included) unmoved at step 0
   and moved after, 2 flash forwards and 1 of each backward kernel a layer
   and microbatch; reduced f32 training with patches on the card equals
   the CPU's (loss and grad norm rtol 1e-4, params atol 1e-5). The kernel
   phase holds the forward, dk/dv and dq at B1 S3073 H48/8 hd128 in both
   dtypes;
18. xlstm-350m as in 15 under ``remat="dots"`` (each group keeps its
   projections' outputs) beside ``remat="full"``, in turns from one start
   state (full, dots, dots, full): ms a step, peak memory and launches a
   step per turn; every turn launches phase 15's kernels, and the dots
   turns' losses and grad norms equal the full turns' bit for bit; reduced
   f32 xlstm under dots on the card equals the CPU's;
19. the dry run against the card (``launch/dryrun.py`` on the meta
   device, ``launch/roofline.py``'s H100 terms): at phase 7's qwen3-4b
   training step (B2 in 2 microbatches, seq 4096, remat full) and phase
   15's xlstm-350m step, each traced on meta and then run on the card
   (a step to set up, one measured, one under ``FlopCounterMode``): the
   kernels' calls a step the trace predicts equal the launch counters,
   the predicted peak is within DRYRUN_PEAK_MARGIN of
   ``max_memory_allocated`` over the step, the roofline's time
   max(t_compute, t_memory) is no more than the step's device time (CUDA
   events), and the trace's aten product FLOPs equal ``FlopCounterMode``'s;
20. multi-device execution: the script spawns one rank per card
   (``torch.cuda.device_count()``, NCCL, ``launch/mesh.py::run_world``) and
   drives ``SpotTrainingOrchestrator`` in siwoft mode over the world's ranks
   on a shrink scenario (markets of 4, 2, 1 and 4 devices; on 4 cards the
   plans are (2, 2), (2, 1), (1, 1), (2, 2)): full-width qwen3-4b, f32 +
   AdamW, seq 4096, global batch 2 (36 layers on 4 cards; on fewer every
   plan caps to the world, nothing moves, and the depth is cut to
   MULTI_ONE_CARD_LAYERS). Each rank runs the sharded step on its slices;
   every revocation moves the live params and both moments between cards.
   Held: every move's bytes received, summed over ranks, equal the bytes
   it was priced at (``reshard_bytes``); re-executed steps give the first
   attempt's loss bit for bit (and grad norm, where they ran on the same
   plan), and reduced f32's sharded step run twice from one state on each
   plan gives the same bits on every rank; every rank launches the flash
   forward, dk/dv and dq for each step it ran; each rank's peak memory
   under 80 GB; then reduced f32 qwen3-4b in the three modes and siwoft on
   phase 8's split scenario (on 4 ranks a one-leg repair: the lost leg's
   slices rebuilt, received ``==`` ``leg_state_bytes``) over the same world
   equals a gloo world of as many ranks on the CPU (columns ``==``, losses
   at rtol 1e-4). Logs ms a step by plan, each rank's peak, each
   move's bytes and seconds beside its priced hours.
21. serving over torch.distributed: phase 9's five runs (full-width
   qwen3-4b, bf16 matrices, 8 prompts x 2000 tokens, 32 new, revoked after
   16 steps) through ``serve_plan`` on every rank of a world of one rank a
   card, plans of 4 -> 2 ranks ((2, 2) -> (2, 1) on 4 cards; on fewer every
   plan caps to the world, nothing moves, and the depth is cut to
   MSERVE_ONE_CARD_LAYERS): each rank holds its params slices, computes
   with the whole params gathered once a plan, and serves the rows of its
   ``data`` coordinate; a revocation moves the params, and under migrate
   the cache, between cards. Held: each move's bytes received, summed over
   ranks, equal its priced bytes, and the byte columns (with the moved
   cache's gather to the new rows) equal ``serve_plan_predicted`` for 4 ->
   2, made from the specs before the run; params below the training
   path's; the ranks of a data coordinate give the same tokens; migrate's
   stream equals the uninterrupted one, drop's and the engine's rows equal
   theirs or first diverge at a near-tie after the revocation, and the
   uninterrupted world's rows equal phase 9's one-card run's (batch 8 on
   one card, run here) or first diverge at a near-tie; on every rank 36
   flash forwards a prefill call and 36 paged launches an engine decode
   step; each rank's peak under 80 GB; rates measured on both plans; then
   reduced f32 in the same five runs over the cards equals a gloo world of
   as many ranks on the CPU (every column but the timings, received bytes
   ``==`` priced). Logs ms a decode step by plan, the time to recover,
   each move's and the gather's bytes and seconds, prefill seconds, the
   engine's tokens/s before and after, and each rank's peak.

A kernel variant's ``launches_by_path`` in the JSON record holds its count
on each path (``serve``, ``hybrid``, ``xlstm``, ``train``, ``spot`` at full width
in bf16, the reduced f32 runs ``serve_f32``, ``hybrid_f32``, ``xlstm_f32``,
``train_f32``, ``spot_f32``, the launcher's reduced bf16 ``spot_launch``, and
the plan modes' ``serve_plan`` and ``serve_plan_f32``, the MoE family's
``moe``, ``moe_phi``, ``moe_train`` at full width and ``moe_f32``,
``moe_train_f32`` reduced; the dense variants' ``dense_int8``,
``dense_bf16``, ``dense_q4_train``, ``dense_q4_serve``, ``dense_vlm`` at
full width and ``dense_int8_f32``, ``dense_q4_train_f32``,
``dense_q4_tri``, ``dense_q4_serve_f32``, ``dense_vlm_f32`` reduced;
gemma-7b's ``gemma``, ``gemma_train`` at full width and ``gemma_f32``,
``gemma_train_f32`` reduced; whisper-tiny's ``whisper``, ``whisper_train``
and ``whisper_f32``, ``whisper_train_f32``; hymba's ``hybrid_train`` and
``hybrid_train_f32``; xlstm's ``xlstm_train`` and ``xlstm_train_f32``;
``whisper_plan`` and ``whisper_plan_f32``; ``vlm_train`` and
``vlm_train_f32``; ``xlstm_train_dots`` (its dots turns) and
``xlstm_train_dots_f32``; ``slstm_wide_f32``, the d-1152 model; phase 19's
measured steps ``dryrun_train`` and ``dryrun_xlstm_train``; phase 20's
``multi`` and ``multi_f32`` and phase 21's ``serve_multi`` and
``serve_multi_f32``, summed over ranks), each
counted from 0
just before each run of that path and read
just after; ``launches`` is their sum. The full-width paths launch only the
bf16 tensor-core variants (``_tc``), the f32 runs only the f32 ones (the
flash forward's and backward's split-TF32 kernels, the paged kernel's FMA
variants (its int8 one on ``dense_int8_f32``) and the mLSTM's FMA kernels). The last three
lines of stdout are the card's name and power limit, the
per-kernel JSON record and ``{"ok": true, "device": {...}}``. Without a CUDA device, or without the
repository beside this file, the script prints no result and exits 2.
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import gc
import json
import math
import os
from pathlib import Path
import re
import subprocess
import sys
import time

# qwen1.5-32b's weights and int8 pool leave ~6 GB of the card: growable
# segments keep the caching allocator from stranding it in split blocks
# (read when the allocator starts, so set before torch touches the card)
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
SRC = REPO / "src"

# kernels that must build without spilling registers (ptxas): the paged
# split and merge, the mLSTM decode step, its tensor-core prefill and its
# split-TF32 chunkwise kernel, the scan's prefill and decode kernels and its
# backward's, the f32 (split-TF32) flash forward and backward, every
# instantiation at head dim 256 (a template argument of 256 in its mangled
# name), the mLSTM backward's four kernels and the sLSTM's two
NO_SPILL_KERNELS = ("paged_split_fma_kernel", "paged_split_tc_kernel", "paged_merge_kernel",
                    "mlstm_step_kernel", "mlstm_tc_kernel", "mlstm_tc_carry_kernel",
                    "mlstm_tc_out_kernel", "mlstm_tf32_kernel",
                    "ssm_scan_kernel", "ssm_step_kernel",
                    "ssm_scan_bwd_kernel", "ssm_scan_bwd_carry_kernel", "ssm_sum_parts_kernel",
                    "flash_fwd_tf32_kernel", "flash_bwd_dkdv_tf32_kernel",
                    "flash_bwd_dq_tf32_kernel", "Li256E", "mlstm_bwd_kernel",
                    "mlstm_bwd_prep_kernel", "mlstm_bwd_carry_kernel", "mlstm_bwd_sum_kernel",
                    "slstm_fwd_kernel", "slstm_bwd_kernel", "slstm_fwd_wide_kernel",
                    "slstm_bwd_wide_kernel")
# NVIDIA H100 SXM data sheet: dense bf16 tensor-core rate and HBM3 bandwidth
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12       # f32 outside the tensor cores
PEAK_TF32_FLOPS = 495e12     # dense TF32 tensor-core rate
# f32 products as split TF32 take three TF32 products each: the split-TF32
# kernels' bound is their work at a third of the TF32 rate (their f32 FMA
# bound, at PEAK_F32_FLOPS, is logged beside it)
PEAK_SPLIT_TF32_FLOPS = PEAK_TF32_FLOPS / 3
PEAK_BYTES = 3.35e12
# the SFU's exponentials (ex2): 16 a clock per SM, 132 SMs, 1980 MHz boost
SFU_EXP_PER_S = 16 * 132 * 1.98e9

# (B, S, H, KVH, hd, causal, window, dtype): tests/test_torch_kernels.py
# FLASH_CASES (tests/test_kernels.py's, then rows for each feature of the
# bf16 tensor-core kernel: hd 32, a window, S not a multiple of 128)
FLASH_CASES = [
    (2, 256, 4, 4, 64, True, 0, torch.float32),
    (1, 256, 8, 2, 64, True, 0, torch.float32),
    (2, 128, 4, 1, 32, True, 64, torch.float32),
    (1, 384, 4, 4, 128, True, 0, torch.float32),
    (1, 256, 4, 2, 64, True, 0, torch.bfloat16),
    (2, 128, 2, 2, 128, True, 32, torch.bfloat16),
    (2, 128, 4, 1, 32, True, 64, torch.bfloat16),
    (1, 200, 4, 2, 32, True, 48, torch.float32),
    (1, 200, 4, 2, 32, True, 48, torch.bfloat16),
    (2, 333, 8, 2, 128, True, 0, torch.float32),
    (2, 333, 8, 2, 128, True, 0, torch.bfloat16),
]
# (B, Sq, Skv, H, KVH, hd, causal, window, q_offset): tests/test_torch_kernels.py
# FLASH_EXTRA_CASES, run in both dtypes by the forward and the backward checks
FLASH_EXTRA_CASES = [
    (1, 64, 192, 4, 2, 64, True, 0, 128),
    (2, 100, 100, 4, 2, 64, False, 0, 0),
]
# (B, H, KVH, hd, page_size, max_blocks, lens, dtype): tests/test_kernels.py PAGED_CASES
PAGED_CASES = [
    (2, 4, 4, 64, 16, 4, [64, 33], torch.float32),
    (3, 8, 2, 64, 16, 4, [1, 50, 64], torch.float32),
    (2, 4, 1, 32, 8, 6, [41, 17], torch.float32),
    (2, 4, 2, 64, 16, 4, [64, 7], torch.bfloat16),
]


F32_TOL = dict(atol=2e-5, rtol=2e-5)
# Reduced f32 serving, card (kernels) vs CPU (plain versions): the
# repository's f32 model tolerance (XLA and torch, or cuBLAS and the CPU,
# sum matmuls in different orders).
REDUCED_LOGITS_TOL = dict(atol=1e-4, rtol=1e-4)
# Main-path bf16 shapes: a typical |o| there is only ~0.03-0.05 (softmax over
# ~1000 positions), so the repository's 2e-2 is most of a typical value.
# rtol 1e-2 covers the bf16 output's rounding (at most one ulp, 2^-7 |o|);
# atol covers the small |o| that dominate. Largest errors on an H100: flash
# 3.9e-3 (S=2000), paged 4.9e-4; dropping a ragged kv tile or a partial
# last page gave 3.7e-2 and 1.3e-1.
FLASH_MAIN_BF16_TOL = dict(atol=4e-3, rtol=1e-2)
PAGED_MAIN_BF16_TOL = dict(atol=1e-3, rtol=1e-2)
# The bf16 paged kernels keep p as hi + lo bf16 halves in P.V. Without the
# lo half each weight moves by up to 2^-9 of itself, which
# PAGED_MAIN_BF16_TOL cannot see, but the mean error over a main-path
# call's outputs can: against the f32 version on the same bf16 inputs the
# kernel's mean |error| must stay within PAGED_MEAN_ERR_MARGIN x that of the
# plain split form in bf16 (which rounds only its output). An emulation of
# the kernel's arithmetic on the CPU at 8 lanes, H32/8 and H40/40
# (tools/paged_holds.py --emulate), gives 1.000005x with the lo half and
# 1.478x without it.
PAGED_MEAN_ERR_MARGIN = 1.1
# Backward main path, bf16 at S=4096: the largest |dq|, |dk|, |dv| there are
# ~4, 5.5 and 10. rtol 1e-2 covers one bf16 ulp of the output (at most
# 2^-7 |g|); atol the values near 0. Largest errors of the tensor-core
# kernels on an H100: dk 1.6e-2, dv 3.1e-2, dq 7.8e-3, each one ulp of a
# value in [2, 4), [4, 8) and [1, 2); a dropped ragged kv tile or a
# skipped diagonal mask gave 1.1 and 776 (dq, at the feature cases).
FLASH_BWD_MAIN_BF16_TOL = dict(atol=2e-3, rtol=1e-2)
# (B, S, H, KVH, hd, window): tests/test_kernels.py FLASH_BWD_CASES, f32
FLASH_BWD_CASES = [
    (1, 128, 2, 2, 32, 0),
    (1, 128, 4, 2, 32, 0),
    (1, 128, 4, 1, 64, 32),
    (1, 192, 2, 2, 32, 0),
]
# the JAX test's own tolerance for the backward kernels
FLASH_BWD_F32_TOL = dict(atol=1e-4, rtol=1e-4)
# (B, S, inner, N, dtype): tests/test_kernels.py SSM_CASES (the JAX test's
# chunk column has no counterpart: the kernel stages S in tiles of its own)
SSM_CASES = [
    (2, 128, 256, 16, torch.float32),
    (1, 96, 128, 8, torch.float32),
    (2, 64, 512, 16, torch.float32),
    (1, 128, 256, 16, torch.bfloat16),
]
# (B, H, S, hd, dtype): tests/test_kernels.py MLSTM_CASES (the JAX test's
# chunk column has no counterpart: each kernel variant picks its own chunk)
MLSTM_CASES = [
    (2, 2, 128, 64, torch.float32),
    (1, 4, 64, 32, torch.float32),
    (2, 1, 96, 128, torch.float32),
    (1, 2, 128, 64, torch.bfloat16),
]
# the mLSTM kernel's stabiliser m (as the JAX test holds it) and its f32
# state C, n (the CPU parity tests' state tolerance); h takes tol(dtype)
MLSTM_M_TOL = dict(atol=1e-3, rtol=1e-3)
MLSTM_STATE_TOL = dict(atol=1e-4, rtol=1e-4)
# xlstm-350m's prefill shape (B8 S4096 H4 hd512, q/k/v bf16) against the
# plain chunkwise form at the model's chunk 256: both see the same bf16
# inputs and sum in f32 in other orders (chunk 64 vs 256), so h (bf16) may
# differ by one bf16 ulp (rtol 1e-2 covers 2^-7 |h|) and the state by f32
# rounding over 4096 steps.
MLSTM_MAIN_H_TOL = dict(atol=1e-3, rtol=1e-2)
MLSTM_MAIN_STATE_TOL = dict(atol=1e-4, rtol=1e-3)
MLSTM_MAIN_TOLS = dict(h=MLSTM_MAIN_H_TOL, C=MLSTM_MAIN_STATE_TOL, n=MLSTM_MAIN_STATE_TOL,
                       m=MLSTM_M_TOL)
# calls the split-TF32 mLSTM is timed over at the prefill shape in f32
MLSTM_F32_REPS = 20
# the mLSTM's gradient against an f64 witness: mlstm_chunkwise_bwd_ref on
# the same inputs (the forward kernel's h among them) made f64, so that a
# reading is the kernel's own rounding alone. An f32 output (dgates, the
# start state's dC0, dn0 and dm0, and dq, dk, dv in f32) sums terms up to
# its largest value in size, so atol is taken times max(1, max |witness|)
# of that output (q x 20, the rarely clamped case, makes dk's terms
# hundreds of times larger; df~ is a reverse cumsum over up to 64 steps).
# On the CPU the plain version in f32 reaches at most 0.879 of this limit
# against the witness (dm0, which cancels to far under its terms: B2 H1 S96
# hd128 bf16 with a state) and 0.271 on any other output (12 cases, 3
# seeds). The bf16 dq, dk, dv (one rounding each) against the witness
# rounded to bf16, at tol(bf16), at the training shape at MLSTM_MAIN_H_TOL.
MLSTM_BWD_TOL = dict(atol=5e-5, rtol=1e-4)
# xlstm-350m's training microbatch: B1 S4096 H4 hd512
XLSTM_TRAIN_MLSTM = dict(B=1, S=4096, H=4, hd=512)
# calls the mLSTM backward is timed over at that shape
MLSTM_BWD_REPS = 20
# the sLSTM kernels against their plain versions in f32 at the small shapes
# (the reduced width, d = 128): the same f32 function in another order of
# each step's product (h r: 128 terms; dpre r^T: 512)
SLSTM_TOL = dict(atol=1e-5, rtol=1e-4)
# The backward's small shapes are held against an f64 witness (the plain
# version on the same inputs made f64), within SLSTM_MAIN_MARGIN x the plain
# f32 version's own error, as the main shapes are, where two right f32
# orders cannot meet SLSTM_TOL: dr (h dpre summed over the B S steps) at
# every shape, and every output at S >= SLSTM_WITNESS_S (a long reverse
# recurrence from a start state). ``tools/slstm_holds.py --draws 3`` on an
# H100 (4 draws of SLSTM_CASES): dr up to 3.1x SLSTM_TOL's limit off the
# plain version, dwx and dm0 1.6x at B2 S200 with a state, where the kernel
# and the plain f32 were both 2.8e-4 off the witness; the kernel's error at
# most 1.26x the plain's for dr and 1.15x at S200. Elsewhere SLSTM_TOL
# (every other output at S <= 64 within 0.16 of its limit), since at
# S <= 5, where both err by 1-2 ulps, the kernel's came up to 1.74x the
# plain's.
SLSTM_WITNESS_S = 200
SLSTM_D = 128
# a width at which the backward keeps a thread's third unit's r in shared
# memory (640 / 256 units a thread, two in registers), held against the
# f64 witness as the main shapes are
SLSTM_SMEM_D = 640
# (B, S) at SLSTM_D, each with and without a start state; B10 takes two of
# the forward's 8-row passes over r and three of the backward's 4-row tiles
SLSTM_CASES = [(1, 1), (3, 1), (2, 5), (3, 64), (1, 200), (2, 200), (10, 20)]
# xlstm-350m's sLSTM at the main path's shapes (d 1024): prefill B8 S4096,
# training's microbatch B1 S4096. There each output is held against an f64
# witness (the plain version on the same inputs made f64): the kernel's
# largest error at most SLSTM_MAIN_MARGIN x the plain f32 version's own
SLSTM_MAIN = {"prefill": (8, 4096), "training": (1, 4096)}
SLSTM_MAIN_D = 1024
SLSTM_MAIN_MARGIN = 2.0
# In those witness holds the plain f32 version's error counts as at least
# SLSTM_ULP_FLOOR f32 ulps of the output's largest |value|: where both err
# by an ulp or two (a step or two), their ratio is noise (an H100 run: the
# kernel's dr 1.75x the plain's at B1 S1 with a state, 2.1 ulps against 1.2)
SLSTM_ULP_FLOOR = 2
# decode's step (B8 S1 d1024) from a start state, both a drawn one and the
# prefill's final state, at SLSTM_TOL against the plain version
SLSTM_DECODE = (8, 1)
# calls each sLSTM kernel is timed over at the main path's shapes
SLSTM_REPS = 20
# the sLSTM at a width that 32 does not divide (200: padded to 224, 28
# blocks of 8 units) and past d 1056, where the wide grids run (16 units a
# block at d 1152 and 2048, 32 at 4096): (d, B, S, with a start state),
# held as the d-128 cases are (SLSTM_TOL; against the f64 witness at S >=
# SLSTM_WITNESS_S and for dr); timed at SLSTM_WIDE_TIMED (d, B, S)
SLSTM_WIDE_CASES = ([(d, B, 256, st) for d in (200, 1152, 2048) for B in (1, 8)
                     for st in (False, True)]
                    + [(1152, 1, 4096, False), (4096, 1, 64, False), (4096, 1, 64, True)])
SLSTM_WIDE_TIMED = [(200, 8, 256), (1152, 1, 256), (1152, 8, 256), (1152, 1, 4096),
                    (2048, 1, 256), (2048, 8, 256), (4096, 1, 64)]
SLSTM_WIDE_REPS = 5
# the model-level hold at a wide d: xlstm-350m laid out as BlockKind.SLSTM
# at d 1152 (6 heads: the mLSTM's head dim 384, within its kernels' 512), 4
# layers (2 groups of an mLSTM and an sLSTM block), f32
SLSTM_WIDE_MODEL = dict(d_model=1152, num_heads=6, num_kv_heads=6, num_layers=4,
                        slstm_every=2)
# the JAX test's tolerance for the scan's final state (y takes tol(dtype))
SSM_H_TOL = dict(atol=1e-4, rtol=1e-4)
# hymba's main-path shapes (u bf16, dt/B_/C_ f32), held tighter than the
# JAX test's after a first H100 run showed the errors: y (bf16) up to one
# bf16 ulp (3.1e-2 at |y| in [4, 8); 6.25e-2 in [8, 16)), which rtol 1e-2
# covers (an ulp is at most 2^-7 |y|); h (f32) up to 7.7e-7 with expf,
# 2.9e-6 with ex2.approx, against 1e-5 here.
SSM_MAIN_Y_TOL = dict(atol=1e-3, rtol=1e-2)
SSM_MAIN_H_TOL = dict(atol=1e-5, rtol=1e-5)
# the scan's gradient against ssm_scan_bwd_ref (f32, exp): the f32 outputs
# at the test cases as the JAX test holds h; du (u's dtype) at tol(dtype).
# At hymba's training shape g runs 4096 steps and dB_, dC_ sum 3200
# channels, each term off by ex2.approx's few ulps: rtol 1e-3; du (bf16)
# within one bf16 ulp, as y is.
SSM_BWD_TOL = dict(atol=1e-4, rtol=1e-4)
SSM_BWD_MAIN_TOL = dict(atol=1e-3, rtol=1e-3)
# hymba-1.5b's training microbatch: B1 S4096, inner 3200, N16, u bf16
HYMBA_TRAIN_SCAN = dict(B=1, S=4096, inner=3200, N=16)
# The forward's lse (f32, natural log, ~5-10 here) is computed from the same
# rounded inputs on both sides at every dtype, so the f32 tolerance holds.
LSE_TOL = F32_TOL


# fields a reduced config keeps from the full one: gemma's head dim 256
# (``reduced()`` sets 32), so that the reduced runs take the hd-256 kernels
REDUCED_KEEPS = {"gemma-7b": ("head_dim",)}


def reduced_f32(cfg):
    """``cfg.reduced()`` at f32, keeping the fields REDUCED_KEEPS names."""
    keep = {f: getattr(cfg, f) for f in REDUCED_KEEPS.get(cfg.name, ())}
    return dataclasses.replace(cfg.reduced(), dtype="float32", **keep)


def tol(dtype) -> dict:
    """The repository's kernel tolerances at its test shapes (tests/test_kernels.py)."""
    return dict(atol=2e-2, rtol=2e-2) if dtype == torch.bfloat16 else F32_TOL


def log(msg: str) -> None:
    print(msg, flush=True)


def within(out: torch.Tensor, ref: torch.Tensor, t: dict) -> tuple:
    """(max abs error, whether out is finite and |out - ref| <= atol + rtol
    |ref| everywhere)."""
    a, b = out.float(), ref.float()
    err = float((a - b).abs().max())
    ok = bool(torch.isfinite(a).all() and torch.all((a - b).abs() <= t["atol"] + t["rtol"] * b.abs()))
    return err, ok


def limit_frac(out: torch.Tensor, ref: torch.Tensor, t: dict) -> float:
    """The largest |out - ref| / (atol + rtol |ref|): at most 1 where ``t`` holds."""
    a, b = out.double(), ref.double()
    return float(((a - b).abs() / (t["atol"] + t["rtol"] * b.abs())).max())


def hold(name: str, out: torch.Tensor, ref: torch.Tensor, t: dict) -> float:
    """Raise unless out is finite and |out - ref| <= atol + rtol |ref|
    everywhere; return the max abs error."""
    err, ok = within(out, ref, t)
    log(f"  {name}: max_abs_err={err:.3e} (atol={t['atol']}, rtol={t['rtol']}) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with its plain version")
    return err


def time_each(fn, flush: torch.Tensor, reps: int = 10, warmup: int = 2,
              clean: bool = False) -> list:
    """Device time of each of ``reps`` calls, CUDA events around each call,
    with the L2 cache flushed before each (the main path finds it cold): by
    writing the 256 MB buffer, or with ``clean`` by reading it, so that no
    dirty line is written back during the call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        if clean:
            flush.max()
        else:
            flush.zero_()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return [s.elapsed_time(e) for s, e in pairs]


def time_ms(fn, flush: torch.Tensor, reps: int = 10, warmup: int = 2,
            clean: bool = False) -> float:
    """Mean device time of one call (``time_each``)."""
    return sum(time_each(fn, flush, reps, warmup, clean)) / reps


def spread(times: list) -> tuple:
    """(min, median, max) of a list of times."""
    xs = sorted(times)
    return xs[0], xs[len(xs) // 2], xs[-1]


def fmt_spread(times: list) -> str:
    return "min {:.4f} / median {:.4f} / max {:.4f} ms".format(*spread(times))


def bound(flops: float, nbytes: float, peak_flops: float) -> tuple:
    t_ops, t_bytes = flops / peak_flops * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _counters() -> dict:
    """Every kernel variant's launch counter, as (module, attribute), by the
    name its JSON record carries."""
    from repro_torch.kernels.flash_attention import kernel, kernel_bwd
    from repro_torch.kernels.mlstm import kernel as mlstm
    from repro_torch.kernels.paged_attention import kernel as paged
    from repro_torch.kernels.slstm import kernel as slstm
    from repro_torch.kernels.ssm_scan import kernel as scan

    return {"flash_attention_tc": (kernel, "launches_tc"),
            "flash_attention_tf32": (kernel, "launches_tf32"),
            "paged_attention_tc": (paged, "launches_tc"),
            "paged_attention_fma": (paged, "launches_fma"),
            "paged_attention_int8_tc": (paged, "launches_int8_tc"),
            "paged_attention_int8_fma": (paged, "launches_int8_fma"),
            "flash_attention_bwd_dkdv_tc": (kernel_bwd, "launches_dkdv_tc"),
            "flash_attention_bwd_dkdv_tf32": (kernel_bwd, "launches_dkdv_tf32"),
            "flash_attention_bwd_dq_tc": (kernel_bwd, "launches_dq_tc"),
            "flash_attention_bwd_dq_tf32": (kernel_bwd, "launches_dq_tf32"),
            "ssm_scan": (scan, "launches"), "mlstm_tc": (mlstm, "launches_tc"),
            "mlstm_tf32": (mlstm, "launches_tf32"), "mlstm_step": (mlstm, "launches_step"),
            "ssm_scan_bwd": (scan, "launches_bwd"), "mlstm_bwd": (mlstm, "launches_bwd"),
            "slstm": (slstm, "launches"), "slstm_bwd": (slstm, "launches_bwd")}


def reset_launches() -> None:
    """Set every kernel wrapper's launch counts to 0."""
    for module, attr in _counters().values():
        setattr(module, attr, 0)


def read_launches() -> dict:
    """Every kernel variant's launch count, by the name its JSON record carries."""
    return {name: getattr(module, attr) for name, (module, attr) in _counters().items()}


def expect_launches(**counts) -> dict:
    """The launch counts of a path: ``counts`` for the kernels named, 0 for the rest."""
    want = dict.fromkeys(read_launches(), 0)
    want.update(counts)
    return want


def hold_f32_launches(tag: str, launches: dict, *kernels: str) -> dict:
    """A reduced f32 run on the card: each of ``kernels`` launched, and
    the tensor-core variants (bf16 only) never."""
    log(f"[{tag}] reduced f32 launches {launches}")
    tensor_cores = [n for n in launches if n.endswith("_tc")]
    if any(launches[n] for n in tensor_cores) or min(launches[k] for k in kernels) <= 0:
        raise AssertionError(f"reduced f32 {tag}: not only the f32 variants of {kernels} ran")
    return launches


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def hold_fwd(name: str, o, lse, q, k, v, kw: dict, t: dict) -> float:
    """The forward kernel's o (at ``t``) and lse (at ``LSE_TOL``) against
    ``attention_fwd_ref``; returns o's max abs error."""
    from repro_torch.kernels.flash_attention.ref import attention_fwd_ref

    ro, rlse = attention_fwd_ref(q, k, v, **kw)
    err = hold(name, o, ro, t)
    hold(f"{name} lse", lse, rlse, LSE_TOL)
    return err


def flash_work(B, S, H, KVH, hd, window=0, el=2) -> dict:
    """(flop, bytes) the causal self-attention's kernels need at this shape,
    by the cost functions beside them (``kernels/flash_attention/ops.py``):
    the forward's QK^T and PV, dk/dv's s, dp, dv, dk and dq's own product
    over the live (q, k) pairs; each input read and each output written
    once (``el`` bytes an element: bf16 unless told; lse and delta f32).
    The backward's 5 products are split over dkdv and dq so that their
    bounds add up to the whole backward's: that dq computes s and dp again
    (7 products in all, no atomics), and that the tensor-core kernels
    multiply hi and lo halves of p and ds, is each design's overhead, in
    its ms."""
    from repro_torch.kernels.flash_attention import ops

    kw = dict(B=B, Sq=S, Skv=S, H=H, KVH=KVH, hd=hd, window=window, el=el)
    return {"fwd": ops.fwd_cost(**kw), "dkdv": ops.dkdv_cost(**kw), "dq": ops.dq_cost(**kw)}


# the f32 forward's timed shapes (PERF.md row 1f): (tag, B, S, H, KVH, hd,
# window): qwen3-4b's attention at S 1000, gemma-7b's (hd 256), whisper-tiny's
# training, hymba-1.5b's training at S 1500 under its window
F32_FWD_SHAPES = [("S1000 H32/8 hd128", 1, 1000, 32, 8, 128, 0),
                  ("S1000 H16/16 hd256", 1, 1000, 16, 16, 256, 0),
                  ("whisper B4 S448 H6/6 hd64", 4, 448, 6, 6, 64, 0),
                  ("hymba B1 S1500 H25/5 hd64 w1024", 1, 1500, 25, 5, 64, 1024)]
# calls timed a shape: kernel and SDPA in turns, F32_FWD_ROUNDS rounds of
# F32_FWD_REPS calls each, so that each spread holds 2 x 20 calls
F32_FWD_ROUNDS, F32_FWD_REPS = 2, 20


def check_flash_f32(gen: torch.Generator, flush: torch.Tensor) -> tuple:
    """The f32 forward (``flash_fwd_tf32_kernel``) at F32_FWD_SHAPES against
    ``attention_fwd_ref`` (F32_TOL, lse at LSE_TOL); two calls give the same
    bits at each; its time (min, median, max over the rounds' calls) beside
    SDPA's f32 forward in turns (the band as a boolean mask under a
    window), the plain version's and both bounds (split TF32, and the f32
    FMA rate). Returns (the largest error, the record's fields at the first
    shape: the medians)."""
    from repro_torch.kernels.flash_attention import kernel
    from repro_torch.kernels.flash_attention.ref import _mask, attention_fwd_ref

    sdpa = torch.nn.functional.scaled_dot_product_attention
    err, record = 0.0, None
    log("[kernels] flash_attention_tf32 (the f32 forward) at its timed shapes")
    for tag, B, S, H, KVH, hd, window in F32_FWD_SHAPES:
        mk = lambda heads: torch.randn((B, S, heads, hd), generator=gen, device="cuda")
        q, k, v = mk(H), mk(KVH), mk(KVH)
        kw = dict(causal=True, window=window, q_offset=0)
        o, lse = kernel.flash_attention_fwd(q, k, v, **kw)
        torch.cuda.synchronize()
        err = max(err, hold_fwd(f"flash f32 {tag}", o, lse, q, k, v, kw, F32_TOL))
        o2, lse2 = kernel.flash_attention_fwd(q, k, v, **kw)
        same = torch.equal(o, o2) and torch.equal(lse, lse2)
        log(f"  flash f32 {tag}: two calls give the same bits: {same}")
        if not same:
            raise AssertionError(f"the f32 forward gave different bits at {tag}")
        flops, nbytes = flash_work(B, S, H, KVH, hd, window, el=4)["fwd"]
        b_ms, b_by = bound(flops, nbytes, PEAK_SPLIT_TF32_FLOPS)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        lib_kw = dict(attn_mask=_mask(S, S, True, window, 0, q.device)) if window else \
            dict(is_causal=True)
        ks, ls = [], []
        for _ in range(F32_FWD_ROUNDS):
            ks += time_each(lambda: kernel.flash_attention_fwd(q, k, v, **kw), flush,
                            reps=F32_FWD_REPS)
            ls += time_each(lambda: sdpa(qt, kt, vt, enable_gqa=True, **lib_kw), flush,
                            reps=F32_FWD_REPS)
        plain_ms = time_ms(lambda: attention_fwd_ref(q, k, v, **kw), flush, reps=3)
        med = spread(ks)[1]
        log(f"  flash_attention_tf32 at {tag}: kernel {fmt_spread(ks)}; SDPA f32 forward"
            f"{' (the band as a boolean mask)' if window else ''} {fmt_spread(ls)}; plain "
            f"(o, lse) {plain_ms:.4f} ms; bound {b_ms:.4f} ms ({b_by}, split TF32"
            f"{f32_fma_bound(flops, nbytes, PEAK_SPLIT_TF32_FLOPS)}); {flops / med / 1e9:.1f} "
            f"TFLOP/s at the median")
        if record is None:
            record = dict(ms=med, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                          library_ms=spread(ls)[1])
        del q, k, v, o, lse, o2, lse2, qt, kt, vt, lib_kw
        torch.cuda.empty_cache()
    return err, record


def check_flash(gen: torch.Generator, flush: torch.Tensor) -> list:
    """The forward's two variants (bf16: tensor cores on wgmma; f32: split
    TF32 on mma.sync) against ``attention_fwd_ref`` on the reference's
    cases and each feature of the kernels (head dims, window, q offset,
    ragged and non-causal lengths, S not a multiple of 128) in both dtypes,
    and at the main paths' shapes (the f32 ones in ``check_flash_f32``);
    one record per variant."""
    from repro_torch.kernels.flash_attention import kernel
    from repro_torch.kernels.flash_attention.ref import attention_fwd_ref

    def case(name, B, Sq, Skv, H, KVH, hd, causal, window, q_offset, dtype, t=None):
        q = torch.randn((B, Sq, H, hd), generator=gen, device="cuda").to(dtype)
        k = torch.randn((B, Skv, KVH, hd), generator=gen, device="cuda").to(dtype)
        v = torch.randn((B, Skv, KVH, hd), generator=gen, device="cuda").to(dtype)
        kw = dict(causal=causal, window=window, q_offset=q_offset)
        o, lse = kernel.flash_attention_fwd(q, k, v, **kw)
        torch.cuda.synchronize()
        return (q, k, v, kw), hold_fwd(name, o, lse, q, k, v, kw, t or tol(dtype))

    log("[kernels] flash_attention vs attention_fwd_ref (o and lse)")
    errs = {torch.float32: 0.0, torch.bfloat16: 0.0}
    for B, S, H, KVH, hd, causal, window, dtype in FLASH_CASES:
        _, e = case(f"flash B{B} S{S} H{H}/{KVH} hd{hd} w{window} {str(dtype)[6:]}",
                    B, S, S, H, KVH, hd, causal, window, 0, dtype)
        errs[dtype] = max(errs[dtype], e)
    for dtype in (torch.float32, torch.bfloat16):
        for args in FLASH_EXTRA_CASES:
            _, e = case(f"flash (B, Sq, Skv, H, KVH, hd, causal, window, q_offset) = {args} "
                        f"{str(dtype)[6:]}", *args, dtype)
            errs[dtype] = max(errs[dtype], e)
    e, f32_record = check_flash_f32(gen, flush)
    errs[torch.float32] = max(errs[torch.float32], e)
    main = {S: case(f"flash main-path S{S} H32/8 hd128 bf16",
                    1, S, S, 32, 8, 128, True, 0, 0, torch.bfloat16, FLASH_MAIN_BF16_TOL)
            for S in (129, 1000, 2000, 4096)}       # 2000: serving's longest; 4096: training
    errs[torch.bfloat16] = max([errs[torch.bfloat16], *(e for _, e in main.values())])
    errs[torch.bfloat16] = max(errs[torch.bfloat16], check_flash_hymba(gen, flush))

    def timed(args, peak, tag):
        q, k, v, kw = args
        B, S, H, hd = q.shape
        flops, nbytes = flash_work(B, S, H, k.shape[2], hd)["fwd"]
        b_ms, b_by = bound(flops, nbytes, peak)
        ms = time_ms(lambda: kernel.flash_attention_fwd(q, k, v, **kw), flush)
        plain_ms = time_ms(lambda: attention_fwd_ref(q, k, v, **kw), flush)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        lib_ms = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True), flush)
        log(f"  flash {tag} (B{B} S{S} H{H}/{k.shape[2]} hd{hd} {str(q.dtype)[6:]}): kernel "
            f"{ms:.4f} ms, plain (o, lse) {plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound "
            f"{b_ms:.4f} ms ({b_by}); {flops / ms / 1e9:.1f} TFLOP/s achieved")
        return dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)

    timed(main[4096][0], PEAK_BF16_FLOPS, "training shape")
    rec = dict(route="cuda", source="src/repro_torch/csrc/flash_attention.cu",
               replaces="src/repro/kernels/flash_attention/kernel.py:33")
    return [dict(rec, name="flash_attention_tc", max_abs_err=errs[torch.bfloat16],
                 **timed(main[2000][0], PEAK_BF16_FLOPS, "main path")),
            dict(rec, name="flash_attention_tf32", max_abs_err=errs[torch.float32],
                 **f32_record)]


def check_flash_hymba(gen: torch.Generator, flush: torch.Tensor) -> float:
    """The forward kernel at hymba-1.5b's prefill shape (B8 S4096 H25/5 hd64,
    window 1024, bf16); the plain version runs one batch row at a time (its
    S x S f32 scores are 1.7 GB a row). Beside it, one SDPA call with the
    band as a boolean mask. Returns the largest error."""
    from repro_torch.kernels.flash_attention import kernel
    from repro_torch.kernels.flash_attention.ref import _mask

    B, S, H, KVH, hd, window = 8, 4096, 25, 5, 64, 1024
    q = torch.randn((B, S, H, hd), generator=gen, device="cuda").to(torch.bfloat16)
    k = torch.randn((B, S, KVH, hd), generator=gen, device="cuda").to(torch.bfloat16)
    v = torch.randn((B, S, KVH, hd), generator=gen, device="cuda").to(torch.bfloat16)
    kw = dict(causal=True, window=window, q_offset=0)
    o, lse = kernel.flash_attention_fwd(q, k, v, **kw)
    torch.cuda.synchronize()
    err = max(hold_fwd(f"flash hymba prefill S{S} H{H}/{KVH} hd{hd} w{window} bf16 row {b}",
                       o[b:b + 1], lse[b:b + 1], q[b:b + 1], k[b:b + 1], v[b:b + 1], kw,
                       FLASH_MAIN_BF16_TOL) for b in range(B))
    del o, lse
    flops, nbytes = flash_work(B, S, H, KVH, hd, window)["fwd"]
    b_ms, b_by = bound(flops, nbytes, PEAK_BF16_FLOPS)
    ms = time_ms(lambda: kernel.flash_attention_fwd(q, k, v, **kw), flush)
    band = _mask(S, S, True, window, 0, q.device)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    lib_ms = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=band, enable_gqa=True), flush, reps=3, warmup=1)
    log(f"  flash hymba prefill (B{B} S{S} H{H}/{KVH} hd{hd} w{window} bf16): kernel {ms:.4f} ms, "
        f"sdpa (boolean band mask, enable_gqa) {lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}); "
        f"{flops / ms / 1e9:.1f} TFLOP/s achieved; max abs err {err:.3e}")
    return err


def check_flash_bwd(gen: torch.Generator, flush: torch.Tensor) -> list:
    """Both backward kernels against ``attention_bwd_ref`` on the same
    (q, k, v, o, lse, do, delta); o and lse from the forward kernel, held
    first against ``attention_fwd_ref``. Each kernel runs its wgmma
    variant in bf16 and its split-TF32 one (mma.sync) in f32: every feature
    case runs in both dtypes. One record per variant; the bf16 dq, and the
    f32 dq and dk/dv at S1000 hd128, give the same bits twice. The f32
    records' bound is split TF32's (PEAK_SPLIT_TF32_FLOPS), the f32 FMA
    bound logged beside it."""
    from repro_torch.kernels.flash_attention import kernel, kernel_bwd
    from repro_torch.kernels.flash_attention.ref import attention_bwd_ref

    def case(name, B, Sq, Skv, H, KVH, hd, causal, window, q_offset, dtype, t):
        q = torch.randn((B, Sq, H, hd), generator=gen, device="cuda").to(dtype)
        k = torch.randn((B, Skv, KVH, hd), generator=gen, device="cuda").to(dtype)
        v = torch.randn((B, Skv, KVH, hd), generator=gen, device="cuda").to(dtype)
        do = torch.randn((B, Sq, H, hd), generator=gen, device="cuda").to(dtype)
        kw = dict(causal=causal, window=window, q_offset=q_offset)
        o, lse = kernel.flash_attention_fwd(q, k, v, **kw)
        hold_fwd(f"{name} fwd", o, lse, q, k, v, kw,
                 F32_TOL if dtype == torch.float32 else FLASH_MAIN_BF16_TOL)
        delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
        dk, dv = kernel_bwd.flash_attention_bwd_dkdv(q, k, v, do, lse, delta, **kw)
        dq = kernel_bwd.flash_attention_bwd_dq(q, k, v, do, lse, delta, **kw)
        torch.cuda.synchronize()
        rq, rk, rv = attention_bwd_ref(q, k, v, o, lse, do, **kw)
        log(f"  {name}: max |ref| dq {float(rq.float().abs().max()):.3e} dk "
            f"{float(rk.float().abs().max()):.3e} dv {float(rv.float().abs().max()):.3e}")
        variant = "tc" if dtype == torch.bfloat16 else "tf32"
        errs["dkdv_" + variant] = max(errs["dkdv_" + variant], hold(f"{name} dk", dk, rk, t),
                                      hold(f"{name} dv", dv, rv, t))
        errs["dq_" + variant] = max(errs["dq_" + variant], hold(f"{name} dq", dq, rq, t))
        return q, k, v, do, lse, delta, kw

    log("[kernels] flash_attention_bwd (dkdv, dq) vs attention_bwd_ref")
    errs = {"dkdv_tc": 0.0, "dkdv_tf32": 0.0, "dq_tc": 0.0, "dq_tf32": 0.0}
    for B, S, H, KVH, hd, window in FLASH_BWD_CASES:
        case(f"bwd B{B} S{S} H{H}/{KVH} hd{hd} w{window} f32",
             B, S, S, H, KVH, hd, True, window, 0, torch.float32, FLASH_BWD_F32_TOL)
        case(f"bwd B{B} S{S} H{H}/{KVH} hd{hd} w{window} bf16",
             B, S, S, H, KVH, hd, True, window, 0, torch.bfloat16, tol(torch.bfloat16))
    case("bwd B1 S256 H4/2 hd64 bf16", 1, 256, 256, 4, 2, 64, True, 0, 0, torch.bfloat16,
         tol(torch.bfloat16))
    # tests/test_torch_flash_bwd.py BF16_CASES beyond the rows above, in both dtypes
    for dtype, t in ((torch.float32, FLASH_BWD_F32_TOL), (torch.bfloat16, tol(torch.bfloat16))):
        for args in FLASH_EXTRA_CASES + [(1, 200, 200, 4, 2, 32, True, 48, 0),
                                         (2, 333, 333, 8, 2, 128, True, 0, 0)]:
            case(f"bwd (B, Sq, Skv, H, KVH, hd, causal, window, q_offset) = {args} "
                 f"{str(dtype)[6:]}", *args, dtype, t)
    f32_args = case("bwd main-path S1000 H32/8 hd128 f32", 1, 1000, 1000, 32, 8, 128, True, 0,
                    0, torch.float32, FLASH_BWD_F32_TOL)
    hold_same_bits("bwd main-path S1000 H32/8 hd128 f32", *f32_args)
    q, k, v, do, lse, delta, kw = case(
        "bwd main-path S4096 H32/8 hd128 bf16", 1, 4096, 4096, 32, 8, 128, True, 0, 0,
        torch.bfloat16, FLASH_BWD_MAIN_BF16_TOL)
    dq_a, dq_b = (kernel_bwd.flash_attention_bwd_dq(q, k, v, do, lse, delta, **kw)
                  for _ in range(2))
    same = torch.equal(dq_a, dq_b)
    log(f"  bwd main-path S4096 bf16: two dq calls give the same bits: {same}")
    if not same:
        raise AssertionError("the bf16 dq kernel gave different bits on the same inputs")
    del dq_a, dq_b

    def work(q, k):
        """The function's least work (``flash_work``): 5 products split over
        the dkdv and dq rows."""
        B, S, H, hd = q.shape
        return flash_work(B, S, H, k.shape[2], hd, el=q.element_size())

    o, _ = kernel.flash_attention_fwd(q, k, v, **kw)
    plain_ms = time_ms(lambda: attention_bwd_ref(q, k, v, o, lse, do, **kw), flush, reps=3)
    lib_ms = sdpa_backward_ms(q, k, v, do, flush)
    w = work(q, k)
    fused_ms, fused_by = bound(5 * w["dq"][0], w["dkdv"][1] + w["dq"][1], PEAK_BF16_FLOPS)
    log(f"  flash backward main path (B1 S4096 H32/8 hd128 bf16): plain attention_bwd_ref "
        f"{plain_ms:.4f} ms; SDPA flash backward {lib_ms:.4f} ms (autograd fwd+bwd minus fwd, "
        f"k/v repeated to 32 heads); bound of the whole backward (5 products) "
        f"{fused_ms:.4f} ms ({fused_by})")
    q32, k32, v32, do32, lse32, delta32, kw32 = f32_args
    o32, _ = kernel.flash_attention_fwd(q32, k32, v32, **kw32)
    plain32_ms = time_ms(lambda: attention_bwd_ref(q32, k32, v32, o32, lse32, do32, **kw32),
                         flush, reps=3)
    lib32_ms = sdpa_backward_ms(q32, k32, v32, do32, flush)
    runs = {"dkdv_tc": ((q, k, v, do, lse, delta, kw), "dkdv", PEAK_BF16_FLOPS, plain_ms, lib_ms),
            "dq_tc": ((q, k, v, do, lse, delta, kw), "dq", PEAK_BF16_FLOPS, plain_ms, lib_ms),
            "dkdv_tf32": (f32_args, "dkdv", PEAK_SPLIT_TF32_FLOPS, plain32_ms, lib32_ms),
            "dq_tf32": (f32_args, "dq", PEAK_SPLIT_TF32_FLOPS, plain32_ms, lib32_ms)}
    fns = {"dkdv": kernel_bwd.flash_attention_bwd_dkdv, "dq": kernel_bwd.flash_attention_bwd_dq}
    lines = {"dkdv": 55, "dq": 111}
    records = []
    for name, (args, which, peak, p_ms, l_ms) in runs.items():
        flops, nbytes = work(args[0], args[1])[which]
        b_ms, b_by = bound(flops, nbytes, peak)
        ms = time_ms(lambda: fns[which](*args[:6], **args[6]), flush)
        log(f"  {name} (S{args[0].shape[1]} {str(args[0].dtype)[6:]}): kernel {ms:.4f} ms, bound "
            f"{b_ms:.4f} ms ({b_by}{f32_fma_bound(flops, nbytes, peak)}); "
            f"{flops / ms / 1e9:.1f} TFLOP/s of the function's work achieved; plain "
            f"{p_ms:.4f} ms, SDPA backward {l_ms:.4f} ms (whole backward)")
        records.append(dict(
            name=f"flash_attention_bwd_{name}", route="cuda",
            source="src/repro_torch/csrc/flash_attention_bwd.cu",
            replaces=f"src/repro/kernels/flash_attention/kernel_bwd.py:{lines[which]}",
            max_abs_err=errs[name], ms=ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
            library_ms=l_ms))
    return records


def hold_same_bits(tag: str, q, k, v, do, lse, delta, kw) -> None:
    """Two calls of the f32 dk/dv and of the f32 dq on the same inputs give
    the same bits (each block owns its output tile: no atomics)."""
    from repro_torch.kernels.flash_attention import kernel_bwd

    for which, fn in (("dk/dv", kernel_bwd.flash_attention_bwd_dkdv),
                      ("dq", kernel_bwd.flash_attention_bwd_dq)):
        one, two = (fn(q, k, v, do, lse, delta, **kw) for _ in range(2))
        if not isinstance(one, tuple):
            one, two = (one,), (two,)
        same = all(torch.equal(x, y) for x, y in zip(one, two))
        log(f"  {tag}: two {which} calls give the same bits: {same}")
        if not same:
            raise AssertionError(f"the f32 {which} kernel gave different bits at {tag}")


# the f32 backward's and forward's outputs at these shapes, (B, S, H, KVH,
# hd), are logged as digests (``bwd_digests``, ``fwd_digests``): inputs made
# on the CPU from seed 0, with o and lse by the plain forward there for the
# backward, so that two builds of the kernels (before and after a change
# that must not move their bits) can be compared
BWD_DIGEST_SHAPES = [(1, 1000, 32, 8, 128), (1, 1000, 16, 16, 256)]


def bwd_digests() -> dict:
    """SHA-256 (16 hex digits) of the f32 dk, dv and dq at BWD_DIGEST_SHAPES,
    by the ``repro_torch`` on ``sys.path``; logged and returned."""
    import hashlib

    from repro_torch.kernels.flash_attention import kernel_bwd
    from repro_torch.kernels.flash_attention.ref import attention_fwd_ref

    out = {}
    for B, S, H, KVH, hd in BWD_DIGEST_SHAPES:
        g = torch.Generator().manual_seed(0)
        q, k, v, do = (torch.randn((B, S, n, hd), generator=g) for n in (H, KVH, KVH, H))
        o, lse = attention_fwd_ref(q, k, v)
        delta = (do * o).sum(-1).transpose(1, 2).contiguous()
        args = [t.cuda() for t in (q, k, v, do, lse, delta)]
        dk, dv = kernel_bwd.flash_attention_bwd_dkdv(*args)
        dq = kernel_bwd.flash_attention_bwd_dq(*args)
        # the CPU-made inputs too: the CPU's multithreaded sums may round
        # differently from one process to the next
        out[f"B{B} S{S} H{H}/{KVH} hd{hd}"] = {
            n: hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()[:16]
            for n, t in (("dk", dk), ("dv", dv), ("dq", dq), ("lse, delta", torch.cat(
                [lse.flatten(), delta.flatten()])))}
    log(f"[kernels] f32 flash backward digests (inputs made on the CPU, seed 0): {out}")
    return out


def fwd_digests() -> dict:
    """SHA-256 (16 hex digits) of the f32 forward's o and lse at
    BWD_DIGEST_SHAPES (causal), by the ``repro_torch`` on ``sys.path``;
    logged and returned."""
    import hashlib

    from repro_torch.kernels.flash_attention import kernel

    out = {}
    for B, S, H, KVH, hd in BWD_DIGEST_SHAPES:
        g = torch.Generator().manual_seed(0)
        q, k, v = (torch.randn((B, S, n, hd), generator=g) for n in (H, KVH, KVH))
        o, lse = kernel.flash_attention_fwd(q.cuda(), k.cuda(), v.cuda(), causal=True)
        out[f"B{B} S{S} H{H}/{KVH} hd{hd}"] = {
            n: hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()[:16]
            for n, t in (("o", o), ("lse", lse))}
    log(f"[kernels] f32 flash forward digests (inputs made on the CPU, seed 0): {out}")
    return out


def peak_flops(record: str) -> float:
    """The rate a record's bound counts its operations at: bf16
    tensor cores (``_tc``), split TF32 (``_tf32``), else f32 FMAs."""
    if record.endswith("_tc"):
        return PEAK_BF16_FLOPS
    return PEAK_SPLIT_TF32_FLOPS if record.endswith("_tf32") else PEAK_F32_FLOPS


def f32_fma_bound(flops: float, nbytes: float, peak: float) -> str:
    """For a split-TF32 record: its bound at the f32 FMA rate, as text to log
    beside the record's own bound (empty for any other peak)."""
    if peak != PEAK_SPLIT_TF32_FLOPS:
        return ""
    ms, by = bound(flops, nbytes, PEAK_F32_FLOPS)
    return f"; at the f32 FMA rate {ms:.4f} ms ({by})"


def sdpa_backward_ms(q, k, v, do, flush, mask=None) -> float:
    """PyTorch's SDPA backward at the same shapes: autograd through
    ``scaled_dot_product_attention`` (fwd + bwd) minus its forward alone,
    with k and v repeated to H heads; causal, or with ``mask`` (a boolean
    band) as ``attn_mask``; the flash backend in bf16 and causal, the
    memory-efficient one in f32 or with a mask (flash takes neither)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    G = q.shape[2] // k.shape[2]
    qt = q.transpose(1, 2).detach().requires_grad_()
    kt = k.repeat_interleave(G, dim=2).transpose(1, 2).detach().requires_grad_()
    vt = v.repeat_interleave(G, dim=2).transpose(1, 2).detach().requires_grad_()
    dot = do.transpose(1, 2)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    backend = (SDPBackend.FLASH_ATTENTION if q.dtype == torch.bfloat16 and mask is None
               else SDPBackend.EFFICIENT_ATTENTION)
    kw = dict(is_causal=True) if mask is None else dict(attn_mask=mask)

    def fwd_bwd():
        for t in (qt, kt, vt):
            t.grad = None
        sdpa(qt, kt, vt, **kw).backward(dot)

    with sdpa_kernel(backend):
        both = time_ms(fwd_bwd, flush)
        with torch.no_grad():
            fwd = time_ms(lambda: sdpa(qt, kt, vt, **kw), flush)
    return both - fwd


# mixtral-8x7b's training shape: B1 S8192 H32/8 hd128, window 4096, bf16
MOE_ATTN = dict(B=1, S=8192, H=32, KVH=8, hd=128, window=4096)


def check_flash_window_8192(gen: torch.Generator, flush: torch.Tensor) -> dict:
    """The forward, dk/dv and dq tensor-core kernels at mixtral-8x7b's
    training shape against their plain versions, which run one kv head's
    group of query heads at a time (a group's S x S f32 scores are 1.07 GB);
    the kernels' times beside their bounds and SDPA's with the band as a
    boolean mask (the memory-efficient backend: flash takes no mask).
    Returns the largest errors, by record name."""
    from repro_torch.kernels.flash_attention import kernel, kernel_bwd
    from repro_torch.kernels.flash_attention.ref import _mask, attention_bwd_ref, attention_fwd_ref

    B, S, H, KVH, hd, window = (MOE_ATTN[k] for k in ("B", "S", "H", "KVH", "hd", "window"))
    G = H // KVH
    mk = lambda heads: torch.randn((B, S, heads, hd), generator=gen,
                                   device="cuda").to(torch.bfloat16)
    q, k, v, do = mk(H), mk(KVH), mk(KVH), mk(H)
    kw = dict(causal=True, window=window, q_offset=0)
    o, lse = kernel.flash_attention_fwd(q, k, v, **kw)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    dk, dv = kernel_bwd.flash_attention_bwd_dkdv(q, k, v, do, lse, delta, **kw)
    dq = kernel_bwd.flash_attention_bwd_dq(q, k, v, do, lse, delta, **kw)
    torch.cuda.synchronize()
    log(f"[kernels] flash forward and backward at mixtral's training shape (B{B} S{S} "
        f"H{H}/{KVH} hd{hd} w{window} bf16) vs the plain versions, one kv group at a time")
    errs = {"flash_attention_tc": 0.0, "flash_attention_bwd_dkdv_tc": 0.0,
            "flash_attention_bwd_dq_tc": 0.0}
    for g in range(KVH):
        hs, ks = slice(g * G, (g + 1) * G), slice(g, g + 1)
        tag = f"flash S{S} w{window} bf16 kv group {g}"
        ro, rlse = attention_fwd_ref(q[:, :, hs], k[:, :, ks], v[:, :, ks], **kw)
        e = hold(tag, o[:, :, hs], ro, FLASH_MAIN_BF16_TOL)
        hold(f"{tag} lse", lse[:, hs], rlse, LSE_TOL)
        errs["flash_attention_tc"] = max(errs["flash_attention_tc"], e)
        del ro, rlse
        rq, rk, rv = attention_bwd_ref(q[:, :, hs], k[:, :, ks], v[:, :, ks], o[:, :, hs],
                                       lse[:, hs], do[:, :, hs], **kw)
        errs["flash_attention_bwd_dkdv_tc"] = max(
            errs["flash_attention_bwd_dkdv_tc"],
            hold(f"{tag} dk", dk[:, :, ks], rk, FLASH_BWD_MAIN_BF16_TOL),
            hold(f"{tag} dv", dv[:, :, ks], rv, FLASH_BWD_MAIN_BF16_TOL))
        errs["flash_attention_bwd_dq_tc"] = max(
            errs["flash_attention_bwd_dq_tc"],
            hold(f"{tag} dq", dq[:, :, hs], rq, FLASH_BWD_MAIN_BF16_TOL))
        del rq, rk, rv
    del o, dk, dv, dq
    torch.cuda.empty_cache()

    # bounds: the forward's 2 products over the live pairs; the backward's
    # 5 split as check_flash_bwd splits them (dkdv: s, dp, dv, dk; dq: dq)
    w = flash_work(B, S, H, KVH, hd, window)
    work = {"flash_attention_tc": w["fwd"], "flash_attention_bwd_dkdv_tc": w["dkdv"],
            "flash_attention_bwd_dq_tc": w["dq"]}
    fns = {"flash_attention_tc": lambda: kernel.flash_attention_fwd(q, k, v, **kw),
           "flash_attention_bwd_dkdv_tc": lambda: kernel_bwd.flash_attention_bwd_dkdv(
               q, k, v, do, lse, delta, **kw),
           "flash_attention_bwd_dq_tc": lambda: kernel_bwd.flash_attention_bwd_dq(
               q, k, v, do, lse, delta, **kw)}
    band = _mask(S, S, True, window, 0, q.device)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    sdpa_fwd = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=band, enable_gqa=True), flush, reps=3, warmup=1)
    sdpa_bwd = sdpa_backward_ms(q, k, v, do, flush, mask=band)
    times = {}
    for name, (flops, nbytes) in work.items():
        b_ms, b_by = bound(flops, nbytes, PEAK_BF16_FLOPS)
        ms = time_ms(fns[name], flush)
        times[name] = dict(ms=ms, bound_ms=b_ms, bound_by=b_by)
        log(f"  {name} at B{B} S{S} H{H}/{KVH} hd{hd} w{window} bf16: kernel {ms:.4f} ms, "
            f"bound {b_ms:.4f} ms ({b_by}); {flops / ms / 1e9:.1f} TFLOP/s of the function's "
            f"work achieved")
    log(f"  SDPA with the band as a boolean mask (memory-efficient backend, GQA): forward "
        f"{sdpa_fwd:.4f} ms; backward (fwd + bwd minus fwd, k/v repeated to {H} heads) "
        f"{sdpa_bwd:.4f} ms; largest errors {errs}")
    return errs


def _paged_inputs(gen, B, H, KVH, hd, ps, mb, lens, dtype, seed):
    rng = np.random.RandomState(seed)
    num_pages = B * mb + 1
    q = torch.randn((B, H, hd), generator=gen, device="cuda").to(dtype)
    kp = torch.randn((num_pages, ps, KVH, hd), generator=gen, device="cuda").to(dtype)
    vp = torch.randn((num_pages, ps, KVH, hd), generator=gen, device="cuda").to(dtype)
    perm = rng.permutation(B * mb)
    table = np.full((B, mb), -1, np.int32)
    for b, n in enumerate(lens):
        used = -(-n // ps)
        table[b, :used] = perm[b * mb: b * mb + used]
    return (q, kp, vp, torch.as_tensor(table, device="cuda"),
            torch.as_tensor(np.asarray(lens, np.int32), device="cuda"))


def hold_mean_err(name: str, out: torch.Tensor, ref32: torch.Tensor,
                  plain: torch.Tensor) -> float:
    """Raise unless the bf16 ``out``'s mean |error| against the f32
    ``ref32`` is within PAGED_MEAN_ERR_MARGIN x the bf16 ``plain``'s; return
    the ratio."""
    e_out = float((out.float() - ref32).abs().mean())
    e_plain = float((plain.float() - ref32).abs().mean())
    ratio = e_out / e_plain
    ok = ratio <= PAGED_MEAN_ERR_MARGIN
    log(f"  {name}: mean abs error against f32 on the same inputs {e_out:.6e}, the plain split "
        f"form's in bf16 {e_plain:.6e}: {ratio:.6f}x (limit {PAGED_MEAN_ERR_MARGIN}x) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: the mean error is {ratio:.4f}x the plain version's")
    return ratio


def hold_no_farther(name: str, out: torch.Tensor, other: torch.Tensor,
                    exact32: torch.Tensor) -> None:
    """Raise unless ``out`` is no farther from the f32 ``exact32`` than
    ``other`` is, in its largest and in its mean |error|."""
    e_out, e_other = (out.float() - exact32).abs(), (other.float() - exact32).abs()
    worst, mean = (float(e_out.max()), float(e_other.max())), (float(e_out.mean()),
                                                               float(e_other.mean()))
    ok = worst[0] <= worst[1] and mean[0] <= mean[1]
    log(f"  {name}: against f32 on the same inputs, largest |error| {worst[0]:.6e} against the "
        f"gather path's {worst[1]:.6e}, mean {mean[0]:.6e} against {mean[1]:.6e} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: farther from the f32 attention than the gather path")


def check_paged(gen: torch.Generator, flush: torch.Tensor) -> list:
    """The split-and-merge paged kernel in both dtypes (bf16 on tensor
    cores, f32 on FMAs) against ``paged_attention_ref`` on the reference's cases, the
    split's edges, a dead lane and the serving main path's shape; at that
    shape also against the plain split form, two calls giving the same
    bits and, in bf16, the mean error (``hold_mean_err``). One record per
    dtype."""
    from repro_torch.kernels.paged_attention import kernel
    from repro_torch.kernels.paged_attention import ops as paged_ops
    from repro_torch.kernels.paged_attention.ref import (paged_attention_ref,
                                                         paged_attention_split_ref)

    log("[kernels] paged_attention (split over positions, then merge; bf16 mma.sync, f32 FMA) "
        "vs paged_attention_ref")
    errs = {torch.float32: 0.0, torch.bfloat16: 0.0}
    for B, H, KVH, hd, ps, mb, lens, dtype in PAGED_CASES:
        args = _paged_inputs(gen, B, H, KVH, hd, ps, mb, lens, dtype, seed=0)
        errs[dtype] = max(errs[dtype], hold(
            f"paged B{B} H{H}/{KVH} hd{hd} ps{ps} lens{lens} {str(dtype)[6:]}",
            kernel.paged_attention(*args), paged_attention_ref(*args), tol(dtype)))
    # the split's edges at its segment of 128 positions: lengths 0 and 1,
    # one and two segments, one more position, every lane dead, pages of 8,
    # a page of 24 that straddles segments, a page of 256 that holds two
    for ps, mb, lens in ((16, 20, [0, 1, 128, 129]), (16, 20, [0, 0, 0, 0]),
                         (16, 20, [256, 257, 127, 5]), (8, 40, [128, 129, 0, 1]),
                         (24, 14, [128, 150, 143, 1]), (256, 2, [129, 300, 256, 0])):
        for dtype in (torch.float32, torch.bfloat16):
            args = _paged_inputs(gen, 4, 8, 2, 64, ps, mb, lens, dtype, seed=2)
            out = kernel.paged_attention(*args)
            errs[dtype] = max(errs[dtype], hold(
                f"paged split edges ps{ps} lens{lens} {str(dtype)[6:]}",
                out, paged_attention_ref(*args), tol(dtype)))
            if not all(bool((out[b] == 0).all()) for b, n in enumerate(lens) if n == 0):
                raise AssertionError(f"paged split edges lens{lens}: a dead lane is not zeros")

    q, kp, vp, table, sl = _paged_inputs(gen, 3, 4, 2, 32, 16, 3, [40, 17, 25], torch.float32, 0)
    full = kernel.paged_attention(q, kp, vp, table, sl)
    dead_sl = sl.clone()
    dead_sl[1] = 0
    out = kernel.paged_attention(q, kp, vp, table, dead_sl)
    hold("paged dead lane", out, paged_attention_ref(q, kp, vp, table, dead_sl), F32_TOL)
    if not (bool((out[1] == 0).all()) and torch.equal(out[0], full[0])
            and torch.equal(out[2], full[2])):
        raise AssertionError("paged dead lane: not exact zeros, or live lanes changed")
    log("  paged dead lane: exact zeros, live lanes bit-identical")

    rng = np.random.RandomState(1)
    lens = [2048] + rng.randint(1, 2049, 7).tolist()
    main = {}
    for dtype, t in ((torch.float32, F32_TOL), (torch.bfloat16, PAGED_MAIN_BF16_TOL)):
        args = main[dtype] = _paged_inputs(gen, 8, 32, 8, 128, 16, 128, lens, dtype, seed=1)
        name = f"paged main-path 8 lanes H32/8 hd128 ps16 lens{lens} {str(dtype)[6:]}"
        out = kernel.paged_attention(*args)
        errs[dtype] = max(errs[dtype], hold(name, out, paged_attention_ref(*args), t))
        hold(f"{name} vs the plain split form", out, paged_attention_split_ref(*args), t)
        same = torch.equal(out, kernel.paged_attention(*args))
        log(f"  {name}: two calls give the same bits: {same}")
        if not same:
            raise AssertionError("the paged kernel gave different bits on the same inputs")
        if dtype == torch.bfloat16:
            q, kp, vp, table, sl = args
            hold_mean_err(name, out, paged_attention_ref(q.float(), kp.float(), vp.float(), table,
                                                         sl), paged_attention_split_ref(*args))

    n_tok = sum(lens)
    n_pages = sum(-(-n // 16) for n in lens)
    records = []
    for dtype in (torch.bfloat16, torch.float32):
        args = main[dtype]
        el = args[0].element_size()
        flops, nbytes = paged_ops.cost(8, 32, 8, 128, n_tok, n_pages, el=el)
        b_ms, b_by = bound(flops, nbytes, PEAK_BF16_FLOPS if el == 2 else PEAK_F32_FLOPS)
        ms = time_ms(lambda: kernel.paged_attention(*args), flush)
        clean_ms = time_ms(lambda: kernel.paged_attention(*args), flush, clean=True)
        plain_ms = time_ms(lambda: paged_attention_ref(*args), flush)
        log(f"  paged main path (8 lanes, {n_tok} cached tokens, {str(dtype)[6:]}): kernel "
            f"{ms:.4f} ms (split + merge; {clean_ms:.4f} ms after a read-only flush), plain "
            f"{plain_ms:.4f} ms, bound {b_ms:.4f} ms "
            f"({b_by}); {nbytes / ms / 1e6:.1f} GB/s achieved; device time per launch "
            f"(profiler): " + ", ".join(
                f"{name} {t:.4f} ms" for name, t in _device_ms_per_launch(
                    lambda: kernel.paged_attention(*args), flush, "paged_").items()))
        records.append(dict(
            name=f"paged_attention_{'tc' if el == 2 else 'fma'}", route="cuda",
            source="src/repro_torch/csrc/paged_attention.cu",
            replaces="src/repro/kernels/paged_attention/kernel.py:35",
            max_abs_err=errs[dtype], ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
            library_ms=None))
    return records


def _device_ms_per_launch(fn, flush: torch.Tensor, key: str, reps: int = 5) -> dict:
    """Device time per launch of each kernel whose name holds ``key``, over
    ``reps`` calls of ``fn`` (L2 flushed before each), from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if key in e.key and getattr(e, "self_device_time_total", 0) > 0:
            name = re.search(r"(\w+)[<(]", e.key).group(1)   # the function's own name
            out[name] = e.self_device_time_total / e.count / 1e3
    return out


def phase11_lens() -> list:
    """The 8 lanes' attended lengths of phase 11's int8 attend
    (``scoped_equals_whole_pool``): one at 2048 positions, seven shorter."""
    return [n + 1 for n in [2047] + np.random.RandomState(5).randint(1, 1500, 7).tolist()]


def _int8_pools(args) -> tuple:
    """From ``_paged_inputs``' pools: the int8 call's arguments (q, codes and
    scales of k and v by ``layers._quantize_kv``, the scales in q's dtype as
    the engine writes them, table, lengths) and the bf16 or f32 call's on
    the pools ``layers._dequantize_kv`` makes of them."""
    from repro_torch.models import layers

    q, kp, vp, table, sl = args
    codes, deq = [], []
    for pool in (kp, vp):
        c, scale = layers._quantize_kv(pool)
        scale = scale.to(q.dtype)
        codes.append((c, scale))
        deq.append(layers._dequantize_kv(c, scale, q.dtype))
    (kc, ks), (vc, vs) = codes
    return (q, kc, vc, ks, vs, table, sl), (q, *deq, table, sl)


def check_paged_int8(gen: torch.Generator, flush: torch.Tensor) -> list:
    """The int8 pool's variants of the split kernel (bf16 on tensor cores,
    f32 on FMAs) on the reference's cases, the split's edges, a dead lane,
    the serving main path's shape and qwen1.5-32b's (phase 11's lengths),
    in both dtypes: the same bits as the bf16 or f32 kernel on the pool
    dequantized by ``_dequantize_kv``, and twice; live lanes within
    tolerance of ``paged_attention_ref`` on that pool (the exact attention,
    as the bf16 and f32 kernel is held) and of ``paged_attention_int8_ref``
    (the reference's gather path, whose dead lanes average page 0's rows;
    in bf16 at the reference's kernel tolerance, as it rounds p to bf16
    before P.V); dead lanes exact zeros; in bf16 at the two main shapes,
    ``hold_mean_err`` and no farther from the f32 attention than the gather
    path (``hold_no_farther``). Timed at qwen1.5-32b's shape beside the
    plain version, the bf16 or f32 kernel on the dequantized pool and the
    bound. One record per dtype."""
    from repro_torch.kernels.paged_attention import kernel
    from repro_torch.kernels.paged_attention import ops as paged_ops
    from repro_torch.kernels.paged_attention.ref import (paged_attention_int8_ref,
                                                         paged_attention_ref,
                                                         paged_attention_split_ref)

    log("[kernels] paged_attention_int8 (the split kernel staging int8 codes, dequantized a "
        "tile at a time) vs the bf16 / f32 kernel on the dequantized pool and "
        "paged_attention_int8_ref")
    errs = {torch.float32: 0.0, torch.bfloat16: 0.0}

    def held(name, args, t, mean=False):
        i8, deq = _int8_pools(args)
        dtype, lens = i8[0].dtype, i8[-1].tolist()
        name = f"{name} {str(dtype)[6:]}"
        out = kernel.paged_attention_int8(*i8)
        live = [b for b, n in enumerate(lens) if n > 0]
        dead = [b for b, n in enumerate(lens) if n == 0]
        gather = paged_attention_int8_ref(*i8)
        if live:
            errs[dtype] = max(errs[dtype], hold(
                f"{name} live lanes vs paged_attention_ref on the dequantized pool", out[live],
                paged_attention_ref(*deq)[live], t))
            hold(f"{name} live lanes vs paged_attention_int8_ref", out[live], gather[live],
                 t if dtype == torch.float32 else tol(dtype))
        as_row2 = torch.equal(out, kernel.paged_attention(*deq))
        twice = torch.equal(out, kernel.paged_attention_int8(*i8))
        zeros = all(bool((out[b] == 0).all()) for b in dead)
        log(f"  {name}: the bits of the {'tc' if dtype == torch.bfloat16 else 'fma'} kernel on "
            f"the dequantized pool: {as_row2}; two calls the same bits: {twice}; dead lanes "
            f"{dead} exact zeros: {zeros}")
        if not (as_row2 and twice and zeros):
            raise AssertionError(f"{name}: the int8 kernel differs from the kernel on the "
                                 "dequantized pool, from itself, or a dead lane is not zeros")
        if mean:
            q, kd, vd, table, sl = deq
            exact32 = paged_attention_ref(q.float(), kd.float(), vd.float(), table, sl)
            hold_mean_err(name, out, exact32, paged_attention_split_ref(*deq))
            hold_no_farther(name, out, gather, exact32)
        return i8, deq

    for B, H, KVH, hd, ps, mb, lens, _ in PAGED_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            held(f"paged int8 B{B} H{H}/{KVH} hd{hd} ps{ps} lens{lens}",
                 _paged_inputs(gen, B, H, KVH, hd, ps, mb, lens, dtype, seed=0), tol(dtype))
    # check_paged's edges of the split: lengths 0 and 1, one and two segments,
    # every lane dead, pages of 8, 24 (straddling segments) and 256
    for ps, mb, lens in ((16, 20, [0, 1, 128, 129]), (16, 20, [0, 0, 0, 0]),
                         (16, 20, [256, 257, 127, 5]), (8, 40, [128, 129, 0, 1]),
                         (24, 14, [128, 150, 143, 1]), (256, 2, [129, 300, 256, 0])):
        for dtype in (torch.float32, torch.bfloat16):
            held(f"paged int8 split edges ps{ps} lens{lens}",
                 _paged_inputs(gen, 4, 8, 2, 64, ps, mb, lens, dtype, seed=2), tol(dtype))

    args = _paged_inputs(gen, 3, 4, 2, 32, 16, 3, [40, 17, 25], torch.float32, 0)
    i8, _ = _int8_pools(args)
    full = kernel.paged_attention_int8(*i8)
    dead_sl = i8[-1].clone()
    dead_sl[1] = 0
    out = kernel.paged_attention_int8(*i8[:-1], dead_sl)
    if not (bool((out[1] == 0).all()) and torch.equal(out[0], full[0])
            and torch.equal(out[2], full[2])):
        raise AssertionError("paged int8 dead lane: not exact zeros, or live lanes changed")
    log("  paged int8 dead lane: exact zeros, live lanes bit-identical")

    main_lens = [2048] + np.random.RandomState(1).randint(1, 2049, 7).tolist()
    q32_lens = phase11_lens()
    timed = {}
    for dtype, t in ((torch.float32, F32_TOL), (torch.bfloat16, PAGED_MAIN_BF16_TOL)):
        held(f"paged int8 main-path 8 lanes H32/8 hd128 ps16 lens{main_lens}",
             _paged_inputs(gen, 8, 32, 8, 128, 16, 128, main_lens, dtype, seed=1), t,
             mean=dtype == torch.bfloat16)
        timed[dtype] = held(f"paged int8 qwen1.5-32b 8 lanes H40/40 hd128 ps16 lens{q32_lens}",
                            _paged_inputs(gen, 8, 40, 40, 128, 16, 128, q32_lens, dtype, seed=3),
                            t, mean=dtype == torch.bfloat16)
        torch.cuda.empty_cache()

    n_tok = sum(q32_lens)
    n_pages = sum(-(-n // 16) for n in q32_lens)
    records = []
    for dtype in (torch.bfloat16, torch.float32):
        i8, deq = timed[dtype]
        el = i8[0].element_size()
        variant = "tc" if el == 2 else "fma"
        flops, nbytes = paged_ops.int8_cost(8, 40, 40, 128, n_tok, n_pages, el=el)
        b_ms, b_by = bound(flops, nbytes, PEAK_BF16_FLOPS if el == 2 else PEAK_F32_FLOPS)
        times = time_each(lambda: kernel.paged_attention_int8(*i8), flush, reps=20)
        ms = sum(times) / len(times)
        row2_ms = time_ms(lambda: kernel.paged_attention(*deq), flush, reps=20)
        plain_ms = time_ms(lambda: paged_attention_int8_ref(*i8), flush)
        row2_b_ms, _ = bound(*paged_ops.cost(8, 40, 40, 128, n_tok, n_pages, el=el),
                             PEAK_BF16_FLOPS if el == 2 else PEAK_F32_FLOPS)
        log(f"  paged int8 at qwen1.5-32b's decode (8 lanes, H40/40, {n_tok} cached tokens, "
            f"{str(dtype)[6:]}): kernel {ms:.4f} ms ({fmt_spread(times)}), plain (gather, "
            f"dequantize, masked softmax) {plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}), "
            f"{nbytes / ms / 1e6:.1f} GB/s achieved; the {variant} kernel on the dequantized "
            f"pool {row2_ms:.4f} ms (bound {row2_b_ms:.4f}); device time per launch "
            f"(profiler): " + ", ".join(
                f"{name} {t:.4f} ms" for name, t in _device_ms_per_launch(
                    lambda: kernel.paged_attention_int8(*i8), flush, "paged_").items()))
        records.append(dict(
            name=f"paged_attention_int8_{variant}", route="cuda",
            source="src/repro_torch/csrc/paged_attention.cu",
            replaces="src/repro/models/layers.py:629",
            max_abs_err=errs[dtype], ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
            library_ms=None))
    del timed
    torch.cuda.empty_cache()
    return records


def _ssm_inputs(gen, B, S, inner, N, dtype, dt_dtype):
    """The JAX test's distributions: u, B_, C_ normal; dt = 0.1 softplus(normal);
    A = -exp(0.5 normal); D, h0 normal."""
    rnd = lambda *shape: torch.randn(shape, generator=gen, device="cuda")
    u = rnd(B, S, inner).to(dtype)
    dt = (torch.nn.functional.softplus(rnd(B, S, inner)) * 0.1).to(dt_dtype)
    B_, C_ = rnd(B, S, N).to(dt_dtype), rnd(B, S, N).to(dt_dtype)
    A = -torch.exp(rnd(inner, N) * 0.5)
    return u, dt, B_, C_, A, rnd(inner), rnd(B, inner, N)


def check_ssm_scan(gen: torch.Generator, flush: torch.Tensor) -> dict:
    """The selective scan against ``ssm_scan_ref``: its prefill entry
    (``ssm_scan_kernel``, S > ``STEP_MAX``) on the JAX test's cases and
    ragged ones, its decode entry (``ssm_step_kernel``) on the first two
    steps of each of those, and both at hymba-1.5b's serving shapes (prefill
    and one decode step), where two calls must give the same bits."""
    from repro_torch.kernels.ssm_scan import kernel, ops
    from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref

    def case(name, B, S, inner, N, dtype, dt_dtype, with_h0=True, tols=None, args=None):
        args = args or _ssm_inputs(gen, B, S, inner, N, dtype, dt_dtype)[:7 if with_h0 else 6]
        name += " [step]" if args[0].shape[1] <= kernel.STEP_MAX else " [scan]"
        y, h = ops.ssm_scan(*args)
        torch.cuda.synchronize()
        yr, hr = ssm_scan_ref(*args)
        if y.dtype != dtype or h.dtype != torch.float32:
            raise AssertionError(f"{name}: y {y.dtype}, h {h.dtype}")
        y_tol, h_tol = tols or (tol(dtype), SSM_H_TOL)
        return args, max(hold(f"{name} y", y, yr, y_tol), hold(f"{name} h", h, hr, h_tol))

    def first_steps(args, S):
        return [x[:, :S].contiguous() if i < 4 else x for i, x in enumerate(args)]

    log("[kernels] ssm_scan vs ssm_scan_ref (y and h_final)")
    for B, S, inner, N, dtype in SSM_CASES:
        # as in the JAX test, dt, B_ and C_ have u's dtype (bf16 ones upcast in ops.py)
        name = f"ssm B{B} S{S} inner{inner} N{N} {str(dtype)[6:]}"
        args, _ = case(name, B, S, inner, N, dtype, dtype)
        case(f"{name}, its first 2 steps", B, 2, inner, N, dtype, dtype,
             args=first_steps(args, 2))
    # ragged against the scan's blocks (32 channels at N 16, 64 at N 8) and
    # 16-step tiles, and against the step's blocks (16 or 32 channels); no h0
    # (zeros); inner 203: rows not 16-byte aligned (copied element by element)
    for name, B, S, inner, N, dtype, with_h0 in (
            ("ssm no h0 B2 S33 inner200 N8 f32", 2, 33, 200, 8, torch.float32, False),
            ("ssm ragged B2 S33 inner200 N16 bf16", 2, 33, 200, 16, torch.bfloat16, True),
            ("ssm misaligned B2 S40 inner203 N16 bf16", 2, 40, 203, 16, torch.bfloat16, True),
            ("ssm misaligned B1 S21 inner203 N8 f32", 1, 21, 203, 8, torch.float32, True),
            ("ssm decode B3 S1 inner200 N16 f32", 3, 1, 200, 16, torch.float32, True),
            ("ssm decode B3 S2 inner200 N8 bf16", 3, 2, 200, 8, torch.bfloat16, True),
            ("ssm no h0 B2 S3 inner203 N16 f32", 2, 3, 203, 16, torch.float32, False)):
        case(name, B, S, inner, N, dtype, dtype, with_h0=with_h0)
    # hymba-1.5b's main path: u in the compute dtype, dt/B_/C_ f32, a carried state
    main = (SSM_MAIN_Y_TOL, SSM_MAIN_H_TOL)
    dec, err_dec = case("ssm main-path decode B8 S1 inner3200 N16 bf16", 8, 1, 3200, 16,
                        torch.bfloat16, torch.float32, tols=main)
    args, err = case("ssm main-path prefill B8 S4096 inner3200 N16 bf16", 8, 4096, 3200, 16,
                     torch.bfloat16, torch.float32, tols=main)
    for what, a in (("prefill", args), ("decode", dec)):
        one, two = kernel.ssm_scan(*a), kernel.ssm_scan(*a)
        same = all(torch.equal(x, z) for x, z in zip(one, two))
        log(f"  ssm main-path {what}: two calls give the same bits: {same}")
        if not same:
            raise AssertionError(f"the scan's {what} gave different bits on the same inputs")
        del one, two

    def work(u, dt, B_, C_, A, D, h0):
        """(flop, bytes) by the scan's cost function (``ops.cost``)."""
        return ops.cost(*u.shape, A.shape[1], el=u.element_size(), h0=h0 is not None)

    B, S, inner = args[0].shape
    N = args[4].shape[1]
    flops, nbytes = work(*args)
    b_ms, b_by = bound(flops, nbytes, PEAK_F32_FLOPS)
    sfu_ms = B * S * inner * N / SFU_EXP_PER_S * 1e3
    ms = time_ms(lambda: kernel.ssm_scan(*args), flush)
    plain_ms = time_ms(lambda: ssm_scan_ref(*args), flush, reps=2, warmup=1)
    dec_ms = time_ms(lambda: kernel.ssm_scan(*dec), flush)
    dec_dev = _device_ms_per_launch(lambda: kernel.ssm_scan(*dec), flush, "ssm_step")
    dec_b_ms, dec_by = bound(*work(*dec), PEAK_F32_FLOPS)
    log(f"  ssm_scan main path (B{B} S{S} inner{inner} N{N}, u bf16): kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}), the {B * S * inner * N:.3e} "
        f"exponentials at the SFU's rate {sfu_ms:.4f} ms; {nbytes / ms / 1e6:.1f} GB/s, "
        f"{flops / ms / 1e9:.1f} GFLOP/s achieved; decode shape (S=1, h0 carried): kernel "
        f"{dec_ms:.4f} ms by events, device time per launch {dec_dev} (profiler), bound "
        f"{dec_b_ms:.4f} ms ({dec_by})")
    return dict(name="ssm_scan", route="cuda", source="src/repro_torch/csrc/ssm_scan.cu",
                replaces="src/repro/kernels/ssm_scan/kernel.py:24",
                max_abs_err=max(err, err_dec), ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=None)


def hold_scan_bwd_bits(tag: str, args) -> None:
    """Two calls of the scan's backward on the same inputs give the same
    bits (every partial sum in a fixed order: no atomics)."""
    from repro_torch.kernels.ssm_scan import kernel

    one, two = kernel.ssm_scan_bwd(*args), kernel.ssm_scan_bwd(*args)
    same = all(a is None and b is None or torch.equal(a, b) for a, b in zip(one, two))
    log(f"  {tag}: two calls give the same bits: {same}")
    if not same:
        raise AssertionError(f"the scan's backward gave different bits at {tag}")


def check_ssm_scan_bwd(gen: torch.Generator, flush: torch.Tensor) -> dict:
    """The scan's backward (its carry pass, main pass and partial sums)
    against ``ssm_scan_bwd_ref``, from the forward kernel's kept states: on
    the JAX test's cases and ragged ones, both u dtypes, with h0 and dh and
    without, over many segments with a ragged end, and at hymba-1.5b's
    training microbatch, where two calls must give the same bits. The
    forward with the kept states gives the bits it gives without them; its
    time at the training shape, with and without; the backward's time
    there with its spread."""
    from repro_torch.kernels.ssm_scan import kernel, ops
    from repro_torch.kernels.ssm_scan.ref import ssm_scan_bwd_ref, ssm_scan_ref

    names = ("du", "ddt", "dB_", "dC_", "dA", "dD", "dh0")

    def case(name, B, S, inner, N, dtype, with_h0, tols=None):
        u, dt, B_, C_, A, D, h0 = _ssm_inputs(gen, B, S, inner, N, dtype, torch.float32)
        h0 = h0 if with_h0 else None
        dy = torch.randn((B, S, inner), generator=gen, device="cuda").to(dtype)
        dh = torch.randn((B, inner, N), generator=gen, device="cuda") if with_h0 else None
        y0, h_0 = kernel.ssm_scan(u, dt, B_, C_, A, D, h0)
        y, h, chunks = kernel.ssm_scan(u, dt, B_, C_, A, D, h0, keep_chunks=True)
        if not (torch.equal(y, y0) and torch.equal(h, h_0)):
            raise AssertionError(f"{name}: the forward keeping its states gave other bits")
        got = kernel.ssm_scan_bwd(u, dt, B_, C_, A, D, h0, chunks, dy, dh)
        torch.cuda.synchronize()
        want = ssm_scan_bwd_ref(u, dt, B_, C_, A, D, h0, dy, dh)
        f32_tol, du_tol = tols or (SSM_BWD_TOL, tol(dtype))
        err = 0.0
        for n, a, b in zip(names, got, want):
            if (a is None) != (b is None):
                raise AssertionError(f"{name} {n}: {a is None} vs the plain version's {b is None}")
            if a is not None:
                if a.dtype != b.dtype or a.shape != b.shape:
                    raise AssertionError(f"{name} {n}: {a.dtype}{tuple(a.shape)} vs "
                                         f"{b.dtype}{tuple(b.shape)}")
                err = max(err, hold(f"{name} {n}", a, b, du_tol if n == "du" else f32_tol))
        return err, (u, dt, B_, C_, A, D, h0, chunks, dy, dh)

    log("[kernels] ssm_scan_bwd vs ssm_scan_bwd_ref (du, ddt, dB_, dC_, dA, dD, dh0)")
    err = 0.0
    for B, S, inner, N, dtype in SSM_CASES:
        for with_h0 in (True, False):
            e, _ = case(f"ssm bwd B{B} S{S} inner{inner} N{N} {str(dtype)[6:]}"
                        f"{'' if with_h0 else ' no h0, no dh'}", B, S, inner, N, dtype, with_h0)
            err = max(err, e)
    # ragged against the 16-step tiles and the backward's blocks (32 channels
    # at N 16, 64 at N 8); S <= 4 (the step kernel's forward, no kept state)
    # and S <= 16 (one tile); inner 203: rows not 16-byte aligned; S over
    # many segments with a ragged last tile (kernel.bwd_segment: 16 steps a
    # segment at these shapes), where two calls give the same bits too. S
    # 4113 is the training shape's length, held at its tolerance: there the
    # f32 plain version's own dA and dD sum 4113 steps in order, and on the
    # CPU its dA was 2.2e-4 off an f64 adjoint (0.47 of SSM_BWD_TOL's
    # limit), the split's emulation (tests/test_torch_scan_bwd_split.py)
    # 6.9e-5; the kernel came 2.8e-4 off it on the H100
    for name, B, S, inner, N, dtype, with_h0 in (
            ("ssm bwd ragged B2 S33 inner200 N16 bf16", 2, 33, 200, 16, torch.bfloat16, True),
            ("ssm bwd ragged B2 S40 inner203 N8 f32", 2, 40, 203, 8, torch.float32, True),
            ("ssm bwd one tile B3 S16 inner70 N16 f32", 3, 16, 70, 16, torch.float32, False),
            ("ssm bwd step-kernel forward B2 S3 inner65 N8 bf16", 2, 3, 65, 8, torch.bfloat16,
             True),
            ("ssm bwd segments B2 S1000 inner200 N16 bf16", 2, 1000, 200, 16, torch.bfloat16,
             True),
            ("ssm bwd segments B1 S4113 inner203 N8 f32", 1, 4113, 203, 8, torch.float32,
             True)):
        seg = kernel.bwd_segment(B, S, inner, N)
        e, args = case(f"{name} ({kernel.bwd_segments(S, seg)} segments of {seg} steps)", B, S,
                       inner, N, dtype, with_h0,
                       tols=(SSM_BWD_MAIN_TOL, tol(dtype)) if S > 4096 else None)
        err = max(err, e)
        if "segments" in name:
            hold_scan_bwd_bits(name, args)
    # hymba-1.5b's training microbatch (u bf16, zero start state, no dh)
    sh = HYMBA_TRAIN_SCAN
    B, S, inner, N = sh["B"], sh["S"], sh["inner"], sh["N"]
    seg = kernel.bwd_segment(B, S, inner, N)
    e, args = case(f"ssm bwd main-path training B{B} S{S} inner{inner} N{N} bf16 "
                   f"({kernel.bwd_segments(S, seg)} segments of {seg} steps)", B, S, inner,
                   N, torch.bfloat16, False, tols=(SSM_BWD_MAIN_TOL, SSM_MAIN_Y_TOL))
    err = max(err, e)
    hold_scan_bwd_bits("ssm bwd main-path training", args)

    u, dt, B_, C_, A, D, h0, chunks, dy, dh = args
    # the gradient's least work: each input (u, dt, B_, C_, A, D, dy) read and
    # each output (du, ddt, dB_, dC_, dA, dD) written once; per (b, t, i, n)
    # the state (4 flops) and the adjoint (16), and one exponential
    flops, nbytes = ops.bwd_cost(B, S, inner, N, el=u.element_size())
    b_ms, b_by = bound(flops, nbytes, PEAK_F32_FLOPS)
    sfu_ms = B * S * inner * N / SFU_EXP_PER_S * 1e3
    times = time_each(lambda: kernel.ssm_scan_bwd(*args), flush, reps=30)
    ms = spread(times)[1]
    plain_ms = time_ms(lambda: ssm_scan_bwd_ref(u, dt, B_, C_, A, D, h0, dy, dh), flush,
                       reps=1, warmup=1)
    leaves = [t.detach().clone().requires_grad_() for t in (u, dt, B_, C_, A, D)]

    def autograd_ref():
        y, _ = ssm_scan_ref(*leaves)
        torch.autograd.grad(y, leaves, dy)

    autograd_ms = time_ms(autograd_ref, flush, reps=1, warmup=1)
    fwd = {what: time_ms(lambda: kernel.ssm_scan(u, dt, B_, C_, A, D, h0, keep_chunks=keep), flush)
           for what, keep in (("plain", False), ("keeping its states", True))}
    dev = _device_ms_per_launch(lambda: kernel.ssm_scan_bwd(*args), flush, "ssm_")
    log(f"  ssm_scan_bwd main path (B{B} S{S} inner{inner} N{N}, u bf16): kernel "
        f"{fmt_spread(times)} (carry pass, main pass and partial sums; device time per "
        f"launch {dev}), plain ssm_scan_bwd_ref {plain_ms:.4f} ms, autograd through "
        f"ssm_scan_ref (forward + backward) {autograd_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}; "
        f"the {B * S * inner * N:.3e} exponentials at the SFU's rate: one {sfu_ms:.4f} ms, the "
        f"design's three {3 * sfu_ms:.4f} ms); {nbytes / ms / 1e6:.1f} GB/s achieved at the "
        f"median; the forward at this shape {fwd['plain']:.4f} ms, keeping its "
        f"{chunks.shape[1]} states {fwd['keeping its states']:.4f} ms")
    del args, u, dt, B_, C_, A, D, chunks, dy, leaves
    return dict(name="ssm_scan_bwd", route="cuda", source="src/repro_torch/csrc/ssm_scan.cu",
                replaces="src/repro/models/ssm.py:129",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=None)


def _mlstm_inputs(gen, B, S, H, hd, dtype, with_state=False):
    """The JAX test's distributions in the model's layout: q, k, v normal
    (B, S, H, hd); gates 2 x normal (B, S, 2H) f32; a state (C, n normal,
    m = 0.5 x normal) when asked for."""
    rnd = lambda *shape: torch.randn(shape, generator=gen, device="cuda")
    q, k, v = (rnd(B, S, H, hd).to(dtype) for _ in range(3))
    gates = rnd(B, S, 2 * H) * 2.0
    state = (rnd(B, H, hd, hd), rnd(B, H, hd), rnd(B, H) * 0.5) if with_state else None
    return q, k, v, gates, state


def _to_ref_layout(q, k, v, gates):
    """(B, S, H, hd) and (B, S, 2H) -> the sequential oracle's (B, H, S, hd)
    and (B, H, S, 2)."""
    H = q.shape[2]
    g = torch.stack([gates[..., :H], gates[..., H:]], dim=-1).transpose(1, 2)
    return q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), g


# xlstm-350m's two shapes of the tensor-core mLSTM: its serving prefill
# (B8 S4096 H4 hd512, nothing kept) and its training microbatch (B1,
# keeping the chunk states for the gradient); calls each design is timed over
MLSTM_TC_SHAPES = {"prefill": (8, False), "training": (1, True)}
MLSTM_TC_REPS = 10


def check_mlstm_tc_designs(gen: torch.Generator, flush: torch.Tensor) -> dict:
    """Both designs of the tensor-core mLSTM (``kernel.tc_call``: the split
    design's carry pass over C's 64 x 64 tiles and output pass over chunks,
    and the single pass) at xlstm-350m's two shapes (MLSTM_TC_SHAPES), each
    keeping its chunk states: h and the final state against the plain
    chunkwise form at chunk 256 (MLSTM_MAIN_TOLS), each kept tensor against
    the plain split form (``mlstm_chunkwise_split_ref``: C_in and n_in at
    MLSTM_MAIN_STATE_TOL, m_in at MLSTM_M_TOL, n.q at MLSTM_MAIN_STATE_TOL);
    without keeping the same bits, and two calls the same bits. Then both
    designs timed in turns (split, single, single, split; MLSTM_TC_REPS
    calls a turn) with and without keeping, beside the bound and the kept
    states' floor (their bytes written once), and the wrapper's pick
    (``tc_design``). Returns the training shape's record for the kernels
    line (the wrapper keeping, read from the counter ``mlstm_tc``; its error
    the largest of every hold here). The kernel phase and
    ``--xlstm-train-only`` run it."""
    from repro_torch.kernels.mlstm import kernel, ops
    from repro_torch.kernels.mlstm.ref import mlstm_chunkwise_ref, mlstm_chunkwise_split_ref

    err, rec = 0.0, None
    H, S, hd = 4, 4096, 512
    kept_tols = (MLSTM_MAIN_STATE_TOL, MLSTM_MAIN_STATE_TOL, MLSTM_M_TOL, MLSTM_MAIN_STATE_TOL)
    log("[kernels] mlstm_tc, both designs (split: carry + output pass; single), at xlstm-350m's "
        "prefill and training shapes, keeping: h and state vs mlstm_chunkwise_ref (chunk 256), "
        "kept C_in, n_in, m_in, n.q vs mlstm_chunkwise_split_ref")
    for tag, (B, keep) in MLSTM_TC_SHAPES.items():
        q, k, v, gates, _ = _mlstm_inputs(gen, B, S, H, hd, torch.bfloat16)
        hr, (Cr, nr, mr) = mlstm_chunkwise_ref(q, k, v, gates, None, 256)
        plain_kept = mlstm_chunkwise_split_ref(q, k, v, gates)[2]
        for design in ("split", "single"):
            name = f"mlstm_tc [{design}] {tag} B{B} S{S} H{H} hd{hd} bf16 keeping"
            h, (C, n, m), kept = kernel.tc_call(design, q, k, v, gates, keep=True)
            torch.cuda.synchronize()
            err = max(err, hold(f"{name} h", h, hr, MLSTM_MAIN_H_TOL),
                      hold(f"{name} C", C, Cr, MLSTM_MAIN_STATE_TOL),
                      hold(f"{name} n", n, nr, MLSTM_MAIN_STATE_TOL))
            hold(f"{name} m", m, mr, MLSTM_M_TOL)
            for key, x, r, t in zip(("C_in", "n_in", "m_in", "n.q"), kept, plain_kept, kept_tols):
                err = max(err, hold(f"{name} kept {key}", x, r, t))
            h2, st2 = kernel.tc_call(design, q, k, v, gates)
            again = kernel.tc_call(design, q, k, v, gates, keep=True)
            same_keep = torch.equal(h, h2) and all(map(torch.equal, (C, n, m), st2))
            same_twice = all(map(torch.equal, (h, C, n, m, *kept),
                                 (again[0], *again[1], *again[2])))
            log(f"  {name}: without keeping the same bits: {same_keep}; two calls give the same "
                f"bits: {same_twice}")
            if not (same_keep and same_twice):
                raise AssertionError(f"{name}: other bits without keeping or on a second call")
            del h, C, n, m, kept, h2, st2, again
        del hr, Cr, nr, mr, plain_kept

        flops, nbytes = ops.cost(B, S, H, hd, el=2)
        b_ms, b_by = bound(flops, nbytes, PEAK_BF16_FLOPS)
        nc = -(-S // kernel.CHUNK)
        kept_bytes = 4.0 * B * H * nc * (hd * hd + hd + 1) + 4.0 * B * S * H
        times = {}
        for design in ("split", "single", "single", "split"):
            for kp in (False, True):
                fn = lambda: kernel.tc_call(design, q, k, v, gates, keep=kp)
                times.setdefault((design, kp), []).extend(
                    time_each(fn, flush, reps=MLSTM_TC_REPS))
        pick = kernel.tc_design(B, S, H, hd)
        log(f"  mlstm_tc {tag} B{B} S{S} H{H} hd{hd} bf16, both designs in turns (split, single, "
            f"single, split; {2 * MLSTM_TC_REPS} calls each): " + "; ".join(
                f"{d}{' keeping' if kp else ''} {fmt_spread(ts)}"
                for (d, kp), ts in times.items())
            + f"; the wrapper takes {pick}; bound {b_ms:.4f} ms ({b_by}); the kept states, "
            f"{kept_bytes / 1e9:.4f} GB, written once: {kept_bytes / PEAK_BYTES * 1e3:.4f} ms")
        if keep:
            plain_ms = time_ms(lambda: mlstm_chunkwise_ref(q, k, v, gates, None, 256), flush,
                               reps=3)
            rec = dict(name="mlstm_tc_train", counter="mlstm_tc", route="cuda",
                       source="src/repro_torch/csrc/mlstm_tc.cu",
                       replaces="src/repro/kernels/mlstm/kernel.py:31", library_ms=None,
                       ms=spread(times[(pick, True)])[1], plain_ms=plain_ms, bound_ms=b_ms,
                       bound_by=b_by)
            log(f"  mlstm_tc training record: {pick} keeping, median {rec['ms']:.4f} ms, plain "
                f"(chunkwise, chunk 256) {plain_ms:.4f} ms, bound {b_ms:.4f} ms")
        del q, k, v, gates
    rec["max_abs_err"] = err
    return rec


def check_mlstm(gen: torch.Generator, flush: torch.Tensor) -> list:
    """The chunkwise mLSTM's three kernels (S <= ``STEP_MAX``: the one-pass
    decode step; longer: the bf16 tensor-core kernel, and the split-TF32
    kernel, both dtypes, which takes f32 and what the tensor-core kernel
    does not), each through its own wrapper, against ``mlstm_ref`` (the
    sequential oracle) on the JAX test's cases, ragged S with a carried
    state and two calls carrying the state, and against
    ``mlstm_chunkwise_ref`` at xlstm-350m's prefill shape (in bf16, and in
    f32 for the split-TF32 kernel, timed there over MLSTM_F32_REPS calls)
    and decode shape; two calls of each chunkwise kernel and of the step
    give the same bits. One record per kernel."""
    from repro_torch.kernels.mlstm import kernel, ops
    from repro_torch.kernels.mlstm.ref import mlstm_chunkwise_ref, mlstm_ref

    def variants(S, dtype):
        """(name, function) of each kernel that takes these inputs; the
        tensor-core kernel in both its designs (``kernel.tc_call``)."""
        if S <= kernel.STEP_MAX:
            return [("step", ops.mlstm)]
        tc = [(f"tc {d}", functools.partial(kernel.tc_call, d)) for d in ("split", "single")]
        return [("tf32", kernel.mlstm_tf32)] + (tc if dtype == torch.bfloat16 else [])

    def same_bits(name, fn, args, out):
        again = fn(*args)
        same = all(torch.equal(x, y) for x, y in zip((out[0], *out[1]), (again[0], *again[1])))
        log(f"  {name}: two calls give the same bits: {same}")
        if not same:
            raise AssertionError(f"{name}: two calls on the same inputs gave different bits")

    errs = {"tc": 0.0, "tf32": 0.0, "step": 0.0}

    def against_oracle(name, B, S, H, hd, dtype, with_state=False, h_tol=None, twice=False,
                       misaligned=False):
        q, k, v, gates, state = _mlstm_inputs(gen, B, S, H, hd, dtype, with_state)
        if misaligned:      # 4 bytes past a 16-byte boundary: the plain loads' path
            q, k, v = (torch.cat([t.new_zeros(1), t.flatten()])[1:].view(t.shape)
                       for t in (q, k, v))
        hr, (Cr, nr, mr) = mlstm_ref(*_to_ref_layout(q, k, v, gates), state)
        for var, fn in variants(S, dtype):
            h, (C, n, m) = fn(q, k, v, gates, state)
            torch.cuda.synchronize()
            if h.dtype != dtype or {C.dtype, n.dtype, m.dtype} != {torch.float32}:
                raise AssertionError(f"{name}: h {h.dtype}, state {C.dtype} {n.dtype} {m.dtype}")
            full = f"{name} [{var}]"
            err = max(hold(f"{full} h", h, hr.transpose(1, 2), h_tol or tol(dtype)),
                      hold(f"{full} C", C, Cr, MLSTM_STATE_TOL),
                      hold(f"{full} n", n, nr, MLSTM_STATE_TOL))
            hold(f"{full} m", m, mr, MLSTM_M_TOL)
            errs[var.split()[0]] = max(errs[var.split()[0]], err)
            if twice:
                same_bits(full, fn, (q, k, v, gates, state), (h, (C, n, m)))

    log("[kernels] mlstm (one-pass step, split TF32, tensor cores) vs mlstm_ref (h, C, n, m) "
        "and mlstm_chunkwise_ref")
    for i, (B, H, S, hd, dtype) in enumerate(MLSTM_CASES):
        against_oracle(f"mlstm B{B} H{H} S{S} hd{hd} {str(dtype)[6:]}", B, S, H, hd, dtype,
                       twice=i == 0)
    against_oracle("mlstm ragged S100 with state B2 H2 hd96 f32", 2, 100, 2, 96, torch.float32,
                   with_state=True)
    against_oracle("mlstm ragged S100 with state B2 H2 hd128 bf16", 2, 100, 2, 128,
                   torch.bfloat16, with_state=True)
    against_oracle("mlstm q/k/v 4 bytes off 16-byte alignment B2 H2 S100 hd64 f32", 2, 100, 2,
                   64, torch.float32, with_state=True, misaligned=True)
    for dtype in (torch.float32, torch.bfloat16):
        against_oracle(f"mlstm step S5 with state B2 H2 hd96 {str(dtype)[6:]}", 2, 5, 2, 96,
                       dtype, with_state=True)
    against_oracle("mlstm main-path decode S1 with state B8 H4 hd512 bf16", 8, 1, 4,
                   512, torch.bfloat16, with_state=True, h_tol=MLSTM_MAIN_H_TOL)

    # two calls carrying the state compose into one call
    for dtype, h_t in ((torch.float32, F32_TOL), (torch.bfloat16, tol(torch.bfloat16))):
        q, k, v, gates, state = _mlstm_inputs(gen, 2, 77, 4, 64, dtype, with_state=True)
        for var, fn in variants(77, dtype):
            h_all, st_all = fn(q, k, v, gates, state)
            h1, st1 = fn(q[:, :40], k[:, :40], v[:, :40], gates[:, :40], state)
            h2, st2 = fn(q[:, 40:], k[:, 40:], v[:, 40:], gates[:, 40:], st1)
            torch.cuda.synchronize()
            name = f"mlstm two calls compose {str(dtype)[6:]} [{var}]"
            hold(f"{name} h", torch.cat([h1, h2], 1), h_all, h_t)
            for key, a, b in zip("Cnm", st2, st_all):
                hold(f"{name} {key}", a, b, MLSTM_STATE_TOL)
    train_rec = check_mlstm_tc_designs(gen, flush)
    errs["tc"] = max(errs["tc"], train_rec["max_abs_err"])

    # xlstm-350m's prefill shape, against the plain chunkwise form at chunk 256
    B, S, H, hd, chunk = 8, 4096, 4, 512, 256
    q, k, v, gates, _ = _mlstm_inputs(gen, B, S, H, hd, torch.bfloat16)
    hr, (Cr, nr, mr) = mlstm_chunkwise_ref(q, k, v, gates, None, chunk)
    for var, fn in [("tf32", kernel.mlstm_tf32), ("tc", kernel.mlstm_tc)]:
        h, (C, n, m) = fn(q, k, v, gates)
        torch.cuda.synchronize()
        name = f"mlstm main-path prefill B{B} S{S} H{H} hd{hd} bf16 [{var}]"
        errs[var] = max(errs[var], hold(f"{name} h", h, hr, MLSTM_MAIN_H_TOL),
                        hold(f"{name} C", C, Cr, MLSTM_MAIN_STATE_TOL),
                        hold(f"{name} n", n, nr, MLSTM_MAIN_STATE_TOL))
        hold(f"{name} m", m, mr, MLSTM_M_TOL)
        if var == "tc":
            same_bits(name, fn, (q, k, v, gates), (h, (C, n, m)))
        del h, C, n, m
    del hr, Cr, nr, mr
    # the same shape in f32 (xlstm's reduced parity path's kernel), held at
    # the prefill shape's state tolerance (h too: f32 carries no bf16 ulp):
    # C and n against the plain form, h against the f64 recurrence. The
    # plain f32 form's own rounding of h over 4096 steps reaches the whole
    # margin on some draws, so it is no oracle for h; the kernel's distance
    # to it is logged.
    q32, k32, v32, g32, _ = _mlstm_inputs(gen, B, S, H, hd, torch.float32)
    hr, (Cr, nr, mr) = mlstm_chunkwise_ref(q32, k32, v32, g32, None, chunk)
    out = kernel.mlstm_tf32(q32, k32, v32, g32)
    torch.cuda.synchronize()
    name = f"mlstm main-path prefill B{B} S{S} H{H} hd{hd} f32 [tf32]"
    hf = _mlstm_f64(q32, k32, v32, g32)
    errs["tf32"] = max(errs["tf32"],
                       hold(f"{name} h against the f64 recurrence", out[0], hf,
                            MLSTM_MAIN_STATE_TOL),
                       *(hold(f"{name} {key}", x, r, MLSTM_MAIN_STATE_TOL)
                         for key, x, r in zip("Cn", out[1], (Cr, nr))))
    hold(f"{name} m", out[1][2], mr, MLSTM_M_TOL)
    log(f"  {name}: worst error / limit (MLSTM_MAIN_STATE_TOL) of h: kernel vs plain "
        f"{limit_frac(out[0], hr, MLSTM_MAIN_STATE_TOL):.4f}, kernel vs f64 "
        f"{limit_frac(out[0], hf, MLSTM_MAIN_STATE_TOL):.4f}, plain vs f64 "
        f"{limit_frac(hr, hf, MLSTM_MAIN_STATE_TOL):.4f}")
    same_bits(name, kernel.mlstm_tf32, (q32, k32, v32, g32), out)
    del hr, Cr, nr, mr, out, hf
    dq, dk, dv, dg, dstate = _mlstm_inputs(gen, B, 1, H, hd, torch.bfloat16, with_state=True)
    same_bits("mlstm main-path decode S1 (step)", ops.mlstm, (dq, dk, dv, dg, dstate),
              ops.mlstm(dq, dk, dv, dg, dstate))

    def work(B, S, H, hd, el):
        """(flop, bytes) by the mLSTM's cost function (``ops.cost``); the
        decode step (S = 1) carries a state in."""
        return ops.cost(B, S, H, hd, el=el, state=S == 1)

    flops, nbytes = work(B, S, H, hd, 2)
    b_ms, b_by = bound(flops, nbytes, PEAK_BF16_FLOPS)
    ms = time_ms(lambda: kernel.mlstm_tf32(q, k, v, gates), flush, reps=3)
    tc_ms = time_ms(lambda: kernel.mlstm_tc(q, k, v, gates), flush)
    plain_ms = time_ms(lambda: mlstm_chunkwise_ref(q, k, v, gates, None, chunk), flush, reps=3)
    log(f"  mlstm main path (B{B} S{S} H{H} hd{hd}, q/k/v bf16): tensor-core kernel (the "
        f"path's, {kernel.tc_design(B, S, H, hd)}) {tc_ms:.4f} ms, split-TF32 kernel {ms:.4f} "
        f"ms, plain (chunkwise, chunk {chunk}) {plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}); "
        f"{flops / tc_ms / 1e9:.1f} and {flops / ms / 1e9:.1f} TFLOP/s of the function's work "
        f"achieved")
    del q, k, v
    f_flops, f_bytes = work(B, S, H, hd, 4)
    f_b_ms, f_by = bound(f_flops, f_bytes, PEAK_SPLIT_TF32_FLOPS)
    f_times = time_each(lambda: kernel.mlstm_tf32(q32, k32, v32, g32), flush,
                        reps=MLSTM_F32_REPS)
    f_ms = spread(f_times)[1]
    f_plain_ms = time_ms(lambda: mlstm_chunkwise_ref(q32, k32, v32, g32, None, chunk), flush,
                         reps=3)
    log(f"  mlstm_tf32 at the main path's shape in f32: kernel {fmt_spread(f_times)} "
        f"({MLSTM_F32_REPS} calls), plain {f_plain_ms:.4f} ms, bound {f_b_ms:.4f} ms ({f_by}, "
        f"split TF32{f32_fma_bound(f_flops, f_bytes, PEAK_SPLIT_TF32_FLOPS)}); "
        f"{f_flops / f_ms / 1e9:.1f} TFLOP/s of the function's {f_flops:.4e} operations at "
        f"the median")
    del q32, k32, v32, g32
    d_flops, d_bytes = work(B, 1, H, hd, 2)
    d_b_ms, d_by = bound(d_flops, d_bytes, PEAK_BF16_FLOPS)
    d_ms = time_ms(lambda: kernel.mlstm(dq, dk, dv, dg, dstate), flush)
    d_plain_ms = time_ms(lambda: mlstm_chunkwise_ref(dq, dk, dv, dg, dstate, chunk), flush)
    log(f"  mlstm step at the decode shape (S=1, state carried, bf16): kernel {d_ms:.4f} ms, "
        f"plain {d_plain_ms:.4f} ms, bound {d_b_ms:.4f} ms ({d_by}); "
        f"{d_bytes / d_ms / 1e6:.1f} GB/s achieved")
    rec = dict(route="cuda", replaces="src/repro/kernels/mlstm/kernel.py:31", library_ms=None,
               source="src/repro_torch/csrc/mlstm.cu")
    return [dict(rec, name="mlstm_tc", source="src/repro_torch/csrc/mlstm_tc.cu",
                 max_abs_err=errs["tc"], ms=tc_ms, plain_ms=plain_ms, bound_ms=b_ms,
                 bound_by=b_by),
            dict(train_rec, max_abs_err=errs["tc"]),
            dict(rec, name="mlstm_tf32", max_abs_err=errs["tf32"], ms=f_ms,
                 plain_ms=f_plain_ms, bound_ms=f_b_ms, bound_by=f_by),
            dict(rec, name="mlstm_step", max_abs_err=errs["step"], ms=d_ms,
                 plain_ms=d_plain_ms, bound_ms=d_b_ms, bound_by=d_by)]


def _clamped_share(kept) -> float:
    """The share of steps whose denominator is clamped (|n.q| <= 1), from a
    forward's kept n.q."""
    return float((kept[3].abs() <= 1.0).float().mean())


def check_mlstm_bwd(gen: torch.Generator, flush: torch.Tensor) -> dict:
    """The mLSTM's gradient (``csrc/mlstm_bwd.cu``: the per-step scalars,
    the carry pass over dC's tiles, the parallel pass and the sums, from
    what the forward kernel kept) against
    ``mlstm_chunkwise_bwd_ref`` in f64 on the same inputs and the forward
    kernel's h: on every MLSTM_CASES row in f32 and in bf16, with and without
    a start state (and then the final state's gradient too), ragged S, a
    case whose denominators are mostly clamped and one where almost none are
    (each case's clamped share logged), and at xlstm-350m's training
    microbatch in bf16 (the tensor-core forward's, the path's) and in f32;
    two calls give the same bits there. Every hold is logged with the share
    of its limit taken, and those that fail are raised together. The forward
    keeping its states gives the bits it gives without. Timed at the training
    shape beside the bound, the plain version in f32 and autograd through
    ``mlstm_chunkwise_ref``."""
    from repro_torch.kernels.mlstm import kernel
    from repro_torch.kernels.mlstm.ref import mlstm_chunkwise_bwd_ref, mlstm_chunkwise_ref

    names = ("dq", "dk", "dv", "dgates", "dC0", "dn0", "dm0")

    def run(q, k, v, gates, state, dh, dfinal):
        h, fin, kept = kernel.mlstm_chunkwise(q, k, v, gates, state, keep=True)
        return h, fin, kept, kernel.mlstm_bwd(q, k, v, gates, h, dh, kept, fin[:2], dfinal,
                                              want_dstate=state is not None)

    failed = []

    def check(name, out, ref, t):
        """``hold``'s test and line, with the share of the limit taken; a
        failure is listed and raised once every case has run, so that one
        run names every hold that fails."""
        err, ok = within(out, ref, t)
        log(f"  {name}: max_abs_err={err:.3e} ({limit_frac(out, ref, t):.3f} of atol="
            f"{t['atol']:.3e}, rtol={t['rtol']}) {'ok' if ok else 'FAIL'}")
        if not ok:
            failed.append(name)
        return err

    def case(name, B, S, H, hd, dtype, with_state, q_scale=1.0, main=False):
        q, k, v, gates, state = _mlstm_inputs(gen, B, S, H, hd, dtype, with_state)
        if q_scale != 1.0:
            q = (q.float() * q_scale).to(dtype)
        dh = torch.randn((B, S, H, hd), generator=gen, device="cuda").to(dtype)
        rnd = lambda *shape: torch.randn(shape, generator=gen, device="cuda")
        dfinal = (rnd(B, H, hd, hd), rnd(B, H, hd), rnd(B, H)) if with_state else None
        h0, fin0 = kernel.mlstm_chunkwise(q, k, v, gates, state)
        h, fin, kept, got = run(q, k, v, gates, state, dh, dfinal)
        torch.cuda.synchronize()
        if not (torch.equal(h, h0) and all(torch.equal(a, b) for a, b in zip(fin, fin0))):
            raise AssertionError(f"{name}: the forward keeping its states gave other bits")
        f64 = lambda ts: None if ts is None else tuple(t.double() for t in ts)
        want = mlstm_chunkwise_bwd_ref(*f64((q, k, v, gates)), f64(state), *f64((h, dh)),
                                       f64(dfinal), kernel.CHUNK)
        route = "tc" if kernel._tc_takes(q, k, v) else "tf32"
        full = f"{name} [{route} forward, {100 * _clamped_share(kept):.1f}% clamped]"
        err = 0.0
        for n, a, b in zip(names, (*got[:4], *(got[4] or ())), (*want[:4], *(want[4] or ()))):
            dt = dtype if n in ("dq", "dk", "dv") else torch.float32
            if a.dtype != dt or a.shape != b.shape:
                raise AssertionError(f"{full} {n}: {a.dtype}{tuple(a.shape)}, expected "
                                     f"{dt}{tuple(b.shape)}")
            if a.dtype == torch.bfloat16:
                t, b = MLSTM_MAIN_H_TOL if main else tol(dtype), b.to(torch.bfloat16)
            else:
                t = dict(atol=MLSTM_BWD_TOL["atol"] * max(1.0, float(b.abs().max())),
                         rtol=MLSTM_BWD_TOL["rtol"])
            err = max(err, check(f"{full} {n}", a, b, t))
        if (got[4] is None) != (want[4] is None):
            raise AssertionError(f"{full}: the start state's gradient missing on one side")
        return err, (q, k, v, gates, h, dh, kept), _clamped_share(kept)

    def same_bits(name, args):
        a = kernel.mlstm_bwd(*args)
        b = kernel.mlstm_bwd(*args)
        same = all(torch.equal(x, y) for x, y in zip(a[:4], b[:4]))
        log(f"  {name}: two calls give the same bits: {same}")
        if not same:
            raise AssertionError(f"{name}: two calls on the same inputs gave different bits")

    log("[kernels] mlstm_bwd (prep, carry pass, parallel pass, sums) vs "
        "mlstm_chunkwise_bwd_ref in f64 (dq, dk, dv, dgates; dC0, dn0, dm0 with a start state)")
    err = 0.0
    for B, H, S, hd, _ in MLSTM_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            for with_state in (False, True):
                e, _, _ = case(f"mlstm bwd B{B} H{H} S{S} hd{hd} {str(dtype)[6:]}"
                               f"{' with state' if with_state else ''}", B, S, H, hd, dtype,
                               with_state)
                err = max(err, e)
    for name, B, S, H, hd, dtype, q_scale in (
            ("mlstm bwd ragged S100 B2 H2 hd96 f32", 2, 100, 2, 96, torch.float32, 1.0),
            ("mlstm bwd ragged S100 B2 H2 hd128 bf16", 2, 100, 2, 128, torch.bfloat16, 1.0),
            ("mlstm bwd q x 0.02 (mostly clamped) B2 H2 S200 hd64 f32", 2, 200, 2, 64,
             torch.float32, 0.02),
            ("mlstm bwd q x 20 (rarely clamped) B2 H2 S200 hd64 f32", 2, 200, 2, 64,
             torch.float32, 20.0)):
        e, _, share = case(name, B, S, H, hd, dtype, True, q_scale)
        err = max(err, e)
        if "mostly" in name and not share > 0.9 or "rarely" in name and not share < 0.1:
            raise AssertionError(f"{name}: clamped share {share:.3f} is not what the case is for")
    sh = XLSTM_TRAIN_MLSTM
    B, S, H, hd = sh["B"], sh["S"], sh["H"], sh["hd"]
    main_args = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = f"mlstm bwd main-path training B{B} S{S} H{H} hd{hd} {str(dtype)[6:]}"
        e, args, _ = case(name, B, S, H, hd, dtype, False, main=True)
        err = max(err, e)
        same_bits(name, args)
        main_args[dtype] = args
    del args
    if failed:
        raise AssertionError(f"mlstm_bwd disagrees with its f64 witness in {len(failed)} holds: "
                             + "; ".join(failed))

    # the gradient's least work, per token and head: its four hd^2 products
    # (dC's step back, C_in^T delta into dq, dC^T v into dk, dC k into dv:
    # 2 hd^2 flop each) and the O(hd) rest (dh.h, the n row's products:
    # ~16 hd); the chunked form's intra-chunk products are its own overhead.
    # Bytes: what the function reads and writes, once each: q, k, v, h, dh
    # and dq, dk, dv (el bytes), the gates and dgates (f32). What this design
    # has the forward keep (C, n, m at each 64-step chunk's start, n.q per
    # step) is left out, as the scan backward's kept states are: a backward
    # could recompute it; its bytes and the bound with them are logged.
    def work(el):
        from repro_torch.kernels.mlstm import ops

        return ops.bwd_cost(B, S, H, hd, el=el)

    recs = {}
    for dtype, peak in ((torch.bfloat16, PEAK_BF16_FLOPS), (torch.float32, PEAK_SPLIT_TF32_FLOPS)):
        q, k, v, gates, h, dh, kept = main_args[dtype]
        flops, nbytes = work(q.element_size())
        b_ms, b_by = bound(flops, nbytes, peak)
        kept_bytes = 4.0 * sum(t.numel() for t in kept)
        kept_ms, kept_by = bound(flops, nbytes + kept_bytes, peak)
        times = time_each(lambda: kernel.mlstm_bwd(q, k, v, gates, h, dh, kept), flush,
                          reps=MLSTM_BWD_REPS)
        ms = spread(times)[1]
        plain_ms = time_ms(lambda: mlstm_chunkwise_bwd_ref(q, k, v, gates, None, h, dh, None,
                                                           kernel.CHUNK), flush, reps=1, warmup=1)
        leaves = [t.detach().clone().requires_grad_() for t in (q, k, v, gates)]

        def autograd_ref():
            out, _ = mlstm_chunkwise_ref(*leaves, None, kernel.CHUNK)
            torch.autograd.grad(out, leaves, dh)

        autograd_ms = time_ms(autograd_ref, flush, reps=1, warmup=1)
        dev = _device_ms_per_launch(lambda: kernel.mlstm_bwd(q, k, v, gates, h, dh, kept), flush,
                                    "mlstm_bwd")
        log(f"  mlstm_bwd main path (B{B} S{S} H{H} hd{hd}, q/k/v {str(dtype)[6:]}): kernel "
            f"{fmt_spread(times)} ({MLSTM_BWD_REPS} calls; device time per launch {dev}), plain "
            f"mlstm_chunkwise_bwd_ref {plain_ms:.4f} ms, autograd through mlstm_chunkwise_ref "
            f"(forward + backward) {autograd_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}: "
            f"{flops:.4e} operations at {peak / 1e12:.0f} TFLOP/s, {nbytes / 1e9:.4f} GB read and "
            f"written); the forward's kept states, {kept_bytes / 1e9:.4f} GB, not counted: "
            f"{kept_ms:.4f} ms ({kept_by}) with them; {flops / ms / 1e9:.1f} TFLOP/s of the "
            f"function's work at the median")
        recs[dtype] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)
        del leaves
    del main_args, q, k, v, gates, h, dh, kept
    # the record carries the training path's dtype, bf16
    return dict(name="mlstm_bwd", route="cuda", source="src/repro_torch/csrc/mlstm_bwd.cu",
                replaces="src/repro/models/xlstm.py:67", max_abs_err=err, library_ms=None,
                **recs[torch.bfloat16])


def _slstm_inputs(gen, B, S, d, with_state):
    """The model's distributions: wx = x w_gates (x RMS-normed, w_gates
    fan-in scaled) normal; r_gates 0.5 / sqrt(d) normal; a start state c
    normal, n |normal|, h and m 0.5 x normal."""
    rnd = lambda *shape: torch.randn(shape, generator=gen, device="cuda")
    wx, r = rnd(B, S, 4 * d), rnd(d, 4 * d) * (0.5 / math.sqrt(d))
    state = (rnd(B, d), rnd(B, d).abs(), 0.5 * rnd(B, d), 0.5 * rnd(B, d)) if with_state else None
    return wx, r, state


def _slstm_vs_witness(tag, got, plain, witness, names, failed) -> float:
    """Each output's largest error against the f64 witness, the kernel's
    and the plain f32 version's; a kernel error above SLSTM_MAIN_MARGIN x
    the plain one's (taken as at least SLSTM_ULP_FLOOR ulps of the largest
    |value|) is listed in ``failed``. Returns the kernel's largest."""
    worst = 0.0
    for name, a, b, w in zip(names, got, plain, witness):
        if a.shape != w.shape or a.dtype != torch.float32:
            raise AssertionError(f"{tag} {name}: {a.dtype}{tuple(a.shape)}, expected "
                                 f"float32{tuple(w.shape)}")
        ek = float((a.double() - w).abs().max())
        ep = float((b.double() - w).abs().max())
        top = float(w.abs().max())
        ulp = math.ldexp(1.0, math.frexp(top)[1] - 24) if top else 0.0
        limit = SLSTM_MAIN_MARGIN * max(ep, SLSTM_ULP_FLOOR * ulp)
        ok = bool(torch.isfinite(a).all()) and ek <= limit
        ratio = ek / ep if ep else (0.0 if ek == 0 else float("inf"))
        log(f"  {tag} {name}: kernel {ek:.3e}, plain f32 {ep:.3e} off the f64 witness "
            f"({ratio:.3f} of plain's; limit {limit:.3e}, {SLSTM_MAIN_MARGIN} x max(plain's, "
            f"{SLSTM_ULP_FLOOR} ulps of {top:.3e})) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failed.append(f"{tag} {name}")
        worst = max(worst, ek)
    return worst


def _slstm_same_bits(name, fn) -> None:
    a, b = fn(), fn()
    flat = lambda out: [t for x in out if x is not None
                        for t in (x if isinstance(x, tuple) else (x,))]
    same = all(torch.equal(x, y) for x, y in zip(flat(a), flat(b)))
    log(f"  {name}: two calls give the same bits: {same}")
    if not same:
        raise AssertionError(f"{name}: two calls on the same inputs gave different bits")


def check_slstm(gen: torch.Generator, flush: torch.Tensor) -> dict:
    """The sLSTM's forward kernel (``csrc/slstm.cu``, ``slstm_fwd_kernel``:
    a persistent cooperative grid, a block per 8 units, r in registers, h
    exchanged as step-tagged words) against ``slstm_ref``: at d = 128 on
    SLSTM_CASES with and without a start state, hs, the final state and
    what it keeps at SLSTM_TOL; at xlstm-350m's prefill (B8 S4096) and
    training (B1 S4096) shapes against an f64 witness, within
    SLSTM_MAIN_MARGIN x the plain f32 version's own error. Two calls give the
    same bits, and keeping what the gradient needs leaves hs's bits as they
    are. Decode's step (SLSTM_DECODE at d 1024, 128 blocks) from a drawn
    start state and from the prefill's final state: hs and the final state
    at SLSTM_TOL. Timed at the three main shapes beside the plain version
    and the bound (f32 FMAs). Wider d: ``check_slstm_wide``."""
    from repro_torch.kernels.slstm import kernel, ops
    from repro_torch.kernels.slstm.ref import slstm_ref

    names = ("hs", "c", "n", "h", "m")
    log("[kernels] slstm (forward) vs slstm_ref in f32 (hs, the final c, n, h, m; kept pre, "
        "c, n, m)")
    err = 0.0
    for B, S in SLSTM_CASES:
        for with_state in (False, True):
            tag = f"slstm B{B} S{S} d{SLSTM_D}{' with state' if with_state else ''}"
            wx, r, state = _slstm_inputs(gen, B, S, SLSTM_D, with_state)
            hs, fin, kept = kernel.slstm(wx, r, state, keep=True)
            hs2, fin2 = kernel.slstm(wx, r, state)
            rhs, rfin, rkept = slstm_ref(wx, r, state, keep=True)
            torch.cuda.synchronize()
            if not (torch.equal(hs, hs2) and all(torch.equal(a, b) for a, b in zip(fin, fin2))):
                raise AssertionError(f"{tag}: keeping gave other bits")
            for n, a, b in zip(names + ("kept pre", "kept c", "kept n", "kept m"),
                               (hs, *fin, *kept), (rhs, *rfin, *rkept)):
                err = max(err, hold(f"{tag} {n}", a, b, SLSTM_TOL))

    failed, recs = [], {}
    d = SLSTM_MAIN_D
    for path, (B, S) in SLSTM_MAIN.items():
        tag = f"slstm main-path {path} B{B} S{S} d{d}"
        wx, r, _ = _slstm_inputs(gen, B, S, d, False)
        hs, fin, kept = kernel.slstm(wx, r, None, keep=True)
        out = (hs, *fin)
        if not torch.equal(hs, kernel.slstm(wx, r)[0]):
            raise AssertionError(f"{tag}: keeping gave other bits")
        _slstm_same_bits(tag, lambda: kernel.slstm(wx, r))
        plain_out = slstm_ref(wx, r)
        wit = slstm_ref(wx.double(), r.double())
        err = max(err, _slstm_vs_witness(tag, out, (plain_out[0], *plain_out[1]),
                                         (wit[0], *wit[1]), names, failed))
        if path == "prefill":
            prefill_r, prefill_fin = r, fin
        del plain_out, wit, out, fin, kept
        flops, nbytes = ops.cost(B, S, d)
        b_ms, b_by = bound(flops, nbytes, PEAK_F32_FLOPS)
        times = time_each(lambda: kernel.slstm(wx, r), flush, reps=SLSTM_REPS)
        ms = spread(times)[1]
        plain_ms = time_ms(lambda: slstm_ref(wx, r), flush, reps=1, warmup=1)
        dev = sum(_device_ms_per_launch(lambda: kernel.slstm(wx, r), flush, "slstm_fwd",
                                        reps=3).values())
        log(f"  slstm main path {path} (B{B} S{S} d{d}): kernel {fmt_spread(times)} "
            f"({SLSTM_REPS} calls; slstm_fwd_kernel's device time {dev:.4f} ms), plain slstm_ref "
            f"{plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}: {flops:.4e} f32 operations at "
            f"{PEAK_F32_FLOPS / 1e12:.0f} TFLOP/s, {nbytes / 1e9:.4f} GB read and written); "
            f"{1e3 * ms / S:.3f} us a step at the median, {ms / b_ms:.1f}x the bound")
        recs[path] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)
        del wx, r, hs
    if failed:
        raise AssertionError(f"slstm disagrees with its f64 witness in {len(failed)} holds: "
                             + "; ".join(failed))

    # decode: one step at d 1024 from the cached state, the serving path's
    # most frequent call
    B, S = SLSTM_DECODE
    starts = {"a drawn state": _slstm_inputs(gen, B, S, d, True),
              "the prefill's final state": (_slstm_inputs(gen, B, S, d, False)[0], prefill_r,
                                            prefill_fin)}
    for start, (wx, r, state) in starts.items():
        tag = f"slstm main-path decode B{B} S{S} d{d} from {start}"
        hs, fin, kept = kernel.slstm(wx, r, state, keep=True)
        if not torch.equal(hs, kernel.slstm(wx, r, state)[0]):
            raise AssertionError(f"{tag}: keeping gave other bits")
        _slstm_same_bits(tag, lambda: kernel.slstm(wx, r, state))
        rhs, rfin = slstm_ref(wx, r, state)
        for n, a, b in zip(names, (hs, *fin), (rhs, *rfin)):
            err = max(err, hold(f"{tag} {n}", a, b, SLSTM_TOL))
    flops, nbytes = ops.cost(B, S, d)
    b_ms, b_by = bound(flops, nbytes, PEAK_F32_FLOPS)
    times = time_each(lambda: kernel.slstm(wx, r, state), flush, reps=SLSTM_REPS)
    plain_ms = time_ms(lambda: slstm_ref(wx, r, state), flush, reps=SLSTM_REPS)
    log(f"  slstm main path decode (B{B} S{S} d{d} from a state): kernel {fmt_spread(times)} "
        f"({SLSTM_REPS} calls), plain slstm_ref {plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}: "
        f"{flops:.4e} f32 operations, {nbytes / 1e9:.4f} GB read and written), "
        f"{spread(times)[1] / b_ms:.1f}x the bound")
    del starts, prefill_r, prefill_fin, wx, r, state, hs, fin, kept
    # the record carries the serving path's shape, the prefill
    return dict(name="slstm", route="cuda", source="src/repro_torch/csrc/slstm.cu",
                replaces="src/repro/models/xlstm.py:226", max_abs_err=err, library_ms=None,
                **recs["prefill"])


def check_slstm_bwd(gen: torch.Generator, flush: torch.Tensor) -> dict:
    """The sLSTM's backward kernel (``slstm_bwd_kernel``: the forward's
    grid in reverse time, each block's share of dpre r^T for every unit
    exchanged as step-tagged words; dr one product in the wrapper)
    against ``slstm_bwd_ref`` on what the forward kernel kept: at d = 128
    on SLSTM_CASES with and without a start state (and then the final
    state's gradient) at SLSTM_TOL, dr (and at S >= SLSTM_WITNESS_S every
    output) against an f64 witness within SLSTM_MAIN_MARGIN x the plain
    f32 version's own error; B2 S5 at SLSTM_SMEM_D against the f64 witness; at
    xlstm-350m's training microbatch (B1 S4096 d1024)
    against an f64 witness within SLSTM_MAIN_MARGIN x the plain f32
    version's own error, the same bits twice. Timed there beside the plain
    version and the bound."""
    from repro_torch.kernels.slstm import kernel, ops
    from repro_torch.kernels.slstm.ref import slstm_bwd_ref, slstm_ref

    names = ("dwx", "dr", "dc0", "dn0", "dh0", "dm0")
    log("[kernels] slstm_bwd vs slstm_bwd_ref in f32 on the forward kernel's kept tensors "
        "(dwx, dr; dc0, dn0, dh0, dm0 with a start state)")
    err = 0.0
    rnd = lambda *shape: torch.randn(shape, generator=gen, device="cuda")
    f64 = lambda ts: None if ts is None else tuple(t.double() for t in ts)
    failed = []
    for B, S in SLSTM_CASES:
        for with_state in (False, True):
            tag = f"slstm bwd B{B} S{S} d{SLSTM_D}{' with state' if with_state else ''}"
            wx, r, state = _slstm_inputs(gen, B, S, SLSTM_D, with_state)
            hs, _, kept = kernel.slstm(wx, r, state, keep=True)
            dhs = rnd(B, S, SLSTM_D)
            dfin = tuple(rnd(B, SLSTM_D) for _ in range(4)) if with_state else None
            got = kernel.slstm_bwd(r, state, hs, kept, dhs, dfin)
            want = slstm_bwd_ref(r, state, hs, kept, dhs, dfin)
            wit = slstm_bwd_ref(r.double(), f64(state), hs.double(), f64(kept), dhs.double(),
                                f64(dfin))
            torch.cuda.synchronize()
            if (got[2] is None) != (want[2] is None):
                raise AssertionError(f"{tag}: the start state's gradient missing on one side")
            flat = lambda out: (out[0], out[1], *(out[2] or ()))
            for n, a, b, w in zip(names, flat(got), flat(want), flat(wit)):
                if n == "dr" or S >= SLSTM_WITNESS_S:
                    err = max(err, _slstm_vs_witness(tag, (a,), (b,), (w,), (n,), failed))
                else:
                    err = max(err, hold(f"{tag} {n}", a, b, SLSTM_TOL))
            _slstm_same_bits(tag, lambda: kernel.slstm_bwd(r, state, hs, kept, dhs, dfin))
    if failed:
        raise AssertionError("slstm_bwd disagrees with its f64 witness: " + "; ".join(failed))

    # SLSTM_SMEM_D: a thread's third unit keeps r's values in shared memory
    d = SLSTM_SMEM_D
    wx, r, state = _slstm_inputs(gen, 2, 5, d, True)
    hs, _, kept = kernel.slstm(wx, r, state, keep=True)
    dhs, dfin = rnd(2, 5, d), tuple(rnd(2, d) for _ in range(4))
    wit = slstm_bwd_ref(r.double(), f64(state), hs.double(), f64(kept), dhs.double(), f64(dfin))
    err = max(err, _slstm_vs_witness(
        f"slstm bwd B2 S5 d{d} with state", flat(kernel.slstm_bwd(r, state, hs, kept, dhs, dfin)),
        flat(slstm_bwd_ref(r, state, hs, kept, dhs, dfin)), flat(wit), names, failed))
    if failed:
        raise AssertionError("slstm_bwd disagrees with its f64 witness: " + "; ".join(failed))

    B, S = SLSTM_MAIN["training"]
    d = SLSTM_MAIN_D
    tag = f"slstm bwd main-path training B{B} S{S} d{d}"
    wx, r, _ = _slstm_inputs(gen, B, S, d, False)
    hs, _, kept = kernel.slstm(wx, r, None, keep=True)
    dhs = rnd(B, S, d)
    del wx
    fn = lambda: kernel.slstm_bwd(r, None, hs, kept, dhs)
    got = fn()
    _slstm_same_bits(tag, fn)
    plain = slstm_bwd_ref(r, None, hs, kept, dhs, None)
    wit = slstm_bwd_ref(r.double(), None, hs.double(), f64(kept), dhs.double(), None)
    err = max(err, _slstm_vs_witness(tag, got[:2], plain[:2], wit[:2], names, failed))
    del got, plain, wit
    if failed:
        raise AssertionError("slstm_bwd disagrees with its f64 witness: " + "; ".join(failed))

    # the gradient's least work (``ops.bwd_cost``): dpre r^T (the recurrent
    # dh) and dr = h_prev^T dpre at the f32 FMA rate
    flops, nbytes = ops.bwd_cost(B, S, d)
    b_ms, b_by = bound(flops, nbytes, PEAK_F32_FLOPS)
    times = time_each(fn, flush, reps=SLSTM_REPS)
    ms = spread(times)[1]
    plain_ms = time_ms(lambda: slstm_bwd_ref(r, None, hs, kept, dhs, None), flush, reps=1,
                       warmup=1)
    dev = sum(_device_ms_per_launch(fn, flush, "slstm_bwd", reps=3).values())
    log(f"  slstm_bwd main path (B{B} S{S} d{d}): kernel and the wrapper's dr product "
        f"{fmt_spread(times)} ({SLSTM_REPS} calls; slstm_bwd_kernel's device time {dev:.4f} ms), "
        f"plain slstm_bwd_ref {plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}: {flops:.4e} f32 "
        f"operations at {PEAK_F32_FLOPS / 1e12:.0f} TFLOP/s, {nbytes / 1e9:.4f} GB read and "
        f"written); {1e3 * ms / S:.3f} us a step at the median, {ms / b_ms:.1f}x the bound")
    del r, hs, kept, dhs
    return dict(name="slstm_bwd", route="cuda", source="src/repro_torch/csrc/slstm.cu",
                replaces="src/repro/models/xlstm.py:226", max_abs_err=err, library_ms=None,
                ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)


def check_slstm_wide(gen: torch.Generator, flush: torch.Tensor) -> dict:
    """Both sLSTM kernels at SLSTM_WIDE_CASES' widths: d 200 (padded to a
    multiple of 32 by the wrapper and sliced back) and d 1152, 2048 and
    4096, where d / 8 blocks cannot all be resident and the wide grids run.
    At each launch the units a block the library picks equal
    ``kernel.h100_units`` (the meta route's rule: the dry run allocates the
    backward's exchange by it). The forward against ``slstm_ref``: its
    final state is the last step of hs and of what it keeps, bit for bit;
    hs, the final state and what it keeps at SLSTM_TOL, or at S >=
    SLSTM_WITNESS_S hs and what it keeps (every step's pre, c, n, m)
    against the f64 witness within SLSTM_MAIN_MARGIN x the plain f32
    version's own error. The backward on the kernel's kept tensors against
    ``slstm_bwd_ref``: at SLSTM_TOL, but dr, and every output at S >=
    SLSTM_WITNESS_S, against the f64 witness the same way;
    keeping leaves the forward's bits as they are; two calls of each give
    the same bits. Timed at SLSTM_WIDE_TIMED beside the plain versions and
    the bounds (``ops.cost``, ``ops.bwd_cost``: f32 FMAs). Returns each
    kernel's largest error."""
    from repro_torch.kernels.slstm import kernel, ops
    from repro_torch.kernels.slstm.ref import slstm_bwd_ref, slstm_ref

    log("[kernels] slstm and slstm_bwd at wide and unaligned d (the wide grids, the padding)")
    fwd_names, bwd_names = ("hs", "c", "n", "h", "m"), ("dwx", "dr", "dc0", "dn0", "dh0", "dm0")
    kept_names = ("hs", "kept pre", "kept c", "kept n", "kept m")
    rnd = lambda *shape: torch.randn(shape, generator=gen, device="cuda")
    f64 = lambda ts: None if ts is None else tuple(t.double() for t in ts)
    flat = lambda out: (out[0], out[1], *(out[2] or ()))
    errs = {"slstm": 0.0, "slstm_bwd": 0.0}
    failed = []
    for d, B, S, with_state in SLSTM_WIDE_CASES:
        dp = kernel.padded(d)
        picked = (kernel.units(B, dp), kernel.units(B, dp, backward=True))
        tag = (f"slstm wide d{d} B{B} S{S}{' with state' if with_state else ''} "
               f"(units a block {picked[0]} / {picked[1]})")
        if picked != (kernel.h100_units(dp),) * 2:
            raise AssertionError(f"{tag}: the library picked {picked} units a block, the dry "
                                 f"run's rule {kernel.h100_units(dp)}")
        wx, r, state = _slstm_inputs(gen, B, S, d, with_state)
        hs, fin, kept = kernel.slstm(wx, r, state, keep=True)
        if not torch.equal(hs, kernel.slstm(wx, r, state)[0]):
            raise AssertionError(f"{tag}: keeping gave other bits")
        last = (kept[1][:, -1], kept[2][:, -1], hs[:, -1], kept[3][:, -1])
        if not all(torch.equal(a, b) for a, b in zip(fin, last)):
            raise AssertionError(f"{tag}: the final state is not the last step's c, n, h, m")
        _slstm_same_bits(tag, lambda: kernel.slstm(wx, r, state))
        plain = slstm_ref(wx, r, state, keep=True)
        if S >= SLSTM_WITNESS_S:
            # every step's h, pre-activations and c, n, m (the final state is
            # their last step, bit for bit): a B x d slice alone is too few
            # values for a ratio of two largest errors
            wit = slstm_ref(wx.double(), r.double(), f64(state), keep=True)
            errs["slstm"] = max(errs["slstm"], _slstm_vs_witness(
                tag, (hs, *kept), (plain[0], *plain[2]), (wit[0], *wit[2]), kept_names, failed))
            del wit
        else:
            for n, a, b in zip(fwd_names + ("kept pre", "kept c", "kept n", "kept m"),
                               (hs, *fin, *kept), (plain[0], *plain[1], *plain[2])):
                errs["slstm"] = max(errs["slstm"], hold(f"{tag} {n}", a, b, SLSTM_TOL))
        del plain
        dhs = rnd(B, S, d)
        dfin = tuple(rnd(B, d) for _ in range(4)) if with_state else None
        bwd = lambda: kernel.slstm_bwd(r, state, hs, kept, dhs, dfin)
        got = bwd()
        want = slstm_bwd_ref(r, state, hs, kept, dhs, dfin)
        wit = slstm_bwd_ref(r.double(), f64(state), hs.double(), f64(kept), dhs.double(),
                            f64(dfin))
        for n, a, b, w in zip(bwd_names, flat(got), flat(want), flat(wit)):
            if n == "dr" or S >= SLSTM_WITNESS_S:
                errs["slstm_bwd"] = max(errs["slstm_bwd"], _slstm_vs_witness(
                    f"{tag} bwd", (a,), (b,), (w,), (n,), failed))
            else:
                errs["slstm_bwd"] = max(errs["slstm_bwd"], hold(f"{tag} bwd {n}", a, b, SLSTM_TOL))
        _slstm_same_bits(f"{tag} bwd", bwd)
        del got, want, wit, wx, r, state, hs, fin, kept, dhs, dfin
    if failed:
        raise AssertionError("the wide sLSTM disagrees with its f64 witness: " + "; ".join(failed))

    for d, B, S in SLSTM_WIDE_TIMED:
        wx, r, _ = _slstm_inputs(gen, B, S, d, False)
        hs, _, kept = kernel.slstm(wx, r, None, keep=True)
        dhs = rnd(B, S, d)
        reps = 2 if S > 1024 else SLSTM_WIDE_REPS
        fwd_t = time_each(lambda: kernel.slstm(wx, r), flush, reps=reps)
        bwd_t = time_each(lambda: kernel.slstm_bwd(r, None, hs, kept, dhs), flush, reps=reps)
        fwd_plain = time_ms(lambda: slstm_ref(wx, r), flush, reps=1, warmup=1)
        bwd_plain = time_ms(lambda: slstm_bwd_ref(r, None, hs, kept, dhs, None), flush, reps=1,
                            warmup=1)
        fb, fby = bound(*ops.cost(B, S, d), PEAK_F32_FLOPS)
        bb, bby = bound(*ops.bwd_cost(B, S, d), PEAK_F32_FLOPS)
        log(f"  slstm wide d{d} B{B} S{S} ({kernel.units(B, kernel.padded(d))} units a block): "
            f"forward {fmt_spread(fwd_t)} ({reps} calls), plain slstm_ref {fwd_plain:.4f} ms, "
            f"bound {fb:.4f} ms ({fby}), {1e3 * spread(fwd_t)[1] / S:.3f} us a step, "
            f"{spread(fwd_t)[1] / fb:.1f}x the bound; backward with the wrapper's dr "
            f"{fmt_spread(bwd_t)}, plain slstm_bwd_ref {bwd_plain:.4f} ms, bound {bb:.4f} ms "
            f"({bby}), {1e3 * spread(bwd_t)[1] / S:.3f} us a step, "
            f"{spread(bwd_t)[1] / bb:.1f}x the bound")
        del wx, r, hs, kept, dhs
    return errs


# ---------------------------------------------------------------------------
# phase 4: full-width serving
# ---------------------------------------------------------------------------

def draw_biases(params, gen: torch.Generator) -> None:
    """Overwrite the attention biases (zeros from ``init``, as in the
    reference) with an N(0, 0.5) draw from ``gen``, in place, so that a
    path that never added them could not pass; no-op without biases."""
    attn = params["blocks"]["attn"] if "blocks" in params else {}
    for key in ("bq", "bk", "bv"):
        if key in attn:
            t = attn[key]
            t.copy_(0.5 * torch.randn(t.shape, generator=gen, device=t.device,
                                      dtype=torch.float32))


def phase4_requests(cfg) -> list:
    """Phase 4's 16 requests: lengths from RandomState(0) in [16, 2000],
    plus 2000 and 127, 32 new tokens each."""
    from repro_torch.serve import Request

    rng = np.random.RandomState(0)
    lens = rng.randint(16, 2001, 14).tolist() + [2000, 127]
    return [Request(rid=i, prompt=rng.randint(0, cfg.vocab_size, n).astype(np.int32),
                    max_new_tokens=32) for i, n in enumerate(lens)]


def serve_full_width(arch: str = "qwen3-4b", tag: str = "serve") -> dict:
    """``arch`` at full width and depth, bf16, through ``DecodeEngine`` on
    phase 4's requests (the attention biases drawn nonzero where the model
    has them)."""
    from repro_torch.config import ShardingLayout, get_arch
    from repro_torch.models import RunOpts, build_model
    from repro_torch.serve import DecodeEngine

    cfg = get_arch(arch)
    model = build_model(cfg)
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = model.init(gen, "cuda", torch.bfloat16)
    draw_biases(params, gen)
    torch.cuda.synchronize()
    n_params = model.param_count()
    log(f"[{tag}] {cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.num_heads}/{cfg.num_kv_heads} heads x {cfg.resolved_head_dim}, qkv bias "
        f"{cfg.qkv_bias}, {n_params / 1e9:.3f} B params in bf16, made on the card in "
        f"{time.perf_counter() - t0:.1f} s")

    reqs = phase4_requests(cfg)
    lens = [len(r.prompt) for r in reqs]
    num_pages = 4 * 128 + 1
    eng = DecodeEngine(model, ShardingLayout(attn_impl="flash"), "cuda",
                       lanes=8, num_pages=num_pages, max_context=2048)
    for r in reqs:
        eng.submit(r)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    done = eng.run(params)
    wall = time.perf_counter() - t0
    launches = read_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    if sorted(c.rid for c in done) != list(range(len(reqs))):
        raise AssertionError("not every request completed")
    if not all(len(c.tokens) == 32 and c.reason == "length" for c in done):
        raise AssertionError("a request did not get 32 tokens")
    if not all(0 <= t < cfg.vocab_size for c in done for t in c.tokens):
        raise AssertionError("a generated token is outside the vocabulary")
    if eng.free_pages != num_pages - 1:
        raise AssertionError(f"pool did not drain: {eng.free_pages} free of {num_pages - 1}")
    want = expect_launches(flash_attention_tc=cfg.num_layers * eng.prefills,
                           paged_attention_tc=cfg.num_layers * eng.decode_steps)
    log(f"[{tag}] {len(done)} requests x 32 tokens done in {wall:.2f} s; prompt lengths "
        f"{lens}; {eng.prefills} prefills, {eng.decode_steps} decode steps; pool back to "
        f"{eng.free_pages} free pages")
    log(f"[{tag}] launches {launches}, expected {want}")
    if launches != want or min(launches["flash_attention_tc"],
                               launches["paged_attention_tc"]) <= 0:
        raise AssertionError("the main path did not go through the kernels as expected")
    log(f"[{tag}] prefill {eng.prefilled_tokens / eng.prefill_seconds:.1f} tokens/s "
        f"({eng.prefilled_tokens} tokens in {eng.prefill_seconds:.3f} s); decode "
        f"{eng.measured_tokens_per_sec:.1f} tokens/s ({eng.decoded_tokens} tokens in "
        f"{eng.decode_seconds:.3f} s, {1e3 * eng.decode_seconds / eng.decode_steps:.2f} ms "
        f"per step); peak memory {peak_gb:.2f} GB")

    # flash prefill against the plain masked path, on the longest prompt
    tokens = torch.as_tensor(reqs[14].prompt[None, :], device="cuda")
    S = tokens.shape[1]
    flash, _ = model.prefill(params, {"tokens": tokens}, S, RunOpts(attn_impl="flash"))
    masked, _ = model.prefill(params, {"tokens": tokens}, S, RunOpts(attn_impl="masked"))
    a, b = flash[0, -1].float(), masked[0, -1].float()
    corr = float(torch.corrcoef(torch.stack([a, b]))[0, 1])
    top_eq = int(a.argmax()) == int(b.argmax())
    log(f"[{tag}] flash vs masked prefill logits (S={S}): top-1 equal {top_eq}, "
        f"correlation {corr:.6f}, max abs diff {float((a - b).abs().max()):.4f}")
    del flash, masked
    if not (torch.isfinite(a).all() and top_eq and corr > 0.99):
        raise AssertionError("flash prefill logits disagree with the masked path")
    profile_serving(model, params)
    return launches


def _device_breakdown(prof, wall_ms: float, top: int = 8) -> str:
    """Device time by kernel (torch.profiler): the ``top`` kernels and each
    of the port's own wherever it ranks; the device's busy share of the
    window; the host ops that cost the most CPU time."""
    evts = prof.key_averages()
    dev = [e for e in evts if getattr(e, "self_device_time_total", 0) > 0
           and str(getattr(e, "device_type", "")).endswith("CUDA")]
    busy_ms = sum(e.self_device_time_total for e in dev) / 1e3
    if busy_ms <= 0:
        raise AssertionError("the profiler recorded no device time")
    lines = [f"    window {wall_ms:.2f} ms, device busy {busy_ms:.2f} ms "
             f"({100 * busy_ms / wall_ms:.1f}%), idle {100 * (1 - busy_ms / wall_ms):.1f}%"]
    ranked = sorted(dev, key=lambda e: -e.self_device_time_total)
    # csrc/*.cu keep their kernels in an anonymous namespace
    port = [e for e in ranked[top:] if e.key.startswith("void (anonymous namespace)::")]
    for e in ranked[:top] + port:
        lines.append(f"    device {e.self_device_time_total / 1e3:9.3f} ms "
                     f"{100 * e.self_device_time_total / 1e3 / busy_ms:5.1f}% "
                     f"x{e.count:<5d} {e.key[:90]}")
    host = sorted((e for e in evts if e.self_cpu_time_total > 0),
                  key=lambda e: -e.self_cpu_time_total)[:top]
    for e in host:
        lines.append(f"    host   {e.self_cpu_time_total / 1e3:9.3f} ms "
                     f"x{e.count:<6d} {e.key[:60]}")
    return "\n".join(lines)


def profile_serving(model, params) -> None:
    """Where the time goes: one full-width prefill (S=2000) and three decode
    steps of 8 lanes at ~1000 cached tokens, under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.config import ShardingLayout
    from repro_torch.serve import DecodeEngine, Request

    rng = np.random.RandomState(2)
    eng = DecodeEngine(model, ShardingLayout(attn_impl="flash"), "cuda",
                       lanes=8, num_pages=4 * 128 + 1, max_context=2048)
    vocab = model.cfg.vocab_size
    eng.submit(Request(rid=0, prompt=rng.randint(0, vocab, 2000).astype(np.int32),
                       max_new_tokens=2))
    eng.run(params)                                   # warm the prefill path
    eng.submit(Request(rid=1, prompt=rng.randint(0, vocab, 2000).astype(np.int32),
                       max_new_tokens=1))             # prefill only: done at admission
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        eng.step(params)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    log(f"[profile] one prefill, S=2000:\n{_device_breakdown(prof, wall)}")

    for i in range(8):
        eng.submit(Request(rid=10 + i, prompt=rng.randint(0, vocab, 1000).astype(np.int32),
                           max_new_tokens=8))
    eng.step(params)                                  # admits all 8 lanes, first decode
    eng.step(params)
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(3):
            eng.step(params)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    log(f"[profile] three decode steps, 8 lanes x ~1000 cached tokens:\n"
        f"{_device_breakdown(prof, wall)}")


def serve_reduced_matches_cpu(arch: str = "qwen3-4b", int8: bool = False,
                              tag: str = "serve") -> dict:
    """A reduced f32 model: the engine on the card (the f32 flash variant and
    the paged kernel; with ``int8`` the int8 pool, which decodes through the
    paged kernel's int8 FMA variant) must give the plain CPU engine's greedy
    streams token for token. Returns the card run's launches."""
    from repro_torch.config import ShardingLayout, get_arch
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_map
    from repro_torch.serve import DecodeEngine, Request

    cfg = reduced_f32(get_arch(arch))
    model = build_model(cfg)
    gen = torch.Generator().manual_seed(0)
    params_cpu = model.init(gen, "cpu")
    draw_biases(params_cpu, gen)
    params_gpu = tree_map(lambda t: t.to("cuda"), params_cpu)
    rng = np.random.RandomState(0)
    reqs = [Request(rid=i, prompt=rng.randint(0, cfg.vocab_size, n).astype(np.int32),
                    max_new_tokens=8) for i, n in enumerate((5, 17, 9, 30))]
    streams = {}
    layout = ShardingLayout(attn_impl="flash", int8_kv_cache=int8)
    for device, params in (("cpu", params_cpu), ("cuda", params_gpu)):
        eng = DecodeEngine(model, layout, device, lanes=2, num_pages=9, max_context=48)
        for r in reqs:
            eng.submit(r)
        reset_launches()
        streams[device] = {c.rid: c.tokens for c in eng.run(params)}
        launches = read_launches()
    log(f"[{tag}] reduced f32 {cfg.name} streams{' (int8 pool)' if int8 else ''}, card vs CPU "
        f"plain: {'identical' if streams['cpu'] == streams['cuda'] else 'DIFFERENT'}")
    if streams["cpu"] != streams["cuda"]:
        raise AssertionError(f"card streams {streams['cuda']} != CPU {streams['cpu']}")
    if int8:
        if launches["paged_attention_fma"] or launches["paged_attention_tc"]:
            raise AssertionError("the int8 pool launched the bf16 or f32 paged kernel")
        return hold_f32_launches(tag, launches, "flash_attention_tf32", "paged_attention_int8_fma")
    return hold_f32_launches(tag, launches, "flash_attention_tf32", "paged_attention_fma")


# ---------------------------------------------------------------------------
# phase 5: full-width hybrid serving (hymba-1.5b)
# ---------------------------------------------------------------------------

HYBRID_BATCH, HYBRID_PROMPT, HYBRID_NEW = 8, 4096, 32


def serve_hybrid_full_width() -> dict:
    """hymba-1.5b at full width and depth through the serve launcher's loop:
    one batched prefill of 8 prompts x 4096 tokens (four windows), then 31
    greedy decode steps against the 1024-slot ring-buffer cache."""
    from unittest import mock

    from repro_torch.config import get_arch
    from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref
    from repro_torch.launch.serve import greedy_serve
    from repro_torch.models import RunOpts, build_model, ssm

    cfg = get_arch("hymba-1.5b")
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(0), "cuda", torch.bfloat16)
    torch.cuda.synchronize()
    mamba = params["blocks"]["mamba"]
    kept = {k: mamba[k].dtype for k in ("A_log", "x_proj", "dt_proj")}
    log(f"[hybrid] {cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.num_heads}/{cfg.num_kv_heads} heads x {cfg.resolved_head_dim}, window "
        f"{cfg.window}, ssm inner {cfg.ssm.expand * cfg.d_model} N {cfg.ssm.state_dim}; "
        f"{model.param_count() / 1e9:.3f} B params (matrices bf16, {kept}), made on the "
        f"card in {time.perf_counter() - t0:.1f} s")
    if any(d != torch.float32 for d in kept.values()):
        raise AssertionError(f"f32 leaves stored in another dtype: {kept}")

    B, S, new = HYBRID_BATCH, HYBRID_PROMPT, HYBRID_NEW
    prompts = np.random.RandomState(0).randint(0, cfg.vocab_size, (B, S)).astype(np.int32)
    tokens = torch.as_tensor(prompts, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    res = greedy_serve(model, params, tokens, new)
    launches = read_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    want = expect_launches(flash_attention_tc=cfg.num_layers,
                           ssm_scan=cfg.num_layers * (1 + res.decode_steps))
    out = res.tokens
    log(f"[hybrid] {B} prompts x {S} tokens, {new} new tokens each; first row "
        f"{out[0].tolist()}")
    log(f"[hybrid] launches {launches}, expected {want}")
    if tuple(out.shape) != (B, new) or not bool(((out >= 0) & (out < cfg.vocab_size)).all()):
        raise AssertionError(f"generated tokens {tuple(out.shape)} outside the vocabulary")
    if not all(bool(torch.isfinite(lg.float()).all()) for lg in res.logits):
        raise AssertionError("non-finite logits")
    if res.decode_steps != new - 1 or launches != want:
        raise AssertionError("the hybrid path did not go through the kernels as expected")
    log(f"[hybrid] prefill {B * S / res.prefill_seconds:.1f} tokens/s ({B * S} tokens in "
        f"{res.prefill_seconds:.3f} s); decode {1e3 * res.decode_seconds / res.decode_steps:.2f} "
        f"ms per step ({B * res.decode_steps / res.decode_seconds:.1f} tokens/s); peak memory "
        f"{peak_gb:.2f} GB")

    # the kernel path's prefill against the plain path (masked attention, the
    # plain sequential scan) on one prompt longer than the window
    row = tokens[:1]
    kern, _ = model.prefill(params, {"tokens": row}, S, RunOpts(attn_impl="flash"))
    before = read_launches()
    t0 = time.perf_counter()
    with mock.patch.object(ssm, "ssm_scan", ssm_scan_ref):
        plain, _ = model.prefill(params, {"tokens": row}, S, RunOpts(attn_impl="masked"))
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    if read_launches() != before:
        raise AssertionError("the plain path launched a kernel")
    a, b = kern[0, -1].float(), plain[0, -1].float()
    corr = float(torch.corrcoef(torch.stack([a, b]))[0, 1])
    top_eq = int(a.argmax()) == int(b.argmax())
    same_as_batch = float((res.logits[0][0].float() - a).abs().max())
    log(f"[hybrid] kernel vs plain prefill logits (S={S}, plain path {plain_s:.1f} s): top-1 "
        f"equal {top_eq}, correlation {corr:.6f}, max abs diff {float((a - b).abs().max()):.4f}; "
        f"the batched prefill's row 0 differs from the single prompt's by {same_as_batch:.4f}")
    if not (torch.isfinite(b).all() and top_eq and corr > 0.99):
        raise AssertionError("kernel-path prefill logits disagree with the plain path")
    profile_greedy("hybrid", model, params, tokens, res.cache, new)
    return launches


def profile_greedy(tag: str, model, params, tokens, cache, new: int, frames=None) -> None:
    """Where the time goes on a serve-launcher path: one batched full-width
    prefill of ``tokens`` (an encoder-decoder's ``frames`` encoded first)
    and three decode steps of its rows from ``cache`` (past the served
    tokens, in the ring), under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import RunOpts

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    opts = RunOpts(attn_impl="flash")
    B, S = tokens.shape
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        batch = {"tokens": tokens} if frames is None else {"tokens": tokens, "frames": frames}
        logits, _ = model.prefill(params, batch, S + new, opts)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    log(f"[profile] {tag} prefill, {B} x {S} tokens:\n{_device_breakdown(prof, wall)}")
    del logits, prof
    tok = torch.zeros((B, 1), dtype=torch.int32, device="cuda")
    pos = S + new
    model.decode_step(params, cache, tok, pos, opts)
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for i in range(3):
            model.decode_step(params, cache, tok, pos + 1 + i, opts)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    log(f"[profile] three {tag} decode steps, {B} rows:\n{_device_breakdown(prof, wall)}")


def greedy_reduced_matches_cpu(arch: str, tag: str, *kernels: str, cfg=None) -> dict:
    """A reduced model at f32 (or ``cfg``): the serve launcher's loop on the
    card (the kernels) against the same loop on the CPU (their plain
    versions), and a MoE model's expert counters equal. The prompt, 20
    tokens, is longer than hymba's and mixtral's 16-slot rings (16 new
    tokens wrap them) and ragged against the mLSTM's chunks (8 on the CPU,
    64 in the kernel). Returns the card run's launches, which must include
    ``kernels``."""
    from repro_torch.config import get_arch
    from repro_torch.launch.serve import greedy_serve
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_map

    cfg = cfg or reduced_f32(get_arch(arch))
    model = build_model(cfg)
    gen = torch.Generator().manual_seed(0)
    params_cpu = model.init(gen, "cpu")
    # an encoder-decoder's biases and norms all start at their defaults
    (draw_off_defaults if cfg.encoder_layers else draw_biases)(params_cpu, gen)
    params_gpu = tree_map(lambda t: t.to("cuda"), params_cpu)
    prompt = np.random.RandomState(0).randint(0, cfg.vocab_size, (2, 20)).astype(np.int32)
    patches = (torch.randn((2, cfg.vision_tokens, cfg.vision_width), generator=gen)
               if cfg.vision_tokens else None)
    frames = (torch.randn((2, cfg.encoder_seq_len, cfg.d_model), generator=gen)
              if cfg.encoder_layers else None)
    on = lambda t, device: None if t is None else t.to(device)
    runs = {}
    for device, params in (("cuda", params_gpu), ("cpu", params_cpu)):
        reset_launches()
        runs[device] = greedy_serve(
            model, params, torch.as_tensor(prompt, device=device), 16,
            patches=on(patches, device), frames=on(frames, device))
        if device == "cuda":
            launches = read_launches()
    gpu, cpu = runs["cuda"], runs["cpu"]
    err = max(float((a.cpu() - b).abs().max()) for a, b in zip(gpu.logits, cpu.logits))
    ok = all(torch.allclose(a.cpu(), b, **REDUCED_LOGITS_TOL) for a, b in zip(gpu.logits, cpu.logits))
    same = torch.equal(gpu.tokens, cpu.tokens)
    log(f"[{tag}] reduced f32 streams, card vs CPU plain: {'identical' if same else 'DIFFERENT'}; "
        f"logits max abs diff {err:.3e} (atol {REDUCED_LOGITS_TOL['atol']}, rtol "
        f"{REDUCED_LOGITS_TOL['rtol']})")
    if "moe_load" in cpu.cache.get("blocks", {}):
        loads = gpu.cache["blocks"]["moe_load"].cpu(), cpu.cache["blocks"]["moe_load"]
        log(f"[{tag}] reduced f32 expert counters ({loads[1].numel()}), card vs CPU: "
            f"{'equal' if torch.equal(*loads) else 'DIFFERENT'}")
        same = same and torch.equal(*loads)
    if not (same and ok):
        raise AssertionError(f"card {gpu.tokens.tolist()} != CPU {cpu.tokens.tolist()}, or logits")
    return hold_f32_launches(tag, launches, *kernels)


# ---------------------------------------------------------------------------
# phase 6: full-width xLSTM serving (xlstm-350m)
# ---------------------------------------------------------------------------

XLSTM_BATCH, XLSTM_PROMPT, XLSTM_NEW = 8, 4096, 32
# the prompt length of the bf16 end-to-end check, above the step kernel's
# STEP_MAX so that the prefill kernel runs it. Random-weight bf16 xlstm is
# chaotic (``--xlstm-orders``: a random relative 1e-7 change of the mLSTM
# outputs flips prompt 0's top-1 at 8 and 32 tokens), so the check holds a
# path's distance from an f32 reference against that of two plain bf16
# orders, not top-1 against one of them.
XLSTM_BF16_LEN = 32
# hold 1's margin over the larger of the two plain orders' distances
XLSTM_D_MARGIN = 1.5


def serve_xlstm_full_width() -> dict:
    """xlstm-350m at full width and depth through the serve launcher's loop:
    one batched prefill of 8 prompts x 4096 tokens, then 31 greedy decode
    steps against the recurrent states."""
    from repro_torch.config import get_arch
    from repro_torch.launch.serve import greedy_serve
    from repro_torch.models import build_model, transformer, xlstm
    from repro_torch.models.common import tree_leaves

    cfg = get_arch("xlstm-350m")
    model = build_model(cfg)
    groups, m_per, has_s = transformer._xlstm_group_layout(cfg)
    n_mlstm, n_slstm = groups * m_per, groups * has_s
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(0), "cuda", torch.bfloat16)
    torch.cuda.synchronize()
    g = params["groups"]
    kept = {k: g[blk]["block"][k].dtype for blk, k in (("mlstm", "w_if"), ("slstm", "w_gates"),
                                                       ("slstm", "r_gates"))}
    H, inner, hd = xlstm._mdims(cfg)
    log(f"[xlstm] {cfg.name}: {cfg.num_layers} layers = {groups} groups x ({m_per} mLSTM + "
        f"{has_s} sLSTM), d_model {cfg.d_model}, {H} heads x {hd} (inner {inner}), vocab "
        f"{cfg.vocab_size}; {model.param_count()} params (matrices bf16, {kept}), made on the "
        f"card in {time.perf_counter() - t0:.1f} s")
    if any(d != torch.float32 for d in kept.values()):
        raise AssertionError(f"f32 leaves stored in another dtype: {kept}")

    B, S, new = XLSTM_BATCH, XLSTM_PROMPT, XLSTM_NEW
    prompts = np.random.RandomState(0).randint(0, cfg.vocab_size, (B, S)).astype(np.int32)
    tokens = torch.as_tensor(prompts, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    res = greedy_serve(model, params, tokens, new)
    launches = read_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    want = expect_launches(mlstm_tc=n_mlstm, mlstm_step=n_mlstm * res.decode_steps,
                           slstm=n_slstm * (1 + res.decode_steps))
    out = res.tokens
    log(f"[xlstm] {B} prompts x {S} tokens, {new} new tokens each; first row "
        f"{out[0].tolist()}")
    log(f"[xlstm] launches {launches}, expected {want}")
    if tuple(out.shape) != (B, new) or not bool(((out >= 0) & (out < cfg.vocab_size)).all()):
        raise AssertionError(f"generated tokens {tuple(out.shape)} outside the vocabulary")
    if not all(bool(torch.isfinite(lg.float()).all()) for lg in res.logits):
        raise AssertionError("non-finite logits")
    if not all(bool(torch.isfinite(t).all()) for t in tree_leaves(res.cache)):
        raise AssertionError("non-finite recurrent state")
    if res.decode_steps != new - 1 or launches != want:
        raise AssertionError("the xLSTM path did not go through the kernels as expected")
    log(f"[xlstm] prefill {B * S / res.prefill_seconds:.1f} tokens/s ({B * S} tokens in "
        f"{res.prefill_seconds:.3f} s); decode {1e3 * res.decode_seconds / res.decode_steps:.2f} "
        f"ms per step ({B * res.decode_steps / res.decode_seconds:.1f} tokens/s); peak memory "
        f"{peak_gb:.2f} GB")

    profile_greedy("xlstm", model, params, tokens, res.cache, new)
    compare_xlstm_paths(model, params, tokens, "tc" if launches["mlstm_tc"] else "tf32")
    return launches


def _xlstm_prefill(model, params, rows, chunk=None, held=None, perturb=0.0, route=None):
    """Prefill ``rows`` with the mLSTM kernels (``chunk`` None: as the model
    calls them, or with ``route`` "tf32" or "tc" that chunkwise kernel where
    S > ``STEP_MAX``) and the sLSTM kernel, or with the plain chunkwise form
    at ``chunk`` and the plain ``slstm_ref`` (the kernels' wrappers never
    fall back: a plain route on the card calls the plain versions); with
    ``perturb``, the plain form's h is multiplied by (1 + perturb x a
    standard normal draw) before its rounding to q's dtype. With ``held``
    (a dict), every kernel call's h and final (C, n, m) are held against the
    plain form at the model's chunk on that call's own inputs; ``held``
    keeps the number of calls, each quantity's max abs error and the
    failures. Returns the last position's logits (B, vocab) in f32."""
    from unittest import mock

    from repro_torch.kernels.mlstm import kernel, ops
    from repro_torch.kernels.mlstm.ref import mlstm_chunkwise_ref
    from repro_torch.kernels.slstm import kernel as slstm_kernel
    from repro_torch.kernels.slstm.ref import slstm_ref
    from repro_torch.models import xlstm

    noise = torch.Generator(device="cuda").manual_seed(1) if perturb else None
    chunkwise = {"tf32": kernel.mlstm_tf32, "tc": kernel.mlstm_tc}

    def mlstm(q, k, v, gates, state, model_chunk):
        if chunk is not None and perturb:
            h, st = mlstm_chunkwise_ref(q.float(), k.float(), v.float(), gates, state, chunk)
            h = h * (1 + perturb * torch.randn(h.shape, generator=noise, device=h.device))
            return h.to(q.dtype), st
        if chunk is not None:
            return mlstm_chunkwise_ref(q, k, v, gates, state, chunk)
        if route is not None and q.shape[1] > kernel.STEP_MAX:
            out = chunkwise[route](q, k, v, gates.float().contiguous(), state)
        else:
            out = ops.mlstm(q, k, v, gates, state, model_chunk)
        if held is not None:
            (h, st), (hr, st_r) = out, mlstm_chunkwise_ref(q, k, v, gates, state, model_chunk)
            held["calls"] = held.get("calls", 0) + 1
            for key, a, b in zip("hCnm", (h, *st), (hr, *st_r)):
                err, ok = within(a, b, MLSTM_MAIN_TOLS[key])
                held[key] = max(held.get(key, 0.0), err)
                if not ok:
                    held.setdefault("failed", []).append(f"call {held['calls']} {key}")
        return out

    mlstm_launches = lambda: sum(n for name, n in read_launches().items()
                                 if name.startswith("mlstm_"))
    before, s_before = mlstm_launches(), slstm_kernel.launches
    plain_s = chunk is not None
    with mock.patch.object(xlstm, "mlstm", mlstm), \
            mock.patch.object(xlstm, "slstm", slstm_ref if plain_s else xlstm.slstm):
        logits, _ = model.prefill(params, {"tokens": rows}, rows.shape[1])
    torch.cuda.synchronize()
    launched, s_launched = mlstm_launches() - before, slstm_kernel.launches - s_before
    if launched != (_n_mlstm(model.cfg) if chunk is None else 0):
        raise AssertionError(f"prefill launched the mLSTM kernel {launched} times")
    n_slstm = model.cfg.num_layers // model.cfg.slstm_every
    if s_launched != (0 if plain_s else n_slstm):
        raise AssertionError(f"prefill launched the sLSTM kernel {s_launched} times")
    return logits[:, -1].float()


def _n_mlstm(cfg) -> int:
    return cfg.num_layers - cfg.num_layers // cfg.slstm_every


def _logit_agreement(a: torch.Tensor, b: torch.Tensor) -> tuple:
    corr = float(torch.corrcoef(torch.stack([a, b]))[0, 1])
    return int(a.argmax()) == int(b.argmax()), corr, float((a - b).abs().max())


def _distance(p: torch.Tensor, ref: torch.Tensor) -> float:
    """D: the mean over rows of 1 - corr(p's row, ref's row)."""
    return sum(1 - _logit_agreement(a, b)[1] for a, b in zip(p, ref)) / len(p)


def _mlstm_f64(q, k, v, gates) -> torch.Tensor:
    """h of the mLSTM recurrence from a zero state in f64 (model layout)."""
    B, S, H, hd = q.shape
    q, k, v, gates = (t.double() for t in (q, k, v, gates))
    C = q.new_zeros((B, H, hd, hd))
    n, m = q.new_zeros((B, H, hd)), q.new_zeros((B, H))
    hs = []
    for t in range(S):
        it, ft = gates[:, t, :H], gates[:, t, H:]
        m_new = torch.maximum(ft + m, it)
        i_, f_ = torch.exp(it - m_new), torch.exp(ft + m - m_new)
        kf = k[:, t] / math.sqrt(hd)
        C = f_[..., None, None] * C + i_[..., None, None] * (v[:, t][..., :, None]
                                                             * kf[..., None, :])
        n = f_[..., None] * n + i_[..., None] * kf
        den = torch.clamp((n * q[:, t]).sum(-1).abs(), min=1.0)
        hs.append(torch.einsum("bhij,bhj->bhi", C, q[:, t]) / den[..., None])
        m = m_new
    return torch.stack(hs, dim=1)


def _h_vs_f64(model, params, rows) -> dict:
    """Each mLSTM call of a bf16 prefill of ``rows`` (on the plain path's
    inputs): the share of h's bf16 elements that differ from the f64
    recurrence rounded to bf16, for the split-TF32 kernel, the tensor-core kernel
    and the plain form at chunk 256 (how far each is from exact where the
    end-to-end check compares them). The sLSTM runs its plain ``slstm_ref``
    (the plain path's inputs)."""
    from unittest import mock

    from repro_torch.kernels.mlstm import kernel
    from repro_torch.kernels.mlstm.ref import mlstm_chunkwise_ref
    from repro_torch.kernels.slstm.ref import slstm_ref
    from repro_torch.models import xlstm

    differ = {"tf32": 0, "tc": 0, "plain 256": 0}
    total = 0

    def mlstm(q, k, v, gates, state, model_chunk):
        nonlocal total
        plain = mlstm_chunkwise_ref(q, k, v, gates, state, 256)
        exact = _mlstm_f64(q, k, v, gates).to(q.dtype)
        g = gates.float().contiguous()
        for name, h in (("tf32", kernel.mlstm_tf32(q, k, v, g, state)[0]),
                        ("tc", kernel.mlstm_tc(q, k, v, g, state)[0]), ("plain 256", plain[0])):
            differ[name] += int((h != exact).sum())
        total += exact.numel()
        return plain

    with mock.patch.object(xlstm, "mlstm", mlstm), mock.patch.object(xlstm, "slstm", slstm_ref):
        model.prefill(params, {"tokens": rows}, rows.shape[1])
    return {name: n / total for name, n in differ.items()}


def compare_xlstm_paths(model, params, tokens, route: str) -> None:
    """The bf16 model's prefill, whose chunkwise mLSTM calls run the
    ``route`` kernel ("tc" or "tf32"), against plain and f32 references:

    * bf16, one prompt, all 4096 tokens: every mLSTM call of the kernel
      path's prefill (20 layers) holds h and the final (C, n, m) against
      the plain form on the call's own inputs, at the kernel phase's
      prefill-shape tolerances;
    * bf16, all 8 prompts cut to ``XLSTM_BF16_LEN`` tokens, against
      ``ref32`` (the same weights upcast to f32, f32 compute, the plain
      chunkwise form at chunk 256). D(P) = the mean over the prompts of
      1 - corr(P's last-position logits, ref32's). Hold 1: the path's
      logits are finite and D(path) <= ``XLSTM_D_MARGIN`` x the larger D
      of two plain bf16 orders (chunk 256 and 32): no farther from f32
      than correct bf16 orders. Hold 2: over the 20 mLSTM calls of that
      prefill, each on the plain path's inputs, the share of the path's
      bf16 h elements that differ from the f64 recurrence rounded to bf16
      is at most the plain form's (chunk 256). Both kernel paths (split
      TF32 and tensor cores) are measured under both holds; the one the model runs
      is held. Logged, not held: each path's count of prompts whose top-1
      equals ref32's, and prompt 0's comparison with plain 256 (top-1,
      correlation, max diff), the check of earlier versions;
    * f32 (the same seed's weights in f32, f32 compute), one prompt, all
      4096 tokens: top-1 equal and correlation > 0.99 against the plain
      path.

    All run; the phase fails after them if any did not hold."""
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_map

    row = tokens[:1]
    S = row.shape[1]
    failed = []
    held: dict = {}
    _xlstm_prefill(model, params, row, held=held)
    log(f"[xlstm] bf16 prefill (S={S}), each of {held['calls']} mLSTM calls against the plain "
        f"form on its own inputs, max abs err: " + ", ".join(
            f"{key} {held[key]:.3e} (atol={MLSTM_MAIN_TOLS[key]['atol']}, "
            f"rtol={MLSTM_MAIN_TOLS[key]['rtol']})"
            for key in "hCnm") + f"; failures: {held.get('failed', 'none')}")
    if held.get("failed") or held["calls"] != _n_mlstm(model.cfg):
        failed.append("an mLSTM call of the bf16 prefill disagrees with the plain form")

    short = tokens[:, :XLSTM_BF16_LEN]
    model32 = build_model(dataclasses.replace(model.cfg, dtype="float32"))
    ref32 = _xlstm_prefill(model32, tree_map(lambda t: t.float(), params), short, 256)
    # (at 32 tokens, chunks of 256 and of 32 are one chunk, and coincide; plain
    # 8 is logged beside them as a third order)
    logits = {"plain 256": _xlstm_prefill(model, params, short, 256),
              "plain 32": _xlstm_prefill(model, params, short, 32),
              "plain 8": _xlstm_prefill(model, params, short, 8),
              "tf32": _xlstm_prefill(model, params, short, route="tf32"),
              "tc": _xlstm_prefill(model, params, short, route="tc"),
              "model": _xlstm_prefill(model, params, short)}
    if not torch.equal(logits["model"], logits[route]):
        failed.append(f"the model's bf16 prefill is not the {route} kernel's path")
    dist = {name: _distance(x, ref32) for name, x in logits.items()}
    limit = XLSTM_D_MARGIN * max(dist["plain 256"], dist["plain 32"])
    share = _h_vs_f64(model, params, short)
    top = {name: sum(int(a.argmax()) == int(b.argmax()) for a, b in zip(x, ref32))
           for name, x in logits.items()}
    n = len(short)
    log(f"[xlstm] bf16 prefill of {n} prompts x {XLSTM_BF16_LEN} tokens against ref32 (f32 "
        f"weights and compute, plain chunk 256): D = mean(1 - corr) " + ", ".join(
            f"{name} {d:.6e}" for name, d in dist.items())
        + f"; hold 1 limit {XLSTM_D_MARGIN} x max(plain 256, plain 32) = {limit:.6e}; top-1 "
        f"equal to ref32's (of {n}, logged): " + ", ".join(f"{k} {v}" for k, v in top.items()))
    log(f"[xlstm] bf16 prefill ({n} x {XLSTM_BF16_LEN}), mLSTM h elements that differ from the "
        f"f64 recurrence rounded to bf16, over the {_n_mlstm(model.cfg)} calls: " + ", ".join(
            f"{name} {100 * v:.4f}%" for name, v in share.items()))
    for name in ("tf32", "tc"):
        hold1 = bool(torch.isfinite(logits[name]).all()) and dist[name] <= limit
        hold2 = share[name] <= share["plain 256"]
        top0, corr0, diff0 = _logit_agreement(logits[name][0], logits["plain 256"][0])
        path = name == route
        log(f"[xlstm] {name} path{' (the model runs it: held)' if path else ' (logged)'}: "
            f"hold 1 {'ok' if hold1 else 'FAIL'}, hold 2 {'ok' if hold2 else 'FAIL'}; prompt 0 "
            f"against plain 256 (logged): top-1 equal {top0}, correlation {corr0:.6f}, max abs "
            f"diff {diff0:.4f}")
        if path and not (hold1 and hold2):
            failed.append(f"bf16 prefill (S={XLSTM_BF16_LEN}): the {name} path fails hold " +
                          " and ".join(str(i + 1) for i, ok in enumerate((hold1, hold2)) if not ok))

    params32 = model32.init(torch.Generator(device="cuda").manual_seed(0), "cuda")
    top0, corr0, diff0 = _logit_agreement(_xlstm_prefill(model32, params32, row)[0],
                                          _xlstm_prefill(model32, params32, row, 256)[0])
    log(f"[xlstm] f32 prefill logits (S={S}), kernel vs plain chunk 256: top-1 equal {top0}, "
        f"correlation {corr0:.6f}, max abs diff {diff0:.4f}")
    if not (top0 and corr0 > 0.99):
        failed.append(f"f32 prefill logits (S={S}): kernel-path logits disagree with the plain "
                      f"path")
    if failed:
        raise AssertionError("; ".join(failed))


def _block_divergence(model, params, row, chunks) -> str:
    """Two plain orders (the chunkwise form at ``chunks[0]`` vs
    ``chunks[1]``) of one bf16 prefill, block by block: the relative
    difference ||a - b|| / ||b|| of each block's input and of its output,
    in the order the blocks run."""
    from unittest import mock

    from repro_torch.models import xlstm

    runs = {}
    for chunk in chunks:
        seen = runs[chunk] = []

        def wrap(block, kind):
            def run(params, x, *args, **kw):
                out = block(params, x, *args, **kw)
                seen.append((kind, x.float(), out[0].float()))
                return out
            return run

        with mock.patch.object(xlstm, "mlstm_block", wrap(xlstm.mlstm_block, "m")), \
                mock.patch.object(xlstm, "slstm_block", wrap(xlstm.slstm_block, "s")):
            _xlstm_prefill(model, params, row, chunk)
    rel = lambda a, b: float((a - b).norm() / b.norm())
    return " ".join(f"{kind}{i}:{rel(xa, xb):.1e}->{rel(ya, yb):.1e}"
                    for i, ((kind, xa, ya), (_, xb, yb)) in enumerate(zip(*runs.values())))


def xlstm_orders() -> None:
    """bf16 full-width xlstm-350m prefill logits of single prompts at
    growing lengths, each against the plain path (the chunkwise form at
    chunk 256): the tensor-core and the split-TF32 kernel paths, the plain path in
    two other orders of the same sums (chunk 32, chunk 8), and up to 64
    tokens the plain path with each mLSTM output moved by a random relative
    1e-7 (f32's rounding size) before its bf16 rounding. Shows how far
    bf16 logits are comparable end to end, and, for one prompt, how two
    plain orders drift apart block by block."""
    from repro_torch.config import get_arch
    from repro_torch.models import build_model

    cfg = get_arch("xlstm-350m")
    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0), "cuda", torch.bfloat16)
    prompts = np.random.RandomState(0).randint(0, cfg.vocab_size, (XLSTM_BATCH, XLSTM_PROMPT))
    for r in range(4):
        for S in (8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096):
            row = torch.as_tensor(prompts[r:r + 1, :S].astype(np.int32), device="cuda")
            plain = _xlstm_prefill(model, params, row, 256)[0]
            others = {"tensor cores": _xlstm_prefill(model, params, row, route="tc")[0],
                      "split-TF32 kernel": _xlstm_prefill(model, params, row,
                                                          route="tf32")[0],
                      "plain 32": _xlstm_prefill(model, params, row, 32)[0],
                      "plain 8": _xlstm_prefill(model, params, row, 8)[0]}
            if S <= 64:     # plain 256 with h moved by f32's own rounding size
                others["plain 256, h x (1 + 1e-7 n)"] = _xlstm_prefill(
                    model, params, row, 256, perturb=1e-7)[0]
            log(f"[xlstm-orders] prompt {r} S={S}, against plain 256 (top-1 equal, "
                f"correlation): " + "; ".join(
                    "{} {} {:.6f}".format(name, *_logit_agreement(x, plain)[:2])
                    for name, x in others.items()))
    for S, chunks in ((32, (256, 8)), (128, (256, 32))):
        row = torch.as_tensor(prompts[:1, :S].astype(np.int32), device="cuda")
        log(f"[xlstm-orders] prompt 0 S={S}, plain {chunks[0]} vs plain {chunks[1]}, each "
            f"block's input -> output relative difference (m: mLSTM, s: sLSTM): "
            f"{_block_divergence(model, params, row, chunks)}")


# ---------------------------------------------------------------------------
# phase 7: full-width training
# ---------------------------------------------------------------------------

def _recording(step_fn, out: list):
    """``step_fn`` that also keeps each step's metrics as floats."""
    def step(state, batch):
        state, metrics = step_fn(state, batch)
        out.append({k: float(v) for k, v in metrics.items()})
        return state, metrics
    return step


def _probe(state) -> list:
    """Small slices of four leaves (and of a bias, where the model has
    one), to see whether an update moved them."""
    p = state.params
    attn = p["blocks"]["attn"]
    head = p["lm_head"][:8, :4] if "lm_head" in p else p["embed"][-4:, :8]   # tied: embed.T
    mamba = p["blocks"].get("mamba")
    return [t.detach().clone() for t in (p["embed"][:4, :8], head,
                                         attn["wq"][0, :8, :4], p["blocks"]["mlp"]["wo"][-1, :8, :4],
                                         *([attn["bq"][-1, :8]] if "bq" in attn else []),
                                         *([mamba["A_log"][-1, :8], mamba["D"][0, :8]]
                                           if mamba is not None else []))]


def train_full_width(arch: str = "qwen3-4b", tag: str = "train", layers: int = 0) -> dict:
    """``arch`` at full width and depth (or ``layers`` of its layers), f32
    params + AdamW, seq 4096, global batch 2 in 2 microbatches, through
    ``run_segment`` for 4 steps (the attention biases drawn nonzero where
    the model has them, and their gradients held nonzero through AdamW's
    first moment)."""
    from repro_torch.config import ShardingLayout, TrainConfig, get_arch
    from repro_torch.data import SyntheticLM
    from repro_torch.models import build_model
    from repro_torch.train.loop import make_step, run_segment
    from repro_torch.train.steps import init_train_state

    full = get_arch(arch)
    cfg = dataclasses.replace(full, num_layers=layers) if layers else full
    model = build_model(cfg)
    seq, batch, n_steps = 4096, 2, 4
    tc = TrainConfig(total_steps=n_steps, warmup_steps=1, microbatches=2)
    layout = ShardingLayout(attn_impl="flash")
    ds = SyntheticLM(cfg.vocab_size, seq, batch, seed=0)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    state = init_train_state(model, gen, "cuda")
    draw_biases(state.params, gen)
    torch.cuda.synchronize()
    depth = f"{cfg.num_layers} of {full.num_layers} layers (depth cut, width full)" if layers \
        else f"{cfg.num_layers} layers (no depth cut)"
    log(f"[{tag}] {cfg.name}: {depth}, d_model {cfg.d_model}, d_ff {cfg.d_ff}, "
        f"{model.param_count() / 1e9:.3f} B f32 params; params + AdamW moments "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB, made on the card in "
        f"{time.perf_counter() - t0:.1f} s; seq {seq}, global batch {batch} in "
        f"{tc.microbatches} microbatches, remat {layout.remat}, fused CE chunk {layout.ce_chunk}")

    metrics: list = []
    step_fn = _recording(make_step(model, tc, layout), metrics)
    before = _probe(state)
    reset_launches()
    res0 = run_segment(model, state, ds, "cuda", tc, layout, num_steps=1, jitted=step_fn)
    if not all(torch.equal(a, b) for a, b in zip(before, _probe(res0.state))):
        raise AssertionError("params moved at step 0, where the learning rate is 0")
    res1 = run_segment(model, res0.state, ds, "cuda", tc, layout, num_steps=n_steps - 1,
                       start_step=1, jitted=step_fn)
    launches = read_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    moved = [float((a - b).abs().max()) for a, b in zip(before, _probe(res1.state))]

    per_mb = cfg.num_layers * tc.microbatches * n_steps
    # a hybrid block's scan: forward and recompute keeping its states, then
    # its backward, as the flash kernels
    scan = dict(ssm_scan=2 * per_mb, ssm_scan_bwd=per_mb) if "mamba" in state.params["blocks"] \
        else {}
    want = expect_launches(flash_attention_tc=2 * per_mb, flash_attention_bwd_dkdv_tc=per_mb,
                           flash_attention_bwd_dq_tc=per_mb, **scan)
    secs = res0.step_seconds + res1.step_seconds
    for i, (m, dt) in enumerate(zip(metrics, secs)):
        log(f"[{tag}] step {i}: loss {m['loss']:.6f}, grad_norm {m['grad_norm']:.6f}, "
            f"lr {m['lr']:.3e}, {dt * 1e3:.1f} ms, {batch * seq / dt:.1f} tokens/s")
    log(f"[{tag}] peak memory {peak_gb:.2f} GB; largest change of the probed params after "
        f"step 1: {max(moved):.3e}; launches {launches}, expected {want}")
    if len(metrics) != n_steps or not all(
            np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"]) for m in metrics):
        raise AssertionError(f"non-finite or missing training metrics: {metrics}")
    if not min(moved) > 0:
        raise AssertionError("a probed param did not move after step 1")
    if launches != want:
        raise AssertionError("the training path did not go through the kernels as expected")
    m_attn = res1.state.opt.m["blocks"]["attn"]
    if "bq" in m_attn:
        # AdamW's first moment is (1 - b1) x the gradient's running mean: a
        # bias whose gradient never reached it would keep it at 0 (its
        # weight decay moves the param, not the moment)
        first = {k: float(m_attn[k].abs().max()) for k in ("bq", "bk", "bv")}
        log(f"[{tag}] largest |AdamW first moment| of the biases after {n_steps} steps: {first}")
        if not min(first.values()) > 0:
            raise AssertionError("a bias got no gradient")
    profile_training(model, step_fn, res1.state, ds)
    return launches


def profile_training(model, step_fn, state, ds, label: str = "seq 4096", batch=None) -> None:
    """Where the time goes: one more full-width step under torch.profiler,
    on ``batch`` or else the dataset's next batch."""
    from torch.profiler import ProfilerActivity, profile

    if batch is None:
        batch = {k: torch.from_numpy(v).to("cuda") for k, v in ds.batch(state.step).items()}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step_fn(state, batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    log(f"[profile] one training step, {label}, 2 microbatches:\n"
        f"{_device_breakdown(prof, wall, top=12)}")


def _copy_state(state, device):
    from repro_torch.models.common import tree_map
    from repro_torch.optim import OptState
    from repro_torch.train.steps import TrainState

    to = lambda tree: tree_map(lambda t: t.to(device, copy=True), tree)
    return TrainState(to(state.params), OptState(to(state.opt.m), to(state.opt.v),
                                                 state.opt.count), state.step)


def train_reduced_matches_cpu(arch: str = "qwen3-4b", tag: str = "train",
                              n_steps: int = 5, attn_impl: str = "flash",
                              remat: str = "full") -> dict:
    """A reduced f32 model: ``n_steps`` training steps on the card (the f32
    variants of the flash kernels; with ``attn_impl="triangular"`` the
    plain causal chunk schedule, no kernel) against the plain CPU trainer,
    from the same state and data (a MoE model's aux loss too; attention
    biases drawn nonzero), both under ``remat``. Returns the card run's
    launches."""
    from repro_torch.config import ShardingLayout, TrainConfig, get_arch
    from repro_torch.data import SyntheticLM
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_leaves
    from repro_torch.train.loop import make_step, run_segment
    from repro_torch.train.steps import init_train_state

    cfg = reduced_f32(get_arch(arch))
    model = build_model(cfg)
    tc = TrainConfig(total_steps=10, warmup_steps=2, microbatches=2)
    layout = ShardingLayout(attn_impl=attn_impl, q_chunk=32, kv_chunk=32, remat=remat)
    ds = SyntheticLM(cfg.vocab_size, 100, 4, seed=0)   # 100: ragged against 64-row tiles
    gen = torch.Generator().manual_seed(0)
    state_cpu = init_train_state(model, gen, "cpu")
    draw_biases(state_cpu.params, gen)
    runs = {}
    for device, state in (("cuda", _copy_state(state_cpu, "cuda")), ("cpu", state_cpu)):
        metrics: list = []
        step_fn = _recording(make_step(model, tc, layout), metrics)
        reset_launches()
        res = run_segment(model, state, ds, device, tc, layout, num_steps=n_steps,
                          jitted=step_fn)
        runs[device] = (metrics, res.state)
        if device == "cuda":
            launches = read_launches()
    (m_gpu, s_gpu), (m_cpu, s_cpu) = runs["cuda"], runs["cpu"]
    for key in ("loss", "grad_norm") + (("aux_loss",) if cfg.moe is not None else ()):
        a = np.array([m[key] for m in m_gpu])
        b = np.array([m[key] for m in m_cpu])
        log(f"[{tag}] reduced f32 {key}, card {a.tolist()} vs CPU {b.tolist()}; "
            f"largest relative difference {float(np.max(np.abs(a - b) / np.abs(b))):.3e}")
        if not np.allclose(a, b, rtol=1e-4, atol=0):
            raise AssertionError(f"reduced training {key} on the card differs from the CPU's")
    err = max(float((a.cpu() - b).abs().max())
              for a, b in zip(tree_leaves(s_gpu.params), tree_leaves(s_cpu.params)))
    log(f"[{tag}] reduced f32 params after {n_steps} steps, card vs CPU: max abs diff {err:.3e} "
        f"(atol 1e-5)")
    if not err <= 1e-5:
        raise AssertionError("reduced training params on the card differ from the CPU's")
    if attn_impl == "triangular":
        log(f"[{tag}] reduced f32 launches {launches} (triangular: plain attention)")
        if launches != expect_launches():
            raise AssertionError("the triangular schedule launched a kernel")
        return launches
    if cfg.block.value == "mlstm":
        return hold_f32_launches(tag, launches, "mlstm_tf32", "mlstm_bwd", "slstm", "slstm_bwd")
    scan = ("ssm_scan", "ssm_scan_bwd") if cfg.ssm is not None else ()
    return hold_f32_launches(tag, launches, "flash_attention_tf32",
                             "flash_attention_bwd_dkdv_tf32", "flash_attention_bwd_dq_tf32", *scan)


# ---------------------------------------------------------------------------
# phase 8: the spot provisioner
# ---------------------------------------------------------------------------

# the split scenario of benchmarks/orchestrator_bench.py:130-150: three
# 8-device markets with 40 GB a device (A, B calm in history, C mildly
# revoking) and a 1-device market that never fits; B revokes at future hour 2
SPLIT_MARKETS = [
    ("big8.a", "us-east-1", "us-east-1a", 40, 1.2, 8, 60.0),
    ("big8.b", "eu-west-1", "eu-west-1a", 40, 1.2, 8, 60.0),
    ("big8.c", "ap-southeast-1", "ap-southeast-1a", 40, 1.2, 8, 60.0),
    ("small1", "us-east-1", "us-east-1b", 64, 0.4, 1, 10.0),
]
# 12 steps in segments of 3 at one step a trace hour (the 1-device
# reference rate): B's revocation cuts the segment that starts at step 9
# after 2 of its steps (the CPU port's run of this scenario says so)
SPOT_STEPS, SPOT_SEGMENT = 12, 3
# the reduced three-mode run: tests/test_orchestrator.py's config
SPOT_REDUCED = dict(steps=30, segment_steps=10, ckpt_every=5, ft_revocations=2)
# the deterministic report columns the card must reproduce (==)
SPOT_COLUMNS = ("total_steps", "useful_steps", "wasted_steps", "revocations", "markets_used",
                "allocations_used", "leg_repairs", "leg_costs", "cost_dollars",
                "reshard_bytes", "restore_bytes", "reshard_events", "mesh_shapes",
                "cost_to_complete")


def _split_markets():
    from repro_torch.core.market import Market, MarketSet

    markets = [Market(i, *m[:5], device_count=m[5], interconnect_gbps=m[6])
               for i, m in enumerate(SPLIT_MARKETS)]
    hp = np.full((4, 90), 0.35)
    hp[2, ::45] = 1.5
    hp[3, ::5] = 0.6
    fp = np.full((4, 24), 0.35)
    fp[1, 2:4] = 1.5
    return MarketSet(markets, hp), MarketSet(markets, fp, start_hour=90)


def _indexed(step_fn, out: list):
    """``step_fn`` that also keeps (the state's step index, its metrics as
    floats, its seconds to the loss on the host) for every executed step."""
    def step(state, batch):
        i, t0 = state.step, time.perf_counter()
        state, metrics = step_fn(state, batch)
        m = {k: float(v) for k, v in metrics.items()}
        out.append((i, m, time.perf_counter() - t0))
        return state, metrics
    return step


def spot_full_width() -> dict:
    """Full-width qwen3-4b through ``SpotTrainingOrchestrator`` in siwoft
    mode on the split scenario, a pool of 8 slots on cuda:0."""
    from repro_torch.config import ShardingLayout, TrainConfig, get_arch
    from repro_torch.core import orchestrator as orch
    from repro_torch.data import SyntheticLM
    from repro_torch.dist import ElasticMeshManager, train_state_bytes
    from repro_torch.models import build_model

    cfg = get_arch("qwen3-4b")
    model = build_model(cfg)
    seq, batch = 4096, 2
    tc = TrainConfig(total_steps=SPOT_STEPS, warmup_steps=1, microbatches=2)
    layout = ShardingLayout(attn_impl="flash")
    pool = ElasticMeshManager([torch.device("cuda", 0)] * 8)
    log(f"[spot] {cfg.name} at full width and depth, f32 params + AdamW, seq {seq}, global "
        f"batch {batch} in {tc.microbatches} microbatches; siwoft on the split scenario "
        f"(job_memory_gb 400, one step a trace hour, B revokes at future hour 2), "
        f"{SPOT_STEPS} steps in segments of {SPOT_SEGMENT}, a pool of 8 slots on cuda:0; "
        f"train_state_bytes {train_state_bytes(model)}")
    steps: list = []
    make_step = orch.make_step
    orch.make_step = lambda *a, **kw: _indexed(make_step(*a, **kw), steps)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    try:
        rep = orch.SpotTrainingOrchestrator(
            model, SyntheticLM(cfg.vocab_size, seq, batch, seed=0), "cuda", *_split_markets(),
            mode="siwoft", tc=tc, layout=layout, segment_steps=SPOT_SEGMENT,
            steps_per_trace_hour=1, seed=0, mesh_manager=pool, job_memory_gb=400.0,
        ).run(SPOT_STEPS)
    finally:
        orch.make_step = make_step
    wall = time.perf_counter() - t0
    launches = read_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    executed = rep.useful_steps + rep.wasted_steps
    per_step = cfg.num_layers * tc.microbatches
    want = expect_launches(flash_attention_tc=2 * per_step * executed,
                           flash_attention_bwd_dkdv_tc=per_step * executed,
                           flash_attention_bwd_dq_tc=per_step * executed)
    for i, m, dt in steps:
        log(f"[spot] step {i}: loss {m['loss']:.9g}, grad_norm {m['grad_norm']:.6f}, "
            f"{dt * 1e3:.1f} ms")
    firsts, repeats = {}, []
    for i, m, _ in steps:
        if i in firsts:
            repeats.append((i, firsts[i], m["loss"]))
        else:
            firsts[i] = m["loss"]
    ms = [dt * 1e3 for i, _, dt in steps if i > 0]
    decisions = rep.decision_seconds
    log(f"[spot] report: useful {rep.useful_steps}, wasted {rep.wasted_steps}, revocations "
        f"{rep.revocations}, leg repairs {rep.leg_repairs}, allocations "
        f"{rep.allocations_used}, reshard_bytes {rep.reshard_bytes}, cost "
        f"{rep.cost_dollars!r}, leg costs {rep.leg_costs}, mesh shapes {rep.mesh_shapes}")
    for snap in rep.snapshots:
        back = snap["restore_seconds"]
        log(f"[spot] segment-start snapshot at step {snap['step']}: "
            f"{snap['bytes'] / 1e9:.3f} GB to host memory in {snap['seconds']:.2f} s, "
            + (f"written back in {back:.2f} s" if back is not None else "not written back"))
    log(f"[spot] {executed} steps executed in {wall:.1f} s of run; ms a step (after step "
        f"0) {min(ms):.1f}-{max(ms):.1f}, mean {sum(ms) / len(ms):.1f}; host seconds a "
        f"provisioning decision: {len(decisions)} decisions, mean "
        f"{sum(decisions) / len(decisions):.4f}, max {max(decisions):.4f}; peak device "
        f"memory {peak_gb:.2f} GB; launches {launches}, expected {want}")
    log(f"[spot] re-executed steps, loss of the first attempt vs the second: "
        + ", ".join(f"step {i}: {a!r} vs {b!r}" for i, a, b in repeats))
    if rep.useful_steps != SPOT_STEPS or executed != len(steps):
        raise AssertionError(f"spot run: {rep.useful_steps} useful of {SPOT_STEPS}, "
                             f"{executed} executed, {len(steps)} recorded")
    if not (rep.revocations >= 1 and rep.leg_repairs >= 1 and rep.snapshots):
        raise AssertionError("spot run: no mid-segment revocation with a leg repair")
    if not 0 < rep.reshard_bytes < train_state_bytes(model):
        raise AssertionError(f"spot run: reshard_bytes {rep.reshard_bytes} not in "
                             f"(0, {train_state_bytes(model)})")
    if not abs(sum(rep.leg_costs.values()) - rep.cost_dollars) <= 1e-6:
        raise AssertionError("spot run: the leg costs do not sum to the bill")
    if not all(np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"]) for _, m, _ in steps):
        raise AssertionError("spot run: non-finite training metrics")
    if launches != want:
        raise AssertionError("the spot path did not go through the kernels as expected")
    if not repeats or any(a != b for _, a, b in repeats):
        raise AssertionError("re-executed steps did not reproduce the first attempt's losses")
    if not peak_gb < 80:
        raise AssertionError(f"peak device memory {peak_gb:.2f} GB")
    return launches


def spot_reduced_matches_cpu() -> dict:
    """Reduced f32 qwen3-4b through the orchestrator in all three modes, on
    the card and on the CPU from the same initial state: the deterministic
    report columns equal, losses at rtol 1e-4. Returns the card's launches."""
    import tempfile

    from repro_torch.config import ShardingLayout, TrainConfig, get_arch
    from repro_torch.core import generate_markets, split_history_future
    from repro_torch.core.orchestrator import SpotTrainingOrchestrator
    from repro_torch.data import SyntheticLM
    from repro_torch.models import build_model
    from repro_torch.train.steps import init_train_state

    cfg = dataclasses.replace(get_arch("qwen3-4b").reduced(), dtype="float32")
    model = build_model(cfg)
    ms = split_history_future(generate_markets(seed=3, n_hours=24 * 120), 24 * 90)
    state_cpu = init_train_state(model, torch.Generator().manual_seed(0), "cpu")
    r = SPOT_REDUCED
    launches = dict.fromkeys(read_launches(), 0)
    for mode in ("siwoft", "checkpoint", "hybrid"):
        reports = {}
        for device in ("cuda", "cpu"):
            if device == "cuda":
                reset_launches()
            with tempfile.TemporaryDirectory() as d:
                o = SpotTrainingOrchestrator(
                    model, SyntheticLM(cfg.vocab_size, 32, 4, seed=0), device, *ms, mode=mode,
                    tc=TrainConfig(total_steps=2 * r["steps"], warmup_steps=5),
                    layout=ShardingLayout(attn_impl="flash"),
                    segment_steps=r["segment_steps"], steps_per_trace_hour=200, ckpt_dir=d,
                    ckpt_every=r["ckpt_every"], ft_revocations=r["ft_revocations"], seed=0,
                    init_state=lambda: _copy_state(state_cpu, device),
                )
                reports[device] = o.run(r["steps"])
                if o.ckpt is not None:
                    o.ckpt.close()
            if device == "cuda":
                launches = {k: launches[k] + v for k, v in read_launches().items()}
        gpu, cpu = reports["cuda"], reports["cpu"]
        a, b = np.array(gpu.losses), np.array(cpu.losses)
        same = {k: getattr(gpu, k) == getattr(cpu, k) for k in SPOT_COLUMNS}
        log(f"[spot] reduced f32 {mode}: useful {gpu.useful_steps}, wasted {gpu.wasted_steps}, "
            f"revocations {gpu.revocations}, restore_bytes {gpu.restore_bytes}, cost "
            f"{gpu.cost_dollars!r}; columns equal to the CPU's: {all(same.values())}; "
            f"losses, largest relative difference "
            f"{float(np.max(np.abs(a - b) / np.abs(b))) if len(a) == len(b) else 'n/a'}")
        if not all(same.values()):
            raise AssertionError(f"reduced {mode} on the card: columns differ from the CPU's: "
                                 f"{[k for k, v in same.items() if not v]}")
        if not np.allclose(a, b, rtol=1e-4, atol=0):
            raise AssertionError(f"reduced {mode} on the card: losses differ from the CPU's")
    return hold_f32_launches("spot", launches, "flash_attention_tf32",
                             "flash_attention_bwd_dkdv_tf32", "flash_attention_bwd_dq_tf32")


def spot_launcher() -> dict:
    """``python -m repro_torch.launch.train --spot-mode M --trace PATH`` for
    each mode, reduced, on the card; each trace parses with ``read_jsonl``
    into a run that opens with RunStart and pins its breakdown."""
    import tempfile

    from repro_torch.launch import train
    from repro_torch.obs import events, read_jsonl

    reset_launches()
    with tempfile.TemporaryDirectory() as d:
        for mode in ("siwoft", "checkpoint", "hybrid"):
            path = Path(d) / f"{mode}.jsonl"
            summary = train.main(["--spot-mode", mode, "--steps", "10", "--device", "cuda",
                                  "--trace", str(path)])
            trace = read_jsonl(path)
            kinds = [events.wire_name(type(e)) for e in trace]
            log(f"[spot] launcher --spot-mode {mode}: {summary}; trace {len(trace)} events "
                f"{sorted(set(kinds))}")
            if not (kinds and kinds[0] == "run_start" and "breakdown_pin" in kinds
                    and summary["useful"] >= 10 and np.isfinite(summary["loss_last"])):
                raise AssertionError(f"launcher --spot-mode {mode}: bad run or trace")
    return read_launches()


# ---------------------------------------------------------------------------
# phase 9: spot serving
# ---------------------------------------------------------------------------

# qwen3-4b at full width: 8 prompts x 2000 tokens, 32 new tokens, revoked
# after 16 decode steps; a pool of 8 slots on cuda:0 (plans 8 -> 4)
SERVE_B, SERVE_S, SERVE_NEW, SERVE_REVOKE = 8, 2000, 32, 16
# the five runs: (counts, revoke_after, cache_policy, engine)
SERVE_RUNS = {
    "dense": ([8], 0, "drop", False),
    "dense_drop": ([8, 4], SERVE_REVOKE, "drop", False),
    "dense_migrate": ([8, 4], SERVE_REVOKE, "migrate", False),
    "engine": ([8], 0, "drop", True),
    "engine_revoked": ([8, 4], SERVE_REVOKE, "drop", True),
}
# the reduced f32 runs, card against CPU: tests/test_torch_serve_plan.py's sizes
SERVE_F32 = dict(batch=4, prompt_len=16, new_tokens=8, revoke_after=3)
# PLAN_JSON columns that are timings (every other column must be equal)
PLAN_TIMINGS = ("measured_steps_per_sec", "engine_tokens_per_sec",
                "engine_tokens_per_sec_before", "recover_seconds", "prefill_seconds",
                "decode_seconds")
# the engine rule after the revocation: a row may first diverge only where
# the uninterrupted run's top-2 logit gap is at most 2 bf16 ulps of the top
# logit (|top| x 2^-7 each) and the two runs' logits correlate above 0.99
ENGINE_GAP_ULPS, ENGINE_MIN_CORR = 2, 0.99
# benchmarks/serve_bench.py's CSV columns (report_row)
FLEET_CSV = ("scenario,policy,cost_usd,slo_violation_s,served_mtok,shed_tok,queued_tok_h,"
             "revocations,repairs,migrated_bytes,restored_bytes,replicas,p50_delay_s,"
             "p99_delay_s,scale_ups,scale_downs,idle_headroom_mtok")


def serve_plan_predicted(model, counts=(8, 4), slots: int = 8) -> dict:
    """The byte columns the revoked full-width runs must report, from the
    specs alone on the CPU (before any run): params moved between the plans
    of ``counts`` (on a pool of ``slots``, which caps them as a world of as
    many ranks does) with weight matrices in bf16 (the tree the card
    serves), the bf16 dense cache at batch 8 x (2000 + 32), the moved
    cache's gather to the new plan's rows (phase 21), and the training
    path's state."""
    from repro_torch.dist import (ElasticMeshManager, cache_shardings, param_shardings,
                                  reshard_bytes, rows_shardings, train_state_bytes)
    from repro_torch.launch.serve import PLAN_LAYOUT as layout
    from repro_torch.models.common import tree_map

    man = ElasticMeshManager([torch.device("cpu")] * slots)
    old, new = man.plan_for(counts[0]).mesh, man.plan_for(counts[1]).mesh
    served = tree_map(lambda s: dataclasses.replace(s, dtype="bfloat16") if s.is_matrix else s,
                      model.specs)
    c_specs = model.cache_specs(SERVE_B, SERVE_S + SERVE_NEW)
    c_new = cache_shardings(c_specs, new, layout)
    return {"params_bytes": reshard_bytes(served, param_shardings(model.specs, old, layout),
                                          param_shardings(model.specs, new, layout)),
            "cache_bytes": reshard_bytes(c_specs, cache_shardings(c_specs, old, layout), c_new),
            "cache_gather_bytes": reshard_bytes(c_specs, c_new, rows_shardings(c_specs, new)),
            "train_path_bytes": train_state_bytes(model)}


# whisper-tiny under the launcher's dense plans (whisper_plan): phase 13's
# 16 prompts x 64 tokens with their 1500 stub frames, 128 new tokens, plans
# 8 -> 4 slots revoked after 32 decode steps, under drop and migrate
WHISPER_PLAN = dict(B=16, S=64, new=128, revoke=32)


def whisper_plan_predicted(model) -> dict:
    """The byte columns the revoked full-width whisper runs must report, from
    the specs alone on the CPU (before any run): the f32 params (the plan
    modes hold them in ``param_dtype``, as the reference's do) moved 8 -> 4
    slots, the bf16 dense cache at 16 x (64 + 128) positions with the
    encoder's ``memory`` (16 x 1500 x 384), and the training path's state;
    ``memory_bytes`` is the memory's share of ``cache_bytes``, ``memory_size``
    the whole leaf."""
    from repro_torch.dist import (ElasticMeshManager, cache_shardings, param_shardings,
                                  reshard_bytes, train_state_bytes)
    from repro_torch.launch.serve import PLAN_LAYOUT as layout
    from repro_torch.models.common import param_bytes

    man = ElasticMeshManager([torch.device("cpu")] * 8)
    old, new = man.plan_for(8).mesh, man.plan_for(4).mesh
    w = WHISPER_PLAN
    c_specs = model.cache_specs(w["B"], w["S"] + w["new"])
    c_old, c_new = cache_shardings(c_specs, old, layout), cache_shardings(c_specs, new, layout)
    mem = lambda tree: {"memory": tree["memory"]}
    return {"params_bytes": reshard_bytes(model.specs, param_shardings(model.specs, old, layout),
                                          param_shardings(model.specs, new, layout)),
            "cache_bytes": reshard_bytes(c_specs, c_old, c_new),
            "train_path_bytes": train_state_bytes(model),
            "memory_bytes": reshard_bytes(mem(c_specs), mem(c_old), mem(c_new)),
            "memory_size": param_bytes(mem(c_specs))}


class _DecodeLogits:
    """Keep, on the card, the last-position logits of every paged decode
    call of the engines built inside the block (a copy: 8 x vocab f32 a
    step), by wrapping the engine module's step builder; and, just before
    the decode call numbered ``capture_at`` (counted over every engine of
    the block: the replacement's first call after a revocation at that
    step), each lane's ``seq_lens`` and the K/V rows its pages hold at
    positions 0 .. ``rows`` - 1, as ``kv`` = (seq_lens, k, v), k and v
    (layers, lanes, positions, KVH, hd)."""

    def __init__(self, capture_at=None, rows=0):
        self.logits: list = []
        self.capture_at, self.rows = capture_at, rows
        self.kv = None

    def __enter__(self):
        from repro_torch.serve import engine

        self._build = build = engine.build_paged_decode_step

        def wrapped(model, layout):
            step = build(model, layout)

            def keep(params, cache, tokens, seq_lens, table):
                if len(self.logits) == self.capture_at:
                    self.kv = _lane_rows(cache, seq_lens, table, self.rows)
                logits, cache = step(params, cache, tokens, seq_lens, table)
                self.logits.append(logits[:, -1].float().clone())
                return logits, cache
            return keep

        engine.build_paged_decode_step = wrapped
        return self

    def __exit__(self, *exc):
        from repro_torch.serve import engine

        engine.build_paged_decode_step = self._build


def _lane_rows(cache, seq_lens, table, T: int) -> tuple:
    """(seq_lens on the host, k, v): each lane's K/V rows at positions
    0 .. T - 1 of every layer, gathered through its block table."""
    lens = seq_lens.cpu()
    out = []
    for key in ("k_pages", "v_pages"):
        pool = cache["blocks"][key]                           # (L, P, ps, KVH, hd)
        ps = pool.shape[2]
        rows = []
        for b in range(len(lens)):
            pages = table[b, :-(-T // ps)].long()
            lane = pool[:, pages]                             # (L, n, ps, KVH, hd)
            rows.append(lane.reshape(lane.shape[0], -1, *lane.shape[3:])[:, :T])
        out.append(torch.stack(rows, dim=1).clone())
    return (lens, *out)


def hold_resumed_pages(ref_kv: tuple, got_kv: tuple, prompt_len: int) -> dict:
    """After the revocation, the replacement engine's lanes against the
    uninterrupted engine's at the same decode call: ``seq_lens`` equal and
    equal to the prompt plus every committed token but the newest (which
    rides this call), P + SERVE_REVOKE; and every K/V row (layer, lane,
    position) below P + SERVE_REVOKE correlating with the uninterrupted row
    above ENGINE_MIN_CORR, phase 9's flash-vs-incremental rule (the
    replacement wrote them by a flash prefill, the uninterrupted engine by
    its prefill and incremental decode). A resume one token short fails
    both: its ``seq_lens`` is one less and its last row is empty. Both are
    evaluated before either raises."""
    (ref_lens, rk, rv), (got_lens, gk, gv) = ref_kv, got_kv
    want = prompt_len + SERVE_REVOKE
    lens_ok = torch.equal(ref_lens, got_lens) and bool((got_lens == want).all())
    log(f"[serve-plan] engine resume: seq_lens {got_lens.tolist()} (uninterrupted "
        f"{ref_lens.tolist()}, want prompt + committed - 1 = {want}): "
        f"{'equal' if lens_ok else 'DIFFERENT'}")
    worst, where, max_diff = 1.0, None, 0.0
    for name, a_all, b_all in (("k", rk, gk), ("v", rv, gv)):
        if a_all.shape != b_all.shape:
            raise AssertionError(f"engine resume: {name} rows {tuple(b_all.shape)} against "
                                 f"{tuple(a_all.shape)}")
        for layer in range(a_all.shape[0]):
            a = a_all[layer].float().flatten(2)               # (lanes, positions, KVH*hd)
            b = b_all[layer].float().flatten(2)
            max_diff = max(max_diff, float((a - b).abs().max()))
            a, b = a - a.mean(-1, keepdim=True), b - b.mean(-1, keepdim=True)
            corr = (a * b).sum(-1) / (a.norm(dim=-1) * b.norm(dim=-1))
            corr = torch.nan_to_num(corr, nan=-1.0)
            low = float(corr.min())
            if low < worst:
                lane, pos = divmod(int(corr.argmin()), corr.shape[1])
                worst, where = low, (name, layer, lane, pos)
    ok = worst > ENGINE_MIN_CORR
    log(f"[serve-plan] engine resume: K/V rows of {rk.shape[0]} layers x {rk.shape[1]} lanes x "
        f"{rk.shape[2]} positions against the uninterrupted engine's: lowest row correlation "
        f"{worst:.6f} at (tensor, layer, lane, position) {where}, largest abs difference "
        f"{max_diff:.4f}; {'ok' if ok else 'FAIL'} (> {ENGINE_MIN_CORR})")
    if not lens_ok:
        raise AssertionError("engine resume: the lanes' seq_lens differ from the uninterrupted "
                             "engine's")
    if not ok:
        raise AssertionError(f"engine resume: the K/V row at {where} differs from the "
                             f"uninterrupted engine's (correlation {worst:.6f})")
    return {"seq_lens": got_lens.tolist(), "lowest_corr": worst, "max_abs_diff": max_diff}


def _serve_plan_run(model, params, prompts, name, tracker=None, capture=False) -> tuple:
    """One of SERVE_RUNS at full width: (PLAN_JSON object, launches, peak
    GB, decode logits of an engine run, with ``capture`` the lanes' rows
    before decode call SERVE_REVOKE)."""
    from repro_torch.launch.serve import serve_plan

    counts, revoke, policy, engine = SERVE_RUNS[name]
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    keep = _DecodeLogits(SERVE_REVOKE if capture else None, prompts.shape[1] + SERVE_REVOKE)
    reset_launches()
    with keep:
        out = serve_plan(model, params, prompts, SERVE_NEW, counts, revoke_after=revoke,
                         cache_policy=policy, engine=engine, device="cuda", tracker=tracker)
    launches = read_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    steps = max(out["decode_steps"], 1)
    log(f"[serve-plan] {name}: plans {counts}, prefill {out['prefill_seconds']:.3f} s, decode "
        f"{1e3 * out['decode_seconds'] / steps:.2f} ms a step ({out['decode_steps']} steps), "
        f"steps/s by plan {out['measured_steps_per_sec']}, "
        + (f"engine tokens/s {out['engine_tokens_per_sec']} (before the revocation "
           f"{out['engine_tokens_per_sec_before']}), " if engine else "")
        + f"time to recover {out['recover_seconds']} s, params_bytes {out['params_bytes']}, "
        f"cache_bytes {out['cache_bytes']}, train_path_bytes {out['train_path_bytes']}, "
        f"migrated_at {out['migrated_at']}, peak device memory {peak_gb:.2f} GB")
    return out, launches, peak_gb, keep


def _hold_serve_launches(name, out, launches, layers) -> None:
    if SERVE_RUNS[name][3]:
        want = expect_launches(flash_attention_tc=layers * out["prefills"],
                               paged_attention_tc=layers * out["decode_steps"])
    else:
        want = expect_launches(flash_attention_tc=layers * (2 if name == "dense_drop" else 1))
    log(f"[serve-plan] {name}: launches {launches}, expected {want}")
    if launches != want:
        raise AssertionError(f"serve-plan {name}: the path did not go through the kernels "
                             f"as expected")


def hold_engine_streams(ref: dict, got: dict, ref_logits: list, got_logits: list,
                        revoke: int = SERVE_REVOKE, tag: str = "engine") -> list:
    """The revoked engine run's streams (or, by ``tag``, another revoked
    run's) against the uninterrupted one's: equal through the revocation
    after ``revoke`` decode steps; after it each row is equal or first
    diverges at a near-tie (ENGINE_GAP_ULPS, ENGINE_MIN_CORR). Token j >= 1
    of a row comes from decode call j - 1 in both runs. Returns the
    divergences as (row, token, gap, allowed gap, correlation)."""
    out = []
    for b, (r, g) in enumerate(zip(ref["tokens"], got["tokens"])):
        if r == g:
            continue
        j = next(k for k, (x, y) in enumerate(zip(r, g)) if x != y)
        if j <= revoke:
            raise AssertionError(f"{tag} row {b} diverges at token {j}, before the revocation")
        a, c = ref_logits[j - 1][b], got_logits[j - 1][b]
        top = torch.topk(a, 2).values
        gap, allowed = float(top[0] - top[1]), ENGINE_GAP_ULPS * abs(float(top[0])) * 2 ** -7
        corr = float(torch.corrcoef(torch.stack([a, c]))[0, 1])
        out.append((b, j, gap, allowed, corr))
        log(f"[serve-plan] {tag} row {b}: first divergence at token {j}: uninterrupted top-2 "
            f"gap {gap:.5f} (allowed {allowed:.5f}), logits correlation {corr:.6f}")
        if not (gap <= allowed and corr > ENGINE_MIN_CORR):
            raise AssertionError(f"{tag} row {b}: the resumed stream diverges at token {j} "
                                 f"where the uninterrupted run has no near-tie")
    return out


def serve_plan_full_width() -> tuple:
    """Full-width qwen3-4b through the launcher's plan modes: dense under
    both cache policies and the engine, each revoked after 16 steps beside
    an uninterrupted run. Returns (launches summed over the runs, the
    uninterrupted engine's tokens/s, the revoked engine run's tracker, the
    model, its params)."""
    from repro_torch.config import get_arch
    from repro_torch.dist import ThroughputTracker, train_state_bytes
    from repro_torch.models import build_model
    from repro_torch.models.common import param_bytes
    from repro_torch.serve import DecodeEngine

    cfg = get_arch("qwen3-4b")
    model = build_model(cfg)
    predicted = serve_plan_predicted(model)
    if predicted["train_path_bytes"] != train_state_bytes(model):
        raise AssertionError("the predicted training-path bytes are not train_state_bytes")
    params = model.init(torch.Generator(device="cuda").manual_seed(0), "cuda", torch.bfloat16)
    prompts = np.random.RandomState(0).randint(0, cfg.vocab_size,
                                               (SERVE_B, SERVE_S)).astype(np.int32)
    log(f"[serve-plan] {cfg.name} at full width and depth ({model.param_count() / 1e9:.3f} B "
        f"params, bf16), {SERVE_B} prompts x {SERVE_S} tokens, {SERVE_NEW} new tokens, "
        f"revoked after {SERVE_REVOKE} steps, plans 8 -> 4 slots on cuda:0; predicted "
        f"{predicted}")
    total = dict.fromkeys(read_launches(), 0)
    runs, logits, rows = {}, {}, {}
    tracker = ThroughputTracker()
    for name in SERVE_RUNS:
        out, launches, peak, kept = _serve_plan_run(
            model, params, prompts, name, tracker if name == "engine_revoked" else None,
            capture=SERVE_RUNS[name][3])
        _hold_serve_launches(name, out, launches, cfg.num_layers)
        runs[name], logits[name], rows[name] = out, kept.logits, kept.kv
        total = {k: total[k] + v for k, v in launches.items()}
        if name == "engine_revoked":
            pool_gb = param_bytes(model.paged_cache_specs(
                SERVE_B * -(-(SERVE_S + SERVE_NEW) // 16) + 1)) / 1e9
            release = DecodeEngine.release_pool
            DecodeEngine.release_pool = lambda self: None
            try:
                held, _, held_peak, _ = _serve_plan_run(model, params, prompts, name)
            finally:
                DecodeEngine.release_pool = release
            log(f"[serve-plan] engine_revoked: peak device memory {peak:.2f} GB with the "
                f"dying pool ({pool_gb:.3f} GB) released before the replacement's is made, "
                f"{held_peak:.2f} GB with it held; streams equal: "
                f"{held['tokens'] == out['tokens']}")
            if held["tokens"] != out["tokens"]:
                raise AssertionError("engine streams depend on the dying pool's release")

    for name in ("dense_drop", "dense_migrate", "engine_revoked"):
        r = runs[name]
        want_cache = predicted["cache_bytes"] if name == "dense_migrate" else 0
        sps = r["measured_steps_per_sec"]
        if not (r["migrated_at"] == SERVE_REVOKE
                and r["params_bytes"] == predicted["params_bytes"]
                and 0 < r["params_bytes"] < r["train_path_bytes"]
                and r["train_path_bytes"] == predicted["train_path_bytes"]
                and r["cache_bytes"] == want_cache
                and set(sps) == {"4x2", "2x2"} and min(sps.values()) > 0
                and r["recover_seconds"] > 0):
            raise AssertionError(f"serve-plan {name}: migration columns {r} against {predicted}")
    ref = runs["dense"]["tokens"]
    if runs["dense_migrate"]["tokens"] != ref:
        raise AssertionError("dense migrate: the stream differs from the uninterrupted run's")
    drop = runs["dense_drop"]["tokens"]
    head = SERVE_REVOKE + 1
    if [row[:head] for row in drop] != [row[:head] for row in ref]:
        raise AssertionError("dense drop: the first tokens differ from the uninterrupted run's")
    later = [sum(x == y for x, y in zip(a[head:], b[head:])) for a, b in zip(drop, ref)]
    log(f"[serve-plan] dense migrate: stream equal to the uninterrupted run's; dense drop: "
        f"first {head} tokens equal, later tokens equal by row {later} of {SERVE_NEW - head}")
    resumed = hold_resumed_pages(rows["engine"], rows["engine_revoked"], SERVE_S)
    del rows
    div = hold_engine_streams(runs["engine"], runs["engine_revoked"], logits["engine"],
                              logits["engine_revoked"])
    log(f"[serve-plan] engine: {SERVE_B - len(div)} of {SERVE_B} rows equal in full, "
        f"divergences {div}; resumed lanes {resumed}")
    return total, runs["engine"]["engine_tokens_per_sec"], tracker, model, params


def serve_plan_reduced_matches_cpu(arch: str = "qwen3-4b", runs: dict = SERVE_RUNS,
                                   tag: str = "serve-plan",
                                   kernels: tuple = ("flash_attention_tf32",
                                                     "paged_attention_fma")) -> dict:
    """Reduced f32 ``arch`` through ``runs`` on the card and on the CPU,
    the same weights and prompts (an encoder-decoder's biases and norms
    drawn off their defaults, and its frames): every PLAN_JSON column but
    the timings equal, and every revoked stream equal to the uninterrupted
    run of its kind (dense or engine). Returns the card's launches, which
    must include ``kernels``."""
    from repro_torch.config import get_arch
    from repro_torch.launch.serve import serve_plan
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_map

    cfg = dataclasses.replace(get_arch(arch).reduced(), dtype="float32")
    model = build_model(cfg)
    r = SERVE_F32
    gen = torch.Generator().manual_seed(0)
    params_cpu = model.init(gen, "cpu")
    frames = None
    if cfg.encoder_layers:
        draw_off_defaults(params_cpu, gen)
        frames = torch.randn((r["batch"], cfg.encoder_seq_len, cfg.d_model), generator=gen)
    params_gpu = tree_map(lambda t: t.to("cuda"), params_cpu)
    prompts = np.random.RandomState(0).randint(
        0, cfg.vocab_size, (r["batch"], r["prompt_len"])).astype(np.int32)
    launches = dict.fromkeys(read_launches(), 0)
    outs = {}
    for name, (counts, revoke, policy, engine) in runs.items():
        for device, params in (("cuda", params_gpu), ("cpu", params_cpu)):
            if device == "cuda":
                reset_launches()
            outs[name, device] = serve_plan(
                model, params, prompts, r["new_tokens"], counts,
                revoke_after=r["revoke_after"] if revoke else 0, cache_policy=policy,
                engine=engine, device=device,
                frames=None if frames is None else frames.to(device))
            if device == "cuda":
                launches = {k: launches[k] + v for k, v in read_launches().items()}
        gpu, cpu = (outs[name, d] for d in ("cuda", "cpu"))
        differ = [k for k in gpu if k not in PLAN_TIMINGS and gpu[k] != cpu[k]]
        log(f"[{tag}] reduced f32 {name}: columns other than timings equal to the CPU's: "
            f"{not differ}; migrated_at {gpu['migrated_at']}, params_bytes "
            f"{gpu['params_bytes']}, cache_bytes {gpu['cache_bytes']}")
        if differ or set(gpu) != set(cpu):
            raise AssertionError(f"reduced f32 {name} on the card differs from the CPU: {differ}")
    for name, (_, revoke, _, engine) in runs.items():
        whole = next(n for n, run in runs.items() if not run[1] and run[3] == engine)
        if revoke and outs[name, "cuda"]["tokens"] != outs[whole, "cuda"]["tokens"]:
            raise AssertionError(f"reduced f32 {name}: stream differs from the uninterrupted "
                                 f"{whole}")
    return hold_f32_launches(tag, launches, *kernels)


def _fleet_row(scenario, policy, rep) -> str:
    """benchmarks/serve_bench.py::report_row."""
    from repro_torch.core.units import SECONDS_PER_HOUR, TOKENS_PER_MEGATOKEN

    return (
        f"{scenario},{policy},{rep.cost_dollars:.4f},"
        f"{rep.slo_violation_seconds:.1f},"
        f"{rep.router.served_tokens / TOKENS_PER_MEGATOKEN:.3f},{rep.router.shed_tokens:.1f},"
        f"{rep.router.queued_token_seconds / SECONDS_PER_HOUR:.1f},"
        f"{rep.revocations},{rep.repairs},"
        f"{rep.migrated_bytes},{rep.restored_bytes},{rep.replicas_provisioned},"
        f"{rep.p50_delay_seconds:.3f},{rep.p99_delay_seconds:.3f},"
        f"{rep.scale_ups},{rep.scale_downs},"
        f"{rep.idle_headroom_tokens / TOKENS_PER_MEGATOKEN:.3f}"
    )


def fleet_on_card_rate(model, params, engine_tps: float, tracker) -> list:
    """The serve bench's fleet, sized by the card's rate: FleetSimulator in
    engine mode with the uninterrupted engine run's tokens/s and the revoked
    run's tracker, on BENCH_serve's market set and its steady and diurnal
    traces at --quick length, scaled so that target / replica rate is
    480 / 100; the workload is full-width qwen3-4b's serving footprint.
    Holds token conservation, every migration below the training path's
    bytes, and a replay of the recorded trace with 0 mismatches. Returns
    the CSV rows."""
    import tempfile

    from repro_torch.core import generate_markets, split_history_future
    from repro_torch.core import provisioner as alg
    from repro_torch.core.units import BYTES_PER_GIB
    from repro_torch.dist import serve_state_bytes, train_state_bytes, tree_bytes
    from repro_torch.models.common import param_bytes
    from repro_torch.obs import events, read_jsonl, recording, replay, write_jsonl
    from repro_torch.serve import FleetSimulator, ServePolicy, ServingWorkload
    from repro_torch.serve import on_demand_reference

    pb = tree_bytes(params)
    cb = serve_state_bytes(model, SERVE_B, 2048) - param_bytes(model.specs)
    scale = engine_tps / 100.0
    wl = ServingWorkload(target_tokens_per_sec=480.0 * scale, replica_tokens_per_sec=engine_tps,
                         state_gb=(pb + cb) / BYTES_PER_GIB, param_bytes=pb, cache_bytes=cb,
                         inflight_context_tokens=SERVE_B * 2048.0)
    hours = 24 * 3
    hist, fut = split_history_future(generate_markets(seed=4, n_hours=24 * 90 + hours + 24),
                                     24 * 90)
    feats = alg.MarketFeatures.from_history(hist)
    fleet_policy = ServePolicy(slo_horizon_hours=24.0, capacity_headroom=1.25,
                               cache_policy="drop")
    static_policy = ServePolicy(slo_horizon_hours=24.0, capacity_headroom=1.5)
    kw = dict(throughput_mode="engine", measured_tokens_per_sec=engine_tps, tracker=tracker)
    t = np.arange(hours, dtype=float)
    steady = np.full(hours, 350.0)
    steady[0] = 0.0
    diurnal = 300.0 - 180.0 * np.cos(2 * math.pi * ((t % 24) / 24.0))
    diurnal[0] = 0.0
    log(f"[fleet] workload: param_bytes {pb} (bf16 tree), cache_bytes {cb} (batch 8 x 2048), "
        f"replica rate {engine_tps} tokens/s (the card's engine), target "
        f"{wl.target_tokens_per_sec}; tracker {tracker.measured}")
    rows, train_path = [FLEET_CSV], train_state_bytes(model)
    with recording() as rec:
        for scenario, rate in (("steady", steady * scale), ("diurnal", diurnal * scale)):
            reps = {
                "fleet": FleetSimulator(hist, fut, wl, fleet_policy, **kw).run(hours, rate),
                "autoscale": FleetSimulator(hist, fut, wl, fleet_policy, sizing="auto",
                                            **kw).run(hours, rate),
                "on_demand": on_demand_reference(wl, feats, fut, hours, rate, fleet_policy),
                "static": FleetSimulator(hist, fut, wl, static_policy, mode="static",
                                         **kw).run(hours, rate),
            }
            for policy, rep in reps.items():
                rows.append(_fleet_row(scenario, policy, rep))
                r = rep.router
                if not math.isclose(r.served_tokens + r.shed_tokens + r.q_end,
                                    r.offered_tokens, rel_tol=1e-9):
                    raise AssertionError(f"fleet {scenario} {policy}: tokens not conserved")
            f, od, auto = reps["fleet"], reps["on_demand"], reps["autoscale"]
            log(f"[fleet] {scenario} (logged, not held): fleet cost < on-demand "
                f"{f.cost_dollars < od.cost_dollars}, fleet violations <= on-demand "
                f"{f.slo_violation_seconds <= od.slo_violation_seconds}, autoscale violations "
                f"<= fleet {auto.slo_violation_seconds <= f.slo_violation_seconds}, autoscale "
                f"cost < fleet {auto.cost_dollars < f.cost_dollars}")
    moves = [e.bytes_moved for e in rec.events if isinstance(e, events.ReshardStart)]
    if not all(0 < m < train_path for m in moves):
        raise AssertionError(f"a fleet migration moved {max(moves)} >= {train_path} bytes")
    with tempfile.TemporaryDirectory() as d:
        path = Path(d) / "fleet.jsonl"
        write_jsonl(path, rec.events)
        runs, problems = replay.verify_events(read_jsonl(path))
    log(f"[fleet] {len(moves)} migrations, largest {max(moves, default=0)} bytes (training "
        f"path {train_path}); trace of {len(rec.events)} events replays as {len(runs)} runs "
        f"with {len(problems)} mismatches")
    if problems or not runs or any(r.pin is None for r in runs):
        raise AssertionError(f"fleet trace replay: {problems[:3]}")
    return rows


def spot_serving() -> dict:
    """Phase 9: the launcher's plan modes at full width, reduced f32 against
    the CPU, and the fleet on the card's rate. Returns launches by path."""
    launches, engine_tps, tracker, model, params = serve_plan_full_width()
    rows = fleet_on_card_rate(model, params, engine_tps, tracker)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    paths = {"serve_plan": launches, "serve_plan_f32": serve_plan_reduced_matches_cpu()}
    for row in rows:
        print(row, flush=True)
    return paths


# ---------------------------------------------------------------------------
# phase 10: the MoE family (mixtral-8x7b, phi3.5-moe)
# ---------------------------------------------------------------------------

# full layer width, depth cut to fit one card's 80 GB: 16 of 32 layers to
# serve (mixtral 23.48 B params, 46.96 GB of bf16 matrices; phi3.5 21.07 B),
# 2 to train (3.165 B f32 params, 50.6 GB with grads and AdamW moments)
MOE_LAYERS, MOE_TRAIN_LAYERS, MOE_NEW = 16, 2, 32
# path: (arch, prompts, prompt length); mixtral's prompts span two windows
MOE_SERVE = {"moe": ("mixtral-8x7b", 4, 8192), "moe_phi": ("phi3.5-moe-42b-a6.6b", 4, 4096)}
MOE_TRAIN_SEQ, MOE_TRAIN_BATCH, MOE_TRAIN_STEPS = 8192, 2, 4
# Random-weight MoE in bf16 is chaotic: a rounding-level change of the
# attention output flips a few near-tie top-k picks in the first layer,
# each flip moves the capacity drops of every later assignment to those
# experts (the heaviest expert takes well over its capacity in the later
# layers), and the share of differing picks grows layer by layer
# (``moe_flash_gate`` logs them): the flash and the masked prefill's last
# logits correlate well below 0.99 with the same top-1, and for phi3.5
# two masked chunk orders do too. So, as for bf16 xlstm (PR 18), the flash
# prefill is held by its distance from an f32 reference (the same bf16
# weights upcast, f32 compute, masked attention) over every position of
# the first prompt, D = mean(1 - corr) of the logits, against that of the
# masked bf16 path in two chunk orders: D(flash) <= MOE_D_MARGIN x
# max(D(masked)).
MOE_D_MARGIN = 1.5


def _near_tie(ref: torch.Tensor, pick: int) -> tuple:
    """(ok, gap, allowed): ``pick`` is the top-1 of ``ref`` or within
    ENGINE_GAP_ULPS bf16 ulps of it (phase 9's near-tie rule)."""
    top = float(ref.max())
    gap, allowed = top - float(ref[pick]), ENGINE_GAP_ULPS * abs(top) * 2 ** -7
    return gap <= allowed, gap, allowed


def moe_serve_full_width(path: str) -> dict:
    """mixtral-8x7b or phi3.5-moe at full layer width and 16 of 32 layers
    through the serve launcher's loop: one batched prefill of 4 prompts,
    then 31 greedy decode steps against the dense cache (for mixtral the
    4096-slot ring). Held: the launches (one flash forward a layer, nothing
    else), the flash prefill against the masked one (``moe_flash_gate``),
    and the last decode step against a fresh prefill over the prompt and
    the 31 generated tokens (top-1 equal, or phase 9's near-tie); how many
    expert counters agree is logged."""
    from repro_torch.config import get_arch
    from repro_torch.launch.serve import greedy_serve
    from repro_torch.models import RunOpts, build_model
    from repro_torch.models.common import tree_leaves

    arch, B, S = MOE_SERVE[path]
    cfg = dataclasses.replace(get_arch(arch), num_layers=MOE_LAYERS)
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(0), "cuda", torch.bfloat16)
    torch.cuda.synchronize()
    router = params["blocks"]["moe"]["router"].dtype
    gb = sum(t.numel() * t.element_size() for t in tree_leaves(params)) / 1e9
    log(f"[{path}] {cfg.name}: {cfg.num_layers} of {get_arch(arch).num_layers} layers (depth "
        f"cut, width full), d_model {cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} heads x "
        f"{cfg.resolved_head_dim}, window {cfg.window}, {cfg.moe.num_experts} experts top-"
        f"{cfg.moe.top_k}, d_ff {cfg.d_ff}; {model.param_count() / 1e9:.3f} B params, "
        f"{gb:.2f} GB on the card (router {router}), made in {time.perf_counter() - t0:.1f} s")
    if router != torch.float32:
        raise AssertionError(f"the router is stored in {router}, not f32")

    prompts = np.random.RandomState(0).randint(0, cfg.vocab_size, (B, S)).astype(np.int32)
    tokens = torch.as_tensor(prompts, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    res = greedy_serve(model, params, tokens, MOE_NEW)
    launches = read_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    want = expect_launches(flash_attention_tc=cfg.num_layers)
    out = res.tokens
    log(f"[{path}] {B} prompts x {S} tokens, {MOE_NEW} new tokens each; first row "
        f"{out[0].tolist()}")
    log(f"[{path}] launches {launches}, expected {want}")
    if tuple(out.shape) != (B, MOE_NEW) or not bool(((out >= 0) & (out < cfg.vocab_size)).all()):
        raise AssertionError(f"generated tokens {tuple(out.shape)} outside the vocabulary")
    if not all(bool(torch.isfinite(lg.float()).all()) for lg in res.logits):
        raise AssertionError("non-finite logits")
    if res.decode_steps != MOE_NEW - 1 or launches != want:
        raise AssertionError(f"{path}: the path did not go through the kernels as expected")
    log(f"[{path}] prefill {B * S / res.prefill_seconds:.1f} tokens/s ({B * S} tokens in "
        f"{res.prefill_seconds:.3f} s); decode {1e3 * res.decode_seconds / res.decode_steps:.2f} "
        f"ms per step ({B * res.decode_steps / res.decode_seconds:.1f} tokens/s); peak memory "
        f"{peak_gb:.2f} GB")

    moe_flash_gate(path, model, params, tokens[:1])

    # decode against the forward: the last decode step's logits beside a
    # fresh prefill over the prompt and the 31 tokens decode fed
    grown = torch.cat([tokens, out[:, :MOE_NEW - 1].to("cuda")], dim=1)
    fresh, fresh_cache = model.prefill(params, {"tokens": grown}, S + MOE_NEW,
                                       RunOpts(attn_impl="flash"))
    dec = res.logits[-1].float()
    fwd = fresh[:, -1].float()
    rows = []
    for r in range(B):
        pick = int(dec[r].argmax())
        tie, gap, allowed = _near_tie(fwd[r], pick)
        c = float(torch.corrcoef(torch.stack([dec[r], fwd[r]]))[0, 1])
        same = pick == int(fwd[r].argmax())
        rows.append((r, same, round(gap, 5), round(allowed, 5), round(c, 6)))
        if not (same or (tie and c > ENGINE_MIN_CORR)):
            raise AssertionError(f"{path} row {r}: decode's top-1 {pick} is not the forward's "
                                 f"nor a near-tie of it (gap {gap}, allowed {allowed}, "
                                 f"correlation {c})")
    got, ref = res.cache["blocks"]["moe_load"], fresh_cache["blocks"]["moe_load"]
    equal = int((got == ref).sum())
    log(f"[{path}] last decode step vs a fresh prefill of {S + MOE_NEW - 1} tokens, by row "
        f"(row, top-1 equal, forward's gap to decode's pick, allowed, correlation): {rows}; "
        f"moe_load counters equal to the fresh prefill's: {equal} of {got.numel()} "
        f"(largest difference {int((got - ref).abs().max())})")
    del fresh, fresh_cache
    profile_greedy(path, model, params, tokens, res.cache, MOE_NEW)
    return launches


def _positions_distance(a: torch.Tensor, ref: torch.Tensor) -> tuple:
    """(mean over positions of 1 - corr of the logits rows, share of
    positions whose top-1 agrees) of ``a`` against ``ref``, both (S, V)."""
    a, ref = a.float(), ref.float()
    top = float((a.argmax(-1) == ref.argmax(-1)).float().mean())
    a, ref = a - a.mean(-1, keepdim=True), ref - ref.mean(-1, keepdim=True)
    corr = (a * ref).sum(-1) / (a.norm(dim=-1) * ref.norm(dim=-1))
    return float((1 - corr).mean()), top


def moe_flash_gate(path: str, model, params, row: torch.Tensor) -> None:
    """The flash forward of one prompt against the masked one: the last
    position's top-1 equal, and D(flash) <= MOE_D_MARGIN x max(D(masked))
    against the f32 reference (MOE_D_MARGIN's comment), every position."""
    from unittest import mock

    from repro_torch.models import RunOpts, build_model, moe

    batch = {"tokens": row}
    model32 = build_model(dataclasses.replace(model.cfg, dtype="float32"))
    picks: dict = {}

    def forward(tag, m, opts):
        """All positions' logits of ``m``; each layer's top-k picks, sorted,
        into ``picks[tag]``."""
        route = moe._route
        picks[tag] = []

        def recording(p, x, cfg):
            out = route(p, x, cfg)
            picks[tag].append(out[2].sort(-1).values)
            return out

        with mock.patch.object(moe, "_route", recording):
            return m.forward(params, batch, dataclasses.replace(opts, remat="none"))[0][0]

    with torch.no_grad():
        before = read_launches()
        ref = forward("f32", model32, RunOpts(attn_impl="masked"))
        plain = {kv: forward(kv, model, RunOpts(attn_impl="masked", kv_chunk=kv))
                 for kv in (1024, 512)}
        if read_launches() != before:
            raise AssertionError("the masked path launched a kernel")
        flash = forward("flash", model, RunOpts(attn_impl="flash"))
    d = {"flash": _positions_distance(flash, ref),
         **{f"masked kv_chunk {kv}": _positions_distance(t, ref) for kv, t in plain.items()}}
    limit = MOE_D_MARGIN * max(d[f"masked kv_chunk {kv}"][0] for kv in plain)
    a, b = flash[-1].float(), plain[1024][-1].float()
    corr = float(torch.corrcoef(torch.stack([a, b]))[0, 1])
    top_eq = int(a.argmax()) == int(b.argmax())
    orders = float(torch.corrcoef(torch.stack([plain[512][-1].float(), b]))[0, 1])
    differ = lambda x, y: [round(float((p != q).any(-1).float().mean()), 5)
                           for p, q in zip(picks[x], picks[y])]
    cap = moe._capacity(model.cfg, row.shape[1])
    heaviest = [int(torch.bincount(p.flatten(), minlength=model.cfg.moe.num_experts).max())
                for p in picks[1024]]
    log(f"[{path}] share of tokens whose top-{model.cfg.moe.top_k} picks differ, by layer: "
        f"flash vs masked {differ('flash', 1024)}; masked kv_chunk 512 vs 1024 "
        f"{differ(512, 1024)}; f32 vs masked {differ('f32', 1024)}; the heaviest expert's "
        f"assignments by layer (masked) {heaviest} against a capacity of {cap}")
    log(f"[{path}] flash vs masked logits at the last of {row.shape[1]} positions: top-1 equal "
        f"{top_eq}, correlation {corr:.6f} (masked kv_chunk 512 vs 1024: {orders:.6f}); "
        f"against the f32 reference over every position, "
        f"(D = mean(1 - corr), top-1 share): " + ", ".join(
            f"{k} ({v[0]:.6e}, {v[1]:.4f})" for k, v in d.items())
        + f"; limit {limit:.6e} ({MOE_D_MARGIN} x the masked paths')")
    if not (bool(torch.isfinite(flash.float()).all()) and top_eq and d["flash"][0] <= limit):
        raise AssertionError(f"{path}: the flash prefill is farther from the f32 reference "
                             f"than the masked paths allow, or its last top-1 differs")


def moe_train_full_width() -> dict:
    """mixtral-8x7b at full layer width and 2 of 32 layers, f32 params +
    AdamW, seq 8192 (two windows), global batch 2 in 2 microbatches, remat
    per layer, through ``run_segment`` for 4 steps: the windowed flash
    backward on a training path."""
    from repro_torch.config import ShardingLayout, TrainConfig, get_arch
    from repro_torch.data import SyntheticLM
    from repro_torch.models import build_model
    from repro_torch.train.loop import make_step, run_segment
    from repro_torch.train.steps import init_train_state

    cfg = dataclasses.replace(get_arch("mixtral-8x7b"), num_layers=MOE_TRAIN_LAYERS)
    model = build_model(cfg)
    seq, batch, n_steps = MOE_TRAIN_SEQ, MOE_TRAIN_BATCH, MOE_TRAIN_STEPS
    tc = TrainConfig(total_steps=n_steps, warmup_steps=1, microbatches=2)
    layout = ShardingLayout(attn_impl="flash")
    ds = SyntheticLM(cfg.vocab_size, seq, batch, seed=0)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = init_train_state(model, torch.Generator(device="cuda").manual_seed(0), "cuda")
    torch.cuda.synchronize()
    log(f"[moe-train] {cfg.name}: {cfg.num_layers} of 32 layers (depth cut, width full), "
        f"window {cfg.window}, {cfg.moe.num_experts} experts; {model.param_count() / 1e9:.3f} "
        f"B f32 params; params + AdamW moments {torch.cuda.memory_allocated() / 1e9:.2f} GB, "
        f"made in {time.perf_counter() - t0:.1f} s; seq {seq}, global batch {batch} in "
        f"{tc.microbatches} microbatches, remat {layout.remat}")

    def probe(st):
        p = st.params
        return [t.detach().clone() for t in (
            p["embed"][:4, :8], p["lm_head"][:8, :4], p["blocks"]["attn"]["wq"][0, :8, :4],
            p["blocks"]["moe"]["router"][-1, :8], p["blocks"]["moe"]["wo"][-1, 0, :8, :4])]

    metrics: list = []
    step_fn = _recording(make_step(model, tc, layout), metrics)
    before = probe(state)
    reset_launches()
    res0 = run_segment(model, state, ds, "cuda", tc, layout, num_steps=1, jitted=step_fn)
    if not all(torch.equal(a, b) for a, b in zip(before, probe(res0.state))):
        raise AssertionError("params moved at step 0, where the learning rate is 0")
    res1 = run_segment(model, res0.state, ds, "cuda", tc, layout, num_steps=n_steps - 1,
                       start_step=1, jitted=step_fn)
    launches = read_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    moved = [float((a - b).abs().max()) for a, b in zip(before, probe(res1.state))]
    per_mb = cfg.num_layers * tc.microbatches * n_steps
    want = expect_launches(flash_attention_tc=2 * per_mb, flash_attention_bwd_dkdv_tc=per_mb,
                           flash_attention_bwd_dq_tc=per_mb)
    secs = res0.step_seconds + res1.step_seconds
    for i, (m, dt) in enumerate(zip(metrics, secs)):
        log(f"[moe-train] step {i}: loss {m['loss']:.6f}, aux_loss {m['aux_loss']:.6f}, "
            f"grad_norm {m['grad_norm']:.6f}, lr {m['lr']:.3e}, {dt * 1e3:.1f} ms, "
            f"{batch * seq / dt:.1f} tokens/s")
    log(f"[moe-train] peak memory {peak_gb:.2f} GB; largest change of the probed params after "
        f"step 1: {max(moved):.3e}; launches {launches}, expected {want}")
    if len(metrics) != n_steps or not all(
            np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"]) and np.isfinite(m["aux_loss"])
            and m["aux_loss"] > 0 for m in metrics):
        raise AssertionError(f"non-finite or missing training metrics, or aux_loss <= 0: {metrics}")
    if not min(moved) > 0:
        raise AssertionError("a probed param did not move after step 1")
    if launches != want:
        raise AssertionError("the MoE training path did not go through the kernels as expected")
    profile_training(model, step_fn, res1.state, ds, f"seq {seq}")
    return launches


def moe_reduced_matches_cpu() -> dict:
    """Reduced mixtral (window 8, 4 experts) and phi3.5 at f32 through the
    serve launcher's loop, card against CPU: streams, logits and every
    expert counter. Returns the card's launches over both."""
    runs = [greedy_reduced_matches_cpu(arch, tag, "flash_attention_tf32")
            for arch, tag in (("mixtral-8x7b", "moe"), ("phi3.5-moe-42b-a6.6b", "moe_phi"))]
    return {k: sum(r[k] for r in runs) for k in runs[0]}


def moe_phase() -> dict:
    """Phase 10: MoE serving (mixtral, phi3.5) and mixtral training at full
    width, then the reduced f32 runs against the CPU. Returns launches by
    path."""
    paths = {}
    for path in MOE_SERVE:
        paths[path] = moe_serve_full_width(path)
        gc.collect()
        torch.cuda.empty_cache()
    paths["moe_train"] = moe_train_full_width()
    gc.collect()
    torch.cuda.empty_cache()
    paths["moe_f32"] = moe_reduced_matches_cpu()
    paths["moe_train_f32"] = train_reduced_matches_cpu("mixtral-8x7b", "moe-train", 3)
    return paths


# ---------------------------------------------------------------------------
# phase 3, the dense variants' shapes (run again under --dense-variants-only)
# ---------------------------------------------------------------------------

# (tag, B, S, H, KVH): the flash forward at qwen1.5-32b's prefill (G=1) and
# internvl2-26b's (1025 patch rows + 2048 text tokens, G=6; the last q tile
# of 128 rows holds one row), hd 128, causal, bf16
DENSE_FLASH_SHAPES = [("qwen1.5-32b prefill", 1, 2000, 40, 40),
                      ("internvl2-26b prefill", 4, 3073, 48, 8)]
# qwen1.5-4b's training shape: B1 S4096 H20/20 hd128 causal, bf16
DENSE_TRAIN_ATTN = dict(B=1, S=4096, H=20, KVH=20, hd=128)
# the paged kernel at 8 lanes, G=1 (qwen1.5-4b's H20, qwen1.5-32b's H40), hd128
DENSE_PAGED_HEADS = (20, 40)


def check_dense_variant_kernels(gen: torch.Generator, flush: torch.Tensor) -> dict:
    """The forward, dk/dv, dq and paged tensor-core kernels at this slice's
    new shapes (group sizes 1 and 6, a ragged last tile of one row) against
    their plain versions (one batch row at a time where the plain scores
    would not fit), each timed beside SDPA (or, for the paged kernel, the
    plain version) and its bound. Returns the largest errors, by record name."""
    from repro_torch.kernels.flash_attention import kernel, kernel_bwd
    from repro_torch.kernels.flash_attention.ref import attention_bwd_ref, attention_fwd_ref
    from repro_torch.kernels.paged_attention import kernel as paged
    from repro_torch.kernels.paged_attention import ops as paged_ops
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref

    log("[kernels] the dense variants' shapes: flash forward at G=1 and G=6 (S=3073), the "
        "backward at H20/20, paged at G=1")
    errs = dict.fromkeys(("flash_attention_tc", "flash_attention_bwd_dkdv_tc",
                          "flash_attention_bwd_dq_tc", "paged_attention_tc"), 0.0)
    kw = dict(causal=True, window=0, q_offset=0)
    mk = lambda B, S, heads, hd=128: torch.randn((B, S, heads, hd), generator=gen,
                                                 device="cuda").to(torch.bfloat16)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for tag, B, S, H, KVH in DENSE_FLASH_SHAPES:
        q, k, v = mk(B, S, H), mk(B, S, KVH), mk(B, S, KVH)
        o, lse = kernel.flash_attention_fwd(q, k, v, **kw)
        torch.cuda.synchronize()
        for b in range(B):
            e = hold_fwd(f"flash {tag} B{B} S{S} H{H}/{KVH} hd128 bf16 row {b}", o[b:b + 1],
                         lse[b:b + 1], q[b:b + 1], k[b:b + 1], v[b:b + 1], kw,
                         FLASH_MAIN_BF16_TOL)
            errs["flash_attention_tc"] = max(errs["flash_attention_tc"], e)
        del o, lse
        flops, nbytes = flash_work(B, S, H, KVH, 128)["fwd"]
        b_ms, b_by = bound(flops, nbytes, PEAK_BF16_FLOPS)
        ms = time_ms(lambda: kernel.flash_attention_fwd(q, k, v, **kw), flush)
        plain_ms = time_ms(lambda: attention_fwd_ref(q[:1], k[:1], v[:1], **kw), flush, reps=3)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        lib_ms = time_ms(lambda: sdpa(qt, kt, vt, is_causal=True, enable_gqa=True), flush)
        log(f"  flash {tag} (B{B} S{S} H{H}/{KVH} hd128 bf16): kernel {ms:.4f} ms, plain (o, "
            f"lse; one batch row) {plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound {b_ms:.4f} ms "
            f"({b_by}); {flops / ms / 1e9:.1f} TFLOP/s achieved")
        del q, k, v, qt, kt, vt
        torch.cuda.empty_cache()

    B, S, H, KVH, hd = (DENSE_TRAIN_ATTN[x] for x in ("B", "S", "H", "KVH", "hd"))
    q, k, v, do = mk(B, S, H), mk(B, S, KVH), mk(B, S, KVH), mk(B, S, H)
    o, lse = kernel.flash_attention_fwd(q, k, v, **kw)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    dk, dv = kernel_bwd.flash_attention_bwd_dkdv(q, k, v, do, lse, delta, **kw)
    dq = kernel_bwd.flash_attention_bwd_dq(q, k, v, do, lse, delta, **kw)
    torch.cuda.synchronize()
    tag = f"qwen1.5-4b training B{B} S{S} H{H}/{KVH} hd{hd} bf16"
    errs["flash_attention_tc"] = max(errs["flash_attention_tc"], hold_fwd(
        f"flash {tag}", o, lse, q, k, v, kw, FLASH_MAIN_BF16_TOL))
    rq, rk, rv = attention_bwd_ref(q, k, v, o, lse, do, **kw)
    errs["flash_attention_bwd_dkdv_tc"] = max(
        hold(f"bwd {tag} dk", dk, rk, FLASH_BWD_MAIN_BF16_TOL),
        hold(f"bwd {tag} dv", dv, rv, FLASH_BWD_MAIN_BF16_TOL))
    errs["flash_attention_bwd_dq_tc"] = hold(f"bwd {tag} dq", dq, rq, FLASH_BWD_MAIN_BF16_TOL)
    del rq, rk, rv, dk, dv, dq
    torch.cuda.empty_cache()
    w = flash_work(B, S, H, KVH, hd)
    work = {"flash_attention_tc": w["fwd"], "flash_attention_bwd_dkdv_tc": w["dkdv"],
            "flash_attention_bwd_dq_tc": w["dq"]}
    fns = {"flash_attention_tc": lambda: kernel.flash_attention_fwd(q, k, v, **kw),
           "flash_attention_bwd_dkdv_tc": lambda: kernel_bwd.flash_attention_bwd_dkdv(
               q, k, v, do, lse, delta, **kw),
           "flash_attention_bwd_dq_tc": lambda: kernel_bwd.flash_attention_bwd_dq(
               q, k, v, do, lse, delta, **kw)}
    plain_fwd = time_ms(lambda: attention_fwd_ref(q, k, v, **kw), flush, reps=3)
    plain_bwd = time_ms(lambda: attention_bwd_ref(q, k, v, o, lse, do, **kw), flush, reps=3)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    sdpa_fwd = time_ms(lambda: sdpa(qt, kt, vt, is_causal=True), flush)
    sdpa_bwd = sdpa_backward_ms(q, k, v, do, flush)
    for name, (flops, nbytes) in work.items():
        b_ms, b_by = bound(flops, nbytes, PEAK_BF16_FLOPS)
        ms = time_ms(fns[name], flush)
        log(f"  {name} at {tag}: kernel {ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}); "
            f"{flops / ms / 1e9:.1f} TFLOP/s of the function's work achieved")
    log(f"  at {tag}: plain forward {plain_fwd:.4f} ms, plain backward (all of dq, dk, dv) "
        f"{plain_bwd:.4f} ms; SDPA flash forward {sdpa_fwd:.4f} ms, backward (fwd + bwd minus "
        f"fwd) {sdpa_bwd:.4f} ms")
    del q, k, v, do, o, lse, delta, qt, kt, vt
    torch.cuda.empty_cache()

    lens = [2048] + np.random.RandomState(1).randint(1, 2049, 7).tolist()
    n_tok = sum(lens)
    n_pages = sum(-(-n // 16) for n in lens)
    for H in DENSE_PAGED_HEADS:
        args = _paged_inputs(gen, 8, H, H, 128, 16, 128, lens, torch.bfloat16, seed=1)
        name = f"paged 8 lanes H{H}/{H} hd128 ps16 lens{lens} bf16"
        out = paged.paged_attention(*args)
        errs["paged_attention_tc"] = max(errs["paged_attention_tc"], hold(
            name, out, paged_attention_ref(*args), PAGED_MAIN_BF16_TOL))
        flops, nbytes = paged_ops.cost(8, H, H, 128, n_tok, n_pages)
        b_ms, b_by = bound(flops, nbytes, PEAK_BF16_FLOPS)
        ms = time_ms(lambda: paged.paged_attention(*args), flush)
        plain_ms = time_ms(lambda: paged_attention_ref(*args), flush)
        log(f"  {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms "
            f"({b_by}); {nbytes / ms / 1e6:.1f} GB/s achieved")
    return errs


# ---------------------------------------------------------------------------
# phase 3 at head dim 256: gemma-7b's kernels (run again under --gemma-only)
# ---------------------------------------------------------------------------

# (B, Sq, Skv, H, KVH, causal, window, q_offset) at hd 256, both dtypes,
# forward and backward: the reference's feature cases (GQA, a window, a
# ragged tail, a q offset, non-causal) with the head dim set to 256, and a
# q offset that is no multiple of the 64-row kv tile (the causal diagonal
# then crosses a tile 48 rows in)
GEMMA_FLASH_CASES = [
    (1, 256, 256, 4, 2, True, 0, 0),
    (2, 128, 128, 4, 1, True, 64, 0),
    (1, 200, 200, 4, 2, True, 48, 0),
    (2, 333, 333, 4, 2, True, 0, 0),
    (1, 64, 192, 4, 2, True, 0, 128),
    (1, 64, 240, 4, 2, True, 0, 176),
    (2, 100, 100, 4, 2, False, 0, 0),
]
# (B, H, KVH, page_size, max_blocks, lens) at hd 256, both dtypes:
# tests/test_kernels.py PAGED_CASES and the split's edges (check_paged)
GEMMA_PAGED_CASES = [
    (2, 4, 4, 16, 4, [64, 33]),
    (3, 8, 2, 16, 4, [1, 50, 64]),
    (2, 4, 1, 8, 6, [41, 17]),
    (4, 8, 2, 16, 20, [0, 1, 128, 129]),
    (4, 8, 2, 24, 14, [128, 150, 143, 1]),
    (4, 8, 2, 256, 2, [129, 300, 256, 0]),
]
# gemma-7b's shapes: serving prefill B1 S2000 and training B1 S4096, H16/16
# hd 256 causal; the paged kernel at 8 lanes, H16/16 hd 256
GEMMA_ATTN = dict(H=16, KVH=16, hd=256, prefill_S=2000, train_S=4096)


def check_gemma_kernels(gen: torch.Generator, flush: torch.Tensor) -> dict:
    """The flash forward, dk/dv, dq and paged kernels at head dim 256 in
    both dtypes (bf16 on tensor cores; f32 on tensor cores as split TF32,
    but for the paged kernel on FMAs) against their plain versions on the
    feature cases and at gemma-7b's shapes; the bf16 dq, the f32 dk/dv and
    dq and the paged kernel give the same bits twice; times beside the bound and
    SDPA's (the paged kernel: the plain version's). Returns the largest
    errors, by record name."""
    from repro_torch.kernels.flash_attention import kernel, kernel_bwd
    from repro_torch.kernels.flash_attention.ref import attention_bwd_ref, attention_fwd_ref
    from repro_torch.kernels.paged_attention import kernel as paged
    from repro_torch.kernels.paged_attention import ops as paged_ops
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref

    hd = GEMMA_ATTN["hd"]
    log(f"[kernels] head dim {hd} (gemma-7b): flash forward, dk/dv, dq and paged, both dtypes")
    # the record's variant: tensor cores in bf16; in f32 split TF32 for the
    # flash kernels, FMAs for the paged one
    variant = lambda dtype, flash=True: ("tc" if dtype == torch.bfloat16 else
                                         "tf32" if flash else "fma")
    errs = {f"{n}_{v}": 0.0 for n, vs in (("flash_attention", ("tc", "tf32")),
                                          ("flash_attention_bwd_dkdv", ("tc", "tf32")),
                                          ("flash_attention_bwd_dq", ("tc", "tf32")),
                                          ("paged_attention", ("tc", "fma")))
            for v in vs}
    mk = lambda B, S, heads, dtype: torch.randn((B, S, heads, hd), generator=gen,
                                                device="cuda").to(dtype)

    def fwd_bwd(name, B, Sq, Skv, H, KVH, causal, window, q_offset, dtype, t_fwd, t_bwd):
        q, k, v, do = mk(B, Sq, H, dtype), mk(B, Skv, KVH, dtype), mk(B, Skv, KVH, dtype), \
            mk(B, Sq, H, dtype)
        kw = dict(causal=causal, window=window, q_offset=q_offset)
        o, lse = kernel.flash_attention_fwd(q, k, v, **kw)
        delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
        dk, dv = kernel_bwd.flash_attention_bwd_dkdv(q, k, v, do, lse, delta, **kw)
        dq = kernel_bwd.flash_attention_bwd_dq(q, k, v, do, lse, delta, **kw)
        torch.cuda.synchronize()
        vr = vb = variant(dtype)
        errs[f"flash_attention_{vr}"] = max(errs[f"flash_attention_{vr}"],
                                            hold_fwd(name, o, lse, q, k, v, kw, t_fwd))
        rq, rk, rv = attention_bwd_ref(q, k, v, o, lse, do, **kw)
        errs[f"flash_attention_bwd_dkdv_{vb}"] = max(
            errs[f"flash_attention_bwd_dkdv_{vb}"], hold(f"{name} dk", dk, rk, t_bwd),
            hold(f"{name} dv", dv, rv, t_bwd))
        errs[f"flash_attention_bwd_dq_{vb}"] = max(errs[f"flash_attention_bwd_dq_{vb}"],
                                                   hold(f"{name} dq", dq, rq, t_bwd))
        return q, k, v, do, o, lse, delta, kw

    for dtype in (torch.float32, torch.bfloat16):
        for args in GEMMA_FLASH_CASES:
            fwd_bwd(f"hd{hd} (B, Sq, Skv, H, KVH, causal, window, q_offset) = {args} "
                    f"{str(dtype)[6:]}", *args, dtype, tol(dtype),
                    FLASH_BWD_F32_TOL if dtype == torch.float32 else tol(dtype))
    for dtype in (torch.float32, torch.bfloat16):
        for B, H, KVH, ps, mb, lens in GEMMA_PAGED_CASES:
            args = _paged_inputs(gen, B, H, KVH, hd, ps, mb, lens, dtype, seed=3)
            out = paged.paged_attention(*args)
            errs[f"paged_attention_{variant(dtype, False)}"] = max(
                errs[f"paged_attention_{variant(dtype, False)}"],
                hold(f"paged hd{hd} B{B} H{H}/{KVH} ps{ps} lens{lens} {str(dtype)[6:]}",
                     out, paged_attention_ref(*args), tol(dtype)))
            if not all(bool((out[b] == 0).all()) for b, n in enumerate(lens) if n == 0):
                raise AssertionError(f"paged hd{hd} lens{lens}: a dead lane is not zeros")

    H, KVH = GEMMA_ATTN["H"], GEMMA_ATTN["KVH"]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    # serving prefill, bf16 (and the f32 variant at S 1000)
    for S, dtype, t in ((GEMMA_ATTN["prefill_S"], torch.bfloat16, FLASH_MAIN_BF16_TOL),
                        (1000, torch.float32, F32_TOL)):
        q, k, v = mk(1, S, H, dtype), mk(1, S, KVH, dtype), mk(1, S, KVH, dtype)
        kw = dict(causal=True, window=0, q_offset=0)
        o, lse = kernel.flash_attention_fwd(q, k, v, **kw)
        torch.cuda.synchronize()
        tag = f"gemma prefill B1 S{S} H{H}/{KVH} hd{hd} {str(dtype)[6:]}"
        vr = variant(dtype)
        errs[f"flash_attention_{vr}"] = max(errs[f"flash_attention_{vr}"],
                                            hold_fwd(f"flash {tag}", o, lse, q, k, v, kw, t))
        flops, nbytes = flash_work(1, S, H, KVH, hd, el=q.element_size())["fwd"]
        peak = peak_flops(f"flash_attention_{vr}")
        b_ms, b_by = bound(flops, nbytes, peak)
        ms = time_ms(lambda: kernel.flash_attention_fwd(q, k, v, **kw), flush)
        plain_ms = time_ms(lambda: attention_fwd_ref(q, k, v, **kw), flush, reps=3)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        lib_ms = time_ms(lambda: sdpa(qt, kt, vt, is_causal=True), flush)
        log(f"  flash_attention_{vr} at {tag}: kernel {ms:.4f} ms, plain (o, lse) "
            f"{plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}"
            f"{f32_fma_bound(flops, nbytes, peak)}); {flops / ms / 1e9:.1f} TFLOP/s achieved")
        del q, k, v, o, lse, qt, kt, vt

    # training, bf16 at S 4096 (and the f32 variants at S 1000)
    for S, dtype, t_fwd, t_bwd in ((GEMMA_ATTN["train_S"], torch.bfloat16, FLASH_MAIN_BF16_TOL,
                                    FLASH_BWD_MAIN_BF16_TOL),
                                   (1000, torch.float32, F32_TOL, FLASH_BWD_F32_TOL)):
        tag = f"gemma training B1 S{S} H{H}/{KVH} hd{hd} {str(dtype)[6:]}"
        q, k, v, do, o, lse, delta, kw = fwd_bwd(tag, 1, S, S, H, KVH, True, 0, 0, dtype,
                                                 t_fwd, t_bwd)
        torch.cuda.empty_cache()
        vr = vb = variant(dtype)
        if dtype == torch.bfloat16:
            dq_a, dq_b = (kernel_bwd.flash_attention_bwd_dq(q, k, v, do, lse, delta, **kw)
                          for _ in range(2))
            same = torch.equal(dq_a, dq_b)
            log(f"  {tag}: two dq calls give the same bits: {same}")
            if not same:
                raise AssertionError("the bf16 dq kernel gave different bits at hd 256")
            del dq_a, dq_b
        else:
            hold_same_bits(tag, q, k, v, do, lse, delta, kw)
        w = flash_work(1, S, H, KVH, hd, el=q.element_size())
        work = {f"flash_attention_{vr}": w["fwd"], f"flash_attention_bwd_dkdv_{vb}": w["dkdv"],
                f"flash_attention_bwd_dq_{vb}": w["dq"]}
        fns = {f"flash_attention_{vr}": lambda: kernel.flash_attention_fwd(q, k, v, **kw),
               f"flash_attention_bwd_dkdv_{vb}": lambda: kernel_bwd.flash_attention_bwd_dkdv(
                   q, k, v, do, lse, delta, **kw),
               f"flash_attention_bwd_dq_{vb}": lambda: kernel_bwd.flash_attention_bwd_dq(
                   q, k, v, do, lse, delta, **kw)}
        plain_fwd = time_ms(lambda: attention_fwd_ref(q, k, v, **kw), flush, reps=3)
        plain_bwd = time_ms(lambda: attention_bwd_ref(q, k, v, o, lse, do, **kw), flush, reps=3)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        sdpa_fwd = time_ms(lambda: sdpa(qt, kt, vt, is_causal=True), flush)
        sdpa_bwd = sdpa_backward_ms(q, k, v, do, flush)
        for name, (flops, nbytes) in work.items():
            peak = peak_flops(name)
            b_ms, b_by = bound(flops, nbytes, peak)
            ms = time_ms(fns[name], flush)
            log(f"  {name} at {tag}: kernel {ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}"
                f"{f32_fma_bound(flops, nbytes, peak)}); {flops / ms / 1e9:.1f} TFLOP/s of "
                f"the function's work achieved")
        log(f"  at {tag}: plain forward {plain_fwd:.4f} ms, plain backward (all of dq, dk, dv) "
            f"{plain_bwd:.4f} ms; SDPA forward {sdpa_fwd:.4f} ms, backward (fwd + bwd minus "
            f"fwd) {sdpa_bwd:.4f} ms")
        del q, k, v, do, o, lse, delta, qt, kt, vt
        torch.cuda.empty_cache()

    # paged decode at 8 lanes, both dtypes
    lens = [2048] + np.random.RandomState(1).randint(1, 2049, 7).tolist()
    n_tok = sum(lens)
    n_pages = sum(-(-n // 16) for n in lens)
    for dtype, t in ((torch.bfloat16, PAGED_MAIN_BF16_TOL), (torch.float32, F32_TOL)):
        args = _paged_inputs(gen, 8, H, KVH, hd, 16, 128, lens, dtype, seed=1)
        vr = variant(dtype, False)
        name = f"paged 8 lanes H{H}/{KVH} hd{hd} ps16 lens{lens} {str(dtype)[6:]}"
        out = paged.paged_attention(*args)
        errs[f"paged_attention_{vr}"] = max(errs[f"paged_attention_{vr}"], hold(
            name, out, paged_attention_ref(*args), t))
        same = torch.equal(out, paged.paged_attention(*args))
        log(f"  {name}: two calls give the same bits: {same}")
        if not same:
            raise AssertionError("the paged kernel gave different bits at hd 256")
        el = args[0].element_size()
        flops, nbytes = paged_ops.cost(8, H, KVH, hd, n_tok, n_pages, el=el)
        b_ms, b_by = bound(flops, nbytes, PEAK_BF16_FLOPS if el == 2 else PEAK_F32_FLOPS)
        ms = time_ms(lambda: paged.paged_attention(*args), flush)
        plain_ms = time_ms(lambda: paged_attention_ref(*args), flush)
        log(f"  paged_attention_{vr} at {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"bound {b_ms:.4f} ms ({b_by}); {nbytes / ms / 1e6:.1f} GB/s achieved")
    return errs

# ---------------------------------------------------------------------------
# phase 11: the dense variants (qwen1.5-32b int8, qwen1.5-4b, internvl2-26b)
# ---------------------------------------------------------------------------

# qwen1.5-32b through the engine with the int8 pool: 768 live pages + the
# trash page (8.19 GB in int8; the same pool in bf16, 16.13 GB, does not
# fit beside the 70.39 GB of bf16 weights); the bf16 comparison run serves
# the first 2 requests in 256 + 1 pages (5.39 GB)
INT8_PAGES, BF16_CMP_LANES, BF16_CMP_PAGES = 769, 2, 257
# the reference's int8 rule (tests/test_serving_extras.py): top-1 equal, or
# the logits correlate above this
INT8_MIN_CORR = 0.98
# internvl2-26b: 4 prompts of 2048 text tokens after its 1025 patch rows
VLM_B, VLM_S, VLM_NEW = 4, 2048, 32


def _free_cuda() -> None:
    gc.collect()
    torch.cuda.empty_cache()


def _recorded(eng, rids, out: dict, force: dict = None):
    """Wrap ``eng``'s decode step: keep each step's logits (f32, on the
    host) of the lanes that hold ``rids`` in ``out[rid]``; with ``force``
    (rid -> token stream), make the engine feed those tokens instead of
    its own greedy picks (teacher forcing; the kept logits are the real
    ones)."""
    step = eng._decode

    def decode(params, cache, tokens, seq_lens, table):
        logits, cache = step(params, cache, tokens, seq_lens, table)
        lanes = {lane.rid: i for i, lane in enumerate(eng._lanes)
                 if lane is not None and lane.rid in rids}
        if force is not None:
            logits = logits.clone()
        for rid, i in lanes.items():
            out.setdefault(rid, []).append(logits[i, -1].float().cpu())
            if force is not None:
                tok = force[rid][len(out[rid])]
                logits[i, -1, tok] = torch.finfo(logits.dtype).max
        return logits, cache

    eng._decode = decode


def scoped_equals_whole_pool(cfg, params, pool_layer) -> None:
    """On one layer of the int8 pool at this shape (8 lanes, up to 2048
    positions, the pool's own pages): ``decode_attention_paged`` attends
    through the int8 kernel, whose output equals the bf16 kernel's on the
    whole pool dequantized, bit for bit, and is within PAGED_MAIN_BF16_TOL
    of the plain gather path; that path's scoped dequantization gives the
    bits that dequantizing the WHOLE pool before the same gather and masked
    attention gives (the reference's tests/test_serve_engine.py property).
    Then the int8 kernel, the plain attend and the bf16 kernel on the
    dequantized pool are timed here."""
    from repro_torch.kernels.paged_attention import kernel
    from repro_torch.kernels.paged_attention import ops as paged_ops
    from repro_torch.kernels.paged_attention.ref import (paged_attention_int8_ref,
                                                         paged_attention_ref)
    from repro_torch.models import common, layers

    gen = torch.Generator(device="cuda").manual_seed(5)
    rng = np.random.RandomState(5)
    c = {k: v.clone() for k, v in pool_layer.items()}
    P, ps, KVH, hd = c["k_pages"].shape
    mb = 128
    # 8 lanes on distinct pages of the pool's 768: one at 2047 cached
    # tokens, seven shorter
    lens = torch.as_tensor([2047] + rng.randint(1, 1500, 7).tolist(), dtype=torch.int32,
                           device="cuda")
    assert (lens + 1).tolist() == phase11_lens()
    table = np.full((8, mb), -1, np.int32)
    perm, at = rng.permutation(P - 1), 0
    for b, n in enumerate(lens.tolist()):
        used = -(-(n + 1) // ps)
        table[b, :used] = perm[at:at + used]
        at += used
    table = torch.as_tensor(table, device="cuda")
    x = torch.randn((8, 1, cfg.d_model), generator=gen, device="cuda").to(torch.bfloat16)
    p = {k: v[0] for k, v in params["blocks"]["attn"].items()}
    y_kernel = layers.decode_attention_paged(p, c, x, lens, table, cfg)
    q, _, _ = layers._project_qkv(p, x, x, cfg)
    q = layers.rope(q, lens[:, None].float(), cfg.rope_theta)[:, 0]
    out = lambda att: common.dense(att.reshape(8, 1, cfg.q_dim), p["wo"], cfg.dtype)
    i8 = (q, c["k_pages"], c["v_pages"], c["k_scale"], c["v_scale"], table, lens + 1)
    att_kernel = kernel.paged_attention_int8(*i8)
    att_scoped = paged_attention_int8_ref(*i8)
    full_k = layers._dequantize_kv(c["k_pages"], c["k_scale"], x.dtype)
    full_v = layers._dequantize_kv(c["v_pages"], c["v_scale"], x.dtype)
    tbl = torch.clamp(table, min=0).long()
    kg = full_k[tbl].reshape(8, mb * ps, KVH, hd)
    vg = full_v[tbl].reshape(8, mb * ps, KVH, hd)
    mask = (torch.arange(mb * ps, device="cuda")[None, :] < (lens + 1)[:, None])[:, None, :]
    att = layers._sdpa(q.reshape(8, 1, KVH, -1, hd), kg, vg, mask, float(hd ** -0.5))
    del kg, vg
    wired = torch.equal(y_kernel, out(att_kernel))
    same = torch.equal(out(att_scoped), out(att))
    deq = (q, full_k, full_v, table, lens + 1)
    as_row2 = torch.equal(att_kernel, kernel.paged_attention(*deq))
    log(f"[dense_int8] one layer at 8 lanes x up to {mb * ps} positions, H{KVH}: the layer "
        f"went through the int8 kernel: {wired}; its attention = the bf16 kernel's on the "
        f"dequantized pool, bit for bit: {as_row2}; the plain path's scoped dequantization "
        f"equals the whole pool's, bit for bit: {same}")
    hold("[dense_int8] the int8 kernel vs paged_attention_ref on the dequantized pool",
         att_kernel, paged_attention_ref(*deq), PAGED_MAIN_BF16_TOL)
    hold("[dense_int8] the int8 kernel vs the plain gather path", att_kernel, att_scoped,
         tol(torch.bfloat16))
    hold_no_farther("[dense_int8] the int8 kernel", att_kernel, att_scoped, paged_attention_ref(
        q.float(), full_k.float(), full_v.float(), table, lens + 1))
    if not (wired and same and as_row2):
        raise AssertionError("the int8 layer did not go through the kernel, the kernel differs "
                             "from the bf16 kernel on the dequantized pool, or the scoped "
                             "dequantization differs from the whole pool's")
    # the attend alone at this shape, 64 times a step: the int8 kernel, the
    # plain gather path it replaces, the bf16 kernel on the dequantized pool
    n_tok = int((lens + 1).sum())
    n_pages = sum(-(-n // ps) for n in (lens + 1).tolist())
    el = q.element_size()
    b_ms, b_by = bound(*paged_ops.int8_cost(8, cfg.num_heads, KVH, hd, n_tok, n_pages, el=el),
                       PEAK_BF16_FLOPS)
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    times = time_each(lambda: kernel.paged_attention_int8(*i8), flush, reps=20)
    ms = sum(times) / len(times)
    row2_ms = time_ms(lambda: kernel.paged_attention(q, full_k, full_v, table, lens + 1), flush,
                      reps=20)
    plain_ms = time_ms(lambda: paged_attention_int8_ref(*i8), flush)
    log(f"[dense_int8] the int8 paged attend (one layer, {n_tok} cached tokens): kernel "
        f"{ms:.4f} ms ({fmt_spread(times)}), plain {plain_ms:.4f} ms, the bf16 kernel on the "
        f"dequantized pool {row2_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}); x {cfg.num_layers} "
        f"layers = {ms * cfg.num_layers:.2f} ms a decode step (plain "
        f"{plain_ms * cfg.num_layers:.2f})")


def profile_int8_decode(eng, params) -> None:
    """Where a decode step of the int8 pool goes: 8 lanes admitted with
    1000-token prompts, two steps, then three under torch.profiler (after
    the path's launches are read)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serve import Request

    rng = np.random.RandomState(3)
    for i in range(8):
        eng.submit(Request(rid=100 + i, max_new_tokens=8, prompt=rng.randint(
            0, eng.model.cfg.vocab_size, 1000).astype(np.int32)))
    eng.step(params)                                  # admits all 8 lanes, first decode
    eng.step(params)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(3):
            eng.step(params)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    log(f"[dense_int8] three decode steps of the int8 pool, 8 lanes x ~1000 cached tokens:\n"
        f"{_device_breakdown(prof, wall)}")
    eng.run(params)                                   # drain the 8 lanes


def dense_int8_full_width() -> dict:
    """qwen1.5-32b at full width and depth (64 layers, 35.2 B params in
    bf16) through ``DecodeEngine`` with the int8 pool, on phase 4's
    requests; then its first 2 requests through a bf16 pool, teacher-forced
    on the int8 streams, held by the reference's rule. Returns launches by
    path: ``dense_int8`` and ``dense_bf16``."""
    from repro_torch.config import ShardingLayout, get_arch
    from repro_torch.models import build_model, common
    from repro_torch.serve import DecodeEngine

    total = torch.cuda.get_device_properties(0).total_memory
    cfg = get_arch("qwen1.5-32b")
    model = build_model(cfg)
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = model.init(gen, "cuda", torch.bfloat16)
    draw_biases(params, gen)
    torch.cuda.synchronize()
    _free_cuda()                        # the f32 draws' blocks, before the pool
    weights = sum(t.numel() * t.element_size() for t in common.tree_leaves(params))
    free, _ = torch.cuda.mem_get_info()
    int8_pool = common.param_bytes(model.paged_cache_specs(INT8_PAGES, int8=True))
    bf16_pool = common.param_bytes(model.paged_cache_specs(INT8_PAGES))
    log(f"[dense_int8] {cfg.name}: {cfg.num_layers} of {cfg.num_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} heads, d_ff {cfg.d_ff}, qkv bias; "
        f"{model.param_count() / 1e9:.3f} B params, {weights / 1e9:.2f} GB on the card, made "
        f"in {time.perf_counter() - t0:.1f} s; total_memory {total} B ({total / 2**30:.2f} "
        f"GiB), free after the weights {free / 1e9:.2f} GB")
    log(f"[dense_int8] a pool of {INT8_PAGES} pages x 16: int8 {int8_pool} B "
        f"({int8_pool / 1e9:.2f} GB), bf16 {bf16_pool} B ({bf16_pool / 1e9:.2f} GB); weights + "
        f"int8 pool {(weights + int8_pool) / 2**30:.2f} GiB, weights + bf16 pool "
        f"{(weights + bf16_pool) / 2**30:.2f} GiB, of {total / 2**30:.2f} GiB")
    if not (weights + bf16_pool > total and weights + int8_pool <= total):
        raise AssertionError("the bf16 pool would fit, or the int8 pool would not")

    reqs = phase4_requests(cfg)
    eng = DecodeEngine(model, ShardingLayout(attn_impl="flash", int8_kv_cache=True), "cuda",
                       lanes=8, num_pages=INT8_PAGES, max_context=2048)
    if eng.pool_bytes != int8_pool:
        raise AssertionError(f"engine pool {eng.pool_bytes} B != the specs' {int8_pool} B")
    logits8: dict = {}
    _recorded(eng, (0, 1), logits8)
    for r in reqs:
        eng.submit(r)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    done = {c.rid: c.tokens for c in eng.run(params)}
    wall = time.perf_counter() - t0
    launches = read_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    want = expect_launches(flash_attention_tc=cfg.num_layers * eng.prefills,
                           paged_attention_int8_tc=cfg.num_layers * eng.decode_steps)
    log(f"[dense_int8] {len(done)} requests x 32 tokens in {wall:.2f} s; {eng.prefills} "
        f"prefills, {eng.decode_steps} decode steps; launches {launches}, expected {want}")
    if sorted(done) != list(range(len(reqs))) or not all(
            len(t) == 32 and all(0 <= x < cfg.vocab_size for x in t) for t in done.values()):
        raise AssertionError("a request did not get 32 tokens in the vocabulary")
    if eng.free_pages != INT8_PAGES - 1 or launches != want:
        raise AssertionError("the pool did not drain, or the int8 path launched other kernels")
    log(f"[dense_int8] prefill {eng.prefilled_tokens / eng.prefill_seconds:.1f} tokens/s "
        f"({eng.prefilled_tokens} tokens in {eng.prefill_seconds:.3f} s); decode "
        f"{eng.measured_tokens_per_sec:.1f} tokens/s, "
        f"{1e3 * eng.decode_seconds / eng.decode_steps:.2f} ms per step (bound "
        f"{weights / PEAK_BYTES * 1e3:.2f} ms: the weights read once); peak memory "
        f"{peak_gb:.2f} GB ({torch.cuda.max_memory_allocated() / 2**30:.2f} GiB)")
    profile_int8_decode(eng, params)
    scoped_equals_whole_pool(cfg, params, {k: v[0] for k, v in eng.cache["blocks"].items()})
    del eng
    _free_cuda()

    # the first 2 requests through a bf16 pool, fed the int8 run's tokens
    eng = DecodeEngine(model, ShardingLayout(attn_impl="flash"), "cuda", lanes=BF16_CMP_LANES,
                       num_pages=BF16_CMP_PAGES, max_context=2048)
    logits16: dict = {}
    _recorded(eng, (0, 1), logits16, force=done)
    for r in reqs[:2]:
        eng.submit(r)
    reset_launches()
    forced = {c.rid: c.tokens for c in eng.run(params)}
    cmp_launches = read_launches()
    want = expect_launches(flash_attention_tc=cfg.num_layers * eng.prefills,
                           paged_attention_tc=cfg.num_layers * eng.decode_steps)
    log(f"[dense_bf16] {BF16_CMP_LANES} requests through a bf16 pool of {BF16_CMP_PAGES} "
        f"pages ({eng.pool_bytes / 1e9:.2f} GB), {eng.decode_steps} decode steps; launches "
        f"{cmp_launches}, expected {want}")
    if cmp_launches != want or forced != {r: done[r] for r in (0, 1)}:
        raise AssertionError("the bf16 comparison run did not go through the kernels, or was "
                             "not fed the int8 streams")
    rows = []
    for rid in (0, 1):
        for i, (a, b) in enumerate(zip(logits8[rid], logits16[rid])):
            same = int(a.argmax()) == int(b.argmax())
            c = float(torch.corrcoef(torch.stack([a, b]))[0, 1])
            rows.append((rid, i + 1, same, c))
            if not (same or c > INT8_MIN_CORR):
                raise AssertionError(f"request {rid} step {i + 1}: int8 top-1 differs and the "
                                     f"logits correlate {c} <= {INT8_MIN_CORR}")
    log(f"[dense_bf16] int8 vs bf16 pool on the same tokens, {len(rows)} decode steps of "
        f"requests 0 and 1 (and their first tokens, from the same prefill): top-1 equal at "
        f"{sum(r[2] for r in rows)}; correlation {min(r[3] for r in rows):.6f} to "
        f"{max(r[3] for r in rows):.6f}")
    del eng, params
    _free_cuda()
    return {"dense_int8": launches, "dense_bf16": cmp_launches}


def triangular_reduced_matches_cpu() -> dict:
    """Reduced f32 qwen1.5-4b prefill logits with ``attn_impl="triangular"``
    (chunks of 8 over a 40-token prompt), card against CPU; then 3 training
    steps (``train_reduced_matches_cpu``). Returns the card's launches."""
    from repro_torch.config import get_arch
    from repro_torch.models import RunOpts, build_model
    from repro_torch.models.common import tree_map

    cfg = dataclasses.replace(get_arch("qwen1.5-4b").reduced(), dtype="float32")
    model = build_model(cfg)
    gen = torch.Generator().manual_seed(0)
    params = model.init(gen, "cpu")
    draw_biases(params, gen)
    tokens = torch.as_tensor(np.random.RandomState(0).randint(0, cfg.vocab_size, (2, 40))
                             .astype(np.int32))
    opts = RunOpts(attn_impl="triangular", q_chunk=8, kv_chunk=8)
    reset_launches()
    card, _ = model.prefill(tree_map(lambda t: t.to("cuda"), params),
                            {"tokens": tokens.to("cuda")}, 48, opts)
    cpu, _ = model.prefill(params, {"tokens": tokens}, 48, opts)
    err = float((card.cpu() - cpu).abs().max())
    log(f"[dense_q4_tri] reduced f32 triangular prefill logits, card vs CPU: max abs diff "
        f"{err:.3e} (atol {REDUCED_LOGITS_TOL['atol']}, rtol {REDUCED_LOGITS_TOL['rtol']})")
    if not torch.allclose(card.cpu(), cpu, **REDUCED_LOGITS_TOL) or read_launches() != \
            expect_launches():
        raise AssertionError("the triangular prefill differs from the CPU's, or launched a "
                             "kernel")
    return train_reduced_matches_cpu("qwen1.5-4b", "dense_q4_tri", 3, attn_impl="triangular")


def dense_vlm_full_width() -> dict:
    """internvl2-26b at full width and depth (48 layers, bf16) through the
    serve launcher's loop: 4 prompts of 2048 text tokens after 1025 patch
    rows (the flash kernel sees S=3073), 32 new tokens; the dense ring
    cache decodes in plain PyTorch, as the reference does."""
    from repro_torch.config import get_arch
    from repro_torch.launch.serve import greedy_serve
    from repro_torch.models import RunOpts, build_model, common

    cfg = get_arch("internvl2-26b")
    model = build_model(cfg)
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = model.init(gen, "cuda", torch.bfloat16)
    patches = torch.randn((VLM_B, cfg.vision_tokens, cfg.vision_width), generator=gen,
                          device="cuda").to(torch.bfloat16)
    torch.cuda.synchronize()
    gb = sum(t.numel() * t.element_size() for t in common.tree_leaves(params)) / 1e9
    log(f"[dense_vlm] {cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.num_heads}/{cfg.num_kv_heads} heads, {cfg.vision_tokens} patch rows of width "
        f"{cfg.vision_width}; {model.param_count() / 1e9:.3f} B params, {gb:.2f} GB on the "
        f"card, made in {time.perf_counter() - t0:.1f} s")
    prompts = np.random.RandomState(0).randint(0, cfg.vocab_size, (VLM_B, VLM_S)).astype(np.int32)
    tokens = torch.as_tensor(prompts, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    res = greedy_serve(model, params, tokens, VLM_NEW, patches=patches)
    launches = read_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    want = expect_launches(flash_attention_tc=cfg.num_layers)
    out = res.tokens
    S_all = cfg.vision_tokens + VLM_S
    log(f"[dense_vlm] {VLM_B} prompts x ({cfg.vision_tokens} patch rows + {VLM_S} tokens), "
        f"{VLM_NEW} new tokens; first row {out[0].tolist()}; launches {launches}, expected "
        f"{want}")
    if tuple(out.shape) != (VLM_B, VLM_NEW) or not bool(((out >= 0) & (out < cfg.vocab_size))
                                                        .all()):
        raise AssertionError("generated tokens outside the vocabulary")
    if not all(bool(torch.isfinite(lg.float()).all()) for lg in res.logits) or launches != want:
        raise AssertionError("non-finite logits, or the VLM path did not launch as expected")
    log(f"[dense_vlm] prefill {VLM_B * S_all / res.prefill_seconds:.1f} rows/s ({VLM_B} x "
        f"{S_all} in {res.prefill_seconds:.3f} s); decode "
        f"{1e3 * res.decode_seconds / res.decode_steps:.2f} ms per step "
        f"({VLM_B * res.decode_steps / res.decode_seconds:.1f} tokens/s); peak memory "
        f"{peak_gb:.2f} GB")
    pos = res.cache["blocks"]["pos_ids"][0].cpu()
    n = S_all + VLM_NEW - 1
    hole_free = torch.equal(pos[:n], torch.arange(n, dtype=pos.dtype)) and bool((pos[n:] == -1)
                                                                                .all())
    log(f"[dense_vlm] pos_ids after decode: 0..{n - 1} without a hole, the rest empty: "
        f"{hole_free}")
    if not hole_free:
        raise AssertionError("the VLM cache's positions have a hole (a missing decode offset?)")

    # flash prefill against the masked path on the first prompt
    row = {"tokens": tokens[:1], "patches": patches[:1]}
    flash, _ = model.prefill(params, row, VLM_S, RunOpts(attn_impl="flash"))
    masked, _ = model.prefill(params, row, VLM_S, RunOpts(attn_impl="masked"))
    a, b = flash[0, -1].float(), masked[0, -1].float()
    corr = float(torch.corrcoef(torch.stack([a, b]))[0, 1])
    top_eq = int(a.argmax()) == int(b.argmax())
    log(f"[dense_vlm] flash vs masked prefill logits (S={S_all}): top-1 equal {top_eq}, "
        f"correlation {corr:.6f}, max abs diff {float((a - b).abs().max()):.4f}")
    if not (torch.isfinite(a).all() and top_eq and corr > 0.99):
        raise AssertionError("the VLM's flash prefill disagrees with the masked path")
    del flash, masked

    # the last decode step against a fresh prefill over patches, prompt and the 31 fed tokens
    grown = torch.cat([tokens, out[:, :VLM_NEW - 1].to("cuda")], dim=1)
    fresh, _ = model.prefill(params, {"tokens": grown, "patches": patches}, VLM_S + VLM_NEW,
                             RunOpts(attn_impl="flash"))
    dec, fwd = res.logits[-1].float(), fresh[:, -1].float()
    rows = []
    for r in range(VLM_B):
        pick = int(dec[r].argmax())
        tie, gap, allowed = _near_tie(fwd[r], pick)
        c = float(torch.corrcoef(torch.stack([dec[r], fwd[r]]))[0, 1])
        same = pick == int(fwd[r].argmax())
        rows.append((r, same, round(gap, 5), round(allowed, 5), round(c, 6)))
        if not (same or (tie and c > ENGINE_MIN_CORR)):
            raise AssertionError(f"dense_vlm row {r}: decode's top-1 {pick} is not the fresh "
                                 f"prefill's nor a near-tie (gap {gap}, allowed {allowed}, "
                                 f"correlation {c})")
    log(f"[dense_vlm] last decode step vs a fresh prefill of {S_all + VLM_NEW - 1} rows, by row "
        f"(row, top-1 equal, gap, allowed, correlation): {rows}")
    del fresh, res, params
    _free_cuda()
    return launches


def dense_variants_phase() -> dict:
    """Phase 11: qwen1.5-32b with the int8 pool (and its bf16 comparison),
    qwen1.5-4b training and serving, internvl2-26b serving, each at full
    width and depth, and their reduced f32 runs against the CPU; the
    triangular schedule, reduced, card against CPU. Returns launches by
    path."""
    log(f"[dense] total_memory {torch.cuda.get_device_properties(0).total_memory} B")
    _free_cuda()
    paths = dense_int8_full_width()
    paths["dense_int8_f32"] = serve_reduced_matches_cpu("qwen1.5-32b", True, "dense_int8")
    _free_cuda()
    paths["dense_q4_train"] = train_full_width("qwen1.5-4b", "dense_q4_train")
    _free_cuda()
    paths["dense_q4_train_f32"] = train_reduced_matches_cpu("qwen1.5-4b", "dense_q4_train", 3)
    paths["dense_q4_tri"] = triangular_reduced_matches_cpu()
    paths["dense_q4_serve"] = serve_full_width("qwen1.5-4b", "dense_q4_serve")
    _free_cuda()
    paths["dense_q4_serve_f32"] = serve_reduced_matches_cpu("qwen1.5-4b", False,
                                                            "dense_q4_serve")
    paths["dense_vlm"] = dense_vlm_full_width()
    paths["dense_vlm_f32"] = greedy_reduced_matches_cpu("internvl2-26b", "dense_vlm",
                                                        "flash_attention_tf32")
    return paths


# ---------------------------------------------------------------------------
# phase 12: gemma-7b (head dim 256, GeGLU, tied and scaled embeddings)
# ---------------------------------------------------------------------------

# gemma-7b trained at full width with GEMMA_TRAIN_LAYERS of its 28 layers:
# f32 params, grads and AdamW moments are 16 B a param, 12.58 GB for the
# tied embedding and 4.43 GB a layer, so all 28 (136.6 GB) do not fit. 10
# layers peaked at 67.09 GB on an H100 (80 GB HBM3, 700 W); 12 add 8.86 GB
# of state, ~76 GB of the card's 85.0, as qwen3-4b's full depth (75.5 GB)
GEMMA_TRAIN_LAYERS = 12
def gemma_phase() -> dict:
    """Phase 12: gemma-7b served at full width and depth through the engine,
    trained at full width with GEMMA_TRAIN_LAYERS layers, and its reduced
    f32 serving and training (head dim 256) against the CPU. Returns
    launches by path."""
    _free_cuda()
    paths = {"gemma": serve_full_width("gemma-7b", "gemma")}
    _free_cuda()
    paths["gemma_f32"] = serve_reduced_matches_cpu("gemma-7b", False, "gemma")
    paths["gemma_train"] = train_full_width("gemma-7b", "gemma_train", GEMMA_TRAIN_LAYERS)
    _free_cuda()
    paths["gemma_train_f32"] = train_reduced_matches_cpu("gemma-7b", "gemma_train", 3)
    return paths


# ---------------------------------------------------------------------------
# phase 3 at this slice's shapes: whisper-tiny's and hymba-1.5b's training
# attention (run again under --whisper-only and --hybrid-train-only)
# ---------------------------------------------------------------------------

# (name, B, S, H, KVH, hd, window, dtype, backward): whisper's decoder
# prefill (B16 S64) and training microbatch (4 rows of 448), G=1 hd 64;
# hymba's training microbatch (B1 S4096 H25/5, G=5, window 1024); the f32
# variants (the reduced runs' route) at whisper's training shape and at G=5
# under the window at S=1500; internvl2-26b's training microbatch in both
# dtypes
SLICE14_ATTN = [
    ("whisper prefill", 16, 64, 6, 6, 64, 0, torch.bfloat16, False),
    ("whisper training", 4, 448, 6, 6, 64, 0, torch.bfloat16, True),
    ("hymba training", 1, 4096, 25, 5, 64, 1024, torch.bfloat16, True),
    ("whisper training", 4, 448, 6, 6, 64, 0, torch.float32, True),
    ("hymba training", 1, 1500, 25, 5, 64, 1024, torch.float32, True),
    # internvl2-26b's training microbatch (phase 17): 1025 patch rows + 2048
    # tokens, G=6 hd 128; the last 64-row tile of the backward holds one row
    ("internvl2 training", 1, 3073, 48, 8, 128, 0, torch.bfloat16, True),
    ("internvl2 training", 1, 3073, 48, 8, 128, 0, torch.float32, True),
]


def check_slice14_attention(gen: torch.Generator, flush: torch.Tensor, which: str = "") -> dict:
    """The flash forward, dk/dv and dq kernels at SLICE14_ATTN's shapes
    (those whose name starts with ``which``) against their plain versions,
    which run one kv head's group of query heads at a time; the bf16 dq at
    G=5 gives the same bits twice; each kernel's time beside its bound, the
    plain versions' and SDPA's (the band as a boolean mask under a window).
    Returns the largest errors, by record name."""
    from repro_torch.kernels.flash_attention import kernel, kernel_bwd
    from repro_torch.kernels.flash_attention.ref import _mask, attention_bwd_ref, attention_fwd_ref

    errs: dict = {}
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for name, B, S, H, KVH, hd, window, dtype, backward in SLICE14_ATTN:
        if not name.startswith(which):
            continue
        G = H // KVH
        vr = vb = "tc" if dtype == torch.bfloat16 else "tf32"
        tag = f"{name} B{B} S{S} H{H}/{KVH} hd{hd} w{window} {str(dtype)[6:]}"
        log(f"[kernels] flash at {tag} vs the plain versions, one kv group at a time")
        mk = lambda heads: torch.randn((B, S, heads, hd), generator=gen, device="cuda").to(dtype)
        q, k, v, do = mk(H), mk(KVH), mk(KVH), mk(H)
        kw = dict(causal=True, window=window, q_offset=0)
        t_fwd = FLASH_MAIN_BF16_TOL if dtype == torch.bfloat16 else F32_TOL
        t_bwd = FLASH_BWD_MAIN_BF16_TOL if dtype == torch.bfloat16 else FLASH_BWD_F32_TOL
        o, lse = kernel.flash_attention_fwd(q, k, v, **kw)
        if backward:
            delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
            dk, dv = kernel_bwd.flash_attention_bwd_dkdv(q, k, v, do, lse, delta, **kw)
            dq = kernel_bwd.flash_attention_bwd_dq(q, k, v, do, lse, delta, **kw)
        torch.cuda.synchronize()
        put = lambda key, e: errs.__setitem__(key, max(errs.get(key, 0.0), e))
        for g in range(KVH):
            hs, ks = slice(g * G, (g + 1) * G), slice(g, g + 1)
            gt = f"{tag} kv group {g}"
            ro, rlse = attention_fwd_ref(q[:, :, hs], k[:, :, ks], v[:, :, ks], **kw)
            put(f"flash_attention_{vr}", hold(gt, o[:, :, hs], ro, t_fwd))
            hold(f"{gt} lse", lse[:, hs], rlse, LSE_TOL)
            del ro, rlse
            if backward:
                rq, rk, rv = attention_bwd_ref(q[:, :, hs], k[:, :, ks], v[:, :, ks],
                                               o[:, :, hs], lse[:, hs], do[:, :, hs], **kw)
                put(f"flash_attention_bwd_dkdv_{vb}",
                    max(hold(f"{gt} dk", dk[:, :, ks], rk, t_bwd),
                        hold(f"{gt} dv", dv[:, :, ks], rv, t_bwd)))
                put(f"flash_attention_bwd_dq_{vb}", hold(f"{gt} dq", dq[:, :, hs], rq, t_bwd))
                del rq, rk, rv
        if backward and dtype == torch.bfloat16 and G > 1:
            again = kernel_bwd.flash_attention_bwd_dq(q, k, v, do, lse, delta, **kw)
            same = torch.equal(dq, again)
            log(f"  {tag}: two dq calls give the same bits: {same}")
            if not same:
                raise AssertionError(f"the bf16 dq kernel gave different bits at {tag}")
            del again

        # bounds: the forward's 2 products over the live pairs; the
        # backward's 5 split as check_flash_bwd splits them
        w = flash_work(B, S, H, KVH, hd, window, el=q.element_size())
        work = {f"flash_attention_{vr}": (*w["fwd"],
                                          lambda: kernel.flash_attention_fwd(q, k, v, **kw))}
        if backward:
            work[f"flash_attention_bwd_dkdv_{vb}"] = (
                *w["dkdv"],
                lambda: kernel_bwd.flash_attention_bwd_dkdv(q, k, v, do, lse, delta, **kw))
            work[f"flash_attention_bwd_dq_{vb}"] = (
                *w["dq"],
                lambda: kernel_bwd.flash_attention_bwd_dq(q, k, v, do, lse, delta, **kw))
        for rec, (flops, nbytes, fn) in work.items():
            peak = peak_flops(rec)
            b_ms, b_by = bound(flops, nbytes, peak)
            ms = time_ms(fn, flush)
            log(f"  {rec} at {tag}: kernel {ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}"
                f"{f32_fma_bound(flops, nbytes, peak)}); {flops / ms / 1e9:.1f} TFLOP/s of "
                f"the function's work achieved")
        plain_fwd = time_ms(lambda: attention_fwd_ref(q, k, v, **kw), flush, reps=2, warmup=1)
        mask = _mask(S, S, True, window, 0, q.device) if window else None
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        lib_kw = dict(attn_mask=mask) if window else dict(is_causal=True)
        sdpa_fwd = time_ms(lambda: sdpa(qt, kt, vt, enable_gqa=True, **lib_kw), flush)
        line = (f"  at {tag}: plain forward {plain_fwd:.4f} ms, SDPA forward {sdpa_fwd:.4f} ms"
                f"{' (the band as a boolean mask)' if window else ''}")
        if backward:
            plain_bwd = time_ms(lambda: attention_bwd_ref(q, k, v, o, lse, do, **kw), flush,
                                reps=2, warmup=1)
            line += (f"; plain backward (all of dq, dk, dv) {plain_bwd:.4f} ms, SDPA backward "
                     f"(fwd + bwd minus fwd) {sdpa_backward_ms(q, k, v, do, flush, mask):.4f} ms")
            del dk, dv, dq, delta
        log(line)
        del q, k, v, do, o, lse, qt, kt, vt, mask
        torch.cuda.empty_cache()
    log(f"  largest errors at this slice's attention shapes: {errs}")
    return errs


# ---------------------------------------------------------------------------
# phase 13: whisper-tiny (LayerNorm, the biased GELU MLP, the encoder,
# cross-attention, the memory cache)
# ---------------------------------------------------------------------------

# serving: 16 rows of 1500 frames, 64-token prompts, 128 new tokens (192
# decoder positions, inside whisper's 448-token context); training: 8 rows
# of 448 tokens with their frames, 2 microbatches
WHISPER_SERVE = dict(B=16, S=64, new=128)
WHISPER_TRAIN = dict(B=8, S=448, steps=4)


def draw_off_defaults(params, gen: torch.Generator) -> None:
    """Overwrite, in place, every bias (``bias``, ``bi``, ``bo``, ``bq``,
    ``bk``, ``bv``: zeros from ``init``, as in the reference) with N(0, 0.5)
    and every norm ``scale`` (ones) with 1 + N(0, 0.2), drawn from ``gen``,
    so that a path that skipped one could not pass unseen."""
    for key, t in params.items():
        if isinstance(t, dict):
            draw_off_defaults(t, gen)
        elif key in ("bias", "bi", "bo", "bq", "bk", "bv", "scale"):
            x = torch.randn(t.shape, generator=gen, device=t.device, dtype=torch.float32)
            t.copy_(x * 0.2 + 1.0 if key == "scale" else x * 0.5)


def _whisper_batch(cfg, B: int, S: int, gen: torch.Generator, device, seed: int = 0,
                   labels: bool = False) -> dict:
    """Prompts from RandomState(seed) (with next-token labels, never equal
    to the tokens, when asked for) and bf16 standard-normal frames from
    ``gen``: the stub frontend's embeddings."""
    rows = np.random.RandomState(seed).randint(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    out = {"tokens": torch.as_tensor(rows[:, :S], device=device),
           "frames": torch.randn((B, cfg.encoder_seq_len, cfg.d_model), generator=gen,
                                 device=device).to(torch.bfloat16)}
    if labels:
        out["labels"] = torch.as_tensor(rows[:, 1:], device=device)
    return out


def whisper_serve_full_width() -> dict:
    """whisper-tiny at full width and depth (bf16, biases and norms drawn
    off their defaults) through the serve launcher's loop; returns the
    launches."""
    from repro_torch.config import get_arch
    from repro_torch.launch.serve import greedy_serve
    from repro_torch.models import RunOpts, build_model, transformer

    cfg = get_arch("whisper-tiny")
    model = build_model(cfg)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = model.init(gen, "cuda", torch.bfloat16)
    draw_off_defaults(params, gen)
    B, S, new = WHISPER_SERVE["B"], WHISPER_SERVE["S"], WHISPER_SERVE["new"]
    batch = _whisper_batch(cfg, B, S, gen, "cuda")
    log(f"[whisper] {cfg.name}: {cfg.num_layers} decoder and {cfg.encoder_layers} encoder "
        f"layers, d_model {cfg.d_model}, {cfg.num_heads} heads x {cfg.resolved_head_dim}, "
        f"{cfg.encoder_seq_len} frames, vocab {cfg.vocab_size} tied; "
        f"{model.param_count():,} params (bf16 matrices); {B} rows x {S} prompt tokens, {new} "
        f"new tokens")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    res = greedy_serve(model, params, batch["tokens"], new, frames=batch["frames"])
    launches = read_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    want = expect_launches(flash_attention_tc=cfg.num_layers)
    log(f"[whisper] launches {launches}, expected {want}; first row {res.tokens[0, :16].tolist()}")
    if tuple(res.tokens.shape) != (B, new) or not all(
            bool(torch.isfinite(lg.float()).all()) for lg in res.logits):
        raise AssertionError("whisper serving: tokens of the wrong shape or non-finite logits")
    if launches != want:
        raise AssertionError("whisper serving did not go through the kernels as expected")
    if tuple(res.cache["memory"].shape) != (B, cfg.encoder_seq_len, cfg.d_model):
        raise AssertionError(f"memory {tuple(res.cache['memory'].shape)}")

    # the encoder alone, then the flash prefill against the masked one
    ct = torch.bfloat16
    frames = batch["frames"]
    transformer._run_encoder(params["encoder"], frames.to(ct), cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        transformer._run_encoder(params["encoder"], frames.to(ct), cfg)
    torch.cuda.synchronize()
    enc_s = (time.perf_counter() - t0) / 3
    kern, _ = model.prefill(params, batch, S + new, RunOpts(attn_impl="flash"))
    masked, _ = model.prefill(params, batch, S + new, RunOpts(attn_impl="masked"))
    a, b = kern[:, -1].float(), masked[:, -1].float()
    corr = min(float(torch.corrcoef(torch.stack([a[i], b[i]]))[0, 1]) for i in range(B))
    top_eq = bool((a.argmax(-1) == b.argmax(-1)).all())
    log(f"[whisper] flash vs masked prefill logits: top-1 equal in every row {top_eq}, smallest "
        f"correlation {corr:.6f}, max abs diff {float((a - b).abs().max()):.4f}")
    if not (top_eq and corr > 0.99):
        raise AssertionError("whisper's flash prefill disagrees with the masked one")
    log(f"[whisper] encoder {B * cfg.encoder_seq_len / enc_s:.1f} frames/s ({B} x "
        f"{cfg.encoder_seq_len} frames in {enc_s * 1e3:.2f} ms); prefill (encoder included) "
        f"{B * S / res.prefill_seconds:.1f} tokens/s ({res.prefill_seconds * 1e3:.2f} ms); decode "
        f"{1e3 * res.decode_seconds / res.decode_steps:.3f} ms a step ({res.decode_steps} steps, "
        f"{B * res.decode_steps / res.decode_seconds:.1f} tokens/s); peak memory {peak_gb:.3f} GB")
    profile_greedy("whisper", model, params, batch["tokens"], res.cache, new,
                   frames=batch["frames"])
    return launches


def whisper_train_full_width() -> dict:
    """whisper-tiny at full width and depth, f32 params (biases and norms
    drawn off their defaults) + AdamW, 8 rows of 448 tokens with their
    frames in 2 microbatches, ``remat="full"``, through ``build_train_step``
    for 4 steps (``run_segment`` refuses an encoder-decoder: the data path
    makes no frames). Returns the launches."""
    from repro_torch.config import ShardingLayout, TrainConfig, get_arch
    from repro_torch.models import build_model
    from repro_torch.train.steps import build_train_step, init_train_state

    cfg = get_arch("whisper-tiny")
    model = build_model(cfg)
    B, S, n_steps = WHISPER_TRAIN["B"], WHISPER_TRAIN["S"], WHISPER_TRAIN["steps"]
    tc = TrainConfig(total_steps=n_steps, warmup_steps=1, microbatches=2)
    layout = ShardingLayout(attn_impl="flash")
    gen = torch.Generator(device="cuda").manual_seed(0)
    state = init_train_state(model, gen, "cuda")
    draw_off_defaults(state.params, gen)
    step_fn = build_train_step(model, tc, layout)
    probe = lambda st: [t.detach().clone() for t in (
        st.params["embed"][:4, :8], st.params["encoder"]["blocks"]["mlp"]["bo"][0, :8],
        st.params["blocks"]["cross"]["wq"][0, :8, :4], st.params["blocks"]["ln_cross"]["bias"][0, :8])]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = probe(state)
    reset_launches()
    metrics, secs = [], []
    for i in range(n_steps):
        batch = _whisper_batch(cfg, B, S, gen, "cuda", seed=100 + i, labels=True)
        t0 = time.perf_counter()
        state, m = step_fn(state, batch)
        metrics.append({k: float(v) for k, v in m.items()})   # the device sync
        secs.append(time.perf_counter() - t0)
        if i == 0 and not all(torch.equal(a, b) for a, b in zip(before, probe(state))):
            raise AssertionError("whisper params moved at step 0, where the learning rate is 0")
    launches = read_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    moved = [float((a - b).abs().max()) for a, b in zip(before, probe(state))]
    per = cfg.num_layers * tc.microbatches * n_steps
    want = expect_launches(flash_attention_tc=2 * per, flash_attention_bwd_dkdv_tc=per,
                           flash_attention_bwd_dq_tc=per)
    for i, (m, dt) in enumerate(zip(metrics, secs)):
        log(f"[whisper_train] step {i}: loss {m['loss']:.6f}, grad_norm {m['grad_norm']:.6f}, "
            f"lr {m['lr']:.3e}, {dt * 1e3:.1f} ms, {B * S / dt:.1f} tokens/s")
    log(f"[whisper_train] peak memory {peak_gb:.3f} GB; largest change of the probed params "
        f"after step 1: {max(moved):.3e}; launches {launches}, expected {want}")
    if not all(np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"]) for m in metrics):
        raise AssertionError(f"non-finite whisper training metrics: {metrics}")
    if not min(moved) > 0:
        raise AssertionError("a probed whisper param did not move after step 1")
    if launches != want:
        raise AssertionError("whisper training did not go through the kernels as expected")
    profile_training(model, step_fn, state, None, f"whisper {B} x {S} tokens with frames",
                     _whisper_batch(cfg, B, S, gen, "cuda", seed=100 + n_steps, labels=True))
    return launches


def step_reduced_matches_cpu(arch: str, tag: str, n_steps: int = 3) -> dict:
    """Reduced f32 ``arch``: ``n_steps`` of ``build_train_step`` (4 rows of
    100 tokens, 2 microbatches; whisper's with frames, biases and norms
    drawn off their defaults; a VLM's after 8 patch rows, attention biases
    drawn) on the card against the CPU: loss and grad norm rtol 1e-4,
    params atol 1e-5 but whisper's cross-attention key bias, whose
    gradient is 0 up to rounding (no RoPE: it shifts a query row's scores
    alike), held by its first moment below 1e-9 on both. Returns the
    card's launches."""
    from repro_torch.config import ShardingLayout, TrainConfig, get_arch
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_flatten
    from repro_torch.train.steps import build_train_step, init_train_state

    cfg = reduced_f32(get_arch(arch))
    model = build_model(cfg)
    tc = TrainConfig(total_steps=10, warmup_steps=2, microbatches=2)
    layout = ShardingLayout(attn_impl="flash", q_chunk=32, kv_chunk=32)
    gen = torch.Generator().manual_seed(0)
    state_cpu = init_train_state(model, gen, "cpu")
    if cfg.encoder_layers:
        draw_off_defaults(state_cpu.params, gen)
        batches = [_whisper_batch(cfg, 4, 100, gen, "cpu", seed=i, labels=True)
                   for i in range(n_steps)]
    else:
        draw_biases(state_cpu.params, gen)
        batches = [_vlm_batch(cfg, 4, 100, gen, "cpu", seed=i, dtype=torch.float32)
                   for i in range(n_steps)]
    runs = {}
    for device, state in (("cuda", _copy_state(state_cpu, "cuda")), ("cpu", state_cpu)):
        step_fn = build_train_step(model, tc, layout)
        reset_launches()
        metrics = []
        for b in batches:
            state, m = step_fn(state, {k: v.to(device) for k, v in b.items()})
            metrics.append({k: float(v) for k, v in m.items()})
        runs[device] = (metrics, state)
        if device == "cuda":
            launches = read_launches()
    (m_gpu, s_gpu), (m_cpu, s_cpu) = runs["cuda"], runs["cpu"]
    for key in ("loss", "grad_norm"):
        a, b = np.array([m[key] for m in m_gpu]), np.array([m[key] for m in m_cpu])
        log(f"[{tag}] reduced f32 {key}, card {a.tolist()} vs CPU {b.tolist()}; largest "
            f"relative difference {float(np.max(np.abs(a - b) / np.abs(b))):.3e}")
        if not np.allclose(a, b, rtol=1e-4, atol=0):
            raise AssertionError(f"reduced {arch} training {key} on the card differs from the "
                                 f"CPU's")
    cross = "cross" in s_cpu.params["blocks"]
    noise = s_cpu.params["blocks"]["cross"]["bk"] if cross else None
    err = max(float((a.cpu() - b).abs().max()) for a, b in
              zip(tree_flatten(s_gpu.params)[0], tree_flatten(s_cpu.params)[0]) if b is not noise)
    first = max(float(s.opt.m["blocks"]["cross"]["bk"].abs().max()) for s in (s_gpu, s_cpu)) \
        if cross else 0.0
    log(f"[{tag}] reduced f32 params after {n_steps} steps, card vs CPU: max abs diff {err:.3e} "
        f"(atol 1e-5)" + (f"; cross-attention bk's largest first moment {first:.3e}"
                          if cross else ""))
    if not (err <= 1e-5 and first < 1e-9):
        raise AssertionError(f"reduced {arch} training params on the card differ from the CPU's")
    return hold_f32_launches(tag, launches, "flash_attention_tf32",
                             "flash_attention_bwd_dkdv_tf32", "flash_attention_bwd_dq_tf32")


def whisper_phase() -> dict:
    """Phase 13: whisper-tiny served and trained at full width and depth,
    and its reduced f32 serving and training against the CPU. Returns
    launches by path."""
    _free_cuda()
    paths = {"whisper": whisper_serve_full_width()}
    _free_cuda()
    paths["whisper_f32"] = greedy_reduced_matches_cpu("whisper-tiny", "whisper",
                                                      "flash_attention_tf32")
    paths["whisper_train"] = whisper_train_full_width()
    _free_cuda()
    paths["whisper_train_f32"] = step_reduced_matches_cpu("whisper-tiny", "whisper_train")
    return paths


# ---------------------------------------------------------------------------
# phase 14: hymba-1.5b trained at full width and depth (the scan's backward)
# ---------------------------------------------------------------------------

def hybrid_train_phase() -> dict:
    """Phase 14: hymba-1.5b, all 32 layers, trained as phase 7 trains
    qwen3-4b (the flash kernels under the window, the scan forward keeping
    its states and the scan backward every step), then reduced f32 hymba's
    3 steps on the card against the CPU. Returns launches by path."""
    _free_cuda()
    paths = {"hybrid_train": train_full_width("hymba-1.5b", "hybrid_train")}
    _free_cuda()
    paths["hybrid_train_f32"] = train_reduced_matches_cpu("hymba-1.5b", "hybrid_train", 3)
    return paths


# ---------------------------------------------------------------------------
# phase 15: xlstm-350m trained at full width and depth (the mLSTM's backward)
# ---------------------------------------------------------------------------

# phase 15's sequence and steps (the first at learning rate 0); one more
# step at that sequence is profiled. The sLSTM runs as one forward and one
# backward kernel a layer (a step at seq 4096 took 77.5-91.5 s while it was
# a per-step loop of host-launched ops)
XLSTM_TRAIN = dict(seq=4096, batch=2, steps=3)


def _probe_xlstm(state) -> list:
    """Small slices of the embedding, an mLSTM block's wq and f32 gate
    weights, and an sLSTM block's recurrent weights, to see whether an
    update moved them."""
    p = state.params
    m, s = p["groups"]["mlstm"]["block"], p["groups"]["slstm"]["block"]
    return [t.detach().clone() for t in (p["embed"][:4, :8], m["wq"][0, 0, :8, :4],
                                         m["w_if"][-1, -1, :8], s["r_gates"][-1, :8, :4],
                                         s["w_gates"][0, :8, :4])]


def xlstm_train_full_width() -> dict:
    """xlstm-350m at full width and depth (24 layers: 4 groups of 5 mLSTM
    and 1 sLSTM), f32 params + AdamW, XLSTM_TRAIN's sequence, global batch
    2 in 2 microbatches, each group under remat, through ``run_segment`` for
    XLSTM_TRAIN's steps: finite losses, params unmoved at step 0 (learning
    rate 0) and moved after; per step and microbatch each mLSTM layer's
    tensor-core forward twice (the pass and its recompute, both keeping
    their states) and its backward once, each sLSTM layer's forward kernel
    twice (keeping) and its backward kernel once, and no other kernel; the
    step's time and spread, peak memory and, from one more profiled step,
    where the time goes."""
    from repro_torch.config import ShardingLayout, TrainConfig, get_arch
    from repro_torch.data import SyntheticLM
    from repro_torch.models import build_model, transformer
    from repro_torch.train.loop import make_step, run_segment
    from repro_torch.train.steps import init_train_state

    cfg = get_arch("xlstm-350m")
    model = build_model(cfg)
    groups, m_per, has_s = transformer._xlstm_group_layout(cfg)
    seq, batch, n_steps = XLSTM_TRAIN["seq"], XLSTM_TRAIN["batch"], XLSTM_TRAIN["steps"]
    tc = TrainConfig(total_steps=n_steps, warmup_steps=1, microbatches=2)
    layout = ShardingLayout(attn_impl="flash")
    ds = SyntheticLM(cfg.vocab_size, seq, batch, seed=0)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = init_train_state(model, torch.Generator(device="cuda").manual_seed(0), "cuda")
    torch.cuda.synchronize()
    kept = {k: state.params["groups"][blk]["block"][k].dtype
            for blk, k in (("mlstm", "w_if"), ("slstm", "w_gates"), ("slstm", "r_gates"))}
    log(f"[xlstm_train] {cfg.name}: {cfg.num_layers} layers = {groups} groups x ({m_per} "
        f"mLSTM + {has_s} sLSTM) (no depth cut), d_model {cfg.d_model}; "
        f"{model.param_count() / 1e9:.3f} B f32 params ({kept}); params + AdamW moments "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB, made on the card in "
        f"{time.perf_counter() - t0:.1f} s; seq {seq}, global batch {batch} in "
        f"{tc.microbatches} microbatches, remat {layout.remat} (per group)")

    metrics: list = []
    step_fn = _recording(make_step(model, tc, layout), metrics)
    before = _probe_xlstm(state)
    reset_launches()
    res0 = run_segment(model, state, ds, "cuda", tc, layout, num_steps=1, jitted=step_fn)
    if not all(torch.equal(a, b) for a, b in zip(before, _probe_xlstm(res0.state))):
        raise AssertionError("params moved at step 0, where the learning rate is 0")
    res1 = run_segment(model, res0.state, ds, "cuda", tc, layout, num_steps=n_steps - 1,
                       start_step=1, jitted=step_fn)
    launches = read_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    moved = [float((a - b).abs().max()) for a, b in zip(before, _probe_xlstm(res1.state))]
    per_mb = groups * m_per * tc.microbatches * n_steps
    per_s = groups * has_s * tc.microbatches * n_steps
    want = expect_launches(mlstm_tc=2 * per_mb, mlstm_bwd=per_mb, slstm=2 * per_s,
                           slstm_bwd=per_s)
    secs = res0.step_seconds + res1.step_seconds
    for i, (m, dt) in enumerate(zip(metrics, secs)):
        log(f"[xlstm_train] step {i}: loss {m['loss']:.6f}, grad_norm {m['grad_norm']:.6f}, "
            f"lr {m['lr']:.3e}, {dt * 1e3:.1f} ms, {batch * seq / dt:.1f} tokens/s")
    log(f"[xlstm_train] step time {fmt_spread([1e3 * s for s in secs])} over {n_steps} steps "
        f"(the first includes the first calls' set-up); peak memory {peak_gb:.2f} GB; largest "
        f"change of the probed params after step 1: {max(moved):.3e}; launches {launches}, "
        f"expected {want}")
    if len(metrics) != n_steps or not all(
            np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"]) for m in metrics):
        raise AssertionError(f"non-finite or missing training metrics: {metrics}")
    if not min(moved) > 0:
        raise AssertionError("a probed param did not move after step 1")
    if launches != want:
        raise AssertionError("the xLSTM training path did not go through the kernels as expected")
    profile_training(model, step_fn, res1.state, ds, f"seq {seq}")
    return launches


def slstm_wide_model_matches_cpu() -> dict:
    """Part of phase 3: xlstm-350m laid out as ``BlockKind.SLSTM`` at
    SLSTM_WIDE_MODEL's d 1152 (the sLSTM on the wide grid, 16 units a
    block), f32: its prefill logits and 16-token greedy stream on the card
    equal the CPU's (``greedy_reduced_matches_cpu``'s holds); the mLSTM runs
    the split-TF32 kernel and the step, the sLSTM its forward kernel."""
    from repro_torch.config import BlockKind, get_arch

    cfg = dataclasses.replace(get_arch("xlstm-350m"), name="xlstm-slstm-d1152",
                              block=BlockKind.SLSTM, dtype="float32", **SLSTM_WIDE_MODEL)
    log(f"[slstm_wide] {cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.num_heads} heads, block {cfg.block.value}, f32")
    return greedy_reduced_matches_cpu(cfg.name, "slstm_wide", "mlstm_tf32", "mlstm_step",
                                      "slstm", cfg=cfg)


def xlstm_train_phase() -> dict:
    """Phase 15: xlstm-350m trained at full width and depth, then reduced f32
    xlstm's 3 steps on the card (the split-TF32 forward keeping its states,
    the backward) against the CPU. Returns launches by path."""
    _free_cuda()
    paths = {"xlstm_train": xlstm_train_full_width()}
    _free_cuda()
    paths["xlstm_train_f32"] = train_reduced_matches_cpu("xlstm-350m", "xlstm_train", 3)
    return paths


# ---------------------------------------------------------------------------
# phase 16: whisper-tiny on the serve launcher's dense plans (whisper_plan)
# ---------------------------------------------------------------------------

# the three runs, as SERVE_RUNS: (counts, revoke_after, cache_policy, engine)
WHISPER_PLAN_RUNS = {"dense": ([8], 0, "drop", False),
                     "drop": ([8, 4], WHISPER_PLAN["revoke"], "drop", False),
                     "migrate": ([8, 4], WHISPER_PLAN["revoke"], "migrate", False)}


class _PlanLogits:
    """Keep, on the card, the last-position logits of every decode call of
    the launcher's dense paths inside the block (a copy each), by wrapping
    the launcher module's decode-step builder."""

    def __enter__(self):
        from repro_torch.launch import serve

        self.logits: list = []
        self._build = build = serve.build_decode_step

        def wrapped(model, layout):
            step = build(model, layout)

            def keep(params, cache, tokens, pos):
                logits, cache = step(params, cache, tokens, pos)
                self.logits.append(logits[:, -1].float().clone())
                return logits, cache
            return keep

        serve.build_decode_step = wrapped
        return self

    def __exit__(self, *exc):
        from repro_torch.launch import serve

        serve.build_decode_step = self._build


def whisper_plan_full_width() -> dict:
    """whisper-tiny at full width and depth through ``serve_plan``: f32
    params (as the plan modes hold them; biases and norms drawn off their
    defaults), phase 13's 16 prompts x 64 tokens with their frames, 128 new
    tokens, uninterrupted and revoked after 32 steps (plans 8 -> 4) under
    drop and migrate. Held: one flash forward a layer a prefill (two
    prefills under drop: the re-prefill re-runs the encoder and the
    decoder); the byte columns equal ``whisper_plan_predicted``; the
    migrate stream equals the uninterrupted one; drop's rows are equal or
    first diverge after the revocation at a near-tie (phase 9's engine
    rule). Returns the launches summed over the runs."""
    from repro_torch.config import get_arch
    from repro_torch.launch.serve import serve_plan
    from repro_torch.models import build_model

    cfg = get_arch("whisper-tiny")
    model = build_model(cfg)
    predicted = whisper_plan_predicted(model)
    w = WHISPER_PLAN
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = model.init(gen, "cuda")
    draw_off_defaults(params, gen)
    batch = _whisper_batch(cfg, w["B"], w["S"], gen, "cuda")
    prompts = batch["tokens"].cpu().numpy()
    log(f"[whisper_plan] {cfg.name} at full width and depth ({model.param_count():,} f32 params), "
        f"{w['B']} prompts x {w['S']} tokens with {cfg.encoder_seq_len} frames each, {w['new']} "
        f"new tokens, revoked after {w['revoke']} steps, plans 8 -> 4 slots on cuda:0; "
        f"predicted {predicted}")
    total = dict.fromkeys(read_launches(), 0)
    runs, logits = {}, {}
    for name, (counts, revoke, policy, _) in WHISPER_PLAN_RUNS.items():
        _free_cuda()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        with _PlanLogits() as keep:
            out = serve_plan(model, params, prompts, w["new"], counts, revoke_after=revoke,
                             cache_policy=policy, device="cuda", frames=batch["frames"])
        launches = read_launches()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        want = expect_launches(flash_attention_tc=cfg.num_layers * (2 if name == "drop" else 1))
        steps = max(out["decode_steps"], 1)
        log(f"[whisper_plan] {name}: plans {counts}, prefill {out['prefill_seconds']:.4f} s, "
            f"decode {1e3 * out['decode_seconds'] / steps:.3f} ms a step ({out['decode_steps']} "
            f"steps), steps/s by plan {out['measured_steps_per_sec']}, time to recover "
            f"{out['recover_seconds']} s, params_bytes {out['params_bytes']}, cache_bytes "
            f"{out['cache_bytes']} (the encoder memory's share "
            f"{predicted['memory_bytes'] if policy == 'migrate' and revoke else 0} of its "
            f"{predicted['memory_size']} B), train_path_bytes {out['train_path_bytes']}, "
            f"migrated_at {out['migrated_at']}, peak device memory {peak_gb:.3f} GB; launches "
            f"{launches}, expected {want}")
        if launches != want:
            raise AssertionError(f"whisper_plan {name}: the path did not go through the kernels "
                                 f"as expected")
        toks = np.asarray(out["tokens"])
        if toks.shape != (w["B"], w["new"]) or not ((toks >= 0) & (toks < cfg.vocab_size)).all() \
                or not all(bool(torch.isfinite(lg).all()) for lg in keep.logits):
            raise AssertionError(f"whisper_plan {name}: tokens of the wrong shape or non-finite "
                                 f"logits")
        runs[name], logits[name] = out, keep.logits
        total = {k: total[k] + v for k, v in launches.items()}
    for name in ("drop", "migrate"):
        r = runs[name]
        want_cache = predicted["cache_bytes"] if name == "migrate" else 0
        sps = r["measured_steps_per_sec"]
        if not (r["migrated_at"] == w["revoke"]
                and r["params_bytes"] == predicted["params_bytes"]
                and 0 < r["params_bytes"] < r["train_path_bytes"]
                and r["train_path_bytes"] == predicted["train_path_bytes"]
                and r["cache_bytes"] == want_cache
                and set(sps) == {"4x2", "2x2"} and min(sps.values()) > 0
                and r["recover_seconds"] > 0):
            raise AssertionError(f"whisper_plan {name}: migration columns {r} against {predicted}")
    ref = runs["dense"]["tokens"]
    if runs["migrate"]["tokens"] != ref:
        raise AssertionError("whisper_plan migrate: the stream differs from the uninterrupted one")
    div = hold_engine_streams(runs["dense"], runs["drop"], logits["dense"], logits["drop"],
                              w["revoke"], "whisper drop")
    log(f"[whisper_plan] migrate: stream equal to the uninterrupted run's; drop: "
        f"{w['B'] - len(div)} of {w['B']} rows equal in full, divergences {div}")
    del params, logits
    _free_cuda()
    return total


def whisper_plan_phase() -> dict:
    """Phase 16: whisper-tiny on the launcher's dense plans at full width
    and depth, then reduced f32 (tests/test_torch_whisper_plan.py's sizes)
    against the CPU. Returns launches by path."""
    _free_cuda()
    paths = {"whisper_plan": whisper_plan_full_width()}
    paths["whisper_plan_f32"] = serve_plan_reduced_matches_cpu(
        "whisper-tiny", WHISPER_PLAN_RUNS, "whisper_plan", ("flash_attention_tf32",))
    return paths


# ---------------------------------------------------------------------------
# phase 17: internvl2-26b's training step (vlm_train)
# ---------------------------------------------------------------------------

# text tokens a row (after the 1025 patch rows: the flash kernels see S =
# 3073), global batch, steps (the first at learning rate 0)
VLM_TRAIN = dict(S=2048, batch=2, steps=3)
# internvl2-26b trained at full width with VLM_TRAIN_LAYERS of its 48
# layers: f32 params, grads and AdamW moments are 16 B a param, 18.5 GB for
# the embedding, the LM head and vision_proj (1.157 B params) and 6.24 GB a
# layer (0.390 B), so all 48 (318 GB) do not fit; 8 layers hold 68.4 GB of
# state (qwen3-4b's 70.6 GB peaked at 75.48 GB of the card's 85.0)
VLM_TRAIN_LAYERS = 8


def _vlm_batch(cfg, B: int, S: int, gen: torch.Generator, device, seed: int,
               dtype=torch.bfloat16) -> dict:
    """Prompts from RandomState(seed) with next-token labels (never equal to
    the tokens), and standard-normal patch embeddings from ``gen`` in
    ``dtype``: the stub projector's input."""
    rows = np.random.RandomState(seed).randint(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    return {"tokens": torch.as_tensor(rows[:, :S], device=device),
            "labels": torch.as_tensor(rows[:, 1:], device=device),
            "patches": torch.randn((B, cfg.vision_tokens, cfg.vision_width), generator=gen,
                                   device=device).to(dtype)}


def vlm_train_full_width() -> dict:
    """internvl2-26b at full width with VLM_TRAIN_LAYERS of its 48 layers,
    f32 params (attention biases drawn nonzero) + AdamW, 2 rows of 1025
    patch rows + 2048 tokens in 2 microbatches, ``remat="full"``, through
    ``build_train_step`` for 3 steps (``run_segment`` refuses a VLM: the data
    path makes no patches): finite losses and grad norms, params unmoved at
    step 0 (learning rate 0) and moved after, vision_proj included; per
    layer and microbatch two flash forwards and one of each backward kernel
    at S = 3073, and no other kernel. Returns the launches."""
    from repro_torch.config import ShardingLayout, TrainConfig, get_arch
    from repro_torch.models import build_model
    from repro_torch.train.steps import build_train_step, init_train_state

    full = get_arch("internvl2-26b")
    cfg = dataclasses.replace(full, num_layers=VLM_TRAIN_LAYERS)
    model = build_model(cfg)
    S, B, n_steps = VLM_TRAIN["S"], VLM_TRAIN["batch"], VLM_TRAIN["steps"]
    tc = TrainConfig(total_steps=n_steps, warmup_steps=1, microbatches=2)
    layout = ShardingLayout(attn_impl="flash")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    state = init_train_state(model, gen, "cuda")
    draw_biases(state.params, gen)
    torch.cuda.synchronize()
    log(f"[vlm_train] {cfg.name}: {cfg.num_layers} of {full.num_layers} layers (depth cut, width "
        f"full), d_model {cfg.d_model}, d_ff {cfg.d_ff}, {cfg.num_heads}/{cfg.num_kv_heads} "
        f"heads, {cfg.vision_tokens} patch rows of width {cfg.vision_width}; "
        f"{model.param_count() / 1e9:.3f} B f32 params; params + AdamW moments "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB, made on the card in "
        f"{time.perf_counter() - t0:.1f} s; {cfg.vision_tokens} + {S} rows, global batch {B} in "
        f"{tc.microbatches} microbatches, remat {layout.remat}")
    step_fn = build_train_step(model, tc, layout)
    probe = lambda st: [t.detach().clone() for t in (
        st.params["embed"][:4, :8], st.params["vision_proj"][:8, :4],
        st.params["lm_head"][:8, :4], st.params["blocks"]["attn"]["wq"][0, :8, :4],
        st.params["blocks"]["mlp"]["wo"][-1, :8, :4])]
    before = probe(state)
    reset_launches()
    metrics, secs = [], []
    for i in range(n_steps):
        batch = _vlm_batch(cfg, B, S, gen, "cuda", seed=100 + i)
        t0 = time.perf_counter()
        state, m = step_fn(state, batch)
        metrics.append({k: float(v) for k, v in m.items()})   # the device sync
        secs.append(time.perf_counter() - t0)
        if i == 0 and not all(torch.equal(a, b) for a, b in zip(before, probe(state))):
            raise AssertionError("VLM params moved at step 0, where the learning rate is 0")
    launches = read_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    moved = [float((a - b).abs().max()) for a, b in zip(before, probe(state))]
    per = cfg.num_layers * tc.microbatches * n_steps
    want = expect_launches(flash_attention_tc=2 * per, flash_attention_bwd_dkdv_tc=per,
                           flash_attention_bwd_dq_tc=per)
    for i, (m, dt) in enumerate(zip(metrics, secs)):
        log(f"[vlm_train] step {i}: loss {m['loss']:.6f}, grad_norm {m['grad_norm']:.6f}, "
            f"lr {m['lr']:.3e}, {dt * 1e3:.1f} ms, {B * S / dt:.1f} text tokens/s "
            f"({B * (S + cfg.vision_tokens) / dt:.1f} rows/s)")
    log(f"[vlm_train] step time {fmt_spread([1e3 * s for s in secs])} over {n_steps} steps (the "
        f"first includes the first calls' set-up); peak memory {peak_gb:.2f} GB; largest change "
        f"of the probed params after step 1 (embed, vision_proj, lm_head, wq, wo): "
        f"{[f'{x:.3e}' for x in moved]}; launches {launches}, expected {want}")
    if not all(np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"]) for m in metrics):
        raise AssertionError(f"non-finite VLM training metrics: {metrics}")
    if not min(moved) > 0:
        raise AssertionError("a probed VLM param did not move after step 1")
    if launches != want:
        raise AssertionError("VLM training did not go through the kernels as expected")
    profile_training(model, step_fn, state, None,
                     f"internvl2 {B} x ({cfg.vision_tokens} patch rows + {S} tokens)",
                     _vlm_batch(cfg, B, S, gen, "cuda", seed=100 + n_steps))
    del state, step_fn
    _free_cuda()
    return launches


def vlm_train_phase() -> dict:
    """Phase 17: internvl2-26b's training step at full width (depth cut),
    then reduced f32 against the CPU. Returns launches by path."""
    _free_cuda()
    paths = {"vlm_train": vlm_train_full_width()}
    paths["vlm_train_f32"] = step_reduced_matches_cpu("internvl2-26b", "vlm_train")
    return paths


# ---------------------------------------------------------------------------
# phase 18: xlstm-350m trained under remat="dots" beside "full"
# ---------------------------------------------------------------------------

# the turns, each from the same start state and data (A B B A)
XLSTM_DOTS_TURNS = ("full", "dots", "dots", "full")


def xlstm_train_dots() -> dict:
    """xlstm-350m at full width and depth (phase 15's model, sequence,
    batch and steps) through ``run_segment`` under ``remat="dots"`` (each
    group keeping its projections' outputs) and ``"full"``, in turns from
    one start state (kept in host memory) and the same data: per turn the
    ms a step, peak device memory and launches a step of each kernel. Held:
    finite metrics; every turn's launches those of phase 15 (the kernels'
    autograd Functions recompute under both); the dots turns' losses and
    grad norms equal the full turns' bit for bit (dots saves the products
    that full recomputes, and each kernel gives the same bits twice).
    Returns the dots turns' launches."""
    from repro_torch.config import ShardingLayout, TrainConfig, get_arch
    from repro_torch.data import SyntheticLM
    from repro_torch.models import build_model, transformer
    from repro_torch.train.loop import make_step, run_segment
    from repro_torch.train.steps import init_train_state

    cfg = get_arch("xlstm-350m")
    model = build_model(cfg)
    groups, m_per, has_s = transformer._xlstm_group_layout(cfg)
    seq, batch, n_steps = XLSTM_TRAIN["seq"], XLSTM_TRAIN["batch"], XLSTM_TRAIN["steps"]
    tc = TrainConfig(total_steps=n_steps, warmup_steps=1, microbatches=2)
    ds = SyntheticLM(cfg.vocab_size, seq, batch, seed=0)
    start = _copy_state(init_train_state(model, torch.Generator(device="cuda").manual_seed(0),
                                         "cuda"), "cpu")
    _free_cuda()
    per_mb = groups * m_per * tc.microbatches
    per_s = groups * has_s * tc.microbatches
    want = expect_launches(mlstm_tc=2 * per_mb * n_steps, mlstm_bwd=per_mb * n_steps,
                           slstm=2 * per_s * n_steps, slstm_bwd=per_s * n_steps)
    turns, dots_launches = [], dict.fromkeys(read_launches(), 0)
    for remat in XLSTM_DOTS_TURNS:
        layout = ShardingLayout(attn_impl="flash", remat=remat)
        state = _copy_state(start, "cuda")
        metrics: list = []
        step_fn = _recording(make_step(model, tc, layout), metrics)
        torch.cuda.synchronize()
        base_gb = torch.cuda.memory_allocated() / 1e9
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        res = run_segment(model, state, ds, "cuda", tc, layout, num_steps=n_steps,
                          jitted=step_fn)
        launches = read_launches()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        secs = [1e3 * s for s in res.step_seconds]
        turns.append((remat, metrics, secs, peak_gb, launches))
        log(f"[xlstm_dots] remat {remat}: losses {[m['loss'] for m in metrics]}, grad norms "
            f"{[m['grad_norm'] for m in metrics]}; step time {fmt_spread(secs)} (steps "
            f"{[round(x, 1) for x in secs]} ms, the first with the first calls' set-up); peak "
            f"device memory {peak_gb:.2f} GB (params + moments {base_gb:.2f} GB); launches a "
            f"step {({k: v / n_steps for k, v in launches.items() if v})}")
        if not all(np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"]) for m in metrics):
            raise AssertionError(f"non-finite xlstm training metrics under remat {remat}")
        if launches != want:
            raise AssertionError(f"xlstm training under remat {remat} did not go through the "
                                 f"kernels as expected: {launches} against {want}")
        if remat == "dots":
            dots_launches = {k: dots_launches[k] + v for k, v in launches.items()}
        del state, res, step_fn
        _free_cuda()
    ref = [(m["loss"], m["grad_norm"]) for m in turns[0][1]]
    same = {i: [(m["loss"], m["grad_norm"]) for m in t[1]] == ref for i, t in enumerate(turns)}
    steps = {r: [ms for t in turns if t[0] == r for ms in t[2][1:]] for r in ("full", "dots")}
    peaks = {r: [round(t[3], 3) for t in turns if t[0] == r] for r in ("full", "dots")}
    log(f"[xlstm_dots] losses and grad norms equal to the first full turn's, by turn: {same}; "
        f"steps after the first, full {fmt_spread(steps['full'])}, dots "
        f"{fmt_spread(steps['dots'])}; peak GB {peaks}")
    if not all(same.values()):
        raise AssertionError("remat dots gives other losses or grad norms than full on the card")
    return dots_launches


def xlstm_dots_phase() -> dict:
    """Phase 18: xlstm-350m trained under remat="dots" beside "full" at full
    width and depth, then reduced f32 xlstm's 3 steps under dots on the
    card against the CPU. Returns launches by path."""
    _free_cuda()
    paths = {"xlstm_train_dots": xlstm_train_dots()}
    paths["xlstm_train_dots_f32"] = train_reduced_matches_cpu("xlstm-350m", "xlstm_train_dots",
                                                              3, remat="dots")
    return paths


# ---------------------------------------------------------------------------
# phase 19: the dry run's estimate against the card
# ---------------------------------------------------------------------------

# phase 7's and phase 15's training steps: (arch, global batch, seq,
# microbatches), remat "full", the flash layout
DRYRUN_PATHS = {"dryrun_train": ("qwen3-4b", 2, 4096, 2),
                "dryrun_xlstm_train": ("xlstm-350m", 2, 4096, 2)}
# the predicted peak against max_memory_allocated over the step: the
# caching allocator rounds each block up (512 B at least) and keeps
# cuBLAS's workspaces, which the trace does not count
DRYRUN_PEAK_MARGIN = 0.10


def dryrun_step(tag: str, arch: str, batch: int, seq: int, microbatches: int) -> dict:
    """One training step of ``arch`` at full width, traced on the meta
    device by ``launch/dryrun.py`` (no allocation), then run on the card
    from a seeded init: a first step (set-up), a measured one (launch
    counters from 0, the allocator's peak reset, CUDA events around it) and
    one under ``FlopCounterMode``. Held: the trace's kernel calls equal the
    counters, its peak within DRYRUN_PEAK_MARGIN of the measured one, the
    roofline's time (``roofline.compute_seconds``, bytes at 3.35 TB/s) no
    more than the measured step, its aten product FLOPs equal
    ``FlopCounterMode``'s. Returns the measured step's launches."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.config import InputShape, ShardingLayout, TrainConfig, get_arch
    from repro_torch.launch import dryrun, roofline
    from repro_torch.models import build_model
    from repro_torch.train.steps import build_train_step, init_train_state

    cfg = get_arch(arch)
    layout = ShardingLayout(attn_impl="flash")
    t0 = time.perf_counter()
    pred = dryrun.trace_step(cfg, InputShape(tag, seq, batch, "train"), layout, microbatches)
    t_compute = roofline.compute_seconds(pred["flops_by_dtype"])
    t_memory = pred["hbm_bytes"] / roofline.HBM_BANDWIDTH
    t_roof = max(t_compute, t_memory)
    log(f"[{tag}] {arch} traced on meta in {time.perf_counter() - t0:.1f} s: "
        f"{pred['flops']:.4e} FLOPs {pred['flops_by_dtype']}, {pred['hbm_bytes']:.4e} bytes, "
        f"peak {pred['peak_bytes_per_device'] / 1e9:.3f} GB, kernel calls "
        f"{pred['kernel_calls']}; roofline t_compute {1e3 * t_compute:.2f} ms, t_memory "
        f"{1e3 * t_memory:.2f} ms")

    model = build_model(cfg)
    state = init_train_state(model, torch.Generator(device="cuda").manual_seed(0), "cuda")
    step = build_train_step(model, TrainConfig(total_steps=4, warmup_steps=1,
                                               microbatches=microbatches), layout)
    gen = torch.Generator(device="cuda").manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (batch, seq + 1), generator=gen, device="cuda",
                           dtype=torch.int32)
    data = {"tokens": tokens[:, :-1].contiguous(), "labels": tokens[:, 1:].contiguous()}
    del tokens
    state, _ = step(state, data)
    torch.cuda.synchronize()
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    state, metrics = step(state, data)
    ev[1].record()
    torch.cuda.synchronize()
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    step_ms = ev[0].elapsed_time(ev[1])
    with FlopCounterMode(display=False) as fc:
        step(state, data)
        torch.cuda.synchronize()
    aten = fc.get_total_flops()
    calls = {k: v for k, v in launches.items() if v}
    peak_off = pred["peak_bytes_per_device"] / peak - 1
    log(f"[{tag}] measured step {step_ms:.2f} ms (loss {float(metrics['loss']):.6f}); peak "
        f"{peak / 1e9:.3f} GB against the predicted {pred['peak_bytes_per_device'] / 1e9:.3f} "
        f"({100 * peak_off:+.2f}%; limit {100 * DRYRUN_PEAK_MARGIN:.0f}%); roofline "
        f"{1e3 * t_roof:.2f} ms ({'compute' if t_compute >= t_memory else 'memory'}), "
        f"{100 * 1e3 * t_roof / step_ms:.1f}% of the step; launches {calls} against the "
        f"trace's {pred['kernel_calls']}; aten product FLOPs {pred['product_flops']:.6e} "
        f"traced, {aten:.6e} by FlopCounterMode")
    if calls != pred["kernel_calls"]:
        raise AssertionError(f"{tag}: launches {calls} != the dry run's {pred['kernel_calls']}")
    if abs(peak_off) > DRYRUN_PEAK_MARGIN:
        raise AssertionError(f"{tag}: predicted peak {pred['peak_bytes_per_device']} B is "
                             f"{100 * peak_off:+.2f}% off the measured {peak} B")
    if 1e3 * t_roof > step_ms:
        raise AssertionError(f"{tag}: the roofline's {1e3 * t_roof:.2f} ms exceeds the "
                             f"measured step's {step_ms:.2f} ms")
    if pred["product_flops"] != aten:
        raise AssertionError(f"{tag}: traced product FLOPs {pred['product_flops']} != "
                             f"FlopCounterMode's {aten}")
    del state, step, data, model
    _free_cuda()
    return launches


def dryrun_phase() -> dict:
    """Phase 19: the dry run's estimate held against the card at phase 7's
    and phase 15's training steps. Returns launches by path."""
    _free_cuda()
    return {tag: dryrun_step(tag, *args) for tag, args in DRYRUN_PATHS.items()}


# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# phase 20: multi-device execution over torch.distributed
# ---------------------------------------------------------------------------

# four markets of 4, 2, 1 and 4 devices (80 GB each, explicit relative
# rates, so no measured time enters a decision); history ranks them by
# lifetime A > B > C > D, and A, B, C revoke at future hours 4, 8, 12:
# siwoft trains on (2, 2), shrinks to (2, 1) and (1, 1), grows back to
# (2, 2) on a world of 4 (tests/torch_world_workers.py's scenario)
SHRINK_MARKETS = [
    ("quad.a", "us-east-1", "us-east-1a", 80, 1.2, 4, 100.0),
    ("pair.b", "eu-west-1", "eu-west-1a", 80, 1.2, 2, 100.0),
    ("one.c", "ap-southeast-1", "ap-southeast-1a", 80, 1.2, 1, 100.0),
    ("quad.d", "us-west-2", "us-west-2a", 80, 1.2, 4, 100.0),
]
# 12 steps in segments of 3 at one step a trace hour; the full-width run
# takes phase 7's settings (f32 + AdamW, seq 4096, global batch 2 in 2
# microbatches); the reduced f32 run the three modes, as tests do
MULTI = dict(steps=12, segment_steps=3, seq=4096, batch=2, microbatches=2)
MULTI_REDUCED = dict(steps=12, segment_steps=3, ckpt_every=2, ft_revocations=2)
# the world of 4 trains all 36 layers; a world of one card, which moves
# nothing (every plan caps to one rank), cuts the depth to keep the whole
# script's time
MULTI_ONE_CARD_LAYERS = 4
MULTI_RANKS = 4
MULTI_TIMEOUT = 480


def _shrink_markets():
    from repro_torch.core.market import Market, MarketSet

    markets = [Market(i, *m[:5], device_count=m[5], interconnect_gbps=m[6], steps_per_hour=1.0)
               for i, m in enumerate(SHRINK_MARKETS)]
    hp = np.full((4, 90), 0.35)
    hp[1, 45] = 1.5
    hp[2, 30::30] = 1.5
    hp[3, 15::15] = 1.5
    fp = np.full((4, 48), 0.35)
    for i, h in enumerate((4, 8, 12)):
        fp[i, h] = 1.5
    return MarketSet(markets, hp), MarketSet(markets, fp, start_hour=90)


def _multi_reduced(device) -> dict:
    """The shrink scenario's three modes and siwoft on the split scenario,
    reduced f32 qwen3-4b from one CPU-made start state, on this rank's
    ``device``: columns, losses and moves by run."""
    import tempfile

    from repro_torch.config import ShardingLayout, TrainConfig, get_arch
    from repro_torch.core.orchestrator import SpotTrainingOrchestrator
    from repro_torch.data import SyntheticLM
    from repro_torch.models import build_model
    from repro_torch.train.steps import init_train_state

    cfg = dataclasses.replace(get_arch("qwen3-4b").reduced(), dtype="float32")
    model = build_model(cfg)
    start = init_train_state(model, torch.Generator().manual_seed(0), "cpu")
    r = MULTI_REDUCED
    out = {}
    for mode in ("siwoft", "checkpoint", "hybrid"):
        with tempfile.TemporaryDirectory() as d:
            o = SpotTrainingOrchestrator(
                model, SyntheticLM(cfg.vocab_size, 32, 4, seed=0), device, *_shrink_markets(),
                mode=mode, tc=TrainConfig(total_steps=2 * r["steps"], warmup_steps=2),
                layout=ShardingLayout(attn_impl="flash"), segment_steps=r["segment_steps"],
                steps_per_trace_hour=1, seed=0, job_memory_gb=40.0, ckpt_dir=d,
                ckpt_every=r["ckpt_every"], ft_revocations=r["ft_revocations"],
                init_state=lambda: _copy_state(start, device))
            rep = o.run(r["steps"])
            if o.ckpt is not None:
                o.ckpt.close()
        out[mode] = ({k: getattr(rep, k) for k in SPOT_COLUMNS}, rep.losses, rep.moves)
    # phase 8's split scenario in siwoft: over 4 ranks two legs of 2, and
    # leg B's revocation repaired by rebuilding that leg alone
    rep = SpotTrainingOrchestrator(
        model, SyntheticLM(cfg.vocab_size, 32, 4, seed=0), device, *_split_markets(),
        mode="siwoft", tc=TrainConfig(total_steps=80, warmup_steps=2),
        layout=ShardingLayout(attn_impl="flash"), segment_steps=10, steps_per_trace_hour=1,
        seed=0, job_memory_gb=400.0, init_state=lambda: _copy_state(start, device)).run(40)
    out["split"] = ({k: getattr(rep, k) for k in SPOT_COLUMNS}, rep.losses, rep.moves)
    return out


def _step_twice(step, state, batch):
    """Run ``step`` from ``state``, put the state back (the step updates it
    in place) and run it again: whether the two runs' metrics and slices
    have the same bits."""
    from repro_torch.models.common import tree_flatten

    leaves, unflatten = tree_flatten(state)
    kept = [x.clone() if isinstance(x, torch.Tensor) else x for x in leaves]
    state, first = step(state, batch)
    first = {k: v.clone() for k, v in first.items()}
    after = [x.clone() if isinstance(x, torch.Tensor) else x for x in tree_flatten(state)[0]]
    with torch.no_grad():
        state = unflatten([x.copy_(k) if isinstance(x, torch.Tensor) else k
                           for x, k in zip(tree_flatten(state)[0], kept)])
    state, second = step(state, batch)
    return all(torch.equal(first[k], second[k]) for k in first) and all(
        torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b
        for a, b in zip(after, tree_flatten(state)[0]))


def _multi_twice(w) -> dict:
    """Reduced f32 qwen3-4b's sharded step on each plan the world holds
    ((2, 2), (2, 1), (1, 1) on 4 ranks), run twice from one state on its
    ranks: plan shape -> whether every rank got the same bits."""
    import torch.distributed as dist

    from repro_torch.config import ShardingLayout, TrainConfig, get_arch
    from repro_torch.data import SyntheticLM
    from repro_torch.dist import ElasticMeshManager, elastic, reshard_tree
    from repro_torch.models import build_model
    from repro_torch.train.loop import make_step, state_shardings
    from repro_torch.train.steps import init_train_state

    cfg = dataclasses.replace(get_arch("qwen3-4b").reduced(), dtype="float32")
    model = build_model(cfg)
    layout = ShardingLayout(attn_impl="flash")
    man = ElasticMeshManager()
    batch = {k: torch.from_numpy(v).to(w.device)
             for k, v in SyntheticLM(cfg.vocab_size, 32, 4, seed=0).batch(0).items()}
    out = {}
    for n in sorted({w.size, min(2, w.size), 1}, reverse=True):
        plan = man.plan_for(n)
        state = _copy_state(init_train_state(model, torch.Generator().manual_seed(0), "cpu"),
                            w.device)
        state = reshard_tree(state, state_shardings(model, plan.mesh, layout),
                             elastic.everywhere(state))
        step = make_step(model, TrainConfig(total_steps=10, warmup_steps=2), layout, plan.mesh)
        same = _step_twice(step, state, batch) if w.rank in plan.mesh.slots else True
        agree = torch.tensor([int(same)], device=w.device)
        dist.all_reduce(agree, op=dist.ReduceOp.MIN)
        out[plan.mesh_shape] = bool(agree.item())
    return out


def _multi_card_rank(w, layers: int) -> list:
    """One rank of phase 20's world on the cards: full-width qwen3-4b
    through siwoft on the shrink scenario, then the reduced f32 modes.
    Returns every rank's record (gathered to all)."""
    import torch.distributed as dist

    from repro_torch.config import ShardingLayout, TrainConfig, get_arch
    from repro_torch.core import orchestrator as orch
    from repro_torch.data import SyntheticLM
    from repro_torch.models import build_model

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_arch("qwen3-4b")
    if layers:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    model = build_model(cfg)
    m = MULTI
    tc = TrainConfig(total_steps=2 * m["steps"], warmup_steps=1, microbatches=m["microbatches"])
    steps: list = []
    peak = [0]          # over the run; each step's own peak is reset at its start
    make_step = orch.make_step

    def recording_step(model_, tc_, layout_, mesh=None):
        inner = make_step(model_, tc_, layout_, mesh)
        shape = mesh.grid_shape if mesh is not None else (1, 1)

        def step(state, batch):
            i, t0 = state.step, time.perf_counter()
            peak[0] = max(peak[0], torch.cuda.max_memory_allocated())
            torch.cuda.reset_peak_memory_stats()
            state, metrics = inner(state, batch)
            loss = float(metrics["loss"])
            steps.append({"step": i, "plan": shape, "loss": loss,
                          "grad_norm": float(metrics["grad_norm"]),
                          "seconds": time.perf_counter() - t0,
                          "peak": torch.cuda.max_memory_allocated()})
            return state, metrics
        return step

    orch.make_step = recording_step
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        rep = orch.SpotTrainingOrchestrator(
            model, SyntheticLM(cfg.vocab_size, m["seq"], m["batch"], seed=0), w.device,
            *_shrink_markets(), mode="siwoft", tc=tc, layout=ShardingLayout(attn_impl="flash"),
            segment_steps=m["segment_steps"], steps_per_trace_hour=1, seed=0,
            job_memory_gb=40.0).run(m["steps"])
    finally:
        orch.make_step = make_step
    wall = time.perf_counter() - t0
    mine = {"rank": w.rank, "launches": read_launches(), "steps": steps,
            "peak": max(peak[0], torch.cuda.max_memory_allocated()), "wall": wall,
            "report": {k: getattr(rep, k) for k in SPOT_COLUMNS}, "moves": rep.moves,
            "snapshots": [{k: v for k, v in snap.items() if k != "leaves"}
                          for snap in rep.snapshots],
            "useful": rep.useful_steps, "wasted": rep.wasted_steps}
    del rep
    gc.collect()
    torch.cuda.empty_cache()
    reset_launches()
    mine["twice"] = _multi_twice(w)
    mine["reduced"] = _multi_reduced(w.device)
    mine["reduced_launches"] = read_launches()
    every = [None] * w.size
    dist.all_gather_object(every, mine)
    return every


def _multi_cpu_rank(w) -> dict:
    """One rank of phase 20's gloo world on the CPU: the reduced modes."""
    return _multi_reduced(w.device)


def multi_device_phase() -> dict:
    """Phase 20: the spot path over ``torch.cuda.device_count()`` ranks,
    one process and card each (NCCL), spawned here. Returns launches by
    path, summed over ranks."""
    from repro_torch.launch.mesh import run_world

    n = torch.cuda.device_count()
    layers = 0 if n >= MULTI_RANKS else MULTI_ONE_CARD_LAYERS
    log(f"[multi] torch.distributed: nccl available {torch.distributed.is_nccl_available()}, "
        f"gloo {torch.distributed.is_gloo_available()}; a world of {n} rank(s), one card each")
    if n < MULTI_RANKS:
        log(f"[multi] the {MULTI_RANKS}-rank part (qwen3-4b trained on (2, 2), (2, 1) and (1, 1), "
            f"the state moved between cards) needs {MULTI_RANKS} cards; this machine has {n}, "
            f"so every plan caps to {n} rank(s) and the depth is cut to {layers} layers "
            f"(python3 chip_smoke.py --multi-device-only on {MULTI_RANKS} cards)")
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = run_world(_multi_card_rank, n, "cuda", (layers,), timeout=MULTI_TIMEOUT)
    t_card = time.perf_counter() - t0
    cpu = run_world(_multi_cpu_rank, n, "cpu", (), timeout=MULTI_TIMEOUT, threads=2)
    log(f"[multi] worlds: the cards' {t_card:.1f} s, the CPU's {time.perf_counter() - t0 - t_card:.1f} s")
    zero = ranks[0]
    depth = layers or 36
    log(f"[multi] qwen3-4b at full width, {depth} layers, f32 params + AdamW, seq {MULTI['seq']}, "
        f"global batch {MULTI['batch']} in {MULTI['microbatches']} microbatches; siwoft on the "
        f"shrink scenario, {MULTI['steps']} steps in segments of {MULTI['segment_steps']}: "
        f"report {zero['report']}")
    failed = []
    for r in ranks:
        if r["report"] != zero["report"]:
            failed.append(f"rank {r['rank']}'s report differs from rank 0's")
    by_plan: dict = {}
    for rec in zero["steps"]:
        by_plan.setdefault(rec["plan"], []).append(rec)
    for plan, recs in sorted(by_plan.items(), reverse=True):
        ms = [x["seconds"] * 1e3 for x in recs]
        log(f"[multi] plan {plan}: {len(recs)} steps on rank 0, ms a step "
            + ", ".join(f"{t:.1f}" for t in ms) + "; each rank's peak over its steps on it (GB) "
            + ", ".join(f"rank {r['rank']}: {max((x['peak'] for x in r['steps'] if x['plan'] == plan), default=0) / 1e9:.2f}"
                        for r in ranks))
    for r in ranks:
        log(f"[multi] rank {r['rank']}: peak device memory over the run "
            f"{r['peak'] / 1e9:.2f} GB, {len(r['steps'])} steps, launches "
            f"{ {k: v for k, v in r['launches'].items() if v} }, run {r['wall']:.1f} s")
    for mv in zero["moves"]:
        gbps = mv["received"] / mv["seconds"] / 1e9 if mv["seconds"] else float("nan")
        log(f"[multi] move {mv['kind']} to {tuple(mv['to'])}: received {mv['received']} B "
            f"(priced {mv['priced']}) in {mv['seconds']:.3f} s ({gbps:.1f} GB/s summed over "
            f"ranks), priced {mv['hours'] * 3600:.3f} s on the trace clock")
    for snap in zero["snapshots"]:
        log(f"[multi] rank 0's segment-start snapshot at step {snap['step']}: "
            f"{snap['bytes'] / 1e9:.3f} GB in {snap['seconds']:.2f} s, written back in "
            f"{snap['restore_seconds']}")
    # every move of the live state received the bytes it was priced at
    for mv in zero["moves"]:
        if mv["kind"] in ("reshard", "leg") and mv["received"] != mv["priced"]:
            failed.append(f"move {mv}: received != priced")
    if sum(mv["priced"] for mv in zero["moves"] if mv["kind"] in ("reshard", "leg")) \
            != zero["report"]["reshard_bytes"]:
        failed.append("the moves' priced bytes do not sum to the report's reshard_bytes")
    # re-executed steps give the first attempt's loss bits (a revocation
    # re-runs them on the next market's plan: each row is one microbatch
    # on every plan, so the loss's sum is the same; the grad norm's sums
    # follow the plan, and are the same bits where the plan is)
    firsts, repeats = {}, []
    for rec in zero["steps"]:
        if rec["step"] in firsts:
            repeats.append((rec["step"], firsts[rec["step"]], rec))
        else:
            firsts[rec["step"]] = rec
    log("[multi] re-executed steps, loss and grad norm of the first attempt vs the second: "
        + ", ".join(f"step {i}: {a['loss']!r} vs {b['loss']!r}, {a['grad_norm']!r} on "
                    f"{a['plan']} vs {b['grad_norm']!r} on {b['plan']}"
                    for i, a, b in repeats))
    if not repeats or any(a["loss"] != b["loss"] or (
            a["plan"] == b["plan"] and a["grad_norm"] != b["grad_norm"]) for _, a, b in repeats):
        failed.append("re-executed steps did not reproduce the first attempt's bits")
    log(f"[multi] reduced f32 sharded step run twice from one state, same bits on every rank "
        f"by plan: {zero['twice']}")
    if not all(zero["twice"].values()):
        failed.append(f"a step run twice from one state gave other bits: {zero['twice']}")
    if zero["useful"] != MULTI["steps"] or not all(
            np.isfinite(x["loss"]) and np.isfinite(x["grad_norm"]) for x in zero["steps"]):
        failed.append("the run did not finish its steps with finite metrics")
    if n >= MULTI_RANKS:
        shapes = [tuple(s) for s in zero["report"]["mesh_shapes"]]
        if not {(2, 2), (2, 1), (1, 1)} <= set(shapes) or not zero["moves"]:
            failed.append(f"the world of {n} did not train on (2, 2), (2, 1) and (1, 1): {shapes}")
    # every rank launched the flash forward, dk/dv and dq for each step it ran
    launches = dict.fromkeys(read_launches(), 0)
    for r in ranks:
        fwd = dkdv = 0
        for rec in r["steps"]:
            data = rec["plan"][0]
            mb = max(1, MULTI["microbatches"] * (MULTI["batch"] // data) // MULTI["batch"])
            fwd, dkdv = fwd + 2 * depth * mb, dkdv + depth * mb
        want = expect_launches(flash_attention_tc=fwd, flash_attention_bwd_dkdv_tc=dkdv,
                               flash_attention_bwd_dq_tc=dkdv)
        if r["launches"] != want or not r["steps"] or not fwd:
            failed.append(f"rank {r['rank']}: launches {r['launches']}, expected {want}")
        launches = {k: launches[k] + v for k, v in r["launches"].items()}
        if not r["peak"] < 80e9:
            failed.append(f"rank {r['rank']}: peak device memory {r['peak'] / 1e9:.2f} GB")
    # the reduced f32 modes on the cards equal the same world on the CPU
    reduced = dict.fromkeys(launches, 0)
    for mode, (cols, losses, moves) in zero["reduced"].items():
        c_cols, c_losses, c_moves = cpu[mode]
        a, b = np.array(losses), np.array(c_losses)
        rel = float(np.max(np.abs(a - b) / np.abs(b))) if len(a) == len(b) else float("nan")
        log(f"[multi] reduced f32 {mode} over {n} rank(s): mesh shapes {cols['mesh_shapes']}, "
            f"reshard_bytes {cols['reshard_bytes']}, restore_bytes {cols['restore_bytes']}; "
            f"columns equal to the CPU world's: {cols == c_cols}; losses, largest relative "
            f"difference {rel}; moves received/priced "
            + ", ".join(f"{mv['kind']} {mv['received']}/{mv['priced']}" for mv in moves))
        if cols != c_cols or not np.allclose(a, b, rtol=1e-4, atol=0):
            failed.append(f"reduced {mode}: the cards' world differs from the CPU's")
        if any(mv["kind"] in ("reshard", "leg") and mv["received"] != mv["priced"]
               for mv in moves):
            failed.append(f"reduced {mode}: a move received other bytes than priced")
    if n >= MULTI_RANKS and not any(mv["kind"] == "leg" for mv in zero["reduced"]["split"][2]):
        failed.append("reduced split: no leg was rebuilt")
    for r in ranks:
        reduced = {k: reduced[k] + v for k, v in r["reduced_launches"].items()}
    hold_f32_launches("multi", reduced, "flash_attention_tf32",
                      "flash_attention_bwd_dkdv_tf32", "flash_attention_bwd_dq_tf32")
    if failed:
        raise AssertionError("phase 20: " + "; ".join(failed))
    return {"multi": launches, "multi_f32": reduced}


# ---------------------------------------------------------------------------
# phase 21: serving over torch.distributed
# ---------------------------------------------------------------------------

# phase 9's serving at full width (qwen3-4b, bf16 matrices, 8 prompts x 2000
# tokens, 32 new tokens, revoked after 16 decode steps) over one rank a card:
# plans of 4 and 2 ranks, (2, 2) -> (2, 1); the five runs as phase 9's
MSERVE_RUNS = {
    "dense": ([4], 0, "drop", False),
    "dense_drop": ([4, 2], SERVE_REVOKE, "drop", False),
    "dense_migrate": ([4, 2], SERVE_REVOKE, "migrate", False),
    "engine": ([4], 0, "drop", True),
    "engine_revoked": ([4, 2], SERVE_REVOKE, "drop", True),
}
MSERVE_RANKS = 4
# a world of one card moves nothing (every plan caps to one rank): the depth
# is cut to keep the whole script's time
MSERVE_ONE_CARD_LAYERS = 4
MSERVE_TIMEOUT = 600
# PLAN_JSON columns of the runs over ranks that are timings
MSERVE_TIMINGS = PLAN_TIMINGS + ("move_seconds",)


class _RowLogits:
    """Keep, on the card, the last-position logits a serving run computes
    on this process: the first batched prefill's (key -1) and each decode
    call's, dense or paged (key k: the call that gives token k + 1), by
    wrapping the step builders. ``rows_of(k)`` is the slice of global rows
    call k computed (None where none); :meth:`entries` gives the logits of
    the (row, key) pairs asked for that this process computed."""

    def __init__(self, rows_of):
        self.rows_of = rows_of
        self.prefill = None
        self.calls: list = []

    def __enter__(self):
        from repro_torch.launch import serve
        from repro_torch.serve import engine

        self._saved = (serve.build_prefill_step, serve.build_decode_step,
                       engine.build_paged_decode_step)
        pre, dense, paged = self._saved

        def keep_prefill(model, layout, total):
            step = pre(model, layout, total)

            def run(params, batch):
                logits, cache = step(params, batch)
                if self.prefill is None:
                    self.prefill = logits[:, -1].float().clone()
                return logits, cache
            return run

        def keep_decode(build):
            def wrapped(model, layout):
                step = build(model, layout)

                def run(params, cache, *rest):
                    logits, cache = step(params, cache, *rest)
                    self.calls.append(logits[:, -1].float().clone())
                    return logits, cache
                return run
            return wrapped

        serve.build_prefill_step = keep_prefill
        serve.build_decode_step = keep_decode(dense)
        engine.build_paged_decode_step = keep_decode(paged)
        return self

    def __exit__(self, *exc):
        from repro_torch.launch import serve
        from repro_torch.serve import engine

        serve.build_prefill_step, serve.build_decode_step, \
            engine.build_paged_decode_step = self._saved

    def table(self) -> dict:
        """Every key's logits, on the host: {k: (rows, vocab)}."""
        out = {k: t.cpu() for k, t in enumerate(self.calls)}
        if self.prefill is not None:
            out[-1] = self.prefill.cpu()
        return out

    def entries(self, wanted) -> dict:
        out = {}
        for b, k in wanted:
            rows = self.rows_of(k)
            t = self.prefill if k < 0 else (self.calls[k] if k < len(self.calls) else None)
            if rows is not None and t is not None and rows.start <= b < rows.stop:
                out[(b, k)] = t[b - rows.start].cpu()
        return out


def _first_divergences(ref: list, got: list) -> list:
    """(row, token) of each row's first token where ``got`` leaves ``ref``."""
    return [(b, next(j for j, (x, y) in enumerate(zip(r, g)) if x != y))
            for b, (r, g) in enumerate(zip(ref, got)) if r != g]


def _plan_rows(size: int, rank: int, counts: list, revoke: int):
    """``rows_of`` for a run over ``size`` ranks: the rows ``rank`` computes
    at decode call k (the first plan's before the revocation, the second's
    after), as ``batch_shardings`` places the prompts."""
    from repro_torch.dist import ElasticMeshManager, batch_shardings

    man = ElasticMeshManager([torch.device("cpu")] * size)

    def rows(count):
        p = batch_shardings({"t": np.zeros((SERVE_B, 1))}, man.plan_for(count).mesh)["t"]
        box = p.box((SERVE_B, 1), rank)
        return None if box is None else slice(*box[0])

    first, second = rows(counts[0]), rows(counts[-1])
    return lambda k: first if not revoke or k < revoke else second


class _StepLog:
    """A ``ThroughputTracker`` that also keeps each observed step's
    (plan, seconds)."""

    def __init__(self):
        from repro_torch.dist import ThroughputTracker

        self.inner, self.steps = ThroughputTracker(), []

    def observe(self, key, steps, seconds):
        self.steps.append((f"{key[1][0]}x{key[1][1]}", seconds / max(steps, 1)))
        self.inner.observe(key, steps, seconds)

    @property
    def measured(self):
        return self.inner.measured


def _mserve_model(layers: int):
    from repro_torch.config import get_arch
    from repro_torch.models import build_model

    cfg = get_arch("qwen3-4b")
    return build_model(dataclasses.replace(cfg, num_layers=layers) if layers else cfg)


def _mserve_prompts(cfg) -> np.ndarray:
    return np.random.RandomState(0).randint(0, cfg.vocab_size,
                                            (SERVE_B, SERVE_S)).astype(np.int32)


def _mserve_one_card(model) -> tuple:
    """Phase 9's uninterrupted dense run in this process on cuda:0 (a pool
    of 8 slots, batch 8): its PLAN_JSON and every token's logits."""
    from repro_torch.launch.serve import serve_plan

    params = model.init(torch.Generator(device="cuda").manual_seed(0), "cuda", torch.bfloat16)
    with _RowLogits(lambda k: slice(0, SERVE_B)) as keep:
        out = serve_plan(model, params, _mserve_prompts(model.cfg), SERVE_NEW, [8],
                         device="cuda")
    table = keep.table()
    del keep, params
    gc.collect()
    torch.cuda.empty_cache()
    return out, table


def _mserve_reduced(device) -> dict:
    """Reduced f32 qwen3-4b through MSERVE_RUNS over the world's ranks on
    ``device``, at phase 9's reduced sizes, from one CPU-made start."""
    from repro_torch.config import get_arch
    from repro_torch.launch.serve import serve_plan
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_map

    cfg = dataclasses.replace(get_arch("qwen3-4b").reduced(), dtype="float32")
    model = build_model(cfg)
    params = tree_map(lambda t: t.to(device), model.init(torch.Generator().manual_seed(0), "cpu"))
    r = SERVE_F32
    prompts = np.random.RandomState(0).randint(
        0, cfg.vocab_size, (r["batch"], r["prompt_len"])).astype(np.int32)
    return {name: serve_plan(model, params, prompts, r["new_tokens"], counts,
                             revoke_after=r["revoke_after"] if revoke else 0,
                             cache_policy=policy, engine=engine, device=device)
            for name, (counts, revoke, policy, engine) in MSERVE_RUNS.items()}


def _mserve_card_rank(w, layers: int, one_card_tokens: list) -> dict:
    """One rank of phase 21's world on the cards: the five full-width runs,
    then the reduced f32 ones. Returns, on every rank, rank 0's PLAN_JSON
    of each run, every rank's launches, peaks and step times by run, the
    logits of the rows where streams part (from whichever rank computed
    them), and the reduced runs and their launches."""
    import torch.distributed as dist

    from repro_torch.launch.serve import serve_plan

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = _mserve_model(layers)
    params = model.init(torch.Generator(device="cuda").manual_seed(0), "cuda", torch.bfloat16)
    prompts = _mserve_prompts(model.cfg)
    runs, kept = {}, {}
    mine = {"rank": w.rank, "device": torch.cuda.get_device_name(w.device), "runs": {}}
    for name, (counts, revoke, policy, engine) in MSERVE_RUNS.items():
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        steps = _StepLog()
        t0 = time.perf_counter()
        with _RowLogits(_plan_rows(w.size, w.rank, counts, revoke)) as keep:
            runs[name] = serve_plan(model, params, prompts, SERVE_NEW, counts,
                                    revoke_after=revoke, cache_policy=policy, engine=engine,
                                    device="cuda", tracker=steps)
        mine["runs"][name] = {"launches": read_launches(), "wall": time.perf_counter() - t0,
                              "peak": torch.cuda.max_memory_allocated(w.device),
                              "steps": steps.steps}
        kept[name] = keep
    # the logits where a run's rows part from the run they are held to
    wanted: dict = {name: set() for name in MSERVE_RUNS}
    for ref, got in (("dense", "dense_drop"), ("engine", "engine_revoked")):
        for b, j in _first_divergences(runs[ref]["tokens"], runs[got]["tokens"]):
            wanted[ref].add((b, j - 1))
            wanted[got].add((b, j - 1))
    for b, j in _first_divergences(one_card_tokens, runs["dense"]["tokens"]):
        wanted["dense"].add((b, j - 1))
    have = {name: kept[name].entries(wanted[name]) for name in MSERVE_RUNS}
    del kept, params
    gc.collect()
    torch.cuda.empty_cache()
    reset_launches()
    reduced = _mserve_reduced(w.device)
    mine["reduced_launches"] = read_launches()
    every = [None] * w.size
    dist.all_gather_object(every, {"mine": mine, "have": have})
    logits: dict = {name: {} for name in MSERVE_RUNS}
    for r in every:
        for name, got in r["have"].items():
            for (b, k), t in got.items():
                logits[name].setdefault(k, {})[b] = t
    return {"runs": runs, "ranks": [r["mine"] for r in every], "logits": logits,
            "reduced": reduced}


def _mserve_cpu_rank(w) -> dict:
    """One rank of phase 21's gloo world on the CPU: the reduced runs."""
    return _mserve_reduced(w.device)


def multi_serve_phase() -> dict:
    """Phase 21: the spot serving plans over ``torch.cuda.device_count()``
    ranks, one process and card each (NCCL), spawned here. Returns
    launches by path, summed over ranks."""
    from repro_torch.launch.mesh import run_world

    n = torch.cuda.device_count()
    layers = 0 if n >= MSERVE_RANKS else MSERVE_ONE_CARD_LAYERS
    depth = layers or 36
    model = _mserve_model(layers)
    predicted = serve_plan_predicted(model, (4, 2), n)
    log(f"[mserve] a world of {n} rank(s), one card each; {model.cfg.name} at full width, "
        f"{depth} layers, bf16 matrices, {SERVE_B} prompts x {SERVE_S} tokens, {SERVE_NEW} new "
        f"tokens, plans of 4 -> 2 ranks (capped to {n}) revoked after {SERVE_REVOKE} steps; "
        f"predicted from the specs {predicted}")
    if n < MSERVE_RANKS:
        log(f"[mserve] the {MSERVE_RANKS}-rank part (plans (2, 2) -> (2, 1), the params and "
            f"the cache moved between cards) needs {MSERVE_RANKS} cards; this machine has {n}, "
            f"so every plan caps to {n} rank(s) and the depth is cut to {layers} layers "
            f"(python3 chip_smoke.py --multi-serve-only on {MSERVE_RANKS} cards)")
    gc.collect()
    torch.cuda.empty_cache()
    one_card, one_card_logits = _mserve_one_card(model)
    t0 = time.perf_counter()
    world = run_world(_mserve_card_rank, n, "cuda", (layers, one_card["tokens"]),
                      timeout=MSERVE_TIMEOUT)
    t_card = time.perf_counter() - t0
    cpu = run_world(_mserve_cpu_rank, n, "cpu", (), timeout=MSERVE_TIMEOUT, threads=2)
    log(f"[mserve] worlds: the cards' {t_card:.1f} s, the CPU's "
        f"{time.perf_counter() - t0 - t_card:.1f} s")
    runs, ranks, logits = world["runs"], world["ranks"], world["logits"]
    failed = []
    plans = {"2x2", "2x1"} if n >= MSERVE_RANKS else {"1x1"}
    for name, out in runs.items():
        counts, revoke, policy, engine = MSERVE_RUNS[name]
        by_plan: dict = {}
        for plan, secs in ranks[0]["runs"][name]["steps"]:
            by_plan.setdefault(plan, []).append(secs * 1e3)
        mv = out["move_seconds"]
        log(f"[mserve] {name}: plans {counts}, prefill {out['prefill_seconds']:.3f} s, decode "
            f"{1e3 * out['decode_seconds'] / max(out['decode_steps'], 1):.2f} ms a step "
            f"({out['decode_steps']} steps); rank 0's ms a step by plan "
            + "; ".join(f"{p}: {fmt_spread(t)} ({len(t)} steps)" for p, t in by_plan.items())
            + f"; steps/s by plan {out['measured_steps_per_sec']}, "
            + (f"engine tokens/s {out['engine_tokens_per_sec']} (before the revocation "
               f"{out['engine_tokens_per_sec_before']}), " if engine else "")
            + f"time to recover {out['recover_seconds']} s; params_bytes {out['params_bytes']} "
            f"(received {out['params_received']}, in {mv.get('params')} s; gathered again "
            f"{out['params_gather_bytes']} B in {mv.get('params_gather')} s), cache_bytes "
            f"{out['cache_bytes']} (received {out['cache_received']}, in {mv.get('cache')} s), "
            f"cache_gather_bytes {out['cache_gather_bytes']} (in {mv.get('cache_gather')} s), "
            f"train_path_bytes {out['train_path_bytes']}, migrated_at {out['migrated_at']}; "
            f"per rank {out['ranks']}; ranks of a data coordinate agree "
            f"{out['data_ranks_agree']}")
        for r in ranks:
            rec = r["runs"][name]
            log(f"[mserve] {name}: rank {r['rank']} ({r['device']}): peak device memory "
                f"{rec['peak'] / 1e9:.2f} GB, run {rec['wall']:.1f} s, launches "
                f"{ {k: v for k, v in rec['launches'].items() if v} }")
        if not out["data_ranks_agree"]:
            failed.append(f"{name}: the ranks of a data coordinate gave other tokens")
        if revoke:
            want_cache = predicted["cache_bytes"] if policy == "migrate" else 0
            want_gather = predicted["cache_gather_bytes"] if policy == "migrate" else 0
            sps = out["measured_steps_per_sec"]
            if not (out["migrated_at"] == SERVE_REVOKE
                    and out["params_bytes"] == out["params_received"] == predicted["params_bytes"]
                    and out["params_bytes"] < out["train_path_bytes"]
                    and out["train_path_bytes"] == predicted["train_path_bytes"]
                    and out["cache_bytes"] == out["cache_received"] == want_cache
                    and out["cache_gather_bytes"] == want_gather
                    and set(sps) == plans and min(sps.values()) > 0
                    and out["recover_seconds"] > 0
                    and (n < MSERVE_RANKS or out["params_bytes"] > 0)
                    and (n < MSERVE_RANKS or policy != "migrate" or out["cache_bytes"] > 0)):
                failed.append(f"{name}: migration columns {out} against {predicted}")
        # every rank: 36 flash forwards a prefill call, 36 paged launches an
        # engine decode step
        for r, stat in zip(ranks, out["ranks"]):
            want = expect_launches(flash_attention_tc=depth * stat["prefills"],
                                   paged_attention_tc=depth * stat["decode_steps"] * engine)
            if r["runs"][name]["launches"] != want or not stat["prefills"]:
                failed.append(f"{name}: rank {r['rank']} launches "
                              f"{r['runs'][name]['launches']}, expected {want}")
            if not r["runs"][name]["peak"] < 80e9:
                failed.append(f"{name}: rank {r['rank']} peak {r['runs'][name]['peak']}")
    if runs["dense_migrate"]["tokens"] != runs["dense"]["tokens"]:
        failed.append("dense migrate: the stream differs from the uninterrupted run's")
    for ref, got in (("dense", "dense_drop"), ("engine", "engine_revoked")):
        try:
            div = hold_engine_streams(runs[ref], runs[got], logits[ref], logits[got],
                                      tag=f"mserve {got}")
            log(f"[mserve] {got}: {SERVE_B - len(div)} of {SERVE_B} rows equal to {ref}'s in "
                f"full, divergences {div}")
        except AssertionError as e:
            failed.append(str(e))
    try:
        div = hold_engine_streams(one_card, runs["dense"], one_card_logits, logits["dense"],
                                  revoke=-1, tag="mserve dense against one card")
        log(f"[mserve] dense over {n} rank(s) against phase 9's one-card run (batch "
            f"{SERVE_B} on one card): {SERVE_B - len(div)} of {SERVE_B} rows equal in full, "
            f"divergences {div}")
    except AssertionError as e:
        failed.append(str(e))
    # the reduced f32 runs on the cards equal the same world on the CPU
    for name, got in world["reduced"].items():
        want = cpu[name]
        differ = [k for k in got if k not in MSERVE_TIMINGS and got[k] != want.get(k)]
        log(f"[mserve] reduced f32 {name} over {n} rank(s): columns other than timings equal "
            f"to the CPU world's: {not differ and set(got) == set(want)}; params_bytes "
            f"{got['params_bytes']} (received {got['params_received']}), cache_bytes "
            f"{got['cache_bytes']} (received {got['cache_received']}), cache_gather_bytes "
            f"{got['cache_gather_bytes']}")
        if differ or set(got) != set(want):
            failed.append(f"reduced f32 {name}: the cards' world differs from the CPU's: {differ}")
        if got["params_received"] != got["params_bytes"] or \
                got["cache_received"] != got["cache_bytes"]:
            failed.append(f"reduced f32 {name}: a move received other bytes than priced")
    launches = dict.fromkeys(read_launches(), 0)
    reduced = dict.fromkeys(launches, 0)
    for r in ranks:
        for rec in r["runs"].values():
            launches = {k: launches[k] + v for k, v in rec["launches"].items()}
        reduced = {k: reduced[k] + v for k, v in r["reduced_launches"].items()}
    try:
        hold_f32_launches("mserve", reduced, "flash_attention_tf32", "paged_attention_fma")
    except AssertionError as e:
        failed.append(str(e))
    if failed:
        raise AssertionError("phase 21: " + "; ".join(failed))
    return {"serve_multi": launches, "serve_multi_f32": reduced}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernels-only", action="store_true",
                    help="stop after building and checking the kernels")
    ap.add_argument("--paged-only", action="store_true",
                    help="only build the kernels and check the paged kernel and its int8 "
                         "variants")
    ap.add_argument("--spot-only", action="store_true",
                    help="only build the kernels and run the spot provisioner's phase")
    ap.add_argument("--serve-plan-only", action="store_true",
                    help="only build the kernels and run the spot serving phase")
    ap.add_argument("--moe-only", action="store_true",
                    help="only build the kernels, hold the flash kernels at mixtral's training "
                         "shape and run the MoE phase")
    ap.add_argument("--dense-variants-only", action="store_true",
                    help="only build the kernels, hold them at the dense variants' shapes and "
                         "run the dense variants' phase")
    ap.add_argument("--gemma-only", action="store_true",
                    help="only build the kernels, hold them at head dim 256 and run gemma-7b's "
                         "phase")
    ap.add_argument("--whisper-only", action="store_true",
                    help="only build the kernels, hold the flash kernels at whisper-tiny's shapes "
                         "and run whisper-tiny's phase")
    ap.add_argument("--hybrid-train-only", action="store_true",
                    help="only build the kernels, hold the flash kernels at hymba-1.5b's "
                         "training shape and the scan's backward, and run hymba's training phase")
    ap.add_argument("--xlstm-train-only", action="store_true",
                    help="only build the kernels, hold the tensor-core mLSTM's two designs, "
                         "the mLSTM's backward and the sLSTM's kernels and run xlstm-350m's "
                         "training phase")
    ap.add_argument("--whisper-plan-only", action="store_true",
                    help="only build the kernels, hold the flash kernels at whisper-tiny's shapes "
                         "and run whisper-tiny on the launcher's dense plans")
    ap.add_argument("--vlm-train-only", action="store_true",
                    help="only build the kernels, hold the flash kernels at internvl2-26b's "
                         "training shape and run its training phase")
    ap.add_argument("--xlstm-dots-only", action="store_true",
                    help="only build the kernels and run xlstm-350m's training under remat "
                         "'dots' beside 'full'")
    ap.add_argument("--dryrun-only", action="store_true",
                    help="only build the kernels and hold the dry run's estimate against two "
                         "training steps on the card")
    ap.add_argument("--multi-device-only", action="store_true",
                    help="only build the kernels and run phase 20 over 4 cards or more "
                         "(exits non-zero with fewer)")
    ap.add_argument("--multi-serve-only", action="store_true",
                    help="only build the kernels and run phase 21 over 4 cards or more "
                         "(exits non-zero with fewer)")
    ap.add_argument("--xlstm-orders", action="store_true",
                    help="only build the kernels and report how bf16 xlstm prefill logits "
                         "of the kernel paths and plain orders agree, by prompt length")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: the port is not beside this script ({SRC / 'repro_torch'})",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch.kernels import _build

    t_start = time.perf_counter()
    device_name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    smi_line = smi.stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[phase 1/21] [device] {device_name}; {smi_line}; torch {torch.__version__}, "
        f"cuda {torch.version.cuda}")

    log("[phase 2/21] build")
    _build.build()
    ptxas = _build.last_build["log"]
    per_source = {}
    for section in ptxas.split("== ")[1:]:        # one section per source (_build.build)
        src, _, text = section.partition("\n")
        regs = [int(n) for n in re.findall(r"Used (\d+) registers", text)]
        spill = sum(int(a) + int(b) for a, b in
                    re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill loads", text))
        per_source[src.strip()] = f"max {max(regs, default=0)} registers, {spill} spill bytes"
    log(f"[build] {len(_build.sources())} sources in {_build.last_build['seconds']:.1f} s "
        f"-> {_build.last_build['path']}; ptxas per source (all instantiations): {per_source}")
    # this slice's kernels, per entry function: registers and spill bytes (none allowed)
    spills = {}
    for entry in ptxas.split("Compiling entry function '")[1:]:
        fn = entry.split("'", 1)[0]
        if any(key in fn for key in NO_SPILL_KERNELS):
            regs = re.findall(r"Used (\d+) registers", entry)
            spill = sum(int(a) + int(b) for a, b in
                        re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill loads", entry))
            spills[fn] = (int(regs[0]) if regs else None, spill)
    log("[build] ptxas of " + ", ".join(NO_SPILL_KERNELS) + ": " + "; ".join(
        f"{re.sub(r'^_ZN.*?_cu_[0-9a-f]+', '', fn)[:70]}: {r} registers, {sp} spill bytes"
        for fn, (r, sp) in spills.items()))
    if ptxas != "(cached)" and (not spills or any(sp for _, sp in spills.values())):
        raise AssertionError("a kernel of this slice spills registers (or was not compiled)")
    _build.load()
    if args.xlstm_orders:
        xlstm_orders()
        return 0
    if args.paged_only:
        gen = torch.Generator(device="cuda").manual_seed(0)
        flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
        recs = [*check_paged(gen, flush), *check_paged_int8(gen, flush)]
        del flush
        log(json.dumps({"kernels": recs}))
        log(f"chip_smoke: --paged-only, {time.perf_counter() - t_start:.1f} s in all")
        return 0
    if args.spot_only:
        log("[phase 8/21] the spot provisioner")
        spot = {"spot": spot_full_width(), "spot_f32": spot_reduced_matches_cpu(),
                "spot_launch": spot_launcher()}
        log(f"chip_smoke: --spot-only, launches by path {spot}; "
            f"{time.perf_counter() - t_start:.1f} s in all")
        return 0
    if args.serve_plan_only:
        log("[phase 9/21] spot serving")
        paths = spot_serving()
        log(f"chip_smoke: --serve-plan-only, launches by path {paths}; "
            f"{time.perf_counter() - t_start:.1f} s in all")
        return 0
    if args.moe_only:
        flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
        check_flash_window_8192(torch.Generator(device="cuda").manual_seed(0), flush)
        del flush
        log("[phase 10/21] the MoE family")
        paths = moe_phase()
        log(f"chip_smoke: --moe-only, launches by path {paths}; "
            f"{time.perf_counter() - t_start:.1f} s in all")
        return 0
    if args.dense_variants_only:
        flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
        check_dense_variant_kernels(torch.Generator(device="cuda").manual_seed(0), flush)
        del flush
        log("[phase 11/21] the dense variants")
        paths = dense_variants_phase()
        log(f"chip_smoke: --dense-variants-only, launches by path {paths}; "
            f"{time.perf_counter() - t_start:.1f} s in all")
        return 0
    if args.gemma_only:
        flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
        check_gemma_kernels(torch.Generator(device="cuda").manual_seed(0), flush)
        del flush
        log("[phase 12/21] gemma-7b")
        paths = gemma_phase()
        log(f"chip_smoke: --gemma-only, launches by path {paths}; "
            f"{time.perf_counter() - t_start:.1f} s in all")
        return 0
    if args.whisper_only:
        flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
        check_slice14_attention(torch.Generator(device="cuda").manual_seed(0), flush, "whisper")
        del flush
        log("[phase 13/21] whisper-tiny")
        paths = whisper_phase()
        log(f"chip_smoke: --whisper-only, launches by path {paths}; "
            f"{time.perf_counter() - t_start:.1f} s in all")
        return 0
    if args.hybrid_train_only:
        flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
        gen = torch.Generator(device="cuda").manual_seed(0)
        check_slice14_attention(gen, flush, "hymba")
        check_ssm_scan_bwd(gen, flush)
        del flush
        log("[phase 14/21] hymba-1.5b training")
        paths = hybrid_train_phase()
        log(f"chip_smoke: --hybrid-train-only, launches by path {paths}; "
            f"{time.perf_counter() - t_start:.1f} s in all")
        return 0
    if args.xlstm_train_only:
        flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
        gen = torch.Generator(device="cuda").manual_seed(0)
        recs = [check_mlstm_tc_designs(gen, flush), check_mlstm_bwd(gen, flush),
                check_slstm(gen, flush), check_slstm_bwd(gen, flush)]
        for r, err in zip(recs[2:], check_slstm_wide(gen, flush).values()):
            r["max_abs_err"] = max(r["max_abs_err"], err)
        slstm_wide_model_matches_cpu()
        del flush
        log(json.dumps({"kernels": recs}))
        log("[phase 15/21] xlstm-350m training")
        paths = xlstm_train_phase()
        log(f"chip_smoke: --xlstm-train-only, launches by path {paths}; "
            f"{time.perf_counter() - t_start:.1f} s in all")
        return 0

    if args.whisper_plan_only:
        flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
        check_slice14_attention(torch.Generator(device="cuda").manual_seed(0), flush, "whisper")
        del flush
        log("[phase 16/21] whisper-tiny on the launcher's plans")
        paths = whisper_plan_phase()
        log(f"chip_smoke: --whisper-plan-only, launches by path {paths}; "
            f"{time.perf_counter() - t_start:.1f} s in all")
        return 0
    if args.vlm_train_only:
        flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
        check_slice14_attention(torch.Generator(device="cuda").manual_seed(0), flush,
                                "internvl2")
        del flush
        log("[phase 17/21] internvl2-26b training")
        paths = vlm_train_phase()
        log(f"chip_smoke: --vlm-train-only, launches by path {paths}; "
            f"{time.perf_counter() - t_start:.1f} s in all")
        return 0
    if args.dryrun_only:
        log("[phase 19/21] the dry run against the card")
        paths = dryrun_phase()
        log(f"chip_smoke: --dryrun-only, launches by path {paths}; "
            f"{time.perf_counter() - t_start:.1f} s in all")
        return 0
    if args.multi_device_only:
        if torch.cuda.device_count() < MULTI_RANKS:
            print(f"chip_smoke: --multi-device-only needs {MULTI_RANKS} cards, "
                  f"{torch.cuda.device_count()} present", file=sys.stderr)
            return 2
        log("[phase 20/21] multi-device execution")
        paths = multi_device_phase()
        log(f"chip_smoke: --multi-device-only, launches by path {paths}; "
            f"{time.perf_counter() - t_start:.1f} s in all")
        return 0
    if args.multi_serve_only:
        if torch.cuda.device_count() < MSERVE_RANKS:
            print(f"chip_smoke: --multi-serve-only needs {MSERVE_RANKS} cards, "
                  f"{torch.cuda.device_count()} present", file=sys.stderr)
            return 2
        log("[phase 21/21] serving over torch.distributed")
        paths = multi_serve_phase()
        log(f"chip_smoke: --multi-serve-only, launches by path {paths}; "
            f"{time.perf_counter() - t_start:.1f} s in all")
        return 0
    if args.xlstm_dots_only:
        log("[phase 18/21] xlstm-350m training under remat dots")
        paths = xlstm_dots_phase()
        log(f"chip_smoke: --xlstm-dots-only, launches by path {paths}; "
            f"{time.perf_counter() - t_start:.1f} s in all")
        return 0

    log("[phase 3/21] kernels against their plain versions")
    gen = torch.Generator(device="cuda").manual_seed(0)
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    records = [*check_flash(gen, flush), *check_paged(gen, flush),
               *check_paged_int8(gen, flush), *check_flash_bwd(gen, flush),
               check_ssm_scan(gen, flush), check_ssm_scan_bwd(gen, flush),
               *check_mlstm(gen, flush), check_mlstm_bwd(gen, flush), check_slstm(gen, flush),
               check_slstm_bwd(gen, flush)]
    for kernel_name, err in check_slstm_wide(gen, flush).items():
        rec = next(r for r in records if r["name"] == kernel_name)
        rec["max_abs_err"] = max(rec["max_abs_err"], err)
    bwd_digests()
    fwd_digests()
    for more in (check_flash_window_8192(gen, flush), check_dense_variant_kernels(gen, flush),
                 check_gemma_kernels(gen, flush), check_slice14_attention(gen, flush)):
        for kernel_name, err in more.items():
            rec = next(r for r in records if r["name"] == kernel_name)
            rec["max_abs_err"] = max(rec["max_abs_err"], err)
    del flush
    if args.kernels_only:
        log(json.dumps({"kernels": records}))
        log("chip_smoke: --kernels-only, stopped before serving")
        return 0
    paths = {"slstm_wide_f32": slstm_wide_model_matches_cpu()}

    log("[phase 4/21] serving")
    paths["serve"] = serve_full_width()
    paths["serve_f32"] = serve_reduced_matches_cpu()
    gc.collect()
    torch.cuda.empty_cache()
    log("[phase 5/21] hybrid serving")
    paths["hybrid"] = serve_hybrid_full_width()
    paths["hybrid_f32"] = greedy_reduced_matches_cpu("hymba-1.5b", "hybrid",
                                                     "flash_attention_tf32", "ssm_scan")
    gc.collect()
    torch.cuda.empty_cache()
    log("[phase 6/21] xLSTM serving")
    paths["xlstm"] = serve_xlstm_full_width()
    paths["xlstm_f32"] = greedy_reduced_matches_cpu("xlstm-350m", "xlstm", "mlstm_tf32",
                                                    "mlstm_step", "slstm")
    gc.collect()
    torch.cuda.empty_cache()
    log("[phase 7/21] training")
    paths["train"] = train_full_width()
    paths["train_f32"] = train_reduced_matches_cpu()
    gc.collect()
    torch.cuda.empty_cache()
    log("[phase 8/21] the spot provisioner")
    paths["spot"] = spot_full_width()
    gc.collect()
    torch.cuda.empty_cache()
    paths["spot_f32"] = spot_reduced_matches_cpu()
    paths["spot_launch"] = spot_launcher()
    gc.collect()
    torch.cuda.empty_cache()
    log("[phase 9/21] spot serving")
    paths.update(spot_serving())
    gc.collect()
    torch.cuda.empty_cache()
    log("[phase 10/21] the MoE family")
    paths.update(moe_phase())
    gc.collect()
    torch.cuda.empty_cache()
    log("[phase 11/21] the dense variants")
    paths.update(dense_variants_phase())
    gc.collect()
    torch.cuda.empty_cache()
    log("[phase 12/21] gemma-7b")
    paths.update(gemma_phase())
    gc.collect()
    torch.cuda.empty_cache()
    log("[phase 13/21] whisper-tiny")
    paths.update(whisper_phase())
    gc.collect()
    torch.cuda.empty_cache()
    log("[phase 14/21] hymba-1.5b training")
    paths.update(hybrid_train_phase())
    gc.collect()
    torch.cuda.empty_cache()
    log("[phase 15/21] xlstm-350m training")
    paths.update(xlstm_train_phase())
    gc.collect()
    torch.cuda.empty_cache()
    log("[phase 16/21] whisper-tiny on the launcher's plans")
    paths.update(whisper_plan_phase())
    gc.collect()
    torch.cuda.empty_cache()
    log("[phase 17/21] internvl2-26b training")
    paths.update(vlm_train_phase())
    gc.collect()
    torch.cuda.empty_cache()
    log("[phase 18/21] xlstm-350m training under remat dots")
    paths.update(xlstm_dots_phase())
    gc.collect()
    torch.cuda.empty_cache()
    log("[phase 19/21] the dry run against the card")
    paths.update(dryrun_phase())
    gc.collect()
    torch.cuda.empty_cache()
    log("[phase 20/21] multi-device execution")
    paths.update(multi_device_phase())
    gc.collect()
    torch.cuda.empty_cache()
    log("[phase 21/21] serving over torch.distributed")
    paths.update(multi_serve_phase())
    for r in records:     # a record at a second shape reads its kernel's counter
        r["launches_by_path"] = {path: counts[r.get("counter", r["name"])]
                                 for path, counts in paths.items()}
        r["launches"] = sum(r["launches_by_path"].values())
    keys = ("name", "route", "source", "replaces", "launches", "launches_by_path",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    log(f"[done] {time.perf_counter() - t_start:.1f} s in all")
    print(smi_line)
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in records]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": device_name,
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
