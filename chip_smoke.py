#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA H100.

    python3 chip_smoke.py                 # the whole check, one card
    python3 chip_smoke.py --kernels-only  # build + kernel checks only
    python3 chip_smoke.py --spot-only     # build + the spot provisioner's phase only
    python3 chip_smoke.py --serve-plan-only  # build + the spot serving phase only

Phases, each of which raises on a failed check (so the exit code is not 0):

1. device: the card's name and power limit (``nvidia-smi``); TF32 off;
2. build: compile ``src/repro_torch/csrc/*.cu`` for sm_90a (``kernels/_build.py``),
   one nvcc per source, all in parallel;
3. kernels: each hand-written kernel (flash forward, paged decode, the two
   flash backward kernels, the selective scan, the chunkwise mLSTM) against
   its plain PyTorch version on the card, on the reference's test shapes
   and at the main paths' shapes, with times (CUDA events, L2 flushed
   between launches) beside the bound. The flash forward, dk/dv and dq
   have two variants each, by dtype: bf16 on tensor cores (wgmma fed by
   TMA), f32 on FMAs; every feature case runs in both dtypes. The paged
   kernel (split over positions, then merged) has two: bf16 scores and P.V
   on tensor cores (mma.sync), f32 on FMAs. The scan has a prefill kernel
   and a decode kernel (S <= 4), picked by S. The mLSTM's model calls go
   to a one-pass decode step (S <= 8) or a chunkwise kernel: bf16 on
   tensor cores, f32 (and head dims the tensor cores do not take) on
   FMAs, both held in both dtypes. Two calls on the same inputs give the
   same bits for the bf16 dq, the paged kernel, the scan, the tensor-core
   mLSTM and the step; the new kernels build with no spilled registers;
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
   decode step through the one-pass step (20 x 31), and nothing else; on
   one prompt, every mLSTM call of the bf16 prefill gives the same h and
   state as the plain chunkwise form on its own inputs; the bf16 prefill
   of all 8 prompts' first 32 tokens is no farther from an f32 reference
   than 1.5 x two plain bf16 orders are, and its mLSTM h no farther from
   an f64 recurrence than the plain form's (``compare_xlstm_paths``; the
   FMA kernel's path is measured beside it); f32 prefill logits on 4096
   tokens agree with the plain path's; a reduced model's f32 streams on
   the card equal the CPU's;
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
   > 0.99); 36 flash launches a prefill and 36 paged ones a decode step;
   reduced f32 in the five runs on the card equals the CPU in every
   column but the timings. Then ``FleetSimulator`` in engine mode, priced
   by the engine's tokens/s and the revoked run's tracker, runs the serve
   bench's policies on its markets and quick traces: token conservation,
   every migration below the training path's bytes, and a replay of its
   trace with 0 mismatches are held; the CSV rows are printed.

A kernel variant's ``launches_by_path`` in the JSON record holds its count
on each path (``serve``, ``hybrid``, ``xlstm``, ``train``, ``spot`` at full width
in bf16, the reduced f32 runs ``serve_f32``, ``hybrid_f32``, ``xlstm_f32``,
``train_f32``, ``spot_f32``, the launcher's reduced bf16 ``spot_launch``, and
the plan modes' ``serve_plan`` and ``serve_plan_f32``), each counted from 0
just before each run of that path and read
just after; ``launches`` is their sum. The full-width paths launch only the
tensor-core variants, the f32 runs only the FMA ones. The last three lines of stdout are the card's name and power limit, the
per-kernel JSON record and ``{"ok": true, "device": {...}}``. Without a CUDA device, or without the
repository beside this file, the script prints no result and exits 2.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import math
from pathlib import Path
import re
import subprocess
import sys
import time

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
SRC = REPO / "src"

# kernels that must build without spilling registers (ptxas): the paged
# split and merge, the mLSTM decode step and its tensor-core prefill, the
# scan's prefill and decode kernels
NO_SPILL_KERNELS = ("paged_split_fma_kernel", "paged_split_tc_kernel", "paged_merge_kernel",
                    "mlstm_step_kernel", "mlstm_tc_kernel", "ssm_scan_kernel", "ssm_step_kernel")
# NVIDIA H100 SXM data sheet: dense bf16 tensor-core rate and HBM3 bandwidth
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12       # f32 outside the tensor cores
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
# inputs and sum in f32 in other orders (chunk 32 vs 256), so h (bf16) may
# differ by one bf16 ulp (rtol 1e-2 covers 2^-7 |h|) and the state by f32
# rounding over 4096 steps.
MLSTM_MAIN_H_TOL = dict(atol=1e-3, rtol=1e-2)
MLSTM_MAIN_STATE_TOL = dict(atol=1e-4, rtol=1e-3)
MLSTM_MAIN_TOLS = dict(h=MLSTM_MAIN_H_TOL, C=MLSTM_MAIN_STATE_TOL, n=MLSTM_MAIN_STATE_TOL,
                       m=MLSTM_M_TOL)
# the chunk at which the mLSTM's bound counts the intra-chunk products: a
# fixed yardstick, whatever chunk a kernel variant uses (the tensor-core
# kernel's 64, the FMA kernel's 32)
MLSTM_BOUND_CHUNK = 32
# the JAX test's tolerance for the scan's final state (y takes tol(dtype))
SSM_H_TOL = dict(atol=1e-4, rtol=1e-4)
# hymba's main-path shapes (u bf16, dt/B_/C_ f32), held tighter than the
# JAX test's after a first H100 run showed the errors: y (bf16) up to one
# bf16 ulp (3.1e-2 at |y| in [4, 8); 6.25e-2 in [8, 16)), which rtol 1e-2
# covers (an ulp is at most 2^-7 |y|); h (f32) up to 7.7e-7 with expf,
# 2.9e-6 with ex2.approx, against 1e-5 here.
SSM_MAIN_Y_TOL = dict(atol=1e-3, rtol=1e-2)
SSM_MAIN_H_TOL = dict(atol=1e-5, rtol=1e-5)
# The forward's lse (f32, natural log, ~5-10 here) is computed from the same
# rounded inputs on both sides at every dtype, so the f32 tolerance holds.
LSE_TOL = F32_TOL


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


def hold(name: str, out: torch.Tensor, ref: torch.Tensor, t: dict) -> float:
    """Raise unless out is finite and |out - ref| <= atol + rtol |ref|
    everywhere; return the max abs error."""
    err, ok = within(out, ref, t)
    log(f"  {name}: max_abs_err={err:.3e} (atol={t['atol']}, rtol={t['rtol']}) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with its plain version")
    return err


def time_ms(fn, flush: torch.Tensor, reps: int = 10, warmup: int = 2,
            clean: bool = False) -> float:
    """Mean device time of one call, CUDA events around each call, with the
    L2 cache flushed before each (the main path finds it cold): by writing
    the 256 MB buffer, or with ``clean`` by reading it, so that no dirty
    line is written back during the call."""
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
    return sum(s.elapsed_time(e) for s, e in pairs) / reps


def bound(flops: float, nbytes: float, peak_flops: float) -> tuple:
    t_ops, t_bytes = flops / peak_flops * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _counters() -> dict:
    """Every kernel variant's launch counter, as (module, attribute), by the
    name its JSON record carries."""
    from repro_torch.kernels.flash_attention import kernel, kernel_bwd
    from repro_torch.kernels.mlstm import kernel as mlstm
    from repro_torch.kernels.paged_attention import kernel as paged
    from repro_torch.kernels.ssm_scan import kernel as scan

    return {"flash_attention_tc": (kernel, "launches_tc"),
            "flash_attention_fma": (kernel, "launches_fma"),
            "paged_attention_tc": (paged, "launches_tc"),
            "paged_attention_fma": (paged, "launches_fma"),
            "flash_attention_bwd_dkdv_tc": (kernel_bwd, "launches_dkdv_tc"),
            "flash_attention_bwd_dkdv_fma": (kernel_bwd, "launches_dkdv_fma"),
            "flash_attention_bwd_dq_tc": (kernel_bwd, "launches_dq_tc"),
            "flash_attention_bwd_dq_fma": (kernel_bwd, "launches_dq_fma"),
            "ssm_scan": (scan, "launches"), "mlstm_tc": (mlstm, "launches_tc"),
            "mlstm_fma": (mlstm, "launches_fma"), "mlstm_step": (mlstm, "launches_step")}


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


def _flash_fwd_work(B, S, H, KVH, hd, window=0) -> tuple:
    """(flop, bytes) the causal forward needs: QK^T and PV over the live
    (q, k) pairs, 2 flops per multiply-add; q, k, v read and o written once
    (bf16), lse written once (f32)."""
    pairs = S * (S + 1) // 2 if not window else \
        window * (window + 1) // 2 + (S - window) * window
    return 4.0 * pairs * hd * H * B, 2.0 * (2 * B * S * H * hd + 2 * B * S * KVH * hd) + 4.0 * B * H * S


def check_flash(gen: torch.Generator, flush: torch.Tensor) -> list:
    """The forward's two variants (bf16: tensor cores; f32: FMAs) against
    ``attention_fwd_ref`` on the reference's cases and each feature of the
    kernels (head dims, window, q offset, ragged and non-causal lengths, S
    not a multiple of 128) in both dtypes, and at the main paths' shapes;
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
    (q32, k32, v32, kw32), e = case("flash main-path S1000 H32/8 hd128 f32", 1, 1000, 1000, 32,
                                    8, 128, True, 0, 0, torch.float32)
    errs[torch.float32] = max(errs[torch.float32], e)
    main = {S: case(f"flash main-path S{S} H32/8 hd128 bf16",
                    1, S, S, 32, 8, 128, True, 0, 0, torch.bfloat16, FLASH_MAIN_BF16_TOL)
            for S in (129, 1000, 2000, 4096)}       # 2000: serving's longest; 4096: training
    errs[torch.bfloat16] = max([errs[torch.bfloat16], *(e for _, e in main.values())])
    errs[torch.bfloat16] = max(errs[torch.bfloat16], check_flash_hymba(gen, flush))

    def timed(args, peak, tag):
        q, k, v, kw = args
        B, S, H, hd = q.shape
        flops, nbytes = _flash_fwd_work(B, S, H, k.shape[2], hd)
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
            dict(rec, name="flash_attention_fma", max_abs_err=errs[torch.float32],
                 **timed((q32, k32, v32, kw32), PEAK_F32_FLOPS, "f32 variant"))]


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
    flops, nbytes = _flash_fwd_work(B, S, H, KVH, hd, window)
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
    first against ``attention_fwd_ref``. Each kernel runs its tensor-core
    variant in bf16 and its FMA one in f32: every feature case runs in both
    dtypes. One record per variant; the bf16 dq gives the same bits twice."""
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
        variant = "tc" if dtype == torch.bfloat16 else "fma"
        errs["dkdv_" + variant] = max(errs["dkdv_" + variant], hold(f"{name} dk", dk, rk, t),
                                      hold(f"{name} dv", dv, rv, t))
        errs["dq_" + variant] = max(errs["dq_" + variant], hold(f"{name} dq", dq, rq, t))
        return q, k, v, do, lse, delta, kw

    log("[kernels] flash_attention_bwd (dkdv, dq) vs attention_bwd_ref")
    errs = {"dkdv_tc": 0.0, "dkdv_fma": 0.0, "dq_tc": 0.0, "dq_fma": 0.0}
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
        """The function's least work: 5 products (s, dp, dv, dk, dq), each
        input read once, each output written once. It is split over the
        dkdv and dq rows so that their bounds add up to it: dkdv carries s,
        dp, dv, dk, the inputs and dk, dv; dq its own product and dq. That dq
        computes s and dp again (7 products in all, no atomics), and that
        the tensor-core kernels multiply hi and lo halves of p and ds, is
        each design's overhead, in its ms."""
        B, S, H, hd = q.shape
        KVH, el = k.shape[2], q.element_size()
        prod = 2.0 * S * (S + 1) // 2 * hd * H * B      # one causal (S x S x hd) product
        in_bytes = el * (2 * B * S * H * hd + 2 * B * S * KVH * hd) + 2 * 4.0 * B * H * S
        return {"dkdv": (4 * prod, in_bytes + el * 2 * B * S * KVH * hd),
                "dq": (prod, el * B * S * H * hd)}

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
            "dkdv_fma": (f32_args, "dkdv", PEAK_F32_FLOPS, plain32_ms, lib32_ms),
            "dq_fma": (f32_args, "dq", PEAK_F32_FLOPS, plain32_ms, lib32_ms)}
    fns = {"dkdv": kernel_bwd.flash_attention_bwd_dkdv, "dq": kernel_bwd.flash_attention_bwd_dq}
    lines = {"dkdv": 55, "dq": 111}
    records = []
    for name, (args, which, peak, p_ms, l_ms) in runs.items():
        flops, nbytes = work(args[0], args[1])[which]
        b_ms, b_by = bound(flops, nbytes, peak)
        ms = time_ms(lambda: fns[which](*args[:6], **args[6]), flush)
        log(f"  {name} (S{args[0].shape[1]} {str(args[0].dtype)[6:]}): kernel {ms:.4f} ms, bound "
            f"{b_ms:.4f} ms ({b_by}); {flops / ms / 1e9:.1f} TFLOP/s of the function's work "
            f"achieved; plain {p_ms:.4f} ms, SDPA backward {l_ms:.4f} ms (whole backward)")
        records.append(dict(
            name=f"flash_attention_bwd_{name}", route="cuda",
            source="src/repro_torch/csrc/flash_attention_bwd.cu",
            replaces=f"src/repro/kernels/flash_attention/kernel_bwd.py:{lines[which]}",
            max_abs_err=errs[name], ms=ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
            library_ms=l_ms))
    return records


def sdpa_backward_ms(q, k, v, do, flush) -> float:
    """PyTorch's SDPA backward at the same shapes: autograd through
    ``scaled_dot_product_attention`` (fwd + bwd) minus its forward alone,
    with k and v repeated to H heads; the flash backend in bf16, the
    memory-efficient one in f32 (flash takes no f32)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    G = q.shape[2] // k.shape[2]
    qt = q.transpose(1, 2).detach().requires_grad_()
    kt = k.repeat_interleave(G, dim=2).transpose(1, 2).detach().requires_grad_()
    vt = v.repeat_interleave(G, dim=2).transpose(1, 2).detach().requires_grad_()
    dot = do.transpose(1, 2)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    backend = (SDPBackend.FLASH_ATTENTION if q.dtype == torch.bfloat16
               else SDPBackend.EFFICIENT_ATTENTION)

    def fwd_bwd():
        for t in (qt, kt, vt):
            t.grad = None
        sdpa(qt, kt, vt, is_causal=True).backward(dot)

    with sdpa_kernel(backend):
        both = time_ms(fwd_bwd, flush)
        with torch.no_grad():
            fwd = time_ms(lambda: sdpa(qt, kt, vt, is_causal=True), flush)
    return both - fwd


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


def check_paged(gen: torch.Generator, flush: torch.Tensor) -> list:
    """The split-and-merge paged kernel in both dtypes (bf16 on tensor
    cores, f32 on FMAs) against ``paged_attention_ref`` on the reference's cases, the
    split's edges, a dead lane and the serving main path's shape; at that
    shape also against the plain split form, and two calls giving the same
    bits. One record per dtype."""
    from repro_torch.kernels.paged_attention import kernel
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

    n_tok = sum(lens)
    n_pages = sum(-(-n // 16) for n in lens)
    records = []
    for dtype in (torch.bfloat16, torch.float32):
        args = main[dtype]
        el = args[0].element_size()
        flops = 4.0 * n_tok * 32 * 128
        nbytes = el * (2 * 8 * 32 * 128 + 2 * n_tok * 8 * 128) + 4.0 * (n_pages + 8)
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
            name = re.sub(r"^.*::", "", e.key.split("<")[0])
            out[name] = e.self_device_time_total / e.count / 1e3
    return out


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
        """(flop, bytes): each input read once (h0 too), y and h written once."""
        B, S, inner = u.shape
        N = A.shape[1]
        nbytes = (u.numel() * u.element_size() * 2 + 4.0 * (dt.numel() + B_.numel()
                  + C_.numel() + A.numel() + D.numel() + 2 * h0.numel()))
        # per (b, t, i, n): dt*A, exp, dt*B, da*h, db*u, +, h*C, + (8); per (b, t, i): D*u, +
        return 8.0 * B * S * inner * N + 2.0 * B * S * inner, nbytes

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


def check_mlstm(gen: torch.Generator, flush: torch.Tensor) -> list:
    """The chunkwise mLSTM's three kernels (S <= ``STEP_MAX``: the one-pass
    decode step; longer: the bf16 tensor-core kernel, and the FMA kernel,
    both dtypes, which takes f32 and other head dims), each through its own
    wrapper, against ``mlstm_ref`` (the sequential oracle) on the JAX
    test's cases, ragged S with a carried state and two calls carrying the
    state, and against ``mlstm_chunkwise_ref`` at xlstm-350m's prefill and
    decode shapes; two calls of the tensor-core kernel and of the step give
    the same bits. One record per kernel."""
    from repro_torch.kernels.mlstm import kernel, ops
    from repro_torch.kernels.mlstm.ref import mlstm_chunkwise_ref, mlstm_ref

    def variants(S, dtype):
        """(name, function) of each kernel that takes these inputs."""
        if S <= kernel.STEP_MAX:
            return [("step", ops.mlstm)]
        return [("fma", kernel.mlstm_fma)] + ([("tc", kernel.mlstm_tc)]
                                              if dtype == torch.bfloat16 else [])

    errs = {"tc": 0.0, "fma": 0.0, "step": 0.0}

    def against_oracle(name, B, S, H, hd, dtype, with_state=False, h_tol=None):
        q, k, v, gates, state = _mlstm_inputs(gen, B, S, H, hd, dtype, with_state)
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
            errs[var] = max(errs[var], err)

    log("[kernels] mlstm (one-pass step, FMA, tensor cores) vs mlstm_ref (h, C, n, m) and "
        "mlstm_chunkwise_ref")
    for B, H, S, hd, dtype in MLSTM_CASES:
        against_oracle(f"mlstm B{B} H{H} S{S} hd{hd} {str(dtype)[6:]}", B, S, H, hd, dtype)
    against_oracle("mlstm ragged S100 with state B2 H2 hd96 f32", 2, 100, 2, 96, torch.float32,
                   with_state=True)
    against_oracle("mlstm ragged S100 with state B2 H2 hd128 bf16", 2, 100, 2, 128,
                   torch.bfloat16, with_state=True)
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

    # xlstm-350m's prefill shape, against the plain chunkwise form at chunk 256
    B, S, H, hd, chunk = 8, 4096, 4, 512, 256
    q, k, v, gates, _ = _mlstm_inputs(gen, B, S, H, hd, torch.bfloat16)
    hr, (Cr, nr, mr) = mlstm_chunkwise_ref(q, k, v, gates, None, chunk)
    for var, fn in variants(S, torch.bfloat16):
        h, (C, n, m) = fn(q, k, v, gates)
        torch.cuda.synchronize()
        name = f"mlstm main-path prefill B{B} S{S} H{H} hd{hd} bf16 [{var}]"
        errs[var] = max(errs[var], hold(f"{name} h", h, hr, MLSTM_MAIN_H_TOL),
                        hold(f"{name} C", C, Cr, MLSTM_MAIN_STATE_TOL),
                        hold(f"{name} n", n, nr, MLSTM_MAIN_STATE_TOL))
        hold(f"{name} m", m, mr, MLSTM_M_TOL)
        if var == "tc":
            h2, (C2, n2, m2) = fn(q, k, v, gates)
            same = all(torch.equal(x, y) for x, y in zip((h, C, n, m), (h2, C2, n2, m2)))
            log(f"  {name}: two calls give the same bits: {same}")
            if not same:
                raise AssertionError("the tensor-core mLSTM gave different bits on the same "
                                     "inputs")
            del h2, C2, n2, m2
        del h, C, n, m
    del hr, Cr, nr, mr
    dq, dk, dv, dg, dstate = _mlstm_inputs(gen, B, 1, H, hd, torch.bfloat16, with_state=True)
    outs = [ops.mlstm(dq, dk, dv, dg, dstate) for _ in range(2)]
    same = all(torch.equal(x, y) for x, y in zip((outs[0][0], *outs[0][1]),
                                                  (outs[1][0], *outs[1][1])))
    log(f"  mlstm main-path decode S1: two step calls give the same bits: {same}")
    if not same:
        raise AssertionError("the mLSTM decode step gave different bits on the same inputs")
    del outs

    def work(B, S, H, hd, el):
        """(flop, bytes) the function needs: per token and head q C^T and the
        C update (2 hd^2 flop each) and, at the fixed yardstick chunk
        MLSTM_BOUND_CHUNK, the intra-chunk q K^T and (q K^T . D) V (2 c hd
        each); q, k, v read and h written once (el bytes), the gates read
        and the state (C, n, m) written once (read too where it is
        carried: S = 1)."""
        c = MLSTM_BOUND_CHUNK
        flops = (4.0 * hd * hd + (4.0 * c * hd if S > 1 else 0.0)) * B * S * H
        state = 4.0 * B * H * (hd * hd + hd + 1)
        nbytes = el * B * S * H * hd * 4 + 4.0 * B * S * 2 * H + state * (1 if S > 1 else 2)
        return flops, nbytes

    flops, nbytes = work(B, S, H, hd, 2)
    b_ms, b_by = bound(flops, nbytes, PEAK_BF16_FLOPS)
    ms = time_ms(lambda: kernel.mlstm_fma(q, k, v, gates), flush, reps=3)
    tc_ms = time_ms(lambda: kernel.mlstm_tc(q, k, v, gates), flush)
    plain_ms = time_ms(lambda: mlstm_chunkwise_ref(q, k, v, gates, None, chunk), flush, reps=3)
    log(f"  mlstm main path (B{B} S{S} H{H} hd{hd}, q/k/v bf16): tensor-core kernel (the "
        f"path's) {tc_ms:.4f} ms, FMA kernel {ms:.4f} ms, plain (chunkwise, chunk {chunk}) "
        f"{plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}); {flops / tc_ms / 1e9:.1f} and "
        f"{flops / ms / 1e9:.1f} TFLOP/s of the function's work achieved")
    q32, k32, v32 = (x.float() for x in (q, k, v))
    del q, k, v
    f_flops, f_bytes = work(B, S, H, hd, 4)
    f_b_ms, f_by = bound(f_flops, f_bytes, PEAK_F32_FLOPS)
    f_ms = time_ms(lambda: kernel.mlstm_fma(q32, k32, v32, gates), flush, reps=3)
    f_plain_ms = time_ms(lambda: mlstm_chunkwise_ref(q32, k32, v32, gates, None, chunk), flush,
                         reps=3)
    log(f"  mlstm fma at the main path's shape in f32: kernel {f_ms:.4f} ms, plain "
        f"{f_plain_ms:.4f} ms, bound {f_b_ms:.4f} ms ({f_by}, f32 at 67 TFLOP/s)")
    del q32, k32, v32
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
            dict(rec, name="mlstm_fma", max_abs_err=errs["fma"], ms=ms, plain_ms=plain_ms,
                 bound_ms=b_ms, bound_by=b_by),
            dict(rec, name="mlstm_step", max_abs_err=errs["step"], ms=d_ms,
                 plain_ms=d_plain_ms, bound_ms=d_b_ms, bound_by=d_by)]


# ---------------------------------------------------------------------------
# phase 4: full-width serving
# ---------------------------------------------------------------------------

def serve_full_width() -> dict:
    from repro_torch.config import ShardingLayout, get_arch
    from repro_torch.models import RunOpts, build_model
    from repro_torch.serve import DecodeEngine, Request

    cfg = get_arch("qwen3-4b")
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(0), "cuda", torch.bfloat16)
    torch.cuda.synchronize()
    n_params = model.param_count()
    log(f"[serve] {cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
        f"{n_params / 1e9:.3f} B params in bf16, made on the card in "
        f"{time.perf_counter() - t0:.1f} s")

    rng = np.random.RandomState(0)
    lens = rng.randint(16, 2001, 14).tolist() + [2000, 127]
    reqs = [Request(rid=i, prompt=rng.randint(0, cfg.vocab_size, n).astype(np.int32),
                    max_new_tokens=32) for i, n in enumerate(lens)]
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
    log(f"[serve] {len(done)} requests x 32 tokens done in {wall:.2f} s; prompt lengths "
        f"{lens}; {eng.prefills} prefills, {eng.decode_steps} decode steps; pool back to "
        f"{eng.free_pages} free pages")
    log(f"[serve] launches {launches}, expected {want}")
    if launches != want or min(launches["flash_attention_tc"],
                               launches["paged_attention_tc"]) <= 0:
        raise AssertionError("the main path did not go through the kernels as expected")
    log(f"[serve] prefill {eng.prefilled_tokens / eng.prefill_seconds:.1f} tokens/s "
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
    log(f"[serve] flash vs masked prefill logits (S={S}): top-1 equal {top_eq}, "
        f"correlation {corr:.6f}, max abs diff {float((a - b).abs().max()):.4f}")
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


def serve_reduced_matches_cpu() -> dict:
    """A reduced f32 model: the engine on the card (the f32 flash variant and
    the paged kernel) must give the plain CPU engine's greedy streams token
    for token. Returns the card run's launches."""
    from repro_torch.config import ShardingLayout, get_arch
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_map
    from repro_torch.serve import DecodeEngine, Request

    cfg = dataclasses.replace(get_arch("qwen3-4b").reduced(), dtype="float32")
    model = build_model(cfg)
    params_cpu = model.init(torch.Generator().manual_seed(0), "cpu")
    params_gpu = tree_map(lambda t: t.to("cuda"), params_cpu)
    rng = np.random.RandomState(0)
    reqs = [Request(rid=i, prompt=rng.randint(0, cfg.vocab_size, n).astype(np.int32),
                    max_new_tokens=8) for i, n in enumerate((5, 17, 9, 30))]
    streams = {}
    for device, params in (("cpu", params_cpu), ("cuda", params_gpu)):
        eng = DecodeEngine(model, ShardingLayout(attn_impl="flash"), device,
                           lanes=2, num_pages=9, max_context=48)
        for r in reqs:
            eng.submit(r)
        reset_launches()
        streams[device] = {c.rid: c.tokens for c in eng.run(params)}
        launches = read_launches()
    log(f"[serve] reduced f32 streams, card vs CPU plain: "
        f"{'identical' if streams['cpu'] == streams['cuda'] else 'DIFFERENT'}")
    if streams["cpu"] != streams["cuda"]:
        raise AssertionError(f"card streams {streams['cuda']} != CPU {streams['cpu']}")
    return hold_f32_launches("serve", launches, "flash_attention_fma", "paged_attention_fma")


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


def profile_greedy(tag: str, model, params, tokens, cache, new: int) -> None:
    """Where the time goes on a serve-launcher path: one batched full-width
    prefill of ``tokens`` and three decode steps of its rows from ``cache``
    (past the served tokens), under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import RunOpts

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    opts = RunOpts(attn_impl="flash")
    B, S = tokens.shape
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        logits, _ = model.prefill(params, {"tokens": tokens}, S + new, opts)
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


def greedy_reduced_matches_cpu(arch: str, tag: str, *kernels: str) -> dict:
    """A reduced model at f32: the serve launcher's loop on the card (the
    kernels) against the same loop on the CPU (their plain versions). The
    prompt, 20 tokens, is longer than hymba's 16-slot ring (16 new tokens
    wrap it) and ragged against the mLSTM's chunks (8 on the CPU, 32 in the
    kernel). Returns the card run's launches, which must include
    ``kernels``."""
    from repro_torch.config import get_arch
    from repro_torch.launch.serve import greedy_serve
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_map

    cfg = dataclasses.replace(get_arch(arch).reduced(), dtype="float32")
    model = build_model(cfg)
    params_cpu = model.init(torch.Generator().manual_seed(0), "cpu")
    params_gpu = tree_map(lambda t: t.to("cuda"), params_cpu)
    prompt = np.random.RandomState(0).randint(0, cfg.vocab_size, (2, 20)).astype(np.int32)
    runs = {}
    for device, params in (("cuda", params_gpu), ("cpu", params_cpu)):
        reset_launches()
        runs[device] = greedy_serve(model, params, torch.as_tensor(prompt, device=device), 16)
        if device == "cuda":
            launches = read_launches()
    gpu, cpu = runs["cuda"], runs["cpu"]
    err = max(float((a.cpu() - b).abs().max()) for a, b in zip(gpu.logits, cpu.logits))
    ok = all(torch.allclose(a.cpu(), b, **REDUCED_LOGITS_TOL) for a, b in zip(gpu.logits, cpu.logits))
    same = torch.equal(gpu.tokens, cpu.tokens)
    log(f"[{tag}] reduced f32 streams, card vs CPU plain: {'identical' if same else 'DIFFERENT'}; "
        f"logits max abs diff {err:.3e} (atol {REDUCED_LOGITS_TOL['atol']}, rtol "
        f"{REDUCED_LOGITS_TOL['rtol']})")
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
    n_mlstm = groups * m_per
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

    want = expect_launches(mlstm_tc=n_mlstm, mlstm_step=n_mlstm * res.decode_steps)
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
    compare_xlstm_paths(model, params, tokens, "tc" if launches["mlstm_tc"] else "fma")
    return launches


def _xlstm_prefill(model, params, rows, chunk=None, held=None, perturb=0.0, route=None):
    """Prefill ``rows`` with the mLSTM kernels (``chunk`` None: as the model
    calls them, or with ``route`` "fma" or "tc" that chunkwise kernel where
    S > ``STEP_MAX``) or with the plain chunkwise form at ``chunk``; with
    ``perturb``, the plain form's h is multiplied by (1 + perturb x a
    standard normal draw) before its rounding to q's dtype. With ``held``
    (a dict), every kernel call's h and final (C, n, m) are held against the
    plain form at the model's chunk on that call's own inputs; ``held``
    keeps the number of calls, each quantity's max abs error and the
    failures. Returns the last position's logits (B, vocab) in f32."""
    from unittest import mock

    from repro_torch.kernels.mlstm import kernel, ops
    from repro_torch.kernels.mlstm.ref import mlstm_chunkwise_ref
    from repro_torch.models import xlstm

    noise = torch.Generator(device="cuda").manual_seed(1) if perturb else None
    chunkwise = {"fma": kernel.mlstm_fma, "tc": kernel.mlstm_tc}

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
    before = mlstm_launches()
    with mock.patch.object(xlstm, "mlstm", mlstm):
        logits, _ = model.prefill(params, {"tokens": rows}, rows.shape[1])
    torch.cuda.synchronize()
    launched = mlstm_launches() - before
    if launched != (_n_mlstm(model.cfg) if chunk is None else 0):
        raise AssertionError(f"prefill launched the mLSTM kernel {launched} times")
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
    recurrence rounded to bf16, for the FMA kernel, the tensor-core kernel
    and the plain form at chunk 256 (how far each is from exact where the
    end-to-end check compares them)."""
    from unittest import mock

    from repro_torch.kernels.mlstm import kernel
    from repro_torch.kernels.mlstm.ref import mlstm_chunkwise_ref
    from repro_torch.models import xlstm

    differ = {"fma": 0, "tc": 0, "plain 256": 0}
    total = 0

    def mlstm(q, k, v, gates, state, model_chunk):
        nonlocal total
        plain = mlstm_chunkwise_ref(q, k, v, gates, state, 256)
        exact = _mlstm_f64(q, k, v, gates).to(q.dtype)
        g = gates.float().contiguous()
        for name, h in (("fma", kernel.mlstm_fma(q, k, v, g, state)[0]),
                        ("tc", kernel.mlstm_tc(q, k, v, g, state)[0]), ("plain 256", plain[0])):
            differ[name] += int((h != exact).sum())
        total += exact.numel()
        return plain

    with mock.patch.object(xlstm, "mlstm", mlstm):
        model.prefill(params, {"tokens": rows}, rows.shape[1])
    return {name: n / total for name, n in differ.items()}


def compare_xlstm_paths(model, params, tokens, route: str) -> None:
    """The bf16 model's prefill, whose chunkwise mLSTM calls run the
    ``route`` kernel ("tc" or "fma"), against plain and f32 references:

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
      is at most the plain form's (chunk 256). Both kernel paths (FMA and
      tensor cores) are measured under both holds; the one the model runs
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
              "fma": _xlstm_prefill(model, params, short, route="fma"),
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
    for name in ("fma", "tc"):
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
    chunk 256): the tensor-core and the FMA kernel paths, the plain path in
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
                      "FMA kernel": _xlstm_prefill(model, params, row, route="fma")[0],
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
    """Small slices of four leaves, to see whether an update moved them."""
    p = state.params
    return [t.detach().clone() for t in (p["embed"][:4, :8], p["lm_head"][:8, :4],
                                         p["blocks"]["attn"]["wq"][0, :8, :4],
                                         p["blocks"]["mlp"]["wo"][-1, :8, :4])]


def train_full_width() -> dict:
    """qwen3-4b at full width and depth, f32 params + AdamW, seq 4096,
    global batch 2 in 2 microbatches, through ``run_segment`` for 4 steps."""
    from repro_torch.config import ShardingLayout, TrainConfig, get_arch
    from repro_torch.data import SyntheticLM
    from repro_torch.models import build_model
    from repro_torch.train.loop import make_step, run_segment
    from repro_torch.train.steps import init_train_state

    cfg = get_arch("qwen3-4b")
    model = build_model(cfg)
    seq, batch, n_steps = 4096, 2, 4
    tc = TrainConfig(total_steps=n_steps, warmup_steps=1, microbatches=2)
    layout = ShardingLayout(attn_impl="flash")
    ds = SyntheticLM(cfg.vocab_size, seq, batch, seed=0)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = init_train_state(model, torch.Generator(device="cuda").manual_seed(0), "cuda")
    torch.cuda.synchronize()
    log(f"[train] {cfg.name}: {cfg.num_layers} layers (no depth cut), d_model {cfg.d_model}, "
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
    want = expect_launches(flash_attention_tc=2 * per_mb, flash_attention_bwd_dkdv_tc=per_mb,
                           flash_attention_bwd_dq_tc=per_mb)
    secs = res0.step_seconds + res1.step_seconds
    for i, (m, dt) in enumerate(zip(metrics, secs)):
        log(f"[train] step {i}: loss {m['loss']:.6f}, grad_norm {m['grad_norm']:.6f}, "
            f"lr {m['lr']:.3e}, {dt * 1e3:.1f} ms, {batch * seq / dt:.1f} tokens/s")
    log(f"[train] peak memory {peak_gb:.2f} GB; largest change of the probed params after "
        f"step 1: {max(moved):.3e}; launches {launches}, expected {want}")
    if len(metrics) != n_steps or not all(
            np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"]) for m in metrics):
        raise AssertionError(f"non-finite or missing training metrics: {metrics}")
    if not min(moved) > 0:
        raise AssertionError("a probed param did not move after step 1")
    if launches != want:
        raise AssertionError("the training path did not go through the kernels as expected")
    profile_training(model, step_fn, res1.state, ds)
    return launches


def profile_training(model, step_fn, state, ds) -> None:
    """Where the time goes: one more full-width step under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    batch = {k: torch.from_numpy(v).to("cuda") for k, v in ds.batch(state.step).items()}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step_fn(state, batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    log(f"[profile] one training step, seq 4096, 2 microbatches:\n"
        f"{_device_breakdown(prof, wall, top=12)}")


def _copy_state(state, device):
    from repro_torch.models.common import tree_map
    from repro_torch.optim import OptState
    from repro_torch.train.steps import TrainState

    to = lambda tree: tree_map(lambda t: t.to(device), tree)
    return TrainState(to(state.params), OptState(to(state.opt.m), to(state.opt.v),
                                                 state.opt.count), state.step)


def train_reduced_matches_cpu() -> dict:
    """A reduced f32 model: 5 training steps on the card (the f32 variants
    of the flash kernels) against the plain CPU trainer, from the same state
    and data. Returns the card run's launches."""
    from repro_torch.config import ShardingLayout, TrainConfig, get_arch
    from repro_torch.data import SyntheticLM
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_leaves
    from repro_torch.train.loop import make_step, run_segment
    from repro_torch.train.steps import init_train_state

    cfg = dataclasses.replace(get_arch("qwen3-4b").reduced(), dtype="float32")
    model = build_model(cfg)
    tc = TrainConfig(total_steps=10, warmup_steps=2, microbatches=2)
    layout = ShardingLayout(attn_impl="flash")
    ds = SyntheticLM(cfg.vocab_size, 100, 4, seed=0)   # 100: ragged against 64-row tiles
    state_cpu = init_train_state(model, torch.Generator().manual_seed(0), "cpu")
    runs = {}
    for device, state in (("cuda", _copy_state(state_cpu, "cuda")), ("cpu", state_cpu)):
        metrics: list = []
        step_fn = _recording(make_step(model, tc, layout), metrics)
        reset_launches()
        res = run_segment(model, state, ds, device, tc, layout, num_steps=5, jitted=step_fn)
        runs[device] = (metrics, res.state)
        if device == "cuda":
            launches = read_launches()
    (m_gpu, s_gpu), (m_cpu, s_cpu) = runs["cuda"], runs["cpu"]
    for key in ("loss", "grad_norm"):
        a = np.array([m[key] for m in m_gpu])
        b = np.array([m[key] for m in m_cpu])
        log(f"[train] reduced f32 {key}, card {a.tolist()} vs CPU {b.tolist()}; "
            f"largest relative difference {float(np.max(np.abs(a - b) / np.abs(b))):.3e}")
        if not np.allclose(a, b, rtol=1e-4, atol=0):
            raise AssertionError(f"reduced training {key} on the card differs from the CPU's")
    err = max(float((a.cpu() - b).abs().max())
              for a, b in zip(tree_leaves(s_gpu.params), tree_leaves(s_cpu.params)))
    log(f"[train] reduced f32 params after 5 steps, card vs CPU: max abs diff {err:.3e} "
        f"(atol 1e-5)")
    if not err <= 1e-5:
        raise AssertionError("reduced training params on the card differ from the CPU's")
    return hold_f32_launches("train", launches, "flash_attention_fma",
                             "flash_attention_bwd_dkdv_fma", "flash_attention_bwd_dq_fma")


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
    return hold_f32_launches("spot", launches, "flash_attention_fma",
                             "flash_attention_bwd_dkdv_fma", "flash_attention_bwd_dq_fma")


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


def serve_plan_predicted(model) -> dict:
    """The byte columns the revoked full-width runs must report, from the
    specs alone on the CPU (before any run): params moved 8 -> 4 slots with
    weight matrices in bf16 (the tree the card serves), the bf16 dense cache
    at batch 8 x (2000 + 32), and the training path's state."""
    from repro_torch.dist import (ElasticMeshManager, cache_shardings, param_shardings,
                                  reshard_bytes, train_state_bytes)
    from repro_torch.launch.serve import PLAN_LAYOUT as layout
    from repro_torch.models.common import tree_map

    man = ElasticMeshManager([torch.device("cpu")] * 8)
    old, new = man.plan_for(8).mesh, man.plan_for(4).mesh
    served = tree_map(lambda s: dataclasses.replace(s, dtype="bfloat16") if s.is_matrix else s,
                      model.specs)
    c_specs = model.cache_specs(SERVE_B, SERVE_S + SERVE_NEW)
    return {"params_bytes": reshard_bytes(served, param_shardings(model.specs, old, layout),
                                          param_shardings(model.specs, new, layout)),
            "cache_bytes": reshard_bytes(c_specs, cache_shardings(c_specs, old, layout),
                                         cache_shardings(c_specs, new, layout)),
            "train_path_bytes": train_state_bytes(model)}


class _DecodeLogits:
    """Keep, on the card, the last-position logits of every paged decode
    call of the engines built inside the block (a copy: 8 x vocab f32 a
    step), by wrapping the engine module's step builder."""

    def __init__(self):
        self.logits: list = []

    def __enter__(self):
        from repro_torch.serve import engine

        self._build = build = engine.build_paged_decode_step

        def wrapped(model, layout):
            step = build(model, layout)

            def keep(params, cache, tokens, seq_lens, table):
                logits, cache = step(params, cache, tokens, seq_lens, table)
                self.logits.append(logits[:, -1].float().clone())
                return logits, cache
            return keep

        engine.build_paged_decode_step = wrapped
        return self

    def __exit__(self, *exc):
        from repro_torch.serve import engine

        engine.build_paged_decode_step = self._build


def _serve_plan_run(model, params, prompts, name, tracker=None) -> tuple:
    """One of SERVE_RUNS at full width: (PLAN_JSON object, launches, peak
    GB, decode logits of an engine run)."""
    from repro_torch.launch.serve import serve_plan

    counts, revoke, policy, engine = SERVE_RUNS[name]
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    keep = _DecodeLogits()
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
    return out, launches, peak_gb, keep.logits


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


def hold_engine_streams(ref: dict, got: dict, ref_logits: list, got_logits: list) -> list:
    """The revoked engine run's streams against the uninterrupted one's:
    equal through the revocation; after it each row is equal or first
    diverges at a near-tie (ENGINE_GAP_ULPS, ENGINE_MIN_CORR). Token j >= 1
    of a row comes from decode call j - 1 in both runs. Returns the
    divergences as (row, token, gap, allowed gap, correlation)."""
    out = []
    for b, (r, g) in enumerate(zip(ref["tokens"], got["tokens"])):
        if r == g:
            continue
        j = next(k for k, (x, y) in enumerate(zip(r, g)) if x != y)
        if j <= SERVE_REVOKE:
            raise AssertionError(f"engine row {b} diverges at token {j}, before the revocation")
        a, c = ref_logits[j - 1][b], got_logits[j - 1][b]
        top = torch.topk(a, 2).values
        gap, allowed = float(top[0] - top[1]), ENGINE_GAP_ULPS * abs(float(top[0])) * 2 ** -7
        corr = float(torch.corrcoef(torch.stack([a, c]))[0, 1])
        out.append((b, j, gap, allowed, corr))
        log(f"[serve-plan] engine row {b}: first divergence at token {j}: uninterrupted top-2 "
            f"gap {gap:.5f} (allowed {allowed:.5f}), logits correlation {corr:.6f}")
        if not (gap <= allowed and corr > ENGINE_MIN_CORR):
            raise AssertionError(f"engine row {b}: the resumed stream diverges at token {j} "
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
    runs, logits = {}, {}
    tracker = ThroughputTracker()
    for name in SERVE_RUNS:
        out, launches, peak, kept = _serve_plan_run(
            model, params, prompts, name, tracker if name == "engine_revoked" else None)
        _hold_serve_launches(name, out, launches, cfg.num_layers)
        runs[name], logits[name] = out, kept
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
    div = hold_engine_streams(runs["engine"], runs["engine_revoked"], logits["engine"],
                              logits["engine_revoked"])
    log(f"[serve-plan] engine: {SERVE_B - len(div)} of {SERVE_B} rows equal in full, "
        f"divergences {div}")
    return total, runs["engine"]["engine_tokens_per_sec"], tracker, model, params


def serve_plan_reduced_matches_cpu() -> dict:
    """Reduced f32 qwen3-4b through the five runs on the card and on the
    CPU, the same weights and prompts: every PLAN_JSON column but the
    timings equal, and every revoked stream equal to the uninterrupted
    one. Returns the card's launches."""
    from repro_torch.config import get_arch
    from repro_torch.launch.serve import serve_plan
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_map

    cfg = dataclasses.replace(get_arch("qwen3-4b").reduced(), dtype="float32")
    model = build_model(cfg)
    params_cpu = model.init(torch.Generator().manual_seed(0), "cpu")
    params_gpu = tree_map(lambda t: t.to("cuda"), params_cpu)
    r = SERVE_F32
    prompts = np.random.RandomState(0).randint(
        0, cfg.vocab_size, (r["batch"], r["prompt_len"])).astype(np.int32)
    launches = dict.fromkeys(read_launches(), 0)
    outs = {}
    for name, (counts, revoke, policy, engine) in SERVE_RUNS.items():
        for device, params in (("cuda", params_gpu), ("cpu", params_cpu)):
            if device == "cuda":
                reset_launches()
            outs[name, device] = serve_plan(
                model, params, prompts, r["new_tokens"], counts,
                revoke_after=r["revoke_after"] if revoke else 0, cache_policy=policy,
                engine=engine, device=device)
            if device == "cuda":
                launches = {k: launches[k] + v for k, v in read_launches().items()}
        gpu, cpu = (outs[name, d] for d in ("cuda", "cpu"))
        differ = [k for k in gpu if k not in PLAN_TIMINGS and gpu[k] != cpu[k]]
        log(f"[serve-plan] reduced f32 {name}: columns other than timings equal to the CPU's: "
            f"{not differ}; migrated_at {gpu['migrated_at']}, params_bytes "
            f"{gpu['params_bytes']}, cache_bytes {gpu['cache_bytes']}")
        if differ or set(gpu) != set(cpu):
            raise AssertionError(f"reduced f32 {name} on the card differs from the CPU: {differ}")
    for name in ("dense_drop", "dense_migrate"):
        if outs[name, "cuda"]["tokens"] != outs["dense", "cuda"]["tokens"]:
            raise AssertionError(f"reduced f32 {name}: stream differs from the uninterrupted")
    if outs["engine_revoked", "cuda"]["tokens"] != outs["engine", "cuda"]["tokens"]:
        raise AssertionError("reduced f32 engine round trip differs from the uninterrupted run")
    return hold_f32_launches("serve-plan", launches, "flash_attention_fma",
                             "paged_attention_fma")


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

def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernels-only", action="store_true",
                    help="stop after building and checking the kernels")
    ap.add_argument("--spot-only", action="store_true",
                    help="only build the kernels and run the spot provisioner's phase")
    ap.add_argument("--serve-plan-only", action="store_true",
                    help="only build the kernels and run the spot serving phase")
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
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    smi_line = smi.stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[phase 1/9] [device] {name}; {smi_line}; torch {torch.__version__}, "
        f"cuda {torch.version.cuda}")

    log("[phase 2/9] build")
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
        f"{fn[:70]}: {r} registers, {sp} spill bytes" for fn, (r, sp) in spills.items()))
    if ptxas != "(cached)" and (not spills or any(sp for _, sp in spills.values())):
        raise AssertionError("a kernel of this slice spills registers (or was not compiled)")
    _build.load()
    if args.xlstm_orders:
        xlstm_orders()
        return 0
    if args.spot_only:
        log("[phase 8/9] the spot provisioner")
        spot = {"spot": spot_full_width(), "spot_f32": spot_reduced_matches_cpu(),
                "spot_launch": spot_launcher()}
        log(f"chip_smoke: --spot-only, launches by path {spot}; "
            f"{time.perf_counter() - t_start:.1f} s in all")
        return 0
    if args.serve_plan_only:
        log("[phase 9/9] spot serving")
        paths = spot_serving()
        log(f"chip_smoke: --serve-plan-only, launches by path {paths}; "
            f"{time.perf_counter() - t_start:.1f} s in all")
        return 0

    log("[phase 3/9] kernels against their plain versions")
    gen = torch.Generator(device="cuda").manual_seed(0)
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    records = [*check_flash(gen, flush), *check_paged(gen, flush), *check_flash_bwd(gen, flush),
               check_ssm_scan(gen, flush), *check_mlstm(gen, flush)]
    del flush
    if args.kernels_only:
        log(json.dumps({"kernels": records}))
        log("chip_smoke: --kernels-only, stopped before serving")
        return 0

    log("[phase 4/9] serving")
    paths = {"serve": serve_full_width()}
    paths["serve_f32"] = serve_reduced_matches_cpu()
    gc.collect()
    torch.cuda.empty_cache()
    log("[phase 5/9] hybrid serving")
    paths["hybrid"] = serve_hybrid_full_width()
    paths["hybrid_f32"] = greedy_reduced_matches_cpu("hymba-1.5b", "hybrid",
                                                     "flash_attention_fma", "ssm_scan")
    gc.collect()
    torch.cuda.empty_cache()
    log("[phase 6/9] xLSTM serving")
    paths["xlstm"] = serve_xlstm_full_width()
    paths["xlstm_f32"] = greedy_reduced_matches_cpu("xlstm-350m", "xlstm", "mlstm_fma",
                                                    "mlstm_step")
    gc.collect()
    torch.cuda.empty_cache()
    log("[phase 7/9] training")
    paths["train"] = train_full_width()
    paths["train_f32"] = train_reduced_matches_cpu()
    gc.collect()
    torch.cuda.empty_cache()
    log("[phase 8/9] the spot provisioner")
    paths["spot"] = spot_full_width()
    gc.collect()
    torch.cuda.empty_cache()
    paths["spot_f32"] = spot_reduced_matches_cpu()
    paths["spot_launch"] = spot_launcher()
    gc.collect()
    torch.cuda.empty_cache()
    log("[phase 9/9] spot serving")
    paths.update(spot_serving())
    for r in records:
        r["launches_by_path"] = {path: counts[r["name"]] for path, counts in paths.items()}
        r["launches"] = sum(r["launches_by_path"].values())
    keys = ("name", "route", "source", "replaces", "launches", "launches_by_path",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    log(f"[done] {time.perf_counter() - t_start:.1f} s in all")
    print(smi_line)
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in records]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
