#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA H100.

    python3 chip_smoke.py                 # the whole check, one card
    python3 chip_smoke.py --kernels-only  # build + kernel checks only

Phases, each of which raises on a failed check (so the exit code is not 0):

1. device: the card's name and power limit (``nvidia-smi``); TF32 off;
2. build: compile ``src/repro_torch/csrc/*.cu`` for sm_90a (``kernels/_build.py``);
3. kernels: each hand-written kernel against its plain PyTorch version on
   the card, on the reference's test shapes and at the main path's shapes,
   with times (CUDA events, L2 flushed between launches) beside the bound;
4. serving: full-width qwen3-4b (random bf16 weights from a seeded
   generator) through ``DecodeEngine`` on 16 requests; launch counters
   prove prefill went through the flash kernel (36 launches per prefill)
   and decode through the paged kernel (36 per step); the flash prefill's
   logits agree with the plain masked path; a reduced model's f32 streams
   on the card equal the plain CPU engine's.

The last two lines of stdout are the per-kernel JSON record and
``{"ok": true, "device": {...}}``. Without a CUDA device, or without the
repository beside this file, the script prints no result and exits 2.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
from pathlib import Path
import re
import subprocess
import sys
import time

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
SRC = REPO / "src"

# NVIDIA H100 SXM data sheet: dense bf16 tensor-core rate and HBM3 bandwidth
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12

# (B, S, H, KVH, hd, causal, window, dtype): tests/test_kernels.py FLASH_CASES
FLASH_CASES = [
    (2, 256, 4, 4, 64, True, 0, torch.float32),
    (1, 256, 8, 2, 64, True, 0, torch.float32),
    (2, 128, 4, 1, 32, True, 64, torch.float32),
    (1, 384, 4, 4, 128, True, 0, torch.float32),
    (1, 256, 4, 2, 64, True, 0, torch.bfloat16),
    (2, 128, 2, 2, 128, True, 32, torch.bfloat16),
]
# (B, H, KVH, hd, page_size, max_blocks, lens, dtype): tests/test_kernels.py PAGED_CASES
PAGED_CASES = [
    (2, 4, 4, 64, 16, 4, [64, 33], torch.float32),
    (3, 8, 2, 64, 16, 4, [1, 50, 64], torch.float32),
    (2, 4, 1, 32, 8, 6, [41, 17], torch.float32),
    (2, 4, 2, 64, 16, 4, [64, 7], torch.bfloat16),
]


F32_TOL = dict(atol=2e-5, rtol=2e-5)
# Main-path bf16 shapes: a typical |o| there is only ~0.03-0.05 (softmax over
# ~1000 positions), so the repository's 2e-2 is most of a typical value.
# rtol 1e-2 covers the bf16 output's rounding (at most one ulp, 2^-7 |o|);
# atol covers the small |o| that dominate. Largest errors on an H100: flash
# 3.9e-3 (S=2000), paged 4.9e-4; dropping a ragged kv tile or a partial
# last page gave 3.7e-2 and 1.3e-1.
FLASH_MAIN_BF16_TOL = dict(atol=4e-3, rtol=1e-2)
PAGED_MAIN_BF16_TOL = dict(atol=1e-3, rtol=1e-2)


def tol(dtype) -> dict:
    """The repository's kernel tolerances at its test shapes (tests/test_kernels.py)."""
    return dict(atol=2e-2, rtol=2e-2) if dtype == torch.bfloat16 else F32_TOL


def log(msg: str) -> None:
    print(msg, flush=True)


def hold(name: str, out: torch.Tensor, ref: torch.Tensor, t: dict) -> float:
    """Raise unless |out - ref| <= atol + rtol |ref| everywhere; return the
    max abs error."""
    a, b = out.float(), ref.float()
    if not torch.isfinite(a).all():
        raise AssertionError(f"{name}: non-finite output")
    err = float((a - b).abs().max())
    ok = bool(torch.all((a - b).abs() <= t["atol"] + t["rtol"] * b.abs()))
    log(f"  {name}: max_abs_err={err:.3e} (atol={t['atol']}, rtol={t['rtol']}) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with its plain version")
    return err


def time_ms(fn, flush: torch.Tensor, reps: int = 10, warmup: int = 2) -> float:
    """Mean device time of one call, CUDA events around each call, with the
    L2 cache flushed before each (the main path finds it cold)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
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


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def check_flash(gen: torch.Generator, flush: torch.Tensor) -> dict:
    from repro_torch.kernels.flash_attention import kernel
    from repro_torch.kernels.flash_attention.ref import attention_ref

    def case(name, B, Sq, Skv, H, KVH, hd, causal, window, q_offset, dtype, t=None):
        q = torch.randn((B, Sq, H, hd), generator=gen, device="cuda").to(dtype)
        k = torch.randn((B, Skv, KVH, hd), generator=gen, device="cuda").to(dtype)
        v = torch.randn((B, Skv, KVH, hd), generator=gen, device="cuda").to(dtype)
        kw = dict(causal=causal, window=window, q_offset=q_offset)
        o, lse = kernel.flash_attention_fwd(q, k, v, **kw)
        torch.cuda.synchronize()
        if not torch.isfinite(lse).all():
            raise AssertionError(f"{name}: non-finite lse")
        return (q, k, v, kw), hold(name, o, attention_ref(q, k, v, **kw), t or tol(dtype))

    log("[kernels] flash_attention vs attention_ref")
    for B, S, H, KVH, hd, causal, window, dtype in FLASH_CASES:
        case(f"flash B{B} S{S} H{H}/{KVH} hd{hd} w{window} {str(dtype)[6:]}",
             B, S, S, H, KVH, hd, causal, window, 0, dtype)
    case("flash q_offset=128 Sq64 Skv192", 1, 64, 192, 4, 2, 64, True, 0, 128, torch.float32)
    case("flash non-causal ragged S100", 2, 100, 100, 4, 2, 64, False, 0, 0, torch.float32)
    case("flash main-path S1000 H32/8 hd128 f32", 1, 1000, 1000, 32, 8, 128, True, 0, 0,
         torch.float32)
    main = None
    for S in (129, 1000, 2000):
        main = case(f"flash main-path S{S} H32/8 hd128 bf16",
                    1, S, S, 32, 8, 128, True, 0, 0, torch.bfloat16, FLASH_MAIN_BF16_TOL)
    (q, k, v, kw), err = main
    B, S, H, hd = q.shape
    KVH = k.shape[2]
    pairs = S * (S + 1) // 2                     # causal (q, k) pairs this input needs
    flops = 4.0 * pairs * hd * H * B             # QK^T and PV, 2 flops per multiply-add
    nbytes = 2.0 * (2 * B * S * H * hd + 2 * B * S * KVH * hd) + 4.0 * B * H * S
    b_ms, b_by = bound(flops, nbytes, PEAK_BF16_FLOPS)
    ms = time_ms(lambda: kernel.flash_attention_fwd(q, k, v, **kw), flush)
    plain_ms = time_ms(lambda: attention_ref(q, k, v, **kw), flush)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    lib_ms = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True), flush)
    log(f"  flash main path (B1 S{S} H32/8 hd128 bf16): kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}); "
        f"{flops / ms / 1e9:.1f} TFLOP/s achieved")
    return dict(name="flash_attention", route="cuda",
                source="src/repro_torch/csrc/flash_attention.cu",
                replaces="src/repro/kernels/flash_attention/kernel.py:33",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=lib_ms)


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


def check_paged(gen: torch.Generator, flush: torch.Tensor) -> dict:
    from repro_torch.kernels.paged_attention import kernel
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref

    log("[kernels] paged_attention vs paged_attention_ref")
    for B, H, KVH, hd, ps, mb, lens, dtype in PAGED_CASES:
        args = _paged_inputs(gen, B, H, KVH, hd, ps, mb, lens, dtype, seed=0)
        hold(f"paged B{B} H{H}/{KVH} hd{hd} ps{ps} lens{lens} {str(dtype)[6:]}",
             kernel.paged_attention(*args), paged_attention_ref(*args), tol(dtype))

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
    args = _paged_inputs(gen, 8, 32, 8, 128, 16, 128, lens, torch.float32, seed=1)
    hold(f"paged main-path 8 lanes H32/8 hd128 ps16 lens{lens} f32",
         kernel.paged_attention(*args), paged_attention_ref(*args), F32_TOL)
    args = _paged_inputs(gen, 8, 32, 8, 128, 16, 128, lens, torch.bfloat16, seed=1)
    err = hold(f"paged main-path 8 lanes H32/8 hd128 ps16 lens{lens} bf16",
               kernel.paged_attention(*args), paged_attention_ref(*args), PAGED_MAIN_BF16_TOL)
    n_tok = sum(lens)
    n_pages = sum(-(-n // 16) for n in lens)
    flops = 4.0 * n_tok * 32 * 128
    nbytes = 2.0 * (2 * 8 * 32 * 128 + 2 * n_tok * 8 * 128) + 4.0 * (n_pages + 8)
    b_ms, b_by = bound(flops, nbytes, PEAK_BF16_FLOPS)
    ms = time_ms(lambda: kernel.paged_attention(*args), flush)
    plain_ms = time_ms(lambda: paged_attention_ref(*args), flush)
    log(f"  paged main path (8 lanes, {n_tok} cached tokens, bf16): kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}); "
        f"{nbytes / ms / 1e6:.1f} GB/s achieved")
    return dict(name="paged_attention", route="cuda",
                source="src/repro_torch/csrc/paged_attention.cu",
                replaces="src/repro/kernels/paged_attention/kernel.py:35",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=None)


# ---------------------------------------------------------------------------
# phase 4: full-width serving
# ---------------------------------------------------------------------------

def serve_full_width() -> dict:
    from repro_torch.config import ShardingLayout, get_arch
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.paged_attention import kernel as pa_kernel
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
    fa_kernel.launches = 0
    pa_kernel.launches = 0
    t0 = time.perf_counter()
    done = eng.run(params)
    wall = time.perf_counter() - t0
    launches = {"flash_attention": fa_kernel.launches, "paged_attention": pa_kernel.launches}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    if sorted(c.rid for c in done) != list(range(len(reqs))):
        raise AssertionError("not every request completed")
    if not all(len(c.tokens) == 32 and c.reason == "length" for c in done):
        raise AssertionError("a request did not get 32 tokens")
    if not all(0 <= t < cfg.vocab_size for c in done for t in c.tokens):
        raise AssertionError("a generated token is outside the vocabulary")
    if eng.free_pages != num_pages - 1:
        raise AssertionError(f"pool did not drain: {eng.free_pages} free of {num_pages - 1}")
    want = {"flash_attention": cfg.num_layers * eng.prefills,
            "paged_attention": cfg.num_layers * eng.decode_steps}
    log(f"[serve] {len(done)} requests x 32 tokens done in {wall:.2f} s; prompt lengths "
        f"{lens}; {eng.prefills} prefills, {eng.decode_steps} decode steps; pool back to "
        f"{eng.free_pages} free pages")
    log(f"[serve] launches {launches}, expected {want}")
    if launches != want or min(launches.values()) <= 0:
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
    """Device time by kernel (torch.profiler), the device's busy share of
    the window, and the host ops that cost the most CPU time."""
    evts = prof.key_averages()
    dev = [e for e in evts if getattr(e, "self_device_time_total", 0) > 0
           and str(getattr(e, "device_type", "")).endswith("CUDA")]
    busy_ms = sum(e.self_device_time_total for e in dev) / 1e3
    if busy_ms <= 0:
        raise AssertionError("the profiler recorded no device time")
    lines = [f"    window {wall_ms:.2f} ms, device busy {busy_ms:.2f} ms "
             f"({100 * busy_ms / wall_ms:.1f}%), idle {100 * (1 - busy_ms / wall_ms):.1f}%"]
    for e in sorted(dev, key=lambda e: -e.self_device_time_total)[:top]:
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


def serve_reduced_matches_cpu() -> None:
    """A reduced f32 model: the engine on the card (both kernels) must give
    the plain CPU engine's greedy streams token for token."""
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
        streams[device] = {c.rid: c.tokens for c in eng.run(params)}
    log(f"[serve] reduced f32 streams, card vs CPU plain: "
        f"{'identical' if streams['cpu'] == streams['cuda'] else 'DIFFERENT'}")
    if streams["cpu"] != streams["cuda"]:
        raise AssertionError(f"card streams {streams['cuda']} != CPU {streams['cpu']}")


# ---------------------------------------------------------------------------

def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernels-only", action="store_true",
                    help="stop after building and checking the kernels")
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
    log(f"[device] {name}; {smi_line}; torch {torch.__version__}, cuda {torch.version.cuda}")

    _build.build()
    ptxas = _build.last_build["log"]
    spills = [m.group(0) for m in re.finditer(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                                              ptxas) if m.group(1) != "0" or m.group(2) != "0"]
    regs = [int(n) for n in re.findall(r"Used (\d+) registers", ptxas)]
    log(f"[build] {len(_build.sources())} sources in {_build.last_build['seconds']:.1f} s "
        f"-> {_build.last_build['path']}; max {max(regs, default=0)} registers/thread; "
        f"spill lines: {spills or 'none'}")
    _build.load()

    gen = torch.Generator(device="cuda").manual_seed(0)
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    records = [check_flash(gen, flush), check_paged(gen, flush)]
    del flush
    if args.kernels_only:
        log(json.dumps({"kernels": records}))
        log("chip_smoke: --kernels-only, stopped before serving")
        return 0

    launches = serve_full_width()
    serve_reduced_matches_cpu()
    for r in records:
        r["launches"] = launches[r["name"]]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    log(f"[done] {time.perf_counter() - t_start:.1f} s in all")
    print(smi_line)
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in records]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
