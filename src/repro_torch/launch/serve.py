"""Serving launcher of the port: lock-step batched prefill + greedy decode.

    python -m repro_torch.launch.serve --arch <id> [--batch 4] [--prompt-len 64]
        [--new-tokens 8] [--reduced | --no-reduced] [--device cuda|cpu] [--seed 0]

The counterpart of ``repro.launch.serve::host_main`` on one device
(``cuda`` unless ``--device cpu``): one batched prefill over the prompts,
then ``new_tokens - 1`` greedy ``decode_step`` calls against the dense
cache (or, for xLSTM, the recurrent states), every row at the same
position. Attention prefills through the flash kernel's entry point,
hybrid blocks scan through the selective-scan kernel's and mLSTM blocks
through the chunkwise mLSTM kernel's, in prefill and in every decode
step: the CUDA kernels on the card, their plain versions on the CPU.
``--reduced`` (the default, as in the reference) serves the
family-preserving tiny config, ``--no-reduced`` the full one: for example
``--arch xlstm-350m --device cpu`` serves reduced xLSTM on the CPU, and
``--arch xlstm-350m --no-reduced`` full-width xLSTM on the card.

Params come from ``torch.Generator(device).manual_seed(seed)``, weight
matrices stored in the config's compute dtype. The prompts are
``numpy.random.RandomState(seed).randint(0, vocab, (batch, prompt_len))``:
the reference draws them with ``jax.random``, whose numbers the port cannot
reproduce, so the two launchers serve different prompts.

Not ported yet: ``--plan`` and ``--engine`` (they need ``dist/``, the
mesh plans), ``--trace`` (the obs exporters) and ``--int8-cache`` (the int8
KV cache); each raises ``NotImplementedError``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Any, List

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.config import ShardingLayout, get_arch, list_archs
from repro_torch.models import build_model, common
from repro_torch.models.zoo import Model
from repro_torch.train.steps import build_decode_step, build_prefill_step


@dataclasses.dataclass
class ServeResult:
    tokens: torch.Tensor          # (B, new_tokens) int32 greedy tokens, on the host
    logits: List[torch.Tensor]    # per generated token, the (B, V) logits it was taken from
    cache: Any                    # the cache after the last decode step
    prefill_seconds: float        # prefill + first argmax, ended by a device sync
    decode_seconds: float         # all decode steps, ended by a device sync

    @property
    def decode_steps(self) -> int:
        return len(self.logits) - 1


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def greedy_serve(model: Model, params, tokens: torch.Tensor, new_tokens: int,
                 layout: ShardingLayout = ShardingLayout(attn_impl="flash")) -> ServeResult:
    """Prefill ``tokens`` (B, S) in one batch, then greedy-decode until
    every row has ``new_tokens`` tokens; the cache holds S + new_tokens
    positions (a ring buffer of the window for sliding attention; xLSTM
    keeps only its constant-size recurrent states)."""
    device = tokens.device
    S = tokens.shape[1]
    prefill = build_prefill_step(model, layout, S + new_tokens)
    decode = build_decode_step(model, layout)

    t0 = time.perf_counter()
    logits, cache = prefill(params, {"tokens": tokens})
    tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
    _sync(device)
    prefill_s = time.perf_counter() - t0

    toks, outs = [tok], [logits[:, -1]]
    t0 = time.perf_counter()
    for i in range(new_tokens - 1):
        logits, cache = decode(params, cache, tok, S + i)
        tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
        toks.append(tok)
        outs.append(logits[:, -1])
    _sync(device)
    return ServeResult(torch.cat(toks, dim=1).cpu(), outs, cache, prefill_s,
                       time.perf_counter() - t0)


def host_main(args) -> dict:
    for flag, needs in (("plan", "dist/ (mesh plans)"), ("engine", "dist/ (mesh plans)"),
                        ("trace", "the obs exporters"), ("int8_cache", "the int8 KV cache")):
        if getattr(args, flag):
            raise NotImplementedError(
                f"repro_torch: --{flag.replace('_', '-')} needs {needs}, not ported yet")
    device = resolve_device(args.device)
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = build_model(cfg)
    params = model.init(torch.Generator(device=device).manual_seed(args.seed), device,
                        common.torch_dtype(cfg.dtype))
    prompt = np.random.RandomState(args.seed).randint(
        0, cfg.vocab_size, (args.batch, args.prompt_len)).astype(np.int32)
    res = greedy_serve(model, params, torch.as_tensor(prompt, device=device), args.new_tokens)
    summary = {"event": "serve done", "arch": cfg.name, "device": str(device),
               "batch": args.batch, "prompt_len": args.prompt_len,
               "prefill_ms": res.prefill_seconds * 1e3,
               "ms_per_token": res.decode_seconds / max(res.decode_steps, 1) * 1e3,
               "first_row": res.tokens[0].tolist()}
    print(json.dumps(summary), flush=True)
    return summary


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list_archs())
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--new-tokens", type=int, default=8)
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction, default=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--int8-cache", action="store_true", help="not ported yet")
    ap.add_argument("--plan", default="", help="not ported yet")
    ap.add_argument("--engine", action="store_true", help="not ported yet")
    ap.add_argument("--trace", default="", help="not ported yet")
    host_main(ap.parse_args())


if __name__ == "__main__":
    main()
