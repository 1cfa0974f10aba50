"""Mamba-style selective SSM block (port of ``repro.models.ssm``), the SSM
half of Hymba's parallel attention + SSM blocks.

The recurrence goes through ``kernels.ssm_scan.ops.ssm_scan``: the CUDA
kernel on a GPU tensor, its plain sequential version on the CPU, in
prefill (the whole sequence from a zero state), in every decode step
(S=1 from the cached state) and in training, where the block is
differentiated: the scan's gradient is its backward kernel on the card
(from the states the forward kept after each 16-step tile, as the
reference's ``jax.checkpoint`` keeps its chunk boundaries) and the plain
adjoint recurrence on the CPU; everything around it is autograd. The
selective-parameter projections stay
``torch.matmul``, as the JAX package leaves them to XLA outside any
kernel; the JAX block computes them per scan chunk under
``jax.checkpoint``, here they run once over the whole sequence, which
gives the same per-row values.

State layout (also the decode state): ``{"conv": (B, W-1, inner),
"h": (B, inner, N)}``, constant per-token memory.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.config.base import ModelConfig
from repro_torch.kernels.ssm_scan.ops import ssm_scan
from repro_torch.models import common
from repro_torch.models.common import ParamSpec


def _dims(cfg: ModelConfig) -> Tuple[int, int, int, int]:
    s = cfg.ssm
    inner = s.expand * cfg.d_model
    dt_rank = s.dt_rank or math.ceil(cfg.d_model / 16)
    return inner, s.state_dim, dt_rank, s.conv_width


def mamba_spec(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    """``x_proj``, ``dt_proj`` and ``A_log`` are read in f32 by the block
    (``keep_f32``): serving never stores them in the compute dtype."""
    d = cfg.d_model
    inner, N, R, W = _dims(cfg)
    return {
        "in_proj": ParamSpec((d, 2 * inner), ("embed", "ssm_inner")),
        "conv_w": ParamSpec((W, inner), ("conv", "ssm_inner"), scale=0.5),
        "conv_b": ParamSpec((inner,), ("ssm_inner",), init="zeros"),
        "x_proj": ParamSpec((inner, R + 2 * N), ("ssm_inner", None), keep_f32=True),
        "dt_proj": ParamSpec((R, inner), ("dt_rank", "ssm_inner"), keep_f32=True),
        "dt_bias": ParamSpec((inner,), ("ssm_inner",), init="zeros"),
        "A_log": ParamSpec((inner, N), ("ssm_inner", "ssm_state"), init="ones", keep_f32=True),
        "D": ParamSpec((inner,), ("ssm_inner",), init="ones"),
        "out_proj": ParamSpec((inner, d), ("ssm_inner", "embed")),
    }


def init_state(cfg: ModelConfig, batch: int) -> Dict[str, ParamSpec]:
    inner, N, _, W = _dims(cfg)
    return {
        "conv": ParamSpec((batch, W - 1, inner), ("batch", None, "ssm_inner"), init="zeros"),
        "h": ParamSpec((batch, inner, N), ("batch", "ssm_inner", "ssm_state"), init="zeros"),
    }


def _ssm_params(params: Dict, u: torch.Tensor, cfg: ModelConfig):
    """u: (..., inner) post-conv activations -> (dt, B_, C_) selective params, f32."""
    _, N, R, _ = _dims(cfg)
    proj = common.dense(u, params["x_proj"], "float32")
    dt_low, B_, C_ = torch.split(proj, [R, N, N], dim=-1)
    dt = F.softplus(common.dense(dt_low, params["dt_proj"], "float32")
                    + params["dt_bias"].float())
    return dt, B_, C_


def _causal_conv(params: Dict, x: torch.Tensor, prefix: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over seq. x: (B,S,inner); prefix: (B,W-1,inner).

    The W products are summed in x's dtype, in order, as the reference
    does (``conv1d`` would accumulate in f32 and round differently at bf16).
    """
    W = params["conv_w"].shape[0]
    S = x.shape[1]
    w = params["conv_w"].to(x.dtype)
    xp = torch.cat([prefix.to(x.dtype), x], dim=1)
    out = xp[:, 0:S] * w[0]
    for i in range(1, W):
        out = out + xp[:, i:i + S] * w[i]
    return out + params["conv_b"].to(x.dtype)


def mamba_block(
    params: Dict,
    x: torch.Tensor,
    cfg: ModelConfig,
    state: Optional[Dict] = None,
) -> Tuple[torch.Tensor, Dict]:
    """Full-sequence Mamba block. x: (B, S, d) -> (y (B,S,d), final state)."""
    B = x.shape[0]
    inner, _, _, W = _dims(cfg)
    ct = common.torch_dtype(cfg.dtype)

    xz = common.dense(x, params["in_proj"], cfg.dtype)
    xin, z = xz.chunk(2, dim=-1)
    conv_prefix = (state["conv"] if state is not None
                   else torch.zeros((B, W - 1, inner), dtype=ct, device=x.device))
    u = F.silu(_causal_conv(params, xin, conv_prefix))          # (B, S, inner)
    h0 = state["h"].float() if state is not None else None

    dt, B_, C_ = _ssm_params(params, u, cfg)
    A = -torch.exp(params["A_log"].float())                      # (inner, N)
    y, h_final = ssm_scan(u, dt, B_, C_, A, params["D"].float(), h0)
    y = y.to(ct) * F.silu(z)
    out = common.dense(y, params["out_proj"], cfg.dtype)
    new_state = {
        "conv": torch.cat([conv_prefix.to(ct), xin], dim=1)[:, -(W - 1):],
        "h": h_final,
    }
    return out, new_state


def mamba_decode_step(
    params: Dict, x: torch.Tensor, state: Dict, cfg: ModelConfig
) -> Tuple[torch.Tensor, Dict]:
    """Single-token step. x: (B, 1, d) -> (y (B,1,d), new state)."""
    return mamba_block(params, x, cfg, state=state)
