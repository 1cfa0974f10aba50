"""xLSTM blocks (port of ``repro.models.xlstm``): mLSTM (matrix memory)
and sLSTM (scalar memory), after arXiv:2405.04517.

The mLSTM recurrence goes through ``kernels.mlstm.ops.mlstm``: the CUDA
kernel on a GPU tensor, the plain chunkwise form on the CPU, in prefill
(the whole sequence from a zero state) and in every decode step (S=1 from
the cached state). The sLSTM recurrence goes through
``kernels.slstm.ops.slstm`` the same way: the CUDA kernel (one launch for
the whole sequence, a backward kernel for its gradient) on a GPU tensor,
the plain per-step loop ``slstm_ref`` on the CPU; the reference runs it as
a ``lax.scan``.

Decode state per mLSTM layer: ``{"C": (B,H,hd,hd), "n": (B,H,hd), "m":
(B,H)}``; per sLSTM layer: ``{"c","n","h","m": (B,d)}``, all f32 and
constant per token. ``w_if``, ``w_gates`` and ``r_gates`` are read in f32
(``keep_f32``): serving never stores them in the compute dtype.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.config.base import ModelConfig
from repro_torch.kernels.mlstm.ops import mlstm
from repro_torch.kernels.slstm.ops import slstm
from repro_torch.models import common
from repro_torch.models.common import ParamSpec


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def _mdims(cfg: ModelConfig) -> Tuple[int, int, int]:
    H = cfg.num_heads
    inner = 2 * cfg.d_model  # up-projection factor 2 (paper's mLSTM block)
    return H, inner, inner // H


def mlstm_spec(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    d = cfg.d_model
    H, inner, _ = _mdims(cfg)
    return {
        "up_proj": ParamSpec((d, 2 * inner), ("embed", "ssm_inner")),
        "wq": ParamSpec((inner, inner), ("ssm_inner", "q_dim")),
        "wk": ParamSpec((inner, inner), ("ssm_inner", "q_dim")),
        "wv": ParamSpec((inner, inner), ("ssm_inner", "q_dim")),
        "w_if": ParamSpec((inner, 2 * H), ("ssm_inner", None), keep_f32=True),  # ĩ, f̃
        "b_if": ParamSpec((2 * H,), (None,), init="zeros"),
        "down_proj": ParamSpec((inner, d), ("ssm_inner", "embed")),
    }


def mlstm_state_spec(cfg: ModelConfig, batch: int) -> Dict[str, ParamSpec]:
    H, _, hd = _mdims(cfg)
    return {
        "C": ParamSpec((batch, H, hd, hd), ("batch", "heads", "head_dim", None), init="zeros"),
        "n": ParamSpec((batch, H, hd), ("batch", "heads", "head_dim"), init="zeros"),
        "m": ParamSpec((batch, H), ("batch", "heads"), init="zeros"),
    }


def mlstm_block(
    params: Dict,
    x: torch.Tensor,
    cfg: ModelConfig,
    state: Optional[Dict] = None,
) -> Tuple[torch.Tensor, Dict]:
    """x: (B,S,d) -> (y (B,S,d), new state {"C", "n", "m"} f32)."""
    B, S, _ = x.shape
    H, inner, hd = _mdims(cfg)
    up = common.dense(x, params["up_proj"], cfg.dtype)
    u, z = up.chunk(2, dim=-1)                                   # (B,S,inner) x2
    q = common.dense(u, params["wq"], cfg.dtype).view(B, S, H, hd)
    k = common.dense(u, params["wk"], cfg.dtype).view(B, S, H, hd)
    v = common.dense(u, params["wv"], cfg.dtype).view(B, S, H, hd)
    gates = common.dense(u, params["w_if"], "float32") + params["b_if"].float()
    st = None if state is None else (state["C"], state["n"], state["m"])
    h, (C, n, m) = mlstm(q, k, v, gates, st, cfg.ssm.chunk if cfg.ssm else 64)
    y = h.reshape(B, S, inner).to(common.torch_dtype(cfg.dtype)) * F.silu(z)
    return common.dense(y, params["down_proj"], cfg.dtype), {"C": C, "n": n, "m": m}


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def slstm_spec(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    d = cfg.d_model
    return {
        "w_gates": ParamSpec((d, 4 * d), ("embed", "ssm_inner"), keep_f32=True),  # z,i,f,o
        "r_gates": ParamSpec((d, 4 * d), ("embed", "ssm_inner"), scale=0.5, keep_f32=True),
        "b_gates": ParamSpec((4 * d,), ("ssm_inner",), init="zeros"),
        "up_proj": ParamSpec((d, 2 * d), ("embed", "ffn")),
        "down_proj": ParamSpec((d, d), ("ffn", "embed")),
    }


def slstm_state_spec(cfg: ModelConfig, batch: int) -> Dict[str, ParamSpec]:
    d = cfg.d_model
    return {key: ParamSpec((batch, d), ("batch", "embed"), init="zeros")
            for key in ("c", "n", "h", "m")}


def slstm_block(
    params: Dict,
    x: torch.Tensor,
    cfg: ModelConfig,
    state: Optional[Dict] = None,
) -> Tuple[torch.Tensor, Dict]:
    """sLSTM with exponential gating and recurrent connections.
    x: (B,S,d) -> (y (B,S,d), new state {"c", "n", "h", "m"} f32)."""
    ct = common.torch_dtype(cfg.dtype)
    st = None if state is None else tuple(state[key].float() for key in ("c", "n", "h", "m"))
    wx = common.dense(x, params["w_gates"], "float32") + params["b_gates"].float()  # (B,S,4d)
    hs, (c, n, h, m) = slstm(wx, params["r_gates"].float(), st)
    y = hs.to(ct)                                                # (B,S,d)
    a, b = common.dense(y, params["up_proj"], cfg.dtype).chunk(2, dim=-1)
    out = common.dense(F.gelu(a, approximate="tanh") * b, params["down_proj"], cfg.dtype)
    return out, {"c": c, "n": n, "h": h, "m": m}
