"""RG-LRU recurrent block (port of `repro/nn/rglru.py`, RecurrentGemma /
Griffin, arXiv:2402.19427).

The block: x -> [linear -> causal conv1d -> RG-LRU], gated by a parallel
GeLU branch, then the output projection.  The recurrence per channel:

    r_t = sigmoid(W_a x_t + b_a)            recurrence gate
    i_t = sigmoid(W_x x_t + b_x)            input gate
    a_t = a^(c r_t)   with a = sigmoid(Lambda),  c = 8
    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) (i_t x_t)

in float32 (`lam` stays float32 in a bf16 model).  Training
(`rglru_block_apply`) and prefill run the recurrence as a log-depth scan
in plain torch (the reference's `jax.lax.associative_scan` has no
kernel); decode is the O(1) step.
The cache is the last d_conv-1 raw (pre-conv) rows and the float32 h.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.nn import layers as L

_C = 8.0


@dataclasses.dataclass(frozen=True)
class RGLRUConfig:
    d_model: int
    lru_width: int
    d_conv: int = 4
    dtype: Any = torch.float32


def rglru_init(gen, cfg: RGLRUConfig, device=None):
    device = gen.device if device is None else device
    D, W = cfg.d_model, cfg.lru_width
    kw = dict(dtype=cfg.dtype, device=device)
    # Lambda so that a = sigmoid(Lambda) spans [0.9, 0.999]
    a = torch.linspace(0.9, 0.999, W, dtype=torch.float32, device=device)
    return {
        "in_x": L.dense_init(gen, D, W, **kw),
        "in_gate": L.dense_init(gen, D, W, **kw),
        "conv": L.conv1d_init(gen, W, W, cfg.d_conv, **kw),
        "gate_a": L.dense_init(gen, W, W, bias=True, **kw),
        "gate_x": L.dense_init(gen, W, W, bias=True, **kw),
        "lam": torch.log(a / (1 - a)),
        "out": L.dense_init(gen, W, D, **kw),
    }


def _gelu(x):
    return F.gelu(x, approximate="tanh")         # jax.nn.gelu's default


def _rglru_gates(params, x):
    """x: (..., W) -> the decay a and the gated, scaled input, float32."""
    r = torch.sigmoid(L.dense_apply(params["gate_a"], x).float())
    i = torch.sigmoid(L.dense_apply(params["gate_x"], x).float())
    log_a = _C * r * F.logsigmoid(params["lam"])          # (..., W) < 0
    a = torch.exp(log_a)
    scaled_in = torch.sqrt(torch.clamp_min(1.0 - a * a, 1e-12)) \
        * (i * x.float())
    return a, scaled_in


def rglru_scan(a, u):
    """h_t = a_t h_{t-1} + u_t over axis 1 from h_0 = 0; a, u (B,S,W)
    float32 -> h (B,S,W).  A doubling scan with the reference's combine
    (a1, u1) . (a2, u2) = (a1 a2, u1 a2 + u2): log2(S) rounds of whole-
    tensor products, not S steps; its sums group differently from XLA's
    tree, so results agree to float32 rounding.  Each round builds new
    tensors (the untouched head beside the updated tail), so autograd
    can differentiate it."""
    h = u
    S = a.shape[1]
    step = 1
    while step < S:
        carry = h[:, :-step] * a[:, step:]
        if 2 * step < S:                # the last round needs no decays
            a = torch.cat([a[:, :step], a[:, :-step] * a[:, step:]], dim=1)
        h = torch.cat([h[:, :step], h[:, step:] + carry], dim=1)
        step *= 2
    return h


def rglru_block_apply(params, cfg: RGLRUConfig, x):
    """Full-sequence recurrent block forward from a zero state (train).
    x: (B,S,D) -> (B,S,D)."""
    gate = _gelu(L.dense_apply(params["in_gate"], x))
    h = L.dense_apply(params["in_x"], x)
    h = L.conv1d_apply(params["conv"], F.pad(h, (0, 0, cfg.d_conv - 1, 0)))
    a, u = _rglru_gates(params, h)
    y = rglru_scan(a, u).to(x.dtype)
    return L.dense_apply(params["out"], y * gate)


def rglru_init_cache(cfg: RGLRUConfig, batch: int, device=None):
    return {
        "conv": torch.zeros((batch, cfg.d_conv - 1, cfg.lru_width),
                            dtype=cfg.dtype, device=device),
        "h": torch.zeros((batch, cfg.lru_width), dtype=torch.float32,
                         device=device),
    }


def rglru_prefill(params, cfg: RGLRUConfig, x, cache):
    """Full-sequence forward that fills the recurrent cache.  x: (B,S,D)
    -> (y (B,S,D), cache).  The conv runs over [cached raw rows, new raw
    rows]; the carried h enters as a_1 h_0 added to the first input term
    (exact: the scan itself starts from h_0 = 0)."""
    gate = _gelu(L.dense_apply(params["in_gate"], x))
    h_in = L.dense_apply(params["in_x"], x)                # (B,S,W)
    window = torch.cat([cache["conv"], h_in], dim=1)
    conv_out = L.conv1d_apply(params["conv"], window)
    new_conv = window[:, -(cfg.d_conv - 1):, :].contiguous()
    a, u = _rglru_gates(params, conv_out)                  # (B,S,W) f32
    u[:, 0] += a[:, 0] * cache["h"]
    hs = rglru_scan(a, u)
    out = L.dense_apply(params["out"], hs.to(x.dtype) * gate)
    return out, {"conv": new_conv, "h": hs[:, -1].contiguous()}


def rglru_block_decode(params, cfg: RGLRUConfig, x, cache):
    """x: (B,1,D), one step -> (y (B,1,D), cache)."""
    gate = _gelu(L.dense_apply(params["in_gate"], x))
    h_in = L.dense_apply(params["in_x"], x)                # (B,1,W)
    window = torch.cat([cache["conv"], h_in], dim=1)       # (B,d_conv,W)
    conv_out = L.conv1d_apply(params["conv"], window)      # (B,1,W)
    a, u = _rglru_gates(params, conv_out)
    h_new = a[:, 0] * cache["h"] + u[:, 0]                 # (B,W)
    out = L.dense_apply(params["out"], h_new[:, None, :].to(x.dtype) * gate)
    return out, {"conv": window[:, 1:, :], "h": h_new}
