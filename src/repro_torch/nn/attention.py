"""Grouped-query attention with RoPE and a decode KV cache (port of
`repro/nn/attention.py`, the GQA part).

Shapes: x is (B, S, D); heads are (B, S, H, head_dim); a KV cache is
{"k", "v": (B, cache_len, K, head_dim), "pos": int}.

Training (`gqa_apply`) and prefill attend through `ops.flash_attention`
(the flash kernel on a CUDA tensor, the plain grouped einsum on a CPU or
meta one); decode
attends over the ring with the plain `grouped_attention`, as the
reference does.  Unlike the reference, which returns new caches, the
port writes the new K/V rows into the cache tensors in place and
advances `pos`, a host integer (one cursor for the whole batch), so
decode never reads a device value back.  A sliding-window ring holds
`min(max_len, window)` rows, indexed `pos % cache_len`.  Native-dtype
caches only: the int8 KV cache, MLA, cross-attention and the
sequence-sharded decode wait for later slices.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.kernels import ops
# the plain attention, which decode runs over the KV ring on every device
from repro_torch.kernels.ref import causal_mask  # noqa: F401
from repro_torch.kernels.ref import grouped_attention
from repro_torch.nn import layers as L


@dataclasses.dataclass(frozen=True)
class AttnConfig:
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    qkv_bias: bool = False
    rope_fraction: float = 1.0
    rope_theta: float = 10000.0
    window: int | None = None
    dtype: Any = torch.float32


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                         device=device) / dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, *, theta: float,
               fraction: float = 1.0) -> torch.Tensor:
    """x: (B, S, H, hd); positions: (B, S) or (S,)."""
    hd = x.shape[-1]
    rot = int(hd * fraction)
    rot -= rot % 2
    if rot == 0:
        return x
    x_rot, x_pass = x[..., :rot], x[..., rot:]
    freqs = rope_freqs(rot, theta, x.device)
    if positions.ndim == 1:
        positions = positions[None, :]
    ang = positions[..., None].float() * freqs           # (B, S, rot/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x_rot.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return torch.cat([out.to(x.dtype), x_pass], dim=-1)


# ---------------------------------------------------------------------------
# GQA module
# ---------------------------------------------------------------------------

def gqa_init(gen, cfg: AttnConfig, device=None):
    D, H, K, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    kw = dict(dtype=cfg.dtype, device=device)
    return {
        "wq": L.dense_init(gen, D, H * hd, bias=cfg.qkv_bias, **kw),
        "wk": L.dense_init(gen, D, K * hd, bias=cfg.qkv_bias, **kw),
        "wv": L.dense_init(gen, D, K * hd, bias=cfg.qkv_bias, **kw),
        "wo": L.dense_init(gen, H * hd, D, bias=False, **kw),
    }


def _qkv(params, cfg: AttnConfig, x):
    B, S, _ = x.shape
    q = L.dense_apply(params["wq"], x).reshape(B, S, cfg.n_heads, cfg.head_dim)
    k = L.dense_apply(params["wk"], x).reshape(B, S, cfg.n_kv_heads,
                                               cfg.head_dim)
    v = L.dense_apply(params["wv"], x).reshape(B, S, cfg.n_kv_heads,
                                               cfg.head_dim)
    return q, k, v


def gqa_init_cache(cfg: AttnConfig, batch: int, max_len: int, device=None):
    K, hd = cfg.n_kv_heads, cfg.head_dim
    cache_len = min(max_len, cfg.window) if cfg.window else max_len
    kw = dict(dtype=cfg.dtype, device=device)
    return {"k": torch.zeros((batch, cache_len, K, hd), **kw),
            "v": torch.zeros((batch, cache_len, K, hd), **kw),
            "pos": 0}


def _ring_put(buf: torch.Tensor, val: torch.Tensor, slot: int) -> None:
    """Write the one-token rows `val` (B, 1, ...) at ring slot `slot`,
    in place."""
    buf[:, slot] = val[:, 0]


def _valid_mask(pos: int, cache_len: int, batch: int,
                device=None) -> torch.Tensor:
    """(B, 1, T) attend-mask over the ring: index < min(pos+1, len)."""
    idx = torch.arange(cache_len, device=device)
    valid = (idx < min(pos + 1, cache_len))[None, :]
    return valid[:, None, :].expand(batch, 1, cache_len)


def gqa_decode(params, cfg: AttnConfig, x, cache, *, qkv=None):
    """One-token decode.  x: (B, 1, D).  Sliding-window caches are ring
    buffers indexed mod window.  `qkv` optionally supplies the flat
    pre-rope (q, k, v) projections, shapes (B, 1, H*hd) / (B, 1, K*hd):
    the serving engine's fused entry computes them from the int8 wire
    payload.  Updates `cache` in place and returns (y, cache)."""
    B = x.shape[0]
    if qkv is None:
        q, k, v = _qkv(params, cfg, x)
    else:
        q, k, v = qkv
        q = q.reshape(B, 1, cfg.n_heads, cfg.head_dim)
        k = k.reshape(B, 1, cfg.n_kv_heads, cfg.head_dim)
        v = v.reshape(B, 1, cfg.n_kv_heads, cfg.head_dim)
    pos = cache["pos"]
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    q = apply_rope(q, positions, theta=cfg.rope_theta,
                   fraction=cfg.rope_fraction)
    k = apply_rope(k, positions, theta=cfg.rope_theta,
                   fraction=cfg.rope_fraction)
    cache_len = cache["k"].shape[1]
    slot = pos % cache_len
    _ring_put(cache["k"], k, slot)
    _ring_put(cache["v"], v, slot)
    # ring order is irrelevant to softmax: rope encoded absolute positions
    mask = _valid_mask(pos, cache_len, B, x.device)
    out = grouped_attention(q, cache["k"], cache["v"], mask,
                            scale=1.0 / math.sqrt(cfg.head_dim))
    y = L.dense_apply(params["wo"], out.reshape(B, 1, -1))
    cache["pos"] = pos + 1
    return y, cache


def _attend(params, cfg: AttnConfig, x, positions, mask):
    """The full-sequence attention: q/k/v with rope, attention and the
    output projection.  Returns (y, k, v), k and v after rope."""
    B, S, _ = x.shape
    q, k, v = _qkv(params, cfg, x)
    q = apply_rope(q, positions, theta=cfg.rope_theta,
                   fraction=cfg.rope_fraction)
    k = apply_rope(k, positions, theta=cfg.rope_theta,
                   fraction=cfg.rope_fraction)
    scale = 1.0 / math.sqrt(cfg.head_dim)
    if mask is None:
        out = ops.flash_attention(q, k, v, causal=True, window=cfg.window,
                                  scale=scale)
    else:
        out = grouped_attention(q, k, v, mask, scale=scale)
    return L.dense_apply(params["wo"], out.reshape(B, S, -1)), k, v


def gqa_apply(params, cfg: AttnConfig, x, *, positions=None, mask=None):
    """Full-sequence forward (train).  With `mask=None` it is causal,
    within `cfg.window` when set, through `ops.flash_attention`; an
    explicit (S, T) or (B, S, T) `mask` takes the plain
    `grouped_attention`."""
    if positions is None:
        positions = torch.arange(x.shape[1], device=x.device)
    return _attend(params, cfg, x, positions, mask)[0]


def gqa_prefill(params, cfg: AttnConfig, x, cache):
    """Teacher-forced full-sequence forward that fills a fresh cache
    (pos == 0) and leaves pos = S.  For S beyond a sliding-window ring
    only the last `cache_len` rows are kept."""
    S = x.shape[1]
    y, k, v = _attend(params, cfg, x, torch.arange(S, device=x.device),
                      None)
    cache_len = cache["k"].shape[1]
    keep = min(S, cache_len)
    slots = torch.arange(S - keep, S, device=x.device) % cache_len
    cache["k"][:, slots] = k[:, S - keep:]
    cache["v"][:, slots] = v[:, S - keep:]
    cache["pos"] = S
    return y, cache
