"""Attention: grouped-query attention and DeepSeek-V2's multi-head latent
attention (MLA), with RoPE and decode caches (port of
`repro/nn/attention.py`, the GQA and MLA parts).

Shapes: x is (B, S, D); heads are (B, S, H, head_dim).  A GQA cache is
{"k", "v": (B, cache_len, K, head_dim), "pos": int}; an MLA cache keeps
the compressed rows, {"c_kv": (B, cache_len, kv_lora_rank), "k_pe":
(B, cache_len, qk_rope_head_dim), "pos": int}.

Training (`gqa_apply`, `mla_apply`) and prefill attend through
`ops.flash_attention` (the flash kernel on a CUDA tensor, the plain
grouped einsum on a CPU or meta one); MLA's prefill attends with q/k of
qk_nope + qk_rope and v of v_head_dim (192 and 128 in DeepSeek-V2).
Decode attends plainly, as the reference does: GQA with
`grouped_attention` over the ring, MLA with the absorbed weights against
the compressed cache in float32.  Unlike the reference, which returns
new caches, the port writes the new rows into the cache tensors in place
and advances `pos`.  `pos` is either a host integer, one cursor for the
whole batch, or a (B,) int32 tensor on the cache's device, one cursor
per row (`models.lm.per_slot_pos`: the serving `Batcher` keeps tenants
at their own positions in one stacked cache); either way decode never
reads a device value back.  A sliding-window ring holds
`min(max_len, window)` rows, indexed `pos % cache_len` (per row, so
each row's ring wraps on its own).  Native-dtype caches only: the int8
KV cache, cross-attention and the sequence-sharded decode wait for
later slices.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.kernels import ops
# the plain attention, which decode runs over the KV ring on every device
from repro_torch.kernels.ref import causal_mask  # noqa: F401
from repro_torch.kernels.ref import NEG_INF, grouped_attention
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
    kind: str = "gqa"                 # "gqa" | "mla"
    # --- MLA (deepseek-v2) ---
    q_lora_rank: int = 0              # 0 = full-rank q projection
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
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


def _per_row(pos) -> bool:
    """Whether `pos` is the per-row (B,) cursor rather than one int."""
    return isinstance(pos, torch.Tensor)


def _positions(pos, batch: int, device) -> torch.Tensor:
    """(B, 1) rope positions of the token being decoded."""
    if _per_row(pos):
        return pos[:, None]
    return torch.full((batch, 1), pos, dtype=torch.int32, device=device)


def _ring_put(buf: torch.Tensor, val: torch.Tensor, slot) -> None:
    """Write the one-token rows `val` (B, 1, ...) at ring slot `slot`, in
    place: one int for the whole batch, or (B,) slots, one per row."""
    if _per_row(slot):
        buf[torch.arange(buf.shape[0], device=buf.device),
            slot.long()] = val[:, 0]
    else:
        buf[:, slot] = val[:, 0]


def _valid_mask(pos, cache_len: int, batch: int,
                device=None) -> torch.Tensor:
    """(B, 1, T) attend-mask over the ring: index < min(pos+1, len), with
    `pos` one int or (B,) per row."""
    idx = torch.arange(cache_len, device=device)
    if _per_row(pos):
        valid = idx[None, :] < torch.clamp_max(pos + 1, cache_len)[:, None]
        return valid[:, None, :]
    valid = (idx < min(pos + 1, cache_len))[None, :]
    return valid[:, None, :].expand(batch, 1, cache_len)


def gqa_decode(params, cfg: AttnConfig, x, cache, *, qkv=None):
    """One-token decode.  x: (B, 1, D).  Sliding-window caches are ring
    buffers indexed mod window.  `cache["pos"]` is one int for the batch
    or a (B,) tensor, each row at its own position.  `qkv` optionally
    supplies the flat pre-rope (q, k, v) projections, shapes
    (B, 1, H*hd) / (B, 1, K*hd): the serving engine's fused entry
    computes them from the int8 wire payload.  Updates `cache` in place
    and returns (y, cache)."""
    B = x.shape[0]
    if qkv is None:
        q, k, v = _qkv(params, cfg, x)
    else:
        q, k, v = qkv
        q = q.reshape(B, 1, cfg.n_heads, cfg.head_dim)
        k = k.reshape(B, 1, cfg.n_kv_heads, cfg.head_dim)
        v = v.reshape(B, 1, cfg.n_kv_heads, cfg.head_dim)
    pos = cache["pos"]
    positions = _positions(pos, B, x.device)
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


# ---------------------------------------------------------------------------
# MLA (multi-head latent attention, DeepSeek-V2): compressed KV cache
# ---------------------------------------------------------------------------

def mla_init(gen, cfg: AttnConfig, device=None):
    D, H = cfg.d_model, cfg.n_heads
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    r = cfg.kv_lora_rank
    kw = dict(dtype=cfg.dtype, device=device)
    p = {}
    if cfg.q_lora_rank:
        p["wq_a"] = L.dense_init(gen, D, cfg.q_lora_rank, **kw)
        p["q_norm"] = L.rmsnorm_init(cfg.q_lora_rank, **kw)
        p["wq_b"] = L.dense_init(gen, cfg.q_lora_rank, H * (dn + dr), **kw)
    else:
        p["wq"] = L.dense_init(gen, D, H * (dn + dr), **kw)
    p["wkv_a"] = L.dense_init(gen, D, r + dr, **kw)
    p["kv_norm"] = L.rmsnorm_init(r, **kw)
    p["wk_b"] = L.dense_init(gen, r, H * dn, **kw)
    p["wv_b"] = L.dense_init(gen, r, H * dv, **kw)
    p["wo"] = L.dense_init(gen, H * dv, D, **kw)
    return p


def _mla_q(params, cfg: AttnConfig, x):
    B, S, _ = x.shape
    dn, dr = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    if cfg.q_lora_rank:
        q = L.dense_apply(params["wq_a"], x)
        q = L.rmsnorm_apply(params["q_norm"], q)
        q = L.dense_apply(params["wq_b"], q)
    else:
        q = L.dense_apply(params["wq"], x)
    q = q.reshape(B, S, cfg.n_heads, dn + dr)
    return q[..., :dn], q[..., dn:]                      # nope, rope parts


def _mla_kv(params, cfg: AttnConfig, x, positions):
    """The compressed rows a cache keeps: post-norm c_kv (B, S, r) and the
    rope'd k_pe (B, S, dr)."""
    r = cfg.kv_lora_rank
    kv = L.dense_apply(params["wkv_a"], x)               # (B, S, r + dr)
    # the rmsnorm kernel reads dense rows: c_kv's slice is copied out
    c_kv = L.rmsnorm_apply(params["kv_norm"], kv[..., :r].contiguous())
    k_pe = apply_rope(kv[..., r:][:, :, None, :], positions,
                      theta=cfg.rope_theta)[:, :, 0, :]
    return c_kv, k_pe


def _mla_attend(params, cfg: AttnConfig, x, positions, mask):
    """The full-sequence MLA: k and v decompressed from c_kv, standard
    multi-head attention at scale 1/sqrt(dn + dr).  Returns (y, c_kv,
    k_pe)."""
    B, S, _ = x.shape
    H = cfg.n_heads
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    q_nope, q_pe = _mla_q(params, cfg, x)
    q_pe = apply_rope(q_pe, positions, theta=cfg.rope_theta)
    c_kv, k_pe = _mla_kv(params, cfg, x, positions)
    k_nope = L.dense_apply(params["wk_b"], c_kv).reshape(B, S, H, dn)
    v = L.dense_apply(params["wv_b"], c_kv).reshape(B, S, H, dv)
    q = torch.cat([q_nope, q_pe], dim=-1)
    k = torch.cat([k_nope, k_pe[:, :, None, :].expand(B, S, H, dr)], dim=-1)
    scale = 1.0 / math.sqrt(dn + dr)
    if mask is None:
        out = ops.flash_attention(q, k, v, causal=True, window=cfg.window,
                                  scale=scale)
    else:
        out = grouped_attention(q, k, v, mask, scale=scale)
    return L.dense_apply(params["wo"], out.reshape(B, S, H * dv)), c_kv, k_pe


def mla_apply(params, cfg: AttnConfig, x, *, positions=None, mask=None):
    """Full-sequence forward (train).  With `mask=None` it is causal,
    within `cfg.window` when set, through `ops.flash_attention`; an
    explicit mask takes the plain `grouped_attention`."""
    if positions is None:
        positions = torch.arange(x.shape[1], device=x.device)
    return _mla_attend(params, cfg, x, positions, mask)[0]


def mla_init_cache(cfg: AttnConfig, batch: int, max_len: int, device=None):
    cache_len = min(max_len, cfg.window) if cfg.window else max_len
    kw = dict(dtype=cfg.dtype, device=device)
    return {"c_kv": torch.zeros((batch, cache_len, cfg.kv_lora_rank), **kw),
            "k_pe": torch.zeros((batch, cache_len, cfg.qk_rope_head_dim),
                                **kw),
            "pos": 0}


def mla_decode(params, cfg: AttnConfig, x, cache):
    """Absorbed-weight decode: the scores are taken against the
    compressed cache c_kv in float32 (wk_b folded into q, wv_b applied
    after the weighted sum), never a per-token K or V.  As in
    `gqa_decode`, `cache["pos"]` is one int or (B,) per row.  Updates
    `cache` in place and returns (y, cache)."""
    B = x.shape[0]
    H = cfg.n_heads
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    r = cfg.kv_lora_rank
    pos = cache["pos"]
    positions = _positions(pos, B, x.device)
    q_nope, q_pe = _mla_q(params, cfg, x)                # (B,1,H,dn|dr)
    q_pe = apply_rope(q_pe, positions, theta=cfg.rope_theta)
    c_new, kpe_new = _mla_kv(params, cfg, x, positions)
    cache_len = cache["c_kv"].shape[1]
    slot = pos % cache_len
    _ring_put(cache["c_kv"], c_new, slot)
    _ring_put(cache["k_pe"], kpe_new, slot)
    c_kv, k_pe = cache["c_kv"].float(), cache["k_pe"].float()

    # absorb wk_b into q: q_eff[b,h,r'] = sum_dn q_nope * wk_b[r', h, dn]
    wk_b = params["wk_b"]["w"].reshape(r, H, dn).float()
    q_eff = torch.einsum("bshd,rhd->bshr", q_nope.float(), wk_b)
    scores = torch.einsum("bshr,btr->bhst", q_eff, c_kv)
    scores = scores + torch.einsum("bshd,btd->bhst", q_pe.float(), k_pe)
    scores = scores / math.sqrt(dn + dr)
    valid = _valid_mask(pos, cache_len, B, x.device)    # (B, 1, T)
    scores = torch.where(valid[:, None], scores, NEG_INF)
    w = torch.softmax(scores, dim=-1)                   # (B, H, 1, T)
    ctx = torch.einsum("bhst,btr->bshr", w, c_kv)       # (B, 1, H, r)
    wv_b = params["wv_b"]["w"].reshape(r, H, dv).float()
    out = torch.einsum("bshr,rhd->bshd", ctx, wv_b)
    y = L.dense_apply(params["wo"], out.reshape(B, 1, H * dv).to(x.dtype))
    cache["pos"] = pos + 1
    return y, cache


def mla_prefill(params, cfg: AttnConfig, x, cache):
    """Full-sequence MLA forward (the math of `mla_apply`) that also
    writes the compressed rows (post-norm c_kv and rope'd k_pe, what
    `mla_decode` stores) into a fresh cache and leaves pos = S."""
    S = x.shape[1]
    y, c_kv, k_pe = _mla_attend(params, cfg, x,
                                torch.arange(S, device=x.device), None)
    cache_len = cache["c_kv"].shape[1]
    keep = min(S, cache_len)
    slots = torch.arange(S - keep, S, device=x.device) % cache_len
    cache["c_kv"][:, slots] = c_kv[:, S - keep:]
    cache["k_pe"][:, slots] = k_pe[:, S - keep:]
    cache["pos"] = S
    return y, cache
