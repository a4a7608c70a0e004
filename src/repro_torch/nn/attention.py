"""Attention: grouped-query attention, DeepSeek-V2's multi-head latent
attention (MLA), Whisper's bidirectional encoder attention and its
decoder's cross-attention, with RoPE and decode caches (port of
`repro/nn/attention.py`).

Shapes: x is (B, S, D); heads are (B, S, H, head_dim).  A GQA cache is
{"k", "v": (B, cache_len, K, head_dim), "pos": int}; an MLA cache keeps
the compressed rows, {"c_kv": (B, cache_len, kv_lora_rank), "k_pe":
(B, cache_len, qk_rope_head_dim), "pos": int}.

Training (`gqa_apply`, `mla_apply`) and prefill attend through
`ops.flash_attention` (the flash kernel on a CUDA tensor, the plain
grouped einsum on a CPU or meta one); MLA's prefill attends with q/k of
qk_nope + qk_rope and v of v_head_dim (192 and 128 in DeepSeek-V2).  A
`kind="bidir"` config (Whisper's encoder) takes no rope and attends
every key, through the flash kernel's non-causal mode.  Cross-attention
(`cross_attn_kv`, `cross_attn_apply`) reads K/V computed once from the
encoder's output, over its own length, and attends plainly with
`grouped_attention`, as the reference does: the TPU kernel, and so its
port, takes one length for q and kv.
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
each row's ring wraps on its own).  A GQA cache stores native rows or,
with `kv_cache_dtype="int8"`, int8 rows with a float32 scale a (slot,
head) (`_quant_kv`; decode dequantizes the ring, the reference's
arithmetic).  With `decode_kv_shard` the ring is sharded by length over
a mesh axis (`gqa_decode_sharded`, split-KV with an online-softmax
combine over the ranks).
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
from repro_torch.nn import dist
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
    kind: str = "gqa"                 # "gqa" | "mla" | "bidir" | "cross"
    # --- MLA (deepseek-v2) ---
    q_lora_rank: int = 0              # 0 = full-rank q projection
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    # split-KV decode: the mesh axis the ring is sharded over by length
    # (None = the single-device path).  See gqa_decode_sharded.
    decode_kv_shard: str | None = None
    # KV cache storage: "native" | "int8" (int8 rows with an fp32 scale a
    # (slot, head))
    kv_cache_dtype: str = "native"
    dtype: Any = torch.float32

    def __post_init__(self):
        if self.kv_cache_dtype not in ("native", "int8"):
            raise ValueError(f"kv_cache_dtype {self.kv_cache_dtype!r}: "
                             "'native' or 'int8'")
        if self.decode_kv_shard is None:
            return
        if self.kind != "gqa":
            raise ValueError(
                f"decode_kv_shard with kind={self.kind!r}: the split-KV "
                "decode is GQA only, as the reference's")
        if self.kv_cache_dtype != "native":
            raise ValueError(
                "decode_kv_shard with kv_cache_dtype='int8': the split-KV "
                "decode keeps native rows (the reference's sharded body "
                "has no int8 branch)")


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(dim: int, theta: float, device=None, *,
               folded: bool = True) -> torch.Tensor:
    """1 / theta^(2i / dim) from float32 exponents.  `folded`: the power
    and its reciprocal in float64, rounded once to float32, the bits XLA's
    constant folding gives the reference's rope in its compiled layer
    scans; a float32 power differs from them in the last bit at some
    widths (96, 192, 256 at theta 1e4), and at the long-context cursors
    (~5.2e5) that moves an angle by up to ~1e-3 rad.  The cache paths
    (prefill, decode) take these.  `folded=False`, the float32 power, is
    the no-cache training forward's (`gqa_apply`, `mla_apply`), whose
    positions stay below its sequence length: the LM fits over the int8
    wire were measured against it, and with the folded bits one int8
    level of a cut gradient flips there and 3-round trajectories part by
    1.2e-3 (the float32 sums of the two frameworks straddle it)."""
    e = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    if folded:
        return (1.0 / theta ** e.double()).float()
    return 1.0 / (theta ** e)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, *, theta: float,
               fraction: float = 1.0, folded: bool = True) -> torch.Tensor:
    """x: (B, S, H, hd); positions: (B, S) or (S,)."""
    hd = x.shape[-1]
    rot = int(hd * fraction)
    rot -= rot % 2
    if rot == 0:
        return x
    x_rot, x_pass = x[..., :rot], x[..., rot:]
    freqs = rope_freqs(rot, theta, x.device, folded=folded)
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


def _kv_shard(cfg: AttnConfig):
    """(mesh, ranks, this rank's index) of the split-KV axis."""
    mesh = dist.get_mesh()
    ax = cfg.decode_kv_shard
    return mesh, mesh.shape[ax], mesh.coords[ax]


def gqa_init_cache(cfg: AttnConfig, batch: int, max_len: int, device=None):
    """Zero rings of `min(max_len, window)` rows: native k/v, or int8 k/v
    (B, L, K, hd) with float32 `k_scale`/`v_scale` (B, L, K, 1).  Under
    `decode_kv_shard` this rank's length chunk, L/n rows, on the mesh's
    device unless `device` is given."""
    K, hd = cfg.n_kv_heads, cfg.head_dim
    cache_len = min(max_len, cfg.window) if cfg.window else max_len
    if cfg.decode_kv_shard is not None:
        mesh, n, _ = _kv_shard(cfg)
        if cache_len % n:
            raise ValueError(f"a ring of {cache_len} rows does not divide "
                             f"over the {n} ranks of {cfg.decode_kv_shard!r}")
        cache_len //= n
        device = mesh.device if device is None else device
    shape = (batch, cache_len, K, hd)
    if cfg.kv_cache_dtype == "int8":
        kw = dict(dtype=torch.float32, device=device)
        return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "k_scale": torch.zeros(shape[:-1] + (1,), **kw),
                "v_scale": torch.zeros(shape[:-1] + (1,), **kw),
                "pos": 0}
    kw = dict(dtype=cfg.dtype, device=device)
    return {"k": torch.zeros(shape, **kw), "v": torch.zeros(shape, **kw),
            "pos": 0}


def _quant_kv(t):
    """(..., hd) -> int8 rows and a float32 scale a row (..., 1): scale =
    absmax / 127 (at least 1e-12), q = round-half-even(t / scale) clipped
    to +-127, all in float32 (IEEE division)."""
    tf = t.float()
    amax = tf.abs().amax(dim=-1, keepdim=True)
    # a tensor divisor: CUDA divides by a Python scalar as a product with
    # its reciprocal, which is not IEEE division
    scale = torch.clamp_min(amax / torch.full_like(amax, 127.0), 1e-12)
    q = torch.clamp(torch.round(tf / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequant_kv(q, scale, dtype):
    return (q.float() * scale).to(dtype)


def _kv_rows(cfg: AttnConfig, k, v) -> dict:
    """The cache entries of the rows k, v: themselves, or for an int8
    cache their int8 rows and scales."""
    if cfg.kv_cache_dtype != "int8":
        return {"k": k, "v": v}
    (kq, ks), (vq, vs) = _quant_kv(k), _quant_kv(v)
    return {"k": kq, "k_scale": ks, "v": vq, "v_scale": vs}


def _cache_kv(cfg: AttnConfig, cache, dtype):
    """The whole ring's k and v in `dtype` (an int8 ring dequantized)."""
    if cfg.kv_cache_dtype == "int8":
        return (_dequant_kv(cache["k"], cache["k_scale"], dtype),
                _dequant_kv(cache["v"], cache["v_scale"], dtype))
    return cache["k"], cache["v"]


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
    computes them from the int8 wire payload.  An int8 cache quantizes
    the new rows, writes them in place and attends over the whole ring
    dequantized.  Updates `cache` in place and returns (y, cache).  A
    config with `decode_kv_shard` takes `gqa_decode_sharded`."""
    if cfg.decode_kv_shard is not None:
        return gqa_decode_sharded(params, cfg, x, cache, qkv=qkv)
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
    for name, t in _kv_rows(cfg, k, v).items():
        _ring_put(cache[name], t, pos % cache_len)
    kc, vc = _cache_kv(cfg, cache, k.dtype)
    # ring order is irrelevant to softmax: rope encoded absolute positions
    mask = _valid_mask(pos, cache_len, B, x.device)
    out = grouped_attention(q, kc, vc, mask,
                            scale=1.0 / math.sqrt(cfg.head_dim))
    y = L.dense_apply(params["wo"], out.reshape(B, 1, -1))
    cache["pos"] = pos + 1
    return y, cache


def _attend(params, cfg: AttnConfig, x, positions, mask, *,
            folded: bool = True):
    """The full-sequence attention: q/k/v with rope (none for "bidir";
    `folded` as in `rope_freqs`), attention and the output projection.
    Returns (y, k, v), k and v after rope."""
    B, S, _ = x.shape
    q, k, v = _qkv(params, cfg, x)
    bidir = cfg.kind == "bidir"
    if not bidir:
        q = apply_rope(q, positions, theta=cfg.rope_theta,
                       fraction=cfg.rope_fraction, folded=folded)
        k = apply_rope(k, positions, theta=cfg.rope_theta,
                       fraction=cfg.rope_fraction, folded=folded)
    scale = 1.0 / math.sqrt(cfg.head_dim)
    if mask is None:
        out = ops.flash_attention(q, k, v, causal=not bidir,
                                  window=None if bidir else cfg.window,
                                  scale=scale)
    else:
        out = grouped_attention(q, k, v, mask, scale=scale)
    return L.dense_apply(params["wo"], out.reshape(B, S, -1)), k, v


def gqa_apply(params, cfg: AttnConfig, x, *, positions=None, mask=None):
    """Full-sequence forward (train).  With `mask=None` it is causal,
    within `cfg.window` when set (for `kind="bidir"`: every key, no
    rope), through `ops.flash_attention`; an explicit (S, T) or
    (B, S, T) `mask` takes the plain `grouped_attention`."""
    if positions is None:
        positions = torch.arange(x.shape[1], device=x.device)
    return _attend(params, cfg, x, positions, mask, folded=False)[0]


def gqa_prefill(params, cfg: AttnConfig, x, cache):
    """Teacher-forced full-sequence forward that fills a fresh cache
    (pos == 0) and leaves pos = S.  For S beyond a sliding-window ring
    only the last `cache_len` rows are kept (an int8 cache quantized).
    Under `decode_kv_shard` every rank computes the whole prefill, as the
    reference's replicated prefill does, and writes the kept rows whose
    ring slots fall in its chunk."""
    S = x.shape[1]
    y, k, v = _attend(params, cfg, x, torch.arange(S, device=x.device),
                      None)
    L_l = cache["k"].shape[1]                # this rank's rows
    n, lo = 1, 0
    if cfg.decode_kv_shard is not None:
        _, n, s = _kv_shard(cfg)
        lo = s * L_l
    cache_len = L_l * n
    rows = [p for p in range(max(0, S - cache_len), S)
            if lo <= p % cache_len < lo + L_l]
    if rows:
        src = torch.tensor(rows, device=x.device)
        slots = torch.tensor([p % cache_len - lo for p in rows],
                             device=x.device)
        for name, t in _kv_rows(cfg, k[:, src], v[:, src]).items():
            cache[name][:, slots] = t
    cache["pos"] = S
    return y, cache


def gqa_decode_sharded(params, cfg: AttnConfig, x, cache, *, qkv=None):
    """One-token decode with the ring sharded by length over the mesh axis
    `cfg.decode_kv_shard` (split-KV / flash-decode; port of
    `repro/nn/attention.py:497-595`).  `cache` holds this rank's chunk,
    rows [s*L_l, (s+1)*L_l) of the ring; `pos` is the global cursor, one
    host int.

    Each rank projects its column slice of wq/wk/wv (and their biases),
    one `all_gather` of the flat features gives every rank the whole q, k
    and v (no head divisibility needed), rope at `pos`, and only the rank
    that owns the slot writes it, in place.  Each rank takes the scores
    over its chunk, masked by the global index; an `all_reduce` MAX gives
    the running max, one `all_reduce` sums the normalizers and the
    weighted values, and o / l is the attention.  Each rank's slice of
    heads times its rows of wo, summed by an `all_reduce`, is the output:
    B*H*hd floats cross the ranks, not the ring.

    Refused, as the reference cannot do them: a per-row `pos` (the
    reference broadcasts one scalar) and `qkv=` (it projects its own)."""
    pos = cache["pos"]
    if _per_row(pos):
        raise ValueError("the split-KV decode takes one cursor for the "
                         "batch (the reference broadcasts a scalar pos), "
                         "not a per-row (B,) pos")
    if qkv is not None:
        raise ValueError("the split-KV decode projects its own q/k/v: the "
                         "fused entry's qkv= is refused (the reference's "
                         "sharded body ignores it)")
    mesh, n, s = _kv_shard(cfg)
    ax = cfg.decode_kv_shard
    B = x.shape[0]
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    if (H * hd) % n or (K * hd) % n:
        raise ValueError(f"q/k/v widths {H * hd}/{K * hd} do not divide "
                         f"over the {n} ranks of {ax!r}")

    def cols(p, width):                      # this rank's column slice
        sl = slice(s * width // n, (s + 1) * width // n)
        y = x @ p["w"][:, sl]
        return y + p["b"][sl] if "b" in p else y
    local = torch.cat([cols(params["wq"], H * hd), cols(params["wk"], K * hd),
                       cols(params["wv"], K * hd)], dim=-1)
    full = dist.all_gather(local, ax, dim=-1, mesh=mesh).reshape(B, 1, n, -1)
    wq, wk = H * hd // n, K * hd // n
    q = full[..., :wq].reshape(B, 1, H, hd)
    k = full[..., wq:wq + wk].reshape(B, 1, K, hd)
    v = full[..., wq + wk:].reshape(B, 1, K, hd)
    positions = _positions(pos, B, x.device)
    q = apply_rope(q, positions, theta=cfg.rope_theta,
                   fraction=cfg.rope_fraction)
    k = apply_rope(k, positions, theta=cfg.rope_theta,
                   fraction=cfg.rope_fraction)

    L_l = cache["k"].shape[1]
    cache_len = L_l * n
    slot = pos % cache_len
    if slot // L_l == s:                     # the owner writes the slot
        _ring_put(cache["k"], k, slot - s * L_l)
        _ring_put(cache["v"], v, slot - s * L_l)

    # this chunk's partial online softmax, in float32
    ct = torch.promote_types(x.dtype, torch.float32)
    qg = q.reshape(B, 1, K, H // K, hd).to(ct)
    scores = torch.einsum("bskgd,btkd->bkgst", qg, cache["k"].to(ct)) \
        * (1.0 / math.sqrt(hd))
    gidx = s * L_l + torch.arange(L_l, device=x.device)
    valid = gidx < min(pos + 1, cache_len)
    scores = torch.where(valid, scores, NEG_INF)
    m = dist.all_reduce(scores.amax(dim=-1, keepdim=True), ax, "max",
                        mesh=mesh)                       # (B,K,G,1,1)
    p = torch.exp(scores - m)
    o_l = torch.einsum("bkgst,btkd->bskgd", p, cache["v"].to(ct))
    l_l = p.sum(dim=-1)                                  # (B,K,G,1)
    lo = dist.all_reduce(torch.cat([l_l.reshape(-1), o_l.reshape(-1)]), ax,
                         mesh=mesh)
    lsum = lo[:l_l.numel()].reshape(B, 1, K, H // K, 1)
    out = lo[l_l.numel():].reshape(o_l.shape) / torch.clamp_min(lsum, 1e-30)
    out = out.reshape(B, 1, H * hd).to(x.dtype)

    # row-parallel output projection: my heads' slice x my rows of wo
    sl = slice(s * H * hd // n, (s + 1) * H * hd // n)
    y = dist.all_reduce(out[..., sl] @ params["wo"]["w"][sl], ax, mesh=mesh)
    cache["pos"] = pos + 1
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


def _mla_kv(params, cfg: AttnConfig, x, positions, folded: bool = True):
    """The compressed rows a cache keeps: post-norm c_kv (B, S, r) and the
    rope'd k_pe (B, S, dr) (`folded` as in `rope_freqs`)."""
    r = cfg.kv_lora_rank
    kv = L.dense_apply(params["wkv_a"], x)               # (B, S, r + dr)
    # the rmsnorm kernel reads dense rows: c_kv's slice is copied out
    c_kv = L.rmsnorm_apply(params["kv_norm"], kv[..., :r].contiguous())
    k_pe = apply_rope(kv[..., r:][:, :, None, :], positions,
                      theta=cfg.rope_theta, folded=folded)[:, :, 0, :]
    return c_kv, k_pe


def _mla_attend(params, cfg: AttnConfig, x, positions, mask, *,
                folded: bool = True):
    """The full-sequence MLA: k and v decompressed from c_kv, standard
    multi-head attention at scale 1/sqrt(dn + dr).  Returns (y, c_kv,
    k_pe)."""
    B, S, _ = x.shape
    H = cfg.n_heads
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    q_nope, q_pe = _mla_q(params, cfg, x)
    q_pe = apply_rope(q_pe, positions, theta=cfg.rope_theta, folded=folded)
    c_kv, k_pe = _mla_kv(params, cfg, x, positions, folded)
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
    return _mla_attend(params, cfg, x, positions, mask, folded=False)[0]


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


# ---------------------------------------------------------------------------
# Cross-attention (Whisper's decoder over the encoder's states)
# ---------------------------------------------------------------------------

def cross_attn_kv(params, cfg: AttnConfig, enc_out):
    """K and V of the encoder's output (B, T, D), each (B, T, K, hd):
    computed once a request and kept for every decode step."""
    B, T, _ = enc_out.shape
    k = L.dense_apply(params["wk"], enc_out).reshape(B, T, cfg.n_kv_heads,
                                                     cfg.head_dim)
    v = L.dense_apply(params["wv"], enc_out).reshape(B, T, cfg.n_kv_heads,
                                                     cfg.head_dim)
    return {"k": k, "v": v}


def cross_attn_apply(params, cfg: AttnConfig, x, enc_kv):
    """x (B, S, D) attends every row of `enc_kv` (from `cross_attn_kv`),
    no rope and no mask."""
    B, S, _ = x.shape
    q = L.dense_apply(params["wq"], x).reshape(B, S, cfg.n_heads,
                                               cfg.head_dim)
    T = enc_kv["k"].shape[1]
    mask = torch.ones((S, T), dtype=torch.bool, device=x.device)
    out = grouped_attention(q, enc_kv["k"], enc_kv["v"], mask,
                            scale=1.0 / math.sqrt(cfg.head_dim))
    return L.dense_apply(params["wo"], out.reshape(B, S, -1))
