"""Mamba2 / SSD (state-space duality) block (port of `repro/nn/ssm.py`,
arXiv:2405.21060).

The SSD layer computes, per head h with scalar decay a_t = exp(dt_t A_h):

    s_t = a_t s_{t-1} + dt_t x_t B_t^T        s in R^{P x N}
    y_t = s_t C_t  (+ D x_t)

Prefill runs the whole sequence through `ssd_chunked`: the SSD kernel on
a CUDA tensor, the reference's chunked dual form on a CPU or meta one
(`kernels.ssd_scan`).  Decode is the O(1) recurrent update
`ssd_decode_step`, which has no kernel.  Layout follows the reference:
x (B,S,H,P), B/C (B,S,G,N) with G state groups, dt (B,S,H), A (H,).
`A_log`, `D` and `dt_bias` are float32 in a bf16 model, as there.
`F.softplus` stands for the reference's `jax.nn.softplus`
(`logaddexp(x, 0)`): above its threshold of 20 it returns x itself,
which differs by log1p(exp(-20)) = 2e-9, below a float32 ulp of 20.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.nn import layers as L


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_model: int
    d_inner: int              # = expand * d_model
    head_dim: int = 64        # P
    d_state: int = 128        # N
    n_groups: int = 1         # G
    d_conv: int = 4
    chunk: int = 256          # SSD chunk length
    dtype: Any = torch.float32

    @property
    def n_heads(self) -> int:
        return self.d_inner // self.head_dim


def ssd_chunked(x, dt, A, Bm, Cm, *, chunk: int, initial_state=None,
                return_state: bool = False):
    """Chunked SSD scan: x (B,S,H,P) dt (B,S,H) A (H,) Bm/Cm (B,S,G,N) ->
    y (B,S,H,P), and the final (B,H,P,N) float32 state if
    `return_state`.  `initial_state` ((B,H,P,N) float32) seeds the
    recurrence, so the output continues an earlier sequence exactly as
    the recurrent decode would.  S % chunk == 0."""
    return ops.ssd_scan(x, dt, A, Bm, Cm, chunk=chunk,
                        initial_state=initial_state,
                        return_state=return_state)


def ssd_decode_step(state, x_t, dt_t, A, B_t, C_t):
    """O(1) recurrent step.  state: (B,H,P,N); x_t: (B,H,P); dt_t: (B,H);
    B_t/C_t: (B,G,N)."""
    rep = x_t.shape[1] // B_t.shape[1]
    Bh = B_t.repeat_interleave(rep, dim=1)               # (B,H,N)
    Ch = C_t.repeat_interleave(rep, dim=1)
    da = torch.exp(dt_t * A[None, :])                    # (B,H)
    xd = x_t * dt_t[..., None]
    new_state = state * da[:, :, None, None] \
        + torch.einsum("bhp,bhn->bhpn", xd.float(), Bh.float())
    y = torch.einsum("bhpn,bhn->bhp", new_state, Ch.float())
    return new_state, y.to(x_t.dtype)


# ---------------------------------------------------------------------------
# Full Mamba2 mixer layer (proj -> conv -> SSD -> gate -> proj)
# ---------------------------------------------------------------------------

def mamba2_init(gen, cfg: SSMConfig, device=None):
    device = gen.device if device is None else device
    D, Di = cfg.d_model, cfg.d_inner
    H, G, N = cfg.n_heads, cfg.n_groups, cfg.d_state
    conv_dim = Di + 2 * G * N
    kw = dict(dtype=cfg.dtype, device=device)
    f32 = dict(dtype=torch.float32, device=device)
    return {
        # in_proj -> [z (gate), x, B, C, dt]
        "in_proj": L.dense_init(gen, D, 2 * Di + 2 * G * N + H, **kw),
        "conv": L.conv1d_init(gen, conv_dim, conv_dim, cfg.d_conv, **kw),
        "A_log": torch.log(torch.linspace(1.0, 16.0, H, **f32)),
        "D": torch.ones((H,), **f32),
        "dt_bias": torch.zeros((H,), **f32),
        "norm": L.rmsnorm_init(Di, **kw),
        "out_proj": L.dense_init(gen, Di, D, **kw),
    }


def _depthwise_conv(params, x, d_conv: int):
    """The reference's "depthwise" conv: a dense (k, C, C) causal conv
    (zero front padding, then VALID), kept as the reference has it."""
    return L.conv1d_apply(params, F.pad(x, (0, 0, d_conv - 1, 0)))


def _split_xbc(cfg: SSMConfig, zxbcdt):
    Di, G, N = cfg.d_inner, cfg.n_groups, cfg.d_state
    return torch.split(zxbcdt, [Di, Di + 2 * G * N, cfg.n_heads], dim=-1)


def _heads(cfg: SSMConfig, xbc, lead: tuple):
    """Split the conv output into x (.., H, P), B and C (.., G, N)."""
    Di, G, N = cfg.d_inner, cfg.n_groups, cfg.d_state
    xs, Bm, Cm = torch.split(xbc, [Di, G * N, G * N], dim=-1)
    return (xs.reshape(*lead, cfg.n_heads, cfg.head_dim),
            Bm.reshape(*lead, G, N), Cm.reshape(*lead, G, N))


def _gate_out(params, cfg: SSMConfig, y, xs, z):
    """y + D x, the gated rmsnorm, and the output projection."""
    y = y + xs * params["D"].to(y.dtype)[..., :, None]
    y = y.reshape(*z.shape[:-1], cfg.d_inner)
    y = L.rmsnorm_apply(params["norm"], y) * F.silu(z)
    return L.dense_apply(params["out_proj"], y)


def mamba2_apply(params, cfg: SSMConfig, x):
    """x: (B,S,D) -> (B,S,D).  Full sequence from a zero state."""
    B, S, _ = x.shape
    z, xbc, dt = _split_xbc(cfg, L.dense_apply(params["in_proj"], x))
    xbc = F.silu(_depthwise_conv(params["conv"], xbc, cfg.d_conv))
    xs, Bm, Cm = _heads(cfg, xbc, (B, S))
    dt = F.softplus(dt + params["dt_bias"])                # (B,S,H)
    A = -torch.exp(params["A_log"])                      # (H,) < 0
    y = ssd_chunked(xs, dt, A, Bm, Cm, chunk=min(cfg.chunk, S))
    return _gate_out(params, cfg, y, xs, z)


def mamba2_init_cache(cfg: SSMConfig, batch: int, device=None):
    conv_dim = cfg.d_inner + 2 * cfg.n_groups * cfg.d_state
    return {
        "conv": torch.zeros((batch, cfg.d_conv - 1, conv_dim),
                            dtype=cfg.dtype, device=device),
        "ssm": torch.zeros((batch, cfg.n_heads, cfg.head_dim, cfg.d_state),
                           dtype=torch.float32, device=device),
    }


def mamba2_prefill(params, cfg: SSMConfig, x, cache):
    """Full-sequence forward that fills the recurrent cache.  x: (B,S,D)
    -> (y (B,S,D), cache).

    Any S: the scan runs over the full chunks and threads its carried
    state into one remainder call (padding would be wrong: padded steps
    still decay the state).  The conv cache keeps the last d_conv-1 RAW
    (pre-conv, pre-silu) rows, the window the decode step shifts."""
    B, S, _ = x.shape
    z, xbc_raw, dt = _split_xbc(cfg, L.dense_apply(params["in_proj"], x))
    # conv over [cached window, raw rows]; a fresh cache is the zero
    # front padding of `mamba2_apply`'s causal conv
    window = torch.cat([cache["conv"], xbc_raw], dim=1)
    xbc = F.silu(L.conv1d_apply(params["conv"], window))
    new_conv = window[:, -(cfg.d_conv - 1):, :].contiguous()
    xs, Bm, Cm = _heads(cfg, xbc, (B, S))
    dt = F.softplus(dt + params["dt_bias"])
    A = -torch.exp(params["A_log"])

    state = cache["ssm"]
    c = min(cfg.chunk, S)
    main = (S // c) * c
    ys = []
    for lo, hi, chunk in ((0, main, c), (main, S, S - main)):
        if hi > lo:
            y, state = ssd_chunked(
                xs[:, lo:hi], dt[:, lo:hi], A, Bm[:, lo:hi], Cm[:, lo:hi],
                chunk=chunk, initial_state=state, return_state=True)
            ys.append(y)
    y = ys[0] if len(ys) == 1 else torch.cat(ys, dim=1)
    return _gate_out(params, cfg, y, xs, z), {"conv": new_conv, "ssm": state}


def mamba2_decode(params, cfg: SSMConfig, x, cache):
    """x: (B,1,D), one step of the recurrence -> (y (B,1,D), cache)."""
    B = x.shape[0]
    z, xbc, dt = _split_xbc(cfg, L.dense_apply(params["in_proj"], x))
    window = torch.cat([cache["conv"], xbc], dim=1)      # (B, d_conv, C)
    xbc = F.silu(L.conv1d_apply(params["conv"], window))  # (B, 1, C)
    xs, Bm, Cm = _heads(cfg, xbc[:, 0], (B,))
    dt1 = F.softplus(dt[:, 0] + params["dt_bias"])         # (B,H)
    A = -torch.exp(params["A_log"])
    new_state, y = ssd_decode_step(cache["ssm"], xs, dt1, A, Bm, Cm)
    return (_gate_out(params, cfg, y, xs, z),
            {"conv": window[:, 1:, :], "ssm": new_state})
