"""Plain-torch copies of the reference's oracles (`repro.kernels.ref`) for
the kernels the port has ported.

Attention's plain version is the grouped einsum the served models have
always run (`repro/nn/attention.py:grouped_attention` with `causal_mask`),
so a model on the CPU computes what the reference's `gqa_prefill` does;
decode runs `grouped_attention` over its KV ring on every device.

The quantizer's two constants are the float32 values the reference uses
(`f32(1/127)` and `f32(1e-12)`), held as Python floats that are exact in
float32, so the products and the comparison round the same whatever
precision torch computes a scalar operand in.
"""
from __future__ import annotations

import math

import numpy as np
import torch

NEG_INF = -1e30
INV127 = float(np.float32(1.0 / 127.0))
EPS = float(np.float32(1e-12))


def plain_grads(fn, saved, needs, *grad_outputs) -> tuple:
    """The backward of a kernel's autograd Function: the plain version
    `fn` recomputed on fresh leaves of the `saved` inputs under grad and
    differentiated at `grad_outputs`.  One entry per input, None where
    `needs` (the Function's `needs_input_grad`) asks for none or the
    input is None."""
    with torch.enable_grad():
        ins = [None if t is None else t.detach().requires_grad_(bool(n))
               for t, n in zip(saved, needs)]
        outs = fn(*ins)
        outs = outs if isinstance(outs, tuple) else (outs,)
        want = [t for t in ins if t is not None and t.requires_grad]
        gs = iter(torch.autograd.grad(outs, want, grad_outputs,
                                      allow_unused=True) if want else ())
    return tuple(next(gs) if t is not None and t.requires_grad else None
                 for t in ins)


def wire_quant_ref(x: torch.Tensor):
    """Per-last-axis-row symmetric int8 quantize + pack -> (q int8,
    fp32 row scales (..., 1)).  `torch.round` rounds half to even, as
    the reference's `jnp.round` does."""
    xf = x.float()
    scale = torch.amax(xf.abs(), dim=-1, keepdim=True) * INV127
    scale = torch.clamp_min(scale, EPS)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def wire_dequant_ref(q: torch.Tensor, scale: torch.Tensor,
                     dtype=torch.float32):
    return (q.float() * scale).to(dtype)


def splitcat_linear_ref(parts: list, w: torch.Tensor, b=None):
    """concat(parts, -1) @ w (+ b) — the vertical-split server entry op."""
    x = torch.cat(parts, dim=-1)
    y = x.float() @ w.float()
    if b is not None:
        y = y + b.float()
    return y.to(parts[0].dtype)


def splitcat_linear_q8_ref(qs: list, scales: list, w: torch.Tensor, b=None,
                           out_dtype=torch.float32):
    """Dequant + concat + matmul over packed int8 payloads — the
    reference's oracle for the fused q8 kernel (dequantizes first)."""
    parts = [wire_dequant_ref(q, s) for q, s in zip(qs, scales)]
    return splitcat_linear_ref(parts, w, b).to(out_dtype)


def rmsnorm_ref(x: torch.Tensor, scale: torch.Tensor, *, eps: float = 1e-6):
    """x * rsqrt(mean(x^2) + eps) * scale per last-axis row, in float32,
    cast back to x's dtype."""
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def ssd_scan_ref(x, dt, A, Bm, Cm):
    """Naive O(S) recurrence oracle for the SSD scan.
    x: (B,S,H,P) dt: (B,S,H) A: (H,) Bm/Cm: (B,S,G,N) -> (B,S,H,P);
    head h reads state group h // (H/G).  The state is float32, as in
    the reference (float64 for float64 inputs)."""
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    rep = H // G
    acc = torch.promote_types(x.dtype, torch.float32)
    state = torch.zeros((Bsz, H, P, N), dtype=acc, device=x.device)
    ys = []
    for t in range(S):
        Bh = Bm[:, t].repeat_interleave(rep, dim=1).to(acc)   # (B,H,N)
        Ch = Cm[:, t].repeat_interleave(rep, dim=1).to(acc)
        da = torch.exp(dt[:, t] * A[None, :])                 # (B,H)
        xd = (x[:, t] * dt[:, t, :, None]).to(acc)            # (B,H,P)
        state = state * da[:, :, None, None] \
            + torch.einsum("bhp,bhn->bhpn", xd, Bh)
        ys.append(torch.einsum("bhpn,bhn->bhp", state, Ch))
    return torch.stack(ys, dim=1).to(x.dtype)


def causal_mask(q_len: int, kv_len: int, *, window: int | None = None,
                device=None) -> torch.Tensor:
    """(q_len, kv_len) boolean: True = attend."""
    q_pos = torch.arange(q_len, device=device)[:, None]
    k_pos = torch.arange(kv_len, device=device)[None, :]
    m = k_pos <= q_pos
    if window is not None:
        m = m & (k_pos > q_pos - window)
    return m


def grouped_attention(q, k, v, mask, *, scale: float) -> torch.Tensor:
    """q: (B,S,H,hd), k: (B,T,K,hd), v: (B,T,K,hd_v), mask: (S,T) or
    (B,S,T).  Scores
    and softmax in float32 (float64 for float64 inputs); query head h
    reads KV head h // (H/K), which is never repeated in memory.
    Returns (B,S,H,hd_v) in q's dtype."""
    B, S, H, hd = q.shape
    K = k.shape[2]
    ct = torch.promote_types(q.dtype, torch.float32)
    qg = q.reshape(B, S, K, H // K, hd)
    scores = torch.einsum("bskgd,btkd->bkgst", qg.to(ct), k.to(ct)) * scale
    if mask.ndim == 2:
        mask = mask[None, None, None, :, :]
    else:  # (B, S, T) -> (B,1,1,S,T)
        mask = mask[:, None, None, :, :]
    scores = torch.where(mask, scores, NEG_INF)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", w, v.to(ct))
    return out.reshape(B, S, H, v.shape[-1]).to(q.dtype)


def flash_attention_ref(q, k, v, *, causal: bool = True,
                        window: int | None = None, scale: float | None = None):
    """Attention over a whole sequence, q (B,S,H,DQK), k (B,S,K,DQK) and
    v (B,S,K,DV) with H % K == 0 -> (B,S,H,DV): key j is visible to query
    i when j <= i (causal) and j > i - window (a window); softmax in
    float32 (float64 for float64 inputs), the result in q's dtype.
    `scale` defaults to 1/sqrt(DQK)."""
    S = q.shape[1]
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if causal:
        mask = causal_mask(S, S, window=window, device=q.device)
    else:                        # without a window every key is visible
        pos = torch.arange(S, device=q.device)
        mask = pos[None, :] > pos[:, None] - (S if window is None else window)
    return grouped_attention(q, k, v, mask, scale=scale)
