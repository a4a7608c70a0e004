"""Public entry points for the port's kernels.

Each wrapper dispatches by the device of the tensor it is given — a CUDA
tensor launches the hand-written kernel, a CPU or meta tensor takes the
plain version — so there is no mode switch and no fallback.  This module
adds the 0-d leaf path of `repro/kernels/ops.py:127-149` and the launch
counters' reset.  Like the reference (`repro/kernels/ops.py:164-191`),
`flash_attention`'s K KV heads reach the H query heads as head h -> KV
head h // (H/K), and `ssd_scan`'s G state groups as head h -> group
h // (H/G); the kernels index the KV head and the group in place.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import rmsnorm as _rn
from repro_torch.kernels import splitcat_linear as _sc
from repro_torch.kernels import ssd_scan as _ssd
from repro_torch.kernels import wire_quant as _wq
from repro_torch.kernels.wire_quant import wire_roundtrip  # noqa: F401

_COUNTERS = (_wq.launches, _sc.launches, _rn.launches, _ssd.launches,
             _fa.launches)


def wire_quantize(x: torch.Tensor):
    """Per-row absmax quantize + int8 pack: x -> (q, row scales).  A 0-d
    payload is packed as a one-element row and keeps its () shape."""
    if x.ndim == 0:
        q, s = wire_quantize(x[None])
        return q[0], s[0]
    return _wq.wire_quant(x)


def wire_dequantize(q: torch.Tensor, scale: torch.Tensor,
                    dtype=torch.float32) -> torch.Tensor:
    if q.ndim == 0:
        return wire_dequantize(q[None], scale[None], dtype)[0]
    return _wq.wire_dequant(q, scale, dtype)


def splitcat_linear(parts, w, b=None):
    """Fused concat + matmul over dense parts, `concat(parts) @ w (+ b)`
    without the concat — the vertical split's server entry."""
    return _sc.splitcat_linear(parts, w, b)


def splitcat_linear_q8(qs, scales, w, b=None, *, out_dtype=torch.float32):
    """Fused dequant + concat + matmul over packed int8 payloads — the
    server entry layer reading the physical wire directly."""
    return _sc.splitcat_linear_q8(qs, scales, w, b, out_dtype)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6):
    """x * rsqrt(mean(x^2) + eps) * scale over the last axis, in float32,
    cast back to x's type."""
    return _rn.rmsnorm(x, scale, eps)


def flash_attention(q, k, v, *, causal: bool = True,
                    window: int | None = None, scale: float | None = None):
    """Attention of q (B,S,H,DQK) over k (B,S,K,DQK) and v (B,S,K,DV),
    causal and/or within a sliding window, softmax in float32 ->
    (B,S,H,DV) in q's type."""
    return _fa.flash_attention(q, k, v, causal=causal, window=window,
                               scale=scale)


def ssd_scan(x, dt, A, Bm, Cm, *, chunk: int, initial_state=None,
             return_state: bool = False):
    """The Mamba2 SSD over x (B,S,H,P), dt (B,S,H), A (H,), Bm/Cm
    (B,S,G,N) -> y (B,S,H,P), plus the final float32 state
    (B,H,P,N) if `return_state`."""
    return _ssd.ssd_scan(x, dt, A, Bm, Cm, chunk=chunk,
                         initial_state=initial_state,
                         return_state=return_state)


def launch_counts() -> dict:
    """Kernel launches since the last reset, by kernel name."""
    return {k: v for counts in _COUNTERS for k, v in counts.items()}


def reset_launches() -> None:
    for counts in _COUNTERS:
        for name in counts:
            counts[name] = 0
