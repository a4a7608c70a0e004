"""Public entry points for the port's kernels.

Each wrapper dispatches by the device of the tensor it is given — a CUDA
tensor launches the hand-written kernel, a CPU or meta tensor takes the
plain version — so there is no mode switch and no fallback.  This module
adds the 0-d leaf path of `repro/kernels/ops.py:127-149` and the launch
counters' reset.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import splitcat_linear as _sc
from repro_torch.kernels import wire_quant as _wq


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


def launch_counts() -> dict:
    """Kernel launches since the last reset, by kernel name."""
    return {**_wq.launches, **_sc.launches}


def reset_launches() -> None:
    for counts in (_wq.launches, _sc.launches):
        for name in counts:
            counts[name] = 0
