"""The packed int8 wire's pack and unpack: CUDA kernels and their plain
versions.

`wire_quant(x)` -> (q int8 (..., K), scale fp32 (..., 1)) quantizes every
last-axis row by its absmax; `wire_dequant(q, scale, dtype)` is the
receiving side.  They replace `repro/kernels/wire_quant.py`'s
`wire_quant_pallas` and `wire_dequant_pallas` (sources in
`csrc/wire_quant.cu`).  `wire_roundtrip(x)` is `dequant(quant(x))` with
the wire's backward, the reference's custom VJP (`:125-148`) as an
autograd Function over the two.

Dispatch is by the tensor's device: a CUDA tensor launches the kernel
(or raises if it cannot be built or launched, as for a row wider than
sixteen blocks' shared memory holds: over 3.2 MB of x); a CPU or meta
tensor takes the plain version, `kernels.ref.wire_quant_ref` /
`wire_dequant_ref`, which the kernels match bitwise.  `launches` counts
kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref

launches = {"wire_quant": 0, "wire_dequant": 0}

_SIGNATURES = {
    "wire_quant_launch": [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                          ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
                          ctypes.c_float, ctypes.c_float, ctypes.c_void_p],
    "wire_dequant_launch": [ctypes.c_void_p, ctypes.c_void_p,
                            ctypes.c_void_p, ctypes.c_longlong,
                            ctypes.c_longlong, ctypes.c_int,
                            ctypes.c_void_p],
}
_TYPES = (torch.float32, torch.bfloat16)


def _plain_device(t: torch.Tensor) -> bool:
    if t.device.type in ("cpu", "meta"):
        return True
    if t.device.type == "cuda":
        return False
    raise ValueError(f"no wire kernel for device {t.device}")


def _stream(t: torch.Tensor):
    return torch.cuda.current_stream(t.device).cuda_stream


def wire_quant(x: torch.Tensor):
    """x (..., K) float32/bfloat16 -> (q int8 (..., K), scale fp32 (..., 1))."""
    if x.ndim == 0:
        raise ValueError("wire_quant takes (..., K); 0-d leaves go through "
                         "ops.wire_quantize")
    if _plain_device(x):
        return ref.wire_quant_ref(x)
    if x.dtype not in _TYPES:
        raise TypeError(f"wire_quant: x must be float32 or bfloat16, "
                        f"got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("wire_quant: x must be contiguous")
    k = x.shape[-1]
    rows = x.numel() // k if k else 0
    q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    scale = torch.empty((*x.shape[:-1], 1), dtype=torch.float32,
                        device=x.device)
    if rows == 0 or k == 0:
        return q, scale
    lib = build.load("wire_quant", _SIGNATURES)
    with torch.cuda.device(x.device):
        err = lib.wire_quant_launch(
            x.data_ptr(), q.data_ptr(), scale.data_ptr(), rows, k,
            int(x.dtype == torch.bfloat16), ref.INV127, ref.EPS, _stream(x))
    build.check(err, "wire_quant")
    launches["wire_quant"] += 1
    return q, scale


def wire_dequant(q: torch.Tensor, scale: torch.Tensor,
                 dtype=torch.float32) -> torch.Tensor:
    """(q int8 (..., K), scale fp32 (..., 1)) -> (..., K) in `dtype`."""
    if _plain_device(q):
        return ref.wire_dequant_ref(q, scale, dtype)
    if q.dtype != torch.int8 or scale.dtype != torch.float32:
        raise TypeError(f"wire_dequant: needs int8 q and float32 scale, got "
                        f"{q.dtype} and {scale.dtype}")
    if dtype not in _TYPES:
        raise TypeError(f"wire_dequant: output must be float32 or bfloat16, "
                        f"got {dtype}")
    if scale.device != q.device:
        raise ValueError("wire_dequant: q and scale on different devices")
    if tuple(scale.shape) != (*q.shape[:-1], 1):
        raise ValueError(f"wire_dequant: scale {tuple(scale.shape)} does "
                         f"not match q {tuple(q.shape)}")
    if not (q.is_contiguous() and scale.is_contiguous()):
        raise ValueError("wire_dequant: q and scale must be contiguous")
    k = q.shape[-1]
    rows = q.numel() // k if k else 0
    out = torch.empty(q.shape, dtype=dtype, device=q.device)
    if rows == 0 or k == 0:
        return out
    lib = build.load("wire_quant", _SIGNATURES)
    with torch.cuda.device(q.device):
        err = lib.wire_dequant_launch(
            q.data_ptr(), scale.data_ptr(), out.data_ptr(), rows, k,
            int(dtype == torch.bfloat16), _stream(q))
    build.check(err, "wire_dequant")
    launches["wire_dequant"] += 1
    return out


def _roundtrip(x: torch.Tensor) -> torch.Tensor:
    """dequant(quant(x)) in x's type; a 0-d leaf is a one-element row."""
    q, s = wire_quant(x.reshape(1) if x.ndim == 0 else x.contiguous())
    return wire_dequant(q, s, x.dtype).reshape(x.shape)


class _WireRoundtrip(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _roundtrip(x)

    @staticmethod
    def backward(ctx, g):
        return _roundtrip(g)


def wire_roundtrip(x: torch.Tensor) -> torch.Tensor:
    """dequant(quant(x)) whose backward squeezes the cotangent through the
    same int8 wire: the client backprops the quantized cut gradient, as
    the physical protocol would."""
    return _WireRoundtrip.apply(x)
