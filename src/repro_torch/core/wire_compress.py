"""Cut-layer wire compression: the fake and the physical int8 wire.

Port of `repro/core/wire_compress.py`.  Both paths share one scheme,
per-last-axis-row symmetric absmax int8:

  * fake     — `_fake_quant_int8` (and `quantized_wire`, the same with
    the cotangent quantized too): a quantize-dequantize in plain torch;
    the value stays float and the metered bytes are a claim;
  * physical — `pack_int8` emits the `PackedInt8` payload (int8 q + fp32
    row scales) through the wire kernels; bytes come from the payload's
    real dtypes, and `unpack_int8(pack_int8(x))` is bitwise
    `_fake_quant_int8(x)`.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels import ops
from repro_torch.kernels.ref import EPS, INV127


def _fake_quant_int8(x: torch.Tensor) -> torch.Tensor:
    """Per-last-axis-row int8 quantize-dequantize (0-d leaves are
    one-element rows), in the reference's order of operations."""
    if x.ndim == 0:
        return _fake_quant_int8(x[None])[0]
    xf = x.float()
    scale = torch.amax(xf.abs(), dim=-1, keepdim=True) * INV127
    scale = torch.clamp_min(scale, EPS)
    q = torch.clamp(torch.round(xf / scale), -127, 127)
    return (q * scale).to(x.dtype)


class _QuantizedWire(torch.autograd.Function):
    """The fake wire's custom VJP (`repro/core/wire_compress.py:47-60`):
    fake-quant forward, fake-quant of the cotangent backward, so a
    gradient crossing back carries int8 information content too."""

    @staticmethod
    def forward(ctx, x):
        return _fake_quant_int8(x)

    @staticmethod
    def backward(ctx, g):
        return _fake_quant_int8(g)


def quantized_wire(x: torch.Tensor) -> torch.Tensor:
    return _QuantizedWire.apply(x)


def wire_bytes(shape, *, quantized: bool, base_dtype=torch.bfloat16) -> int:
    """Bytes on the physical wire for one payload of `shape`."""
    n = 1
    for s in shape:
        n *= s
    if quantized:
        rows = n // shape[-1] if shape else 1
        return n * 1 + rows * 4          # int8 payload + fp32 row scales
    return n * base_dtype.itemsize


@dataclasses.dataclass
class PackedInt8:
    """The packed int8 wire payload: `q` (..., K) int8 + `scale` (..., 1)
    fp32 row scales.  `shape`/`dtype` are the LOGICAL (pre-pack) view, so
    wire records compare across the fake and physical paths."""
    q: torch.Tensor
    scale: torch.Tensor
    orig_dtype: torch.dtype = torch.float32

    @property
    def shape(self):
        return tuple(self.q.shape)

    @property
    def dtype(self):
        return self.orig_dtype


def pack_int8(x: torch.Tensor) -> PackedInt8:
    """Quantize + pack one dense payload through the wire kernel."""
    q, scale = ops.wire_quantize(x.contiguous())
    return PackedInt8(q, scale, x.dtype)


def unpack_int8(p: PackedInt8) -> torch.Tensor:
    return ops.wire_dequantize(p.q, p.scale, p.orig_dtype)


def as_dense(t):
    """The dense view of a wire value: packed payloads are dequantized,
    dense tensors pass through."""
    return unpack_int8(t) if isinstance(t, PackedInt8) else t


def pack_like(template, x):
    """Re-pack `x` iff `template` was packed."""
    return pack_int8(x) if isinstance(template, PackedInt8) else x


def payload_nbytes(t) -> int:
    """Physical bytes of one wire value from its ACTUAL tensors: int8 q +
    fp32 scales for a packed payload, numel * itemsize otherwise."""
    leaves = (t.q, t.scale) if isinstance(t, PackedInt8) else (t,)
    return sum(leaf.numel() * leaf.element_size() for leaf in leaves)


def stack_packed(parts: list, dim: int = 0):
    """Concatenate wire payloads along a batch dim.  Per-last-axis-row
    quantization never mixes rows, so the stacked payload is bitwise the
    per-part payloads; dense payloads concat as plain tensors."""
    if all(isinstance(p, PackedInt8) for p in parts):
        return PackedInt8(torch.cat([p.q for p in parts], dim=dim),
                          torch.cat([p.scale for p in parts], dim=dim),
                          parts[0].orig_dtype)
    return torch.cat([as_dense(p) for p in parts], dim=dim)


def splitcat_linear_packed(parts: list, w: torch.Tensor, b=None,
                           out_dtype=None) -> torch.Tensor:
    """Server entry layer over a list of wire payloads: packed parts go
    through the fused q8 kernel (the float activation never exists);
    dense parts, and mixed lists after densifying, through the dense
    splitcat kernel."""
    if parts and all(isinstance(p, PackedInt8) for p in parts):
        dt = out_dtype or parts[0].orig_dtype
        return ops.splitcat_linear_q8([p.q for p in parts],
                                      [p.scale for p in parts], w, b,
                                      out_dtype=dt)
    return ops.splitcat_linear([as_dense(p) for p in parts], w, b)
