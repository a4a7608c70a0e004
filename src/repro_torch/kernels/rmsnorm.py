"""RMSNorm over the last axis: the CUDA kernel and its plain version.

`rmsnorm(x, scale, eps)` computes `x * rsqrt(mean(x^2) + eps) * scale`
per row in float32 and casts back to x's type.  It replaces
`repro/kernels/rmsnorm.py`'s `rmsnorm_pallas` (source in
`csrc/rmsnorm.cu`); every rmsnorm of the served models (block norms,
the final norm, Mamba2's gated norm) goes through it.

A CUDA tensor launches the kernel (or raises); a CPU or meta tensor takes
the plain version, `kernels.ref.rmsnorm_ref`.  `launches` counts kernel
launches.

Training: on a CUDA tensor with grad enabled and an input that requires
grad, the call goes through `_RMSNormFn`, whose forward launches the
same kernel and whose backward is the designated gradient: it recomputes
the plain version on the saved inputs and differentiates it.  The
reference has no backward kernel either (its LM is differentiated
through plain `jnp`), so the forward always runs on the kernel and the
backward launches nothing.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref

launches = {"rmsnorm": 0}

_SIGNATURES = {
    "rmsnorm_launch": [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_float, ctypes.c_void_p],
}
_TYPES = (torch.float32, torch.bfloat16)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6):
    """x (..., D) float32/bfloat16, scale (D,) -> (..., D) in x's type."""
    if x.device.type in ("cpu", "meta"):
        return ref.rmsnorm_ref(x, scale, eps=eps)
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad):
        return _RMSNormFn.apply(x, scale, eps)
    return _launch(x, scale, eps)


class _RMSNormFn(torch.autograd.Function):
    """The kernel forward; the backward differentiates the plain version
    recomputed on the saved inputs."""

    @staticmethod
    def forward(ctx, x, scale, eps):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return _launch(x, scale, eps)

    @staticmethod
    def backward(ctx, g):
        gx, gs = ref.plain_grads(
            lambda x, s: ref.rmsnorm_ref(x, s, eps=ctx.eps),
            ctx.saved_tensors, ctx.needs_input_grad, g)
        return gx, gs, None


def _launch(x: torch.Tensor, scale: torch.Tensor, eps: float):
    if x.device.type != "cuda":
        raise ValueError(f"no rmsnorm kernel for device {x.device}")
    if x.dtype not in _TYPES or scale.dtype not in _TYPES:
        raise TypeError(f"rmsnorm: x and scale must be float32 or bfloat16, "
                        f"got {x.dtype} and {scale.dtype}")
    d = x.shape[-1]
    if tuple(scale.shape) != (d,) or scale.device != x.device:
        raise ValueError(f"rmsnorm: scale {tuple(scale.shape)} on "
                         f"{scale.device} does not match x {tuple(x.shape)} "
                         f"on {x.device}")
    if not (x.is_contiguous() and scale.is_contiguous()):
        raise ValueError("rmsnorm: x and scale must be contiguous")
    y = torch.empty_like(x)
    rows = x.numel() // d if d else 0
    if rows == 0:
        return y
    lib = build.load("rmsnorm", _SIGNATURES)
    with torch.cuda.device(x.device):
        err = lib.rmsnorm_launch(
            x.data_ptr(), scale.data_ptr(), y.data_ptr(), rows, d,
            int(x.dtype == torch.bfloat16), int(scale.dtype == torch.bfloat16),
            float(eps), torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "rmsnorm")
    launches["rmsnorm"] += 1
    return y
