"""RMSNorm over the last axis: the CUDA kernels and their plain versions.

`rmsnorm(x, scale, eps)` computes `x * rsqrt(mean(x^2) + eps) * scale`
per row in float32 and casts back to x's type.  It replaces
`repro/kernels/rmsnorm.py`'s `rmsnorm_pallas` (source in
`csrc/rmsnorm.cu`); every rmsnorm of the served and trained models
(block norms, the final norm, Mamba2's gated norm) goes through it.

A CUDA tensor launches the kernel (or raises); a CPU or meta tensor takes
the plain version, `kernels.ref.rmsnorm_ref`.  `launches` counts kernel
launches: "rmsnorm" the forward's, "rmsnorm_bwd" the backward's.

Training: on a CUDA tensor with grad enabled and an input that requires
grad, the call goes through `_RMSNormFn`, whose forward launches the
same kernel and whose backward launches the hand-written backward
kernels (`_launch_bwd`, in the same source and library):
`rmsnorm_bwd_rows` for dx and each CTA's partial dscale row, then, when
`scale` needs a gradient, `rmsnorm_bwd_cols` to sum those partials.
One backward call so launches 2 kernels when `scale` requires grad and
1 when only x does.  It
recomputes r = rsqrt(mean(x^2) + eps) from x, which it reads anyway,
rather than saving it from the forward: that costs no byte, and the
backward kernels come within reach of their bytes bound without it
(PERF.md).  Its plain version is
`kernels.ref.rmsnorm_bwd_ref`.  The reference has no backward kernel
(its LM is differentiated through plain `jnp`).
"""
from __future__ import annotations

import contextlib
import ctypes

import torch

from repro_torch.kernels import build, ref

launches = {"rmsnorm": 0, "rmsnorm_bwd": 0}

_SIGNATURES = {
    "rmsnorm_launch": [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_float, ctypes.c_void_p],
    "rmsnorm_bwd_grid": [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                         ctypes.c_int, ctypes.c_int],
    "rmsnorm_bwd_launch": [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
        ctypes.c_void_p],
}
_TYPES = (torch.float32, torch.bfloat16)
_GRIDS: dict = {}     # (device, rows, d, types, need_dscale) -> CTAs


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6):
    """x (..., D) float32/bfloat16, scale (D,) -> (..., D) in x's type."""
    if x.device.type in ("cpu", "meta"):
        return ref.rmsnorm_ref(x, scale, eps=eps)
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad):
        return _RMSNormFn.apply(x, scale, eps)
    return _launch(x, scale, eps)


class _RMSNormFn(torch.autograd.Function):
    """The kernel forward; the backward kernels (`_launch_bwd`) for the
    inputs that need a gradient."""

    @staticmethod
    def forward(ctx, x, scale, eps):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return _launch(x, scale, eps)

    @staticmethod
    def backward(ctx, g):
        x, scale = ctx.saved_tensors
        need_x, need_s = ctx.needs_input_grad[:2]
        dx, ds = _launch_bwd(x, scale, g, ctx.eps, need_x, need_s)
        return dx, ds, None


def _check(x: torch.Tensor, scale: torch.Tensor, what: str) -> int:
    """Raise on what the kernels do not take; return D."""
    if x.device.type != "cuda":
        raise ValueError(f"no {what} kernel for device {x.device}")
    if x.dtype not in _TYPES or scale.dtype not in _TYPES:
        raise TypeError(f"{what}: x and scale must be float32 or bfloat16, "
                        f"got {x.dtype} and {scale.dtype}")
    d = x.shape[-1]
    if scale.shape != (d,) or scale.device != x.device:
        raise ValueError(f"{what}: scale {tuple(scale.shape)} on "
                         f"{scale.device} does not match x {tuple(x.shape)} "
                         f"on {x.device}")
    if not (x.is_contiguous() and scale.is_contiguous()):
        raise ValueError(f"{what}: x and scale must be contiguous")
    return d


def _on(x: torch.Tensor):
    """x's device made current for a launch (a no-op when it is)."""
    if x.device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(x.device)


def _stream(x: torch.Tensor) -> int:
    """The current CUDA stream of x's device, as the int ctypes passes
    (torch's raw accessor: a fraction of `current_stream`'s host time,
    which a decode step pays once a norm)."""
    return torch._C._cuda_getCurrentRawStream(x.device.index)


def _launch(x: torch.Tensor, scale: torch.Tensor, eps: float):
    d = _check(x, scale, "rmsnorm")
    y = torch.empty_like(x)
    rows = x.numel() // d if d else 0
    if rows == 0:
        return y
    lib = build.load("rmsnorm", _SIGNATURES)
    with _on(x):
        err = lib.rmsnorm_launch(
            x.data_ptr(), scale.data_ptr(), y.data_ptr(), rows, d,
            x.dtype == torch.bfloat16, scale.dtype == torch.bfloat16,
            eps, _stream(x))
    build.check(err, "rmsnorm")
    launches["rmsnorm"] += 1
    return y


def _launch_bwd(x: torch.Tensor, scale: torch.Tensor, g: torch.Tensor,
                eps: float, need_dx: bool = True, need_dscale: bool = True):
    """(dx or None, dscale or None) of rmsnorm at (x, scale) for the
    output gradient g, on the card, in one call into the library that
    launches `rmsnorm_bwd_rows` once (dx where `need_dx`, and each CTA's
    partial dscale row into an fp32 workspace where `need_dscale`), then
    `rmsnorm_bwd_cols` once where `need_dscale`: 2 launches, or 1.  No
    atomics: the same shapes give the same bits."""
    d = _check(x, scale, "rmsnorm_bwd")
    if g.dtype != x.dtype:
        g = g.to(x.dtype)
    if not g.is_contiguous():
        g = g.contiguous()
    if g.shape != x.shape or g.device != x.device:
        raise ValueError(f"rmsnorm_bwd: g {tuple(g.shape)} on {g.device} "
                         f"does not match x {tuple(x.shape)} on {x.device}")
    rows = x.numel() // d if d else 0
    dx = torch.empty_like(x) if need_dx else None
    if rows == 0:
        return dx, torch.zeros_like(scale) if need_dscale else None
    xb, sb = x.dtype == torch.bfloat16, scale.dtype == torch.bfloat16
    lib = build.load("rmsnorm", _SIGNATURES)
    grid = bwd_grid(x, scale, need_dscale)
    ws = ds = None
    if need_dscale:
        ws = torch.empty((grid, d), dtype=torch.float32, device=x.device)
        ds = torch.empty_like(scale)
    with _on(x):
        err = lib.rmsnorm_bwd_launch(
            x.data_ptr(), scale.data_ptr(), g.data_ptr(),
            None if dx is None else dx.data_ptr(),
            None if ws is None else ws.data_ptr(),
            None if ds is None else ds.data_ptr(), grid, rows, d, xb, sb,
            eps, _stream(x))
    build.check(err, "rmsnorm_bwd")
    launches["rmsnorm_bwd"] += 2 if need_dscale else 1
    return dx, ds


def bwd_grid(x: torch.Tensor, scale: torch.Tensor, need_dscale: bool) -> int:
    """The CTAs `rmsnorm_bwd_rows` runs on for x's rows: as many as the
    card holds at once, or fewer; with `need_dscale`, the rows of the
    fp32 dscale workspace.  Asked of the library once per shape."""
    d = x.shape[-1]
    rows = x.numel() // d if d else 0
    key = (x.device.index, rows, d, x.dtype, scale.dtype, need_dscale)
    grid = _GRIDS.get(key)
    if grid is None:
        lib = build.load("rmsnorm", _SIGNATURES)
        with _on(x):
            grid = lib.rmsnorm_bwd_grid(rows, d, x.dtype == torch.bfloat16,
                                        scale.dtype == torch.bfloat16,
                                        need_dscale)
        if grid < 1:
            raise RuntimeError(f"rmsnorm_bwd: no grid for rows of {d} "
                               f"(cudaError {-grid})")
        _GRIDS[key] = grid
    return grid
