"""Fused concat + matmul over the parts of a split activation: the CUDA
kernels and their plain versions.

* `splitcat_linear(parts, w, b)` computes `y = sum_i part_i @ W_i (+ b)`
  over dense float32/bf16 parts with float32 accumulation and `W`
  row-split at the part boundaries, in the parts' type.  It replaces
  `repro/kernels/splitcat_linear.py`'s `splitcat_linear_pallas` (source
  in `csrc/splitcat_linear.cu`); the vertical split's server entry reads
  the branches' features through it without forming their concat.
* `splitcat_linear_q8(qs, scales, w, b, out_dtype)` computes
  `y = sum_i (q_i @ W_i) * s_i (+ b)` over packed int8 payloads and
  replaces `splitcat_linear_q8_pallas` (source in
  `csrc/splitcat_linear_q8.cu`).  The server's fused entry QKV reads the
  int8 wire payload through it.

A CUDA tensor launches the kernel (or raises); a CPU or meta tensor
takes the plain version, which keeps the kernel's association (each
part's product in turn, the q8 scale on each part's product, the bias
last).  Both kernels are forward only, as the reference's are.
`launches` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

launches = {"splitcat_linear_q8": 0, "splitcat_linear": 0}

MAX_PARTS = 8       # kMaxParts in both CUDA sources
_DENSE_SIGNATURES = {
    "splitcat_launch": [ctypes.c_int, ctypes.POINTER(ctypes.c_void_p),
                        ctypes.POINTER(ctypes.c_int), ctypes.c_void_p,
                        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                        ctypes.c_int, ctypes.c_int, ctypes.c_int,
                        ctypes.c_void_p],
}
_SIGNATURES = {
    "splitcat_q8_launch": [ctypes.c_int, ctypes.POINTER(ctypes.c_void_p),
                           ctypes.POINTER(ctypes.c_void_p),
                           ctypes.POINTER(ctypes.c_int), ctypes.c_void_p,
                           ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                           ctypes.c_int, ctypes.c_int, ctypes.c_int,
                           ctypes.c_void_p],
}
_TYPES = (torch.float32, torch.bfloat16)


def _row_split(w: torch.Tensor, ks: list) -> list:
    if sum(ks) != w.shape[0]:
        raise ValueError(f"sum K_i {sum(ks)} != w rows {w.shape[0]}")
    return list(torch.split(w, ks, dim=0))


def splitcat_linear_q8_plain(qs: list, scales: list, w: torch.Tensor,
                             b=None, out_dtype=torch.float32):
    """The kernel's arithmetic in plain torch: float32 products of the
    int8 parts with their W row blocks, each times its row scales."""
    ws = _row_split(w, [q.shape[-1] for q in qs])
    acc = None
    for q, s, wi in zip(qs, scales, ws):
        part = (q.float() @ wi.float()) * s
        acc = part if acc is None else acc + part
    if b is not None:
        acc = acc + b.float()
    return acc.to(out_dtype)


def _check(qs, scales, w, b, out_dtype):
    dev = w.device
    if not qs or len(qs) != len(scales):
        raise ValueError("splitcat_linear_q8: needs one scale per part")
    if len(qs) > MAX_PARTS:
        raise ValueError(f"splitcat_linear_q8: at most {MAX_PARTS} parts")
    if w.dtype not in _TYPES or out_dtype not in _TYPES:
        raise TypeError(f"splitcat_linear_q8: w and out must be float32 or "
                        f"bfloat16, got {w.dtype} and {out_dtype}")
    if w.ndim != 2 or not w.is_contiguous():
        raise ValueError("splitcat_linear_q8: w must be a contiguous "
                         "(sum K_i, C) matrix")
    if b is not None and (b.dtype != w.dtype or tuple(b.shape)
                          != (w.shape[1],) or b.device != dev):
        raise ValueError("splitcat_linear_q8: b must be (C,) of w's type "
                         "on w's device")
    lead = tuple(qs[0].shape[:-1])
    for q, s in zip(qs, scales):
        if q.dtype != torch.int8 or s.dtype != torch.float32:
            raise TypeError("splitcat_linear_q8: parts are int8 q with "
                            "float32 scales")
        if q.device != dev or s.device != dev:
            raise ValueError("splitcat_linear_q8: all inputs on one device")
        if tuple(q.shape[:-1]) != lead or tuple(s.shape) != (*lead, 1):
            raise ValueError("splitcat_linear_q8: parts disagree on their "
                             "rows")
        if not (q.is_contiguous() and s.is_contiguous()):
            raise ValueError("splitcat_linear_q8: parts must be contiguous")
    if sum(q.shape[-1] for q in qs) != w.shape[0]:
        raise ValueError(f"sum K_i {sum(q.shape[-1] for q in qs)} != "
                         f"w rows {w.shape[0]}")
    return lead


def splitcat_linear_q8(qs: list, scales: list, w: torch.Tensor, b=None,
                       out_dtype=torch.float32) -> torch.Tensor:
    """qs[i] (..., K_i) int8, scales[i] (..., 1) fp32, w (sum K_i, C),
    b (C,) or None -> (..., C) in `out_dtype`."""
    qs, scales = list(qs), list(scales)
    if w.device.type in ("cpu", "meta"):
        return splitcat_linear_q8_plain(qs, scales, w, b, out_dtype)
    if w.device.type != "cuda":
        raise ValueError(f"no splitcat_linear_q8 kernel for {w.device}")
    lead = _check(qs, scales, w, b, out_dtype)
    rows = 1
    for d in lead:
        rows *= d
    cols = w.shape[1]
    out = torch.empty((*lead, cols), dtype=out_dtype, device=w.device)
    if rows == 0 or cols == 0:
        return out
    n = len(qs)
    q_ptrs = (ctypes.c_void_p * n)(*[q.data_ptr() for q in qs])
    s_ptrs = (ctypes.c_void_p * n)(*[s.data_ptr() for s in scales])
    ks = (ctypes.c_int * n)(*[q.shape[-1] for q in qs])
    lib = build.load("splitcat_linear_q8", _SIGNATURES)
    with torch.cuda.device(w.device):
        err = lib.splitcat_q8_launch(
            n, q_ptrs, s_ptrs, ks, w.data_ptr(),
            None if b is None else b.data_ptr(), out.data_ptr(), rows, cols,
            int(w.dtype == torch.bfloat16), int(out_dtype == torch.bfloat16),
            torch.cuda.current_stream(w.device).cuda_stream)
    build.check(err, "splitcat_linear_q8")
    launches["splitcat_linear_q8"] += 1
    return out


# ---------------------------------------------------------------------------
# dense parts
# ---------------------------------------------------------------------------

def splitcat_linear_plain(parts: list, w: torch.Tensor, b=None):
    """The kernel's arithmetic in plain torch: float32 products of each
    part with its W row block, summed part by part, then the bias."""
    ws = _row_split(w, [p.shape[-1] for p in parts])
    acc = None
    for p, wi in zip(parts, ws):
        part = p.float() @ wi.float()
        acc = part if acc is None else acc + part
    if b is not None:
        acc = acc + b.float()
    return acc.to(parts[0].dtype)


def _check_dense(parts, w, b):
    dev = w.device
    if not parts:
        raise ValueError("splitcat_linear: needs at least one part")
    if len(parts) > MAX_PARTS:
        raise ValueError(f"splitcat_linear: at most {MAX_PARTS} parts")
    dtype = parts[0].dtype
    if dtype not in _TYPES or w.dtype not in _TYPES:
        raise TypeError(f"splitcat_linear: parts and w must be float32 or "
                        f"bfloat16, got {dtype} and {w.dtype}")
    if w.ndim != 2 or not w.is_contiguous():
        raise ValueError("splitcat_linear: w must be a contiguous "
                         "(sum K_i, C) matrix")
    if b is not None and (b.dtype != w.dtype or tuple(b.shape)
                          != (w.shape[1],) or b.device != dev):
        raise ValueError("splitcat_linear: b must be (C,) of w's type on "
                         "w's device")
    lead = tuple(parts[0].shape[:-1])
    for p in parts:
        if p.dtype != dtype:
            raise TypeError("splitcat_linear: all parts of one type")
        if p.device != dev:
            raise ValueError("splitcat_linear: all inputs on one device")
        if tuple(p.shape[:-1]) != lead:
            raise ValueError("splitcat_linear: parts disagree on their rows")
        if not p.is_contiguous():
            raise ValueError("splitcat_linear: parts must be contiguous")
    if sum(p.shape[-1] for p in parts) != w.shape[0]:
        raise ValueError(f"sum K_i {sum(p.shape[-1] for p in parts)} != "
                         f"w rows {w.shape[0]}")
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (*parts, w, b)):
        raise ValueError("splitcat_linear: the kernel is forward only; "
                         "call it under torch.no_grad()")
    return lead


def splitcat_linear(parts: list, w: torch.Tensor, b=None) -> torch.Tensor:
    """parts[i] (..., K_i), w (sum K_i, C), b (C,) or None -> (..., C) in
    the parts' type."""
    parts = list(parts)
    if w.device.type in ("cpu", "meta"):
        return splitcat_linear_plain(parts, w, b)
    if w.device.type != "cuda":
        raise ValueError(f"no splitcat_linear kernel for {w.device}")
    lead = _check_dense(parts, w, b)
    rows = 1
    for d in lead:
        rows *= d
    cols = w.shape[1]
    out = torch.empty((*lead, cols), dtype=parts[0].dtype, device=w.device)
    if rows == 0 or cols == 0:
        return out
    n = len(parts)
    ptrs = (ctypes.c_void_p * n)(*[p.data_ptr() for p in parts])
    ks = (ctypes.c_int * n)(*[p.shape[-1] for p in parts])
    lib = build.load("splitcat_linear", _DENSE_SIGNATURES)
    with torch.cuda.device(w.device):
        err = lib.splitcat_launch(
            n, ptrs, ks, w.data_ptr(), None if b is None else b.data_ptr(),
            out.data_ptr(), rows, cols,
            int(parts[0].dtype == torch.bfloat16),
            int(w.dtype == torch.bfloat16),
            torch.cuda.current_stream(w.device).cuda_stream)
    build.check(err, "splitcat_linear")
    launches["splitcat_linear"] += 1
    return out
