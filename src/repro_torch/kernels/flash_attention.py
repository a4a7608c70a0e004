"""Causal / sliding-window / non-causal attention: the CUDA kernel and its
plain version.

`flash_attention(q, k, v, causal=True, window=None, scale=None)` attends
q (B,S,H,DQK) over k (B,S,K,DQK) and v (B,S,K,DV), H % K == 0, query head
h reading KV head h // (H/K): key j is visible to query i when j <= i
(causal) and j > i - window; softmax in float32, the result (B,S,H,DV) in
q's type.  It replaces `repro/kernels/flash_attention.py`'s
`flash_attention_pallas` (source in `csrc/flash_attention.cu`) and runs
every attention prefill of the served models (`nn/attention.py:
gqa_prefill`, `mla_prefill`): phi4-mini's, Qwen3-MoE's and InternVL2's
causal GQA, RecurrentGemma's local attention, Whisper's decoder
self-attention and DeepSeek-V2's MLA, whose q and k are 192 wide (128 +
64 rope) and v 128.  With `causal=False` every key is visible (within
`window` when set): Whisper's encoder attends its 1,500 frames so, a
length that leaves 28 of the last 64-row KV tile's rows real, which only
the bound check `j < S` masks.  The kernel is instantiated for the
(DQK, DV) pairs in `HEAD_DIMS`.  Decode and cross-attention (q over
another length than k and v) attend plainly, as the reference does.

A CUDA tensor launches the kernel (or raises); a CPU or meta tensor takes
the plain version, `kernels.ref.flash_attention_ref`.  `launches` counts
kernel launches.

Training: on a CUDA tensor with grad enabled and an input that requires
grad, the call goes through `_FlashFn`, whose forward launches the same
kernel and whose backward is the designated gradient: it recomputes the
plain version on the saved q, k and v and differentiates it.  The
reference has no backward kernel either (its LM trains through the plain
grouped einsum), so the forward always runs on the kernel and the
backward launches nothing.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build, ref

launches = {"flash_attention": 0}

# the kernel's (DQK, DV) instantiations: equal pairs, DeepSeek-V2's MLA
# and the reduced MLA that the card check serves
HEAD_DIMS = ((32, 32), (64, 64), (128, 128), (256, 256), (192, 128),
             (64, 32))
_SIGNATURES = {
    "flash_attention_launch": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
    + [ctypes.c_longlong] * 12
    + [ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int,
       ctypes.c_void_p],
}
_TYPES = (torch.float32, torch.bfloat16)


def _strides(t: torch.Tensor, what: str) -> tuple:
    """(batch, sequence, head) strides of a (B, S, heads, D) tensor whose
    rows of D are dense and start on 16 bytes, as the kernel reads them."""
    size = t.element_size()
    if t.stride(-1) != 1 or t.data_ptr() % 16 or any(
            s * size % 16 for s in t.stride()[:3]):
        raise ValueError(f"flash_attention: {what} {tuple(t.shape)} with "
                         f"strides {t.stride()} needs unit stride over D "
                         "and 16-byte aligned rows")
    return t.stride()[:3]


def flash_attention(q, k, v, *, causal: bool = True,
                    window: int | None = None, scale: float | None = None):
    """q (B,S,H,DQK), k (B,S,K,DQK), v (B,S,K,DV) -> (B,S,H,DV) in q's
    type; `scale` defaults to 1/sqrt(DQK)."""
    if q.device.type in ("cpu", "meta"):
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                       scale=scale)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashFn.apply(q, k, v, causal, window, scale)
    return _launch(q, k, v, causal, window, scale)


class _FlashFn(torch.autograd.Function):
    """The kernel forward; the backward differentiates the plain version
    recomputed on the saved inputs."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale):
        ctx.save_for_backward(q, k, v)
        ctx.kw = dict(causal=causal, window=window, scale=scale)
        return _launch(q, k, v, causal, window, scale)

    @staticmethod
    def backward(ctx, g):
        grads = ref.plain_grads(
            lambda q, k, v: ref.flash_attention_ref(q, k, v, **ctx.kw),
            ctx.saved_tensors, ctx.needs_input_grad[:3], g)
        return (*grads, None, None, None)


def _launch(q, k, v, causal, window, scale):
    if q.device.type != "cuda":
        raise ValueError(f"no flash_attention kernel for device {q.device}")
    Bsz, S, H, D = q.shape
    K, DV = k.shape[2], v.shape[-1]
    if q.dtype not in _TYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: q, k and v must share one type, "
                        f"float32 or bfloat16; got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if (tuple(k.shape) != (Bsz, S, K, D) or tuple(v.shape) != (Bsz, S, K, DV)
            or K == 0 or H % K):
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} do not fit")
    if (D, DV) not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dims (q/k, v) {(D, DV)} "
                         f"not in {HEAD_DIMS}")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window {window} < 1")
    if k.device != q.device or v.device != q.device:
        raise ValueError("flash_attention: inputs on different devices")
    o = torch.empty((Bsz, S, H, DV), dtype=q.dtype, device=q.device)
    if o.numel() == 0:
        return o
    strides = [s for t, what in ((q, "q"), (k, "k"), (v, "v"), (o, "o"))
               for s in _strides(t, what)]
    scale = 1.0 / math.sqrt(D) if scale is None else scale
    lib = build.load("flash_attention", _SIGNATURES)
    with torch.cuda.device(q.device):
        err = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            Bsz, S, H, K, D, DV, *strides, int(causal),
            0 if window is None else int(window), float(scale),
            int(q.dtype == torch.bfloat16),
            torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "flash_attention")
    launches["flash_attention"] += 1
    return o
