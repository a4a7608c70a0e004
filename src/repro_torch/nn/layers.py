"""Primitive layers (port of `repro/nn/layers.py:14-66, 87-135, 141-167`).

Parameters are plain dicts of tensors in the reference's layouts: a
dense weight is `(in, out)` and applied as `x @ w`; a 2-D conv weight is
HWIO over NHWC activations, a 1-D one TIO over NTC.  Init draws from an
explicit `torch.Generator` (on `device`, default the generator's); its
numbers differ from `jax.random`'s, so parity tests bridge the
reference's parameters over (`repro_torch.bridge`).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.nn.module import lecun_init, normal_init


# ---------------------------------------------------------------------------
# Dense
# ---------------------------------------------------------------------------

def dense_init(gen, in_dim: int, out_dim: int, *, bias: bool = False,
               dtype=torch.float32, device=None):
    """LeCun-normal `(in, out)` weight, zero bias."""
    device = gen.device if device is None else device
    p = {"w": lecun_init(gen, (in_dim, out_dim), dtype, in_dim, device)}
    if bias:
        p["b"] = torch.zeros((out_dim,), dtype=dtype, device=device)
    return p


def dense_apply(params, x):
    y = x @ params["w"]
    if "b" in params:
        y = y + params["b"]
    return y


# ---------------------------------------------------------------------------
# Embedding
# ---------------------------------------------------------------------------

def embedding_init(gen, vocab: int, dim: int, *, dtype=torch.float32,
                   device=None):
    return {"table": normal_init(gen, (vocab, dim), dtype, 0.02, device)}


def embedding_apply(params, token_ids):
    return params["table"][token_ids]


def embedding_attend(params, x):
    """Tied-softmax logits: x @ table.T"""
    return x @ params["table"].T


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rmsnorm_init(dim: int, *, dtype=torch.float32, device=None):
    return {"scale": torch.ones((dim,), dtype=dtype, device=device)}


def rmsnorm_apply(params, x, *, eps: float = 1e-6):
    """Computed in float32 and cast back to x's dtype: the rmsnorm kernel
    on a CUDA tensor, its plain version (`kernels.ref.rmsnorm_ref`, the
    reference's arithmetic) on a CPU or meta one."""
    return ops.rmsnorm(x, params["scale"], eps)


# ---------------------------------------------------------------------------
# Conv2D and pooling (VGG), NHWC activations and HWIO weights
# ---------------------------------------------------------------------------

def conv2d_init(gen, in_ch: int, out_ch: int, ksize: int, *,
                bias: bool = True, dtype=torch.float32, device=None):
    device = gen.device if device is None else device
    w = lecun_init(gen, (ksize, ksize, in_ch, out_ch), dtype,
                   in_ch * ksize * ksize, device)
    p = {"w": w}
    if bias:
        p["b"] = torch.zeros((out_ch,), dtype=dtype, device=device)
    return p


def _same_pad(size: int, k: int, stride: int) -> tuple:
    """XLA's SAME padding of one spatial axis: (low, high), the odd pixel
    going high."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv2d_apply(params, x, *, stride: int = 1, padding: str = "SAME"):
    """x: (B, H, W, C).  The NHWC tensor viewed as NCHW is channels-last
    in memory, so cuDNN reads it in place; the tree keeps HWIO."""
    w = params["w"]
    kh, kw = w.shape[0], w.shape[1]
    xc = x.permute(0, 3, 1, 2)
    if padding == "SAME":
        (pt, pb), (pl, pr) = (_same_pad(x.shape[1], kh, stride),
                              _same_pad(x.shape[2], kw, stride))
        if pt == pb and pl == pr:
            pad = (pt, pl)
        else:
            xc, pad = F.pad(xc, (pl, pr, pt, pb)), 0
    elif padding == "VALID":
        pad = 0
    else:
        raise ValueError(f"padding must be SAME or VALID, got {padding!r}")
    y = F.conv2d(xc, w.permute(3, 2, 0, 1), params.get("b"), stride=stride,
                 padding=pad)
    return y.permute(0, 2, 3, 1)


# ---------------------------------------------------------------------------
# Conv1D (Mamba2's causal conv), NTC activations and TIO weights
# ---------------------------------------------------------------------------

def conv1d_init(gen, in_ch: int, out_ch: int, ksize: int, *,
                bias: bool = True, dtype=torch.float32, device=None):
    device = gen.device if device is None else device
    p = {"w": lecun_init(gen, (ksize, in_ch, out_ch), dtype, in_ch * ksize,
                         device)}
    if bias:
        p["b"] = torch.zeros((out_ch,), dtype=dtype, device=device)
    return p


def conv1d_apply(params, x):
    """x: (B, T, C_in) -> (B, T - k + 1, C_out), VALID (the caller pads
    causally first, as the reference's Mamba2 does).  One matmul of the k
    shifted windows, side by side, with the TIO weight viewed as
    (k C_in, C_out): the weight is read in place (a library convolution
    would re-lay it out at every call), and the result is NTC in memory,
    so its per-token channel slices (Mamba2's x, B, C) are dense rows,
    as the SSD kernel reads them.  At T = k (a decode step's window) the
    windows are the input itself."""
    w = params["w"]
    k, c_in, c_out = w.shape
    t = x.shape[1] - k + 1
    if t == 1:
        cols = x.reshape(x.shape[0], 1, k * c_in)
    else:
        cols = torch.cat([x[:, j:j + t] for j in range(k)], dim=-1)
    return F.linear(cols, w.reshape(k * c_in, c_out).t(), params.get("b"))


def maxpool2d(x, window: int = 2, stride: int = 2):
    """VALID max pool over NHWC (the reference's `-inf` init: no padding
    ever enters a window)."""
    y = F.max_pool2d(x.permute(0, 3, 1, 2), window, stride)
    return y.permute(0, 2, 3, 1)


def avgpool_global(x):
    return x.mean(dim=(1, 2))


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def swiglu_init(gen, dim: int, hidden: int, *, dtype=torch.float32,
                device=None):
    return {
        "gate": dense_init(gen, dim, hidden, dtype=dtype, device=device),
        "up": dense_init(gen, dim, hidden, dtype=dtype, device=device),
        "down": dense_init(gen, hidden, dim, dtype=dtype, device=device),
    }


def swiglu_apply(params, x):
    g = F.silu(dense_apply(params["gate"], x))
    u = dense_apply(params["up"], x)
    return dense_apply(params["down"], g * u)


def gelu_mlp_init(gen, dim: int, hidden: int, *, bias: bool = True,
                  dtype=torch.float32, device=None):
    return {
        "fc1": dense_init(gen, dim, hidden, bias=bias, dtype=dtype,
                          device=device),
        "fc2": dense_init(gen, hidden, dim, bias=bias, dtype=dtype,
                          device=device),
    }


def gelu_mlp_apply(params, x):
    """fc2(gelu(fc1(x))) with the tanh gelu: `jax.nn.gelu`'s default
    (`approximate=True`), which the reference's MLP uses."""
    return dense_apply(params["fc2"],
                       F.gelu(dense_apply(params["fc1"], x),
                              approximate="tanh"))
