"""Primitive layers (port of `repro/nn/layers.py:14-66, 141-153`).

Parameters are plain dicts of tensors in the reference's layouts: a
dense weight is `(in, out)` and applied as `x @ w`.  Init draws from an
explicit `torch.Generator` on the target device; its numbers differ from
`jax.random`'s, so parity tests bridge the reference's parameters over
(`repro_torch.bridge`).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def _normal(gen, shape, std, dtype, device):
    w = torch.randn(shape, generator=gen, device=device,
                    dtype=torch.float32)
    return (w * std).to(dtype)


# ---------------------------------------------------------------------------
# Dense
# ---------------------------------------------------------------------------

def dense_init(gen, in_dim: int, out_dim: int, *, bias: bool = False,
               dtype=torch.float32, device=None):
    """LeCun-normal `(in, out)` weight, zero bias."""
    p = {"w": _normal(gen, (in_dim, out_dim), 1.0 / math.sqrt(max(1, in_dim)),
                      dtype, device)}
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
    return {"table": _normal(gen, (vocab, dim), 0.02, dtype, device)}


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
    """Computed in float32 and cast back to x's dtype."""
    dt = x.dtype
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * params["scale"].float()).to(dt)


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
