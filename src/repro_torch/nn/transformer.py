"""Transformer blocks (port of `repro/nn/transformer.py:27-169`).

A `BlockSpec` describes one residual block: a temporal mixer and a
channel mixer.  The port builds the dense decoder block (attention +
SwiGLU) and the Mamba2 block (mamba2 mixer, no channel mixer), both with
rmsnorm; the other mixers (mla, rglru, moe) come with their serving
slices.  Where the reference scans stacked layer params, the port keeps
one param dict per layer and loops in Python (`models.lm`).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.nn import attention as A
from repro_torch.nn import layers as L
from repro_torch.nn import ssm as S


@dataclasses.dataclass(frozen=True)
class BlockSpec:
    d_model: int
    mixer: str                            # attn | mamba2
    mlp: str                              # swiglu | none
    d_ff: int = 0
    attn: A.AttnConfig | None = None
    ssm: S.SSMConfig | None = None
    norm: str = "rmsnorm"
    dtype: Any = torch.float32


def _check(spec: BlockSpec):
    ok = {"attn": ("swiglu", "none"), "mamba2": ("none",)}
    if spec.mlp not in ok.get(spec.mixer, ()) or spec.norm != "rmsnorm":
        raise NotImplementedError(
            f"block {spec.mixer}/{spec.mlp}/{spec.norm}: the port builds "
            "attn + swiglu and mamba2 blocks with rmsnorm; other blocks "
            "come with later slices")


def _norm_apply(params, spec: BlockSpec, x):
    return L.rmsnorm_apply(params, x)


def _mlp_apply(params, spec: BlockSpec, x):
    return L.swiglu_apply(params, x)


def block_init(gen, spec: BlockSpec, device=None):
    _check(spec)
    kw = dict(dtype=spec.dtype, device=device)
    mixer = (S.mamba2_init(gen, spec.ssm, device) if spec.mixer == "mamba2"
             else A.gqa_init(gen, spec.attn, device))
    p = {"norm1": L.rmsnorm_init(spec.d_model, **kw), "mixer": mixer}
    if spec.mlp != "none":
        p["norm2"] = L.rmsnorm_init(spec.d_model, **kw)
        p["mlp"] = L.swiglu_init(gen, spec.d_model, spec.d_ff, **kw)
    return p


def block_init_cache(spec: BlockSpec, batch: int, max_len: int,
                     device=None):
    """The attention KV ring holds `max_len` rows; the Mamba2 cache (conv
    window and SSM state) does not grow with the sequence."""
    _check(spec)
    if spec.mixer == "mamba2":
        return S.mamba2_init_cache(spec.ssm, batch, device)
    return A.gqa_init_cache(spec.attn, batch, max_len, device)


def block_decode(params, spec: BlockSpec, x, cache):
    xn = _norm_apply(params["norm1"], spec, x)
    if spec.mixer == "mamba2":
        y, cache = S.mamba2_decode(params["mixer"], spec.ssm, xn, cache)
    else:
        y, cache = A.gqa_decode(params["mixer"], spec.attn, xn, cache)
    h = x + y
    if spec.mlp != "none":
        h = h + _mlp_apply(params["mlp"], spec,
                           _norm_apply(params["norm2"], spec, h))
    return h, cache


def block_prefill(params, spec: BlockSpec, x, cache):
    """Full-sequence block forward that also fills the decode cache."""
    xn = _norm_apply(params["norm1"], spec, x)
    if spec.mixer == "mamba2":
        y, cache = S.mamba2_prefill(params["mixer"], spec.ssm, xn, cache)
    else:
        y, cache = A.gqa_prefill(params["mixer"], spec.attn, xn, cache)
    h = x + y
    if spec.mlp != "none":
        h = h + _mlp_apply(params["mlp"], spec,
                           _norm_apply(params["norm2"], spec, h))
    return h, cache
