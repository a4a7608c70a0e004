"""Transformer blocks (port of `repro/nn/transformer.py:27-184`).

A `BlockSpec` describes one residual block: a temporal mixer and a
channel mixer.  The port builds the attention and MLA blocks (with
SwiGLU, the tanh-gelu MLP, the MoE MLP or no MLP), the Mamba2 block (no
channel mixer) and the RG-LRU block (with the gelu MLP), all with
rmsnorm.  Where the reference scans stacked layer params, the port keeps
one param dict per layer and loops in Python (`models.lm`).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.nn import attention as A
from repro_torch.nn import layers as L
from repro_torch.nn import moe as M
from repro_torch.nn import rglru as R
from repro_torch.nn import ssm as S


@dataclasses.dataclass(frozen=True)
class BlockSpec:
    d_model: int
    mixer: str                            # attn | mla | mamba2 | rglru
    mlp: str                              # swiglu | gelu | moe | none
    d_ff: int = 0
    attn: A.AttnConfig | None = None
    moe: M.MoEConfig | None = None
    ssm: S.SSMConfig | None = None
    rglru: R.RGLRUConfig | None = None
    norm: str = "rmsnorm"
    mlp_bias: bool = False
    dtype: Any = torch.float32


def _check(spec: BlockSpec):
    attn_mlps = ("swiglu", "gelu", "moe", "none")
    ok = {"attn": attn_mlps, "mla": attn_mlps, "mamba2": ("none",),
          "rglru": ("gelu",)}
    if spec.mlp not in ok.get(spec.mixer, ()) or spec.norm != "rmsnorm":
        raise NotImplementedError(
            f"block {spec.mixer}/{spec.mlp}/{spec.norm}: the port builds "
            "attn and mla (+ swiglu, gelu or moe), mamba2 and rglru + gelu "
            "blocks with rmsnorm; other blocks come with later slices")


def _norm_apply(params, spec: BlockSpec, x):
    return L.rmsnorm_apply(params, x)


def _mlp_apply(params, spec: BlockSpec, x):
    if spec.mlp == "gelu":
        return L.gelu_mlp_apply(params, x)
    if spec.mlp == "moe":
        return M.moe_apply(params, spec.moe, x)
    return L.swiglu_apply(params, x)


def block_init(gen, spec: BlockSpec, device=None):
    _check(spec)
    kw = dict(dtype=spec.dtype, device=device)
    if spec.mixer == "mamba2":
        mixer = S.mamba2_init(gen, spec.ssm, device)
    elif spec.mixer == "rglru":
        mixer = R.rglru_init(gen, spec.rglru, device)
    elif spec.mixer == "mla":
        mixer = A.mla_init(gen, spec.attn, device)
    else:
        mixer = A.gqa_init(gen, spec.attn, device)
    p = {"norm1": L.rmsnorm_init(spec.d_model, **kw), "mixer": mixer}
    if spec.mlp != "none":
        p["norm2"] = L.rmsnorm_init(spec.d_model, **kw)
    if spec.mlp == "gelu":
        p["mlp"] = L.gelu_mlp_init(gen, spec.d_model, spec.d_ff,
                                   bias=spec.mlp_bias, **kw)
    elif spec.mlp == "moe":
        p["mlp"] = M.moe_init(gen, spec.moe, device)
    elif spec.mlp == "swiglu":
        p["mlp"] = L.swiglu_init(gen, spec.d_model, spec.d_ff, **kw)
    return p


def block_init_cache(spec: BlockSpec, batch: int, max_len: int,
                     device=None):
    """The attention KV ring and MLA's compressed ring hold `max_len`
    rows (a sliding window's at most `window`); the Mamba2 cache (conv
    window and SSM state) and the RG-LRU cache (conv window and h) do not
    grow with the sequence."""
    _check(spec)
    if spec.mixer == "mamba2":
        return S.mamba2_init_cache(spec.ssm, batch, device)
    if spec.mixer == "rglru":
        return R.rglru_init_cache(spec.rglru, batch, device)
    if spec.mixer == "mla":
        return A.mla_init_cache(spec.attn, batch, max_len, device)
    return A.gqa_init_cache(spec.attn, batch, max_len, device)


def _residual(params, spec: BlockSpec, x, y):
    h = x + y
    if spec.mlp != "none":
        h = h + _mlp_apply(params["mlp"], spec,
                           _norm_apply(params["norm2"], spec, h))
    return h


def _mixer_apply(params, spec: BlockSpec, x, *, positions=None, mask=None):
    if spec.mixer == "mamba2":
        return S.mamba2_apply(params, spec.ssm, x)
    if spec.mixer == "rglru":
        return R.rglru_block_apply(params, spec.rglru, x)
    if spec.mixer == "mla":
        return A.mla_apply(params, spec.attn, x, positions=positions,
                           mask=mask)
    return A.gqa_apply(params, spec.attn, x, positions=positions, mask=mask)


def block_apply(params, spec: BlockSpec, x, *, positions=None, mask=None):
    """Full-sequence block forward from no cache (train)."""
    y = _mixer_apply(params["mixer"], spec,
                     _norm_apply(params["norm1"], spec, x),
                     positions=positions, mask=mask)
    return _residual(params, spec, x, y)


def block_decode(params, spec: BlockSpec, x, cache):
    xn = _norm_apply(params["norm1"], spec, x)
    if spec.mixer == "mamba2":
        y, cache = S.mamba2_decode(params["mixer"], spec.ssm, xn, cache)
    elif spec.mixer == "rglru":
        y, cache = R.rglru_block_decode(params["mixer"], spec.rglru, xn,
                                        cache)
    elif spec.mixer == "mla":
        y, cache = A.mla_decode(params["mixer"], spec.attn, xn, cache)
    else:
        y, cache = A.gqa_decode(params["mixer"], spec.attn, xn, cache)
    return _residual(params, spec, x, y), cache


def block_prefill(params, spec: BlockSpec, x, cache):
    """Full-sequence block forward that also fills the decode cache."""
    xn = _norm_apply(params["norm1"], spec, x)
    if spec.mixer == "mamba2":
        y, cache = S.mamba2_prefill(params["mixer"], spec.ssm, xn, cache)
    elif spec.mixer == "rglru":
        y, cache = R.rglru_prefill(params["mixer"], spec.rglru, xn, cache)
    elif spec.mixer == "mla":
        y, cache = A.mla_prefill(params["mixer"], spec.attn, xn, cache)
    else:
        y, cache = A.gqa_prefill(params["mixer"], spec.attn, xn, cache)
    return _residual(params, spec, x, y), cache
