"""VGG-16, the paper's own experimental model (port of
`repro/nn/convnets.py:18-82`).

Built as a *layer list*, so a split-learning cut can land between any two
entries: `vgg_apply(params, cfg, x, to_layer=19)` runs the 13 convs, the
5 max-pools and FC1, which is the feature branch of the vertical split.
Activations are NHWC until the head.  The ResNet half of the reference
module is not ported yet (ROADMAP).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.nn import layers as L
from repro_torch.nn.module import key_iter

# VGG-16 plan: (conv out_ch | 'M' maxpool) then classifier
VGG16_PLAN = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
              512, 512, 512, "M", 512, 512, 512, "M"]


@dataclasses.dataclass(frozen=True)
class CNNConfig:
    name: str
    in_ch: int = 3
    n_classes: int = 10
    width_mult: float = 1.0       # reduced variants for CPU experiments
    plan: tuple = tuple(VGG16_PLAN)
    dtype: Any = torch.float32


def _w(ch, mult):
    return max(8, int(ch * mult))


def vgg_init(gen: torch.Generator, cfg: CNNConfig):
    """A list of per-layer param dicts (parallel to `vgg_plan`), drawn on
    the generator's device."""
    layers = []
    in_ch = cfg.in_ch
    kit = key_iter(gen)
    for item in cfg.plan:
        if item == "M":
            layers.append({})
        else:
            out_ch = _w(item, cfg.width_mult)
            layers.append({"conv": L.conv2d_init(next(kit), in_ch, out_ch, 3,
                                                 dtype=cfg.dtype)})
            in_ch = out_ch
    layers.append({"fc1": L.dense_init(next(kit), in_ch,
                                       _w(512, cfg.width_mult), bias=True,
                                       dtype=cfg.dtype)})
    layers.append({"fc2": L.dense_init(next(kit), _w(512, cfg.width_mult),
                                       cfg.n_classes, bias=True,
                                       dtype=cfg.dtype)})
    return layers


def vgg_layer_apply(layer_params, plan_item, x):
    """Apply one logical layer.  x: (B,H,W,C) until the head, then (B,D)."""
    if plan_item == "M":
        return L.maxpool2d(x)
    if plan_item == "FC1":
        x = x.mean(dim=(1, 2)) if x.ndim == 4 else x
        return torch.relu(L.dense_apply(layer_params["fc1"], x))
    if plan_item == "FC2":
        return L.dense_apply(layer_params["fc2"], x)
    return torch.relu(L.conv2d_apply(layer_params["conv"], x))


def vgg_plan(cfg: CNNConfig):
    return list(cfg.plan) + ["FC1", "FC2"]


def vgg_apply(params, cfg: CNNConfig, x, *, from_layer: int = 0,
              to_layer: int | None = None):
    """Run layers [from_layer, to_layer) — the split-learning hook."""
    plan = vgg_plan(cfg)
    to_layer = len(plan) if to_layer is None else to_layer
    for i in range(from_layer, to_layer):
        x = vgg_layer_apply(params[i], plan[i], x)
    return x
