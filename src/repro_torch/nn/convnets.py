"""VGG-16 and the ResNet-style CNN, the paper's own experimental models
(port of `repro/nn/convnets.py`): VGG on CIFAR-10 (Table 1, Fig. 3(a))
and ResNet on CIFAR-100 (Table 2, Fig. 3(b)).

Both are built as *layer lists*, so a split-learning cut can land between
any two entries: `vgg_apply(params, cfg, x, to_layer=19)` runs the 13
convs, the 5 max-pools and FC1, which is the feature branch of the
vertical split.  Activations are NHWC until the head.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.nn import layers as L
from repro_torch.nn.module import key_iter, split_keys

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


# ---------------------------------------------------------------------------
# ResNet (the basic-block variant of the reference, no batch norm: basic
# blocks keep the client/server FLOP asymmetry the paper's tables measure,
# and the analytic accounting uses the true ResNet-50 costs)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    name: str
    stages: tuple = (2, 2, 2, 2)
    widths: tuple = (64, 128, 256, 512)
    in_ch: int = 3
    n_classes: int = 100
    width_mult: float = 1.0
    dtype: Any = torch.float32


def _resblock_init(gen, in_ch, out_ch, dtype):
    k1, k2, k3 = split_keys(gen, 3)
    p = {"c1": L.conv2d_init(k1, in_ch, out_ch, 3, dtype=dtype),
         "c2": L.conv2d_init(k2, out_ch, out_ch, 3, dtype=dtype)}
    if in_ch != out_ch:
        p["proj"] = L.conv2d_init(k3, in_ch, out_ch, 1, dtype=dtype)
    return p


def _resblock_apply(p, x, stride):
    h = torch.relu(L.conv2d_apply(p["c1"], x, stride=stride))
    h = L.conv2d_apply(p["c2"], h)
    sc = x
    if "proj" in p:
        sc = L.conv2d_apply(p["proj"], x, stride=stride)
    elif stride != 1:
        sc = x[:, ::stride, ::stride, :]
    return torch.relu(h + sc)


def resnet_init(gen: torch.Generator, cfg: ResNetConfig):
    """A list of per-layer param dicts (parallel to `resnet_plan`): the
    stem conv, one dict per basic block, the classifier."""
    layers = []
    kit = key_iter(gen)
    in_ch = cfg.in_ch
    stem_ch = _w(cfg.widths[0], cfg.width_mult)
    layers.append({"conv": L.conv2d_init(next(kit), in_ch, stem_ch, 3,
                                         dtype=cfg.dtype)})
    in_ch = stem_ch
    for n, w in zip(cfg.stages, cfg.widths):
        out_ch = _w(w, cfg.width_mult)
        for _ in range(n):
            layers.append(_resblock_init(next(kit), in_ch, out_ch, cfg.dtype))
            in_ch = out_ch
    layers.append({"fc": L.dense_init(next(kit), in_ch, cfg.n_classes,
                                      bias=True, dtype=cfg.dtype)})
    return layers


def resnet_plan(cfg: ResNetConfig):
    """(kind, stride) descriptors parallel to `resnet_init`'s layers: each
    stage after the first opens with a stride-2 block."""
    plan = [("stem", 1)]
    for si, n in enumerate(cfg.stages):
        for bi in range(n):
            plan.append(("block", 2 if (si > 0 and bi == 0) else 1))
    plan.append(("head", 1))
    return plan


def resnet_layer_apply(layer_params, plan_item, x):
    """Apply one logical layer of `resnet_plan`."""
    kind, stride = plan_item
    if kind == "stem":
        return torch.relu(L.conv2d_apply(layer_params["conv"], x))
    if kind == "block":
        return _resblock_apply(layer_params, x, stride)
    x = L.avgpool_global(x) if x.ndim == 4 else x
    return L.dense_apply(layer_params["fc"], x)


def resnet_apply(params, cfg: ResNetConfig, x, *, from_layer: int = 0,
                 to_layer: int | None = None):
    """Run layers [from_layer, to_layer) — the split-learning hook."""
    plan = resnet_plan(cfg)
    to_layer = len(plan) if to_layer is None else to_layer
    for i in range(from_layer, to_layer):
        x = resnet_layer_apply(params[i], plan[i], x)
    return x
