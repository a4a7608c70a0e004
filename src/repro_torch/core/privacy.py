"""Privacy instrumentation of the cut (port of `repro/core/privacy.py`).

Two kinds of evidence that raw data never crosses the boundary:

1. Structural: `assert_no_raw_payload` flags every wire record with the
   shape and dtype of a raw input or label tensor.
2. Statistical: the distance correlation (Székely et al.) between raw
   inputs and what crosses the wire, 0 meaning independent.  SplitNN does
   not guarantee low leakage; this metric quantifies it.
"""
from __future__ import annotations

import torch


def _pairwise_dist(x):
    """Euclidean distance matrix of rows of x: (n, n)."""
    sq = (x * x).sum(dim=1)
    d2 = sq[:, None] + sq[None, :] - 2 * (x @ x.T)
    return torch.sqrt(torch.clamp_min(d2, 0.0))


def _center(d):
    rm = d.mean(dim=0, keepdim=True)
    cm = d.mean(dim=1, keepdim=True)
    return d - rm - cm + d.mean()


def distance_correlation(x, y) -> torch.Tensor:
    """Empirical distance correlation between samples x (n, dx) and
    y (n, dy) in [0, 1]; 0 = independent."""
    x = x.reshape(x.shape[0], -1).float()
    y = y.reshape(y.shape[0], -1).float()
    a = _center(_pairwise_dist(x))
    b = _center(_pairwise_dist(y))
    dcov2 = (a * b).mean()
    dvar_x = (a * a).mean()
    dvar_y = (b * b).mean()
    return torch.sqrt(torch.clamp_min(dcov2, 0.0)
                      / torch.clamp_min(torch.sqrt(dvar_x * dvar_y), 1e-12))


def assert_no_raw_payload(wires, raw_tensors: dict) -> list:
    """No wire payload may have the shape and dtype of a raw tensor AND be
    that tensor: every (record name, raw name) pair whose shape and dtype
    collide is returned (a collision alone is allowed, but flagged)."""
    problems = []
    for w in wires:
        for name, t in raw_tensors.items():
            if tuple(w.shape) == tuple(t.shape) and w.dtype == t.dtype:
                problems.append((w.name, name))
    return problems


def leakage_report(x_raw, cut_act, labels=None) -> dict:
    out = {"dcor_input_vs_act": float(distance_correlation(x_raw, cut_act))}
    if labels is not None:
        one_hot = torch.nn.functional.one_hot(
            labels.long(), int(labels.max()) + 1).float()
        out["dcor_label_vs_act"] = float(
            distance_correlation(one_hot, cut_act))
    return out
