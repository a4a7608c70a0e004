"""Move parameters and training state between the reference's layout
and the port's.

* LM params: the reference (`repro.models.lm`) keeps each group's layers
  stacked along a leading axis, `{"0": {..., leaf (n_repeat, ...)}}`;
  the port keeps a list with one `{"0": {..., leaf (...)}}` per repeat
  (`params_from_jax` / `params_to_numpy`).
* Everything else has the same layout in both packages, leaf for leaf:
  the CNN list-of-dict trees (HWIO conv and `(in, out)` dense weights)
  and a whole engine state — stacked `clients`, `server`, `opt_c`,
  `opt_s` (with int32 `step`s) and `last_trained`
  (`tree_from_jax` / `tree_to_numpy`).

Arrays cross as numpy: the caller turns the reference's tree into numpy
arrays (`jax.tree_util.tree_map(np.asarray, tree)`) and hands it here,
so this module imports no JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.lm import make_groups
from repro_torch.nn.module import tree_map as _map


def _tensor(a, dtype, device) -> torch.Tensor:
    """One numpy leaf as a tensor on `device`; float leaves cast to
    `dtype` (None keeps theirs), others keep their type."""
    a = np.array(a, copy=True)
    if a.dtype.name == "bfloat16":           # numpy has no bf16 of its own
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    if t.is_floating_point() and dtype is not None:
        t = t.to(dtype)
    return t.to(device)


def _array(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:            # exact in float32
        t = t.float()
    return t.numpy()


def params_from_jax(np_tree: dict, cfg: ArchConfig, device="cpu") -> dict:
    """The reference's LM param tree (as numpy arrays) -> the port's
    params on `device`, float leaves in `cfg.dtype`."""
    conv = lambda tree: _map(lambda a: _tensor(a, cfg.dtype, device), tree)
    out = {k: conv(v) for k, v in np_tree.items() if k != "groups"}
    out["groups"] = []
    for g, gp in zip(make_groups(cfg), np_tree["groups"]):
        out["groups"].append([conv(_map(lambda a, r=r: a[r], gp))
                              for r in range(g.n_repeat)])
    return out


def params_to_numpy(params: dict) -> dict:
    """Inverse of `params_from_jax`: the reference's layout as numpy
    arrays (bf16 leaves come back as float32, which holds them exactly)."""
    out = {k: _map(_array, v) for k, v in params.items() if k != "groups"}
    out["groups"] = []
    for gp in params["groups"]:
        reps = [_map(_array, rep) for rep in gp]
        out["groups"].append(_map_stack(reps))
    return out


def _map_stack(reps: list):
    first = reps[0]
    if isinstance(first, dict):
        return {k: _map_stack([r[k] for r in reps]) for k in first}
    return np.stack(reps)


def tree_from_jax(np_tree, device="cpu", dtype=None):
    """A reference tree of numpy arrays (CNN params, an optimizer state,
    a whole engine state) -> the same tree of tensors on `device`."""
    return _map(lambda a: _tensor(a, dtype, device), np_tree)


def tree_to_numpy(tree):
    """Inverse of `tree_from_jax` (bf16 leaves come back as float32)."""
    return _map(_array, tree)
