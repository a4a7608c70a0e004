"""Tree checkpoints: a flat-path npz and a JSON manifest (port of
`repro/checkpoint/checkpoint.py`).

The files are the reference's: each leaf is stored under its path in the
tree, dict keys and list indices joined by "/" in sorted-key order
(`repro/nn/module.py:_path_elem_str`), and the manifest holds `step`,
`extra` and each leaf's shape and dtype name.  numpy has no bfloat16 of
its own, so a bf16 leaf is stored as its raw 16-bit pattern (numpy's
2-byte void, `<V2`), which is what the reference's npz holds for one, with
"bfloat16" in the manifest.  Trees are the port's (dicts, lists and
tuples of tensors); an LM tree is written in the reference's layout
through `bridge.lm_tree_to_ref` first.
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch

_SEP = "/"


def _flatten(tree, prefix: tuple = ()) -> list:
    """(path, leaf) pairs in the reference's order: dict keys sorted."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in _flatten(tree[k], prefix + (str(k),))]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree)
                for kv in _flatten(v, prefix + (str(i),))]
    return [(_SEP.join(prefix), tree)]


def _unflatten(tree, leaves):
    if isinstance(tree, dict):
        return {k: _unflatten(tree[k], leaves) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unflatten(v, leaves) for v in tree)
    return next(leaves)


def _to_numpy(t: torch.Tensor) -> tuple:
    """(array to store, manifest dtype name) for one leaf."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2"), "bfloat16"
    a = t.numpy()
    return a, str(a.dtype)


def _npz(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def save(path: str, params, step: int | None = None,
         extra: dict | None = None):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    flat = {k: _to_numpy(v) for k, v in _flatten(params)}
    np.savez(_npz(path), **{k: a for k, (a, _) in flat.items()})
    manifest = {
        "step": step,
        "extra": extra or {},
        "leaves": {k: {"shape": list(a.shape), "dtype": dt}
                   for k, (a, dt) in flat.items()},
    }
    with open(path.removesuffix(".npz") + ".json", "w") as f:
        json.dump(manifest, f, indent=1)


def _to_tensor(arr: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    if arr.dtype == np.dtype("V2") or arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(device=like.device, dtype=like.dtype)


def restore(path: str, template):
    """The checkpoint at `path` in the structure of `template` (a tree of
    tensors, e.g. a fresh init): each leaf takes its template leaf's dtype
    and device.  Raises ValueError where a stored shape differs from the
    template's."""
    with np.load(_npz(path)) as npz:
        out = []
        for key, tmpl in _flatten(template):
            arr = npz[key]
            if tuple(arr.shape) != tuple(tmpl.shape):
                raise ValueError(f"ckpt leaf {key}: {arr.shape} != "
                                 f"{tuple(tmpl.shape)}")
            out.append(_to_tensor(arr, tmpl))
    return _unflatten(template, iter(out))


def load_manifest(path: str) -> dict:
    with open(path.removesuffix(".npz") + ".json") as f:
        return json.load(f)
