"""Move parameters and training state between the reference's layout
and the port's.

* LM params: the reference (`repro.models.lm`) keeps each group's layers
  stacked along a leading axis, `{"0": {..., leaf (n_repeat, ...)}}`;
  the port keeps a list with one `{"0": {..., leaf (...)}}` per repeat
  (`params_from_jax` / `params_to_numpy`).  Each float leaf takes the
  dtype the port's own init gives it: the model's dtype, or float32 for
  Mamba2's `A_log`, `D` and `dt_bias` (`nn/ssm.py:mamba2_init`) and
  RG-LRU's `lam` (`nn/rglru.py:rglru_init`).
  A composite group (the hybrid pattern) stacks each of its specs
  `{"0", "1", "2"}` in the reference and is one such dict per repeat in
  the port.  A MoE layer's leaves are the reference's: the float32
  router `(D, E)`, the stacked experts `gate`/`up` `(E, D, F)` and `down`
  `(E, F, D)`, and `shared`'s SwiGLU; an MLA layer's `wq_a`, `q_norm`,
  `wq_b` (or `wq`), `wkv_a`, `kv_norm`, `wk_b`, `wv_b` and `wo`.
* Split-serving caches, stacked the same way (`caches_from_jax` /
  `caches_to_numpy`): Mamba2's `{"conv", "ssm"}`, RG-LRU's `{"conv",
  "h"}`, the attention ring's `{"k", "v", "pos"}` and MLA's compressed
  ring `{"c_kv", "k_pe", "pos"}`; each leaf keeps its dtype (a conv
  window and the rings the model's, a state float32), and a ring's `pos`
  is a host int in the port, an int32 in the reference; a per-row cursor
  (`per_slot_pos`, the `Batcher`'s stacked cache) is a (B,) int32 in
  both, and `caches_to_numpy` carries it over.
* A whole LM training state (`lm_state_from_jax` / `lm_state_to_numpy`):
  a `Plan` over `lm_split_fns` or over the LM's `FullFns` keeps each
  "groups" list in the LM layout above, inside trees that are otherwise
  the same in both packages.  Under a client-stacked subtree (a split
  mode's `clients` and `opt_c`, fedavg's per-client `opt`) a group leaf
  is (n_clients, n_repeat, ...) in the reference, so the repeats are its
  second axis; elsewhere its first.  Optimizer moments follow the params
  they track, and every leaf keeps its dtype.
  Both go through `lm_tree_to_ref` / `lm_tree_from_ref`, which restack
  any LM tree of tensors (params, one side of the split, a
  client-stacked subtree); the checkpoints write LM trees through them.
* Everything else has the same layout in both packages, leaf for leaf:
  the CNN list-of-dict trees (HWIO conv and `(in, out)` dense weights,
  `{}` for a pool) and a whole engine state of any `Plan` mode — a split
  mode's stacked `clients`, `server`, `opt_c`, `opt_s` (with int32
  `step`s) and the int32 `last_trained`, a baseline's `{"global",
  "opt"}` — with tuples kept as tuples (the multihop relay slabs, the
  multitask heads) (`tree_from_jax` / `tree_to_numpy`).

Arrays cross as numpy: the caller turns the reference's tree into numpy
arrays (`jax.tree_util.tree_map(np.asarray, tree)`) and hands it here,
so this module imports no JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import build_model
from repro_torch.nn.module import tree_leaves
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


def _array(t) -> np.ndarray:
    if isinstance(t, int):                   # a KV ring's host `pos`
        return np.int32(t)
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:            # exact in float32
        t = t.float()
    return t.numpy()


def _unstack(group) -> list:
    """A stacked group tree -> one tree per repeat (leading axis)."""
    n = len(tree_leaves(group)[0])
    return [_map(lambda a, r=r: a[r], group) for r in range(n)]


def _stack(groups: list) -> list:
    """Inverse of `_unstack` over a list of groups, as numpy arrays."""
    return [_map_stack([_map(_array, rep) for rep in g]) for g in groups]


def params_from_jax(np_tree: dict, cfg: ArchConfig, device="cpu") -> dict:
    """The reference's LM param tree (as numpy arrays) -> the port's
    params on `device`, each float leaf in the dtype of the port's own
    init of `cfg` (run on meta, so nothing is drawn)."""
    like = build_model(cfg).init(torch.Generator(), "meta")

    def cast(tree, like_tree):
        return _map(lambda a, t: _tensor(a, t.dtype, device), tree,
                    like_tree)
    out = {k: cast(v, like[k]) for k, v in np_tree.items() if k != "groups"}
    out["groups"] = [[cast(rep, like_rep)
                      for rep, like_rep in zip(_unstack(gp), like_gp,
                                                 strict=True)]
                     for gp, like_gp in zip(np_tree["groups"],
                                            like["groups"], strict=True)]
    return out


def params_to_numpy(params: dict) -> dict:
    """Inverse of `params_from_jax`: the reference's layout as numpy
    arrays (bf16 leaves come back as float32, which holds them exactly)."""
    out = {k: _map(_array, v) for k, v in params.items() if k != "groups"}
    out["groups"] = _stack(params["groups"])
    return out


def _cache_from_np(tree, device):
    if isinstance(tree, dict):
        return {k: int(v) if k == "pos" else _cache_from_np(v, device)
                for k, v in tree.items()}
    return _tensor(tree, None, device)


def caches_from_jax(np_caches: list, device="cpu") -> list:
    """One side's split-serving caches from the reference
    (`init_cache_split`'s list of stacked group caches, as numpy) -> the
    port's list of per-repeat caches, each leaf in its own dtype."""
    return [[_cache_from_np(rep, device) for rep in _unstack(gc)]
            for gc in np_caches]


def caches_to_numpy(caches: list) -> list:
    """Inverse of `caches_from_jax` (`pos` back as an int32)."""
    return _stack(caches)


def _map_stack(reps: list):
    first = reps[0]
    if isinstance(first, dict):
        return {k: _map_stack([r[k] for r in reps]) for k in first}
    return np.stack(reps)


def _in_groups(tree, fn):
    """`tree` with `fn` applied to the list under every "groups" key."""
    if isinstance(tree, dict):
        return {k: fn(v) if k == "groups" else _in_groups(v, fn)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_in_groups(v, fn) for v in tree)
    return tree


def _client_stacked(state: dict) -> set:
    """The top-level keys of an engine state whose trees carry a leading
    client axis."""
    if "clients" in state:                       # a split mode
        return {"clients", "opt_c"}
    step = state.get("opt", {}).get("step")      # fedavg stacks its opt
    return {"opt"} if step is not None and np.ndim(step) == 1 else set()


def lm_tree_to_ref(tree, *, axis: int = 0):
    """An LM tree of tensors with each "groups" list of repeats stacked
    into the reference's layout along `axis` (1 under a client-stacked
    subtree, whose leaves lead with the client axis; else 0)."""
    def stack(groups):
        return [_map(lambda *reps: torch.stack(reps, dim=axis), *g)
                for g in groups]
    return _in_groups(tree, stack)


def lm_tree_from_ref(tree, *, axis: int = 0):
    """Inverse of `lm_tree_to_ref`: each stacked group unbound along
    `axis` into the port's list of repeats (copies, not views)."""
    def unstack(groups):
        return [[_map(lambda a, r=r: a.select(axis, r).clone(), g)
                 for r in range(tree_leaves(g)[0].shape[axis])]
                for g in groups]
    return _in_groups(tree, unstack)


def lm_state_from_jax(np_state: dict, device="cpu") -> dict:
    """A reference LM engine state (as numpy arrays) -> the port's, each
    group's repeat axis unstacked into the port's list of repeats."""
    stacked = _client_stacked(np_state)
    return {k: lm_tree_from_ref(v, axis=int(k in stacked))
            for k, v in tree_from_jax(np_state, device).items()}


def lm_state_to_numpy(state: dict) -> dict:
    """Inverse of `lm_state_from_jax`: the reference's layout as numpy
    arrays."""
    stacked = _client_stacked(state)
    return tree_to_numpy({k: lm_tree_to_ref(v, axis=int(k in stacked))
                          for k, v in state.items()})


def tree_from_jax(np_tree, device="cpu", dtype=None):
    """A reference tree of numpy arrays (CNN params, an optimizer state,
    a whole engine state) -> the same tree of tensors on `device`."""
    return _map(lambda a: _tensor(a, dtype, device), np_tree)


def tree_to_numpy(tree):
    """Inverse of `tree_from_jax` (bf16 leaves come back as float32)."""
    return _map(_array, tree)
