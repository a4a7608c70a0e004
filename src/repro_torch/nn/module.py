"""Minimal functional module system (port of `repro/nn/module.py`).

Parameters are plain nested dicts and lists of tensors ("param trees").
Every layer is a pair of functions:

    init(gen, ...) -> params
    apply(params, x, ...) -> y

Randomness comes from an explicit `torch.Generator`, the counterpart of a
`jax.random` key: a layer draws its parameters from the generator it is
given, on the generator's device.  `split_keys` / `key_iter` derive child
generators from a parent, as `jax.random.split` derives subkeys, so each
consumer owns its own stream.  The numbers differ from `jax.random`'s;
parity tests bridge the reference's parameters (`repro_torch.bridge`).
"""
from __future__ import annotations

import math
from typing import Any, Callable, Iterator

import torch

Params = Any  # nested dict[str, Params] | list[Params] | torch.Tensor


def _child(gen: torch.Generator) -> torch.Generator:
    seed = int(torch.randint(0, 2 ** 62, (), generator=gen,
                             device=gen.device))
    return torch.Generator(device=gen.device).manual_seed(seed)


def split_keys(gen: torch.Generator, n: int) -> list[torch.Generator]:
    """`n` child generators seeded from `gen` (which advances)."""
    return [_child(gen) for _ in range(n)]


def key_iter(gen: torch.Generator) -> Iterator[torch.Generator]:
    """Infinite stream of fresh child generators."""
    while True:
        yield _child(gen)


def mix_seed(*words: int) -> int:
    """One 64-bit generator seed from a sequence of integers (splitmix64
    over each in turn): the counterpart of folding them into a key."""
    m = (1 << 64) - 1
    x = 0
    for w in words:
        x = ((x ^ w) + 0x9E3779B97F4A7C15) & m
        x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & m
        x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & m
        x ^= x >> 31
    return x


# ---------------------------------------------------------------------------
# Initializers
# ---------------------------------------------------------------------------

def normal_init(gen, shape, dtype, stddev: float = 0.02, device=None):
    """Normal(0, stddev) drawn in float32 on `device` (default: the
    generator's), then cast: one float32 copy of the leaf at a time (the
    scaling is in place)."""
    device = gen.device if device is None else device
    w = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
    return w.mul_(stddev).to(dtype)


def lecun_init(gen, shape, dtype, fan_in: int | None = None, device=None):
    fan_in = fan_in if fan_in is not None else shape[0]
    return normal_init(gen, shape, dtype, 1.0 / math.sqrt(max(1, fan_in)),
                       device)


# ---------------------------------------------------------------------------
# Tree utilities
# ---------------------------------------------------------------------------

def tree_map(fn: Callable, tree, *rest):
    """Apply `fn` leafwise over nested dicts, lists and tuples (the
    structure of `tree`; `rest` must share it).  Dict keys go in sorted
    order, as in `jax.tree_util`, so leaf lists line up with the
    reference's."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves of `tree` in `tree_map` order."""
    out: list = []
    tree_map(out.append, tree)
    return out


def param_count(params: Params) -> int:
    return sum(x.numel() for x in tree_leaves(params))


def param_bytes(params: Params) -> int:
    return sum(x.numel() * x.element_size() for x in tree_leaves(params))


def map_with_path(fn: Callable[[tuple, Any], Any], params: Params) -> Params:
    """`tree_map` where `fn` also receives the leaf's path: a tuple of
    strings, a dict key or a list / tuple index as `str` (the reference's
    `_path_elem_str`), e.g. ("groups", "0", "0", "mixer", "wq", "w")."""
    def walk(path, t):
        if isinstance(t, dict):
            return {k: walk(path + (str(k),), t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return type(t)(walk(path + (str(i),), v)
                           for i, v in enumerate(t))
        return fn(path, t)
    return walk((), params)


def tree_paths(params: Params) -> list[tuple[str, ...]]:
    """The leaves' paths in `tree_leaves` order, e.g. ('embed', 'table')."""
    out: list = []
    map_with_path(lambda path, _: out.append(path), params)
    return out
