"""The meshes of the port and the production mesh's sharding rules (port
of `repro/launch/mesh.py`).

The fleet mesh: the client axis the fleet engines shard over.

A fleet rank is one process with one device; a `FleetMesh` names the
process group the ranks share, this process's rank and device, and the
("clients", "model") axes of the reference's mesh.  The "model" axis is
reserved for server tensor parallelism, which no engine consumes yet, so
it has size 1.

`make_mesh_compat` builds the named mesh the sharded serving paths run
over (`nn.moe.moe_apply_ep`, `nn.attention.gqa_decode_sharded`): any
axes, one subgroup per axis.

The production mesh (`make_production_mesh`: (data=16, model=16), or
(pod=2, data=16, model=16) across two pods) is a `DeviceMesh` over the
default process group, and the sharding rules say how each parameter,
optimizer moment, batch input and decode cache lies on it
(`param_pspecs`, `opt_pspecs`, `batch_pspecs`, `cache_pspecs`).  A spec
is a plain tuple with one entry a tensor dim: None (replicated), an
axis name, or a tuple of names (the dim split over their product).  The
rules match on tree paths and commit a sharded dim only where the mesh
divides it, else they replicate.  They take any mesh with a `shape`
mapping each axis name to its size and `axis_names`, or a `DeviceMesh`.

The rules are the reference's, which it applies to its stacked trees:
a group's repeats stacked along a leading axis, so that `_FSDP_MIN_SIZE`
counts the stacked leaf's elements and the cache rules find the batch
at dim 1.  The port keeps a list of per-repeat trees, so each rule runs
on the reference's layout (meta tensors restacked by
`bridge.lm_tree_to_ref` / `bridge.lm_caches_to_ref`) and each per-layer
leaf takes its stacked leaf's spec without the leading (layer) entry,
which no rule shards.  A ring's `pos` is a host int: its spec is ().
`param_shardings` / `batch_shardings` / `cache_shardings` turn each spec
into `(mesh, placements)` for `distribute_tensor`: `Shard(d)` on each
mesh dim the spec names for tensor dim d, `Replicate()` elsewhere.
"""
from __future__ import annotations

import collections
import dataclasses
import math
import os
import tempfile
from typing import Any

import torch
import torch.distributed as dist

from repro_torch import bridge
from repro_torch.device import resolve_device
from repro_torch.nn.module import map_with_path, tree_leaves, tree_map

FLEET_CLIENT_AXIS = "clients"
FLEET_MODEL_AXIS = "model"
BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


@dataclasses.dataclass
class FleetMesh:
    """The fleet's ranks: `group` (the default process group), this
    process's `rank` along the client axis and its `device`, and
    `counts`, the leaves passed to each collective (`nn.dist`)."""
    group: Any
    rank: int
    device: torch.device
    n_devices: int
    axis_names: tuple = (FLEET_CLIENT_AXIS, FLEET_MODEL_AXIS)
    counts: collections.Counter = dataclasses.field(
        default_factory=collections.Counter)

    @property
    def shape(self) -> dict:
        return {self.axis_names[0]: self.n_devices, self.axis_names[1]: 1}


def _launch_hint(n: int) -> str:
    return (f"launch one process a rank: on cards `torchrun "
            f"--nproc-per-node {n} <script>` (one GPU a rank, nccl); on the "
            f"CPU `torchrun --nproc-per-node {n} <script> --device cpu`, or "
            f"the tests' spawn helper (tests/_torch_fleet_ranks.py, gloo)")


def _join_group(dev: torch.device, n: int | None, what: str) -> int:
    """Join the default process group for `dev`, creating it if need be,
    and return its world size.  Its backend follows the device: nccl for
    cuda, one rank a GPU (`torch.cuda.set_device` to the rank's local
    index), gloo for the CPU.  With no group yet, it joins the ranks
    `torchrun` launched (its environment), or else, with one rank asked
    for (`n` of None or 1), creates a group of one rank (a `FileStore` in
    a temporary directory); more ranks are launched, not created here
    (the ValueError says how)."""
    backend = BACKENDS[dev.type]
    if not dist.is_initialized():
        launched = "WORLD_SIZE" in os.environ        # torchrun's ranks
        if not launched and n not in (None, 1):
            raise ValueError(
                f"{what} needs {n} ranks but no process group is "
                f"initialized; {_launch_hint(n)}")
        if dev.type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        if launched:
            dist.init_process_group(backend)
        else:
            store = dist.FileStore(
                os.path.join(tempfile.mkdtemp(prefix="fleet-"), "store"), 1)
            dist.init_process_group(backend, store=store, rank=0,
                                    world_size=1)
    world = dist.get_world_size()
    if n is not None and n > world:
        raise ValueError(f"{what} needs {n} ranks but the process group "
                         f"has {world}; {_launch_hint(n)}")
    have = dist.get_backend()
    if backend not in have:
        raise ValueError(f"a {what} on {dev.type} needs a {backend} group; "
                         f"the process group's backend is {have}")
    return world


def _rank_device(dev: torch.device) -> torch.device:
    """This rank's device: on cuda the GPU of its local rank (made
    current), on the CPU `dev` itself."""
    if dev.type != "cuda":
        return dev
    dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK",
                                                  dist.get_rank())))
    torch.cuda.set_device(dev)
    return dev


def make_fleet_mesh(n_devices: int | None = None, *,
                    model_parallel: int = 1, device=None) -> FleetMesh:
    """THE mesh factory of the fleet engines, over the default process
    group (`_join_group`: nccl on the GPU, the default, gloo on the
    CPU).  `n_devices=None` takes the group's world size; the fleet spans
    every rank of the group."""
    if model_parallel != 1:
        raise NotImplementedError(
            "model_parallel > 1: the 'model' mesh axis is reserved for "
            "server tensor parallelism, which no fleet engine consumes yet")
    dev = resolve_device(device)
    world = _join_group(dev, n_devices, "fleet mesh")
    n = world if n_devices is None else n_devices
    if n < world:
        raise ValueError(f"fleet mesh of {n} ranks: the fleet spans every "
                         f"rank of the process group ({world})")
    return FleetMesh(group=dist.group.WORLD, rank=dist.get_rank(),
                     device=_rank_device(dev), n_devices=n)


@dataclasses.dataclass
class Mesh:
    """A named mesh over the ranks of the default process group, one rank
    a device (port of `repro/launch/mesh.py:24-32`'s `jax.make_mesh`).
    `shape` maps each axis name to its size, in order; the ranks are laid
    out row-major, the last axis fastest.  `coords[axis]` is this rank's
    index on the axis and `groups[axis]` the subgroup of the ranks that
    share its other coordinates (the default group where the axis spans
    every rank).  `group` is the default group (the `tree_*`
    collectives'), `counts` the collective calls `nn.dist` made."""
    group: Any
    rank: int
    device: torch.device
    shape: dict
    coords: dict
    groups: dict
    counts: collections.Counter = dataclasses.field(
        default_factory=collections.Counter)

    @property
    def axis_names(self) -> tuple:
        return tuple(self.shape)


def make_mesh_compat(shape, axes, *, device=None) -> Mesh:
    """A mesh of `shape` named `axes` (e.g. `((1, 1), ("data", "model"))`)
    over the default process group, which `_join_group` joins or creates
    for `device` (default the GPU); the product of `shape` must be the
    group's world size.  Every rank must call it, in the same order: each
    axis's subgroups are made with `dist.new_group`, which every rank
    enters."""
    shape, axes = tuple(int(n) for n in shape), tuple(axes)
    if len(shape) != len(axes) or len(set(axes)) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes}: one distinct "
                         "name an axis")
    dev = resolve_device(device)
    need = math.prod(shape)
    world = _join_group(dev, need, f"mesh {dict(zip(axes, shape))}")
    if need != world:
        raise ValueError(f"mesh {dict(zip(axes, shape))} spans {need} ranks "
                         f"but the process group has {world}")
    rank = dist.get_rank()
    coords, groups = {}, {}
    grid = torch.arange(world).reshape(shape)
    for i, ax in enumerate(axes):
        coords[ax] = int((grid == rank).nonzero()[0, i])
        if shape[i] == world:
            groups[ax] = dist.group.WORLD
            continue
        # the lines of the grid along axis i, each one subgroup
        lines = grid.movedim(i, -1).reshape(-1, shape[i]).tolist()
        for line in lines:
            g = dist.new_group(line)
            if rank in line:
                groups[ax] = g
    return Mesh(group=dist.group.WORLD, rank=rank, device=_rank_device(dev),
                shape=dict(zip(axes, shape)), coords=coords, groups=groups)


# ---------------------------------------------------------------------------
# The production mesh (port of `repro/launch/mesh.py:35-41`)
# ---------------------------------------------------------------------------

def production_shape(multi_pod: bool = False) -> tuple:
    """((sizes), (axis names)) of the production mesh."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_production_mesh(*, multi_pod: bool = False):
    """The production mesh as a `DeviceMesh` over the default process
    group, which must hold exactly its 256 (512) ranks: the card's NCCL
    ranks, or the fake group of the dry run (`launch/dryrun.py`)."""
    from torch.distributed.device_mesh import init_device_mesh
    shape, axes = production_shape(multi_pod)
    need = math.prod(shape)
    what = f"production mesh {dict(zip(axes, shape))}"
    if not dist.is_initialized():
        raise ValueError(f"{what} needs a process group of {need} ranks; "
                         "none is initialized")
    world = dist.get_world_size()
    if world != need:
        raise ValueError(f"{what} spans {need} ranks but the process group "
                         f"has {world}")
    device = "cuda" if "nccl" in dist.get_backend() else "cpu"
    return init_device_mesh(device, shape, mesh_dim_names=axes)


def mesh_axes(mesh) -> dict:
    """Axis name -> size of a `DeviceMesh`, or of a mesh whose `shape`
    maps names to sizes."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return dict(mesh.shape)


def _batch_axes(axes: dict):
    """The batch axes: ("pod", "data"), or "data" alone (as jax's
    PartitionSpec writes a one-name tuple)."""
    return ("pod", "data") if "pod" in axes else "data"


def _axis_size(axes: dict, axis) -> int:
    if isinstance(axis, tuple):
        return math.prod(_axis_size(axes, a) for a in axis)
    return axes[axis]


def _ok(axes: dict, dim_size: int, axis) -> bool:
    return axis is not None and dim_size % _axis_size(axes, axis) == 0


# ---------------------------------------------------------------------------
# Parameter sharding rules (port of `repro/launch/mesh.py:95-185`)
# ---------------------------------------------------------------------------

# leaf/parent names whose *last* dim is tensor-parallel (column parallel)
_COL = {"wq", "wk", "wv", "gate", "up", "in_x", "in_gate", "in_proj",
        "wq_b", "wk_b", "wv_b", "fc1", "gate_a", "gate_x"}
# names whose second-to-last dim is tensor-parallel (row parallel)
_ROW = {"wo", "down", "out", "out_proj", "fc2"}
# MoE stacked expert tensors: leaf itself named gate/up/down with rank>=3
_EXPERT_LEAVES = {"gate", "up", "down"}

_FSDP_MIN_SIZE = 1 << 20      # only 2D-shard leaves >= 1M elements


def _param_spec(path: tuple, shape: tuple, axes: dict, *,
                fsdp: bool = False) -> tuple:
    """The spec of one leaf of the reference's (stacked) layout."""
    model_ax = "model"
    name = path[-1]
    parent = path[-2] if len(path) >= 2 else ""
    rank = len(shape)

    def maybe_fsdp(spec_tail: tuple) -> tuple:
        """FSDP (ZeRO-3) 2D weight sharding: also shard the largest
        still-unsharded dim of the tail over the batch axes, for a leaf of
        at least `_FSDP_MIN_SIZE` elements (counted stacked)."""
        if not fsdp or math.prod(shape) < _FSDP_MIN_SIZE:
            return spec_tail
        da = _batch_axes(axes)
        tail = list(spec_tail)
        offset = rank - len(tail)
        order = sorted(range(len(tail)), key=lambda i: -shape[offset + i])
        for i in order:
            if tail[i] is None and _ok(axes, shape[offset + i], da):
                tail[i] = da
                break
        return tuple(tail)

    def pad(spec_tail: tuple) -> tuple:
        spec_tail = maybe_fsdp(spec_tail)
        return (None,) * (rank - len(spec_tail)) + spec_tail

    # MoE experts: (..., E, D, F), expert-parallel over the model axis
    if name in _EXPERT_LEAVES and rank >= 3 and parent == "mlp":
        if _ok(axes, shape[-3], model_ax):
            return pad((model_ax, None, None))
        return pad((None, None, None))
    # embedding / tied head table: vocab-parallel
    if name == "table":
        if _ok(axes, shape[-2], model_ax):
            return pad((model_ax, None))
        return pad((None, None))
    # generic dense weights
    if name == "w":
        if parent in _COL and _ok(axes, shape[-1], model_ax):
            return pad((None, model_ax))
        if parent in _ROW and _ok(axes, shape[-2], model_ax):
            return pad((model_ax, None))
        # head / unlisted: shard the bigger dim if divisible
        if shape[-1] >= shape[-2] and _ok(axes, shape[-1], model_ax):
            return pad((None, model_ax))
        if _ok(axes, shape[-2], model_ax):
            return pad((model_ax, None))
        return pad((None, None))
    if name == "b":
        if parent in _COL and _ok(axes, shape[-1], model_ax):
            return pad((model_ax,))
        return pad((None,))
    # everything else (norm scales, A_log, dt_bias, lam, conv, router)
    return (None,) * rank


def _spec_map(fn, specs):
    """`fn` over the specs (tuples) of a spec tree of dicts and lists."""
    if isinstance(specs, dict):             # keys sorted, as `tree_map`
        return {k: _spec_map(fn, specs[k]) for k in sorted(specs)}
    if isinstance(specs, list):
        return [_spec_map(fn, v) for v in specs]
    return fn(specs)


def spec_leaves(specs) -> list:
    """The specs of a spec tree in `tree_leaves` order."""
    out: list = []
    _spec_map(out.append, specs)
    return out


def _drop_layer_axis(spec: tuple) -> tuple:
    """A stacked leaf's spec for one of its layers."""
    if not spec:                         # a cursor: replicated, any rank
        return spec
    if spec[0] is not None:
        raise ValueError(f"spec {spec} shards the layer axis of a stacked "
                         "leaf; a per-layer leaf cannot take it")
    return spec[1:]


def _per_layer(stacked_specs, n: int) -> list:
    return [_spec_map(_drop_layer_axis, stacked_specs) for _ in range(n)]


# an encoder-decoder model's layer stacks (as in `bridge`)
_LAYER_STACKS = ("enc_blocks", "dec_blocks")


def _unstack_specs(tree, specs):
    """The specs of the restacked `tree` given back in `tree`'s layout:
    each group's (each layer stack's) stacked specs to every repeat."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            if k == "groups":
                out[k] = [_per_layer(s, len(reps))
                          for reps, s in zip(v, specs[k], strict=True)]
            elif k in _LAYER_STACKS:
                out[k] = _per_layer(specs[k], len(v))
            else:
                out[k] = _unstack_specs(v, specs[k])
        return out
    if isinstance(tree, (list, tuple)):
        return [_unstack_specs(v, s) for v, s in zip(tree, specs,
                                                     strict=True)]
    return specs


def _meta(t):
    if isinstance(t, torch.Tensor):
        return torch.empty(t.shape, dtype=t.dtype, device="meta")
    return t


def _shape(leaf) -> tuple:
    return tuple(leaf.shape) if isinstance(leaf, torch.Tensor) else ()


def param_pspecs(params, mesh, *, fsdp: bool = False):
    """The spec of every leaf of an LM's or an encoder-decoder model's
    param tree (any tree whose "groups" / layer stacks are the port's
    per-repeat lists: params, one side of a split, an optimizer moment).
    `fsdp=True` also shards large weights over the batch axes (ZeRO-3
    2D sharding), for models whose params and fp32 optimizer state
    exceed a device under tensor parallelism alone."""
    axes = mesh_axes(mesh)
    stacked = bridge.lm_tree_to_ref(tree_map(_meta, params))
    specs = map_with_path(
        lambda path, leaf: _param_spec(path, _shape(leaf), axes,
                                       fsdp=fsdp), stacked)
    return _unstack_specs(params, specs)


# ---------------------------------------------------------------------------
# Batch sharding (port of `repro/launch/mesh.py:198-222`)
# ---------------------------------------------------------------------------

def batch_pspecs(batch: dict, mesh) -> dict:
    """Shard the leading (global-batch) dim over ("pod", "data"); if the
    batch is too small (long_500k's B=1), shard the sequence dim."""
    axes = mesh_axes(mesh)
    ba = _batch_axes(axes)
    out = {}
    for k, v in batch.items():
        rank = v.ndim
        if _ok(axes, v.shape[0], ba):
            out[k] = (ba,) + (None,) * (rank - 1)
        elif rank >= 2 and _ok(axes, v.shape[1], ba):
            out[k] = (None, ba) + (None,) * (rank - 2)
        else:
            out[k] = (None,) * rank
    return out


# ---------------------------------------------------------------------------
# KV / state cache sharding, decode (port of `repro/launch/mesh.py:229-277`)
# ---------------------------------------------------------------------------

_SEQ_CACHE_LEAVES = {"k", "v", "c_kv", "k_pe"}


def _cache_spec(path: tuple, shape: tuple, axes: dict) -> tuple:
    """Caches may be stacked (a leading layer dim).  Ring caches lie as
    (layers?, B, len, heads?, hd?): the batch sharded over ("pod",
    "data") where divisible, the cache length over "model" where
    divisible (sequence-sharded KV)."""
    name = path[-1]
    rank = len(shape)
    ba = _batch_axes(axes)
    if name == "pos":
        return ()
    spec: list = [None] * rank
    if name in _SEQ_CACHE_LEAVES and rank >= 3:
        if rank == 3:            # (B, len, r): a flat MLA latent
            b_dim, l_dim = 0, 1
        elif rank == 4:
            # k/v at rank 4 are FLAT (B, len, K, hd); only the MLA
            # latents (c_kv, k_pe) are stacked at rank 4 (L, B, len, r)
            b_dim, l_dim = (1, 2) if name in ("c_kv", "k_pe") else (0, 1)
        else:                    # rank 5: (L, B, len, K, hd)
            b_dim, l_dim = 1, 2
        if _ok(axes, shape[b_dim], ba):
            spec[b_dim] = ba
        if _ok(axes, shape[l_dim], "model"):
            spec[l_dim] = "model"
        return tuple(spec)
    # recurrent states ("conv", "h", "ssm", "0") and the rest: the batch
    # on dim 1 (stacked), else dim 0, where divisible
    for b_dim in (1, 0):
        if b_dim < rank and _ok(axes, shape[b_dim], ba):
            spec[b_dim] = ba
            break
    return tuple(spec)


def cache_pspecs(caches, mesh):
    """The spec of every leaf of a decode cache: an LM's list of group
    caches (each a list of per-repeat caches), or an encoder-decoder
    model's cache dict (stacked in both packages)."""
    axes = mesh_axes(mesh)
    lm = isinstance(caches, list)
    stacked = tree_map(_meta, caches)
    if lm:
        stacked = bridge.lm_caches_to_ref(stacked)
    specs = map_with_path(
        lambda path, leaf: _cache_spec(path, _shape(leaf), axes), stacked)
    if lm:
        return [_per_layer(s, len(reps))
                for reps, s in zip(caches, specs, strict=True)]
    return specs


# ---------------------------------------------------------------------------
# Optimizer state: mirrors the params (port of `repro/launch/mesh.py:284`)
# ---------------------------------------------------------------------------

def opt_pspecs(opt_state, params_pspecs):
    """The moments m / v / mu take their params' specs; scalars (the
    step) replicate."""
    def fix(path, leaf):
        if path and path[0] in ("m", "v", "mu"):
            sub = params_pspecs
            for p in path[1:]:
                sub = sub[p] if isinstance(sub, dict) else sub[int(p)]
            return sub
        return (None,) * len(_shape(leaf))
    return map_with_path(fix, opt_state)


# ---------------------------------------------------------------------------
# Specs -> placements, and the bytes a device holds
# ---------------------------------------------------------------------------

def placements(spec: tuple, mesh) -> tuple:
    """The `DeviceMesh` placements of `spec`: `Shard(d)` on every mesh dim
    that the spec names for tensor dim d (a dim over ("pod", "data")
    takes it on both), `Replicate()` on the others."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, ax in enumerate(spec):
        for a in ((ax,) if isinstance(ax, str) else ax or ()):
            out[names.index(a)] = Shard(d)
    return tuple(out)


def _shardings(specs, mesh):
    return _spec_map(lambda s: (mesh, placements(s, mesh)), specs)


def param_shardings(params, mesh, *, fsdp: bool = False):
    """`(mesh, placements)` for every leaf of `params` on a `DeviceMesh`,
    e.g. `distribute_tensor(leaf, *sharding)`."""
    return _shardings(param_pspecs(params, mesh, fsdp=fsdp), mesh)


def batch_shardings(batch: dict, mesh) -> dict:
    return _shardings(batch_pspecs(batch, mesh), mesh)


def cache_shardings(caches, mesh):
    return _shardings(cache_pspecs(caches, mesh), mesh)


def local_shape(shape: tuple, spec: tuple, mesh) -> tuple:
    """The shape of one device's shard of a `shape` leaf under `spec`."""
    axes = mesh_axes(mesh)
    return tuple(n // (1 if ax is None else _axis_size(axes, ax))
                 for n, ax in zip(shape, spec))


def local_bytes(tree, specs, mesh) -> int:
    """The bytes one device holds of `tree`'s tensors under `specs` (its
    spec tree); a host int (a ring's `pos`) holds none."""
    leaves, specs = tree_leaves(tree), spec_leaves(specs)
    if len(leaves) != len(specs):
        raise ValueError(f"{len(leaves)} leaves but {len(specs)} specs")
    return sum(math.prod(local_shape(tuple(t.shape), s, mesh))
               * t.element_size()
               for t, s in zip(leaves, specs) if isinstance(t, torch.Tensor))
