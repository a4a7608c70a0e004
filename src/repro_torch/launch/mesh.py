"""The fleet mesh: the client axis the fleet engines shard over (port of
the fleet part of `repro/launch/mesh.py:44-76`).

A fleet rank is one process with one device; a `FleetMesh` names the
process group the ranks share, this process's rank and device, and the
("clients", "model") axes of the reference's mesh.  The "model" axis is
reserved for server tensor parallelism, which no engine consumes yet, so
it has size 1.

`make_mesh_compat` builds the named mesh the sharded serving paths run
over (`nn.moe.moe_apply_ep`, `nn.attention.gqa_decode_sharded`): any
axes, one subgroup per axis.  The reference's production mesh and its
parameter-sharding rules (`make_production_mesh`, `param_pspecs`,
`param_shardings`, `batch_pspecs`; `repro/launch/mesh.py:35-41,
79-295`) come with the dry-run slice (ROADMAP.md).
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

from repro_torch.device import resolve_device

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
