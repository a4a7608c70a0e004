"""The fleet mesh: the client axis the fleet engines shard over (port of
the fleet part of `repro/launch/mesh.py:44-76`).

A fleet rank is one process with one device; a `FleetMesh` names the
process group the ranks share, this process's rank and device, and the
("clients", "model") axes of the reference's mesh.  The "model" axis is
reserved for server tensor parallelism, which no engine consumes yet, so
it has size 1.

The reference's production mesh and its parameter-sharding rules
(`make_production_mesh`, `param_pspecs`, `param_shardings`,
`batch_pspecs`; `repro/launch/mesh.py:35-41, 79-295`) come with the
dry-run slice (ROADMAP.md).
"""
from __future__ import annotations

import collections
import dataclasses
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


def make_fleet_mesh(n_devices: int | None = None, *,
                    model_parallel: int = 1, device=None) -> FleetMesh:
    """THE mesh factory of the fleet engines, over the default process
    group, whose backend follows `device` (default the GPU): nccl for
    cuda, one rank a GPU (`torch.cuda.set_device` to the rank's local
    index), gloo for the CPU.  `n_devices=None` takes the group's world
    size.  With no group yet, it joins the ranks `torchrun` launched (its
    environment), or else, with one device asked for, creates a group of
    one rank (a `FileStore` in a temporary directory); more ranks are
    launched, not created here (the ValueError says how)."""
    if model_parallel != 1:
        raise NotImplementedError(
            "model_parallel > 1: the 'model' mesh axis is reserved for "
            "server tensor parallelism, which no fleet engine consumes yet")
    dev = resolve_device(device)
    backend = BACKENDS[dev.type]
    if not dist.is_initialized():
        launched = "WORLD_SIZE" in os.environ        # torchrun's ranks
        if not launched and n_devices not in (None, 1):
            raise ValueError(
                f"fleet mesh needs {n_devices} ranks but no process group "
                f"is initialized; {_launch_hint(n_devices)}")
        if dev.type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        if launched:
            dist.init_process_group(backend)
        else:
            store = dist.FileStore(
                os.path.join(tempfile.mkdtemp(prefix="fleet-"), "store"), 1)
            dist.init_process_group(backend, store=store, rank=0,
                                    world_size=1)
    world, rank = dist.get_world_size(), dist.get_rank()
    n = world if n_devices is None else n_devices
    if n > world:
        raise ValueError(f"fleet mesh needs {n} ranks but the process group "
                         f"has {world}; {_launch_hint(n)}")
    if n < world:
        raise ValueError(f"fleet mesh of {n} ranks: the fleet spans every "
                         f"rank of the process group ({world})")
    have = dist.get_backend()
    if backend not in have:
        raise ValueError(f"a fleet on {dev.type} needs a {backend} group; "
                         f"the process group's backend is {have}")
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", rank)))
        torch.cuda.set_device(dev)
    return FleetMesh(group=dist.group.WORLD, rank=rank, device=dev,
                     n_devices=n)
