"""The fleet round engine: the client axis sharded over ranks (port of
`repro/engine/fleet.py`).

`RoundEngine` stacks the N client trees on one device, so the client
count is capped by one device's memory.  `FleetRoundEngine` runs the same
rounds with the N clients sharded over D ranks (`launch.mesh.
make_fleet_mesh`): a rank is a process with one device, every rank runs
the same script, and rank d holds clients d N/D .. (d+1) N/D - 1 and
their optimizer states; the server side is whole on every rank.

  schedule="parallel"   — each rank runs `run_parallel`'s turns over its
      own clients; ONE `tree_psum` carries the sum of their cut gradients,
      divided by N (`program.tree_mean0`, the single-device mean's own
      helper, so D=1 is bitwise the single-device round), and every rank
      applies the same server update.
  schedule="round_robin" — the serial schedule cannot be parallelised
      (client i+1 needs client i's weights), so the fleet shards memory,
      not time.  The reference runs D masked SPMD phases; eager ranks need
      no masking: rank d waits for the carry from rank d-1 (server params,
      their optimizer state, `last_trained` and the p2p handoff), runs
      `_round_robin` over its own clients, and sends the carry on to rank
      d+1; the last rank's carry is then broadcast.  The handoff rides the
      ring in its transport form, quantized once at the source
      (`WireStack.handoff_pack`) and adopted through `handoff_unpack`, so
      over a physical stack the int8 q and the fp32 row scales cross, and
      the pack plus the unpack on the far rank launch the wire kernels as
      often as the one `handoff_recv` they replace.  A client whose
      predecessor lives on its own rank goes through `handoff_recv`.  At
      D=1 the ring is the identity and no hop is sent.

The branch fan-in kinds (vertical, multitask, extended_vanilla) have no
shardable client fleet (K is the modality count), so they run replicated:
every rank runs the whole round.  The pipelined schedule is refused, as
the reference refuses it.

Engine state: `init` draws the whole state from the same generator seed
on every rank and keeps the rank's slice (`shard_state`), so the initial
state at D=k is the one at D=1; `gather_state` returns the whole fleet on
every rank.  Accounting is untouched: `TurnCost` probing, the meters and
`wire_report` are analytic over all N clients on every rank, so they are
bitwise the single-device engine's with no communication.

Baselines get the same treatment in `repro_torch.api.baseline`
(FleetFedAvgEngine / FleetLargeBatchEngine); `Plan(fleet=FleetSpec(...))`
routes every mode here.
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any

import torch

from repro_torch.core.accounting import to_meta
from repro_torch.core.wire_compress import PackedInt8, payload_nbytes
from repro_torch.engine.engine import RoundEngine
from repro_torch.engine.program import _round_robin, run_parallel, tree_at
from repro_torch.launch.mesh import make_fleet_mesh
from repro_torch.nn.dist import (tree_all_gather, tree_ppermute, tree_psum,
                                 tree_replicate_from)
from repro_torch.nn.module import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class FleetSpec:
    """How to lay a Plan's client fleet onto ranks.

    n_devices          — client-axis size, one rank a device (None = the
                         process group's world size); n_clients must
                         divide evenly.
    client_sharding    — "shard" partitions the stacked client axis;
                         "replicate" keeps every rank a full replica
                         (what the branch fan-in topologies force).
    server_replication — True keeps the server whole on every rank with
                         psum'd cut gradients (the SplitFed server is
                         small by construction).  False would shard the
                         server over the "model" axis — reserved, not
                         implemented yet.
    model_parallel     — size of the trailing "model" mesh axis
                         (reserved for server tensor parallelism).
    """
    n_devices: int | None = None
    client_sharding: str = "shard"          # "shard" | "replicate"
    server_replication: bool = True
    model_parallel: int = 1

    def __post_init__(self):
        if self.client_sharding not in ("shard", "replicate"):
            raise ValueError("client_sharding must be 'shard' or "
                             f"'replicate', got {self.client_sharding!r}")
        if not self.server_replication:
            raise NotImplementedError(
                "server_replication=False (server sharding over the "
                "'model' mesh axis) is reserved; the mesh already "
                "carries the axis but no engine consumes it yet")


class FleetMeshMixin:
    """What every fleet engine shares (`FleetRoundEngine` here, the
    sharded baselines in `repro_torch.api.baseline`): the mesh from the
    spec, the even division of the clients, the rank's slice of a
    client-stacked tree, the gather back, and the sum over the ranks that
    the client means reduce through.  Expects dataclass fields `fleet`,
    `mesh`, `device` and `n_clients`."""

    def _fleet_setup(self, *, force_replicate: bool = False):
        if self.fleet is None:
            self.fleet = FleetSpec()
        if self.mesh is None:
            self.mesh = make_fleet_mesh(
                self.fleet.n_devices,
                model_parallel=self.fleet.model_parallel, device=self.device)
        ax = self.mesh.axis_names[0]
        self._replicated = (force_replicate
                            or self.fleet.client_sharding == "replicate")
        self._n_shards = 1 if self._replicated else int(self.mesh.shape[ax])
        if self.n_clients % self._n_shards:
            raise ValueError(
                f"n_clients={self.n_clients} must divide evenly over the "
                f"{self._n_shards}-way client mesh axis (pass "
                "FleetSpec(n_devices=...) or resize the fleet)")
        self._n_local = self.n_clients // self._n_shards
        self._offset = 0 if self._replicated else \
            self.mesh.rank * self._n_local
        if not self._replicated:
            self._allreduce = partial(tree_psum, mesh=self.mesh)

    def _local(self, tree):
        """The rank's slice of a tree stacked over the whole client axis
        (copied, so the whole stack can be freed), or `tree` itself where
        its leading axis already is the rank's (idempotent)."""
        n = tree_leaves(tree)[0].shape[0]
        if n == self._n_local:
            return tree
        if n != self.n_clients:
            raise ValueError(f"a client axis of {n}: neither the fleet's "
                             f"{self.n_clients} nor the rank's "
                             f"{self._n_local}")
        lo = self._offset
        return tree_map(lambda a: a[lo:lo + self._n_local].clone(), tree)

    def _gather(self, tree):
        """The whole client axis on every rank from each rank's share."""
        return tree if self._replicated else tree_all_gather(tree, self.mesh)


@dataclasses.dataclass
class FleetRoundEngine(FleetMeshMixin, RoundEngine):
    """`RoundEngine` with the stacked client axis sharded over the ranks.

    Drop-in: same state layout (the rank's slice of `clients` and
    `opt_c`), same `run_round/turn_cost/evaluate/meter` surface, bitwise
    the single-device engine at D=1 (tests/test_torch_fleet.py).  The
    losses a round returns, and `evaluate_all`, cover all N clients on
    every rank."""
    fleet: FleetSpec | None = None
    mesh: Any = None
    device: Any = None

    def __post_init__(self):
        if self.schedule == "pipelined":
            raise NotImplementedError(
                "the pipelined schedule is single-mesh only, as in the "
                "reference (no double-buffered cut across the ring); use "
                "schedule='parallel' with fleet=")
        self._fleet_setup(force_replicate=self.topology.parallel_only)
        super().__post_init__()
        if not self._replicated:
            self._ctx = dataclasses.replace(self._ctx,
                                            allreduce=self._allreduce)
        self.ring_hops: list = []       # the last round's handoff hops
        self._handoff_like = None       # (packed meta, transport, bytes)

    # ---- state -------------------------------------------------------------

    def shard_state(self, state: dict) -> dict:
        """The rank's slice of `clients` and `opt_c`; the server side is
        whole on every rank.  Idempotent: safe on restored checkpoints."""
        return {**state, "clients": self._local(state["clients"]),
                "opt_c": self._local(state["opt_c"])}

    def gather_state(self, state: dict) -> dict:
        """The whole fleet's state on every rank (a collective)."""
        return {**state, "clients": self._gather(state["clients"]),
                "opt_c": self._gather(state["opt_c"])}

    def init(self, gen: torch.Generator, *, identical_clients: bool = True):
        return self.shard_state(
            super().init(gen, identical_clients=identical_clients))

    # ---- one round ---------------------------------------------------------

    def _round(self, state, batches):
        if self._replicated:
            return super()._round(state, batches)
        batches = self._local(batches)
        if self.schedule == "parallel":
            state, losses = run_parallel(self.program, self._ctx, state,
                                         batches)
        else:
            state, losses = self._ring_round(state, batches)
        return state, self._gather(losses)

    def _pack(self, tree):
        return self.wire_stack.handoff_pack(tree) if self._wire_handoff \
            else tree

    def _unpack(self, flat, like):
        """The adopted handoff from the tensors that crossed (`like`: the
        packed meta template)."""
        packed = tree_map(
            lambda p, t: PackedInt8(*t, p.orig_dtype)
            if isinstance(p, PackedInt8) else t, like, flat)
        return self.wire_stack.handoff_unpack(packed) if self._wire_handoff \
            else packed

    def _ring_round(self, state, batches):
        """The round-robin round as D phases over the ring; see the module
        docstring.  Every rank walks the same hops in the same order (a
        hop passes a rank it does not touch at once); `ring_hops` lists
        each handoff hop's (src, dst, bytes)."""
        mesh, me, n_local = self.mesh, self.mesh.rank, self._n_local
        d_last = self._n_shards - 1
        sync = self.sync == "p2p" and self.n_clients > 1
        if self._handoff_like is None:
            # the template a rank receives a handoff into: one client's
            # leaves packed on meta tensors, once per engine (meta ops
            # cost host time: 9-10 ms for VGG-16's four client leaves on
            # an H100's host, `chip_fleet.py`)
            packed = self._pack(to_meta(tree_at(state["clients"], 0)))
            flat = _transport(packed)
            self._handoff_like = (packed, flat, sum(
                payload_nbytes(t) for t in tree_leaves(flat)))
        like_packed, like, hop_bytes = self._handoff_like
        self.ring_hops = []

        def hop(src, dst, carry, clients, client):
            """`carry`, and under p2p the handoff of rank `src`'s local
            client `client` packed at the source, from `src` to `dst`.
            Returns (carry, adopted handoff) on `dst`, (None, None)
            elsewhere."""
            out, want = carry, carry
            if sync:
                out += (_transport(self._pack(tree_at(clients, client)))
                        if me == src else like,)
                want += (like,)
                self.ring_hops.append((src, dst, hop_bytes))
            got = tree_ppermute(out, mesh, [(src, dst)], like=want)
            if got is None:
                return None, None
            return (got[:len(carry)],
                    self._unpack(got[-1], like_packed) if sync else None)

        arrived, losses = None, None
        last = int(state["last_trained"])
        if sync and last >= 0 and last // n_local:
            # the handoff entering the round: the last trained client's
            # weights, from the rank that holds them to rank 0
            owner = last // n_local
            _, arrived = hop(owner, 0, (), state["clients"],
                             last - owner * n_local)
        for d in range(d_last + 1):
            if me == d:
                state, losses = _round_robin(
                    self.program.topology.turn_grads, self._ctx, state,
                    batches, offset=me * n_local, arrived=arrived)
            if d < d_last:
                carry, handoff = hop(
                    d, d + 1, (state["server"], state["opt_s"],
                               state["last_trained"]),
                    state["clients"], n_local - 1)
                if carry is not None:
                    state = {**state, "server": carry[0],
                             "opt_s": carry[1], "last_trained": carry[2]}
                    arrived = handoff
        server, opt_s, last_t = tree_replicate_from(
            (state["server"], state["opt_s"], state["last_trained"]), mesh,
            d_last)
        return {**state, "server": server, "opt_s": opt_s,
                "last_trained": last_t}, losses

    # ---- evaluation ----------------------------------------------------------

    def client_params(self, state, client: int):
        """Client `client`'s parameters on every rank (from its owner)."""
        if self._replicated:
            return super().client_params(state, client)
        owner, li = divmod(client, self._n_local)
        mine = tree_at(state["clients"], li if owner == self.mesh.rank
                       else 0)
        return tree_replicate_from(mine, self.mesh, owner)

    @torch.no_grad()
    def evaluate(self, state, batch, *, client: int = 0):
        """Client `client`'s accuracy, computed on its rank and broadcast."""
        if self._replicated:
            return super().evaluate(state, batch, client=client)
        owner, li = divmod(client, self._n_local)
        acc = (super().evaluate(state, batch, client=li)
               if owner == self.mesh.rank
               else torch.zeros((), device=self.mesh.device))
        return tree_replicate_from(acc, self.mesh, owner)

    def evaluate_all(self, state, batch):
        """(n_clients,) accuracies on every rank: each rank scores its own
        clients, then one all-gather."""
        if self._replicated:
            return super().evaluate_all(state, batch)
        return self._gather(torch.stack([
            RoundEngine.evaluate(self, state, batch, client=i)
            for i in range(self._n_local)]))


def _transport(tree):
    """A handoff tree as the tensors that cross a hop: a packed leaf as
    its (q, scale) pair."""
    return tree_map(lambda p: (p.q, p.scale) if isinstance(p, PackedInt8)
                    else p, tree)


__all__ = ["FleetSpec", "FleetRoundEngine", "FleetMeshMixin"]
