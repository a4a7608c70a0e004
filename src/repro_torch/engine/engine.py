"""Multi-client round engine — an executor selection over the
step-program IR (port of `repro/engine/engine.py:56-233`, branch path).

The engine stacks the N client trees along a leading client axis and
runs ONE round per call.  The topology lowers to a `StepProgram` once;
branch fan-in topologies (vertical) run their joint round through
`program.run_branch`.  The turn topologies and their schedules
(round_robin / parallel / pipelined executors) come with the vanilla
slice (ROADMAP).

Resource accounting: wire shapes are static per (topology, batch shape),
so the engine probes the wire records ONCE per batch shape on meta
tensors (`accounting.probe_wire_records`) and then bills each round
analytically.  WHICH crossings each client pays for is read off the
program's `SendCut`/`RecvGrad` edges (`program.billed_wires`).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.core.accounting import (Meter, TurnCost, bytes_of_tree,
                                         flops_of_fn, probe_wire_records)
from repro_torch.engine.program import (ExecContext, run_branch, stack_trees,
                                        tree_at)
from repro_torch.engine.topology import Topology, lower
from repro_torch.nn.module import split_keys

@dataclasses.dataclass
class RoundEngine:
    """One training round over N split-learning clients."""
    topology: Topology
    loss_fn: Callable
    optimizer_client: Any
    optimizer_server: Any
    n_clients: int

    def __post_init__(self):
        if not self.topology.parallel_only:
            raise NotImplementedError(
                f"the {self.topology.kind} topology's turn schedules are "
                "not ported yet: this slice runs the branch fan-in round "
                "(vertical); see ROADMAP.md")
        self.meter = Meter(self.n_clients)
        self._turn_costs: dict = {}     # batch-shape key -> TurnCost
        self.program = lower(self.topology)
        self._ctx = ExecContext(
            n_clients=self.n_clients, loss_fn=self.loss_fn,
            optimizer_client=self.optimizer_client,
            optimizer_server=self.optimizer_server)

    # ---- state ------------------------------------------------------------

    def init(self, gen: torch.Generator):
        """Stacked engine state on the generator's device.  Each client
        draws its own init (modality branches are independent networks)
        and the server takes client 0's draw of the trunk, as the
        reference's `identical_clients=False` does."""
        inits = [self.topology.init(g)
                 for g in split_keys(gen, self.n_clients)]
        clients = stack_trees([pc for pc, _ in inits])
        ps = inits[0][1]
        opt_c = stack_trees(
            [self.optimizer_client.init(tree_at(clients, i))
             for i in range(self.n_clients)])
        return {"clients": clients, "server": ps,
                "opt_c": opt_c, "opt_s": self.optimizer_server.init(ps),
                "last_trained": torch.tensor(-1, dtype=torch.int32,
                                             device=gen.device)}

    # ---- one round ---------------------------------------------------------

    def run_round(self, state, batches):
        """batches: {"x": (N, B, ...), "labels": (B,)} (shared labels).
        Returns (state, losses (1,)) and meters the round."""
        self.turn_cost(state, batches)          # probe once per shape
        state, losses = run_branch(self.program, self._ctx, state, batches)
        self._account_round(state, batches)
        return state, losses

    # ---- resource accounting ---------------------------------------------

    def turn_cost(self, state, batches) -> TurnCost:
        """Static per-round `TurnCost` for this batch shape: one probe of
        the wire records and one FLOP count of the client forward, both
        on meta tensors, per shape."""
        key = tuple(sorted((k, tuple(v.shape), str(v.dtype))
                           for k, v in batches.items()))
        if key not in self._turn_costs:
            wires = probe_wire_records(
                lambda cl, ps, b, w: self.topology.turn_grads_wires(
                    cl, ps, b, self.loss_fn, w),
                state["clients"], state["server"], batches)
            flops = 0.0
            if self.topology.client_fwd is not None:
                flops = 3.0 * flops_of_fn(self.topology.client_fwd,
                                          tree_at(state["clients"], 0),
                                          batches)
            self._turn_costs[key] = TurnCost(
                wires=tuple(wires), flops=flops,
                sync_bytes=bytes_of_tree(state["clients"]) // self.n_clients)
        return self._turn_costs[key]

    def _account_round(self, state, batches):
        """Bill the round from the program's wire edges: each client
        pays for the `SendCut`/`RecvGrad` steps whose `owner`/`client`
        metadata point at it."""
        cost = self.turn_cost(state, batches)
        by_name: dict = {}
        for w in cost.wires:
            by_name.setdefault(w.name, []).append(w)
        for ci in range(self.n_clients):
            self.meter.add_flops(ci, cost.flops)
            self.meter.add_wires(ci, [
                w for name in self.program.billed_wires(ci)
                for w in by_name.get(name, ())])

    # ---- eval --------------------------------------------------------------

    @torch.no_grad()
    def evaluate(self, state, batch):
        """Accuracy of the joint fleet on one batch (a 0-d tensor)."""
        logits = self.topology.evaluate(state["clients"], state["server"],
                                        batch)
        return (logits.argmax(-1) == batch["labels"]).float().mean()

    def evaluate_all(self, state, batch):
        """Branch fan-in kinds have a single joint fleet: shape (1,)."""
        return self.evaluate(state, batch)[None]
