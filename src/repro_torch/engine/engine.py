"""Multi-client round engine — an executor selection over the
step-program IR (port of `repro/engine/engine.py:56-233`).

The engine stacks the N client trees along a leading client axis and
runs ONE round per call.  The topology lowers to a `StepProgram` once;
`schedule=` picks the interpreter for the turn kinds:

  schedule="round_robin" (or "serial") — `program.run_serial`, the
      paper's serial round-robin with the p2p weight handoff;
  schedule="parallel" — `program.run_parallel`, SplitFed: every client's
      turn against the same server, which steps on the mean cut
      gradient; no handoff;
  schedule="pipelined" — `program.run_pipelined`, the round-robin with
      each client batch streamed through the cut as `microbatches`
      microbatches; M=1 is the serial math.

Branch fan-in topologies (vertical, multitask, extended_vanilla) have no
turn axis; their joint round runs through `program.run_branch`, or
`program.run_branch_pipelined` under the pipelined schedule with M > 1.
The baselines (fedavg, large_batch) have engines of their own
(`repro_torch.api.baseline`).

Resource accounting: wire shapes are static per (topology, batch shape),
so the engine probes the wire records ONCE per batch shape on meta
tensors (`accounting.probe_wire_records`) and then bills each round
analytically.  WHICH crossings each client pays for is read off the
program's `SendCut`/`RecvGrad` edges (`program.billed_wires`); the p2p
handoff is billed to each client that received one (round-robin and
pipelined).  Wire bytes do not depend on the microbatch count: M
payloads of B/M rows carry the bytes of one of B rows.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.core.accounting import (Meter, TurnCost, bytes_of_tree,
                                         flops_of_fn, probe_wire_records)
from repro_torch.engine.program import (EXECUTORS, ExecContext, run_branch,
                                        run_branch_pipelined, stack_trees,
                                        tree_at)
from repro_torch.engine.topology import Topology, lower
from repro_torch.nn.module import split_keys

SCHEDULES = ("round_robin", "parallel", "pipelined")


@dataclasses.dataclass
class RoundEngine:
    """One training round over N split-learning clients."""
    topology: Topology
    loss_fn: Callable
    optimizer_client: Any
    optimizer_server: Any
    n_clients: int
    schedule: str = "round_robin"
    sync: str = "p2p"                   # "p2p" | "none" (serial, pipelined)
    wire_stack: Any = None              # api.wire.WireStack | None
    microbatches: int = 1               # pipelined schedule only

    def __post_init__(self):
        if self.schedule == "serial":       # IR executor name, accepted
            self.schedule = "round_robin"
        if self.schedule not in SCHEDULES:
            raise ValueError(f"schedule must be one of {SCHEDULES}")
        if self.topology.parallel_only and self.schedule == "round_robin":
            raise ValueError(f"{self.topology.kind} topology is parallel-only")
        if self.microbatches < 1:
            raise ValueError("microbatches must be >= 1")
        if self.microbatches > 1 and self.schedule != "pipelined":
            raise ValueError("microbatches > 1 requires "
                             "schedule='pipelined'")
        if (self.schedule == "pipelined"
                and not self.topology.parallel_only
                and self.topology.pipeline_fwd is None):
            raise ValueError(
                f"{self.topology.kind} topology exposes no staged turn "
                "(pipeline_fwd/rest/bwd): pipelined schedule unavailable")
        self.meter = Meter(self.n_clients)
        self._turn_costs: dict = {}     # batch-shape key -> TurnCost
        self._wire_handoff = bool(self.wire_stack is not None
                                  and self.wire_stack.has_handoff)
        self.program = lower(self.topology)
        self._ctx = ExecContext(
            n_clients=self.n_clients, sync=self.sync, loss_fn=self.loss_fn,
            optimizer_client=self.optimizer_client,
            optimizer_server=self.optimizer_server,
            wire_stack=self.wire_stack, wire_handoff=self._wire_handoff,
            microbatches=self.microbatches)

    # ---- state ------------------------------------------------------------

    def init(self, gen: torch.Generator, *, identical_clients: bool = True):
        """Stacked engine state on the generator's device.
        identical_clients=True is the paper's setting: every client starts
        from one draw.  False gives each client its own draw and the
        server client 0's draw of the rest (modality branches are
        independent networks)."""
        if identical_clients:
            pc, ps = self.topology.init(gen)
            clients = stack_trees([pc] * self.n_clients)
        else:
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
        """batches: dict of (N, B, ...) tensors (turn kinds), or the branch
        layout {"x": (N, B, ...), "labels": (B,)} (shared labels).  Returns
        (state, per-turn losses (N,), or (1,) for a branch round) and
        meters the round."""
        first = int(state["last_trained"]) < 0
        self.turn_cost(state, batches)          # probe once per shape
        state, losses = self._round(state, batches)
        self._account_round(state, batches, first_round=first)
        return state, losses

    def _round(self, state, batches):
        """The round's executor over the program (the fleet engine runs
        it over its ranks instead)."""
        prog, ctx = self.program, self._ctx
        if prog.round_type != "branch":
            return EXECUTORS[self.schedule](prog, ctx, state, batches)
        if self.schedule == "pipelined" and self.microbatches > 1:
            return run_branch_pipelined(prog, ctx, state, batches)
        return run_branch(prog, ctx, state, batches)

    # ---- resource accounting ---------------------------------------------

    def turn_cost(self, state, batches) -> TurnCost:
        """Static `TurnCost` for this batch shape (a turn's, or a branch
        round's): one probe of the wire records and one FLOP count of the
        client forward, both on meta tensors, per shape."""
        key = tuple(sorted((k, tuple(v.shape), str(v.dtype))
                           for k, v in batches.items()))
        if key not in self._turn_costs:
            branch = self.topology.parallel_only
            one = batches if branch else {k: v[0] for k, v in batches.items()}
            pc = tree_at(state["clients"], 0)
            wires = probe_wire_records(
                lambda side, ps, b, w: self.topology.turn_grads_wires(
                    side, ps, b, self.loss_fn, w),
                state["clients"] if branch else pc, state["server"], one)
            flops = 0.0
            if self.topology.client_fwd is not None:
                flops = 3.0 * flops_of_fn(self.topology.client_fwd, pc, one)
            # the p2p handoff is wire traffic too: priced through the
            # stack's handoff transforms (int8 + row scales under
            # quantize_int8) instead of the dense parameter bytes
            sync_bytes = (self.wire_stack.handoff_bytes(pc)
                          if self._wire_handoff else bytes_of_tree(pc))
            self._turn_costs[key] = TurnCost(
                wires=tuple(wires), flops=flops, sync_bytes=sync_bytes)
        return self._turn_costs[key]

    def _account_round(self, state, batches, *, first_round: bool):
        """Bill the round from the program's wire edges: each client pays
        for the `SendCut`/`RecvGrad` steps whose `owner`/`client` metadata
        point at it, and under the round-robin and pipelined p2p schedules
        for every handoff it received (all but client 0's in the first
        round); the parallel schedule has no handoff."""
        cost = self.turn_cost(state, batches)
        by_name: dict = {}
        for w in cost.wires:
            by_name.setdefault(w.name, []).append(w)
        handoff = (self.program.round_type == "turn"
                   and self.schedule in ("round_robin", "pipelined")
                   and self.sync == "p2p" and self.n_clients > 1)
        for ci in range(self.n_clients):
            self.meter.add_flops(ci, cost.flops)
            self.meter.add_wires(ci, [
                w for name in self.program.billed_wires(ci)
                for w in by_name.get(name, ())])
            if handoff and not (first_round and ci == 0):
                self.meter.sync_bytes[ci] += cost.sync_bytes

    # ---- eval --------------------------------------------------------------

    def client_params(self, state, client: int):
        """Client `client`'s parameters (views of the stacked state)."""
        return tree_at(state["clients"], client)

    @torch.no_grad()
    def evaluate(self, state, batch, *, client: int = 0):
        """Accuracy on one batch (a 0-d tensor): of the joint fleet for
        the branch kinds, of client `client` with the server otherwise.
        Multitask logits (T, B, C) compare with (T, B) labels: the mean
        over tasks."""
        if self.topology.parallel_only:
            logits = self.topology.evaluate(state["clients"],
                                            state["server"], batch)
        else:
            logits = self.topology.evaluate(tree_at(state["clients"], client),
                                            state["server"], batch)
        return (logits.argmax(-1) == batch["labels"]).float().mean()

    def evaluate_all(self, state, batch):
        """Per-client accuracies, (n_clients,) for the turn kinds; the
        branch fan-in kinds have a single joint fleet: shape (1,)."""
        if self.topology.parallel_only:
            return self.evaluate(state, batch)[None]
        return torch.stack([self.evaluate(state, batch, client=ci)
                            for ci in range(self.n_clients)])
