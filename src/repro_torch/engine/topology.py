"""Declarative split-learning topologies and their lowering onto the
step-program IR (port of `repro/engine/topology.py:57-139, 330-382`).

A `Topology` names where the cut falls and lowers onto the grad
functions in `repro_torch.core.split`; it owns no scheduling.  For the
branch fan-in kinds the `RoundEngine` consumes

    init(gen)                          -> (client_params, server_params)
    round_grads(clients, ps, batch, lf) -> (loss, stacked g_clients, g_s)
    turn_grads_wires(..., wires)       -> same, appending WireRecords

`lower()` turns a Topology into the `StepProgram` the executors
interpret.  This slice ports the vertical (multi-modal) topology; the
other five kinds come with later slices (ROADMAP).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.core import split as sp
from repro_torch.engine import program as ir
from repro_torch.engine.program import stack_trees, unstack_tree
from repro_torch.nn.module import split_keys


@dataclasses.dataclass(frozen=True)
class Topology:
    kind: str
    init: Callable                # gen -> (client_params, server_params)
    # (clients, ps, batch, loss_fn, wires) -> (loss, g_c, g_s), appending
    # the crossings' WireRecords to `wires`
    turn_grads_wires: Callable
    evaluate: Callable | None = None   # (pc, ps, batch) -> logits
    client_fwd: Callable | None = None  # (pc, batch) -> first outbound act
    # branch kinds: all clients contribute to ONE step
    round_grads: Callable | None = None  # (clients, ps, batch, loss_fn)
    # the step-sequence IR this topology lowers to
    steps: tuple = ()

    @property
    def parallel_only(self) -> bool:
        return self.round_grads is not None


def lower(topology: Topology) -> ir.StepProgram:
    """Topology -> the one `StepProgram` every executor interprets."""
    return ir.StepProgram(
        kind=topology.kind,
        round_type="branch" if topology.parallel_only else "turn",
        steps=tuple(topology.steps), topology=topology)


def _branch_fanin_steps(n_clients: int) -> tuple:
    """The K branch forwards + their billed wire edges (branch kinds)."""
    out = []
    for i in range(n_clients):
        out += [ir.ClientFwd(stage=f"branch_{i}", client=i),
                ir.SendCut(name=f"branch_{i}_act", direction="up",
                           client=i)]
    return tuple(out) + (ir.Aggregate(what="concat_features"),)


def _branch_fanout_steps(n_clients: int) -> tuple:
    out = []
    for i in range(n_clients):
        out += [ir.RecvGrad(name=f"branch_{i}_grad", direction="down",
                            client=i),
                ir.ClientBwd(stage=f"branch_{i}", client=i)]
    return tuple(out) + (ir.Aggregate(what="step"),)


# ---------------------------------------------------------------------------
# vertical (multi-modal, parallel-only)
# ---------------------------------------------------------------------------

def vertical(branch: sp.Branch, n_clients: int, trunk_init: Callable,
             trunk_apply: Callable) -> Topology:
    """K clients each hold one modality and one (structurally identical)
    feature branch; the server concatenates features into the trunk.
    Every step needs all branches, so there is no turn axis.

    Batch layout: {"x": (K, B, ...), "labels": (B,)} — modality i at
    x[i], labels aligned across clients (server-held)."""
    def init(gen):
        kb, kt = split_keys(gen, 2)
        return branch.init(kb), trunk_init(kt)

    def round_grads_wires(clients, ps, batch, loss_fn, wires):
        params_list = unstack_tree(clients, n_clients)
        xs = [batch["x"][i] for i in range(n_clients)]
        loss, g_branches, g_trunk, _ = sp.vertical_split_grads(
            [branch] * n_clients, params_list, trunk_apply, ps, xs,
            batch["labels"], loss_fn, wires)
        return loss, stack_trees(g_branches), g_trunk

    def round_grads(clients, ps, batch, loss_fn):
        return round_grads_wires(clients, ps, batch, loss_fn, [])

    def evaluate(clients, ps, batch):
        feats = [branch.apply(pc, batch["x"][i]) for i, pc in
                 enumerate(unstack_tree(clients, n_clients))]
        return trunk_apply(ps, torch.cat(feats, dim=-1))

    steps = (_branch_fanin_steps(n_clients)
             + (ir.ServerFwdBwd(stage="trunk"),)
             + _branch_fanout_steps(n_clients))
    return Topology(kind="vertical", init=init,
                    turn_grads_wires=round_grads_wires,
                    evaluate=evaluate, round_grads=round_grads,
                    client_fwd=lambda pc, b: branch.apply(pc, b["x"][0]),
                    steps=steps)
