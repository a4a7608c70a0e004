"""Declarative split-learning topologies and their lowering onto the
step-program IR (port of `repro/engine/topology.py:57-208, 330-382`).

A `Topology` names where the cut falls and lowers onto the grad
functions in `repro_torch.core.split`; it owns no scheduling.  The
`RoundEngine` consumes

    init(gen)                           -> (client_params, server_params)
    turn_grads(pc, ps, batch, lf)       -> (loss, g_client, g_server)
    turn_grads_wires(..., wires)        -> same, appending WireRecords
    round_grads(clients, ps, batch, lf) -> (loss, stacked g_clients, g_s)

the turn kinds (vanilla) through `turn_grads`, one client at a time; the
branch fan-in kinds (vertical) through `round_grads`, all clients in one
step.  `lower()` turns a Topology into the `StepProgram` the executors
interpret.  This module ports the vanilla and vertical topologies; the
other four kinds, `vanilla_fns` and the staged `pipeline_*` turn come
with later slices (ROADMAP).
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
    # (pc or clients, ps, batch, loss_fn, wires) -> (loss, g_c, g_s),
    # appending the crossings' WireRecords to `wires`
    turn_grads_wires: Callable
    # turn kinds: (pc, ps, batch, loss_fn) -> (loss, g_c, g_s)
    turn_grads: Callable | None = None
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


def _turn_steps(*inner) -> tuple:
    """The shared turn-kind frame: the p2p handoff edge in, one optimizer
    step boundary out."""
    return ((ir.WeightHandoff(name="p2p_handoff", direction="p2p",
                              when="sync=p2p"),)
            + tuple(inner) + (ir.Aggregate(what="step"),))


def _drop_wires(turn_grads_wires):
    def turn_grads(pc, ps, batch, loss_fn):
        return turn_grads_wires(pc, ps, batch, loss_fn, [])
    return turn_grads


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
# vanilla
# ---------------------------------------------------------------------------

VANILLA_STEPS = _turn_steps(
    ir.ClientFwd(stage="client"),
    ir.SendCut(name="cut_act", direction="up"),
    ir.ServerFwdBwd(),
    ir.RecvGrad(name="cut_grad", direction="down"),
    ir.ClientBwd(stage="client"))


def vanilla(model: sp.SegModel, cut: int) -> Topology:
    """Client segments [0, cut), server [cut, L) and the loss.  Batch
    layout per turn: {"x": (B, ...), "labels": (B,)}."""
    def init(gen):
        full = model.init(gen)
        return (model.param_slice(full, 0, cut),
                model.param_slice(full, cut, model.n_segments))

    def turn_grads_wires(pc, ps, batch, loss_fn, wires):
        loss, g_c, g_s, _ = sp.vanilla_split_grads(
            model, cut, pc, ps, batch["x"], batch["labels"], loss_fn, wires)
        return loss, g_c, g_s

    def client_fwd(pc, batch):
        return model.apply_range(pc, batch["x"], 0, cut)

    def evaluate(pc, ps, batch):
        return sp.server_apply(model, cut, ps, client_fwd(pc, batch))

    return Topology(kind="vanilla", init=init,
                    turn_grads=_drop_wires(turn_grads_wires),
                    turn_grads_wires=turn_grads_wires, evaluate=evaluate,
                    client_fwd=client_fwd, steps=VANILLA_STEPS)


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
