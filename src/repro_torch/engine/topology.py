"""Declarative split-learning topologies and their lowering onto the
step-program IR (port of `repro/engine/topology.py:57-572`).

A `Topology` names where the cut(s) fall and lowers onto the grad
functions in `repro_torch.core.split`; it owns no scheduling.  The
`RoundEngine` consumes

    init(gen)                           -> (client_params, server_params)
    turn_grads(pc, ps, batch, lf)       -> (loss, g_client, g_server)
    turn_grads_wires(..., wires)        -> same, appending WireRecords
    round_grads(clients, ps, batch, lf) -> (loss, stacked g_clients, g_s)

the turn kinds through `turn_grads`, one client at a time; the branch
fan-in kinds through `round_grads`, all clients in one step.  The turn
kinds also attach the staged form of one turn that the pipelined
executor streams microbatch by microbatch:

    pipeline_fwd(pc, batch)                   -> the client's first act
    pipeline_rest(pc, ps, act, batch, lf, wires)
                                -> (loss, g_rest, g_server, g_act)
    pipeline_bwd(pc, batch, g_act, g_rest)    -> g_client

`rest` is everything past the first crossing (the server, and the
u-shaped client's tail, whose gradient comes back in `g_rest`); `bwd`
rematerializes the client's forward and pulls the received cut gradient
back through it.  `lower()` turns a Topology into the `StepProgram` the
executors interpret; `lower_baseline()` does the same for the fedavg and
large_batch comparison modes.  The six paper configurations (Gupta &
Raskar §3; Ceballos et al. 2020 for vertical; Fig. 4 for multi-hop /
extended / multi-task):

  vanilla          client [0, cut), server [cut, L) + loss
  u_shaped         client head + tail + loss, server mid; labels never
                   cross
  vertical         K modality branches -> concat -> server trunk
  multihop         a chain of slabs; the client owns the first, the
                   relay slabs and the loss are the server side
  multitask        K modality branches -> concat -> T server heads
  extended_vanilla K modality branches -> concat -> an intermediate
                   client -> server trunk

`vanilla_fns` is the vanilla kind over opaque client and server
functions (the LM family's `apply_client` / `apply_server`) instead of a
SegModel.
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
    # the staged turn (pipelined executor); turn kinds only
    pipeline_fwd: Callable | None = None   # (pc, batch) -> act
    # (pc, ps, act, batch, loss_fn, wires) -> (loss, g_rest, g_s, g_act)
    pipeline_rest: Callable | None = None
    pipeline_bwd: Callable | None = None   # (pc, batch, g_act, g_rest) -> g_c

    @property
    def parallel_only(self) -> bool:
        return self.round_grads is not None


def lower(topology: Topology) -> ir.StepProgram:
    """Topology -> the one `StepProgram` every executor interprets."""
    branch = topology.parallel_only
    return ir.StepProgram(
        kind=topology.kind, round_type="branch" if branch else "turn",
        steps=tuple(topology.steps), topology=topology,
        split_batch=(ir.split_branch_batch if branch
                     else ir.split_turn_batch))


def lower_baseline(mode: str, *, local_steps: int = 1) -> ir.StepProgram:
    """The comparison baselines' step programs: no cut, the whole model
    (or its gradient) is the wire payload, priced on the `WeightHandoff`
    edges by the same middleware stack."""
    if mode == "fedavg":
        steps = (ir.WeightHandoff(name="model_pull", direction="down"),
                 ir.ClientFwd(stage="local", repeats=local_steps),
                 ir.ClientBwd(stage="local"),
                 ir.WeightHandoff(name="model_push", direction="up"),
                 ir.Aggregate(what="mean_models"))
    elif mode == "large_batch":
        steps = (ir.WeightHandoff(name="model_pull", direction="down"),
                 ir.ClientFwd(stage="full"),
                 ir.ClientBwd(stage="full"),
                 ir.WeightHandoff(name="grad_push", direction="up"),
                 ir.Aggregate(what="mean_grads"))
    else:
        raise ValueError(f"unknown baseline mode {mode!r}")
    return ir.StepProgram(kind=mode, round_type=mode, steps=steps)


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


def _remat_grads(fwd: Callable, params, g_out):
    """A staged client backward: `fwd` rerun on fresh leaves of `params`,
    and the received gradient `g_out` pulled back through it."""
    with torch.enable_grad():
        p = sp._leaf_params(params)
        return sp._grads(fwd(p), p, g_out)


def _branch_features(branch, n_clients, clients, batch):
    """Every branch's features on its modality, concatenated."""
    return torch.cat([branch.apply(pc, batch["x"][i]) for i, pc in
                      enumerate(unstack_tree(clients, n_clients))], dim=-1)


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
    """Client segments [0, cut), server [cut, L) and the loss:
    `vanilla_fns` over the segments.  Batch layout per turn: {"x": (B,
    ...), "labels": (B,)}."""
    return vanilla_fns(
        model.init,
        lambda full: (model.param_slice(full, 0, cut),
                      model.param_slice(full, cut, model.n_segments)),
        lambda pc, batch: model.apply_range(pc, batch["x"], 0, cut),
        lambda ps, a: sp.server_apply(model, cut, ps, a))


def vanilla_fns(init_full: Callable, split: Callable, client_apply: Callable,
                server_apply: Callable) -> Topology:
    """Vanilla topology over opaque client/server apply functions (the
    `models.lm.LM` split hooks, or a SegModel's segments): the wire
    protocol of `core.split.cut_split_grads`, where only the cut
    activation (up) and its gradient (down) cross.  Batch layout per
    turn: what `client_apply` reads, plus "labels" for the loss (an LM's
    {"tokens": (B, S), "labels": (B, S)})."""
    def init(gen):
        return split(init_full(gen))

    def pipeline_rest(pc, ps, act, batch, loss_fn, wires):
        loss, g_s, g_act = sp.cut_rest(server_apply, ps, act,
                                       batch["labels"], loss_fn, wires)
        return loss, {}, g_s, g_act

    def turn_grads_wires(pc, ps, batch, loss_fn, wires):
        loss, g_c, g_s, _ = sp.cut_split_grads(
            client_apply, server_apply, pc, ps, batch, batch["labels"],
            loss_fn, wires)
        return loss, g_c, g_s

    def evaluate(pc, ps, batch):
        return server_apply(ps, client_apply(pc, batch))

    def pipeline_bwd(pc, batch, g_act, g_rest):
        return _remat_grads(lambda p: client_apply(p, batch), pc, g_act)

    return Topology(kind="vanilla", init=init,
                    turn_grads=_drop_wires(turn_grads_wires),
                    turn_grads_wires=turn_grads_wires, evaluate=evaluate,
                    client_fwd=client_apply, steps=VANILLA_STEPS,
                    pipeline_fwd=client_apply, pipeline_rest=pipeline_rest,
                    pipeline_bwd=pipeline_bwd)


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
        return trunk_apply(ps, _branch_features(branch, n_clients, clients,
                                                batch))

    steps = (_branch_fanin_steps(n_clients)
             + (ir.ServerFwdBwd(stage="trunk"),)
             + _branch_fanout_steps(n_clients))
    return Topology(kind="vertical", init=init,
                    turn_grads_wires=round_grads_wires,
                    evaluate=evaluate, round_grads=round_grads,
                    client_fwd=lambda pc, b: branch.apply(pc, b["x"][0]),
                    steps=steps)


# ---------------------------------------------------------------------------
# u-shaped (label-private)
# ---------------------------------------------------------------------------

def u_shaped(model: sp.SegModel, cut1: int, cut2: int) -> Topology:
    """Client head [0, cut1) and tail [cut2, L) with the loss, server mid
    [cut1, cut2).  The client tree is {"head", "tail"}, so the p2p
    handoff squeezes both."""
    def init(gen):
        full = model.init(gen)
        client = {"head": model.param_slice(full, 0, cut1),
                  "tail": model.param_slice(full, cut2, model.n_segments)}
        return client, model.param_slice(full, cut1, cut2)

    def turn_grads_wires(pc, ps, batch, loss_fn, wires):
        loss, g_head, g_mid, g_tail, _ = sp.u_shaped_grads(
            model, cut1, cut2, pc["head"], ps, pc["tail"], batch["x"],
            batch["labels"], loss_fn, wires)
        return loss, {"head": g_head, "tail": g_tail}, g_mid

    def head_fwd(pc, batch):
        return model.apply_range(pc["head"], batch["x"], 0, cut1)

    def evaluate(pc, ps, batch):
        act = sp._apply_mid(model, ps, head_fwd(pc, batch), cut1, cut2)
        return sp._apply_tail(model, pc["tail"], act, cut2)

    def pipeline_rest(pc, ps, act1, batch, loss_fn, wires):
        loss, g_mid, g_tail, g_act1 = sp.u_shaped_rest(
            model, cut1, cut2, ps, pc["tail"], act1, batch["labels"],
            loss_fn, wires)
        return loss, {"tail": g_tail}, g_mid, g_act1

    def pipeline_bwd(pc, batch, g_act1, g_rest):
        g_head = _remat_grads(
            lambda p: model.apply_range(p, batch["x"], 0, cut1), pc["head"],
            g_act1)
        return {"head": g_head, "tail": g_rest["tail"]}

    steps = _turn_steps(
        ir.ClientFwd(stage="head"),
        ir.SendCut(name="cut_act_1", direction="up"),
        ir.ServerFwdBwd(stage="mid"),
        ir.SendCut(name="cut_act_2", direction="down"),
        ir.ClientFwd(stage="tail"),
        ir.ClientBwd(stage="tail"),
        ir.RecvGrad(name="cut_grad_2", direction="up"),
        ir.RecvGrad(name="cut_grad_1", direction="down"),
        ir.ClientBwd(stage="head"))

    # client_fwd=None: the client share is head + tail, and the tail's
    # forward needs the server's activation, which a (pc, batch) probe
    # cannot see; the meter bills 0 client FLOPs, as the reference does
    return Topology(kind="u_shaped", init=init,
                    turn_grads=_drop_wires(turn_grads_wires),
                    turn_grads_wires=turn_grads_wires, evaluate=evaluate,
                    steps=steps, pipeline_fwd=head_fwd,
                    pipeline_rest=pipeline_rest, pipeline_bwd=pipeline_bwd)


# ---------------------------------------------------------------------------
# multi-hop (Tor-like)
# ---------------------------------------------------------------------------

def multihop(model: sp.SegModel, cuts: list) -> Topology:
    """Slab chain [0, c0) | [c0, c1) | ... | [c_last, L).  The data client
    owns the first slab; the relay slabs and the loss are the server side
    (a tuple of slab trees), so N data clients round-robin against the
    shared chain.  Relay crossings go over the wire but are billed to no
    data client."""
    cuts = list(cuts)
    bounds = [0] + cuts + [model.n_segments]

    def init(gen):
        full = model.init(gen)
        slabs = [model.param_slice(full, bounds[i], bounds[i + 1])
                 for i in range(len(bounds) - 1)]
        return slabs[0], tuple(slabs[1:])

    def turn_grads_wires(pc, ps, batch, loss_fn, wires):
        loss, grads, _ = sp.multihop_grads(
            model, cuts, [pc] + list(ps), batch["x"], batch["labels"],
            loss_fn, wires)
        return loss, grads[0], tuple(grads[1:])

    def client_fwd(pc, batch):
        return model.apply_range(pc, batch["x"], 0, cuts[0])

    def evaluate(pc, ps, batch):
        act = batch["x"]
        for i, slab in enumerate([pc] + list(ps)):
            act = sp._apply_hop(model, slab, act, bounds[i], bounds[i + 1])
        return act

    def pipeline_rest(pc, ps, act, batch, loss_fn, wires):
        loss, g_chain, g_act = sp.multihop_rest(
            model, cuts, list(ps), act, batch["labels"], loss_fn, wires)
        return loss, {}, tuple(g_chain), g_act

    def pipeline_bwd(pc, batch, g_act, g_rest):
        return _remat_grads(lambda p: client_fwd(p, batch), pc, g_act)

    n_relay = len(cuts) - 1
    steps = _turn_steps(
        ir.ClientFwd(stage="hop_0"),
        ir.SendCut(name="hop_0_act", direction="up"),
        *[ir.SendCut(name=f"hop_{i}_act", direction="up", owner="server")
          for i in range(1, n_relay + 1)],
        ir.ServerFwdBwd(stage="chain"),
        *[ir.RecvGrad(name=f"hop_{i}_grad", direction="down",
                      owner="server")
          for i in reversed(range(1, n_relay + 1))],
        ir.RecvGrad(name="hop_0_grad", direction="down"),
        ir.ClientBwd(stage="hop_0"))
    return Topology(kind="multihop", init=init,
                    turn_grads=_drop_wires(turn_grads_wires),
                    turn_grads_wires=turn_grads_wires, evaluate=evaluate,
                    client_fwd=client_fwd, steps=steps,
                    pipeline_fwd=client_fwd, pipeline_rest=pipeline_rest,
                    pipeline_bwd=pipeline_bwd)


# ---------------------------------------------------------------------------
# multi-task (paper §5.1 Fig. 4b, parallel-only)
# ---------------------------------------------------------------------------

def multitask(branch: sp.Branch, n_clients: int, head_inits: list,
              head_applies: list) -> Topology:
    """K clients each hold one modality branch; the server concatenates
    the features and trains T task heads, each with its own labels.  The
    reported loss is the mean over tasks; the branch gradient is the SUM
    over tasks (`core.split.multitask_grads`).

    Batch layout: {"x": (K, B, ...), "labels": (T, B)}, labels[t] task
    t's targets (server-held)."""
    n_tasks = len(head_inits)

    def init(gen):
        kb, *kh = split_keys(gen, 1 + n_tasks)
        return branch.init(kb), tuple(hi(k) for hi, k in zip(head_inits, kh))

    def round_grads_wires(clients, ps, batch, loss_fn, wires):
        params_list = unstack_tree(clients, n_clients)
        xs = [batch["x"][i] for i in range(n_clients)]
        labels = [batch["labels"][t] for t in range(n_tasks)]
        losses, g_branches, g_heads, _ = sp.multitask_grads(
            [branch] * n_clients, params_list, head_applies, list(ps), xs,
            labels, [loss_fn] * n_tasks, wires)
        return losses.mean(), stack_trees(g_branches), tuple(g_heads)

    def round_grads(clients, ps, batch, loss_fn):
        return round_grads_wires(clients, ps, batch, loss_fn, [])

    def evaluate(clients, ps, batch):
        feats = _branch_features(branch, n_clients, clients, batch)
        # (T, B, C): the engine's accuracy compares with (T, B) labels
        return torch.stack([h(p, feats) for h, p in zip(head_applies, ps)])

    steps = (_branch_fanin_steps(n_clients)
             + (ir.ServerFwdBwd(stage="heads"),
                ir.Aggregate(what="sum_task_grads"))
             + _branch_fanout_steps(n_clients))
    return Topology(kind="multitask", init=init,
                    turn_grads_wires=round_grads_wires, evaluate=evaluate,
                    round_grads=round_grads,
                    client_fwd=lambda pc, b: branch.apply(pc, b["x"][0]),
                    steps=steps)


# ---------------------------------------------------------------------------
# extended vanilla (paper §5.1 Fig. 4a, parallel-only)
# ---------------------------------------------------------------------------

def extended_vanilla(branch: sp.Branch, n_clients: int, mid_init: Callable,
                     mid_apply: Callable, trunk_init: Callable,
                     trunk_apply: Callable) -> Topology:
    """Like `vertical`, but the concatenated features pass through an
    INTERMEDIATE client's network before the server trunk.  The mid and
    trunk parameters live on the engine's server side as {"mid",
    "trunk"}; the `mid_act` / `mid_grad` crossings are the intermediate
    client's traffic, billed to none of the K data clients.

    Batch layout: {"x": (K, B, ...), "labels": (B,)}."""
    def init(gen):
        kb, km, kt = split_keys(gen, 3)
        return branch.init(kb), {"mid": mid_init(km),
                                 "trunk": trunk_init(kt)}

    def round_grads_wires(clients, ps, batch, loss_fn, wires):
        params_list = unstack_tree(clients, n_clients)
        xs = [batch["x"][i] for i in range(n_clients)]
        loss, g_branches, g_mid, g_trunk, _ = sp.extended_vanilla_grads(
            [branch] * n_clients, params_list, mid_apply, ps["mid"],
            trunk_apply, ps["trunk"], xs, batch["labels"], loss_fn, wires)
        return loss, stack_trees(g_branches), {"mid": g_mid,
                                               "trunk": g_trunk}

    def round_grads(clients, ps, batch, loss_fn):
        return round_grads_wires(clients, ps, batch, loss_fn, [])

    def evaluate(clients, ps, batch):
        feats = _branch_features(branch, n_clients, clients, batch)
        return trunk_apply(ps["trunk"], mid_apply(ps["mid"], feats))

    steps = (_branch_fanin_steps(n_clients)
             + (ir.ClientFwd(stage="mid"),
                ir.SendCut(name="mid_act", direction="up", owner="mid"),
                ir.ServerFwdBwd(stage="trunk"),
                ir.RecvGrad(name="mid_grad", direction="down", owner="mid"),
                ir.ClientBwd(stage="mid"))
             + _branch_fanout_steps(n_clients))
    return Topology(kind="extended_vanilla", init=init,
                    turn_grads_wires=round_grads_wires, evaluate=evaluate,
                    round_grads=round_grads,
                    client_fwd=lambda pc, b: branch.apply(pc, b["x"][0]),
                    steps=steps)
