"""The step-program IR (port of `repro/engine/program.py:53-249, 305-339,
360-390, 491-494`).

A Plan mode lowers (`repro_torch.engine.topology.lower`) into ONE
`StepProgram`: a typed sequence of `Step`s describing one logical client
turn or joint round, with the wire crossings (`SendCut` / `RecvGrad`)
and weight movements (`WeightHandoff`) as first-class edges.  Wire
middleware and `TurnCost` accounting attach to those edges:
`billed_wires` tells the meter which crossings each client pays for.

Executors interpret the program:

  run_serial — the paper's round-robin (turn kinds): a Python loop over
               the client turns, each adopting the last trained client's
               weights first (the p2p handoff, `sync="p2p"`);
  run_branch — the joint round of the branch fan-in kinds (vertical,
               multitask, extended_vanilla): every branch contributes to
               ONE step, and each party then steps its optimizer.

The parallel and pipelined executors come with a later slice (ROADMAP).

Engine state is a tree of tensors whose client entries are STACKED along
a leading client axis, as in the reference: `clients` and `opt_c` hold
(n_clients, ...) leaves.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.nn.module import tree_map
from repro_torch.optim import apply_updates

# ---------------------------------------------------------------------------
# stacked-tree helpers
# ---------------------------------------------------------------------------


def stack_trees(trees: list):
    """[tree] * N -> tree with a leading client axis on every leaf."""
    return tree_map(lambda *xs: torch.stack(xs), *trees)


def unstack_tree(tree, n: int) -> list:
    """Inverse of stack_trees: views of each client's slice."""
    return [tree_at(tree, i) for i in range(n)]


def tree_at(tree, i: int):
    """Client `i`'s slice of the leading client axis (views).  It also
    serves for the reference's `tree_index`: eager torch has no traced
    index to tell apart from a static one."""
    return tree_map(lambda a: a[i], tree)


def tree_update(tree, i: int, sub):
    """A new stacked tree whose client `i` slice is `sub`; `tree` keeps
    its values."""
    def put(a, s):
        out = a.clone()
        out[i] = s
        return out
    return tree_map(put, tree, sub)


def stack_batches(batches: list) -> dict:
    """[per-client batch dict] -> dict of (N, ...) tensors."""
    return {k: torch.stack([b[k] for b in batches]) for k in batches[0]}


def copy_tree(tree):
    """Leafwise copy: a state tree with its OWN storage."""
    return tree_map(torch.clone, tree)


# ---------------------------------------------------------------------------
# the typed steps
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Step:
    """One typed step of a round program."""

    def describe(self) -> str:
        name = type(self).__name__
        bits = [f"{f.name}={getattr(self, f.name)!r}"
                for f in dataclasses.fields(self)
                if getattr(self, f.name) != f.default]
        return f"{name}({', '.join(bits)})" if bits else name


@dataclasses.dataclass(frozen=True)
class ClientFwd(Step):
    """A client-side forward (`stage` names which client network)."""
    stage: str = "client"      # "client" | "head" | "tail" | "hop_0" | ...
    client: int | None = None  # branch index (branch kinds only)
    repeats: int = 1           # fedavg: local_steps full fwd/bwd passes


@dataclasses.dataclass(frozen=True)
class SendCut(Step):
    """An activation crossing the cut — a wire edge.  `name` is the
    `WireRecord` name the middleware stack and `TurnCost` price; `owner`
    says whose traffic it is ("client" = billed to the turn's client, or
    to branch client `client`; "server"/"mid" = peer-side relay,
    unbilled)."""
    name: str = "cut_act"
    direction: str = "up"
    owner: str = "client"
    client: int | None = None


@dataclasses.dataclass(frozen=True)
class RecvGrad(Step):
    """A cut-gradient crossing back — the matching wire edge."""
    name: str = "cut_grad"
    direction: str = "down"
    owner: str = "client"
    client: int | None = None


@dataclasses.dataclass(frozen=True)
class ServerFwdBwd(Step):
    """The server-side forward + backward between wire edges."""
    stage: str = "server"


@dataclasses.dataclass(frozen=True)
class ClientBwd(Step):
    """A client-side backward from a received cut gradient."""
    stage: str = "client"
    client: int | None = None


@dataclasses.dataclass(frozen=True)
class Aggregate(Step):
    """A cross-party reduction (feature concat, task-grad sum, model or
    gradient mean, optimizer step boundary)."""
    what: str = "step"


@dataclasses.dataclass(frozen=True)
class WeightHandoff(Step):
    """A whole-parameter-tree movement — the round-robin p2p handoff or
    a baseline's model pull/push — also a priced wire edge."""
    name: str = "p2p_handoff"
    direction: str = "p2p"
    when: str = "always"       # "sync=p2p": only under the p2p schedule


WIRE_STEPS = (SendCut, RecvGrad)


# ---------------------------------------------------------------------------
# the program
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class StepProgram:
    """One mode, lowered: the typed step sequence for a single logical
    turn (turn kinds) or joint round (branch kinds), plus the compute
    callables executors interpret."""
    kind: str
    round_type: str                # "turn" | "branch"
    steps: tuple
    topology: Any = None           # the (wire-wrapped) Topology

    def describe(self) -> tuple:
        """Compact step strings — the golden-test surface."""
        return tuple(s.describe() for s in self.steps)

    def wire_steps(self) -> tuple:
        return tuple(s for s in self.steps if isinstance(s, WIRE_STEPS))

    def handoff_steps(self) -> tuple:
        return tuple(s for s in self.steps if isinstance(s, WeightHandoff))

    def billed_wires(self, client: int) -> tuple:
        """Names of the wire crossings client `client` pays for — the
        accounting attachment point."""
        return tuple(
            s.name for s in self.wire_steps()
            if s.owner == "client" and s.client in (None, client))


@dataclasses.dataclass(frozen=True)
class ExecContext:
    """Everything an executor needs beyond the program: party count,
    sync policy, loss, optimizers and the wire stack."""
    n_clients: int
    sync: str
    loss_fn: Callable
    optimizer_client: Any
    optimizer_server: Any
    wire_stack: Any = None         # api.wire.WireStack | None
    wire_handoff: bool = False     # the stack squeezes the p2p handoff


# ---------------------------------------------------------------------------
# executors
# ---------------------------------------------------------------------------


def run_serial(program: StepProgram, ctx: ExecContext, state, batches):
    """Round-robin over the client turns: client `ci` trains on
    `batches[ci]` against the shared server, each party stepping its own
    optimizer, client `ci` on its own slice (so per-client rules such as
    AdamW's matrices-only decay see one client's shapes).  Under
    `sync="p2p"` a client first adopts the last trained client's weights,
    squeezed through the wire's handoff transforms.  Returns (state,
    per-turn losses (N,))."""
    topo = program.topology
    n = ctx.n_clients
    clients, opt_c = state["clients"], state["opt_c"]
    server, opt_s = state["server"], state["opt_s"]
    last = int(state["last_trained"])
    losses = []
    for ci in range(n):
        batch = {k: v[ci] for k, v in batches.items()}
        pc = tree_at(clients, ci)
        # the reference squeezes the last client's weights on every turn
        # and keeps them where `take` holds (a select under jit); here the
        # handoff runs only where it is taken, every turn but the very
        # first of the first round, with the same values, so the wire
        # kernels launch once per leaf per handoff taken
        if ctx.sync == "p2p" and n > 1 and last >= 0 and last != ci:
            pc = tree_at(clients, last)
            if ctx.wire_handoff:
                pc = ctx.wire_stack.handoff_recv(pc)
        loss, g_c, g_s = topo.turn_grads(pc, server, batch, ctx.loss_fn)
        ups_c, oc = ctx.optimizer_client.update(g_c, tree_at(opt_c, ci), pc)
        clients = tree_update(clients, ci, apply_updates(pc, ups_c))
        opt_c = tree_update(opt_c, ci, oc)
        ups_s, opt_s = ctx.optimizer_server.update(g_s, opt_s, server)
        server = apply_updates(server, ups_s)
        losses.append(loss)
        last = ci
    return {"clients": clients, "server": server, "opt_c": opt_c,
            "opt_s": opt_s,
            "last_trained": torch.tensor(last, dtype=torch.int32,
                                         device=state["last_trained"].device)
            }, torch.stack(losses)


def run_branch(program: StepProgram, ctx: ExecContext, state, batches):
    """Branch fan-in kinds: all K branches contribute to ONE step;
    client grads come back stacked from the topology."""
    loss, g_c, g_s = program.topology.round_grads(
        state["clients"], state["server"], batches, ctx.loss_fn)
    return _branch_step(ctx, state, loss[None], g_c, g_s)


def _branch_step(ctx, state, losses, g_c, g_s):
    """Each client steps on its own slice (the reference vmaps `update`
    over the client axis, so per-client rules such as decaying only
    matrices see one client's shapes); the server steps once."""
    n = ctx.n_clients
    outs = [ctx.optimizer_client.update(tree_at(g_c, i),
                                        tree_at(state["opt_c"], i),
                                        tree_at(state["clients"], i))
            for i in range(n)]
    ups_c = stack_trees([u for u, _ in outs])
    opt_c = stack_trees([o for _, o in outs])
    clients = apply_updates(state["clients"], ups_c)
    ups_s, opt_s = ctx.optimizer_server.update(
        g_s, state["opt_s"], state["server"])
    server = apply_updates(state["server"], ups_s)
    return {"clients": clients, "server": server, "opt_c": opt_c,
            "opt_s": opt_s, "last_trained": state["last_trained"]}, losses


EXECUTORS = {
    "round_robin": run_serial,
    "serial": run_serial,
}
