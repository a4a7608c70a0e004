"""The step-program IR (port of `repro/engine/program.py`).

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
  run_parallel — SplitFed (Thapa et al., AAAI 2022): every client's turn
               against the SAME server state, each client stepping its own
               optimizer slice, the server stepping once on the mean cut
               gradient; no handoff;
  run_branch — the joint round of the branch fan-in kinds (vertical,
               multitask, extended_vanilla): every branch contributes to
               ONE step, and each party then steps its optimizer;
  run_pipelined — round-robin with each client batch streamed through
               the cut as M microbatches (`_pipelined_turn`): the server
               works on microbatch j-1's staged activation, then the
               client computes microbatch j's forward; gradients are the
               microbatch mean and each party steps once a turn, so M=1 is
               the serial math.  Client k+1 adopts client k's post-step
               weights through the handoff, client 0 the last trained
               client's at the round boundary.  Branch kinds stream their
               joint batch the same way (`run_branch_pipelined`).

Where the reference `vmap`s (over clients in `run_parallel`, over
microbatches in the drain), the port loops in Python: the wire's
autograd functions and the CUDA launches have no vmap rule.

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
    turn (turn kinds) or joint round (branch kinds, baselines), plus the
    compute callables executors interpret."""
    kind: str
    round_type: str                # "turn" | "branch" | "fedavg" | ...
    steps: tuple
    topology: Any = None           # the (wire-wrapped) Topology
    split_batch: Callable | None = None   # (batch, M) -> microbatches

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
    sync policy, loss, optimizers, the wire stack and the microbatch
    count of the pipelined schedule."""
    n_clients: int
    sync: str
    loss_fn: Callable
    optimizer_client: Any
    optimizer_server: Any
    wire_stack: Any = None         # api.wire.WireStack | None
    wire_handoff: bool = False     # the stack squeezes the p2p handoff
    microbatches: int = 1


# ---------------------------------------------------------------------------
# microbatch splitting
# ---------------------------------------------------------------------------


def split_turn_batch(batch: dict, m: int) -> dict:
    """One client's batch (leading axis B) -> (M, B/M, ...) microbatches."""
    def leaf(a):
        if a.shape[0] % m:
            raise ValueError(
                f"pipelined schedule: batch axis {a.shape[0]} must divide "
                f"evenly into microbatches={m}")
        return a.reshape(m, a.shape[0] // m, *a.shape[1:])
    return {k: leaf(v) for k, v in batch.items()}


def split_branch_batch(batch: dict, m: int) -> dict:
    """Branch-kind joint batch {"x": (K, B, ...), "labels": (B,)|(T, B)}
    -> the same layout per microbatch, stacked on a leading M axis."""
    x = batch["x"]
    if x.shape[1] % m:
        raise ValueError(
            f"pipelined schedule: batch axis {x.shape[1]} must divide "
            f"evenly into microbatches={m}")
    out = dict(batch)
    out["x"] = x.reshape(x.shape[0], m, x.shape[1] // m,
                         *x.shape[2:]).movedim(1, 0)
    lab = batch["labels"]
    if lab.ndim == 1:                        # shared labels (B,)
        out["labels"] = lab.reshape(m, lab.shape[0] // m)
    else:                                    # multitask labels (T, B)
        out["labels"] = lab.reshape(lab.shape[0], m,
                                    lab.shape[1] // m).movedim(1, 0)
    return out


def _microbatches(mbs: dict, m: int) -> list:
    """(M, ...) stacked microbatches -> M batch dicts (views)."""
    return [{k: v[j] for k, v in mbs.items()} for j in range(m)]


def _tree_mean(trees: list):
    """The leafwise mean of a list of trees, as a mean over a stacked
    leading axis."""
    return tree_map(lambda *xs: torch.stack(xs).mean(0), *trees)


def microbatch_mean(fn: Callable, batch: dict, m: int,
                    split_batch: Callable | None = None):
    """`fn(microbatch)` over the M microbatches of `batch`, one after the
    other, and the leafwise MEAN of its outputs: the accumulation every
    pipelined gradient path shares (the branch joint round here, the
    baselines' gradients in `repro_torch.api.baseline`).  For
    mean-reduction losses the mean of microbatch gradients is the
    full-batch gradient."""
    mbs = (split_batch or split_turn_batch)(batch, m)
    return _tree_mean([fn(mb) for mb in _microbatches(mbs, m)])


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
    return _round_robin(program.topology.turn_grads, ctx, state, batches)


def _round_robin(turn, ctx: ExecContext, state, batches):
    """The turn loop `run_serial` and `run_pipelined` share; `turn(pc, ps,
    batch, loss_fn) -> (loss, g_c, g_s)`."""
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
        loss, g_c, g_s = turn(pc, server, batch, ctx.loss_fn)
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


def run_parallel(program: StepProgram, ctx: ExecContext, state, batches):
    """SplitFed: every client's turn against the SAME server state (one
    client's graph freed before the next's), each client stepping its own
    optimizer slice, the server once on the MEAN cut gradient; no
    handoff, so the clients diverge.  Returns (state, losses (N,))."""
    topo = program.topology
    outs = [topo.turn_grads(tree_at(state["clients"], ci), state["server"],
                            {k: v[ci] for k, v in batches.items()},
                            ctx.loss_fn)
            for ci in range(ctx.n_clients)]
    losses, g_c, g_s = zip(*outs)
    return _branch_step(ctx, state, torch.stack(losses),
                        stack_trees(list(g_c)), _tree_mean(list(g_s)))


def run_branch(program: StepProgram, ctx: ExecContext, state, batches):
    """Branch fan-in kinds: all K branches contribute to ONE step;
    client grads come back stacked from the topology."""
    loss, g_c, g_s = program.topology.round_grads(
        state["clients"], state["server"], batches, ctx.loss_fn)
    return _branch_step(ctx, state, loss[None], g_c, g_s)


def run_branch_pipelined(program: StepProgram, ctx: ExecContext, state,
                         batches):
    """Branch fan-in kinds under the pipelined schedule: the joint batch
    splits into M microbatches through the same `round_grads`; the
    gradients and the loss are the microbatch mean and each party steps
    ONCE, so M=1 is exactly `run_branch`."""
    topo = program.topology
    loss, g_c, g_s = microbatch_mean(
        lambda mb: topo.round_grads(state["clients"], state["server"], mb,
                                    ctx.loss_fn),
        batches, ctx.microbatches, program.split_batch)
    return _branch_step(ctx, state, loss[None], g_c, g_s)


def _branch_step(ctx, state, losses, g_c, g_s):
    """Each client steps on its own slice (the reference vmaps `update`
    over the client axis, so per-client rules such as decaying only
    matrices see one client's shapes); the server steps once.  Shared by
    the branch rounds and `run_parallel`."""
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


def run_pipelined(program: StepProgram, ctx: ExecContext, state, batches):
    """The microbatch-pipelined round-robin: turn order, p2p handoff and
    one optimizer step per party per turn as in `run_serial`, each turn
    streamed through the cut by `_pipelined_turn`.  The reference unrolls
    the client loop so that client k+1 adopts client k's post-step
    weights as plain dataflow, and client 0 the last trained client's at
    the round boundary; in eager torch that is `run_serial`'s handoff, so
    the two share one loop.  Branch kinds stream their joint batch
    instead (`run_branch_pipelined`)."""
    if program.round_type == "branch":
        if ctx.microbatches == 1:
            return run_branch(program, ctx, state, batches)
        return run_branch_pipelined(program, ctx, state, batches)
    topo, m = program.topology, ctx.microbatches

    def turn(pc, ps, batch, loss_fn):
        return _pipelined_turn(topo, loss_fn, pc, ps, batch, m,
                               program.split_batch)
    return _round_robin(turn, ctx, state, batches)


def _pipelined_turn(topo, loss_fn, pc, ps, batch, m: int, split_batch):
    """One client turn as an M-deep software pipeline across the cut.

    Fill: the client forward of microbatch 0.  Body, slot j: the server
    side (`pipeline_rest`) on microbatch j-1's staged activation, then
    the client forward of microbatch j.  Drain: the server side on the
    last one.  The client forwards keep no graph: each backward
    (`pipeline_bwd`) rematerializes its forward from the staged cut
    gradient (the client's weights are constant within the turn, so the
    recompute is exact).  The server gradient is (the sum over the first
    M-1 microbatches + the last) / M, the client gradient and the loss
    the microbatch mean; M == 1 is exactly fwd -> rest -> bwd."""
    fwd, rest, bwd = topo.pipeline_fwd, topo.pipeline_rest, topo.pipeline_bwd
    if m == 1:                       # no pipeline: the serial math
        with torch.no_grad():
            act = fwd(pc, batch)
        loss, g_rest, g_s, g_act = rest(pc, ps, act, batch, loss_fn, [])
        return loss, bwd(pc, batch, g_act, g_rest), g_s
    mbs = _microbatches(split_batch(batch, m), m)
    with torch.no_grad():
        act = fwd(pc, mbs[0])        # pipeline fill
    staged = []
    for j in range(1, m):
        staged.append(rest(pc, ps, act, mbs[j - 1], loss_fn, []))
        with torch.no_grad():
            act = fwd(pc, mbs[j])
    staged.append(rest(pc, ps, act, mbs[-1], loss_fn, []))    # drain
    losses, g_rests, g_ss, g_acts = zip(*staged)
    g_s = tree_map(lambda *gs: (torch.stack(gs[:-1]).sum(0) + gs[-1]) / m,
                   *g_ss)
    g_c = _tree_mean([bwd(pc, mb, ga, gr)
                      for mb, ga, gr in zip(mbs, g_acts, g_rests)])
    return torch.stack(losses).mean(), g_c, g_s


EXECUTORS = {
    "round_robin": run_serial,
    "serial": run_serial,
    "parallel": run_parallel,
    "pipelined": run_pipelined,
}
