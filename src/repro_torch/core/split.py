"""The cut: segmented models, their wire records and the split training
gradients (port of `repro/core/split.py:22-338`).

A `SegModel` is a network as an ordered list of segments; the cut is an
index into that list.  The client holds the parameters of segments
[0, cut), the server the rest.

The only tensors that cross the boundary are the cut activations (up)
and the cut gradients (down), each through `record`, so the wire is a
first-class value: middleware transforms it and the meter prices it.
Each side runs its own autograd graph: the server differentiates with
respect to a fresh leaf made from what it RECEIVED, and each client
backpropagates the gradient it received, so no gradient flows through
the wire's pack/unpack (as in the reference, whose vjps start from the
received values).

The six splits: vanilla, u-shaped (labels stay with the client),
vertical (multi-modal branches), multi-hop (a chain of slabs),
multi-task (several server heads) and extended vanilla (an intermediate
client between the branches and the server).  The turn kinds' server
sides (`cut_rest`, `u_shaped_rest`, `multihop_rest`) take the
client's detached first activation, so the pipelined schedule can stage
them per microbatch; their `*_grads` run the client around them.
"""
from __future__ import annotations

import dataclasses
import inspect
from typing import Callable

import torch

from repro_torch.core.wire_compress import as_dense
from repro_torch.nn.module import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class SegModel:
    """A model as `n_segments` sequential segments.

    init(gen) -> params (indexable by segment via param_slice)
    apply_range(params, x, lo, hi) -> activations after segment hi-1
    param_slice(params, lo, hi) -> the parameters of segments [lo, hi)
    param_join(slices) -> params   (inverse of slicing along segments)
    """
    n_segments: int
    init: Callable
    apply_range: Callable
    param_slice: Callable
    param_join: Callable


def list_segmodel(n_segments, init, layer_apply) -> SegModel:
    """SegModel over a list-of-param-dicts network (VGG): `layer_apply(
    layer_params, i, x)` runs segment i.  With `offset`, `params` is a
    slice starting at segment `offset` (the server's)."""
    def apply_range(params, x, lo, hi, *, offset: int = 0):
        for i in range(lo, hi):
            x = layer_apply(params[i - offset], i, x)
        return x

    return SegModel(
        n_segments=n_segments, init=init, apply_range=apply_range,
        param_slice=lambda p, lo, hi: p[lo:hi],
        param_join=lambda slices: sum(slices, []))


def _takes_offset(model: SegModel) -> bool:
    return "offset" in inspect.signature(model.apply_range).parameters


def _apply_hop(model: SegModel, p, a, lo: int, hi: int):
    """Segments [lo, hi) on `a`, `p` holding only those segments' params
    when the model takes an offset."""
    if _takes_offset(model):
        return model.apply_range(p, a, lo, hi, offset=lo)
    return model.apply_range(p, a, lo, hi)


def server_apply(model: SegModel, cut: int, ps, a):
    """The server's segments [cut, n_segments) on the received `a`."""
    return _apply_hop(model, ps, a, cut, model.n_segments)


def _apply_mid(model: SegModel, p, a, cut1: int, cut2: int):
    """The u-shaped server's segments [cut1, cut2)."""
    return _apply_hop(model, p, a, cut1, cut2)


def _apply_tail(model: SegModel, p, a, cut2: int):
    """The u-shaped client's tail, segments [cut2, n_segments)."""
    return _apply_hop(model, p, a, cut2, model.n_segments)


@dataclasses.dataclass
class WireRecord:
    """One payload that crossed the client/server boundary.

    `payload_bytes` overrides the dense shape * itemsize count when wire
    middleware changed the physical representation (int8 + row scales)."""
    name: str
    shape: tuple             # LOGICAL payload shape (pre-pack)
    dtype: torch.dtype       # LOGICAL dtype (what the dense value carries)
    direction: str           # "up" (client->server) | "down"
    payload_bytes: int | None = None
    physical: bool = False   # True: bytes derived from a packed payload

    @property
    def bytes(self) -> int:
        if self.payload_bytes is not None:
            return self.payload_bytes
        n = 1
        for s in self.shape:
            n *= s
        return n * self.dtype.itemsize


def record(wires: list, name: str, t, direction: str):
    """Record one boundary crossing and return the value AS THE OTHER
    SIDE RECEIVES IT.

    `wires` is a plain list (no middleware: `t` passes unchanged) or an
    `api.wire.WireTape`, which runs the wire stack on the value and
    prices the record at the stack's physical bytes.  With a physical
    transform the returned value is the `PackedInt8` payload itself."""
    transform = getattr(wires, "transform", None)
    payload, physical = None, False
    if transform is not None:
        t = transform(t, name, direction)
        payload, physical = wires.payload_bytes(t)
    wires.append(WireRecord(name, tuple(t.shape), t.dtype, direction,
                            payload, physical))
    return t


def _leaf_params(params):
    """A copy of `params` whose tensors are fresh autograd leaves sharing
    the original storage."""
    return tree_map(lambda t: t.detach().requires_grad_(), params)


def _grads(outputs, params, grad_outputs=None):
    """d outputs / d params as a tree shaped like `params` (zeros where a
    leaf does not reach the outputs)."""
    leaves = tree_leaves(params)
    gs = torch.autograd.grad(outputs, leaves, grad_outputs=grad_outputs,
                             allow_unused=True)
    it = iter([torch.zeros_like(p) if g is None else g
               for p, g in zip(leaves, gs)])
    return tree_map(lambda _: next(it), params)


# ---------------------------------------------------------------------------
# Vanilla split: client [0, cut) -> server [cut, L) + loss
# ---------------------------------------------------------------------------

def cut_rest(server_fn: Callable, params_s, act, labels, loss_fn,
             wires: list):
    """The server's side of a vanilla turn from the client's detached cut
    activation `act`: `cut_act` recorded up, `server_fn(params_s, a)` and
    the loss on a fresh leaf of what arrived, `cut_grad` recorded down.
    Returns (loss detached, g_server, the cut gradient as the client
    receives it, dense)."""
    act = record(wires, "cut_act", act, "up")
    with torch.enable_grad():
        ps = _leaf_params(params_s)
        recv = as_dense(act).detach().requires_grad_()
        loss = loss_fn(server_fn(ps, recv), labels)
        g_server, g_act = _grads(loss, (ps, recv))
    g_act = record(wires, "cut_grad", g_act, "down")
    return loss.detach(), g_server, as_dense(g_act)


def cut_split_grads(client_fn: Callable, server_fn: Callable, params_c,
                    params_s, batch, labels, loss_fn,
                    wires: list | None = None):
    """One vanilla turn's gradients over opaque sides: the client runs
    `client_fn(params_c, batch)` to the cut, `cut_rest` runs the server,
    and the client backpropagates the cut gradient it received.  Returns
    (loss, g_client, g_server, wires); the loss is detached.  The ONLY
    values linking the two sides are the cut activation (up) and its
    gradient (down)."""
    wires = wires if wires is not None else []
    with torch.enable_grad():
        pc = _leaf_params(params_c)
        a = client_fn(pc, batch)
        loss, g_server, g_act = cut_rest(server_fn, params_s, a.detach(),
                                         labels, loss_fn, wires)
        g_client = _grads(a, pc, g_act)
    return loss, g_client, g_server, wires


def vanilla_split_grads(model: SegModel, cut: int, params_c, params_s, x,
                        labels, loss_fn, wires: list | None = None):
    """`cut_split_grads` over a SegModel's segments [0, cut) and [cut, L)."""
    return cut_split_grads(
        lambda pc, x: model.apply_range(pc, x, 0, cut),
        lambda ps, a: server_apply(model, cut, ps, a), params_c, params_s,
        x, labels, loss_fn, wires)


# ---------------------------------------------------------------------------
# U-shaped split: client [0, c1) + [c2, L) + loss; server [c1, c2).
# Labels NEVER cross (the paper's no-label-sharing configuration).
# ---------------------------------------------------------------------------

def u_shaped_rest(model: SegModel, cut1: int, cut2: int, params_mid,
                  params_tail, act1, labels, loss_fn, wires: list):
    """A u-shaped turn past the client's head, from its detached
    activation `act1`: the server's mid, the client's tail with the loss,
    and the two gradients back.  Returns (loss detached, g_mid, g_tail,
    the head's cut gradient as received, dense)."""
    act1 = record(wires, "cut_act_1", act1, "up")
    with torch.enable_grad():
        pm = _leaf_params(params_mid)
        recv1 = as_dense(act1).detach().requires_grad_()
        a2 = _apply_mid(model, pm, recv1, cut1, cut2)
        act2 = record(wires, "cut_act_2", a2.detach(), "down")

        pt = _leaf_params(params_tail)
        recv2 = as_dense(act2).detach().requires_grad_()
        loss = loss_fn(_apply_tail(model, pt, recv2, cut2), labels)
        g_tail, g_act2 = _grads(loss, (pt, recv2))

        g_act2 = record(wires, "cut_grad_2", g_act2, "up")
        g_mid, g_act1 = _grads(a2, (pm, recv1), as_dense(g_act2))
    g_act1 = record(wires, "cut_grad_1", g_act1, "down")
    return loss.detach(), g_mid, g_tail, as_dense(g_act1)


def u_shaped_grads(model: SegModel, cut1: int, cut2: int, params_head,
                   params_mid, params_tail, x, labels, loss_fn,
                   wires: list | None = None):
    """(loss, g_head, g_mid, g_tail, wires); the loss is detached.  Four
    crossings in this order: `cut_act_1` up, `cut_act_2` down,
    `cut_grad_2` up, `cut_grad_1` down."""
    wires = wires if wires is not None else []
    with torch.enable_grad():
        ph = _leaf_params(params_head)
        a1 = model.apply_range(ph, x, 0, cut1)
        loss, g_mid, g_tail, g_act1 = u_shaped_rest(
            model, cut1, cut2, params_mid, params_tail, a1.detach(), labels,
            loss_fn, wires)
        g_head = _grads(a1, ph, g_act1)
    return loss, g_head, g_mid, g_tail, wires


# ---------------------------------------------------------------------------
# Vertical (multi-modal) split: K client branches -> concat -> server trunk
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Branch:
    """A per-modality client-side feature network."""
    init: Callable                    # generator -> params
    apply: Callable                   # (params, x) -> features (B, f)


def _branch_forwards(branches, params_branches, xs, wires):
    """Each branch's forward on its modality, its activation recorded
    up.  Returns ([(leaf params, activation)], [wire values])."""
    owned, acts = [], []
    for i, (br, pb, x) in enumerate(zip(branches, params_branches, xs)):
        pb = _leaf_params(pb)
        a = br.apply(pb, x)
        acts.append(record(wires, f"branch_{i}_act", a.detach(), "up"))
        owned.append((pb, a))
    return owned, acts


def _branch_backwards(owned, g_acts, wires) -> list:
    """Each branch's gradient from its cut gradient, recorded down."""
    g_branches = []
    for i, ((pb, a), ga) in enumerate(zip(owned, g_acts)):
        ga = record(wires, f"branch_{i}_grad", ga, "down")
        g_branches.append(_grads(a, pb, as_dense(ga)))
    return g_branches


def vertical_split_grads(branches: list, params_branches, trunk_apply,
                         params_trunk, xs: list, labels, loss_fn,
                         wires: list | None = None):
    """xs[i] is modality i held by client i.  The concat happens on the
    server.  Returns (loss, [g_branch_i], g_trunk, wires); the loss is
    detached."""
    wires = wires if wires is not None else []
    with torch.enable_grad():
        owned, acts = _branch_forwards(branches, params_branches, xs, wires)
        pt = _leaf_params(params_trunk)
        recv = [as_dense(a).detach().requires_grad_() for a in acts]
        loss = loss_fn(trunk_apply(pt, torch.cat(recv, dim=-1)), labels)
        g_trunk, g_acts = _grads(loss, (pt, recv))
        g_branches = _branch_backwards(owned, g_acts, wires)
    return loss.detach(), g_branches, g_trunk, wires


# ---------------------------------------------------------------------------
# Multi-hop (Tor-like): a chain of slabs, each owning a contiguous range
# ---------------------------------------------------------------------------

def multihop_rest(model: SegModel, cuts: list, params_chain, act, labels,
                  loss_fn, wires: list):
    """The chain past the data client, from hop 0's detached activation
    `act`: each relay hop from a fresh leaf of what it received, its
    activation recorded up and densified before the next; the last slab
    with the loss; the gradients back down in reverse.  `params_chain`
    holds slabs 1, 2, ...  Returns (loss detached, [g_slab_1, ...], hop
    0's cut gradient as received, dense)."""
    bounds = [0] + list(cuts) + [model.n_segments]
    act = record(wires, "hop_0_act", act, "up")
    with torch.enable_grad():
        owned = []
        for i in range(1, len(bounds) - 2):
            p = _leaf_params(params_chain[i - 1])
            inp = as_dense(act).detach().requires_grad_()
            out = _apply_hop(model, p, inp, bounds[i], bounds[i + 1])
            act = record(wires, f"hop_{i}_act", out.detach(), "up")
            owned.append((p, inp, out))

        p_last = _leaf_params(params_chain[-1])
        recv = as_dense(act).detach().requires_grad_()
        loss = loss_fn(_apply_hop(model, p_last, recv, bounds[-2],
                                  bounds[-1]), labels)
        g_last, g_act = _grads(loss, (p_last, recv))
        grads = [g_last]
        for i in reversed(range(len(owned))):
            g_act = record(wires, f"hop_{i + 1}_grad", g_act, "down")
            p, inp, out = owned[i]
            g_slab, g_act = _grads(out, (p, inp), as_dense(g_act))
            grads.append(g_slab)
    g_act = record(wires, "hop_0_grad", g_act, "down")
    return loss.detach(), list(reversed(grads)), as_dense(g_act)


def multihop_grads(model: SegModel, cuts: list, params_slabs, x, labels,
                   loss_fn, wires: list | None = None):
    """cuts: ascending segment boundaries, e.g. [2, 4, 6]; slab i runs
    [cuts[i-1], cuts[i]) and the last slab [cuts[-1], n_segments) with
    the loss.  Returns (loss, [g_slab_i], wires); the loss is detached.
    Every hop's activation is recorded up and densified before the next
    hop; the gradients come back down in reverse."""
    wires = wires if wires is not None else []
    with torch.enable_grad():
        p0 = _leaf_params(params_slabs[0])
        a0 = _apply_hop(model, p0, x, 0, cuts[0])
        loss, g_chain, g_act = multihop_rest(
            model, cuts, params_slabs[1:], a0.detach(), labels, loss_fn,
            wires)
        g0 = _grads(a0, p0, g_act)
    return loss, [g0] + g_chain, wires


# ---------------------------------------------------------------------------
# Multi-task: K client branches -> concat -> T server heads
# ---------------------------------------------------------------------------

def multitask_grads(branches: list, params_branches, heads: list,
                    params_heads, xs: list, labels_per_task: list,
                    loss_fns: list, wires: list | None = None):
    """One loss per task.  Head t gets the gradient of task t's loss; each
    branch gets the SUM over tasks of its cut gradient, which crosses the
    wire once per branch.  Returns (losses (T,), [g_branch_i], [g_head_t],
    wires); the losses are detached."""
    wires = wires if wires is not None else []
    with torch.enable_grad():
        owned, acts = _branch_forwards(branches, params_branches, xs, wires)
        recv = [as_dense(a).detach().requires_grad_() for a in acts]
        losses, g_heads, g_total = [], [], None
        for head, ph, lf, lab in zip(heads, params_heads, loss_fns,
                                     labels_per_task):
            ph = _leaf_params(ph)
            lv = lf(head(ph, torch.cat(recv, dim=-1)), lab)
            gh, gas = _grads(lv, (ph, recv))
            losses.append(lv.detach())
            g_heads.append(gh)
            g_total = gas if g_total is None else [
                a + b for a, b in zip(g_total, gas)]
        g_branches = _branch_backwards(owned, g_total, wires)
    return torch.stack(losses), g_branches, g_heads, wires


# ---------------------------------------------------------------------------
# Extended vanilla (paper §5.1 Fig. 4a): the concatenated branch features
# pass through ANOTHER client before reaching the server
# ---------------------------------------------------------------------------

def extended_vanilla_grads(branches: list, params_branches, mid_apply,
                           params_mid, trunk_apply, params_trunk, xs: list,
                           labels, loss_fn, wires: list | None = None):
    """Like `vertical_split_grads`, but an intermediate client applies
    `mid_apply` to the concatenated features, and its output (`mid_act`
    up, `mid_grad` down) crosses to the server trunk.  Returns (loss,
    [g_branch_i], g_mid, g_trunk, wires); the loss is detached."""
    wires = wires if wires is not None else []
    with torch.enable_grad():
        owned, acts = _branch_forwards(branches, params_branches, xs, wires)
        recv = [as_dense(a).detach().requires_grad_() for a in acts]
        pm = _leaf_params(params_mid)
        mid_out = mid_apply(pm, torch.cat(recv, dim=-1))
        m = record(wires, "mid_act", mid_out.detach(), "up")

        pt = _leaf_params(params_trunk)
        m_recv = as_dense(m).detach().requires_grad_()
        loss = loss_fn(trunk_apply(pt, m_recv), labels)
        g_trunk, g_m = _grads(loss, (pt, m_recv))
        g_m = record(wires, "mid_grad", g_m, "down")
        g_mid, g_acts = _grads(mid_out, (pm, recv), as_dense(g_m))
        g_branches = _branch_backwards(owned, g_acts, wires)
    return loss.detach(), g_branches, g_mid, g_trunk, wires
