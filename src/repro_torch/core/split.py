"""The cut: segmented models, their wire records and the split training
gradients (port of `repro/core/split.py:22-138, 189-220`).

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

This module ports the vanilla and the vertical (multi-modal) splits;
the u-shaped, multi-hop, multi-task and extended-vanilla grads follow
(ROADMAP).
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


def server_apply(model: SegModel, cut: int, ps, a):
    """The server's segments [cut, n_segments) on the received `a`."""
    if _takes_offset(model):
        return model.apply_range(ps, a, cut, model.n_segments, offset=cut)
    return model.apply_range(ps, a, cut, model.n_segments)


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

def vanilla_split_grads(model: SegModel, cut: int, params_c, params_s, x,
                        labels, loss_fn, wires: list | None = None):
    """One split training step's gradients: (loss, g_client, g_server,
    wires); the loss is detached.  The ONLY values linking the two sides
    are the cut activation (up) and its gradient (down)."""
    wires = wires if wires is not None else []
    with torch.enable_grad():
        pc = _leaf_params(params_c)
        a = model.apply_range(pc, x, 0, cut)
        act = record(wires, "cut_act", a.detach(), "up")

        ps = _leaf_params(params_s)
        recv = as_dense(act).detach().requires_grad_()
        loss = loss_fn(server_apply(model, cut, ps, recv), labels)
        g_server, g_act = _grads(loss, (ps, recv))

        g_act = record(wires, "cut_grad", g_act, "down")
        g_client = _grads(a, pc, as_dense(g_act))
    return loss.detach(), g_client, g_server, wires


# ---------------------------------------------------------------------------
# Vertical (multi-modal) split: K client branches -> concat -> server trunk
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Branch:
    """A per-modality client-side feature network."""
    init: Callable                    # generator -> params
    apply: Callable                   # (params, x) -> features (B, f)


def vertical_split_grads(branches: list, params_branches, trunk_apply,
                         params_trunk, xs: list, labels, loss_fn,
                         wires: list | None = None):
    """xs[i] is modality i held by client i.  The concat happens on the
    server.  Returns (loss, [g_branch_i], g_trunk, wires); the loss is
    detached."""
    wires = wires if wires is not None else []
    with torch.enable_grad():
        acts, owned = [], []
        for i, (br, pb, x) in enumerate(zip(branches, params_branches, xs)):
            pb = _leaf_params(pb)
            a = br.apply(pb, x)
            acts.append(record(wires, f"branch_{i}_act", a.detach(), "up"))
            owned.append((pb, a))

        pt = _leaf_params(params_trunk)
        recv = [as_dense(a).detach().requires_grad_() for a in acts]
        loss = loss_fn(trunk_apply(pt, torch.cat(recv, dim=-1)), labels)
        g_all = _grads(loss, (pt, recv))
        g_trunk, g_acts = g_all

        g_branches = []
        for i, ((pb, a), ga) in enumerate(zip(owned, g_acts)):
            ga = record(wires, f"branch_{i}_grad", ga, "down")
            g_branches.append(_grads(a, pb, as_dense(ga)))
    return loss.detach(), g_branches, g_trunk, wires
