"""The fleet's tree collectives over a process group (port of
`repro/nn/dist.py`).

The reference's fleet engines trace one SPMD program under `shard_map`,
whose bodies call `lax` collectives over a mesh axis.  The port's ranks
are processes, one a device, that run plain eager code: every rank runs
the same script (as under `torchrun`), and the collectives below are
called by the rank's own code between ordinary eager steps.  So there is
no `shard_map` and no counterpart of `shard_map_norep`.

Each helper applies one `torch.distributed` call to the leaves of a tree
(nested dicts, lists and tuples of tensors, in `tree_map` order) over the
group of a fleet mesh (`repro_torch.launch.mesh.FleetMesh`: its `group`,
`rank`, `device` and `counts`).  The leaves of one dtype travel together,
flattened into one buffer, so a tree costs one call a dtype (on an
H100, the 80 server and optimizer leaves a VGG-16 round-robin round
broadcasts took 3.0-3.8 ms one call a leaf and 1.0-1.1 ms in one call a
dtype: `chip_fleet.py`), and `mesh.counts[<call>]` counts the calls:

  tree_psum            `all_reduce` (sum) of every leaf;
  tree_ppermute        point-to-point along (src, dst) pairs: the ring
                       hops of the round-robin fleet;
  tree_replicate_from  `broadcast` from the rank that owns the value (the
                       reference's masked psum);
  tree_all_gather      `all_gather` along the leading (client) axis.

Each raises ValueError when a leaf does not lie on the mesh's device, the
one device its group's backend carries (cuda under nccl, the CPU under
gloo): nothing is staged through the host.

The sharded serving paths (`nn.moe.moe_apply_ep`,
`nn.attention.gqa_decode_sharded`) run over one axis of a named mesh
(`launch.mesh.make_mesh_compat`: its `groups[axis]` and `counts`), which
`set_mesh`/`get_mesh` keep for the process.  Two autograd functions give
them what the transpose of `shard_map` gives the reference for free:

  copy_to(x, axis)      forward the identity, backward an `all_reduce`
                        (sum) of the gradient over the axis: a value
                        replicated over the axis that each rank uses for
                        its own partial result;
  reduce_from(x, axis)  forward an `all_reduce` (sum), backward the
                        identity: the partial results summed.

(`torch.distributed.nn.functional.all_reduce` all-reduces the gradient
again in backward, so a replicated cotangent would come back multiplied
by the axis size.)  `all_reduce(x, axis, op)` and `all_gather(x, axis,
dim)` are the plain forward collectives of the split-KV decode.  On meta
tensors (`ServeSession.decode_cost`'s probe) every one returns the
shape and type it would and calls, and counts, nothing.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.nn.module import tree_leaves, tree_map

_MESH = None


def _leaves(tree, mesh) -> list:
    leaves = tree_leaves(tree)
    for t in leaves:
        if t.device != mesh.device:
            raise ValueError(
                f"fleet collective: a tensor on {t.device}, but the "
                f"group's backend ({dist.get_backend(mesh.group)}) carries "
                f"{mesh.device}; tensors are not staged through the host")
    return leaves


def _rebuild(tree, leaves: list):
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def _by_dtype(leaves: list) -> list:
    """The leaves' indices grouped by dtype, in order of first use."""
    groups: dict = {}
    for i, t in enumerate(leaves):
        groups.setdefault(t.dtype, []).append(i)
    return list(groups.values())


def _flat(ts: list) -> torch.Tensor:
    """One buffer holding `ts` end to end (a copy)."""
    return torch.cat([t.reshape(-1) for t in ts])


def _unflat(flat: torch.Tensor, likes: list) -> list:
    """Views of `flat` shaped as `likes`, end to end."""
    out, at = [], 0
    for t in likes:
        out.append(flat[at:at + t.numel()].view(t.shape))
        at += t.numel()
    return out


def tree_psum(tree, mesh):
    """The sum of `tree` over the ranks, leafwise, on every rank (`tree`
    keeps its values)."""
    leaves = _leaves(tree, mesh)
    out = [None] * len(leaves)
    for idx in _by_dtype(leaves):
        flat = _flat([leaves[i] for i in idx])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=mesh.group)
        mesh.counts["all_reduce"] += 1
        for i, t in zip(idx, _unflat(flat, [leaves[i] for i in idx])):
            out[i] = t
    return _rebuild(tree, out)


def tree_ppermute(tree, mesh, perm, *, like=None):
    """Send `tree` along the pair of `perm` ((src, dst) ranks) that starts
    at this rank, and receive along the pair that ends here into fresh
    tensors shaped and typed as `like` (default `tree`; a meta tree
    serves).  Returns the received tree, or None on a rank no pair ends
    at.  A pair from a rank to itself moves nothing: that rank gets
    `tree` back.  Sends and receives are posted together and then waited
    for, so a ring of two (send and receive to one peer) cannot
    deadlock."""
    me = mesh.rank
    dst = [d for s, d in perm if s == me]
    src = [s for s, d in perm if d == me]
    if dst and dst[0] == me:
        return tree
    works, sent, got = [], [], None
    if dst:
        leaves = _leaves(tree, mesh)
        sent = [_flat([leaves[i] for i in idx]) for idx in _by_dtype(leaves)]
        works += [dist.isend(t, dst[0], group=mesh.group) for t in sent]
        mesh.counts["send"] += len(sent)
    if src:
        like = tree if like is None else like
        likes = tree_leaves(like)
        got = [None] * len(likes)
        bufs = []
        for idx in _by_dtype(likes):
            buf = torch.empty(sum(likes[i].numel() for i in idx),
                              dtype=likes[idx[0]].dtype, device=mesh.device)
            works.append(dist.irecv(buf, src[0], group=mesh.group))
            bufs.append((idx, buf))
        mesh.counts["recv"] += len(bufs)
    for w in works:
        w.wait()
    if got is None:
        return None
    for idx, buf in bufs:
        for i, t in zip(idx, _unflat(buf, [likes[i] for i in idx])):
            got[i] = t
    return _rebuild(like, got)


def tree_replicate_from(tree, mesh, src: int):
    """`tree` as rank `src` holds it, on every rank (a `broadcast`).  The
    other ranks pass a tree of the same shapes and types, which is left
    as it was (the values arrive in fresh tensors); rank `src` gets its
    own tensors back."""
    leaves = _leaves(tree, mesh)
    out = list(leaves)
    for idx in _by_dtype(leaves):
        part = [leaves[i] for i in idx]
        flat = (_flat(part) if mesh.rank == src else torch.empty(
            sum(t.numel() for t in part), dtype=part[0].dtype,
            device=mesh.device))
        dist.broadcast(flat, src, group=mesh.group)
        mesh.counts["broadcast"] += 1
        if mesh.rank != src:
            for i, t in zip(idx, _unflat(flat, part)):
                out[i] = t
    return _rebuild(tree, out)


def tree_all_gather(tree, mesh):
    """Every rank's `tree` concatenated along the leading axis, in rank
    order, on every rank: the whole client axis from each rank's share
    (every rank's leaves of the same shapes)."""
    world = dist.get_world_size(mesh.group)
    leaves = _leaves(tree, mesh)
    out = [None] * len(leaves)
    for idx in _by_dtype(leaves):
        part = [leaves[i] for i in idx]
        flat = _flat(part)
        bufs = [torch.empty_like(flat) for _ in range(world)]
        dist.all_gather(bufs, flat, group=mesh.group)
        mesh.counts["all_gather"] += 1
        ranks = [_unflat(b, part) for b in bufs]
        for k, i in enumerate(idx):
            out[i] = torch.cat([r[k] for r in ranks])
    return _rebuild(tree, out)


def batch_axes(mesh) -> tuple:
    """The mesh's batch axes ("pod", "data"), those it has."""
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def _axis_group(mesh, axis: str):
    if axis not in mesh.groups:
        raise ValueError(f"mesh axes {mesh.axis_names} have no {axis!r}")
    return mesh.groups[axis]


def all_reduce(x: torch.Tensor, axis: str, op: str = "sum", mesh=None):
    """`x` reduced over the ranks of `axis` (op "sum" or "max"), in a new
    tensor (`x` keeps its values)."""
    mesh = get_mesh() if mesh is None else mesh
    out = x.clone()
    if x.device.type != "meta":
        _leaves(x, mesh)
        dist.all_reduce(out, op={"sum": dist.ReduceOp.SUM,
                                 "max": dist.ReduceOp.MAX}[op],
                        group=_axis_group(mesh, axis))
        mesh.counts["all_reduce"] += 1
    return out


def all_gather(x: torch.Tensor, axis: str, dim: int, mesh=None):
    """The ranks' `x` along `axis` concatenated along `dim`, in rank
    order (`all_gather` with `tiled=True`)."""
    mesh = get_mesh() if mesh is None else mesh
    group = _axis_group(mesh, axis)
    n = mesh.shape[axis]
    if x.device.type == "meta":
        return torch.cat([x] * n, dim=dim)
    _leaves(x, mesh)
    x = x.contiguous()
    bufs = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(bufs, x, group=group)
    mesh.counts["all_gather"] += 1
    return torch.cat(bufs, dim=dim)


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, mesh):
        ctx.axis, ctx.mesh = axis, mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.axis, mesh=ctx.mesh), None, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, mesh):
        return all_reduce(x, axis, mesh=mesh)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def copy_to(x: torch.Tensor, axis: str, mesh=None) -> torch.Tensor:
    """`x`, replicated over `axis`: the identity, whose gradient is summed
    over the axis's ranks."""
    return _CopyTo.apply(x, axis, get_mesh() if mesh is None else mesh)


def reduce_from(x: torch.Tensor, axis: str, mesh=None) -> torch.Tensor:
    """The sum of `x` over the ranks of `axis`; the gradient passes to
    every rank's `x` unchanged."""
    return _ReduceFrom.apply(x, axis, get_mesh() if mesh is None else mesh)


def set_mesh(mesh):
    global _MESH
    _MESH = mesh


def get_mesh():
    if _MESH is None:
        raise RuntimeError("call repro_torch.nn.dist.set_mesh(mesh) before "
                           "running a sharded path")
    return _MESH
