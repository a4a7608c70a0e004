"""Mixture-of-Experts: top-k router + sort-based capacity dispatch (port
of `repro/nn/moe.py:30-134`).

The dispatch is the reference's, not a loop over experts and not the
(T, E, C) one-hot einsum:

  1. top-k gates per token, renormalised                 (T, k)
  2. the T*k assignments sorted by expert id (stable)    (T*k,)
  3. each assignment's slot within its expert
  4. slots >= the capacity C dropped; the kept tokens
     gathered into (E, C, D) and the grouped SwiGLU run
     as three `torch.bmm` over the stacked expert weights
  5. each token's k weighted outputs summed back

Every step is a sort, a search or a gather with data-independent output
shapes, so a step runs on meta tensors (`ServeSession.decode_cost`).  The
per-expert counts come from `torch.searchsorted` over the sorted ids, not
from `torch.bincount`, which sizes its output from the data.  Where the
reference scatter-adds the weighted rows back, the port gathers each
token's k rows back in ascending expert id (the order the reference's
scatter visits them) and adds them one by one: no float atomics, so the
result is the same bits on every run of the card.

The expert-parallel path (`moe_apply_ep`, the reference's `shard_map`)
runs the same dispatch on each rank of a mesh axis over its own slice of
the experts, and sums the ranks' partial combines.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.nn import dist
from repro_torch.nn import layers as L
from repro_torch.nn.module import lecun_init


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    d_model: int
    d_ff: int                 # per-expert ffn hidden dim
    n_experts: int
    top_k: int
    n_shared: int = 0         # always-on shared experts (deepseek-v2)
    capacity_factor: float = 1.25
    router_dtype: Any = torch.float32
    dtype: Any = torch.float32
    # expert-parallel path: the mesh axis the experts are sharded over
    # (None = the single-device path).  See moe_apply_ep.
    ep_axis: str | None = None


def moe_init(gen, cfg: MoEConfig, device=None):
    """The fp32 router (D, E), the stacked expert weights gate/up
    (E, D, F) and down (E, F, D), and the shared experts' SwiGLU of width
    F * n_shared."""
    device = gen.device if device is None else device
    E, D, Fd = cfg.n_experts, cfg.d_model, cfg.d_ff
    p = {
        "router": L.dense_init(gen, D, E, dtype=cfg.router_dtype,
                               device=device),
        "gate": lecun_init(gen, (E, D, Fd), cfg.dtype, D, device),
        "up": lecun_init(gen, (E, D, Fd), cfg.dtype, D, device),
        "down": lecun_init(gen, (E, Fd, D), cfg.dtype, Fd, device),
    }
    if cfg.n_shared:
        p["shared"] = L.swiglu_init(gen, D, Fd * cfg.n_shared,
                                    dtype=cfg.dtype, device=device)
    return p


def router_probs(params, cfg: MoEConfig, x_flat):
    logits = L.dense_apply(params["router"], x_flat.to(cfg.router_dtype))
    return torch.softmax(logits, dim=-1)                 # (T, E)


def _capacity(T: int, cfg: MoEConfig) -> int:
    c = int(T * cfg.top_k * cfg.capacity_factor / cfg.n_experts) + 1
    return max(cfg.top_k, -(-c // 8) * 8)                # round up to 8


def _route(params, cfg: MoEConfig, xf):
    """The router: probs (T, E), and each token's top-k gates,
    renormalised, and expert ids, both in ascending expert id (the
    dispatch below is the same for any order within a token, and the
    combine adds in this one)."""
    probs = router_probs(params, cfg, xf)                # (T, E)
    gate_w, eid = torch.topk(probs, cfg.top_k, dim=-1)   # (T, k)
    gate_w = gate_w / torch.clamp_min(gate_w.sum(-1, keepdim=True), 1e-9)
    eid, perm = torch.sort(eid, dim=-1)
    return probs, torch.gather(gate_w, -1, perm), eid


def _experts(params, xf, gate_w, eid, C: int, e_lo: int, E_l: int):
    """Experts [e_lo, e_lo + E_l) of the stacked weights (a view, the
    whole stack when E_l is every expert) applied to their assignments of
    xf (T, D): the capacity dispatch, the grouped SwiGLU and each token's
    k weighted rows added in ascending expert id.  An assignment to
    another expert (the expert-parallel path's foreign ones, in bucket
    E_l) or past the capacity adds a zero row.  Returns (out (T, D), the
    local experts' counts (E_l,), keep (T*k,) in sorted order)."""
    T, k = eid.shape
    D = xf.shape[-1]
    dev = xf.device
    local = eid
    if E_l < params["gate"].shape[0]:
        local = torch.where((eid >= e_lo) & (eid < e_lo + E_l), eid - e_lo,
                            E_l)

    # --- sort-based dispatch -------------------------------------------------
    flat_eid = local.reshape(-1)                         # (T*k,)
    order = torch.argsort(flat_eid, stable=True)         # jnp's is stable
    s_eid = flat_eid[order]
    s_tok = order // k                                   # token of each slot
    # expert e's assignments sit at sorted positions [bounds[e], bounds[e+1])
    bounds = torch.searchsorted(s_eid, torch.arange(E_l + 1, device=dev))
    starts, counts = bounds[:-1], bounds[1:] - bounds[:-1]   # (E_l,)
    # slot index within expert = position - start offset of that expert
    slot = torch.arange(T * k, device=dev) - bounds[s_eid]
    keep = slot < C                                      # overflow dropped
    if E_l < params["gate"].shape[0]:
        keep = keep & (s_eid < E_l)                      # foreign dropped
    dest = s_eid * C + slot

    # gather the kept tokens into the expert buffers: slot c of expert e
    # holds the assignment at sorted position starts[e] + c if c < count
    cs = torch.arange(C, device=dev)
    src = torch.clamp_max(starts[:, None] + cs, T * k - 1)   # (E_l, C)
    filled = (cs[None, :] < counts[:, None])[..., None]
    buf = torch.where(filled, xf[s_tok[src]], 0)       # (E_l, C, D)

    # --- grouped expert ffn (swiglu) ----------------------------------------
    sl = slice(e_lo, e_lo + E_l)
    h = F.silu(torch.bmm(buf, params["gate"][sl])) * torch.bmm(
        buf, params["up"][sl])
    y_buf = torch.bmm(h, params["down"][sl]).reshape(E_l * C, D)

    # --- combine: each token's k rows in ascending expert id ----------------
    inv = torch.argsort(order).reshape(T, k)             # sorted position
    w = torch.where(keep[inv], gate_w, 0.0).to(xf.dtype)
    contrib = y_buf[torch.clamp_max(dest[inv], E_l * C - 1)] * w[..., None]
    out = contrib[:, 0]
    for j in range(1, k):
        out = out + contrib[:, j]
    return out, counts, keep


def moe_apply(params, cfg: MoEConfig, x, *, return_aux: bool = False):
    """x: (B, S, D) -> (B, S, D)  [+ aux losses dict].  A config with
    `ep_axis` set, asked for no aux losses, takes `moe_apply_ep`."""
    if cfg.ep_axis is not None and not return_aux:
        return moe_apply_ep(params, cfg, x)
    B, S, D = x.shape
    T = B * S
    E, k = cfg.n_experts, cfg.top_k
    xf = x.reshape(T, D)
    probs, gate_w, eid = _route(params, cfg, xf)
    out, counts, keep = _experts(params, xf, gate_w, eid, _capacity(T, cfg),
                                 0, E)
    out = out.reshape(B, S, D)

    if cfg.n_shared:
        out = out + L.swiglu_apply(params["shared"], x)

    if return_aux:
        # load-balance loss (Switch): E * sum_e f_e * p_e
        frac_tokens = counts.float() / (T * k)
        mean_prob = probs.mean(dim=0)
        lb_loss = E * torch.sum(frac_tokens * mean_prob)
        dropped = torch.sum(~keep) / (T * k)
        return out, {"load_balance_loss": lb_loss, "drop_fraction": dropped}
    return out


# ---------------------------------------------------------------------------
# Expert-parallel path (port of `repro/nn/moe.py:137-215`)
# ---------------------------------------------------------------------------

def moe_apply_ep(params, cfg: MoEConfig, x):
    """Expert-parallel MoE over the mesh axis `cfg.ep_axis` (of the mesh
    `nn.dist.set_mesh` registered).

    The activations are replicated over the expert axis (a batch shard
    lives on the batch axes: `x` is this rank's rows), so dispatch moves
    no token: every rank runs the whole router over its rows, keeps the
    assignments to its own E/ep experts (a view of the full stacked
    weights), runs them at the capacity of its rows, and the ranks' partial
    combines are summed over the axis (`nn.dist.reduce_from`), the
    collective shape of a tensor-parallel MLP's output all-reduce.  The
    router's input and weight enter through `nn.dist.copy_to`, so their
    gradients are summed over the axis; each rank's expert weights get
    the gradient of its own experts only.  The shared experts run after
    the sum, on every rank.  At one rank this is `moe_apply`'s arithmetic
    op for op, so output and gradients are bitwise equal."""
    ax = cfg.ep_axis
    mesh = dist.get_mesh()
    E = cfg.n_experts
    ep = mesh.shape[ax]
    if E % ep:
        raise ValueError(f"{E} experts do not divide over the {ep} ranks "
                         f"of mesh axis {ax!r}")
    E_l = E // ep
    B, S, D = x.shape
    T = B * S
    xf = dist.copy_to(x, ax, mesh).reshape(T, D)
    router = {n: dist.copy_to(t, ax, mesh)
              for n, t in params["router"].items()}
    _, gate_w, eid = _route({"router": router}, cfg, xf)
    partial, _, _ = _experts(params, xf, gate_w, eid, _capacity(T, cfg),
                             mesh.coords[ax] * E_l, E_l)
    out = dist.reduce_from(partial, ax, mesh).reshape(B, S, D)
    if cfg.n_shared:
        out = out + L.swiglu_apply(params["shared"], x)
    return out
