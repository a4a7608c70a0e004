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
waits for the fleet.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F

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


def moe_apply(params, cfg: MoEConfig, x, *, return_aux: bool = False):
    """x: (B, S, D) -> (B, S, D)  [+ aux losses dict]."""
    B, S, D = x.shape
    T = B * S
    E, k = cfg.n_experts, cfg.top_k
    C = _capacity(T, cfg)
    dev = x.device
    xf = x.reshape(T, D)

    probs = router_probs(params, cfg, xf)                # (T, E)
    gate_w, eid = torch.topk(probs, k, dim=-1)           # (T, k)
    gate_w = gate_w / torch.clamp_min(gate_w.sum(-1, keepdim=True), 1e-9)
    # each token's choices in ascending expert id: the dispatch below is
    # the same for any order within a token, and the combine adds in this
    # one
    eid, perm = torch.sort(eid, dim=-1)
    gate_w = torch.gather(gate_w, -1, perm)

    # --- sort-based dispatch -------------------------------------------------
    flat_eid = eid.reshape(-1)                           # (T*k,)
    order = torch.argsort(flat_eid, stable=True)         # jnp's is stable
    s_eid = flat_eid[order]
    s_tok = order // k                                   # token of each slot
    # expert e's assignments sit at sorted positions [bounds[e], bounds[e+1])
    bounds = torch.searchsorted(s_eid, torch.arange(E + 1, device=dev))
    starts, counts = bounds[:-1], bounds[1:] - bounds[:-1]   # (E,)
    # slot index within expert = position - start offset of that expert
    slot = torch.arange(T * k, device=dev) - starts[s_eid]
    keep = slot < C                                      # overflow dropped
    dest = s_eid * C + slot

    # gather the kept tokens into the expert buffers: slot c of expert e
    # holds the assignment at sorted position starts[e] + c if c < count
    cs = torch.arange(C, device=dev)
    src = torch.clamp_max(starts[:, None] + cs, T * k - 1)   # (E, C)
    filled = (cs[None, :] < counts[:, None])[..., None]
    buf = torch.where(filled, xf[s_tok[src]], 0)       # (E, C, D)

    # --- grouped expert ffn (swiglu) ----------------------------------------
    h = F.silu(torch.bmm(buf, params["gate"])) * torch.bmm(buf, params["up"])
    y_buf = torch.bmm(h, params["down"]).reshape(E * C, D)

    # --- combine: each token's k rows in ascending expert id ----------------
    inv = torch.argsort(order).reshape(T, k)             # sorted position
    w = torch.where(keep[inv], gate_w, 0.0).to(x.dtype)
    contrib = y_buf[torch.clamp_max(dest[inv], E * C - 1)] * w[..., None]
    out = contrib[:, 0]
    for j in range(1, k):
        out = out + contrib[:, j]
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
