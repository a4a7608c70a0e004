"""The sharded serving paths' spawn helper: D CPU ranks of the port over
gloo, each running `moe_apply_ep` and `gqa_decode_sharded` on a
`make_mesh_compat` mesh.

`start(suite, world, out_dir)` starts `world` processes of this file, one
a rank, which meet through a file rendezvous in `out_dir`, set one torch
thread, import only `repro_torch`, run every case of the suite and save
what each saw to `out_dir/rank<r>.pt`; `collect` (from
`_torch_fleet_ranks`) waits for them and returns the ranks' results in
rank order.  As a command:

    python tests/_torch_mesh_ranks.py SUITE RANK WORLD OUT_DIR

Suites:

* "perf": the expert-parallel MoE on a (1, world) ("data", "model") mesh
  for every case of `MOE_CASES` (output, the gradient of x, the router's
  and the shared experts' gradients, and each expert weight's gradient
  all-gathered over the expert axis), at world 4 also on a (2, 2) mesh
  with the batch split over "data" (`DM_CASE`), and the split-KV decode
  for every case of `KV_CASES` (each step's output, and the chunks
  all-gathered over the ring's length after the last step);
* "serve": reduced Qwen3-MoE served split with `ep_axis="model"` on every
  MoE layer, from the parameters and prompts the parent saved in
  `out_dir/serve_inputs.pt` (the reference's, bridged): the greedy
  tokens.

Inputs are drawn here and in the parent by the same functions (`moe_case`,
`kv_case`): parameters from the port's init under a seeded
`torch.Generator`, activations from numpy seeds.
"""
from __future__ import annotations

import os
import sys

import numpy as np
import torch

MOE_D, MOE_F, MOE_B, MOE_S = 16, 32, 2, 16
# (experts, shared experts, capacity factor): 1.25 drops, 8.0 keeps all
MOE_CASES = [(e, sh, cf) for e in (4, 8) for sh in (0, 1)
             for cf in (1.25, 8.0)]
DM_CASE = (4, 1, 1.25)         # the (2, 2) mesh's, with drops
KV_STEPS = 16
# (qkv bias, window, max_len): 16 steps cross both rings' wrap
KV_CASES = [(bias, window, 32 if window else 12) for bias in (False, True)
            for window in (None, 8)]
SERVE_ARCH, SERVE_VOCAB, SERVE_B, SERVE_PROMPT, SERVE_GEN = (
    "qwen3_moe_30b_a3b", 97, 2, 24, 6)


def _rows(seed: int, shape) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def moe_config(case, **kw):
    from repro_torch.nn import moe as M

    e, sh, cf = case
    return M.MoEConfig(d_model=MOE_D, d_ff=MOE_F, n_experts=e, top_k=2,
                       n_shared=sh, capacity_factor=cf, **kw)


def moe_case(case, batch: int = MOE_B):
    """(params, x (batch, S, D), loss weights c) of an MoE case.  Every
    token of x shares a topic row (twice a seeded normal row) beside its
    own noise, so the router prefers some experts and, at capacity factor
    1.25, slots drop (at 8.0 none do)."""
    from repro_torch.nn import moe as M

    e, sh, cf = case
    seed = 100 * e + 10 * sh + int(cf)
    params = M.moe_init(torch.Generator().manual_seed(seed),
                        moe_config(case))
    x = _rows(seed + 1, (batch, MOE_S, MOE_D)) + 2 * _rows(9, (MOE_D,))
    return params, x, _rows(seed + 2, (batch, MOE_S, MOE_D))


def attn_config(case, **kw):
    from repro_torch.nn import attention as A

    bias, window, _ = case
    return A.AttnConfig(d_model=32, n_heads=4, n_kv_heads=2, head_dim=8,
                        qkv_bias=bias, window=window, **kw)


def kv_case(case):
    """(params, [x (2, 1, 32) a step]) of a split-KV case; the biases,
    when present, are drawn too (the init's are zero)."""
    from repro_torch.nn import attention as A

    bias, window, max_len = case
    seed = 7 + 2 * int(bias) + (window or 0)
    params = A.gqa_init(torch.Generator().manual_seed(seed),
                        attn_config(case))
    if bias:
        for i, name in enumerate(("wq", "wk", "wv")):
            b = params[name]["b"]
            b.copy_(torch.from_numpy(_rows(seed + 10 + i, tuple(b.shape))))
    return params, [_rows(1000 * seed + t, (2, 1, 32))
                    for t in range(KV_STEPS)]


def _grad_tree(params):
    from repro_torch.nn.module import tree_map

    return tree_map(lambda t: t.clone().requires_grad_(), params)


def run_moe(case, mesh, rows=None) -> dict:
    """The EP MoE over `mesh`'s "model" axis on the case's x (its `rows`
    only, when given) and the gradient of sum(y * c)."""
    from repro_torch.nn import dist
    from repro_torch.nn import moe as M

    params, x, c = moe_case(case, 4 if rows is not None else MOE_B)
    if rows is not None:
        x, c = x[rows], c[rows]
    p = _grad_tree(params)
    xt = torch.from_numpy(x).requires_grad_()
    y = M.moe_apply(p, moe_config(case, ep_axis="model"), xt)
    (y * torch.from_numpy(c)).sum().backward()
    e_l = case[0] // mesh.shape["model"]
    lo = mesh.coords["model"] * e_l
    experts = {n: dist.all_gather(p[n].grad[lo:lo + e_l], "model", 0,
                                  mesh=mesh)
               for n in ("gate", "up", "down")}
    return {"y": y.detach(), "dx": xt.grad, "router": p["router"]["w"].grad,
            "shared": ({n: p["shared"][n]["w"].grad for n in p["shared"]}
                       if "shared" in p else None),
            "experts": experts,
            # each rank's own slice of the expert gradient, the rest zero
            "foreign_zero": all(
                bool((p[n].grad[:lo] == 0).all()
                     and (p[n].grad[lo + e_l:] == 0).all())
                for n in ("gate", "up", "down"))}


def run_kv(case, mesh) -> dict:
    """16 split-KV decode steps over `mesh`'s "model" axis: each step's
    output and the ring gathered over the axis."""
    from repro_torch.nn import attention as A
    from repro_torch.nn import dist

    params, xs = kv_case(case)
    cfg = attn_config(case, decode_kv_shard="model")
    cache = A.gqa_init_cache(cfg, 2, case[2])
    ys = []
    with torch.no_grad():
        for x in xs:
            y, cache = A.gqa_decode(params, cfg, torch.from_numpy(x), cache)
            ys.append(y)
    return {"ys": torch.stack(ys), "pos": cache["pos"],
            "chunk": tuple(cache["k"].shape),
            "k": dist.all_gather(cache["k"], "model", 1, mesh=mesh),
            "v": dist.all_gather(cache["v"], "model", 1, mesh=mesh)}


def run_serve(out_dir: str) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models.lm import replace_specs
    from repro_torch.serve import ServePlan, ServeSession

    inputs = torch.load(os.path.join(out_dir, "serve_inputs.pt"),
                        weights_only=False)
    cfg = get_config(SERVE_ARCH).reduced(vocab=SERVE_VOCAB)
    plan = ServePlan(arch=cfg, max_batch=SERVE_B,
                     max_len=SERVE_PROMPT + SERVE_GEN + 2,
                     wire="quantize_int8:physical", fused_entry=True)
    sess = ServeSession(plan, inputs["params"], device="cpu",
                        model=replace_specs(build_model(cfg),
                                            moe={"ep_axis": "model"}))
    toks = sess.generate(inputs["prompts"], SERVE_GEN)
    return {"tokens": toks, "bytes_per_token": sess.bytes_per_token()}


def rank_main(suite: str, rank: int, world: int, out_dir: str):
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh_compat
    from repro_torch.nn import dist as tdist

    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method="file://" + os.path.join(out_dir, "rendezvous"),
        rank=rank, world_size=world)
    mesh = make_mesh_compat((1, world), ("data", "model"), device="cpu")
    tdist.set_mesh(mesh)
    out = {}
    if suite == "perf":
        out["moe"] = {case: run_moe(case, mesh) for case in MOE_CASES}
        out["kv"] = {case: run_kv(case, mesh) for case in KV_CASES}
        out["counts"] = dict(mesh.counts)
        if world == 4:
            dm = make_mesh_compat((2, 2), ("data", "model"), device="cpu")
            tdist.set_mesh(dm)
            d = dm.coords["data"]
            out["dm"] = {"data": d, "model": dm.coords["model"],
                         **run_moe(DM_CASE, dm, rows=slice(2 * d,
                                                           2 * d + 2))}
    else:
        out["serve"] = run_serve(out_dir)
        out["counts"] = dict(mesh.counts)
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.destroy_process_group()


def start(suite: str, world: int, out_dir: str) -> list:
    """Start `world` ranks of `suite` (`_torch_fleet_ranks.collect` waits
    for them)."""
    import _torch_fleet_ranks

    return _torch_fleet_ranks.start(world, out_dir,
                                    [os.path.abspath(__file__), suite])


if __name__ == "__main__":
    rank_main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
