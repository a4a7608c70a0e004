#!/usr/bin/env python3
"""What the fleet (`Plan(fleet=FleetSpec(...))`) costs at one rank on one
GPU, over an NCCL group of one rank: why `nn/dist.py` sends a tree one
call a dtype and the round-robin fleet packs its handoff template once.

Run from the root of a checkout, with no arguments:

    python3 chip_fleet.py

1. `chip_smoke.py` phase 3s's VGG-16 paths (Table 1's setup: 4 clients of
   128 rows, the physical int8 wire, AdamW 1e-4), vanilla round-robin
   and parallel: ms a round of the single-device `Session` and of the
   one-rank fleet, `ROUNDS` rounds a run under CUDA events, in the order
   single, fleet, fleet, single, after two warm-up rounds each.
2. The round-robin round's closing broadcast (the server's 26 leaves,
   their 53 AdamW leaves and `last_trained`), synchronized, over `REPS`
   calls: `nn.dist.tree_replicate_from` (one call a dtype) against one
   `broadcast` a leaf.
3. The host time of one client's handoff template (`WireStack.
   handoff_pack` of its leaves on meta tensors), which the ring round
   builds once per engine.

Prints each reading with the card's name and power limit first.
"""
from __future__ import annotations

import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
ROUNDS = 8
REPS = 20


def main():
    import torch
    if not torch.cuda.is_available():
        sys.exit("chip_fleet: torch.cuda.is_available() is false: this "
                 "needs a GPU")
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import dataclasses

    import torch.distributed as dist

    import chip_smoke as cs
    from repro_torch.api import FleetSpec, leakage_probe, quantize_int8
    from repro_torch.configs.vgg_cifar10 import CONFIG
    from repro_torch.core.accounting import to_meta
    from repro_torch.engine import tree_at
    from repro_torch.kernels import build
    from repro_torch.nn import dist as tdist
    from repro_torch.nn.module import tree_leaves

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"card: {cs.card_line()}")
    build.build()
    phys = [quantize_int8(physical=True), leakage_probe()]
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 9)
    batches = cs._client_batches(gen, ROUNDS + 2, cs.V_CLIENTS, cs.VB,
                                 cs.N_CLASSES)
    fleet = None
    for schedule in (None, "parallel"):
        plan = cs._turn_plan(CONFIG, "vanilla", phys, cs.V_CLIENTS,
                             {"cut": cs.V_CUT}, schedule)
        sess = {"single device": plan.compile(),
                "fleet": dataclasses.replace(
                    plan, fleet=FleetSpec(n_devices=1)).compile()}
        for s in sess.values():
            s.init(seed=cs.SEED)
            for b in batches[:2]:
                s.run_round(b)
        ms: dict = {k: [] for k in sess}
        for name in ("single device", "fleet", "fleet", "single device"):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            for b in batches[2:]:
                sess[name].run_round(b)
            end.record()
            end.synchronize()
            ms[name].append(start.elapsed_time(end) / ROUNDS)
        print(f"vanilla {schedule or 'round-robin'}: ms a round over "
              f"{ROUNDS} rounds a run (CUDA events), single device "
              f"{[round(x, 3) for x in ms['single device']]}, fleet "
              f"{[round(x, 3) for x in ms['fleet']]}; fleet / single "
              f"{statistics.mean(ms['fleet']) / statistics.mean(ms['single device']):.3f}")
        if schedule is None:
            fleet = sess["fleet"]
        else:
            del sess

    state, mesh = fleet.state, fleet.engine.mesh
    tree = (state["server"], state["opt_s"], state["last_trained"])
    leaves = tree_leaves(tree)

    def per_leaf():
        for t in leaves:
            dist.broadcast(t, 0, group=mesh.group)

    for label, fn in (("one call a dtype (tree_replicate_from)",
                       lambda: tdist.tree_replicate_from(tree, mesh, 0)),
                      ("one call a leaf", per_leaf)) * 2:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(REPS):
            fn()
        torch.cuda.synchronize()
        print(f"closing broadcast of {len(leaves)} leaves, {label}: "
              f"{(time.perf_counter() - t0) / REPS * 1e3:.3f} ms a call "
              f"(host clock, synchronized, {REPS} calls)")

    client = tree_at(state["clients"], 0)
    stack = fleet.wire_stack
    for _ in range(2):
        t0 = time.perf_counter()
        for _ in range(REPS):
            stack.handoff_pack(to_meta(client))
        print(f"handoff template ({len(tree_leaves(client))} client leaves "
              f"packed on meta tensors): "
              f"{(time.perf_counter() - t0) / REPS * 1e3:.3f} ms of host")
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
