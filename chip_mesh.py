#!/usr/bin/env python3
"""What the sharded serving paths cost at one rank on one GPU, over an
NCCL group of one rank, and how deep `chip_smoke.py` phase 3t's CLI runs
can train: the measurements behind `chip_smoke.T_RUNS` and `PERF.md`.

Run from the root of a checkout, with no arguments:

    python3 chip_mesh.py

1. The host time of one `all_reduce` over the one-rank "model" axis of a
   `make_mesh_compat((1, 1), ("data", "model"))` mesh, a (4, 2048) bf16
   tensor (a Qwen3-30B-A3B decode row), `REPS` calls: the same tensor
   over and over, 48 tensors in turn, and each call after a 1 GB
   elementwise op (host clock without and with a final synchronize).
2. Qwen3-30B-A3B cut to `EP_LAYERS` layers served split as phase 3l
   serves it, the single-device path and the EP one (`ep_axis="model"`)
   in the order single, EP, EP, single: ms a decode step over `STEPS`
   steps, then the profiler's host time a call of `c10d::allreduce_`
   and of `_ReduceFrom` over 2 profiled EP steps.
3. Phase 3t's CLI runs for 3 steps at `T_RUNS`'s depth and client count,
   and at the next depth, and over 2 clients where `T_RUNS` takes 1: the
   peak allocated GiB of each, or that it ran out of memory.

Prints each reading with the card's name and power limit first.
"""
from __future__ import annotations

import dataclasses
import gc
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
REPS, EP_LAYERS, STEPS = 96, 8, 10


def allreduce_host(torch, mesh):
    from repro_torch.nn import dist as tdist

    xs = [torch.randn(4, 2048, device="cuda", dtype=torch.bfloat16)
          for _ in range(48)]
    big = torch.randn(256 << 20, device="cuda")
    cases = {"the same tensor": lambda i: tdist.all_reduce(xs[0], "model"),
             "48 tensors in turn": lambda i: tdist.all_reduce(xs[i % 48],
                                                               "model"),
             "after a 1 GB op": lambda i: (big.mul_(1.0), tdist.all_reduce(
                 xs[i % 48], "model"))}
    for what, fn in cases.items():
        for i in range(48):
            fn(i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(REPS):
            fn(i)
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        print(f"all_reduce, {what}: host {(t1 - t0) / REPS * 1e3:.4f} ms a "
              f"call, {(t2 - t0) / REPS * 1e3:.4f} with the synchronize")
    mesh.counts.clear()


def ep_decode(torch, cs):
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models.lm import replace_specs
    from repro_torch.serve import ServePlan, ServeSession

    cfg = dataclasses.replace(get_config(cs.EP_ARCH), n_layers=EP_LAYERS)
    base = build_model(cfg)
    models = {"single": base,
              "EP": replace_specs(base, moe={"ep_axis": "model"})}
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    params = base.init(gen, "cuda")
    prompts = torch.randint(0, cfg.vocab, (cs.B, cs.PROMPT), generator=gen,
                            device="cuda")
    plan = ServePlan(arch=cfg, wire="quantize_int8:physical",
                     max_batch=cs.B, max_len=cs.PROMPT + 3 + STEPS + 3,
                     fused_entry=True)
    kept = {}
    for name in ("single", "EP", "EP", "single"):
        sess = ServeSession(plan, params, device="cuda", model=models[name])
        tok = sess.prefill(prompts)
        for _ in range(3):
            tok = sess.decode_step(tok)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(STEPS):
            tok = sess.decode_step(tok)
        torch.cuda.synchronize()
        print(f"{cfg.name} {EP_LAYERS} layers, {name}: "
              f"{(time.perf_counter() - t0) / STEPS * 1e3:.3f} ms a decode "
              "step")
        kept[name] = sess, tok
    sess, tok = kept["EP"]
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            tok = sess.decode_step(tok)
        torch.cuda.synchronize()
    for e in prof.key_averages():
        if e.key in ("c10d::allreduce_", "_ReduceFrom", "record_param_comms"):
            us = e.cpu_time_total / e.count
            print(f"  profiled EP steps: {e.key} {us:.1f} us of host a call "
                  f"(CPU total), {e.count} calls")
    del params, sess, kept
    gc.collect()
    torch.cuda.empty_cache()


def depths(torch, cs):
    from repro_torch.configs import get_config

    # the runs that may run out of memory last
    runs = [(arch, n, k) for arch, (n, k) in cs.T_RUNS.items()]
    runs += [(arch, 1, 2) for arch, (_, k) in cs.T_RUNS.items() if k == 1]
    runs += [(arch, n + 1, k) for arch, (n, k) in cs.T_RUNS.items()]
    torch.cuda.memory._set_allocator_settings("expandable_segments:True")
    for arch, n, clients in runs:
        cfg = dataclasses.replace(get_config(arch), n_layers=n)
        argv = cs._cli_argv("depth", arch, cs.t_argv(clients), 3)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated() / 2 ** 30
        try:
            run, _ = cs._run_cli(torch, argv, cfg)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            print(f"{cfg.name} {n} layers over {clients} client(s): peak "
                  f"{peak:.2f} GiB ({held:.2f} held before)")
            del run
        except torch.OutOfMemoryError:
            print(f"{cfg.name} {n} layers over {clients} client(s): out of "
                  "memory")
        gc.collect()
        torch.cuda.empty_cache()
    torch.cuda.memory._set_allocator_settings("expandable_segments:False")


def main():
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch
    if not torch.cuda.is_available():
        sys.exit("chip_mesh: torch.cuda.is_available() is false: this needs "
                 "a GPU")
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import torch.distributed as dist

    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.launch.mesh import make_mesh_compat
    from repro_torch.nn import dist as tdist

    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"card: {cs.card_line()}")
    build.build()
    try:
        mesh = make_mesh_compat((1, 1), ("data", "model"))
        tdist.set_mesh(mesh)
        allreduce_host(torch, mesh)
        ep_decode(torch, cs)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    depths(torch, cs)


if __name__ == "__main__":
    main()
