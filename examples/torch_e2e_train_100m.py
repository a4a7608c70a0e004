"""End-to-end driver over the PyTorch port: train a ~100M-parameter
transformer for a few hundred steps with the SPLIT protocol through the
Plan API (`examples/e2e_train_100m.py` over `repro_torch`): the model
registry, Plan -> Session, a warmup-cosine schedule, clipping, wire
accounting and checkpointing.

The ~100M model (12 layers, d 512, vocab 8192, fp32) runs on the GPU by
default; pass --tiny for a 2-layer sanity run, and --device cpu to run
on the CPU.  Checkpoints go to a temporary directory:

    PYTHONPATH=src python examples/torch_e2e_train_100m.py [--tiny]
"""
import argparse
import dataclasses
import os
import tempfile
import time

import torch

from repro_torch import checkpoint as ckpt
from repro_torch import optim
from repro_torch.api import Plan, lm_split_fns
from repro_torch.configs import get_config
from repro_torch.data import synthetic as syn
from repro_torch.device import resolve_device
from repro_torch.engine import tree_index
from repro_torch.models import build_model
from repro_torch.nn.module import param_count, tree_leaves


def config(tiny: bool):
    """(cfg, default steps, batch, seq)."""
    base = get_config("phi4_mini_3_8b")
    if tiny:
        return base.reduced(vocab=256), 80, 8, 32
    return dataclasses.replace(
        base, n_layers=12, d_model=512, n_heads=8, n_kv_heads=4,
        head_dim=64, d_ff=2048, vocab=8192, dtype=torch.float32,
        tie_embeddings=True), 300, 16, 128


def cut_of(cfg) -> int:
    return max(1, cfg.n_layers // 4)


def make_plan(model, cut: int, steps: int):
    sched = optim.schedules.warmup_cosine(3e-3, steps // 10, steps)
    return Plan(mode="vanilla", model=lm_split_fns(model, cut), cut=cut,
                optimizer=optim.adamw(sched, weight_decay=0.01),
                clip_norm=1.0)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--steps", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg, steps, batch, seq = config(args.tiny)
    steps = args.steps or steps

    model = build_model(cfg)
    n_params = param_count(model.init(torch.Generator(), device="meta"))
    print(f"arch={cfg.name}-custom params={n_params / 1e6:.1f}M "
          f"steps={steps}")

    cut = cut_of(cfg)
    sess = make_plan(model, cut, steps).compile(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    sess.init(gen)

    stream = syn.lm_stream(gen, batch=batch, seq=seq, vocab=cfg.vocab)
    t0 = time.time()
    hist = sess.fit(([next(stream)] for _ in range(steps)),
                    log_every=max(1, steps // 10))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.time() - t0
    tok_s = batch * seq * steps / wall

    pc = tree_index(sess.state["clients"], 0)
    with tempfile.TemporaryDirectory(prefix="e2e_") as tmp:
        path_c = os.path.join(tmp, "client")
        ckpt.save(path_c, pc, step=steps)
        ckpt.save(os.path.join(tmp, "server"), sess.state["server"],
                  step=steps)
        back = ckpt.restore(path_c, pc)
        assert all(torch.equal(a, b) for a, b in zip(
            tree_leaves(back), tree_leaves(pc))), "checkpoint did not restore"
        print(f"checkpoint roundtrip ok "
              f"({ckpt.load_manifest(path_c)['step']} steps)")
    report = sess.wire_report([next(stream)])
    client_gb = sess.meter()["client_gb"][0]
    print(f"client wire: {client_gb:.3f} GB over {steps} turns; "
          f"tok/s {tok_s:,.0f}")
    print(f"loss: {hist[0]:.3f} -> {hist[-1]:.3f}  wall={wall:.0f}s")
    assert hist[-1] < hist[0] - 0.5
    print("OK")
    return {"losses": hist, "params": n_params, "steps": steps,
            "tok_s": tok_s, "client_gb": client_gb, "wire_report": report}


if __name__ == "__main__":
    main()
