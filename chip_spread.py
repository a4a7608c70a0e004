#!/usr/bin/env python3
"""The run-to-run spread of the branch kinds' held-out accuracy on one
GPU, against the number of training rounds: why `chip_smoke.py` trains
multitask and extended_vanilla 30 rounds more before their accuracy
check.

Run from the root of a checkout, with no arguments (both parts below) or
with `resnet` (the second only):

    python3 chip_spread.py [resnet]

`chip_smoke.py`'s branch-kind paths (two full-width VGG-16 branches into
a 1024 -> 10 trunk, two 1024 -> 10 task heads, or a 1024 -> 512 ReLU mid
client and a 512 -> 10 trunk; 128 rows per modality, AdamW(1e-4), the
physical int8 wire, seed 0), in their joint round and pipelined with 2
microbatches, trained from the same state on the same batches 6 times
each for the round counts in `ROUND_COUNTS`, with `chip_smoke.py`'s data
(the rounds past its 30 on batches drawn after the held-out rows, as its
`EXTRA_ROUNDS` are); cuDNN's nondeterministic kernels make the runs
differ. Prints each run's accuracy on the 512
held-out rows (multitask: the lower task's), then per setting the least,
the largest, the mean and how many runs are at or below 3x chance
(`chip_smoke.py`'s limit).

Then ResNet-CIFAR100's held-out accuracy the same way over
`RESNET_REPEATS` runs of `chip_smoke.py`'s phase 3k path (full width,
cut 2, 4 clients round-robin with the p2p handoff, 128 rows a turn, 30
rounds, AdamW(1e-4), the physical wire): each client's accuracy on the
512 held-out rows of 100 classes, against the 3x chance limit that path
holds.
"""
from __future__ import annotations

import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
REPEATS = 6
RESNET_REPEATS = 3
ROUND_COUNTS = {"vertical": (30,), "multitask": (30, 60),
                "extended_vanilla": (30, 45, 60)}


def main():
    import torch
    if not torch.cuda.is_available():
        sys.exit("chip_spread: torch.cuda.is_available() is false: this "
                 "needs a GPU")
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.api import leakage_probe, quantize_int8
    from repro_torch.configs.vgg_cifar10 import CONFIG

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(cs.card_line())
    if sys.argv[1:] != ["resnet"]:
        branch_spread(torch, cs, CONFIG, leakage_probe, quantize_int8)
    resnet_spread(torch, cs, leakage_probe, quantize_int8)


def branch_spread(torch, cs, CONFIG, leakage_probe, quantize_int8):
    spread = {}
    for mode, counts in ROUND_COUNTS.items():
        for rounds in counts:
            for schedule in (None, "pipelined"):
                name = f"{mode} {schedule or 'joint round'} {rounds} rounds"
                spread[name] = [_accuracy(torch, cs, CONFIG, mode, schedule,
                                          rounds, [quantize_int8(
                                              physical=True),
                                              leakage_probe()], name, rep)
                                for rep in range(REPEATS)]
    for name, accs in spread.items():
        low = sum(a <= 3 / cs.N_CLASSES for a in accs)
        print(f"{name}: accuracy {min(accs):.4f} to {max(accs):.4f}, mean "
              f"{statistics.mean(accs):.4f}; {low} of {len(accs)} at or "
              f"below 3x chance")


def _accuracy(torch, cs, cfg, mode, schedule, rounds, wire, name, rep):
    """One training run of `rounds` rounds from seed 0; its held-out
    accuracy (multitask: the lower of the two tasks')."""
    sess = cs._branch_plan(cfg, 512, wire, mode, schedule)[1].compile()
    sess.init(seed=cs.SEED)
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 7)
    batches = cs._modality_batches(torch, gen, cs.ROUNDS + 5, cs.TB,
                                   cs.N_CLASSES)[:cs.ROUNDS]
    ev = cs._modality_batches(torch, gen, 1, cs.EVAL_B, cs.N_CLASSES)[0]
    batches += cs._modality_batches(torch, gen, rounds - cs.ROUNDS, cs.TB,
                                    cs.N_CLASSES)
    if mode == "multitask":
        batches = [cs._task_labels(torch, b) for b in batches]
        ev = cs._task_labels(torch, ev)
    losses = sess.fit(lambda r: batches[r], rounds=rounds)
    with torch.no_grad():
        logits = sess.engine.topology.evaluate(sess.state["clients"],
                                               sess.state["server"], ev)
    acc = min(torch.atleast_1d((logits.argmax(-1) == ev["labels"])
                               .float().mean(-1)).tolist())
    print(f"{name} run {rep}: last 5 losses' mean "
          f"{statistics.mean(losses[-5:]):.4f}, accuracy {acc:.4f}",
          flush=True)
    return acc


def resnet_spread(torch, cs, leakage_probe, quantize_int8):
    from repro_torch.configs.resnet50_cifar100 import CONFIG
    from repro_torch.data.synthetic import image_batch

    accs = []
    for rep in range(RESNET_REPEATS):
        sess = cs._resnet_plan(CONFIG, [quantize_int8(physical=True),
                                        leakage_probe()],
                               cs.V_CLIENTS).compile()
        sess.init(seed=cs.SEED)
        gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 50)
        batches = cs._client_batches(gen, cs.V_ROUNDS + 1, cs.V_CLIENTS,
                                     cs.VB, cs.R_CLASSES)
        ev = image_batch(gen, cs.EVAL_B, cs.R_CLASSES)
        ev = {"x": ev["images"], "labels": ev["labels"]}
        losses = sess.fit(lambda r: batches[r], rounds=cs.V_ROUNDS)
        run = sess.evaluate_all(ev).tolist()
        print(f"resnet run {rep}: last 5 losses' mean "
              f"{statistics.mean(losses[-5:]):.4f}, accuracy per client "
              f"{run}", flush=True)
        accs += run
        del sess
        torch.cuda.empty_cache()
    low = sum(a <= 3 / cs.R_CLASSES for a in accs)
    print(f"resnet {cs.V_ROUNDS} rounds: accuracy {min(accs):.4f} to "
          f"{max(accs):.4f}, mean {statistics.mean(accs):.4f}; {low} of "
          f"{len(accs)} at or below 3x chance ({3 / cs.R_CLASSES:.2f})")


if __name__ == "__main__":
    main()
