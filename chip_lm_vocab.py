#!/usr/bin/env python3
"""Why `chip_smoke.py`'s LM paths draw their token ids from the first
`LM_DATA_VOCAB` ids: their loss over 30 rounds on one GPU, with the ids
drawn from the model's whole vocabulary and from the first
`LM_DATA_VOCAB`.

Run from the root of a checkout, with no arguments (both parts) or with
`cli` (the second only):

    python3 chip_lm_vocab.py [cli]

`chip_smoke.py`'s two round-robin LM paths (Mamba2-130M whole, 2
clients; phi4-mini at full width with 4 layers, 1 client; fp32, AdamW at
its rate, the physical int8 wire, seed 0), each trained 30 rounds from
the same init on `lm_batch` tokens of each data vocabulary.  Prints each
run's per-round losses and the means of its first 5 and last 5 rounds,
the comparison `chip_smoke.py` holds.

Then the training CLI's two 30-step runs of `chip_smoke.py`'s phase 3k
(`repro_torch.launch.train`: Mamba2-130M whole, 2 clients over
`CLI_WIRE`; RecurrentGemma-2B cut to `CLI_RG_LAYERS` layers, 1 client
over the physical wire; bf16, batch 8 x seq 512), each at AdamW 1e-3 (the
CLI's default) and 1e-4, with the CLI's own ids (the whole vocabulary)
and with ids below `LM_DATA_VOCAB`: each run's first and final loss, the
comparison the CLI's JSON line gives.
"""
from __future__ import annotations

import os
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def main():
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch
    if not torch.cuda.is_available():
        sys.exit("chip_lm_vocab: torch.cuda.is_available() is false: this "
                 "needs a GPU")
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.api import leakage_probe, quantize_int8
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.card_line())
    build.build()
    if sys.argv[1:] != ["cli"]:
        plan_runs(torch, cs, leakage_probe, quantize_int8)
    cli_runs(torch, cs)


def plan_runs(torch, cs, leakage_probe, quantize_int8):
    for arch in cs.LM_RUNS:
        vocab = cs._lm_config(torch, arch).vocab
        for data_vocab in (vocab, cs.LM_DATA_VOCAB):
            sess = cs._lm_plan(torch, arch, [quantize_int8(physical=True),
                                             leakage_probe()]).compile()
            sess.init(seed=cs.SEED)
            gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 21)
            batches = cs._lm_batches(gen, cs.L_ROUNDS, cs.LM_RUNS[arch][2],
                                     cs.LB, cs.LS, data_vocab)
            losses = sess.fit(lambda r: batches[r], rounds=cs.L_ROUNDS)
            print(f"{arch}, ids below {data_vocab}, AdamW({cs.LR}): first-5 "
                  f"mean {statistics.mean(losses[:5]):.4f}, last-5 mean "
                  f"{statistics.mean(losses[-5:]):.4f}; losses "
                  f"{[round(x, 4) for x in losses]}", flush=True)
            del sess, batches
            torch.cuda.empty_cache()



def cli_runs(torch, cs):
    import contextlib
    import io

    from repro_torch.launch import train

    runs = {"mamba2_130m": ["--mode", "split", "--n-clients", "2", "--wire",
                            cs.CLI_WIRE],
            "recurrentgemma_2b": ["--mode", "split", "--n-clients", "1",
                                  "--wire", "quantize_int8:physical"]}
    for arch, argv in runs.items():
        cfg = cs.cli_config(torch, arch)
        for lr in (1e-3, 1e-4):
            for data_vocab in (None, cs.CLI_DATA_VOCAB):
                with contextlib.redirect_stdout(io.StringIO()):
                    run = train.main(
                        ["--arch", arch, "--batch", str(cs.CLI_B), "--seq",
                         str(cs.CLI_S), "--steps", str(cs.CLI_STEPS),
                         "--lr", str(lr), "--log-every", "0"] + argv,
                        cfg=cfg, data_vocab=data_vocab)
                ls = run.losses
                print(f"CLI {arch} ({cfg.n_layers} layers, bf16), ids below "
                      f"{data_vocab or cfg.vocab}, AdamW({lr}): first "
                      f"{ls[0]:.4f}, final {ls[-1]:.4f}; first-5 mean "
                      f"{statistics.mean(ls[:5]):.4f}, last-5 mean "
                      f"{statistics.mean(ls[-5:]):.4f}; losses "
                      f"{[round(x, 4) for x in ls]}", flush=True)
                del run
                torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
