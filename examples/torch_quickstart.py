"""Quickstart over the PyTorch port: train a small transformer with
SplitNN through the Plan API (`examples/quickstart.py` over
`repro_torch`).

Two parties: a client (owns the data and the first `CUT` blocks) and a
server (owns the rest).  Only the cut-layer activation and its gradient
ever cross the boundary: `wire_report` shows exactly what moved, and a
`quantize_int8` middleware squeezes it 4x without stopping learning.
Runs on the GPU unless `--device cpu`:

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""
import argparse

import torch

from repro_torch import optim
from repro_torch.api import Plan, lm_split_fns, quantize_int8
from repro_torch.configs import get_config
from repro_torch.data import synthetic as syn
from repro_torch.device import resolve_device
from repro_torch.models import build_model

CUT = 1
STEPS = 60
BATCH, SEQ = 8, 32


def config():
    return get_config("phi4_mini_3_8b").reduced(vocab=128)


def make_plan(cfg):
    return Plan(
        mode="vanilla",                      # the paper's section 3 setting
        model=lm_split_fns(build_model(cfg), CUT),  # client [0, CUT)
        cut=CUT,
        n_clients=1,
        optimizer=optim.adamw(5e-3),
        wire=[quantize_int8()],              # int8 middleware at the cut
    )


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = config()
    model = build_model(cfg)
    sess = make_plan(cfg).compile(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    sess.init(gen)

    stream = syn.lm_stream(gen, batch=BATCH, seq=SEQ, vocab=cfg.vocab)
    losses = sess.fit(([next(stream)] for _ in range(STEPS)),
                      log_every=10)

    print("\nwire_report: the ONLY tensors the server ever sees:")
    report = sess.wire_report([next(stream)])
    for w in report:
        print(f"  {w['name']:9s} {w['direction']:4s} shape={w['shape']} "
              f"{w['bytes']} bytes on the wire (int8-quantized)")
    print(f"loss {losses[0]:.3f} -> {losses[-1]:.3f}  (client owns embed + "
          f"{CUT} block, server owns {model.flat_layers() - CUT} blocks + "
          "head)")
    assert losses[-1] < losses[0], "did not learn!"
    print("OK")
    return {"losses": losses, "wire_report": report}


if __name__ == "__main__":
    main()
