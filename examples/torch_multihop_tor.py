"""Tor-like multi-hop split learning (paper section 5.1, Fig. 4c) over the
PyTorch port's Plan API (`examples/multihop_tor.py` over `repro_torch`).

A chain of parties each owns a contiguous slab of layers; activations hop
client -> client -> ... -> server, gradients hop back.  No hop ever sees
another hop's weights or the raw data (only hop 0 holds the input).
Runs on the GPU unless `--device cpu`:

    PYTHONPATH=src python examples/torch_multihop_tor.py [--device cpu]
"""
import argparse

import torch

from repro_torch import optim
from repro_torch.api import Plan, softmax_xent
from repro_torch.core import split as sp
from repro_torch.data import synthetic as syn
from repro_torch.device import resolve_device
from repro_torch.nn import convnets as C
from repro_torch.nn.module import mix_seed

CUTS = [1, 3, 5]            # 3 client hops + the server slab
STEPS = 40
ROWS, N_CLASSES = 64, 4
CFG = C.CNNConfig(name="hops", width_mult=0.25,
                  plan=(16, 16, "M", 32, "M"), n_classes=N_CLASSES)


def make_plan():
    plan_layers = C.vgg_plan(CFG)
    model = sp.list_segmodel(
        n_segments=len(plan_layers),
        init=lambda g: C.vgg_init(g, CFG),
        layer_apply=lambda p, i, x: C.vgg_layer_apply(p, plan_layers[i], x))
    return Plan(mode="multihop", model=model, cuts=CUTS, n_clients=1,
                loss_fn=softmax_xent, optimizer=optim.adamw(3e-3))


def batches(r: int, device):
    """Round `r`'s one-client batch, from a generator seeded from (0, r)."""
    gen = torch.Generator(device=device).manual_seed(mix_seed(0, r))
    b = syn.image_batch(gen, ROWS, N_CLASSES)
    return [{"x": b["images"], "labels": b["labels"]}]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    sess = make_plan().compile(dev)
    sess.init(seed=0)

    losses = sess.fit(lambda r: batches(r, dev), rounds=STEPS,
                      log_every=10)
    report = sess.wire_report(batches(0, dev))
    print("hops on the wire:", [w["name"] for w in report])
    print(f"\nloss {losses[0]:.3f} -> {losses[-1]:.3f} across "
          f"{len(CUTS) + 1} slabs")
    assert losses[-1] < losses[0]
    print("OK")
    return {"losses": losses, "wire_report": report}


if __name__ == "__main__":
    main()
