"""The paper's Tables 1 and 2 and Fig. 3 (port of
`benchmarks/paper_tables.py`).

Table 1 (client TFLOPs, VGG-16 / CIFAR-10) and Table 2 (client GB,
ResNet-50 / CIFAR-100) are the protocol cost model's closed forms over
the paper's architectures (`core/accounting.py:paper_table1_setup`,
`paper_table2_setup`).  Fig. 3 is measured: SplitNN, federated averaging
and large-batch SGD train on one synthetic CIFAR-shaped data stream
through the deprecated shims (`core/protocol.py`, `core/baselines.py`),
and every 5 rounds each method's cumulative client TFLOPs (client 0's
meter) is paired with its accuracy on 256 held-out rows.

Assumptions (the paper does not publish its epoch or round counts):
100 epochs over CIFAR's 50k samples; FedAvg syncs once per epoch;
large-batch sync SGD all-reduces once per local step (batch 32); SplitNN
cuts after the first conv block and p2p-syncs client weights each epoch.

By default Fig. 3 runs the reference's smoke VGG (4 classes, 16 rows a
client a round, AdamW 3e-3); `--full` runs the paper's VGG-16 over 10
classes at 128 rows a client and AdamW 1e-4.  Runs on the GPU unless
`--device cpu`; prints each table row and each curve point as a JSON
line:

    PYTHONPATH=src python -m repro_torch.launch.paper_tables --device cpu
    PYTHONPATH=src python -m repro_torch.launch.paper_tables --full
"""
from __future__ import annotations

import argparse
import json

import torch

from repro_torch import optim
from repro_torch.api import softmax_xent
from repro_torch.configs import vgg_cifar10
from repro_torch.core import baselines as bl
from repro_torch.core import protocol as pr
from repro_torch.core import split as sp
from repro_torch.core.accounting import paper_table1_setup, paper_table2_setup
from repro_torch.data import synthetic as syn
from repro_torch.device import resolve_device
from repro_torch.nn import convnets as C

EVAL_ROWS, EVAL_SEED, EVAL_EVERY = 256, 777, 5
FULL = dict(cfg=vgg_cifar10.CONFIG, lr=1e-4, rows=128)


def table1_rows():
    rows = []
    for n in (100, 500):
        c = paper_table1_setup(n)
        rows.append(("large_batch_sgd", n, c.lbsgd()["tflops"]))
        rows.append(("federated_learning", n, c.fedavg()["tflops"]))
        rows.append(("splitnn", n, c.splitnn()["tflops"]))
    return rows


def table2_rows():
    rows = []
    for n in (100, 500):
        c = paper_table2_setup(n)
        rows.append(("large_batch_sgd", n, c.lbsgd()["gb"]))
        rows.append(("federated_learning", n, c.fedavg()["gb"]))
        rows.append(("splitnn", n, c.splitnn()["gb"]))
    return rows


def fig3_accuracy_vs_flops(rounds: int = 30, n_clients: int = 4,
                           seed: int = 0, *, cfg=vgg_cifar10.SMOKE,
                           lr: float = 3e-3, rows: int = 16, device=None):
    """Fig. 3 measured: (method, cumulative client TFLOPs, accuracy) every
    5 rounds on held-out rows, the three methods labelled `splitnn`,
    `federated` and `large_batch`.  Every method starts from the draw of
    a generator seeded with `seed` and trains on the same batches."""
    dev = resolve_device(device)
    plan = C.vgg_plan(cfg)
    model = sp.list_segmodel(
        n_segments=len(plan),
        init=lambda g: C.vgg_init(g, cfg),
        layer_apply=lambda p, i, x: C.vgg_layer_apply(p, plan[i], x))
    full = dict(init_fn=lambda g: C.vgg_init(g, cfg),
                apply_fn=lambda p, x: C.vgg_apply(p, cfg, x),
                loss_fn=softmax_xent, n_clients=n_clients, device=dev)
    tr = pr.SplitTrainer(model=model, cut=2, loss_fn=softmax_xent,
                         optimizer_client=optim.adamw(lr),
                         optimizer_server=optim.adamw(lr),
                         n_clients=n_clients, device=dev)
    fa = bl.FedAvgTrainer(optimizer=optim.adamw(lr), **full)
    lb = bl.LargeBatchSGDTrainer(optimizer=optim.adamw(lr), **full)
    st_s, st_f, st_l = (t.init(seed=seed) for t in (tr, fa, lb))

    ev = syn.image_batch(torch.Generator(device=dev).manual_seed(EVAL_SEED),
                         EVAL_ROWS, cfg.n_classes)
    evb = {"x": ev["images"], "labels": ev["labels"]}
    data = torch.Generator(device=dev).manual_seed(seed + 1)
    curve = []
    for r in range(rounds):
        b = syn.image_batch(data, rows * n_clients, cfg.n_classes)
        shards = [{"x": b["images"][i * rows:(i + 1) * rows],
                   "labels": b["labels"][i * rows:(i + 1) * rows]}
                  for i in range(n_clients)]
        st_s, _ = tr.train_round(st_s, shards)
        st_f, _ = fa.train_round(st_f, shards)
        st_l, _ = lb.train_step(st_l, shards)
        if (r + 1) % EVAL_EVERY == 0:
            curve.append(("splitnn", tr.meter.totals()["client_tflops"][0],
                          float(tr.evaluate(st_s, evb))))
            curve.append(("federated", fa.meter.totals()["client_tflops"][0],
                          float(fa.evaluate(st_f, evb))))
            curve.append(("large_batch",
                          lb.meter.totals()["client_tflops"][0],
                          float(lb.evaluate(st_l, evb))))
    return curve


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--full", action="store_true",
                    help="Fig. 3 over the paper's VGG-16 (10 classes, 128 "
                         "rows a client, AdamW 1e-4)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    args = ap.parse_args(argv)
    out = {"table1": table1_rows(), "table2": table2_rows(),
           "fig3": fig3_accuracy_vs_flops(
               device=args.device, **(FULL if args.full else {}))}
    for name, unit in (("table1", "client_tflops"), ("table2", "client_gb")):
        for method, n, v in out[name]:
            print(json.dumps({"table": name, "method": method,
                              "n_clients": n, unit: v}))
    for method, tflops, acc in out["fig3"]:
        print(json.dumps({"fig3": method, "client_tflops": tflops,
                          "accuracy": acc}))
    return out


if __name__ == "__main__":
    main()
