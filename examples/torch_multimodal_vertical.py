"""The paper's motivating health scenario (section 2, the vertical
configuration) over the PyTorch port's Plan API
(`examples/multimodal_vertical.py` over `repro_torch`):

    radiology center  (imaging features)  \\
                                            -> diagnosis server (trunk)
    pathology lab     (lab-test features) /

Neither institution shares raw data; each trains a private branch network
and ships ONLY its cut-layer features.  The server concatenates the
features (the fused splitcat kernel on the GPU) and trains the diagnosis
trunk.  Leakage of each branch's wire is quantified by distance
correlation: `Session.leakage_report` measures it through the wire
middleware stack.  Runs on the GPU unless `--device cpu`:

    PYTHONPATH=src python examples/torch_multimodal_vertical.py
"""
import argparse

import torch

import repro_torch.nn.layers as L
from repro_torch import optim
from repro_torch.api import Plan, leakage_probe, softmax_xent
from repro_torch.core import split as sp
from repro_torch.data import synthetic as syn
from repro_torch.device import resolve_device
from repro_torch.engine import tree_at
from repro_torch.kernels import ops
from repro_torch.nn.module import mix_seed

N_CLASSES = 4
DIM = 56                 # features per institution
DFEAT = 20               # cut-layer features each ships
STEPS = 80
ROWS = 64
EVAL_ROUND = 9999

branch = sp.Branch(
    init=lambda g: {"l1": L.dense_init(g, DIM, 40, bias=True),
                    "l2": L.dense_init(g, 40, DFEAT, bias=True)},
    apply=lambda p, x: L.dense_apply(
        p["l2"], torch.relu(L.dense_apply(p["l1"], x))))


def trunk_init(g):
    return L.dense_init(g, 2 * DFEAT, N_CLASSES, bias=True)


def trunk_apply(p, feats):
    return L.dense_apply(p, feats)


def make_plan():
    return Plan(mode="vertical", branch=branch, n_clients=2,
                trunk=(trunk_init, trunk_apply), loss_fn=softmax_xent,
                optimizer=optim.adamw(5e-3), wire=[leakage_probe()])


def batch(r: int, device):
    """Round `r`'s batch, from a generator seeded from (0, r)."""
    gen = torch.Generator(device=device).manual_seed(mix_seed(0, r))
    b = syn.multimodal_batch(gen, ROWS, N_CLASSES, dim_a=DIM, dim_b=DIM)
    return {"x": torch.stack([b["mod_a"], b["mod_b"]]),
            "labels": b["labels"]}


def fused_accuracy(sess, ev) -> float:
    """The server's trunk over both branches' features without the
    concat (`ops.splitcat_linear`, one launch on the GPU)."""
    fa = branch.apply(tree_at(sess.state["clients"], 0), ev["x"][0])
    fb = branch.apply(tree_at(sess.state["clients"], 1), ev["x"][1])
    tp = sess.state["server"]
    with torch.no_grad():
        logits = ops.splitcat_linear([fa, fb], tp["w"], tp["b"])
    return float((logits.argmax(-1) == ev["labels"]).float().mean())


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    sess = make_plan().compile(dev)
    sess.init(seed=0)

    losses = sess.fit(lambda r: batch(r, dev), rounds=STEPS,
                      log_every=20)
    report = sess.wire_report(batch(0, dev))
    print("wires:", [f"{w['name']}{w['shape']}" for w in report])

    # evaluation, also through the fused splitcat server entry
    ev = batch(EVAL_ROUND, dev)
    acc = float(sess.evaluate(ev))
    acc_fused = fused_accuracy(sess, ev)
    assert abs(acc - acc_fused) < 1e-6

    print(f"\ndiagnosis accuracy (multi-modal, no raw sharing): {acc:.3f}")
    print("leakage (distance correlation, raw vs wire):")
    leak = {}
    for name, ci in (("radiology", 0), ("pathology", 1)):
        leak[name] = float(sess.leakage_report(ev, client=ci)[
            "dcor_input_vs_act"])
        print(f"  {name}: {leak[name]:.3f}")
    assert acc > 0.8
    print("OK")
    return {"losses": losses, "wire_report": report, "accuracy": acc,
            "accuracy_fused": acc_fused, "leakage": leak}


if __name__ == "__main__":
    main()
