"""Resource accounting: client FLOPs and communication bytes (port of
`repro/core/accounting.py:30-245`).

The live meters: `probe_wire_records` finds the wire records of one
grads call from a run on meta tensors (shapes only, no device work, as
the reference traces under `jax.eval_shape`); `flops_of_fn` counts a
function's FLOPs with `torch.utils.flop_counter.FlopCounterMode`, also
on meta tensors.  The reference asks XLA's cost model instead, which
also counts elementwise work: the torch counter counts the matmuls and
convolutions only (tests/test_torch_train.py holds the ratio).

The analytic costs of the paper's Tables 1 and 2 (`ProtocolCost`,
`paper_table1_setup`, `paper_table2_setup`) are closed forms over the
architectures' shapes: per-client TFLOPs and GB of SplitNN, FedAvg and
large-batch SGD for a whole training run.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.nn.convnets import VGG16_PLAN
from repro_torch.nn.module import param_bytes, tree_map


def to_meta(tree):
    """`tree` with every tensor replaced by a meta tensor of its shape
    and dtype."""
    return tree_map(lambda t: t.to("meta") if isinstance(t, torch.Tensor)
                    else t, tree)


def probe_wire_records(grads_fn, *args) -> list:
    """Run `grads_fn(*args, wires)` once on meta copies of `args` and
    return the `WireRecord`s it emitted.  With a physical transform the
    records are priced from the packed payload's real tensors
    (`wire_compress.payload_nbytes`, checked against the `bytes_fn`
    claim), which meta tensors carry exactly; no kernel is launched."""
    wires: list = []
    grads_fn(*to_meta(args), wires)
    return wires


@dataclasses.dataclass(frozen=True)
class TurnCost:
    """Static cost of one turn: its wire records, client flops and the
    p2p weight-handoff bytes."""
    wires: tuple            # tuple[WireRecord]
    flops: float
    sync_bytes: int

    @property
    def bytes_up(self) -> int:
        return sum(w.bytes for w in self.wires if w.direction == "up")

    @property
    def bytes_down(self) -> int:
        return sum(w.bytes for w in self.wires if w.direction == "down")


def flops_of_fn(fn, *args) -> float:
    """FLOPs of fn(*args) (per call) from torch's flop counter, on meta
    copies of `args`."""
    from torch.utils.flop_counter import FlopCounterMode
    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        fn(*to_meta(args))
    return float(counter.get_total_flops())


def bytes_of_tree(tree) -> int:
    return param_bytes(tree)


class Meter:
    """Per-client cumulative resource meters."""

    def __init__(self, n_clients: int):
        self.flops = [0.0] * n_clients
        self.bytes_up = [0] * n_clients
        self.bytes_down = [0] * n_clients
        self.sync_bytes = [0] * n_clients

    def add_flops(self, ci, f):
        self.flops[ci] += f

    def add_wires(self, ci, wires):
        for w in wires:
            if w.direction == "up":
                self.bytes_up[ci] += w.bytes
            else:
                self.bytes_down[ci] += w.bytes

    def totals(self) -> dict:
        return {
            "client_tflops": [f / 1e12 for f in self.flops],
            "client_gb": [(u + d + s) / 1e9 for u, d, s in
                          zip(self.bytes_up, self.bytes_down,
                              self.sync_bytes)],
        }


# ---------------------------------------------------------------------------
# Analytic costs for the paper's architectures
# ---------------------------------------------------------------------------

def vgg16_flops_per_sample(hw: int = 32, in_ch: int = 3,
                           upto_layer: int | None = None) -> float:
    """Forward FLOPs (a multiply-add is 2) of VGG-16's convs on hw x hw
    inputs, plus its classifier; `upto_layer` counts only the first k
    conv/pool entries (the split-learning client share), no classifier."""
    plan = VGG16_PLAN if upto_layer is None else VGG16_PLAN[:upto_layer]
    flops = 0.0
    ch, size = in_ch, hw
    for item in plan:
        if item == "M":
            size //= 2
        else:
            flops += 2.0 * 9 * ch * item * size * size
            ch = item
    if upto_layer is None:
        flops += 2.0 * ch * 512 + 2.0 * 512 * 10     # classifier
    return flops


def vgg16_param_count() -> int:
    params, ch = 0, 3
    for item in VGG16_PLAN:
        if item != "M":
            params += 9 * ch * item + item
            ch = item
    params += ch * 512 + 512 + 512 * 10 + 10
    return params


def resnet50_flops_per_sample(hw: int = 32) -> float:
    """The canonical ResNet-50 cost (4.1 GMACs at 224^2) scaled to hw x hw
    inputs by (hw/224)^2 (spatial convs dominate)."""
    return 4.1e9 * 2 * (hw / 224.0) ** 2 / 2


def resnet50_param_count() -> int:
    return 25_557_032


@dataclasses.dataclass(frozen=True)
class ProtocolCost:
    """Closed-form per-client resource costs of one training run."""
    n_total: int            # dataset size
    n_clients: int
    epochs: int
    full_flops_fwd: float   # per-sample forward flops, whole model
    client_flops_fwd: float  # per-sample forward flops, client share
    param_bytes_full: int
    param_bytes_client: int
    cut_act_bytes: int      # bytes of the cut activation per sample
    rounds: int | None = None   # fedavg sync rounds (default: epochs)
    steps: int | None = None    # lbsgd steps (default: epochs * n_local)
    label_bytes: int = 4

    @property
    def n_local(self) -> int:
        return self.n_total // self.n_clients

    def fedavg(self) -> dict:
        r = self.rounds if self.rounds is not None else self.epochs
        return {"tflops": 3 * self.full_flops_fwd * self.n_local
                * self.epochs / 1e12,
                "gb": 2 * self.param_bytes_full * r / 1e9}

    def lbsgd(self) -> dict:
        # sync-SGD all-reduces every local step (local batch 32)
        steps = self.steps if self.steps is not None \
            else self.epochs * max(2, self.n_local // 32)
        return {"tflops": 3 * self.full_flops_fwd * self.n_local
                * self.epochs / 1e12,
                "gb": 2 * self.param_bytes_full * steps / 1e9}

    def splitnn(self, *, sync: str = "p2p") -> dict:
        wire = 2 * self.cut_act_bytes * self.n_local * self.epochs \
            + self.label_bytes * self.n_local * self.epochs
        if sync == "p2p":
            wire += 2 * self.param_bytes_client * self.epochs
        return {"tflops": 3 * self.client_flops_fwd * self.n_local
                * self.epochs / 1e12,
                "gb": wire / 1e9}


def paper_table1_setup(n_clients: int, *, epochs: int = 100,
                       cut_layer: int = 1) -> ProtocolCost:
    """VGG-16 / CIFAR-10 (50k samples), cut after `cut_layer` conv layers
    (the paper's client share is tiny: a cut right after the first conv)."""
    act_bytes = 32 * 32 * 64 * 4                  # 64 channels at the cut
    client_params = 9 * 3 * 64 + 64
    if cut_layer >= 2:
        client_params += 9 * 64 * 64 + 64
    return ProtocolCost(
        n_total=50_000, n_clients=n_clients, epochs=epochs,
        full_flops_fwd=vgg16_flops_per_sample(),
        client_flops_fwd=vgg16_flops_per_sample(upto_layer=cut_layer),
        param_bytes_full=vgg16_param_count() * 4,
        param_bytes_client=client_params * 4,
        cut_act_bytes=act_bytes)


def paper_table2_setup(n_clients: int, *, epochs: int = 100) -> ProtocolCost:
    """ResNet-50 / CIFAR-100 (50k samples), cut after the stem."""
    act_bytes = 32 * 32 * 64 * 4                  # stem output fp32
    stem_params = 9 * 3 * 64 + 64
    return ProtocolCost(
        n_total=50_000, n_clients=n_clients, epochs=epochs,
        full_flops_fwd=resnet50_flops_per_sample(),
        client_flops_fwd=2.0 * 9 * 3 * 64 * 32 * 32,
        param_bytes_full=resnet50_param_count() * 4,
        param_bytes_client=stem_params * 4,
        cut_act_bytes=act_bytes)
