"""Resource accounting: client FLOPs and communication bytes (port of
`repro/core/accounting.py:30-120`).

The live meters: `probe_wire_records` finds the wire records of one
grads call from a run on meta tensors (shapes only, no device work, as
the reference traces under `jax.eval_shape`); `flops_of_fn` counts a
function's FLOPs with `torch.utils.flop_counter.FlopCounterMode`, also
on meta tensors.  The reference asks XLA's cost model instead, which
also counts elementwise work: the torch counter counts the matmuls and
convolutions only (tests/test_torch_train.py holds the ratio).  The
analytic Table 1/2 costs are not ported yet (ROADMAP).
"""
from __future__ import annotations

import dataclasses

import torch

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
