"""`Plan` — the declarative description of a training run (port of
`repro/api/plan.py`).

A `Plan` names the collaboration mode, who the parties are
(`n_clients`), the optimizers, the loss and an ordered stack of
`WireTransform` middleware applied at the cut.  `Plan.compile()` lowers
it onto the step-program IR and wraps the engine in a `Session`:

    sess = Plan(mode="vertical", branch=branch, trunk=(t_init, t_apply),
                n_clients=2, wire=[quantize_int8(physical=True)]).compile()
    sess.fit(batches, rounds=30)
    print(sess.meter(), sess.wire_report(batch))

This slice ports the vertical (multi-modal) mode; the other seven modes
raise, naming ROADMAP.md.  `compile()` runs on the GPU unless given
`device="cpu"`, and raises without one.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import torch

from repro_torch import optim
from repro_torch.api import session as _session
from repro_torch.api.wire import WireStack, WireTransform, with_wire
from repro_torch.core import split as sp
from repro_torch.device import resolve_device
from repro_torch.engine import RoundEngine
from repro_torch.engine import topology as topo

MODES = ("vanilla", "u_shaped", "vertical", "multihop", "multitask",
         "extended_vanilla", "fedavg", "large_batch")
PORTED_MODES = ("vertical",)


def softmax_xent(logits, labels):
    """Default loss: softmax cross-entropy over the last axis, in
    float32.  `labels` are int64 class indices."""
    lp = torch.log_softmax(logits.float(), -1)
    return -lp.gather(-1, labels.long()[..., None]).mean()


def _clipped(opt, max_norm: float):
    def update(grads, state, params=None):
        grads, _ = optim.clip_by_global_norm(grads, max_norm)
        return opt.update(grads, state, params)
    return optim.Optimizer(opt.init, update)


@dataclasses.dataclass(frozen=True)
class Plan:
    mode: str
    branch: sp.Branch | None = None       # vertical: one per client
    trunk: tuple | None = None            # (init, apply)
    n_clients: int = 1
    loss_fn: Callable = softmax_xent
    optimizer: "optim.Optimizer | None" = None  # None -> adamw(1e-3)
    optimizer_server: "optim.Optimizer | None" = None
    wire: Sequence[WireTransform] = ()
    clip_norm: float | None = None

    def _require(self, cond, msg):
        if not cond:
            raise ValueError(f"Plan(mode={self.mode!r}): {msg}")

    def _optimizers(self):
        opt_c = self.optimizer or optim.adamw(1e-3)
        opt_s = self.optimizer_server or opt_c
        if self.clip_norm is not None:
            opt_c, opt_s = (_clipped(opt_c, self.clip_norm),
                            _clipped(opt_s, self.clip_norm))
        return opt_c, opt_s

    def _topology(self) -> topo.Topology:
        self._require(self.branch is not None, "needs branch=")
        self._require(self.trunk is not None, "needs trunk=(init, apply)")
        return topo.vertical(self.branch, self.n_clients, *self.trunk)

    def compile(self, device=None) -> "_session.Session":
        """Lower this plan onto one engine and wrap it in a `Session`
        whose state lives on `device` (default the GPU)."""
        if self.mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, "
                             f"got {self.mode!r}")
        if self.mode not in PORTED_MODES:
            raise NotImplementedError(
                f"Plan(mode={self.mode!r}) is not ported yet: the port "
                f"trains {PORTED_MODES}; see ROADMAP.md for the order of "
                "the other modes")
        dev = resolve_device(device)
        stack = WireStack(self.wire)
        opt_c, opt_s = self._optimizers()
        engine = RoundEngine(
            topology=with_wire(self._topology(), stack), loss_fn=self.loss_fn,
            optimizer_client=opt_c, optimizer_server=opt_s,
            n_clients=self.n_clients)
        return _session.Session(self, engine, stack, dev)
