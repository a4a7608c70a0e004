"""`Plan` — the declarative description of a training run (port of
`repro/api/plan.py`).

A `Plan` names the collaboration mode, where the cut falls, who the
parties are (`n_clients`), how turns are scheduled, the optimizers, the
loss and an ordered stack of `WireTransform` middleware applied at the
cut.  `Plan.compile()` lowers it onto the step-program IR and wraps the
engine in a `Session`:

    sess = Plan(mode="vanilla", model=seg_model, cut=2, n_clients=4,
                wire=[quantize_int8(physical=True)]).compile()
    sess.fit(data, rounds=30)
    print(sess.meter(), sess.wire_report(batches))

Ported modes and their required fields:

  vanilla   model (SegModel), cut; round_robin, sync "p2p" or "none"
  vertical  branch, trunk=(init, apply)

The other six modes, LM training (a `SplitFns` model) and the parallel
and pipelined schedules raise, naming ROADMAP.md.  `compile()` runs on
the GPU unless given `device="cpu"`, and raises without one.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Sequence

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
PORTED_MODES = ("vanilla", "vertical")
BRANCH_MODES = ("vertical", "multitask", "extended_vanilla")


def softmax_xent(logits, labels):
    """Default loss: softmax cross-entropy over the last axis, in
    float32.  `labels` are int64 class indices."""
    lp = torch.log_softmax(logits.float(), -1)
    return -lp.gather(-1, labels.long()[..., None]).mean()


@dataclasses.dataclass(frozen=True)
class SplitFns:
    """Vanilla-split hooks over an opaque model (the LM family): init the
    full tree, split it at the cut, run each side.  Training over them is
    not ported yet (ROADMAP.md)."""
    init: Callable            # gen -> full params
    split: Callable           # full params -> (client, server)
    client_apply: Callable    # (pc, batch) -> cut activation
    server_apply: Callable    # (ps, act) -> logits
    full_apply: Callable | None = None   # (params, batch) -> logits


def _clipped(opt, max_norm: float):
    def update(grads, state, params=None):
        grads, _ = optim.clip_by_global_norm(grads, max_norm)
        return opt.update(grads, state, params)
    return optim.Optimizer(opt.init, update)


@dataclasses.dataclass(frozen=True)
class Plan:
    mode: str
    model: Any = None                     # vanilla: SegModel
    cut: int | None = None                # vanilla
    branch: sp.Branch | None = None       # vertical: one per client
    trunk: tuple | None = None            # (init, apply)
    n_clients: int = 1
    schedule: str | None = None           # None -> the mode's default
    sync: str = "p2p"                     # "p2p" | "none" (round_robin)
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

    @property
    def effective_schedule(self) -> str:
        sched = {"serial": "round_robin"}.get(self.schedule, self.schedule)
        if self.mode in BRANCH_MODES:
            # branch fan-in kinds have no turn axis: one joint round
            return "pipelined" if sched == "pipelined" else "parallel"
        return sched or "round_robin"

    def _topology(self) -> topo.Topology:
        if self.mode == "vanilla":
            self._require(self.cut is not None, "needs cut=")
            if isinstance(self.model, SplitFns):
                raise NotImplementedError(
                    "Plan(mode='vanilla') over SplitFns (LM training) is "
                    "not ported yet: the port trains a SegModel; see "
                    "ROADMAP.md")
            self._require(isinstance(self.model, sp.SegModel),
                          "needs model= (SegModel or SplitFns)")
            return topo.vanilla(self.model, self.cut)
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
            n_clients=self.n_clients, schedule=self.effective_schedule,
            sync=self.sync, wire_stack=stack if stack else None)
        return _session.Session(self, engine, stack, dev)
