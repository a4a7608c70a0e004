"""`Plan` — the declarative description of a training run (port of
`repro/api/plan.py`).

A `Plan` names the collaboration mode (the paper's six split topologies
and the two baselines it compares against), where the cut falls, who the
parties are (`n_clients`), how turns are scheduled, the optimizers, the
loss and an ordered stack of `WireTransform` middleware applied at the
cut.  `Plan.compile()` lowers it onto the step-program IR and wraps the
engine in a `Session`:

    sess = Plan(mode="vanilla", model=seg_model, cut=2, n_clients=4,
                wire=[quantize_int8(physical=True)]).compile()
    sess.fit(data, rounds=30)
    print(sess.meter(), sess.wire_report(batches))

Modes and their required fields:

  vanilla           model (SegModel or SplitFns), cut
  u_shaped          model (SegModel), cuts=(c1, c2)
  vertical          branch, trunk=(init, apply)
  multihop          model (SegModel), cuts=[c0, c1, ...]
  multitask         branch, heads=((init, apply), ...)
  extended_vanilla  branch, mid=(init, apply), trunk=(init, apply)
  fedavg            model (SegModel, FullFns or SplitFns with
                    full_apply), local_steps
  large_batch       model (as fedavg)

The turn kinds run round-robin (sync "p2p" or "none") by default,
`schedule="parallel"` (SplitFed: every client against one server, which
steps on the mean cut gradient) or `schedule="pipelined",
microbatches=M` (each client batch streamed through the cut as M
microbatches).  The branch kinds run their joint round, streamed as M
microbatches under the pipelined schedule; so are the baselines'
gradients.  The LM family trains vanilla over `lm_split_fns(model, cut)`
and in the baselines over `FullFns(model.init, model.forward)`; fleets
raise, naming ROADMAP.md.  `compile()` runs on the GPU unless given
`device="cpu"`, and raises without one.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Sequence

import torch

from repro_torch import optim
from repro_torch.api import session as _session
from repro_torch.api.baseline import FedAvgEngine, LargeBatchEngine
from repro_torch.api.wire import WireStack, WireTransform, with_wire
from repro_torch.core import split as sp
from repro_torch.device import resolve_device
from repro_torch.engine import RoundEngine
from repro_torch.engine import topology as topo

MODES = ("vanilla", "u_shaped", "vertical", "multihop", "multitask",
         "extended_vanilla", "fedavg", "large_batch")
PORTED_MODES = MODES
BASELINE_MODES = MODES[6:]
BRANCH_MODES = ("vertical", "multitask", "extended_vanilla")


def softmax_xent(logits, labels):
    """Default loss: softmax cross-entropy over the last axis, in
    float32.  `labels` are int64 class indices."""
    lp = torch.log_softmax(logits.float(), -1)
    return -lp.gather(-1, labels.long()[..., None]).mean()


@dataclasses.dataclass(frozen=True)
class SplitFns:
    """Vanilla-split hooks over an opaque model (the `models.lm.LM`
    family): init the full tree, split it at the cut, run each side."""
    init: Callable            # gen -> full params
    split: Callable           # full params -> (client, server)
    client_apply: Callable    # (pc, batch) -> cut activation
    server_apply: Callable    # (ps, act) -> logits
    full_apply: Callable | None = None   # (params, batch) -> logits


def lm_split_fns(model, cut: int) -> SplitFns:
    """`SplitFns` for any model exposing the LM split hooks."""
    return SplitFns(
        init=model.init,
        split=lambda p: model.split_params(p, cut),
        client_apply=lambda pc, b: model.apply_client(pc, b, cut),
        server_apply=lambda ps, a: model.apply_server(ps, a, cut),
        full_apply=model.forward)


@dataclasses.dataclass(frozen=True)
class FullFns:
    """Whole-model hooks for the baseline modes (no cut)."""
    init: Callable            # gen -> params
    apply: Callable           # (params, batch) -> logits


def _full_fns(model) -> FullFns:
    """Any accepted model form as the baselines' (init, apply)."""
    if isinstance(model, FullFns):
        return model
    if isinstance(model, sp.SegModel):
        return FullFns(
            init=model.init,
            apply=lambda p, b: model.apply_range(p, b["x"], 0,
                                                 model.n_segments))
    if isinstance(model, SplitFns):
        if model.full_apply is None:
            raise ValueError("SplitFns.full_apply is required for the "
                             "baseline modes")
        return FullFns(init=model.init, apply=model.full_apply)
    raise TypeError(f"cannot run a baseline over {type(model).__name__}")


def _clipped(opt, max_norm: float):
    def update(grads, state, params=None):
        grads, _ = optim.clip_by_global_norm(grads, max_norm)
        return opt.update(grads, state, params)
    return optim.Optimizer(opt.init, update)


@dataclasses.dataclass(frozen=True)
class Plan:
    mode: str
    model: Any = None                     # SegModel | SplitFns | FullFns
    cut: int | None = None                # vanilla
    cuts: Sequence[int] | None = None     # u_shaped / multihop
    branch: sp.Branch | None = None       # branch modes: one per client
    trunk: tuple | None = None            # (init, apply)
    mid: tuple | None = None              # (init, apply) extended_vanilla
    heads: Sequence[tuple] | None = None  # ((init, apply), ...) multitask
    n_clients: int = 1
    schedule: str | None = None           # None -> the mode's default
    microbatches: int = 1                 # > 1: schedule="pipelined" only
    sync: str = "p2p"                     # "p2p" | "none" (round_robin)
    loss_fn: Callable = softmax_xent
    optimizer: "optim.Optimizer | None" = None  # None -> adamw(1e-3)
    optimizer_server: "optim.Optimizer | None" = None
    wire: Sequence[WireTransform] = ()
    local_steps: int = 1                  # fedavg
    clip_norm: float | None = None
    fleet: Any = None                     # not ported (ROADMAP)

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

    def _segmodel(self):
        self._require(isinstance(self.model, sp.SegModel),
                      "needs model= (SegModel)")
        return self.model

    def _topology(self) -> topo.Topology:
        m = self.mode
        if m == "vanilla":
            self._require(self.cut is not None, "needs cut=")
            if isinstance(self.model, SplitFns):
                return topo.vanilla_fns(self.model.init, self.model.split,
                                        self.model.client_apply,
                                        self.model.server_apply)
            self._require(isinstance(self.model, sp.SegModel),
                          "needs model= (SegModel or SplitFns)")
            return topo.vanilla(self.model, self.cut)
        if m == "u_shaped":
            model = self._segmodel()
            self._require(self.cuts is not None and len(self.cuts) == 2,
                          "needs cuts=(c1, c2)")
            return topo.u_shaped(model, *self.cuts)
        if m == "multihop":
            model = self._segmodel()
            self._require(bool(self.cuts), "needs cuts=[c0, ...]")
            return topo.multihop(model, list(self.cuts))
        self._require(self.branch is not None, "needs branch=")
        if m == "vertical":
            self._require(self.trunk is not None,
                          "needs trunk=(init, apply)")
            return topo.vertical(self.branch, self.n_clients, *self.trunk)
        if m == "multitask":
            self._require(bool(self.heads),
                          "needs heads=((init, apply), ...)")
            return topo.multitask(self.branch, self.n_clients,
                                  [h[0] for h in self.heads],
                                  [h[1] for h in self.heads])
        self._require(self.mid is not None and self.trunk is not None,
                      "needs mid=(init, apply) and trunk=(init, apply)")
        return topo.extended_vanilla(self.branch, self.n_clients,
                                     *self.mid, *self.trunk)

    def _baseline_engine(self, stack: WireStack, opt):
        fns = _full_fns(self.model)
        kw = dict(init_fn=fns.init, apply_fn=fns.apply, loss_fn=self.loss_fn,
                  optimizer=opt, n_clients=self.n_clients,
                  microbatches=self.microbatches,
                  wire_stack=stack if stack else None)
        if self.mode == "fedavg":
            return FedAvgEngine(local_steps=self.local_steps, **kw)
        return LargeBatchEngine(**kw)

    def compile(self, device=None) -> "_session.Session":
        """Lower this plan onto one engine and wrap it in a `Session`
        whose state lives on `device` (default the GPU)."""
        if self.mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, "
                             f"got {self.mode!r}")
        self._require(self.microbatches >= 1, "microbatches must be >= 1")
        self._require(self.microbatches == 1
                      or self.effective_schedule == "pipelined",
                      "microbatches > 1 requires schedule='pipelined'")
        if self.effective_schedule == "pipelined":
            self._require(self.fleet is None,
                          "the pipelined schedule is single-mesh only for "
                          "now (ROADMAP: double-buffer the cut across the "
                          "ring)")
        if self.fleet is not None:
            raise NotImplementedError(
                "a fleet (clients sharded over several devices) is not "
                "ported yet; see ROADMAP.md")
        dev = resolve_device(device)
        stack = WireStack(self.wire)
        opt_c, opt_s = self._optimizers()
        if self.mode in BASELINE_MODES:
            return _session.Session(self, self._baseline_engine(stack, opt_c),
                                    stack, dev)
        engine = RoundEngine(
            topology=with_wire(self._topology(), stack), loss_fn=self.loss_fn,
            optimizer_client=opt_c, optimizer_server=opt_s,
            n_clients=self.n_clients, schedule=self.effective_schedule,
            sync=self.sync, microbatches=self.microbatches,
            wire_stack=stack if stack else None)
        return _session.Session(self, engine, stack, dev)
