"""Baselines the paper compares against: federated averaging (McMahan et
al. 2017) and large-batch synchronous SGD (Chen et al. 2016); port of
`repro/core/baselines.py`.

DEPRECATED: these trainers are thin shims over `repro_torch.api.Plan`
(mode="fedavg" / mode="large_batch"): `train_round` / `train_step` run
the `FedAvgEngine` / `LargeBatchEngine` that the Plan compiles, sharing
the shim's `Meter`, so shim and Plan stay bitwise the same.
`backend="eager"` keeps the reference's per-client Python loops, which
ragged batches take too.  `apply_fn` takes `(params, x)`, as in the
reference.  The state lives on `device`: the GPU unless the caller
passes `device="cpu"`.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Callable

import torch

from repro_torch.api.plan import FullFns, Plan
from repro_torch.core.accounting import Meter, bytes_of_tree, flops_of_fn
from repro_torch.core.protocol import _init_gen, _ragged, _to
from repro_torch.core.split import _grads, _leaf_params
from repro_torch.device import resolve_device
from repro_torch.engine import stack_batches, stack_trees, unstack_tree
from repro_torch.nn.module import tree_map
from repro_torch.optim import apply_updates


def _warn_deprecated(name: str, mode: str):
    warnings.warn(
        f"{name} is deprecated; use repro_torch.api.Plan(mode={mode!r}, "
        "...) instead (same engine, one declarative surface)",
        DeprecationWarning, stacklevel=3)


def tree_mean(trees: list):
    return tree_map(lambda *xs: sum(xs[1:], xs[0]) / len(xs), *trees)


def _value_and_grad(loss_of, params):
    """(loss detached, d loss / d params) of `loss_of(params)`."""
    with torch.enable_grad():
        p = _leaf_params(params)
        loss = loss_of(p)
        return loss.detach(), _grads(loss, p)


class _Shim:
    """What the two baseline shims share: the device, the meter, the
    Plan they compile and the global model's evaluation."""

    def _setup(self, name: str, mode: str):
        _warn_deprecated(name, mode)
        self.device = resolve_device(self.device)
        self.meter = Meter(self.n_clients)
        self._flops_per_batch = None
        self._engine = None

    def _compiled(self, mode: str, **kw):
        if self._engine is None:
            sess = Plan(
                mode=mode,
                model=FullFns(init=self.init_fn,
                              apply=lambda p, b: self.apply_fn(p, b["x"])),
                loss_fn=self.loss_fn, optimizer=self.optimizer,
                n_clients=self.n_clients, **kw).compile(self.device)
            self._engine = sess.engine
            self._engine.meter = self.meter     # one shared meter
        return self._engine

    def _meter_flops(self, ci, p, x):
        if self._flops_per_batch is None:
            self._flops_per_batch = 3.0 * flops_of_fn(
                lambda pp, xx: self.apply_fn(pp, xx), p, x)
        self.meter.add_flops(ci, self._flops_per_batch)

    @torch.no_grad()
    def evaluate(self, state, batch):
        batch = _to(batch, self.device)
        logits = self.apply_fn(state["global"], batch["x"])
        return (logits.argmax(-1) == batch["labels"]).float().mean()


@dataclasses.dataclass
class FedAvgTrainer(_Shim):
    """Each round: every client trains `local_steps` full-model steps on
    its local data, then the server averages the models."""
    init_fn: Callable            # gen -> params
    apply_fn: Callable           # (params, x) -> logits
    loss_fn: Callable
    optimizer: Any
    n_clients: int
    local_steps: int = 1
    backend: str = "engine"      # "engine" | "eager"
    device: Any = None           # None -> the GPU

    def __post_init__(self):
        self._setup("FedAvgTrainer", "fedavg")

    @property
    def engine(self):
        return self._compiled("fedavg", local_steps=self.local_steps)

    def init(self, gen: torch.Generator | None = None, *, seed: int = 0):
        params = self.init_fn(_init_gen(gen, seed, self.device))
        return {"global": params,
                "opt": [self.optimizer.init(params)
                        for _ in range(self.n_clients)]}

    def _local_loss(self, params, batch):
        return self.loss_fn(self.apply_fn(params, batch["x"]),
                            batch["labels"])

    def train_round(self, state, client_batches: list[dict]):
        if self.backend == "eager" or _ragged(client_batches):
            return self._train_round_eager(state, client_batches)
        est = {"global": state["global"], "opt": stack_trees(state["opt"])}
        est, losses = self.engine.run_round(
            est, _to(stack_batches(client_batches), self.device))
        return {"global": est["global"],
                "opt": unstack_tree(est["opt"], self.n_clients)}, \
            losses.mean()

    def _train_round_eager(self, state, client_batches: list[dict]):
        locals_, losses = [], []
        for ci, batch in enumerate(client_batches):
            batch = _to(batch, self.device)
            p = state["global"]
            self.meter.bytes_down[ci] += bytes_of_tree(p)      # model pull
            opt = state["opt"][ci]
            for _ in range(self.local_steps):
                loss, g = _value_and_grad(
                    lambda pp: self._local_loss(pp, batch), p)
                self._meter_flops(ci, p, batch["x"])
                ups, opt = self.optimizer.update(g, opt, p)
                p = apply_updates(p, ups)
            state["opt"][ci] = opt
            self.meter.bytes_up[ci] += bytes_of_tree(p)        # model push
            locals_.append(p)
            losses.append(loss)
        state["global"] = tree_mean(locals_)
        return state, torch.stack(losses).mean()


@dataclasses.dataclass
class LargeBatchSGDTrainer(_Shim):
    """Synchronous data-parallel SGD: every step, every client computes a
    full-model gradient on its shard; the gradients are averaged."""
    init_fn: Callable
    apply_fn: Callable
    loss_fn: Callable
    optimizer: Any
    n_clients: int
    backend: str = "engine"      # "engine" | "eager"
    device: Any = None           # None -> the GPU

    def __post_init__(self):
        self._setup("LargeBatchSGDTrainer", "large_batch")

    @property
    def engine(self):
        return self._compiled("large_batch")

    def init(self, gen: torch.Generator | None = None, *, seed: int = 0):
        params = self.init_fn(_init_gen(gen, seed, self.device))
        return {"global": params, "opt": self.optimizer.init(params)}

    def train_step(self, state, client_batches: list[dict]):
        if self.backend == "eager" or _ragged(client_batches):
            return self._train_step_eager(state, client_batches)
        state, losses = self.engine.run_round(
            state, _to(stack_batches(client_batches), self.device))
        return state, losses.mean()

    def _train_step_eager(self, state, client_batches: list[dict]):
        grads, losses = [], []
        p = state["global"]
        for ci, batch in enumerate(client_batches):
            batch = _to(batch, self.device)
            loss, g = _value_and_grad(
                lambda pp: self.loss_fn(self.apply_fn(pp, batch["x"]),
                                        batch["labels"]), p)
            self._meter_flops(ci, p, batch["x"])
            # grad push + model pull (ring all-reduce ~ 2x param bytes)
            self.meter.bytes_up[ci] += bytes_of_tree(g)
            self.meter.bytes_down[ci] += bytes_of_tree(p)
            grads.append(g)
            losses.append(loss)
        ups, state["opt"] = self.optimizer.update(tree_mean(grads),
                                                  state["opt"], p)
        state["global"] = apply_updates(p, ups)
        return state, torch.stack(losses).mean()
