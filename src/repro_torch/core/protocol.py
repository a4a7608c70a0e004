"""Multi-client split-learning protocol (Gupta & Raskar 2018 scheduling;
port of `repro/core/protocol.py`).

N clients, one server.  Clients take turns (round-robin over local
batches); between turns, client weights move either peer-to-peer
("p2p": the next client pulls the last trained client's weights, billed
as client-side communication) or not at all ("none").  The server's
segment updates every step.  Meters accumulate per-client FLOPs and wire
bytes, so the Fig. 3 / Tables 1-2 comparisons come from the same loop
(`repro_torch.launch.paper_tables`).

DEPRECATED: these trainers are thin shims over the declarative
`repro_torch.api.Plan`.  Their engines come from
`Plan(mode=..., ...).compile(device)` and share the shim's `Meter`, so
a shim gives bitwise the `Plan`'s result; state stacking lives in
`repro_torch.engine.stack_state` / `unstack_state`.  `backend="eager"`
keeps the reference's per-turn Python loop over
`core.split.vanilla_split_grads`, which ragged batches take too.  The
state lives on `device`: the GPU unless the caller passes
`device="cpu"`.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Callable

import torch

from repro_torch.api.plan import Plan
from repro_torch.core import split as sp
from repro_torch.core.accounting import Meter, flops_of_fn
from repro_torch.device import resolve_device
from repro_torch.engine import (copy_tree, stack_batches, stack_state,
                                stack_trees, unstack_state, unstack_tree)
from repro_torch.optim import apply_updates


def _warn_deprecated(name: str):
    warnings.warn(
        f"{name} is deprecated; build a repro_torch.api.Plan instead "
        "(same engine, one declarative surface for every mode)",
        DeprecationWarning, stacklevel=3)


def _init_gen(gen, seed: int, device) -> torch.Generator:
    if gen is None:
        gen = torch.Generator(device=device).manual_seed(seed)
    return gen


def _to(batch: dict, device) -> dict:
    return {k: v.to(device) for k, v in batch.items()}


def _ragged(client_batches: list[dict]) -> bool:
    """True when per-client batches cannot be stacked along a client
    axis (unequal shapes, e.g. a dataset-remainder shard)."""
    sigs = {tuple(sorted((k, tuple(v.shape)) for k, v in b.items()))
            for b in client_batches}
    return len(sigs) > 1


@dataclasses.dataclass
class SplitTrainer:
    model: sp.SegModel
    cut: int
    loss_fn: Callable
    optimizer_client: Any
    optimizer_server: Any
    n_clients: int
    sync: str = "p2p"                       # "p2p" | "none"
    backend: str = "engine"                 # "engine" | "eager"
    schedule: str = "round_robin"           # engine backend only
    device: Any = None                      # None -> the GPU

    def __post_init__(self):
        _warn_deprecated("SplitTrainer")
        self.device = resolve_device(self.device)
        self.meter = Meter(self.n_clients)
        self._client_flops_per_batch = None
        self._engine = None

    @property
    def engine(self):
        """The engine, built through the Plan API so the shim stays
        bitwise `Plan(mode="vanilla", ...).compile(device)`."""
        if self._engine is None:
            sess = Plan(
                mode="vanilla", model=self.model, cut=self.cut,
                loss_fn=self.loss_fn, optimizer=self.optimizer_client,
                optimizer_server=self.optimizer_server,
                n_clients=self.n_clients, schedule=self.schedule,
                sync=self.sync).compile(self.device)
            self._engine = sess.engine
            self._engine.meter = self.meter     # one shared meter
        return self._engine

    def init(self, gen: torch.Generator | None = None, *, seed: int = 0):
        """Every client starts from the same draw (the paper's setting),
        as `Session.init` draws it from `gen` (default: a generator on
        the shim's device seeded with `seed`)."""
        full = self.model.init(_init_gen(gen, seed, self.device))
        params_c = self.model.param_slice(full, 0, self.cut)
        params_s = self.model.param_slice(full, self.cut,
                                          self.model.n_segments)
        clients = [copy_tree(params_c) for _ in range(self.n_clients)]
        return {"clients": clients, "server": params_s,
                "opt_c": [self.optimizer_client.init(c) for c in clients],
                "opt_s": self.optimizer_server.init(params_s),
                "last_trained": -1}

    def train_round(self, state, client_batches: list[dict]):
        """One round: each client takes one turn on its local batch.
        backend="engine" runs the round on the Plan's engine (ragged
        per-client batch shapes take the eager loop: they cannot stack);
        backend="eager" is the reference loop.  Returns (state, the mean
        turn loss as a 0-d tensor)."""
        if self.backend == "eager" or _ragged(client_batches):
            losses = []
            for ci, batch in enumerate(client_batches):
                state, loss = self.client_turn(state, ci, batch)
                losses.append(loss)
            return state, torch.stack(losses).mean()
        est, losses = self.engine.run_round(
            stack_state(state, self.n_clients),
            _to(stack_batches(client_batches), self.device))
        return unstack_state(est, self.n_clients), losses.mean()

    def client_turn(self, state, ci: int, batch):
        batch = _to(batch, self.device)
        x, y = batch["x"], batch["labels"]
        # weight sync from the previously trained client
        if self.sync == "p2p" and state["last_trained"] >= 0 \
                and state["last_trained"] != ci:
            src = state["last_trained"]
            state["clients"][ci] = copy_tree(state["clients"][src])
            self.meter.add_sync_bytes(ci, state["clients"][ci])

        loss, g_c, g_s, wires = sp.vanilla_split_grads(
            self.model, self.cut, state["clients"][ci], state["server"],
            x, y, self.loss_fn, [])
        self.meter.add_wires(ci, wires)
        self._meter_flops(ci, state, x)

        ups_c, state["opt_c"][ci] = self.optimizer_client.update(
            g_c, state["opt_c"][ci], state["clients"][ci])
        state["clients"][ci] = apply_updates(state["clients"][ci], ups_c)
        ups_s, state["opt_s"] = self.optimizer_server.update(
            g_s, state["opt_s"], state["server"])
        state["server"] = apply_updates(state["server"], ups_s)
        state["last_trained"] = ci
        return state, loss

    def _meter_flops(self, ci, state, x):
        if self._client_flops_per_batch is None:
            fwd = flops_of_fn(
                lambda p, xi: self.model.apply_range(p, xi, 0, self.cut),
                state["clients"][ci], x)
            # fwd + bwd ~= 3x fwd (standard accounting, as in the paper)
            self._client_flops_per_batch = 3.0 * fwd
        self.meter.add_flops(ci, self._client_flops_per_batch)

    @torch.no_grad()
    def evaluate(self, state, batch, *, client: int = 0):
        """Client `client` with the server: the accuracy, a 0-d tensor."""
        batch = _to(batch, self.device)
        act = self.model.apply_range(state["clients"][client], batch["x"],
                                     0, self.cut)
        if sp._takes_offset(self.model):
            logits = self.model.apply_range(
                state["server"], act, self.cut, self.model.n_segments,
                offset=self.cut)
        else:
            logits = self.model.apply_range(
                state["server"], act, self.cut, self.model.n_segments)
        return (logits.argmax(-1) == batch["labels"]).float().mean()


@dataclasses.dataclass
class UShapedTrainer:
    """Label-private variant: the loss is computed on the client."""
    model: sp.SegModel
    cut1: int
    cut2: int
    loss_fn: Callable
    optimizer: Any
    n_clients: int
    device: Any = None                      # None -> the GPU

    def __post_init__(self):
        _warn_deprecated("UShapedTrainer")
        self.device = resolve_device(self.device)
        self.meter = Meter(self.n_clients)
        self._engine = None

    @property
    def engine(self):
        if self._engine is None:
            sess = Plan(
                mode="u_shaped", model=self.model,
                cuts=(self.cut1, self.cut2), loss_fn=self.loss_fn,
                optimizer=self.optimizer, n_clients=self.n_clients,
                sync="none").compile(self.device)
            self._engine = sess.engine
            self._engine.meter = self.meter
        return self._engine

    def train_round(self, state, client_batches: list[dict]):
        """One round-robin round on the Plan's engine (no weight handoff:
        the u-shaped configuration keeps clients independent)."""
        est = {"clients": stack_trees(state["clients"]),
               "server": state["server"],
               "opt_c": stack_trees(state["opt"]["clients"]),
               "opt_s": state["opt"]["server"],
               "last_trained": torch.tensor(-1, dtype=torch.int32,
                                            device=self.device)}
        est, losses = self.engine.run_round(
            est, _to(stack_batches(client_batches), self.device))
        state = {"clients": unstack_tree(est["clients"], self.n_clients),
                 "server": est["server"],
                 "opt": {"clients": unstack_tree(est["opt_c"],
                                                 self.n_clients),
                         "server": est["opt_s"]}}
        return state, losses.mean()

    def init(self, gen: torch.Generator | None = None, *, seed: int = 0):
        full = self.model.init(_init_gen(gen, seed, self.device))
        head = self.model.param_slice(full, 0, self.cut1)
        mid = self.model.param_slice(full, self.cut1, self.cut2)
        tail = self.model.param_slice(full, self.cut2,
                                      self.model.n_segments)
        clients = [{"head": copy_tree(head), "tail": copy_tree(tail)}
                   for _ in range(self.n_clients)]
        opt = {"clients": [self.optimizer.init(c) for c in clients],
               "server": self.optimizer.init(mid)}
        return {"clients": clients, "server": mid, "opt": opt}

    def client_turn(self, state, ci: int, batch):
        batch = _to(batch, self.device)
        loss, g_head, g_mid, g_tail, wires = sp.u_shaped_grads(
            self.model, self.cut1, self.cut2,
            state["clients"][ci]["head"], state["server"],
            state["clients"][ci]["tail"], batch["x"], batch["labels"],
            self.loss_fn, [])
        self.meter.add_wires(ci, wires)
        g_client = {"head": g_head, "tail": g_tail}
        ups_c, state["opt"]["clients"][ci] = self.optimizer.update(
            g_client, state["opt"]["clients"][ci], state["clients"][ci])
        state["clients"][ci] = apply_updates(state["clients"][ci], ups_c)
        ups_s, state["opt"]["server"] = self.optimizer.update(
            g_mid, state["opt"]["server"], state["server"])
        state["server"] = apply_updates(state["server"], ups_s)
        return state, loss

