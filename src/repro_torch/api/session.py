"""`Session` — a compiled `Plan`, ready to train (port of
`repro/api/session.py`).

One surface for all eight modes: `fit` drives rounds (a round is one
turn per client; for `large_batch` one synchronous step), `evaluate`
scores a batch, `meter` reports per-client FLOPs and wire bytes,
`wire_report` lists exactly what crosses the boundary per round (priced
through the plan's `WireTransform` stack; the baselines' model pull and
push) and `leakage_report` quantifies how much of the raw input survives
onto the wire (distance correlation).  State and batches live on the
session's device; batches given elsewhere are moved there.
"""
from __future__ import annotations

from typing import Iterable

import torch

from repro_torch.core import privacy
from repro_torch.engine import RoundEngine, stack_batches, tree_at
from repro_torch.nn.module import tree_map


class Session:
    """Stateful handle over one engine.  `self.state` is the engine's
    tree of tensors (`repro_torch.bridge` converts it to and from the
    reference's layout)."""

    def __init__(self, plan, engine, wire_stack, device):
        self.plan = plan
        self.engine = engine
        self.wire_stack = wire_stack
        self.device = torch.device(device)
        self.state = None
        self._probe_state_cache = None

    # ---- lifecycle ---------------------------------------------------------

    @property
    def is_split(self) -> bool:
        """A split mode (False: a baseline)."""
        return isinstance(self.engine, RoundEngine)

    def _generator(self, gen, seed: int) -> torch.Generator:
        if gen is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
        return gen

    def init(self, gen: torch.Generator | None = None, *, seed: int = 0):
        """Fresh state drawn from `gen` (a generator on the session's
        device), or from a generator seeded with `seed`."""
        self.state = self._engine_init(self._generator(gen, seed))
        self._probe_state_cache = None
        return self.state

    def _engine_init(self, gen):
        """The paper's identical clients for the turn kinds; one draw per
        branch for the branch fan-in kinds; one global model for the
        baselines."""
        if not self.is_split:
            return self.engine.init(gen)
        return self.engine.init(
            gen, identical_clients=not self.engine.topology.parallel_only)

    def _state_for_probe(self):
        """The state the probes (`wire_report`, `leakage_report`) read:
        the live state, or before `init` a cached throwaway one, so a
        probe never commits an init."""
        if self.state is not None:
            return self.state
        if self._probe_state_cache is None:
            self._probe_state_cache = self._engine_init(
                self._generator(None, 0))
        return self._probe_state_cache

    # ---- training ----------------------------------------------------------

    def _prep(self, batches):
        """List of per-client dicts -> stacked; dicts pass through (the
        (K, B, ...) layout of the branch modes).  Tensors move to the
        session's device."""
        if isinstance(batches, (list, tuple)):
            batches = stack_batches(list(batches))
        return tree_map(lambda t: t.to(self.device), batches)

    def run_round(self, batches):
        """One round.  Returns the per-turn losses ((n_clients,), or (1,)
        for the branch modes; the baselines' per-client losses)."""
        if self.state is None:
            self.init()
        self.state, losses = self.engine.run_round(self.state,
                                                   self._prep(batches))
        return losses

    def fit(self, data, *, rounds: int | None = None, gen=None,
            log_every: int = 0) -> list[float]:
        """Train.  `data` is an iterable yielding one round's batches
        each, or a callable `round_idx -> batches` (then `rounds` is
        required).  Returns the per-round mean losses."""
        if callable(data):
            if rounds is None:
                raise ValueError("fit(data=<callable>) needs rounds=")
            it: Iterable = (data(r) for r in range(rounds))
        else:
            it = data if rounds is None else _take(data, rounds)
        if self.state is None:
            self.init(gen)
        losses = []
        for r, batches in enumerate(it):
            ls = self.run_round(batches)
            losses.append(float(ls.mean()))
            if log_every and (r % log_every == 0):
                print(f"round {r:5d}  loss {losses[-1]:.4f}", flush=True)
        return losses

    # ---- inspection --------------------------------------------------------

    def evaluate(self, batch, *, client: int = 0):
        """Accuracy on one (unstacked) eval batch, a 0-d tensor: client
        `client` with the server (turn modes), the joint fleet (branch
        modes) or the global model (baselines)."""
        if self.state is None:
            self.init()
        if not self.is_split:
            return self.engine.evaluate(self.state, self._prep(batch))
        return self.engine.evaluate(self.state, self._prep(batch),
                                    client=client)

    def evaluate_all(self, batch):
        """Per-client accuracies: (n_clients,) for the turn modes, shape
        (1,) for the branch fan-in modes and the baselines (one joint
        model)."""
        if self.state is None:
            self.init()
        if not self.is_split:
            return self.evaluate(batch)[None]
        return self.engine.evaluate_all(self.state, self._prep(batch))

    def meter(self) -> dict:
        """Cumulative per-client resource totals (TFLOPs / GB)."""
        return self.engine.meter.totals()

    def wire_report(self, batches) -> list[dict]:
        """Everything that crosses the boundary in ONE turn (a branch
        mode's joint round) for this batch shape, priced through the wire
        middleware stack.  Free of side effects: probing never
        initialises state or touches the meter.  With a physical stack
        each crossing's bytes come from the packed payload and are checked
        against the `bytes_fn` claim (`WireAccountingError` on drift);
        each record carries a `physical` flag naming which pricing
        applied.  The baselines report their model pull and push instead
        (no cut: the whole model is the payload)."""
        if not self.is_split:
            if self.engine._wire_bytes is None:
                self.engine._probe(self._state_for_probe(),
                                   self._prep(batches))
            pb = self.engine._wire_bytes
            phys = bool(self.wire_stack) and self.wire_stack.physical
            return [{"name": "model_pull", "direction": "down",
                     "bytes": pb, "physical": phys},
                    {"name": "model_push", "direction": "up",
                     "bytes": pb, "physical": phys}]
        cost = self.engine.turn_cost(self._state_for_probe(),
                                     self._prep(batches))
        return [{"name": w.name, "direction": w.direction,
                 "shape": tuple(w.shape),
                 "dtype": str(w.dtype).replace("torch.", ""),
                 "bytes": w.bytes, "physical": w.physical}
                for w in cost.wires]

    @torch.no_grad()
    def leakage_report(self, batch, *, client: int = 0) -> dict:
        """Distance correlation between the raw input client `client`
        holds and what crosses the wire after the transform stack.  `batch`
        is one unstacked batch (the branch modes: the (K, B, ...) layout,
        `client` selecting the modality); the raw input is its "x", or
        else its first value (an LM batch's "tokens")."""
        if not self.is_split:
            raise ValueError("baseline modes ship the whole model, not a "
                             "cut activation: leakage_report does not "
                             "apply")
        topology = self.engine.topology
        if topology.client_fwd is None:
            raise ValueError(f"{topology.kind} topology exposes no client "
                             "forward to probe")
        state = self._state_for_probe()
        first = next(iter(batch))          # the caller's order: _prep sorts
        batch = self._prep(batch)
        pc = tree_at(state["clients"], client)
        if topology.parallel_only:
            x_raw = batch["x"][client]
            probe = {**batch, "x": batch["x"][client:client + 1]}
        else:
            # the raw input the client holds: "x", or the batch's first
            # value (an LM batch's "tokens"), as the reference reads it
            x_raw, probe = batch.get("x", batch[first]), batch
        act = topology.client_fwd(pc, probe)
        wire_val = self.wire_stack.pre_probe(act) if self.wire_stack else act
        return privacy.leakage_report(x_raw, wire_val, batch.get("labels"))


def _take(data, n: int):
    for r, item in enumerate(data):
        if r >= n:
            return
        yield item
