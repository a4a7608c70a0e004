"""The two methods the paper compares SplitNN against (port of
`repro/api/baseline.py:50-260`), lowered through the same step-program IR
as the split modes (`repro_torch.engine.topology.lower_baseline`): their
model pull and push are the program's `WeightHandoff` edges.

  FedAvgEngine     federated averaging (McMahan et al. 2017): every
      client pulls the global model, runs `local_steps` full-model steps
      on its batch, and pushes its local model; the server averages them.
  LargeBatchEngine synchronous large-batch SGD (Chen et al. 2016): every
      client pulls the global model and pushes its full-model gradient;
      the server averages the gradients and steps once.

The reference runs the clients under `vmap`; here each client is one
pass of a Python loop over the stacked client axis, stepping its own
optimizer slice, as `run_serial` does.  Under `Plan(schedule=
"pipelined", microbatches=M)` each client's gradient is the mean over M
microbatches of its batch (`program.microbatch_mean`); the pull and push
are unchanged.  Both meter per round
analytically (model pull and push bytes, 3 x forward FLOPs per batch),
as the reference does.

  FleetFedAvgEngine / FleetLargeBatchEngine — the same rounds with the
      clients sharded over a fleet's ranks (`repro_torch.engine.fleet`):
      each rank fits or differentiates its own clients, and the model or
      gradient mean is one `tree_psum` of the rank's pushed sum, divided
      by the whole client count (`program.tree_mean0`), so one rank is
      bitwise the single-device engine.  The pull and push cross the same
      int8 wire; the meters stay analytic over all N clients on every
      rank.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.api.wire import WireAccountingError
from repro_torch.core.accounting import (Meter, bytes_of_tree, flops_of_fn,
                                         to_meta)
from repro_torch.core.split import _grads, _leaf_params
from repro_torch.core.wire_compress import (as_dense, pack_int8,
                                            payload_nbytes)
from repro_torch.engine.fleet import FleetMeshMixin, FleetSpec
from repro_torch.engine.program import (microbatch_mean, stack_trees,
                                        tree_at, tree_mean0)
from repro_torch.engine.topology import lower_baseline
from repro_torch.nn.module import tree_leaves, tree_map
from repro_torch.optim import apply_updates


class _WireModelMixin:
    """Wire middleware over the baselines' model pull and push.

    The baselines have no cut, but the whole model crosses the wire
    (pull down, push up).  A `wire_stack` squeezes every crossing leaf by
    leaf through the stack, as it does a cut payload: clients train on
    the RECEIVED (int8) pull, the server averages the received pushes,
    and the master copy stays full precision on the server.  The fake
    and physical int8 flavours give bitwise the same values."""

    def _wire_tree(self, tree, name: str, direction: str):
        if not self.wire_stack:
            return tree
        return tree_map(
            lambda a: as_dense(self.wire_stack.apply(a, name, direction)),
            tree)

    def _wire_model_bytes(self, tree) -> int:
        """Wire bytes of one model payload through the stack.  With a
        physical stack the `bytes_fn` claim is checked against the packed
        payloads' real tensors, packed on meta copies (no device work)."""
        stack = self.wire_stack
        if not stack:
            return bytes_of_tree(tree)
        claim = stack.tree_wire_bytes(tree)
        if stack.physical:
            actual = sum(payload_nbytes(pack_int8(leaf))
                         for leaf in tree_leaves(to_meta(tree)))
            if actual != claim:
                raise WireAccountingError(
                    f"baseline model wire: bytes_fn claims {claim}, the "
                    f"packed payloads hold {actual}")
        return claim


class _BaselineEngine(_WireModelMixin):
    """What the two baselines share: the probe, one client's gradient, the
    mean over the clients and the global model's evaluation."""

    _allreduce = None           # a fleet rank's sum over the ranks

    def _client_mean(self, stacked):
        """The mean of the pushed trees stacked over the clients this
        engine holds: all of them, or a fleet rank's share."""
        return tree_mean0(stacked, n=self.n_clients,
                          allreduce=self._allreduce)

    def _probe(self, state, batches):
        """FLOPs of one client's batch (3 x the forward) and the model
        payload's wire bytes, once."""
        if self._flops_per_batch is None:
            one = {k: v[0] for k, v in batches.items()}
            self._flops_per_batch = 3.0 * flops_of_fn(
                self.apply_fn, state["global"], one)
        if self._wire_bytes is None:
            self._param_bytes = bytes_of_tree(state["global"])
            self._wire_bytes = self._wire_model_bytes(state["global"])

    def _check_microbatches(self):
        if self.microbatches < 1:
            raise ValueError("microbatches must be >= 1")

    def _grad(self, params, batch):
        """(loss, full-model gradient) of one client batch, the loss
        detached; with microbatches > 1 the mean over the M microbatches
        of the batch (the full-batch gradient for mean-reduction
        losses)."""
        if self.microbatches == 1:
            return self._batch_grad(params, batch)
        return microbatch_mean(lambda mb: self._batch_grad(params, mb),
                               batch, self.microbatches)

    def _batch_grad(self, params, batch):
        with torch.enable_grad():
            p = _leaf_params(params)
            loss = self.loss_fn(self.apply_fn(p, batch), batch["labels"])
            return loss.detach(), _grads(loss, p)

    @torch.no_grad()
    def evaluate(self, state, batch):
        """The global model's accuracy on one batch (a 0-d tensor)."""
        logits = self.apply_fn(state["global"], batch)
        return (logits.argmax(-1) == batch["labels"]).float().mean()


@dataclasses.dataclass
class FedAvgEngine(_BaselineEngine):
    """One fedavg round: every client `local_steps` steps from the pull."""
    init_fn: Callable            # gen -> params
    apply_fn: Callable           # (params, batch) -> logits
    loss_fn: Callable            # (logits, labels) -> scalar
    optimizer: Any
    n_clients: int
    local_steps: int = 1
    wire_stack: Any = None       # api.wire.WireStack | None
    microbatches: int = 1        # Plan(schedule="pipelined") only

    def __post_init__(self):
        self._check_microbatches()
        self.program = lower_baseline("fedavg",
                                      local_steps=self.local_steps)
        self.meter = Meter(self.n_clients)
        self._flops_per_batch = None
        self._param_bytes = None
        self._wire_bytes = None

    def init(self, gen):
        """{"global": params, "opt": per-client optimizer states stacked
        along a client axis}; a client's optimizer state persists across
        rounds while its params restart from each pull."""
        params = self.init_fn(gen)
        return {"global": params,
                "opt": stack_trees([self.optimizer.init(params)
                                    for _ in range(self.n_clients)])}

    def _round(self, state, batches):
        pull, push = self.program.handoff_steps()
        # one pull through the wire, shared by every client
        pulled = self._wire_tree(state["global"], pull.name, pull.direction)
        locals_, opts, losses = [], [], []
        for ci in range(len(next(iter(batches.values())))):
            batch = {k: v[ci] for k, v in batches.items()}
            p, o = pulled, tree_at(state["opt"], ci)
            for _ in range(self.local_steps):     # the same batch each step
                loss, g = self._grad(p, batch)
                ups, o = self.optimizer.update(g, o, p)
                p = apply_updates(p, ups)
            locals_.append(p)
            opts.append(o)
            losses.append(loss)
        # the push quantizes each stacked (N, ...) leaf in one call: per
        # last-axis row, so per client
        pushed = self._wire_tree(stack_trees(locals_), push.name,
                                 push.direction)
        return ({"global": self._client_mean(pushed),
                 "opt": stack_trees(opts)}, torch.stack(losses))

    def run_round(self, state, batches):
        """batches: dict of (N, ...) stacked per-client tensors.  Returns
        (state, each client's last local loss (N,)) and meters the round."""
        self._probe(state, batches)
        out = self._round(state, batches)
        for ci in range(self.n_clients):
            self.meter.bytes_down[ci] += self._wire_bytes       # model pull
            self.meter.add_flops(ci,
                                 self._flops_per_batch * self.local_steps)
            self.meter.bytes_up[ci] += self._wire_bytes         # model push
        return out


@dataclasses.dataclass
class LargeBatchEngine(_BaselineEngine):
    """One synchronous step: per-client gradients, their mean, one
    update of the full-precision master."""
    init_fn: Callable
    apply_fn: Callable
    loss_fn: Callable
    optimizer: Any
    n_clients: int
    wire_stack: Any = None
    microbatches: int = 1        # Plan(schedule="pipelined") only

    def __post_init__(self):
        self._check_microbatches()
        self.program = lower_baseline("large_batch")
        self.meter = Meter(self.n_clients)
        self._flops_per_batch = None
        self._param_bytes = None
        self._wire_bytes = None

    def init(self, gen):
        params = self.init_fn(gen)
        return {"global": params, "opt": self.optimizer.init(params)}

    def _step(self, state, batches):
        pull, push = self.program.handoff_steps()
        pulled = self._wire_tree(state["global"], pull.name, pull.direction)
        outs = [self._grad(pulled, {k: v[ci] for k, v in batches.items()})
                for ci in range(len(next(iter(batches.values()))))]
        pushed = self._wire_tree(stack_trees([g for _, g in outs]),
                                 push.name, push.direction)
        ups, opt = self.optimizer.update(self._client_mean(pushed),
                                         state["opt"], state["global"])
        return ({"global": apply_updates(state["global"], ups), "opt": opt},
                torch.stack([loss for loss, _ in outs]))

    def run_round(self, state, batches):
        self._probe(state, batches)
        out = self._step(state, batches)
        for ci in range(self.n_clients):
            self.meter.add_flops(ci, self._flops_per_batch)
            self.meter.bytes_up[ci] += self._wire_bytes     # gradient push
            self.meter.bytes_down[ci] += self._wire_bytes   # model pull
        return out


# ---------------------------------------------------------------------------
# the baselines over a fleet (Plan(fleet=FleetSpec(...)))
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class FleetFedAvgEngine(FleetMeshMixin, FedAvgEngine):
    """FedAvg with the clients sharded over the fleet's ranks: each rank
    runs its clients' `local_steps` and holds their optimizer states; the
    model average is one `tree_psum` of the rank's pushed sum."""
    fleet: FleetSpec | None = None
    mesh: Any = None
    device: Any = None

    def __post_init__(self):
        self._fleet_setup()
        super().__post_init__()

    def init(self, gen):
        return self.shard_state(super().init(gen))

    def shard_state(self, state: dict) -> dict:
        """The rank's slice of the clients' optimizer states; the global
        model is whole on every rank.  Idempotent."""
        return {"global": state["global"], "opt": self._local(state["opt"])}

    def gather_state(self, state: dict) -> dict:
        return {"global": state["global"], "opt": self._gather(state["opt"])}

    def _round(self, state, batches):
        state, losses = super()._round(state, self._local(batches))
        return state, self._gather(losses)


@dataclasses.dataclass
class FleetLargeBatchEngine(FleetMeshMixin, LargeBatchEngine):
    """Sync-SGD with the clients' gradients sharded over the fleet's ranks:
    the gradient mean is one `tree_psum`, and the update replays on every
    rank, whose state is whole."""
    fleet: FleetSpec | None = None
    mesh: Any = None
    device: Any = None

    def __post_init__(self):
        self._fleet_setup()
        super().__post_init__()

    def _step(self, state, batches):
        state, losses = super()._step(state, self._local(batches))
        return state, self._gather(losses)
