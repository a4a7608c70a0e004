"""Multi-tenant continuous batching over one split-serving session (port
of `repro/serve/batcher.py`).

Each tenant is an independent client: its own prompt, its own B=1
client half and caches, so raw tokens never leave it.  The server holds
one stacked cache of `plan.max_batch` slots with a cursor per row
(`models.lm.per_slot_pos`), so every slot advances on its own: a tenant
joining mid-flight prefills into its slot while the others keep
decoding, with no barrier and no re-padding of anyone else's state.

Per step the batcher
  1. runs every live tenant's B=1 client step, and the wire stack on its
     cut activation (each tenant quantizes its own row);
  2. concatenates the payloads along the batch axis
     (`wire_compress.stack_packed`: bitwise the per-tenant payloads,
     since quantization is per last-axis row);
  3. runs one server step over the stacked payload at `max_batch` rows
     (`ServeSession._fused_server_decode` when the session is fused and
     the payload packed, else `decode_step_server`);
  4. takes each tenant's token as the argmax of its own logits row.

Vacant slots carry one pad payload (a zero activation through the wire
stack), built once per batcher, so its quantize launches once.  Every op
of a dense, SSM or hybrid server trunk is row-independent, so pad rows
cannot perturb live rows.  A MoE server step need not be: at the
reference's capacity dispatch (`nn/moe.py`) every row of the step, pad
rows included, competes for each expert's capacity, so which tokens an
expert drops depends on the other slots.  A MoE model under the
`Batcher` is therefore held to the reference's `Batcher`, not to its
solo stream.

Wire bytes are billed per active tenant from the session's meta-tensor
cost probes: `prefill_cost(1, S, extra)` for each join (a VLM's
patches cross with its prompt) and `decode_cost(batch=1)` for each
decode step.  Vacant-slot padding would not cross a real
wire and is not billed.

The port's caches are lists of per-layer dicts of (B, ...) tensors (the
reference stacks layers on a leading axis), so seating a tenant writes
row `b` of every tensor leaf and `pos[b]`.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.api.wire import WireTape
from repro_torch.core.wire_compress import PackedInt8, as_dense, stack_packed
from repro_torch.models.lm import per_slot_pos
from repro_torch.serve.split_infer import ServeSession


@dataclasses.dataclass
class Tenant:
    """One client stream multiplexed into the batch."""
    slot: int
    max_new: int
    tokens: list                  # generated tokens (ints), tok0 first
    cache: object                 # B=1 client-side caches
    cur: object                   # (1, 1) current token, on the device
    done: bool = False


def _scatter(full, one, b: int) -> None:
    """Write a tenant's B=1 server cache `one` into row `b` of the
    stacked cache `full`, in place: each tensor leaf's row, and the int
    `pos` into the (B,) cursor."""
    if isinstance(full, dict):
        for k, v in full.items():
            if isinstance(v, torch.Tensor):
                v[b] = one[k] if k == "pos" else one[k][0]
            else:
                _scatter(v, one[k], b)
    else:
        for f, o in zip(full, one, strict=True):
            _scatter(f, o, b)


class Batcher:
    """Continuous batching: `join` prefills a tenant into a free slot,
    `step` advances every live tenant one token, and a tenant leaves on
    `eos_id` or at its `max_new` budget, its slot free at once."""

    def __init__(self, session: ServeSession, eos_id: int | None = None):
        self.session = session
        self.eos_id = eos_id
        self.max_batch = session.plan.max_batch
        self.tenants: dict[int, Tenant] = {}
        self.finished: list[Tenant] = []
        self.bytes_up = 0
        self.bytes_down = 0
        self.tokens_generated = 0

        model, plan = session.model, session.plan
        _, sc = model.init_cache_split(self.max_batch, plan.max_len,
                                       session.cut, session.device)
        self._sc = per_slot_pos(sc, self.max_batch)
        self._pad_part = None                 # built on first use
        dc = session.decode_cost(batch=1)
        self._decode_up = dc.bytes_up
        self._decode_down = dc.bytes_down

    # ---- admission ---------------------------------------------------------

    def free_slots(self) -> list[int]:
        return [b for b in range(self.max_batch) if b not in self.tenants]

    @torch.no_grad()
    def join(self, prompt, max_new: int, extra: dict | None = None) -> int:
        """Prefill one tenant at B=1 (one teacher-forced forward per half)
        and seat it in the first free slot.  prompt: (S,) or (1, S);
        `extra`: its modality inputs at B=1 (a VLM's
        {"patch_embeds": (1, n_patches, vision_dim)})."""
        free = self.free_slots()
        if not free:
            raise RuntimeError("batch full: no free slot")
        b = free[0]
        sess = self.session
        batch = sess.batch(prompt, extra)
        if batch["tokens"].ndim == 1:
            batch["tokens"] = batch["tokens"][None]
        tok0, cc, sc1 = sess._prefill_fn(sess.client_params,
                                         sess.server_params, batch,
                                         WireTape(sess.stack))
        _scatter(self._sc, sc1, b)
        pc = sess.prefill_cost(1, batch["tokens"].shape[1], extra)
        self.bytes_up += pc.bytes_up
        self.bytes_down += pc.bytes_down
        self.tokens_generated += 1
        t = Tenant(slot=b, max_new=max_new, tokens=[int(tok0[0, 0])],
                   cache=cc, cur=tok0)
        self.tenants[b] = t
        self._maybe_finish(t)
        return b

    # ---- the batched step --------------------------------------------------

    def _part(self, b: int):
        sess = self.session
        t = self.tenants.get(b)
        if t is not None and not t.done:
            act, t.cache = sess.model.decode_step_client(
                sess.client_params, t.cur, sess.cut, t.cache)
            return sess.stack.apply(act, "cut_act", "up")
        if self._pad_part is None:
            zero = torch.zeros((1, 1, sess.cfg.d_model), dtype=sess.cfg.dtype,
                               device=sess.device)
            self._pad_part = sess.stack.apply(zero, "cut_act", "up")
        return self._pad_part

    @torch.no_grad()
    def step(self) -> dict[int, int]:
        """Advance every live tenant one token.  Returns {slot: token}
        for the tokens sampled this step."""
        live = [b for b, t in self.tenants.items() if not t.done]
        if not live:
            return {}
        sess = self.session
        payload = stack_packed([self._part(b) for b in range(self.max_batch)])
        if sess._fused is not None and isinstance(payload, PackedInt8):
            logits, self._sc = sess._fused_server_decode(
                sess.server_params, sess._fused, payload, self._sc)
        else:
            logits, self._sc = sess.model.decode_step_server(
                sess.server_params, as_dense(payload), sess.cut, self._sc)
        logits = sess.stack.apply(logits, "logits", "down")
        toks = torch.argmax(as_dense(logits)[:, -1], dim=-1)
        picked = toks.tolist()
        out = {}
        for b in live:
            t = self.tenants[b]
            t.tokens.append(picked[b])
            t.cur = toks[b:b + 1, None]
            out[b] = picked[b]
            self.bytes_up += self._decode_up
            self.bytes_down += self._decode_down
            self.tokens_generated += 1
            self._maybe_finish(t)
        return out

    def _maybe_finish(self, t: Tenant):
        if len(t.tokens) >= t.max_new or (self.eos_id is not None
                                          and t.tokens[-1] == self.eos_id):
            t.done = True
            self.tenants.pop(t.slot, None)
            self.finished.append(t)

    def run(self, max_steps: int = 10_000) -> list[Tenant]:
        """Step until every seated tenant finishes; returns and clears the
        finished list (join and run can then go on: the slots are free)."""
        for _ in range(max_steps):
            if not self.step():
                break
        done, self.finished = self.finished, []
        return done

    # ---- metering ----------------------------------------------------------

    @property
    def bytes_per_token(self) -> float:
        return ((self.bytes_up + self.bytes_down)
                / max(self.tokens_generated, 1))
