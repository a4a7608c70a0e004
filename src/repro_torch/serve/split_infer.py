"""Split-inference serving: prefill + decode across the cut (port of
`repro/serve/split_infer.py`).

The client holds the embedding and layers [0, cut), the server the rest.
The client never ships raw tokens up, only the cut activation; the server
never ships hidden state down, only logits.  Both hops run through the
`WireStack` middleware, so `wire="quantize_int8:physical"` makes each hop
the packed int8 payload (int8 q + fp32 row scales) built by the wire
kernels.  `unpack(pack(x))` is bitwise the fake-quant value, so the
physical wire generates token for token what the fake wire does.

With `fused_entry=True` the server's first block reads the packed
payload directly: its rmsnorm folds into the per-row scales and the int8
q feeds the fused q8 QKV kernel (`_fused_server_decode`).

Runs on the GPU unless the caller passes `device="cpu"`; without a
visible GPU and without that, the session raises.  Prefill is one
teacher-forced forward per half; decode is a Python loop of steps (the
reference scans).  The port serves the dense family (phi4-mini,
ChatGLM3-6B, Qwen1.5-32B, Mistral-Large-123B), the
MoE family (Qwen3-MoE: GQA + MoE blocks; DeepSeek-V2: MLA blocks with a
compressed cache, a dense first layer, then MoE with shared experts),
the SSM family (Mamba2) and the hybrid family (RecurrentGemma: RG-LRU
blocks and local attention in composite super-blocks; the cut falls on
a super-block boundary).  Caches are updated in place: the attention KV
ring and MLA's compressed ring row by row (a sliding window's ring
holds the last `window` rows and wraps), the Mamba2 and RG-LRU caches
(conv window and recurrent state, which `max_len` does not bound) by
writing each block's new cache back into its slot.  The fused entry
needs a GQA block at the server's entry (its MLP may be MoE), so an
MLA, SSM or hybrid model raises with `fused_entry=True`, as in the
reference.  The VLM family (InternVL2) serves like the dense one, its
patches entering at prefill through `extra` (`prefill`, `generate`,
`prefill_cost`): the client projects them, and they cross the cut in
front of the prompt's rows.  `decode_cost` runs one step on meta
tensors, which launches no kernel, spends no FLOP and leaves the
session's caches alone, and prices every `WireRecord`.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.api.wire import WireStack, WireTape, parse_wire
from repro_torch.configs import get_config
from repro_torch.configs.base import ArchConfig
from repro_torch.core.accounting import TurnCost
from repro_torch.core.split import record
from repro_torch.core.wire_compress import (PackedInt8, as_dense,
                                            splitcat_linear_packed)
from repro_torch.device import resolve_device
from repro_torch.models import build_model, supports_split_serving
from repro_torch.models.lm import group_decode
from repro_torch.nn import attention as A
from repro_torch.nn import transformer as T


def _tree_map(fn, tree):
    """Apply `fn` to every tensor in nested dicts/lists/tuples."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return tree


@torch.no_grad()
def greedy_decode_scan(model, params, cache, first_token, steps: int):
    """Monolithic greedy decode: `steps` tokens after `first_token` (B, 1),
    each step's argmax written on the device into a preallocated (B,
    steps) tensor, so no step reads a value back to the host.  The
    reference compiles this loop into one `lax.scan`; here it is a loop
    of `model.decode_step` launches.  Returns ((B, steps) tokens, cache)."""
    out = torch.empty((first_token.shape[0], steps), dtype=torch.long,
                      device=first_token.device)
    tok = first_token
    for i in range(steps):
        logits, cache = model.decode_step(params, tok, cache)
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
        out[:, i] = tok[:, 0]
    return out, cache


@dataclasses.dataclass(frozen=True)
class ServePlan:
    """Declarative split-serving config -> `ServeSession`.

    arch        — arch id or a built `ArchConfig`;
    cut         — flat layer index of the client/server boundary
                  (None = the arch's default cut);
    wire        — `parse_wire` spec ("quantize_int8:physical"), a
                  transform sequence, or a `WireStack`; "" = dense wire;
    max_batch   — batch rows `decode_cost()` prices by default (the
                  `Batcher`'s slot count);
    max_len     — KV ring length (prompt + generation budget; a
                  sliding window's ring is at most the window); SSM and
                  RG-LRU caches do not depend on it;
    fused_entry — the server's entry QKV reads the packed payload through
                  the fused q8 kernel (allclose, not bitwise, to the
                  unfused order of operations, hence opt-in).
    """
    arch: Any
    cut: int | None = None
    wire: Any = ""
    max_batch: int = 1
    max_len: int = 256
    fused_entry: bool = False

    def config(self) -> ArchConfig:
        if isinstance(self.arch, ArchConfig):
            return self.arch
        return get_config(self.arch)


class ServeSession:
    """One split-serving run: the split params, the wire stack and, after
    `prefill`, both sides' live caches.

    `seed_or_params` is an int seed (random params drawn on the device
    from a `torch.Generator`) or a full-model param tree.  `model`, when
    given, is the plan's model with its group specs replaced
    (`dataclasses.replace`): the sharded paths are switched on so, e.g.
    `ep_axis` on the MoE specs or `decode_kv_shard` on the attention ones,
    with a `launch.mesh.make_mesh_compat` mesh registered by
    `nn.dist.set_mesh`."""

    def __init__(self, plan: ServePlan, seed_or_params, *, device=None,
                 model=None):
        self.device = resolve_device(device)
        self.plan = plan
        self.cfg = plan.config()
        ok, why = supports_split_serving(self.cfg)
        if not ok:
            raise ValueError(f"{self.cfg.name}: {why}")
        self.model = build_model(self.cfg) if model is None else model
        n_layers = self.model.flat_layers()
        self.cut = plan.cut if plan.cut is not None else min(
            self.cfg.default_cut, max(1, n_layers // 2))
        if not 0 < self.cut < n_layers:
            raise ValueError(f"cut {self.cut} outside (0, {n_layers})")
        self.stack = WireStack(parse_wire(plan.wire))
        if isinstance(seed_or_params, dict):
            params = _tree_map(lambda t: t.to(self.device), seed_or_params)
        else:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(int(seed_or_params))
            params = self.model.init(gen, self.device)
        self.client_params, self.server_params = self.model.split_params(
            params, self.cut)
        self._fused = (self._fused_entry_weights()
                       if plan.fused_entry else None)
        if plan.fused_entry and self._fused is None:
            raise ValueError(
                "fused_entry needs a physical int8 wire and a plain "
                "rmsnorm+attention block at the server entry")
        self._meta = None           # meta-device copy for the cost probes
        self._cc = self._sc = None

    # ---- the fused packed-wire server entry --------------------------------

    def _fused_entry_weights(self):
        """The folded entry weights, or None if the server's first block
        is not a plain rmsnorm+GQA layer (an MLA entry, say) or the wire
        is not packed.

        The payload encodes x = q * s (per-row scale), and with rmsnorm
        gain g and eps = 1e-6:
            rmsnorm(q*s) = q * s_eff * g,
            s_eff = s * rsqrt(s^2 * mean(q^2) + eps)
        so QKV = (q @ (g[:, None] * [Wq|Wk|Wv])) * s_eff + b, the q8
        kernel's contract.  [Wq|Wk|Wv] concatenates along the output
        axis of the (in, out) weights, as the reference does."""
        if not self.stack.physical:
            return None
        g0 = self.model._groups_for_range(self.cut, "server")[0]
        if g0.layers_per_repeat != 1:
            return None
        spec = g0.specs[0]
        if spec.mixer != "attn" or spec.norm != "rmsnorm":
            return None
        p0 = self.server_params["groups"][0][0]["0"]
        m = p0["mixer"]
        w_cat = torch.cat([m["wq"]["w"], m["wk"]["w"], m["wv"]["w"]], dim=1)
        w_cat = p0["norm1"]["scale"][:, None] * w_cat
        b_cat = (torch.cat([m["wq"]["b"], m["wk"]["b"], m["wv"]["b"]])
                 if "b" in m["wq"] else None)
        widths = (m["wq"]["w"].shape[1], m["wk"]["w"].shape[1],
                  m["wv"]["w"].shape[1])
        return {"spec": spec, "group": g0, "w_cat": w_cat, "b_cat": b_cat,
                "widths": widths, "p0": p0}

    def _fused_server_decode(self, sp, fe, payload: PackedInt8, caches):
        """Server decode step reading the PACKED payload: entry QKV
        through the fused dequant+matmul kernel, then the entry block's
        MLP (dense or MoE) and the regular path for the rest of the
        trunk."""
        spec, g0 = fe["spec"], fe["group"]
        qf = payload.q.float()
        ms = (qf * qf).mean(dim=-1, keepdim=True)
        s_eff = (payload.scale * torch.rsqrt(
            payload.scale.float() ** 2 * ms + 1e-6)).float()
        qkv_flat = splitcat_linear_packed(
            [PackedInt8(payload.q, s_eff, payload.orig_dtype)],
            fe["w_cat"], fe["b_cat"], out_dtype=payload.orig_dtype)
        wq, wk, _ = fe["widths"]
        qkv = (qkv_flat[..., :wq], qkv_flat[..., wq:wq + wk],
               qkv_flat[..., wq + wk:])

        x = as_dense(payload)                       # residual stream only
        p0 = fe["p0"]
        y, _ = A.gqa_decode(p0["mixer"], spec.attn, x, caches[0][0]["0"],
                            qkv=qkv)
        h = T._residual(p0, spec, x, y)
        # the entry group's other repeats, then the remaining groups
        h, _ = group_decode(sp["groups"][0][1:], g0, h, caches[0][1:])
        groups = self.model._groups_for_range(self.cut, "server")
        for g, gp, c in zip(groups[1:], sp["groups"][1:], caches[1:]):
            h, _ = group_decode(gp, g, h, c)
        return self.model.server_head(sp, h), caches

    # ---- core step / prefill (wire tape threaded through) ------------------

    def _prefill_fn(self, cp, sp, batch, wires):
        """`batch`: {"tokens": (B, S)} and any modality inputs (a VLM's
        "patch_embeds"), all on one device."""
        tokens = batch["tokens"]
        cc, sc = self.model.init_cache_split(tokens.shape[0],
                                             self.plan.max_len, self.cut,
                                             tokens.device)
        act, cc = self.model.prefill_client(cp, batch, self.cut, cc)
        act = record(wires, "prefill_act", act, "up")
        logits, sc = self.model.prefill_server(sp, as_dense(act), self.cut,
                                               sc)
        last = record(wires, "prefill_logits", logits[:, -1:], "down")
        tok0 = torch.argmax(as_dense(last)[:, -1], dim=-1)[:, None]
        return tok0, cc, sc

    def _step_fn(self, cp, sp, fe, tok, cc, sc, wires):
        """One decode step: client half -> up wire -> server half -> down
        wire -> client-side argmax."""
        act, cc = self.model.decode_step_client(cp, tok, self.cut, cc)
        act = record(wires, "cut_act", act, "up")
        if fe is not None and isinstance(act, PackedInt8):
            logits, sc = self._fused_server_decode(sp, fe, act, sc)
        else:
            logits, sc = self.model.decode_step_server(sp, as_dense(act),
                                                       self.cut, sc)
        logits = record(wires, "logits", logits, "down")
        nxt = torch.argmax(as_dense(logits)[:, -1], dim=-1)[:, None]
        return nxt, cc, sc

    def _meta_weights(self):
        if self._meta is None:
            self._meta = _tree_map(
                lambda t: t.to("meta"),
                (self.client_params, self.server_params, self._fused))
        return self._meta

    def batch(self, prompts, extra: dict | None = None,
              device=None) -> dict:
        """The client's prefill batch on `device` (the session's by
        default): {"tokens": prompts} merged with `extra`, the modality
        inputs (e.g. {"patch_embeds": (B, n_patches, vision_dim)} for a
        VLM).  On meta only the shapes and types are kept."""
        device = self.device if device is None else torch.device(device)

        def put(t, dtype=None):
            t = torch.as_tensor(t, dtype=dtype)
            if device.type == "meta":
                return torch.empty(t.shape, dtype=t.dtype, device="meta")
            return t.to(device)
        out = {"tokens": put(prompts, torch.long)}
        out.update({k: put(v) for k, v in (extra or {}).items()})
        return out

    # ---- stateful serving API ----------------------------------------------

    @torch.no_grad()
    def prefill(self, prompts, extra: dict | None = None):
        """One teacher-forced forward per half.  prompts: (B, prompt_len)
        int tokens; `extra` carries modality inputs (a VLM's
        {"patch_embeds": ...}, whose rows take the front of every cache:
        `plan.max_len` must count them).  Returns the first sampled
        token (B, 1) and arms the session's caches."""
        tok0, self._cc, self._sc = self._prefill_fn(
            self.client_params, self.server_params,
            self.batch(prompts, extra), WireTape(self.stack))
        return tok0

    @torch.no_grad()
    def decode_step(self, tok):
        """One token for every row; the client->server hop is the wire
        payload (packed int8 when the stack is physical)."""
        nxt, self._cc, self._sc = self._step_fn(
            self.client_params, self.server_params, self._fused, tok,
            self._cc, self._sc, WireTape(self.stack))
        return nxt

    def decode(self, tok0, steps: int):
        """`steps` greedy tokens after `tok0` -> (B, steps)."""
        toks, tok = [], tok0
        for _ in range(steps):
            tok = self.decode_step(tok)
            toks.append(tok)
        return torch.cat(toks, dim=1)

    def generate(self, prompts, max_new: int, extra: dict | None = None):
        """prefill + decode -> (B, max_new) generated tokens."""
        tok0 = self.prefill(prompts, extra)
        if max_new <= 1:
            return tok0[:, :max_new]
        return torch.cat([tok0, self.decode(tok0, max_new - 1)], dim=1)

    # ---- metering ----------------------------------------------------------

    @torch.no_grad()
    def decode_cost(self, batch: int | None = None) -> TurnCost:
        """Wire cost of ONE decode step, from one step run on meta
        tensors.  `bytes_up + bytes_down` is the per-generated-token wire
        traffic; with a physical stack the bytes come from the packed
        payload's tensors."""
        B = batch or self.plan.max_batch
        cp, sp, fe = self._meta_weights()
        cc, sc = self.model.init_cache_split(B, self.plan.max_len, self.cut,
                                             "meta")
        tok = torch.zeros((B, 1), dtype=torch.long, device="meta")
        wires = WireTape(self.stack)
        self._step_fn(cp, sp, fe, tok, cc, sc, wires)
        return TurnCost(wires=tuple(wires), flops=0.0, sync_bytes=0)

    @torch.no_grad()
    def prefill_cost(self, batch: int, prompt_len: int,
                     extra: dict | None = None) -> TurnCost:
        """Wire cost of one prefill of `batch` prompts `prompt_len` long
        with the modality inputs `extra` (only their shapes count), from
        a prefill run on meta tensors."""
        cp, sp, _ = self._meta_weights()
        b = self.batch(torch.empty((batch, prompt_len), dtype=torch.long,
                                   device="meta"), extra, "meta")
        wires = WireTape(self.stack)
        self._prefill_fn(cp, sp, b, wires)
        return TurnCost(wires=tuple(wires), flops=0.0, sync_bytes=0)

    def bytes_per_token(self) -> int:
        c = self.decode_cost(batch=1)
        return c.bytes_up + c.bytes_down
