"""Decoder-only LM for split training and serving (port of
`repro/models/lm.py`).

Model params:
    {"embed": {"table"}, "groups": [g0, ...], "final_norm": {"scale"},
     ["head"]: {"w"}, ["vision_proj"]: {"w", "b"}}

A group is a homogeneous run of layers (`GroupSpec`).  Where the
reference stacks a group's layer params along a leading axis and scans,
the port keeps a list with one entry per repeat, each a dict from the
spec index ("0", ...) to that layer's params, and loops in Python.
Caches follow the same layout.

Split hooks: `split_params(params, cut)` gives the client the embedding
and layers [0, cut) and the server the rest plus the final norm and the
head.  Training runs the no-cache forward (`forward`, `loss`, and the
halves `apply_client` / `apply_server`); monolithic serving prefills and
decodes the whole model (`init_cache`, `prefill`, `decode_step`), split
serving each half against its own caches.  Either way only the cut
activation crosses.  The port builds the dense family, the MoE family (Qwen3-MoE's
GQA + MoE blocks; DeepSeek-V2's MLA blocks, a dense first group, then
MoE with shared experts), the SSM family (Mamba2), the hybrid family
(RecurrentGemma's composite super-blocks) and the VLM family
(InternVL2: the dense trunk behind `vision_proj`, a `vision_dim ->
d_model` dense with bias over the stub frontend's `patch_embeds`,
whose rows go in front of the text's; the client owns it, the logits
cover the text positions only, every cache and rope position counts
the patches first, and decode is text-only).  The encoder-decoder
family is `models.encdec`.  Each block's returned cache
is written back into its slot of the group's cache list: the attention
rings are updated in place anyway, but the Mamba2 and RG-LRU conv
windows and states are new tensors.
"""
from __future__ import annotations

import dataclasses

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.nn import attention as A
from repro_torch.nn import layers as L
from repro_torch.nn import moe as M
from repro_torch.nn import rglru as R
from repro_torch.nn import ssm as S
from repro_torch.nn import transformer as T


@dataclasses.dataclass(frozen=True)
class GroupSpec:
    specs: tuple                  # tuple[BlockSpec]; len>1 = composite
    n_repeat: int

    @property
    def layers_per_repeat(self) -> int:
        return len(self.specs)

    @property
    def n_layers(self) -> int:
        return self.n_repeat * len(self.specs)


def _attn_cfg(cfg: ArchConfig, *, window=None) -> A.AttnConfig:
    if cfg.attn_kind == "mla":
        return A.AttnConfig(
            d_model=cfg.d_model, n_heads=cfg.n_heads,
            n_kv_heads=cfg.n_kv_heads, head_dim=cfg.resolved_head_dim,
            kind="mla", q_lora_rank=cfg.q_lora_rank,
            kv_lora_rank=cfg.kv_lora_rank,
            qk_nope_head_dim=cfg.qk_nope_head_dim,
            qk_rope_head_dim=cfg.qk_rope_head_dim,
            v_head_dim=cfg.v_head_dim, rope_theta=cfg.rope_theta,
            window=window, dtype=cfg.dtype)
    return A.AttnConfig(
        d_model=cfg.d_model, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.resolved_head_dim, qkv_bias=cfg.qkv_bias,
        rope_fraction=cfg.rope_fraction, rope_theta=cfg.rope_theta,
        window=window, dtype=cfg.dtype)


def _block_spec(cfg: ArchConfig, kind: str, *, window=None,
                moe_layer=False) -> T.BlockSpec:
    common = dict(d_model=cfg.d_model, norm=cfg.norm, dtype=cfg.dtype)
    if kind in ("attn", "mla"):
        attn = _attn_cfg(cfg, window=window)
        if moe_layer:
            moe = M.MoEConfig(d_model=cfg.d_model, d_ff=cfg.d_ff,
                              n_experts=cfg.n_experts, top_k=cfg.top_k,
                              n_shared=cfg.n_shared, dtype=cfg.dtype)
            return T.BlockSpec(mixer=kind, mlp="moe", attn=attn, moe=moe,
                               **common)
        return T.BlockSpec(mixer=kind, mlp=cfg.mlp if cfg.mlp != "none"
                           else "swiglu", d_ff=cfg.dense_d_ff or cfg.d_ff,
                           attn=attn, **common)
    if kind == "mamba2":
        ssm = S.SSMConfig(d_model=cfg.d_model,
                          d_inner=cfg.ssm_expand * cfg.d_model,
                          head_dim=cfg.ssm_head_dim, d_state=cfg.ssm_state,
                          n_groups=cfg.ssm_groups, chunk=cfg.ssm_chunk,
                          dtype=cfg.dtype)
        return T.BlockSpec(mixer="mamba2", mlp="none", ssm=ssm, **common)
    if kind == "rglru":
        rg = R.RGLRUConfig(d_model=cfg.d_model,
                           lru_width=cfg.lru_width or cfg.d_model,
                           dtype=cfg.dtype)
        return T.BlockSpec(mixer="rglru", mlp=cfg.mlp, d_ff=cfg.d_ff,
                           rglru=rg, **common)
    raise ValueError(kind)


def make_groups(cfg: ArchConfig, *,
                long_context: bool = False) -> list[GroupSpec]:
    """The SSM family: one group of Mamba2 blocks (no channel mixer).  The
    dense family: one group of identical attn + MLP blocks.  The MoE
    family: a group of `first_dense` attention (or MLA) blocks with a
    dense SwiGLU of `dense_d_ff`, if any, then a group of attention (or
    MLA) + MoE blocks.  The hybrid family: one composite group of the
    layer pattern (RecurrentGemma's rglru, rglru, attn, the attention
    local within the window) repeated n_layers // len(pattern) times,
    plus a remainder group of the pattern's first n_layers % len(pattern)
    blocks; a cut falls on a super-block boundary (`split_params`).

    `long_context=True` builds the long-context variant: where the config
    has a `long_window`, every attention block attends within it (the
    decode ring holds that many rows).  No parameter changes shape, so
    the variant takes the normal model's parameters as they are."""
    window = cfg.window
    if long_context and cfg.long_window:
        window = cfg.long_window
    if cfg.family == "ssm":
        return [GroupSpec((_block_spec(cfg, "mamba2"),), cfg.n_layers)]
    if cfg.family not in ("dense", "moe", "hybrid", "vlm") or cfg.encdec:
        raise NotImplementedError(
            f"{cfg.name} ({cfg.family}): an LM is of the dense, MoE, SSM, "
            "hybrid or VLM family; an encoder-decoder model is "
            "models.encdec.EncDec")
    if cfg.pattern:
        n_full, rem = divmod(cfg.n_layers, len(cfg.pattern))
        specs = tuple(_block_spec(cfg, k, window=window
                                  if k == "attn" else None)
                      for k in cfg.pattern)
        groups = [GroupSpec(specs, n_full)]
        if rem:
            groups.append(GroupSpec(specs[:rem], 1))
        return groups
    kind = "mla" if cfg.attn_kind == "mla" else "attn"
    if cfg.n_experts:
        groups = []
        if cfg.first_dense:
            groups.append(GroupSpec(
                (_block_spec(cfg, kind, window=window),), cfg.first_dense))
        groups.append(GroupSpec(
            (_block_spec(cfg, kind, window=window, moe_layer=True),),
            cfg.n_layers - cfg.first_dense))
        return groups
    return [GroupSpec((_block_spec(cfg, kind, window=window),),
                      cfg.n_layers)]


# ---------------------------------------------------------------------------
# Groups: init / cache / prefill / decode
# ---------------------------------------------------------------------------

def group_init(gen, g: GroupSpec, device=None) -> list:
    return [{str(i): T.block_init(gen, spec, device)
             for i, spec in enumerate(g.specs)}
            for _ in range(g.n_repeat)]


def _repeat_apply(layer_params: dict, g: GroupSpec, x):
    for i, spec in enumerate(g.specs):
        x = T.block_apply(layer_params[str(i)], spec, x)
    return x


def group_apply(params: list, g: GroupSpec, x, *, remat: bool = False):
    """The no-cache forward of a group: its repeats in order, each
    running the group's specs in order.  `remat=True` checkpoints each
    repeat (one layer, or one super-block of a composite group): its
    activations are recomputed in backward instead of stored.  The
    blocks draw no randomness, so no RNG state is kept."""
    for layer_params in params:
        if remat:
            x = checkpoint(_repeat_apply, layer_params, g, x,
                           use_reentrant=False, preserve_rng_state=False)
        else:
            x = _repeat_apply(layer_params, g, x)
    return x


def group_init_cache(g: GroupSpec, batch: int, max_len: int,
                     device=None) -> list:
    return [{str(i): T.block_init_cache(spec, batch, max_len, device)
             for i, spec in enumerate(g.specs)}
            for _ in range(g.n_repeat)]


def group_decode(params: list, g: GroupSpec, x, caches: list):
    for layer_params, cache in zip(params, caches):
        for i, spec in enumerate(g.specs):
            x, cache[str(i)] = T.block_decode(layer_params[str(i)], spec, x,
                                              cache[str(i)])
    return x, caches


def group_prefill(params: list, g: GroupSpec, x, caches: list):
    for layer_params, cache in zip(params, caches):
        for i, spec in enumerate(g.specs):
            x, cache[str(i)] = T.block_prefill(layer_params[str(i)], spec,
                                               x, cache[str(i)])
    return x, caches


def per_slot_pos(caches, batch: int):
    """Turn every `pos` cursor of a cache tree (an int) into a (batch,)
    int32 tensor on its ring's device, in place, and return the tree: the
    layout of the serving `Batcher`, whose stacked slots each advance
    their own position (`nn.attention.gqa_decode`).  Recurrent caches
    (Mamba2, RG-LRU) carry no cursor and pass through unchanged."""
    def walk(t):
        if isinstance(t, dict):
            if "pos" in t and not isinstance(t["pos"], torch.Tensor):
                ring = next(v for v in t.values()
                            if isinstance(v, torch.Tensor))
                t["pos"] = torch.full((batch,), t["pos"], dtype=torch.int32,
                                      device=ring.device)
            for v in t.values():
                walk(v)
        elif isinstance(t, list):
            for v in t:
                walk(v)
    walk(caches)
    return caches


# ---------------------------------------------------------------------------
# The LM
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LM:
    cfg: ArchConfig
    groups: tuple                 # tuple[GroupSpec]

    def init(self, gen: torch.Generator, device=None):
        """Random params drawn from `gen`, on `device` (default the
        generator's)."""
        c = self.cfg
        device = gen.device if device is None else device
        kw = dict(dtype=c.dtype, device=device)
        p = {"embed": L.embedding_init(gen, c.vocab, c.d_model, **kw),
             "groups": [group_init(gen, g, device) for g in self.groups],
             "final_norm": L.rmsnorm_init(c.d_model, **kw)}
        if not c.tie_embeddings:
            p["head"] = L.dense_init(gen, c.d_model, c.vocab, **kw)
        if c.family == "vlm":
            p["vision_proj"] = L.dense_init(gen, c.vision_dim, c.d_model,
                                            bias=True, **kw)
        return p

    # ---- embedding / head / no-cache forward (train) ----
    def embed(self, params, batch):
        """Token embeddings (B, S, D); a VLM's projected patches
        (B, n_patches, D) go in front of them."""
        x = L.embedding_apply(params["embed"], batch["tokens"])
        if self.cfg.family == "vlm":
            vis = L.dense_apply(params["vision_proj"],
                                batch["patch_embeds"].to(self.cfg.dtype))
            x = torch.cat([vis, x], dim=1)
        return x

    def _text(self, logits):
        """A VLM's logits at the text positions only."""
        if self.cfg.family == "vlm":
            return logits[:, self.cfg.n_patches:]
        return logits

    def head(self, params, x):
        x = L.rmsnorm_apply(params["final_norm"], x)
        if self.cfg.tie_embeddings:
            return L.embedding_attend(params["embed"], x)
        return L.dense_apply(params["head"], x)

    def forward(self, params, batch, *, remat: bool = False):
        """{"tokens": (B, S)} (a VLM's also "patch_embeds") -> logits
        (B, S, V); `remat` as in `group_apply`."""
        x = self.embed(params, batch)
        for g, gp in zip(self.groups, params["groups"]):
            x = group_apply(gp, g, x, remat=remat)
        return self._text(self.head(params, x))

    def loss(self, params, batch, *, remat: bool = False):
        """Mean next-token cross-entropy in float32 over `labels`, over the
        positions `loss_mask` keeps when given."""
        lp = torch.log_softmax(self.forward(params, batch,
                                            remat=remat).float(), dim=-1)
        nll = -lp.gather(-1, batch["labels"].long()[..., None])[..., 0]
        mask = batch.get("loss_mask")
        if mask is not None:
            return (nll * mask).sum() / torch.clamp_min(mask.sum(), 1.0)
        return nll.mean()

    # ---- monolithic serving ----
    def init_cache(self, batch: int, max_len: int, device=None):
        return [group_init_cache(g, batch, max_len, device)
                for g in self.groups]

    def prefill(self, params, batch, caches):
        """One teacher-forced forward that fills `caches` (every attention
        layer launches flash once).  Returns (logits (B, S, V), caches);
        logits[:, -1] picks the first generated token."""
        x = self.embed(params, batch)
        for g, gp, c in zip(self.groups, params["groups"], caches):
            x, _ = group_prefill(gp, g, x, c)
        return self._text(self.head(params, x)), caches

    def decode_step(self, params, tokens, caches):
        """tokens (B, 1) -> (logits (B, 1, V), caches)."""
        x = L.embedding_apply(params["embed"], tokens)
        for g, gp, c in zip(self.groups, params["groups"], caches):
            x, _ = group_decode(gp, g, x, c)
        return self.head(params, x), caches

    def flat_layers(self) -> int:
        return sum(g.n_layers for g in self.groups)

    def split_params(self, params, cut: int):
        """Client: embed (a VLM's vision_proj too) + layers [0, cut).
        Server: layers [cut, L) + final norm + head.  With tied
        embeddings the server's head is the client's embedding table,
        SHARED at the split (the same tensor,
        not a copy); a training engine stacks the client's copy, so from
        then on `embed` and `tied_head` are two leaves that train apart,
        as the reference's two trees do."""
        client = {"embed": params["embed"]}
        if "vision_proj" in params:
            client["vision_proj"] = params["vision_proj"]
        server = {"final_norm": params["final_norm"]}
        if "head" in params:
            server["head"] = params["head"]
        else:
            server["tied_head"] = params["embed"]
        cg, sg = [], []
        seen = 0
        for g, gp in zip(self.groups, params["groups"]):
            lo, hi = seen, seen + g.n_layers
            seen = hi
            if hi <= cut:
                cg.append(gp)
            elif lo >= cut:
                sg.append(gp)
            else:
                k = cut - lo
                if k % g.layers_per_repeat:
                    raise ValueError(f"cut {cut} splits a composite "
                                     "super-block")
                r = k // g.layers_per_repeat
                cg.append(gp[:r])
                sg.append(gp[r:])
        client["groups"] = cg
        server["groups"] = sg
        return client, server

    def _groups_for_range(self, cut: int, side: str) -> list[GroupSpec]:
        out, seen = [], 0
        for g in self.groups:
            lo, hi = seen, seen + g.n_layers
            seen = hi
            if side == "client":
                if hi <= cut:
                    out.append(g)
                elif lo < cut:
                    out.append(dataclasses.replace(
                        g, n_repeat=(cut - lo) // g.layers_per_repeat))
            else:
                if lo >= cut:
                    out.append(g)
                elif hi > cut:
                    out.append(dataclasses.replace(
                        g, n_repeat=(hi - cut) // g.layers_per_repeat))
        return out

    def apply_client(self, client_params, batch, cut: int, *,
                     remat: bool = False):
        """The client half's no-cache forward: embed + layers [0, cut)
        -> the cut activation (B, S, D)."""
        x = self.embed(client_params, batch)
        for g, gp in zip(self._groups_for_range(cut, "client"),
                         client_params["groups"]):
            x = group_apply(gp, g, x, remat=remat)
        return x

    def apply_server(self, server_params, act, cut: int, *,
                     remat: bool = False):
        """The server half's no-cache forward: layers [cut, L) + final
        norm + head on the cut activation -> logits (B, S, V)."""
        x = act
        for g, gp in zip(self._groups_for_range(cut, "server"),
                         server_params["groups"]):
            x = group_apply(gp, g, x, remat=remat)
        return self.server_head(server_params, x)

    def server_head(self, server_params, x):
        """Final norm + unembedding on the server side of a split."""
        x = L.rmsnorm_apply(server_params["final_norm"], x)
        if "head" in server_params:
            return L.dense_apply(server_params["head"], x)
        return L.embedding_attend(server_params["tied_head"], x)

    # ---- split serving (each half owns its own caches) ----
    def init_cache_split(self, batch: int, max_len: int, cut: int,
                         device=None):
        """(client_caches, server_caches) for [0, cut) and [cut, L)."""
        client = [group_init_cache(g, batch, max_len, device)
                  for g in self._groups_for_range(cut, "client")]
        server = [group_init_cache(g, batch, max_len, device)
                  for g in self._groups_for_range(cut, "server")]
        return client, server

    def prefill_client(self, client_params, batch, cut: int, caches):
        """Teacher-forced client half: embed + layers [0, cut).  Returns
        (cut activation (B, S, D), caches)."""
        x = self.embed(client_params, batch)
        for g, gp, c in zip(self._groups_for_range(cut, "client"),
                            client_params["groups"], caches):
            x, _ = group_prefill(gp, g, x, c)
        return x, caches

    def prefill_server(self, server_params, act, cut: int, caches):
        """Teacher-forced server half.  Returns (logits (B, S, V), caches)."""
        x = act
        for g, gp, c in zip(self._groups_for_range(cut, "server"),
                            server_params["groups"], caches):
            x, _ = group_prefill(gp, g, x, c)
        return self._text(self.server_head(server_params, x)), caches

    def decode_step_client(self, client_params, tokens, cut: int, caches):
        """tokens (B, 1) -> (cut activation (B, 1, D), caches).  Token
        embedding only: a VLM's patches entered at prefill."""
        x = L.embedding_apply(client_params["embed"], tokens)
        for g, gp, c in zip(self._groups_for_range(cut, "client"),
                            client_params["groups"], caches):
            x, _ = group_decode(gp, g, x, c)
        return x, caches

    def decode_step_server(self, server_params, act, cut: int, caches):
        """act (B, 1, D) -> (logits (B, 1, V), caches)."""
        x = act
        for g, gp, c in zip(self._groups_for_range(cut, "server"),
                            server_params["groups"], caches):
            x, _ = group_decode(gp, g, x, c)
        return self.server_head(server_params, x), caches


def replace_specs(model: LM, *, attn: dict | None = None,
                  moe: dict | None = None) -> LM:
    """`model` with fields of its blocks' configs replaced
    (`dataclasses.replace` on the group specs): `moe` on every MoE
    layer's, `attn` on every GQA layer's.  The sharded and quantized
    paths are switched on so, e.g. `replace_specs(model,
    moe={"ep_axis": "model"})`, `attn={"decode_kv_shard": "model"}` or
    `attn={"kv_cache_dtype": "int8"}` (the sharded ones over the mesh
    `nn.dist.set_mesh` registers); no config field or flag sets them."""
    def spec(s: T.BlockSpec) -> T.BlockSpec:
        if moe and s.moe is not None:
            s = dataclasses.replace(s, moe=dataclasses.replace(s.moe, **moe))
        if attn and s.attn is not None and s.attn.kind == "gqa":
            s = dataclasses.replace(s, attn=dataclasses.replace(s.attn,
                                                                **attn))
        return s
    return dataclasses.replace(model, groups=tuple(
        dataclasses.replace(g, specs=tuple(map(spec, g.specs)))
        for g in model.groups))


def build_lm(cfg: ArchConfig, *, long_context: bool = False) -> LM:
    return LM(cfg=cfg, groups=tuple(make_groups(cfg,
                                                long_context=long_context)))
