"""Whisper-style encoder-decoder transformer (port of
`repro/models/encdec.py`).

The mel-spectrogram and conv feature extractor are a stub, as in the
reference: the model takes precomputed frame embeddings (B, n_frames,
d_model).  Positions are sinusoidal on both sides.

Params:
    {"enc_blocks": [block, ...], "enc_norm": {"scale", "bias"},
     "embed": {"table"}, "dec_blocks": [dec block, ...],
     "dec_norm": {"scale", "bias"}}
with one dict per layer where the reference stacks the layers along a
leading axis; an encoder block is `nn.transformer`'s layernorm attention
block (bidirectional, qkv bias, the gelu MLP with biases), a decoder
block {"norm1", "self_attn", "norm2", "cross_attn", "norm3", "mlp"}.
The output head is the embedding table (Whisper ties it).

The encoder attends every frame through the flash kernel's non-causal
mode; the decoder's causal self-attention trains and prefills through
its causal mode (`nn.attention.gqa_apply` / `gqa_prefill`; the reference
writes that prefill as a plain masked attention) and decodes plainly
over its ring; cross-attention is plain throughout, as in the
reference.

Decode cache (`init_cache`): {"cross": {"k", "v": (L, B, T, K, hd)},
"self": {"k", "v": (L, B, max_len, K, hd)}, "pos": int}.  The encoder
runs once a request and every decoder layer's cross K/V are kept, so a
decode step reads them and never recomputes them; the self-attention
rings are written in place.

Split learning maps this family vertically (the audio client owns the
encoder), not by a decoder layer cut: `registry.supports_split_serving`
refuses it, as the reference does.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.nn import attention as A
from repro_torch.nn import layers as L
from repro_torch.nn import transformer as T


def sinusoidal_positions(n: int, d: int, offset: int = 0,
                         device=None) -> torch.Tensor:
    """(n, d) float32: sin then cos of (offset + i) / 10000^(2 j / d)."""
    pos = torch.arange(n, device=device)[:, None] + offset
    dim = torch.arange(d // 2, device=device)[None, :]
    ang = pos / torch.pow(10000.0, 2 * dim / d)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _dec_block_init(gen, cfg: ArchConfig, ac: A.AttnConfig, device):
    kw = dict(dtype=cfg.dtype, device=device)
    return {
        "norm1": L.layernorm_init(cfg.d_model, **kw),
        "self_attn": A.gqa_init(gen, ac, device),
        "norm2": L.layernorm_init(cfg.d_model, **kw),
        "cross_attn": A.gqa_init(gen, ac, device),
        "norm3": L.layernorm_init(cfg.d_model, **kw),
        "mlp": L.gelu_mlp_init(gen, cfg.d_model, cfg.d_ff, **kw),
    }


@dataclasses.dataclass(frozen=True)
class EncDec:
    cfg: ArchConfig

    def _enc_spec(self) -> T.BlockSpec:
        c = self.cfg
        ac = A.AttnConfig(d_model=c.d_model, n_heads=c.n_heads,
                          n_kv_heads=c.n_kv_heads,
                          head_dim=c.resolved_head_dim, qkv_bias=True,
                          kind="bidir", dtype=c.dtype)
        return T.BlockSpec(d_model=c.d_model, mixer="attn", mlp="gelu",
                           d_ff=c.d_ff, attn=ac, norm="layernorm",
                           mlp_bias=True, dtype=c.dtype)

    def _dec_attn_cfg(self) -> A.AttnConfig:
        c = self.cfg
        return A.AttnConfig(d_model=c.d_model, n_heads=c.n_heads,
                            n_kv_heads=c.n_kv_heads,
                            head_dim=c.resolved_head_dim, qkv_bias=True,
                            rope_fraction=0.0,      # absolute positions
                            dtype=c.dtype)

    def init(self, gen: torch.Generator, device=None):
        """Random params drawn from `gen`, on `device` (default the
        generator's)."""
        c = self.cfg
        device = gen.device if device is None else device
        kw = dict(dtype=c.dtype, device=device)
        spec, ac = self._enc_spec(), self._dec_attn_cfg()
        return {
            "enc_blocks": [T.block_init(gen, spec, device)
                           for _ in range(c.n_enc_layers)],
            "enc_norm": L.layernorm_init(c.d_model, **kw),
            "embed": L.embedding_init(gen, c.vocab, c.d_model, **kw),
            "dec_blocks": [_dec_block_init(gen, c, ac, device)
                           for _ in range(c.n_layers)],
            "dec_norm": L.layernorm_init(c.d_model, **kw),
        }

    # ---- encoder ----
    def encode(self, params, audio_feats):
        """audio_feats (B, n_frames, d_model), the stub frontend's output
        -> the encoder's states, same shape."""
        _, n, d = audio_feats.shape
        dt = self.cfg.dtype
        x = audio_feats.to(dt) + sinusoidal_positions(
            n, d, device=audio_feats.device).to(dt)
        spec = self._enc_spec()
        for p in params["enc_blocks"]:
            x = T.block_apply(p, spec, x)
        return L.layernorm_apply(params["enc_norm"], x)

    # ---- decoder ----
    def _embed(self, params, tokens, offset: int = 0):
        x = L.embedding_apply(params["embed"], tokens)
        return x + sinusoidal_positions(tokens.shape[1], self.cfg.d_model,
                                        offset, x.device).to(x.dtype)

    def _dec_rest(self, p, ac, h, cross_kv):
        """A decoder block after its self-attention: cross-attention and
        the MLP, each pre-norm with a residual."""
        h = h + A.cross_attn_apply(p["cross_attn"], ac,
                                   L.layernorm_apply(p["norm2"], h), cross_kv)
        return h + L.gelu_mlp_apply(p["mlp"],
                                    L.layernorm_apply(p["norm3"], h))

    def _head(self, params, x):
        x = L.layernorm_apply(params["dec_norm"], x)
        return L.embedding_attend(params["embed"], x)

    def decode_full(self, params, tokens, enc_out):
        """Teacher-forced decoder forward (train) -> logits (B, S, V)."""
        ac = self._dec_attn_cfg()
        x = self._embed(params, tokens)
        for p in params["dec_blocks"]:
            h = x + A.gqa_apply(p["self_attn"], ac,
                                L.layernorm_apply(p["norm1"], x))
            x = self._dec_rest(p, ac, h,
                               A.cross_attn_kv(p["cross_attn"], ac, enc_out))
        return self._head(params, x)

    def forward(self, params, batch, **_):
        """{"audio_feats": (B, n_frames, D), "tokens": (B, S)} -> logits
        (B, S, V).  Keywords such as `remat` are accepted and ignored, as
        the reference's are."""
        enc_out = self.encode(params, batch["audio_feats"])
        return self.decode_full(params, batch["tokens"], enc_out)

    def loss(self, params, batch, **_):
        """Mean next-token cross-entropy in float32 over `labels`
        (keywords ignored, as in `forward`)."""
        lp = torch.log_softmax(self.forward(params, batch).float(), dim=-1)
        nll = -lp.gather(-1, batch["labels"].long()[..., None])[..., 0]
        return nll.mean()

    # ---- incremental decode ----
    def init_cache(self, params, audio_feats, max_len: int):
        """Runs the encoder once and keeps every decoder layer's cross K/V,
        with empty self-attention rings of `max_len` rows."""
        c = self.cfg
        enc_out = self.encode(params, audio_feats)
        ac = self._dec_attn_cfg()
        per_layer = [A.cross_attn_kv(p["cross_attn"], ac, enc_out)
                     for p in params["dec_blocks"]]
        shape = (c.n_layers, audio_feats.shape[0], max_len, c.n_kv_heads,
                 c.resolved_head_dim)
        kw = dict(dtype=c.dtype, device=audio_feats.device)
        return {"cross": {k: torch.stack([kv[k] for kv in per_layer])
                          for k in ("k", "v")},
                "self": {"k": torch.zeros(shape, **kw),
                         "v": torch.zeros(shape, **kw)},
                "pos": 0}

    def _run(self, params, x, cache, attend):
        """The decoder blocks over x against `cache`, each block's
        self-attention through `attend(params, cfg, x, ring)` on its layer
        of the rings; then the final norm and the tied head."""
        ac = self._dec_attn_cfg()
        ring = cache["self"]
        for i, p in enumerate(params["dec_blocks"]):
            layer = {"k": ring["k"][i], "v": ring["v"][i],
                     "pos": cache["pos"]}
            y, _ = attend(p["self_attn"], ac,
                          L.layernorm_apply(p["norm1"], x), layer)
            cross = {"k": cache["cross"]["k"][i],
                     "v": cache["cross"]["v"][i]}
            x = self._dec_rest(p, ac, x + y, cross)
        return self._head(params, x)

    def prefill(self, params, tokens, cache):
        """One teacher-forced decoder pass that fills the self-attention
        rings of a fresh cache (pos == 0), each layer's causal attention
        one flash launch.  Returns (logits (B, S, V), cache)."""
        logits = self._run(params, self._embed(params, tokens), cache,
                           A.gqa_prefill)
        cache["pos"] += tokens.shape[1]
        return logits, cache

    def decode_step(self, params, tokens, cache):
        """tokens (B, 1) -> (logits (B, 1, V), cache), attending the ring
        up to and including the new row, and every encoder frame."""
        x = self._embed(params, tokens, cache["pos"])
        logits = self._run(params, x, cache, A.gqa_decode)
        cache["pos"] += 1
        return logits, cache


def build_encdec(cfg: ArchConfig) -> EncDec:
    return EncDec(cfg=cfg)
