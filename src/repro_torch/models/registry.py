"""Model registry (port of `repro/models/registry.py`)."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig, InputShape
from repro_torch.models.encdec import build_encdec
from repro_torch.models.lm import build_lm

# Whisper's decoder works over at most this many text positions
WHISPER_TEXT_LEN = 448


def build_model(cfg: ArchConfig, *, long_context: bool = False):
    """The model of `cfg`; `long_context=True` gives an LM its
    long-context variant (`models.lm.make_groups`).  An encoder-decoder
    model has none and ignores it, as the reference's does."""
    if cfg.encdec:
        return build_encdec(cfg)
    return build_lm(cfg, long_context=long_context)


def text_len(cfg: ArchConfig, seq_len: int) -> int:
    """The text positions of an input `seq_len` long: an encoder-decoder
    model with a real frontend (over 100 frames) caps them at
    `WHISPER_TEXT_LEN`; a VLM's patches take `n_patches` of them, and at
    least one is left."""
    if cfg.encdec:
        return min(seq_len, WHISPER_TEXT_LEN if cfg.n_audio_frames > 100
                   else seq_len)
    if cfg.family == "vlm":
        return max(seq_len - cfg.n_patches, 1)
    return seq_len


def input_specs(cfg: ArchConfig, shape: InputShape) -> dict:
    """Meta-tensor stand-ins for every model input (nothing allocated):
    int64 token ids and labels, the stub frontends' frames or patches in
    the model's dtype."""
    B = shape.global_batch

    def tok(*s):
        return torch.empty(s, dtype=torch.long, device="meta")

    def feats(*s):
        return torch.empty(s, dtype=cfg.dtype, device="meta")

    s_txt = 1 if shape.kind == "decode" else text_len(cfg, shape.seq_len)
    out = {"tokens": tok(B, s_txt)}
    if shape.kind == "train":
        out["labels"] = tok(B, s_txt)
    if cfg.encdec:
        out["audio_feats"] = feats(B, cfg.n_audio_frames, cfg.d_model)
    elif cfg.family == "vlm":
        out["patch_embeds"] = feats(B, cfg.n_patches, cfg.vision_dim)
    return out


def supports_split_serving(cfg: ArchConfig) -> tuple[bool, str]:
    """(supported, reason-if-not) for the cut-at-layer serving engine.
    Encoder-decoder archs serve monolithically: their split mapping is
    vertical (encoder-side client), not a decoder layer cut."""
    if cfg.encdec:
        return False, "encdec archs have no decoder layer cut; serve " \
                      "monolithically"
    return True, ""


def supports_shape(cfg: ArchConfig, shape: InputShape) -> tuple[bool, str]:
    """(supported, reason-if-not): the reference's skip rule.  Only
    `long_500k` is refused, to an attention arch with no sliding-window
    long-context variant; the SSM and hybrid families carry no full
    attention and take it."""
    if shape.name == "long_500k":
        if cfg.family in ("ssm", "hybrid"):
            return True, ""
        if cfg.long_window:
            return True, ""
        return False, ("full-attention arch without a sliding-window "
                       "long-context variant")
    return True, ""
