"""Model registry (port of `repro/models/registry.py:12-15, 58-66`)."""
from __future__ import annotations

from repro_torch.configs.base import ArchConfig
from repro_torch.models.lm import build_lm


def build_model(cfg: ArchConfig):
    if cfg.encdec:
        raise NotImplementedError(
            f"{cfg.name}: encoder-decoder models come with a later slice")
    return build_lm(cfg)


def supports_split_serving(cfg: ArchConfig) -> tuple[bool, str]:
    """(supported, reason-if-not) for the cut-at-layer serving engine.
    Encoder-decoder archs serve monolithically: their split mapping is
    vertical (encoder-side client), not a decoder layer cut."""
    if cfg.encdec:
        return False, "encdec archs have no decoder layer cut; serve " \
                      "monolithically"
    return True, ""
