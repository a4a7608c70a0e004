"""ArchConfig — the port's copy of `repro.configs.base.ArchConfig`, with
torch dtypes, plus the config registry.

The dense, MoE (with MLA), SSM and hybrid families build
(`models.lm.make_groups`); the other fields are kept so a config reads
the same in both packages.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Any

import torch

# arch ids whose config module the port carries so far
PORTED_ARCH_IDS = ["phi4_mini_3_8b", "mamba2_130m", "recurrentgemma_2b",
                   "qwen3_moe_30b_a3b", "deepseek_v2_236b", "chatglm3_6b",
                   "qwen1_5_32b", "mistral_large_123b"]


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0              # 0 -> d_model // n_heads
    qkv_bias: bool = False
    rope_fraction: float = 1.0
    rope_theta: float = 10000.0
    norm: str = "rmsnorm"
    mlp: str = "swiglu"            # swiglu | gelu
    tie_embeddings: bool = False
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    n_shared: int = 0
    dense_d_ff: int = 0
    first_dense: int = 0
    # --- attention kind ---
    attn_kind: str = "gqa"         # gqa | mla
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0
    window: int | None = None
    # --- SSM (mamba2) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_groups: int = 1
    ssm_chunk: int = 256
    # --- hybrid (recurrentgemma) ---
    pattern: tuple = ()
    lru_width: int = 0
    # --- vlm ---
    n_patches: int = 0
    vision_dim: int = 0
    # --- audio / enc-dec ---
    encdec: bool = False
    n_enc_layers: int = 0
    n_audio_frames: int = 0
    # --- long-context variant ---
    long_window: int | None = None
    # --- split learning default ---
    default_cut: int = 2
    dtype: Any = torch.bfloat16
    source: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def reduced(self, **overrides) -> "ArchConfig":
        """CPU-test variant: 2 layers, small dims, same family, fp32 —
        the same shrink as the reference's `reduced()`."""
        small = dict(
            n_layers=2, d_model=min(self.d_model, 128),
            n_heads=min(self.n_heads, 4),
            n_kv_heads=min(self.n_kv_heads, 2),
            head_dim=32 if self.head_dim else 0,
            d_ff=min(self.d_ff, 256) if self.d_ff else 0,
            vocab=min(self.vocab, 512),
            dtype=torch.float32,
        )
        if self.n_experts:
            small.update(n_experts=min(self.n_experts, 4),
                         top_k=min(self.top_k, 2),
                         n_shared=min(self.n_shared, 1),
                         dense_d_ff=min(self.dense_d_ff, 256)
                         if self.dense_d_ff else 0,
                         first_dense=min(self.first_dense, 1))
        if self.attn_kind == "mla":
            small.update(q_lora_rank=min(self.q_lora_rank, 64),
                         kv_lora_rank=min(self.kv_lora_rank, 32),
                         qk_nope_head_dim=32, qk_rope_head_dim=16,
                         v_head_dim=32, head_dim=32)
        if self.family == "ssm":
            small.update(ssm_state=min(self.ssm_state, 32),
                         ssm_head_dim=32, ssm_chunk=8)
        if self.pattern:
            small.update(n_layers=len(self.pattern),
                         lru_width=min(self.lru_width or self.d_model, 128),
                         window=min(self.window or 64, 64))
        if self.family == "vlm":
            small.update(n_patches=8, vision_dim=64)
        if self.encdec:
            small.update(n_enc_layers=2, n_audio_frames=16)
        if self.window:
            small.setdefault("window", min(self.window, 64))
        small.update(overrides)
        return dataclasses.replace(self, **small)


def get_config(arch_id: str) -> ArchConfig:
    arch_id = arch_id.replace("-", "_")
    if arch_id not in PORTED_ARCH_IDS:
        raise NotImplementedError(
            f"{arch_id}: not ported yet; the port serves {PORTED_ARCH_IDS} "
            "and the other architectures come with later slices")
    mod = importlib.import_module(f"repro_torch.configs.{arch_id}")
    return mod.CONFIG
