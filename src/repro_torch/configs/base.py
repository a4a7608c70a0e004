"""ArchConfig — the port's copy of `repro.configs.base.ArchConfig`, with
torch dtypes, plus the config registry.

Every family of the reference builds: the dense, MoE (with MLA), SSM,
hybrid and VLM families as an `models.lm.LM`, the encoder-decoder
(audio) family as a `models.encdec.EncDec`.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Any

import torch

# every arch id, in the reference's order (`repro/configs/base.py:125`)
ARCH_IDS = [
    "qwen1_5_32b", "mamba2_130m", "mistral_large_123b", "deepseek_v2_236b",
    "recurrentgemma_2b", "internvl2_2b", "qwen3_moe_30b_a3b", "chatglm3_6b",
    "phi4_mini_3_8b", "whisper_base",
]


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


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                      # train | prefill | decode


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}


def get_config(arch_id: str) -> ArchConfig:
    arch_id = arch_id.replace("-", "_")
    if arch_id not in ARCH_IDS:
        raise ValueError(f"{arch_id}: no such architecture; the known ones "
                         f"are {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{arch_id}")
    return mod.CONFIG


def all_configs() -> dict:
    return {a: get_config(a) for a in ARCH_IDS}
