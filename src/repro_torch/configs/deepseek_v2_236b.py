"""DeepSeek-V2-236B [arXiv:2405.04434] — MLA + 2 shared / 160 routed top-6."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-v2-236b", family="moe",
    n_layers=60, d_model=5120, n_heads=128, n_kv_heads=128, head_dim=192,
    d_ff=1536, vocab=102400,
    n_experts=160, top_k=6, n_shared=2, dense_d_ff=12288, first_dense=1,
    attn_kind="mla", q_lora_rank=1536, kv_lora_rank=512,
    qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128,
    long_window=8192,
    default_cut=4,
    source="arXiv:2405.04434")
