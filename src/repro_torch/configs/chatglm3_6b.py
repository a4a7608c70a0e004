"""ChatGLM3-6B [arXiv:2406.12793] — 2d (half-dim) RoPE, GQA kv=2, QKV bias."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="chatglm3-6b", family="dense",
    n_layers=28, d_model=4096, n_heads=32, n_kv_heads=2, head_dim=128,
    d_ff=13696, vocab=65024, qkv_bias=True, rope_fraction=0.5,
    long_window=8192,
    default_cut=4,
    source="arXiv:2406.12793")
