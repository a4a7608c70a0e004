"""Phi-4-mini-3.8B [arXiv:2412.08905] — RoPE + SwiGLU + GQA."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="phi4-mini-3.8b", family="dense",
    n_layers=32, d_model=3072, n_heads=24, n_kv_heads=8, head_dim=128,
    d_ff=8192, vocab=200064, tie_embeddings=True,
    long_window=8192,
    default_cut=4,
    source="arXiv:2412.08905")
