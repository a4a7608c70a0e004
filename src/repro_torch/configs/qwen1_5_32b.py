"""Qwen1.5-32B [hf:Qwen/Qwen1.5-0.5B family scaling] — dense, QKV bias.

The reference's scaled config, copied field for field: MHA 40/40, 35.2B
parameters.  The published Qwen1.5-32B (hf:Qwen/Qwen1.5-32B) has 40
heads over 8 KV heads and about 32.5B parameters.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen1.5-32b", family="dense",
    n_layers=64, d_model=5120, n_heads=40, n_kv_heads=40, head_dim=128,
    d_ff=27392, vocab=152064, qkv_bias=True,
    long_window=8192,          # long-context sliding-window variant
    default_cut=4,
    source="hf:Qwen/Qwen1.5-0.5B (family card, scaled per assignment)")
