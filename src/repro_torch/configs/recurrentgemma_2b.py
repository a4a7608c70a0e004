"""RecurrentGemma-2B [arXiv:2402.19427] — RG-LRU + local attn, 1 attn per 3."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-2b", family="hybrid",
    n_layers=26, d_model=2560, n_heads=10, n_kv_heads=1, head_dim=256,
    d_ff=7680, vocab=256000, lru_width=2560, window=2048,
    pattern=("rglru", "rglru", "attn"), mlp="gelu",
    default_cut=3,
    source="arXiv:2402.19427")
