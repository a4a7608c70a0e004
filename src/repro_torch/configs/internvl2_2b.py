"""InternVL2-2B [arXiv:2404.16821] — InternViT (stub frontend) + InternLM2."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-2b", family="vlm",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=8, head_dim=128,
    d_ff=8192, vocab=92553,
    n_patches=256, vision_dim=1024,
    long_window=8192,
    default_cut=4,
    source="arXiv:2404.16821")
