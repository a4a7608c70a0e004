"""Mamba2-130M [arXiv:2405.21060] — attention-free SSM (SSD)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-130m", family="ssm",
    n_layers=24, d_model=768, n_heads=0, n_kv_heads=0, d_ff=0,
    vocab=50280, ssm_state=128, ssm_expand=2, ssm_head_dim=64,
    ssm_groups=1, ssm_chunk=256, mlp="none", tie_embeddings=True,
    default_cut=4,
    source="arXiv:2405.21060")
