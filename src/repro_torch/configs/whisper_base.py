"""Whisper-base [arXiv:2212.04356] — enc-dec; conv frontend is a stub
(the model takes precomputed frame embeddings (B, 1500, 512))."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-base", family="audio",
    n_layers=6, d_model=512, n_heads=8, n_kv_heads=8, head_dim=64,
    d_ff=2048, vocab=51865, norm="layernorm", mlp="gelu",
    encdec=True, n_enc_layers=6, n_audio_frames=1500,
    long_window=None,          # decoder positions architecturally capped
    default_cut=2,
    source="arXiv:2212.04356")
