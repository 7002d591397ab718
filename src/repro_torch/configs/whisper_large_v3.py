"""Whisper large-v3 — encoder-decoder audio backbone; mel+conv frontend is a
stub that supplies precomputed frame embeddings. [arXiv:2212.04356]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3", family="audio",
    n_layers=32, d_model=1280, n_heads=20, n_kv_heads=20,
    d_ff=5120, vocab_size=51866,
    is_encoder_decoder=True, n_encoder_layers=32, encoder_seq=1500,
    mlp="gelu", norm="layernorm", qkv_bias=True, rope_theta=0.0,
    source="arXiv:2212.04356 (Robust Speech Recognition, large-v3 card)",
)
