"""Llama-3 405B — dense GQA decoder, 128k vocab. [arXiv:2407.21783]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama3-405b", family="dense",
    n_layers=126, d_model=16384, n_heads=128, n_kv_heads=8,
    d_ff=53248, vocab_size=128256,
    rope_theta=500_000.0, mlp="swiglu",
    source="arXiv:2407.21783 (The Llama 3 Herd of Models, Table 3)",
)
