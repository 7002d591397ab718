"""Llama-3.1-8B — the paper's exemplar model (RAPID Section 4). [arXiv:2407.21783]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama3.1-8b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab_size=128256,
    rope_theta=500_000.0, mlp="swiglu",
    source="arXiv:2407.21783; RAPID Section 4 exemplar model",
)
