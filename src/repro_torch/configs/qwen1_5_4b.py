"""Qwen1.5-4B — dense GQA decoder with QKV bias. [hf:Qwen/Qwen1.5-0.5B]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-4b", family="dense",
    n_layers=40, d_model=2560, n_heads=20, n_kv_heads=20,
    d_ff=6912, vocab_size=151936,
    qkv_bias=True, rope_theta=1_000_000.0, mlp="swiglu",
    source="hf:Qwen/Qwen1.5-0.5B (family card, scaled per assignment)",
)
