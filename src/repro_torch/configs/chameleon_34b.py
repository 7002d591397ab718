"""Chameleon-34B — early-fusion VLM: VQ image tokens share the unified 65536
vocab (VQ tokenizer stubbed); QK-norm for stability. [arXiv:2405.09818]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b", family="vlm",
    n_layers=48, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=22016, vocab_size=65536,
    qk_norm=True, rope_theta=10_000.0, mlp="swiglu",
    source="arXiv:2405.09818 (Chameleon, 34B config)",
)
