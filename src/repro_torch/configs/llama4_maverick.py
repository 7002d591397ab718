"""Llama-4 Maverick 400B-A17B — MoE 128 experts top-1 + shared expert,
early-fusion multimodal (VQ tokens share the text vocab; frontend stubbed).
[hf:meta-llama/Llama-4-Scout-17B-16E]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b", family="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8,
    d_ff=8192, vocab_size=202048,
    n_experts=128, top_k=1, shared_expert=True, moe_every=2, d_ff_dense=16384,
    rope_theta=500_000.0, mlp="swiglu", qk_norm=True,
    source="hf:meta-llama/Llama-4-Scout-17B-16E (family card, per assignment)",
)
