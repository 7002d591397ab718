"""RecurrentGemma-2B — Griffin-style hybrid: RG-LRU recurrent blocks + local
attention, 1 attention per 2 recurrent layers. [arXiv:2402.19427]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b", family="hybrid",
    n_layers=26, d_model=2560, n_heads=10, n_kv_heads=1,
    d_ff=7680, vocab_size=256000,
    attn_pattern=("rec", "rec", "attn"), window=2048,
    head_dim=256, lru_width=2560, conv_width=4,
    source="arXiv:2402.19427 (Griffin/RecurrentGemma-2B card)",
)
