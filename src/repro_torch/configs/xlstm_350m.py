"""xLSTM-350M — sLSTM + mLSTM block stack (no separate FFN; mLSTM blocks carry
an internal 2x up-projection). [arXiv:2405.04517]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-350m", family="ssm",
    n_layers=24, d_model=1024, n_heads=4, n_kv_heads=4,
    d_ff=0, vocab_size=50304,
    slstm_every=8,   # 7:1 mLSTM:sLSTM ratio per the xLSTM paper
    head_dim=256,
    source="arXiv:2405.04517 (xLSTM, 350M config Table 9)",
)
