"""Model architecture configs for the PyTorch port.

A copy of the JAX package's ``ModelConfig`` (same fields, same
``reduced()``), ``InputShape``, ``INPUT_SHAPES`` and ``ARCH_IDS``, so the
port depends on nothing in ``repro``. Each ported
architecture has one module in ``repro_torch/configs`` exporting ``CONFIG``
(the exact published shape, cited).
"""
from __future__ import annotations

import dataclasses
import importlib
from dataclasses import dataclass
from typing import Optional, Tuple

FAMILIES = ("dense", "moe", "ssm", "hybrid", "audio", "vlm")


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # one of FAMILIES
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0               # 0 -> d_model // n_heads
    # attention details
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    window: Optional[int] = None    # sliding-window size (None = full causal)
    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    shared_expert: bool = False     # llama4-style shared FFN beside routed experts
    moe_group_size: int = 512       # gshard dispatch group size (tokens)
    moe_every: int = 1              # every k-th layer is MoE (llama4: 2)
    d_ff_dense: int = 0             # FFN width of interleaved dense layers (0 -> d_ff)
    # MLP variant
    mlp: str = "swiglu"             # "swiglu" | "gelu"
    # hybrid / ssm structure
    attn_pattern: Tuple[str, ...] = ()   # e.g. ("rec","rec","attn"); repeats over layers
    slstm_every: int = 0            # xlstm: every k-th layer is sLSTM (0 = none)
    conv_width: int = 4             # RG-LRU temporal conv width
    lru_width: int = 0              # RG-LRU recurrence width (0 -> d_model)
    # encoder-decoder (audio)
    is_encoder_decoder: bool = False
    n_encoder_layers: int = 0
    encoder_seq: int = 1500         # whisper: 30 s of audio after conv frontend
    # norms / numerics
    norm: str = "rmsnorm"           # "rmsnorm" | "layernorm"
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    source: str = ""                # citation for the config

    def __post_init__(self):
        assert self.family in FAMILIES, self.family
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        assert self.n_heads % self.n_kv_heads == 0 or self.n_kv_heads > self.n_heads is False

    # ---- derived quantities -------------------------------------------------
    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    def layer_kinds(self) -> Tuple[str, ...]:
        """Per-layer block kind for the decoder stack."""
        if self.family == "ssm":
            kinds = []
            for i in range(self.n_layers):
                if self.slstm_every and (i % self.slstm_every == self.slstm_every - 1):
                    kinds.append("slstm")
                else:
                    kinds.append("mlstm")
            return tuple(kinds)
        if self.family == "hybrid":
            pat = self.attn_pattern or ("rec", "rec", "attn")
            return tuple(pat[i % len(pat)] for i in range(self.n_layers))
        return tuple("attn" for _ in range(self.n_layers))

    def param_count(self) -> int:
        """Analytic parameter count (embedding included once if tied)."""
        D, F, V = self.d_model, self.d_ff, self.vocab_size
        qd, kvd = self.q_dim, self.kv_dim
        total = V * D                      # embed
        if not self.tie_embeddings:
            total += D * V                 # unembed
        enc_layers = self.n_encoder_layers if self.is_encoder_decoder else 0
        kinds = self.layer_kinds()
        ffn_kinds = self.ffn_kinds()
        for kind, fkind in zip(kinds, ffn_kinds):
            total += 2 * D                 # two norms
            if kind == "attn":
                total += D * (qd + 2 * kvd) + qd * D
                if self.qkv_bias:
                    total += qd + 2 * kvd
                total += self._ffn_params(fkind)
            elif kind == "mlstm":
                # xlstm mLSTM block: up-proj 2x, q/k/v proj in inner dim, gates, out
                inner = 2 * D
                total += D * inner * 2 + inner * D           # up (x2 branches) + down
                total += 3 * inner * self.head_dim * self.n_heads // max(self.n_heads, 1)
                total += 2 * inner                           # i/f gate proj (per-unit)
            elif kind == "slstm":
                h = self.n_heads
                total += 4 * D * D + 4 * D * (D // max(h, 1))  # in-proj + block-diag recurrent
                total += self._ffn_params() if F else 0
            elif kind == "rec":
                W = self.lru_width or D
                total += D * W * 2 + W * D                   # in (gate+rec branch) + out
                total += W * self.conv_width + 2 * W * W // 8  # conv + lru gates (8-block diag)
                total += self._ffn_params()
        for _ in range(enc_layers):
            total += 2 * D + D * (qd + 2 * kvd) + qd * D + self._ffn_params()
        if self.is_encoder_decoder:        # cross-attention in every decoder layer
            total += self.n_layers * (D * (qd + 2 * kvd) + qd * D + D)
        return total

    def ffn_kinds(self) -> Tuple[str, ...]:
        """Per-layer FFN kind: "moe" or "dense" (interleaving per moe_every)."""
        if not self.n_experts:
            return tuple("dense" for _ in range(self.n_layers))
        return tuple(
            "moe" if (i % self.moe_every == self.moe_every - 1) else "dense"
            for i in range(self.n_layers)
        )

    def _ffn_params(self, kind: str = "moe") -> int:
        D, F = self.d_model, self.d_ff
        if F == 0:
            return 0
        mult = 3 if self.mlp == "swiglu" else 2
        if self.n_experts and kind == "moe":
            per = mult * D * F
            total = self.n_experts * per + D * self.n_experts  # + router
            if self.shared_expert:
                total += per
            return total
        return mult * D * (self.d_ff_dense or F)

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only routed top-k experts)."""
        if not self.n_experts:
            return self.param_count()
        full = self.param_count()
        D, F = self.d_model, self.d_ff
        per = (3 if self.mlp == "swiglu" else 2) * D * F
        n_moe_layers = sum(1 for k in self.ffn_kinds() if k == "moe")
        inactive = n_moe_layers * (self.n_experts - self.top_k) * per
        return full - inactive

    # ---- smoke-test variant --------------------------------------------------
    def reduced(self) -> "ModelConfig":
        """2-layer / small-width variant of the same family for CPU smoke tests."""
        changes = dict(
            name=self.name + "-smoke",
            n_layers=2,
            d_model=256,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads < self.n_heads else 4,
            head_dim=64,
            d_ff=512 if self.d_ff else 0,
            vocab_size=512,
            moe_group_size=64,
        )
        if self.n_experts:
            changes["n_experts"] = 4
            changes["top_k"] = min(self.top_k, 2)
        if self.is_encoder_decoder:
            changes["n_encoder_layers"] = 2
            changes["encoder_seq"] = 16
        if self.family == "hybrid":
            changes["attn_pattern"] = ("rec", "attn")
            changes["lru_width"] = 256
            changes["window"] = 32
        if self.family == "ssm":
            changes["slstm_every"] = 2
            changes["n_heads"] = 2
            changes["n_kv_heads"] = 2
            changes["head_dim"] = 128
        return dataclasses.replace(self, **changes)

    def with_window(self, window: int) -> "ModelConfig":
        return dataclasses.replace(self, window=window)


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                       # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}

ARCH_IDS = (
    "qwen1_5_4b",
    "granite_3_8b",
    "llama3_405b",
    "starcoder2_15b",
    "llama4_maverick",
    "whisper_large_v3",
    "xlstm_350m",
    "recurrentgemma_2b",
    "phi3_5_moe",
    "chameleon_34b",
)

# CLI-facing aliases (the assignment spells them with dots/dashes)
ARCH_ALIASES = {
    "qwen1.5-4b": "qwen1_5_4b",
    "granite-3-8b": "granite_3_8b",
    "llama3-405b": "llama3_405b",
    "starcoder2-15b": "starcoder2_15b",
    "llama4-maverick-400b-a17b": "llama4_maverick",
    "whisper-large-v3": "whisper_large_v3",
    "xlstm-350m": "xlstm_350m",
    "recurrentgemma-2b": "recurrentgemma_2b",
    "phi3.5-moe-42b-a6.6b": "phi3_5_moe",
    "chameleon-34b": "chameleon_34b",
    "llama3.1-8b": "llama31_8b",
}

# every architecture of the JAX package, and llama3.1-8b
PORTED_ARCHS = ("llama31_8b", "qwen1_5_4b", "granite_3_8b", "llama3_405b",
                "starcoder2_15b", "chameleon_34b", "recurrentgemma_2b",
                "xlstm_350m", "phi3_5_moe", "llama4_maverick",
                "whisper_large_v3")


def get_config(arch: str) -> ModelConfig:
    arch = ARCH_ALIASES.get(arch, arch).replace("-", "_").replace(".", "_")
    if arch not in PORTED_ARCHS:
        raise KeyError(f"unknown arch {arch!r}")
    mod = importlib.import_module(f"repro_torch.configs.{arch}")
    return mod.CONFIG
