"""Decoder-only transformer, ported from ``repro.models.transformer``
(families ``"dense"`` and ``"vlm"``: Chameleon's early fusion puts image
tokens in the one vocabulary, so the vlm runs the same stack; its
tokenizer is not modelled, as in the JAX package).

Parameters keep the JAX package's pytree: every per-layer leaf is stacked
along a leading layer dim ``G`` under ``slots[0]`` (the JAX package stacks
them with ``vmap`` to ``scan`` over them); here a written-out loop walks
that dim. The KV cache is ``{"slots": ({"k", "v"},), "pos"}`` with
(G, B, Sc, K, hd) tensors; ``prefill`` and ``decode_step`` write into them
in place and return them.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.models import layers as L
from repro_torch.models.params import layer_of, prefixed


def check_supported(cfg) -> None:
    """Raise for the options the port does not carry yet, naming the
    ROADMAP item."""
    if cfg.n_experts or cfg.moe_every != 1:
        raise NotImplementedError(
            f"{cfg.name}: MoE layers are not ported yet (ROADMAP item A5)")


def param_specs(cfg) -> Dict[str, tuple]:
    """Flat parameter layout, keyed by the JAX pytree's paths as
    ``repro.training.checkpoint._flatten`` joins them: name -> (shape,
    init), init a normal std, "ones" or "zeros"."""
    check_supported(cfg)
    G, D, V = cfg.n_layers, cfg.d_model, cfg.vocab_size
    norm = L.init_norm(D, cfg.norm)
    specs = {
        "embed": ((V, D), L.EMBED_STD),
        "unembed": ((D, V), L.dense_std((D, V))),
        **prefixed("final_norm", norm),
    }
    for block, spec in (("ln1", norm), ("ln2", norm),
                        ("attn", L.init_attention(cfg)),
                        ("ffn", L.init_mlp(cfg))):
        for name, (shape, init) in spec.items():
            specs[f"slots/0/{block}/{name}"] = ((G, *shape), init)
    return specs


def init_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16,
               window: Optional[int] = None, device=None) -> dict:
    check_supported(cfg)
    G = cfg.n_layers
    Sc = min(max_len, window) if window else max_len

    def kv():
        return torch.zeros((G, batch, Sc, cfg.n_kv_heads, cfg.head_dim),
                           dtype=dtype, device=device)
    return {"slots": ({"k": kv(), "v": kv()},),
            "pos": torch.zeros((), dtype=torch.int32, device=device)}


def _run_stack(params, x, cfg, mode: str, cache=None, window=None):
    stack = params["slots"][0]
    kv = cache["slots"][0] if cache is not None else None
    for g in range(cfg.n_layers):
        p = layer_of(stack, g)
        h = L.apply_norm(x, p["ln1"], cfg.norm, cfg.norm_eps)
        if mode == "train":
            a = L.attn_forward(p["attn"], h, cfg, window=window)
        elif mode == "prefill":
            a, _, _ = L.attn_prefill(p["attn"], h, cfg, kv["k"][g],
                                     kv["v"][g], window=window)
        else:
            a, _, _ = L.attn_decode(p["attn"], h, cfg, kv["k"][g],
                                    kv["v"][g], cache["pos"], window=window)
        x = x + a
        h = L.apply_norm(x, p["ln2"], cfg.norm, cfg.norm_eps)
        x = x + L.mlp_forward(p["ffn"], h, cfg)
    return x


def _logits(params, x, cfg):
    x = L.apply_norm(x, params["final_norm"], cfg.norm, cfg.norm_eps)
    return x @ params["unembed"]


def forward_train(params, cfg, batch, *, window=None):
    """Full-sequence forward. Returns (logits (B, S, V), aux loss 0)."""
    x = params["embed"][batch["tokens"]]
    x = _run_stack(params, x, cfg, "train", window=window)
    return _logits(params, x, cfg), torch.zeros((), device=x.device)


def prefill(params, cfg, batch, cache, *, window=None):
    """Process the prompt and fill the cache in place. Returns (last-token
    logits, cache)."""
    tokens = batch["tokens"]
    x = params["embed"][tokens]
    x = _run_stack(params, x, cfg, "prefill", cache=cache, window=window)
    last = _logits(params, x[:, -1:, :], cfg)[:, 0]
    pos = torch.tensor(tokens.shape[1], dtype=torch.int32, device=x.device)
    return last, {"slots": cache["slots"], "pos": pos}


def decode_step(params, cfg, token, cache, *, window=None):
    """One decode step; ``cache["pos"]`` is a scalar or (B,) per-slot
    positions. token: (B,) or (B, 1). Returns (logits (B, V), cache), the
    cache written in place and its positions advanced by one."""
    if token.ndim == 1:
        token = token[:, None]
    x = params["embed"][token]
    x = _run_stack(params, x, cfg, "decode", cache=cache, window=window)
    logits = _logits(params, x, cfg)[:, 0]
    return logits, {"slots": cache["slots"], "pos": cache["pos"] + 1}
