"""Whisper-style encoder-decoder audio backbone, ported from
``repro.models.whisper`` (family ``"audio"``).

As in the JAX package, the mel-spectrogram and convolution front end is a
stub: ``batch["enc_feats"]`` supplies the frame embeddings (B,
encoder_seq, d_model). The encoder is bidirectional; the decoder is causal,
with self-attention over its own KV cache and cross-attention over the
encoder's K and V, projected once at prefill and kept in the cache.
Positions are sinusoidal in both stacks (the JAX package's choice for the
decoder too); there is no RoPE (``rope_theta`` 0).

Parameters keep the JAX package's pytree: ``enc/...`` leaves are stacked
along a leading dim of ``n_encoder_layers``, ``dec/...`` along one of
``n_layers``. The cache is ``{"k", "v", "ck", "cv", "pos"}`` with (L, B,
S, K, hd) tensors (S the cache length for k and v, encoder_seq for ck and
cv); ``prefill`` and ``decode_step`` write into them in place and return
them.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.models import layers as L
from repro_torch.models.params import layer_of, prefixed, unbind_layers


def param_specs(cfg) -> Dict[str, tuple]:
    """Flat parameter layout, keyed by the JAX pytree's paths:
    name -> (shape, init)."""
    D, V = cfg.d_model, cfg.vocab_size
    norm = L.init_norm(D, cfg.norm)
    specs = {
        "embed": ((V, D), L.EMBED_STD),
        "unembed": ((D, V), L.dense_std((D, V))),
        **prefixed("final_norm", norm),
        **prefixed("enc_norm", norm),
    }
    stacks = (
        ("enc", cfg.n_encoder_layers,
         (("ln1", norm), ("ln2", norm), ("attn", L.init_attention(cfg)),
          ("ffn", L.init_mlp(cfg)))),
        ("dec", cfg.n_layers,
         (("ln1", norm), ("ln_c", norm), ("ln2", norm),
          ("attn", L.init_attention(cfg)),
          ("cross", L.init_attention(cfg, cross=True)),
          ("ffn", L.init_mlp(cfg)))))
    for stack, n, blocks in stacks:
        for block, spec in blocks:
            for name, (shape, init) in spec.items():
                specs[f"{stack}/{block}/{name}"] = ((n, *shape), init)
    return specs


def init_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16,
               window: Optional[int] = None, device=None) -> dict:
    Sc = min(max_len, window) if window else max_len

    def kv(s):
        return torch.zeros((cfg.n_layers, batch, s, cfg.n_kv_heads,
                            cfg.head_dim), dtype=dtype, device=device)
    return {"k": kv(Sc), "v": kv(Sc),
            "ck": kv(cfg.encoder_seq), "cv": kv(cfg.encoder_seq),
            "pos": torch.zeros((), dtype=torch.int32, device=device)}


def encode(params, cfg, enc_feats):
    """The bidirectional encoder over the frame embeddings (B, S, D)."""
    S = enc_feats.shape[1]
    x = enc_feats + L.sinusoidal_pos(
        torch.arange(S, device=enc_feats.device), cfg.d_model,
        enc_feats.dtype)
    enc = unbind_layers(params["enc"])
    for g in range(cfg.n_encoder_layers):
        p = layer_of(enc, g)
        h = L.apply_norm(x, p["ln1"], cfg.norm, cfg.norm_eps)
        x = x + L.attn_forward(p["attn"], h, cfg, causal=False)
        h = L.apply_norm(x, p["ln2"], cfg.norm, cfg.norm_eps)
        x = x + L.mlp_forward(p["ffn"], h, cfg)
    return L.apply_norm(x, params["enc_norm"], cfg.norm, cfg.norm_eps)


def _dec_embed(params, cfg, tokens, pos0):
    """Token embeddings plus the sinusoidal embeddings of their positions,
    from a scalar first position or per-slot ones (B,)."""
    x = params["embed"][tokens]
    p0 = torch.as_tensor(pos0, device=x.device)
    steps = torch.arange(tokens.shape[1], device=x.device)
    positions = (p0 + steps)[None, :] if p0.ndim == 0 else \
        p0[:, None] + steps[None, :]
    return x + L.sinusoidal_pos(positions, cfg.d_model, x.dtype)


def _dec_layer(p, x, cfg, mode: str, cache, g: int, enc_out, window):
    """Decoder layer g (``p``, its parameters)."""
    h = L.apply_norm(x, p["ln1"], cfg.norm, cfg.norm_eps)
    if mode == "train":
        a = L.attn_forward(p["attn"], h, cfg, window=window)
        ck, cv = L.cross_attn_cache(p["cross"], enc_out, cfg)
    elif mode == "prefill":
        a, _, _ = L.attn_prefill(p["attn"], h, cfg, cache["k"][g],
                                 cache["v"][g], window=window)
        ck, cv = L.cross_attn_cache(p["cross"], enc_out, cfg)
        cache["ck"][g].copy_(ck)
        cache["cv"][g].copy_(cv)
    else:
        a, _, _ = L.attn_decode(p["attn"], h, cfg, cache["k"][g],
                                cache["v"][g], cache["pos"],
                                window=window)
        ck, cv = cache["ck"][g], cache["cv"][g]
    x = x + a
    h = L.apply_norm(x, p["ln_c"], cfg.norm, cfg.norm_eps)
    x = x + L.cross_attn_apply(p["cross"], h, cfg, ck, cv)
    h = L.apply_norm(x, p["ln2"], cfg.norm, cfg.norm_eps)
    return x + L.mlp_forward(p["ffn"], h, cfg)


def _dec_stack(params, cfg, x, mode: str, cache=None, enc_out=None,
               window=None, remat=False):
    """mode: train, prefill or decode. Train and prefill take ``enc_out``;
    prefill stores its cross K and V in the cache, decode reads them
    there. In training each decoder layer is rematerialised where
    ``remat`` asks (the encoder's are not, as in the JAX package)."""
    dec = unbind_layers(params["dec"])
    for g in range(cfg.n_layers):
        args = (layer_of(dec, g), x, cfg, mode, cache, g, enc_out, window)
        x = L.checkpointed(_dec_layer, *args) if remat else _dec_layer(*args)
    return x


def _logits(params, x, cfg):
    x = L.apply_norm(x, params["final_norm"], cfg.norm, cfg.norm_eps)
    return x @ params["unembed"]


def forward_train(params, cfg, batch, *, window=None, remat=True):
    """Full-sequence forward of ``batch["tokens"]`` over
    ``batch["enc_feats"]``, each decoder layer rematerialised in the
    backward where ``remat`` asks. Returns (logits (B, S, V), aux loss
    0)."""
    enc_out = encode(params, cfg, batch["enc_feats"])
    x = _dec_embed(params, cfg, batch["tokens"], 0)
    x = _dec_stack(params, cfg, x, "train", enc_out=enc_out, window=window,
                   remat=remat)
    return _logits(params, x, cfg), torch.zeros((), device=x.device)


def prefill(params, cfg, batch, cache, *, window=None):
    """Encode the frames, run the prompt and fill the cache in place.
    Returns (last-token logits, cache)."""
    enc_out = encode(params, cfg, batch["enc_feats"])
    tokens = batch["tokens"]
    x = _dec_embed(params, cfg, tokens, 0)
    x = _dec_stack(params, cfg, x, "prefill", cache, enc_out=enc_out,
                   window=window)
    last = _logits(params, x[:, -1:, :], cfg)[:, 0]
    pos = torch.tensor(tokens.shape[1], dtype=torch.int32, device=x.device)
    return last, {**cache, "pos": pos}


def decode_step(params, cfg, token, cache, *, window=None):
    """One decode step; ``cache["pos"]`` is a scalar or (B,) per-slot
    positions. Returns (logits (B, V), cache), the cache written in place
    and its positions advanced by one."""
    if token.ndim == 1:
        token = token[:, None]
    x = _dec_embed(params, cfg, token, cache["pos"])
    x = _dec_stack(params, cfg, x, "decode", cache, window=window)
    return _logits(params, x, cfg)[:, 0], {**cache, "pos": cache["pos"] + 1}
