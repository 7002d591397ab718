"""Single-device layers of the dense decoder and of the other families'
shared slots, ported from ``repro.models.layers``: RMS and layer norm,
RoPE and the encoder-decoder's sinusoidal embeddings, GQA attention for
prefill and decode (with QKV bias and QK-norm as the config asks) and its
cross-attention, KV-cache writes, the SwiGLU and GeLU MLPs and the
initialisers.

Parameters are plain dicts of tensors with the JAX package's names and
layouts: activations (B, S, H, hd), caches (B, Sc, K, hd). Attention math
is fp32 whatever the activation dtype. Unlike the JAX functions, the cache
writes (``cache_update_decode``, ``cache_fill_prefill`` and the attention
blocks that call them) update the cache tensors in place and return them.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.kernels.flash_attention.ops import flash_attention

# gqa_attention and decode_attention run the hand-written kernels on CUDA
# tensors and their plain versions on CPU tensors (the JAX layers' contract).
gqa_attention = flash_attention


def checkpointed(fn, *args):
    """``fn(*args)`` with its activations recomputed in the backward
    rather than kept, as the JAX package's ``jax.checkpoint`` of a layer
    group's body (``remat``)."""
    return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False)


# ---------------------------------------------------------------------------
# initializers
# ---------------------------------------------------------------------------

def dense_std(shape, scale: Optional[float] = None) -> float:
    """Std of the JAX package's ``dense_init``: 1/sqrt(fan_in) unless a
    scale is given."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    return scale if scale is not None else 1.0 / math.sqrt(fan_in)


EMBED_STD = 0.02


# ---------------------------------------------------------------------------
# norms and rotary embeddings
# ---------------------------------------------------------------------------

def rms_norm(x, w, eps: float = 1e-5):
    dtype = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps) * w.float()).to(dtype)


def layer_norm(x, w, b, eps: float = 1e-5):
    dtype = x.dtype
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * w.float() + b.float()).to(dtype)


def apply_norm(x, p, kind: str, eps: float):
    """``cfg.norm``'s norm: "layernorm" (weight and bias) or RMS norm."""
    if kind == "layernorm":
        return layer_norm(x, p["w"], p["b"], eps)
    return rms_norm(x, p["w"], eps)


def init_norm(d: int, kind: str) -> dict:
    """Layout and init of a norm's parameters, as
    ``repro.models.layers.init_norm``: name -> (shape, init)."""
    if kind == "layernorm":
        return {"w": ((d,), "ones"), "b": ((d,), "zeros")}
    return {"w": ((d,), "ones")}


def rope_freqs(head_dim: int, theta: float, device=None):
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x, positions, theta: float):
    """x: (..., S, H, hd); positions: broadcastable to (..., S). Split-halves
    convention (the first and second halves of hd are the pair)."""
    if theta <= 0:
        return x
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                 # (hd/2,)
    angles = positions.float()[..., None] * freqs           # (..., S, hd/2)
    angles = angles[..., None, :]                           # (..., S, 1, hd/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoidal_pos(positions, d_model: int, dtype):
    """Whisper's sinusoidal embeddings of ``positions`` (...,): (..., d_model),
    the sines of the first half then the cosines, at frequencies
    10000^(-i / (half - 1))."""
    half = d_model // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=positions.device) / (half - 1))
    ang = positions.float()[..., None] * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(dtype)


# ---------------------------------------------------------------------------
# KV-cache writes (in place)
# ---------------------------------------------------------------------------

def cache_update_decode(cache, new, pos, *, window: Optional[int] = None):
    """Write one token's k or v (B, 1, K, hd) into ``cache`` (B, Sc, K, hd)
    at ``pos``, in place. A scalar pos is clamped into the cache, as
    ``jax.lax.dynamic_update_slice`` clamps; a (B,) pos drops the writes of
    slots whose position lies past the cache, as JAX's ``.at[].set`` drops
    out-of-bounds updates (an idle decode slot's position keeps growing)."""
    Sc = cache.shape[1]
    posv = torch.as_tensor(pos, device=cache.device)
    slot = posv if window is None else torch.remainder(posv, Sc)
    if posv.ndim == 0:
        idx = slot.clamp(0, Sc - 1).reshape(1).long()
        cache.index_copy_(1, idx, new.to(cache.dtype))
        return cache
    rows = torch.arange(cache.shape[0], device=cache.device)
    inside = (slot >= 0) & (slot < Sc)
    idx = slot.clamp(0, Sc - 1).long()
    cache[rows, idx] = torch.where(inside[:, None, None],
                                   new[:, 0].to(cache.dtype), cache[rows, idx])
    return cache


def cache_fill_prefill(cache, k, *, window: Optional[int] = None):
    """Write a prompt's keys or values (B, S, K, hd) into a fresh cache, in
    place. A rotating cache keeps the last Sc tokens, the token at absolute
    position p in slot p mod Sc."""
    S, Sc = k.shape[1], cache.shape[1]
    if window is None or S <= Sc:
        if S > Sc:
            k = k[:, -Sc:]
            S = Sc
        cache[:, :S] = k.to(cache.dtype)
        return cache
    pos0 = S - Sc
    slots = torch.remainder(pos0 + torch.arange(Sc, device=cache.device), Sc)
    cache[:, slots] = k[:, -Sc:].to(cache.dtype)
    return cache


# ---------------------------------------------------------------------------
# attention block
# ---------------------------------------------------------------------------

def init_attention(cfg, cross: bool = False) -> dict:
    """Layout and init of one attention block's parameters, as
    ``repro.models.layers.init_attention`` draws them: name -> (shape,
    init), init a normal std or "zeros". Cross-attention has no QKV bias,
    whatever the config says."""
    D, qd, kvd = cfg.d_model, cfg.q_dim, cfg.kv_dim
    spec = {
        "wq": ((D, qd), dense_std((D, qd))),
        "wk": ((D, kvd), dense_std((D, kvd))),
        "wv": ((D, kvd), dense_std((D, kvd))),
        "wo": ((qd, D), dense_std((qd, D), 1.0 / math.sqrt(qd))),
    }
    if cfg.qkv_bias and not cross:
        spec.update(bq=((qd,), "zeros"), bk=((kvd,), "zeros"),
                    bv=((kvd,), "zeros"))
    if cfg.qk_norm:
        spec.update(q_norm=((cfg.head_dim,), "ones"),
                    k_norm=((cfg.head_dim,), "ones"))
    return spec


def _project_qkv(p, x, cfg, positions):
    B, S = x.shape[0], x.shape[1]
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(B, S, cfg.n_heads, cfg.head_dim)
    k = k.reshape(B, S, cfg.n_kv_heads, cfg.head_dim)
    v = v.reshape(B, S, cfg.n_kv_heads, cfg.head_dim)
    if "q_norm" in p:               # QK-norm over head_dim, before RoPE
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    if cfg.rope_theta > 0:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def attn_forward(p, x, cfg, *, window=None, causal=True):
    """Full-sequence attention (train / prefill without cache)."""
    B, S = x.shape[0], x.shape[1]
    positions = torch.arange(S, device=x.device)[None, :]
    q, k, v = _project_qkv(p, x, cfg, positions)
    out = gqa_attention(q, k, v, causal=causal, window=window)
    return out.reshape(B, S, cfg.q_dim) @ p["wo"]


def attn_prefill(p, x, cfg, k_cache, v_cache, *, window=None):
    """Prefill: full attention, and fill the caches in place. Returns
    (out, k_cache, v_cache)."""
    B, S = x.shape[0], x.shape[1]
    positions = torch.arange(S, device=x.device)[None, :]
    q, k, v = _project_qkv(p, x, cfg, positions)
    out = gqa_attention(q, k, v, causal=True, window=window)
    cache_fill_prefill(k_cache, k, window=window)
    cache_fill_prefill(v_cache, v, window=window)
    return out.reshape(B, S, cfg.q_dim) @ p["wo"], k_cache, v_cache


def attn_decode(p, x, cfg, k_cache, v_cache, pos, *, window=None):
    """Decode one token. x: (B, 1, D); pos scalar or (B,). Writes the
    token's k and v into the caches in place. Returns (out, k_cache,
    v_cache)."""
    B = x.shape[0]
    posv = torch.as_tensor(pos, device=x.device)
    positions = posv.expand(B)[:, None]
    q, k, v = _project_qkv(p, x, cfg, positions)
    cache_update_decode(k_cache, k, posv, window=window)
    cache_update_decode(v_cache, v, posv, window=window)
    out = decode_attention(q, k_cache, v_cache, posv, window=window)
    return out.reshape(B, 1, cfg.q_dim) @ p["wo"], k_cache, v_cache


def cross_attn_cache(p, enc_out, cfg):
    """The encoder output's cross-attention K and V (B, S, K, hd), projected
    once at prefill: no bias and no RoPE."""
    B, S = enc_out.shape[0], enc_out.shape[1]
    k = (enc_out @ p["wk"]).reshape(B, S, cfg.n_kv_heads, cfg.head_dim)
    v = (enc_out @ p["wv"]).reshape(B, S, cfg.n_kv_heads, cfg.head_dim)
    return k, v


def cross_attn_apply(p, x, cfg, k, v):
    """Non-causal attention of x (B, S, D) over the encoder's K and V."""
    B, S = x.shape[0], x.shape[1]
    q = (x @ p["wq"]).reshape(B, S, cfg.n_heads, cfg.head_dim)
    out = gqa_attention(q, k, v, causal=False)
    return out.reshape(B, S, cfg.q_dim) @ p["wo"]


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def init_mlp(cfg, d_ff: Optional[int] = None) -> dict:
    """Layout and init of the FFN's parameters, as
    ``repro.models.layers.init_mlp``: name -> (shape, normal std), of width
    ``d_ff or cfg.d_ff``; the SwiGLU FFN has a gate ``wg``, the GeLU one
    not."""
    D, Fd = cfg.d_model, d_ff or cfg.d_ff
    spec = {"wi": ((D, Fd), dense_std((D, Fd)))}
    if cfg.mlp == "swiglu":
        spec["wg"] = ((D, Fd), dense_std((D, Fd)))
    spec["wo"] = ((Fd, D), dense_std((Fd, D), 1.0 / math.sqrt(Fd)))
    return spec


def mlp_forward(p, x, cfg):
    """SwiGLU FFN, or GeLU where there is no gate (the tanh form, which
    ``jax.nn.gelu`` computes by default)."""
    if "wg" in p:
        h = F.silu(x @ p["wg"]) * (x @ p["wi"])
    else:
        h = F.gelu(x @ p["wi"], approximate="tanh")
    return h @ p["wo"]
