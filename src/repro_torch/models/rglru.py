"""Griffin-style hybrid family (RecurrentGemma), ported from
``repro.models.rglru``: RG-LRU recurrent blocks + local (sliding-window)
attention, pattern ("rec", "rec", "attn"). [arXiv:2402.19427]

Parameters and cache keep the JAX package's pytree. The layers at each
position of the pattern are stacked along a leading dim G under
``slots[i]`` (the JAX package scans over them); the leftover layers
(26 mod 3 = 2) are unstacked under ``rest``. A written-out loop walks both.
The cache is ``{"slots": (rec, rec, {"k", "v"}), "rest": (...), "pos"}``,
a rec state being (conv tail (..., B, cw-1, W) in the cache dtype,
h (..., B, W) fp32). ``prefill`` and ``decode_step`` write every leaf in
place and return the cache.

Train and prefill run the recurrence through ``kernels.rglru_scan`` (the
CUDA scan on the card, the plain sequential version on the CPU) where the
JAX package uses ``jax.lax.associative_scan``; decode is the exact one-step
recurrence. Attention runs with ``window=cfg.window`` in every mode.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.rglru_scan.ops import rglru_scan
from repro_torch.models import layers as L
from repro_torch.models.params import LRU_LAMBDA, layer_of, prefixed

_N_BLOCKS = 8   # block-diagonal gate projections (Griffin Appendix A)
_LRU_C = 8.0


def _plan(cfg):
    pat = cfg.attn_pattern or ("rec", "rec", "attn")
    G = cfg.n_layers // len(pat)
    rest = tuple(pat[: cfg.n_layers - G * len(pat)])
    return G, pat, rest


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def _rec_specs(cfg) -> Dict[str, tuple]:
    """One RG-LRU block's parameters, as ``_init_rec`` draws them."""
    D, W, cw = cfg.d_model, cfg.lru_width or cfg.d_model, cfg.conv_width
    gates = (_N_BLOCKS, W // _N_BLOCKS, W // _N_BLOCKS)
    return {
        **prefixed("ln", L.init_norm(D, cfg.norm)),
        "w_gate": ((D, W), L.dense_std((D, W))),
        "w_in": ((D, W), L.dense_std((D, W))),
        "conv_w": ((cw, W), L.dense_std((cw, W), 0.1)),
        "conv_b": ((W,), "zeros"),
        "w_r": (gates, L.dense_std(gates)),
        "w_i": (gates, L.dense_std(gates)),
        "b_r": ((W,), "zeros"),
        "b_i": ((W,), "zeros"),
        "lam": ((W,), LRU_LAMBDA),
        "w_out": ((W, D), L.dense_std((W, D))),
    }


def _slot_specs(cfg, kind: str) -> Dict[str, tuple]:
    norm = L.init_norm(cfg.d_model, cfg.norm)
    if kind == "rec":
        blocks = {"rec": _rec_specs(cfg)}
    else:
        blocks = {"ln1": norm, "attn": L.init_attention(cfg)}
    blocks["ln2"] = norm
    blocks["ffn"] = L.init_mlp(cfg)
    return {f"{block}/{k}": v for block, spec in blocks.items()
            for k, v in spec.items()}


def param_specs(cfg) -> Dict[str, tuple]:
    """Flat parameter layout, keyed by the JAX pytree's paths
    (``slots/0/rec/w_r``, ``rest/1/rec/lam``, ``slots/2/attn/wq``):
    name -> (shape, init), see ``models.params``."""
    G, pat, rest = _plan(cfg)
    D, V = cfg.d_model, cfg.vocab_size
    specs = {
        "embed": ((V, D), L.EMBED_STD),
        "unembed": ((D, V), L.dense_std((D, V))),
        **prefixed("final_norm", L.init_norm(D, cfg.norm)),
    }
    for i, kind in enumerate(pat):
        for name, (shape, init) in _slot_specs(cfg, kind).items():
            specs[f"slots/{i}/{name}"] = ((G, *shape), init)
    for j, kind in enumerate(rest):
        for name, spec in _slot_specs(cfg, kind).items():
            specs[f"rest/{j}/{name}"] = spec
    return specs


# ---------------------------------------------------------------------------
# cache
# ---------------------------------------------------------------------------

def _slot_cache(cfg, kind, batch, max_len, dtype, window, device, lead=()):
    if kind == "rec":   # the conv tail in the cache dtype, h in fp32
        W = cfg.lru_width or cfg.d_model
        return (torch.zeros((*lead, batch, cfg.conv_width - 1, W),
                            dtype=dtype, device=device),
                torch.zeros((*lead, batch, W), dtype=torch.float32,
                            device=device))
    Sc = min(max_len, window or cfg.window or max_len)

    def z():
        return torch.zeros((*lead, batch, Sc, cfg.n_kv_heads, cfg.head_dim),
                           dtype=dtype, device=device)
    return {"k": z(), "v": z()}


def init_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16,
               window: Optional[int] = None, device=None) -> dict:
    G, pat, rest = _plan(cfg)
    return {
        "slots": tuple(_slot_cache(cfg, k, batch, max_len, dtype, window,
                                   device, (G,)) for k in pat),
        "rest": tuple(_slot_cache(cfg, k, batch, max_len, dtype, window,
                                  device) for k in rest),
        "pos": torch.zeros((), dtype=torch.int32, device=device),
    }


# ---------------------------------------------------------------------------
# RG-LRU recurrent block
# ---------------------------------------------------------------------------

def _block_diag(u, w):
    """u: (..., W) @ block-diagonal w: (nb, W/nb, W/nb) -> (..., W)."""
    nb, bs, _ = w.shape
    ub = u.reshape(*u.shape[:-1], nb, bs)
    return torch.einsum("...nb,nbk->...nk", ub, w).reshape(u.shape)


def _lru_gates(p, u):
    """Return (log_a, x_scaled), both (..., W) fp32."""
    uf = u.float()
    r = torch.sigmoid(_block_diag(uf, p["w_r"].float()) + p["b_r"].float())
    i = torch.sigmoid(_block_diag(uf, p["w_i"].float()) + p["b_i"].float())
    log_a = -_LRU_C * F.softplus(p["lam"]) * r            # (..., W) < 0
    a_sq = torch.exp(2.0 * log_a)
    x = torch.sqrt(torch.clamp(1.0 - a_sq, min=1e-12)) * (i * uf)
    return log_a, x


def _causal_conv(u, w, b, tail):
    """Depthwise causal conv, the explicit shifted sum of the reference (a
    float32 ``F.conv1d`` on the card would run in TF32). u: (B, S, W);
    w: (cw, W); tail: (B, cw-1, W). Returns (out, new tail)."""
    cw, S = w.shape[0], u.shape[1]
    full = torch.cat([tail, u], dim=1)
    out = full[:, :S] * w[0]
    for j in range(1, cw):
        out = out + full[:, j:j + S] * w[j]
    new_tail = full[:, S:] if cw > 1 else tail
    return out + b, new_tail


def _rec_block(p, x, cfg, state, mode):
    h_in = L.apply_norm(x, p["ln"], cfg.norm, cfg.norm_eps)
    gate = F.gelu(h_in @ p["w_gate"], approximate="tanh")   # jax.nn.gelu
    u = h_in @ p["w_in"]
    conv_tail, h_lru = state
    u, conv_tail = _causal_conv(u, p["conv_w"], p["conv_b"], conv_tail)
    log_a, xs = _lru_gates(p, u)
    if mode == "decode":
        h_new = torch.exp(log_a[:, 0]) * h_lru + xs[:, 0]     # (B, W)
        y = h_new[:, None]
    else:
        y = rglru_scan(log_a, xs, h_lru)                      # (B, S, W)
        h_new = y[:, -1]
    out = (y.to(x.dtype) * gate) @ p["w_out"]
    return x + out, (conv_tail, h_new)


# ---------------------------------------------------------------------------
# slots and stack
# ---------------------------------------------------------------------------

def _attn_apply(p, x, cfg, cache, mode, pos):
    h = L.apply_norm(x, p["ln1"], cfg.norm, cfg.norm_eps)
    w = cfg.window
    if mode == "train":
        a = L.attn_forward(p["attn"], h, cfg, window=w)
    elif mode == "prefill":
        a, _, _ = L.attn_prefill(p["attn"], h, cfg, cache["k"], cache["v"],
                                 window=w)
    else:
        a, _, _ = L.attn_decode(p["attn"], h, cfg, cache["k"], cache["v"],
                                pos, window=w)
    x = x + a
    h = L.apply_norm(x, p["ln2"], cfg.norm, cfg.norm_eps)
    return x + L.mlp_forward(p["ffn"], h, cfg)


def _rec_apply(p, x, cfg, state, mode):
    """The rec slot; a given state is read and then overwritten in place,
    without one (train) it starts from zeros."""
    if state is None:
        state = _slot_cache(cfg, "rec", x.shape[0], 0, x.dtype, None,
                            x.device)
        x, _ = _rec_block(p["rec"], x, cfg, state, mode)
    else:
        x, (tail, h) = _rec_block(p["rec"], x, cfg, state, mode)
        state[0].copy_(tail)
        state[1].copy_(h)
    h = L.apply_norm(x, p["ln2"], cfg.norm, cfg.norm_eps)
    return x + L.mlp_forward(p["ffn"], h, cfg)


def _run_stack(params, x, cfg, mode: str, cache=None):
    G, pat, rest = _plan(cfg)
    pos = cache["pos"] if cache is not None else None

    def apply(kind, p, x, state):
        if kind == "rec":
            return _rec_apply(p, x, cfg, state, mode)
        return _attn_apply(p, x, cfg, state, mode, pos)

    for g in range(G):
        for i, kind in enumerate(pat):
            state = layer_of(cache["slots"][i], g) if cache is not None \
                else None
            x = apply(kind, layer_of(params["slots"][i], g), x, state)
    for j, kind in enumerate(rest):
        x = apply(kind, params["rest"][j], x,
                  cache["rest"][j] if cache is not None else None)
    return x


def _logits(params, x, cfg):
    x = L.apply_norm(x, params["final_norm"], cfg.norm, cfg.norm_eps)
    return x @ params["unembed"]


def forward_train(params, cfg, batch, *, window=None):
    """Full-sequence forward. Returns (logits (B, S, V), aux loss 0)."""
    x = params["embed"][batch["tokens"]]
    x = _run_stack(params, x, cfg, "train")
    return _logits(params, x, cfg), torch.zeros((), device=x.device)


def prefill(params, cfg, batch, cache, *, window=None):
    """Process the prompt and fill the cache in place. Returns (last-token
    logits, cache)."""
    tokens = batch["tokens"]
    x = params["embed"][tokens]
    x = _run_stack(params, x, cfg, "prefill", cache)
    last = _logits(params, x[:, -1:, :], cfg)[:, 0]
    pos = torch.tensor(tokens.shape[1], dtype=torch.int32, device=x.device)
    return last, {"slots": cache["slots"], "rest": cache["rest"], "pos": pos}


def decode_step(params, cfg, token, cache, *, window=None):
    """One decode step; ``cache["pos"]`` is a scalar or (B,) per-slot
    positions (attention layers only; the recurrence needs none). Returns
    (logits (B, V), cache), the cache written in place and its positions
    advanced by one."""
    if token.ndim == 1:
        token = token[:, None]
    x = params["embed"][token]
    x = _run_stack(params, x, cfg, "decode", cache)
    return _logits(params, x, cfg)[:, 0], {
        "slots": cache["slots"], "rest": cache["rest"],
        "pos": cache["pos"] + 1}
