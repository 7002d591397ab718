"""xLSTM family, ported from ``repro.models.xlstm``: mLSTM (matrix memory,
chunkwise-parallel) and sLSTM (scalar memory, sequential) blocks.
[arXiv:2405.04517]

Every ``slstm_every``-th layer is an sLSTM, the others mLSTM (7:1 in
xLSTM-350M). Parameters and cache keep the JAX package's pytree: the layers
at each position of the period are stacked along a leading dim G under
``slots[i]`` (the JAX package scans over them); a written-out loop walks
them. The cache is ``{"slots": (state, ...), "pos"}``, all fp32 whatever
the model dtype: an mLSTM state (C (G, B, nh, hd, hd), n (G, B, nh, hd),
m (G, B, nh)), an sLSTM state (c, n, m, h), each (G, B, D); ``m`` starts at
-1e30. ``prefill`` and ``decode_step`` write every leaf in place and return
the cache.

The mLSTM head dim is ``2 * d_model / n_heads`` (512 at full width), not
``cfg.head_dim``. Train and prefill run its chunk scan through
``kernels.mlstm_chunk`` (the CUDA kernel on the card, the plain chunkwise
version on the CPU); decode is the exact one-step recurrence. The sLSTM has
no kernel: prefill walks its steps in a Python loop, where JAX uses
``lax.scan``.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.mlstm_chunk.ops import mlstm_chunk
from repro_torch.kernels.mlstm_chunk.ref import NEG
from repro_torch.models import layers as L
from repro_torch.models.params import IF_BIAS, layer_of, prefixed


def _slot_kinds(cfg):
    period = cfg.slstm_every or cfg.n_layers
    return cfg.layer_kinds()[:period]


def _n_groups(cfg):
    period = cfg.slstm_every or cfg.n_layers
    if cfg.n_layers % period:
        raise ValueError(f"{cfg.name}: {cfg.n_layers} layers are not whole "
                         f"groups of {period}")
    return cfg.n_layers // period


# ---------------------------------------------------------------------------
# parameters and cache
# ---------------------------------------------------------------------------

def _mlstm_specs(cfg) -> Dict[str, tuple]:
    D, nh = cfg.d_model, cfg.n_heads
    inner = 2 * D
    return {
        **prefixed("ln", L.init_norm(D, cfg.norm)),
        "w_up": ((D, inner), L.dense_std((D, inner))),
        "w_gate": ((D, inner), L.dense_std((D, inner))),
        "wq": ((inner, inner), L.dense_std((inner, inner))),
        "wk": ((inner, inner), L.dense_std((inner, inner))),
        "wv": ((inner, inner), L.dense_std((inner, inner))),
        "w_if": ((inner, 2 * nh), L.dense_std((inner, 2 * nh), 0.02)),
        "b_if": ((2 * nh,), IF_BIAS),
        "w_down": ((inner, D), L.dense_std((inner, D), 1 / math.sqrt(inner))),
    }


def _slstm_specs(cfg) -> Dict[str, tuple]:
    D, nh = cfg.d_model, cfg.n_heads
    hd = D // nh
    return {
        **prefixed("ln", L.init_norm(D, cfg.norm)),
        "w_in": ((D, 4 * D), L.dense_std((D, 4 * D))),
        "b_in": ((4 * D,), "zeros"),
        "r": ((nh, hd, 4 * hd), L.dense_std((nh, hd, 4 * hd))),
        "w_out": ((D, D), L.dense_std((D, D))),
    }


def param_specs(cfg) -> Dict[str, tuple]:
    """Flat parameter layout, keyed by the JAX pytree's paths
    (``slots/0/wq``, ``slots/7/r``): name -> (shape, init), see
    ``models.params``."""
    G, D, V = _n_groups(cfg), cfg.d_model, cfg.vocab_size
    specs = {
        "embed": ((V, D), L.EMBED_STD),
        "unembed": ((D, V), L.dense_std((D, V))),
        **prefixed("final_norm", L.init_norm(D, cfg.norm)),
    }
    for i, kind in enumerate(_slot_kinds(cfg)):
        slot = _mlstm_specs(cfg) if kind == "mlstm" else _slstm_specs(cfg)
        for name, (shape, init) in slot.items():
            specs[f"slots/{i}/{name}"] = ((G, *shape), init)
    return specs


def _state(cfg, kind, batch, device, lead=()):
    def z(*shape):
        return torch.zeros((*lead, batch, *shape), dtype=torch.float32,
                           device=device)

    def neg(*shape):
        return torch.full((*lead, batch, *shape), NEG, dtype=torch.float32,
                          device=device)
    if kind == "mlstm":
        nh = cfg.n_heads
        hd = 2 * cfg.d_model // nh
        return (z(nh, hd, hd), z(nh, hd), neg(nh))
    D = cfg.d_model
    return (z(D), z(D), neg(D), z(D))


def init_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16,
               window: Optional[int] = None, device=None) -> dict:
    """The recurrent state of every layer, fp32 whatever ``dtype``; its size
    does not depend on ``max_len``."""
    G = _n_groups(cfg)
    return {"slots": tuple(_state(cfg, kind, batch, device, (G,))
                           for kind in _slot_kinds(cfg)),
            "pos": torch.zeros((), dtype=torch.int32, device=device)}


# ---------------------------------------------------------------------------
# mLSTM block
# ---------------------------------------------------------------------------

def _mlstm_qkvif(p, x, cfg):
    """x: (B, S, D) -> q, k, v (B, S, nh, hd) fp32; log_i, log_f (B, S, nh)
    fp32, contiguous; the output gate in x's dtype."""
    B, S, _ = x.shape
    nh = cfg.n_heads
    up = x @ p["w_up"]
    hd = up.shape[-1] // nh
    q = (up @ p["wq"]).reshape(B, S, nh, hd).float()
    k = (up @ p["wk"]).reshape(B, S, nh, hd).float() / math.sqrt(hd)
    v = (up @ p["wv"]).reshape(B, S, nh, hd).float()
    gif = (up @ p["w_if"] + p["b_if"]).float()
    log_i = gif[..., :nh].contiguous()
    log_f = F.logsigmoid(gif[..., nh:])
    gate = F.silu(x @ p["w_gate"])
    return q, k, v, log_i, log_f, gate


def _mlstm_decode(q, k, v, log_i, log_f, state):
    """One mLSTM step, writing the state in place. q, k, v: (B, nh, hd);
    gates (B, nh). Returns h (B, nh, hd)."""
    C, n, m = state
    m_new = torch.maximum(log_f + m, log_i)
    f_s = torch.exp(log_f + m - m_new)
    i_s = torch.exp(log_i - m_new)
    C.mul_(f_s[..., None, None]).add_(
        i_s[..., None, None] * (k[..., :, None] * v[..., None, :]))
    n.mul_(f_s[..., None]).add_(i_s[..., None] * k)
    m.copy_(m_new)
    num = torch.einsum("bhd,bhde->bhe", q, C)
    denom = torch.maximum(torch.abs(torch.einsum("bhd,bhd->bh", q, n)),
                          torch.exp(-m_new))
    return num / denom[..., None]


def _mlstm_block(p, x, cfg, state, mode):
    B, S, _ = x.shape
    h_in = L.apply_norm(x, p["ln"], cfg.norm, cfg.norm_eps)
    q, k, v, log_i, log_f, gate = _mlstm_qkvif(p, h_in, cfg)
    if mode == "decode":
        h = _mlstm_decode(q[:, 0], k[:, 0], v[:, 0], log_i[:, 0],
                          log_f[:, 0], state)[:, None]
    else:
        h, new = mlstm_chunk(q, k, v, log_i, log_f, state)
        for leaf, t in zip(state, new):
            leaf.copy_(t)
    h = h.reshape(B, S, -1).to(x.dtype)
    return x + (h * gate) @ p["w_down"]


# ---------------------------------------------------------------------------
# sLSTM block
# ---------------------------------------------------------------------------

def _slstm_step(r, cfg, pre_x, state):
    """One sLSTM step. r: the recurrent weights (nh, hd, 4 hd) in fp32 (JAX
    promotes the fp32 state's product with them to fp32); pre_x: (B, 4D)
    input preactivation. Returns the new (c, n, m, h), each (B, D) fp32."""
    c, n, m, h = state
    B, D4 = pre_x.shape
    D, nh = D4 // 4, cfg.n_heads
    hd = D // nh
    rec = torch.einsum("bnh,nhk->bnk", h.reshape(B, nh, hd), r)
    # per-head (z, i, f, o) blocks -> the global (z, i, f, o) layout of w_in
    rec = rec.reshape(B, nh, 4, hd).transpose(1, 2).reshape(B, D4)
    z, i_raw, f_raw, o_raw = (pre_x.float() + rec).chunk(4, dim=-1)
    log_f = F.logsigmoid(f_raw)
    m_new = torch.maximum(log_f + m, i_raw)
    i_s = torch.exp(i_raw - m_new)
    f_s = torch.exp(log_f + m - m_new)
    c_new = f_s * c + i_s * torch.tanh(z)
    n_new = f_s * n + i_s
    h_new = torch.sigmoid(o_raw) * c_new / torch.clamp(n_new, min=1.0)
    return c_new, n_new, m_new, h_new


def _slstm_block(p, x, cfg, state, mode):
    h_in = L.apply_norm(x, p["ln"], cfg.norm, cfg.norm_eps)
    pre = h_in @ p["w_in"] + p["b_in"]
    r = p["r"].float()
    st = state
    hs = []
    # a span for launch/profile_serve.py: the loop's share of a prefill
    with torch.profiler.record_function("xlstm.slstm_steps"):
        for t in range(x.shape[1]):
            st = _slstm_step(r, cfg, pre[:, t], st)
            hs.append(st[3])
    for leaf, t in zip(state, st):
        leaf.copy_(t)
    out = torch.stack(hs, dim=1).to(x.dtype) @ p["w_out"]
    return x + out


# ---------------------------------------------------------------------------
# stack
# ---------------------------------------------------------------------------

def _run_stack(params, x, cfg, mode: str, cache):
    kinds = _slot_kinds(cfg)
    for g in range(_n_groups(cfg)):
        for i, kind in enumerate(kinds):
            blk = _mlstm_block if kind == "mlstm" else _slstm_block
            x = blk(layer_of(params["slots"][i], g), x, cfg,
                    layer_of(cache["slots"][i], g), mode)
    return x


def _logits(params, x, cfg):
    x = L.apply_norm(x, params["final_norm"], cfg.norm, cfg.norm_eps)
    return x @ params["unembed"]


def forward_train(params, cfg, batch, *, window=None):
    """Full-sequence forward from a zero state. Returns (logits (B, S, V),
    aux loss 0)."""
    x = params["embed"][batch["tokens"]]
    cache = init_cache(cfg, x.shape[0], 0, device=x.device)
    x = _run_stack(params, x, cfg, "prefill", cache)
    return _logits(params, x, cfg), torch.zeros((), device=x.device)


def prefill(params, cfg, batch, cache, *, window=None):
    """Process the prompt from the state in ``cache`` and write the state
    after it in place. Returns (last-token logits, cache)."""
    tokens = batch["tokens"]
    x = params["embed"][tokens]
    x = _run_stack(params, x, cfg, "prefill", cache)
    last = _logits(params, x[:, -1:, :], cfg)[:, 0]
    pos = torch.tensor(tokens.shape[1], dtype=torch.int32, device=x.device)
    return last, {"slots": cache["slots"], "pos": pos}


def decode_step(params, cfg, token, cache, *, window=None):
    """One decode step; ``cache["pos"]`` is a scalar or (B,) per-slot
    positions, which the recurrence does not read. Returns (logits (B, V),
    cache), the state written in place and the positions advanced by one."""
    if token.ndim == 1:
        token = token[:, None]
    x = params["embed"][token]
    x = _run_stack(params, x, cfg, "decode", cache)
    return _logits(params, x, cfg)[:, 0], {"slots": cache["slots"],
                                           "pos": cache["pos"] + 1}
