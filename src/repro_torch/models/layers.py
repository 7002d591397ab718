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

Under sharding rules (``repro_torch.models.sharding``) the layers are the
JAX package's multi-device ones, sharded explicitly: each rank holds its
block of the parameters (``launch.shardspecs.local_params``) and of the
cache (``transformer.local_cache``) and all-reduces what it contracted over a sharded
dimension. ``heads`` over n ranks gives a rank n_heads / n query heads and
the KV heads they read (``head_plan``); ``d_ff`` cuts the FFN's width;
``kv_seq`` cuts the cache's rows (``dist_decode_attention``, flash-decoding
across ranks on B2's log-sum-exp); ``tp_bf16_ar`` all-reduces the
attention output's and the FFN's partial products in the activation dtype
(``tp_attn_out``, ``tp_mlp_forward``), where otherwise, as GSPMD does for
the JAX functions, the partial product is formed and all-reduced in fp32
and cast once.

The collectives differentiate (``models.sharding``), so the layers train
under the same rules: where a replicated activation enters a block whose
work is cut (the projections of the rank's heads, the FFN's d_ff columns),
``sharding.entry`` sums its gradient over the axis. The leaves a rank holds
whole but uses only in part are ``partial_leaves``.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models import sharding as SH

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


def cache_fill_rows(cache, k, off: int, n: int):
    """Fill the rows [off, off + Sc_l) of a prompt's keys or values (B, S,
    K, hd) that fall inside it into this rank's block ``cache`` (B, Sc_l,
    K, hd), in place: one of n blocks of a flat cache of n Sc_l rows (a
    prompt longer than that keeps its last n Sc_l tokens, as
    ``cache_fill_prefill`` does)."""
    rows = cache.shape[1]
    k = k[:, -n * rows:]
    lo, hi = min(off, k.shape[1]), min(off + rows, k.shape[1])
    cache[:, :hi - lo] = k[:, lo:hi].to(cache.dtype)
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


class HeadPlan(NamedTuple):
    """A rank's share of the attention heads under the ``heads`` rule.

    axis: the mesh axis the heads are cut over (None: every head here);
    h0, n_q: the rank's query heads [h0, h0 + n_q);
    kv: how its K and V columns come: "whole" (wk and wv whole, as
        ``sanitize_spec`` keeps a width the axis does not divide), "own"
        (its block of columns is exactly the KV heads its query heads read:
        K divides over the axis) or "gather" (the blocks cut KV heads, so
        the projections are gathered over the axis);
    kv_heads: the KV heads (global indices) the rank attends over and
        caches, in order: those of its query heads, head h reading h // G;
        one a query head where its query heads split them unevenly.
    """
    axis: Optional[str]
    h0: int
    n_q: int
    kv: str
    kv_heads: Tuple[int, ...]

    @property
    def n_kv(self) -> int:
        return len(self.kv_heads)


def head_plan(cfg) -> HeadPlan:
    """The rank's heads under the active rules (all of them outside a rules
    context, or where the ``heads`` axis does not divide n_heads)."""
    H, K = cfg.n_heads, cfg.n_kv_heads
    sh = SH.shard_of("heads")
    if sh.size == 1 or H % sh.size:
        if sh.size > 1 and cfg.q_dim % sh.size == 0:
            raise NotImplementedError(
                f"{H} heads over {sh.size} ranks: wq's block would cut a "
                "head")
        return HeadPlan(None, 0, H, "whole", tuple(range(K)))
    n_q = H // sh.size
    h0 = sh.rank * n_q
    G = H // K
    need = [h // G for h in range(h0, h0 + n_q)]
    lo, hi = need[0], need[-1] + 1
    even = n_q % (hi - lo) == 0 and all(
        need.count(j) == n_q // (hi - lo) for j in range(lo, hi))
    if cfg.kv_dim % sh.size:
        kv = "whole"
    elif K % sh.size == 0:
        kv = "own"
    else:
        kv = "gather"
    return HeadPlan(SH.rule("heads"), h0, n_q, kv,
                    tuple(range(lo, hi)) if even else tuple(need))


def _check_width(p, name: str, want: int) -> None:
    """Raise unless leaf ``name`` is as wide as the rules give this rank
    (the parameters were cut, or kept whole, under other rules)."""
    if p[name].shape[-1] != want:
        raise ValueError(f"{name} is {p[name].shape[-1]} wide where the "
                         f"rules give this rank {want}: cut the parameters "
                         "with launch.shardspecs.local_params under the "
                         "same rules")


def _rank_heads(p, q, k, v, cfg):
    """The projections (B, S, width) of this rank's leaves as the heads its
    plan gives it (``head_plan``): q (B, S, n_q, hd), k and v (B, S, n_kv,
    hd), gathered over the heads' axis or picked from the whole where the
    plan says so."""
    B, S = q.shape[0], q.shape[1]
    plan = head_plan(cfg)
    hd, K = cfg.head_dim, cfg.n_kv_heads
    if plan.axis is not None:
        n = cfg.n_heads // plan.n_q                 # ranks over the heads
        _check_width(p, "wq", plan.n_q * hd)
        _check_width(p, "wk", {"whole": K * hd, "own": plan.n_kv * hd,
                               "gather": cfg.kv_dim // n}[plan.kv])
    if plan.kv == "gather":
        k = SH.all_gather(k, plan.axis, -1)
        v = SH.all_gather(v, plan.axis, -1)
    q = q.reshape(B, S, plan.n_q, hd)
    k = k.reshape(B, S, -1, hd)
    v = v.reshape(B, S, -1, hd)
    if plan.kv != "own" and plan.kv_heads != tuple(range(K)):
        idx = torch.tensor(plan.kv_heads, device=q.device)
        k, v = k.index_select(2, idx), v.index_select(2, idx)
    return q, k, v


def partial_leaves(cfg) -> Tuple[str, ...]:
    """The attention leaves that a rank holds whole but uses only in part
    under the active rules: with the heads cut over an axis, the QK-norm's
    weights (applied to the rank's heads only) and, in the ``"whole"`` KV
    plan, wk, wv, bk and bv (the rank reads the KV heads of its own query
    heads). A rank's gradient of such a leaf is its heads' share; the
    whole gradient is the SUM over the heads' axis. Every other leaf is
    either the rank's block or used whole, and its gradient complete."""
    plan = head_plan(cfg)
    if plan.axis is None:
        return ()
    names = ("q_norm", "k_norm")
    if plan.kv == "whole":
        names += ("wk", "wv", "bk", "bv")
    return names


def _project_qkv(p, x, cfg, positions):
    B, S = x.shape[0], x.shape[1]
    if SH.active():       # the heads' work is cut: the gradient of x sums
        x = SH.entry(x, head_plan(cfg).axis)
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    if SH.active():
        q, k, v = _rank_heads(p, q, k, v, cfg)
    else:
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


def _attn_out(out, wo, cfg, tp: bool):
    """out (B, S, heads, hd) @ wo. With the heads sharded: ``tp_attn_out``
    where ``tp`` and the ``tp_bf16_ar`` rule allow it, else the fp32 partial
    product all-reduced in fp32 and cast once (GSPMD's contraction of the
    JAX functions)."""
    B, S = out.shape[0], out.shape[1]
    if not SH.active() or head_plan(cfg).axis is None:
        return out.reshape(B, S, -1) @ wo
    if tp and _tp_axis_ok(cfg.n_heads, "heads"):
        return tp_attn_out(out, wo, cfg)
    y = out.reshape(B, S, -1).float() @ wo.float()
    return SH.all_reduce(y, SH.rule("heads")).to(out.dtype)


def _kv_seq() -> SH.Shard:
    """The ``kv_seq`` shard; raises where it shares a sharded axis with the
    heads (each rank would hold other heads over other rows)."""
    seq = SH.shard_of("kv_seq")
    if seq.size > 1 and SH.rule("kv_seq") == SH.rule("heads"):
        raise NotImplementedError("kv_seq and heads on one mesh axis: give "
                                  "the heads rule None or another axis")
    return seq


def attn_forward(p, x, cfg, *, window=None, causal=True):
    """Full-sequence attention (train / prefill without cache)."""
    S = x.shape[1]
    positions = torch.arange(S, device=x.device)[None, :]
    q, k, v = _project_qkv(p, x, cfg, positions)
    out = gqa_attention(q, k, v, causal=causal, window=window)
    return _attn_out(out, p["wo"], cfg, tp=True)


def attn_prefill(p, x, cfg, k_cache, v_cache, *, window=None):
    """Prefill: full attention, and fill the caches in place (under
    ``kv_seq`` only this rank's rows). Returns (out, k_cache, v_cache)."""
    S = x.shape[1]
    positions = torch.arange(S, device=x.device)[None, :]
    q, k, v = _project_qkv(p, x, cfg, positions)
    out = gqa_attention(q, k, v, causal=True, window=window)
    seq = _kv_seq()
    if seq.size > 1:
        if window is not None:
            raise NotImplementedError("a window cache sharded over kv_seq "
                                      "comes with ROADMAP A12")
        cache_fill_rows(k_cache, k, seq.rank * k_cache.shape[1], seq.size)
        cache_fill_rows(v_cache, v, seq.rank * v_cache.shape[1], seq.size)
    else:
        cache_fill_prefill(k_cache, k, window=window)
        cache_fill_prefill(v_cache, v, window=window)
    return _attn_out(out, p["wo"], cfg, tp=False), k_cache, v_cache


def attn_decode(p, x, cfg, k_cache, v_cache, pos, *, window=None):
    """Decode one token. x: (B, 1, D); pos scalar or (B,). Writes the
    token's k and v into the caches in place. Returns (out, k_cache,
    v_cache). Under the ``kv_seq`` rule, with no window and a scalar pos,
    the cache's rows are sharded: ``dist_decode_attention``."""
    B = x.shape[0]
    posv = torch.as_tensor(pos, device=x.device)
    positions = posv.expand(B)[:, None]
    q, k, v = _project_qkv(p, x, cfg, positions)
    seq = _kv_seq()
    if SH.rule("kv_seq") is not None and window is None and posv.ndim == 0:
        out, _, _ = dist_decode_attention(q, k_cache, v_cache, k, v, posv)
    elif seq.size > 1:
        raise NotImplementedError("a window or per-slot positions over a "
                                  "kv_seq-sharded cache come with ROADMAP "
                                  "A12")
    else:
        cache_update_decode(k_cache, k, posv, window=window)
        cache_update_decode(v_cache, v, posv, window=window)
        out = decode_attention(q, k_cache, v_cache, posv, window=window)
    return _attn_out(out, p["wo"], cfg, tp=False), k_cache, v_cache


def dist_decode_attention(q, k_cache, v_cache, k_new, v_new, pos):
    """Decode attention with the cache's rows sharded over the ``kv_seq``
    mesh axis (flash-decoding across ranks): rank r holds rows [r Sc_l,
    (r + 1) Sc_l) of each slot, Sc_l = ``k_cache.shape[1]``. The rank that
    owns ``pos`` writes the new token's k and v there (in place; the
    others leave their rows as they are), each rank runs B2 over its own
    rows at the local position pos - r Sc_l (B2 admits rows [0, min(pos -
    r Sc_l + 1, Sc_l)): all of them on a rank before pos, none past it)
    and returns its output with its log-sum-exp, and the ranks combine in
    fp32: m = max of the lse, w = exp(lse - m), the output sum(w out) /
    sum(w), cast once to q's dtype. Bytes on the wire O(B Hq hd), not O(KV).

    q, k_new, v_new: (B, 1, Hq|K, hd), the same on every rank of the axis;
    caches (B, Sc_l, K, hd); pos: a scalar. Returns (out (B, 1, Hq, hd),
    k_cache, v_cache)."""
    axis = SH.rule("kv_seq")
    seq = SH.shard_of("kv_seq")
    rows = k_cache.shape[1]
    slot = torch.as_tensor(pos, device=q.device) - seq.rank * rows
    own = (slot >= 0) & (slot < rows)
    idx = slot.clamp(0, rows - 1).reshape(1).long()
    for cache, new in ((k_cache, k_new), (v_cache, v_new)):
        kept = cache.index_select(1, idx)
        cache.index_copy_(1, idx, torch.where(own, new.to(cache.dtype), kept))
    out, lse = decode_attention(q, k_cache, v_cache, slot, return_lse=True)
    m = SH.all_reduce(lse.clone(), axis, "max")
    w = torch.exp(lse - m)                                  # (B, Hq)
    o = SH.all_reduce(out.float() * w[:, None, :, None], axis)
    denom = SH.all_reduce(w, axis)
    return (o / denom[:, None, :, None]).to(q.dtype), k_cache, v_cache


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


def _ffn_width(cfg) -> int:
    return cfg.d_ff_dense or cfg.d_ff


def mlp_forward(p, x, cfg):
    """SwiGLU FFN, or GeLU where there is no gate (the tanh form, which
    ``jax.nn.gelu`` computes by default). With ``d_ff`` sharded:
    ``tp_mlp_forward`` under ``tp_bf16_ar``, else the fp32 partial product
    all-reduced in fp32 and cast once."""
    if not SH.active():
        return _ffn_hidden(p, x) @ p["wo"]
    width = _ffn_width(cfg)
    sh = SH.shard_of("d_ff")
    sharded = sh.size > 1 and width % sh.size == 0
    _check_width(p, "wi", width // sh.size if sharded else width)
    if sharded:           # d_ff's work is cut: the gradient of x sums
        x = SH.entry(x, SH.rule("d_ff"))
    if _tp_axis_ok(width):
        return tp_mlp_forward(p, x, cfg)
    h = _ffn_hidden(p, x)
    if not sharded:
        return h @ p["wo"]
    y = h.float() @ p["wo"].float()
    return SH.all_reduce(y, SH.rule("d_ff")).to(x.dtype)


def _ffn_hidden(p, x):
    if "wg" in p:
        return F.silu(x @ p["wg"]) * (x @ p["wi"])
    return F.gelu(x @ p["wi"], approximate="tanh")


# ---------------------------------------------------------------------------
# explicit-TP projections (all-reduce in the activation dtype)
# ---------------------------------------------------------------------------
# As the JAX package's shard_map bodies: the local partial product comes out
# in the activation dtype (bf16 on the card) and is all-reduced in it, half
# the wire bytes of an fp32 all-reduce, at the cost of one rounding of the
# partial sums. Enabled by the 'tp_bf16_ar' rule.

def _tp_axis_ok(dim: int, axis_name: str = "d_ff") -> bool:
    """The ``tp_bf16_ar`` rule is set and ``axis_name``'s mesh axis divides
    ``dim``, the layer's global width (n_heads, or the FFN's d_ff)."""
    ax = SH.rule(axis_name)
    m = SH.mesh()
    return bool(SH.rule("tp_bf16_ar") and ax is not None and m is not None
                and dim % SH.axis_size(m, ax) == 0)


def tp_mlp_forward(p, x, cfg):
    """SwiGLU/GeLU FFN over this rank's d_ff columns; the partial product
    all-reduced over the ``d_ff`` axis in x's dtype."""
    y = _ffn_hidden(p, x) @ p["wo"]
    return SH.all_reduce(y, SH.rule("d_ff"))


def tp_attn_out(out_heads, wo, cfg):
    """Attention output projection of this rank's heads, (B, S, hl, hd) @
    (hl hd, D), all-reduced over the ``heads`` axis in the activations'
    dtype."""
    B, S = out_heads.shape[0], out_heads.shape[1]
    y = out_heads.reshape(B, S, -1) @ wo
    return SH.all_reduce(y, SH.rule("heads"))
