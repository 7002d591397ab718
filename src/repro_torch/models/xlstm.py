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

Under sharding rules each rank runs its block of the mLSTM's inner width
over the ``lru`` axis of m ranks, which is nh/m whole heads (so m divides
nh, ``check_lru_axis``). ``launch.shardspecs.local_params`` cuts an mLSTM
slot's ``w_up``, ``w_gate``, ``wq``, ``wk`` and ``wv`` to the rank's 2D/m
columns and ``w_if`` and ``w_down`` to its 2D/m rows, an sLSTM slot's
``w_in`` to its 4D/m columns and ``w_out`` to its D/m rows (``CUT_LEAVES``,
by the slot's kind). An mLSTM block gathers its ``up`` block whole over the
axis (q, k and v are the whole ``up`` times the rank's head columns); the
gates are the SUM over the axis of each rank's fp32 ``up`` block times its
``w_if`` rows, plus ``b_if``, and their gradient is summed over the axis
after that sum (each rank reads only its heads' gates), so ``b_if``'s
gradient is whole; B4 and the decode step run on the rank's heads, and
the partial products of ``w_down`` are summed over the axis. An sLSTM
block's ``w_in`` columns are whole gates (z, i, f, o), not whole units: its
preactivation block, with the rank's slice of ``b_in``, is gathered whole,
the recurrence runs whole on every rank with ``r`` whole, and the rank's
D/m rows of its output times its ``w_out`` block are summed over the axis.
``r`` and ``b_in`` are held whole and read in part (a rank's gradient of
them is its rows' share), so the train step sums their gradients over the
axis (``partial_leaves``). An mLSTM state holds the rank's nh/m heads, an
sLSTM state is whole on every rank; the embedding and the logits are the
vocabulary-parallel ones of ``models.vocab``. Under FSDP (the
``fsdp_gather`` rule) each rank holds its block of every leaf: a group's
weights are gathered inside its remat, a leaf cut on its layer dim before
the layers are unbound, and ``embed``, ``unembed`` and ``final_norm`` in
``forward_train`` (``sharding.maybe_gather_params``).
"""
from __future__ import annotations

import math
from typing import Dict, FrozenSet, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.mlstm_chunk.ops import mlstm_chunk
from repro_torch.kernels.mlstm_chunk.ref import NEG
from repro_torch.models import layers as L
from repro_torch.models import sharding as SH
from repro_torch.models.params import (IF_BIAS, layer_of, prefixed,
                                      unbind_layers)
from repro_torch.models.vocab import embed, logits, whole_logits

# the leaves of a slot that a rank holds cut under the ``lru`` rule, by the
# slot's kind: an mLSTM's inner width, an sLSTM's gate columns and rows
CUT_LEAVES = {"mlstm": ("w_up", "w_gate", "wq", "wk", "wv", "w_if",
                        "w_down"),
              "slstm": ("w_in", "w_out")}
# the leaves of an sLSTM slot that a rank holds whole but reads in part
# under the ``lru`` rule: the recurrence's weights and its gates' bias
_WHOLE_READ_IN_PART = ("r", "b_in")


def _slot_kinds(cfg):
    period = cfg.slstm_every or cfg.n_layers
    return cfg.layer_kinds()[:period]


def _n_groups(cfg):
    period = cfg.slstm_every or cfg.n_layers
    if cfg.n_layers % period:
        raise ValueError(f"{cfg.name}: {cfg.n_layers} layers are not whole "
                         f"groups of {period}")
    return cfg.n_layers // period


def check_lru_axis(cfg, n: int) -> None:
    """Raise unless an ``lru`` axis of ``n`` ranks gives each rank whole
    mLSTM heads: n divides n_heads."""
    if cfg.n_heads % n:
        raise NotImplementedError(
            f"{cfg.name}: the mLSTM's {cfg.n_heads} heads over {n} ranks cut "
            "a head (a rank's q, k and v would need another rank's columns "
            "of up): gathering a head's columns comes with ROADMAP A12")


def lru_shard(cfg) -> SH.Shard:
    """The rank's place along the ``lru`` axis under the active rules
    ((None, 0, 1) outside them, or where it maps to no axis); raises
    where the axis cuts an mLSTM head (``check_lru_axis``)."""
    sh = SH.shard_of("lru")
    check_lru_axis(cfg, sh.size)
    return sh


def cut_leaves(cfg) -> FrozenSet[str]:
    """The paths (``slots/<i>/<leaf>``) of the leaves a rank holds cut
    under the ``lru`` rule, chosen by each slot's kind (``CUT_LEAVES``)."""
    return frozenset(f"slots/{i}/{leaf}"
                     for i, kind in enumerate(_slot_kinds(cfg))
                     for leaf in CUT_LEAVES[kind])


def partial_leaves(cfg) -> Tuple[str, ...]:
    """The paths of the leaves that a rank holds whole but reads only in
    part under the active rules: each sLSTM slot's ``r`` and ``b_in``
    where the ``lru`` axis has more than one rank, else none. A rank's
    gradient of such a leaf is its share; the whole gradient is the SUM
    over the ``lru`` axis."""
    if lru_shard(cfg).size == 1:
        return ()
    return tuple(f"slots/{i}/{leaf}"
                 for i, kind in enumerate(_slot_kinds(cfg))
                 if kind == "slstm" for leaf in _WHOLE_READ_IN_PART)


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
    if kind == "mlstm":     # the rank's heads under the lru rule
        nh = cfg.n_heads // lru_shard(cfg).size
        hd = 2 * cfg.d_model // cfg.n_heads
        return (z(nh, hd, hd), z(nh, hd), neg(nh))
    D = cfg.d_model
    return (z(D), z(D), neg(D), z(D))


def init_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16,
               window: Optional[int] = None, device=None) -> dict:
    """The recurrent state of every layer, fp32 whatever ``dtype``; its size
    does not depend on ``max_len``. Under sharding rules this rank's: an
    mLSTM state at its heads, an sLSTM state whole (``batch`` the rank's
    share of the batch)."""
    G = _n_groups(cfg)
    return {"slots": tuple(_state(cfg, kind, batch, device, (G,))
                           for kind in _slot_kinds(cfg)),
            "pos": torch.zeros((), dtype=torch.int32, device=device)}


# ---------------------------------------------------------------------------
# mLSTM block
# ---------------------------------------------------------------------------

def _mlstm_qkvif(p, x, cfg):
    """x: (B, S, D) -> q, k, v (B, S, nh/m, hd) fp32 of the rank's heads on
    the lru axis of m ranks (one outside rules); log_i, log_f (B, S,
    nh/m) fp32, contiguous; the output gate (B, S, 2D/m) in x's dtype. On
    an axis of m > 1 ranks x enters cut work (``entry``), ``up`` is
    gathered whole and the gates are summed (the module's doc)."""
    B, S, _ = x.shape
    sh = lru_shard(cfg)
    H = cfg.n_heads
    nh = H // sh.size
    hd = 2 * cfg.d_model // H
    if sh.size > 1:       # the inner width's work is cut: x's gradient sums
        axis = SH.rule("lru")
        L.check_width(p, "w_up", nh * hd)
        x = SH.entry(x, axis)
    up = x @ p["w_up"]
    gate = F.silu(x @ p["w_gate"])
    if sh.size == 1:
        gif = (up @ p["w_if"] + p["b_if"]).float()
    else:
        # the rank's rows of w_if, summed, b_if added once; a rank reads
        # its heads' gates only, so their gradient is summed after the sum
        gif = SH.all_reduce(up.float() @ p["w_if"].float(), axis)
        gif = SH.entry(gif + p["b_if"].float(), axis)
        up = SH.all_gather(up, axis, -1)
    h0 = sh.rank * nh
    q = (up @ p["wq"]).reshape(B, S, nh, hd).float()
    k = (up @ p["wk"]).reshape(B, S, nh, hd).float() / math.sqrt(hd)
    v = (up @ p["wv"]).reshape(B, S, nh, hd).float()
    log_i = gif[..., h0:h0 + nh].contiguous()
    log_f = F.logsigmoid(gif[..., H + h0:H + h0 + nh])
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
        if mode != "train":
            for leaf, t in zip(state, new):
                leaf.copy_(t)
    h = h.reshape(B, S, -1).to(x.dtype)
    return x + SH.row_block_product(h * gate, p["w_down"], SH.rule("lru"),
                                    x.dtype)


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
    sh = lru_shard(cfg)
    h_in = L.apply_norm(x, p["ln"], cfg.norm, cfg.norm_eps)
    if sh.size == 1:
        pre = h_in @ p["w_in"] + p["b_in"]
    else:
        # the rank's columns are whole gates of every unit: its block of
        # the preactivation gathered whole, the recurrence run whole
        n = p["b_in"].shape[-1] // sh.size
        axis = SH.rule("lru")
        L.check_width(p, "w_in", n)
        pre = SH.entry(h_in, axis) @ p["w_in"] + \
            p["b_in"].narrow(-1, sh.rank * n, n)
        pre = SH.all_gather(pre, axis, -1)
    r = p["r"].float()
    st = state
    hs = []
    # a span for launch/profile_serve.py: the loop's share of a prefill
    with torch.profiler.record_function("xlstm.slstm_steps"):
        for t in range(x.shape[1]):
            st = _slstm_step(r, cfg, pre[:, t], st)
            hs.append(st[3])
    if mode != "train":
        for leaf, t in zip(state, st):
            leaf.copy_(t)
    hs = torch.stack(hs, dim=1).to(x.dtype)
    if sh.size > 1:       # the rank's rows of w_out
        n = hs.shape[-1] // sh.size
        hs = hs.narrow(-1, sh.rank * n, n)
    return x + SH.row_block_product(hs, p["w_out"], SH.rule("lru"), x.dtype)


# ---------------------------------------------------------------------------
# stack
# ---------------------------------------------------------------------------

def _run_stack(params, x, cfg, mode: str, cache, remat=False):
    """The groups of the period in order. Train reads the states of
    ``cache`` and writes none back (autograd keeps what it read), each group
    rematerialised where ``remat`` asks; prefill and decode write them in
    place. Under FSDP a group's weights are gathered whole inside its remat
    (so its recompute gathers them again), and a leaf cut on its layer dim
    before the layers are unbound."""
    kinds = _slot_kinds(cfg)
    G = _n_groups(cfg)
    fsdp = SH.rule("fsdp_gather")

    def group(slots, x, g):
        if fsdp:
            slots = SH.maybe_gather_params(slots, SH.whole_shapes(
                param_specs(cfg), "slots/", stacked=True))
        for i, kind in enumerate(kinds):
            blk = _mlstm_block if kind == "mlstm" else _slstm_block
            x = blk(slots[i], x, cfg, layer_of(cache["slots"][i], g), mode)
        return x

    slots = unbind_layers(SH.gather_layer_dim(params["slots"], G))
    for g in range(G):
        args = (layer_of(slots, g), x, g)
        x = L.checkpointed(group, *args) if remat else group(*args)
    return x


def forward_train(params, cfg, batch, *, window=None, remat=True):
    """Full-sequence forward from a zero state, each group rematerialised
    in the backward where ``remat`` asks. Returns (logits (B, S, V), aux
    loss 0); with ``unembed`` cut over the vocabulary, the rank's block of
    the logits, (B, S, V / n). Under FSDP ``embed``, ``unembed`` and
    ``final_norm`` are gathered whole first."""
    params = SH.gather_top(params, param_specs(cfg))
    x = embed(params, batch["tokens"], cfg)
    cache = init_cache(cfg, x.shape[0], 0, device=x.device)
    x = _run_stack(params, x, cfg, "train", cache, remat=remat)
    return logits(params, x, cfg), torch.zeros((), device=x.device)


def prefill(params, cfg, batch, cache, *, window=None):
    """Process the prompt from the state in ``cache`` and write the state
    after it in place. Returns (last-token logits (B, V), whole on every
    rank, cache)."""
    tokens = batch["tokens"]
    x = embed(params, tokens, cfg)
    x = _run_stack(params, x, cfg, "prefill", cache)
    last = whole_logits(logits(params, x[:, -1:, :], cfg)[:, 0], cfg)
    pos = torch.tensor(tokens.shape[1], dtype=torch.int32, device=x.device)
    return last, {"slots": cache["slots"], "pos": pos}


def decode_step(params, cfg, token, cache, *, window=None):
    """One decode step; ``cache["pos"]`` is a scalar or (B,) per-slot
    positions, which the recurrence does not read. Returns (logits (B, V),
    whole on every rank, cache), the state written in place and the
    positions advanced by one."""
    if token.ndim == 1:
        token = token[:, None]
    x = embed(params, token, cfg)
    x = _run_stack(params, x, cfg, "decode", cache)
    return whole_logits(logits(params, x, cfg)[:, 0], cfg), {
        "slots": cache["slots"], "pos": cache["pos"] + 1}
