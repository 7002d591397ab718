"""Decoder-only transformer, ported from ``repro.models.transformer``
(families ``"dense"``, ``"moe"`` and ``"vlm"``: Chameleon's early fusion puts
image tokens in the one vocabulary, so the vlm runs the same stack; its
tokenizer is not modelled, as in the JAX package).

The layers form ``G = n_layers // moe_every`` groups of ``moe_every``
slots; slot i of every group has the FFN kind ``cfg.ffn_kinds()[i]``
(dense, or the MoE FFN of ``moe_layer``). Parameters keep the JAX
package's pytree: every per-layer leaf of slot i is stacked along a leading
dim G under ``slots[i]`` (the JAX package stacks them with ``vmap`` to
``scan`` over them); here a written-out loop walks group g, then slot i.
The KV cache is ``{"slots": ({"k", "v"}, ...), "pos"}``, one (G, B, Sc, K,
hd) pair a slot; ``prefill`` and ``decode_step`` write into them in place
and return them. Under sharding rules (dense and vlm only; ``api.LM``
refuses the rest) each rank runs its block of the layers and the cache
(``models.layers``), and, where ``embed`` and ``unembed`` are cut over the
vocabulary (``launch.shardspecs.local_params``), its block of the
vocabulary: the embedding is a SUM over the ``vocab`` axis of each rank's
lookup of its own rows, and ``forward_train`` returns the rank's block of
the logits, which ``api.LM.loss_terms`` reduces without gathering;
``prefill`` and ``decode_step`` return whole logits, gathered.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.models import layers as L
from repro_torch.models import sharding as SH
from repro_torch.models.moe_layer import init_moe, moe_forward
from repro_torch.models.params import layer_of, prefixed, unbind_layers


def _slot_kinds(cfg):
    return cfg.ffn_kinds()[:cfg.moe_every]


def _n_groups(cfg) -> int:
    if cfg.n_layers % cfg.moe_every:
        raise ValueError(f"{cfg.name}: n_layers={cfg.n_layers} is not a "
                         f"multiple of moe_every={cfg.moe_every}")
    return cfg.n_layers // cfg.moe_every


def param_specs(cfg) -> Dict[str, tuple]:
    """Flat parameter layout, keyed by the JAX pytree's paths as
    ``repro.training.checkpoint._flatten`` joins them: name -> (shape,
    init), init a normal std, "ones" or "zeros"."""
    G, D, V = _n_groups(cfg), cfg.d_model, cfg.vocab_size
    norm = L.init_norm(D, cfg.norm)
    specs = {
        "embed": ((V, D), L.EMBED_STD),
        "unembed": ((D, V), L.dense_std((D, V))),
        **prefixed("final_norm", norm),
    }
    for i, kind in enumerate(_slot_kinds(cfg)):
        ffn = init_moe(cfg) if kind == "moe" else \
            L.init_mlp(cfg, d_ff=cfg.d_ff_dense or cfg.d_ff)
        for block, spec in (("ln1", norm), ("ln2", norm),
                            ("attn", L.init_attention(cfg)), ("ffn", ffn)):
            for name, (shape, init) in spec.items():
                specs[f"slots/{i}/{block}/{name}"] = ((G, *shape), init)
    return specs


def local_cache(cfg, batch: int, max_len: int,
                window: Optional[int] = None) -> tuple:
    """The shape (G, batch, rows, KV heads, hd) of one slot's K (or V) cache
    on this rank under the active rules: ``max_len`` / n rows where
    ``kv_seq`` shards the sequence over n ranks (as ``cache_specs``' kv5
    places it), and the KV heads that the rank's query heads read where
    ``heads`` is sharded (``layers.head_plan``). ``batch`` is the rank's
    own share of the batch. Outside a rules context, the whole cache."""
    Sc = min(max_len, window) if window else max_len
    seq = SH.shard_of("kv_seq")
    if seq.size > 1:
        if window:
            raise NotImplementedError("a rotating window cache sharded over "
                                      "kv_seq comes with ROADMAP A12")
        if Sc % seq.size:
            raise ValueError(f"max_len {Sc} does not split over the "
                             f"{seq.size} ranks of kv_seq")
        Sc //= seq.size
    return (_n_groups(cfg), batch, Sc, L.head_plan(cfg).n_kv, cfg.head_dim)


def init_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16,
               window: Optional[int] = None, device=None) -> dict:
    """Zeroed caches; under sharding rules this rank's block of them
    (``local_cache``), ``batch`` its share of the batch."""
    shape = local_cache(cfg, batch, max_len, window)

    def kv():
        return torch.zeros(shape, dtype=dtype, device=device)
    return {"slots": tuple({"k": kv(), "v": kv()} for _ in _slot_kinds(cfg)),
            "pos": torch.zeros((), dtype=torch.int32, device=device)}


def _group(slots, x, aux, cfg, mode: str, cache, g: int, window):
    """Group g's layers (slot i of ``slots``, its parameters). Returns
    (x, aux plus their MoE FFNs' aux loss)."""
    for i, kind in enumerate(_slot_kinds(cfg)):
        p = slots[i]
        h = L.apply_norm(x, p["ln1"], cfg.norm, cfg.norm_eps)
        if mode == "train":
            a = L.attn_forward(p["attn"], h, cfg, window=window)
        else:
            kv = cache["slots"][i]
            if mode == "prefill":
                a, _, _ = L.attn_prefill(p["attn"], h, cfg, kv["k"][g],
                                         kv["v"][g], window=window)
            else:
                a, _, _ = L.attn_decode(p["attn"], h, cfg, kv["k"][g],
                                        kv["v"][g], cache["pos"],
                                        window=window)
        x = x + a
        h = L.apply_norm(x, p["ln2"], cfg.norm, cfg.norm_eps)
        if kind == "moe":
            f, aux_i = moe_forward(p["ffn"], h, cfg,
                                   dropless=(mode == "decode"))
            aux = aux + aux_i
        else:
            f = L.mlp_forward(p["ffn"], h, cfg)
        x = x + f
    return x, aux


def _run_stack(params, x, cfg, mode: str, cache=None, window=None,
               remat=False):
    """The layers in order (group g, then slot i); in training each group
    is rematerialised where ``remat`` asks. Returns (x, the summed aux loss
    of the MoE FFNs)."""
    aux = torch.zeros((), device=x.device)
    slots = unbind_layers(params["slots"])
    for g in range(_n_groups(cfg)):
        args = (layer_of(slots, g), x, aux, cfg, mode, cache, g, window)
        x, aux = L.checkpointed(_group, *args) if remat else _group(*args)
    return x, aux


def vocab_block(cfg, width: int) -> Optional[int]:
    """The first vocabulary id of this rank's block where a leaf holds
    ``width`` of the vocabulary's rows or columns: None where it holds
    them all (outside rules, or kept whole), the rank's first id where it
    holds its block over the ``vocab`` axis. Raises for any other width."""
    V = cfg.vocab_size
    if width == V:
        return None
    sh = SH.shard_of("vocab")
    if sh.size == 1 or V % sh.size or width != V // sh.size:
        raise ValueError(f"embed/unembed hold {width} of the vocabulary's "
                         f"{V} ids where the rules give this rank "
                         f"{V // sh.size if V % sh.size == 0 else V}: cut "
                         "the parameters with launch.shardspecs.local_params "
                         "under the same rules")
    return sh.rank * width


def _embed(params, tokens, cfg):
    """The embedding rows of ``tokens``; with ``embed`` cut over the
    vocabulary, each rank looks up the tokens in its rows, zeros the
    others and the ranks' lookups are summed (whose backward gives each
    rank the gradient of its own rows)."""
    table = params["embed"]
    lo = vocab_block(cfg, table.shape[0])
    if lo is None:
        return table[tokens]
    local = tokens - lo
    mine = (local >= 0) & (local < table.shape[0])
    x = table[local.clamp(0, table.shape[0] - 1)] * \
        mine[..., None].to(table.dtype)
    return SH.all_reduce(x, SH.rule("vocab"))


def _logits(params, x, cfg):
    """The logits of this rank's columns of ``unembed``: (..., V), or the
    rank's block (..., V / n) of them where it holds a block."""
    x = L.apply_norm(x, params["final_norm"], cfg.norm, cfg.norm_eps)
    if vocab_block(cfg, params["unembed"].shape[-1]) is not None:
        x = SH.entry(x, SH.rule("vocab"))  # the gradient of x sums
    return x @ params["unembed"]


def whole_logits(logits, cfg):
    """Whole logits (..., V) from ``forward_train``'s or ``_logits``' (the
    rank's block gathered over ``vocab``; whole logits as they are)."""
    if logits.shape[-1] == cfg.vocab_size:
        return logits
    return SH.all_gather(logits, SH.rule("vocab"), -1)


def forward_train(params, cfg, batch, *, window=None, remat=True):
    """Full-sequence forward, each group of layers rematerialised in the
    backward where ``remat`` asks. Returns (logits (B, S, V), the MoE FFNs'
    summed aux loss, 0 without them); with ``unembed`` cut over the
    vocabulary, the rank's block of the logits, (B, S, V / n)."""
    x = _embed(params, batch["tokens"], cfg)
    x, aux = _run_stack(params, x, cfg, "train", window=window, remat=remat)
    return _logits(params, x, cfg), aux


def prefill(params, cfg, batch, cache, *, window=None):
    """Process the prompt and fill the cache in place. Returns (last-token
    logits (B, V), whole on every rank, cache)."""
    tokens = batch["tokens"]
    x = _embed(params, tokens, cfg)
    x, _ = _run_stack(params, x, cfg, "prefill", cache=cache, window=window)
    last = whole_logits(_logits(params, x[:, -1:, :], cfg)[:, 0], cfg)
    pos = torch.tensor(tokens.shape[1], dtype=torch.int32, device=x.device)
    return last, {"slots": cache["slots"], "pos": pos}


def decode_step(params, cfg, token, cache, *, window=None):
    """One decode step; ``cache["pos"]`` is a scalar or (B,) per-slot
    positions. token: (B,) or (B, 1). Returns (logits (B, V), whole on
    every rank, cache), the cache written in place and its positions
    advanced by one."""
    if token.ndim == 1:
        token = token[:, None]
    x = _embed(params, token, cfg)
    x, _ = _run_stack(params, x, cfg, "decode", cache=cache, window=window)
    logits = whole_logits(_logits(params, x, cfg)[:, 0], cfg)
    return logits, {"slots": cache["slots"], "pos": cache["pos"] + 1}
