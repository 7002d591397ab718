"""The vocabulary-parallel embedding and logits, shared by the families that
run under sharding rules (``models.transformer``, ``models.rglru``,
``models.xlstm``).

Where ``embed`` and ``unembed`` are cut over the vocabulary
(``launch.shardspecs.local_params`` under a ``vocab`` rule), a rank holds
its block of the vocabulary's rows or columns: the embedding is a SUM over
the ``vocab`` axis of each rank's lookup of its own rows, and ``logits``
gives the rank's block of the logits, which ``api.LM.loss_terms`` reduces
without gathering and ``whole_logits`` gathers. Where they are whole (no
rules, or a vocabulary the axis does not divide), the plain lookup and
product.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.models import layers as L
from repro_torch.models import sharding as SH


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


def embed(params, tokens, cfg):
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


def logits(params, x, cfg):
    """The final norm, then the logits of this rank's columns of
    ``unembed``: (..., V), or the rank's block (..., V / n) of them where
    it holds a block."""
    x = L.apply_norm(x, params["final_norm"], cfg.norm, cfg.norm_eps)
    if vocab_block(cfg, params["unembed"].shape[-1]) is not None:
        x = SH.entry(x, SH.rule("vocab"))  # the gradient of x sums
    return x @ params["unembed"]


def whole_logits(out, cfg):
    """Whole logits (..., V) from ``logits``' (the rank's block gathered
    over ``vocab``; whole logits as they are)."""
    if out.shape[-1] == cfg.vocab_size:
        return out
    return SH.all_gather(out, SH.rule("vocab"), -1)
