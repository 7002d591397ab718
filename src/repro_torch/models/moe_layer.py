"""Capacity-based top-k MoE FFN, ported from ``repro.models.moe_layer``.

Tokens are flattened and padded at the end into groups of
g = min(moe_group_size, B*S); each group routes to experts with capacity
C = ceil(g * capacity_factor * k / E), or C = g when dropless (decode).
Tokens past an expert's capacity are dropped: only the residual carries
them. ``route`` computes the reference's routing (its dispatch and combine
tensors and the Switch aux loss) as indices, and ``moe_forward`` runs the
experts on a (E, N*C, D) buffer filled by scatter and read back by gather,
the same function as the reference's one-hot einsums. Every expert's FFN
runs as torch ops (no Pallas kernel backs it); all E experts are computed
on their C slots, as the reference's dense dispatch does.

Under sharding rules whose ``experts`` axis divides E, a rank holds its
E / n experts and its E / n columns of the router
(``launch.shardspecs.local_params``), the counterpart of the reference's
``constrain`` of the expert buffers to ("experts", ..., "batch"): the
rank's logits are gathered whole over the axis, so that every rank routes
the same gates alike, it runs its own experts on its tokens' choices of
them, and the ranks' outputs and their shares of the aux loss are summed
over the axis. The groups are formed from the rank's own rows, which is
the reference's grouping of the global token stream where those rows hold
whole groups (``check_groups``).
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L
from repro_torch.models import sharding as SH


def init_moe(cfg) -> Dict[str, tuple]:
    """Layout and init of one MoE FFN's parameters, as
    ``repro.models.moe_layer.init_moe``: name -> (shape, init)."""
    D, Fd, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    spec = {
        "router": ((D, E), 0.02),
        "wi": ((E, D, Fd), L.dense_std((E, D, Fd))),
        "wo": ((E, Fd, D), L.dense_std((E, Fd, D), 1.0 / math.sqrt(Fd))),
    }
    if cfg.mlp == "swiglu":
        spec["wg"] = ((E, D, Fd), L.dense_std((E, D, Fd)))
    if cfg.shared_expert:
        spec.update({f"shared/{k}": v for k, v in L.init_mlp(cfg).items()})
    return spec


def capacity(group: int, cfg) -> int:
    return max(1, int(math.ceil(group * cfg.capacity_factor * cfg.top_k
                                / cfg.n_experts)))


class Routing(NamedTuple):
    """Each token's k choices, (N, g, k) each: the expert, the slot in its
    capacity (>= C when it does not fit), whether it fits, and its combine
    weight (gate / the summed gates that fit, 0 where it does not fit)."""
    expert: torch.Tensor
    slot: torch.Tensor
    fits: torch.Tensor
    weight: torch.Tensor
    aux: torch.Tensor


def route(gates, k: int, C: int, own: slice = slice(None),
          chosen: Optional[torch.Tensor] = None) -> Routing:
    """Top-k routing of fp32 gates (N, g, E) with per-expert capacity C, in
    the reference's arithmetic: k rounds of argmax over the gates not yet
    chosen (the first index wins a tie); a choice's slot is the count of
    earlier tokens of its group that chose the same expert this round, plus
    what fitted in earlier rounds; the aux loss E * mean_N(sum_E
    frac_tokens * frac_probs) / k counts every choice, fitted or not, its
    sum over E taken over the experts ``own`` alone (a rank's share).
    ``chosen`` (N, g, k), where given, are the experts round j takes in
    place of its argmax (another run's routing imposed, so that two runs
    can be held to the same choices); slots, fits, weights and the aux
    loss follow from them and ``gates`` as above."""
    N, g, E = gates.shape
    masked = gates
    counts = torch.zeros((N, 1, E), dtype=torch.long, device=gates.device)
    gate_sum = torch.zeros((N, g), dtype=torch.float32, device=gates.device)
    sel = torch.zeros_like(gates)
    experts, slots, fits, gate_k = [], [], [], []
    for j in range(k):
        idx = torch.argmax(masked, dim=-1) if chosen is None else \
            chosen[..., j]                                      # (N, g)
        onehot = F.one_hot(idx, E)                              # (N, g, E)
        gate_j = torch.gather(gates, -1, idx[..., None])[..., 0]
        # the prefix sum over the group, taken along the last dim: on CUDA a
        # scan along an outer dim runs one thread per (group, expert)
        before = torch.cumsum(onehot.transpose(1, 2), dim=-1).transpose(1, 2)
        pos = before - onehot + counts
        slot = torch.gather(pos, -1, idx[..., None])[..., 0]    # (N, g)
        fit = slot < C
        gate_sum = gate_sum + gate_j * fit
        counts = counts + (onehot * fit[..., None]).sum(1, keepdim=True)
        masked = masked * (1 - onehot.float())
        sel = sel + onehot
        experts.append(idx)
        slots.append(slot)
        fits.append(fit)
        gate_k.append(gate_j)
    fit = torch.stack(fits, -1)
    weight = torch.stack(gate_k, -1) * fit / \
        torch.clamp(gate_sum, min=1e-9)[..., None]
    frac_tokens = sel.mean(dim=1)                               # (N, E)
    frac_probs = gates.mean(dim=1)                              # (N, E)
    aux = E * (frac_tokens * frac_probs)[:, own].sum(-1).mean() / k
    return Routing(torch.stack(experts, -1), torch.stack(slots, -1), fit,
                   weight, aux)


def check_groups(cfg, tokens: int, n_rows: int, dropless: bool) -> None:
    """Raise where a rank's ``tokens``, its run of a token stream cut over
    ``n_rows`` ranks, split a group of the whole stream's grouping (g =
    min(moe_group_size, the stream's tokens)) and capacity decides the
    drops: such a group's capacity and drops differ from the reference's.
    A dropless group (decode) drops nothing however it is grouped."""
    g = min(cfg.moe_group_size, tokens * n_rows)
    if dropless or n_rows == 1 or tokens % g == 0:
        return
    raise NotImplementedError(
        f"{cfg.name}: {tokens} tokens a rank of {n_rows} split the groups of "
        f"{g}: a capacity-routed group across the batch's ranks comes with "
        "ROADMAP A12")


def experts_shard(p, cfg) -> SH.Shard:
    """The rank's place over the ``experts`` axis where it holds E / n of
    the experts, else (None, 0, 1): outside rules, and where the axis does
    not divide E (``sanitize_spec`` keeps them whole). Raises where the
    leaves hold another count."""
    E = cfg.n_experts
    sh = SH.shard_of("experts") if SH.active() else SH.Shard(None, 0, 1)
    if E % sh.size:
        sh = SH.Shard(None, 0, 1)
    want = E // sh.size
    for name in ("wi", "wo", "router"):
        held = p[name].shape[-1 if name == "router" else 0]
        if held != want:
            raise ValueError(f"moe {name} holds {held} of {E} experts where "
                             f"the rules give this rank {want}: cut the "
                             "parameters with launch.shardspecs.local_params "
                             "under the same rules")
    return sh


def moe_forward(p, x, cfg, dropless: bool = False):
    """x: (B, S, D) -> (out (B, S, D), aux loss). ``dropless`` (decode) sets
    the capacity to the group size, so no token overflows.

    With the experts cut over n ranks (``experts_shard``): ``x`` enters
    through ``sharding.entry``; the rank's fp32 logits (N, g, E / n) are
    gathered whole (the gather's backward gives the rank its block of the
    summed gradient) and routed; the rank fills its experts' rows of the
    (E / n, N C, D) buffer, sends the choices of other ranks' experts to
    the spare row and combines its own choices alone (the others at weight
    0, so their weights get no gradient from it). The combine, as the
    reference's einsum over operands in x's dtype accumulates, multiplies
    and sums in fp32 and casts once; with the experts cut, the rank's fp32
    partial output is all-reduced over the axis before the cast, as
    GSPMD's contraction of that einsum over the sharded E is taken here
    and as ``layers.mlp_forward`` takes its d_ff (under ``tp_bf16_ar`` the
    partial output is formed and all-reduced in x's dtype). Each token's
    output is then the same fp32 sum of its k products on every mesh, so
    the experts' cut changes no bit of it. The aux loss is the SUM over the
    axis of each rank's own experts' terms (whose backward is the
    identity): each rank differentiates only its share, so the gather's
    backward sums the whole aux's gradient once."""
    B, S, D = x.shape
    E, k = cfg.n_experts, cfg.top_k
    T = B * S
    if SH.active():
        check_groups(cfg, T, SH.shard_of("batch").size, dropless)
    g = min(cfg.moe_group_size, T)
    n_groups = -(-T // g)
    ex = experts_shard(p, cfg)
    axis = SH.rule("experts")
    El = E // ex.size
    lo = ex.rank * El
    xin = SH.entry(x, axis) if ex.size > 1 else x
    xf = xin.reshape(T, D)
    if n_groups * g > T:                 # pad tokens route too
        xf = F.pad(xf, (0, 0, 0, n_groups * g - T))
    C = g if dropless else capacity(g, cfg)
    logits = xf.reshape(n_groups, g, D).float() @ p["router"].float()
    if ex.size > 1:
        logits = SH.all_gather(logits, axis, -1)
    gates = torch.softmax(logits, dim=-1)
    # with the experts cut, the aux loss's terms of the rank's experts
    r = route(gates, k, C, slice(lo, lo + El)) if ex.size > 1 else \
        route(gates, k, C)

    # each choice's row in the rank's (El, N*C) slot buffer; a choice that
    # does not fit, or goes to another rank's expert, writes to a spare
    # row past its end and reads row 0 at weight 0
    n = torch.arange(n_groups, device=x.device)[:, None, None]
    row = (((r.expert - lo) * n_groups + n) * C + r.slot).reshape(-1)
    mine = (r.fits & (r.expert >= lo) & (r.expert < lo + El)).reshape(-1)
    rows = El * n_groups * C
    tok = torch.arange(n_groups * g, device=x.device).repeat_interleave(k)
    xe = xf.new_zeros((rows + 1, D))
    xe[torch.where(mine, row, rows)] = xf[tok]
    xe = xe[:rows].view(El, n_groups * C, D)
    if "wg" in p:
        h = F.silu(torch.bmm(xe, p["wg"])) * torch.bmm(xe, p["wi"])
    else:
        h = F.gelu(torch.bmm(xe, p["wi"]), approximate="tanh")
    ye = torch.bmm(h, p["wo"]).view(rows, D)
    # the first T tokens' choices (the padding's are never read), their
    # weights in x's dtype as the reference casts its combine tensor
    pick = torch.where(mine, row, 0)[:T * k]
    w = torch.where(mine, r.weight.reshape(-1), 0.0)[:T * k, None] \
        .to(x.dtype)
    if ex.size > 1 and L._tp_axis_ok(E, "experts"):
        out = SH.all_reduce((ye[pick] * w).view(T, k, D).sum(1), axis)
    else:
        out = (ye[pick].float() * w.float()).view(T, k, D).sum(1)
        if ex.size > 1:
            out = SH.all_reduce(out, axis)
        out = out.to(x.dtype)
    aux = SH.all_reduce(r.aux, axis) if ex.size > 1 else r.aux
    out = out.reshape(B, S, D)
    if "shared" in p:
        out = out + L.mlp_forward(p["shared"], x, cfg, d_ff=cfg.d_ff)
    return out, aux
