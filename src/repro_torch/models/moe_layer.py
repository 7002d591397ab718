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
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L


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


def route(gates, k: int, C: int) -> Routing:
    """Top-k routing of fp32 gates (N, g, E) with per-expert capacity C, in
    the reference's arithmetic: k rounds of argmax over the gates not yet
    chosen (the first index wins a tie); a choice's slot is the count of
    earlier tokens of its group that chose the same expert this round, plus
    what fitted in earlier rounds; the aux loss E * mean_N(sum_E
    frac_tokens * frac_probs) / k counts every choice, fitted or not."""
    N, g, E = gates.shape
    masked = gates
    counts = torch.zeros((N, 1, E), dtype=torch.long, device=gates.device)
    gate_sum = torch.zeros((N, g), dtype=torch.float32, device=gates.device)
    sel = torch.zeros_like(gates)
    experts, slots, fits, gate_k = [], [], [], []
    for _ in range(k):
        idx = torch.argmax(masked, dim=-1)                      # (N, g)
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
    aux = E * (frac_tokens * frac_probs).sum(-1).mean() / k
    return Routing(torch.stack(experts, -1), torch.stack(slots, -1), fit,
                   weight, aux)


def moe_forward(p, x, cfg, dropless: bool = False):
    """x: (B, S, D) -> (out (B, S, D), aux loss). ``dropless`` (decode) sets
    the capacity to the group size, so no token overflows."""
    B, S, D = x.shape
    E, k = cfg.n_experts, cfg.top_k
    T = B * S
    g = min(cfg.moe_group_size, T)
    n_groups = -(-T // g)
    xf = x.reshape(T, D)
    if n_groups * g > T:                 # pad tokens route too
        xf = F.pad(xf, (0, 0, 0, n_groups * g - T))
    C = g if dropless else capacity(g, cfg)
    logits = xf.reshape(n_groups, g, D).float() @ p["router"].float()
    r = route(torch.softmax(logits, dim=-1), k, C)

    # each choice's row in the (E, N*C) slot buffer; a choice that does not
    # fit writes to a spare row past its end and reads row 0 at weight 0
    n = torch.arange(n_groups, device=x.device)[:, None, None]
    row = ((r.expert * n_groups + n) * C + r.slot).reshape(-1)
    fits = r.fits.reshape(-1)
    rows = E * n_groups * C
    tok = torch.arange(n_groups * g, device=x.device).repeat_interleave(k)
    xe = xf.new_zeros((rows + 1, D))
    xe[torch.where(fits, row, rows)] = xf[tok]
    xe = xe[:rows].view(E, n_groups * C, D)
    if "wg" in p:
        h = F.silu(torch.bmm(xe, p["wg"])) * torch.bmm(xe, p["wi"])
    else:
        h = F.gelu(torch.bmm(xe, p["wi"]), approximate="tanh")
    ye = torch.bmm(h, p["wo"]).view(rows, D)
    w = r.weight.to(x.dtype).reshape(-1, 1)
    out = (ye[torch.where(fits, row, 0)] * w).view(n_groups * g, k, D).sum(1)
    out = out[:T].reshape(B, S, D)
    if "shared" in p:
        out = out + L.mlp_forward(p["shared"], x, cfg)
    return out, r.aux
