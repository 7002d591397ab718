"""Plain PyTorch chunkwise mLSTM: ``repro.models.xlstm._mlstm_chunk_scan``
with its padding rule, in fp32.

The CPU path of ``ops.mlstm_chunk`` and the version the CUDA kernel is held
against on the card.
"""
from __future__ import annotations

import torch

CHUNK = 256      # the model's chunk (``repro.models.xlstm.CHUNK``)
NEG = -1e30      # finite, as the reference: -inf would give inf - inf = NaN


def mlstm_chunk_ref(q, k, v, log_i, log_f, state, chunk: int = CHUNK):
    """Stabilised chunkwise mLSTM. q, k, v: (B, S, nh, hd) fp32 (k already
    scaled by 1/sqrt(hd)); log_i, log_f: (B, S, nh); state = (C (B, nh, hd,
    hd), n (B, nh, hd), m (B, nh)). Returns (h (B, S, nh, hd), (C, n, m)),
    new tensors. S is padded to a multiple of ``chunk`` with steps that
    inject nothing (log_i = NEG) and do not decay the state (log_f = 0)."""
    B, S, nh, hd = q.shape
    nc = -(-S // chunk)
    pad = nc * chunk - S

    def prep(a, fill=0.0):
        a = a.float()
        if pad:
            a = torch.cat([a, a.new_full((B, pad, *a.shape[2:]), fill)], 1)
        return a.reshape(B, nc, chunk, *a.shape[2:])
    qc, kc, vc = prep(q), prep(k), prep(v)
    lic, lfc = prep(log_i, NEG), prep(log_f)
    C, n, m = (t.float() for t in state)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=q.device))
    hs = []
    for c in range(nc):
        qq, kk, vv, li, lf = qc[:, c], kc[:, c], vc[:, c], lic[:, c], lfc[:, c]
        F = torch.cumsum(lf, dim=1)                          # (B, L, nh)
        # D[t, s] = F_t - F_s + li_s for s <= t
        Dm = F[:, :, None, :] - F[:, None, :, :] + li[:, None, :, :]
        Dm = torch.where(tri[None, :, :, None], Dm, Dm.new_tensor(NEG))
        m_intra = Dm.amax(dim=2)                             # (B, L, nh)
        m_inter = m[:, None, :] + F
        m_row = torch.maximum(m_intra, m_inter)
        scores = torch.einsum("bthd,bshd->btsh", qq, kk)
        w = scores * torch.exp(Dm - m_row[:, :, None, :])
        intra = torch.einsum("btsh,bshd->bthd", w, vv)
        e_inter = torch.exp(m_inter - m_row)
        inter = e_inter[..., None] * torch.einsum("bthd,bhde->bthe", qq, C)
        qn = torch.einsum("bthd,bhd->bth", qq, n)
        denom = torch.abs(w.sum(dim=2) + e_inter * qn)
        denom = torch.maximum(denom, torch.exp(-m_row))
        hs.append((intra + inter) / denom[..., None])
        # chunk-end state update
        FL = F[:, -1]                                        # (B, nh)
        log_w = FL[:, None] - F + li                         # (B, L, nh)
        m_next = torch.maximum(m + FL, log_w.amax(dim=1))
        scale_old = torch.exp(m + FL - m_next)
        w_s = torch.exp(log_w - m_next[:, None])
        C = C * scale_old[..., None, None] + \
            torch.einsum("bsh,bshd,bshe->bhde", w_s, kk, vv)
        n = n * scale_old[..., None] + torch.einsum("bsh,bshd->bhd", w_s, kk)
        m = m_next
    h = torch.stack(hs, dim=1).reshape(B, nc * chunk, nh, hd)[:, :S]
    return h, (C, n, m)


def make_inputs(gen: torch.Generator, B: int, S: int, nh: int, hd: int,
                given: bool):
    """Random fp32 inputs on ``gen``'s device, drawn as the JAX package's
    kernel tests draw them: k scaled by 1/sqrt(hd), forget gates
    log_sigmoid(N + 3). A given state is small, with a finite m; otherwise
    the fresh state a prefill starts from. Returns ((q, k, v, log_i,
    log_f), (C, n, m))."""
    dev = gen.device

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)
    q, v = randn(B, S, nh, hd), randn(B, S, nh, hd)
    k = randn(B, S, nh, hd) / hd ** 0.5
    li = randn(B, S, nh) * 0.5
    lf = torch.nn.functional.logsigmoid(randn(B, S, nh) + 3.0)
    if given:
        state = (randn(B, nh, hd, hd) * 0.1, randn(B, nh, hd) * 0.1,
                 randn(B, nh))
    else:
        state = (torch.zeros((B, nh, hd, hd), device=dev),
                 torch.zeros((B, nh, hd), device=dev),
                 torch.full((B, nh), NEG, device=dev))
    return (q, k, v, li, lf), state
