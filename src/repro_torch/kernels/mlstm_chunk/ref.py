"""Plain PyTorch chunkwise mLSTM: ``repro.models.xlstm._mlstm_chunk_scan``
with its padding rule, in fp32 (or in fp64, given fp64 inputs).

The CPU path of ``ops.mlstm_chunk`` (fp32), and, evaluated in fp64, the
version the CUDA kernel is held against on the card: h divides by a
denominator that can cancel, and the fp32 version's own rounding on an H100
reaches 2.7e-4 at the served prefill's shape, past the kernel's tolerance.
"""
from __future__ import annotations

import torch

CHUNK = 256      # the model's chunk (``repro.models.xlstm.CHUNK``)
NEG = -1e30      # finite, as the reference: -inf would give inf - inf = NaN


def mlstm_chunk_ref(q, k, v, log_i, log_f, state, chunk: int = CHUNK):
    """Stabilised chunkwise mLSTM. q, k, v: (B, S, nh, hd) fp32 (k already
    scaled by 1/sqrt(hd)); log_i, log_f: (B, S, nh); state = (C (B, nh, hd,
    hd), n (B, nh, hd), m (B, nh)). Returns (h (B, S, nh, hd), (C, n, m)),
    new tensors, in fp64 if q is fp64, else in fp32. S is padded to a
    multiple of ``chunk`` with steps that inject nothing (log_i = NEG) and
    do not decay the state (log_f = 0)."""
    B, S, nh, hd = q.shape
    nc = -(-S // chunk)
    pad = nc * chunk - S
    dt = torch.float64 if q.dtype == torch.float64 else torch.float32

    def prep(a, fill=0.0):
        a = a.to(dt)
        if pad:
            a = torch.cat([a, a.new_full((B, pad, *a.shape[2:]), fill)], 1)
        return a.reshape(B, nc, chunk, *a.shape[2:])
    qc, kc, vc = prep(q), prep(k), prep(v)
    lic, lfc = prep(log_i, NEG), prep(log_f)
    C, n, m = (t.to(dt) for t in state)
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


def mlstm_chunk_bwd_ref(q, k, v, log_i, log_f, state, dh, chunk: int = CHUNK):
    """The gradient of ``mlstm_chunk_ref``'s h, written out in the passes
    the CUDA backward (``csrc/mlstm_chunk_bwd.cu``) makes: the forward's
    chain for the state entering each chunk; each chunk's weights and the
    gradients of h's numerator and denominator; a reverse chain over chunks
    for the gradient of the state leaving each chunk, dC_c = scale_old_c
    dC_{c+1} + sum_t e_t q_t dnum_t^T (and dn likewise); each chunk's local
    gradients from C_c and dC_{c+1}; the gates' gradient, a reverse cumsum
    within each chunk (F restarts at every chunk, and only the chunk-end
    term dFL crosses it). Arguments as ``mlstm_chunk_ref``, plus dh (B, S,
    nh, hd), the cotangent of h; the state leaving the scan takes none and
    the state entering it gets none. Returns (dq, dk, dv, dlog_i, dlog_f),
    in fp64 if q is fp64, else in fp32.

    The stabilisers m_row, m_next and the state's m are constants: h is
    the same for any value of them (m_row scales the numerator and the
    denominator alike, the clamp exp(-m_row) with them, and (C, n, m) may
    shift jointly), so no gradient flows through them. In the clamp's
    branch (|a_t| < exp(-m_row_t)) h does not depend on a_t."""
    B, S, nh, hd = q.shape
    nc = -(-S // chunk)
    pad = nc * chunk - S
    dt = torch.float64 if q.dtype == torch.float64 else torch.float32

    def prep(a, fill=0.0):
        a = a.to(dt)
        if pad:
            a = torch.cat([a, a.new_full((B, pad, *a.shape[2:]), fill)], 1)
        return a.reshape(B, nc, chunk, *a.shape[2:])
    qc, kc, vc, dhc = prep(q), prep(k), prep(v), prep(dh)
    lic, lfc = prep(log_i, NEG), prep(log_f)
    F = torch.cumsum(lfc, dim=2)                         # (B, nc, L, nh)
    FL = F[:, :, -1]                                     # (B, nc, nh)
    log_w = FL[:, :, None] - F + lic
    # the forward's chain: the state entering chunk c, the chunk-end weights
    C, n, m = (t.to(dt) for t in state)
    Cs, ns, ms, scales, ws = [], [], [], [], []
    for c in range(nc):
        Cs.append(C)
        ns.append(n)
        ms.append(m)
        m_next = torch.maximum(m + FL[:, c], log_w[:, c].amax(dim=1))
        scales.append(torch.exp(m + FL[:, c] - m_next))
        ws.append(torch.exp(log_w[:, c] - m_next[:, None]))
        C = C * scales[-1][..., None, None] + \
            torch.einsum("bsh,bshd,bshe->bhde", ws[-1], kc[:, c], vc[:, c])
        n = n * scales[-1][..., None] + \
            torch.einsum("bsh,bshd->bhd", ws[-1], kc[:, c])
        m = m_next
    Cs, ns, ms, scale, w_s = (torch.stack(t, 1)
                              for t in (Cs, ns, ms, scales, ws))
    # 1. each chunk's weights and denominators; dnum = dh / den and da, the
    #    gradient of the denominator's signed sum a (none in the clamp)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=q.device))[:, :, None]
    Dm = F[:, :, :, None] - F[:, :, None] + lic[:, :, None]   # (B,nc,t,s,nh)
    Dm = torch.where(tri, Dm, Dm.new_tensor(NEG))
    m_row = torch.maximum(Dm.amax(dim=3), ms[:, :, None] + F)
    P = torch.exp(Dm - m_row[:, :, :, None])
    W = torch.einsum("bcthd,bcshd->bctsh", qc, kc) * P
    e = torch.exp(ms[:, :, None] + F - m_row)               # (B, nc, L, nh)
    qn = torch.einsum("bcthd,bchd->bcth", qc, ns)
    a = W.sum(dim=3) + e * qn
    floor = torch.exp(-m_row)
    den = torch.maximum(a.abs(), floor)
    X = torch.einsum("bcthe,bchde->bcthd", dhc, Cs)         # C_c dh_t
    num = torch.einsum("bctsh,bcshd->bcthd", W, vc) + e[..., None] * \
        torch.einsum("bcthd,bchde->bcthe", qc, Cs)
    dnum = dhc / den[..., None]
    dden = -(dhc * num).sum(dim=-1) / den ** 2
    da = torch.where(a.abs() >= floor, torch.sign(a) * dden, 0.0)
    # 2. the reverse chain: dC'_c, dn'_c, the gradient of the state leaving
    #    chunk c (none leaves the last)
    dC = torch.zeros_like(Cs[:, 0])
    dn = torch.zeros_like(ns[:, 0])
    dCs, dns = [None] * nc, [None] * nc
    for c in reversed(range(nc)):
        dCs[c], dns[c] = dC, dn
        eq = e[:, c, :, :, None] * qc[:, c]
        dC = scale[:, c, :, None, None] * dC + \
            torch.einsum("bthd,bthe->bhde", eq, dnum[:, c])
        dn = scale[:, c, :, None] * dn + \
            torch.einsum("bth,bthd->bhd", da[:, c], eq)
    dCs, dns = torch.stack(dCs, 1), torch.stack(dns, 1)
    # 3. each chunk's local gradients, from C_c and dC'_c
    dW = torch.einsum("bcthe,bcshe->bctsh", dnum, vc) + da[:, :, :, None]
    dS, dD = dW * P, dW * W
    dq = e[..., None] * (X / den[..., None] + da[..., None] * ns[:, :, None]) \
        + torch.einsum("bctsh,bcshd->bcthd", dS, kc)
    G = torch.einsum("bcshe,bchde->bcshd", vc, dCs) + dns[:, :, None]
    dk = w_s[..., None] * G + torch.einsum("bctsh,bcthd->bcshd", dS, qc)
    dv = w_s[..., None] * torch.einsum("bcshd,bchde->bcshe", kc, dCs) + \
        torch.einsum("bctsh,bcthe->bcshe", W, dnum)
    # 4. the gates: D[t, s] = F_t - F_s + log_i_s, e_t = exp(m + F_t - ...),
    #    log_w_s = F_L - F_s + log_i_s, scale_old = exp(m + F_L - m_next);
    #    then dlog_f_s = sum_{t >= s} dF_t within the chunk
    de = (qc * X).sum(dim=-1) / den + da * qn
    dlog_w = w_s * (kc * G).sum(dim=-1)
    dscale = (dCs * Cs).sum(dim=(-2, -1)) + (dns * ns).sum(dim=-1)
    dF = dD.sum(dim=3) - dD.sum(dim=2) + de * e - dlog_w
    dF[:, :, -1] += dlog_w.sum(dim=2) + dscale * scale
    dlog_i = dD.sum(dim=2) + dlog_w
    dlog_f = torch.flip(torch.cumsum(torch.flip(dF, (2,)), 2), (2,))

    def unpad(t):
        return t.reshape(B, nc * chunk, *t.shape[3:])[:, :S]
    return tuple(unpad(t) for t in (dq, dk, dv, dlog_i, dlog_f))


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
