"""The arithmetic of the Hopper mLSTM backward (``csrc/mlstm_chunk_bwd.cu``)
on the CPU, where the kernel cannot run.

Its four passes are written out in plain torch at the kernel's chunk of 64
steps: the weight pass (q k^T and dh v^T over hd, W, the denominators, dS,
W / den and dD), the reverse state pass (dC' <- scale dC' + (q e / den)^T
dh, one 64-deep product a chunk), the gradient pass (dq, dk and dv, each a
product over hd and then one over the chunk's steps) and the gate pass.
Every product the kernel does on the tensor cores is formed as it forms
it: each operand split into hi = tf32(x) and lo = tf32(x - hi), with tf32
emulated as ``cvt.rna``, a_lo b_hi + a_hi b_lo + a_hi b_hi summed in fp32
over one stage (32 deep along hd or the chunk, the state pass's whole
64-step chunk), and the stages added in fp32 in the kernel's order; the
gates are summed in fp64, as the kernel sums them. The forward's states
and h come from the forward's passes written out the same way
(test_torch_mlstm_tf32.py). The gradients are held against the plain
backward (``mlstm_chunk_bwd_ref``, itself held against ``jax.vjp`` in
test_torch_mlstm_grad.py) evaluated in fp64, at the card tests' tolerance:
1e-4 of max |plain| for each of dq, dk, dv, dlog_i and dlog_f. Inputs come
from numpy seeds. The wrapper's launch plan is checked against the card:
every pass with products runs at least 132 blocks (the H100's SMs) at
xLSTM-350M's training shape.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.mlstm_chunk.kernel import KERNEL_CHUNK, plan_bwd  # noqa: E402
from repro_torch.kernels.mlstm_chunk.ref import NEG, mlstm_chunk_bwd_ref  # noqa: E402
from test_torch_mlstm_tf32 import (  # noqa: E402
    chunks,
    split_mm,
    state_pass,
    tf32,
    three_passes,
)

L = KERNEL_CHUNK
STAGE = 32        # the kernel's kK: depth of one tensor-core sum
BWD_TOL = 1e-4    # of max |plain|, each gradient
H100_SMS = 132


def staged_mm(a, b, mm=split_mm):
    """a @ b over the last axis of a in stages of 32, each formed by ``mm``
    and added in fp32 in order, as the kernel's pipelined products."""
    out = torch.zeros((*a.shape[:-1], b.shape[-1]), dtype=torch.float32)
    for k0 in range(0, a.shape[-1], STAGE):
        out = out + mm(a[..., k0:k0 + STAGE], b[..., k0:k0 + STAGE, :])
    return out


def four_passes(q, k, v, log_i, log_f, state, h, dh, mm=split_mm):
    """The kernel's four passes, each tensor-core product formed by ``mm``
    (and summed in stages by ``staged_mm``); arguments as
    ``mlstm_chunk_bwd_ref`` plus the forward's h. Returns (dq, dk, dv,
    dlog_i, dlog_f)."""
    B, S, nh, hd = q.shape
    nc = -(-S // L)
    qc, kc, vc, hc, dhc = (chunks(t) for t in (q, k, v, h, dh))
    lic, lfc = chunks(log_i, NEG), chunks(log_f)
    F = torch.cumsum(lfc.double(), -1)   # gate sums in fp64, as the kernel's
    FL = F[..., -1]
    entering, _ = state_pass(kc, vc, lic, F, state, mm)
    tri = torch.tril(torch.ones((L, L), dtype=torch.bool))
    live = (torch.arange(nc * L) < S).reshape(nc, 1, 1, L)

    # 1. weight pass
    E, R, DA, QN, w, scale = [], [], [], [], [], []
    dS, Wd, dD = [], [], []
    for c in range(nc):
        _, n_c, m_c = entering[c]
        D = F[c][..., :, None] - F[c][..., None, :] + lic[c][..., None, :]
        D = D.masked_fill(~tri, NEG)
        m_F = m_c[..., None].double() + F[c]
        m_row = torch.maximum(D.amax(-1), m_F).float()
        Sc = staged_mm(qc[c], kc[c].transpose(-1, -2), mm)
        G = staged_mm(dhc[c], vc[c].transpose(-1, -2), mm)
        p_ = (torch.exp(D.float() - m_row[..., None]) * tri).masked_fill(
            ~live[c][..., None], 0.0)
        W_ = Sc * p_
        e = torch.exp(m_F.float() - m_row) * live[c]
        qn = (qc[c] * n_c[..., None, :]).sum(-1)
        dhh = (dhc[c] * hc[c]).sum(-1)
        a = W_.sum(-1) + e * qn
        flo = torch.exp(-m_row)
        R_ = torch.where(live[c], 1 / torch.maximum(a.abs(), flo), 0.0)
        da = torch.where(live[c] & (a.abs() >= flo),
                         torch.sign(a) * -dhh * R_, 0.0)
        dW = G * R_[..., None] + da[..., None]
        dS.append(dW * p_)
        dD.append(dW * W_)
        Wd.append(W_ * R_[..., None])
        E.append(e)
        R.append(R_)
        DA.append(da)
        QN.append(qn)
        # the chunk end's weights and scale, as the forward's state pass
        log_w = (FL[c][..., None] - F[c] + lic[c]).float()
        m_next = torch.maximum((m_c.double() + FL[c]).float(),
                               log_w.amax(-1))
        w.append(torch.exp(log_w - m_next[..., None]))
        scale.append(torch.exp((m_c.double() + FL[c] - m_next).float()))

    # 2. state pass, in reverse: dC'_c and dn'_c leave chunk c
    dC = torch.zeros_like(state[0])
    dn = torch.zeros_like(state[1])
    dCs, dns, dscale = [None] * nc, [None] * nc, [None] * nc
    for c in reversed(range(nc)):
        C_c, n_c, _ = entering[c]
        dCs[c], dns[c] = dC, dn
        dscale[c] = (dC * C_c).sum((-2, -1)) + (dn * n_c).sum(-1)
        eq = qc[c] * (E[c] * R[c])[..., None]   # e / den folded into q
        dC = dC * scale[c][..., None, None] + mm(eq.transpose(-1, -2),
                                                 dhc[c])
        dn = dn * scale[c][..., None] + \
            ((DA[c] * E[c])[..., None] * qc[c]).sum(-2)

    # 3. gradient pass: a product over hd, then one over the chunk's steps
    dq, dk, dv, qX, kG = [], [], [], [], []
    for c in range(nc):
        C_c, n_c, _ = entering[c]
        X = staged_mm(dhc[c], C_c.transpose(-1, -2), mm)   # C_c dh_t
        qX.append((qc[c] * X).sum(-1))
        dq.append(X * (E[c] * R[c])[..., None] +
                  (E[c] * DA[c])[..., None] * n_c[..., None, :] +
                  staged_mm(dS[c], kc[c], mm))
        G = staged_mm(vc[c], dCs[c].transpose(-1, -2), mm) + \
            dns[c][..., None, :]
        kG.append((kc[c] * G).sum(-1))
        dk.append(G * w[c][..., None] +
                  staged_mm(dS[c].transpose(-1, -2), qc[c], mm))
        dv.append(staged_mm(kc[c], dCs[c], mm) * w[c][..., None] +
                  staged_mm(Wd[c].transpose(-1, -2), dhc[c], mm))

    # 4. gate pass, dF and its reverse cumsum in fp64
    dli, dlf = [], []
    for c in range(nc):
        col, rowsum = dD[c].sum(-2), dD[c].sum(-1)
        de = R[c] * qX[c] + DA[c] * QN[c]
        dlw = w[c] * kG[c]
        f = rowsum.double() - col + de.double() * E[c].double() - dlw
        f[..., -1] += dlw.sum(-1) + (dscale[c] * scale[c]).double()
        dli.append(col + dlw)
        dlf.append(torch.flip(torch.cumsum(torch.flip(f, (-1,)), -1),
                              (-1,)).float())

    def unchunk(parts):   # [(B, nh, L, ...)] * nc -> (B, S, nh, ...)
        t = torch.stack(parts).movedim(0, 1).movedim(2, 3)
        return t.reshape(B, nc * L, nh, *t.shape[4:])[:, :S]
    return tuple(unchunk(t) for t in (dq, dk, dv, dli, dlf))


def np_inputs(seed, B, S, nh, hd, given):
    """fp32 inputs from a numpy seed, drawn as ``ref.make_inputs`` draws
    them: k scaled by 1/sqrt(hd), forget gates log_sigmoid(N + 3); a small
    given state with a finite m, or the fresh state. Returns ((q, k, v,
    log_i, log_f), (C, n, m), dh)."""
    rng = np.random.default_rng(seed)

    def randn(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    q, v = randn(B, S, nh, hd), randn(B, S, nh, hd)
    k = randn(B, S, nh, hd) / hd ** 0.5
    li = randn(B, S, nh) * 0.5
    lf = torch.nn.functional.logsigmoid(randn(B, S, nh) + 3.0)
    if given:
        state = (randn(B, nh, hd, hd) * 0.1, randn(B, nh, hd) * 0.1,
                 randn(B, nh))
    else:
        state = (torch.zeros(B, nh, hd, hd), torch.zeros(B, nh, hd),
                 torch.full((B, nh), NEG))
    return (q, k, v, li, lf), state, randn(B, S, nh, hd)


def _case(seed, B, S, nh, hd, given, mm=split_mm):
    ins, state, dh = np_inputs(seed, B, S, nh, hd, given)
    h, _ = three_passes(*ins, state)   # the forward kernel's h
    got = four_passes(*ins, state, h, dh, mm)
    want = mlstm_chunk_bwd_ref(*(t.double() for t in ins),
                               tuple(t.double() for t in state), dh.double(),
                               chunk=L)
    return got, want


@pytest.mark.parametrize("B,S,nh,hd,given", [
    (1, L, 1, 512, False),    # one chunk
    (1, L, 1, 512, True),
    (2, 1, 2, 32, True),      # one step
    (1, 300, 1, 512, False),  # ragged, five chunks
    (1, 300, 1, 512, True),
    (2, 130, 2, 96, True),    # hd not a multiple of the 128-column slice
])
def test_split_tf32_backward_matches_plain(B, S, nh, hd, given):
    got, want = _case(S + hd + given, B, S, nh, hd, given)
    for name, g, w in zip(("dq", "dk", "dv", "dlog_i", "dlog_f"), got, want):
        assert g.shape == w.shape and g.dtype == torch.float32, name
        err = float((g.double() - w).abs().max())
        assert err <= BWD_TOL * float(w.abs().max()), (name, err)


def test_one_tf32_product_misses_the_tolerance():
    """Why the operands are split: with a single TF32 product (10-bit
    operands) the same passes miss 1e-4 of max |plain| by far."""
    got, want = _case(1, 1, 300, 1, 512, True,
                      mm=lambda a, b: tf32(a) @ tf32(b))
    rel = max(float((g.double() - w).abs().max() / w.abs().max())
              for g, w in zip(got, want))
    assert rel > 10 * BWD_TOL


def test_plan_bwd_fills_the_card_at_the_training_shape():
    """xLSTM-350M's training step: B=1, S=4096, nh=4, hd=512."""
    p = plan_bwd(1, 4096, 4, 512)
    assert p["launches"] == 4 and p["chunks"] == 64
    assert p["blocks"] == {"weight": 1024, "state": 256, "grad": 3072,
                           "gate": 256}
    assert p["threads"] == {"weight": 128, "state": 256, "grad": 256,
                            "gate": 64}
    assert min(p["blocks"][k] for k in ("weight", "state", "grad")) >= \
        H100_SMS
    # as the head note of csrc/mlstm_chunk_bwd.cu states it
    assert p["workspace_bytes"] == 278_258_688


@pytest.mark.parametrize("B,S,nh,hd", [(1, 1, 1, 32), (2, 300, 2, 256),
                                       (1, 65, 4, 96)])
def test_plan_bwd_of_ragged_and_narrow_shapes(B, S, nh, hd):
    p = plan_bwd(B, S, nh, hd)
    nc, nsl, nt = -(-S // L), -(-hd // 128), -(-hd // 64)
    assert p["chunks"] == nc
    assert p["blocks"]["weight"] == B * nh * nc * L // 16
    assert p["blocks"]["state"] == B * nh * nt * nt
    assert p["blocks"]["grad"] == B * nh * nc * 3 * nsl
    # no gradient leaves the last chunk, so only the others' dC' is kept
    assert p["workspace"]["dC"] == B * nh * (nc - 1) * hd * hd
