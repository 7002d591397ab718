"""The arithmetic of the Hopper chunkwise mLSTM (``csrc/mlstm_chunk.cu``) on
the CPU, where the kernel cannot run.

The three passes are written out in plain torch at the kernel's chunk of
64 steps: the states entering each chunk (state pass), W once per chunk
with its denominators (weight pass), and each chunk's output from its
entering state (output pass). Every product the kernel does on the tensor
cores is formed as it forms it: each operand split into hi = tf32(x) and
lo = tf32(x - hi), with tf32 emulated as ``cvt.rna`` (the fp32 bit pattern
rounded to 10 mantissa bits, ties away from zero), and a_lo b_hi + a_hi
b_lo + a_hi b_hi summed in fp32; the gates are summed in fp64, as the
kernel sums them. The result is held against the plain chunkwise mLSTM
(``mlstm_chunk_ref``, itself held against the JAX package in
test_torch_xlstm.py), in fp32 and evaluated in fp64 as the card tests hold
the kernel, at their tolerances: 2e-4 on h (h reaches ~25), 1e-5 on the
final C, n and m. The wrapper's launch plan is checked against the card:
every pass with products runs at least 132 blocks (the H100's SMs) at the
served model's prefill.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.mlstm_chunk.kernel import KERNEL_CHUNK, plan  # noqa: E402
from repro_torch.kernels.mlstm_chunk.ref import (  # noqa: E402
    NEG,
    make_inputs,
    mlstm_chunk_ref,
)

L = KERNEL_CHUNK
H_TOL, STATE_TOL = 2e-4, 1e-5
H100_SMS = 132


def tf32(x):
    """``cvt.rna.tf32.f32`` on the fp32 bit pattern: add half of the 13
    dropped bits' unit to the magnitude, then clear them."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split_mm(a, b):
    """a @ b as the kernel forms it on mma.sync: split TF32, fp32 sums."""
    a_hi, b_hi = tf32(a), tf32(b)
    a_lo, b_lo = tf32(a - a_hi), tf32(b - b_hi)
    return a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi


def chunks(a, fill=0.0):
    """(B, S, nh, ...) -> (nc, B, nh, L, ...), S padded to whole chunks of
    the kernel's L steps with ``fill``."""
    B, S = a.shape[:2]
    nc = -(-S // L)
    a = torch.cat([a, a.new_full((B, nc * L - S, *a.shape[2:]), fill)], 1)
    return a.reshape(B, nc, L, *a.shape[2:]).movedim(3, 2).movedim(1, 0)


def state_pass(kc, vc, lic, F, state, mm=split_mm):
    """The forward's state pass over chunked k, v, log_i and the fp64 gate
    sums F: the state entering each chunk, and the state after the last."""
    FL = F[..., -1]
    C, n, m = state
    entering = []
    for c in range(kc.shape[0]):
        entering.append((C, n, m))
        log_w = (FL[c][..., None] - F[c] + lic[c]).float()
        m_FL = m.double() + FL[c]
        m_next = torch.maximum(m_FL.float(), log_w.amax(-1))
        kw = kc[c] * torch.exp(log_w - m_next[..., None])[..., None]
        scale = torch.exp((m_FL - m_next).float())
        C = C * scale[..., None, None] + mm(kw.transpose(-1, -2), vc[c])
        n = n * scale[..., None] + kw.sum(-2)
        m = m_next
    return entering, (C, n, m)


def three_passes(q, k, v, log_i, log_f, state, mm=split_mm):
    """The kernel's three passes, each product formed by ``mm``; same
    arguments and result as ``mlstm_chunk_ref``."""
    B, S, nh, hd = q.shape
    nc = -(-S // L)
    qc, kc, vc = chunks(q), chunks(k), chunks(v)
    lic, lfc = chunks(log_i, NEG), chunks(log_f)   # past S: no input, no decay
    F = torch.cumsum(lfc.double(), -1)   # gate sums in fp64, as the kernel's

    # 1. state pass: the state entering each chunk
    entering, (C, n, m) = state_pass(kc, vc, lic, F, state, mm)

    # 2. weight pass: q k^T once per chunk, W, e and the denominators
    tri = torch.tril(torch.ones((L, L), dtype=torch.bool, device=q.device))
    weights = []
    for c in range(nc):
        _, n_c, m_c = entering[c]
        D = F[c][..., :, None] - F[c][..., None, :] + lic[c][..., None, :]
        D = D.masked_fill(~tri, NEG)
        m_F = m_c[..., None].double() + F[c]
        m_row = torch.maximum(D.amax(-1), m_F).float()
        scores = mm(qc[c], kc[c].transpose(-1, -2))
        W = (scores * torch.exp(D.float() - m_row[..., None])
             ).masked_fill(~tri, 0.0)
        e = torch.exp(m_F.float() - m_row)
        qn = (qc[c] * n_c[..., None, :]).sum(-1)
        den = torch.maximum((W.sum(-1) + e * qn).abs(), torch.exp(-m_row))
        weights.append((W, e, den))

    # 3. output pass: each chunk from the state entering it
    hs = []
    for c in range(nc):
        W, e, den = weights[c]
        C_c = entering[c][0]
        hs.append((e[..., None] * mm(qc[c], C_c) + mm(W, vc[c]))
                  / den[..., None])
    h = torch.stack(hs).movedim(0, 1).movedim(2, 3).reshape(B, nc * L, nh, hd)
    return h[:, :S], (C, n, m)


def test_tf32_rounds_as_cvt_rna():
    x = torch.tensor([1.0, 1 + 2 ** -11, 1 + 3 * 2 ** -12, -(1 + 2 ** -11),
                      1 + 2 ** -12, 3.0e-5, -7.25])
    want = torch.tensor([1.0, 1 + 2 ** -10, 1 + 2 ** -10, -(1 + 2 ** -10),
                         1.0, 3.0e-5, -7.25])
    got = tf32(x)
    assert torch.equal(got[:5], want[:5])
    assert torch.equal(got[6:], want[6:])   # exact in 10 bits
    assert float((got[5] - x[5]).abs()) <= 2 ** -11 * float(x[5])
    assert not (got.view(torch.int32) & 0x1FFF).any()


@pytest.mark.parametrize("hd", [32, 512])
@pytest.mark.parametrize("S", [1, L - 1, L + 1, 300])
@pytest.mark.parametrize("given", [False, True])
def test_split_tf32_passes_match_plain(S, hd, given):
    B, nh = (2, 2) if hd == 32 else (1, 1)
    gen = torch.Generator().manual_seed(S + hd + given)
    ins, state = make_inputs(gen, B, S, nh, hd, given)
    h, new = three_passes(*ins, state)
    assert h.shape == (B, S, nh, hd)
    for dt in (torch.float32, torch.float64):
        h_ref, new_ref = mlstm_chunk_ref(*(t.to(dt) for t in ins),
                                         tuple(t.to(dt) for t in state))
        assert h_ref.dtype == dt
        assert float((h.to(dt) - h_ref).abs().max()) < H_TOL
        for ours, plain in zip(new, new_ref):
            assert ours.shape == plain.shape
            assert float((ours.to(dt) - plain).abs().max()) < STATE_TOL


def test_one_tf32_product_misses_the_tolerances():
    """Why the operands are split: with a single TF32 product (10-bit
    operands) the same passes miss both limits by far."""
    ins, state = make_inputs(torch.Generator().manual_seed(1), 1, 300, 1,
                             512, True)
    h, new = three_passes(*ins, state, mm=lambda a, b: tf32(a) @ tf32(b))
    h_ref, new_ref = mlstm_chunk_ref(*ins, state)
    assert float((h - h_ref).abs().max()) > 10 * H_TOL
    assert float((new[0] - new_ref[0]).abs().max()) > 10 * STATE_TOL


def test_plan_fills_the_card_at_the_served_prefill():
    """xLSTM-350M's prefill: B=1, S=2048, nh=4, hd=512."""
    p = plan(1, 2048, 4, 512)
    assert p["launches"] == 3 and p["chunks"] == 32
    assert p["blocks"] == {"state": 256, "weight": 512, "output": 512}
    assert min(p["blocks"].values()) >= H100_SMS
    # as the head note of csrc/mlstm_chunk.cu states it
    assert p["workspace_bytes"] == 132_440_560


@pytest.mark.parametrize("B,S,nh,hd", [(1, 1, 1, 32), (2, 65, 2, 96),
                                       (1, 64, 4, 512)])
def test_plan_of_ragged_and_narrow_shapes(B, S, nh, hd):
    p = plan(B, S, nh, hd)
    nc = -(-S // L)
    assert p["chunks"] == nc
    # chunk 0 reads the given state, so only later chunks' states are kept
    assert p["workspace"]["C"] == B * nh * (nc - 1) * hd * hd
    assert p["workspace"]["W"] == B * nh * nc * L * L
    assert p["blocks"]["state"] == B * nh * (-(-hd // 64)) ** 2
    assert p["blocks"]["output"] == B * nh * -(-S // 64) * -(-hd // 128)
