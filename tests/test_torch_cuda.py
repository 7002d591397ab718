"""The port's CUDA kernels on the card, each held against its plain PyTorch
version on the same inputs, and the reduced model on the card against the
CPU. Imports neither JAX nor ``repro``, so it runs where the port runs:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Every test skips without a CUDA device (the kernels have no CPU mode).
Tolerances: 2e-5 in fp32, as test_kernels.py (fp32 math in another sum
order). In bf16 both sides do fp32 math and round once to bf16, so they may
differ by one bf16 step, at most 2^-7 of the value: each element must be
within 1e-3 + 1e-2 |plain|, and never more than test_kernels.py's 3e-2 (the
tensor-core flash kernel feeds P to its bf16 products as two bf16 halves,
so its weights keep ~16 bits, as the plain version's fp32 ones).
A long slot's output is ~0.05, so a lost split shows. The backwards:
flash attention's dq, dk and dv within 1e-4 · max |plain| in fp32 and
2e-2 · max |plain| in bf16 (the plain backward in fp32 from the same bf16
inputs, its own L; the kernels read the forward kernel's L, which is held
within 1e-5 · max(1, |L|) of the plain L), the RG-LRU scan's within
1e-4 · max |plain|, the chunkwise mLSTM's (dq, dk, dv, dlog_i, dlog_f)
within 1e-4 · max |plain| of the plain backward evaluated in fp64; a reduced model's gradients on the card
within 1e-4 · max(1, max |g_cpu|) of the CPU's.
The RG-LRU scan is fp32 only: 1e-4, as test_kernels.py (the carry across chunks is exp of a
summed log decay where the plain version multiplies step by step). The
chunkwise mLSTM is fp32 only: 2e-4 on h, as test_kernels.py (chunks of 64
against the plain version's 256, products in split TF32, other sum orders;
h reaches ~25), 1e-5 on the final C and n (entries below ~2) and m, against
the plain version evaluated in fp64 (h divides by a denominator that can
cancel, and the plain version's own fp32 rounding on the card reaches
2.7e-4 at the served prefill's shape). 1e-4 on the logits and on the
loss of the reduced models.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.decode_attention.kernel import decode_attention_cuda  # noqa: E402
from repro_torch.kernels.decode_attention.ref import decode_attention_ref  # noqa: E402
from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda  # noqa: E402
from repro_torch.kernels.flash_attention.ref import flash_attention_ref  # noqa: E402
from repro_torch.kernels.mlstm_chunk.kernel import mlstm_chunk_cuda  # noqa: E402
from repro_torch.kernels.mlstm_chunk.ref import make_inputs, mlstm_chunk_ref  # noqa: E402
from repro_torch.kernels.rglru_scan.kernel import rglru_scan_cuda  # noqa: E402
from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref  # noqa: E402

FP32_TOL = 2e-5


def _close(out, ref) -> bool:
    d = (out.float() - ref.float()).abs()
    if out.dtype == torch.float32:
        return float(d.max()) < FP32_TOL
    lim = (1e-3 + 1e-2 * ref.float().abs()).clamp(max=3e-2)
    return bool((d <= lim).all())

# (B, Sq, Skv, Hq, K, hd, causal, window, q_pos_offset)
FLASH_CASES = [
    (2, 37, 37, 4, 2, 16, True, None, 0),      # ragged, GQA
    (1, 45, 45, 4, 4, 32, True, 8, 0),         # sliding window
    (2, 5, 29, 8, 2, 16, True, None, 24),      # query tail at an offset
    (1, 7, 19, 4, 1, 16, False, None, 0),      # not causal
    (1, 70, 70, 6, 3, 8, True, 33, 0),         # window across tiles
    (1, 200, 200, 2, 1, 256, True, None, 0),   # the widest head
    (1, 1000, 1000, 32, 8, 128, True, None, 0),  # llama3.1-8b, ragged prompt
    (1, 1000, 1000, 32, 8, 128, True, 100, 0),
    (1, 3000, 3000, 10, 1, 256, True, 2048, 0),  # recurrentgemma-2b
    (2, 300, 300, 10, 1, 256, True, 64, 0),
    # the edges of the bf16 tensor-core kernel's tiles (64 query rows per
    # warpgroup, 64 keys per tile, 64-column head-dim slabs)
    (1, 63, 63, 4, 2, 64, True, None, 0),
    (1, 64, 64, 4, 2, 64, True, None, 0),
    (1, 65, 65, 4, 2, 64, True, None, 0),
    (1, 127, 127, 4, 2, 64, True, None, 0),
    (1, 128, 128, 4, 2, 64, True, None, 0),
    (1, 129, 129, 4, 2, 64, True, None, 0),
    (2, 200, 200, 8, 2, 128, True, None, 0),    # the map's batch coordinate
    (1, 300, 300, 10, 1, 256, True, 100, 0),    # window edge inside a tile
    (1, 100, 700, 8, 2, 128, True, None, 600),  # query tail at an offset
    (1, 50, 90, 4, 4, 64, False, 20, 40),       # offset window, not causal
    # starcoder2-15b (48 query heads over 4, G = 12) and llama3-405b (128
    # over 8, G = 16)
    (1, 1500, 1500, 48, 4, 128, True, None, 0),
    (1, 1000, 1000, 128, 8, 128, True, None, 0),
    # whisper-large-v3 (20 over 20 heads, G = 1, hd 64): the encoder over
    # its 1500 frames, and cross-attention at decode, one query row of the
    # 128-row tile over the 1500 frames for each of 8 slots
    (1, 1500, 1500, 20, 20, 64, False, None, 0),
    (8, 1, 1500, 20, 20, 64, False, None, 0),
]

# (B, Sc, Hq, K, hd, pos, window): pos an int or a per-slot list
DECODE_CASES = [
    (2, 32, 4, 2, 16, 13, None),               # scalar pos
    (4, 32, 8, 2, 16, [0, 5, 31, 40], None),   # per-slot, one idle past Sc
    (4, 8, 4, 4, 16, [3, 7, 8, 20], 8),        # rotating window
    (2, 8, 4, 1, 16, 19, 8),                   # rotating, scalar pos
    (3, 300, 16, 2, 8, [299, 128, 1000], None),  # several 128-row splits
    (8, 2048, 32, 8, 128, [0, 1, 127, 128, 1000, 2046, 2047, 5000], None),
    (8, 2048, 32, 8, 128, [0, 1, 127, 128, 1000, 2046, 2047, 5000], 2048),
    # recurrentgemma-2b: 10 query heads over one KV head, hd 256, the
    # rotating window cache before and after it wraps
    (8, 2048, 10, 1, 256, [0, 1, 127, 128, 1000, 2047, 2048, 3500], 2048),
    (8, 2048, 10, 1, 256, [5, 300, 700, 1023, 1024, 1500, 2046, 2047], None),
    # slots with one or two keys, where bf16(P) alone would lose the limit
    (8, 2048, 32, 8, 128, [0, 1, 1, 0, 1, 0, 0, 1], None),
    (8, 2048, 10, 1, 256, [1, 0, 0, 1, 0, 1, 1, 0], 2048),
    # G = 5 (llama4-maverick, 40 over 8) and G = 12 (starcoder2-15b, 48
    # over 4), which only padding to the 16-row tile serves in bf16
    (4, 1000, 40, 8, 128, [0, 1, 500, 2000], None),
    (4, 1000, 48, 4, 128, [1, 300, 999, 1500], 1000),
    # G = 16 (llama3-405b, 128 over 8), the largest group the bf16 kernel
    # takes, on a rotating cache
    (8, 2048, 128, 8, 128, [0, 1, 300, 1023, 1024, 2047, 2048, 3500], 2048),
    # whisper-large-v3's decoder self-attention (G = 1, hd 64) over its
    # 448-token context
    (8, 448, 20, 20, 64, [0, 1, 223, 447, 5, 100, 300, 446], None),
]

# (B, S, W): ragged, and the serve's prefill shapes (W = lru_width 2560);
# then the edges of the kernel's 32-step chunk (S = L - 1, L, L + 1,
# 2L + 1), the serve's shortest and longest prompts, a long look-back over
# narrow channels, a grid far past the card's resident blocks (the tickets'
# forward progress), and W not a multiple of the 128-channel tile
SCAN_CASES = [(2, 37, 200), (1, 5, 8), (1, 1, 3), (3, 70, 33),
              (1, 3000, 2560), (1, 129, 2560), (4, 1024, 256),
              (1, 31, 256), (1, 32, 256), (1, 33, 256), (1, 65, 256),
              (1, 206, 2560), (1, 3450, 2560), (4, 4096, 64),
              (4, 4096, 2560), (33, 200, 2561)]


# (B, S, nh, hd, initial state given): one chunk, ragged chunks, the
# reduced model's head, and the served model's prefill at full width; then
# the edges of the kernel's 64-step chunks and of the plain version's 256,
# the serve's longest prompt, a batch at full width from a given state, and
# head widths that are multiples of 32 but not of the 64-wide C tiles
MLSTM_CASES = [(1, 1, 1, 32, False), (2, 37, 2, 64, True),
               (2, 300, 2, 256, True), (3, 256, 1, 128, False),
               (1, 520, 4, 512, True), (1, 2048, 4, 512, False),
               (1, 63, 2, 64, True), (1, 64, 2, 64, False),
               (1, 65, 2, 64, True), (1, 255, 2, 64, True),
               (1, 257, 2, 64, False), (1, 2047, 4, 512, False),
               (2, 300, 4, 512, True), (2, 130, 3, 96, True),
               (1, 65, 2, 96, False)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _randn(gen, shape, dtype):
    return torch.randn(shape, generator=gen, device="cuda").to(
        getattr(torch, dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Sq,Skv,Hq,K,hd,causal,window,off", FLASH_CASES)
def test_flash_kernel_matches_plain(cuda, dtype, B, Sq, Skv, Hq, K, hd,
                                    causal, window, off):
    q = _randn(cuda, (B, Sq, Hq, hd), dtype)
    k = _randn(cuda, (B, Skv, K, hd), dtype)
    v = _randn(cuda, (B, Skv, K, hd), dtype)
    before = flash_attention_cuda.launches
    before_sm90 = flash_attention_cuda.launches_sm90
    out = flash_attention_cuda(q, k, v, causal=causal, window=window,
                               q_pos_offset=off)
    ref = flash_attention_ref(q, k, v, causal=causal, window=window,
                              q_pos_offset=off)
    torch.cuda.synchronize()
    assert flash_attention_cuda.launches == before + 1
    # bf16 takes the tensor-core kernel, fp32 the CUDA-core one
    assert flash_attention_cuda.launches_sm90 == \
        before_sm90 + (dtype == "bfloat16")
    assert out.dtype == q.dtype and out.shape == q.shape
    assert _close(out, ref)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Sc,Hq,K,hd,pos,window", DECODE_CASES)
def test_decode_kernel_matches_plain(cuda, dtype, B, Sc, Hq, K, hd, pos,
                                     window):
    q = _randn(cuda, (B, 1, Hq, hd), dtype)
    kc = _randn(cuda, (B, Sc, K, hd), dtype)
    vc = _randn(cuda, (B, Sc, K, hd), dtype)
    posd = torch.as_tensor(pos, dtype=torch.int32, device="cuda")
    before = decode_attention_cuda.launches
    before_sm90 = decode_attention_cuda.launches_sm90
    out = decode_attention_cuda(q, kc, vc, posd)   # one launch, any layout
    ref = decode_attention_ref(q, kc, vc, posd, window=window)
    torch.cuda.synchronize()
    assert decode_attention_cuda.launches == before + 1
    # bf16 takes the tensor-core kernel, fp32 the CUDA-core one
    assert decode_attention_cuda.launches_sm90 == \
        before_sm90 + (dtype == "bfloat16")
    assert out.dtype == q.dtype and out.shape == q.shape
    assert _close(out, ref)


# B2's log-sum-exp: the decode cases, and slots with no admitted row
# (pos < 0), among them the layout of a rank's rows in flash-decoding
# across ranks (models/layers.py::dist_decode_attention)
LSE_CASES = DECODE_CASES + [
    (4, 4096, 32, 8, 128, [4088, -8, 4095, 7], None),
    (8, 2048, 10, 1, 256, [0, -1, 300, 1023, 1024, 2047, -2, 3500], 2048),
]
LSE_TOL = 1e-5    # of max(1, |lse|): fp32 math on the same inputs


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Sc,Hq,K,hd,pos,window", LSE_CASES)
def test_decode_kernel_writes_lse(cuda, dtype, B, Sc, Hq, K, hd, pos,
                                  window):
    """Both routes write the lse within 1e-5 max(1, |lse|) of the plain
    version's, -inf where pos < 0, and the output bitwise equal to the
    call without it."""
    q = _randn(cuda, (B, 1, Hq, hd), dtype)
    kc = _randn(cuda, (B, Sc, K, hd), dtype)
    vc = _randn(cuda, (B, Sc, K, hd), dtype)
    posd = torch.as_tensor(pos, dtype=torch.int32, device="cuda")
    lse = torch.full((B, Hq), float("nan"), device="cuda")
    before = decode_attention_cuda.launches_lse
    out = decode_attention_cuda(q, kc, vc, posd, lse=lse)
    plain = decode_attention_cuda(q, kc, vc, posd)
    _, ref = decode_attention_ref(q, kc, vc, posd, window=window,
                                  return_lse=True)
    torch.cuda.synchronize()
    assert decode_attention_cuda.launches_lse == before + 1
    assert torch.equal(out, plain)
    empty = (posd.expand(B) < 0)[:, None].expand(B, Hq)
    assert torch.isneginf(lse[empty]).all() and torch.isneginf(ref[empty]).all()
    err = (lse - ref)[~empty].abs() / ref[~empty].abs().clamp(min=1.0)
    assert float(err.max()) < LSE_TOL


@pytest.mark.parametrize("B,S,W", SCAN_CASES)
def test_rglru_scan_kernel_matches_plain(cuda, B, S, W):
    la = -torch.rand((B, S, W), generator=cuda, device="cuda") * 0.5
    x = torch.randn((B, S, W), generator=cuda, device="cuda")
    h0 = torch.randn((B, W), generator=cuda, device="cuda")
    before = rglru_scan_cuda.launches
    out = rglru_scan_cuda(la, x, h0)
    ref = rglru_scan_ref(la, x, h0)
    torch.cuda.synchronize()
    assert rglru_scan_cuda.launches == before + 1
    assert out.dtype == torch.float32 and out.shape == (B, S, W)
    assert float((out - ref).abs().max()) < 1e-4


def _model_gates(gen, B, S, W):
    """log_a and x as the model feeds the scan (models/rglru.py
    ``_lru_gates``): log_a = 8 r log(u), u ~ U[0.9, 0.999] (the lam init's
    range), r ~ U(0, 1); x = sqrt(1 - exp(2 log_a)) times a normal draw."""
    u = 0.9 + 0.099 * torch.rand((B, S, W), generator=gen, device="cuda")
    r = torch.rand((B, S, W), generator=gen, device="cuda")
    la = 8.0 * r * torch.log(u)
    z = torch.randn((B, S, W), generator=gen, device="cuda")
    x = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * la), min=1e-12)) * z
    return la, x


@pytest.mark.parametrize("B,S,W", [(1, 3000, 2560), (1, 206, 2560),
                                   (2, 37, 200)])
def test_rglru_scan_kernel_matches_plain_on_model_gates(cuda, B, S, W):
    la, x = _model_gates(cuda, B, S, W)
    h0 = torch.randn((B, W), generator=cuda, device="cuda")
    out = rglru_scan_cuda(la, x, h0)
    ref = rglru_scan_ref(la, x, h0)
    torch.cuda.synchronize()
    assert float((out - ref).abs().max()) < 1e-4


def test_rglru_scan_kernel_reads_no_stale_record(cuda):
    """Calls in a row on one workspace, each on new inputs: two of one
    shape, then a longer S; every output matches its own plain version, so
    no call took a record an earlier one left."""
    from repro_torch.kernels.rglru_scan.kernel import (KERNEL_CHUNK,
                                                       _entry)
    assert _entry()[0].rglru_scan_chunk() == KERNEL_CHUNK
    outs = []
    for S in (1000, 1000, 2100):
        la = -torch.rand((2, S, 384), generator=cuda, device="cuda") * 0.5
        x = torch.randn((2, S, 384), generator=cuda, device="cuda")
        h0 = torch.randn((2, 384), generator=cuda, device="cuda")
        outs.append((rglru_scan_cuda(la, x, h0), rglru_scan_ref(la, x, h0)))
    torch.cuda.synchronize()
    for out, ref in outs:
        assert float((out - ref).abs().max()) < 1e-4


@pytest.mark.parametrize("B,S,W", [(1, 3000, 2560), (2, 37, 200),
                                   (1, 1, 3)])
def test_rglru_scan_refuses_a_short_workspace(cuda, B, S, W):
    """The library counts the workspace it needs and its entry launches
    nothing, with an error, on a buffer one float short; on one of the
    counted size it matches the plain version."""
    from repro_torch.kernels import build
    from repro_torch.kernels.rglru_scan.kernel import _entry
    lib, fn = _entry()
    need = lib.rglru_scan_workspace_floats(B, S, W)
    chunks = -(-S // lib.rglru_scan_chunk())
    assert need == 4 + 4 * B * chunks * W
    assert lib.rglru_scan_workspace_floats(B, 0, W) == -1
    la = -torch.rand((B, S, W), generator=cuda, device="cuda") * 0.5
    x = torch.randn((B, S, W), generator=cuda, device="cuda")
    h0 = torch.randn((B, W), generator=cuda, device="cuda")
    out = torch.full_like(x, float("nan"))
    ws = torch.zeros(need, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    ptrs = [t.data_ptr() for t in (la, x, h0, out, ws)]
    err = fn(*ptrs, need - 1, 1, B, S, W, stream)
    assert err != 0
    with pytest.raises(RuntimeError):
        build.raise_on_error(lib, "rglru_scan_fwd", err)
    torch.cuda.synchronize()
    assert bool(torch.isnan(out).all())       # nothing was launched
    assert fn(*ptrs, need, 1, B, S, W, stream) == 0
    torch.cuda.synchronize()
    assert float((out - rglru_scan_ref(la, x, h0)).abs().max()) < 1e-4


@pytest.mark.parametrize("B,S,nh,hd,given", MLSTM_CASES)
def test_mlstm_chunk_kernel_matches_plain(cuda, B, S, nh, hd, given):
    ins, state = make_inputs(cuda, B, S, nh, hd, given)
    before = mlstm_chunk_cuda.launches
    h, new = mlstm_chunk_cuda(*ins, *state)
    # the plain version evaluated in fp64: its fp32 rounding on the card
    # reaches 2.7e-4 by itself at the served prefill's shape
    h_ref, new_ref = mlstm_chunk_ref(*(t.double() for t in ins),
                                     tuple(t.double() for t in state))
    torch.cuda.synchronize()
    assert mlstm_chunk_cuda.launches == before + 1
    assert h.dtype == torch.float32 and h.shape == (B, S, nh, hd)
    assert float((h.double() - h_ref).abs().max()) < 2e-4
    for ours, plain in zip(new, new_ref):
        assert ours.shape == plain.shape
        assert float((ours.double() - plain).abs().max()) < 1e-5


def test_mlstm_chunk_kernel_takes_4_byte_aligned_operands(cuda):
    """The kernel moves q, k, v and C in 16-byte pieces; the wrapper copies
    an operand that starts 4 bytes past that first, and the result is the
    same."""
    ins, state = make_inputs(cuda, 1, 300, 2, 64, True)

    def shifted(t):   # the same values, 4 bytes into a larger buffer
        buf = torch.empty(t.numel() + 1, device="cuda")
        out = buf[1:].view(t.shape)
        out.copy_(t)
        assert out.is_contiguous() and out.data_ptr() % 16
        return out
    q, k, v, li, lf = ins
    h, new = mlstm_chunk_cuda(shifted(q), shifted(k), shifted(v), li, lf,
                              shifted(state[0]), *state[1:])
    h_ref, new_ref = mlstm_chunk_cuda(*ins, *state)
    torch.cuda.synchronize()
    assert torch.equal(h, h_ref)
    for ours, theirs in zip(new, new_ref):
        assert torch.equal(ours, theirs)


@pytest.mark.parametrize("B,S,nh,hd", [(1, 2048, 4, 512), (2, 300, 2, 96),
                                        (1, 1, 1, 32)])
def test_mlstm_chunk_refuses_a_short_workspace(cuda, B, S, nh, hd):
    """The library counts the workspace it needs (as ``plan`` does) and its
    entry launches nothing, with an error, on a buffer one float short."""
    from repro_torch.kernels import build
    from repro_torch.kernels.mlstm_chunk.kernel import _entry, plan
    lib, fn = _entry()
    need = lib.mlstm_chunk_workspace_floats(B, S, nh, hd)
    assert 4 * need == plan(B, S, nh, hd)["workspace_bytes"]
    assert lib.mlstm_chunk_workspace_floats(B, S, nh, 48) == -1
    ins, state = make_inputs(cuda, B, S, nh, hd, True)
    outs = (torch.empty_like(ins[0]), *(torch.empty_like(t) for t in state))
    ws = torch.empty(need, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    ptrs = [t.data_ptr() for t in (*ins, *state, *outs, ws)]
    err = fn(*ptrs, need - 1, B, S, nh, hd, stream)
    assert err != 0
    with pytest.raises(RuntimeError):
        build.raise_on_error(lib, "mlstm_chunk_fwd", err)
    assert fn(*ptrs, need, B, S, nh, hd, stream) == 0
    torch.cuda.synchronize()
    h_ref, _ = mlstm_chunk_cuda(*ins, *state)
    assert torch.equal(outs[0], h_ref)


def test_kernels_reject_what_they_do_not_take(cuda):
    q = _randn(cuda, (1, 8, 4, 16), "float32")
    k = _randn(cuda, (1, 8, 2, 16), "float32")
    with pytest.raises(ValueError):          # a row with no key
        flash_attention_cuda(q, k, k, causal=True, q_pos_offset=-1)
    with pytest.raises(ValueError):          # not contiguous
        flash_attention_cuda(q.transpose(1, 2).contiguous().transpose(1, 2),
                             k, k, causal=True)
    with pytest.raises(TypeError):           # mixed dtypes
        flash_attention_cuda(q, k.bfloat16(), k.bfloat16(), causal=True)
    with pytest.raises(TypeError):           # a dtype the kernels lack
        flash_attention_cuda(q.half(), k.half(), k.half(), causal=True)
    wide = _randn(cuda, (1, 4, 1, 260), "float32")
    with pytest.raises(ValueError):          # head_dim above 256
        flash_attention_cuda(wide, wide, wide, causal=True)
    odd = _randn(cuda, (1, 4, 1, 12), "bfloat16")
    with pytest.raises(ValueError):          # bf16 needs a multiple of 8
        flash_attention_cuda(odd, odd, odd, causal=True)
    kc = _randn(cuda, (1, 16, 1, 16), "float32")
    with pytest.raises(ValueError):          # 3 query heads per KV head
        decode_attention_cuda(_randn(cuda, (1, 1, 3, 16), "float32"), kc, kc,
                              3)
    with pytest.raises(ValueError):          # 17 per KV head (16 is taken)
        decode_attention_cuda(_randn(cuda, (1, 1, 17, 16), "float32"), kc,
                              kc, 3)
    kb = kc.bfloat16()
    with pytest.raises(ValueError):          # 17 in bf16 too
        decode_attention_cuda(_randn(cuda, (1, 1, 17, 16), "bfloat16"), kb,
                              kb, 3)
    with pytest.raises(ValueError):          # bf16 needs a multiple of 8
        decode_attention_cuda(odd[:, :1].contiguous(), odd, odd, 3)
    la = _randn(cuda, (1, 6, 8), "float32")
    h0 = _randn(cuda, (1, 8), "float32")
    with pytest.raises(TypeError):           # the scan is fp32 only
        rglru_scan_cuda(la.bfloat16(), la.bfloat16(), h0.bfloat16())
    with pytest.raises(ValueError):          # h0 of another width
        rglru_scan_cuda(la, la, h0[:, :4].contiguous())
    with pytest.raises(ValueError):          # not contiguous
        rglru_scan_cuda(la.transpose(1, 2).contiguous().transpose(1, 2), la,
                        h0)
    with pytest.raises(ValueError):          # a CPU operand
        rglru_scan_cuda(la, la, h0.cpu())
    ins, state = make_inputs(cuda, 1, 8, 2, 64, True)
    q, k, v, li, lf = ins
    with pytest.raises(ValueError):          # gates as strided slices
        mlstm_chunk_cuda(q, k, v, torch.cat([li, lf], -1)[..., :2], lf,
                         *state)
    with pytest.raises(ValueError):          # hd not a multiple of 32
        mlstm_chunk_cuda(q[..., :48].contiguous(), k[..., :48].contiguous(),
                         v[..., :48].contiguous(), li, lf,
                         state[0][..., :48, :48].contiguous(),
                         state[1][..., :48].contiguous(), state[2])
    with pytest.raises(ValueError):          # a state of another width
        mlstm_chunk_cuda(q, k, v, li, lf, state[0][..., :32].contiguous(),
                         *state[1:])
    with pytest.raises(TypeError):           # the kernel is fp32 only
        mlstm_chunk_cuda(*(t.bfloat16() for t in ins),
                         *(t.bfloat16() for t in state))


def _to_cuda(tree):
    if isinstance(tree, dict):
        return {k: _to_cuda(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_to_cuda(v) for v in tree)
    return tree.cuda()


REDUCED_ARCHS = ["llama3.1-8b", "qwen1.5-4b", "starcoder2-15b",
                 "chameleon-34b", "granite-3-8b", "phi3.5-moe-42b-a6.6b",
                 "llama4-maverick-400b-a17b", "whisper-large-v3",
                 "recurrentgemma-2b", "xlstm-350m"]


def _frames(cfg, B):
    """The encoder-decoder's frame embeddings for a batch of B, else
    nothing."""
    if not cfg.is_encoder_decoder:
        return {}
    gen = torch.Generator().manual_seed(2)
    return {"enc_feats": 0.5 * torch.randn(
        (B, cfg.encoder_seq, cfg.d_model), generator=gen)}


@pytest.mark.parametrize("arch", REDUCED_ARCHS)
def test_reduced_model_on_card_matches_cpu(cuda, arch):
    from repro_torch.configs import get_config
    from repro_torch.models import LM
    cfg = get_config(arch).reduced()
    lm = LM(cfg)
    params = lm.init(torch.Generator().manual_seed(0), device="cpu")
    params_gpu = _to_cuda(params)
    # the hybrid prefills 20 tokens and decodes past its window of 32; the
    # xLSTM prefills past the plain version's 256-step chunk
    P, S, max_len = {"hybrid": (20, 40, 64), "ssm": (300, 310, 0)}.get(
        cfg.family, (15, 19, 24))
    toks = torch.randint(0, cfg.vocab_size, (2, S),
                         generator=torch.Generator().manual_seed(1))
    frames = _frames(cfg, 2)
    out = {}
    for dev, p in (("cpu", params), ("cuda", params_gpu)):
        cache = lm.init_cache(2, max_len, dtype=torch.float32, device=dev)
        batch = {k: v.to(dev) for k, v in frames.items()}
        lg, cache = lm.prefill(p, {**batch, "tokens": toks[:, :P].to(dev)},
                               cache)
        steps = [lg]
        for t in range(P, S):
            lg, cache = lm.decode_step(p, toks[:, t].to(dev), cache)
            steps.append(lg)
        out[dev] = torch.stack(steps).cpu()
    assert float((out["cuda"] - out["cpu"]).abs().max()) < 1e-4


@pytest.mark.parametrize("arch", REDUCED_ARCHS)
def test_reduced_model_loss_on_card_matches_cpu(cuda, arch):
    """``LM.loss`` (the logits of ``forward_train`` through the kernels on
    the card, the plain versions on the CPU) with some labels masked."""
    from repro_torch.configs import get_config
    from repro_torch.models import LM
    cfg = get_config(arch).reduced()
    lm = LM(cfg)
    params = lm.init(torch.Generator().manual_seed(0), device="cpu")
    S = 300 if cfg.family == "ssm" else 40
    toks = torch.randint(0, cfg.vocab_size, (2, S),
                         generator=torch.Generator().manual_seed(1))
    labels = toks.roll(-1, dims=1)
    labels[:, -1] = -1
    labels[0, 5:12] = -1
    batch = {"tokens": toks, "labels": labels, **_frames(cfg, 2)}
    loss = {dev: float(lm.loss(p, {k: v.to(dev) for k, v in batch.items()}))
            for dev, p in (("cpu", params), ("cuda", _to_cuda(params)))}
    assert abs(loss["cuda"] - loss["cpu"]) < 1e-4


def _requires_grad(tree):
    if isinstance(tree, dict):
        return {k: _requires_grad(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_requires_grad(v) for v in tree)
    return tree.requires_grad_() if tree.is_floating_point() else tree


def _loss_grads(lm, params, batch, device):
    """``LM.loss`` (remat on) and its gradients on ``device``, keyed by
    leaf path."""
    from repro_torch.models.params import flatten, unflatten
    leaves = {k: v.detach().to(device).requires_grad_()
              for k, v in flatten(params).items()}
    loss = lm.loss(unflatten(leaves), {k: v.to(device)
                                       for k, v in batch.items()})
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return float(loss.detach()), {k: g.cpu() for k, g in zip(leaves, grads)}


def _check_card_grads(arch):
    """The reduced model's loss and every gradient leaf on the card (B1, B3
    and B4 forward and backward kernels) against the CPU's (autograd through
    the plain versions): 1e-4 on the loss, 1e-4 · max(1, max |g_cpu|) on a
    leaf. The xLSTM's batch is 300 tokens, past the plain version's
    256-step chunk."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_bwd_cuda)
    from repro_torch.kernels.mlstm_chunk.kernel import mlstm_chunk_bwd_cuda
    from repro_torch.models import LM
    cfg = get_config(arch).reduced()
    lm = LM(cfg)
    params = lm.init(torch.Generator().manual_seed(0), device="cpu")
    S = 300 if cfg.family == "ssm" else 40
    toks = torch.randint(0, cfg.vocab_size, (2, S),
                         generator=torch.Generator().manual_seed(1))
    labels = toks.roll(-1, dims=1)
    labels[:, -1] = -1
    batch = {"tokens": toks, "labels": labels, **_frames(cfg, 2)}
    bwd = mlstm_chunk_bwd_cuda if cfg.family == "ssm" else \
        flash_attention_bwd_cuda
    before = bwd.launches
    loss, grads = _loss_grads(lm, params, batch, "cuda")
    assert bwd.launches > before   # the kernel ran
    cpu_loss, cpu_grads = _loss_grads(lm, params, batch, "cpu")
    assert abs(loss - cpu_loss) < 1e-4
    for key, g in cpu_grads.items():
        scale = max(1.0, float(g.abs().max()))
        assert float((grads[key] - g).abs().max()) <= 1e-4 * scale, key


def test_kernels_refuse_autograd(cuda):
    """Flash attention differentiates on the card (the Llama reduced
    model's gradients match the CPU's), through its autograd function; a
    raw wrapper called with an operand that requires grad under grad mode
    still raises, and decode attention (B2), which no training path
    differentiates, raises "no backward" rather than cut the graph."""
    _check_card_grads("llama3.1-8b")
    q = _randn(cuda, (1, 8, 4, 16), "float32").requires_grad_()
    k = _randn(cuda, (1, 8, 2, 16), "float32")
    with pytest.raises(RuntimeError, match="no backward"):
        flash_attention_cuda(q, k, k, causal=True)
    qd = _randn(cuda, (2, 1, 4, 16), "float32").requires_grad_()
    kc = _randn(cuda, (2, 32, 2, 16), "float32")
    pos = torch.tensor([3, 9], dtype=torch.int32, device="cuda")
    with pytest.raises(RuntimeError, match="no backward"):
        decode_attention_cuda(qd, kc, kc, pos)
    with torch.no_grad():                    # inference is untouched
        flash_attention_cuda(q, k, k, causal=True)
        decode_attention_cuda(qd, kc, kc, pos)


def test_loss_refuses_autograd(cuda):
    """``LM.loss`` of the reduced Chameleon (QK-norm) and of the reduced
    xLSTM, whose mLSTM layers now differentiate through B4's backward,
    give the CPU's gradients on the card; under no_grad the xLSTM's loss
    is finite. (The name is kept from when the xLSTM refused autograd.)"""
    _check_card_grads("chameleon-34b")
    _check_card_grads("xlstm-350m")
    from repro_torch.configs import get_config
    from repro_torch.models import LM
    lm = LM(get_config("xlstm-350m").reduced())
    params = lm.init(cuda, device="cuda")
    toks = torch.randint(0, lm.cfg.vocab_size, (2, 9), generator=cuda,
                         device="cuda")
    with torch.no_grad():
        assert torch.isfinite(lm.loss(params, {"tokens": toks,
                                               "labels": toks}))


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "whisper-large-v3",
                                  "phi3.5-moe-42b-a6.6b"])
def test_reduced_model_grads_on_card_match_cpu(cuda, arch):
    _check_card_grads(arch)


# (B, Sq, Skv, Hq, K, hd, causal, window, q_pos_offset): ragged shapes and
# tile edges in both dtypes (fp32 takes the CUDA-core passes, bf16 the
# wgmma ones, whose dQ blocks take 128 query rows and dK/dV blocks 128 keys
# (64 each at head_dim 256), in tiles of 64, and whose head dims pad to 64,
# 128 or 256; G = 4 at 16/4 and G = 2 at 4/2 split the query heads over
# blocks, ``plan_bwd``)
FLASH_BWD_CASES = [
    (2, 37, 37, 4, 2, 16, True, None, 0),
    (1, 45, 45, 4, 4, 32, True, 8, 0),
    (2, 5, 29, 8, 2, 16, True, None, 24),
    (1, 7, 19, 4, 1, 16, False, None, 0),
    (1, 70, 70, 6, 3, 8, True, 33, 0),
    (1, 200, 200, 2, 1, 256, True, None, 0),
    (1, 100, 700, 8, 2, 128, True, None, 600),
    (1, 50, 90, 4, 4, 64, False, 20, 40),
    (1, 129, 129, 4, 2, 96, True, None, 0),
    (1, 63, 63, 4, 2, 64, True, None, 0),
    (1, 65, 65, 4, 2, 64, True, None, 0),
    (1, 1000, 1000, 16, 4, 128, True, 256, 0),
    (8, 1, 1500, 20, 20, 64, False, None, 0),
]
# the training shapes, bf16: G = 16, llama3.1-8b and recurrentgemma-2b at
# S=4096, whisper-large-v3's cross-attention
FLASH_BWD_TRAIN_CASES = [
    (1, 1000, 1000, 128, 8, 128, True, None, 0),
    (1, 4096, 4096, 32, 8, 128, True, None, 0),
    (1, 4096, 4096, 10, 1, 256, True, 2048, 0),
    (1, 448, 1500, 20, 20, 64, False, None, 0),
]


def _bwd_inputs(gen, B, Sq, Skv, Hq, K, hd, causal, window, off, dtype):
    """q, k, v, dO, and the forward's output and L on them."""
    q = _randn(gen, (B, Sq, Hq, hd), dtype)
    k = _randn(gen, (B, Skv, K, hd), dtype)
    v = _randn(gen, (B, Skv, K, hd), dtype)
    do = _randn(gen, (B, Sq, Hq, hd), dtype)
    mask = dict(causal=causal, window=window, q_pos_offset=off)
    lse = torch.empty((B, Hq, Sq), dtype=torch.float32, device="cuda")
    with torch.no_grad():
        o = flash_attention_cuda(q, k, v, lse=lse, **mask)
    return q, k, v, do, o, lse, mask


@pytest.mark.parametrize(
    "B,Sq,Skv,Hq,K,hd,causal,window,off,dtype",
    [c + (d,) for c in FLASH_BWD_CASES for d in ("float32", "bfloat16")] +
    [c + ("bfloat16",) for c in FLASH_BWD_TRAIN_CASES])
def test_flash_backward_kernel_matches_plain(cuda, B, Sq, Skv, Hq, K, hd,
                                             causal, window, off, dtype):
    """dq, dk and dv, through L from the forward kernel, against
    ``flash_attention_bwd_ref`` (fp32 math from the same inputs, its own
    L): within 1e-4 · max |plain| in fp32, 2e-2 · max |plain| in bf16 (P
    and dS enter the tensor-core products rounded to bf16, and the results
    are rounded once more)."""
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_bwd_cuda)
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_bwd_ref)
    q, k, v, do, o, lse, mask = _bwd_inputs(cuda, B, Sq, Skv, Hq, K, hd,
                                            causal, window, off, dtype)
    before = flash_attention_bwd_cuda.launches
    got = flash_attention_bwd_cuda(q, k, v, o, do, lse, **mask)
    want = flash_attention_bwd_ref(q, k, v, o, do, **mask)
    torch.cuda.synchronize()
    assert flash_attention_bwd_cuda.launches == before + 1
    tol = 1e-4 if dtype == "float32" else 2e-2
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        scale = float(w.float().abs().max())
        assert float((g.float() - w.float()).abs().max()) <= tol * scale


@pytest.mark.parametrize("B,S,W", [(2, 37, 200), (1, 1, 3), (3, 70, 33),
                                   (1, 4096, 2560), (33, 200, 2561)])
def test_rglru_scan_backward_matches_plain(cuda, B, S, W):
    """d log_a, dx and dh0 of the backward kernel against
    ``rglru_scan_bwd_ref``, within 1e-4 · max |plain|; the autograd
    function counts its backward launches apart from the forward's."""
    from repro_torch.kernels.rglru_scan.kernel import (RGLRUScan,
                                                       rglru_scan_bwd_cuda)
    from repro_torch.kernels.rglru_scan.ref import rglru_scan_bwd_ref
    la, x = _model_gates(cuda, B, S, W)
    h0 = torch.randn((B, W), generator=cuda, device="cuda")
    dy = torch.randn((B, S, W), generator=cuda, device="cuda")
    la, x, h0 = (t.requires_grad_() for t in (la, x, h0))
    fwd, bwd = rglru_scan_cuda.launches, rglru_scan_bwd_cuda.launches
    y = RGLRUScan.apply(la, x, h0)
    got = torch.autograd.grad(y, (la, x, h0), dy)
    want = rglru_scan_bwd_ref(la.detach(), h0.detach(), y.detach(), dy)
    torch.cuda.synchronize()
    assert (rglru_scan_cuda.launches, rglru_scan_bwd_cuda.launches) == \
        (fwd + 1, bwd + 1)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert float((g - w).abs().max()) <= 1e-4 * float(w.abs().max())


def _scan_bwd_inputs(gen, B, S, W):
    la, x = _model_gates(gen, B, S, W)
    h0 = torch.randn((B, W), generator=gen, device="cuda")
    dy = torch.randn((B, S, W), generator=gen, device="cuda")
    return la, x, h0, dy


def _bwd_close(got, want) -> bool:
    return all(float((g - w).abs().max()) <= 1e-4 * float(w.abs().max())
               for g, w in zip(got, want))


@pytest.mark.parametrize("streams", [1, 2])
def test_rglru_scan_fwd_and_bwd_interleaved(cuda, streams):
    """Forwards and backwards of several shapes in turns, on one stream or
    on two (each with its own workspace), without a synchronise between
    them: every output matches its plain version, so no call read a
    record another call left in the shared workspace."""
    from repro_torch.kernels.rglru_scan.kernel import rglru_scan_bwd_cuda
    from repro_torch.kernels.rglru_scan.ref import rglru_scan_bwd_ref
    pool = [torch.cuda.current_stream()] + \
        [torch.cuda.Stream() for _ in range(streams - 1)]
    cases = [_scan_bwd_inputs(cuda, B, S, W)
             for B, S, W in ((1, 1000, 384), (2, 300, 384), (1, 2100, 384),
                             (3, 33, 129))]
    torch.cuda.synchronize()
    outs = []
    for i, (la, x, h0, dy) in enumerate(cases * 2):
        stream = pool[i % streams]
        with torch.cuda.stream(stream):
            y = rglru_scan_cuda(la, x, h0)
            outs.append((la, x, h0, dy, y, rglru_scan_bwd_cuda(la, h0, y, dy)))
    torch.cuda.synchronize()
    for la, x, h0, dy, y, got in outs:
        assert float((y - rglru_scan_ref(la, x, h0)).abs().max()) < 1e-4
        assert _bwd_close(got, rglru_scan_bwd_ref(la, h0, y, dy))


def test_rglru_scan_backward_leaves_the_forward_count(cuda):
    """A backward call adds one to its own count and none to the
    forward's."""
    from repro_torch.kernels.rglru_scan.kernel import rglru_scan_bwd_cuda
    la, x, h0, dy = _scan_bwd_inputs(cuda, 2, 100, 256)
    y = rglru_scan_cuda(la, x, h0)
    fwd, bwd = rglru_scan_cuda.launches, rglru_scan_bwd_cuda.launches
    rglru_scan_bwd_cuda(la, h0, y, dy)
    assert (rglru_scan_cuda.launches, rglru_scan_bwd_cuda.launches) == \
        (fwd, bwd + 1)


def test_rglru_scan_backward_rejects_what_it_does_not_take(cuda):
    """The backward takes (B, S, W) log_a, y, dy of one shape and a
    (B, W) h0, contiguous fp32 on one device; its C entry launches nothing
    on a workspace one float short or off its 16-byte alignment, and
    matches the plain version on the counted one."""
    from repro_torch.kernels import build
    from repro_torch.kernels.rglru_scan.kernel import (_bwd_entry,
                                                       rglru_scan_bwd_cuda)
    from repro_torch.kernels.rglru_scan.ref import rglru_scan_bwd_ref
    B, S, W = 2, 70, 200
    la, x, h0, dy = _scan_bwd_inputs(cuda, B, S, W)
    y = rglru_scan_cuda(la, x, h0)
    with pytest.raises(ValueError):          # dy of another length
        rglru_scan_bwd_cuda(la, h0, y, dy[:, :-1].contiguous())
    with pytest.raises(ValueError):          # h0 of another width
        rglru_scan_bwd_cuda(la, h0[:, :-1].contiguous(), y, dy)
    with pytest.raises(TypeError):           # fp16
        rglru_scan_bwd_cuda(la.half(), h0.half(), y.half(), dy.half())
    with pytest.raises(TypeError):           # one operand in bf16
        rglru_scan_bwd_cuda(la, h0, y.bfloat16(), dy)
    with pytest.raises(ValueError):          # not contiguous
        rglru_scan_bwd_cuda(la, h0, y, dy.transpose(0, 1).contiguous()
                            .transpose(0, 1))
    with pytest.raises(ValueError):          # a CPU operand
        rglru_scan_bwd_cuda(la, h0, y.cpu(), dy)
    lib, fn = _bwd_entry()
    need = lib.rglru_scan_workspace_floats(B, S, W)
    ws = torch.zeros(need + 4, device="cuda")
    outs = [torch.full_like(t, float("nan")) for t in (la, y, h0)]
    stream = torch.cuda.current_stream().cuda_stream
    ptrs = [t.data_ptr() for t in (la, h0, y, dy, *outs)]
    for ptr, floats in ((ws.data_ptr(), need - 1),
                        (ws.data_ptr() + 4, need)):
        err = fn(*ptrs, ptr, floats, 1, B, S, W, stream)
        assert err != 0
        with pytest.raises(RuntimeError):
            build.raise_on_error(lib, "rglru_scan_bwd", err)
    torch.cuda.synchronize()
    assert all(bool(torch.isnan(t).all()) for t in outs)   # no launch
    assert fn(*ptrs, ws.data_ptr(), need, 1, B, S, W, stream) == 0
    torch.cuda.synchronize()
    assert _bwd_close(outs, rglru_scan_bwd_ref(la, h0, y, dy))


def test_flash_backward_rejects_what_it_does_not_take(cuda):
    """The bf16 backward takes head dims that are multiples of 8, the fp32
    one multiples of 4; o and dO must have q's shape, L (B, Hq, Sq)."""
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_bwd_cuda)
    lse = torch.zeros((1, 4, 8), dtype=torch.float32, device="cuda")
    for dtype, hd in (("bfloat16", 12), ("float32", 6)):
        q = _randn(cuda, (1, 8, 4, hd), dtype)
        k = _randn(cuda, (1, 8, 2, hd), dtype)
        with pytest.raises(ValueError, match="head_dim"):
            flash_attention_bwd_cuda(q, k, k, q, q, lse, causal=True)
    q = _randn(cuda, (1, 8, 4, 16), "float32")
    k = _randn(cuda, (1, 8, 2, 16), "float32")
    with pytest.raises(ValueError, match="shape"):
        flash_attention_bwd_cuda(q, k, k, q[:, :4], q, lse, causal=True)
    with pytest.raises(ValueError, match="lse"):
        flash_attention_bwd_cuda(q, k, k, q, q, lse[:, :2], causal=True)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_backward_raises_without_lse(cuda, dtype):
    """The backward reads the forward's L and has no way to form it."""
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_bwd_cuda)
    q = _randn(cuda, (1, 8, 4, 16), dtype)
    k = _randn(cuda, (1, 8, 2, 16), dtype)
    with pytest.raises(ValueError, match="logsumexp"):
        flash_attention_bwd_cuda(q, k, k, q, q, None, causal=True)


@pytest.mark.parametrize("B,Sq,Skv,Hq,K,hd,causal,window,off", [
    (1, 1000, 1000, 16, 4, 128, True, 256, 0),    # split over 4 shares
    (1, 200, 200, 2, 1, 256, True, None, 0),
    (8, 1, 1500, 20, 20, 64, False, None, 0)])
def test_flash_backward_is_deterministic(cuda, B, Sq, Skv, Hq, K, hd, causal,
                                         window, off):
    """No atomics: two bf16 backward calls on the same inputs give the same
    bits."""
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_bwd_cuda)
    q, k, v, do, o, lse, mask = _bwd_inputs(cuda, B, Sq, Skv, Hq, K, hd,
                                            causal, window, off, "bfloat16")
    first = flash_attention_bwd_cuda(q, k, v, o, do, lse, **mask)
    second = flash_attention_bwd_cuda(q, k, v, o, do, lse, **mask)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Sq,Skv,Hq,K,hd,causal,window,off",
                         FLASH_BWD_CASES + FLASH_BWD_TRAIN_CASES)
def test_flash_forward_lse_matches_plain(cuda, dtype, B, Sq, Skv, Hq, K, hd,
                                         causal, window, off):
    """The forward kernel's L against the plain L (both in natural log from
    the same inputs) within 1e-5 · max(1, |L|), at every head dim: an L off
    by log2 e would pass the forward's own checks. The output with L is the
    output without it, bit for bit."""
    q = _randn(cuda, (B, Sq, Hq, hd), dtype)
    k = _randn(cuda, (B, Skv, K, hd), dtype)
    v = _randn(cuda, (B, Skv, K, hd), dtype)
    mask = dict(causal=causal, window=window, q_pos_offset=off)
    lse = torch.full((B, Hq, Sq), float("nan"), device="cuda")
    out = flash_attention_cuda(q, k, v, lse=lse, **mask)
    plain = flash_attention_ref(q, k, v, return_lse=True, **mask)[1]
    bare = flash_attention_cuda(q, k, v, **mask)
    torch.cuda.synchronize()
    assert torch.equal(out, bare)
    err = (lse - plain).abs() / plain.abs().clamp(min=1.0)
    assert float(err.max()) <= 1e-5


# the training shape, the ragged case of chip_smoke.py, one chunk, chunk
# edges, head widths that are not multiples of the 128-column slices
MLSTM_BWD_CASES = [(1, 4096, 4, 512, False), (2, 300, 2, 256, True),
                   (1, 1, 1, 32, False), (2, 37, 2, 64, True),
                   (1, 64, 2, 64, False), (1, 65, 2, 96, True),
                   (3, 130, 3, 96, True), (1, 257, 2, 160, False),
                   (1, 520, 4, 512, True)]


@pytest.mark.parametrize("B,S,nh,hd,given", MLSTM_BWD_CASES)
def test_mlstm_chunk_backward_matches_plain(cuda, B, S, nh, hd, given):
    """dq, dk, dv, dlog_i and dlog_f through ``MLSTMChunk`` against
    ``mlstm_chunk_bwd_ref`` evaluated in fp64 (at the kernel's chunk),
    each within 1e-4 · max |plain|; one forward and one backward launch."""
    from repro_torch.kernels.mlstm_chunk.kernel import (KERNEL_CHUNK,
                                                        MLSTMChunk,
                                                        mlstm_chunk_bwd_cuda)
    from repro_torch.kernels.mlstm_chunk.ref import mlstm_chunk_bwd_ref
    ins, state = make_inputs(cuda, B, S, nh, hd, given)
    dh = torch.randn(ins[0].shape, generator=cuda, device="cuda")
    ins = [t.requires_grad_() for t in ins]
    fwd, bwd = mlstm_chunk_cuda.launches, mlstm_chunk_bwd_cuda.launches
    h, *_ = MLSTMChunk.apply(*ins, *state)
    got = torch.autograd.grad(h, ins, dh)
    want = mlstm_chunk_bwd_ref(*(t.detach().double() for t in ins),
                               tuple(t.double() for t in state),
                               dh.double(), chunk=KERNEL_CHUNK)
    torch.cuda.synchronize()
    assert (mlstm_chunk_cuda.launches, mlstm_chunk_bwd_cuda.launches) == \
        (fwd + 1, bwd + 1)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        assert float((g.double() - w).abs().max()) <= \
            1e-4 * float(w.abs().max())


def test_mlstm_chunk_autograd_refuses_the_state(cuda):
    """A gradient on the state ``MLSTMChunk`` returns, or a state entering
    it that requires grad, raises rather than be dropped."""
    from repro_torch.kernels.mlstm_chunk.kernel import MLSTMChunk
    ins, state = make_inputs(cuda, 1, 70, 2, 64, True)
    ins = [t.requires_grad_() for t in ins]
    h, C, n, m = MLSTMChunk.apply(*ins, *state)
    with pytest.raises(RuntimeError, match="no gradient"):
        torch.autograd.grad(h.sum() + C.sum(), ins)
    with pytest.raises(RuntimeError, match="no gradient"):
        MLSTMChunk.apply(*ins, state[0].clone().requires_grad_(), *state[1:])


def test_mlstm_chunk_backward_takes_4_byte_aligned_operands(cuda):
    """The backward moves q, k, v, h, dh, C and the chunks' states in
    16-byte pieces; the wrapper copies an operand that starts 4 bytes past
    that first. The result is the same bits as from aligned operands, and
    two calls give the same bits (no atomics)."""
    from repro_torch.kernels.mlstm_chunk.kernel import (forward_states,
                                                        mlstm_chunk_bwd_cuda)
    B, S, nh, hd = 1, 300, 2, 64
    (q, k, v, li, lf), state = make_inputs(cuda, B, S, nh, hd, True)
    dh = torch.randn(q.shape, generator=cuda, device="cuda")
    h, _, ws = mlstm_chunk_cuda(q, k, v, li, lf, *state, keep_workspace=True)
    states = forward_states(ws, B, S, nh, hd)

    def shifted(t):   # the same values, 4 bytes into a larger buffer
        buf = torch.empty(t.numel() + 1, device="cuda")
        out = buf[1:].view(t.shape)
        out.copy_(t)
        assert out.is_contiguous() and out.data_ptr() % 16
        return out
    want = mlstm_chunk_bwd_cuda(q, k, v, li, lf, state, h, dh, states)
    again = mlstm_chunk_bwd_cuda(q, k, v, li, lf, state, h, dh, states)
    got = mlstm_chunk_bwd_cuda(
        shifted(q), shifted(k), shifted(v), li, lf,
        (shifted(state[0]), *state[1:]), shifted(h), shifted(dh),
        (shifted(states[0]), *states[1:]))
    torch.cuda.synchronize()
    for ours, other, theirs in zip(got, again, want):
        assert torch.equal(ours, theirs) and torch.equal(other, theirs)


# prefill_32k and decode_32k at Llama-3.1-8B's heads (32 over 8, hd 128),
# the launch steps' shapes: B1 at S=32768 against the plain version taken
# in blocks of 1024 query rows (the whole would need 137 GB of scores), B2
# over 32768 rows a slot
LONG = 32768


def _flash_plain_blocks(q, k, v, rows=1024):
    outs, lses = [], []
    for i in range(0, q.shape[1], rows):
        o, lse = flash_attention_ref(q[:, i:i + rows], k[:, :i + rows],
                                     v[:, :i + rows], causal=True,
                                     q_pos_offset=i, return_lse=True)
        outs.append(o)
        lses.append(lse)
    return torch.cat(outs, 1), torch.cat(lses, 2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_kernel_at_32k_rows(cuda, dtype):
    q = _randn(cuda, (1, LONG, 32, 128), dtype)
    k = _randn(cuda, (1, LONG, 8, 128), dtype)
    v = _randn(cuda, (1, LONG, 8, 128), dtype)
    lse = torch.empty((1, 32, LONG), device="cuda")
    out = flash_attention_cuda(q, k, v, causal=True, lse=lse)
    ref, ref_lse = _flash_plain_blocks(q, k, v)
    torch.cuda.synchronize()
    assert _close(out, ref)
    assert float(((lse - ref_lse).abs() / ref_lse.abs().clamp(min=1.0)
                  ).max()) <= 1e-5


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_kernel_at_32k_rows(cuda, dtype):
    pos = [32752, 32767, 32760, 16383, 0, 32000, 24575, 32766]
    q = _randn(cuda, (8, 1, 32, 128), dtype)
    kc = _randn(cuda, (8, LONG, 8, 128), dtype)
    vc = _randn(cuda, (8, LONG, 8, 128), dtype)
    posd = torch.as_tensor(pos, dtype=torch.int32, device="cuda")
    before = decode_attention_cuda.launches
    out = decode_attention_cuda(q, kc, vc, posd)
    ref = decode_attention_ref(q, kc, vc, posd)
    torch.cuda.synchronize()
    assert decode_attention_cuda.launches == before + 1
    assert _close(out, ref)
    for p in (32752, 32767):      # a scalar position, as the serve step's
        one = torch.tensor(p, dtype=torch.int32, device="cuda")
        assert _close(decode_attention_cuda(q, kc, vc, one),
                      decode_attention_ref(q, kc, vc, one))


def test_collectives_and_train_step_on_a_one_rank_mesh(cuda, tmp_path):
    """On a one-rank gloo mesh over the card: ``all_reduce``, ``entry`` and
    ``all_gather`` pass a tensor that requires grad and its gradient
    through unchanged, and ``build_train_step`` of the reduced Llama in
    fp32 (remat on) gives the losses, grad norms and parameters of the
    unsharded ``make_train_step`` on the card within 1e-5."""
    import torch.distributed as dist

    from repro_torch.configs import INPUT_SHAPES, get_config
    from repro_torch.launch.mesh import init_world, make_smoke_mesh
    from repro_torch.launch.steps import build_step, init_params, materialize
    from repro_torch.models import LM
    from repro_torch.models import sharding as SH
    from repro_torch.models.params import flatten
    from repro_torch.training.optimizer import AdamWConfig
    from repro_torch.training.train_loop import make_train_step
    init_world(rdv=f"file://{tmp_path}/rdv")
    try:
        mesh = make_smoke_mesh(device="cuda")
        with SH.use_rules(SH.standard_rules(False), mesh):
            x = torch.randn(3, 4, device="cuda", requires_grad=True)
            y = SH.all_reduce(x * 2.0, "model") + SH.entry(x, "model") + \
                SH.all_gather(x, "model", 1)
            y.sum().backward()
            assert torch.equal(x.grad, torch.full_like(x, 4.0))
        cfg = get_config("llama3.1-8b").reduced()
        shape = dataclasses.replace(INPUT_SHAPES["train_4k"],
                                    global_batch=2, seq_len=64)
        opt_cfg = AdamWConfig(state_dtype=torch.float32)
        built = build_step(cfg, mesh, shape, dtype=torch.float32,
                           opt_cfg=opt_cfg)
        gen = torch.Generator(device="cuda")
        params = init_params(cfg, built, gen.manual_seed(0), "cuda")
        ref = LM(cfg).init(gen.manual_seed(0), device="cuda")
        opt, ref_opt = (materialize(built.args[1], "cuda") for _ in "ab")
        step = make_train_step(LM(cfg), opt_cfg)
        tokens = torch.randint(0, cfg.vocab_size, (2, 65), generator=gen,
                               device="cuda", dtype=torch.int32)
        batch = {"tokens": tokens[:, :-1].contiguous(),
                 "labels": tokens[:, 1:].contiguous()}
        for _ in range(2):
            params, opt, m = built.fn(params, opt, batch)
            ref, ref_opt, want = step(ref, ref_opt, batch)
            for k in ("loss", "grad_norm", "lr"):
                assert abs(float(m[k]) - float(want[k])) <= \
                    1e-5 * max(1.0, abs(float(want[k]))), k
        for key, t in flatten(params).items():
            r = flatten(ref)[key].detach()
            assert float((t - r).abs().max()) <= \
                1e-5 * max(1.0, float(r.abs().max())), key
    finally:
        dist.destroy_process_group()
