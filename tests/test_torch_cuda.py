"""The port's CUDA kernels on the card, each held against its plain PyTorch
version on the same inputs, and the reduced model on the card against the
CPU. Imports neither JAX nor ``repro``, so it runs where the port runs:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Every test skips without a CUDA device (the kernels have no CPU mode).
Tolerances: 2e-5 in fp32, as test_kernels.py (fp32 math in another sum
order). In bf16 both sides do fp32 math and round once to bf16, so they may
differ by one bf16 step, at most 2^-7 of the value: each element must be
within 1e-3 + 1e-2 |plain|, and never more than test_kernels.py's 3e-2.
A long slot's output is ~0.05, so a lost split shows. The RG-LRU scan is
fp32 only: 1e-4, as test_kernels.py (the carry across chunks is exp of a
summed log decay where the plain version multiplies step by step). The
chunkwise mLSTM is fp32 only: 2e-4 on h, as test_kernels.py (chunks of 64
against the plain version's 256, other sum orders; h reaches ~25), 1e-5 on
the final C and n (entries below ~2) and m. 1e-4 on the logits of the
reduced models.
"""
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
]

# (B, S, W): ragged, and the serve's prefill shapes (W = lru_width 2560)
SCAN_CASES = [(2, 37, 200), (1, 5, 8), (1, 1, 3), (3, 70, 33),
              (1, 3000, 2560), (1, 129, 2560), (4, 1024, 256)]


# (B, S, nh, hd, initial state given): one chunk, ragged chunks, the
# reduced model's head, and the served model's prefill at full width
MLSTM_CASES = [(1, 1, 1, 32, False), (2, 37, 2, 64, True),
               (2, 300, 2, 256, True), (3, 256, 1, 128, False),
               (1, 520, 4, 512, True), (1, 2048, 4, 512, False)]


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
    out = flash_attention_cuda(q, k, v, causal=causal, window=window,
                               q_pos_offset=off)
    ref = flash_attention_ref(q, k, v, causal=causal, window=window,
                              q_pos_offset=off)
    torch.cuda.synchronize()
    assert flash_attention_cuda.launches == before + 1
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
    out = decode_attention_cuda(q, kc, vc, posd)   # one launch, any layout
    ref = decode_attention_ref(q, kc, vc, posd, window=window)
    torch.cuda.synchronize()
    assert decode_attention_cuda.launches == before + 1
    assert out.dtype == q.dtype and out.shape == q.shape
    assert _close(out, ref)


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


@pytest.mark.parametrize("B,S,nh,hd,given", MLSTM_CASES)
def test_mlstm_chunk_kernel_matches_plain(cuda, B, S, nh, hd, given):
    ins, state = make_inputs(cuda, B, S, nh, hd, given)
    before = mlstm_chunk_cuda.launches
    h, new = mlstm_chunk_cuda(*ins, *state)
    h_ref, new_ref = mlstm_chunk_ref(*ins, state)
    torch.cuda.synchronize()
    assert mlstm_chunk_cuda.launches == before + 1
    assert h.dtype == torch.float32 and h.shape == (B, S, nh, hd)
    assert float((h - h_ref).abs().max()) < 2e-4
    for ours, plain in zip(new, new_ref):
        assert ours.shape == plain.shape
        assert float((ours - plain).abs().max()) < 1e-5


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
    kc = _randn(cuda, (1, 16, 1, 16), "float32")
    with pytest.raises(ValueError):          # 3 query heads per KV head
        decode_attention_cuda(_randn(cuda, (1, 1, 3, 16), "float32"), kc, kc,
                              3)
    with pytest.raises(ValueError):          # 12 per KV head (10 is taken)
        decode_attention_cuda(_randn(cuda, (1, 1, 12, 16), "float32"), kc,
                              kc, 3)
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


@pytest.mark.parametrize("arch", ["llama3.1-8b", "qwen1.5-4b",
                                  "recurrentgemma-2b", "xlstm-350m"])
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
    out = {}
    for dev, p in (("cpu", params), ("cuda", params_gpu)):
        cache = lm.init_cache(2, max_len, dtype=torch.float32, device=dev)
        lg, cache = lm.prefill(p, {"tokens": toks[:, :P].to(dev)}, cache)
        steps = [lg]
        for t in range(P, S):
            lg, cache = lm.decode_step(p, toks[:, t].to(dev), cache)
            steps.append(lg)
        out[dev] = torch.stack(steps).cpu()
    assert float((out["cuda"] - out["cpu"]).abs().max()) < 1e-4
