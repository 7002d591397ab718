"""The launch plan of flash attention's backward (``plan_bwd``) and the
wrapper logic around L, on the CPU.

``plan_bwd`` is what the wrapper launches by: the grids of the bf16 route's
dQ and dK/dV kernels (and of the pass that sums the query-head shares where
the keys make fewer than two 64-key tiles for each of the H100's 132 SMs),
the device kernels a call launches and the fp32 workspace of the shares.
The kernels themselves run on the card (tests/test_torch_cuda.py); here
the plan is held to what csrc/flash_attention_bwd.cu makes of it, and the
autograd function is checked to ask the forward for L exactly when a
gradient is wanted.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.flash_attention import kernel  # noqa: E402
from repro_torch.kernels.flash_attention.kernel import (  # noqa: E402
    FlashAttention, flash_attention_bwd_cuda, plan_bwd)

SMS = 132
# (B, Sq, Skv, Hq, K, hd): Llama-3.1-8B's and RecurrentGemma-2B's training
# shapes, Whisper's cross-attention and one query row a slot, G = 16, and
# the small cases of the card tests
SHAPES = [(1, 4096, 4096, 32, 8, 128), (1, 4096, 4096, 10, 1, 256),
          (1, 448, 1500, 20, 20, 64), (8, 1, 1500, 20, 20, 64),
          (1, 1000, 1000, 128, 8, 128), (1, 1000, 1000, 16, 4, 128),
          (2, 37, 37, 4, 2, 16), (1, 200, 200, 2, 1, 256),
          (1, 70, 70, 6, 3, 8), (2, 5, 29, 8, 2, 16)]


@pytest.mark.parametrize("shape", [(1, 4096, 4096, 32, 8, 128),
                                   (1, 4096, 4096, 10, 1, 256)])
def test_plan_bwd_fills_the_card_at_the_training_shapes(shape):
    """Both launches have at least one block an SM at Llama's (K = 8, no
    split: 32 blocks of 128 keys x 8) and RecurrentGemma's (K = 1, G = 10,
    split: 64 blocks of 64 keys x 5 shares) training shapes."""
    p = plan_bwd(*shape)
    dq = p["grids"]["dq"]
    assert dq[0] * dq[1] * dq[2] >= SMS
    assert p["grids"]["dkdv"][0] >= SMS


def test_plan_bwd_at_the_training_shapes():
    """Llama's 64 key tiles x 8 KV heads need no split (256 blocks of 128
    keys); RecurrentGemma's 64 x 1 take 5 shares of 2 query heads (64 x 5
    = 320 blocks of 64 keys, past 2 x 132) and a 42 MB workspace."""
    llama = plan_bwd(1, 4096, 4096, 32, 8, 128)
    assert llama["shares"] == 1 and llama["launches"] == 2
    assert llama["grids"] == {"dq": (32, 32, 1), "dkdv": (256,)}
    assert llama["workspace_bytes"] == 0
    rg = plan_bwd(1, 4096, 4096, 10, 1, 256)
    assert rg["shares"] == 5 and rg["heads_per_share"] == [2] * 5
    assert rg["launches"] == 3
    assert rg["grids"]["dq"] == (10, 64, 1)      # 64 query rows at hd 256
    assert rg["grids"]["dkdv"] == (320,)
    assert rg["workspace_bytes"] == 5 * 4096 * 256 * 8 == 41_943_040


@pytest.mark.parametrize("shape", SHAPES)
def test_plan_bwd_shares_cover_the_query_heads(shape):
    """The shares sum to G, differ by at most one head, and split only
    while (64-key tiles) x K x B is under two an SM."""
    B, Sq, Skv, Hq, K, hd = shape
    p = plan_bwd(*shape)
    G = Hq // K
    heads = p["heads_per_share"]
    assert len(heads) == p["shares"] and sum(heads) == G
    assert max(heads) - min(heads) <= 1 and min(heads) >= 1
    base = -(-Skv // 64) * K * B
    assert (p["shares"] > 1) == (base < 2 * SMS and G > 1)
    if p["shares"] > 1:
        assert p["shares"] == min(G, -(-2 * SMS // base))


@pytest.mark.parametrize("shape", SHAPES)
def test_plan_bwd_workspace_and_launches(shape):
    """The workspace is shares x B x Skv x K x hd x 8 bytes (fp32 dK and
    dV of each share) when split and 0 when not; a call launches the dQ
    and dK/dV kernels, and the sum of the shares when split, each grid as
    the kernels index it (the sum: four elements a thread, 256 a block)."""
    B, Sq, Skv, Hq, K, hd = shape
    p = plan_bwd(*shape)
    split = p["shares"] > 1
    assert p["workspace_bytes"] == (
        p["shares"] * B * Skv * K * hd * 8 if split else 0)
    assert p["launches"] == len(p["grids"]) == 2 + split
    bq = keys = 64 if hd > 128 else 128
    assert p["grids"]["dq"] == (Hq, -(-Sq // bq), B)
    assert p["grids"]["dkdv"] == (-(-Skv // keys) * K * p["shares"] * B,)
    if split:
        (blocks,) = p["grids"]["reduce"]
        n = B * Skv * K * hd
        assert blocks * 256 * 4 >= n > (blocks - 1) * 256 * 4


@pytest.mark.parametrize("shape", SHAPES)
def test_plan_bwd_fp32_route(shape):
    """fp32 runs three CUDA-core launches (D, dK/dV, dQ) with no split and
    no workspace."""
    B, Sq, Skv, Hq, K, hd = shape
    p = plan_bwd(*shape, dtype=torch.float32)
    assert p["launches"] == 3 and p["shares"] == 1
    assert p["workspace_bytes"] == 0
    assert p["grids"]["delta"] == (-(-B * Sq * Hq // 8),)


def test_backward_raises_without_lse():
    """The backward reads the forward's L and raises ValueError without it,
    before it looks at the device."""
    q = torch.zeros((1, 8, 4, 16))
    k = torch.zeros((1, 8, 2, 16))
    with pytest.raises(ValueError, match="logsumexp"):
        flash_attention_bwd_cuda(q, k, k, q, q, None, causal=True)


@pytest.mark.parametrize("needs_grad", [True, False])
def test_autograd_function_asks_for_lse_only_for_a_gradient(monkeypatch,
                                                            needs_grad):
    """``FlashAttention.forward`` hands the forward kernel an fp32 (B, Hq,
    Sq) buffer for L when some input needs a gradient, and none otherwise
    (serving), and saves it beside q, k, v and the output."""
    seen = []

    def forward(q, k, v, *, causal, window, q_pos_offset, lse=None):
        seen.append(lse)
        return torch.zeros_like(q)
    monkeypatch.setattr(kernel, "flash_attention_cuda", forward)
    q = torch.zeros((2, 5, 6, 8), requires_grad=needs_grad)
    k = torch.zeros((2, 7, 3, 8))
    FlashAttention.apply(q, k, k, True, None, 0)
    (lse,) = seen
    if needs_grad:
        assert lse.shape == (2, 6, 5) and lse.dtype == torch.float32
    else:
        assert lse is None
