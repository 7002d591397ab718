"""Gradients of the port against the JAX package on the CPU.

The plain backwards the CUDA backwards are held against on the card
(``flash_attention_bwd_ref``, also given L as the CUDA backward takes it
from the forward, ``rglru_scan_bwd_ref``), the row logsumexp L of the
plain forward (``return_lse``) against ``jax.nn.logsumexp`` of
``gqa_attention``'s own masked scores, and autograd through
the plain forwards (what the port's CPU path differentiates), against
``jax.vjp`` of the JAX functions they stand for: ``gqa_attention``, which
the JAX model differentiates where the port runs B1, and the RG-LRU
recurrence's oracle, where the port runs B3. Then ``LM.loss``'s gradients
of the dense archs, reduced, with remat on and off, against ``jax.grad`` of
the JAX ``LM.loss`` (the vlm, moe, audio, hybrid and ssm archs are in
test_torch_grad_families.py). Inputs and weights come from numpy seeds and
the JAX ``LM.init``.

Tolerances: 2e-5 on attention gradients of unit-scale inputs (fp32 sums in
other orders, and the plain backward's explicit P, dP and dS against JAX's
softmax derivative); 1e-5 on the scan's; on ``LM.loss``'s gradients
1e-4 · max(1, max |g_jax|) per leaf and 1e-5 on the loss (fp32, two layers;
the measured worst is ~1e-6 of the leaf's largest entry). Remat changes no
number on the CPU: the gradients with it on equal those with it off bit for
bit.
"""
import functools
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.kernels.rglru_scan.ref import rglru_scan_ref as jax_scan  # noqa: E402
from repro.models import LM as JaxLM  # noqa: E402
from repro.models.layers import gqa_attention  # noqa: E402
from repro.training.checkpoint import _flatten  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    flash_attention_bwd_ref, flash_attention_ref)
from repro_torch.kernels.rglru_scan.ref import (  # noqa: E402
    rglru_scan_bwd_ref, rglru_scan_ref)
from repro_torch.models import LM  # noqa: E402
from repro_torch.models.params import flatten, rebuild  # noqa: E402

ATTN_TOL = 2e-5
SCAN_TOL = 1e-5
GRAD_TOL = 1e-4
LOSS_TOL = 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: these models are small, and the suite's workers
    share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _max_err(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a, np.float64) -
                               np.asarray(b, np.float64))))


# (B, Sq, Skv, Hq, K, hd, causal, window, q_pos_offset)
ATTN_CASES = [
    (2, 37, 37, 4, 1, 16, True, None, 0),      # causal, ragged, G = 4
    (1, 45, 45, 4, 4, 32, True, 8, 0),         # window, G = 1
    (1, 7, 19, 4, 4, 16, False, None, 0),      # non-causal, Sq != Skv, G = 1
    (2, 5, 29, 8, 2, 16, True, None, 24),      # query tail at an offset
    (1, 50, 90, 4, 1, 8, False, 20, 40),       # offset window, non-causal
    (1, 70, 70, 8, 2, 24, True, 33, 0),        # window across 64-row tiles
]


def _attn_inputs(B, Sq, Skv, Hq, K, hd, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Sq, Hq, hd)).astype(np.float32)
    k = rng.standard_normal((B, Skv, K, hd)).astype(np.float32)
    v = rng.standard_normal((B, Skv, K, hd)).astype(np.float32)
    do = rng.standard_normal((B, Sq, Hq, hd)).astype(np.float32)
    return q, k, v, do


@pytest.mark.parametrize("case", ATTN_CASES)
def test_flash_attention_backward_matches_jax_vjp(case):
    """The plain backward and autograd through the plain forward, both
    against ``jax.vjp`` of ``gqa_attention``."""
    B, Sq, Skv, Hq, K, hd, causal, window, off = case
    q, k, v, do = _attn_inputs(B, Sq, Skv, Hq, K, hd)
    mask = dict(causal=causal, window=window, q_pos_offset=off)
    out, vjp = jax.vjp(lambda a, b, c: gqa_attention(a, b, c, **mask),
                       jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))

    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    o = flash_attention_ref(tq, tk, tv, **mask)
    assert _max_err(o.detach(), out) < ATTN_TOL
    autograd = torch.autograd.grad(o, (tq, tk, tv), torch.from_numpy(do))
    plain = flash_attention_bwd_ref(tq.detach(), tk.detach(), tv.detach(),
                                    o.detach(), torch.from_numpy(do), **mask)
    for name, got in (("plain backward", plain), ("autograd", autograd)):
        for g, w, what in zip(got, want, ("dq", "dk", "dv")):
            assert g.shape == w.shape
            assert _max_err(g, w) < ATTN_TOL, (name, what)


def _gqa_scores(q, k, **mask):
    """The masked, scaled scores ``gqa_attention`` hands its softmax,
    (B, K, G, Sq, Skv), caught at that call."""
    caught = []
    softmax = jax.nn.softmax

    def catch(x, axis=-1):
        caught.append(x)
        return softmax(x, axis=axis)
    v = jnp.zeros_like(jnp.asarray(k))
    with mock.patch.object(jax.nn, "softmax", catch):
        gqa_attention(jnp.asarray(q), jnp.asarray(k), v, **mask)
    (scores,) = caught
    return scores


@pytest.mark.parametrize("case", ATTN_CASES)
def test_flash_attention_lse_matches_jax_logsumexp(case):
    """The row logsumexp L that ``flash_attention_ref(return_lse=True)``
    gives (what the CUDA forwards write for the backward) against
    ``jax.nn.logsumexp`` of ``gqa_attention``'s own masked scores, (B, Hq,
    Sq) with head h = kv head h // G, group member h % G, within 2e-5."""
    B, Sq, Skv, Hq, K, hd, causal, window, off = case
    q, k, v, _ = _attn_inputs(B, Sq, Skv, Hq, K, hd)
    mask = dict(causal=causal, window=window, q_pos_offset=off)
    want = jax.nn.logsumexp(_gqa_scores(q, k, **mask), axis=-1)
    out, lse = flash_attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v), return_lse=True,
                                   **mask)
    assert out.shape == (B, Sq, Hq, hd)
    assert lse.shape == (B, Hq, Sq) and lse.dtype == torch.float32
    assert _max_err(lse, np.asarray(want).reshape(B, Hq, Sq)) < ATTN_TOL


@pytest.mark.parametrize("case", ATTN_CASES)
def test_flash_attention_backward_with_lse_matches_jax_vjp(case):
    """``flash_attention_bwd_ref`` given L from the plain forward, as the
    CUDA backward takes it from the forward kernel, against ``jax.vjp`` of
    ``gqa_attention``."""
    B, Sq, Skv, Hq, K, hd, causal, window, off = case
    q, k, v, do = _attn_inputs(B, Sq, Skv, Hq, K, hd)
    mask = dict(causal=causal, window=window, q_pos_offset=off)
    _, vjp = jax.vjp(lambda a, b, c: gqa_attention(a, b, c, **mask),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    o, lse = flash_attention_ref(tq, tk, tv, return_lse=True, **mask)
    got = flash_attention_bwd_ref(tq, tk, tv, o, tdo, lse=lse, **mask)
    for g, w, what in zip(got, want, ("dq", "dk", "dv")):
        assert g.shape == w.shape
        assert _max_err(g, w) < ATTN_TOL, what


@pytest.mark.parametrize("B,S,W", [(2, 37, 16), (1, 1, 8), (3, 64, 5)])
def test_rglru_scan_backward_matches_jax_vjp(B, S, W):
    """``rglru_scan_bwd_ref`` (the reverse scan the CUDA backward runs) and
    autograd through the plain scan against ``jax.vjp`` of the JAX oracle,
    dh0 included; the gates as the model draws them (log_a in (-8, 0))."""
    rng = np.random.default_rng(1)
    la = (8.0 * rng.uniform(size=(B, S, W)) *
          np.log(rng.uniform(0.9, 0.999, (B, S, W)))).astype(np.float32)
    x = rng.standard_normal((B, S, W)).astype(np.float32)
    h0 = rng.standard_normal((B, W)).astype(np.float32)
    dy = rng.standard_normal((B, S, W)).astype(np.float32)
    y, vjp = jax.vjp(jax_scan, jnp.asarray(la), jnp.asarray(x),
                     jnp.asarray(h0))
    want = vjp(jnp.asarray(dy))

    tla, tx, th0 = (torch.from_numpy(a).requires_grad_() for a in (la, x, h0))
    ty = rglru_scan_ref(tla, tx, th0)
    assert _max_err(ty.detach(), y) < SCAN_TOL
    autograd = torch.autograd.grad(ty, (tla, tx, th0), torch.from_numpy(dy))
    plain = rglru_scan_bwd_ref(tla.detach(), th0.detach(), ty.detach(),
                               torch.from_numpy(dy))
    for name, got in (("plain backward", plain), ("autograd", autograd)):
        for g, w, what in zip(got, want, ("dlog_a", "dx", "dh0")):
            assert g.shape == w.shape
            assert _max_err(g, w) < SCAN_TOL, (name, what)


# ---------------------------------------------------------------------------
# LM.loss gradients
# ---------------------------------------------------------------------------

def loss_batch(cfg, seed=0, B=2, S=40):
    """numpy tokens, next-token labels with some masked, and the
    encoder-decoder's frame embeddings."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels = np.roll(toks, -1, 1)
    labels[:, -1] = -1
    labels[0, 3:9] = -1
    batch = {"tokens": toks, "labels": labels}
    if cfg.is_encoder_decoder:
        batch["enc_feats"] = 0.5 * rng.standard_normal(
            (B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return batch


@functools.lru_cache(maxsize=None)
def _jax_loss_grads(arch: str, remat: bool):
    jcfg = jax_config(arch).reduced()
    jlm = JaxLM(jcfg)
    jparams = jlm.init(jax.random.key(1))
    batch = {k: jnp.asarray(v) for k, v in loss_batch(jcfg).items()}
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: jlm.loss(p, batch, remat=remat)))(jparams)
    return _flatten(jparams), float(loss), _flatten(grads)


def port_loss_grads(arch: str, flat_params, remat: bool):
    """The port's loss and {key: gradient} on the CPU, from the JAX
    package's flattened weights."""
    cfg = get_config(arch).reduced()
    params = params_from_numpy(flat_params, cfg, "cpu")
    leaves = flatten(params)
    for p in leaves.values():
        p.requires_grad_()
    batch = {k: torch.from_numpy(v) for k, v in loss_batch(cfg).items()}
    loss = LM(cfg).loss(rebuild(params, leaves.values()), batch, remat=remat)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return float(loss.detach()), dict(zip(leaves, grads))


def check_loss_grads(arch: str, remat: bool) -> None:
    flat, jloss, jgrads = _jax_loss_grads(arch, remat)
    loss, grads = port_loss_grads(arch, flat, remat)
    assert abs(loss - jloss) < LOSS_TOL
    assert sorted(grads) == sorted(jgrads)
    for key, g in grads.items():
        want = jgrads[key]
        assert tuple(g.shape) == want.shape, key
        scale = max(1.0, float(np.max(np.abs(want))))
        assert _max_err(g, want) <= GRAD_TOL * scale, key
    if remat:   # the same gradients, bit for bit, without remat
        _, plain = port_loss_grads(arch, flat, remat=False)
        for key, g in grads.items():
            assert torch.equal(g, plain[key]), key


DENSE = ["llama31_8b", "qwen1_5_4b", "granite_3_8b", "llama3_405b",
         "starcoder2_15b"]


@pytest.mark.parametrize("remat", [True, False])
@pytest.mark.parametrize("arch", DENSE)
def test_loss_grads_match_jax(arch, remat):
    check_loss_grads(arch, remat)
