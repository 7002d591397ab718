"""The port's disaggregated engine on the CPU: KV handoff through the ring,
continuous batching with per-slot positions, the controller, and the tokens
it generates against an isolated decode and against the JAX engine on the
same weights.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.serving.engine import DisaggEngine as JaxEngine  # noqa: E402
from repro.training.checkpoint import _flatten  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.controller import ControllerConfig  # noqa: E402
from repro_torch.models import LM  # noqa: E402
from repro_torch.serving.engine import DisaggEngine  # noqa: E402
from repro_torch.serving.ring import KVRing  # noqa: E402

ARCHS = ["qwen1_5_4b", "llama31_8b", "starcoder2_15b", "chameleon_34b",
         "recurrentgemma_2b", "xlstm_350m"]
# the reduced hybrid with pattern (rec, rec, attn) over 5 layers: two
# unstacked "rest" rec layers, whose cache leaves take the batch on dim 0
HYBRID_REST = "recurrentgemma_2b+rest"
# Steps whose top-2 logit gap is at most the logit tolerance of
# test_torch_model.py may flip between the two packages' argmax.
MARGIN_TOL = 1e-4


def _prompts(cfg, lengths, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, int(n)).astype(np.int32)
            for n in lengths]


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_serves_all_requests(arch):
    cfg = get_config(arch).reduced()
    eng = DisaggEngine(cfg, n_prefill=1, n_decode=1, max_len=80,
                       decode_slots=3, device="cpu")
    for p in _prompts(cfg, [16] * 5):
        eng.submit(p, 8, 0.0)
    s = eng.run()
    assert s.n_finished == 5
    assert all(len(r.generated) == 8 for r in eng.finished)
    assert len(eng.prefill_walls) == 5 and eng.decode_walls


def _single_request_tokens(lm, params, prompt, n, max_len):
    cache = lm.init_cache(1, max_len, dtype=torch.float32, device="cpu")
    lg, cache = lm.prefill(params, {"tokens": torch.from_numpy(prompt)[None]},
                           cache)
    toks = [int(torch.argmax(lg[0]))]
    for _ in range(n - 1):
        lg, cache = lm.decode_step(params, torch.tensor([toks[-1]]), cache)
        toks.append(int(torch.argmax(lg[0])))
    return toks


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_tokens_match_single_request_decode(arch):
    """Continuous batching (mixed positions, slot insertion, idle slots past
    the cache) must produce exactly the tokens of an isolated decode."""
    cfg = get_config(arch).reduced()
    eng = DisaggEngine(cfg, n_prefill=1, n_decode=1, max_len=64,
                       decode_slots=3, seed=7, device="cpu")
    for p in _prompts(cfg, (12, 20, 17)):
        eng.submit(p, 8, 0.0)
    eng.run()
    lm = LM(cfg)
    for req in eng.finished:
        assert _single_request_tokens(lm, eng.params, req.tokens,
                                      len(req.generated), 64) == req.generated


def _reduced_pair(arch):
    """(JAX config, port config), reduced."""
    name = arch.split("+")[0]
    pair = (jax_config(name).reduced(), get_config(name).reduced())
    if arch == HYBRID_REST:
        pair = tuple(dataclasses.replace(c, n_layers=5,
                                         attn_pattern=("rec", "rec", "attn"))
                     for c in pair)
    return pair


@pytest.mark.parametrize("arch", ARCHS + [HYBRID_REST])
def test_engine_tokens_match_jax_engine(arch):
    """Same weights, same prompts: the port's engine generates the JAX
    engine's tokens up to the first step whose top-2 margin is within
    MARGIN_TOL (after a legitimate flip the two continuations differ)."""
    jcfg, cfg = _reduced_pair(arch)
    jeng = JaxEngine(jcfg, n_prefill=1, n_decode=1, max_len=64,
                     decode_slots=3, seed=7)
    eng = DisaggEngine(cfg, n_prefill=1, n_decode=1, max_len=64,
                       decode_slots=3, device="cpu")
    eng.params = params_from_numpy(_flatten(jeng.params), cfg, "cpu")
    for p in _prompts(cfg, (12, 20, 17, 9), seed=5):
        jeng.submit(p, 10, 0.0)
        eng.submit(p, 10, 0.0)
    jeng.run()
    eng.run()
    ours = {r.rec.rid: r.generated for r in eng.finished}
    decode = jax.jit(jeng.lm.decode_step)
    compared = total = 0
    for jreq in jeng.finished:
        # margins of the JAX model along the JAX engine's own tokens
        cache = jeng.lm.init_cache(1, 64, dtype=jnp.float32)
        lg, cache = jeng._prefill(jeng.params,
                                  jnp.asarray(jreq.tokens)[None], cache)
        margins = []
        for i, tok in enumerate(jreq.generated):
            top2 = np.sort(np.asarray(lg[0]))[-2:]
            margins.append(float(top2[1] - top2[0]))
            if i + 1 < len(jreq.generated):
                lg, cache = decode(jeng.params, jnp.asarray([tok]), cache)
        n = next((i for i, m in enumerate(margins) if m <= MARGIN_TOL),
                 len(margins))
        assert ours[jreq.rec.rid][:n] == jreq.generated[:n]
        compared += n
        total += len(margins)
    print(f"compared {compared} of {total} steps")
    assert compared >= total // 2, (compared, total)


def test_engine_with_controller_respects_budget():
    cfg = get_config("qwen1_5_4b").reduced()
    ctrl = ControllerConfig(ttft_slo=0.01, tpot_slo=0.001, cooldown_s=0.1,
                            power_cooldown_s=0.02, allow_power=True,
                            allow_gpu=True)
    eng = DisaggEngine(cfg, n_prefill=2, n_decode=2, max_len=64,
                       decode_slots=3, ctrl_cfg=ctrl, device="cpu")
    for p in _prompts(cfg, [20] * 8, seed=2):
        eng.submit(p, 6, 0.0)
    s = eng.run()
    assert s.n_finished == 8
    assert sum(eng.pm.effective) <= eng.pm.budget + 1e-6


def test_ring_backpressure():
    ring = KVRing(2)
    assert ring.try_put("a") is not None
    assert ring.try_put("b") is not None
    assert ring.try_put("c") is None       # full -> backpressure
    assert ring.try_pull() == "a"          # pull frees a slot, FIFO order
    assert ring.try_put("c") is not None


def test_engine_runs_on_cuda_unless_told_otherwise():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DisaggEngine(get_config("qwen1_5_4b").reduced())
