"""``LM.loss``'s gradients of the reduced vlm, moe, audio, hybrid and ssm
archs (the xLSTM through the plain chunkwise mLSTM and the sLSTM's step
loop), with remat on and off, against ``jax.grad`` of the JAX
``LM.loss`` on the CPU; the dense archs and the tolerances are in
test_torch_grad.py."""
import pytest

pytest.importorskip("torch")

from test_torch_grad import _one_thread, check_loss_grads  # noqa: E402,F401

FAMILIES = ["chameleon_34b", "phi3_5_moe", "llama4_maverick",
            "whisper_large_v3", "recurrentgemma_2b", "xlstm_350m"]


@pytest.mark.parametrize("remat", [True, False])
@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_grads_match_jax(arch, remat):
    check_loss_grads(arch, remat)
