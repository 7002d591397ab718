"""RG-LRU scan, dispatched by the device of its inputs: CPU tensors go to
the plain version, CUDA tensors to the hand-written kernel (which raises
rather than fall back)."""
from __future__ import annotations

from repro_torch.kernels.rglru_scan.kernel import rglru_scan_cuda
from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref


def rglru_scan(log_a, x, h0):
    """h_t = exp(log_a_t) * h_{t-1} + x_t from h0. log_a, x: (B, S, W)
    fp32; h0: (B, W) fp32. Returns (B, S, W) fp32."""
    if x.device.type == "cuda":
        return rglru_scan_cuda(log_a, x, h0)
    if x.device.type == "cpu":
        return rglru_scan_ref(log_a, x, h0)
    raise ValueError(f"no RG-LRU scan for device {x.device}")
