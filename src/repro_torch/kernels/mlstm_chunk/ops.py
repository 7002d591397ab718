"""Chunkwise mLSTM, dispatched by the device of its inputs: CPU tensors go
to the plain version (which autograd differentiates), CUDA tensors to the
hand-written kernels, forward and backward (which raise rather than fall
back)."""
from __future__ import annotations

from repro_torch.kernels.mlstm_chunk.kernel import MLSTMChunk
from repro_torch.kernels.mlstm_chunk.ref import mlstm_chunk_ref


def mlstm_chunk(q, k, v, log_i, log_f, state):
    """q, k, v: (B, S, nh, hd) fp32; log_i, log_f: (B, S, nh) fp32; state
    = (C (B, nh, hd, hd), n (B, nh, hd), m (B, nh)) fp32. Returns
    (h (B, S, nh, hd), (C, n, m)) fp32, the state after the last step.
    Gradients reach q, k, v and the gates through h; on the card the state
    is not differentiated (``MLSTMChunk``)."""
    if q.device.type == "cuda":
        h, *new = MLSTMChunk.apply(q, k, v, log_i, log_f, *state)
        return h, tuple(new)
    if q.device.type == "cpu":
        return mlstm_chunk_ref(q, k, v, log_i, log_f, state)
    raise ValueError(f"no mLSTM chunk scan for device {q.device}")
