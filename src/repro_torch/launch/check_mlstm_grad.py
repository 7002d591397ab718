"""B4's backward on the inputs a full-width xLSTM-350M training step gives it:
``python -m repro_torch.launch.check_mlstm_grad [--seq 2048] [--seed 0]``.

One fp32 forward and backward of ``LM.loss`` at the published widths on the
card (no remat). Each mLSTM layer's q, k, v, gates, state and h are caught
as the forward makes them, and the cotangent dh as autograd delivers it.
Then, layer by layer, the kernel's backward (``mlstm_chunk_bwd_cuda``) and
the plain backward in fp32 are held against the plain backward evaluated in
fp64: max |err| / max |g_fp64| of dq, dk, dv, dlog_i and dlog_f. max |dh|
of each layer shows how the gradient grows from the last layer to the
first. Exits non-zero if a layer's kernel error passes 1e-4 (the tolerance
of the card tests and ``chip_smoke.py``).
"""
from __future__ import annotations

import argparse
import sys

import torch

TOL = 1e-4


def _rel(got, want) -> list:
    return [float((g.double() - w).abs().max() / w.abs().max())
            for g, w in zip(got, want)]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seq", type=int, default=2048)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("check_mlstm_grad needs a CUDA device")
    from repro_torch.configs import get_config
    from repro_torch.kernels.mlstm_chunk.kernel import (KERNEL_CHUNK,
                                                        forward_states,
                                                        mlstm_chunk_bwd_cuda,
                                                        mlstm_chunk_cuda)
    from repro_torch.kernels.mlstm_chunk.ref import mlstm_chunk_bwd_ref
    from repro_torch.models import LM, xlstm
    from repro_torch.models.params import flatten, map_leaves
    from repro_torch.training.data import TokenStream
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("xlstm-350m")
    lm = LM(cfg)
    params = map_leaves(lambda t: t.requires_grad_(), lm.init(
        torch.Generator(device="cuda").manual_seed(args.seed),
        device="cuda"))
    batch = {k: torch.from_numpy(v).cuda() for k, v in
             TokenStream(cfg, seed=args.seed).batch(1, args.seq).items()}
    layers = []   # forward order: [operands, state, h, dh]
    scan = xlstm.mlstm_chunk

    def caught(q, k, v, log_i, log_f, state):
        h, new = scan(q, k, v, log_i, log_f, state)
        item = [[t.detach().clone() for t in (q, k, v, log_i, log_f)],
                tuple(t.clone() for t in state), h.detach().clone(), None]
        layers.append(item)
        h.register_hook(lambda g: item.__setitem__(3, g.detach().clone()))
        return h, new
    xlstm.mlstm_chunk = caught
    try:
        loss = lm.loss(params, batch, remat=False)
        torch.autograd.grad(loss, list(flatten(params).values()))
    finally:
        xlstm.mlstm_chunk = scan
    print(f"[check_mlstm_grad] xLSTM-350M fp32, B=1 S={args.seq}, loss "
          f"{float(loss.detach()):.6f}; {len(layers)} mLSTM layers; "
          f"{torch.cuda.get_device_name(0)}")
    worst = 0.0
    for i, (ops, state, h, dh) in enumerate(layers):
        with torch.no_grad():
            _, _, ws = mlstm_chunk_cuda(*ops, *state, keep_workspace=True)
        kern = mlstm_chunk_bwd_cuda(*ops, state, h, dh,
                                    forward_states(ws, *ops[0].shape))
        plain = mlstm_chunk_bwd_ref(*ops, state, dh)
        f64 = mlstm_chunk_bwd_ref(*(t.double() for t in ops),
                                  tuple(t.double() for t in state),
                                  dh.double(), chunk=KERNEL_CHUNK)
        rk, rp = _rel(kern, f64), _rel(plain, f64)
        worst = max(worst, *rk)
        print(f"[check_mlstm_grad] layer {i}: max |dh| "
              f"{float(dh.abs().max()):.3g}; of max |g_fp64| (dq, dk, dv, "
              f"dlog_i, dlog_f): kernel "
              f"{', '.join(f'{r:.2g}' for r in rk)}; plain fp32 "
              f"{', '.join(f'{r:.2g}' for r in rp)}")
    print(f"[check_mlstm_grad] worst kernel error {worst:.3g} of max "
          f"|g_fp64| (tol {TOL})")
    return 0 if worst <= TOL else 1


if __name__ == "__main__":
    sys.exit(main())
