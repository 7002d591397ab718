"""Training launcher of the port:
``python -m repro_torch.launch.train --arch <id> --smoke [--device cpu]``.

--smoke trains the reduced config end to end from the synthetic pipeline,
on the GPU unless ``--device`` names another. The production path
(without --smoke) builds a mesh and a sharded step in the JAX package; it
is not ported yet (ROADMAP A11), so the launcher refuses it.
"""
from __future__ import annotations

import argparse


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args()
    if not args.smoke:
        raise SystemExit("only --smoke is ported; the production train step "
                         "(a mesh and a sharded step) waits for ROADMAP "
                         "item A11")

    from repro_torch.configs import get_config
    from repro_torch.training.train_loop import train
    cfg = get_config(args.arch).reduced()
    params, hist = train(cfg, steps=args.steps, batch_size=args.batch,
                         seq_len=args.seq, ckpt_path=args.ckpt,
                         device=args.device)
    print(f"[train] {cfg.name}: loss {hist[0]:.3f} -> {hist[-1]:.3f}")


if __name__ == "__main__":
    main()
