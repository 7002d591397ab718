"""Serving launcher of the port:
``python -m repro_torch.launch.serve --arch <id> --smoke [--device cpu]``.

--smoke serves a reduced model through the real-compute disaggregated
engine (prefill worker -> ring buffer -> decode worker) with the RAPID
controller enabled, on the GPU unless ``--device`` names another. The
production serve step (without --smoke) is not ported yet (ROADMAP A11).
"""
from __future__ import annotations

import argparse

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--prefill-workers", type=int, default=1)
    ap.add_argument("--decode-workers", type=int, default=1)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args()
    if not args.smoke:
        raise SystemExit("only --smoke is ported; the production serve step "
                         "waits for ROADMAP item A11")

    from repro_torch.configs import get_config
    from repro_torch.core.controller import ControllerConfig
    from repro_torch.serving.engine import DisaggEngine
    rcfg = get_config(args.arch).reduced()
    eng = DisaggEngine(rcfg, n_prefill=args.prefill_workers,
                       n_decode=args.decode_workers, max_len=96,
                       decode_slots=4, ctrl_cfg=ControllerConfig(),
                       device=args.device)
    rng = np.random.default_rng(0)
    for _ in range(args.requests):
        eng.submit(rng.integers(0, rcfg.vocab_size, 24).astype(np.int32),
                   12, 0.0)
    s = eng.run()
    print(f"[serve] {rcfg.name} on {eng.device}: {s.n_finished}/{s.n_total} "
          f"finished  {s.row()}")


if __name__ == "__main__":
    main()
