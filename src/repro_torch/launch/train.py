"""Training launcher of the port: the model zoo on one card.

    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma2-2b \\
        --steps 6 --batch 8 --seq 128
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-14b \\
        --smoke --steps 20 --device cpu

Port of ``repro.launch.train``: the same flags, plus ``--device``
(default ``cuda``; without a card it fails — pass ``--device cpu`` to run
on the CPU).  ``--mesh`` is not ported yet: it exits 2 with a "not
ported" message naming its slice (the model zoo's sharding, ROADMAP
A7.2b), as does an arch outside the ported families.  :func:`run` is
:func:`main` that also returns the trainer.
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile


def run(argv=None):
    """Parse the flags and train: ``(exit code, the Trainer or None)``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--mesh", default=None,
                    help="DxM mesh (not ported yet: ROADMAP A7.2b)")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    if args.mesh:
        print("[train] --mesh is not ported to repro_torch yet: it comes "
              "with the model zoo's sharding (ROADMAP A7.2b)",
              file=sys.stderr)
        return 2, None

    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime import Trainer, TrainerConfig

    try:
        cfg = get_config(args.arch, smoke=args.smoke)
    except NotImplementedError as exc:
        print(f"[train] {exc}", file=sys.stderr)
        return 2, None
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                      global_batch=args.batch,
                      input_mode=cfg.input_mode, d_model=cfg.d_model)
    tcfg = TrainerConfig(steps=args.steps, ckpt_every=args.ckpt_every,
                         ckpt_dir=args.ckpt_dir,
                         adamw=AdamWConfig(lr=args.lr))
    tr = Trainer(cfg, dcfg, tcfg, device=args.device)
    if args.resume:
        tr.init_or_restore()
    hist = tr.train()
    first = hist[0]["loss"] if hist else float("nan")
    last = hist[-1]["loss"] if hist else float("nan")
    print(f"[train] {args.arch} on {tr.device}: {len(hist)} steps, "
          f"loss {first:.4f} → {last:.4f}")
    if tr.monitor.flagged:
        print(f"[train] stragglers flagged: {tr.monitor.flagged}")
    return 0, tr


def main(argv=None) -> int:
    return run(argv)[0]


if __name__ == "__main__":
    sys.exit(main())
