"""How far a bf16 model's step-1 gradient moves when only the SSD scan's
rounding changes: the floor under ``chip_smoke.py``'s bf16 train gate, and
how far other correct SSDs lie from the plain one in units of it.

    python3 tools/ssd_train_floor.py [--arch mamba2-130m] [--layers 24]
        [--seq 512] [--seeds 0 1 2] [--device cpu]

``--arch`` at full width (``--layers`` of its layers), bf16, random weights
from each seed, one row of ``--seq`` tokens (batch ``seed`` of the data
config).  Step 1's gradient, the optimizer not applied, with the plain SSD
(``ssd_impl="plain"``) and with the gate's two floor witnesses
(``chip_smoke.scan_variant``: the plain scan in f64, and in chunks of half
the model's): each leaf's floor is the larger of its two distances from
the plain SSD's gradient (``chip_smoke.leaf_dists``), at least 2^-8.
Then three more correct SSDs — the f64 forward with the f32 backward, the
plain scan in chunks of a quarter, the f64 scan in chunks of half — and
each one's distance from the plain SSD's gradient in floors, at its worst
leaf: what ``SSD_TRAIN_FLOOR_FACTOR`` must clear.  On a card
(``--device cuda``) the kernels are a fourth.  It prints one JSON line a
seed.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import sys

import torch

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]

import chip_smoke  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import DataConfig, make_batch  # noqa: E402
from repro_torch.models import init_params  # noqa: E402
from repro_torch.optim import AdamWConfig, schedule  # noqa: E402
from repro_torch.runtime import make_train_step  # noqa: E402


def _stand_in(fwd, bwd, divisor: int):
    def scan(x, dt, A, Bm, Cm, chunk=256, impl="auto",
             return_final_state=False):
        c = min(chunk, x.shape[1], 128)
        return chip_smoke.PlainScan.apply(x, dt, A, Bm, Cm,
                                          max(c // divisor, 1), fwd, bwd)
    return scan


STAND_INS = {"f64_forward_f32_backward": (torch.float64, torch.float32, 1),
             "quarter_chunks": (torch.float32, torch.float32, 4),
             "f64_half_chunks": (torch.float64, torch.float64, 2)}


def one_seed(cfg, step, seq: int, seed: int, dev) -> dict:
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=seq, global_batch=1)
    batch = {k: torch.from_numpy(v.astype("int64")).to(dev)
             for k, v in make_batch(dcfg, seed).items()}
    master = {n: p.detach().float() for n, p in
              init_params(cfg, seed, device=dev).named_parameters()}
    out, ref = chip_smoke.ssd_step_grads(step, master, batch, "plain")
    runs, floor = {"plain": out}, {}
    for name in ("f64", "half"):
        runs["plain_" + name], g = chip_smoke.ssd_step_grads(
            step, master, batch, "plain", scan=chip_smoke.scan_variant(name))
        for n, d in chip_smoke.leaf_dists(g, ref).items():
            floor[n] = max(floor.get(n, 0.0), d)
    others = {k: _stand_in(*v) for k, v in STAND_INS.items()}
    if dev.type == "cuda":
        others["kernels"] = None
    worst = {}
    for name, scan in others.items():
        runs[name], g = chip_smoke.ssd_step_grads(
            step, master, batch, "auto" if scan is None else "plain",
            scan=scan)
        dist = chip_smoke.leaf_dists(g, ref)
        ratio = {n: dist[n] / max(floor[n], chip_smoke.BF16_ROUNDING)
                 for n in dist}
        worst[name] = chip_smoke.top_leaves(ratio, 1)[0]
    return {"arch": cfg.name, "layers": cfg.n_layers, "tokens": seq,
            "seed": seed, "device": str(dev), **runs,
            "floor_median": statistics.median(floor.values()),
            "floor_moved_most": chip_smoke.top_leaves(floor),
            "worst_leaf_in_floors": worst}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mamba2-130m")
    ap.add_argument("--layers", type=int, default=24)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--device", default="cpu")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    cfg = dataclasses.replace(get_config(args.arch), n_layers=args.layers)
    step = make_train_step(cfg, AdamWConfig(lr=3e-4), schedule.constant)
    for seed in args.seeds:
        print(json.dumps(one_seed(cfg, step, args.seq, seed, dev)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
