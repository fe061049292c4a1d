"""Where the card's bf16 unembedding departs from the CPU's, over many draws.

    python3 tools/unembed_card_census.py [--draws 200]   # on a machine with a card

``DenseLM.unembed`` is the bf16 final RMSNorm and then the f32 product of
the bf16 values (``torch.mm(…, out_dtype=float32)`` on the card).  For
mamba2-smoke's weights (seed 0) and ``--draws`` inputs x (2, 5, d_model)
drawn from the card's generator seeded with the draw's index, the script
counts, apart:

* the bf16 norm outputs that differ between the card and the CPU;
* the logits of one and the same normed input (the CPU's) further than
  ``1e-5 + 1e-5·|want|`` from the CPU's f32 product, with
  ``torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction``
  as PyTorch sets it (on) and off;
* the same for the whole ``unembed`` (norm and product on each device).

It prints one JSON line.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import init_params  # noqa: E402
from repro_torch.models.layers import rmsnorm  # noqa: E402


def over(got: torch.Tensor, want: torch.Tensor) -> tuple:
    """(elements past 1e-5 + 1e-5·|want|, the largest |got - want|)."""
    err = (got.double() - want.double()).abs()
    return (int((err > 1e-5 + 1e-5 * want.double().abs()).sum()),
            float(err.max()))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--draws", type=int, default=200)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("unembed_card_census: no CUDA device", file=sys.stderr)
        return 1
    cuda = torch.device("cuda", 0)
    cfg = get_config("mamba2-130m", smoke=True)
    model = init_params(cfg, 0, device=cuda)
    cpu = init_params(cfg, 0, device=cuda).to("cpu")
    flag = torch.backends.cuda.matmul
    default = flag.allow_bf16_reduced_precision_reduction
    out = {"draws": args.draws, "norm_differ": 0, "norm_total": 0,
           "reduced_precision_default": default}
    for setting in (default, not default):
        flag.allow_bf16_reduced_precision_reduction = setting
        key = "reduced_on" if setting else "reduced_off"
        stats = {"product_over": 0, "product_max_err": 0.0,
                 "unembed_over": 0, "unembed_max_err": 0.0,
                 "draws_failing": 0}
        for i in range(args.draws):
            gen = torch.Generator(device=cuda).manual_seed(i)
            x = torch.randn((2, 5, cfg.d_model), generator=gen,
                            device=cuda).bfloat16()
            h_card = rmsnorm(model.final_norm, x, cfg.rms_eps)
            h_cpu = rmsnorm(cpu.final_norm, x.cpu(), cfg.rms_eps)
            if setting == default:
                out["norm_differ"] += int((h_card.cpu() != h_cpu).sum())
                out["norm_total"] += h_cpu.numel()
            n_p, e_p = over(model.logits(h_cpu.to(cuda)).cpu(),
                            cpu.logits(h_cpu))
            n_u, e_u = over(model.unembed(x).cpu(), cpu.unembed(x.cpu()))
            stats["product_over"] += n_p
            stats["unembed_over"] += n_u
            stats["product_max_err"] = max(stats["product_max_err"], e_p)
            stats["unembed_max_err"] = max(stats["unembed_max_err"], e_u)
            stats["draws_failing"] += bool(n_p or n_u)
        out[key] = stats
    flag.allow_bf16_reduced_precision_reduction = default
    out["device"] = torch.cuda.get_device_name(0)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
