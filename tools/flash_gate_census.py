"""How often the smoke's bf16 flash gates at gemma2's shapes are crossed.

    python3 tools/flash_gate_census.py                      # on a card
    python3 tools/flash_gate_census.py --seq 8192 --draws 8

``chip_smoke.py`` holds the bf16 flash kernel at gemma2-2b's layer shapes,
on one draw of inputs, to the exact (f64) attention: every output within
half a bf16 step of the exact value plus ``GEMMA2_BF16_DELTA``
(``exact_gate``).  It used to hold it within ``GEMMA2_BF16_ATOL`` (6e-3)
of the plain version's bf16 output; two f32 computations that sum in
different orders round an output in [1, 2) to neighbouring bf16 numbers
now and then, 7.8e-3 apart, so whether that gate held depended on the
draw.  This script draws fresh inputs at gemma2-2b's head shape (B=2, 8
query and 4 KV heads of dim 256, soft-cap 50, causal; ``--seq`` rows, each
layer kind) and counts, per kernel and per gate, the outputs past the
limit and the draws that hold one, with the largest excess over half a
step that sets ``GEMMA2_BF16_DELTA``:

* ``wgmma``: the bf16 tensor-core kernel, as the main path runs it;
* ``ffma_f32``: the f32 FFMA kernel on the same inputs in f32, its output
  rounded to bf16 (another f32 computation, summed in another order).

Rows 0..S-1 of a causal case see the same keys at any longer S, so the
default ``--seq 256`` covers the rows where outputs reach 1 and more at a
small cost per draw; ``--seq 8192`` runs the smoke's gated shape itself.
Prints one JSON object per layer kind (only the global one when ``--seq``
is within the window).  ``--device cpu`` runs the plain version in the
kernels' place, as ``ops.attention`` does for a CPU tensor (the former
gate's counts are then 0).
"""
import argparse
import importlib.util
import json
import pathlib

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _smoke():
    """``chip_smoke.py`` as a module: its limit and its gemma2 settings."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def census(smoke, draws: int, seq: int, layer: int, device: str,
           seed: int = 0) -> dict:
    flash_ops, attention_ref = smoke.flash_ops, smoke.attention_ref
    cfg = smoke.get_config(smoke.ARCH)
    kw = smoke.gemma2_layer_kw(cfg, layer)
    atol = smoke.GEMMA2_BF16_ATOL
    shapes = ((smoke.PROMPT_BATCH, cfg.n_heads, seq, cfg.head_dim),
              (smoke.PROMPT_BATCH, cfg.n_kv_heads, seq, cfg.head_dim),
              (smoke.PROMPT_BATCH, cfg.n_kv_heads, seq, cfg.head_dim))
    kernels = ("wgmma", "ffma_f32")
    over = {k: [0, 0] for k in kernels}             # outputs, draws
    crossed = {k: [0, 0] for k in kernels}
    worst = {k: 0.0 for k in kernels}
    excess = {k: float("-inf") for k in kernels}
    for i in range(draws):
        g = torch.Generator(device=device).manual_seed(seed + i)
        q, k, v = (torch.randn(sh, generator=g, device=device).bfloat16()
                   for sh in shapes)
        plain = attention_ref(q, k, v, **kw).float()
        exact = smoke.exact_attention(q, k, v, rows=512, **kw)
        before = (flash_ops.TC_LAUNCHES, flash_ops.FFMA_LAUNCHES)
        outs = {"wgmma": flash_ops.attention(q, k, v, **kw),
                "ffma_f32": flash_ops.attention(
                    q.float(), k.float(), v.float(), **kw).bfloat16()}
        routed = (flash_ops.TC_LAUNCHES - before[0],
                  flash_ops.FFMA_LAUNCHES - before[1])
        if routed != ((1, 1) if device == "cuda" else (0, 0)):
            raise RuntimeError(f"(tensor-core, FFMA) launches {routed}")
        for name, o in outs.items():
            err = (o.float() - plain).abs()
            n = int((err > atol).sum())
            over[name][0] += n
            over[name][1] += n > 0
            worst[name] = max(worst[name], err.max().item())
            gate = smoke.exact_gate(o, exact)
            crossed[name][0] += gate["crossings"]
            crossed[name][1] += gate["crossings"] > 0
            excess[name] = max(excess[name],
                               gate["max_excess_over_half_step"])
        del plain, exact, outs
    return {"at": f"{smoke.ARCH} layer {layer}, {kw}, seq {seq}",
            "draws": draws, "first_seed": seed, "atol": atol,
            "delta": smoke.GEMMA2_BF16_DELTA,
            "outputs_per_draw": shapes[0][0] * shapes[0][1] * seq
            * cfg.head_dim,
            "over_atol": {name: {"outputs": n, "draws": d,
                                 "draw_rate": d / draws,
                                 "max_abs_err": worst[name]}
                          for name, (n, d) in over.items()},
            "over_exact_gate": {name: {"outputs": n, "draws": d,
                                       "draw_rate": d / draws,
                                       "max_excess_over_half_step":
                                       excess[name]}
                                for name, (n, d) in crossed.items()}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--draws", type=int, default=64)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("flash_gate_census: no CUDA device")
        return 1
    smoke = _smoke()
    # layer 1 is global; layer 0's sliding window bites only past its width
    window = smoke.get_config(smoke.ARCH).attn_window
    for layer in ((0, 1) if args.seq > window else (1,)):
        print(json.dumps(census(smoke, args.draws, args.seq, layer,
                                args.device, args.seed)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
