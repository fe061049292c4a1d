"""Serving launcher of the port: TraServer with continuous batching, and the
model zoo's prefill + decode loop.

    PYTHONPATH=src python -m repro_torch.launch.serve --servable lm \\
        --arch gemma2-2b --requests 40 --mode poisson --rate 50
    PYTHONPATH=src python -m repro_torch.launch.serve --servable scorer \\
        --requests 40 --mode poisson --rate 50
    PYTHONPATH=src python -m repro_torch.launch.serve --dense-oracle \\
        --arch gemma2-2b --batch 2 --prompt-len 8192 --gen 32
    PYTHONPATH=src python -m repro_torch.launch.serve --dense-oracle \\
        --arch mamba2-130m --batch 8 --prompt-len 8192 --gen 32
    PYTHONPATH=src python -m repro_torch.launch.serve --dense-oracle \\
        --arch zamba2-7b --batch 2 --prompt-len 8192 --gen 32

Port of ``repro.launch.serve``:

* ``--servable lm`` / ``--servable scorer``: the step-decode
  ``RecurrentLM`` sized from ``--arch`` (``--capacity`` slots; prompts of 1
  to ``--prompt-len`` tokens, 1 to ``--gen`` new tokens) or the §5.3 FFNN
  scorer, served through :class:`~repro_torch.serve.server.TraServer`
  (zero compile-cache misses after warmup), printing tokens/s and
  p50/p95/p99 of total / queue-wait / service latency;
* ``--dense-oracle``: the model zoo's prefill + greedy decode loop
  (:func:`dense_generate`) over a dense-family arch (KV cache), the
  ssm family's mamba2-130m (conv and SSM state caches) or the hybrid
  family's zamba2-7b (both) (``--arch``, default ``gemma2-2b``;
  ``--smoke`` for its narrow config), printing prefill ms and decode
  tok/s.  Prompts come from a ``torch.Generator``
  seeded with ``--seed``, weights from ``init_params(cfg, --seed)``.

The flags are the JAX launcher's, plus ``--device`` (default ``cuda``;
without a card it fails — pass ``--device cpu`` to run on the CPU).
``--servable`` defaults to ``scorer`` here.  Not ported yet, each exits 2
with a "not ported" message naming its slice (``ROADMAP.md``):
``--dense-oracle`` for an arch outside the dense, ssm and hybrid families
(MoE, MLA and embedding-input archs), and ``--dense-oracle --mesh`` (the
model zoo's sharding, A7.2b).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from typing import Optional

import torch


@dataclasses.dataclass
class DenseRun:
    """What :func:`dense_generate` did: the prefill's last-position logits
    (B, 1, vocab) f32 (their argmax is the first decode step's token), the
    first decode step's logits, the greedy tokens of every decode step
    (B, gen) on the host, the seconds each phase took (host clock, device
    synchronized)."""
    prefill_logits: torch.Tensor
    first_decode_logits: Optional[torch.Tensor]
    tokens: torch.Tensor
    prefill_s: float
    decode_s: float


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def dense_generate(cfg, model, prompts: torch.Tensor, gen: int) -> DenseRun:
    """Prefill ``prompts`` (B, S) into a cache of ``S + gen`` positions,
    then ``gen`` greedy decode steps, as ``repro.launch.serve``'s
    ``--dense-oracle`` loop does."""
    from repro_torch.models import decode_step, prefill
    device = prompts.device
    with torch.inference_mode():
        t0 = time.perf_counter()
        prefill_logits, cache = prefill(cfg, model, {"tokens": prompts},
                                        prompts.shape[1] + gen)
        _sync(device)
        prefill_s = time.perf_counter() - t0
        tok = prefill_logits.argmax(-1)
        out = []
        first_logits = None
        t1 = time.perf_counter()
        for _ in range(gen):
            logits, cache = decode_step(cfg, model, cache, {"token": tok})
            if first_logits is None:
                first_logits = logits
            tok = logits.argmax(-1)
            out.append(tok.cpu())
        _sync(device)
        decode_s = time.perf_counter() - t1
    tokens = torch.cat(out, dim=1) if out else torch.zeros(
        (prompts.shape[0], 0), dtype=torch.long)
    return DenseRun(prefill_logits, first_logits, tokens, prefill_s, decode_s)


def _dense_oracle(args) -> int:
    """Model zoo prefill + decode loop (``--dense-oracle``)."""
    from repro_torch.configs import get_config
    from repro_torch.device import resolve_device
    from repro_torch.models import init_params
    if args.mesh:
        print("[serve] --dense-oracle --mesh is not ported to repro_torch "
              "yet: it comes with the model zoo's sharding (ROADMAP A7.2b)",
              file=sys.stderr)
        return 2
    try:
        cfg = get_config(args.arch, smoke=args.smoke)
    except NotImplementedError as exc:
        print(f"[serve] --dense-oracle: {exc}", file=sys.stderr)
        return 2
    device = resolve_device(args.device)
    model = init_params(cfg, args.seed, device=device)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    B, S = args.batch, args.prompt_len
    prompts = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                            device=device)
    run = dense_generate(cfg, model, prompts, args.gen)
    toks_s = B * args.gen / run.decode_s if args.gen else 0.0
    print(f"[serve] {args.arch} on {device}: prefill({B}x{S}) "
          f"{run.prefill_s * 1e3:.1f} ms, decode {args.gen} steps @ "
          f"{toks_s:.1f} tok/s")
    print(f"[serve] sample continuation (seq 0): "
          f"{run.tokens[0].tolist()}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--servable", choices=("lm", "scorer"), default="scorer")
    ap.add_argument("--arch", default="gemma2-2b",
                    help="model config sizing the LM servable / dense path")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--executor", default="jit",
                    help="TRA engine executor (reference | jit | auto)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--requests", type=int, default=40)
    ap.add_argument("--capacity", type=int, default=8,
                    help="decode slots (lm servable)")
    ap.add_argument("--mode", choices=("poisson", "closed"),
                    default="poisson")
    ap.add_argument("--rate", type=float, default=50.0,
                    help="poisson arrival rate, requests/s")
    ap.add_argument("--concurrency", type=int, default=8,
                    help="closed-loop outstanding requests")
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--max-pending", type=int, default=None,
                    help="admission bound: shed submissions over this "
                         "many pending requests (ServerOverloaded)")
    ap.add_argument("--max-queue-wait", type=float, default=None,
                    help="shed requests queued longer than this (s)")
    ap.add_argument("--deadline", type=float, default=None,
                    help="per-request deadline (s), scheduler-enforced")
    ap.add_argument("--retries", type=int, default=3,
                    help="per-request transient-fault retry budget")
    ap.add_argument("--json", action="store_true",
                    help="emit the full report as JSON")
    ap.add_argument("--dense-oracle", action="store_true",
                    help="run the dense transformer prefill/decode loop "
                         "instead of TraServer (comparison path)")
    ap.add_argument("--batch", type=int, default=4,
                    help="dense-oracle batch size")
    ap.add_argument("--mesh", default=None,
                    help="dense-oracle mesh, e.g. 2x2")
    args = ap.parse_args(argv)

    if args.dense_oracle:
        return _dense_oracle(args)

    import numpy as np

    from repro_torch.core import Engine
    from repro_torch.serve import (FFNNScorer, RecurrentLM, TraServer,
                                   closed_loop, lm_mix, open_loop,
                                   poisson_arrivals, scorer_mix)

    rng = np.random.default_rng(args.seed)
    engine = Engine(executor=args.executor, device=args.device)
    if args.servable == "scorer":
        servable = FFNNScorer(seed=args.seed, device=args.device)
        payloads = scorer_mix(servable, rng, args.requests)
    else:
        from repro_torch.configs import get_config
        cfg = get_config(args.arch, smoke=args.smoke)
        servable = RecurrentLM.from_config(cfg, capacity=args.capacity,
                                           seed=args.seed,
                                           device=args.device)
        payloads = lm_mix(servable, rng, args.requests,
                          prompt_len=(1, max(1, args.prompt_len)),
                          new_tokens=(1, max(1, args.gen)))

    server = TraServer(engine, servable,
                       max_pending=args.max_pending,
                       max_queue_wait_s=args.max_queue_wait,
                       max_retries=args.retries)
    server.warmup()
    if args.mode == "poisson":
        arrivals = poisson_arrivals(rng, args.requests, args.rate)
        report = open_loop(server, payloads, arrivals,
                           deadline_s=args.deadline)
    else:
        report = closed_loop(server, lambda i: payloads[i],
                             n_requests=args.requests,
                             concurrency=args.concurrency)

    stats = server.stats()
    out = {**report.to_json(),
           "device": str(engine.device),
           "cache_misses_since_warmup": stats["cache_misses_since_warmup"],
           "artifacts": stats["artifacts"],
           "health": stats["health"]}
    if args.json:
        print(json.dumps(out, indent=2))
    else:
        t = out["total_ms"]
        print(f"[serve] {servable.name} on {engine.executor} "
              f"({engine.device}): {report.requests} requests "
              f"({report.errors} errors, {report.shed} shed), "
              f"{out['tokens_per_s']:.1f} tok/s")
        print(f"[serve] latency ms p50/p95/p99 = "
              f"{t['p50']:.1f}/{t['p95']:.1f}/{t['p99']:.1f}; "
              f"queue-wait p50 = {out['queue_wait_ms']['p50']:.1f} ms")
        print(f"[serve] artifacts: {len(out['artifacts'])} pinned, "
              f"{out['cache_misses_since_warmup']} cache misses "
              f"after warmup")
        hc = out["health"]["counters"]
        print(f"[serve] health {out['health']['status']}: "
              f"retries={hc['retries']} recovered={hc['recovered']} "
              f"shed={hc['shed']} deadline={hc['deadline_expired']}")
    return 1 if report.errors else 0


if __name__ == "__main__":
    sys.exit(main())
