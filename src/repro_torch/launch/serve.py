"""Serving launcher of the port: TraServer with continuous batching.

    PYTHONPATH=src python -m repro_torch.launch.serve --servable scorer \\
        --requests 40 --mode poisson --rate 50

Port of ``repro.launch.serve`` with the ``--servable scorer`` branch: the
§5.3 FFNN scorer served through :class:`~repro_torch.serve.server.
TraServer` (zero compile-cache misses after warmup), printing tokens/s and
p50/p95/p99 of total / queue-wait / service latency.  The flags are the
JAX launcher's, plus ``--device`` (default ``cuda``; without a card it
fails — pass ``--device cpu`` to run on the CPU).  ``--servable``
defaults to ``scorer`` here: ``--servable lm`` and
``--dense-oracle`` exit with a "not ported yet" message until the decode
(3) and model-zoo (8) slices, see ``ROADMAP.md``.
"""
from __future__ import annotations

import argparse
import json
import sys


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

    if args.dense_oracle or args.servable == "lm":
        what = "--dense-oracle" if args.dense_oracle else "--servable lm"
        print(f"[serve] {what} is not ported to repro_torch yet (see "
              f"ROADMAP.md); use --servable scorer", file=sys.stderr)
        return 2

    import numpy as np

    from repro_torch.core import Engine
    from repro_torch.serve import (FFNNScorer, TraServer, closed_loop,
                                   open_loop, poisson_arrivals, scorer_mix)

    rng = np.random.default_rng(args.seed)
    engine = Engine(executor=args.executor, device=args.device)
    servable = FFNNScorer(seed=args.seed, device=args.device)
    payloads = scorer_mix(servable, rng, args.requests)

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
