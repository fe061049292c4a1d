"""The FFNN scorer served by two trees of this repo, in turns, on one card.

    python3 tools/scorer_ab.py PARENT_DIR                  # on a card
    python3 tools/scorer_ab.py PARENT_DIR CHANGE_DIR --rounds 2

Each run is one tree's own serve phase, ``chip_smoke.phase_serve``: the
scorer at speech-100k width behind ``TraServer``, warmed up, then 64
Poisson-arriving requests at 2000/s, with that tree's gates (responses
against the oracle, no cache miss after warmup, that tree's launch counts)
and its bucket-8 dispatch breakdown.  The runs go parent, change, change,
parent (``--rounds`` times), each in a fresh process started in its tree,
so the two trees are compared on one card, under one power limit, in
alternation.  A tree builds its own kernels at its first run.

Prints one JSON object per run (tree, p50 / p99 latency, requests/s, the
bucket-8 dispatch's host time, launches) and, last, the medians per tree.
CHANGE_DIR defaults to this tree.  A run that fails its tree's gates fails
this script.
"""
import argparse
import json
import pathlib
import statistics
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]

RUN = """
import json, sys, torch
sys.path.insert(0, "src")
import chip_smoke
torch.backends.cuda.matmul.allow_tf32 = False
chip_smoke.phase_serve(torch.device("cuda", 0))
"""

KEYS = ("p50_ms", "p99_ms", "requests_per_s", "dispatch_b8_host_ms",
        "service_p50_ms", "dispatches", "launches", "max_abs_err_vs_oracle")


def serve_once(tree: pathlib.Path) -> dict:
    proc = subprocess.run([sys.executable, "-c", RUN], cwd=tree,
                          capture_output=True, text=True)
    if proc.returncode != 0:
        sys.stderr.write(proc.stdout[-4000:] + proc.stderr[-4000:])
        raise SystemExit(f"scorer_ab: the serve phase of {tree} failed "
                         f"(exit {proc.returncode})")
    for line in proc.stdout.splitlines():
        if line.startswith("{") and '"phase": "serve"' in line:
            return json.loads(line)
    raise SystemExit(f"scorer_ab: no serve line from {tree}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("parent", type=pathlib.Path)
    ap.add_argument("change", type=pathlib.Path, nargs="?", default=ROOT)
    ap.add_argument("--rounds", type=int, default=1)
    args = ap.parse_args()
    trees = {"parent": args.parent.resolve(), "change": args.change.resolve()}
    runs = {"parent": [], "change": []}
    for _ in range(args.rounds):
        for name in ("parent", "change", "change", "parent"):
            out = serve_once(trees[name])
            row = {"tree": name, **{k: out.get(k) for k in KEYS}}
            runs[name].append(row)
            print(json.dumps(row), flush=True)
    print(json.dumps({"medians": {
        name: {k: statistics.median(r[k] for r in rows)
               for k in ("p50_ms", "p99_ms", "requests_per_s",
                         "dispatch_b8_host_ms")}
        for name, rows in runs.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
