"""zamba2-7b's cut train step on two trees of this repo, in turns, on one card.

    python3 tools/zamba2_train_ab.py PARENT_DIR                  # on a card
    python3 tools/zamba2_train_ab.py PARENT_DIR CHANGE_DIR --rounds 2

Each run is one process started in one tree.  It builds that tree's flash
and SSD libraries (the seconds each build took; 0 when the tree had built
it already), then trains zamba2-7b at full width cut to 12 Mamba2 layers
(the tree's ``chip_smoke.ssm_train_run``: ``runtime.Trainer`` at batch
4 × 1024, 6 AdamW steps, the same seed and batches in both trees) with
every launch count set to 0 just before and read just after, and
profiles one more step by kernel group (the tree's ``device_profile`` and
``SSM_TRAIN_GROUPS``).  It prints ms a step (median of steps 2-6, host
clock), the device ms of the flash-backward group and of the whole step,
the busy share, the losses, and the launch counts that are not 0.  The
runs go parent, change, change, parent (``--rounds`` times), so the two
trees are compared on one card, under one power limit, in alternation.

Prints the card's name and power limit, one JSON object per run, and,
last, the medians per tree.  CHANGE_DIR defaults to this tree.  A run
whose losses are not finite fails this script.
"""
import argparse
import json
import pathlib
import statistics
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]

RUN = """
import dataclasses, json, math, statistics, sys, tempfile, torch
sys.path[:0] = ["src", "."]
import chip_smoke as c
from repro_torch.data import make_batch
from repro_torch.kernels import build
seconds = {name: build.build(name) for name in ("flash_attention", "ssd_scan")}
dev = torch.device("cuda", 0)
cfg = dataclasses.replace(c.get_config(c.HYBRID_ARCH),
                          n_layers=c.HYBRID_TRAIN_LAYERS)
with tempfile.TemporaryDirectory() as d:
    c.reset_launches()
    tr = c.ssm_train_run(cfg, c.HYBRID_TRAIN_BATCH, c.HYBRID_TRAIN_SEQ, d,
                         False)
    launches = c.read_launches()
hist = tr.history
if not all(math.isfinite(h["loss"]) for h in hist):
    raise SystemExit(f"losses {[h['loss'] for h in hist]}")
walls = [h["wall"] * 1e3 for h in hist]
batch = tr._batch(make_batch(tr.data_cfg, c.SSM_TRAIN_STEPS))
prof = c.device_profile(lambda: tr._step_fn(tr.opt_state, batch),
                        c.SSM_TRAIN_GROUPS)
out = {"build_s": seconds, "step_ms": walls,
       "ms_per_step_median_2_6": statistics.median(walls[1:]),
       "flash_backward_ms": prof["device_ms_by_group"]["flash_backward"],
       "device_ms_total": prof["device_ms_total"],
       "device_busy_share": prof["device_busy_share"],
       "profiled_wall_ms": prof["wall_ms"],
       "losses": [h["loss"] for h in hist],
       "launches": {k: v for k, v in launches.items() if v}}
print("ZAMBA2_AB " + json.dumps(out))
"""

KEYS = ("ms_per_step_median_2_6", "flash_backward_ms", "device_ms_total",
        "device_busy_share")


def run_once(tree: pathlib.Path) -> dict:
    proc = subprocess.run([sys.executable, "-c", RUN], cwd=tree,
                          capture_output=True, text=True)
    if proc.returncode != 0:
        sys.stderr.write(proc.stdout[-4000:] + proc.stderr[-4000:])
        raise SystemExit(f"zamba2_train_ab: the run in {tree} failed "
                         f"(exit {proc.returncode})")
    for line in proc.stdout.splitlines():
        if line.startswith("ZAMBA2_AB "):
            return json.loads(line[len("ZAMBA2_AB "):])
    raise SystemExit(f"zamba2_train_ab: no result from {tree}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("parent", type=pathlib.Path)
    ap.add_argument("change", type=pathlib.Path, nargs="?", default=ROOT)
    ap.add_argument("--rounds", type=int, default=1)
    args = ap.parse_args()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    trees = {"parent": args.parent.resolve(), "change": args.change.resolve()}
    runs = {"parent": [], "change": []}
    for _ in range(args.rounds):
        for name in ("parent", "change", "change", "parent"):
            row = {"tree": name, **run_once(trees[name])}
            runs[name].append(row)
            print(json.dumps(row), flush=True)
    print(json.dumps({"medians": {
        name: {key: statistics.median(r[key] for r in rows) for key in KEYS}
        for name, rows in runs.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
