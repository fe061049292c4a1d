"""The narrow matmul kernel of two trees of this repo, in turns, on one card.

    python3 tools/narrow_ab.py PARENT_DIR                  # on a card
    python3 tools/narrow_ab.py PARENT_DIR CHANGE_DIR --rounds 2

Each run is one process started in one tree: it builds that tree's matmul
library (the seconds the build took; 0 when the tree had built it
already), reads the narrow kernel's registers from the compiler's output,
then runs ``ops.matmul`` on the narrow route at the FFNN train step's
a1·W2 shape, f32 (10000 x 100000) @ (100000 x N), for N = 10 (the train
path's) and 17 and 32.  Each product is held to the f64 product on its
first 1000 rows within the f32 limit (rtol 1e-4 at this K, atol
1e-5·√K) and timed with CUDA events over back-to-back calls, beside
``torch.matmul`` on the same operands.  The runs go parent, change,
change, parent (``--rounds`` times), so the two trees are compared on one
card, under one power limit, in alternation.

Prints the card's name and power limit, one JSON object per run, and,
last, the medians per tree.  CHANGE_DIR defaults to this tree.  A run
whose product misses the limit fails this script.
"""
import argparse
import json
import pathlib
import statistics
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
COLS = (10, 17, 32)

RUN = """
import json, math, re, sys, torch
sys.path.insert(0, "src")
from repro_torch.kernels import build
from repro_torch.kernels.matmul import ops
cols = %r
seconds = build.build("matmul")
lines = build.BUILD_LOGS.get("matmul", "").splitlines()
regs = {}
for i, line in enumerate(lines):
    if "Compiling entry function" in line and "matmul_narrow_kernel" in line:
        name = re.search(r"matmul_narrow_kernelILi(\\d+)E", line).group(1)
        used = next(l for l in lines[i + 1:] if "Used" in l and "registers" in l)
        spill = next(l for l in lines[i + 1:] if "spill stores" in l)
        regs[name] = used.split(":", 1)[1].strip() + "; " + spill.strip()
dev = torch.device("cuda", 0)
torch.backends.cuda.matmul.allow_tf32 = False
g = torch.Generator(device=dev).manual_seed(0)
m, k = 10000, 100000
a = torch.randn((m, k), generator=g, device=dev)
exact_a = a[:1000].double()
out = {"build_s": seconds, "ptxas": regs}

def timed(fn, iters=20):
    for _ in range(2):
        fn()
    torch.cuda.synchronize(dev)
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(iters):
        fn()
    e.record()
    e.synchronize()
    return s.elapsed_time(e) / iters

for n in cols:
    b = torch.randn((k, n), generator=g, device=dev)
    launches = ops.NARROW_LAUNCHES
    got = ops.matmul(a, b, impl="kernel")
    torch.cuda.synchronize(dev)
    if ops.NARROW_LAUNCHES != launches + 1:
        raise SystemExit(f"N {n}: not on the narrow kernel")
    want = exact_a @ b.double()
    err = (got[:1000].double() - want).abs()
    if bool((err > 1e-5 * math.sqrt(k) + 1e-4 * want.abs()).any()):
        raise SystemExit(f"N {n}: max |err| {err.max().item()} over the limit")
    out[f"n{n}_ms"] = timed(lambda: ops.matmul(a, b, impl="kernel"))
    out[f"n{n}_torch_matmul_ms"] = timed(lambda: torch.matmul(a, b))
    out[f"n{n}_max_abs_err_vs_f64"] = err.max().item()
print("NARROW_AB " + json.dumps(out))
"""


def run_once(tree: pathlib.Path) -> dict:
    proc = subprocess.run([sys.executable, "-c", RUN % (COLS,)], cwd=tree,
                          capture_output=True, text=True)
    if proc.returncode != 0:
        sys.stderr.write(proc.stdout[-4000:] + proc.stderr[-4000:])
        raise SystemExit(f"narrow_ab: the run in {tree} failed "
                         f"(exit {proc.returncode})")
    for line in proc.stdout.splitlines():
        if line.startswith("NARROW_AB "):
            return json.loads(line[len("NARROW_AB "):])
    raise SystemExit(f"narrow_ab: no result from {tree}")


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
    keys = [f"n{n}_{what}" for n in COLS for what in ("ms", "torch_matmul_ms")]
    print(json.dumps({"medians": {
        name: {key: statistics.median(r[key] for r in rows) for key in keys}
        for name, rows in runs.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
