"""Chip smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py                 # on a machine with one H100

Drives the port's main path — the §5.3 FFNN scorer at the paper's
speech-100k width (1600 features, 100000 hidden units, 10 labels) served
through ``TraServer`` on the ``jit`` executor — and holds every hand-written
kernel of that path against its plain PyTorch version on the card:

1. device: the card's name and power limit (``nvidia-smi``);
2. build: compiles the CUDA source of ``src/repro_torch/kernels/matmul``;
3. kernels: ``matmul`` against ``matmul_ref`` at the shapes of the JAX
   package's kernel tests, a ragged shape and the scorer's two products,
   and the split-K reduction pass (``splitk_reduce``) against
   ``splitk_reduce_ref`` at the partial sums of the scorer's second
   product, each with kernel / plain / library times and the bound;
4. serve: 64 Poisson-arriving requests through ``TraServer`` with every
   kernel launch count set to 0 just before and read just after; each
   response is checked against the scorer's per-request oracle;
5. the kernels line, the ``nvidia-smi`` line, and the last line
   ``{"ok": true, "device": {...}}``.

Any failed check exits non-zero before the last line.  Without a CUDA
device the script exits non-zero at once.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

from repro_torch.configs.ffnn_paper import speech  # noqa: E402
from repro_torch.core.cost import H100_SXM  # noqa: E402
from repro_torch.core.plan import FusedJoinAgg, postorder  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.matmul import ops as mm_ops  # noqa: E402
from repro_torch.kernels.matmul.ref import (matmul_ref,  # noqa: E402
                                            splitk_reduce_ref)

SEED = 0
N_REQUESTS = 64
ARRIVAL_RATE = 2000.0            # requests/s, Poisson
BUCKETS = (1, 2, 4, 8)
PEAK = {torch.float32: H100_SXM.peak_flops_f32,
        torch.bfloat16: H100_SXM.peak_flops}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def timed_ms(fn, device, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls (CUDA
    events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound_times(m: int, k: int, n: int, dtype) -> tuple:
    """(bytes_ms, operations_ms) of a product on an H100 SXM (data sheet):
    each input read once and the output written once at the HBM rate,
    against the operations at the type's peak.  The bound is the larger."""
    isz = torch.tensor([], dtype=dtype).element_size()
    nbytes = (m * k + k * n + m * n) * isz
    return (nbytes / H100_SXM.hbm_bw * 1e3,
            2.0 * m * n * k / PEAK[dtype] * 1e3)


def reduce_bound_times(splits: int, m: int, n: int) -> tuple:
    """(bytes_ms, operations_ms) of the split-K reduction: the f32 partial
    sums read once and the f32 output written once; one add per partial."""
    return ((splits + 1) * m * n * 4 / H100_SXM.hbm_bw * 1e3,
            splits * m * n / PEAK[torch.float32] * 1e3)


def bound_of(t_bytes: float, t_ops: float) -> tuple:
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def tolerance(k: int, dtype) -> tuple:
    """(rtol, atol): f32 as tests/test_kernels.py (1e-5, 1e-5·√K), with rtol
    widened to 1e-4 at K >= 100000, where the kernel's split-K order and the
    library's order differ over many more terms; bf16 2e-2 (same form)."""
    if dtype == torch.bfloat16:
        return 2e-2, 2e-2 * math.sqrt(k)
    rtol = 1e-4 if k >= 100_000 else 1e-5
    return rtol, 1e-5 * math.sqrt(k)


# ---------------------------------------------------------------- phases
def phase_device(device) -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    emit({"phase": "device", "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "allow_tf32": torch.backends.cuda.matmul.allow_tf32})
    return smi


def phase_build() -> None:
    seconds = build.build("matmul")
    usage = [ln.strip() for ln in build.BUILD_LOGS.get("matmul", "")
             .splitlines() if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "library": "matmul", "seconds": seconds,
          "ptxas": usage})


def kernel_case(m, k, n, dtype, device, gen, iters) -> dict:
    a = torch.randn((m, k), generator=gen, device=device).to(dtype)
    b = torch.randn((k, n), generator=gen, device=device).to(dtype)
    out = mm_ops.matmul(a, b, impl="kernel")
    ref = matmul_ref(a, b)
    torch.cuda.synchronize(device)
    if out.shape != (m, n) or out.dtype != dtype:
        fail(f"matmul {m}x{k}x{n} {dtype}: got {tuple(out.shape)} "
             f"{out.dtype}")
    rtol, atol = tolerance(k, dtype)
    o, r = out.float(), ref.float()
    err = (o - r).abs()
    if not bool(torch.isfinite(o).all()) or bool(
            (err > atol + rtol * r.abs()).any()):
        fail(f"matmul {m}x{k}x{n} {dtype}: max |err| {err.max().item()} "
             f"over rtol={rtol} atol={atol}")
    t_bytes, t_ops = bound_times(m, k, n, dtype)
    bnd, by = bound_of(t_bytes, t_ops)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return {"m": m, "k": k, "n": n, "dtype": str(dtype).split(".")[-1],
            "max_abs_err": err.max().item(), "rtol": rtol, "atol": atol,
            "kernel_ms": timed_ms(lambda: mm_ops.matmul(a, b, impl="kernel"),
                                  device, iters),
            "plain_ms": timed_ms(lambda: matmul_ref(a, b), device, iters),
            "library_ms": timed_ms(lambda: torch.matmul(a, b), device,
                                   iters),
            "bound_ms": bnd, "bound_by": by, "bytes_ms": t_bytes,
            "operations_ms": t_ops,
            "splits": mm_ops.plan_launch(m, n, k, sms)[1]}


def reduce_case(m, k, n, device, gen, iters) -> dict:
    """The split-K reduction at the partial sums of an (m, k) @ (k, n)
    product: as many splits as the matmul takes there.  The kernel adds in
    the plain version's order, so the two agree to the bit; the check
    allows 1e-6."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    splits = mm_ops.plan_launch(m, n, k, sms)[1]
    if splits < 2:
        fail(f"splitk_reduce: {m}x{k}x{n} takes no split-K")
    partial = torch.randn((splits, m, n), generator=gen, device=device)
    out = mm_ops.splitk_reduce(partial, impl="kernel")
    ref = splitk_reduce_ref(partial)
    torch.cuda.synchronize(device)
    err = (out - ref).abs()
    if out.shape != (m, n) or not bool(torch.isfinite(out).all()) or bool(
            (err > 1e-6 + 1e-6 * ref.abs()).any()):
        fail(f"splitk_reduce {splits}x{m}x{n}: shape {tuple(out.shape)}, "
             f"max |err| {err.max().item()} over rtol=atol=1e-6")
    t_bytes, t_ops = reduce_bound_times(splits, m, n)
    bnd, by = bound_of(t_bytes, t_ops)
    return {"splits": splits, "m": m, "n": n, "of_product_k": k,
            "max_abs_err": err.max().item(), "rtol": 1e-6, "atol": 1e-6,
            "kernel_ms": timed_ms(
                lambda: mm_ops.splitk_reduce(partial, impl="kernel"),
                device, iters),
            "plain_ms": timed_ms(lambda: splitk_reduce_ref(partial), device,
                                 iters),
            "library_ms": timed_ms(lambda: partial.sum(0), device, iters),
            "bound_ms": bnd, "bound_by": by, "bytes_ms": t_bytes,
            "operations_ms": t_ops}


def phase_kernels(device, d_in, d_hidden, d_out, gen) -> tuple:
    shapes = [(128, 128, 128), (256, 512, 128), (384, 256, 640)]
    cases = [(m, k, n, dt) for m, k, n in shapes
             for dt in (torch.float32, torch.bfloat16)]
    cases += [(100, 70, 50, torch.float32), (100, 70, 50, torch.bfloat16)]
    # the scorer's two products at the smallest and largest bucket
    for b in (1, 8):
        cases += [(b, d_in, d_hidden, torch.float32),
                  (b, d_hidden, d_out, torch.float32)]
    rows = []
    for m, k, n, dt in cases:
        rows.append(kernel_case(m, k, n, dt, device, gen, iters=20))
        emit({"phase": "kernel", "name": "matmul", **rows[-1]})
    reduce_rows = []
    for b in (1, 8):
        reduce_rows.append(reduce_case(b, d_hidden, d_out, device, gen,
                                       iters=20))
        emit({"phase": "kernel", "name": "matmul_splitk_reduce",
              **reduce_rows[-1]})
    return rows, reduce_rows


def make_scorer(device):
    from repro_torch.serve import FFNNScorer
    cfg = speech(100_000)
    db, hb, lb = 4, 10, 1          # db, hb > 2: both products fuse
    return FFNNScorer(db=db, hb=hb, lb=lb, bd=cfg.d_in // db,
                      bh=cfg.d_hidden // hb, bl=cfg.d_out // lb,
                      buckets=BUCKETS, seed=SEED, device=device)


def phase_serve(device) -> dict:
    from repro_torch.core import Engine
    from repro_torch.serve import (TraServer, open_loop, poisson_arrivals,
                                   scorer_mix)
    t0 = time.perf_counter()
    scorer = make_scorer(device)
    torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t0
    engine = Engine(executor="jit", device=device)
    server = TraServer(engine, scorer)
    t0 = time.perf_counter()
    artifacts = server.warmup()
    warmup_s = time.perf_counter() - t0
    for aid, compiled in artifacts.items():
        fused = sum(isinstance(n, FusedJoinAgg)
                    for n in postorder(compiled.plan))
        if fused != 2:
            fail(f"artifact {aid}: {fused} FusedJoinAgg nodes, expected 2"
                 f"\n{compiled.describe()}")
    rng = np.random.default_rng(SEED)
    payloads = scorer_mix(scorer, rng, N_REQUESTS)
    arrivals = poisson_arrivals(rng, N_REQUESTS, ARRIVAL_RATE)

    # -- the main path: every launch count is 0 just before, read just after
    mm_ops.LAUNCHES = mm_ops.REDUCE_LAUNCHES = 0
    report = open_loop(server, payloads, arrivals)
    launches = {"matmul": mm_ops.LAUNCHES,
                "matmul_splitk_reduce": mm_ops.REDUCE_LAUNCHES}
    # ---------------------------------------------------------------------

    dispatches = sum(server.dispatches.values())
    if report.errors or report.shed:
        fail(f"serve: {report.errors} errors, {report.shed} shed")
    if server.cache_misses_since_warmup != 0:
        fail(f"serve: {server.cache_misses_since_warmup} cache misses "
             f"after warmup")
    # per dispatch: both products launch the tile kernel; the second,
    # (b x 100000) @ (100000 x 10), splits K and launches the reduction
    expected = {"matmul": 2 * dispatches,
                "matmul_splitk_reduce": dispatches}
    if launches != expected:
        fail(f"serve: launches {launches} for {dispatches} dispatches, "
             f"expected {expected}")
    worst = 0.0
    for p, r in zip(payloads, report.results):
        want = scorer.oracle(p)
        r = np.asarray(r)
        if r.shape != (scorer.d_out,) or not np.all(np.isfinite(r)):
            fail(f"serve: response of shape {r.shape} / not finite")
        worst = max(worst, float(np.max(np.abs(r - want))))
    if worst > 1e-4:
        fail(f"serve: responses differ from the oracle by {worst} > 1e-4")
    summary = report.summary
    out = {"phase": "serve", "width": [scorer.d_in, scorer.hb * scorer.bh,
                                       scorer.d_out],
           "blocking": {"db": scorer.db, "hb": scorer.hb, "lb": scorer.lb,
                        "bd": scorer.bd, "bh": scorer.bh, "bl": scorer.bl},
           "requests": report.requests, "arrival_rate_per_s": ARRIVAL_RATE,
           "requests_per_s": report.requests / summary["window_s"],
           "wall_s": report.wall_s,
           "p50_ms": summary["total_ms"]["p50"],
           "p99_ms": summary["total_ms"]["p99"],
           "queue_wait_p50_ms": summary["queue_wait_ms"]["p50"],
           "service_p50_ms": summary["service_ms"]["p50"],
           "dispatches": dispatches,
           "dispatches_by_artifact": dict(server.dispatches),
           "launches": launches, "max_abs_err_vs_oracle": worst,
           "cache_misses_since_warmup": server.cache_misses_since_warmup,
           "setup_s": setup_s, "warmup_s": warmup_s}
    out.update(dispatch_breakdown(server, scorer, device))
    emit(out)
    return out


def dispatch_breakdown(server, scorer, device) -> dict:
    """One bucket-8 dispatch timed whole (host clock, synchronized), and
    the copy that arranges the blocked W1 into the kernel's 2-D operand."""
    bucket = max(scorer.buckets)
    compiled = server.engine.compile(scorer.program(bucket))
    rng = np.random.default_rng(SEED + 1)
    inputs = {**scorer.pack([scorer.random_payload(rng)
                             for _ in range(bucket)], bucket),
              **scorer.weights()}

    def dispatch():
        compiled.run(**inputs)["scores"].data.cpu()

    for _ in range(2):
        dispatch()
    t0 = time.perf_counter()
    iters = 10
    for _ in range(iters):
        dispatch()
    host_ms = (time.perf_counter() - t0) * 1e3 / iters
    w1 = scorer.weights()["scorer.W1"].data
    db, hb, bd, bh = w1.shape
    copy_ms = timed_ms(lambda: w1.permute(0, 2, 1, 3).reshape(db * bd,
                                                             hb * bh),
                       device, iters=10)
    return {"dispatch_b8_host_ms": host_ms, "w1_permute_copy_ms": copy_ms,
            "w1_bytes": w1.numel() * w1.element_size()}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = phase_device(device)
    phase_build()
    gen = torch.Generator(device=device).manual_seed(SEED)
    cfg = speech(100_000)
    d_in, d_hidden, d_out = cfg.d_in, cfg.d_hidden, cfg.d_out
    rows, reduce_rows = phase_kernels(device, d_in, d_hidden, d_out, gen)
    serve = phase_serve(device)

    # per scorer dispatch at the largest bucket: the two products
    b = max(BUCKETS)
    per_dispatch = [r for r in rows if r["m"] == b
                    and (r["k"], r["n"]) in ((d_in, d_hidden),
                                             (d_hidden, d_out))]
    bnd, by = bound_of(sum(r["bytes_ms"] for r in per_dispatch),
                       sum(r["operations_ms"] for r in per_dispatch))
    red = next(r for r in reduce_rows if r["m"] == b)
    source = "src/repro_torch/kernels/matmul/csrc/matmul.cu"
    replaces = "src/repro/kernels/matmul/kernel.py:39"
    emit({"kernels": [{
        "name": "matmul", "route": "cuda", "source": source,
        "replaces": replaces, "function": "matmul_pallas",
        "launches": serve["launches"]["matmul"],
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": sum(r["kernel_ms"] for r in per_dispatch),
        "plain_ms": sum(r["plain_ms"] for r in per_dispatch),
        "bound_ms": bnd, "bound_by": by,
        "library_ms": sum(r["library_ms"] for r in per_dispatch),
        "at": f"one scorer dispatch at bucket {b}: "
              f"({b}x{d_in})@({d_in}x{d_hidden}) + "
              f"({b}x{d_hidden})@({d_hidden}x{d_out}), each a whole "
              f"matmul() call; the second's time includes its split-K "
              f"reduction (matmul_splitk_reduce)"}, {
        "name": "matmul_splitk_reduce", "route": "cuda", "source": source,
        "replaces": replaces, "function": "matmul_pallas (its f32 "
                                          "accumulation over the K grid)",
        "launches": serve["launches"]["matmul_splitk_reduce"],
        "max_abs_err": max(r["max_abs_err"] for r in reduce_rows),
        "ms": red["kernel_ms"], "plain_ms": red["plain_ms"],
        "bound_ms": red["bound_ms"], "bound_by": red["bound_by"],
        "library_ms": red["library_ms"],
        "at": f"the {red['splits']} partial sums of ({b}x{d_hidden})@"
              f"({d_hidden}x{d_out})"}]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
