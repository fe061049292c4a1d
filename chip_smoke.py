"""Chip smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py                 # on a machine with one H100

Drives the port's five main paths — the §5.3 FFNN scorer at the paper's
speech-100k width (1600 features, 100000 hidden units, 10 labels) served
through ``TraServer`` on the ``jit`` executor; the same FFNN trained at
that width on a minibatch of 10000 through ``TraTrainer``, plan-level
autodiff and AdamW; gemma2-2b at full width
(26 layers, d_model 2304, vocab 256000), mamba2-130m at full width (24
Mamba2 layers, d_model 768, 24 SSD heads of dim 64, state 128, chunk 128,
vocab 50280) and zamba2-7b at full width (78 Mamba2 layers in 13 groups of
6, each followed by one of 2 shared attention + MLP blocks; d_model 3584,
112 SSD heads of dim 64, state 64, chunk 128, 32/32 attention heads of dim
112, d_ff 14336, vocab 32000; 6.72 B parameters), each model through the
``--dense-oracle`` prefill + greedy decode loop with random bf16 weights
from seed 0 — and holds every hand-written kernel of those paths against
its plain PyTorch version on the card:

1. device: the card's name and power limit (``nvidia-smi``);
2. build: compiles the CUDA sources of ``src/repro_torch/kernels/`` (one
   ``nvcc`` per source, all started together), and counts the ``HGMMA``
   instructions (``wgmma``) in the flash, SSD and matmul libraries' SASS
   and the ``UTMALDG`` (TMA loads) in the matmul library's: none fails;
3. kernels: ``matmul`` against ``matmul_ref`` at the shapes of the JAX
   package's kernel tests, a ragged shape (M, N and K off the tiles) and
   the scorer's two products (f32 with at most 16 rows through the skinny
   kernel, f32 with more rows and more than 32 columns through the
   tensor-core route, f32 with more rows and at most 32 columns through
   the narrow kernel, bf16 through the tile kernel; the skinny and
   tensor-core products also through the tile kernel, the route they took
   over), and the tile kernel's split-K reduction pass
   (``splitk_reduce``, off every main path) against ``splitk_reduce_ref``
   at the partial sums of the scorer's second product, each with kernel /
   plain / library times and the bound; then the skinny kernel on blocked views read in place
   (a scorer-shaped W1, blocks with ragged edges, W2's 40-byte rows: no
   copy) and on an operand off 16 bytes (one copy), and its split-K fold
   bit-equal to ``splitk_reduce_ref`` on its own partial tiles (drawn from
   a generator of their own, so the flash phase draws what it drew);
4. flash: ``attention`` against ``attention_ref`` at the JAX kernel
   tests' cases (f32 at 2e-4, bf16 at 3e-2), ragged lengths, ``sq <
   skv``, ``dv != d`` and gemma2-2b's two layer shapes (B=2, S=8192,
   D=256, soft-cap 50: window 4096 and global; bf16 within half a bf16
   step plus ``GEMMA2_BF16_DELTA`` of the exact f64 attention, f32 at
   2e-4), every case also within a limit on each output row's error over
   that row's norm (bf16 1e-2, f32 1e-4); every bf16 case through the
   tensor-core kernel (``TC_LAUNCHES``), every f32 case through the FFMA
   kernel (``FFMA_LAUNCHES``); zamba2-7b's shared attention (B=2, S=8192,
   32/32 heads, D=112, causal, no soft-cap) gated as gemma2's shapes are,
   timed in both types with the bound and ``scaled_dot_product_attention``
   beside the bf16 kernel; at gemma2's head shape (8 seeds, S=256)
   the bf16 kernel's outputs that differ from the correctly rounded f64
   attention within ``FLASH_ROUNDING_FACTOR`` times the plain f32
   version's count; timed at the gemma2 shapes in bf16 and at the global
   shape in f32, with the bound, and ``scaled_dot_product_attention``
   beside each kernel at the global shape without soft-cap;
5. serve: 64 Poisson-arriving requests through ``TraServer`` with every
   kernel launch count set to 0 just before and read just after (per
   dispatch 2 launches of the skinny kernel, 1 of them folding, and no
   tile kernel, reduction or copy); each response is checked against the
   scorer's per-request oracle; one bucket-8 dispatch timed whole, the W1
   copy the parent tree made, and each product at bucket 8 timed in place
   as the engine calls it, beside ``torch.matmul`` on the copied 2-D
   operands, the tile kernel there (the parent's path) and the bound;
6. train: ``ffnn_train_step_tra`` at speech-100k (N 10000, D 1600, H
   100000, L 10, f32, blocked nb 10, db 4, hb 10, lb 1) through
   ``TraTrainer(Engine(device="cuda", executor="jit"), ...)`` with
   AdamW(``TRAIN_LR``, 1e-5), data and weights drawn on the card as
   ``benchmarks/train.py`` draws them, for 5 steps with every launch
   count set to 0 just before and read just after: 1 compile and 4 cached
   dispatches, the loss finite and lower at the last step than at the
   first, per step 1 launch of the tensor-core kernel and 2 of its split
   pass (X·W1), 1 of the narrow kernel (a1·W2, split in K and folding its
   sum in the same launch), none of the tile kernel, the split-K pass or
   the skinny kernel, and no operand copy; step 1's loss, AdamW moments and parameters, and
   one SGD(0.01) step's parameters, against the same step with the matmul
   op's plain version on the card and against a dense f64 step on the
   card, each within ``tolerance(k, f32)`` of the product computing it
   (AdamW's parameters where the reference |g| exceeds
   ``ADAM_GATE_ATOLS`` times the atol; W1's first moment against f64
   everywhere, the f64 step taking relu' from the kernel's z1, and
   against the plain run outside the columns where the kernel's and the
   plain run's z1 differ in sign, each such sign within the z1 limit of
   0); z1 itself within ``tolerance(1600, f32)`` of the f64 product; step
   ms (median of steps 2-5), peak memory, a profile of one step by
   kernel, and each forward product timed on its route beside the FFMA
   tile kernel (with its split-K pass: the route both took before), the
   plain version, ``torch.matmul`` and the bounds (X·W1: its split passes
   and the tensor-core kernel alone, too), with the split-K pass at
   a1·W2's partial sums (off the path) beside ``sum(0)``;
7. gemma2: prefill of 2×8192 tokens and 32 greedy decode steps through
   ``launch.serve.dense_generate`` with every launch count set to 0 just
   before and read just after (26 launches of the tensor-core flash
   kernel, none of the FFMA kernel, no copy of q, k or v); the prefill's
   and the first decode step's logits against the same model with the
   plain attention, within ``0.02·(max|logit| + 1)``;
   a profile by kernel of one prefill (26 flash launches) and of 8 decode
   steps (none), so the main path's 26 were all its prefill's;
8. ssd: ``ssd_scan`` against ``ssd_chunked_ref`` computed in f64 (the
   exact result, :func:`exact_ssd`, as in every per-call SSD check here;
   JAX's f32 sum of C·Bᵀ is off by a few % of a row where C_i·B_i
   cancels) at the JAX kernel
   tests' cases, ragged S, S < chunk, B and C read as slices of one (B, S,
   2N) tensor (as the model hands them over) and as contiguous tensors,
   and mamba2-130m's layer shape (B=8, S=8192, H=24, P=64, N=128, L=128) —
   every bf16 case through the tensor-core kernel (``TC_LAUNCHES``), every
   f32 case through the FFMA kernel (``FFMA_LAUNCHES``): max |err| within
   ``SSD_TOL`` of the largest |output| and each output row's error within
   ``SSD_ROW_TOL`` of that row's norm; at the layer shape in bf16 the
   final state from the same launch within ``SSD_TOL`` of the largest |h|
   of ``ssd_final_state`` and within ``SSD_STATE_TOL`` of the largest |h|
   of the f64 state; timed at the layer shape, bf16 on the tensor-core
   kernel and f32 on the FFMA one, with the plain version and the bound;
   zamba2-7b's layer shape (B=2, S=8192, H=112, P=64, N=64, L=128) the
   same ways;
9. mamba2: prefill of 8×8192 tokens and 32 greedy decode steps through
   ``dense_generate`` with every launch count set to 0 just before and
   read just after (24 launches of the tensor-core SSD kernel, none of
   the FFMA one, no cast, no other kernel); in a second prefill, every
   layer's SSD call on its real inputs against the exact result, y and
   final state within the ssd phase's limits (beside them, not gated, the
   row errors of the FFMA kernel, of the plain version in f32 — the
   model's plain path, JAX's arithmetic — and of the exact y rounded to
   bf16, on the same inputs); the same weights in f32
   through the FFMA kernel (24 launches a prefill) and through the plain
   SSD scan, prefill and first decode logits within
   ``MAMBA2_F32_LOGIT_TOL``; the bf16 run's prefill and first
   decode logits against the plain-SSD run's within ``BF16_FLOOR_FACTOR``
   of the model's rounding floor, measured here as the distance between
   the plain scan in half-size chunks and in full chunks (in bf16 the
   logits move by more than ``0.02·(max|logit| + 1)`` when only the
   rounding changes: 24 layers without post-norms add up the bf16 noise
   of each); a profile by kernel of one prefill (24 SSD launches) and of
   8 decode steps (none);
10. zamba2: prefill of 2×8192 tokens and 32 greedy decode steps through
   ``dense_generate`` with every launch count set to 0 just before and
   read just after (13 launches of the tensor-core flash kernel, one per
   shared-block application, and 78 of the tensor-core SSD kernel, one
   per Mamba2 layer; none of either FFMA kernel, no copy, no cast); in
   further prefills, every Mamba2 layer's SSD call on its real inputs held
   as mamba2's are, and every shared-block application's attention on its
   real inputs held to the flash phase's exact gate and row limit (the
   plain version's and the FFMA kernel's crossings beside it); the
   same weights in f32 through the FFMA kernels against both plain
   versions, prefill and first decode logits within
   ``0.02·(max|logit| + 1)``; the bf16 run against the plain-kernels run
   within ``BF16_FLOOR_FACTOR`` of the rounding floor (both plain, the
   SSD in half-size chunks against full ones); a profile by kernel of one
   prefill (13 + 78 launches) and of 8 decode steps (none); peak memory;
11. the kernels line, the ``nvidia-smi`` line, and the last line
   ``{"ok": true, "device": {...}}``.

Any failed check exits non-zero before the last line.  Without a CUDA
device the script exits non-zero at once.
"""
from __future__ import annotations

import contextlib
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

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.ffnn_paper import speech  # noqa: E402
from repro_torch.core.cost import H100_SXM  # noqa: E402
from repro_torch.core.plan import FusedJoinAgg, postorder  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    attention_ref)
from repro_torch.kernels.matmul import ops as mm_ops  # noqa: E402
from repro_torch.kernels.matmul.ref import (matmul_ref,  # noqa: E402
                                            splitk_reduce_ref,
                                            tf32_split_ref)
from repro_torch.kernels.ssd_scan import ops as ssd_ops  # noqa: E402
from repro_torch.kernels.ssd_scan.ref import ssd_chunked_ref  # noqa: E402
from repro_torch.models.model import (_window_for, group_size,  # noqa: E402
                                      n_scan_groups)

SEED = 0
N_REQUESTS = 64
ARRIVAL_RATE = 2000.0            # requests/s, Poisson
BUCKETS = (1, 2, 4, 8)
ARCH = "gemma2-2b"
PROMPT_BATCH, PROMPT_LEN, GEN = 2, 8192, 32
FLASH_TOL = {torch.float32: 2e-4, torch.bfloat16: 3e-2}
# At S=8192 an output is a softmax average over thousands of keys, ~0.02,
# so 3e-2 would hold nothing there.  The gemma2 bf16 shapes are held to the
# exact attention (f64) instead: every output within half a bf16 step of
# the exact value, the step taken at the larger of the two magnitudes, plus
# GEMMA2_BF16_DELTA, 3x the largest excess over half a step that the card
# read at those shapes (tools/flash_gate_census.py on an H100: 1.85e-6 for
# the wgmma kernel over 64 draws at S=256 and 8 at S=8192 of each layer
# kind; 7.3e-7 for the f32 FFMA kernel).  A correct kernel rounds an f32
# result that lies within a few 1e-6 of the exact value, so it may land on
# either bf16 neighbour of a value near their midpoint, and this gate
# passes both; a limit against the plain version's bf16 output (the former
# GEMMA2_BF16_ATOL, 6e-3) failed correct kernels on some draws, one step
# apart.  With delta below 6e-3 the new limit, half a step plus delta,
# lies below the former one, 6e-3 plus the plain output's own half step,
# at every magnitude.  Every case also keeps the limit on the largest
# error of one output row over that row's norm.
GEMMA2_BF16_DELTA = 5.6e-6
GEMMA2_BF16_ATOL = 6e-3          # the former gate: tools/flash_gate_census.py
ROW_REL_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
# The bf16 tensor-core kernel must round like an f32 computation: at
# gemma2's head shape (first 256 rows, where outputs reach 1 and more) the
# outputs that differ from the correctly rounded f64 attention may number
# at most FLASH_ROUNDING_FACTOR times the plain f32 version's.  In a
# plain-torch model of the kernel's arithmetic, P in one or two bf16 terms
# fails this and three pass (tests/test_torch_flash_attention.py).
FLASH_ROUNDING_FACTOR = 2.0
SSM_ARCH = "mamba2-130m"
SSM_BATCH = 8                    # x PROMPT_LEN tokens, GEN decode steps
# An SSD output sums terms of either sign over the chunk and the carried
# state (|C·B| ~ √N), so its rounding error scales with the largest output,
# not with its own size.  At the mamba2-130m layer shape this script read,
# on an H100 80GB HBM3 at 700 W, max |err| 1.2e-5·max|ref| and a row error
# of 1.3e-4 of the row's norm in f32, one bf16 step (2^-9 of max|ref|) and
# 3.1e-3 in bf16.  Limits: max |err| within SSD_TOL·max|ref| (f32 8x that, bf16 above
# one step at the top output, 2^-7); row error within SSD_ROW_TOL (f32 8x,
# bf16 3x).  tests/test_torch_ssd_scan.py shows they catch a chunk boundary
# one step off, a dropped carried state and a decay 1% off.
SSD_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
SSD_ROW_TOL = {torch.float32: 1e-3, torch.bfloat16: 1e-2}
# The final state is f32 in both dtypes, and the decode starts from it.
# ssd_final_state (JAX's op) is itself 7.4e-4 of max|h| off the f64 state
# on mamba2-130m's real inputs (an f32 cumsum over 8192 steps), so besides
# SSD_TOL against it the kernel's state is held to the f64 state: within
# SSD_STATE_TOL of the largest |h|.  This script read 2.2e-6 at the layer
# shape and 2.2e-5 on the real inputs (H100 80GB HBM3 at 700 W); a state
# rounded to bf16 lies ~2e-3 off.
SSD_STATE_TOL = 1e-4
# mamba2-130m end to end.  In f32 the kernel run's prefill and first decode
# logits lay 1.2e-3 and 2.0e-3 from the plain-SSD run's (this script, H100
# 80GB HBM3 at 700 W): the f32 limit is 10x the larger.  In bf16 this random
# 24-layer model moves its logits by more than 0.02·(max|logit| + 1) when
# only the rounding changes, so the bf16 run is held within
# BF16_FLOOR_FACTOR of that rounding floor, measured in the same run.
MAMBA2_F32_LOGIT_TOL = 2e-2
BF16_FLOOR_FACTOR = 1.5
# zamba2-7b at full width: 78 Mamba2 layers in 13 groups of 6, each group
# followed by one of 2 shared attention + MLP blocks; 2 x PROMPT_LEN tokens
# (its SSD layer: 112 heads of two-head CTAs per batch row, 112 CTAs).  The
# f32 run is held within 0.02·(max|logit| + 1) of the plain versions'
# (tests/test_arch_smoke.py:96-98), the bf16 run within BF16_FLOOR_FACTOR
# of its rounding floor, as mamba2's.
HYBRID_ARCH = "zamba2-7b"
HYBRID_BATCH = 2
PEAK = {torch.float32: H100_SXM.peak_flops_f32,
        torch.bfloat16: H100_SXM.peak_flops}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def tile_kernel(a, b):
    """f32 ``a @ b`` (2-D) on the tile kernel and its split-K pass, whatever
    the op's route: the products the skinny, tensor-core and narrow routes
    took over, timed and checked on the kernel they replaced."""
    return mm_ops._launch_tile(a, b, a.shape[0], a.shape[1], b.shape[1],
                               torch.float32)


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


def device_ms_per_call(fn, calls: int = 10) -> float:
    """Device time of one ``fn()``: the kernels it launches, summed over
    ``calls`` calls under ``torch.profiler`` and divided by them.  Beside
    ``timed_ms``, which a call whose host work outlasts its kernels reads
    as the host's time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA) \
        / 1e3 / calls


def bound_times(m: int, k: int, n: int, dtype, route: str = "") -> tuple:
    """(bytes_ms, operations_ms) of a product on an H100 SXM (data sheet):
    each input read once and the output written once at the HBM rate,
    against the operations at the type's peak — for f32 on the
    tensor-core route (``route="tc"``) three TF32 products at the tensor
    cores' TF32 rate, else one product at the FFMA rate.  The bound is the
    larger."""
    isz = torch.tensor([], dtype=dtype).element_size()
    nbytes = (m * k + k * n + m * n) * isz
    flops = 2.0 * m * n * k
    ops_ms = (3 * flops / H100_SXM.peak_flops_tf32 if route == "tc"
              else flops / PEAK[dtype]) * 1e3
    return nbytes / H100_SXM.hbm_bw * 1e3, ops_ms


def split_bound_times(m: int, k: int, n: int) -> tuple:
    """(bytes_ms, operations_ms) of the two split passes of an (m, k) @
    (k, n) product on the tensor-core route: each operand read once and
    its two TF32 terms written once (K padded), against two roundings and
    a subtraction a value at the f32 peak."""
    kp = mm_ops.tc_kp(k)
    nbytes = (m * k + k * n + 2 * (m + n) * kp) * 4
    return (nbytes / H100_SXM.hbm_bw * 1e3,
            3.0 * (m * k + k * n) / PEAK[torch.float32] * 1e3)


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


def reset_launches() -> None:
    mm_ops.LAUNCHES = mm_ops.REDUCE_LAUNCHES = flash_ops.LAUNCHES = 0
    mm_ops.SKINNY_LAUNCHES = mm_ops.FOLDS = mm_ops.COPIES = 0
    mm_ops.TC_LAUNCHES = mm_ops.SPLIT_LAUNCHES = 0
    mm_ops.NARROW_LAUNCHES = mm_ops.NARROW_FOLDS = 0
    flash_ops.TC_LAUNCHES = flash_ops.FFMA_LAUNCHES = flash_ops.COPIES = 0
    ssd_ops.LAUNCHES = ssd_ops.TC_LAUNCHES = ssd_ops.FFMA_LAUNCHES = 0
    ssd_ops.COPIES = 0


def read_launches() -> dict:
    """Every kernel's launch count (``flash_attention`` and ``ssd_scan``
    are the sums of their two kernels'), the skinny and narrow matmul
    launches that folded a split-K sum, and the copies of operands the
    matmul, flash and SSD ops made."""
    return {"matmul_skinny": mm_ops.SKINNY_LAUNCHES,
            "matmul_fold": mm_ops.FOLDS,
            "matmul_copies": mm_ops.COPIES,
            "matmul": mm_ops.LAUNCHES,
            "matmul_splitk_reduce": mm_ops.REDUCE_LAUNCHES,
            "matmul_tc": mm_ops.TC_LAUNCHES,
            "matmul_tf32_split": mm_ops.SPLIT_LAUNCHES,
            "matmul_narrow": mm_ops.NARROW_LAUNCHES,
            "matmul_narrow_fold": mm_ops.NARROW_FOLDS,
            "flash_attention": flash_ops.LAUNCHES,
            "flash_attention_wgmma": flash_ops.TC_LAUNCHES,
            "flash_attention_ffma": flash_ops.FFMA_LAUNCHES,
            "flash_copies": flash_ops.COPIES,
            "ssd_scan": ssd_ops.LAUNCHES,
            "ssd_scan_wgmma": ssd_ops.TC_LAUNCHES,
            "ssd_scan_ffma": ssd_ops.FFMA_LAUNCHES,
            "ssd_copies": ssd_ops.COPIES}


def launches_of(**nonzero) -> dict:
    """The counts a path should read: 0 but where given."""
    return {**{name: 0 for name in read_launches()}, **nonzero}


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
    """Every kernel library at once, each source by its own ``nvcc``, all
    in parallel; then the ``HGMMA`` counts of the flash, SSD and matmul
    libraries and the ``UTMALDG`` count of the matmul library."""
    from concurrent.futures import ThreadPoolExecutor
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(build.SOURCES)) as pool:
        seconds = dict(zip(build.SOURCES, pool.map(build.build,
                                                   build.SOURCES)))
    for name in build.SOURCES:
        usage = [ln.strip() for ln in build.BUILD_LOGS.get(name, "")
                 .splitlines() if "registers" in ln or "spill" in ln]
        emit({"phase": "build", "library": name, "seconds": seconds[name],
              "ptxas": usage})
    hgmma = build.sass_count("flash_attention", "HGMMA")
    ssd_hgmma = build.sass_count("ssd_scan", "HGMMA")
    utmaldg = build.sass_count("matmul", "UTMALDG")
    mm_hgmma = build.sass_count("matmul", "HGMMA")
    emit({"phase": "build", "wall_s": time.perf_counter() - t0,
          "flash_attention_hgmma": hgmma, "ssd_scan_hgmma": ssd_hgmma,
          "matmul_hgmma": mm_hgmma, "matmul_utmaldg": utmaldg})
    if hgmma == 0:
        fail("build: no HGMMA instruction in the flash library's SASS")
    if ssd_hgmma == 0:
        fail("build: no HGMMA instruction in the SSD library's SASS")
    if utmaldg == 0:
        fail("build: no UTMALDG (TMA load) in the matmul library's SASS")
    if mm_hgmma == 0:
        fail("build: no HGMMA instruction in the matmul library's SASS")


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
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    route = mm_ops.route(a, b, "kernel")
    t_bytes, t_ops = bound_times(m, k, n, dtype, route)
    bnd, by = bound_of(t_bytes, t_ops)
    row = {"m": m, "k": k, "n": n, "dtype": str(dtype).split(".")[-1],
           "route": route,
           "max_abs_err": err.max().item(), "rtol": rtol, "atol": atol,
           "kernel_ms": timed_ms(lambda: mm_ops.matmul(a, b, impl="kernel"),
                                 device, iters),
           "plain_ms": timed_ms(lambda: matmul_ref(a, b), device, iters),
           "library_ms": timed_ms(lambda: torch.matmul(a, b), device,
                                  iters),
           "bound_ms": bnd, "bound_by": by, "bytes_ms": t_bytes,
           "operations_ms": t_ops,
           "tile_splits": mm_ops.plan_launch(m, n, k, sms)[1]}
    if route in ("skinny", "tc"):
        # the products the skinny kernel and the tensor-core route took
        # over, on the tile kernel
        tile = tile_kernel(a, b).float()
        terr = (tile - r).abs()
        if not bool(torch.isfinite(tile).all()) or bool(
                (terr > atol + rtol * r.abs()).any()):
            fail(f"matmul tile kernel {m}x{k}x{n}: max |err| "
                 f"{terr.max().item()} over rtol={rtol} atol={atol}")
        row["tile_max_abs_err"] = terr.max().item()
    return row


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


def blocked_case(m, blocks, device, gen) -> dict:
    """The skinny kernel on the (r0·r1, c0·c1) matrix held as the permuted
    view (r0, r1, c0, c1) of a (r0, c0, r1, c1) tensor — how the engine
    hands over a blocked relation — against ``matmul_ref`` on the same
    values made contiguous: read in place, with no copy."""
    r0, r1, c0, c1 = blocks
    k = r0 * r1
    w = torch.randn((r0, c0, r1, c1), generator=gen, device=device)
    view = w.permute(0, 2, 1, 3)
    a = torch.randn((m, k), generator=gen, device=device)
    dense = view.reshape(k, c0 * c1)
    before = (mm_ops.SKINNY_LAUNCHES, mm_ops.COPIES)
    out = mm_ops.matmul(a, view, b_rows=2)
    ref = matmul_ref(a, dense)
    torch.cuda.synchronize(device)
    launched = mm_ops.SKINNY_LAUNCHES - before[0]
    copies = mm_ops.COPIES - before[1]
    rtol, atol = tolerance(k, torch.float32)
    err = (out - ref).abs()
    if launched != 1 or copies != 0 or not bool(torch.isfinite(out).all()) \
            or bool((err > atol + rtol * ref.abs()).any()):
        fail(f"skinny matmul on the view {blocks}, m={m}: {launched} "
             f"launches, {copies} copies, max |err| {err.max().item()} "
             f"over rtol={rtol} atol={atol}")
    return {"case": "blocked view in place", "m": m, "view": list(blocks),
            "copies": copies, "max_abs_err": err.max().item(),
            "rtol": rtol, "atol": atol}


def copied_case(device, gen) -> dict:
    """An operand that starts off a 16-byte boundary: copied once,
    counted, and the product still right."""
    base = torch.randn(1600 * 1000 + 1, generator=gen, device=device)
    b = base[1:].view(1600, 1000)
    a = torch.randn((8, 1600), generator=gen, device=device)
    before = mm_ops.COPIES
    out = mm_ops.matmul(a, b)
    ref = matmul_ref(a, b)
    torch.cuda.synchronize(device)
    rtol, atol = tolerance(1600, torch.float32)
    err = (out - ref).abs()
    if mm_ops.COPIES - before != 1 or bool(
            (err > atol + rtol * ref.abs()).any()):
        fail(f"skinny matmul, B off 16 bytes: {mm_ops.COPIES - before} "
             f"copies (1 expected), max |err| {err.max().item()}")
    return {"case": "B off 16 bytes, copied", "m": 8, "k": 1600, "n": 1000,
            "copies": mm_ops.COPIES - before,
            "max_abs_err": err.max().item(), "rtol": rtol, "atol": atol}


def fold_case(m, k, n, device, gen) -> dict:
    """The skinny kernel's fold against ``splitk_reduce_ref`` on the
    partial tiles the same launch wrote: equal to the bit."""
    a = torch.randn((m, k), generator=gen, device=device)
    b = torch.randn((k, n), generator=gen, device=device)
    out, partials = mm_ops._launch_skinny(a, b, 1, 1, m, k, n, torch.float32,
                                          keep_partials=True)
    torch.cuda.synchronize(device)
    if partials is None:
        fail(f"skinny matmul {m}x{k}x{n}: K was not split")
    ref = splitk_reduce_ref(partials)
    err = (out - ref).abs().max().item()
    if not torch.equal(out, ref):
        fail(f"skinny fold {m}x{k}x{n}: differs from splitk_reduce_ref of "
             f"its {partials.shape[0]} partial tiles by {err}")
    return {"case": "fold vs splitk_reduce_ref of its partials", "m": m,
            "k": k, "n": n, "splits": partials.shape[0],
            "max_abs_err": err, "rtol": 0.0, "atol": 0.0}


def phase_skinny(device, d_in, d_hidden, d_out) -> list:
    """The skinny kernel's own cases, from a generator of their own."""
    gen = torch.Generator(device=device).manual_seed(SEED + 19)
    rows = [blocked_case(8, (4, d_in // 4, 10, 1000), device, gen),
            blocked_case(3, (3, 100, 5, 1000), device, gen),
            blocked_case(8, (10, d_hidden // 10, 1, d_out), device, gen),
            copied_case(device, gen)]
    for b in (1, 8):
        rows.append(fold_case(b, d_hidden, d_out, device, gen))
    rows.append(fold_case(8, d_in, 4000, device, gen))
    for row in rows:
        emit({"phase": "kernel", "name": "matmul_skinny", **row})
    return rows


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
    reset_launches()
    report = open_loop(server, payloads, arrivals)
    launches = read_launches()
    # ---------------------------------------------------------------------

    dispatches = sum(server.dispatches.values())
    if report.errors or report.shed:
        fail(f"serve: {report.errors} errors, {report.shed} shed")
    if server.cache_misses_since_warmup != 0:
        fail(f"serve: {server.cache_misses_since_warmup} cache misses "
             f"after warmup")
    # per dispatch: both products launch the skinny kernel, reading the
    # blocked weights in place; the second, (b x 100000) @ (100000 x 10),
    # splits K and folds the partial sums in its own launch: no tile
    # kernel, no separate reduction, no copy
    expected = launches_of(matmul_skinny=2 * dispatches,
                           matmul_fold=dispatches)
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
    """One bucket-8 dispatch timed whole (host clock, synchronized); the
    copy that arranged the blocked W1 into a 2-D operand on the parent tree
    (the path no longer makes it); and each of the dispatch's two products
    timed as the engine calls the matmul op — the same views of the
    relations' tensors — beside ``torch.matmul`` and the tile kernel (the
    parent's path) on the copied 2-D operands, and the bound."""
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

    # the operands the engine hands the matmul op in one dispatch
    calls, real = [], mm_ops.matmul

    def spy(a, b, **kw):
        calls.append((a, b, kw))
        return real(a, b, **kw)

    mm_ops.matmul = spy
    try:
        dispatch()
    finally:
        mm_ops.matmul = real
    if len(calls) != 2:
        fail(f"dispatch_breakdown: {len(calls)} matmul calls, expected 2")
    products = []
    for (a, b, kw), name in zip(calls, ("first", "second")):
        m = math.prod(a.shape[:kw["a_rows"]])
        k = math.prod(a.shape[kw["a_rows"]:])
        n = math.prod(b.shape[kw["b_rows"]:])
        a2, b2 = a.reshape(m, k).contiguous(), b.reshape(k, n).contiguous()
        before = mm_ops.COPIES
        out = mm_ops.matmul(a, b, **kw)
        ref = matmul_ref(a2, b2)
        tile = tile_kernel(a2, b2)
        torch.cuda.synchronize(device)
        rtol, atol = tolerance(k, torch.float32)
        for what, o in (("in place", out), ("tile kernel", tile)):
            err = (o - ref).abs()
            if bool((err > atol + rtol * ref.abs()).any()):
                fail(f"{name} product {what}: max |err| {err.max().item()}")
        if mm_ops.COPIES != before:
            fail(f"{name} product: the matmul op copied an operand")
        t_bytes, t_ops = bound_times(m, k, n, torch.float32)
        bnd, by = bound_of(t_bytes, t_ops)
        timed = {"in_place": lambda: mm_ops.matmul(a, b, **kw),
                 "torch_matmul_on_copy": lambda: torch.matmul(a2, b2),
                 "tile_kernel_on_copy": lambda: tile_kernel(a2, b2),
                 "plain": lambda: matmul_ref(a2, b2)}
        products.append({
            "product": name, "m": m, "k": k, "n": n,
            "b_view": {"shape": list(b.shape), "strides": list(b.stride())},
            **{f"{what}_ms": timed_ms(fn, device, iters=20)
               for what, fn in timed.items()},
            **{f"{what}_device_ms": device_ms_per_call(fn)
               for what, fn in timed.items()},
            "bound_ms": bnd, "bound_by": by, "bytes_ms": t_bytes,
            "operations_ms": t_ops,
            "max_abs_err": (out - ref).abs().max().item()})
    return {"dispatch_b8_host_ms": host_ms, "w1_permute_copy_ms": copy_ms,
            "w1_bytes": w1.numel() * w1.element_size(),
            "products_b8": products}


# ------------------------------------------------------------- training
TRAIN_STEPS = 5
TRAIN_BLOCKS = (10, 4, 10, 1)    # nb, db, hb, lb: W1 blocked as the scorer's
#: AdamW's rate on the main path.  benchmarks/train.py's 1e-2 moves every
#: weight by ~1e-2 a step, which at D 1600 and H 100000 sends the loss up
#: tenfold (tools/ffnn_train_rates.py: of 1e-2 down to 1e-5 only 3e-5 and
#: 1e-5 lower it over 5 steps, only 1e-5 at every step)
TRAIN_LR = 1e-5
#: the rates of the step-1 checks: benchmarks/train.py's AdamW, whose first
#: update (lr·sign(g)) is far above the gradients' atol, and the paper's η
CHECK_LR = 1e-2
SGD_LR = 0.01
#: the path's name in the kernels line
TRAIN_PATH = "ffnn-train-speech-100k"
#: AdamW's first update is about lr·sign(g): its W' is held only where the
#: reference |g| exceeds this many times the gradient's atol
ADAM_GATE_ATOLS = 100.0
GEMM_NAMES = ("gemm", "nvjet", "sm90_xmma", "cutlass", "cublas")
MODEL_GROUPS = (("flash_attention", ("flash_attention_kernel",)),
                ("ssd_scan", ("ssd_scan_kernel",)), ("gemm", GEMM_NAMES))
TRAIN_GROUPS = (("matmul_tc", ("matmul_tc_kernel",)),
                ("tf32_split", ("tf32_split_kernel",)),
                ("matmul_narrow", ("matmul_narrow_kernel",)),
                ("matmul_tile", ("matmul_tile_kernel",)),
                ("splitk_reduce", ("splitk_reduce_kernel",)),
                ("matmul_skinny", ("matmul_skinny_kernel",)),
                ("gemm", GEMM_NAMES), ("copy", ("copy",)),
                ("elementwise", ("elementwise",)))


@contextlib.contextmanager
def plain_matmul():
    """Every matmul op call inside takes the op's plain version: the
    reference run of the train phase only (the main path never does)."""
    real = mm_ops.matmul
    mm_ops.matmul = lambda a, b, **kw: real(a, b, **{**kw, "impl": "plain"})
    try:
        yield
    finally:
        mm_ops.matmul = real


def train_problem(device):
    """The §5.3 FFNN at speech-100k, not cut: dims for
    ``ffnn_train_step_tra`` and the dense X, Y, W1, W2, drawn on the card
    as ``benchmarks/train.py`` draws them (X normal, Y = sigmoid(X·Wt),
    W1 and W2 scaled by D^-1/2 and H^-1/2)."""
    cfg = speech(100_000)
    nb, db, hb, lb = TRAIN_BLOCKS
    n, d, h, l_ = cfg.batch, cfg.d_in, cfg.d_hidden, cfg.d_out
    dims = (nb, db, hb, lb, n // nb, d // db, h // hb, l_ // lb)
    gen = torch.Generator(device=device).manual_seed(SEED)
    x = torch.randn((n, d), generator=gen, device=device)
    wt = torch.randn((d, l_), generator=gen, device=device) * 0.5
    y = torch.sigmoid(x @ wt)
    w1 = torch.randn((d, h), generator=gen, device=device) * d ** -0.5
    w2 = torch.randn((h, l_), generator=gen, device=device) * h ** -0.5
    return cfg, dims, {"X": x, "Y": y, "W1": w1, "W2": w2}


def train_relations(dims, dense) -> tuple:
    """(data, params): the dense tensors blocked as the program's inputs."""
    from repro_torch.core import from_tensor
    nb, db, hb, lb, bn, bd, bh, bl = dims
    tiles = {"X": (bn, bd), "Y": (bn, bl), "W1": (bd, bh), "W2": (bh, bl)}
    rel = {k: from_tensor(dense[k], t) for k, t in tiles.items()}
    return ({k: rel[k] for k in ("X", "Y")},
            {k: rel[k] for k in ("W1", "W2")})


def train_trainer(dims, params, optimizer, device):
    from repro_torch.core import Engine, TraTrainer
    from repro_torch.core.programs import ffnn_train_step_tra
    return TraTrainer(Engine(executor="jit", device=device),
                      ffnn_train_step_tra(*dims, optimizer=optimizer),
                      params=params)


def dense_f64_step(dense, z1, z1_plain) -> dict:
    """The loss and both gradients of the first step, dense and in f64 on
    the card, from the formulas of the dense oracle of
    ``tests/test_train.py``: a2 = σ(relu(X·W1)·W2), the clipped BCE sum,
    and its gradients through ∂L/∂z2 = a2 − Y.

    ``z1`` is X·W1 as the step's kernel computes it (through the route the
    engine takes, on the dense operands, which the engine's blocked views
    stand for; the route is deterministic and reads a view and a
    contiguous tensor alike): held against the f64 product within
    ``tolerance(D, f32)``.  relu' is taken from the sign of ``z1``, the
    mask the step used, so that the oracle's W1 gradient is the step's
    own function everywhere: where a z1 within rounding of 0 has the other
    sign than the f64 product, relu' would differ for the whole hidden
    unit's column of the gradient.

    ``z1_plain`` is X·W1 as the plain run computes it (``matmul_ref``).
    Where it and ``z1`` take different signs, that column of the plain
    run's W1 gradient differs from the kernel run's: ``flips`` marks those
    columns.  Each such sign must lie within the z1 gate's own limit of 0
    (|z1_f64| ≤ atol + rtol·|z1_f64|); any other fails the run.

    Readings of both z1 against f64, beside the kernel's gate (the plain
    one's share of the limit is not gated): the RMS error, the mean error
    along the sign of the f64 value (a drift toward zero reads negative)
    and the signs that differ from the f64 product's."""
    x, y = dense["X"].double(), dense["Y"].double()
    w1, w2 = dense["W1"].double(), dense["W2"].double()
    d = x.shape[1]
    rtol, atol = tolerance(d, torch.float32)
    a1 = x @ w1                                 # z1, then relu(z1) in place
    flips = torch.zeros(a1.shape[1], dtype=torch.bool, device=a1.device)
    step = 10_000
    n_flips, past_limit = 0, 0
    sums = {what: {"held": [], "sq": 0.0, "along": 0.0, "flips": 0}
            for what in ("kernel", "plain")}
    for c in range(0, a1.shape[1], step):
        cols = slice(c, c + step)
        exact = a1[:, cols]
        for what, z in (("kernel", z1), ("plain", z1_plain)):
            acc = sums[what]
            acc["held"].append(held(f"z1 = X·W1 ({what}) vs f64", z[:, cols],
                                    exact, d, gate=what == "kernel"))
            err = z[:, cols].double() - exact
            acc["sq"] += err.square().sum().item()
            acc["along"] += (err * exact.sign()).sum().item()
            acc["flips"] += int(((z[:, cols] > 0) != (exact > 0)).sum())
            del err
        flip = (z1[:, cols] > 0) != (z1_plain[:, cols] > 0)
        n_flips += int(flip.sum())
        past_limit += int((flip & (exact.abs() > atol + rtol * exact.abs()))
                          .sum())
        flips[cols] = flip.any(0)
        del flip
    readings = {}
    for what, acc in sums.items():
        readings[what] = {
            **max(acc["held"], key=lambda r: r["worst_share_of_limit"]),
            "rms_err": math.sqrt(acc["sq"] / a1.numel()),
            "mean_err_along_sign": acc["along"] / a1.numel(),
            "sign_flips_vs_f64": acc["flips"]}
    if past_limit:
        fail(f"train z1: {past_limit} of the {n_flips} signs where the "
             f"kernel and the plain run differ lie past the z1 limit of 0")
    a1.clamp_min_(0.0)
    a2 = torch.sigmoid(a1 @ w2)
    pc = a2.clamp(1e-7, 1.0 - 1e-7)
    loss = -(y * torch.log(pc) + (1.0 - y) * torch.log1p(-pc)).sum()
    dz2 = a2 - y
    g2 = a1.T @ dz2
    del a1
    dz1 = dz2 @ w2.T
    dz1.mul_(z1 > 0)                            # the step's own relu mask
    g1 = x.T @ dz1
    del dz1
    return {"loss": loss, "W1": g1, "W2": g2, "flips": flips,
            "z1_vs_f64": readings["kernel"],
            "z1_plain_vs_f64": readings["plain"],
            "sign_flips_vs_plain": n_flips, "flip_columns": int(flips.sum())}


def held(what: str, got, ref, k: int, where=None, gate=True) -> dict:
    """``got`` (f32) against ``ref`` within ``tolerance(k, f32)``, where
    ``where`` is true (everywhere by default); fails otherwise, unless
    ``gate`` is false (a reading only)."""
    rtol, atol = tolerance(k, torch.float32)
    got = torch.as_tensor(got).double()
    ref = torch.as_tensor(ref, device=got.device).double()
    if got.shape != ref.shape or not bool(torch.isfinite(got).all()):
        fail(f"train {what}: shape {tuple(got.shape)} against "
             f"{tuple(ref.shape)}, or not finite")
    err, lim = (got - ref).abs(), atol + rtol * ref.abs()
    if where is not None:
        err, lim = err[where], lim[where]
    over = int((err > lim).sum())
    out = {"max_abs_err": err.max().item() if err.numel() else 0.0,
           "worst_share_of_limit": (err / lim).max().item()
           if err.numel() else 0.0, "values_over": over, "rtol": rtol,
           "atol": atol, "k": k}
    if over and gate:
        fail(f"train {what}: {over} values over rtol={rtol} atol={atol} "
             f"(max |err| {out['max_abs_err']})")
    return out


def adamw_first_update(w, g, lr):
    """AdamW's parameter after its first step from zero moments, in f64:
    m̂ = g, v̂ = g², p' = p − lr·m̂/(√v̂ + eps) (no weight decay)."""
    b1, b2, eps = 0.9, 0.999, 1e-8
    m, v = (1.0 - b1) * g, (1.0 - b2) * g * g
    return w - lr * (m / (1.0 - b1)) / (torch.sqrt(v / (1.0 - b2)) + eps)


def train_checks(first: dict, plain: dict, ref: dict, dense, cfg,
                 prefix: str, adam: bool) -> dict:
    """One step's outputs (the loss, W1' and W2', and AdamW's moments)
    against the plain-matmul run's and the f64 oracle's, each within
    ``tolerance(k, f32)`` of the product that computes it: the loss the
    second forward product's (K = H), the gradients' the batch (K = N).
    AdamW's W' is held where the reference |g| exceeds
    ``ADAM_GATE_ATOLS`` times the gradient's atol.  W1's first moment is
    held against the f64 oracle (relu' from the step's own z1) everywhere,
    and against the plain run outside the ``flips`` columns of
    :func:`dense_f64_step` (a reading inside them); the counts are
    reported."""
    from repro_torch.core import to_tensor
    k_loss, k_grad = cfg.d_hidden, cfg.batch
    _, atol = tolerance(k_grad, torch.float32)
    lr = CHECK_LR if adam else SGD_LR
    checks = {}
    for against, want in (("plain", plain["loss"]), ("f64", ref["loss"])):
        checks[f"{prefix}loss_vs_{against}"] = held(
            f"{prefix}loss vs {against}", first["loss"], want, k_loss)
    same_sign = ~ref["flips"][None, :].expand(cfg.d_in, -1)
    for name in ("W1", "W2"):
        g, w = ref[name], dense[name].double()
        if adam:
            gate = g.abs() > ADAM_GATE_ATOLS * atol
            checks[f"{name}_below_the_gate"] = int((~gate).sum())
            exact = {name: adamw_first_update(w, g, lr),
                     f"{name}.m": 0.1 * g, f"{name}.v": 0.001 * g * g}
        else:
            gate, exact = None, {name: w - lr * g}
        for key, value in exact.items():
            got = to_tensor(first[key])
            want = to_tensor(plain[key])
            where = gate if key == name else \
                same_sign if key == "W1.m" else None
            checks[f"{prefix}{key}_vs_plain"] = held(
                f"{prefix}{key} vs plain", got, want, k_grad, where)
            checks[f"{prefix}{key}_vs_f64"] = held(
                f"{prefix}{key} vs f64", got, value, k_grad,
                gate if key == name else None)
            if key == "W1.m":
                checks[f"{prefix}W1.m_vs_plain_in_flip_columns"] = held(
                    "W1.m vs plain where z1's signs differ", got, want,
                    k_grad, ~same_sign, gate=False)
        del exact, w
    return checks


def first_step_checks(cfg, dims, dense, data, params, device) -> dict:
    """Step 1 at the check rates (AdamW, SGD) on the kernels, on the plain
    matmul and in f64, the first product's output z1 held on its own
    (:func:`dense_f64_step`, :func:`train_checks`): z1 through the route
    the engine takes (``matmul(X, W1, impl="kernel")``) and through the
    plain version."""
    from repro_torch.core import AdamW, SGD
    z1 = mm_ops.matmul(dense["X"], dense["W1"], impl="kernel")
    z1_plain = matmul_ref(dense["X"], dense["W1"])
    ref = dense_f64_step(dense, z1, z1_plain)
    del z1, z1_plain
    checks = {key: ref[key] for key in (
        "z1_vs_f64", "z1_plain_vs_f64", "sign_flips_vs_plain",
        "flip_columns")}
    for prefix, make in (("", lambda: AdamW(CHECK_LR)),
                         ("sgd_", lambda: SGD(SGD_LR))):
        run = train_trainer(dims, params, make(), device)
        got = step_outputs(run, run.step(**data))
        with plain_matmul():
            plain = train_trainer(dims, params, make(), device)
            want = step_outputs(plain, plain.step(**data))
        checks.update(train_checks(got, want, ref, dense, cfg, prefix,
                                   adam=not prefix))
        del run, got, plain, want
    return checks


def step_outputs(trainer, loss) -> dict:
    return {"loss": loss, **trainer.params, **trainer.state}


def narrow_plan(m: int, k: int, n: int, sms: int):
    """The narrow kernel's plan (``mm_ops.plan_narrow``) for contiguous 2-D
    operands of this shape."""
    op = mm_ops.plan_operands(((m, k), (k, 1), 0, 1),
                              ((k, n), (n, 1), 0, 1), "narrow")
    return mm_ops.plan_narrow(op.a, op.b, op.b_plan, sms)


def train_routes(products, sms: int) -> tuple:
    """Each train product ``(m, k, n)``'s route (``mm_ops.route``, f32 on
    the card) and the K splits it takes there (the tile kernel's
    ``plan_launch``, the narrow kernel's ``plan_narrow``; 1 elsewhere)."""
    routes = [mm_ops.route(torch.empty(m, k, device="meta"),
                           torch.empty(k, n, device="meta"), "kernel")
              for m, k, n in products]
    splits = [mm_ops.plan_launch(m, n, k, sms)[1] if r == "tile"
              else narrow_plan(m, k, n, sms).splits if r == "narrow" else 1
              for (m, k, n), r in zip(products, routes)]
    return routes, splits


def train_launches(routes, splits, steps: int) -> dict:
    """The launch counts ``steps`` train steps should read: per step and
    product, the tensor-core kernel and its two split passes, the narrow
    kernel (folding when split), or the tile kernel and its split-K pass
    (when split), by each product's route; no copy."""
    def count(route, split=None):
        return steps * sum(r == route and (split is None or (s > 1) == split)
                           for r, s in zip(routes, splits))
    return launches_of(matmul_tc=count("tc"),
                       matmul_tf32_split=2 * count("tc"),
                       matmul=count("tile"),
                       matmul_splitk_reduce=count("tile", True),
                       matmul_narrow=count("narrow"),
                       matmul_narrow_fold=count("narrow", True))


def train_products(calls, device) -> list:
    """The step's two matmul calls, each timed as the engine makes it (the
    relations' views, in place or with the op's copies) and on 2-D
    contiguous copies through the op's route (for X·W1 the tensor-core
    route: also its two split passes and ``matmul_tc_kernel`` alone; for
    a1·W2 the narrow kernel, one launch), the FFMA tile kernel with its
    split-K pass (the route both took before: kept as the earlier
    reading), the plain version and ``torch.matmul``, with the bounds (on
    the tensor-core route both: three TF32 products at the tensor cores'
    rate, one f32 product at the FFMA rate); the route's and the tile
    kernel's outputs held against the plain version within
    ``tolerance(k, f32)``."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    rows = []
    for (a, b, kw), name in zip(calls, ("first", "second")):
        m = math.prod(a.shape[:kw["a_rows"]])
        k = math.prod(a.shape[kw["a_rows"]:])
        n = math.prod(b.shape[kw["b_rows"]:])
        a2, b2 = a.reshape(m, k).contiguous(), b.reshape(k, n).contiguous()
        route = mm_ops.route(a2, b2, "kernel")
        ref = matmul_ref(a2, b2)
        rtol, atol = tolerance(k, torch.float32)
        errs = {}
        for what, fn in (("kernel", lambda: mm_ops.matmul(a2, b2,
                                                          impl="kernel")),
                         ("tile", lambda: tile_kernel(a2, b2))):
            out = fn()
            torch.cuda.synchronize(device)
            err = (out - ref).abs()
            if not bool(torch.isfinite(out).all()) or bool(
                    (err > atol + rtol * ref.abs()).any()):
                fail(f"train {name} product on the {what} route: max |err| "
                     f"{err.max().item()} over rtol={rtol} atol={atol}")
            errs[what] = err.max().item()
            del out, err
        del ref
        t_bytes, t_ops = bound_times(m, k, n, torch.float32, route)
        bnd, by = bound_of(t_bytes, t_ops)
        iters = 3 if k * n > 10 ** 8 else 10
        timed = {"kernel": lambda: mm_ops.matmul(a2, b2, impl="kernel"),
                 "in_place": lambda: mm_ops.matmul(a, b, **kw),
                 "tile": lambda: tile_kernel(a2, b2),
                 "plain": lambda: matmul_ref(a2, b2),
                 "library": lambda: torch.matmul(a2, b2)}
        row = {"product": name, "m": m, "k": k, "n": n, "route": route,
               "a_contiguous": a.is_contiguous(),
               "b_contiguous": b.is_contiguous(),
               "tile_splits": mm_ops.plan_launch(m, n, k, sms)[1],
               **{f"{what}_ms": timed_ms(fn, device, iters, warmup=1)
                  for what, fn in timed.items()},
               "bound_ms": bnd, "bound_by": by, "bytes_ms": t_bytes,
               "operations_ms": t_ops,
               "ffma_operations_ms": bound_times(m, k, n,
                                                 torch.float32)[1],
               "max_abs_err": errs["kernel"], "tile_max_abs_err": errs["tile"],
               "rtol": rtol, "atol": atol}
        if route == "narrow":
            nw = narrow_plan(m, k, n, sms)
            row.update({"narrow_splits": nw.splits,
                        "narrow_stages": nw.stages})
        if route == "tc":
            kp = mm_ops.tc_kp(k)
            sa = mm_ops.tf32_split(a2)
            sb = mm_ops.tf32_split(b2, transpose=True)
            s_bytes, s_ops = split_bound_times(m, k, n)
            row.update({
                "split_passes_ms": timed_ms(lambda: (
                    mm_ops.tf32_split(a2),
                    mm_ops.tf32_split(b2, transpose=True)),
                    device, iters, warmup=1),
                "split_plain_ms": timed_ms(lambda: (
                    tf32_split_ref(a2, kp), tf32_split_ref(b2, kp, True)),
                    device, iters, warmup=1),
                "split_max_abs_err": max(
                    (sa - tf32_split_ref(a2, kp)).abs().max().item(),
                    (sb - tf32_split_ref(b2, kp, True)).abs().max().item()),
                "split_bytes_ms": s_bytes, "split_operations_ms": s_ops,
                "tc_kernel_ms": timed_ms(lambda: mm_ops._tc_gemm(
                    sa, sb, m, n, torch.float32), device, iters, warmup=1)})
            if row["split_max_abs_err"] != 0.0:
                fail(f"train {name} product: the split passes differ from "
                     f"tf32_split_ref by {row['split_max_abs_err']}")
            del sa, sb
        rows.append(row)
        del a2, b2
    return rows


def phase_train(device) -> dict:
    """The §5.3 FFNN trains at speech-100k through the port's Engine,
    plan-level autodiff and ``TraTrainer`` (AdamW at ``TRAIN_LR``), X·W1 on
    the tensor-core route (two split passes, ``matmul_tc_kernel``), a1·W2
    on the narrow kernel (its split-K sum folded in the launch); step 1 at
    the check rates against the plain matmul and the f64 oracle."""
    from repro_torch.core import AdamW
    t0 = time.perf_counter()
    cfg, dims, dense = train_problem(device)
    data, params = train_relations(dims, dense)
    trainer = train_trainer(dims, params, AdamW(TRAIN_LR), device)
    torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t0
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    n, d, h, l_ = cfg.batch, cfg.d_in, cfg.d_hidden, cfg.d_out
    products = [(n, d, h), (n, h, l_)]
    routes, splits = train_routes(products, sms)
    torch.cuda.reset_peak_memory_stats(device)

    # -- the main path: every launch count is 0 just before, read just after
    reset_launches()
    step_ms, copies = [], []
    for _ in range(TRAIN_STEPS):
        c0 = mm_ops.COPIES
        torch.cuda.synchronize(device)
        s0 = time.perf_counter()
        trainer.step(**data)
        torch.cuda.synchronize(device)
        step_ms.append((time.perf_counter() - s0) * 1e3)
        copies.append(mm_ops.COPIES - c0)
    launches = read_launches()
    # ---------------------------------------------------------------------

    peak = torch.cuda.max_memory_allocated(device)
    eng = trainer.engine
    if eng.cache_misses != 1 or eng.cache_hits != TRAIN_STEPS - 1:
        fail(f"train: {eng.cache_misses} compiles and {eng.cache_hits} "
             f"cached dispatches in {TRAIN_STEPS} steps, expected 1 and "
             f"{TRAIN_STEPS - 1}")
    losses = list(trainer.history)
    if not all(math.isfinite(x) for x in losses) or \
            not losses[-1] < losses[0]:
        fail(f"train: losses {losses} not finite or not decreasing")
    # X and W1 read in place by the split passes, a1 and W2 by the narrow
    # kernel: no operand is copied
    expected = train_launches(routes, splits, TRAIN_STEPS)
    if launches != expected:
        fail(f"train: launches {launches} in {TRAIN_STEPS} steps, "
             f"expected {expected}")

    checks = first_step_checks(cfg, dims, dense, data, params, device)

    # one more step, profiled by kernel, with the matmul calls it makes
    calls, real = [], mm_ops.matmul

    def spy(a, b, **kw):
        calls.append((a, b, kw))
        return real(a, b, **kw)

    mm_ops.matmul = spy
    try:
        profile = device_profile(lambda: trainer.step(**data),
                                 TRAIN_GROUPS)
    finally:
        mm_ops.matmul = real
    if len(calls) != len(products):
        fail(f"train: {len(calls)} matmul calls in a step, expected "
             f"{len(products)}")
    rows = train_products(calls, device)
    del calls
    gen = torch.Generator(device=device).manual_seed(SEED + 2)
    reduce = reduce_case(n, h, l_, device, gen, iters=20)
    med = sorted(step_ms[1:])
    out = {"phase": "train", "path": TRAIN_PATH,
           "width": [d, h, l_], "batch": n, "dims": list(dims),
           "optimizer": f"AdamW({TRAIN_LR})",
           "check_optimizers": [f"AdamW({CHECK_LR})", f"SGD({SGD_LR})"],
           "steps": TRAIN_STEPS,
           "losses": losses, "step_ms": step_ms,
           "step_ms_median_2_to_5": (med[len(med) // 2]
                                     + med[(len(med) - 1) // 2]) / 2,
           "cache": {"misses": eng.cache_misses, "hits": eng.cache_hits},
           "launches": launches,
           "launches_per_step": {k: v / TRAIN_STEPS
                                 for k, v in launches.items() if v},
           "matmul_copies_per_step": copies,
           "routes": routes, "splits": splits,
           "max_memory_allocated_gb": peak / 1e9, "checks": checks,
           "profile_step": profile, "products": rows,
           "splitk_reduce": reduce, "setup_s": setup_s,
           "phase_s": time.perf_counter() - t0}
    emit(out)
    del trainer, data, params, dense
    torch.cuda.empty_cache()
    return out


def attention_pairs(sq: int, skv: int, causal: bool, window: int) -> int:
    """Unmasked (query, key) pairs of one head: the work this input needs
    (row i stands at key position i + skv - sq)."""
    pos = np.arange(sq, dtype=np.int64) + (skv - sq)
    hi = np.minimum(skv - 1, pos) if causal else np.full(sq, skv - 1)
    lo = np.maximum(0, pos - window + 1) if window > 0 else np.zeros(sq)
    return int(np.maximum(0, hi - lo + 1).sum())


def flash_bound_times(b, hq, hkv, sq, skv, d, dv, dtype, causal,
                      window) -> tuple:
    """(bytes_ms, operations_ms) of one attention call on an H100 SXM: q,
    k, v read once and the output written once at the HBM rate, against
    2·(d + dv) operations per unmasked pair at the type's peak."""
    isz = torch.tensor([], dtype=dtype).element_size()
    nbytes = (b * hq * sq * d + b * hkv * skv * (d + dv)
              + b * hq * sq * dv) * isz
    flops = 2.0 * (d + dv) * b * hq * attention_pairs(sq, skv, causal,
                                                      window)
    return nbytes / H100_SXM.hbm_bw * 1e3, flops / PEAK[dtype] * 1e3


def bf16_half_step(m: torch.Tensor) -> torch.Tensor:
    """Half the spacing of bf16 numbers at magnitude ``m``, in f64:
    2^(e-8) for |m| in [2^e, 2^(e+1)) (bf16 keeps 8 significant bits)."""
    m = m.double().abs().clamp_min(2.0 ** -126)
    _, e = torch.frexp(m)                 # m = f·2^e with f in [0.5, 1)
    return torch.ldexp(torch.ones_like(m), e - 9)


def exact_gate(o, exact, delta=GEMMA2_BF16_DELTA) -> dict:
    """``o`` (a bf16 output, any float type) against ``exact`` (the f64
    attention): the outputs further from the exact value than half a bf16
    step at the larger of the two magnitudes plus ``delta``
    (``crossings``), and the largest excess over half a step."""
    o = o.double()
    excess = (o - exact).abs() - bf16_half_step(torch.maximum(o.abs(),
                                                              exact.abs()))
    return {"crossings": int((excess > delta).sum()),
            "max_excess_over_half_step": excess.max().item(),
            "delta": delta}


def flash_errors(o, r, dtype, atol=None, exact=None) -> dict:
    """``o`` (the kernel's output) against ``r`` (the plain version's),
    both f32: elementwise within ``atol + rtol·|r|`` (both ``FLASH_TOL``,
    or ``atol`` alone when given) — or, when ``exact`` (the f64 attention)
    is given, within :func:`exact_gate` of it — and each row's error
    within ``ROW_REL_TOL`` of that row's norm.  ``fault`` says what
    failed, or is None."""
    rtol, atol = (FLASH_TOL[dtype],) * 2 if atol is None else (0.0, atol)
    err = (o - r).abs()
    # a fully masked row is 0 in both: 0 / tiny = 0
    row_rel = ((o - r).norm(dim=-1) / r.norm(dim=-1).clamp_min(1e-30)
               ).max().item()
    gate = exact_gate(o, exact) if exact is not None else None
    out = gate if gate else {"rtol": rtol, "atol": atol}
    fault = None
    if not bool(torch.isfinite(o).all()):
        fault = "output not finite"
    elif gate and gate["crossings"]:
        fault = (f"{gate['crossings']} outputs further than half a bf16 "
                 f"step + {gate['delta']} from the exact attention (largest "
                 f"excess {gate['max_excess_over_half_step']})")
    elif not gate and bool((err > atol + rtol * r.abs()).any()):
        fault = f"max |err| {err.max().item()} over rtol={rtol} atol={atol}"
    elif not row_rel <= ROW_REL_TOL[dtype]:
        fault = (f"a row's error is {row_rel} of its norm, over "
                 f"{ROW_REL_TOL[dtype]}")
    return {"max_abs_err": err.max().item(), **out, "max_row_rel_err": row_rel,
            "row_rel_tol": ROW_REL_TOL[dtype], "fault": fault}


def flash_case(b, hq, hkv, sq, skv, d, dv, dtype, kw, device, gen,
               iters=0, atol=None, exact=False) -> dict:
    """The kernel against ``attention_ref`` on one input
    (:func:`flash_errors`; elementwise against the f64 attention of the
    same inputs when ``exact``); timed (kernel, plain, bound) when
    ``iters`` > 0."""
    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=device).to(dtype)
    q, k, v = rnd(b, hq, sq, d), rnd(b, hkv, skv, d), rnd(b, hkv, skv, dv)
    before = (flash_ops.TC_LAUNCHES, flash_ops.FFMA_LAUNCHES)
    out = flash_ops.attention(q, k, v, impl="kernel", **kw)
    routed = (flash_ops.TC_LAUNCHES - before[0],
              flash_ops.FFMA_LAUNCHES - before[1])
    ref = attention_ref(q, k, v, **kw)
    torch.cuda.synchronize(device)
    name = f"attention b{b} h{hq}/{hkv} s{sq}/{skv} d{d}/{dv} {dtype} {kw}"
    if routed != ((1, 0) if dtype == torch.bfloat16 else (0, 1)):
        fail(f"{name}: (tensor-core, FFMA) launches {routed}")
    if tuple(out.shape) != (b, hq, sq, dv) or out.dtype != dtype:
        fail(f"{name}: got {tuple(out.shape)} {out.dtype}")
    o, r = out.float(), ref.float()
    del out, ref
    ex = exact_attention(q, k, v, rows=512, **kw) if exact else None
    errs = flash_errors(o, r, dtype, atol, ex)
    del ex
    fault = errs.pop("fault")
    if fault is not None:
        fail(f"{name}: {fault}")
    row = {"b": b, "hq": hq, "hkv": hkv, "sq": sq, "skv": skv, "d": d,
           "dv": dv, "dtype": str(dtype).split(".")[-1],
           "kernel": "wgmma" if routed[0] else "ffma", **kw, **errs,
           "max_abs_ref": r.abs().max().item(),
           "mean_abs_ref": r.abs().mean().item()}
    del o, r
    if iters:
        t_bytes, t_ops = flash_bound_times(b, hq, hkv, sq, skv, d, dv, dtype,
                                           kw["causal"], kw["window"])
        bnd, by = bound_of(t_bytes, t_ops)
        row.update({
            "kernel_ms": timed_ms(lambda: flash_ops.attention(
                q, k, v, impl="kernel", **kw), device, iters, warmup=1),
            "plain_ms": timed_ms(lambda: attention_ref(q, k, v, **kw),
                                 device, max(1, iters // 2), warmup=1),
            "bound_ms": bnd, "bound_by": by, "bytes_ms": t_bytes,
            "operations_ms": t_ops})
    return row


def gemma2_layer_kw(cfg, layer: int) -> dict:
    """The attention settings of one layer, as the model hands them on."""
    return {"causal": True,
            "window": _window_for(cfg, layer % group_size(cfg)),
            "softcap": cfg.attn_softcap}


def phase_flash(device, gen) -> dict:
    rows = []
    # the JAX kernel tests' cases (tests/test_kernels.py:47-76)
    for dtype in (torch.float32, torch.bfloat16):
        for hq, hkv in ((4, 4), (8, 2)):
            for causal, window, softcap in ((True, 0, 0.0), (True, 64, 0.0),
                                            (True, 0, 30.0),
                                            (False, 0, 0.0)):
                rows.append(flash_case(
                    2, hq, hkv, 256, 256, 64, 64, dtype,
                    {"causal": causal, "window": window, "softcap": softcap},
                    device, gen))
    # ragged lengths, sq < skv (ends aligned), dv != d
    causal = {"causal": True, "window": 0, "softcap": 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        rows.append(flash_case(2, 8, 4, 200, 200, 64, 64, dtype, causal,
                               device, gen))
        rows.append(flash_case(2, 8, 4, 1000, 1000, 64, 64, dtype,
                               {"causal": True, "window": 100,
                                "softcap": 30.0}, device, gen))
        rows.append(flash_case(2, 8, 4, 100, 300, 64, 64, dtype, causal,
                               device, gen))
        rows.append(flash_case(2, 8, 4, 200, 200, 192, 128, dtype, causal,
                               device, gen))
    for r in rows:
        emit({"phase": "flash", **r})
    # gemma2-2b's two layer shapes: bf16 as the model runs them, timed;
    # f32 at the same shapes, the global one timed (the FFMA kernel's row)
    cfg = get_config(ARCH)
    dims = (PROMPT_BATCH, cfg.n_heads, cfg.n_kv_heads, PROMPT_LEN,
            PROMPT_LEN, cfg.head_dim, cfg.head_dim)
    layers = {}
    for kind, layer in (("window", 0), ("global", 1)):
        kw = gemma2_layer_kw(cfg, layer)
        layers[kind] = flash_case(*dims, torch.bfloat16, kw, device, gen,
                                  iters=4, exact=True)
        emit({"phase": "flash", "at": f"{ARCH} {kind} layer",
              **layers[kind]})
        rows.append(flash_case(*dims, torch.float32, kw, device, gen,
                               iters=2 if kind == "global" else 0,
                               atol=FLASH_TOL[torch.float32]))
        emit({"phase": "flash", "at": f"{ARCH} {kind} layer, f32",
              **rows[-1]})
        if kind == "global":
            layers["global_f32"] = rows[-1]
    library = {dt: flash_library_case(*dims, dt, device, gen)
               for dt in (torch.bfloat16, torch.float32)}
    for row in library.values():
        emit({"phase": "flash", **row})
    rounding = flash_rounding(cfg, device)
    emit({"phase": "flash", **rounding})
    # zamba2-7b's shared attention (MHA 32/32 of dim 112, which the
    # tensor-core kernel pads to 128; causal, no window, no soft-cap), held
    # as gemma2's shapes are, from a generator of its own, so that the
    # later phases draw what they drew
    zgen = torch.Generator(device=device).manual_seed(SEED + 21)
    zdims, zkw = hybrid_attention(get_config(HYBRID_ARCH))
    layers["zamba2"] = flash_case(*zdims, torch.bfloat16, zkw, device, zgen,
                                  iters=4, exact=True)
    emit({"phase": "flash", "at": f"{HYBRID_ARCH} shared attention",
          **layers["zamba2"]})
    rows.append(flash_case(*zdims, torch.float32, zkw, device, zgen, iters=2,
                           atol=FLASH_TOL[torch.float32]))
    layers["zamba2_f32"] = rows[-1]
    emit({"phase": "flash", "at": f"{HYBRID_ARCH} shared attention, f32",
          **rows[-1]})
    zlib = flash_library_case(*zdims, torch.bfloat16, device, zgen,
                              at=f"{HYBRID_ARCH} shared attention shape")
    emit({"phase": "flash", **zlib})
    return {"rows": rows, "layers": layers, "library": library,
            "rounding": rounding, "zamba2_library": zlib}


def hybrid_attention(cfg) -> tuple:
    """The dims and settings of zamba2-7b's attention calls in the prefill
    (every shared-block application): (B, Hq, Hkv, Sq, Skv, D, Dv) and the
    keywords."""
    return ((HYBRID_BATCH, cfg.n_heads, cfg.n_kv_heads, PROMPT_LEN,
             PROMPT_LEN, cfg.head_dim, cfg.head_dim),
            {"causal": True, "window": 0, "softcap": cfg.attn_softcap})


def exact_attention(q, k, v, *, causal, window, softcap, scale=None,
                    rows=None):
    """``attention_ref``'s function computed in f64: the yardstick that
    both the kernel and the plain version round from.  Computed in blocks
    of ``rows`` query rows (all at once when None), so that the f64 scores
    of a long sequence stay within memory."""
    group = q.shape[1] // k.shape[1]
    scale = scale if scale is not None else q.shape[3] ** -0.5
    kd = k.double().repeat_interleave(group, 1)
    vd = v.double().repeat_interleave(group, 1)
    cols = torch.arange(k.shape[2], device=q.device)[None, :]
    step = rows or q.shape[2]
    out = []
    for r0 in range(0, q.shape[2], step):
        qb = q[:, :, r0:r0 + step].double()
        s = torch.einsum("bhqd,bhkd->bhqk", qb, kd) * scale
        if softcap > 0.0:
            s = softcap * torch.tanh(s / softcap)
        pos = torch.arange(r0, r0 + qb.shape[2], device=q.device)[:, None] \
            + (k.shape[2] - q.shape[2])
        mask = torch.ones_like(s[0, 0], dtype=torch.bool)
        if causal:
            mask &= pos >= cols
        if window > 0:
            mask &= pos - cols < window
        p = torch.softmax(s.masked_fill(~mask, float("-inf")),
                          -1).nan_to_num(0.0)
        del s
        out.append(torch.einsum("bhqk,bhkd->bhqd", p, vd))
    return torch.cat(out, 2)


def rounded_off(o, exact) -> int:
    """How many of ``o``'s elements differ from ``exact`` rounded to
    ``o``'s type."""
    return int((o != exact.to(o.dtype)).sum())


def flash_rounding(cfg, device, seeds: int = 8, s: int = 256) -> dict:
    """The bf16 kernel's rounding against the plain f32 version's, at
    gemma2-2b's head shape and soft-cap, causal, over the first ``s`` rows
    (``seeds`` draws): elements that differ from the correctly rounded
    f64 attention, within ``FLASH_ROUNDING_FACTOR`` of the plain count.
    (How often a fresh draw takes a kernel past the gemma2 gate:
    ``tools/flash_gate_census.py``.)"""
    kw = gemma2_layer_kw(cfg, 1)
    shapes = ((PROMPT_BATCH, cfg.n_heads, s, cfg.head_dim),
              (PROMPT_BATCH, cfg.n_kv_heads, s, cfg.head_dim),
              (PROMPT_BATCH, cfg.n_kv_heads, s, cfg.head_dim))
    kernel_off = plain_off = 0
    for i in range(seeds):
        g = torch.Generator(device=device).manual_seed(SEED + i)
        q, k, v = (torch.randn(sh, generator=g, device=device).bfloat16()
                   for sh in shapes)
        exact = exact_attention(q, k, v, **kw)
        kernel_off += rounded_off(
            flash_ops.attention(q, k, v, impl="kernel", **kw), exact)
        plain_off += rounded_off(attention_ref(q, k, v, **kw), exact)
    ratio = kernel_off / max(plain_off, 1)
    if not ratio <= FLASH_ROUNDING_FACTOR:
        fail(f"flash rounding: the bf16 kernel's outputs differ from the "
             f"exact ones {kernel_off} times, the plain version's "
             f"{plain_off}: {ratio:.2f}x > {FLASH_ROUNDING_FACTOR}")
    return {"at": f"{ARCH} head shape, first {s} rows, {seeds} seeds",
            "outputs": seeds * PROMPT_BATCH * cfg.n_heads * s * cfg.head_dim,
            "off_exact": {"wgmma": kernel_off, "plain": plain_off},
            "ratio": ratio, "limit": FLASH_ROUNDING_FACTOR}


def flash_library_case(b, hq, hkv, s, _, d, dv, dt, device, gen,
                       at=f"{ARCH} global layer shape, no soft-cap") -> dict:
    """The library yardstick: one PyTorch call computing the same function
    at one shape without soft-cap (gemma2's global shape: no single call
    applies the soft-cap), timed beside the kernel that ``dt`` routes
    to."""
    q = torch.randn((b, hq, s, d), generator=gen, device=device).to(dt)
    k = torch.randn((b, hkv, s, d), generator=gen, device=device).to(dt)
    v = torch.randn((b, hkv, s, dv), generator=gen, device=device).to(dt)
    nocap = {"causal": True, "window": 0, "softcap": 0.0}
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_out = sdpa(q, k, v, is_causal=True, enable_gqa=True)
    ker_out = flash_ops.attention(q, k, v, impl="kernel", **nocap)
    lib_err = (lib_out.float() - ker_out.float()).abs().max().item()
    del lib_out, ker_out
    iters = 4 if dt == torch.bfloat16 else 2
    return {
        "at": at,
        "dtype": str(dt).split(".")[-1],
        "kernel": "wgmma" if dt == torch.bfloat16 else "ffma",
        "library_call": "scaled_dot_product_attention(is_causal=True, "
                        "enable_gqa=True)",
        "library_ms": timed_ms(lambda: sdpa(q, k, v, is_causal=True,
                                            enable_gqa=True), device, iters,
                               warmup=1),
        "kernel_ms": timed_ms(lambda: flash_ops.attention(
            q, k, v, impl="kernel", **nocap), device, iters, warmup=1),
        "max_abs_diff": lib_err}


def device_profile(fn, groups=MODEL_GROUPS) -> dict:
    """Device time of ``fn()`` by kernel (``torch.profiler``), grouped by
    the first of ``groups`` whose name parts a kernel's name holds (by
    default the flash kernel, the SSD kernel, the GEMMs — cuBLAS:
    projections, MLP, unembedding) and the rest, beside the host-clock
    wall time of the profiled call."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels, launches = {}, 0
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            kernels[e.key] = kernels.get(e.key, 0.0) + \
                e.self_device_time_total / 1e3
            launches += e.count
    totals = {name: 0.0 for name, _ in groups}
    totals["other"] = 0.0
    for name, ms in kernels.items():
        low = name.lower()
        group = next((g for g, parts in groups
                      if any(p in low for p in parts)), "other")
        totals[group] += ms
    busy = sum(kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:8]
    return {"wall_ms": wall_ms, "kernel_launches": launches,
            "device_ms_by_group": totals,
            "device_ms_total": busy,
            "device_busy_share": busy / wall_ms if busy else None,
            "top_kernels_ms": [[n[:90], ms] for n, ms in top]}


def compare_with_plain(cfg, model, prompts, run, impls=("attn_impl",),
                       what_path="gemma2", limits=None) -> dict:
    """The same model with the plain versions of its kernels (``impls``:
    ``attn_impl`` for the attention, ``ssd_impl`` for the SSD scan), fed
    the kernel run's tokens: its prefill and first decode logits against
    the kernel run's (every logit finite, and within ``limits[what]``, by
    default ``0.02·(max|logit| + 1)``), the share of greedy tokens on
    which the two agree, and the host-clock time of the plain run's
    prefill."""
    from repro_torch.models import decode_step, prefill
    batch = prompts.shape[0]
    for attr in impls:
        setattr(model, attr, "plain")
    with torch.inference_mode():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plain_logits, cache = prefill(cfg, model, {"tokens": prompts},
                                      prompts.shape[1] + GEN)
        torch.cuda.synchronize()
        plain_prefill_ms = (time.perf_counter() - t0) * 1e3
        first_token = run.prefill_logits.argmax(-1)
        tok, agree, plain_first = first_token, 0, None
        for t in range(GEN):
            logits, cache = decode_step(cfg, model, cache, {"token": tok})
            if plain_first is None:
                plain_first = logits
            want = run.tokens[:, t:t + 1].to(prompts.device)
            agree += int((logits.argmax(-1) == want).sum())
            tok = want
    for attr in impls:
        setattr(model, attr, "auto")
    checks = {}
    for what, got, ref in (("prefill", run.prefill_logits, plain_logits),
                           ("decode_step_1", run.first_decode_logits,
                            plain_first)):
        shape = (batch, 1, cfg.vocab_size)
        if tuple(got.shape) != shape or not bool(torch.isfinite(got).all()):
            fail(f"{what_path} {what}: logits of shape {tuple(got.shape)} / "
                 f"not finite")
        diff = (got - ref).abs().max().item()
        bound = (limits[what] if limits else
                 0.02 * (ref.abs().max().item() + 1.0))
        checks[what] = {"max_abs_diff_vs_plain": diff, "bound": bound}
        if not diff <= bound:
            fail(f"{what_path} {what}: logits differ from the plain-kernel "
                 f"run by {diff} > {bound}")
    return {"checks": checks,
            "first_token_agrees": bool(torch.equal(
                first_token, plain_logits.argmax(-1))),
            "greedy_tokens_agree_share": agree / (batch * GEN),
            "plain_prefill_ms": plain_prefill_ms}


def launches_per_prefill(cfg) -> dict:
    """The model kernels' launches in one prefill of ``cfg``: flash
    attention once per attention layer (dense) or shared-block application
    (hybrid), the SSD scan once per Mamba2 layer (ssm, hybrid)."""
    flash = {"dense": cfg.n_layers, "ssm": 0,
             "hybrid": n_scan_groups(cfg)}[cfg.family]
    return {"flash_attention": flash,
            "ssd_scan": 0 if cfg.family == "dense" else cfg.n_layers}


def path_profiles(cfg, model, prompts, what_path="gemma2") -> dict:
    """One prefill, then 8 decode steps as ``dense_generate``'s loop takes
    them, each under the profiler, with the launches of the flash and SSD
    kernels (``ops.LAUNCHES``) in each: :func:`launches_per_prefill` in
    the prefill, none in decode."""
    ops = {"flash_attention": flash_ops, "ssd_scan": ssd_ops}
    from repro_torch.models import decode_step, prefill
    state = {}

    def prefill_once():
        state["logits"], state["cache"] = prefill(
            cfg, model, {"tokens": prompts}, prompts.shape[1] + 8)

    def decode_8_steps():
        cache, tok = state["cache"], state["logits"].argmax(-1)
        for _ in range(8):
            logits, cache = decode_step(cfg, model, cache, {"token": tok})
            tok = logits.argmax(-1)
            tok.cpu()

    def counts():
        return {name: m.LAUNCHES for name, m in ops.items()}

    with torch.inference_mode():
        n0 = counts()
        pre = device_profile(prefill_once)
        n1 = counts()
        dec = device_profile(decode_8_steps)
        n2 = counts()
    by_phase = {"prefill": {k: n1[k] - n0[k] for k in ops},
                "decode_8_steps": {k: n2[k] - n1[k] for k in ops}}
    want = {"prefill": launches_per_prefill(cfg),
            "decode_8_steps": {k: 0 for k in ops}}
    if by_phase != want:
        fail(f"{what_path}: kernel launches by phase {by_phase}; expected "
             f"{want}")
    return {"launches_by_phase": by_phase, "profile_prefill": pre,
            "profile_decode_8_steps": dec}


def decode_step_bound_ms(cfg, model, batch) -> float:
    """The least time of the last decode step: every weight read once,
    each attention's visible KV cache (PROMPT_LEN + GEN positions, or its
    window) read once, and each Mamba2 layer's conv and SSM state read and
    written once, at the HBM rate."""
    weight_bytes = sum(p.numel() * p.element_size()
                       for p in model.parameters())
    isz = model.embed["w"].element_size()
    seen = PROMPT_LEN + GEN
    k_and_v = 2 * batch * cfg.n_kv_heads * cfg.head_dim * isz
    if cfg.family == "dense":
        windows = [gemma2_layer_kw(cfg, i)["window"]
                   for i in range(cfg.n_layers)]
    else:
        windows = [0] * launches_per_prefill(cfg)["flash_attention"]
    cache_bytes = sum(k_and_v * (min(seen, w) if w else seen)
                      for w in windows)
    if cfg.family != "dense":
        gn = cfg.ssm_ngroups * cfg.ssm_state
        state = batch * (cfg.ssm_heads * cfg.ssm_state * cfg.ssm_head_dim * 4
                         + (cfg.ssm_conv_width - 1)
                         * (cfg.d_inner + 2 * gn) * isz)
        cache_bytes += 2 * cfg.n_layers * state
    return (weight_bytes + cache_bytes) / H100_SXM.hbm_bw * 1e3


def phase_gemma2(device) -> dict:
    from repro_torch.launch.serve import dense_generate
    from repro_torch.models import init_params
    cfg = get_config(ARCH)
    t0 = time.perf_counter()
    model = init_params(cfg, SEED, device=device)
    gen = torch.Generator(device=device).manual_seed(SEED)
    prompts = torch.randint(0, cfg.vocab_size, (PROMPT_BATCH, PROMPT_LEN),
                            generator=gen, device=device)
    torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t0
    dense_generate(cfg, model, prompts[:, :256], 2)     # warm: CUDA/cuBLAS
    torch.cuda.reset_peak_memory_stats(device)

    # -- the main path: every launch count is 0 just before, read just after
    reset_launches()
    run = dense_generate(cfg, model, prompts, GEN)
    launches = read_launches()
    # ---------------------------------------------------------------------

    peak = torch.cuda.max_memory_allocated(device)
    # one per layer, all on the tensor-core kernel and with no copy of q, k
    # or v; path_profiles shows a lone prefill makes them all
    expected = launches_of(flash_attention=cfg.n_layers,
                           flash_attention_wgmma=cfg.n_layers)
    if launches != expected:
        fail(f"gemma2: launches {launches}; expected {expected}")
    out = {"phase": "gemma2", "arch": ARCH, "layers": cfg.n_layers,
           "d_model": cfg.d_model, "vocab": cfg.vocab_size,
           "params": sum(p.numel() for p in model.parameters()),
           "batch": PROMPT_BATCH, "prompt_len": PROMPT_LEN, "gen": GEN,
           "launches": launches,
           "prefill_ms": run.prefill_s * 1e3,
           "decode_tok_per_s": PROMPT_BATCH * GEN / run.decode_s,
           "decode_ms_per_step": run.decode_s * 1e3 / GEN,
           "decode_step_bytes_bound_ms": decode_step_bound_ms(
               cfg, model, PROMPT_BATCH),
           "max_memory_allocated_gb": peak / 1e9,
           **compare_with_plain(cfg, model, prompts, run),
           "setup_s": setup_s, **path_profiles(cfg, model, prompts)}
    emit(out)
    return out


FLASH_CSRC = "src/repro_torch/kernels/flash_attention/csrc/"


def by_path(kernel: str, **paths) -> dict:
    """A kernel's launches on each main path that runs it."""
    return {paths[name]["arch"]: paths[name]["launches"][kernel]
            for name in paths}


def path_entry(layer: dict, **extra) -> dict:
    """One layer shape's numbers of a kernels-line entry."""
    return {**{k: layer[k] for k in ("kernel_ms", "plain_ms", "bound_ms",
                                     "bound_by")}, **extra}


def flash_entries(flash: dict, gemma2: dict, zamba2: dict) -> list:
    """The kernels line's two flash attention entries.  The tensor-core
    kernel (bf16, the main paths): one launch at gemma2-2b's global-layer
    shape, the window layer, zamba2-7b's shared attention and a whole
    prefill of each beside it.  The FFMA kernel (f32 only, off the main
    paths): one launch at gemma2's global shape and at zamba2's in f32."""
    cfg = get_config(ARCH)
    glob, win = flash["layers"]["global"], flash["layers"]["window"]
    g32 = flash["layers"]["global_f32"]
    z16, z32 = flash["layers"]["zamba2"], flash["layers"]["zamba2_f32"]
    zlib = flash["zamba2_library"]
    z_apps = zamba2["shared_block_applications"]
    n_win = sum(gemma2_layer_kw(cfg, i)["window"] > 0
                for i in range(cfg.n_layers))
    n_glob = cfg.n_layers - n_win
    lib, lib32 = (flash["library"][dt]
                  for dt in (torch.bfloat16, torch.float32))
    rows = {kind: [r for r in flash["rows"] + [glob, win, z16]
                   if r["kernel"] == kind] for kind in ("wgmma", "ffma")}
    shape = (f"B={PROMPT_BATCH}, Hq={cfg.n_heads}, Hkv={cfg.n_kv_heads}, "
             f"S={PROMPT_LEN}, D={cfg.head_dim}, causal, soft-cap "
             f"{cfg.attn_softcap}")
    common = {"route": "cuda",
              "replaces": "src/repro/kernels/flash_attention/kernel.py:96",
              "function": "flash_attention_pallas"}
    dp = flash_ops.padded_dim(z16["d"], z16["dv"])
    zshape = (f"B={HYBRID_BATCH}, Hq=Hkv={z16['hq']}, S={PROMPT_LEN}, "
              f"D={z16['d']} (padded to {dp}), causal, no soft-cap")
    zprefill = {"kernel_ms": zamba2["profile_prefill"]["device_ms_by_group"][
                    "flash_attention"],
                "launches": z_apps, "bound_ms": z_apps * z16["bound_ms"]}
    wgmma_paths = by_path("flash_attention_wgmma", gemma2=gemma2,
                          zamba2=zamba2)
    return [{
        "name": "flash_attention_wgmma", **common,
        "source": FLASH_CSRC + "flash_attention_wgmma.cu",
        "launches": sum(wgmma_paths.values()),
        "launches_by_path": wgmma_paths,
        "max_abs_err": max(r["max_abs_err"] for r in rows["wgmma"]),
        "ms": glob["kernel_ms"], "plain_ms": glob["plain_ms"],
        "bound_ms": glob["bound_ms"], "bound_by": glob["bound_by"],
        "library_ms": lib["library_ms"],
        "kernel_no_softcap_ms": lib["kernel_ms"],
        "library_call": lib["library_call"] + ", no soft-cap",
        "window_layer": {k: win[k] for k in ("kernel_ms", "plain_ms",
                                             "bound_ms", "bound_by")},
        "prefill": {
            "kernel_ms": gemma2["profile_prefill"]["device_ms_by_group"][
                "flash_attention"],
            "bound_ms": n_glob * glob["bound_ms"] + n_win * win["bound_ms"],
            "prefill_ms": gemma2["prefill_ms"],
            "plain_prefill_ms": gemma2["plain_prefill_ms"]},
        HYBRID_ARCH: path_entry(
            z16, library_ms=zlib["library_ms"],
            library_kernel_ms=zlib["kernel_ms"], prefill=zprefill,
            at=f"one launch at the shared attention's shape ({zshape}); "
               f"library_ms: the same function, library_kernel_ms the "
               f"kernel beside it; prefill: the kernel's device time in a "
               f"profiled prefill and its bound"),
        "at": f"bf16, the main path: one launch at the {ARCH} global-layer "
              f"shape ({shape}); library_ms and kernel_no_softcap_ms at "
              f"that shape with no soft-cap (no single PyTorch call "
              f"computes the soft-capped function); prefill: the kernel's "
              f"device time in a profiled prefill ({n_glob} global + "
              f"{n_win} window launches), their bound, and the prefill on "
              f"the kernel and on the plain attention"}, {
        "name": "flash_attention_ffma", **common,
        "source": FLASH_CSRC + "flash_attention.cu",
        "launches": sum(by_path("flash_attention_ffma", gemma2=gemma2,
                                zamba2=zamba2).values()),
        "max_abs_err": max(r["max_abs_err"] for r in rows["ffma"]),
        "ms": g32["kernel_ms"], "plain_ms": g32["plain_ms"],
        "bound_ms": g32["bound_ms"], "bound_by": g32["bound_by"],
        "library_ms": lib32["library_ms"],
        "kernel_no_softcap_ms": lib32["kernel_ms"],
        "library_call": lib32["library_call"] + ", f32, no soft-cap",
        HYBRID_ARCH: path_entry(z32, at=f"f32, {zshape}"),
        "at": f"f32 only, off the main path (0 launches there): one launch "
              f"at the {ARCH} global-layer shape in f32 ({shape}); the "
              f"bound at the f32 FFMA peak; library_ms and "
              f"kernel_no_softcap_ms at that shape with no soft-cap"}]


def ssd_inputs(b, s, h, p, n, dtype, device, gen, strided=True) -> tuple:
    """x, dt, A, B, C as the JAX kernel tests draw them (x, B, C normal in
    ``dtype``, dt = softplus(normal), A = -exp(normal), both f32); B and C
    are the two halves of one (b, s, 2n) tensor, as the model hands them
    over, unless ``strided`` is false."""
    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=device)
    x = rnd(b, s, h, p).to(dtype)
    dt = torch.nn.functional.softplus(rnd(b, s, h))
    A = -torch.exp(rnd(h))
    bcc = rnd(b, s, 2 * n).to(dtype)
    bm, cm = bcc[..., :n], bcc[..., n:]
    if not strided:
        bm, cm = bm.contiguous(), cm.contiguous()
    return x, dt, A, bm, cm


def ssd_errors(o, r, dtype) -> dict:
    """``o`` (the kernel's output) against ``r`` (the plain version's), both
    f32: max |err| within ``SSD_TOL·max|r|``, and each (b, s, h) row's
    error within ``SSD_ROW_TOL`` of that row's norm.  ``fault`` says what
    failed, or is None."""
    err = (o - r).abs()
    atol = SSD_TOL[dtype] * r.abs().max().item()
    row_rel = ((o - r).norm(dim=-1) / r.norm(dim=-1).clamp_min(1e-30)
               ).max().item()
    fault = None
    if not bool(torch.isfinite(o).all()):
        fault = "output not finite"
    elif not err.max().item() <= atol:
        fault = f"max |err| {err.max().item()} over {atol}"
    elif not row_rel <= SSD_ROW_TOL[dtype]:
        fault = (f"a row's error is {row_rel} of its norm, over "
                 f"{SSD_ROW_TOL[dtype]}")
    return {"max_abs_err": err.max().item(), "atol": atol,
            "max_row_rel_err": row_rel, "row_rel_tol": SSD_ROW_TOL[dtype],
            "fault": fault}


def ssd_bound_times(b, s, h, p, n, chunk, dtype) -> tuple:
    """(bytes_ms, operations_ms) of one SSD scan on an H100 SXM: x, dt, B,
    C read once and y written once at the HBM rate, against the unmasked
    work at the type's peak: C·B over the lower triangle of each chunk
    (once per batch row: B and C are shared by the heads), and per head
    the decayed scores times x·dt, C·h and the state update."""
    isz = torch.tensor([], dtype=dtype).element_size()
    nbytes = 2 * b * s * h * p * isz + b * s * h * 4 + 2 * b * s * n * isz \
        + h * 4
    lens = [min(chunk, s - s0) for s0 in range(0, s, chunk)]
    pairs = sum(L * (L + 1) // 2 for L in lens)
    flops = b * 2.0 * n * pairs + b * h * (2.0 * p * pairs
                                           + 4.0 * s * n * p)
    return nbytes / H100_SXM.hbm_bw * 1e3, flops / PEAK[dtype] * 1e3


def exact_ssd(x, dt, A, Bm, Cm, chunk) -> tuple:
    """``(y, h_S)`` of the plain chunked scan computed in f64 from the same
    inputs: the exact result that every per-call SSD check holds the
    kernels to (the f32 plain version sums C·Bᵀ as JAX does, and loses a
    few % of a row whose C_i·B_i cancels)."""
    return ssd_chunked_ref(*(t.double() for t in (x, dt, A, Bm, Cm)), chunk,
                           final_state=True)


def ssd_state_errors(hk, x, dt, A, bm, cm, dtype, exact=None) -> dict:
    """The kernel's final state ``hk`` against ``ssd_final_state`` on the
    same inputs, max |err| within ``SSD_TOL·max|h|``, and against the f64
    state ``exact`` (:func:`exact_ssd`'s, computed here when not given),
    within ``SSD_STATE_TOL`` of its largest |h|; beside them,
    ``ssd_final_state``'s own distance to the f64 state (an f32 cumsum over
    the whole sequence, whose own rounding grows with S).  ``fault`` says
    what failed, or is None."""
    href = ssd_ops.ssd_final_state(x, dt, A, bm, cm)
    if exact is None:
        exact = exact_ssd(x, dt, A, bm, cm, min(128, x.shape[1]))[1]
    top = exact.abs().max().item()
    err = (hk - href).abs().max().item()
    atol = SSD_TOL[dtype] * href.abs().max().item()
    rel = (hk.double() - exact).abs().max().item() / top
    fault = None
    if not bool(torch.isfinite(hk).all()):
        fault = "final state not finite"
    elif not err <= atol:
        fault = f"final state: max |err| {err} over {atol}"
    elif not rel <= SSD_STATE_TOL:
        fault = (f"final state: {rel} of max|h| off the f64 state, over "
                 f"{SSD_STATE_TOL}")
    return {"state_max_abs_err": err, "state_atol": atol,
            "state_vs_f64_rel": rel, "state_f64_tol": SSD_STATE_TOL,
            "final_state_fn_vs_f64_rel":
                (href.double() - exact).abs().max().item() / top,
            "fault": fault}


def ssd_case(b, s, h, p, n, chunk, dtype, device, gen, iters=0,
             strided=True, state=False) -> dict:
    """The kernel that ``dtype`` routes to (bf16: the tensor-core kernel,
    f32: the FFMA kernel) against the exact result on one input
    (:func:`exact_ssd`, :func:`ssd_errors`); with ``state``, its final
    state from the same launch against ``ssd_final_state`` and the f64
    state (:func:`ssd_state_errors`); timed (kernel, plain, bound) when
    ``iters`` > 0."""
    x, dt, A, bm, cm = ssd_inputs(b, s, h, p, n, dtype, device, gen,
                                  strided)
    before = (ssd_ops.TC_LAUNCHES, ssd_ops.FFMA_LAUNCHES)
    out = ssd_ops.ssd_scan(x, dt, A, bm, cm, chunk=chunk, impl="kernel",
                           return_final_state=state)
    routed = (ssd_ops.TC_LAUNCHES - before[0],
              ssd_ops.FFMA_LAUNCHES - before[1])
    out, hk = out if state else (out, None)
    ref, exact_h = exact_ssd(x, dt, A, bm, cm, min(chunk, s))
    torch.cuda.synchronize(device)
    name = f"ssd_scan b{b} s{s} h{h} p{p} n{n} chunk{chunk} {dtype}"
    if routed != ((1, 0) if dtype == torch.bfloat16 else (0, 1)):
        fail(f"{name}: (tensor-core, FFMA) launches {routed}")
    if out.shape != x.shape or out.dtype != dtype:
        fail(f"{name}: got {tuple(out.shape)} {out.dtype}")
    o, r = out.float(), ref.float()
    del out, ref
    errs = ssd_errors(o, r, dtype)
    fault = errs.pop("fault")
    if fault is not None:
        fail(f"{name}: {fault}")
    row = {"b": b, "s": s, "h": h, "p": p, "n": n, "chunk": chunk,
           "dtype": str(dtype).split(".")[-1], "bc_strided": strided,
           "kernel": "wgmma" if routed[0] else "ffma", **errs,
           "max_abs_ref": r.abs().max().item(),
           "mean_abs_ref": r.abs().mean().item()}
    del o, r
    if state:
        serr = ssd_state_errors(hk, x, dt, A, bm, cm, dtype, exact_h)
        if serr.pop("fault") is not None:
            fail(f"{name}: final state off ssd_final_state: {serr}")
        row.update(serr)
        del hk
    if iters:
        t_bytes, t_ops = ssd_bound_times(b, s, h, p, n, chunk, dtype)
        bnd, by = bound_of(t_bytes, t_ops)
        row.update({
            "kernel_ms": timed_ms(lambda: ssd_ops.ssd_scan(
                x, dt, A, bm, cm, chunk=chunk, impl="kernel"), device, iters,
                warmup=1),
            "plain_ms": timed_ms(lambda: ssd_chunked_ref(x, dt, A, bm, cm,
                                                         chunk),
                                 device, max(1, iters // 2), warmup=1),
            "bound_ms": bnd, "bound_by": by, "bytes_ms": t_bytes,
            "operations_ms": t_ops})
    return row


def phase_ssd(device, gen) -> dict:
    rows = []
    # the JAX kernel tests' cases (tests/test_kernels.py:107-139), ragged S,
    # S < chunk, N and P that are not multiples of 4, contiguous B and C;
    # bf16 through the tensor-core kernel, f32 through the FFMA kernel
    cases = [(2, 64, 4, 16, 8, 16), (2, 128, 4, 16, 8, 32),
             (2, 96, 4, 16, 8, 32), (1, 64, 2, 16, 8, 32),
             (1, 128, 2, 16, 8, 64), (2, 200, 4, 16, 8, 64),
             (2, 40, 3, 16, 8, 128), (1, 77, 2, 22, 13, 16)]
    for dtype in (torch.float32, torch.bfloat16):
        for c in cases:
            rows.append(ssd_case(*c, dtype, device, gen))
        rows.append(ssd_case(2, 300, 4, 64, 128, 128, dtype, device, gen,
                             strided=False))
    for r in rows:
        emit({"phase": "ssd", **r})
    # mamba2-130m's layer shape: bf16 as the model runs it, timed, with its
    # final state; f32 at the same shape through the FFMA kernel, timed
    cfg = get_config(SSM_ARCH)
    dims = (SSM_BATCH, PROMPT_LEN, cfg.ssm_heads, cfg.ssm_head_dim,
            cfg.ssm_state, cfg.ssm_chunk)
    layer = ssd_case(*dims, torch.bfloat16, device, gen, iters=4, state=True)
    emit({"phase": "ssd", "at": f"{SSM_ARCH} layer", **layer})
    layer32 = ssd_case(*dims, torch.float32, device, gen, iters=2)
    rows.append(layer32)
    emit({"phase": "ssd", "at": f"{SSM_ARCH} layer, f32", **layer32})
    # zamba2-7b's layer shape (N = 64: the state rows past N and the B/C
    # columns past it are zero fill), the same two ways, from a generator
    # of its own
    zcfg = get_config(HYBRID_ARCH)
    zgen = torch.Generator(device=device).manual_seed(SEED + 22)
    zdims = (HYBRID_BATCH, PROMPT_LEN, zcfg.ssm_heads, zcfg.ssm_head_dim,
             zcfg.ssm_state, zcfg.ssm_chunk)
    zlayer = ssd_case(*zdims, torch.bfloat16, device, zgen, iters=4,
                      state=True)
    emit({"phase": "ssd", "at": f"{HYBRID_ARCH} layer", **zlayer})
    zlayer32 = ssd_case(*zdims, torch.float32, device, zgen, iters=2)
    rows.append(zlayer32)
    emit({"phase": "ssd", "at": f"{HYBRID_ARCH} layer, f32", **zlayer32})
    return {"rows": rows, "layer": layer, "layer_f32": layer32,
            "zamba2_layer": zlayer, "zamba2_layer_f32": zlayer32}


def ssd_layer_checks(cfg, model, prompts, what_path="mamba2") -> dict:
    """One prefill in which every SSD call is also computed exactly
    (:func:`exact_ssd`) on the inputs the main path hands the kernel (each
    layer's real x, dt, A, B, C): each layer's output within the SSD limits
    of the exact y (:func:`ssd_errors`) and the final state from the same
    launch within them of ``ssd_final_state`` and of the exact state
    (:func:`ssd_state_errors`).  Beside them, not gated, the row errors
    against the exact y of the FFMA kernel (on the inputs cast to f32, an
    exact cast, its y rounded to their type), of the plain version in f32
    (the model's plain path: JAX's arithmetic, whose f32 sum of a
    cancelling C_i·B_i loses a few % of a row), and of the exact y rounded
    to the inputs' type (the floor of any output in that type)."""
    import repro_torch.models.layers as model_layers
    from repro_torch.models import prefill
    kernel_scan = model_layers.ssd_scan
    rows = []

    def checked(x, dt, A, Bm, Cm, *, chunk, impl, return_final_state=False):
        y, hk = kernel_scan(x, dt, A, Bm, Cm, chunk=chunk, impl=impl,
                            return_final_state=True)
        ey, eh = exact_ssd(x, dt, A, Bm, Cm, chunk)
        r = ey.float()
        errs = ssd_errors(y.float(), r, x.dtype)
        serr = ssd_state_errors(hk, x, dt, A, Bm, Cm, x.dtype, eh)
        ffma = ssd_ops._launch(x.float(), dt, A, Bm.float(), Cm.float(),
                               chunk, "ffma").to(x.dtype)
        plain = ssd_chunked_ref(x, dt, A, Bm, Cm, chunk)

        def row_err(o):
            return ssd_errors(o.float(), r, x.dtype)["max_row_rel_err"]
        rows.append({**errs, **{k: v for k, v in serr.items()
                                if k != "fault"},
                     "fault": errs["fault"] or serr["fault"],
                     "max_abs_ref": r.abs().max().item(),
                     "ffma_max_row_rel_err": row_err(ffma),
                     "plain_f32_max_row_rel_err": row_err(plain),
                     "rounded_exact_max_row_rel_err": row_err(
                         ey.to(x.dtype))})
        return (y, hk) if return_final_state else y

    model_layers.ssd_scan = checked
    try:
        with torch.inference_mode():
            prefill(cfg, model, {"tokens": prompts}, prompts.shape[1] + 1)
    finally:
        model_layers.ssd_scan = kernel_scan
    faults = [(i, r["fault"]) for i, r in enumerate(rows) if r["fault"]]
    if len(rows) != cfg.n_layers or faults:
        fail(f"{what_path}: {len(rows)} SSD calls in a prefill; layers whose "
             f"kernel output or final state is off the exact result: "
             f"{faults}")
    worst = max(rows, key=lambda r: r["max_row_rel_err"])
    return {"layers_checked": len(rows),
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "max_abs_ref": max(r["max_abs_ref"] for r in rows),
            "max_row_rel_err": worst["max_row_rel_err"],
            "row_rel_tol": worst["row_rel_tol"],
            "ffma_max_row_rel_err": max(r["ffma_max_row_rel_err"]
                                        for r in rows),
            "plain_f32_max_row_rel_err": max(
                r["plain_f32_max_row_rel_err"] for r in rows),
            "rounded_exact_max_row_rel_err": max(
                r["rounded_exact_max_row_rel_err"] for r in rows),
            # the largest state error over its limit (SSD_TOL·max|h|)
            "state_err_over_limit": max(r["state_max_abs_err"]
                                        / r["state_atol"] for r in rows),
            "state_vs_f64_rel": max(r["state_vs_f64_rel"] for r in rows),
            "final_state_fn_vs_f64_rel": max(r["final_state_fn_vs_f64_rel"]
                                             for r in rows)}


def compare_f32_with_plain(cfg, model, prompts, what_path="mamba2",
                           tol=None) -> dict:
    """The model's weights in f32, through the kernels (f32 routes to the
    FFMA kernels: :func:`launches_per_prefill` of them a prefill, none on
    the tensor cores) and through their plain versions, on the same
    tokens: prefill and first decode logits within ``tol``, or within
    ``0.02·(max|logit| + 1)`` of the plain run's when ``tol`` is None.
    The model's decay erases the carried state within a chunk, so
    last-position logits cannot show a fault in the carried state:
    :func:`ssd_layer_checks` holds every layer's output instead."""
    import dataclasses

    from repro_torch.models import decode_step, prefill
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    # the model itself in f32 (a bf16 weight cast to f32 and back is the
    # same weight): zamba2-7b's weights in both types would hold 40 GB
    dtypes = [p.dtype for p in model.parameters()]
    model.float()
    model.cfg = cfg32
    per = launches_per_prefill(cfg)
    kernels = ("flash_attention_wgmma", "flash_attention_ffma",
               "ssd_scan_wgmma", "ssd_scan_ffma")
    logits = {}
    with torch.inference_mode():
        for impl in ("auto", "plain"):
            model.attn_impl = model.ssd_impl = impl
            before = read_launches()
            pre, cache = prefill(cfg32, model, {"tokens": prompts},
                                 prompts.shape[1] + 1)
            after = read_launches()
            routed = {k: after[k] - before[k] for k in kernels}
            want = {k: 0 for k in kernels}
            if impl == "auto":
                want["flash_attention_ffma"] = per["flash_attention"]
                want["ssd_scan_ffma"] = per["ssd_scan"]
            if routed != want:
                fail(f"{what_path} f32 {impl} prefill: launches {routed}, "
                     f"expected {want}")
            tok = logits["auto"][0].argmax(-1) if logits else pre.argmax(-1)
            step, _ = decode_step(cfg32, model, cache, {"token": tok})
            logits[impl] = (pre, step)
            del cache
    for p, dt in zip(model.parameters(), dtypes):
        p.data = p.data.to(dt)
    model.cfg, model.attn_impl, model.ssd_impl = cfg, "auto", "auto"
    checks = {"ffma_launches_per_prefill": {
        k: v for k, v in per.items() if v}}
    for i, what in enumerate(("prefill", "decode_step_1")):
        got, ref = logits["auto"][i], logits["plain"][i]
        if not bool(torch.isfinite(got).all()):
            fail(f"{what_path} f32 {what}: logits not finite")
        diff = (got - ref).abs().max().item()
        bound = tol if tol is not None else \
            0.02 * (ref.abs().max().item() + 1.0)
        checks[what] = {"max_abs_diff_vs_plain": diff, "bound": bound}
        if not diff <= bound:
            fail(f"{what_path} f32 {what}: logits differ from the plain run "
                 f"by {diff} > {bound}")
    return checks


def bf16_rounding_floor(cfg, model, prompts, first_token) -> dict:
    """How far the bf16 model's prefill and first decode logits (the step
    fed ``first_token``) move when only the rounding changes: with the
    plain versions of both kernels, the SSD scan in chunks of
    ``ssm_chunk / 2`` against chunks of ``ssm_chunk`` (the same function,
    summed in another order)."""
    import dataclasses

    from repro_torch.models import decode_step, prefill
    half = dataclasses.replace(cfg, ssm_chunk=cfg.ssm_chunk // 2)
    out = []
    model.attn_impl = model.ssd_impl = "plain"
    with torch.inference_mode():
        for c in (cfg, half):
            model.cfg = c
            pre, cache = prefill(c, model, {"tokens": prompts},
                                 prompts.shape[1] + 1)
            step, _ = decode_step(c, model, cache, {"token": first_token})
            out.append((pre, step))
            del cache
    model.cfg, model.attn_impl, model.ssd_impl = cfg, "auto", "auto"
    return {what: (out[0][i] - out[1][i]).abs().max().item()
            for i, what in enumerate(("prefill", "decode_step_1"))}


def phase_mamba2(device) -> dict:
    from repro_torch.launch.serve import dense_generate
    from repro_torch.models import init_params
    cfg = get_config(SSM_ARCH)
    t0 = time.perf_counter()
    model = init_params(cfg, SEED, device=device)
    gen = torch.Generator(device=device).manual_seed(SEED)
    prompts = torch.randint(0, cfg.vocab_size, (SSM_BATCH, PROMPT_LEN),
                            generator=gen, device=device)
    torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t0
    dense_generate(cfg, model, prompts[:, :256], 2)     # warm: CUDA/cuBLAS
    torch.cuda.reset_peak_memory_stats(device)

    # -- the main path: every launch count is 0 just before, read just after
    reset_launches()
    run = dense_generate(cfg, model, prompts, GEN)
    launches = read_launches()
    # ---------------------------------------------------------------------

    peak = torch.cuda.max_memory_allocated(device)
    # one per layer, all on the tensor-core kernel, none on the FFMA one
    # and no copy; path_profiles shows a lone prefill makes them all
    expected = launches_of(ssd_scan=cfg.n_layers,
                           ssd_scan_wgmma=cfg.n_layers)
    if launches != expected:
        fail(f"mamba2: launches {launches}; expected {expected}")
    floor = bf16_rounding_floor(cfg, model, prompts,
                                run.prefill_logits.argmax(-1))
    out = {"phase": "mamba2", "arch": SSM_ARCH, "layers": cfg.n_layers,
           "d_model": cfg.d_model, "d_inner": cfg.d_inner,
           "ssd_heads": cfg.ssm_heads, "state": cfg.ssm_state,
           "chunk": cfg.ssm_chunk, "vocab": cfg.vocab_size,
           "params": sum(p.numel() for p in model.parameters()),
           "batch": SSM_BATCH, "prompt_len": PROMPT_LEN, "gen": GEN,
           "launches": launches,
           "prefill_ms": run.prefill_s * 1e3,
           "decode_tok_per_s": SSM_BATCH * GEN / run.decode_s,
           "decode_ms_per_step": run.decode_s * 1e3 / GEN,
           "decode_step_bytes_bound_ms": decode_step_bound_ms(
               cfg, model, SSM_BATCH),
           "max_memory_allocated_gb": peak / 1e9,
           # bf16, held against the model's own rounding floor: see
           # phase 8 of the module docstring
           "bf16_rounding_floor": floor,
           "bf16_vs_plain_ssd": compare_with_plain(
               cfg, model, prompts, run, ("ssd_impl",), "mamba2",
               limits={k: BF16_FLOOR_FACTOR * v for k, v in floor.items()}),
           "f32_vs_plain_ssd": compare_f32_with_plain(
               cfg, model, prompts, tol=MAMBA2_F32_LOGIT_TOL),
           "ssd_per_layer_vs_plain": ssd_layer_checks(cfg, model, prompts),
           "setup_s": setup_s,
           **path_profiles(cfg, model, prompts, "mamba2")}
    emit(out)
    return out


def attention_checks(cfg, model, prompts, what_path) -> dict:
    """One prefill in which every attention call also runs the plain
    version and the exact f64 attention on the inputs the main path hands
    the kernel (each shared-block application's real q, k, v): each within
    the flash phase's gate (:func:`flash_errors`: half a bf16 step plus
    ``GEMMA2_BF16_DELTA`` of the exact attention, each row's error within
    ``ROW_REL_TOL`` of its norm).  Beside it, not gated, the same gate's
    crossings and largest excess of the plain version and of the FFMA
    kernel (on the inputs cast to f32, its output rounded to bf16)."""
    import repro_torch.models.layers as model_layers
    from repro_torch.models import prefill
    kernel_attention = model_layers.attention
    rows = []

    def checked(q, k, v, *, causal, window, softcap, impl):
        o = kernel_attention(q, k, v, causal=causal, window=window,
                             softcap=softcap, impl=impl)
        kw = {"causal": causal, "window": window, "softcap": softcap}
        r = attention_ref(q, k, v, **kw)
        ex = exact_attention(q, k, v, rows=512, **kw)
        ffma = flash_ops.attention(q.float(), k.float(), v.float(),
                                   impl="kernel", **kw).to(q.dtype)
        rows.append({**flash_errors(o.float(), r.float(), q.dtype, exact=ex),
                     "max_abs_ref": r.abs().max().item(),
                     "plain": exact_gate(r, ex), "ffma": exact_gate(ffma, ex)})
        return o

    model_layers.attention = checked
    try:
        with torch.inference_mode():
            prefill(cfg, model, {"tokens": prompts}, prompts.shape[1] + 1)
    finally:
        model_layers.attention = kernel_attention
    n = launches_per_prefill(cfg)["flash_attention"]
    faults = [(i, r["fault"]) for i, r in enumerate(rows) if r["fault"]]
    if len(rows) != n or faults:
        fail(f"{what_path}: {len(rows)} attention calls in a prefill "
             f"({n} expected); applications whose kernel output is off the "
             f"exact attention: {faults}")
    return {"applications_checked": len(rows),
            "crossings": sum(r["crossings"] for r in rows),
            "delta": GEMMA2_BF16_DELTA,
            "max_excess_over_half_step": max(r["max_excess_over_half_step"]
                                             for r in rows),
            "max_abs_err_vs_plain": max(r["max_abs_err"] for r in rows),
            "max_abs_ref": max(r["max_abs_ref"] for r in rows),
            "max_row_rel_err": max(r["max_row_rel_err"] for r in rows),
            "row_rel_tol": ROW_REL_TOL[torch.bfloat16],
            **{f"{name}_{k}": agg(r[name][k] for r in rows)
               for name in ("plain", "ffma")
               for k, agg in (("crossings", sum),
                              ("max_excess_over_half_step", max))}}


def phase_zamba2(device) -> dict:
    from repro_torch.launch.serve import dense_generate
    from repro_torch.models import init_params
    cfg = get_config(HYBRID_ARCH)
    t0 = time.perf_counter()
    model = init_params(cfg, SEED, device=device)
    gen = torch.Generator(device=device).manual_seed(SEED)
    prompts = torch.randint(0, cfg.vocab_size, (HYBRID_BATCH, PROMPT_LEN),
                            generator=gen, device=device)
    torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t0
    dense_generate(cfg, model, prompts[:, :256], 2)     # warm: CUDA/cuBLAS
    torch.cuda.reset_peak_memory_stats(device)

    # -- the main path: every launch count is 0 just before, read just after
    reset_launches()
    run = dense_generate(cfg, model, prompts, GEN)
    launches = read_launches()
    # ---------------------------------------------------------------------

    peak = torch.cuda.max_memory_allocated(device)
    # one flash launch per shared-block application and one SSD launch per
    # Mamba2 layer, all on the tensor cores: no FFMA launch, no copy of q, k
    # or v, no cast of dt or A; path_profiles shows a lone prefill makes
    # them all
    per = launches_per_prefill(cfg)
    expected = launches_of(flash_attention=per["flash_attention"],
                           flash_attention_wgmma=per["flash_attention"],
                           ssd_scan=per["ssd_scan"],
                           ssd_scan_wgmma=per["ssd_scan"])
    if launches != expected:
        fail(f"zamba2: launches {launches}; expected {expected}")
    t_checks = time.perf_counter()

    def progress(what: str) -> None:
        """A line after each check: its seconds and the memory in use."""
        emit({"phase": "zamba2", "done": what,
              "s": time.perf_counter() - t_checks,
              "allocated_gb": torch.cuda.memory_allocated(device) / 1e9})

    progress("main path")
    floor = bf16_rounding_floor(cfg, model, prompts,
                                run.prefill_logits.argmax(-1))
    progress("rounding floor")
    checks = {
        "bf16_vs_plain": compare_with_plain(
            cfg, model, prompts, run, ("attn_impl", "ssd_impl"), "zamba2",
            limits={k: BF16_FLOOR_FACTOR * v for k, v in floor.items()})}
    progress("bf16 against the plain versions")
    checks["f32_vs_plain"] = compare_f32_with_plain(cfg, model, prompts,
                                                    "zamba2")
    progress("f32 against the plain versions")
    checks["ssd_per_layer_vs_plain"] = ssd_layer_checks(cfg, model, prompts,
                                                        "zamba2")
    progress("SSD per layer")
    checks["attention_per_application_vs_exact"] = attention_checks(
        cfg, model, prompts, "zamba2")
    progress("attention per application")
    out = {"phase": "zamba2", "arch": HYBRID_ARCH,
           "mamba_layers": cfg.n_layers,
           "shared_block_applications": per["flash_attention"],
           "shared_blocks": cfg.n_shared_blocks, "d_model": cfg.d_model,
           "d_inner": cfg.d_inner, "ssd_heads": cfg.ssm_heads,
           "state": cfg.ssm_state, "chunk": cfg.ssm_chunk,
           "heads": [cfg.n_heads, cfg.n_kv_heads], "head_dim": cfg.head_dim,
           "d_ff": cfg.d_ff, "vocab": cfg.vocab_size,
           "params": sum(p.numel() for p in model.parameters()),
           "batch": HYBRID_BATCH, "prompt_len": PROMPT_LEN, "gen": GEN,
           "launches": launches,
           "prefill_ms": run.prefill_s * 1e3,
           "decode_tok_per_s": HYBRID_BATCH * GEN / run.decode_s,
           "decode_ms_per_step": run.decode_s * 1e3 / GEN,
           "decode_step_bytes_bound_ms": decode_step_bound_ms(
               cfg, model, HYBRID_BATCH),
           "max_memory_allocated_gb": peak / 1e9,
           # bf16, held against the model's own rounding floor, as mamba2's
           "bf16_rounding_floor": floor, **checks,
           "setup_s": setup_s,
           **path_profiles(cfg, model, prompts, "zamba2")}
    emit(out)
    return out


SSD_CSRC = "src/repro_torch/kernels/ssd_scan/csrc/"


def ssd_entries(ssd: dict, mamba2: dict, zamba2: dict) -> list:
    """The kernels line's two SSD scan entries.  The tensor-core kernel
    (bf16, the main paths): one launch at mamba2-130m's layer shape, one
    at zamba2-7b's, and a whole prefill of each.  The FFMA kernel (f32
    only, off the main paths): one launch at each layer shape in f32."""
    cfg = get_config(SSM_ARCH)
    layer, layer32 = ssd["layer"], ssd["layer_f32"]
    z16, z32 = ssd["zamba2_layer"], ssd["zamba2_layer_f32"]
    rows = {kind: [r for r in ssd["rows"] + [layer, z16]
                   if r["kernel"] == kind] for kind in ("wgmma", "ffma")}
    zshape = (f"B={z16['b']}, S={z16['s']}, H={z16['h']}, P={z16['p']}, "
              f"N={z16['n']}, L={z16['chunk']}")
    zprefill = {"kernel_ms": zamba2["profile_prefill"]["device_ms_by_group"][
                    "ssd_scan"],
                "launches": zamba2["mamba_layers"],
                "bound_ms": zamba2["mamba_layers"] * z16["bound_ms"],
                "prefill_ms": zamba2["prefill_ms"],
                "plain_prefill_ms": zamba2["bf16_vs_plain"][
                    "plain_prefill_ms"]}
    wgmma_paths = by_path("ssd_scan_wgmma", mamba2=mamba2, zamba2=zamba2)
    shape = (f"B={SSM_BATCH}, S={PROMPT_LEN}, H={cfg.ssm_heads}, "
             f"P={cfg.ssm_head_dim}, N={cfg.ssm_state}, L={cfg.ssm_chunk}")
    common = {"route": "cuda",
              "replaces": "src/repro/kernels/ssd_scan/kernel.py:73",
              "function": "ssd_scan_pallas", "library_ms": None,
              "library_call": "none: no single PyTorch call computes the "
                              "chunked SSD scan"}
    return [{
        "name": "ssd_scan_wgmma", **common,
        "source": SSD_CSRC + "ssd_scan_wgmma.cu",
        "launches": sum(wgmma_paths.values()),
        "launches_by_path": wgmma_paths,
        "max_abs_err": max(r["max_abs_err"] for r in rows["wgmma"]),
        "ms": layer["kernel_ms"], "plain_ms": layer["plain_ms"],
        "bound_ms": layer["bound_ms"], "bound_by": layer["bound_by"],
        "state_vs_f64_rel": layer["state_vs_f64_rel"],
        "prefill": {
            "kernel_ms": mamba2["profile_prefill"]["device_ms_by_group"][
                "ssd_scan"],
            "bound_ms": cfg.n_layers * layer["bound_ms"],
            "prefill_ms": mamba2["prefill_ms"],
            "plain_prefill_ms": mamba2["bf16_vs_plain_ssd"][
                "plain_prefill_ms"]},
        HYBRID_ARCH: path_entry(
            z16, state_vs_f64_rel=z16["state_vs_f64_rel"], prefill=zprefill,
            at=f"one launch at the layer shape ({zshape}; dt/A f32), final "
               f"state not asked; prefill: the kernel's device time in a "
               f"profiled prefill (each launch with its final state), their "
               f"bound, and the prefill on both kernels and on both plain "
               f"versions"),
        "at": f"bf16, the main path: one launch at the {SSM_ARCH} layer "
              f"shape ({shape}; dt/A f32), final state not asked; "
              f"the bound counts C·B once per batch row and the causal half "
              f"of each chunk; prefill: the kernel's device time in a "
              f"profiled prefill ({cfg.n_layers} launches, each with its "
              f"final state), their bound, and the prefill on the kernel "
              f"and on the plain SSD"}, {
        "name": "ssd_scan", **common,
        "source": SSD_CSRC + "ssd_scan.cu",
        "launches": sum(by_path("ssd_scan_ffma", mamba2=mamba2,
                                zamba2=zamba2).values()),
        "max_abs_err": max(r["max_abs_err"] for r in rows["ffma"]),
        "ms": layer32["kernel_ms"], "plain_ms": layer32["plain_ms"],
        "bound_ms": layer32["bound_ms"], "bound_by": layer32["bound_by"],
        HYBRID_ARCH: path_entry(z32, at=f"f32, {zshape}"),
        "at": f"ssd_scan_kernel, f32 only, off the main path (0 launches "
              f"there): one launch at the {SSM_ARCH} layer shape in f32 "
              f"({shape}), the bound at the f32 FFMA peak"}]


MATMUL_CU = "src/repro_torch/kernels/matmul/csrc/matmul.cu"
MATMUL_WGMMA_CU = "src/repro_torch/kernels/matmul/csrc/matmul_wgmma.cu"
MATMUL_NARROW_CU = "src/repro_torch/kernels/matmul/csrc/matmul_narrow.cu"


def matmul_entries(rows, reduce_rows, skinny, serve, train) -> list:
    """The kernels line's seven matmul entries.  The skinny kernel and its
    fold at one scorer dispatch at bucket 8 (the serving path: both
    products, read in place as the engine calls them; the fold inside the
    second product's launch).  The tensor-core kernel and its split passes
    at the train path's X·W1, the narrow kernel at its a1·W2 (speech-100k,
    N 10000), with their launches there.  The tile kernel and its split-K
    pass, off both paths, at a1·W2 (their route before the narrow kernel);
    beside the tile kernel, as before, X·W1 and the scorer's two products
    on it."""
    first, second = serve["products_b8"]
    b = first["m"]
    both = (first, second)
    bnd, by = bound_of(sum(p["bytes_ms"] for p in both),
                       sum(p["operations_ms"] for p in both))
    red = next(r for r in reduce_rows if r["m"] == b)
    folds = [r for r in skinny if r["case"].startswith("fold")]
    shapes = (f"({b}x{first['k']})@({first['k']}x{first['n']}) + "
              f"({b}x{second['k']})@({second['k']}x{second['n']})")
    tp = train["products"]
    tc = next(p for p in tp if p["route"] == "tc")
    narrow = next(p for p in tp if p["route"] == "narrow")
    tshape = f"({narrow['m']}x{narrow['k']})@({narrow['k']}x{narrow['n']})"
    tcshape = f"({tc['m']}x{tc['k']})@({tc['k']}x{tc['n']})"
    sbnd, sby = bound_of(tc["split_bytes_ms"], tc["split_operations_ms"])
    tred = train["splitk_reduce"]
    tgroups = train["profile_step"]["device_ms_by_group"]
    common = {"route": "cuda", "source": MATMUL_CU,
              "replaces": "src/repro/kernels/matmul/kernel.py:39"}
    wgmma = {**common, "source": MATMUL_WGMMA_CU}
    tile_paths = {"scorer": serve["launches"]["matmul"],
                  TRAIN_PATH: train["launches"]["matmul"]}
    tc_paths = {"scorer": serve["launches"]["matmul_tc"],
                TRAIN_PATH: train["launches"]["matmul_tc"]}
    split_paths = {"scorer": serve["launches"]["matmul_tf32_split"],
                   TRAIN_PATH: train["launches"]["matmul_tf32_split"]}
    narrow_paths = {"scorer": serve["launches"]["matmul_narrow"],
                    TRAIN_PATH: train["launches"]["matmul_narrow"]}
    reduce_paths = {"scorer": serve["launches"]["matmul_splitk_reduce"],
                    TRAIN_PATH: train["launches"]["matmul_splitk_reduce"]}
    return [{
        "name": "matmul_skinny", **common, "function": "matmul_pallas",
        "launches": serve["launches"]["matmul_skinny"],
        "launches_by_path": {"scorer": serve["launches"]["matmul_skinny"],
                             TRAIN_PATH: train["launches"]["matmul_skinny"]},
        "max_abs_err": max([p["max_abs_err"] for p in both]
                           + [r["max_abs_err"] for r in skinny
                              if not r["case"].startswith("fold")]
                           + [r["max_abs_err"] for r in rows
                              if r["route"] == "skinny"]),
        "ms": sum(p["in_place_device_ms"] for p in both),
        "plain_ms": sum(p["plain_device_ms"] for p in both),
        "bound_ms": bnd, "bound_by": by,
        "library_ms": sum(p["torch_matmul_on_copy_device_ms"] for p in both),
        "library_call": "torch.matmul on each product's copied 2-D operands",
        "events_ms": sum(p["in_place_ms"] for p in both),
        "library_events_ms": sum(p["torch_matmul_on_copy_ms"] for p in both),
        "first_product_ms": first["in_place_device_ms"],
        "first_product_library_ms": first["torch_matmul_on_copy_device_ms"],
        "first_product_bound_ms": first["bound_ms"],
        "at": f"one scorer dispatch at bucket {b}, f32: {shapes}, each "
              f"product read in place as the engine calls it (W1 as the "
              f"blocked view {first['b_view']['shape']}); the second's time "
              f"includes its fold; ms, plain_ms, library_ms: device time "
              f"(torch.profiler); *events_ms: CUDA events over back-to-back "
              f"calls, host work included"}, {
        "name": "matmul_skinny_fold", **common,
        "function": "matmul_pallas (its f32 accumulation over the K grid)",
        "launches": serve["launches"]["matmul_fold"],
        "max_abs_err": max(r["max_abs_err"] for r in folds),
        "ms": second["in_place_device_ms"],
        "plain_ms": second["plain_device_ms"],
        "bound_ms": second["bound_ms"], "bound_by": second["bound_by"],
        "library_ms": second["torch_matmul_on_copy_device_ms"],
        "library_call": "torch.matmul on the copied 2-D operands",
        "events_ms": second["in_place_ms"],
        "library_events_ms": second["torch_matmul_on_copy_ms"],
        "at": f"the fold runs inside matmul_skinny's launch for "
              f"({b}x{second['k']})@({second['k']}x{second['n']}): ms is "
              f"that whole launch's device time, fold included; "
              f"max_abs_err is the fold against splitk_reduce_ref of its "
              f"own partial tiles"}, {
        "name": "matmul_tc", **wgmma, "function": "matmul_pallas",
        "launches": sum(tc_paths.values()), "launches_by_path": tc_paths,
        "max_abs_err": max([r["max_abs_err"] for r in rows
                            if r["route"] == "tc"] + [tc["max_abs_err"]]),
        "ms": tc["tc_kernel_ms"], "plain_ms": tc["plain_ms"],
        "bound_ms": tc["bound_ms"], "bound_by": tc["bound_by"],
        "library_ms": tc["library_ms"],
        "library_call": "torch.matmul (TF32 off)",
        "ffma_bound_ms": tc["ffma_operations_ms"],
        "route_ms": tc["kernel_ms"], "in_place_ms": tc["in_place_ms"],
        "tile_kernel_ms": tc["tile_ms"],
        "kernel_ms_in_profiled_step": tgroups["matmul_tc"],
        "at": f"matmul_tc_kernel alone on the split operands of the train "
              f"path's X·W1 {tcshape}, CUDA events over back-to-back calls; "
              f"bound: three TF32 products at the tensor cores' rate "
              f"(ffma_bound_ms: one f32 product at the FFMA rate); "
              f"route_ms: the two split passes and the kernel on 2-D "
              f"operands, in_place_ms: as the engine calls the op; "
              f"tile_kernel_ms: the same product on matmul_tile_kernel, "
              f"X·W1's route before"}, {
        "name": "matmul_tf32_split", **wgmma,
        "function": "matmul_pallas (its f32 operands, read as two TF32 "
                    "terms each)",
        "launches": sum(split_paths.values()),
        "launches_by_path": split_paths,
        "max_abs_err": tc["split_max_abs_err"],
        "ms": tc["split_passes_ms"], "plain_ms": tc["split_plain_ms"],
        "bound_ms": sbnd, "bound_by": sby, "library_ms": None,
        "library_call": None,
        "kernel_ms_in_profiled_step": tgroups["tf32_split"],
        "at": f"both split passes of the train path's X·W1 {tcshape} (X, "
              f"and W1 transposed), CUDA events; max_abs_err against "
              f"tf32_split_ref (torch bit operations); no PyTorch call "
              f"computes it"}, {
        "name": "matmul_narrow", **common, "source": MATMUL_NARROW_CU,
        "function": "matmul_pallas",
        "launches": sum(narrow_paths.values()),
        "launches_by_path": narrow_paths,
        "folding_launches_by_path": {
            "scorer": serve["launches"]["matmul_narrow_fold"],
            TRAIN_PATH: train["launches"]["matmul_narrow_fold"]},
        "max_abs_err": narrow["max_abs_err"],
        "ms": narrow["kernel_ms"], "plain_ms": narrow["plain_ms"],
        "bound_ms": narrow["bound_ms"], "bound_by": narrow["bound_by"],
        "library_ms": narrow["library_ms"],
        "library_call": "torch.matmul",
        "in_place_ms": narrow["in_place_ms"],
        "tile_kernel_ms": narrow["tile_ms"],
        "kernel_ms_in_profiled_step": tgroups["matmul_narrow"],
        "splits": narrow["narrow_splits"], "stages": narrow["narrow_stages"],
        "at": f"matmul_narrow_kernel at the train path's a1·W2 {tshape} on "
              f"2-D contiguous operands, CUDA events over back-to-back "
              f"calls, its split-K fold included; in_place_ms: as the "
              f"engine calls the op (a1 and W2 read in place); "
              f"tile_kernel_ms: the same product on matmul_tile_kernel and "
              f"its split-K pass, a1·W2's route before; max_abs_err "
              f"against the plain version in f32"}, {
        "name": "matmul", **common, "function": "matmul_pallas",
        "launches": sum(tile_paths.values()),
        "launches_by_path": tile_paths,
        "max_abs_err": max([r.get("tile_max_abs_err", r["max_abs_err"])
                            for r in rows]
                           + [p["tile_max_abs_err"] for p in tp]),
        "ms": narrow["tile_ms"], "plain_ms": narrow["plain_ms"],
        "bound_ms": narrow["bound_ms"], "bound_by": narrow["bound_by"],
        "library_ms": narrow["library_ms"],
        "library_call": "torch.matmul",
        TRAIN_PATH: {
            "products": [{key: p[key] for key in (
                "m", "k", "n", "route", "tile_splits", "kernel_ms",
                "in_place_ms", "tile_ms", "plain_ms", "library_ms",
                "bound_ms", "bound_by", "ffma_operations_ms")}
                for p in tp],
            "kernel_ms_in_profiled_step": tgroups["matmul_tile"],
            "step_ms_median": train["step_ms_median_2_to_5"],
            "copies_per_step": train["matmul_copies_per_step"]},
        "x_w1_on_tile_kernel": {
            "ms": tc["tile_ms"], "bound_ms": tc["ffma_operations_ms"],
            "bound_by": "operations", "plain_ms": tc["plain_ms"],
            "library_ms": tc["library_ms"],
            "at": f"{tcshape} on matmul_tile_kernel (FFMA), off the main "
                  f"path since the tensor-core route took it"},
        "scorer_products_on_copies": {
            "ms": sum(p["tile_kernel_on_copy_device_ms"] for p in both),
            "plain_ms": sum(p["plain_device_ms"] for p in both),
            "bound_ms": bnd, "bound_by": by,
            "library_ms": sum(p["torch_matmul_on_copy_device_ms"]
                              for p in both),
            "events_ms": sum(p["tile_kernel_on_copy_ms"] for p in both),
            "at": f"the scorer dispatch's products {shapes} on the copied "
                  f"2-D operands (off the serving path); device times"},
        "at": f"matmul_tile_kernel (bf16 only since the narrow kernel; off "
              f"both paths): the train path's a1·W2 {tshape} on 2-D "
              f"contiguous operands, CUDA events over back-to-back calls, "
              f"its split-K pass included, the route a1·W2 took before"}, {
        "name": "matmul_splitk_reduce", **common,
        "function": "matmul_pallas (its f32 accumulation over the K grid)",
        "launches": sum(reduce_paths.values()),
        "launches_by_path": reduce_paths,
        "max_abs_err": max(r["max_abs_err"] for r in reduce_rows + [tred]),
        "ms": tred["kernel_ms"], "plain_ms": tred["plain_ms"],
        "bound_ms": tred["bound_ms"], "bound_by": tred["bound_by"],
        "library_ms": tred["library_ms"], "library_call": "sum(0)",
        "kernel_ms_in_profiled_step": tgroups["splitk_reduce"],
        "scorer": {key: red[key] for key in (
            "splits", "m", "n", "of_product_k", "kernel_ms", "plain_ms",
            "library_ms", "bound_ms", "bound_by")},
        "at": f"the tile kernel's split-K pass (off both paths since the "
              f"narrow kernel folds a1·W2's sum): the {tred['splits']} "
              f"partial sums of ({tred['m']}x{tred['of_product_k']})@("
              f"{tred['of_product_k']}x{tred['n']}); scorer: at the "
              f"scorer's second product"}]


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
    skinny = phase_skinny(device, d_in, d_hidden, d_out)
    flash = phase_flash(device, gen)
    serve = phase_serve(device)
    train = phase_train(device)
    gemma2 = phase_gemma2(device)
    ssd = phase_ssd(device, gen)
    mamba2 = phase_mamba2(device)
    zamba2 = phase_zamba2(device)
    emit({"kernels": [*matmul_entries(rows, reduce_rows, skinny, serve,
                                      train),
                      *flash_entries(flash, gemma2, zamba2),
                      *ssd_entries(ssd, mamba2, zamba2)]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
