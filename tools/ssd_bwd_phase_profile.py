"""Where the time of the SSD backward's tensor-core chunk kernel goes, phase
by phase.

    python3 tools/ssd_bwd_phase_profile.py          # on a card

Builds ``csrc/ssd_scan_bwd_wgmma.cu`` a second time with
``-DSSD_BWD_PHASES``, which compiles in the kernel's phase marks: at each
``PHASE(k)`` the first thread of each warpgroup adds the ``clock64()``
cycles since its last mark to a counter of phase k, in shared memory.  At
mamba2-130m's and zamba2-7b's train layers (``chip_smoke.py``'s bf16
inputs and shapes) it runs the built library's two state passes, then the
built chunk kernel and the profiled build on the same buffers, checks that
the two give the same dx, ddt and partials to the bit, and prints one JSON
object a layer: both builds' times (CUDA events, 10 launches each) and
each phase's share of the cycles of each warpgroup, averaged over the
blocks.  A wait at a barrier counts to the phase that ends after it.  The
profiled library goes to the kernels' git-ignored build directory.
"""
import ctypes
import importlib.util
import json
import pathlib
import re
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.ssd_scan import ops  # noqa: E402

SOURCE = ROOT / "src/repro_torch/kernels/ssd_scan/csrc/ssd_scan_bwd_wgmma.cu"

#: the phase that each ``PHASE(k)`` of the kernel ends, in k's order
PHASES = ["C·Bᵀ (the chunk's tiles, the product, into shared memory)",
          "pass i head start: x, dy, a, S_in's terms",
          "dy·xᵀ, W2, P's row sums", "W2∘dt's terms", "(W2∘dt)·B",
          "dy·S_inᵀ, C_iᵀ·S_in·dy_i, e",
          "pass j head start: x, dy, a, G's terms, <S_in, G>",
          "x·dyᵀ, W2ᵀ, P's column sums", "dt∘W2ᵀ's terms", "(dt∘W2ᵀ)·C",
          "W1ᵀ's terms", "W1ᵀ·dy", "B·G, dx out", "x·Gᵀ, B_jᵀ·G·x_j",
          "the vectors' wait, da, ddt", "the partials out"]


def events_ms(fn, iters=10) -> float:
    fn()
    torch.cuda.synchronize()
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def profile(smoke, lib, arch, batch, seq, dev) -> dict:
    cfg = smoke.get_config(arch)
    b, s, h, p, n, chunk = (batch, seq, cfg.ssm_heads, cfg.ssm_head_dim,
                            cfg.ssm_state, cfg.ssm_chunk)
    gen = torch.Generator(device=dev).manual_seed(smoke.SEED + 32)
    x, dt, A, bm, cm = smoke.ssd_inputs(b, s, h, p, n, torch.bfloat16, dev,
                                        gen)
    dy = torch.randn(x.shape, generator=gen, device=dev).to(torch.bfloat16)
    outs, (kernels, args, (_, bufs)) = ops._bwd_call(x, dt, A, bm, cm, dy,
                                                     chunk)
    built = ops._lib()
    entry = {name: getattr(built, e) for name, e, _ in kernels}
    for name in ("state", "dstate", "chunk"):
        if entry[name](*args) != 0:
            raise SystemExit(f"{name} kernel: launch error")
    # what the chunk kernel writes: dx, ddt, the partials of dB, dC and dA
    written = (outs[0], outs[1], bufs[2], bufs[3], bufs[4])
    want = [t.clone() for t in written]
    blocks = args[2][7] * -(-s // chunk) * b
    prof = torch.zeros((blocks * 2, len(PHASES)), dtype=torch.int64,
                       device=dev)
    if lib.repro_ssd_bwd_set_phases(prof.data_ptr()) != 0:
        raise SystemExit("repro_ssd_bwd_set_phases failed")
    if lib.repro_ssd_bwd_chunk_tc(*args) != 0:
        raise SystemExit("profiled chunk kernel: launch error")
    torch.cuda.synchronize()
    same = all(torch.equal(a, w) for a, w in zip(written, want))
    cycles = prof.view(blocks, 2, len(PHASES)).double().mean(0)
    ms = events_ms(lambda: entry["chunk"](*args))
    ms_prof = events_ms(lambda: lib.repro_ssd_bwd_chunk_tc(*args))
    return {"arch": arch, "b": b, "s": s, "h": h, "p": p, "n": n,
            "chunk": chunk, "splits": args[2][7], "blocks": blocks,
            "bit_equal": same, "kernel_ms": ms, "profiled_ms": ms_prof,
            "cycles_per_block": [float(c) for c in cycles.sum(1)],
            "share": {name: [float(cycles[w, k] / cycles[w].sum())
                             for w in range(2)]
                      for k, name in enumerate(PHASES)}}


def main() -> int:
    if not torch.cuda.is_available():
        print("ssd_bwd_phase_profile: no CUDA device")
        return 1
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    marks = int(re.search(r"constexpr int PHASES = (\d+);",
                          SOURCE.read_text()).group(1))
    if marks != len(PHASES):
        raise SystemExit(f"ssd_bwd_phase_profile: the kernel has {marks} "
                         f"phases, this tool names {len(PHASES)}")
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib_path = build.BUILD_DIR / "libssd_scan_bwd_phases.so"
    proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS,
                           "-DSSD_BWD_PHASES", "-shared", "-o",
                           str(lib_path), str(SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"nvcc failed:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(str(lib_path))
    vp = ctypes.c_void_p
    lib.repro_ssd_bwd_chunk_tc.argtypes = [
        ctypes.POINTER(vp), ctypes.POINTER(ctypes.c_longlong),
        ctypes.POINTER(ctypes.c_int), vp]
    lib.repro_ssd_bwd_set_phases.argtypes = [vp]
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    ok = True
    for arch, batch, seq in ((smoke.SSM_ARCH, smoke.SSM_TRAIN_BATCH,
                              smoke.SSM_TRAIN_SEQ),
                             (smoke.HYBRID_ARCH, smoke.HYBRID_TRAIN_BATCH,
                              smoke.HYBRID_TRAIN_SEQ)):
        row = profile(smoke, lib, arch, batch, seq, dev)
        row["nvidia_smi"] = smi
        print(json.dumps(row), flush=True)
        ok = ok and row["bit_equal"]
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
