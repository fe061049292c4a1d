"""Where the time of the tensor-core SSD kernel goes, phase by phase.

    python3 tools/ssd_phase_profile.py          # on a card

Builds ``csrc/ssd_scan_wgmma.cu`` a second time with ``-DSSD_PHASES``,
which compiles in the kernel's phase marks: at each ``PHASE(k)`` the first
thread of each warpgroup adds the ``clock64()`` cycles since its last mark
to a counter of phase k, in shared memory.  It runs that build once at the
mamba2-130m layer shape (B=8, S=8192, H=24, P=64, N=128, L=128, bf16,
``chip_smoke.py``'s inputs), checks that it gives the built kernel's output
to the bit, and prints one JSON object: the built kernel's and the
profiled build's time (CUDA events), and each phase's share of the
cycles, averaged over the warpgroups.  A wait at a barrier counts to the
phase that ends after it.  The profiled library goes to the kernels'
git-ignored build directory.
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

SOURCE = ROOT / "src/repro_torch/kernels/ssd_scan/csrc/ssd_scan_wgmma.cu"

#: the phase that each ``PHASE(k)`` of the kernel ends, in k's order
PHASES = ["chunk start: a, dt, the wait for the chunk's tiles", "C·Bᵀ",
          "h's terms", "C·h", "the scores' terms", "S·x", "y out",
          "x̃'s terms", "state update"]


def main() -> int:
    if not torch.cuda.is_available():
        print("ssd_phase_profile: no CUDA device")
        return 1
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    marks = int(re.search(r"constexpr int PHASES = (\d+);",
                          SOURCE.read_text()).group(1))
    if marks != len(PHASES):
        raise SystemExit(f"ssd_phase_profile: the kernel has {marks} phases, "
                         f"this tool names {len(PHASES)}")
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib_path = build.BUILD_DIR / "libssd_scan_wgmma_phases.so"
    proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-DSSD_PHASES",
                           "-shared", "-o", str(lib_path), str(SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"nvcc failed:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(str(lib_path))
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    strides = ctypes.POINTER(ctypes.c_longlong)
    lib.repro_ssd_scan_tc.argtypes = [vp] * 7 + [strides, strides, i64,
                                                 strides, strides, strides] \
        + [i32] * 6 + [vp]
    lib.repro_ssd_set_phases.argtypes = [vp]

    dev = torch.device("cuda", 0)
    cfg = smoke.get_config(smoke.SSM_ARCH)
    b, s, h, p, n, chunk = (smoke.SSM_BATCH, smoke.PROMPT_LEN, cfg.ssm_heads,
                            cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_chunk)
    gen = torch.Generator(device=dev).manual_seed(smoke.SEED)
    x, dt, A, bm, cm = smoke.ssd_inputs(b, s, h, p, n, torch.bfloat16, dev,
                                        gen)
    y = torch.empty_like(x)
    grid = -(-h // 2) * b
    prof = torch.zeros((grid * 2, len(PHASES)), dtype=torch.int64,
                       device=dev)
    if lib.repro_ssd_set_phases(prof.data_ptr()) != 0:
        raise SystemExit("ssd_phase_profile: cannot set the counters")
    st = ops._strides

    def profiled():
        rc = lib.repro_ssd_scan_tc(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), bm.data_ptr(),
            cm.data_ptr(), y.data_ptr(), None, st(x), st(dt), A.stride(0),
            st(bm), st(cm), st(y), b, s, h, p, n, chunk,
            torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            raise SystemExit(f"launch failed: CUDA error {rc}")

    profiled_ms = smoke.timed_ms(profiled, dev, 5)
    kernel_ms = smoke.timed_ms(lambda: ops.ssd_scan(
        x, dt, A, bm, cm, chunk=chunk, impl="kernel"), dev, 5)
    prof.zero_()
    profiled()
    torch.cuda.synchronize(dev)
    same = torch.equal(y, ops.ssd_scan(x, dt, A, bm, cm, chunk=chunk,
                                       impl="kernel"))
    cycles = prof.double().mean(0)
    total = cycles.sum().item()
    print(json.dumps({
        "at": f"{smoke.SSM_ARCH} layer (B={b}, S={s}, H={h}, P={p}, N={n}, "
              f"L={chunk}), bf16",
        "device": torch.cuda.get_device_name(dev),
        "kernel_ms": kernel_ms, "profiled_ms": profiled_ms,
        "profiled_output_equal": same,
        "cycles_per_warpgroup": total,
        "share": {name: cycles[k].item() / total
                  for k, name in enumerate(PHASES)}}))
    return 0 if same else 1


if __name__ == "__main__":
    raise SystemExit(main())
