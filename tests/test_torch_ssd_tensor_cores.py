"""Port parity: the SSD scan's route and final state, and the tensor-core
kernel's arithmetic (``repro_torch.kernels.ssd_scan``), on the CPU.

A call goes by the type of x, B and C (``ops.route``): bf16 to the
tensor-core kernel, f32 to the FFMA kernel, CPU tensors to the plain
version.  ``ssd_scan(..., return_final_state=True)`` is held against
JAX's ``ssd_scan`` and ``ssd_final_state`` at 1e-5.  A plain-torch model
of the tensor-core kernel's arithmetic (``csrc/ssd_scan_wgmma.cu``) pins
its number of bf16 terms against the smoke's bf16 limits, and the smoke's
final-state gate is shown to catch a state at bf16 precision.  The
kernels themselves run only on a card: ``tests/test_torch_kernels_gpu.py``.
"""
import functools
import pathlib
import re

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.kernels.ssd_scan.ops import (  # noqa: E402
    ssd_final_state as jax_final_state, ssd_scan as jax_ssd_scan)
from repro_torch.kernels.ssd_scan import ops  # noqa: E402
from repro_torch.kernels.ssd_scan.ref import (  # noqa: E402
    ssd_chunked_ref, ssd_ref)
from _torch_helpers import as_np, chip_smoke, ssd_pair  # noqa: E402


@pytest.mark.parametrize("s,chunk", [(64, 32), (100, 32), (40, 64)])
def test_return_final_state_matches_jax_on_the_cpu(s, chunk):
    """The plain route returns the state its chunked scan carries: against
    JAX's ``ssd_final_state`` (computed apart, as JAX's prefill does) at
    1e-5, and y against JAX's ``ssd_scan`` within 1e-5 of the largest |y|
    (an output sums terms of either sign, so the rounding of two f32
    orders scales with the largest output, as the smoke's SSD limits do:
    elementwise, one output of 12800 at S=100 lies 1.3e-5 off); y is the
    same as without the state."""
    js, ts = ssd_pair(2, s, 4, 16, 8, seed=7)
    y, h = ops.ssd_scan(*ts, chunk=chunk, return_final_state=True)
    assert h.dtype == torch.float32 and tuple(h.shape) == (2, 4, 8, 16)
    np.testing.assert_array_equal(as_np(y), as_np(ops.ssd_scan(*ts,
                                                               chunk=chunk)))
    np.testing.assert_allclose(as_np(h), as_np(jax_final_state(*js)),
                               rtol=1e-5, atol=1e-5)
    want = as_np(jax_ssd_scan(*js, chunk=chunk, impl="jnp"))
    np.testing.assert_allclose(as_np(y), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    np.testing.assert_allclose(as_np(h), as_np(ssd_ref(*ts)[1]), rtol=1e-5,
                               atol=1e-5)


def test_route_goes_by_dtype():
    """CPU tensors take the plain version; a kernel call goes by the type
    of x, B and C: bf16 to the tensor-core kernel, f32 to the FFMA
    kernel."""
    _, ts = ssd_pair(1, 16, 2, 8, 8)
    assert ops.route(*ts) == "plain"
    assert ops.route(*ts, impl="plain") == "plain"
    assert ops.route(*ts, impl="kernel") == "ffma"
    x, dt, A, bm, cm = ts
    b16 = (x.bfloat16(), dt, A, bm.bfloat16(), cm.bfloat16())
    assert ops.route(*b16) == "plain"
    assert ops.route(*b16, impl="kernel") == "tc"
    # a bf16 dt does not move the route: it is cast to f32 (counted)
    assert ops.route(x, dt.bfloat16(), A, bm, cm, impl="kernel") == "ffma"


# ------------------------------- the tensor-core kernel's arithmetic, modelled
def _split(t, terms):
    """``t`` (f32) as ``terms`` bf16 terms, hi first (each as f32)."""
    out, rest = [], t
    for _ in range(terms):
        hi = rest.bfloat16().float()
        out.append(hi)
        rest = rest - hi
    return out


def _tc_arithmetic(x, dt, A, Bm, Cm, chunk, terms):
    """``csrc/ssd_scan_wgmma.cu``'s rounding in plain torch, y in f32 and
    the final state: C·Bᵀ from the exact bf16 C and B; the scores with
    dt_j and exp(a_i - a_j) folded into their columns, in ``terms`` bf16
    terms, times the exact x; exp(a_i)·C·h with h in ``terms`` terms; the
    state update Bᵀ·x̃ with x̃ = exp(a_L - a_j)·dt_j·x_j in ``terms`` terms.
    Products of bf16 values are exact in f32, as on the tensor cores; the
    order of the f32 sums is torch's, not the tensor cores'."""
    b, s, h, p = x.shape
    hs = torch.zeros((b, h, Bm.shape[-1], p))
    ys = []
    for s0 in range(0, s, chunk):
        sl = slice(s0, min(s0 + chunk, s))
        xc, dtc = x[:, sl].float(), dt[:, sl].float()
        bc, cc = Bm[:, sl].float(), Cm[:, sl].float()
        L = xc.shape[1]
        a = torch.cumsum(dtc * A.float(), dim=1)
        tri = torch.ones((L, L), dtype=torch.bool).tril()[None, :, :, None]
        cb = torch.einsum("bin,bjn->bij", cc, bc)
        decay = torch.exp(torch.where(tri, a[:, :, None] - a[:, None], 0.0))
        scores = torch.where(tri, cb[..., None] * decay * dtc[:, None], 0.0)
        y = torch.exp(a)[..., None] * sum(
            torch.einsum("bin,bhnp->bihp", cc, t) for t in _split(hs, terms))
        y = y + sum(torch.einsum("bijh,bjhp->bihp", t, xc)
                    for t in _split(scores, terms))
        xt = xc * (torch.exp(a[:, -1:] - a) * dtc)[..., None]
        hs = hs * torch.exp(a[:, -1])[..., None, None] + sum(
            torch.einsum("bjn,bjhp->bhnp", bc, t) for t in _split(xt, terms))
        ys.append(y)
    return torch.cat(ys, dim=1), hs


def _kernel_terms() -> int:
    src = (pathlib.Path(ops.__file__).parent / "csrc" /
           "ssd_scan_wgmma.cu").read_text()
    return int(re.search(r"constexpr int TERMS = (\d+);", src).group(1))


def _row_errors(got, want):
    return (got - want).norm(dim=-1) / want.norm(dim=-1).clamp_min(1e-30)


@functools.lru_cache(maxsize=2)
def _layer_case(seed):
    """The smoke's bf16 inputs at mamba2-130m's layer statistics (S cut to
    512, B to 1) and the plain version's f32 y and final state, its bf16
    y, and its rounding floor (mean row distance of chunks of 64 to chunks
    of 128), computed once per seed for every number of terms."""
    gen = torch.Generator().manual_seed(seed)
    inputs = chip_smoke().ssd_inputs(1, 512, 24, 64, 128, torch.bfloat16,
                                      "cpu", gen)
    x, dt, A, bm, cm = inputs
    xf, bf, cf = x.float(), bm.float(), cm.float()
    want, want_h = ssd_chunked_ref(xf, dt, A, bf, cf, 128, final_state=True)
    floor = _row_errors(ssd_chunked_ref(xf, dt, A, bf, cf, 64), want).mean()
    want16 = ssd_chunked_ref(x, dt, A, bm, cm, 128).float()
    return inputs, want, want_h, want16, floor


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("terms", [1, 2, 3])
def test_three_bf16_terms_keep_the_tensor_core_products_at_f32_precision(
        terms, seed):
    """Why the tensor-core kernel feeds each f32 operand (the decayed
    scores, h, x̃) to ``wgmma`` as three bf16 terms.  At mamba2-130m's
    layer statistics (H=24, P=64, N=128, L=128, the smoke's bf16 inputs; S
    cut to 512 and B to 1) the model of its arithmetic, before y is
    rounded to bf16, must lie no further from the plain f32 version, on a
    mean over the output rows, than the plain version in chunks of 64 does
    (the rounding floor the smoke also measures): then its outputs round
    to bf16 as an f32 computation's do, and the smoke's per-layer row
    limit on 1.5 M real rows holds as it did for the f32 FFMA kernel.  One
    term lies ~2000x past that floor, two 2.5-3x past it (on an H100 a
    kernel with two terms read a row error of 1.5e-2 against the 1e-2
    limit at mamba2-130m's last layer), three ~10x below it.  The kernel's
    terms also meet the smoke's bf16 limits, and its final state lies
    within ``SSD_TOL[f32]`` of the plain scan's."""
    assert _kernel_terms() == 3
    smoke = chip_smoke()
    (x, dt, A, bm, cm), want, want_h, want16, floor = _layer_case(seed)
    y, h = _tc_arithmetic(x, dt, A, bm, cm, 128, terms)
    if terms < _kernel_terms():
        assert _row_errors(y, want).mean() > floor
        return
    assert _row_errors(y, want).mean() <= floor
    bf16 = smoke.ssd_errors(y.bfloat16().float(), want16, torch.bfloat16)
    assert bf16["fault"] is None
    assert (h - want_h).abs().max() <= smoke.SSD_TOL[torch.float32] * \
        want_h.abs().max()


@pytest.mark.parametrize("state", ["carried", "rounded-to-bf16",
                                   "one-term"])
def test_smoke_state_gate_holds_the_state_to_f32_precision(state):
    """``chip_smoke.py``'s final-state gate (``ssd_state_errors``) at
    mamba2-130m's layer statistics: the plain scan's carried f32 state
    passes; the same state rounded to bf16, or built with every f32
    operand in one bf16 term (the kernel's arithmetic at TERMS = 1), lies
    ~2e-3 of max|h| off the f64 state and fails ``SSD_STATE_TOL``, though
    it passes ``SSD_TOL`` against ``ssd_final_state``."""
    smoke = chip_smoke()
    (x, dt, A, bm, cm), _, want_h, _, _ = _layer_case(0)
    h = {"carried": lambda: want_h,
         "rounded-to-bf16": lambda: want_h.bfloat16().float(),
         "one-term": lambda: _tc_arithmetic(x, dt, A, bm, cm, 128, 1)[1]
         }[state]()
    got = smoke.ssd_state_errors(h, x, dt, A, bm, cm, torch.bfloat16)
    assert got["state_max_abs_err"] <= got["state_atol"]
    if state == "carried":
        assert got["fault"] is None
    else:
        assert "off the f64 state" in got["fault"]
        assert got["state_vs_f64_rel"] > 10 * smoke.SSD_STATE_TOL
