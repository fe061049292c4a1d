"""Port parity: the SSD scan (``repro_torch.kernels.ssd_scan``).

On the CPU the port's op takes its chunked plain version.  It is held
against the JAX package's chunked jnp op and its sequential ``ssd_ref`` at
the cases of ``tests/test_kernels.py:107-123`` (f32 1e-4, bf16 5e-2, as
there), against the Pallas kernel run in interpret mode at the cases of
``:125-139`` (1e-3), and at a ragged S and S < chunk, where JAX pads and
the port takes the last chunk short.  ``ssd_final_state`` and
``ssd_decode_step`` are held against JAX at 1e-4 (``:142-160``).  The
CUDA kernels themselves run only on a card: their tests are in
``tests/test_torch_kernels_gpu.py``; the route between them, the final
state and the tensor-core kernel's arithmetic are CPU-tested in
``tests/test_torch_ssd_tensor_cores.py``.  The last test shows that the
limits ``chip_smoke.py`` holds the kernels to at mamba2-130m's layer
shape catch small faults there.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.ssd_scan.kernel import ssd_scan_pallas  # noqa: E402
from repro.kernels.ssd_scan.ops import (  # noqa: E402
    ssd_decode_step as jax_decode_step, ssd_final_state as jax_final_state,
    ssd_scan as jax_ssd_scan)
from repro.kernels.ssd_scan.ref import ssd_ref as jax_ssd_ref  # noqa: E402
from repro_torch.kernels.ssd_scan import ops  # noqa: E402
from repro_torch.kernels.ssd_scan.ref import (  # noqa: E402
    ssd_chunked_ref, ssd_ref)
from _torch_helpers import (  # noqa: E402
    as_np, chip_smoke, normal, rng, ssd_pair)

DTYPES = {"float32": (jnp.float32, torch.float32, 1e-4),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 5e-2)}


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("s,chunk", [(64, 16), (128, 32), (96, 32)])
def test_plain_path_matches_jax_chunked_and_ref(s, chunk, dtype):
    """``tests/test_kernels.py:107-123``: dt in the inputs' dtype too."""
    js, ts = ssd_pair(2, s, 4, 16, 8, dtype, dt_dtype=dtype)
    before = ops.LAUNCHES
    got = ops.ssd_scan(*ts, chunk=chunk)            # CPU tensors → plain
    assert ops.LAUNCHES == before
    assert got.dtype == ts[0].dtype and got.shape == ts[0].shape
    tol = DTYPES[dtype][2]
    for want in (jax_ssd_scan(*js, chunk=chunk, impl="jnp"),
                 jax_ssd_ref(*js)[0]):
        np.testing.assert_allclose(as_np(got), as_np(want), rtol=tol,
                                   atol=tol)


@pytest.mark.parametrize("s,chunk", [(64, 32), (128, 64)])
def test_plain_path_matches_pallas_interpret(s, chunk):
    """``tests/test_kernels.py:125-139``."""
    js, ts = ssd_pair(1, s, 2, 16, 8)
    want = ssd_scan_pallas(*js, chunk=chunk, interpret=True)
    got = ops.ssd_scan(*ts, chunk=chunk)
    np.testing.assert_allclose(as_np(got), as_np(want), rtol=1e-3,
                               atol=1e-3)


@pytest.mark.parametrize("s,chunk", [(100, 32), (40, 64), (77, 16), (1, 16)],
                         ids=["ragged100/32", "s<chunk", "ragged77/16",
                              "s1"])
def test_ragged_s_matches_jax_padding(s, chunk):
    """JAX pads S to a multiple of the chunk; the port's last chunk is
    short.  The chunk boundaries are the same, so is the result."""
    js, ts = ssd_pair(2, s, 3, 16, 8, seed=1)
    got = ops.ssd_scan(*ts, chunk=chunk)
    np.testing.assert_allclose(
        as_np(got), as_np(jax_ssd_scan(*js, chunk=chunk, impl="jnp")),
        rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(as_np(got), as_np(jax_ssd_ref(*js)[0]),
                               rtol=1e-4, atol=1e-4)


def test_sequential_oracle_matches_jax():
    js, ts = ssd_pair(2, 50, 3, 8, 8, seed=2)
    h0 = normal(rng(3), (2, 3, 8, 8))
    jy, jh = jax_ssd_ref(*js, h0=jnp.asarray(h0))
    ty, th = ssd_ref(*ts, h0=torch.from_numpy(h0))
    np.testing.assert_allclose(as_np(ty), as_np(jy), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(as_np(th), as_np(jh), rtol=1e-5, atol=1e-5)


def test_final_state_and_decode_match_jax():
    """``tests/test_kernels.py:142-160``: the prefill state then four
    recurrent steps, against JAX's and against the full scan."""
    b, s, h, p, n = 2, 32, 4, 8, 8
    js, ts = ssd_pair(b, s + 4, h, p, n, seed=4)
    jh = jax_final_state(*[a[:, :s] if a.ndim > 1 else a for a in js])
    th = ops.ssd_final_state(*[a[:, :s] if a.dim() > 1 else a for a in ts])
    np.testing.assert_allclose(as_np(th), as_np(jh), rtol=1e-4, atol=1e-4)
    full, _ = ssd_ref(*ts)
    (jx, jdt, jA, jB, jC), (tx, tdt, tA, tB, tC) = js, ts
    for t in range(s, s + 4):
        jy, jh = jax_decode_step(jh, jx[:, t], jdt[:, t], jA, jB[:, t],
                                 jC[:, t])
        ty, th = ops.ssd_decode_step(th, tx[:, t], tdt[:, t], tA, tB[:, t],
                                     tC[:, t])
        assert ty.dtype == tx.dtype and th.dtype == torch.float32
        np.testing.assert_allclose(as_np(ty), as_np(jy), rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_allclose(as_np(th), as_np(jh), rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_allclose(as_np(ty), as_np(full[:, t]), rtol=1e-4,
                                   atol=1e-4)


def test_plain_impl_is_the_chunked_plain_version():
    _, ts = ssd_pair(1, 40, 2, 8, 8)
    np.testing.assert_array_equal(
        as_np(ops.ssd_scan(*ts, chunk=16, impl="plain")),
        as_np(ssd_chunked_ref(*ts, 16)))
    # chunk defaults to 256, taken as min(256, S), as in JAX
    np.testing.assert_array_equal(as_np(ops.ssd_scan(*ts)),
                                  as_np(ssd_chunked_ref(*ts, 40)))


@pytest.mark.parametrize("s", [512, 1000])
def test_chunk_256_and_128_are_the_same_scan(s):
    """The kernel runs a requested chunk of 256 (JAX's default) at its
    chunk of 128: the plain version in the two chunkings agrees within
    1e-5 of the largest |output| in f32 — the same recurrence, summed in
    another order.  (An output sums terms of either sign, and the chunk's
    decay exp(a_i − a_j) is taken from a cumsum that grows with the chunk,
    so the rounding scales with the largest output, as the smoke's SSD
    limits do.)"""
    _, ts = ssd_pair(2, s, 4, 16, 8, seed=6)
    a = as_np(ops.ssd_scan(*ts, chunk=256, impl="plain"))
    b = as_np(ops.ssd_scan(*ts, chunk=128, impl="plain"))
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-5 * np.abs(b).max())


def test_kernel_impl_on_cpu_raises_and_counts_nothing():
    """No silent fallback: CPU tensors never reach the plain version when
    the kernel is asked for, and nothing is counted."""
    _, ts = ssd_pair(1, 16, 2, 8, 8)
    before = (ops.LAUNCHES, ops.TC_LAUNCHES, ops.FFMA_LAUNCHES, ops.COPIES)
    with pytest.raises(ValueError, match="CUDA device"):
        ops.ssd_scan(*ts, impl="kernel")
    x, dt, A, bm, cm = ts
    with pytest.raises(ValueError, match="CUDA device"):
        ops.ssd_scan(x.bfloat16(), dt.bfloat16(), A, bm.bfloat16(),
                     cm.bfloat16(), impl="kernel", return_final_state=True)
    assert (ops.LAUNCHES, ops.TC_LAUNCHES, ops.FFMA_LAUNCHES,
            ops.COPIES) == before


def test_wrapper_rejects_what_the_kernel_does_not_take():
    _, (x, dt, A, bm, cm) = ssd_pair(1, 16, 2, 8, 8)
    with pytest.raises(ValueError, match=r"x \(B,S,H,P\)"):
        ops.ssd_scan(x[0], dt, A, bm, cm)
    with pytest.raises(ValueError, match="do not fit"):
        ops.ssd_scan(x, dt, A, bm, cm[..., :4])
    with pytest.raises(ValueError, match="do not fit"):
        ops.ssd_scan(x, dt[:, :8], A, bm, cm)
    with pytest.raises(TypeError):
        ops.ssd_scan(x, dt, A, bm.bfloat16(), cm)
    with pytest.raises(TypeError):
        ops.ssd_scan(x.double(), dt, A, bm.double(), cm.double())
    with pytest.raises(ValueError, match="chunk"):
        ops.ssd_scan(x, dt, A, bm, cm, chunk=0)
    with pytest.raises(ValueError, match="impl"):
        ops.ssd_scan(x, dt, A, bm, cm, impl="pallas")


# ---------------------------------------------- chip_smoke.py's SSD limits
def _faulty_chunked(x, dt, A, Bm, Cm, chunk, fault):
    """The chunked algorithm with one fault, standing in for a faulty
    kernel: the chunk's last step left out of the carried state (a chunk
    boundary one step off), the carried-state term dropped from y, or the
    decay rate 1% off."""
    b, s, h, p = x.shape
    Af = A.float() * (1.01 if fault == "decay*1.01" else 1.0)
    hs = torch.zeros((b, h, Bm.shape[-1], p))
    ys = []
    for s0 in range(0, s, chunk):
        sl = slice(s0, min(s0 + chunk, s))
        xc, dtc = x[:, sl].float(), dt[:, sl].float()
        bc, cc = Bm[:, sl].float(), Cm[:, sl].float()
        L = xc.shape[1]
        a = torch.cumsum(dtc * Af, dim=1)
        tri = torch.ones((L, L), dtype=torch.bool).tril()[None, :, :, None]
        m = torch.where(tri, torch.exp(torch.where(
            tri, a[:, :, None] - a[:, None], 0.0)), 0.0)
        xdt = xc * dtc[..., None]
        y = torch.einsum("bijh,bjhp->bihp",
                         torch.einsum("bin,bjn->bij", cc, bc)[..., None] * m,
                         xdt)
        if fault != "no-carried-state":
            y = y + torch.exp(a)[..., None] * torch.einsum(
                "bin,bhnp->bihp", cc, hs)
        w = torch.exp(a[:, -1:] - a) * dtc
        if fault == "boundary-off-by-one":
            w[:, -1] = 0.0
        hs = hs * torch.exp(a[:, -1])[..., None, None] + torch.einsum(
            "bjn,bjhp->bhnp", bc, xc * w[..., None])
        ys.append(y.to(x.dtype))
    return torch.cat(ys, dim=1)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("fault", ["none", "boundary-off-by-one",
                                   "no-carried-state", "decay*1.01"])
def test_smoke_limits_catch_small_faults_at_the_layer_shape(dtype, fault):
    """``chip_smoke.py``'s SSD limits at mamba2-130m's layer shape (H=24,
    P=64, N=128, L=128), S cut from 8192 to 1024 and B from 8 to 1, on the
    smoke's own inputs: the fault-free stand-in passes them, each fault
    fails them (a decay 1% off moves outputs by ~0.4% of the largest, less
    than the bf16 max-abs limit: the row limit catches it)."""
    smoke = chip_smoke()
    tdt = DTYPES[dtype][1]
    gen = torch.Generator().manual_seed(0)
    x, dt, A, bm, cm = smoke.ssd_inputs(1, 1024, 24, 64, 128, tdt, "cpu",
                                        gen)
    want = ssd_chunked_ref(x, dt, A, bm, cm, 128).float()
    got = _faulty_chunked(x, dt, A, bm, cm, 128, fault).float()
    errs = smoke.ssd_errors(got, want, tdt)
    if fault == "none":
        assert errs["fault"] is None
        assert smoke.ssd_errors(want, want, tdt)["fault"] is None
    else:
        assert errs["fault"] is not None
