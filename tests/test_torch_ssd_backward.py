"""Port parity: the gradient of the SSD scan
(``repro_torch.kernels.ssd_scan.ops.ssd_scan_bwd`` and ``ssd_scan`` under
autograd).

On the CPU both take the plain version, autograd through the chunked
plain scan (``ref.ssd_scan_bwd_ref``).  All five gradients (x, dt, A, B,
C) are held against ``jax.vjp`` of the JAX package's chunked jnp op
(``repro.kernels.ssd_scan.ops.ssd_scan(..., impl="jnp")``) and of its
sequential ``ssd_ref`` at the cases of ``tests/test_kernels.py:107-139``, a
ragged S and S < chunk: f32 within 1e-4, bf16 within 5e-2 (JAX's own
limits there), relative and absolute of the leaf's largest |gradient|.
The gradient through ``return_final_state=True`` and through
``ssd_final_state`` is held against ``jax.vjp`` of JAX's
``ssd_final_state``.  The state passes' plain version
(``ref.ssd_bwd_states_ref``) is held against JAX's jitted
``ssd_final_state`` on each chunk's prefix (S_in) and against the
per-step sum that defines G.  A kernel asked for on CPU tensors raises.

The backward kernels run only on a card (``tests/test_torch_kernels_gpu.py``,
``chip_smoke.py``, which holds them against the plain gradient in f64,
strong decay included).  Here the autograd wiring of the kernel route runs
with its launches replaced by the plain versions, and the smoke's SSD
limits, applied to the five gradients, pass the plain gradient in the
working type and catch planted faults: chunks cut apart (no state or state
cotangent carried) and a decay 1% off.
"""
from unittest import mock

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.ssd_scan.ops import (  # noqa: E402
    ssd_final_state as jax_final_state, ssd_scan as jax_ssd_scan)
from repro.kernels.ssd_scan.ref import ssd_ref as jax_ssd_ref  # noqa: E402
from repro_torch.kernels.ssd_scan import ops  # noqa: E402
from repro_torch.kernels.ssd_scan.ref import (  # noqa: E402
    ssd_bwd_states_ref, ssd_chunked_ref, ssd_scan_bwd_ref)
from _torch_helpers import as_np, chip_smoke, normal, rng, ssd_pair  # noqa: E402

TOL = {"float32": 1e-4, "bfloat16": 5e-2}
GRADS = ("x", "dt", "A", "B", "C")
#: (b, s, h, p, n, chunk, dt in the inputs' dtype): tests/test_kernels.py's
#: cases (:107-123 with dt rounded as there, :125-139), a ragged S and
#: S < chunk
CASES = [(2, 64, 4, 16, 8, 16, True), (2, 128, 4, 16, 8, 32, True),
         (2, 96, 4, 16, 8, 32, True), (1, 64, 2, 16, 8, 32, False),
         (1, 128, 2, 16, 8, 64, False), (2, 100, 3, 16, 8, 32, False),
         (2, 40, 3, 16, 8, 64, False)]
IDS = ["64/16", "128/32", "96/32", "pallas64/32", "pallas128/64",
       "ragged100/32", "s<chunk"]


def _close(got, want, tol, what):
    got, want = as_np(got).astype(np.float64), as_np(want).astype(np.float64)
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * max(np.abs(want).max(), 1e-30),
                               err_msg=what)


def _inputs(case, dtype, seed=0):
    b, s, h, p, n, chunk, dt_rounded = case
    js, ts = ssd_pair(b, s, h, p, n, dtype,
                      dt_dtype=dtype if dt_rounded else None, seed=seed)
    dy = normal(rng(seed + 100), (b, s, h, p))
    jdy = jnp.asarray(dy, js[0].dtype)
    tdy = torch.tensor(np.asarray(jdy.astype(jnp.float32))).to(ts[0].dtype)
    return js, ts, jdy, tdy, chunk


def _jax_grads(js, jdy, chunk):
    """``jax.vjp`` of the chunked jnp op and of the sequential oracle."""
    _, vjp = jax.vjp(lambda *a: jax_ssd_scan(*a, chunk=chunk, impl="jnp"),
                     *js)
    _, vjp_ref = jax.vjp(lambda *a: jax_ssd_ref(*a)[0], *js)
    return vjp(jdy), vjp_ref(jdy)


def _autograd(ts, tdy, chunk, **kw):
    leaves = [t.detach().clone().requires_grad_(True) for t in ts]
    y = ops.ssd_scan(*leaves, chunk=chunk, **kw)
    return torch.autograd.grad(y, leaves, tdy)


@pytest.mark.parametrize("route", ["ssd_scan_bwd", "autograd"])
@pytest.mark.parametrize("dtype", sorted(TOL))
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_plain_gradients_match_jax(case, dtype, route):
    js, ts, jdy, tdy, chunk = _inputs(case, dtype)
    before = (ops.LAUNCHES, ops.BWD_LAUNCHES, ops.COPIES)
    got = ops.ssd_scan_bwd(*ts, tdy, chunk=chunk) if route == "ssd_scan_bwd" \
        else _autograd(ts, tdy, chunk)
    assert (ops.LAUNCHES, ops.BWD_LAUNCHES, ops.COPIES) == before
    for g, t in zip(got, ts):
        assert g.dtype == t.dtype and g.shape == t.shape
    for want in _jax_grads(js, jdy, chunk):
        for name, g, w in zip(GRADS, got, want):
            _close(g, w, TOL[dtype], f"d{name}")


def test_plain_impl_and_auto_agree_bit_for_bit():
    _, ts, _, tdy, chunk = _inputs(CASES[5], "float32", seed=3)
    a = ops.ssd_scan_bwd(*ts, tdy, chunk=chunk)
    b = ops.ssd_scan_bwd(*ts, tdy, chunk=chunk, impl="plain")
    c = ssd_scan_bwd_ref(*ts, tdy, chunk)
    for x, y, z in zip(a, b, c):
        assert torch.equal(x, y) and torch.equal(x, z)
    # chunk defaults to 256, taken as min(256, S), as in the forward
    d = ops.ssd_scan_bwd(*ts, tdy)
    e = ssd_scan_bwd_ref(*ts, tdy, ts[0].shape[1])
    assert all(torch.equal(x, y) for x, y in zip(d, e))


@pytest.mark.parametrize("s,chunk", [(40, 16), (100, 32)])
def test_final_state_gradients_match_jax(s, chunk):
    """``return_final_state=True`` under autograd — y and the state, each
    with its own cotangent — and ``ssd_final_state`` alone, against
    ``jax.vjp`` of JAX's jnp op and ``ssd_final_state``."""
    js, ts = ssd_pair(2, s, 3, 16, 8, seed=5)
    r = rng(6)
    dy, dh = normal(r, (2, s, 3, 16)), normal(r, (2, 3, 8, 16))
    _, vjp = jax.vjp(lambda *a: (jax_ssd_scan(*a, chunk=chunk, impl="jnp"),
                                 jax_final_state(*a)), *js)
    want = vjp((jnp.asarray(dy), jnp.asarray(dh)))
    _, vjp_h = jax.vjp(jax_final_state, *js)
    want_h = vjp_h(jnp.asarray(dh))
    leaves = [t.clone().requires_grad_(True) for t in ts]
    y, h = ops.ssd_scan(*leaves, chunk=chunk, return_final_state=True)
    assert h.dtype == torch.float32 and h.shape == (2, 3, 8, 16)
    got = torch.autograd.grad((y, h), leaves, (torch.from_numpy(dy),
                                               torch.from_numpy(dh)))
    got_h = torch.autograd.grad(ops.ssd_final_state(*leaves), leaves,
                                torch.from_numpy(dh),
                                materialize_grads=True)   # dC = 0
    for name, g, w, gh, wh in zip(GRADS, got, want, got_h, want_h):
        _close(g, w, 1e-4, f"d{name}")
        _close(gh, wh, 1e-4, f"d{name} (final state)")


def test_state_buffers_match_jax_final_state_and_per_step_sum():
    """``ssd_bwd_states_ref`` at a ragged S of four chunks, on the same
    numpy inputs as JAX: each chunk's S_in against JAX's jitted
    ``ssd_final_state`` on the prefix before the chunk (both (B, H, N, P);
    0 for the first chunk), within 1e-5 of the largest |value| in f32; each
    chunk's G against Σ_{i past chunk c} exp(a_i − a_end)·C_i ⊗ dy_i, a_end
    the cumsum of dt·A at the chunk's last step, summed step by step in f64
    (numpy): the f32 G within 1e-5 of its largest |value|, the f64 one
    within 1e-12 (0 for the last chunk, exactly)."""
    b, s, h, p, n, chunk = 2, 100, 3, 16, 8, 32
    js, ts = ssd_pair(b, s, h, p, n, seed=14)
    dy = normal(rng(15), (b, s, h, p))
    sin, g = ssd_bwd_states_ref(*ts, torch.from_numpy(dy), chunk)
    g64 = ssd_bwd_states_ref(*(t.double() for t in ts),
                             torch.from_numpy(dy).double(), chunk)[1]
    nc = -(-s // chunk)
    assert sin.shape == g.shape == (b, nc, h, n, p)
    assert sin.dtype == g.dtype == torch.float32
    assert not sin[:, 0].any() and not g[:, -1].any()
    for c in range(1, nc):
        x, dt = (a[:, :c * chunk] for a in js[:2])
        bm, cm = (a[:, :c * chunk] for a in js[3:])
        want = np.asarray(jax_final_state(x, dt, js[2], bm, cm))
        np.testing.assert_allclose(sin[:, c].numpy(), want, rtol=0,
                                   atol=1e-5 * np.abs(want).max(),
                                   err_msg=f"S_in of chunk {c}")
    dt, A, cm = (np.asarray(a, np.float64) for a in (js[1], js[2], js[4]))
    a = np.cumsum(dt * A, axis=1)                              # (b, s, h)
    for c in range(nc):
        end = min((c + 1) * chunk, s) - 1
        want = np.zeros((b, h, n, p))
        for i in range(end + 1, s):
            w = np.exp(a[:, i] - a[:, end])                      # (b, h)
            want += np.einsum("bn,bh,bhp->bhnp", cm[:, i], w, dy[:, i])
        scale = max(np.abs(want).max(), 1e-30)
        np.testing.assert_allclose(g[:, c].numpy(), want, rtol=0,
                                   atol=1e-5 * scale, err_msg=f"G {c}")
        np.testing.assert_allclose(g64[:, c].numpy(), want, rtol=0,
                                   atol=1e-12 * scale, err_msg=f"G {c}")


def test_kernel_impl_on_cpu_raises_and_counts_nothing():
    """No silent fallback, with or without grad: ``impl="kernel"`` on CPU
    tensors raises before a cast or a launch is counted."""
    _, ts, _, tdy, chunk = _inputs(CASES[0], "bfloat16")
    before = (ops.LAUNCHES, ops.BWD_LAUNCHES, ops.COPIES)
    leaves = [t.clone().requires_grad_(True) for t in ts]
    with pytest.raises(ValueError, match="CUDA device"):
        ops.ssd_scan(*leaves, chunk=chunk, impl="kernel")
    with pytest.raises(ValueError, match="CUDA device"):
        ops.ssd_scan(*leaves, chunk=chunk, impl="kernel",
                     return_final_state=True)
    with pytest.raises(ValueError, match="CUDA device"):
        ops.ssd_scan_bwd(*ts, tdy, chunk=chunk, impl="kernel")
    with pytest.raises(ValueError, match="impl"):
        ops.ssd_scan_bwd(*ts, tdy, impl="pallas")
    assert (ops.LAUNCHES, ops.BWD_LAUNCHES, ops.COPIES) == before


def _plain_launch(x, dt, A, Bm, Cm, chunk, kernel, final_state=False):
    assert dt.dtype == A.dtype == torch.float32 and kernel == "tc"
    return ssd_chunked_ref(x, dt, A, Bm, Cm, min(chunk, ops.MAX_CHUNK),
                           final_state)


@pytest.mark.parametrize("final_state", [False, True])
def test_kernel_route_autograd_wiring(final_state):
    """The kernel route's ``torch.autograd.Function`` on the CPU, its
    launches replaced by the plain versions: the forward gets f32 dt and A
    (the bf16 dt's cast counted once), the backward gets the saved inputs
    and dy and returns the plain gradients, the bf16 dt's in bf16 through
    the cast; the final state under grad comes from ``ssd_final_state``."""
    _, ts, _, tdy, chunk = _inputs(CASES[0], "bfloat16", seed=7)
    calls = []

    def plain_bwd(x, dt, A, Bm, Cm, dy, chunk):
        calls.append((dt.dtype, A.dtype, chunk))
        return ssd_scan_bwd_ref(x, dt, A, Bm, Cm, dy,
                                min(chunk, ops.MAX_CHUNK))

    leaves = [t.clone().requires_grad_(True) for t in ts]
    copies = ops.COPIES
    with mock.patch.object(ops, "_on_one_card"), \
            mock.patch.object(ops, "_launch", _plain_launch), \
            mock.patch.object(ops, "_launch_bwd", plain_bwd):
        out = ops.ssd_scan(*leaves, chunk=chunk, impl="kernel",
                           return_final_state=final_state)
        y, h = out if final_state else (out, None)
        assert type(y.grad_fn).__name__ == "_SSDScanBackward"
        assert ops.COPIES == copies + 1          # dt, bf16
        got = torch.autograd.grad(y, leaves, tdy)
        assert calls == [(torch.float32, torch.float32, chunk)]
        via_bwd = ops.ssd_scan_bwd(*ts, tdy, chunk=chunk, impl="kernel")
    want = ssd_scan_bwd_ref(*ts, tdy, chunk)
    for g, v, w, t in zip(got, via_bwd, want, ts):
        assert g.dtype == v.dtype == t.dtype
        assert torch.equal(g, w) and torch.equal(v, w)
    if final_state:
        assert torch.equal(h, ops.ssd_final_state(*ts))


# ---------------------------------------- chip_smoke.py's SSD backward limits
def _planted(ts, tdy, chunk, fault):
    """The plain gradient with a fault planted: ``"decay*1.01"`` (A taken
    1% off) or ``"chunks-cut"`` (each chunk's gradient alone: no state
    carried into a chunk, no state cotangent carried back)."""
    x, dt, A, Bm, Cm = ts
    if fault == "decay*1.01":
        return ssd_scan_bwd_ref(x, dt, A * 1.01, Bm, Cm, tdy, chunk)
    parts = [ssd_scan_bwd_ref(*(t[:, s0:s0 + chunk] for t in (x, dt)), A,
                              *(t[:, s0:s0 + chunk] for t in (Bm, Cm, tdy)),
                              chunk)
             for s0 in range(0, x.shape[1], chunk)]
    dx, ddt, dB, dC = (torch.cat([g[i] for g in parts], 1)
                       for i in (0, 1, 3, 4))
    return dx, ddt, sum(g[2] for g in parts), dB, dC


def _limit_case(dtype):
    _, ts = ssd_pair(2, 150, 3, 16, 20, dtype, seed=12)
    tdy = torch.from_numpy(normal(rng(13), tuple(ts[0].shape))).to(
        ts[0].dtype)
    return ts, tdy, ssd_scan_bwd_ref(*(t.double() for t in ts),
                                     tdy.double(), 64)


@pytest.mark.parametrize("dtype", sorted(TOL))
def test_smoke_limits_pass_the_plain_gradient(dtype):
    """``chip_smoke.ssd_bwd_errors`` passes the plain gradient in the
    working type (f32 arithmetic, each gradient in its input's dtype)
    against the same in f64, at a ragged S of three chunks."""
    smoke = chip_smoke()
    ts, tdy, want = _limit_case(dtype)
    got = ssd_scan_bwd_ref(*ts, tdy, 64)
    for name, g, w, t in zip(GRADS, got, want, ts):
        assert g.dtype == t.dtype
        errs = smoke.ssd_bwd_errors(g.float(), w, t.dtype, name)
        assert errs["fault"] is None, (name, errs)


@pytest.mark.parametrize("dtype", sorted(TOL))
@pytest.mark.parametrize("fault", ["chunks-cut", "decay*1.01"])
def test_smoke_limits_catch_backward_faults(fault, dtype):
    """The same limits fail a gradient whose chunks are cut apart (the
    state and its cotangent not carried) or whose decay is 1% off: some
    gradient leaves its limit."""
    smoke = chip_smoke()
    ts, tdy, want = _limit_case(dtype)
    got = _planted(ts, tdy, 64, fault)
    faults = [smoke.ssd_bwd_errors(g.float(), w, t.dtype, name)["fault"]
              for name, g, w, t in zip(GRADS, got, want, ts)]
    assert any(f is not None for f in faults), faults
