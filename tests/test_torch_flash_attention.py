"""Port parity: flash attention (``repro_torch.kernels.flash_attention``).

On the CPU the port's op takes its plain version.  It is held against the
JAX package's Pallas kernel run in interpret mode at the cases of
``tests/test_kernels.py:47-76`` (B=2, S=256, D=64, GQA 4/4 and 8/2;
causal, window 64, soft-cap 30, non-causal): f32 at 2e-4, bf16 at 3e-2, as
there.  Where the Pallas kernel cannot go — a length that does not divide
its block, ``sq < skv``, ``dv != d`` (it returns the wrong last dim,
ROADMAP B2) — it is held against the JAX ``attention_ref`` at 1e-5, and
so is head dim 256.  The CUDA kernel itself runs only on a card: its
tests are in ``tests/test_torch_kernels_gpu.py``.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.flash_attention.kernel import (  # noqa: E402
    flash_attention_pallas)
from repro.kernels.flash_attention.ref import attention_ref  # noqa: E402
from repro_torch.kernels.flash_attention import ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    attention_ref as port_ref)
from _torch_helpers import as_np, normal, rng  # noqa: E402

DTYPES = {"float32": (jnp.float32, torch.float32, 2e-4),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 3e-2)}


def _qkv(b, hq, hkv, sq, skv, d, dv, dtype, seed=0):
    """The same rounded q, k, v for JAX and the port."""
    r = rng(seed)
    jdt, tdt, _ = DTYPES[dtype]
    shapes = ((b, hq, sq, d), (b, hkv, skv, d), (b, hkv, skv, dv))
    js = [jnp.asarray(normal(r, s), jdt) for s in shapes]
    ts = [torch.tensor(np.asarray(j.astype(jnp.float32))).to(tdt) for j in js]
    return js, ts


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("hq,hkv", [(4, 4), (8, 2)])
@pytest.mark.parametrize("causal,window,softcap", [
    (True, 0, 0.0), (True, 64, 0.0), (True, 0, 30.0), (False, 0, 0.0)])
def test_plain_path_matches_pallas_interpret(dtype, hq, hkv, causal, window,
                                             softcap):
    (jq, jk, jv), (tq, tk, tv) = _qkv(2, hq, hkv, 256, 256, 64, 64, dtype)
    want = flash_attention_pallas(jq, jk, jv, causal=causal, window=window,
                                  softcap=softcap, block_q=128, block_kv=128,
                                  interpret=True)
    before = ops.LAUNCHES
    got = ops.attention(tq, tk, tv, causal=causal, window=window,
                        softcap=softcap)            # CPU tensors → plain
    assert ops.LAUNCHES == before
    assert got.dtype == tq.dtype and tuple(got.shape) == tuple(want.shape)
    tol = DTYPES[dtype][2]
    np.testing.assert_allclose(as_np(got), as_np(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("sq,skv,d,dv,kw", [
    (200, 200, 64, 64, dict(causal=True, window=0, softcap=0.0)),
    (1000, 1000, 32, 32, dict(causal=True, window=100, softcap=30.0)),
    (100, 300, 64, 64, dict(causal=True, window=0, softcap=0.0)),
    (37, 300, 32, 32, dict(causal=True, window=50, softcap=0.0)),
    (300, 100, 64, 64, dict(causal=True, window=0, softcap=0.0)),
    (130, 130, 24, 16, dict(causal=True, window=0, softcap=0.0)),
    (96, 96, 256, 256, dict(causal=True, window=32, softcap=50.0)),
    (96, 96, 256, 256, dict(causal=False, window=0, softcap=0.0)),
], ids=["ragged200", "ragged1000-window-cap", "sq<skv", "sq<skv-window",
        "sq>skv", "dv!=d", "d256-window-cap", "d256-noncausal"])
def test_plain_path_matches_jax_ref(sq, skv, d, dv, kw):
    (jq, jk, jv), (tq, tk, tv) = _qkv(2, 8, 4, sq, skv, d, dv, "float32",
                                      seed=1)
    want = attention_ref(jq, jk, jv, **kw)
    got = ops.attention(tq, tk, tv, **kw)
    assert tuple(got.shape) == (2, 8, sq, dv)
    np.testing.assert_allclose(as_np(got), as_np(want), rtol=1e-5,
                               atol=1e-5)


def test_fully_masked_rows_give_zero():
    """sq > skv, causal: the leading rows see no key and give exactly 0."""
    _, (tq, tk, tv) = _qkv(1, 2, 1, 12, 4, 8, 8, "float32")
    out = ops.attention(tq, tk, tv)
    assert torch.all(out[:, :, :8] == 0)
    assert bool(torch.isfinite(out).all())
    assert not torch.all(out[:, :, 8:] == 0)


def test_plain_impl_is_the_plain_version():
    _, (tq, tk, tv) = _qkv(1, 4, 2, 40, 40, 16, 16, "float32")
    np.testing.assert_array_equal(
        as_np(ops.attention(tq, tk, tv, impl="plain", window=9)),
        as_np(port_ref(tq, tk, tv, window=9)))


def test_kernel_impl_on_cpu_raises_and_counts_nothing():
    """No silent fallback: CPU tensors never reach the plain version when
    the kernel is asked for, and nothing is counted."""
    _, (tq, tk, tv) = _qkv(1, 4, 2, 16, 16, 8, 8, "float32")
    before = ops.LAUNCHES
    with pytest.raises(ValueError, match="CUDA device"):
        ops.attention(tq, tk, tv, impl="kernel")
    assert ops.LAUNCHES == before


def test_wrapper_rejects_what_the_kernel_does_not_take():
    _, (tq, tk, tv) = _qkv(1, 4, 2, 16, 16, 8, 8, "float32")
    with pytest.raises(ValueError, match="4-D"):
        ops.attention(tq[0], tk, tv)
    with pytest.raises(ValueError, match="GQA"):
        ops.attention(torch.zeros(1, 3, 16, 8), tk, tv)
    with pytest.raises(ValueError, match="do not fit"):
        ops.attention(tq, tk, tv[:, :, :8])
    with pytest.raises(TypeError):
        ops.attention(tq, tk, tv.double())
    with pytest.raises(TypeError):
        ops.attention(tq, tk.bfloat16(), tv)
    with pytest.raises(ValueError, match="impl"):
        ops.attention(tq, tk, tv, impl="pallas")


def _chip_smoke():
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("fault", ["window-64", "window-1", "window+1",
                                   "window+64", "late-rows*1.02"])
def test_smoke_limits_catch_small_faults_at_long_rows(dtype, fault):
    """``chip_smoke.py``'s limits at gemma2's layer shapes have to catch
    faults that move outputs by less than the S=256 tolerance of 3e-2:
    here each output averages up to 1024 keys (window 1024, D=256,
    soft-cap 50: a gemma2 window layer cut to S=2048).  The faults, with
    the plain version standing in for a faulty kernel: a window one key or
    one 64-key tile too short or too long, and the rows that see the whole
    window 2% too large (a wrong rescale or denominator on long rows,
    which 3e-2 alone passes)."""
    smoke = _chip_smoke()
    _, (tq, tk, tv) = _qkv(1, 2, 1, 2048, 2048, 256, 256, dtype, seed=3)
    kw = {"causal": True, "softcap": 50.0}
    want = port_ref(tq, tk, tv, window=1024, **kw)
    if fault.startswith("window"):
        got = port_ref(tq, tk, tv, window=1024 + int(fault[6:]), **kw)
    else:
        got = want.clone()
        got[:, :, 1023:] *= 1.02
    tdt = DTYPES[dtype][1]
    atol = smoke.GEMMA2_BF16_ATOL if tdt == torch.bfloat16 else None
    want, got = want.float(), got.float()
    assert smoke.flash_errors(want, want, tdt, atol)["fault"] is None
    assert smoke.flash_errors(got, want, tdt, atol)["fault"] is not None
