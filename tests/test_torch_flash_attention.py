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
import functools

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


@functools.lru_cache(maxsize=1)
def _long_rows_exact():
    """The f64 attention of the long-rows cases' bf16 inputs, computed
    once for all their faults."""
    _, (tq, tk, tv) = _qkv(1, 2, 1, 2048, 2048, 256, 256, "bfloat16", seed=3)
    return _chip_smoke().exact_attention(tq, tk, tv, causal=True,
                                         window=1024, softcap=50.0,
                                         rows=512)


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
    # bf16 is held to the exact attention of the same inputs, as the smoke
    # holds it at gemma2's shapes; f32 to the plain version within 2e-4
    exact = _long_rows_exact() if tdt == torch.bfloat16 else None
    want, got = want.float(), got.float()
    assert smoke.flash_errors(want, want, tdt, None, exact)["fault"] is None
    assert smoke.flash_errors(got, want, tdt, None, exact)["fault"] \
        is not None


# ------------------------------------------- the tensor-core kernel's plan
def test_route_goes_by_dtype():
    """CPU tensors take the plain version; a kernel call goes by dtype:
    bf16 to the tensor-core kernel, f32 to the FFMA kernel."""
    q = torch.zeros(1, 2, 8, 16)
    assert ops.route(q, q, q) == "plain"
    assert ops.route(q, q, q, impl="plain") == "plain"
    assert ops.route(q, q, q, impl="kernel") == "ffma"
    b = q.bfloat16()
    assert ops.route(b, b, b) == "plain"
    assert ops.route(b, b, b, impl="kernel") == "tc"


@pytest.mark.parametrize("d,dv,dp", [(24, 16, 64), (32, 32, 64),
                                     (64, 64, 64), (65, 64, 128),
                                     (192, 128, 192), (64, 200, 256),
                                     (256, 256, 256)])
def test_padded_head_dim(d, dv, dp):
    """The kernel's instantiations: max(d, dv) up to a multiple of 64."""
    assert ops.padded_dim(d, dv) == dp


def test_tma_map_reads_the_models_views_in_place():
    """The model's ``transpose(1, 2)`` views of (B, S, H, D) buffers: S and
    H swap places in the map (ordered by stride), the box takes 128 query
    rows or 64 keys along S, and no copy is needed."""
    q = torch.zeros(2, 300, 8, 256, dtype=torch.bfloat16).transpose(1, 2)
    m = ops.tma_map(q.shape, q.stride(), 0, ops.Q_ROWS)
    assert m.dims == (256, 8, 300, 2)                 # d, h, s, b
    assert m.strides == (512, 8 * 512, 300 * 8 * 512)
    assert m.box == (64, 1, 128, 1)
    assert m.perm == 2 | 1 << 2                      # s at dim 2, h at 1
    k = torch.zeros(2, 4, 300, 256, dtype=torch.bfloat16)   # contiguous
    m = ops.tma_map(k.shape, k.stride(), 0, ops.KV_ROWS)
    assert m.dims == (256, 300, 4, 2) and m.box == (64, 64, 1, 1)
    assert m.strides == (512, 300 * 512, 4 * 300 * 512)
    assert m.perm == 1 | 2 << 2
    # a dim of length 1 is never stepped: any stride of it is accepted
    one = torch.zeros(1, 1, 40, 24, dtype=torch.bfloat16)
    m = ops.tma_map(one.shape, (7, 3, 24, 1), 0, ops.KV_ROWS)
    assert m.dims == (24, 40, 1, 1) and m.strides == (48, 1920, 1920)
    qv, kv, vv = (t.transpose(1, 2) for t in (
        torch.zeros(1, 50, 8, 192, dtype=torch.bfloat16),
        torch.zeros(1, 50, 4, 192, dtype=torch.bfloat16),
        torch.zeros(1, 50, 4, 128, dtype=torch.bfloat16)))
    assert ops.padded_dim(qv.shape[3], vv.shape[3]) == 192
    assert all(ops.tma_map(t.shape, t.stride(), t.data_ptr(), rows)
               is not None for t, rows in ((qv, ops.Q_ROWS), (kv, ops.KV_ROWS),
                                           (vv, ops.KV_ROWS)))


def test_tma_map_refuses_what_tma_cannot_read():
    """A strided last dim, a base address off 16 bytes, or a row stride
    that is not a multiple of 16 bytes needs the copy; the copy is
    readable and holds the same values."""
    x = torch.arange(2 * 3 * 10 * 64, dtype=torch.float32).reshape(
        2, 3, 10, 64).bfloat16()
    assert ops.tma_map(x.shape, x.stride(), 0, 64) is not None
    strided = x[..., ::2]
    assert ops.tma_map(strided.shape, strided.stride(), 0, 64) is None
    assert ops.tma_map(x.shape, x.stride(), 8, 64) is None
    odd = torch.zeros(2, 3, 10, 20, dtype=torch.bfloat16)      # 40-byte rows
    assert ops.tma_map(odd.shape, odd.stride(), 0, 64) is None
    for t in (strided, odd):
        c = ops.tma_copy(t)
        assert ops.tma_map(c.shape, c.stride(), c.data_ptr(), 64) is not None
        assert torch.equal(c, t)


def _kernel_arithmetic(q, k, v, terms, **kw):
    """The tensor-core kernel's rounding in plain torch: f32 scores, exp
    against the row max, P split into ``terms`` bf16 terms, f32 products
    of each term with the bf16 V, the f32 row sum of P, the output rounded
    to bf16.  (The kernel's online rescaling by tiles is f32 and left
    out.)"""
    group = q.shape[1] // k.shape[1]
    kf = k.float().repeat_interleave(group, 1)
    vf = v.float().repeat_interleave(group, 1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kf) * q.shape[3] ** -0.5
    s = kw["softcap"] * torch.tanh(s / kw["softcap"])
    i = torch.arange(s.shape[2])[:, None]
    s = s.masked_fill(i < torch.arange(s.shape[3])[None, :], float("-inf"))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    acc, rest = torch.zeros_like(q, dtype=torch.float32), p
    for _ in range(terms):
        term = rest.bfloat16().float()
        acc += torch.einsum("bhqk,bhkd->bhqd", term, vf)
        rest = rest - term
    return (acc / p.sum(-1, keepdim=True)).bfloat16()


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("terms", [1, 2, 3])
def test_three_bf16_terms_of_p_meet_the_smokes_flash_gates(terms, seed):
    """Why the kernel feeds P to its P·V product as three bf16 terms.  At
    gemma2's head shape (8/4 heads of dim 256, soft-cap 50, causal; the
    first 256 rows, where rows see few keys and outputs reach 1 and more)
    the smoke holds the bf16 kernel (a) within half a bf16 step plus
    ``GEMMA2_BF16_DELTA`` of the exact f64 attention (``exact_gate``) and
    (b) to at most ``FLASH_ROUNDING_FACTOR`` times the plain version's
    count of outputs off the correctly rounded f64 attention.  One bf16
    term moves outputs near 1 by a bf16 step (7.8e-3) and fails both; two
    fail (b); three round like f32 and pass both.  (How often the kernel
    on the card, which sums in the tensor cores' order, crosses (a) on
    fresh draws: ``tools/flash_gate_census.py``.)"""
    smoke = _chip_smoke()
    _, (tq, tk, tv) = _qkv(2, 8, 4, 256, 256, 256, 256, "bfloat16",
                           seed=seed)
    kw = {"causal": True, "window": 0, "softcap": 50.0}
    plain = port_ref(tq, tk, tv, **kw)
    got = _kernel_arithmetic(tq, tk, tv, terms, **kw)
    exact = smoke.exact_attention(tq, tk, tv, **kw)
    fault = smoke.flash_errors(got.float(), plain.float(), torch.bfloat16,
                               None, exact)["fault"]
    ratio = smoke.rounded_off(got, exact) / smoke.rounded_off(plain, exact)
    if terms == 3:
        assert fault is None and ratio <= smoke.FLASH_ROUNDING_FACTOR
    else:
        assert ratio > smoke.FLASH_ROUNDING_FACTOR
    if terms == 1:
        assert fault is not None


def test_gate_census_runs_the_plain_version_on_the_cpu():
    """``tools/flash_gate_census.py`` at a tiny length on CPU tensors: the
    plain version stands in for both kernels, so no output crosses."""
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parents[1] / "tools" \
        / "flash_gate_census.py"
    spec = importlib.util.spec_from_file_location("flash_gate_census", path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    got = tool.census(_chip_smoke(), draws=2, seq=8, layer=1, device="cpu")
    assert got["draws"] == 2 and got["outputs_per_draw"] == 2 * 8 * 8 * 256
    for kernel in ("wgmma", "ffma_f32"):
        assert got["over_atol"][kernel] == {
            "outputs": 0, "draws": 0, "draw_rate": 0.0, "max_abs_err": 0.0}
        # the plain version rounds an f32 result: within the exact gate
        gate = got["over_exact_gate"][kernel]
        assert gate["outputs"] == 0 and gate["draws"] == 0
        assert gate["max_excess_over_half_step"] <= \
            _chip_smoke().GEMMA2_BF16_DELTA


# ------------------------------------------------- the smoke's gemma2 gate
def test_gemma2_gate_passes_either_neighbour_and_fails_two_steps_off():
    """The smoke's bf16 gate at gemma2's shapes: an output rounded to the
    bf16 neighbour on the far side of the exact value (a correct f32 sum
    in another order, where the exact value lies near the midpoint)
    passes; an output two bf16 steps off, or ``GEMMA2_BF16_DELTA`` past
    half a step, fails (where two steps exceed half a step plus delta).
    Over magnitudes 2^-8 .. 4."""
    smoke = _chip_smoke()
    delta = smoke.GEMMA2_BF16_DELTA
    mags = torch.tensor([2.0 ** -8, 0.02, 0.3, 1.0, 1.37, 1.99, 2.5, 3.9],
                        dtype=torch.float64)
    lo = mags.bfloat16().double()                       # bf16 numbers
    step = 2 * smoke.bf16_half_step(lo)
    hi = lo + step                                      # their neighbours
    # exact values just past the midpoint, towards hi: hi is nearest, lo is
    # the far neighbour a different summation order may round to
    exact = lo + step / 2 + step * 2.0 ** -12
    assert torch.equal(exact.bfloat16().double(), hi)
    for o in (hi, lo):
        assert smoke.exact_gate(o, exact)["crossings"] == 0
    # two steps off: 1.5 steps past half a step, more than delta wherever
    # a step is (at every magnitude from 1/4 on, as delta <= 1e-3)
    seen = 1.5 * step > delta
    assert bool(seen[mags >= 0.25].all())
    for o in (lo - step, hi + step):
        assert smoke.exact_gate(o, exact)["crossings"] == int(seen.sum())
    half = smoke.bf16_half_step(hi)
    past = hi + half + 1.5 * delta                      # δ past half a step
    assert smoke.exact_gate(past, hi)["crossings"] == len(mags)
    assert smoke.exact_gate(hi + half + 0.5 * delta, hi)["crossings"] == 0
    # the flash_errors fault follows the gate
    o = torch.stack([lo, lo - step]).float()
    ex = torch.stack([exact, exact])
    assert smoke.flash_errors(o[:1], o[:1], torch.bfloat16, None,
                              ex[:1])["fault"] is None
    assert "half a bf16 step" in smoke.flash_errors(
        o, o, torch.bfloat16, None, ex)["fault"]


def test_gemma2_gate_is_tighter_than_the_former_one_at_every_magnitude():
    """The former gate allowed ``GEMMA2_BF16_ATOL`` (6e-3) off the plain
    version's bf16 output, itself up to half a step off the exact value;
    the new one allows half a step plus ``GEMMA2_BF16_DELTA`` (at most
    1e-3) off the exact value: below it at every magnitude in 2^-8 .. 4."""
    smoke = _chip_smoke()
    assert smoke.GEMMA2_BF16_DELTA <= 1e-3 < smoke.GEMMA2_BF16_ATOL
    m = torch.logspace(-8, 2, 2001, base=2.0, dtype=torch.float64)
    half = smoke.bf16_half_step(m)
    new = half + smoke.GEMMA2_BF16_DELTA
    old = smoke.GEMMA2_BF16_ATOL + half
    assert bool((new < old).all())
    # the half step doubles at each power of two: 2^-16 at 2^-8, 2^-6 at 4
    assert half[0].item() == 2.0 ** -16 and half[-1].item() == 2.0 ** -6
