"""Port parity: the blocked matmul (``repro_torch.kernels.matmul``).

On the CPU the port's op takes its plain version; it is held against the
JAX package's Pallas kernel run in interpret mode (``matmul_pallas`` and
``ops.matmul(impl="pallas")``) at the shapes of ``tests/test_kernels.py``
and the ragged 100×70×50 case: f32 at 1e-5 (atol 1e-5·√K, as there), bf16
at 2e-2.  The CUDA kernel itself runs only on a card: its tests are in
``tests/test_torch_kernels_gpu.py``.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.matmul.kernel import matmul_pallas  # noqa: E402
from repro.kernels.matmul.ops import matmul as jax_matmul  # noqa: E402
from repro_torch.kernels.matmul import ops  # noqa: E402
from _torch_helpers import as_np, normal, rng  # noqa: E402

SHAPES = [(128, 128, 128), (256, 512, 128), (384, 256, 640)]
DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _operands(m, k, n, dtype, seed=0):
    r = rng(seed)
    a, b = normal(r, (m, k)), normal(r, (k, n))
    jdt, tdt, _ = DTYPES[dtype]
    ja, jb = jnp.asarray(a, jdt), jnp.asarray(b, jdt)
    # the same rounded values on both sides
    ta = torch.tensor(np.asarray(ja.astype(jnp.float32))).to(tdt)
    tb = torch.tensor(np.asarray(jb.astype(jnp.float32))).to(tdt)
    return ja, jb, ta, tb


@pytest.mark.parametrize("m,k,n", SHAPES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_plain_path_matches_pallas_interpret(m, k, n, dtype):
    ja, jb, ta, tb = _operands(m, k, n, dtype)
    want = matmul_pallas(ja, jb, block_m=128, block_n=128, block_k=128,
                         interpret=True)
    got = ops.matmul(ta, tb)                     # CPU tensor → plain path
    assert got.dtype == ta.dtype and tuple(got.shape) == (m, n)
    tol = DTYPES[dtype][2]
    np.testing.assert_allclose(as_np(got), as_np(want), rtol=tol,
                               atol=tol * k ** 0.5)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_ragged_matches_padding_pallas_op(dtype):
    ja, jb, ta, tb = _operands(100, 70, 50, dtype, seed=1)
    want = jax_matmul(ja, jb, impl="pallas", block_m=64, block_n=64,
                      block_k=64, interpret=True)
    got = ops.matmul(ta, tb, impl="auto")
    tol = DTYPES[dtype][2]
    np.testing.assert_allclose(as_np(got), as_np(want), rtol=tol,
                               atol=tol * 70 ** 0.5)


def test_out_dtype_and_plain_impl():
    _, _, ta, tb = _operands(16, 32, 8, "bfloat16")
    out = ops.matmul(ta, tb, impl="plain", out_dtype=torch.float32)
    assert out.dtype == torch.float32
    np.testing.assert_array_equal(as_np(out),
                                  as_np(ta.float() @ tb.float()))


def test_wrapper_rejects_what_the_kernel_does_not_take():
    a = torch.zeros(4, 5)
    with pytest.raises(ValueError, match="contraction"):
        ops.matmul(a, torch.zeros(4, 5))
    with pytest.raises(ValueError, match="2-D"):
        ops.matmul(torch.zeros(2, 4, 5), torch.zeros(5, 3))
    with pytest.raises(TypeError):
        ops.matmul(a, torch.zeros(5, 3, dtype=torch.float64))
    with pytest.raises(TypeError):
        ops.matmul(a, torch.zeros(5, 3, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="impl"):
        ops.matmul(a, torch.zeros(5, 3), impl="pallas")


def test_kernel_impl_on_cpu_raises_and_counts_nothing():
    """No silent fallback: a CPU tensor never reaches the plain version
    when the kernel is asked for, and nothing is counted."""
    before = ops.LAUNCHES
    with pytest.raises(ValueError, match="CUDA"):
        ops.matmul(torch.zeros(4, 5), torch.zeros(5, 3), impl="kernel")
    assert ops.LAUNCHES == before


@pytest.mark.parametrize("m,n,k", [(8, 100000, 1600), (8, 10, 100000),
                                   (1, 10, 100000), (128, 128, 128),
                                   (100, 50, 70), (384, 640, 256)])
def test_launch_plan_covers_k_exactly_once(m, n, k):
    """The split-K plan tiles K into whole BK steps, every split non-empty,
    and splits only when the output has too few tiles for the card."""
    config, splits, kchunk = ops.plan_launch(m, n, k, num_sms=132)
    bm, bn, bk = ops.TILE_CONFIGS[config]
    assert kchunk % bk == 0 and splits >= 1
    assert (splits - 1) * kchunk < k <= splits * kchunk
    tiles = -(-m // bm) * -(-n // bn)
    if tiles >= 2 * 132:
        assert splits == 1
    assert config == (0 if m <= 16 else 1)


def test_plan_launch_scorer_shapes():
    assert ops.plan_launch(8, 100000, 1600, 132) == (0, 1, 1600)
    config, splits, _ = ops.plan_launch(8, 10, 100000, 132)
    assert config == 0 and splits > 132


@pytest.mark.parametrize("splits,m,n", [(261, 8, 10), (261, 1, 10), (3, 5, 7)])
def test_splitk_reduce_plain_path_sums_in_split_order(splits, m, n):
    """A CPU tensor takes the plain reduction: the partial sums added in
    split order, the order the CUDA reduction kernel adds them in."""
    part = normal(rng(3), (splits, m, n))
    want = np.zeros((m, n), np.float32)
    for s in range(splits):
        want = want + part[s]
    before = ops.REDUCE_LAUNCHES
    got = ops.splitk_reduce(torch.tensor(part))
    assert ops.REDUCE_LAUNCHES == before
    np.testing.assert_array_equal(as_np(got), want)
    np.testing.assert_allclose(as_np(got), part.sum(0), rtol=1e-5,
                               atol=1e-5 * splits ** 0.5)
    bf = ops.splitk_reduce(torch.tensor(part), out_dtype=torch.bfloat16)
    assert bf.dtype == torch.bfloat16


def test_splitk_reduce_kernel_impl_on_cpu_raises():
    before = ops.REDUCE_LAUNCHES
    with pytest.raises(ValueError, match="CUDA"):
        ops.splitk_reduce(torch.zeros(3, 2, 2), impl="kernel")
    with pytest.raises(TypeError, match="f32"):
        ops.splitk_reduce(torch.zeros(2, 2))
    assert ops.REDUCE_LAUNCHES == before
