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
from repro_torch.kernels.matmul.ref import (  # noqa: E402
    splitk_reduce_ref as ref_splitk)
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


# ------------------------------------------------- the skinny kernel's plan
def _view(t, rows):
    return (t.shape, t.stride(), t.data_ptr(), rows)


def _strided(shape, strides, ptr=0, rows=2):
    return (shape, strides, ptr, rows)


def test_operand_plan_reads_the_scorer_view_in_place():
    """The scorer's blocked W1, (db, hb, bd, bh) = (4, 10, 400, 1000) viewed
    as (db, bd, hb, bh), is read in place: one 4-D map ordered by stride,
    128 x 32 boxes that stop at each block's edge.  A, the contiguous
    (8, 1600) batch, is cut to W1's K blocking (4, 400)."""
    w1 = _strided((4, 400, 10, 1000), (10 * 400 * 1000, 1000, 400 * 1000, 1))
    x = _strided((8, 1600), (1600, 1), 64, 1)
    plan = ops.plan_operands(x, w1)
    assert not (plan.copy_a or plan.copy_b)
    assert plan.b == ops.Blocked((4, 400, 10, 1000),
                                 (400000 * 10, 1000, 400000, 1))
    bp = plan.b_plan
    assert bp.wide and bp.tc == 128 and bp.g == 1 and bp.bk == 32
    assert bp.map.dims == (1000, 400, 10, 4)
    assert bp.map.strides == (4000, 1600000, 16000000)
    assert bp.map.box == (128, 32, 1, 1)
    assert bp.map.perm == 1 | 2 << 2             # row, column block, K block
    assert plan.a == ops.Blocked((1, 8, 4, 400), (12800, 1600, 400, 1))
    assert plan.a_map.dims == (400, 4, 8, 1)     # K in block, K block, row
    assert plan.a_map.box == (32, 1, 8, 1)
    assert plan.a_map.perm == 2 | 1 << 2
    sp = ops.plan_skinny(plan.a, plan.b, bp, num_sms=132)
    assert (sp.mp, sp.ktpb, sp.ktiles, sp.ntpb, sp.ntiles) == (8, 13, 52, 8,
                                                               80)
    # 80 column tiles for 132 SMs: K is cut in two
    assert sp.splits == 2 and sp.kts == 26 and sp.smem <= ops.MAX_SMEM
    # at speech-100k width, 790 column tiles: no split, A's slice kept whole
    full = ops.plan_operands(x, _strided((4, 400, 10, 10000),
                                         (4000 * 10000, 10000, 4000000, 1)))
    sp = ops.plan_skinny(full.a, full.b, full.b_plan, num_sms=132)
    assert (sp.ntiles, sp.splits, sp.kts) == (790, 1, 52)


def test_operand_plan_reads_the_scorer_w2_in_narrow_row_groups():
    """W2, (hb, lb, bh, bl) = (10, 1, 1000, 10): rows of 40 bytes, off TMA's
    16-byte stride rule, so two packed rows make one TMA row."""
    w2 = _strided((10, 1000, 1, 10), (10000, 10, 10000, 1))
    h = _strided((8, 10000), (10000, 1), 0, 1)
    plan = ops.plan_operands(h, w2)
    assert not (plan.copy_a or plan.copy_b)
    bp = plan.b_plan
    assert not bp.wide and bp.tc == 10 and bp.g == 2 and bp.bk == 128
    assert bp.map.dims[:2] == (20, 5000) and bp.map.strides[0] == 80
    assert bp.map.box == (20, 64, 1, 1)
    sp = ops.plan_skinny(plan.a, plan.b, bp, num_sms=132)
    assert sp.ntiles == 1 and 1 < sp.splits <= 132
    assert (sp.splits - 1) * sp.kts < sp.ktiles <= sp.splits * sp.kts


@pytest.mark.parametrize("what", ["a", "b"])
def test_operand_plan_copies_a_transposed_operand_it_cannot_read(what):
    """A transposed operand (its columns strided, its rows contiguous) has
    no contiguous axis for TMA's rows: it is copied."""
    a = torch.zeros(64, 8).t() if what == "a" else torch.zeros(8, 64)
    b = torch.zeros(96, 64).t() if what == "b" else torch.zeros(64, 96)
    plan = ops.plan_operands(_view(a, 1), _view(b, 1))
    assert plan.copy_b == (what == "b")
    assert plan.copy_a == (what == "a")


@pytest.mark.parametrize("case", ["unaligned base", "stride off 16 bytes",
                                  "three row axes", "no shared K blocking"])
def test_operand_plan_copies_what_tma_cannot_read(case):
    x = _strided((8, 1600), (1600, 1), 0, 1)
    w = _strided((1600, 1000), (1000, 1), 0, 1)
    if case == "unaligned base":
        w = _strided((1600, 1000), (1000, 1), 4, 1)
    elif case == "stride off 16 bytes":
        w = _strided((1600, 1000), (1002, 1), 0, 1)
    elif case == "three row axes":
        t = torch.zeros(4, 3, 2, 100).permute(2, 1, 0, 3)   # (2, 3, 4, 100)
        w = _view(t, 3)
        x = _strided((8, 24), (24, 1), 0, 1)
    else:
        # K as (4, 400) blocks in A and (8, 200) in B, neither contiguous
        x = _strided((8, 4, 400), (2000, 500, 1), 0, 1)
        w = _strided((8, 200, 1000), (250000, 1000, 1), 0, 2)
        assert not ops.plan_operands(x, w).copy_b
        assert ops.plan_operands(x, w).copy_a
        return
    assert ops.plan_operands(x, w).copy_b


def test_padded_copy_is_what_the_plan_reads():
    """Each copy the op makes is a layout the kernel reads in place."""
    b = torch.arange(1600 * 10, dtype=torch.float32).view(1600, 10)[:, :7]
    plan = ops.plan_operands(_view(torch.zeros(8, 1600), 1), _view(b, 1))
    assert plan.copy_b
    c = ops._padded_copy(b, (1, 1600, 1, 7))
    assert torch.equal(c.reshape(1600, 7), b)
    assert not ops.plan_operands(_view(torch.zeros(8, 1600), 1),
                                 _view(c, 2)).copy_b


@pytest.mark.parametrize("m,dtype,impl,want", [
    (8, torch.float32, "kernel", "skinny"), (16, torch.float32, "kernel",
                                             "skinny"),
    (17, torch.float32, "kernel", "narrow"), (8, torch.bfloat16, "kernel",
                                              "tile"),
    (8, torch.float32, "auto", "plain"), (8, torch.float32, "plain",
                                          "plain"),
    ((17, 33), torch.float32, "kernel", "tc"),
    ((10000, 100000), torch.float32, "kernel", "tc"),
    ((17, 32), torch.float32, "kernel", "narrow"),
    ((10000, 10), torch.float32, "kernel", "narrow"),
    ((16, 100000), torch.float32, "kernel", "skinny"),
    ((17, 33), torch.bfloat16, "kernel", "tile"),
    ((17, 33), torch.float32, "auto", "plain")])
def test_route(m, dtype, impl, want):
    """f32 with m <= 16 goes to the skinny kernel; f32 with more rows to
    the tensor-core route when B has more than 32 columns, else to the
    narrow kernel; bf16 to the tile kernel; CPU tensors under "auto" to
    the plain version.  ``m`` is A's rows (B 8 columns wide) or (rows,
    columns)."""
    m, n = m if isinstance(m, tuple) else (m, 8)
    a, b = torch.zeros(m, 32, dtype=dtype), torch.zeros(32, n, dtype=dtype)
    assert ops.route(a, b, impl) == want


@pytest.mark.parametrize("m,k,n", [(8, 1600, 100000), (8, 100000, 10),
                                   (1, 100000, 10), (16, 1600, 4000),
                                   (5, 64, 128), (3, 70, 7)])
def test_skinny_plan_covers_k_and_fits_shared_memory(m, k, n):
    plan = ops.plan_operands(_strided((m, k), (-(-k // 4) * 4, 1), 0, 1),
                             _strided((k, n), (-(-n // 4) * 4, 1), 0, 1))
    assert not (plan.copy_a or plan.copy_b)
    sp = ops.plan_skinny(plan.a, plan.b, plan.b_plan, num_sms=132)
    assert sp.m == m and sp.n == n and sp.mp >= m
    assert (sp.splits - 1) * sp.kts < sp.ktiles <= sp.splits * sp.kts
    assert sp.smem <= ops.MAX_SMEM
    assert sp.kts * sp.mp * plan.b_plan.bk * 4 <= ops.A_SLICE_BYTES


@pytest.mark.parametrize("splits,cap", [(131, 50), (131, 131), (5, 2)])
def test_fold_order_is_splitk_reduce_refs(splits, cap):
    """The kernel's fold stages ``cap`` partial tiles at a time and adds
    them into one running sum per output, in split order: the same
    additions as the plain version, so the same bits."""
    part = torch.tensor(normal(rng(5), (splits, 8, 10)))
    total = torch.zeros(8, 10)
    for z0 in range(0, splits, cap):
        for z in range(z0, min(z0 + cap, splits)):
            total = total + part[z]
    assert torch.equal(total, ref_splitk(part))


def test_partials_maps_each_tiles_columns_back_to_the_output():
    """``_launch_skinny(..., keep_partials=True)`` reads the fold's
    workspace, (tile, split, padded row, tile column), back as (split, row,
    column) of C: each column block of n1 columns cut into 128-column
    tiles, the last ragged."""
    plan = ops.plan_operands(
        _strided((3, 64), (64, 1), 0, 1),
        _strided((64, 2, 200), (512, 256, 1), 0, 1))   # blocks 256 apart
    sp = ops.plan_skinny(plan.a, plan.b, plan.b_plan, num_sms=132)
    assert (sp.ntpb, sp.ntiles, sp.mp, sp.tc) == (2, 4, 4, 128)
    # each workspace value its own flat index (exact in f32 at this size)
    ws = torch.arange(sp.ntiles * sp.splits * sp.mp * sp.tc,
                      dtype=torch.float32)
    got = ops._partials(ws, sp)
    assert got.shape == (sp.splits, 3, 400)
    for z in range(sp.splits):
        for row in range(3):
            for col in (0, 127, 128, 199, 200, 327, 328, 399):
                c0, lc = divmod(col, 200)
                tile, cc = c0 * 2 + lc // 128, lc % 128
                want = ((tile * sp.splits + z) * sp.mp + row) * sp.tc + cc
                assert got[z, row, col].item() == want
