"""The matmul's narrow route on the CPU: where it goes, how it is planned,
and its plain versions against the JAX package's Pallas matmul.

The route (``ops.route`` → ``"narrow"``: f32 with more than 16 rows and at
most 32 columns; the train step's a1·W2) launches ``matmul_narrow_kernel``
(``csrc/matmul_narrow.cu``), which has no CPU mode: its ``gpu`` tests are
in ``tests/test_torch_kernels_gpu.py``.  Here: the route and its edges;
``plan_narrow`` over shapes (shared memory, splits that cover K exactly,
the workspace); the in-place reading plan (``plan_operands(...,
kernel="narrow")``) for the engine's own a1 and W2 views, caught from a
train step at nb, hb ≥ 3, and for layouts that need a copy; the fold's
workspace read back (``_narrow_partials``); and ``matmul_ref`` and the
split-order plain version (``matmul_split_ref``, the order the kernel's
fold takes) against ``repro.kernels.matmul.ops.matmul(impl="pallas",
interpret=True)`` at rtol 1e-5, atol 1e-5·√K.

One file of its own, with its JAX runs cached per module, so that xdist's
``--dist loadfile`` queue (files with more tests first) runs it early,
away from the reference's wall-clock tests (``ROADMAP.md`` C3).
"""
import functools

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402
from hypothesis import given, settings, strategies as st  # noqa: E402

from _torch_helpers import CPU, chip_smoke, normal, rng  # noqa: E402
from repro_torch.kernels.matmul import ops  # noqa: E402
from repro_torch.kernels.matmul.ref import (matmul_ref,  # noqa: E402
                                            matmul_split_ref,
                                            splitk_reduce_ref)

SMS = 132                                 # an H100's SMs


def _view(t, rows):
    return (t.shape, t.stride(), t.data_ptr(), rows)


def _plan(m, k, n, a_pitch=None, b_pitch=None, sms=SMS):
    """The narrow kernel's operand and launch plans for 2-D operands of
    this shape, rows ``a_pitch`` / ``b_pitch`` floats apart (default:
    contiguous)."""
    op = ops.plan_operands(((m, k), (a_pitch or k, 1), 0, 1),
                           ((k, n), (b_pitch or n, 1), 0, 1), "narrow")
    if op.copy_a or op.copy_b:
        return op, None
    return op, ops.plan_narrow(op.a, op.b, op.b_plan, sms)


# ---------------------------------------------------------------- routing
@pytest.mark.parametrize("m,n,dtype,want", [
    (17, 1, torch.float32, "narrow"), (17, 10, torch.float32, "narrow"),
    (17, 32, torch.float32, "narrow"), (10000, 1, torch.float32, "narrow"),
    (10000, 10, torch.float32, "narrow"),
    (10000, 32, torch.float32, "narrow"),
    (17, 33, torch.float32, "tc"), (10000, 33, torch.float32, "tc"),
    (16, 10, torch.float32, "skinny"), (16, 32, torch.float32, "skinny"),
    (17, 10, torch.bfloat16, "tile"), (10000, 10, torch.bfloat16, "tile")])
def test_route(m, n, dtype, want):
    """f32 with more than 16 rows and at most 32 columns goes to the narrow
    kernel; 33 columns to the tensor-core route, 16 rows to the skinny
    kernel, bf16 to the tile kernel."""
    a, b = torch.zeros(m, 8, dtype=dtype), torch.zeros(8, n, dtype=dtype)
    assert ops.route(a, b, "kernel") == want
    assert ops.route(a, b) == "plain"                # CPU tensors, "auto"


def test_kernel_on_a_cpu_tensor_raises():
    """``impl="kernel"`` never falls back to the plain version."""
    a, b = torch.zeros(300, 64), torch.zeros(64, 10)
    before = ops.NARROW_LAUNCHES
    with pytest.raises(ValueError, match="CUDA device"):
        ops.matmul(a, b, impl="kernel")
    assert ops.NARROW_LAUNCHES == before


# ----------------------------------------------------------------- plans
def test_plan_at_the_train_shape():
    """a1·W2 at speech-100k: A read in 128 x 32 swizzled boxes (the map's
    box), W2's 40-byte rows two to a TMA row, 79 row tiles x 3 splits
    (237 blocks for 264 slots: one wave), a ring of 6 stages in 107136
    bytes (two blocks an SM)."""
    op, nw = _plan(10000, 100000, 10)
    assert op.a_map.box == (32, 128, 1, 1)
    assert (op.b_plan.tc, op.b_plan.g, op.b_plan.bk) == (10, 2, 32)
    assert op.b_plan.map.box == (20, 16, 1, 1)
    assert (nw.rtiles, nw.splits, nw.kts, nw.ktiles) == (79, 3, 1042, 3125)
    assert (nw.stages, nw.smem) == (6, 107136)
    assert 2 * (nw.smem + 1024) <= 233472
    assert nw.ws_floats == 79 * 3 * 128 * 10
    assert nw.k_bounds() == [0, 33344, 66688, 100000]


@settings(max_examples=300, deadline=None)
@given(m=st.integers(17, 20000), k=st.integers(1, 200000),
       n=st.integers(1, 32), packed=st.booleans())
def test_plan_fits_and_covers_k(m, k, n, packed):
    """Over shapes: the ring fits two blocks an SM (4 to 6 stages); the
    splits cover K's steps exactly and fill at most one wave of two blocks
    an SM; ``k_bounds`` runs from 0 to K, each split non-empty; the
    workspace holds one 128-row tile of every split of every row tile."""
    kp = -(-k // 4) * 4
    op, nw = _plan(m, k, n, a_pitch=kp,
                   b_pitch=n if packed else -(-n // 4) * 4)
    if nw is None:                        # packed rows, K not a multiple of g
        g = 16 // np.gcd(4 * n, 16)
        assert packed and k % g and op.copy_b
        return
    assert ops.NW_MIN_STAGES <= nw.stages <= ops.NW_MAX_STAGES
    assert nw.smem <= ops.NW_SMEM_CAP <= ops.MAX_SMEM
    assert nw.smem == ops.narrow_smem(nw.stages, nw.bpitch)
    assert nw.rtiles == -(-m // ops.NW_BM) and nw.ktiles == -(-k // 32)
    assert (nw.splits - 1) * nw.kts < nw.ktiles <= nw.splits * nw.kts
    assert nw.splits == 1 or nw.rtiles * nw.splits <= 2 * SMS
    bounds = nw.k_bounds()
    assert bounds[0] == 0 and bounds[-1] == k
    assert all(lo < hi for lo, hi in zip(bounds, bounds[1:]))
    assert nw.ws_floats == (nw.rtiles * nw.splits * ops.NW_BM * n
                            if nw.splits > 1 else 0)


@pytest.mark.parametrize("k0,k1,kts", [(10, 10000, 7), (3, 100, 2),
                                       (4, 33, 1)])
def test_split_bounds_follow_the_k_blocks(k0, k1, kts):
    """With K in blocks (a blocked view's K axis), K's steps restart at
    each block: a split's bounds are where its first step starts."""
    ktpb = -(-k1 // 32)
    ktiles = k0 * ktpb
    nw = ops.NarrowPlan(m=300, n=10, bpitch=10, bg=2, a_r1=300, rtpb=3,
                        rtiles=3, kblock=k1, ktpb=ktpb, ktiles=ktiles,
                        kts=kts, splits=-(-ktiles // kts), stages=6, smem=0,
                        ws_floats=0)
    starts = [kb * k1 + j * 32 for kb in range(k0) for j in range(ktpb)]
    assert nw.k_bounds() == [starts[z * kts] for z in range(nw.splits)] \
        + [k0 * k1]


# ------------------------------------------------- in-place reading plans
DIMS = (3, 3, 4, 1, 40, 16, 32, 10)         # nb, db, hb, lb, bn, bd, bh, bl


@functools.lru_cache(maxsize=None)
def _engine_calls(dims=DIMS):
    """The matmul op's calls in one train step of the port's engine on the
    CPU: (a, b, kw) each, as ``_fused_matmul_2d`` hands them over."""
    from repro_torch.core import Engine, SGD, TraTrainer, from_tensor
    from repro_torch.core.programs import ffnn_train_step_tra
    nb, db, hb, lb, bn, bd, bh, bl = dims
    r = rng(21)
    x = torch.from_numpy(normal(r, (nb * bn, db * bd)))
    y = torch.from_numpy((normal(r, (nb * bn, lb * bl)) > 0).astype(
        np.float32))
    w1 = torch.from_numpy(normal(r, (db * bd, hb * bh)))
    w2 = torch.from_numpy(normal(r, (hb * bh, lb * bl)))
    trainer = TraTrainer(
        Engine(executor="jit", device=CPU),
        ffnn_train_step_tra(*dims, optimizer=SGD(0.01)),
        params={"W1": from_tensor(w1, (bd, bh)),
                "W2": from_tensor(w2, (bh, bl))})
    calls, real = [], ops.matmul

    def spy(a, b, **kw):
        calls.append((a, b, kw))
        return real(a, b, **kw)

    ops.matmul = spy
    try:
        trainer.step(X=from_tensor(x, (bn, bd)), Y=from_tensor(y, (bn, bl)))
    finally:
        ops.matmul = real
    return tuple(calls)


@pytest.mark.parametrize("which", ["a1", "W2"])
def test_engine_a1_and_w2_views_are_read_in_place(which):
    """The train step's a1·W2 at nb 3, hb 4: the engine hands over a1 as
    its (nb, bn | hb, bh) view and W2 as its (hb, bh | lb, bl) view; the
    narrow kernel's plan reads both where they lie (no copy), W2's 40-byte
    rows two to a TMA row."""
    calls = _engine_calls()
    assert len(calls) == 2
    a, b, kw = calls[1]
    nb, db, hb, lb, bn, bd, bh, bl = DIMS
    assert tuple(a.shape) == (nb, bn, hb, bh) and kw["a_rows"] == 2
    assert tuple(b.shape) == (hb, bh, lb, bl) and kw["b_rows"] == 2
    assert ops.route(a, b, "kernel", kw["a_rows"], kw["b_rows"]) == "narrow"
    op = ops.plan_operands(_view(a, kw["a_rows"]), _view(b, kw["b_rows"]),
                           "narrow")
    assert not (op.copy_a or op.copy_b)
    if which == "a1":
        assert op.a.rows == nb * bn and op.a.cols == hb * bh
        assert op.a_map.box[0] == 32 and ops.NW_BM in op.a_map.box
    else:
        assert (op.b.rows, op.b.cols) == (hb * bh, lb * bl)
        assert (op.b_plan.tc, op.b_plan.g) == (10, 2)
    nw = ops.plan_narrow(op.a, op.b, op.b_plan, SMS)
    assert nw.m == nb * bn and nw.n == lb * bl


@pytest.mark.parametrize("block_major", [False, True])
@pytest.mark.parametrize("nb,hb,bh", [(3, 3, 1000), (10, 10, 1000),
                                      (3, 4, 1024)])
def test_blocked_a1_views_are_read_in_place(nb, hb, bh, block_major):
    """a1 as (nb, bn | hb, bh) of a row-major tensor (as X·W1 leaves it)
    or of a block-major one (nb, hb, bn, bh), W2 as (hb, bh | 1, 10): read
    in place; block-major rows restart at each row block (ragged tiles).
    The splits follow M, so where bh is whole 32-deep K steps the view is
    split as its contiguous copy is, at the same K values."""
    bn = 200
    a1 = torch.zeros(nb, bn, hb, bh)
    if block_major:
        a1 = torch.zeros(nb, hb, bn, bh).permute(0, 2, 1, 3)
    w2 = torch.zeros(hb, 1, bh, 10).permute(0, 2, 1, 3)
    op = ops.plan_operands(_view(a1, 2), _view(w2, 2), "narrow")
    assert not (op.copy_a or op.copy_b)
    nw = ops.plan_narrow(op.a, op.b, op.b_plan, SMS)
    rows = bn if block_major else nb * bn
    assert nw.a_r1 == rows and nw.rtiles == nb * bn // rows * -(-rows // 128)
    _, flat = _plan(nb * bn, hb * bh, 10)
    if bh % 32 == 0 or not block_major:
        assert (nw.splits, nw.k_bounds()) == (flat.splits, flat.k_bounds())


@pytest.mark.parametrize("case,copy", [
    ("a_pitch_off_16_bytes", "a"), ("b_transposed", "b"),
    ("b_column_blocks", "b"), ("b_packed_ragged", "b")])
def test_layouts_that_need_a_copy(case, copy):
    """A with rows of 4001 f32 (off 16 bytes); B transposed (its columns
    not contiguous); B in two column blocks (the narrow kernel reads one);
    B's 40-byte rows over an odd K (two to a TMA row leave one over).  The
    copy the op makes is read in place."""
    m, k, n = 300, 4001, 10
    a = torch.zeros(m, 4004)[:, :k]           # rows 16-byte aligned
    b = {"a_pitch_off_16_bytes": lambda: torch.zeros(k, n),
         "b_transposed": lambda: torch.zeros(n, k).t(),
         "b_column_blocks": lambda: torch.zeros(k, 2, 5),
         "b_packed_ragged": lambda: torch.zeros(k, n)}[case]()
    if case == "a_pitch_off_16_bytes":
        a, b = torch.zeros(m, k), torch.zeros(k, 12)[:, :n]
    op = ops.plan_operands(_view(a, 1), _view(b, 1), "narrow")
    assert (op.copy_a, op.copy_b) == (copy == "a", copy == "b")
    if copy == "b":
        c = ops._padded_copy(b, (1, k, 1, n))
        op = ops.plan_operands(_view(a, 1), _view(c, 2), "narrow")
        assert not op.copy_b
    else:
        c = ops._padded_copy(a, (1, m, 1, k))
        op = ops.plan_operands(_view(c, 2), _view(b, 1), "narrow")
        assert not (op.copy_a or op.copy_b)


def test_partials_map_each_row_tile_back_to_the_output():
    """``_launch_narrow(..., keep_partials=True)`` reads the workspace,
    (row tile, split, tile row, column), back as (split, row, column):
    row blocks of 200 rows cut into tiles of 128, the last ragged."""
    nw = ops.NarrowPlan(m=600, n=7, bpitch=7, bg=4, a_r1=200, rtpb=2,
                        rtiles=6, kblock=4000, ktpb=125, ktiles=125, kts=42,
                        splits=3, stages=6, smem=0,
                        ws_floats=6 * 3 * 128 * 7)
    ws = torch.arange(nw.ws_floats, dtype=torch.float32)
    got = ops._narrow_partials(ws, nw)
    assert got.shape == (3, 600, 7)
    for z in range(3):
        for row in (0, 127, 128, 199, 200, 455, 599):
            rb, rr = divmod(row, 200)
            tile, tr = rb * 2 + rr // 128, rr % 128
            for col in (0, 6):
                want = ((tile * 3 + z) * 128 + tr) * 7 + col
                assert got[z, row, col].item() == want


# ---------------------------------------- plain versions against JAX's
@functools.lru_cache(maxsize=None)
def _operands(m, k, n, seed):
    r = rng(seed)
    return normal(r, (m, k)), normal(r, (k, n))


@functools.lru_cache(maxsize=None)
def _jax_pallas(m, k, n, seed):
    """JAX's Pallas matmul in interpret mode on the same operands."""
    import jax.numpy as jnp
    from repro.kernels.matmul.ops import matmul as jmatmul
    a, b = _operands(m, k, n, seed)
    return np.asarray(jmatmul(jnp.asarray(a), jnp.asarray(b), impl="pallas",
                              interpret=True))


PARITY = [(300, 4000, 10), (333, 4004, 10), (300, 4001, 10), (257, 700, 1),
          (300, 4000, 32), (17, 1000, 7)]


@pytest.mark.parametrize("m,k,n", PARITY)
@pytest.mark.parametrize("which", ["matmul_ref", "matmul_split_ref"])
def test_plain_versions_match_jax_pallas(m, k, n, which):
    """``matmul_ref`` and the split-order plain version, split as the
    narrow kernel would split this product on an H100 (``k_bounds`` of
    its plan), against JAX's Pallas matmul in interpret mode: at the
    train step's column count, ragged M and K, N 1 and 32."""
    a, b = map(torch.from_numpy, _operands(m, k, n, seed=m + k + n))
    if which == "matmul_ref":
        got = matmul_ref(a, b)
    else:
        _, nw = _plan(m, k, n, a_pitch=-(-k // 4) * 4,
                      b_pitch=-(-n // 4) * 4)
        assert nw.splits > 1
        got = matmul_split_ref(a, b, nw.k_bounds())
    want = _jax_pallas(m, k, n, seed=m + k + n)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-5 * k ** 0.5)


def test_split_ref_is_the_split_order_sum_of_its_partials():
    """``matmul_split_ref`` is ``splitk_reduce_ref`` of the splits' f32
    partial products, to the bit; with one split it is ``matmul_ref``."""
    a, b = map(torch.from_numpy, _operands(300, 4000, 10, seed=1))
    bounds = [0, 1000, 2500, 4000]
    parts = torch.stack([a[:, lo:hi] @ b[lo:hi]
                         for lo, hi in zip(bounds, bounds[1:])])
    assert torch.equal(matmul_split_ref(a, b, bounds),
                       splitk_reduce_ref(parts))
    assert torch.equal(matmul_split_ref(a, b, [0, 4000]), matmul_ref(a, b))
    assert matmul_split_ref(a, b, bounds, torch.bfloat16).dtype == \
        torch.bfloat16


# ----------------------------------------------------- the chip smoke
def test_smoke_expects_the_narrow_kernel_on_the_train_path():
    """``chip_smoke.py``'s train phase expects, per step, 1 tensor-core
    launch and 2 split passes (X·W1) and 1 folding narrow launch (a1·W2),
    no tile kernel, split-K pass or skinny kernel."""
    smoke = chip_smoke()
    routes, splits = smoke.train_routes(
        [(10000, 1600, 100000), (10000, 100000, 10)], SMS)
    assert routes == ["tc", "narrow"] and splits == [1, 3]
    want = {"matmul_tc": 5, "matmul_tf32_split": 10, "matmul_narrow": 5,
            "matmul_narrow_fold": 5}
    got = smoke.train_launches(routes, splits, 5)
    assert {k: v for k, v in got.items() if v} == want
    assert got["matmul"] == got["matmul_splitk_reduce"] == 0
