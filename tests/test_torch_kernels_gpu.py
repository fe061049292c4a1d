"""The port's CUDA kernels on the card (marked ``gpu``).

The matmul's skinny kernel, tile kernel and split-K reduction, the flash
attention kernel and the SSD scan kernel have no CPU mode, so these tests
skip without a CUDA device.
With a card they run with

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_kernels_gpu.py

holding each kernel against its plain version.  The matmul
(``matmul_ref``) at the shapes of ``tests/test_kernels.py``, the ragged
100×70×50 case and the scorer's two product shapes: f32 at rtol 1e-5
(1e-4 at K = 100000, where the summation orders differ over many more
terms), atol 1e-5·√K; bf16 at 2e-2 — f32 with at most 16 rows through the
skinny kernel, f32 with more rows and more than 32 columns through the
tensor-core route (two split passes and ``matmul_tc_kernel``), the rest
through the tile kernel, as the counters show; the split pass against
``tf32_split_ref`` to the bit (blocked views in place, a view of three
merged axes copied once), the tensor-core route at ragged M, N and K, in
f32 and bf16 out, and at the train path's X·W1 cut to N 2000 on the
engine's blocked views (no copy), bit-equal to contiguous operands; the
skinny kernel on strided views read in place (the scorer's blocked W1,
blocks with ragged edges, W2's 40-byte rows), copies only of layouts TMA
cannot read, its split-K fold bit-equal to ``splitk_reduce_ref`` on its own
partial tiles, and one scorer dispatch through the engine (2 skinny
launches, no other, no copy).  Flash attention (``attention_ref``)
at the cases of ``tests/test_kernels.py:47-76`` (f32 at 2e-4, bf16 at
3e-2, as there), ragged lengths, ``sq < skv``, ``dv != d``, head dim 256,
strided inputs and a gemma2-shaped case at S = 2048 — every bf16 case
through the tensor-core kernel, every f32 case through the FFMA kernel,
which the launch counters show; copies only of layouts TMA cannot read;
and the smoke-width dense models through the kernel against the same
models with the plain attention (f32, 1e-4).  The SSD scan
(``ssd_chunked_ref``) at the cases of ``tests/test_kernels.py:107-139``,
ragged S, S < chunk, mamba2-130m's layer dims and the default chunk of
256 (run as the kernel's 128), within 1e-4 (f32) or 1e-2 (bf16) of the
largest |output| — every bf16 case through the tensor-core kernel, every
f32 case through the FFMA kernel, which the launch counters show; B and C
read in place as slices of one tensor; the final state of the same launch
against ``ssd_final_state`` and the plain scan's carried state; and
mamba2-smoke through the kernels against the same model with the plain
SSD scan (f32 at 1e-4; bf16 within 0.02·(max|logit| + 1)).  The SSD
backward kernels (``ssd_scan_bwd``) against the plain backward computed
in f64 within ``chip_smoke.py``'s limits at the forward's cases, the
default chunk, strided inputs, strong decay and the two models' layer
dims, their launch counters, bit-equal repeats and a refused launch;
``ssd_scan`` under autograd on the card; and one train step of
mamba2-smoke and zamba2-smoke on the card against the CPU's.  zamba2-7b's
shapes: the bf16 flash kernel at head dim 112 on the model's transposed
views (no copy), the bf16 SSD kernel at state 64 with an odd S, and
zamba2-smoke through both kernels (launches counted; f32 at 1e-4, bf16
within its rounding floor).  The §5.3 FFNN train step through the
tensor-core route (X·W1), the tile kernel and its split-K pass (a1·W2)
(SGD and AdamW, three steps, no operand copy) against the same steps on
the plain matmul, and the tile kernel at the train path's second product
scaled down (10 columns, split in K).  This file
imports neither JAX nor the JAX package, so it runs where only PyTorch is
installed.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    attention_bwd_ref, attention_ref)
from repro_torch.kernels.matmul import ops  # noqa: E402
from repro_torch.kernels.matmul.ref import (matmul_ref,  # noqa: E402
                                            splitk_reduce_ref,
                                            tf32_split_ref)
from repro_torch.kernels.ssd_scan import ops as ssd_ops  # noqa: E402
from repro_torch.kernels.ssd_scan.ref import ssd_chunked_ref  # noqa: E402

SHAPES = [(128, 128, 128), (256, 512, 128), (384, 256, 640), (100, 70, 50),
          (8, 1600, 4000), (8, 100000, 10), (1, 100000, 10)]
TOL = {"float32": 1e-5, "bfloat16": 2e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _operands(m, k, n, dtype, device, seed=2):
    r = np.random.default_rng(seed)
    a = torch.tensor(r.standard_normal((m, k)), dtype=torch.float32)
    b = torch.tensor(r.standard_normal((k, n)), dtype=torch.float32)
    dt = getattr(torch, dtype)
    return a.to(device=device, dtype=dt), b.to(device=device, dtype=dt)


def _counts():
    return (ops.SKINNY_LAUNCHES, ops.LAUNCHES, ops.REDUCE_LAUNCHES,
            ops.FOLDS, ops.COPIES)


def _tc_counts():
    """Launches of the tensor-core kernel and of its split pass."""
    return ops.TC_LAUNCHES, ops.SPLIT_LAUNCHES


def _narrow_counts():
    """Launches of the narrow kernel, and those that folded."""
    return ops.NARROW_LAUNCHES, ops.NARROW_FOLDS


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n", SHAPES)
@pytest.mark.parametrize("dtype", sorted(TOL))
def test_kernel_matches_plain_on_card(cuda, m, k, n, dtype):
    a, b = _operands(m, k, n, dtype, cuda)
    before, tc_before = _counts(), _tc_counts()
    got = ops.matmul(a, b, impl="kernel")
    want = matmul_ref(a, b)
    torch.cuda.synchronize()
    skinny, tile, reduces, _, copies = (x - y for x, y in zip(_counts(),
                                                              before))
    tc, passes = (x - y for x, y in zip(_tc_counts(), tc_before))
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    route = ops.route(a, b, "kernel")
    assert route == ("tile" if dtype != "float32" else "skinny" if m <= 16
                     else "tc" if n > 32 else "narrow")
    assert route != "narrow"             # the narrow tests are below
    if route == "skinny":
        assert (skinny, tile, reduces, tc, passes) == (1, 0, 0, 0, 0)
    elif route == "tc":
        assert (skinny, tile, reduces, tc, passes) == (0, 0, 0, 1, 2)
    else:
        split = ops.plan_launch(m, n, k, sms)[1] > 1
        assert (skinny, tile, reduces, tc, passes) == (0, 1, int(split), 0,
                                                       0)
    assert copies == 0
    assert got.dtype == a.dtype and tuple(got.shape) == (m, n)
    tol = TOL[dtype]
    rtol = 1e-4 if k >= 100000 and dtype == "float32" else tol
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), rtol=rtol,
                               atol=tol * k ** 0.5)
    # split-K and the tensor-core route are deterministic: a second launch
    # is bit-identical
    again = ops.matmul(a, b)
    assert torch.equal(again, got)


@pytest.mark.gpu
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_out_dtype_on_card(cuda, out_dtype):
    a, b = _operands(8, 256, 96, "float32", cuda)
    got = ops.matmul(a, b, impl="kernel", out_dtype=out_dtype)
    assert got.dtype == out_dtype
    want = matmul_ref(a, b, out_dtype)
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), rtol=2e-2,
                               atol=2e-2 * 16)


@pytest.mark.gpu
def test_unaligned_and_ragged_operands_on_card(cuda):
    """A B that starts off a 16-byte boundary takes the tile kernel's
    scalar load path (N = 128 would otherwise take float4 loads)."""
    base = torch.randn(64 * 128 + 1, device=cuda)
    b = base[1:].view(64, 128)                 # contiguous, 4-byte offset
    a = torch.randn(5, 64, device=cuda)
    launches, copies = ops.LAUNCHES, ops.COPIES
    got = ops._launch_tile(a, b, 5, 64, 128, torch.float32)
    np.testing.assert_allclose(got.cpu().numpy(),
                               matmul_ref(a, b).cpu().numpy(), rtol=1e-5,
                               atol=1e-4)
    assert (ops.LAUNCHES, ops.COPIES) == (launches + 1, copies)


@pytest.mark.gpu
def test_skinny_kernel_copies_an_unaligned_operand_once_on_card(cuda):
    """The same B is out of TMA's reach: the skinny kernel's op copies it
    once, and counts the copy."""
    base = torch.randn(64 * 128 + 1, device=cuda)
    b = base[1:].view(64, 128)
    a = torch.randn(5, 64, device=cuda)
    launches, copies = ops.SKINNY_LAUNCHES, ops.COPIES
    np.testing.assert_allclose(ops.matmul(a, b).cpu().numpy(),
                               matmul_ref(a, b).cpu().numpy(), rtol=1e-5,
                               atol=1e-4)
    assert (ops.SKINNY_LAUNCHES, ops.COPIES) == (launches + 1, copies + 1)


@pytest.mark.gpu
def test_auto_on_card_launches_the_kernel(cuda):
    a = torch.randn(8, 64, device=cuda)
    b = torch.randn(64, 32, device=cuda)
    before = ops.SKINNY_LAUNCHES
    ops.matmul(a, b)
    assert ops.SKINNY_LAUNCHES == before + 1
    # a non-contiguous (column-major) B no longer raises: it is copied into
    # a layout the kernel reads, and counted
    copies = ops.COPIES
    bt = b.t().contiguous().t()
    np.testing.assert_allclose(ops.matmul(a, bt).cpu().numpy(),
                               matmul_ref(a, b).cpu().numpy(), rtol=1e-5,
                               atol=1e-4)
    assert ops.COPIES == copies + 1
    with pytest.raises(ValueError, match="CUDA device"):
        ops.matmul(a, b.cpu())


@pytest.mark.gpu
def test_scorer_dispatch_launches_twice_on_card(cuda):
    """Through the engine: one speech-shaped scorer dispatch (narrow
    hidden width) launches the skinny kernel once per fused product, reads
    the blocked W1 and W2 in place (no copy), and launches neither the tile
    kernel nor a separate reduction: the split second product folds its
    sum in its own launch."""
    from repro_torch.core import Engine
    from repro_torch.serve import FFNNScorer
    sc = FFNNScorer(db=4, hb=10, lb=1, bd=400, bh=100, bl=10, device=cuda)
    eng = Engine(executor="jit", device=cuda)
    payloads = [sc.random_payload(np.random.default_rng(i)) for i in range(3)]
    before = _counts()
    out = eng.run(sc.program(4)["scores"], **sc.pack(payloads, 4),
                  **sc.weights())
    skinny, tile, reduces, folds, copies = (x - y for x, y in
                                            zip(_counts(), before))
    assert (skinny, tile, reduces, copies) == (2, 0, 0, 0)
    assert folds >= 1                       # (4 x 1000) @ (1000 x 10) splits
    got = out.data[:3].reshape(3, -1).cpu().numpy()
    for p, g in zip(payloads, got):
        np.testing.assert_allclose(g, sc.oracle(p), atol=1e-5)


def _blocked(r0, r1, c0, c1, device, seed):
    """A (r0·r1, c0·c1) matrix held as the permuted view (r0, r1, c0, c1)
    of a (r0, c0, r1, c1) tensor, as the engine hands over a blocked
    relation; and the same values as a contiguous 2-D tensor."""
    r = np.random.default_rng(seed)
    t = torch.tensor(r.standard_normal((r0, c0, r1, c1)),
                     dtype=torch.float32, device=device)
    view = t.permute(0, 2, 1, 3)
    return view, view.reshape(r0 * r1, c0 * c1)


@pytest.mark.gpu
@pytest.mark.parametrize("m,blocks", [
    (8, (4, 400, 10, 1000)),      # the scorer's W1 at a narrow width
    (3, (3, 100, 5, 1000)),       # ragged inside each block: 100 and 1000
    (16, (2, 72, 3, 52)),         # 16 rows, blocks narrower than a tile
    (1, (5, 33, 1, 300)),
])
def test_skinny_kernel_reads_blocked_views_in_place(cuda, m, blocks):
    view, dense = _blocked(*blocks, cuda, seed=m)
    k = blocks[0] * blocks[1]
    a = torch.randn(m, k, device=cuda)
    before = _counts()
    got = ops.matmul(a, view, b_rows=2)
    want = matmul_ref(a, dense)
    torch.cuda.synchronize()
    skinny, tile, _, _, copies = (x - y for x, y in zip(_counts(), before))
    assert (skinny, tile, copies) == (1, 0, 0)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=1e-5, atol=1e-5 * k ** 0.5)


@pytest.mark.gpu
@pytest.mark.parametrize("m,n", [(8, 10), (8, 7), (8, 4), (16, 10),
                                 (2, 32)])
def test_skinny_kernel_reads_short_rows_in_place(cuda, m, n):
    """A narrow B whose rows are not a multiple of 16 bytes (the scorer's
    W2: 10 f32) is read a group of packed rows at a time, not copied."""
    k = 4096
    a = torch.randn(m, k, device=cuda)
    b = torch.randn(k, n, device=cuda)
    copies = ops.COPIES
    got = ops.matmul(a, b)
    assert ops.COPIES == copies
    np.testing.assert_allclose(got.cpu().numpy(),
                               matmul_ref(a, b).cpu().numpy(), rtol=1e-5,
                               atol=1e-5 * k ** 0.5)


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n", [(8, 100000, 10), (1, 100000, 10),
                                   (8, 1600, 4000), (16, 20000, 300)])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_skinny_fold_is_splitk_reduce_ref_of_its_partials(cuda, m, k, n,
                                                          out_dtype):
    """The fold adds the splits' partial tiles in split order: its output
    equals ``splitk_reduce_ref`` of the kernel's own partials to the bit."""
    a, b = _operands(m, k, n, "float32", cuda, seed=5)
    folds = ops.FOLDS
    got, partials = ops._launch_skinny(a, b, 1, 1, m, k, n, out_dtype,
                                       keep_partials=True)
    assert partials is not None and partials.shape[1:] == (m, n)
    assert ops.FOLDS == folds + 1
    assert torch.equal(got, splitk_reduce_ref(partials, out_dtype))


@pytest.mark.gpu
def test_skinny_launches_on_two_streams_keep_their_own_tickets(cuda):
    a, b = _operands(8, 100000, 10, "float32", cuda, seed=6)
    want = ops.matmul(a, b)
    s1, s2 = torch.cuda.Stream(), torch.cuda.Stream()
    torch.cuda.synchronize()
    outs = []
    for s in (s1, s2, s1, s2):
        with torch.cuda.stream(s):
            outs.append(ops.matmul(a, b))
    torch.cuda.synchronize()
    for o in outs:
        assert torch.equal(o, want)


def _split_operand(kind, device):
    """An f32 operand of the split pass as ``(tensor, rows)``: contiguous,
    ragged (K 70), the engine's blocked view of X and of W1, and a view
    whose rows merge three strided axes (copied first)."""
    g = torch.Generator(device=device).manual_seed(7)
    if kind == "contiguous":
        return torch.randn((256, 512), generator=g, device=device), None
    if kind == "ragged":
        return torch.randn((100, 70), generator=g, device=device), None
    if kind == "blocked_x":                  # (nb, bn | db, bd) of (nb, db, bn, bd)
        t = torch.randn((4, 3, 50, 40), generator=g, device=device)
        return t.permute(0, 2, 1, 3), 2
    if kind == "blocked_w1":                 # (db, bd | hb, bh) of (db, hb, bd, bh)
        t = torch.randn((3, 5, 40, 36), generator=g, device=device)
        return t.permute(0, 2, 1, 3), 2
    t = torch.randn((2, 3, 4, 24), generator=g, device=device)
    return t.permute(1, 0, 2, 3), 3          # rows (3, 2, 4): three axes


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["contiguous", "ragged", "blocked_x",
                                  "blocked_w1", "three_axes"])
@pytest.mark.parametrize("transpose", [False, True])
def test_tf32_split_matches_plain_on_card(cuda, kind, transpose):
    """The tensor-core route's operand pass against its plain version (torch
    bit operations), to the bit: both TF32 terms, K padded with zeros, B
    transposed; views read in place, a view of three merged row axes
    copied once and counted."""
    x, rows = _split_operand(kind, cuda)
    r = math.prod(x.shape[:rows or 1])
    dense = x.reshape(r, -1)
    kp = ops.tc_kp(dense.shape[0] if transpose else dense.shape[1])
    copies, passes = ops.COPIES, ops.SPLIT_LAUNCHES
    got = ops.tf32_split(x, rows=rows, transpose=transpose)
    torch.cuda.synchronize()
    assert torch.equal(got, tf32_split_ref(dense, kp, transpose))
    assert ops.SPLIT_LAUNCHES == passes + 1
    assert ops.COPIES == copies + (kind == "three_axes")


@pytest.mark.gpu
def test_tc_route_at_the_train_first_product_on_card(cuda):
    """X·W1 of the train path cut to N 2000 (D 1600, H 100000), X and W1
    handed over as the engine's blocked views (nb, bn | db, bd) and (db, bd
    | hb, bh): two split passes read them in place (no copy), one
    tensor-core launch, within tolerance(1600, f32) of the plain version;
    bit-equal to the same values given as contiguous tensors, and to a
    second launch."""
    nb, db, hb, n, d, h = 10, 4, 10, 2000, 1600, 100000
    bn, bd, bh = n // nb, d // db, h // hb
    g = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn((n, d), generator=g, device=cuda)
    w1 = torch.randn((d, h), generator=g, device=cuda) * d ** -0.5
    x_view = x.reshape(nb, bn, db, bd).permute(0, 2, 1, 3).contiguous() \
        .permute(0, 2, 1, 3)
    w_view = w1.reshape(db, bd, hb, bh).permute(0, 2, 1, 3).contiguous() \
        .permute(0, 2, 1, 3)
    before, tc_before = _counts(), _tc_counts()
    got = ops.matmul(x_view, w_view, a_rows=2, b_rows=2)
    torch.cuda.synchronize()
    assert tuple(got.shape) == (n, h)
    assert _counts() == before
    assert _tc_counts() == (tc_before[0] + 1, tc_before[1] + 2)
    want = matmul_ref(x, w1)
    rtol, atol = 1e-5, 1e-5 * d ** 0.5
    assert bool(((got - want).abs() <= atol + rtol * want.abs()).all())
    assert torch.equal(got, ops.matmul(x, w1))
    assert torch.equal(got, ops.matmul(x_view, w_view, a_rows=2, b_rows=2))


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n", [(17, 33, 33), (129, 100, 257),
                                   (300, 1600, 1000)])
def test_tc_route_ragged_edges_on_card(cuda, m, k, n):
    """Rows, columns and K off the kernel's 128 x 128 x 32 tiles, f32 and
    bf16 out: the edges masked, K's padding zero."""
    a, b = _operands(m, k, n, "float32", cuda, seed=4)
    assert ops.route(a, b, "kernel") == "tc"
    want = matmul_ref(a, b)
    got = ops.matmul(a, b, impl="kernel")
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=1e-5, atol=1e-5 * k ** 0.5)
    half = ops.matmul(a, b, impl="kernel", out_dtype=torch.bfloat16)
    assert half.dtype == torch.bfloat16
    assert torch.equal(half, got.to(torch.bfloat16))


# ------------------------------------------------- the narrow kernel
def _narrow_check(got, a, b):
    """``got`` against the exact product (the operands multiplied in f64)
    within the f32 limit at this K.  Not against the plain version in f32:
    at K 100000 on N(0, 1) operands a few outputs of the two differ by more
    than the limit.  Returns the largest error of ``got`` and of the f32
    plain version against the exact product."""
    k = a.shape[1]
    rtol = 1e-4 if k >= 100000 else 1e-5
    exact = a.double() @ b.double()
    np.testing.assert_allclose(got.double().cpu().numpy(),
                               exact.cpu().numpy(), rtol=rtol,
                               atol=1e-5 * k ** 0.5)
    return ((got.double() - exact).abs().max().item(),
            (matmul_ref(a, b).double() - exact).abs().max().item())


def _narrow_operands(m, k, n, device, seed):
    """f32 A (m, k) and B (k, n) drawn on the card (the train shape's 4 GB
    A would take a while through numpy)."""
    g = torch.Generator(device=device).manual_seed(seed)
    return (torch.randn((m, k), generator=g, device=device),
            torch.randn((k, n), generator=g, device=device))


def _narrow_plan(a, b, a_rows=1, b_rows=1):
    sms = torch.cuda.get_device_properties(a.device).multi_processor_count
    op = ops.plan_operands((a.shape, a.stride(), a.data_ptr(), a_rows),
                           (b.shape, b.stride(), b.data_ptr(), b_rows),
                           "narrow")
    return ops.plan_narrow(op.a, op.b, op.b_plan, sms)


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n", [(10000, 100000, 10)]
                         + [(333, 4004, n) for n in range(1, 33)]
                         + [(17, 100000, 10), (129, 32, 1), (2000, 96, 32)])
def test_narrow_kernel_matches_plain_on_card(cuda, m, k, n):
    """The narrow kernel at the train path's a1·W2 and at ragged M, K and
    N = 1 … 32 (K 4004 is off the 32-deep step but keeps rows on 16 bytes,
    so nothing is copied): one launch, no other kernel, no copy, within
    the f32 limit of ``matmul_ref``, and a second launch bit-identical."""
    a, b = _narrow_operands(m, k, n, cuda, seed=7)
    before = _counts(), _tc_counts(), _narrow_counts()
    got = ops.matmul(a, b, impl="kernel")
    torch.cuda.synchronize()
    assert (_counts(), _tc_counts()) == before[:2]
    plan = _narrow_plan(a, b)
    assert _narrow_counts() == (before[2][0] + 1,
                                before[2][1] + (plan.splits > 1))
    assert got.dtype == torch.float32 and tuple(got.shape) == (m, n)
    err, plain_err = _narrow_check(got, a, b)
    if k >= 100000:              # a sum in 12 or more parts against one
        assert err <= plain_err
    assert torch.equal(ops.matmul(a, b), got)


@pytest.mark.gpu
@pytest.mark.parametrize("block_major,bh", [(False, 2000), (True, 2048),
                                            (True, 2000)])
def test_narrow_kernel_reads_blocked_views_in_place_on_card(cuda,
                                                            block_major, bh):
    """a1·W2 as the engine hands it over, at nb = 4, hb = 5: a1 as the
    view (nb, bn | hb, bh) of a tensor stored row-major (as the X·W1
    product leaves it) or block-major (nb, hb, bn, bh), W2 as the view
    (hb, bh | lb, bl) of its blocked tensor.  Read in place (no copy) and
    within the f32 limit; bit-identical to the same values handed over as
    contiguous 2-D tensors where the K blocks are whole 32-deep K steps.
    Block-major a1 with K blocks of 2000 is not: it is read a K block at a
    time, each block ending in a short step, which moves the later steps'
    sums to other warps and the splits' bounds along K.  There the two
    results are held to each other within the f32 limit (rtol 1e-5, atol
    1e-5·√K) instead."""
    nb, bn, hb, n = 4, 300, 5, 10
    r = np.random.default_rng(8)
    a1 = torch.tensor(r.standard_normal((nb, bn, hb, bh)),
                      dtype=torch.float32, device=cuda)
    if block_major:
        a1 = a1.permute(0, 2, 1, 3).contiguous().permute(0, 2, 1, 3)
    w2 = torch.tensor(r.standard_normal((hb, 1, bh, n)),
                      dtype=torch.float32, device=cuda)
    w2_view = w2.permute(0, 2, 1, 3)
    a2, b2 = a1.reshape(nb * bn, -1), w2_view.reshape(hb * bh, n)
    copies, (launches, _) = ops.COPIES, _narrow_counts()
    got = ops.matmul(a1, w2_view, a_rows=2, b_rows=2)
    torch.cuda.synchronize()
    assert ops.COPIES == copies and _narrow_counts()[0] == launches + 1
    _narrow_check(got, a2, b2)
    flat = ops.matmul(a2.contiguous(), b2.contiguous())
    if block_major and bh % 32:
        k = hb * bh
        np.testing.assert_allclose(got.cpu().numpy(), flat.cpu().numpy(),
                                   rtol=1e-5, atol=1e-5 * k ** 0.5)
    else:
        assert torch.equal(flat, got)


@pytest.mark.gpu
def test_narrow_kernel_copies_an_unreadable_view_once_on_card(cuda):
    """A with rows of 4001 f32 (off 16 bytes) is out of TMA's reach: the op
    copies it once into a padded layout, counts the copy, and the result
    is the same."""
    a, b = _narrow_operands(300, 4001, 12, cuda, seed=9)
    copies, (launches, _) = ops.COPIES, _narrow_counts()
    got = ops.matmul(a, b)
    torch.cuda.synchronize()
    assert ops.COPIES == copies + 1
    assert _narrow_counts()[0] == launches + 1
    _narrow_check(got, a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n", [(10000, 100000, 10), (333, 4004, 7),
                                   (17, 100000, 32)])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_narrow_fold_is_the_split_order_sum_of_its_partials(cuda, m, k, n,
                                                            out_dtype):
    """The fold adds the splits' partial tiles in split order: the output
    equals ``splitk_reduce_ref`` of the kernel's own partials to the bit
    (the second half of ``matmul_split_ref``); each partial is its split's
    product (``plan.k_bounds``) within the f32 limit; and the tickets are
    all 0 again after the launch."""
    a, b = _narrow_operands(m, k, n, cuda, seed=10)
    plan = _narrow_plan(a, b)
    assert plan.splits > 1
    folds = ops.NARROW_FOLDS
    got, partials = ops._launch_narrow(a, b, 1, 1, m, k, n, out_dtype,
                                       keep_partials=True)
    torch.cuda.synchronize()
    assert ops.NARROW_FOLDS == folds + 1
    assert tuple(partials.shape) == (plan.splits, m, n)
    assert torch.equal(got, splitk_reduce_ref(partials, out_dtype))
    bounds = plan.k_bounds()
    for z in range(plan.splits):
        _narrow_check(partials[z], a[:, bounds[z]:bounds[z + 1]],
                      b[bounds[z]:bounds[z + 1]])
    if out_dtype == torch.float32:
        _narrow_check(got, a, b)
    stream = torch.cuda.current_stream(cuda).cuda_stream
    tickets = ops._TICKETS[(cuda.index if cuda.index is not None
                            else torch.cuda.current_device(), stream)]
    assert not bool(tickets.any())


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n", [(300, 100000, 32), (17, 100000, 32),
                                   (10000, 100000, 10), (8, 100000, 10)])
def test_repeated_launches_are_bit_identical_on_card(cuda, m, k, n):
    """40 launches of the narrow kernel (and of the skinny kernel, 8 rows),
    each bit-identical to the first and within the f32 limit of the exact
    product.  A stage read by the CUDA cores must be fenced against the
    TMA that refills it: without the fence, at N 32 the last columns of a
    split came from the next stage in most launches."""
    a, b = _narrow_operands(m, k, n, cuda, seed=10)
    first = ops.matmul(a, b)
    _narrow_check(first, a, b)
    for _ in range(39):
        assert torch.equal(ops.matmul(a, b), first)


@pytest.mark.gpu
def test_narrow_kernel_never_falls_back_on_card(cuda):
    """A CUDA call on the narrow route launches the kernel or raises: a
    CPU operand beside a CUDA one raises, and launches nothing."""
    a, b = _narrow_operands(300, 256, 10, cuda, seed=11)
    launches = _narrow_counts()[0]
    with pytest.raises(ValueError, match="CUDA device"):
        ops.matmul(a, b.cpu())
    assert _narrow_counts()[0] == launches


@pytest.mark.gpu
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_splitk_reduce_matches_plain_on_card(cuda, out_dtype):
    """The reduction adds in the plain version's split order: bit-equal."""
    r = np.random.default_rng(4)
    part = torch.tensor(r.standard_normal((261, 8, 10)), dtype=torch.float32,
                        device=cuda)
    before = ops.REDUCE_LAUNCHES
    got = ops.splitk_reduce(part, impl="kernel", out_dtype=out_dtype)
    assert ops.REDUCE_LAUNCHES == before + 1
    assert got.dtype == out_dtype and tuple(got.shape) == (8, 10)
    assert torch.equal(got, splitk_reduce_ref(part, out_dtype))


# ------------------------------------------------------------ flash attention
FLASH_TOL = {"float32": 2e-4, "bfloat16": 3e-2}


def _qkv(b, hq, hkv, sq, skv, d, dv, dtype, device, seed=0):
    r = np.random.default_rng(seed)
    dt = getattr(torch, dtype)
    return tuple(torch.tensor(r.standard_normal(s), dtype=torch.float32)
                 .to(device=device, dtype=dt)
                 for s in ((b, hq, sq, d), (b, hkv, skv, d),
                           (b, hkv, skv, dv)))


def _flash_check(q, k, v, dtype, **kw):
    before = flash_ops.LAUNCHES
    got = flash_ops.attention(q, k, v, impl="kernel", **kw)
    want = attention_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    assert flash_ops.LAUNCHES == before + 1
    assert got.dtype == q.dtype and got.shape == want.shape
    tol = FLASH_TOL[dtype]
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), rtol=tol,
                               atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", sorted(FLASH_TOL))
@pytest.mark.parametrize("hq,hkv", [(4, 4), (8, 2)])
@pytest.mark.parametrize("causal,window,softcap", [
    (True, 0, 0.0), (True, 64, 0.0), (True, 0, 30.0), (False, 0, 0.0)])
def test_flash_kernel_matches_plain_on_card(cuda, dtype, hq, hkv, causal,
                                            window, softcap):
    q, k, v = _qkv(2, hq, hkv, 256, 256, 64, 64, dtype, cuda)
    _flash_check(q, k, v, dtype, causal=causal, window=window,
                 softcap=softcap)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", sorted(FLASH_TOL))
@pytest.mark.parametrize("sq,skv,d,dv,kw", [
    (200, 200, 64, 64, dict(causal=True, window=0, softcap=0.0)),
    (1000, 1000, 64, 64, dict(causal=True, window=100, softcap=30.0)),
    (100, 300, 64, 64, dict(causal=True, window=0, softcap=0.0)),
    (37, 300, 32, 32, dict(causal=True, window=50, softcap=0.0)),
    (300, 100, 64, 64, dict(causal=True, window=0, softcap=0.0)),
    (130, 130, 24, 16, dict(causal=True, window=0, softcap=0.0)),
    (130, 130, 20, 12, dict(causal=True, window=0, softcap=0.0)),
    (200, 200, 192, 128, dict(causal=True, window=0, softcap=0.0)),
    (300, 300, 256, 256, dict(causal=True, window=128, softcap=50.0)),
    (300, 300, 256, 256, dict(causal=False, window=0, softcap=0.0)),
    (1, 300, 64, 64, dict(causal=True, window=0, softcap=0.0)),
])
def test_flash_kernel_ragged_and_dims_on_card(cuda, dtype, sq, skv, d, dv,
                                              kw):
    """Ragged lengths, ``sq < skv`` (ends aligned), ``sq > skv`` (leading
    rows fully masked: 0), ``dv != d``, head dim 256, and rows of 40 and
    24 bytes, which TMA cannot step (bf16: copied first)."""
    q, k, v = _qkv(2, 8, 4, sq, skv, d, dv, dtype, cuda, seed=1)
    _flash_check(q, k, v, dtype, **kw)


@pytest.mark.gpu
def test_flash_kernel_reads_strided_views_on_card(cuda):
    """The model hands over ``transpose(1, 2)`` views: read in place, same
    result as contiguous inputs; the output is a (B,Hq,S,Dv) view."""
    r = np.random.default_rng(3)
    x = [torch.tensor(r.standard_normal((2, 300, h, 64)), dtype=torch.float32,
                      device=cuda) for h in (8, 4, 4)]
    q, k, v = (t.transpose(1, 2) for t in x)
    assert not q.is_contiguous()
    got = flash_ops.attention(q, k, v, window=77, softcap=20.0)
    want = flash_ops.attention(q.contiguous(), k.contiguous(),
                               v.contiguous(), window=77, softcap=20.0)
    assert tuple(got.shape) == (2, 8, 300, 64)
    np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())
    np.testing.assert_allclose(
        got.cpu().numpy(),
        attention_ref(q, k, v, window=77, softcap=20.0).cpu().numpy(),
        rtol=2e-4, atol=2e-4)


@pytest.mark.gpu
def test_flash_auto_on_card_launches_the_kernel(cuda):
    q, k, v = _qkv(1, 4, 2, 64, 64, 32, 32, "bfloat16", cuda)
    before = flash_ops.LAUNCHES
    flash_ops.attention(q, k, v)
    assert flash_ops.LAUNCHES == before + 1
    # a window wider than any row - col distance masks nothing
    assert torch.equal(flash_ops.attention(q, k, v, window=2 ** 40),
                       flash_ops.attention(q, k, v))
    before = flash_ops.LAUNCHES          # refused calls launch nothing
    with pytest.raises(ValueError, match="CUDA device"):
        flash_ops.attention(q, k.cpu(), v)
    with pytest.raises(ValueError, match="head dims"):
        flash_ops.attention(*_qkv(1, 2, 2, 8, 8, 320, 320, "float32", cuda))
    assert flash_ops.LAUNCHES == before


@pytest.mark.gpu
def test_flash_routes_by_dtype_on_card(cuda):
    """bf16 goes to the tensor-core kernel, f32 to the FFMA kernel; every
    launch also counts in ``LAUNCHES``."""
    counts = ("LAUNCHES", "TC_LAUNCHES", "FFMA_LAUNCHES")
    for dtype, kernel in (("bfloat16", "TC_LAUNCHES"),
                          ("float32", "FFMA_LAUNCHES")):
        before = {c: getattr(flash_ops, c) for c in counts}
        flash_ops.attention(*_qkv(1, 4, 2, 100, 100, 64, 64, dtype, cuda))
        after = {c: getattr(flash_ops, c) - before[c] for c in counts}
        assert after == {"LAUNCHES": 1, kernel: 1,
                         ({*counts} - {"LAUNCHES", kernel}).pop(): 0}


@pytest.mark.gpu
def test_flash_copies_only_layouts_tma_cannot_read_on_card(cuda):
    """The model's ``transpose(1, 2)`` views go to TMA in place (no copy);
    a bf16 input whose last dim is strided is copied once, with the same
    result as a contiguous input."""
    r = np.random.default_rng(4)
    x = [torch.tensor(r.standard_normal((2, 200, h, 128)),
                      device=cuda).bfloat16() for h in (8, 4, 4)]
    q, k, v = (t.transpose(1, 2) for t in x)
    before = flash_ops.COPIES
    got = flash_ops.attention(q, k, v, window=50, softcap=30.0)
    assert flash_ops.COPIES == before
    want = flash_ops.attention(q.contiguous(), k.contiguous(),
                               v.contiguous(), window=50, softcap=30.0)
    assert torch.equal(got, want)
    q2 = q[..., ::2]                       # last dim strided
    assert flash_ops.tma_map(q2.shape, q2.stride(), q2.data_ptr(),
                             flash_ops.Q_ROWS) is None
    got = flash_ops.attention(q2, k[..., :64], v)
    assert flash_ops.COPIES == before + 1
    assert torch.equal(got, flash_ops.attention(q2.contiguous(), k[..., :64],
                                                v))
    assert flash_ops.COPIES == before + 1


@pytest.mark.gpu
@pytest.mark.parametrize("window", [1024, 0])
def test_flash_kernel_gemma2_shaped_on_card(cuda, window):
    """gemma2-2b's attention (8/4 heads of dim 256, soft-cap 50) at S = 2048,
    in bf16 through the tensor-core kernel: a 1024-token window (the even
    layers' kind) and global."""
    q, k, v = _qkv(1, 8, 4, 2048, 2048, 256, 256, "bfloat16", cuda, seed=5)
    before = flash_ops.TC_LAUNCHES
    _flash_check(q, k, v, "bfloat16", causal=True, window=window,
                 softcap=50.0)
    assert flash_ops.TC_LAUNCHES == before + 1


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["gemma2-2b", "qwen2-7b"])
def test_dense_model_through_the_kernel_on_card(cuda, arch):
    """The smoke-width model in f32 on the card: one flash launch per layer
    in the prefill, none in decode, logits within 1e-4 of the same model
    with the plain attention; the ``--dense-oracle`` loop runs."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch.serve import dense_generate
    from repro_torch.models import decode_step, init_params, prefill
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32")
    model = init_params(cfg, 0, device=cuda)
    prompts = torch.randint(0, cfg.vocab_size, (2, 200), device=cuda,
                            generator=torch.Generator(cuda).manual_seed(1))
    before = flash_ops.LAUNCHES
    run = dense_generate(cfg, model, prompts, 3)
    assert flash_ops.LAUNCHES == before + cfg.n_layers
    with torch.inference_mode():
        _, cache = prefill(cfg, model, {"tokens": prompts}, 203)
        assert flash_ops.LAUNCHES == before + 2 * cfg.n_layers
        decode_step(cfg, model, cache,
                    {"token": run.prefill_logits.argmax(-1)})
    assert flash_ops.LAUNCHES == before + 2 * cfg.n_layers
    model.attn_impl = "plain"
    with torch.inference_mode():
        logits, cache = prefill(cfg, model, {"tokens": prompts}, 203)
        step, _ = decode_step(cfg, model, cache,
                              {"token": run.prefill_logits.argmax(-1)})
    np.testing.assert_allclose(run.prefill_logits.cpu().numpy(),
                               logits.cpu().numpy(), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(run.first_decode_logits.cpu().numpy(),
                               step.cpu().numpy(), rtol=1e-4, atol=1e-4)


# ------------------------------------------------------------------ SSD scan
SSD_TOL = {"float32": 1e-4, "bfloat16": 1e-2}     # of the largest |output|
SSD_STATE_TOL = 1e-4          # chip_smoke.py's: of the f64 state's largest |h|


def _ssd_inputs(b, s, h, p, n, dtype, device, seed=0):
    """x, dt, A, B, C as the JAX kernel tests draw them: x, B, C normal in
    ``dtype``; dt = softplus(normal) and A = -exp(normal) in f32."""
    r = np.random.default_rng(seed)
    dt_ = getattr(torch, dtype)

    def f32(shape):
        return torch.tensor(r.standard_normal(shape), dtype=torch.float32)
    x, bm, cm = f32((b, s, h, p)), f32((b, s, n)), f32((b, s, n))
    dt = torch.nn.functional.softplus(f32((b, s, h)))
    A = -torch.exp(f32((h,)))
    return (x.to(device, dt_), dt.to(device), A.to(device), bm.to(device, dt_),
            cm.to(device, dt_))


def _ssd_counts():
    return (ssd_ops.LAUNCHES, ssd_ops.TC_LAUNCHES, ssd_ops.FFMA_LAUNCHES,
            ssd_ops.COPIES)


def _ssd_check(x, dt, A, bm, cm, chunk, dtype):
    before = _ssd_counts()
    got = ssd_ops.ssd_scan(x, dt, A, bm, cm, chunk=chunk, impl="kernel")
    want = ssd_chunked_ref(x, dt, A, bm, cm, min(chunk, x.shape[1]))
    torch.cuda.synchronize()
    # bf16 on the tensor-core kernel, f32 on the FFMA kernel, no cast
    tc = dtype == "bfloat16"
    assert _ssd_counts() == (before[0] + 1, before[1] + tc,
                             before[2] + (not tc), before[3])
    assert got.dtype == x.dtype and got.shape == x.shape
    # the outputs sum terms of either sign (|C·B| ~ √N): the limit scales
    # with the largest output, as chip_smoke.py's does
    got, want = got.float().cpu().numpy(), want.float().cpu().numpy()
    tol = SSD_TOL[dtype] * np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", sorted(SSD_TOL))
@pytest.mark.parametrize("b,s,h,p,n,chunk", [
    (2, 64, 4, 16, 8, 16), (2, 128, 4, 16, 8, 32), (2, 96, 4, 16, 8, 32),
    (1, 64, 2, 16, 8, 32), (1, 128, 2, 16, 8, 64),
    (2, 200, 4, 16, 8, 64), (2, 40, 3, 16, 8, 128), (1, 77, 2, 24, 12, 16),
    (1, 300, 24, 64, 128, 128), (2, 520, 4, 64, 128, 128)],
    ids=["jax-64/16", "jax-128/32", "jax-96/32", "pallas-64/32",
         "pallas-128/64", "ragged200/64", "s<chunk", "ragged-odd-dims",
         "mamba2-layer-s300", "mamba2-dims-s520"])
def test_ssd_kernel_matches_plain_on_card(cuda, dtype, b, s, h, p, n, chunk):
    """The JAX kernel tests' cases (``tests/test_kernels.py:107-139``),
    ragged S (the last chunk masked in the kernel), S < chunk, N and P
    that are not multiples of 4 or 8, and mamba2-130m's layer dims (P=64,
    N=128, L=128) at a short S."""
    _ssd_check(*_ssd_inputs(b, s, h, p, n, dtype, cuda), chunk, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", sorted(SSD_TOL))
def test_ssd_kernel_default_chunk_on_card(cuda, dtype):
    """``ssd_scan``'s default chunk of 256 (JAX's) at S = 1024 runs on the
    card, as the kernel at chunk 128, against the plain version at chunk
    256: max |err| within ``SSD_TOL`` of the largest output and each row's
    error within ``chip_smoke.py``'s ``SSD_ROW_TOL`` of its norm."""
    x, dt, A, bm, cm = _ssd_inputs(2, 1024, 4, 64, 128, dtype, cuda, seed=6)
    _ssd_check(x, dt, A, bm, cm, 256, dtype)
    got = ssd_ops.ssd_scan(x, dt, A, bm, cm).float()
    want = ssd_chunked_ref(x, dt, A, bm, cm, 256).float()
    row = ((got - want).norm(dim=-1) / want.norm(dim=-1).clamp_min(1e-30))
    assert row.max().item() <= {"float32": 1e-3, "bfloat16": 1e-2}[dtype]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", sorted(SSD_TOL))
def test_ssd_kernel_reads_strided_b_c_in_place_on_card(cuda, dtype):
    """The model hands over B and C as slices of one (B, S, 2N) tensor and
    x as a reshape: read in place, the same result as contiguous copies."""
    x, dt, A, bm, cm = _ssd_inputs(2, 260, 4, 64, 128, dtype, cuda, seed=5)
    bcc = torch.cat([bm, cm], dim=-1)
    bv, cv = bcc[..., :128], bcc[..., 128:]
    assert not bv.is_contiguous() and not cv.is_contiguous()
    got = ssd_ops.ssd_scan(x, dt, A, bv, cv, chunk=128)
    want = ssd_ops.ssd_scan(x, dt, A, bv.contiguous(), cv.contiguous(),
                            chunk=128)
    np.testing.assert_array_equal(got.float().cpu().numpy(),
                                  want.float().cpu().numpy())
    _ssd_check(x, dt, A, bv, cv, 128, dtype)
    # a transposed x: (B, H, S, P) storage read as (B, S, H, P)
    xt = x.transpose(1, 2).contiguous().transpose(1, 2)
    np.testing.assert_array_equal(
        ssd_ops.ssd_scan(xt, dt, A, bv, cv, chunk=128).float().cpu().numpy(),
        got.float().cpu().numpy())


@pytest.mark.gpu
def test_ssd_auto_on_card_launches_the_kernel(cuda):
    x, dt, A, bm, cm = _ssd_inputs(1, 64, 2, 16, 8, "bfloat16", cuda)
    before = ssd_ops.LAUNCHES
    y = ssd_ops.ssd_scan(x, dt, A, bm, cm, chunk=32)
    assert ssd_ops.LAUNCHES == before + 1
    # a bf16 dt and A are cast to f32 first: the same launch
    y16 = ssd_ops.ssd_scan(x, dt.bfloat16().float(), A, bm, cm, chunk=32)
    assert torch.equal(ssd_ops.ssd_scan(x, dt.bfloat16(), A, bm, cm,
                                        chunk=32), y16)
    assert y.dtype == torch.bfloat16
    # a chunk above the kernel's 128 runs as the kernel at chunk 128
    big = _ssd_inputs(1, 512, 2, 16, 8, "float32", cuda)
    assert torch.equal(ssd_ops.ssd_scan(*big, chunk=256),
                       ssd_ops.ssd_scan(*big, chunk=128))
    before = ssd_ops.LAUNCHES            # refused calls launch nothing
    with pytest.raises(ValueError, match="CUDA device"):
        ssd_ops.ssd_scan(x, dt.cpu(), A, bm, cm, chunk=32)
    with pytest.raises(ValueError, match="states up to 128"):
        ssd_ops.ssd_scan(*_ssd_inputs(1, 64, 2, 16, 160, "float32", cuda),
                         chunk=32)
    with pytest.raises(ValueError, match="head dims up to 64"):
        ssd_ops.ssd_scan(*_ssd_inputs(1, 64, 2, 96, 8, "float32", cuda),
                         chunk=32)
    assert ssd_ops.LAUNCHES == before


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", sorted(SSD_TOL))
@pytest.mark.parametrize("b,s,h,p,n,chunk", [
    (2, 200, 4, 16, 8, 64), (2, 40, 3, 16, 8, 128), (1, 77, 2, 22, 13, 16),
    (1, 300, 24, 64, 128, 128), (2, 1000, 3, 64, 128, 128)],
    ids=["ragged200/64", "s<chunk", "ragged-odd-dims", "mamba2-layer-s300",
         "odd-heads-s1000"])
def test_ssd_final_state_on_card(cuda, dtype, b, s, h, p, n, chunk):
    """``return_final_state``: the state after the last step, from the same
    launch, within ``SSD_TOL`` of the largest |h| of ``ssd_final_state``
    (the plain reference, JAX's op) and of the state the plain chunked
    scan carries, and within ``SSD_STATE_TOL`` of the largest |h| of the
    state in f64 (an f32 state's precision, in both dtypes); y is the
    launch's y without the state, to the bit."""
    x, dt, A, bm, cm = _ssd_inputs(b, s, h, p, n, dtype, cuda, seed=8)
    before = _ssd_counts()
    y, hk = ssd_ops.ssd_scan(x, dt, A, bm, cm, chunk=chunk, impl="kernel",
                             return_final_state=True)
    assert _ssd_counts()[0] == before[0] + 1
    assert hk.dtype == torch.float32 and tuple(hk.shape) == (b, h, n, p)
    assert torch.equal(y, ssd_ops.ssd_scan(x, dt, A, bm, cm, chunk=chunk))
    _, carried = ssd_chunked_ref(x, dt, A, bm, cm, min(chunk, s),
                                 final_state=True)
    for want in (ssd_ops.ssd_final_state(x, dt, A, bm, cm), carried):
        np.testing.assert_allclose(
            hk.cpu().numpy(), want.cpu().numpy(), rtol=0,
            atol=SSD_TOL[dtype] * want.abs().max().item())
    a = torch.cumsum(dt.double() * A.double(), dim=1)
    w = torch.exp(a[:, -1:] - a) * dt.double()
    exact = torch.einsum("bsn,bshp->bhnp", bm.double(),
                         x.double() * w[..., None])
    np.testing.assert_allclose(
        hk.double().cpu().numpy(), exact.cpu().numpy(), rtol=0,
        atol=SSD_STATE_TOL * exact.abs().max().item())


@pytest.mark.gpu
def test_ssd_routes_by_dtype_on_card(cuda):
    """bf16 x, B, C launch the tensor-core kernel, f32 the FFMA kernel;
    a bf16 dt is cast to f32 first, and the cast is counted; each kernel
    refuses the other's type before it launches."""
    x, dt, A, bm, cm = _ssd_inputs(1, 96, 2, 16, 8, "bfloat16", cuda)
    before = _ssd_counts()
    y = ssd_ops.ssd_scan(x, dt, A, bm, cm, chunk=32)
    assert _ssd_counts() == (before[0] + 1, before[1] + 1, before[2],
                             before[3])
    ssd_ops.ssd_scan(x, dt.bfloat16(), A, bm, cm, chunk=32)
    assert _ssd_counts() == (before[0] + 2, before[1] + 2, before[2],
                             before[3] + 1)
    f32 = (x.float(), dt, A, bm.float(), cm.float())
    ssd_ops.ssd_scan(*f32, chunk=32)
    assert _ssd_counts()[2] == before[2] + 1
    want = ssd_chunked_ref(x, dt, A, bm, cm, 32).float()
    tol = SSD_TOL["bfloat16"] * want.abs().max().item()
    assert (y.float() - want).abs().max().item() <= tol
    counts = _ssd_counts()
    with pytest.raises(TypeError, match="f32"):
        ssd_ops._launch(x, dt, A, bm, cm, 32, "ffma")
    with pytest.raises(TypeError, match="bf16"):
        ssd_ops._launch(*f32, 32, "tc")
    assert _ssd_counts() == counts


@pytest.mark.gpu
def test_mamba2_bf16_through_the_tensor_core_kernel_on_card(cuda):
    """mamba2-smoke in bf16 on the card, a 300-token prompt in chunks of
    16: one tensor-core SSD launch per layer in the prefill and none of
    the FFMA kernel, none in decode, no cast; prefill and first decode
    logits within 0.02·(max|logit| + 1) of the same model with the plain
    SSD scan (tests/test_arch_smoke.py's bound)."""
    from repro_torch.configs import get_config
    from repro_torch.models import decode_step, init_params, prefill
    cfg = get_config("mamba2-130m", smoke=True)
    model = init_params(cfg, 0, device=cuda)
    prompts = torch.randint(0, cfg.vocab_size, (2, 300), device=cuda,
                            generator=torch.Generator(cuda).manual_seed(2))
    logits = {}
    for impl in ("auto", "plain"):
        model.ssd_impl = impl
        before = _ssd_counts()
        with torch.inference_mode():
            pre, cache = prefill(cfg, model, {"tokens": prompts}, 301)
            mid = _ssd_counts()
            step, _ = decode_step(cfg, model, cache,
                                  {"token": pre.argmax(-1)})
        n = cfg.n_layers if impl == "auto" else 0
        assert mid == (before[0] + n, before[1] + n, before[2], before[3])
        assert _ssd_counts() == mid
        logits[impl] = (pre, step)
    for got, want in zip(logits["auto"], logits["plain"]):
        assert bool(torch.isfinite(got).all())
        bound = 0.02 * (want.abs().max().item() + 1.0)
        assert (got - want).abs().max().item() <= bound


@pytest.mark.gpu
def test_mamba2_through_the_kernel_on_card(cuda):
    """mamba2-smoke in f32 on the card, a 300-token prompt in chunks of 16
    (the last one short): one SSD launch per layer in the prefill, none in
    decode, logits within 1e-4 of the same model with the plain SSD scan;
    the ``--dense-oracle`` loop runs."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch.serve import dense_generate
    from repro_torch.models import decode_step, init_params, prefill
    cfg = dataclasses.replace(get_config("mamba2-130m", smoke=True),
                              dtype="float32")
    model = init_params(cfg, 0, device=cuda)
    prompts = torch.randint(0, cfg.vocab_size, (2, 300), device=cuda,
                            generator=torch.Generator(cuda).manual_seed(1))
    before = ssd_ops.LAUNCHES
    run = dense_generate(cfg, model, prompts, 3)
    assert ssd_ops.LAUNCHES == before + cfg.n_layers
    with torch.inference_mode():
        _, cache = prefill(cfg, model, {"tokens": prompts}, 303)
        assert ssd_ops.LAUNCHES == before + 2 * cfg.n_layers
        decode_step(cfg, model, cache,
                    {"token": run.prefill_logits.argmax(-1)})
    assert ssd_ops.LAUNCHES == before + 2 * cfg.n_layers
    model.ssd_impl = "plain"
    with torch.inference_mode():
        logits, cache = prefill(cfg, model, {"tokens": prompts}, 303)
        step, _ = decode_step(cfg, model, cache,
                              {"token": run.prefill_logits.argmax(-1)})
    assert ssd_ops.LAUNCHES == before + 2 * cfg.n_layers
    np.testing.assert_allclose(run.prefill_logits.cpu().numpy(),
                               logits.cpu().numpy(), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(run.first_decode_logits.cpu().numpy(),
                               step.cpu().numpy(), rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
def test_unembed_f32_logits_on_card(cuda):
    """``torch.mm(…, out_dtype=float32)`` of the bf16 unembedding gives the
    f32 product of the bf16 values, as the CPU path computes it: the
    logits of one and the same normed input within 1e-5 on both devices,
    over 8 seeded draws.  The two devices' bf16 final norms are compared
    apart: each output within one bf16 rounding (2^-8 of its magnitude) of
    the other's; how many differ is printed (run with ``-s``)."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.models.layers import rmsnorm
    cfg = get_config("mamba2-130m", smoke=True)
    model = init_params(cfg, 0, device=cuda)
    model_cpu = init_params(cfg, 0, device=cuda).to("cpu")
    differ, total = 0, 0
    for seed in range(8):
        r = np.random.default_rng(seed)
        x = torch.tensor(r.standard_normal((2, 5, cfg.d_model)),
                         dtype=torch.float32).bfloat16()
        h_card = rmsnorm(model.final_norm, x.to(cuda), cfg.rms_eps).cpu()
        h_cpu = rmsnorm(model_cpu.final_norm, x, cfg.rms_eps)
        hc, hh = h_card.double(), h_cpu.double()
        assert bool(((hc - hh).abs() <= 2.0 ** -8 * hh.abs()).all())
        differ += int((hc != hh).sum())
        total += hh.numel()
        got = model.logits(h_cpu.to(cuda))
        assert got.dtype == torch.float32
        want = model_cpu.logits(h_cpu)
        np.testing.assert_allclose(got.cpu().numpy(), want.numpy(),
                                   rtol=1e-5, atol=1e-5)
    print(f"[unembed] bf16 final norms differing card vs CPU: {differ} of "
          f"{total}")


@pytest.mark.gpu
def test_unembed_gradients_on_card_match_cpu(cuda):
    """``DenseLM.unembed``'s backward on the card (``_F32Logits``: the f32
    cotangent as three bf16 terms through ``torch.mm(…, out_dtype=f32)``)
    against autograd of the CPU's f32 product, at gemma2-smoke (tied,
    soft-capped) in bf16: the gradients of the normed input and of the
    tied embedding within one bf16 rounding (2^-7 of the element, plus
    1e-6 of the largest) — both devices round the same f32 products."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    cfg = get_config("gemma2-2b", smoke=True)
    r = np.random.default_rng(3)
    h = torch.tensor(r.standard_normal((2, 7, cfg.d_model)),
                     dtype=torch.float32).bfloat16()
    cot = torch.tensor(r.standard_normal((2, 7, cfg.vocab_size)),
                       dtype=torch.float32)
    grads = []
    for dev in (cuda, torch.device("cpu")):
        model = init_params(cfg, 0, device=cuda).to(dev)
        w = model.embed["w"].requires_grad_(True)
        x = h.to(dev).requires_grad_(True)
        logits = model.logits(x)
        grads.append([g.float().cpu() for g in torch.autograd.grad(
            (logits * cot.to(dev)).sum(), (x, w))])
    for got, want in zip(*grads):
        np.testing.assert_allclose(
            got.numpy(), want.numpy(), rtol=2.0 ** -7,
            atol=1e-6 * float(want.abs().max()))


# ------------------------------------------------------- zamba2-7b's shapes
@pytest.mark.gpu
@pytest.mark.parametrize("s", [300, 2048])
def test_flash_kernel_zamba2_head_dim_on_card(cuda, s):
    """zamba2-7b's shared attention: MHA with head dim 112 (padded to 128
    in shared memory; TMA zero-fills columns 112-127), causal, no window,
    no soft-cap, scale 112^-0.5, in bf16 through the tensor-core kernel.
    q, k, v are the model's ``transpose(1, 2)`` views of (B, S, H, 112),
    whose 224-byte rows TMA reads in place: no copy."""
    r = np.random.default_rng(11)
    x = [torch.tensor(r.standard_normal((2, s, 8, 112)), dtype=torch.float32,
                      device=cuda).bfloat16() for _ in range(3)]
    q, k, v = (t.transpose(1, 2) for t in x)
    assert flash_ops.padded_dim(112, 112) == 128
    before = (flash_ops.TC_LAUNCHES, flash_ops.COPIES)
    _flash_check(q, k, v, "bfloat16", causal=True, window=0, softcap=0.0)
    assert (flash_ops.TC_LAUNCHES, flash_ops.COPIES) == (before[0] + 1,
                                                         before[1])
    got = flash_ops.attention(q, k, v)
    assert torch.equal(got, flash_ops.attention(
        q.contiguous(), k.contiguous(), v.contiguous()))
    assert flash_ops.COPIES == before[1]
    # chip_smoke.py's gate: half a bf16 step + GEMMA2_BF16_DELTA of the f64
    # attention, each row's error within ROW_REL_TOL of its norm
    from _torch_helpers import chip_smoke
    smoke = chip_smoke()
    exact = smoke.exact_attention(q, k, v, causal=True, window=0,
                                  softcap=0.0, rows=512)
    errs = smoke.flash_errors(got.float(), attention_ref(q, k, v).float(),
                              torch.bfloat16, exact=exact)
    assert errs["fault"] is None, errs


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,h", [(2, 1001, 5), (1, 257, 6)],
                         ids=["odd-s-odd-heads", "one-past-two-chunks"])
def test_ssd_kernel_zamba2_state_on_card(cuda, b, s, h):
    """zamba2-7b's SSD widths, state N = 64 and heads of 64 (the kernel's
    state rows and B/C columns past N are zero fill), at an odd S with a
    ragged last chunk, in bf16 through the tensor-core kernel with B and C
    the two halves of one (B, S, 128) tensor: y within ``SSD_TOL`` of the
    plain scan, the final state from the same launch within ``SSD_TOL``
    of the plain scan's carried state and ``ssd_final_state``, and within
    ``SSD_STATE_TOL`` of the f64 state."""
    x, dt, A, bm, cm = _ssd_inputs(b, s, h, 64, 64, "bfloat16", cuda,
                                   seed=12)
    bcc = torch.cat([bm, cm], dim=-1)
    bv, cv = bcc[..., :64], bcc[..., 64:]
    _ssd_check(x, dt, A, bv, cv, 128, "bfloat16")
    y, hk = ssd_ops.ssd_scan(x, dt, A, bv, cv, chunk=128,
                             return_final_state=True)
    assert tuple(hk.shape) == (b, h, 64, 64) and hk.dtype == torch.float32
    want, carried = ssd_chunked_ref(x, dt, A, bv, cv, 128, final_state=True)
    tol = SSD_TOL["bfloat16"] * want.float().abs().max().item()
    assert (y.float() - want.float()).abs().max().item() <= tol
    for ref in (carried, ssd_ops.ssd_final_state(x, dt, A, bv, cv)):
        assert (hk - ref).abs().max().item() <= \
            SSD_TOL["bfloat16"] * ref.abs().max().item()
    a = torch.cumsum(dt.double() * A.double(), dim=1)
    w = torch.exp(a[:, -1:] - a) * dt.double()
    exact = torch.einsum("bsn,bshp->bhnp", bv.double(),
                         x.double() * w[..., None])
    assert (hk.double() - exact).abs().max().item() <= \
        SSD_STATE_TOL * exact.abs().max().item()


@pytest.mark.gpu
def test_zamba2_through_both_kernels_on_card(cuda):
    """zamba2-smoke on the card, a 300-token prompt in chunks of 16: one
    flash launch per shared-block application and one SSD launch per
    Mamba2 layer in the prefill, none in decode, no copy or cast.  In f32
    (the FFMA kernels) the prefill and first decode logits lie within
    1e-4 of the same model with both plain versions; in bf16 (the
    tensor-core kernels) within 0.02·(max|logit| + 1) of the plain bf16
    run, or 1.5x the distance between the plain bf16 and f32 runs where
    that lies higher (the model's rounding floor)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch.serve import dense_generate
    from repro_torch.models import decode_step, init_params, prefill
    cfg16 = get_config("zamba2-7b", smoke=True)
    groups = cfg16.n_layers // cfg16.mamba_per_group
    prompts = torch.randint(0, cfg16.vocab_size, (2, 300), device=cuda,
                            generator=torch.Generator(cuda).manual_seed(3))
    model16 = init_params(cfg16, 0, device=cuda)
    logits, tok = {}, None
    for dtype in ("bfloat16", "float32"):
        cfg = dataclasses.replace(cfg16, dtype=dtype)
        model = model16
        if dtype == "float32":
            model = init_params(cfg16, 0, device=cuda).float()
            model.cfg = cfg
        tc = dtype == "bfloat16"
        before = (_ssd_counts(), flash_ops.TC_LAUNCHES,
                  flash_ops.FFMA_LAUNCHES, flash_ops.COPIES)
        run = dense_generate(cfg, model, prompts, 3)
        assert _ssd_counts() == (
            before[0][0] + cfg.n_layers, before[0][1] + tc * cfg.n_layers,
            before[0][2] + (not tc) * cfg.n_layers, before[0][3])
        assert (flash_ops.TC_LAUNCHES, flash_ops.FFMA_LAUNCHES,
                flash_ops.COPIES) == (before[1] + tc * groups,
                                      before[2] + (not tc) * groups,
                                      before[3])
        # every run's first decode step takes the bf16 kernel run's token
        tok = run.prefill_logits.argmax(-1) if tok is None else tok
        for impl in ("auto", "plain"):
            model.attn_impl = model.ssd_impl = impl
            with torch.inference_mode():
                pre, cache = prefill(cfg, model, {"tokens": prompts}, 303)
                step, _ = decode_step(cfg, model, cache, {"token": tok})
            logits[dtype, impl] = (pre, step)
    for got, want in zip(logits["float32", "auto"],
                         logits["float32", "plain"]):
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   rtol=1e-4, atol=1e-4)
    for got, want, want32 in zip(logits["bfloat16", "auto"],
                                 logits["bfloat16", "plain"],
                                 logits["float32", "plain"]):
        assert bool(torch.isfinite(got).all())
        floor = (want - want32).abs().max().item()
        bound = max(0.02 * (want.abs().max().item() + 1.0), 1.5 * floor)
        assert (got - want).abs().max().item() <= bound


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", sorted(SSD_TOL))
def test_ssd_kernels_sum_a_cancelling_diagonal_score_on_card(cuda, dtype):
    """Where a step's decay erases the rest of its chunk, row i of y is
    (C_i·B_i)·dt_i·x_i.  With C_i·B_i = 2^16 + 2^-10 - 2^16, its terms in
    three k-steps of 16 columns, an f32 sum of the products in order (the
    tensor cores' chained accumulator, an f32 FMA chain) loses the 2^-10;
    both kernels give 2^-10·x_i exactly, as the plain version does in f64
    (from f64 inputs)."""
    n, s = 64, 3
    x, dt, _, bm, cm = _ssd_inputs(1, s, 1, 64, n, dtype, cuda, seed=13)
    cm, bm = torch.zeros_like(cm), torch.zeros_like(bm)
    cm[0, 1, [0, 20, 40]] = torch.tensor([256.0, 2.0 ** -5, -256.0],
                                         device=cuda).to(cm.dtype)
    bm[0, 1, [0, 20, 40]] = torch.tensor([256.0, 2.0 ** -5, 256.0],
                                         device=cuda).to(bm.dtype)
    dt = torch.ones_like(dt)
    A = torch.tensor([-1000.0], device=cuda)             # exp(-1000) = 0
    got = ssd_ops.ssd_scan(x, dt, A, bm, cm, chunk=s, impl="kernel")
    want = x[0, 1, 0] * 2.0 ** -10
    assert torch.equal(got[0, 1, 0], want)
    exact = ssd_chunked_ref(*(t.double() for t in (x, dt, A, bm, cm)), s)
    assert torch.equal(exact[0, 1, 0].to(x.dtype), want)


# ------------------------------------------------- the FFNN train step
# N 256, D 64, H 128, L 10; db and hb above 2, so that the optimizer fuses
# both forward products (at 2 the unfused pair ties on its temporaries)
TRAIN_DIMS = (4, 4, 4, 1, 64, 16, 32, 10)


def _train_setup(cuda, optimizer):
    from repro_torch.core import Engine, TraTrainer, from_tensor
    from repro_torch.core.programs import ffnn_train_step_tra
    nb, db, hb, lb, bn, bd, bh, bl = TRAIN_DIMS
    n, d, h, l_ = nb * bn, db * bd, hb * bh, lb * bl
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn((n, d), generator=g, device=cuda)
    y = torch.sigmoid(x @ (torch.randn((d, l_), generator=g, device=cuda)
                           * 0.5))
    w1 = torch.randn((d, h), generator=g, device=cuda) * d ** -0.5
    w2 = torch.randn((h, l_), generator=g, device=cuda) * h ** -0.5
    data = {"X": from_tensor(x, (bn, bd)), "Y": from_tensor(y, (bn, bl))}
    params = {"W1": from_tensor(w1, (bd, bh)),
              "W2": from_tensor(w2, (bh, bl))}
    return TraTrainer(Engine(executor="jit", device=cuda),
                      ffnn_train_step_tra(*TRAIN_DIMS, optimizer=optimizer),
                      params=params), data


@pytest.mark.gpu
@pytest.mark.parametrize("optimizer", ["sgd", "adamw"])
def test_ffnn_train_step_on_card(cuda, optimizer, monkeypatch):
    """Three steps of the §5.3 train step through the hand kernels (X·W1
    on the tensor-core route, two split passes and one tensor-core launch;
    a1·W2, 10 columns wide, on the narrow kernel, one launch) against the
    same steps with the matmul op's plain version on the card, at 1e-4."""
    from repro_torch.core import SGD, AdamW
    make = {"sgd": lambda: SGD(0.01), "adamw": lambda: AdamW(1e-2)}
    nb, db, hb, lb, bn, bd, bh, bl = TRAIN_DIMS
    n, d, h, l_ = nb * bn, db * bd, hb * bh, lb * bl
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert ops.route(torch.empty(n, h, device="meta"),
                     torch.empty(h, l_, device="meta"), "kernel") == "narrow"
    trainer, data = _train_setup(cuda, make[optimizer]())
    before, tc_before, nw_before = _counts(), _tc_counts(), _narrow_counts()
    losses = trainer.fit(3, **data)
    torch.cuda.synchronize()
    skinny, tile, reduces, _, copies = (x - y for x, y in
                                        zip(_counts(), before))
    tc, passes = (x - y for x, y in zip(_tc_counts(), tc_before))
    narrow, _ = (x - y for x, y in zip(_narrow_counts(), nw_before))
    assert (skinny, tile, reduces, tc, passes, narrow) == (
        0, 0, 0, 3, 2 * 3, 3)
    assert copies == 0                  # X, W1, a1 and W2 are read in place
    assert trainer.engine.cache_hits == 2
    real = ops.matmul
    monkeypatch.setattr(ops, "matmul", lambda a, b, **kw: real(
        a, b, **{**kw, "impl": "plain"}))
    plain, data = _train_setup(cuda, make[optimizer]())
    before = _counts(), _tc_counts(), _narrow_counts()
    want = plain.fit(3, **data)
    assert (_counts(), _tc_counts(), _narrow_counts()) == before
    np.testing.assert_allclose(losses, want, rtol=1e-4, atol=1e-4)
    for k in trainer.params:
        np.testing.assert_allclose(trainer.params[k].data.cpu().numpy(),
                                   plain.params[k].data.cpu().numpy(),
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("rows", [2000, 10000])
def test_tile_kernel_at_the_train_second_product_on_card(cuda, rows):
    """The train path's second forward product scaled down in K, a1·W2
    with 10 columns, on the tile kernel (the route it took before the
    narrow kernel): a1 handed over as the engine's blocked view (nb, bn |
    hb, bh), which the tile kernel copies, the tile kernel split in K and
    the split-K pass summing the partials, against the plain version."""
    nb, hb, bh, n = 10, 5, 2000, 10
    bn = rows // nb
    r = np.random.default_rng(5)
    a1 = torch.tensor(r.standard_normal((nb, bn, hb, bh)),
                      dtype=torch.float32, device=cuda).clamp_min(0.0)
    a_view = a1.permute(0, 2, 1, 3).contiguous().permute(0, 2, 1, 3)
    w2 = torch.tensor(r.standard_normal((hb * bh, n)), dtype=torch.float32,
                      device=cuda) * (hb * bh) ** -0.5
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    splits = ops.plan_launch(rows, n, hb * bh, sms)[1]
    assert splits > 1
    before, tc_before = _counts(), _tc_counts()
    got = ops._launch_tile(a_view, w2, rows, hb * bh, n, torch.float32)
    torch.cuda.synchronize()
    skinny, tile, reduces, _, copies = (x - y for x, y in zip(_counts(),
                                                              before))
    assert (skinny, tile, reduces, copies) == (0, 1, 1, 1)
    assert _tc_counts() == tc_before        # 10 columns: not the tc route
    want = matmul_ref(a1.reshape(rows, -1), w2)
    k = hb * bh
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=1e-5, atol=1e-5 * k ** 0.5)


def _all_counts():
    return (_counts(), _tc_counts(), _narrow_counts(), flash_ops.LAUNCHES,
            ssd_ops.LAUNCHES)


def _lm_on_card(cuda, **engine_kw):
    from repro_torch.core import Engine
    from repro_torch.serve import RecurrentLM
    lm = RecurrentLM(d_model=256, vocab_size=4096, capacity=4, seed=3,
                     device=cuda)
    eng = Engine(executor="jit", device=cuda, **engine_kw)
    return lm, eng.compile(lm.step_program())


@pytest.mark.gpu
def test_recurrent_lm_step_on_card(cuda):
    """One ``RecurrentLM`` step program on the card (three live slots of
    four, a non-zero state) against its plain oracle step per slot, f32 at
    1e-5; the free slot's row kept bit-exactly; the plan runs no
    hand-written kernel (JAX's unfused plan: cuBLAS products)."""
    lm, compiled = _lm_on_card(cuda)
    tokens = [7, None, 4095, 0]
    r = np.random.default_rng(9)
    state = torch.tensor(r.standard_normal((4, 1, 1, 256)) * 0.1,
                         dtype=torch.float32, device=cuda)
    before = _all_counts()
    outs = compiled.run(**lm.step_inputs(tokens), **lm.weights(),
                        **{"lm.state": state})
    torch.cuda.synchronize()
    assert _all_counts() == before
    got_state = outs["state"].data.reshape(4, 256)
    got_logits = outs["logits"].data.reshape(4, 4096)
    for i, tok in enumerate(tokens):
        if tok is None:
            assert torch.equal(got_state[i], state.reshape(4, 256)[i])
            continue
        h, logits = lm.oracle_step(state.reshape(4, 256)[i:i + 1], tok)
        np.testing.assert_allclose(got_state[i].cpu().numpy(),
                                   h[0].cpu().numpy(), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got_logits[i].cpu().numpy(), logits,
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
def test_injected_nan_named_on_card_weights_unchanged(cuda):
    """A NaN injected into the step's relu on the card: ``check_numerics``
    names that node (the jit re-run replays the dispatch's NaN), the
    weights and the input state are unchanged, and the next dispatch is
    finite and equal to an unfaulted one."""
    from repro_torch.core.faults import FaultInjector
    from repro_torch.core.guards import NumericsError
    inj = FaultInjector().inject_nan(node="relu", times=1)
    lm, compiled = _lm_on_card(cuda, fault_injector=inj,
                               check_numerics=True)
    weights = {k: r.data.clone() for k, r in lm.weights().items()}
    state = lm.init_state()
    inputs = {**lm.step_inputs([1, 2, None, 3]), **lm.weights(),
              "lm.state": state}
    with pytest.raises(NumericsError) as ei:
        compiled.run(**inputs)
    assert "relu" in ei.value.node_label
    assert inj.log == [("nan", ei.value.node_label)]
    for k, w in weights.items():
        assert torch.equal(lm.weights()[k].data, w)
    assert torch.equal(state.data, torch.zeros_like(state.data))
    outs = compiled.run(**inputs)
    _, clean = _lm_on_card(cuda)
    want = clean.run(**inputs)
    for name in ("state", "logits"):
        assert bool(torch.isfinite(outs[name].data).all())
        assert torch.equal(outs[name].data, want[name].data)


# ------------------------------------------------------------ out-of-core
OOC_DIMS = (4, 3, 8, 1, 64, 64, 64, 10)   # N 256, D 192, H 512, L 10


def _ooc_problem(device):
    """The §5.3 forward's z2 at small width: the expression and the dense
    X, W1, W2 on the card."""
    from repro_torch.core import programs
    nb, db, hb, lb, bn, bd, bh, bl = OOC_DIMS
    g = torch.Generator(device=device).manual_seed(0)
    x = torch.randn(nb * bn, db * bd, generator=g, device=device)
    w1 = torch.randn(db * bd, hb * bh, generator=g, device=device) * 0.1
    w2 = torch.randn(hb * bh, lb * bl, generator=g, device=device) * 0.1
    z2 = programs._ffnn_forward(*OOC_DIMS)[5]
    return z2, {"X": x, "W1": w1, "W2": w2}


def _ooc_rel(dense, name):
    from repro_torch.core import from_tensor
    nb, db, hb, lb, bn, bd, bh, bl = OOC_DIMS
    tiles = {"X": (bn, bd), "W1": (bd, bh), "W2": (bh, bl)}
    return from_tensor(dense[name], tiles[name])


@pytest.mark.gpu
def test_store_blocks_are_page_locked_on_card(cuda, tmp_path):
    """With a card every block is page-locked at admit, a spilled block
    reloads page-locked, and a relation materializes on the card equal to
    its host data."""
    from repro_torch.store import RelationStore
    _, dense = _ooc_problem(cuda)
    w1 = _ooc_rel(dense, "W1")
    blk = w1.data.numel() * 4 // 8              # one key of dim 1 a block
    store = RelationStore(ram_limit_bytes=4 * blk, block_bytes=blk,
                          spill_dir=str(tmp_path))
    hr = store.put("W1", w1, split_dim=1)
    assert store.pin_memory and store.spill_events > 0
    assert all(b.data.is_pinned() for b in hr._blocks if b.data is not None)
    host = hr.to_tensor()                       # faults spilled blocks in
    assert store.unspill_events > 0
    assert all(b.data.is_pinned() for b in hr._blocks if b.data is not None)
    assert torch.equal(host, w1.data.cpu())
    assert torch.equal(hr.to_relation(cuda).data, w1.data)


@pytest.mark.gpu
@pytest.mark.parametrize("mode,budget,chunks,narrow_", [
    ("stream-reduce", 500 * 1024, 8, 0), ("stream-out", 1200 * 1024, 2, 2)])
def test_streamed_ffnn_forward_on_card(cuda, mode, budget, chunks,
                                       narrow_):
    """z2 streamed from page-locked host blocks (W1 and W2 under 500 KiB,
    X under 1200 KiB) through the hand kernels, against the resident run
    on the card and the f64 product.  X·W1 takes the tensor-core route
    once a chunk; a1·W2 the narrow kernel once a chunk in stream-out, and
    none in stream-reduce, where a chunk holds one hidden block: with a
    joined key dim of size 1 the optimizer keeps the join unfused (its
    plans tie), which runs ``torch.matmul``.  Copy times from events, the
    hidden share within [0, 1]; a second run is a cache hit."""
    from repro_torch.core import Engine
    from repro_torch.store import RelationStore
    z2, dense = _ooc_problem(cuda)
    rels = {k: _ooc_rel(dense, k) for k in dense}
    resident = Engine(executor="jit", device=cuda).run(z2, **rels)
    split = {"X": 0, "W1": 1, "W2": 0}
    host = ("W1", "W2") if mode == "stream-reduce" else ("X",)
    store = RelationStore()
    eng = Engine(executor="jit", device=cuda, memory_budget=budget,
                 store=store)
    inputs = {k: store.put(k, v, split_dim=split[k]) if k in host else v
              for k, v in rels.items()}
    assert all(b.data.is_pinned() for k in host
               for b in inputs[k]._blocks)
    before = _counts(), _tc_counts(), _narrow_counts()
    got = eng.run(z2, **inputs)
    torch.cuda.synchronize()
    (skinny, tile, reduces, _, copies), (tc, passes), (narrow, _) = (
        tuple(x - y for x, y in zip(now, was)) for now, was in zip(
            (_counts(), _tc_counts(), _narrow_counts()), before))
    assert (skinny, tile, reduces, tc, passes, narrow) == (
        0, 0, 0, chunks, 2 * chunks, narrow_)
    (stats,) = [c.stream_stats for c in eng.cache_info() if c.stream_stats]
    assert (stats.mode, stats.chunks, stats.runs) == (mode, chunks, 1)
    assert stats.h2d_bytes == sum(dense[k].numel() * 4 for k in host)
    assert 0 < stats.peak_device_bytes <= budget
    assert stats.copy_s > 0 and 0 <= stats.overlap_efficiency <= 1
    exact = torch.relu(dense["X"].double() @ dense["W1"].double()) \
        @ dense["W2"].double()
    assert copies == 0
    want = exact.reshape(4, 64, 1, 10).permute(0, 2, 1, 3)
    np.testing.assert_allclose(got.data.cpu().numpy(),
                               resident.data.cpu().numpy(),
                               rtol=1e-5, atol=1e-5 * math.sqrt(512))
    np.testing.assert_allclose(got.data.double().cpu().numpy(),
                               want.cpu().numpy(), rtol=1e-5,
                               atol=1e-5 * math.sqrt(512))
    hits = eng.cache_hits
    eng.run(z2, **inputs)
    assert eng.cache_hits > hits and stats.runs == 2


@pytest.mark.gpu
def test_checkpoint_round_trip_through_page_locked_buffers_on_card(
        cuda, tmp_path):
    """``save_async`` copies card tensors into page-locked host buffers
    before it returns (the source may change at once) and reuses them at
    the next save; ``restore`` then puts the leaves back on the card
    bit-equal."""
    from repro_torch.checkpoint import CheckpointStore
    gen = torch.Generator(device=cuda).manual_seed(0)
    tree = {"params": {"W1": torch.randn(64, 3000, generator=gen,
                                         device=cuda)},
            "state": {"opt.step": torch.ones(1, 1, 1, device=cuda)}}
    want = {k: {n: t.clone() for n, t in v.items()} for k, v in
            tree.items()}
    store = CheckpointStore(str(tmp_path))
    store.save_async(1, tree)
    tree["params"]["W1"].add_(1.0)          # the snapshot is already taken
    buffers = list(store._buffers)
    assert all(b.is_pinned() for b in buffers)
    store.save_async(2, want)
    assert [id(b) for b in store._buffers] == [id(b) for b in buffers]
    store.wait()
    for step in (1, 2):
        got, _ = store.restore(want, step)
        for k, v in want.items():
            for n, t in v.items():
                assert torch.equal(torch.from_numpy(got[k][n]).to(cuda), t)


def _cpmm_on_card(rank, world):
    """One rank's CPMM product on the ``shard_map`` executor over CUDA
    tensors."""
    from repro_torch.core import (Engine, Placement, from_tensor,
                                  input as tra_input, to_tensor)
    from repro_torch.launch.mesh import make_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", torch.cuda.current_device())
    gen = torch.Generator().manual_seed(0)
    a = torch.randn(32, 64, generator=gen).to(dev)
    b = torch.randn(64, 32, generator=gen).to(dev)
    s = ("sites",)
    eng = Engine(make_mesh((world,), s), executor="shard_map",
                 input_placements={"A": Placement.partitioned((1,), s),
                                   "B": Placement.partitioned((0,), s)})
    expr = tra_input("A", (8, 8), (4, 8)) @ tra_input("B", (8, 8), (8, 4))
    compiled = eng.compile(expr)
    env = {"A": from_tensor(a, (4, 8)), "B": from_tensor(b, (8, 4))}
    out = {"C": to_tensor(compiled.run(**env)).cpu().numpy(),
           "want": (a.cpu() @ b.cpu()).numpy(),
           "schedule": [o.describe() for o in compiled.exchange.schedule()],
           "device": str(compiled.run(**env).data.to_local().device)}
    return out


@pytest.mark.gpu
def test_cpmm_shard_map_on_two_gloo_ranks_sharing_the_card(cuda):
    """Two ranks share ``cuda:0`` over gloo (NCCL refuses two ranks on one
    card): the CPMM plan's reduce-scatter moves CUDA tensors between them,
    and the product equals the one-rank run and the plain one."""
    from repro_torch.launch.mesh import run_sites
    two = run_sites(_cpmm_on_card, 2, backend="gloo", device="cuda",
                    timeout=300)
    (one,) = run_sites(_cpmm_on_card, 1, backend="gloo", device="cuda",
                       timeout=300)
    for got in two:
        assert got["device"].startswith("cuda")
        assert got["schedule"] == one["schedule"] and got["schedule"]
        np.testing.assert_allclose(got["C"], one["C"], rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(got["C"], got["want"], rtol=2e-4,
                                   atol=2e-4)


# ------------------------------------------------- flash attention backward
BWD_ROW_TOL = {"float32": 1e-4, "bfloat16": 1e-2}


def _single_key_rows(sq, skv, causal, window):
    """The query rows that see at most one key (row i at key position
    i + skv - sq): their dq is 0 exactly, a softmax over one element
    having no derivative."""
    pos = np.arange(sq) + (skv - sq)
    hi = np.minimum(skv - 1, pos) if causal else np.full(sq, skv - 1)
    lo = np.maximum(0, pos - window + 1) if window > 0 else np.zeros(sq)
    return hi - lo + 1 <= 1


def _bwd_counts():
    """(dQ launches, of them the tensor-core kernel's, the FFMA kernel's,
    dK/dV launches)."""
    return (flash_ops.BWD_DQ_LAUNCHES, flash_ops.BWD_DQ_TC_LAUNCHES,
            flash_ops.BWD_DQ_FFMA_LAUNCHES, flash_ops.BWD_DKDV_LAUNCHES)


def _bwd_check(q, k, v, dtype, seed=1, **kw):
    """The two backward kernels against ``attention_bwd_ref`` (autograd
    through ``attention_ref``) for an output gradient drawn from ``seed``:
    each of dq, dk, dv elementwise within the forward's limits
    (``FLASH_TOL``: f32 2e-4, bf16 3e-2) and each row within
    ``BWD_ROW_TOL`` (the forward's row limit: f32 1e-4, bf16 1e-2) of its
    norm — but the dq rows of queries that see one key, whose exact
    gradient is 0 and which both sides fill with rounding noise: those are
    held elementwise only; one launch of each kernel, the dQ kernel the
    one ``bwd_route`` names (bf16 up to 128 padded columns the tensor-core
    kernel, else the FFMA one) and none of the other."""
    r = np.random.default_rng(seed)
    shape = (*q.shape[:3], v.shape[3])
    do = torch.tensor(r.standard_normal(shape),
                      dtype=torch.float32).to(q.device, q.dtype)
    tc = flash_ops.bwd_route(q, k, v) == "tc"
    before = _bwd_counts()
    got = flash_ops.attention_bwd(q, k, v, do, impl="kernel", **kw)
    want = attention_bwd_ref(q, k, v, do, **kw)
    torch.cuda.synchronize()
    assert _bwd_counts() == (before[0] + 1, before[1] + int(tc),
                             before[2] + int(not tc), before[3] + 1)
    tol = FLASH_TOL[dtype]
    keep = torch.from_numpy(~_single_key_rows(
        q.shape[2], k.shape[2], kw["causal"], kw["window"])).to(q.device)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == q.dtype and g.shape == w.shape, name
        g, w = g.float(), w.float()
        np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(),
                                   rtol=tol, atol=tol, err_msg=name)
        row = (g - w).norm(dim=-1) / w.norm(dim=-1).clamp_min(1e-30)
        row = (row[..., keep] if name == "dq" else row).max()
        assert float(row) <= BWD_ROW_TOL[dtype], (name, float(row))
    return got


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", sorted(FLASH_TOL))
@pytest.mark.parametrize("hq,hkv", [(4, 4), (8, 2)])
@pytest.mark.parametrize("causal,window,softcap", [
    (True, 0, 0.0), (True, 64, 0.0), (True, 0, 30.0), (False, 0, 0.0)])
def test_flash_backward_matches_plain_on_card(cuda, dtype, hq, hkv, causal,
                                              window, softcap):
    q, k, v = _qkv(2, hq, hkv, 256, 256, 64, 64, dtype, cuda)
    _bwd_check(q, k, v, dtype, causal=causal, window=window,
               softcap=softcap)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", sorted(FLASH_TOL))
@pytest.mark.parametrize("b,hq,hkv,sq,skv,d,dv,kw", [
    (2, 4, 2, 200, 200, 64, 64, dict(causal=True, window=0, softcap=0.0)),
    (1, 2, 1, 1000, 1000, 64, 64, dict(causal=True, window=100,
                                       softcap=30.0)),
    (2, 4, 4, 100, 300, 64, 64, dict(causal=True, window=0, softcap=0.0)),
    (2, 4, 2, 77, 77, 64, 40, dict(causal=True, window=0, softcap=0.0)),
    (2, 2, 2, 70, 70, 112, 112, dict(causal=True, window=0, softcap=0.0)),
    # gemma2-2b's train shapes: window and global layers, soft-cap 50
    (8, 8, 4, 128, 128, 256, 256, dict(causal=True, window=4096,
                                       softcap=50.0)),
    (8, 8, 4, 128, 128, 256, 256, dict(causal=True, window=0, softcap=50.0)),
    (1, 8, 4, 2048, 2048, 256, 256, dict(causal=True, window=1024,
                                         softcap=50.0))])
def test_flash_backward_shapes_on_card(cuda, dtype, b, hq, hkv, sq, skv, d,
                                       dv, kw):
    """Ragged lengths, ``sq < skv``, ``dv != d``, head dim 112, GQA and
    gemma2-2b's train shapes (B 8, S 128; B 1, S 2048 with a window of
    1024)."""
    q, k, v = _qkv(b, hq, hkv, sq, skv, d, dv, dtype, cuda)
    _bwd_check(q, k, v, dtype, **kw)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", sorted(FLASH_TOL))
def test_flash_autograd_on_card_runs_the_backward_kernels(cuda, dtype):
    """``attention`` on CUDA inputs that require grad returns an output with
    a ``grad_fn``; its backward launches each backward kernel once, no
    plain version, and gives ``attention_bwd``'s gradients; two backward
    runs are bit-equal (no atomics).  The model's transposed views go in
    as they are."""
    x = [torch.tensor(np.random.default_rng(i).standard_normal(
        (2, 96, h, 64)), dtype=torch.float32).to(cuda, getattr(torch, dtype))
        for i, h in enumerate((8, 4, 4))]
    q, k, v = (t.transpose(1, 2).requires_grad_(True) for t in x)
    kw = dict(causal=True, window=32, softcap=20.0)
    before = (flash_ops.BWD_DQ_LAUNCHES, flash_ops.BWD_DKDV_LAUNCHES)
    o = flash_ops.attention(q, k, v, **kw)
    assert o.grad_fn is not None
    do = torch.ones_like(o) / 7
    g1 = torch.autograd.grad(o, (q, k, v), do)
    g2 = torch.autograd.grad(flash_ops.attention(q, k, v, **kw), (q, k, v),
                             do)
    torch.cuda.synchronize()
    assert (flash_ops.BWD_DQ_LAUNCHES, flash_ops.BWD_DKDV_LAUNCHES) == (
        before[0] + 2, before[1] + 2)
    want = flash_ops.attention_bwd(q.detach(), k.detach(), v.detach(), do,
                                   **kw)
    for a, b, w in zip(g1, g2, want):
        assert torch.equal(a, b) and torch.equal(a, w)
    with torch.no_grad():
        assert flash_ops.attention(q, k, v, **kw).grad_fn is None


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,d,tc", [("bfloat16", 64, True),
                                        ("bfloat16", 112, True),
                                        ("bfloat16", 256, False),
                                        ("float32", 64, False),
                                        ("float32", 112, False)])
def test_flash_backward_dq_route_on_card(cuda, dtype, d, tc):
    """bf16 at head dims 64 and 112 launches the tensor-core dQ kernel,
    bf16 at 256 and f32 the FFMA one; either within the limits."""
    q, k, v = _qkv(1, 4, 2, 160, 160, d, d, dtype, cuda)
    before = _bwd_counts()
    _bwd_check(q, k, v, dtype, causal=True, window=0, softcap=0.0)
    moved = tuple(a - b for a, b in zip(_bwd_counts(), before))
    assert moved == (1, int(tc), int(not tc), 1)


@pytest.mark.gpu
def test_flash_backward_zamba2_train_layer_on_card(cuda):
    """zamba2-7b's shared attention at its train shape (B 4, 32 heads of
    112, S 1024, causal) on the tensor-core dQ kernel."""
    q, k, v = _qkv(4, 32, 32, 1024, 1024, 112, 112, "bfloat16", cuda)
    _bwd_check(q, k, v, "bfloat16", causal=True, window=0, softcap=0.0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,b,hq,hkv,sq,skv,d,dv,kw", [
    ("bfloat16", 2, 4, 2, 200, 200, 64, 64, dict(causal=True, window=0,
                                                 softcap=0.0)),
    ("bfloat16", 1, 4, 4, 300, 300, 112, 112, dict(causal=True, window=100,
                                                   softcap=30.0)),
    ("bfloat16", 2, 4, 4, 300, 100, 64, 40, dict(causal=True, window=0,
                                                 softcap=0.0)),
    ("bfloat16", 2, 4, 4, 96, 96, 64, 64, dict(causal=False, window=0,
                                               softcap=0.0)),
    ("bfloat16", 2, 8, 4, 128, 128, 256, 256, dict(causal=True, window=0,
                                                   softcap=50.0)),
    ("float32", 2, 4, 2, 200, 200, 64, 64, dict(causal=True, window=32,
                                                softcap=20.0))])
def test_flash_backward_dq_statistics_match_plain_on_card(cuda, dtype, b, hq,
                                                          hkv, sq, skv, d,
                                                          dv, kw):
    """The routed dQ kernel's LSE and D against ``attention_bwd_stats_ref``
    within the f32 limits (``chip_smoke.bwd_stats_errors``), LSE +inf for
    the rows with no key (Sq > Skv, causal)."""
    from _torch_helpers import chip_smoke
    q, k, v = _qkv(b, hq, hkv, sq, skv, d, dv, dtype, cuda)
    do = _qkv(b, hq, hkv, sq, skv, dv, dv, dtype, cuda, seed=2)[0]
    routed = flash_ops.bwd_route(q, k, v)
    errs = chip_smoke().bwd_stats_errors(q, k, v, do, kw, routed)
    torch.cuda.synchronize()
    assert errs["fault"] is None, errs


@pytest.mark.gpu
def test_flash_backward_tc_dq_is_bit_equal_and_reads_model_views(cuda):
    """The model's transposed views of q, k, v and dO go to the
    tensor-core dQ kernel as they are (no copy), and two runs give the
    same bits (no atomics)."""
    b, h, s, d = 2, 8, 300, 112
    q, k, v, do = (torch.randn(b, s, h * d, device=cuda).to(torch.bfloat16)
                   .view(b, s, h, d).transpose(1, 2) for _ in range(4))
    kw = dict(causal=True, window=0, softcap=0.0)
    before = (flash_ops.COPIES, flash_ops.BWD_DQ_TC_LAUNCHES)
    one = flash_ops.attention_bwd(q, k, v, do, impl="kernel", **kw)
    two = flash_ops.attention_bwd(q, k, v, do, impl="kernel", **kw)
    torch.cuda.synchronize()
    assert (flash_ops.COPIES, flash_ops.BWD_DQ_TC_LAUNCHES) == (
        before[0], before[1] + 2)
    for a, c in zip(one, two):
        assert torch.equal(a, c)
    want = attention_bwd_ref(q, k, v, do, **kw)[0].float()
    row = (one[0].float() - want).norm(dim=-1) / want.norm(dim=-1)
    assert float(row[:, :, 1:].max()) <= BWD_ROW_TOL["bfloat16"]


def _ssd_bwd_counts():
    return (ssd_ops.BWD_STATE_LAUNCHES, ssd_ops.BWD_DSTATE_LAUNCHES,
            ssd_ops.BWD_CHUNK_LAUNCHES, ssd_ops.BWD_REDUCE_LAUNCHES,
            ssd_ops.BWD_LAUNCHES)


def _ssd_route_counts():
    """Launches of each route's kernels: (tensor-core state, dstate, chunk
    kernel, FFMA state, dstate, chunk kernel)."""
    return (ssd_ops.BWD_STATE_TC_LAUNCHES, ssd_ops.BWD_DSTATE_TC_LAUNCHES,
            ssd_ops.BWD_CHUNK_TC_LAUNCHES, ssd_ops.BWD_STATE_FFMA_LAUNCHES,
            ssd_ops.BWD_DSTATE_FFMA_LAUNCHES, ssd_ops.BWD_CHUNK_FFMA_LAUNCHES)


def _ssd_route_step(dtype, calls=1):
    """The route counts ``calls`` backward calls of ``dtype`` add: bf16 to
    the tensor-core state passes and chunk kernel, f32 to the FFMA ones."""
    tc = dtype in ("bfloat16", torch.bfloat16)
    return (calls,) * 3 + (0,) * 3 if tc else (0,) * 3 + (calls,) * 3


def _ssd_dy(x, seed):
    r = np.random.default_rng(seed)
    return torch.tensor(r.standard_normal(tuple(x.shape)),
                        dtype=torch.float32).to(x.device, x.dtype)


def _ssd_bwd_check(x, dt, A, bm, cm, dy, chunk, dtype):
    """The four backward kernels against the plain backward computed in f64
    (``ssd_scan_bwd_ref``), each gradient within ``chip_smoke.py``'s
    limits (``ssd_bwd_errors``: ``SSD_TOL`` of its largest |value|, each
    row within ``SSD_ROW_TOL`` of its norm); one launch of each kernel,
    the state passes and the chunk kernel the type's (bf16 the
    tensor-core ones, f32 the FFMA ones) and the other route's none; a
    second call bit-equal (no atomics)."""
    from _torch_helpers import chip_smoke
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_bwd_ref
    before, routes = _ssd_bwd_counts(), _ssd_route_counts()
    got = ssd_ops.ssd_scan_bwd(x, dt, A, bm, cm, dy, chunk=chunk,
                               impl="kernel")
    assert _ssd_bwd_counts() == tuple(c + 1 for c in before[:4]) + (
        before[4] + 4,)
    assert _ssd_route_counts() == tuple(
        c + d for c, d in zip(routes, _ssd_route_step(dtype)))
    again = ssd_ops.ssd_scan_bwd(x, dt, A, bm, cm, dy, chunk=chunk,
                                 impl="kernel")
    want = ssd_scan_bwd_ref(*(t.double() for t in (x, dt, A, bm, cm, dy)),
                            min(chunk, x.shape[1]))
    torch.cuda.synchronize()
    for name, g, g2, w, t in zip(("x", "dt", "A", "B", "C"), got, again,
                                 want, (x, dt, A, bm, cm)):
        assert g.dtype == t.dtype and g.shape == t.shape, name
        assert torch.equal(g, g2), name
        errs = chip_smoke().ssd_bwd_errors(g.float(), w,
                                           getattr(torch, dtype), name)
        assert errs["fault"] is None, errs
    return got


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", sorted(SSD_TOL))
@pytest.mark.parametrize("b,s,h,p,n,chunk", [
    (2, 64, 4, 16, 8, 16), (2, 128, 4, 16, 8, 32), (2, 96, 4, 16, 8, 32),
    (1, 64, 2, 16, 8, 32), (1, 128, 2, 16, 8, 64),
    (2, 200, 4, 16, 8, 128), (2, 40, 3, 16, 8, 128), (1, 77, 2, 22, 13, 16),
    (2, 300, 4, 64, 128, 256), (1, 300, 24, 64, 128, 128),
    (1, 260, 112, 64, 64, 128)],
    ids=["jax-64/16", "jax-128/32", "jax-96/32", "pallas-64/32",
         "pallas-128/64", "ragged200/128", "s<chunk", "ragged-odd-dims",
         "default-chunk-256", "mamba2-layer-s300", "zamba2-layer-s260"])
def test_ssd_backward_matches_plain_on_card(cuda, dtype, b, s, h, p, n,
                                            chunk):
    """The JAX kernel tests' cases (``tests/test_kernels.py:107-139``), a
    ragged S (200 at chunk 128), S < chunk, N and P off the tiles, the
    default chunk 256 (run at 128), and mamba2-130m's and zamba2-7b's
    layer dims at a short S; B and C read in place as slices of one
    tensor where the model hands them over so."""
    x, dt, A, bm, cm = _ssd_inputs(b, s, h, p, n, dtype, cuda, seed=20)
    bc = torch.cat([bm, cm], dim=-1)              # the model's layout
    _ssd_bwd_check(x, dt, A, bc[..., :n], bc[..., n:], _ssd_dy(x, 21), chunk,
                   dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", sorted(SSD_TOL))
def test_ssd_backward_reads_strided_inputs_on_card(cuda, dtype):
    """B and C as slices of one (B, S, 2N) tensor, x and dy as transposed
    views: the same gradients, bit for bit, as from contiguous copies."""
    x, dt, A, bm, cm = _ssd_inputs(2, 260, 4, 64, 128, dtype, cuda, seed=22)
    bc = torch.cat([bm, cm], dim=-1)
    bv, cv = bc[..., :128], bc[..., 128:]
    xt = x.transpose(0, 1).contiguous().transpose(0, 1)
    dy = _ssd_dy(x, 23)
    dyt = dy.transpose(2, 3).contiguous().transpose(2, 3)
    got = _ssd_bwd_check(xt, dt, A, bv, cv, dyt, 128, dtype)
    want = ssd_ops.ssd_scan_bwd(x, dt, A, bv.contiguous(), cv.contiguous(),
                                dy, chunk=128, impl="kernel")
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", sorted(SSD_TOL))
def test_ssd_backward_strong_decay_on_card(cuda, dtype):
    """dt·A between -22 and -20 every step: a row of each gradient is its
    diagonal term, and dA the tiny rest of da (the kernels leave its
    cancelling diagonal out)."""
    x, dt, A, bm, cm = _ssd_inputs(2, 256, 4, 64, 128, dtype, cuda, seed=24)
    r = np.random.default_rng(25)
    dt = torch.tensor(1.0 + 0.1 * r.random(tuple(dt.shape)),
                      dtype=torch.float32, device=cuda)
    A = torch.full_like(A, -20.0)
    _ssd_bwd_check(x, dt, A, bm, cm, _ssd_dy(x, 26), 128, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", sorted(SSD_TOL))
def test_ssd_autograd_on_card_runs_the_backward_kernels(cuda, dtype):
    """``ssd_scan`` on CUDA inputs that require grad returns an output with
    a ``grad_fn`` and the forward kernel's numbers; its backward launches
    each backward kernel once and gives ``ssd_scan_bwd``'s gradients, bit
    for bit, twice over; a bf16 dt gets its gradient in bf16 through the
    counted cast; with ``return_final_state`` the state is
    ``ssd_final_state``'s; without grad, no ``grad_fn``."""
    x, dt, A, bm, cm = _ssd_inputs(2, 160, 4, 32, 16, dtype, cuda, seed=27)
    dt16 = dt.bfloat16()
    leaves = [t.clone().requires_grad_(True) for t in (x, dt16, A, bm, cm)]
    dy = _ssd_dy(x, 28)
    before, copies = _ssd_bwd_counts(), ssd_ops.COPIES
    routes = _ssd_route_counts()
    y = ssd_ops.ssd_scan(*leaves, chunk=64)
    assert type(y.grad_fn).__name__ == "_SSDScanBackward"
    assert ssd_ops.COPIES == copies + 1
    with torch.no_grad():
        assert torch.equal(y, ssd_ops.ssd_scan(*leaves, chunk=64))
    g1 = torch.autograd.grad(y, leaves, dy)
    g2 = torch.autograd.grad(ssd_ops.ssd_scan(*leaves, chunk=64), leaves, dy)
    torch.cuda.synchronize()
    assert _ssd_bwd_counts() == tuple(c + 2 for c in before[:4]) + (
        before[4] + 8,)
    assert _ssd_route_counts() == tuple(
        c + d for c, d in zip(routes, _ssd_route_step(dtype, 2)))
    want = ssd_ops.ssd_scan_bwd(x, dt16, A, bm, cm, dy, chunk=64)
    for a, b, w, t in zip(g1, g2, want, (x, dt16, A, bm, cm)):
        assert a.dtype == t.dtype
        assert torch.equal(a, b) and torch.equal(a, w)
    y, h = ssd_ops.ssd_scan(*leaves, chunk=64, return_final_state=True)
    assert y.grad_fn is not None
    assert torch.equal(h, ssd_ops.ssd_final_state(x, dt16, A, bm, cm))
    with torch.no_grad():
        assert ssd_ops.ssd_scan(*leaves, chunk=64).grad_fn is None


class _OneEntryLaunched:
    """The kernel library with one entry point replaced by a call that
    launches nothing and returns 0."""

    def __init__(self, lib, entry):
        self._lib, self._entry = lib, entry

    def __getattr__(self, name):
        if name == self._entry:
            return lambda *args: 0
        return getattr(self._lib, name)


@pytest.mark.gpu
def test_ssd_backward_launch_error_on_card(cuda, monkeypatch):
    """A state the kernels refuse (N = 160, past their 128), let through the
    wrapper's own check, comes back from the C side as a
    ``KernelLaunchError`` naming the kernel and its entry point, nothing
    counted: in f32 the FFMA state pass, in bf16 the tensor-core one
    (``repro_ssd_bwd_state_tc``), and with that one taken as launched the
    tensor-core reverse pass (``repro_ssd_bwd_dstate_tc``), only the state
    pass counted.  The tensor-core chunk kernel's entry point refuses a head
    split past the heads (the state passes before it take the call): its
    error names it, and no chunk kernel is counted.  The FFMA state passes
    refuse bf16 and the tensor-core ones f32 (``dims[6]``)."""
    monkeypatch.setattr(ssd_ops, "MAX_STATE", 256)
    x, dt, A, bm, cm = _ssd_inputs(1, 64, 2, 16, 160, "float32", cuda)
    before = _ssd_bwd_counts()
    with pytest.raises(ssd_ops.KernelLaunchError,
                       match="state kernel, repro_ssd_bwd_state;"):
        ssd_ops.ssd_scan_bwd(x, dt, A, bm, cm, _ssd_dy(x, 29), chunk=32,
                             impl="kernel")
    assert _ssd_bwd_counts() == before
    x, dt, A, bm, cm = _ssd_inputs(1, 64, 2, 16, 160, "bfloat16", cuda)
    before, routes = _ssd_bwd_counts(), _ssd_route_counts()
    with pytest.raises(ssd_ops.KernelLaunchError,
                       match="state kernel, repro_ssd_bwd_state_tc;"):
        ssd_ops.ssd_scan_bwd(x, dt, A, bm, cm, _ssd_dy(x, 29), chunk=32,
                             impl="kernel")
    assert (_ssd_bwd_counts(), _ssd_route_counts()) == (before, routes)
    real_lib = ssd_ops._lib()
    monkeypatch.setattr(ssd_ops, "_lib", lambda: _OneEntryLaunched(
        real_lib, "repro_ssd_bwd_state_tc"))
    with pytest.raises(ssd_ops.KernelLaunchError,
                       match="dstate kernel, repro_ssd_bwd_dstate_tc;"):
        ssd_ops.ssd_scan_bwd(x, dt, A, bm, cm, _ssd_dy(x, 29), chunk=32,
                             impl="kernel")
    assert _ssd_bwd_counts() == (before[0] + 1, *before[1:4],
                                 before[4] + 1)
    assert _ssd_route_counts() == (routes[0] + 1, *routes[1:])
    monkeypatch.setattr(ssd_ops, "_lib", lambda: real_lib)
    x, dt, A, bm, cm = _ssd_inputs(1, 64, 2, 16, 16, "bfloat16", cuda)
    monkeypatch.setattr(ssd_ops, "plan_splits", lambda b, nc, h, sms: h + 1)
    before, routes = _ssd_bwd_counts(), _ssd_route_counts()
    with pytest.raises(ssd_ops.KernelLaunchError,
                       match="chunk kernel, repro_ssd_bwd_chunk_tc"):
        ssd_ops.ssd_scan_bwd(x, dt, A, bm, cm, _ssd_dy(x, 30), chunk=32,
                             impl="kernel")
    assert _ssd_bwd_counts()[2:4] == before[2:4]
    assert _ssd_route_counts() == (routes[0] + 1, routes[1] + 1,
                                   *routes[2:])
    for dtype, entries in (("bfloat16", ("repro_ssd_bwd_state",
                                         "repro_ssd_bwd_dstate")),
                           ("float32", ("repro_ssd_bwd_state_tc",
                                        "repro_ssd_bwd_dstate_tc"))):
        x, dt, A, bm, cm = _ssd_inputs(1, 64, 2, 16, 16, dtype, cuda)
        _, (_, args, _) = ssd_ops._bwd_call(x, dt, A, bm, cm,
                                            _ssd_dy(x, 31), 32)
        for entry in entries:
            assert getattr(real_lib, entry)(*args) != 0, (dtype, entry)
    torch.cuda.synchronize()


SSD_STATE_CASES = [(2, 200, 4, 16, 8, 128), (2, 40, 3, 16, 8, 128),
                   (1, 77, 2, 22, 13, 16), (2, 300, 4, 64, 128, 256),
                   (1, 300, 24, 64, 128, 128), (1, 260, 112, 64, 64, 128),
                   (8, 2048, 24, 64, 128, 128), (4, 1024, 112, 64, 64, 128)]
SSD_STATE_IDS = ["ragged200/128", "s<chunk-odd-heads", "ragged-odd-dims",
                 "default-chunk-256", "mamba2-layer-s300",
                 "zamba2-layer-s260", "mamba2-train-layer",
                 "zamba2-train-layer"]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", sorted(SSD_TOL))
@pytest.mark.parametrize("layout", ["bc-slices", "strided", "strong-decay"])
@pytest.mark.parametrize("b,s,h,p,n,chunk", SSD_STATE_CASES,
                         ids=SSD_STATE_IDS)
def test_ssd_backward_state_buffers_match_plain_on_card(cuda, dtype, layout,
                                                        b, s, h, p, n, chunk):
    """The state passes of the type (bf16 the tensor-core ones, f32 the
    FFMA ones) write each chunk's S_in and G, ``(B, nC, H, N, P)`` f32,
    within ``chip_smoke.ssd_bwd_state_buffers``' limits of
    ``ssd_bwd_states_ref`` in f64 (``ssd_bwd_errors`` at the f32 limits: 1e-4
    of the largest |value|, each row within 1e-3 of its norm), each entry
    point of the type launched with no error, bit-equal
    on a second launch, the first chunk's S_in and the last chunk's G
    exactly 0: at a ragged S, S < chunk with an odd head count, N 13 and
    P 22, the default chunk 256 (run at 128), and mamba2-130m's and
    zamba2-7b's layers at a short S and at their train shapes; B and C as
    slices of one (B, S, 2N) tensor, or also x and dy as strided views, or
    under strong decay (dt·A between -22 and -20 every step)."""
    from _torch_helpers import chip_smoke
    smoke = chip_smoke()
    x, dt, A, bm, cm = _ssd_inputs(b, s, h, p, n, dtype, cuda, seed=40)
    dy = _ssd_dy(x, 41)
    bc = torch.cat([bm, cm], dim=-1)
    bm, cm = bc[..., :n], bc[..., n:]
    if layout == "strided":
        x = x.transpose(0, 1).contiguous().transpose(0, 1)
        dy = dy.transpose(2, 3).contiguous().transpose(2, 3)
    elif layout == "strong-decay":
        r = np.random.default_rng(42)
        dt = torch.tensor(1.0 + 0.1 * r.random(tuple(dt.shape)),
                          dtype=torch.float32, device=cuda)
        A = torch.full_like(A, -20.0)
    c = min(chunk, s, ssd_ops.MAX_CHUNK)
    before = (_ssd_bwd_counts(), _ssd_route_counts())
    rcs, got, errs = smoke.ssd_bwd_state_buffers(x, dt, A, bm, cm, dy, chunk)
    rcs2, again, _ = smoke.ssd_bwd_state_buffers(x, dt, A, bm, cm, dy, chunk)
    assert (_ssd_bwd_counts(), _ssd_route_counts()) == before
    want_entries = {"float32": ("repro_ssd_bwd_state", "repro_ssd_bwd_dstate"),
                    "bfloat16": ("repro_ssd_bwd_state_tc",
                                 "repro_ssd_bwd_dstate_tc")}[dtype]
    assert tuple(rcs) == want_entries and set(rcs.values()) == {0}, rcs
    assert rcs2 == rcs
    assert not got[0][:, 0].any() and not got[1][:, -1].any()
    for key, g, g2 in zip(("S_in", "G"), got, again):
        assert g.shape == (b, -(-s // c), h, n, p), key
        assert torch.equal(g, g2), key
        assert errs[key]["fault"] is None, errs


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["mamba2-130m", "zamba2-7b"])
def test_ssd_train_step_on_card_matches_cpu(cuda, arch, dtype):
    """One ``make_train_step`` at the smoke width from the same weights and
    a batch of 40 tokens a row (the SSD state across two chunk
    boundaries) on the card (SSD forward and backward kernels; for zamba2
    the flash kernels too) and on the CPU (plain versions): f32 loss, grad
    norm and AdamW moments within 1e-4 (relative, and absolute of the
    leaf's largest), and the master params within 1e-4 wherever the step's
    gradient is not near AdamW's eps (``assert_master_close``: there the
    step divides by √v + eps and rounding alone moves it; ROADMAP C); bf16
    loss and grad norm within 5e-2; each backward kernel launched once a
    Mamba2 layer, the state passes and the chunk kernel the type's."""
    import dataclasses
    from _torch_helpers import assert_master_close
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.optim import AdamWConfig, adamw, schedule
    from repro_torch.runtime import make_train_step
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype=dtype)
    r = np.random.default_rng(30)
    batch = {k: torch.tensor(r.integers(0, cfg.vocab_size, (2, 40)))
             for k in ("tokens", "labels")}
    acfg = AdamWConfig(lr=1e-3)
    out = []
    for dev in (cuda, torch.device("cpu")):
        state = adamw.init(init_params(cfg, 0, device=cuda).to(dev))
        before, routes = _ssd_bwd_counts(), _ssd_route_counts()
        step = make_train_step(cfg, acfg, schedule.constant)
        state, m = step(state, {k: t.to(dev) for k, t in batch.items()})
        if dev.type == "cuda":
            assert _ssd_bwd_counts()[:4] == tuple(
                c + cfg.n_layers for c in before[:4])
            assert _ssd_route_counts() == tuple(c + d for c, d in zip(
                routes, _ssd_route_step(dtype, cfg.n_layers)))
        else:
            assert _ssd_bwd_counts() == before
        out.append((float(m["loss"]), float(m["grad_norm"]),
                    {(part, n): t.cpu() for part in ("m", "v", "master")
                     for n, t in state[part].items()}))
    (loss, gn, leaves), (loss_c, gn_c, leaves_c) = out
    tol = 1e-4 if dtype == "float32" else 5e-2
    assert abs(loss - loss_c) <= tol * abs(loss_c)
    assert abs(gn - gn_c) <= tol * abs(gn_c)
    if dtype == "float32":
        for (part, name), t in leaves_c.items():
            if part == "master":
                g = leaves_c[("m", name)] / (1.0 - acfg.b1)
                assert_master_close(leaves[part, name].numpy(), t.numpy(),
                                    g.numpy(), acfg.lr, tol,
                                    f"{part} {name}")
            else:
                np.testing.assert_allclose(
                    leaves[part, name].numpy(), t.numpy(), rtol=tol,
                    atol=tol * float(t.abs().max()),
                    err_msg=f"{part} {name}")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_step_on_card_matches_cpu(cuda, dtype):
    """One ``make_train_step`` at gemma2-smoke width from the same weights
    and batch on the card (flash forward and backward kernels, the card's
    unembedding backward) and on the CPU (plain versions): f32 loss, grad
    norm and master params within 1e-4 (relative, and absolute of the
    leaf's largest); bf16 loss and grad norm within 5e-2."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.optim import AdamWConfig, adamw, schedule
    from repro_torch.runtime import make_train_step
    cfg = dataclasses.replace(get_config("gemma2-2b", smoke=True),
                              dtype=dtype)
    r = np.random.default_rng(4)
    batch = {k: torch.tensor(r.integers(0, cfg.vocab_size, (2, 32)))
             for k in ("tokens", "labels")}
    out = []
    for dev in (cuda, torch.device("cpu")):
        state = adamw.init(init_params(cfg, 0, device=cuda).to(dev))
        before = flash_ops.BWD_DKDV_LAUNCHES
        step = make_train_step(cfg, AdamWConfig(lr=1e-3), schedule.constant)
        state, m = step(state, {k: t.to(dev) for k, t in batch.items()})
        if dev.type == "cuda":
            assert flash_ops.BWD_DKDV_LAUNCHES == before + cfg.n_layers
        out.append((float(m["loss"]), float(m["grad_norm"]),
                    {n: t.cpu() for n, t in state["master"].items()}))
    (loss, gn, master), (loss_c, gn_c, master_c) = out
    tol = 1e-4 if dtype == "float32" else 5e-2
    assert abs(loss - loss_c) <= tol * abs(loss_c)
    assert abs(gn - gn_c) <= tol * abs(gn_c)
    if dtype == "float32":
        for name, t in master_c.items():
            np.testing.assert_allclose(
                master[name].numpy(), t.numpy(), rtol=tol,
                atol=tol * float(t.abs().max()), err_msg=name)
