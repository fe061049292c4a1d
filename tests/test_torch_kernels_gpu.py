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
skinny kernel, the rest through the tile kernel, as the counters show; the
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
largest |output|; B and C read in place as slices of one tensor; and
mamba2-smoke through the kernel against the same model with the plain
SSD scan (f32, 1e-4).  This file imports neither JAX nor
the JAX package, so it runs where only PyTorch is installed.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: E402
from repro_torch.kernels.matmul import ops  # noqa: E402
from repro_torch.kernels.matmul.ref import (matmul_ref,  # noqa: E402
                                            splitk_reduce_ref)
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


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n", SHAPES)
@pytest.mark.parametrize("dtype", sorted(TOL))
def test_kernel_matches_plain_on_card(cuda, m, k, n, dtype):
    a, b = _operands(m, k, n, dtype, cuda)
    before = _counts()
    got = ops.matmul(a, b, impl="kernel")
    want = matmul_ref(a, b)
    torch.cuda.synchronize()
    skinny, tile, reduces, _, copies = (x - y for x, y in zip(_counts(),
                                                              before))
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    if ops.route(a, b, "kernel") == "skinny":
        assert (skinny, tile, reduces) == (1, 0, 0)
    else:
        split = ops.plan_launch(m, n, k, sms)[1] > 1
        assert (skinny, tile, reduces) == (0, 1, int(split))
    assert copies == 0
    assert got.dtype == a.dtype and tuple(got.shape) == (m, n)
    tol = TOL[dtype]
    rtol = 1e-4 if k >= 100000 and dtype == "float32" else tol
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), rtol=rtol,
                               atol=tol * k ** 0.5)
    # split-K is deterministic: a second launch is bit-identical
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


def _ssd_check(x, dt, A, bm, cm, chunk, dtype):
    before = ssd_ops.LAUNCHES
    got = ssd_ops.ssd_scan(x, dt, A, bm, cm, chunk=chunk, impl="kernel")
    want = ssd_chunked_ref(x, dt, A, bm, cm, min(chunk, x.shape[1]))
    torch.cuda.synchronize()
    assert ssd_ops.LAUNCHES == before + 1
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
    f32 product of the bf16 values, as the CPU path computes it."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    cfg = get_config("mamba2-130m", smoke=True)
    model = init_params(cfg, 0, device=cuda)
    x = torch.randn((2, 5, cfg.d_model), device=cuda).bfloat16()
    got = model.unembed(x)
    assert got.dtype == torch.float32
    model_cpu = model.to("cpu")
    want = model_cpu.unembed(x.cpu())
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)
