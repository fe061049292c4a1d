"""The port's CUDA kernels on the card (marked ``gpu``).

The matmul tile kernel, the split-K reduction and the flash attention
kernel have no CPU mode, so these tests skip without a CUDA device.
With a card they run with

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_kernels_gpu.py

holding each kernel against its plain version.  The matmul
(``matmul_ref``) at the shapes of ``tests/test_kernels.py``, the ragged
100×70×50 case and the scorer's two product shapes: f32 at rtol 1e-5
(1e-4 at K = 100000, where the summation orders differ over many more
terms), atol 1e-5·√K; bf16 at 2e-2.  Flash attention (``attention_ref``)
at the cases of ``tests/test_kernels.py:47-76`` (f32 at 2e-4, bf16 at
3e-2, as there), ragged lengths, ``sq < skv``, ``dv != d``, head dim 256
and strided inputs; and the smoke-width dense models through the kernel
against the same models with the plain attention (f32, 1e-4).  This file imports neither JAX nor the JAX package,
so it runs where only PyTorch is installed.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: E402
from repro_torch.kernels.matmul import ops  # noqa: E402
from repro_torch.kernels.matmul.ref import (matmul_ref,  # noqa: E402
                                            splitk_reduce_ref)

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


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n", SHAPES)
@pytest.mark.parametrize("dtype", sorted(TOL))
def test_kernel_matches_plain_on_card(cuda, m, k, n, dtype):
    a, b = _operands(m, k, n, dtype, cuda)
    before, reduces = ops.LAUNCHES, ops.REDUCE_LAUNCHES
    got = ops.matmul(a, b, impl="kernel")
    want = matmul_ref(a, b)
    torch.cuda.synchronize()
    assert ops.LAUNCHES == before + 1
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    split = ops.plan_launch(m, n, k, sms)[1] > 1
    assert ops.REDUCE_LAUNCHES == reduces + split
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
    """A B that starts off a 16-byte boundary takes the scalar load path
    (N = 128 would otherwise take float4 loads)."""
    base = torch.randn(64 * 128 + 1, device=cuda)
    b = base[1:].view(64, 128)                 # contiguous, 4-byte offset
    a = torch.randn(5, 64, device=cuda)
    np.testing.assert_allclose(ops.matmul(a, b).cpu().numpy(),
                               matmul_ref(a, b).cpu().numpy(), rtol=1e-5,
                               atol=1e-4)


@pytest.mark.gpu
def test_auto_on_card_launches_the_kernel(cuda):
    a = torch.randn(8, 64, device=cuda)
    b = torch.randn(64, 32, device=cuda)
    before = ops.LAUNCHES
    ops.matmul(a, b)
    assert ops.LAUNCHES == before + 1
    with pytest.raises(ValueError, match="contiguous"):
        ops.matmul(a, b.t().contiguous().t())
    with pytest.raises(ValueError, match="CUDA device"):
        ops.matmul(a, b.cpu())


@pytest.mark.gpu
def test_scorer_dispatch_launches_twice_on_card(cuda):
    """Through the engine: one speech-shaped scorer dispatch (narrow
    hidden width) launches the kernel once per fused product."""
    from repro_torch.core import Engine
    from repro_torch.serve import FFNNScorer
    sc = FFNNScorer(db=4, hb=10, lb=1, bd=400, bh=100, bl=10, device=cuda)
    eng = Engine(executor="jit", device=cuda)
    payloads = [sc.random_payload(np.random.default_rng(i)) for i in range(3)]
    before, reduces = ops.LAUNCHES, ops.REDUCE_LAUNCHES
    out = eng.run(sc.program(4)["scores"], **sc.pack(payloads, 4),
                  **sc.weights())
    assert ops.LAUNCHES == before + 2
    # each product whose output has too few tiles splits K and reduces
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    split = sum(ops.plan_launch(4, n, k, sms)[1] > 1
                for k, n in ((1600, 1000), (1000, 10)))
    assert ops.REDUCE_LAUNCHES == reduces + split
    got = out.data[:3].reshape(3, -1).cpu().numpy()
    for p, g in zip(payloads, got):
        np.testing.assert_allclose(g, sc.oracle(p), atol=1e-5)


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
    (200, 200, 192, 128, dict(causal=True, window=0, softcap=0.0)),
    (300, 300, 256, 256, dict(causal=True, window=128, softcap=50.0)),
    (300, 300, 256, 256, dict(causal=False, window=0, softcap=0.0)),
    (1, 300, 64, 64, dict(causal=True, window=0, softcap=0.0)),
])
def test_flash_kernel_ragged_and_dims_on_card(cuda, dtype, sq, skv, d, dv,
                                              kw):
    """Ragged lengths, ``sq < skv`` (ends aligned), ``sq > skv`` (leading
    rows fully masked: 0), ``dv != d`` and head dim 256."""
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
