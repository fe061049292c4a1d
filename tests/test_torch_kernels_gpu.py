"""The blocked matmul's CUDA kernels on the card (marked ``gpu``).

The tile kernel and the split-K reduction have no CPU mode, so these tests skip without a CUDA device.
With a card they run with

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_kernels_gpu.py

holding the kernel against its plain version (``matmul_ref``) at the shapes
of ``tests/test_kernels.py``, the ragged 100×70×50 case and the scorer's
two product shapes: f32 at rtol 1e-5 (1e-4 at K = 100000, where the
summation orders differ over many more terms), atol 1e-5·√K; bf16 at
2e-2.  This file imports neither JAX nor the JAX package, so it runs
where only PyTorch is installed.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.matmul import ops  # noqa: E402
from repro_torch.kernels.matmul.ref import (matmul_ref,  # noqa: E402
                                            splitk_reduce_ref)

SHAPES = [(128, 128, 128), (256, 512, 128), (384, 256, 640), (100, 70, 50),
          (8, 1600, 4000), (8, 100000, 10), (1, 100000, 10)]
TOL = {"float32": 1e-5, "bfloat16": 2e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the matmul kernel has no CPU mode")
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
