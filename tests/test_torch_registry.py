"""Port parity: the kernel registry (``repro_torch.core.kernels_registry``).

Every registered kernel's ``apply`` (and ``reduce``) against the JAX
package's on the same numpy operands at 1e-6, and identical metadata:
``out_bound``, ``flops``, ``is_associative``, ``identity``,
``distributes_over`` and the ``vjp`` rules (join rules by kernel name;
unary rules by the plan they build).
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.core.expr as jE  # noqa: E402
import repro.core.kernels_registry as jkr  # noqa: E402
import repro_torch.core.expr as tE  # noqa: E402
import repro_torch.core.kernels_registry as tkr  # noqa: E402
from _torch_helpers import as_np, normal, rng  # noqa: E402

# operand bounds per kernel (leading dim 2 is a broadcast key dim)
EW = ((3, 4), (3, 4))
OPERANDS = {
    "matMul": ((3, 4), (4, 5)),
    "matTranMulL": ((4, 3), (4, 5)),
    "matTranMulR": ((3, 4), (5, 4)),
    "matVecSub": ((1, 4), (3, 4)),
    "scaleBy": ((3, 4), (1, 1)),
    "minIndex": ((2,), (2,)),
}


def _operands(name, arity, r):
    if arity == 1:
        bounds = ((3, 4),)
    else:
        bounds = OPERANDS.get(name, EW)
    xs = [normal(r, (2,) + b) for b in bounds]
    if name == "bceSum":
        xs = [1.0 / (1.0 + np.exp(-xs[0])),
              (xs[1] > 0).astype(np.float32)]
    if name == "eqMask":
        xs[1] = np.where(xs[1] > 0, xs[0], xs[1]).astype(np.float32)
    if name == "elemDiv":
        xs[1] = (np.abs(xs[1]) + 0.5).astype(np.float32)
    return bounds, xs


def test_same_registered_names():
    assert list(tkr.registered_kernels()) == list(jkr.registered_kernels())


def _vjp_sig(k):
    if k.vjp is None:
        return None
    if k.arity == 2:
        return tuple(None if v is None else
                     (v.kernel if isinstance(v.kernel, str) else v.kernel.name,
                      v.cot_first) for v in k.vjp)
    return "builder"


@pytest.mark.parametrize("name", jkr.registered_kernels())
def test_kernel_apply_and_metadata(name):
    jk, tk = jkr.get_kernel(name), tkr.get_kernel(name)
    bounds, xs = _operands(name, jk.arity, rng(7))
    want = jk.apply(*[jnp.asarray(x) for x in xs])
    got = tk.apply(*[torch.from_numpy(x.copy()) for x in xs])
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(as_np(got), as_np(want), rtol=1e-6, atol=1e-6)
    assert jk.arity == tk.arity
    assert tk.out_bound(*bounds) == jk.out_bound(*bounds)
    assert tk.flops(*bounds) == jk.flops(*bounds)
    assert tk.is_associative == jk.is_associative
    assert tk.identity == jk.identity
    assert tuple(tk.distributes_over) == tuple(jk.distributes_over)
    assert _vjp_sig(tk) == _vjp_sig(jk)
    if jk.reduce is not None:
        x = normal(rng(8), (2, 3, 3, 4))
        np.testing.assert_allclose(
            as_np(tk.reduce(torch.from_numpy(x.copy()), (0, 1))),
            as_np(jk.reduce(jnp.asarray(x), (0, 1))), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name", [n for n in jkr.registered_kernels()
                                  if jkr.get_kernel(n).arity == 1
                                  and jkr.get_kernel(n).vjp is not None])
def test_unary_vjp_builds_same_plan(name):
    """A unary kernel's VJP builder emits the same TRA plan in both
    packages (it is written against the ported Expr frontend)."""
    jk, tk = jkr.get_kernel(name), tkr.get_kernel(name)
    b = (3, 4)
    ob = jk.out_bound(b)
    plans = []
    for mod, k in ((jE, jk), (tE, tk)):
        x = mod.input("x", (2,), b)
        y = x.map(k)
        g = mod.input("g", (2,), ob)
        plans.append(k.vjp(x, y, g).describe())
    assert plans[1] == plans[0]


@pytest.mark.parametrize("factory,arg,arity", [
    ("make_scale_mul", 0.5, 1), ("make_axpy", -0.25, 2),
    ("make_scale_mul_bin", 2.0, 2), ("make_momentum", 0.9, 2),
    ("make_ema", 0.9, 2), ("make_ema_sq", 0.99, 2),
    ("make_adam_dir", 1e-8, 2), ("make_bias_corr", 0.9, 1),
    ("make_row_broadcast", 5, 1), ("make_to_val_idx", 4, 1),
])
def test_factory_kernels(factory, arg, arity):
    jk = getattr(jkr, factory)(arg)
    tk = getattr(tkr, factory)(arg)
    assert tk.name == jk.name and tk.arity == jk.arity == arity
    r = rng(9)
    xs = [normal(r, (2, 3, 4)) for _ in range(arity)]
    if factory == "make_adam_dir":
        xs[1] = np.abs(xs[1])
    if factory == "make_bias_corr":
        xs[0] = np.full((2, 3, 4), 3.0, np.float32)
    want = jk.apply(*[jnp.asarray(x) for x in xs])
    got = tk.apply(*[torch.from_numpy(x.copy()) for x in xs])
    np.testing.assert_allclose(as_np(got), as_np(want), rtol=1e-6, atol=1e-6)
    bounds = ((3, 4),) * arity
    assert tk.out_bound(*bounds) == jk.out_bound(*bounds)
    assert tk.flops(*bounds) == jk.flops(*bounds)


def test_diag_embed_and_compose():
    x = normal(rng(10), (2, 3))
    jk, tk = jkr.make_diag_embed(3, 4), tkr.make_diag_embed(3, 4)
    np.testing.assert_array_equal(as_np(tk.apply(torch.from_numpy(x))),
                                  as_np(jk.apply(jnp.asarray(x))))
    jc = jkr.compose(jkr.get_kernel("relu"), jkr.get_kernel("matMul"))
    tc = tkr.compose(tkr.get_kernel("relu"), tkr.get_kernel("matMul"))
    a, b = normal(rng(11), (2, 3, 4)), normal(rng(12), (2, 4, 5))
    assert tc.name == jc.name
    np.testing.assert_allclose(
        as_np(tc.apply(torch.from_numpy(a), torch.from_numpy(b))),
        as_np(jc.apply(jnp.asarray(a), jnp.asarray(b))), rtol=1e-6,
        atol=1e-6)
    assert tc.flops((3, 4), (4, 5)) == jc.flops((3, 4), (4, 5))
