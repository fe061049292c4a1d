"""Port parity: tensor relations and eager TRA ops (``repro_torch.core.tra``).

``join`` / ``agg`` / ``transform`` / ``fused_join_agg`` (its 2-D matmul
branch and its einsum branch, masked and unmasked) and the serving row
helpers against the JAX package on the same numpy relations, at 1e-5.
The operations not ported yet raise ``NotImplementedError``.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.core.tra as jtra  # noqa: E402
import repro_torch.core.tra as ttra  # noqa: E402
from repro.core import kernels_registry as jkr  # noqa: E402
from repro_torch.core import kernels_registry as tkr  # noqa: E402
from _torch_helpers import (as_np, assert_rel_close, normal,  # noqa: E402
                            rel_pair, rng)

TOL = 1e-5


def _mask(r, shape, p=0.7):
    m = r.random(shape) < p
    m.flat[0] = True
    return m


def test_from_to_tensor_roundtrip():
    x = normal(rng(0), (6, 8))
    jr = jtra.from_tensor(jnp.asarray(x), (3, 4))
    tr = ttra.from_tensor(torch.from_numpy(x), (3, 4))
    assert_rel_close(jr, tr, 0.0)
    np.testing.assert_array_equal(as_np(ttra.to_tensor(tr)), x)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("kernel", ["matMul", "matAdd", "elemMul"])
def test_join_and_agg(masked, kernel):
    r = rng(1)
    lb, rb = ((3, 4), (4, 5)) if kernel == "matMul" else ((3, 4), (3, 4))
    lm = _mask(r, (2, 3)) if masked else None
    jl, tl = rel_pair(r, (2, 3), lb, lm)
    jr, tr = rel_pair(r, (3, 2), rb)
    jj = jtra.join(jl, jr, (1,), (0,), jkr.get_kernel(kernel))
    tj = ttra.join(tl, tr, (1,), (0,), tkr.get_kernel(kernel))
    assert_rel_close(jj, tj, TOL)
    for agg_k in ("matAdd", "elemMax"):
        ja = jtra.agg(jj, (0, 2), jkr.get_kernel(agg_k))
        ta = ttra.agg(tj, (0, 2), tkr.get_kernel(agg_k))
        assert_rel_close(ja, ta, TOL)
    # an agg kernel without a batched reduce folds pairwise
    jv = jtra.agg(jj, (2,), jkr.get_kernel("matAdd"))
    tv = ttra.agg(tj, (2,), tkr.get_kernel("matAdd"))
    assert_rel_close(jv, tv, TOL)


def test_transform():
    jr, tr = rel_pair(rng(2), (2, 3), (3, 4))
    for name in ("relu", "sigmoid", "rowSum", "transpose"):
        assert_rel_close(jtra.transform(jr, jkr.get_kernel(name)),
                         ttra.transform(tr, tkr.get_kernel(name)), TOL)


@pytest.mark.parametrize("case", [
    # (left key/bound, right key/bound, join keys, group-by, kernel, masked)
    ("mm2d", (3, 4), (2, 5), (4, 5), (5, 6), (1,), (0,), (0, 2), "matMul",
     False),
    ("mm2d-batched", (2, 3), (1, 6), (3, 4), (6, 5), (1,), (0,), (0, 2),
     "matMul", False),
    ("einsum-masked", (3, 4), (2, 5), (4, 5), (5, 6), (1,), (0,), (0, 2),
     "matMul", True),
    ("einsum-tranL", (4, 3), (5, 2), (4, 5), (5, 6), (0,), (0,), (1, 2),
     "matTranMulL", False),
    ("einsum-tranR", (3, 4), (2, 5), (6, 4), (6, 5), (1,), (1,), (0, 2),
     "matTranMulR", False),
    ("einsum-elem", (3, 4), (2, 5), (4, 3), (2, 5), (1,), (0,), (0, 2),
     "elemMul", False),
    ("mm-partial-reduce", (3, 4), (2, 5), (4, 5), (5, 6), (1,), (0,), (0,),
     "matMul", False),
])
def test_fused_join_agg_matches_jax_and_unfused(case):
    (_, lk, lb, rk, rb, jkl, jkr_, gb, kernel, masked) = case
    r = rng(3)
    lm = _mask(r, lk) if masked else None
    jl, tl = rel_pair(r, lk, lb, lm)
    jr, tr = rel_pair(r, rk, rb)
    jk, tk = jkr.get_kernel(kernel), tkr.get_kernel(kernel)
    jadd, tadd = jkr.get_kernel("matAdd"), tkr.get_kernel("matAdd")
    want = jtra.fused_join_agg(jl, jr, jkl, jkr_, jk, gb, jadd)
    got = ttra.fused_join_agg(tl, tr, jkl, jkr_, tk, gb, tadd)
    assert_rel_close(want, got, TOL)
    unfused = ttra.agg(ttra.join(tl, tr, jkl, jkr_, tk), gb, tadd)
    assert_rel_close(want, unfused, TOL)


def test_fused_2d_branch_is_taken_only_unmasked(monkeypatch):
    calls = []
    real = ttra._fused_matmul_2d

    def counting(*args, **kw):
        calls.append(1)
        return real(*args, **kw)

    monkeypatch.setattr(ttra, "_fused_matmul_2d", counting)
    r = rng(4)
    for masked in (False, True):
        _, tl = rel_pair(r, (3, 4), (2, 5), _mask(r, (3, 4)) if masked
                         else None)
        _, tr = rel_pair(r, (4, 5), (5, 6))
        ttra.fused_join_agg(tl, tr, (1,), (0,), tkr.get_kernel("matMul"),
                            (0, 2), tkr.get_kernel("matAdd"))
    assert len(calls) == 1


@pytest.mark.parametrize("bucket", [1, 8])
def test_scorer_products_take_the_relations_own_tensors(bucket, monkeypatch):
    """The scorer's two fused products with its blocking (db=4, hb=10,
    lb=1) at narrow widths (bd=40, bh=100, bl=10), against
    ``repro.core.tra.fused_join_agg`` at 1e-5.  ``_fused_matmul_2d`` hands
    the matmul op views of the relations' own storage (W1 as the permuted
    (db, bd, hb, bh) view), and the skinny kernel's plan reads every one in
    place: no copy."""
    from repro_torch.kernels.matmul import ops
    seen = []
    real = ops.matmul

    def spy(a, b, **kw):
        seen.append((a, b, kw))
        return real(a, b, **kw)

    monkeypatch.setattr(ops, "matmul", spy)
    r = rng(7)

    def pair(key_shape, bound, fan_in=1):
        # weights scaled by 1/sqrt(fan_in), as a layer's are
        data = normal(r, key_shape + bound) / np.float32(fan_in ** 0.5)
        return (jtra.TensorRelation(jnp.asarray(data),
                                    jtra.RelType(key_shape, bound)),
                ttra.TensorRelation(torch.from_numpy(data.copy()),
                                    ttra.RelType(key_shape, bound)))

    jx, tx = pair((bucket, 4), (1, 40))
    jw1, tw1 = pair((4, 10), (40, 100), 160)
    jw2, tw2 = pair((10, 1), (100, 10), 1000)
    jmm, tmm = jkr.get_kernel("matMul"), tkr.get_kernel("matMul")
    jadd, tadd = jkr.get_kernel("matAdd"), tkr.get_kernel("matAdd")
    jh = jtra.fused_join_agg(jx, jw1, (1,), (0,), jmm, (0, 2), jadd)
    th = ttra.fused_join_agg(tx, tw1, (1,), (0,), tmm, (0, 2), tadd)
    assert_rel_close(jh, th, TOL)
    want = jtra.fused_join_agg(jh, jw2, (1,), (0,), jmm, (0, 2), jadd)
    got = ttra.fused_join_agg(th, tw2, (1,), (0,), tmm, (0, 2), tadd)
    assert_rel_close(want, got, TOL)
    (a1, b1, _), (a2, b2, _) = seen
    assert a1.data_ptr() == tx.data.data_ptr()
    assert b1.data_ptr() == tw1.data.data_ptr()
    assert a2.data_ptr() == th.data.data_ptr()
    assert b2.data_ptr() == tw2.data.data_ptr()
    assert not b1.is_contiguous()       # W1 as (db, bd, hb, bh): a real view
    for a, b, kw in seen:
        plan = ops.plan_operands(
            (a.shape, a.stride(), a.data_ptr(), kw["a_rows"]),
            (b.shape, b.stride(), b.data_ptr(), kw["b_rows"]))
        assert not (plan.copy_a or plan.copy_b)


def test_chunked_lowering_not_ported():
    r = rng(5)
    _, tl = rel_pair(r, (3, 4), (2, 5))
    _, tr = rel_pair(r, (4, 5), (2, 5))
    with pytest.raises(NotImplementedError, match="slice 2"):
        ttra.fused_join_agg(tl, tr, (1,), (0,), tkr.get_kernel("matAdd"),
                            (0, 2), tkr.get_kernel("elemMax"))


@pytest.mark.parametrize("op,args", [
    ("rekey", (lambda k: k,)), ("filt", (lambda k: True,)),
    ("pad", ((4, 4),)), ("tile", (0, 1)), ("concat", (0, 0)),
])
def test_unported_ops_raise(op, args):
    _, tr = rel_pair(rng(6), (2, 2), (2, 2))
    with pytest.raises(NotImplementedError, match="slice 2"):
        getattr(ttra, op)(tr, *args)


class TestRowHelpers:
    def _rows(self, n, r):
        rt_j, rt_t = jtra.RelType((2,), (1, 3)), ttra.RelType((2,), (1, 3))
        datas = [normal(r, (2, 1, 3)) for _ in range(n)]
        return (rt_j, rt_t, [jnp.asarray(d) for d in datas],
                [torch.from_numpy(d) for d in datas])

    def test_pack_unpack(self):
        rt_j, rt_t, jd, td = self._rows(3, rng(7))
        jp = jtra.pack_rows(jd, 4, rt_j)
        tp = ttra.pack_rows(td, 4, rt_t)
        assert_rel_close(jp, tp, 0.0)
        for a, b in zip(jtra.unpack_rows(jp, 3), ttra.unpack_rows(tp, 3)):
            assert_rel_close(a, b, 0.0)
        with pytest.raises(ValueError):
            ttra.pack_rows(td * 2, 4, rt_t)

    def test_scatter_and_zero_rows(self):
        rt_j, rt_t, jd, td = self._rows(4, rng(8))
        jp, tp = jtra.pack_rows(jd, 4, rt_j), ttra.pack_rows(td, 4, rt_t)
        _, _, jn, tn = self._rows(2, rng(9))
        js = jtra.scatter_rows(jp, [1, 3], jn)
        ts = ttra.scatter_rows(tp, [1, 3], tn)
        assert_rel_close(js, ts, 0.0)
        np.testing.assert_array_equal(as_np(tp), as_np(jp))   # out of place
        assert_rel_close(jtra.zero_rows(js, [0, 3]),
                         ttra.zero_rows(ts, [0, 3]), 0.0)
        with pytest.raises(ValueError):
            ttra.scatter_rows(tp, [1, 1], tn)
        with pytest.raises(ValueError):
            ttra.zero_rows(tp, [4])
