"""Port parity: the TRA operators of the training slice and the chunked
lowering of the fused Σ∘⋈ pair (``repro_torch.core.tra``,
``repro_torch.core.reference``).

``rekey`` / ``filt`` / ``pad`` / ``tile`` / ``concat`` on continuous and
holey relations, and ``fused_join_agg``'s streamed reduction for the
kernel pairs that are not a contraction (``rowSum∘matMul → matAdd``,
``matAdd → elemMax``, ``elemMin → elemMin``, ``elemMul → elemMax``) over
masked and unmasked operands and several ``chunk`` values, against
``repro.core.tra`` on the same numpy relations at 1e-5, and against the
unfused pair and the tuple-at-a-time reference executor.
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

import repro.core.reference as jref  # noqa: E402
import repro.core.tra as jtra  # noqa: E402
import repro_torch.core.reference as tref  # noqa: E402
import repro_torch.core.tra as ttra  # noqa: E402
from repro.core import kernels_registry as jkr  # noqa: E402
from repro_torch.core import kernels_registry as tkr  # noqa: E402
from _torch_helpers import (as_np, assert_rel_close, rel_pair,  # noqa: E402
                            rng)

TOL = 1e-5


def _mask(r, shape, p=0.7):
    m = r.random(shape) < p
    m.flat[0] = True
    return m


def _both(kernel):
    """A kernel by name in both registries, or a composed pair."""
    if kernel == "rowSum∘matMul":
        return (jkr.compose(jkr.get_kernel("rowSum"),
                            jkr.get_kernel("matMul")),
                tkr.compose(tkr.get_kernel("rowSum"),
                            tkr.get_kernel("matMul")))
    return jkr.get_kernel(kernel), tkr.get_kernel(kernel)


def _ref_dict(rel):
    return {k: as_np(v) for k, v in rel.to_dict().items()}


# ----------------------------------------------------------- the operators
OP_CASES = {
    # name: (key shape, bound, masked, op on (tra module, relation))
    "rekey-swap": ((2, 3), (2, 3), False,
                   lambda m, r: m.rekey(r, lambda k: (k[1], k[0]))),
    "rekey-holes": ((2, 3), (2, 3), False,
                    lambda m, r: m.rekey(r, lambda k: (2 * k[0], k[1]))),
    "rekey-flatten": ((2, 3), (2, 2), True,
                      lambda m, r: m.rekey(r, lambda k: (3 * k[0] + k[1],),
                                           out_arity=1)),
    "filt-hole": ((3, 3), (2, 2), False,
                  lambda m, r: m.filt(r, lambda k: k != (1, 1))),
    "filt-shrink": ((3, 4), (2, 2), True,
                    lambda m, r: m.filt(r, lambda k: k[1] < 2)),
    "pad-grow": ((2, 3), (2, 3), False, lambda m, r: m.pad(r, (4, 3))),
    "pad-holes": ((2, 3), (2, 3), True, lambda m, r: m.pad(r, (2, 5))),
    "tile": ((2, 2), (4, 6), False, lambda m, r: m.tile(r, 1, 2)),
    "tile-masked": ((2, 2), (4, 6), True, lambda m, r: m.tile(r, 0, 2)),
    "concat": ((2, 3), (2, 4), False, lambda m, r: m.concat(r, 0, 1)),
    "concat-masked": ((2, 3), (2, 4), "rows",
                      lambda m, r: m.concat(r, 1, 0)),
}


def _op_pair(case, seed):
    ks, bound, masked, op = OP_CASES[case]
    r = rng(seed)
    if masked == "rows":              # concat needs complete groups
        mask = np.ones(ks, bool)
        mask[1] = False
    else:
        mask = _mask(r, ks) if masked else None
    jr, tr = rel_pair(r, ks, bound, mask)
    return op(jtra, jr), op(ttra, tr), tr, op


@pytest.mark.parametrize("case", sorted(OP_CASES))
def test_operator_matches_jax_and_reference(case):
    want, got, tr, op = _op_pair(case, 7)
    assert_rel_close(want, got, TOL)
    if want.mask is not None:         # values at holes are unspecified
        sel = want.mask.reshape(want.mask.shape + (1,) * want.rtype.rank)
        np.testing.assert_array_equal(
            as_np(got) * sel, np.asarray(want.data) * sel)
    if case.startswith("pad"):
        return                        # pad has no tuple-at-a-time form
    name = case.split("-")[0]
    ref_op = {"filt": tref.filt, "rekey": tref.rekey, "tile": tref.tile,
              "concat": tref.concat}[name]
    ks, bound, masked, _ = OP_CASES[case]
    args = {"rekey-swap": (lambda k: (k[1], k[0]),),
            "rekey-holes": (lambda k: (2 * k[0], k[1]),),
            "rekey-flatten": (lambda k: (3 * k[0] + k[1],),),
            "filt-hole": (lambda k: k != (1, 1),),
            "filt-shrink": (lambda k: k[1] < 2,),
            "tile": (1, 2), "tile-masked": (0, 2),
            "concat": (0, 1), "concat-masked": (1, 0)}[case]
    oracle = ref_op(_ref_dict(tr), *args)
    dense = _ref_dict(got)
    assert sorted(oracle) == sorted(dense)
    for k, v in oracle.items():
        np.testing.assert_array_equal(dense[k], v)


def test_operators_raise_as_jax_does():
    _, tr = rel_pair(rng(8), (2, 2), (2, 4))
    with pytest.raises(ValueError, match="duplicate"):
        ttra.rekey(tr, lambda k: (0, 0))
    with pytest.raises(ValueError, match="removed every"):
        ttra.filt(tr, lambda k: False)
    with pytest.raises(ValueError, match="cover"):
        ttra.pad(tr, (1, 2))
    with pytest.raises(ValueError, match="divide"):
        ttra.tile(tr, 1, 3)
    holey = ttra.TensorRelation(tr.data, tr.rtype,
                                np.array([[True, False], [True, True]]))
    with pytest.raises(ValueError, match="complete"):
        ttra.concat(holey, 1, 0)


# --------------------------------------------------- the chunked lowering
CHUNK_CASES = [
    # (join kernel, agg kernel, left key/bound, right key/bound, jkl, jkr,
    #  group-by)
    ("rowSum∘matMul", "matAdd", (3, 4), (2, 5), (4, 2), (5, 3), (1,), (0,),
     (0, 2)),
    ("matAdd", "elemMax", (3, 4), (2, 5), (4, 5), (2, 5), (1,), (0,),
     (0, 2)),
    ("elemMin", "elemMin", (2, 3), (3, 3), (3, 2), (3, 3), (1,), (0,),
     (0, 2)),
    ("elemMul", "elemMax", (2, 4), (4, 4), (4, 2), (4, 4), (1,), (0,),
     (2, 0)),
    ("matAdd", "matAdd", (2, 3, 2), (2, 2), (3, 2), (2, 2), (1,), (0,),
     (0,)),
]


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("chunk", [None, 1, 3, 64])
@pytest.mark.parametrize("case", range(len(CHUNK_CASES)))
def test_chunked_lowering_matches_jax_and_unfused(case, chunk, masked):
    jk_name, ak_name, lk, lb, rk, rb, jkl, jkr_, gb = CHUNK_CASES[case]
    r = rng(11 + case)
    lm = _mask(r, lk) if masked else None
    rm = _mask(r, rk) if masked else None
    jl, tl = rel_pair(r, lk, lb, lm)
    jr, tr = rel_pair(r, rk, rb, rm)
    (jk, tk), (ja, ta) = _both(jk_name), _both(ak_name)
    want = jtra.fused_join_agg(jl, jr, jkl, jkr_, jk, gb, ja,
                               chunk=chunk)
    got = ttra.fused_join_agg(tl, tr, jkl, jkr_, tk, gb, ta, chunk=chunk)
    unfused = ttra.agg(ttra.join(tl, tr, jkl, jkr_, tk), gb, ta)
    for other in (got, unfused):
        assert other.rtype.key_shape == want.rtype.key_shape
        if want.mask is None:
            assert other.mask is None
            np.testing.assert_allclose(as_np(other), np.asarray(want.data),
                                       rtol=TOL, atol=TOL)
        else:
            np.testing.assert_array_equal(other.mask, want.mask)
            sel = want.mask
            np.testing.assert_allclose(as_np(other)[sel],
                                       np.asarray(want.data)[sel],
                                       rtol=TOL, atol=TOL)


def test_chunked_lowering_matches_the_reference_executor():
    """The streamed reduction against the tuple-at-a-time oracle of the
    port (``repro_torch.core.reference``) and of the JAX package."""
    r = rng(21)
    lm = _mask(r, (3, 4))
    jl, tl = rel_pair(r, (3, 4), (2, 5), lm)
    jr, tr = rel_pair(r, (4, 2), (5, 3))
    (jk, tk), (ja, ta) = _both("rowSum∘matMul"), _both("matAdd")
    got = ttra.fused_join_agg(tl, tr, (1,), (0,), tk, (0, 2), ta, chunk=2)
    mine = tref.agg(tref.join(_ref_dict(tl), _ref_dict(tr), (1,), (0,), tk),
                    (0, 2), ta)
    theirs = jref.agg(jref.join(_ref_dict(jl), _ref_dict(jr), (1,), (0,),
                                jk), (0, 2), ja)
    dense = _ref_dict(got)
    assert sorted(mine) == sorted(theirs) == sorted(dense)
    for k in mine:
        np.testing.assert_allclose(dense[k], mine[k], rtol=TOL, atol=TOL)
        np.testing.assert_allclose(mine[k], theirs[k], rtol=TOL, atol=TOL)


def test_chunk_auto_is_the_out_of_core_slice():
    """``chunk="auto"`` (the out-of-core slice's autotuner) on the chunked
    lowering: JAX's values, with and without a budget (a 1-slice budget
    gathers one slice a step)."""
    r = rng(22)
    jl, tl = rel_pair(r, (3, 4), (2, 5))
    jr, tr = rel_pair(r, (4, 5), (2, 5))
    args = ((1,), (0,), "matAdd", (0, 2), "elemMax")
    for budget in (None, 1):
        want = jtra.fused_join_agg(
            jl, jr, *args[:2], jkr.get_kernel(args[2]), args[3],
            jkr.get_kernel(args[4]), chunk="auto", budget=budget)
        got = ttra.fused_join_agg(
            tl, tr, *args[:2], tkr.get_kernel(args[2]), args[3],
            tkr.get_kernel(args[4]), chunk="auto", budget=budget)
        assert_rel_close(want, got, TOL)
