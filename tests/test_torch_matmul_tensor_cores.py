"""The matmul's tensor-core route on the CPU: its arithmetic and the train
gates that hold it (no JAX here).

The route (``ops.route`` → ``"tc"``: f32 with more than 16 rows and more
than 32 columns) splits each operand into two TF32 terms
(``tf32_split_kernel``, whose plain version is ``ref.tf32_split_ref``)
and sums three TF32 products in f32 on ``wgmma``.  Here: the split's plain
version (reconstruction, the 13 low bits, ties, K padding, the transpose,
views); a plain-torch model of 3×TF32 at the train path's X·W1 cut to N
512 (D 1600, H 2048) inside ``chip_smoke.py``'s z1 limit, and one TF32
product past it; and ``chip_smoke.py``'s step-1 gates (C6) on a small
FFNN step whose z1 is summed in another order than the plain run's: the
former gate (W1's first moment against the plain run everywhere) fails on
it, the repaired gates pass, and still fail on a z1 with one K block
dropped, on a gradient column scaled by 1.01 and on a sign flip where |z1|
exceeds its limit.
"""
import types

import numpy as np
import pytest
import torch

from _torch_helpers import chip_smoke, normal, rng
from repro_torch.core import from_tensor, to_tensor
from repro_torch.kernels.matmul import ops
from repro_torch.kernels.matmul.ref import tf32_round, tf32_split_ref

LOW13 = 0x1FFF


def _low_bits(t):
    return t.contiguous().view(torch.int32) & LOW13


# ------------------------------------------------------- the split pass
@pytest.mark.parametrize("scale", [1.0, 1e-30, 1e30])
@pytest.mark.parametrize("transpose", [False, True])
def test_split_reconstructs_x_within_2_to_the_minus_22(scale, transpose):
    """big + small = x to 2⁻²² of |x| (in f64), both terms TF32 (the 13
    low bits zero), K padded to a multiple of 32 with zeros."""
    x = torch.tensor(normal(rng(1), (37, 70))) * scale
    out = tf32_split_ref(x, ops.tc_kp(x.shape[1 - transpose]), transpose)
    m = x.t() if transpose else x
    assert tuple(out.shape) == (2, m.shape[0], 96 if not transpose else 64)
    k = m.shape[1]
    got = out[0, :, :k].double() + out[1, :, :k].double()
    assert bool(((got - m.double()).abs()
                 <= 2.0 ** -22 * m.double().abs()).all())
    assert not bool(_low_bits(out).any())
    assert not bool(out[:, :, k:].any())


def test_split_rounds_to_nearest_ties_away():
    """``cvt.rna``: the nearest TF32 value, a tie away from zero."""
    ulp = 2.0 ** -10
    x = torch.tensor([1 + ulp / 2, 1 + 3 * ulp / 2, -(1 + ulp / 2),
                      1 + ulp / 2 - 2.0 ** -23, 1 + ulp / 2 + 2.0 ** -23])
    want = torch.tensor([1 + ulp, 1 + 2 * ulp, -(1 + ulp), 1.0, 1 + ulp])
    assert torch.equal(tf32_round(x), want)


def test_split_op_reads_views_as_their_matrix_on_cpu():
    """The plain version splits the matrix a view stands for (the engine's
    blocked W1, rows 2 axes), K padded to ``ops.tc_kp`` (a multiple of
    32) as the kernel pads it; ``ops.tf32_split`` refuses a bf16 and a
    CPU tensor."""
    w = torch.tensor(normal(rng(2), (3, 5, 40, 36)))      # (db, hb, bd, bh)
    view = w.permute(0, 2, 1, 3)                          # (db, bd | hb, bh)
    dense = w.permute(0, 2, 1, 3).contiguous().reshape(120, 180)
    assert (ops.tc_kp(120), ops.tc_kp(180)) == (128, 192)
    got = tf32_split_ref(view.reshape(120, 180), ops.tc_kp(120),
                         transpose=True)
    assert got.shape == (2, 180, 128)
    assert torch.equal(got, tf32_split_ref(dense.t().contiguous(), 128))
    assert not got[:, :, 120:].any()
    assert torch.equal(tf32_split_ref(dense, ops.tc_kp(180)),
                       tf32_split_ref(dense, 192))
    with pytest.raises(ValueError, match="shorter than K"):
        tf32_split_ref(dense, 160)                        # K is 180
    with pytest.raises(TypeError, match="f32"):
        ops.tf32_split(dense.bfloat16())
    with pytest.raises(ValueError, match="CUDA"):
        ops.tf32_split(view, rows=2, transpose=True)
    with pytest.raises(ValueError, match="CUDA device"):
        ops.matmul(torch.zeros(17, 8), torch.zeros(8, 33), impl="kernel")


# ------------------------------------------- 3xTF32 against the z1 gate
@pytest.mark.parametrize("terms", [3, 1])
def test_three_tf32_products_meet_the_z1_gate(terms):
    """z1 = X·W1 at the train path's widths cut to N 512 (D 1600, H 2048;
    X normal, W1 scaled by D^-1/2, as ``chip_smoke.train_problem`` draws
    them): three TF32 products, small·big + big·small + big·big summed in
    f32, lie within ``chip_smoke.py``'s z1 limit (``tolerance(1600,
    f32)``) of the f64 product; one, big·big, crosses it."""
    smoke = chip_smoke()
    r = rng(24)
    x = torch.tensor(normal(r, (512, 1600)))
    w1 = torch.tensor(normal(r, (1600, 2048))) * 1600 ** -0.5
    a2, b2 = tf32_split_ref(x, 1600), tf32_split_ref(w1, 1600, True)
    if terms == 3:
        z = a2[1] @ b2[0].t()
        z += a2[0] @ b2[1].t()
        z += a2[0] @ b2[0].t()
    else:
        z = a2[0] @ b2[0].t()
    exact = x.double() @ w1.double()
    got = smoke.held("z1 model", z, exact, 1600, gate=False)
    if terms == 3:
        assert got["values_over"] == 0 and got["worst_share_of_limit"] < 0.1
    else:
        assert got["values_over"] > 0


# ------------------------------------------------- C6: the step-1 gates
# N large enough that a gradient column's largest value stands ~20x above
# what one relu' flip moves it by: then a 1% error of the column is past
# the limit while a flip leaves AdamW's gated signs alone
N, D, H, L = 4096, 48, 40, 10
# columns whose z1 in one row is 0 in exact arithmetic, so that two f32
# sum orders can give it either sign
ZERO_COLS = 24


def _problem():
    """X, Y, W1, W2 (f32) of a small FFNN step; W2 scaled so that a relu'
    flip moves W1's first moment past the plain gate's limit but its
    gradient by less than AdamW's gate."""
    r = rng(6)
    x = normal(r, (N, D)).astype(np.float64)
    w1 = normal(r, (D, H)).astype(np.float64) * D ** -0.5
    for j in range(ZERO_COLS):
        xi = x[j % N]
        w1[:, j] -= (xi @ w1[:, j]) / (xi @ xi) * xi
    y = 1.0 / (1.0 + np.exp(-normal(r, (N, L))))
    w2 = normal(r, (H, L)) * 8e-3
    return {k: torch.tensor(np.asarray(v, np.float32)) for k, v in
            (("X", x), ("Y", y), ("W1", w1), ("W2", w2))}


def _reordered(x, w1, drop_block=False):
    """X·W1 in f32 summed over K in blocks of 8, last block first (the
    first block left out with ``drop_block``)."""
    z = torch.zeros(x.shape[0], w1.shape[1])
    for k0 in range(x.shape[1] - 8, 0 if drop_block else -1, -8):
        z = z + x[:, k0:k0 + 8] @ w1[k0:k0 + 8]
    return z


def _step(dense, z1, lr):
    """One AdamW step of the dense FFNN in f32 from a given z1, as the
    trainer's outputs (relations): the loss, W1', W2' and the moments."""
    smoke = chip_smoke()
    x, y, w1, w2 = (dense[k] for k in ("X", "Y", "W1", "W2"))
    a1 = z1.clamp_min(0.0)
    a2 = torch.sigmoid(a1 @ w2)
    pc = a2.clamp(1e-7, 1.0 - 1e-7)
    loss = -(y * torch.log(pc) + (1.0 - y) * torch.log1p(-pc)).sum()
    dz2 = a2 - y
    g = {"W1": x.t() @ ((dz2 @ w2.t()) * (z1 > 0)), "W2": a1.t() @ dz2}
    tiles = {"W1": (D // 2, H // 2), "W2": (H // 2, L)}
    out = {"loss": loss.item()}
    for name, w in (("W1", w1), ("W2", w2)):
        for key, v in ((name, smoke.adamw_first_update(w, g[name], lr)),
                       (f"{name}.m", 0.1 * g[name]),
                       (f"{name}.v", 0.001 * g[name] * g[name])):
            out[key] = from_tensor(v.contiguous(), tiles[name])
    return out


@pytest.fixture(scope="module")
def c6():
    dense = _problem()
    z1 = _reordered(dense["X"], dense["W1"])
    z1_plain = dense["X"] @ dense["W1"]
    flips = (z1 > 0) != (z1_plain > 0)
    assert int(flips.sum()) > 0
    lr = chip_smoke().CHECK_LR
    return {"dense": dense, "z1": z1, "z1_plain": z1_plain,
            "flip_cols": flips.any(0), "first": _step(dense, z1, lr),
            "plain": _step(dense, z1_plain, lr),
            "cfg": types.SimpleNamespace(d_in=D, d_hidden=H, batch=N)}


def _checks(c, first=None, z1=None, z1_plain=None):
    smoke = chip_smoke()
    ref = smoke.dense_f64_step(c["dense"], c["z1"] if z1 is None else z1,
                               c["z1_plain"] if z1_plain is None else
                               z1_plain)
    return ref, smoke.train_checks(first or c["first"], c["plain"], ref,
                                   c["dense"], c["cfg"], "", adam=True)


def test_c6_former_plain_gate_fails_on_a_z1_summed_in_another_order(c6):
    """W1's first moment against the plain run everywhere — the gate
    before the repair — fails on rounding alone: where a z1 within
    rounding of 0 takes the other sign, relu' flips for the whole hidden
    unit's gradient column."""
    with pytest.raises(SystemExit):
        chip_smoke().held("W1.m vs plain", to_tensor(c6["first"]["W1.m"]),
                          to_tensor(c6["plain"]["W1.m"]), N)


def test_c6_repaired_gates_pass_on_a_z1_summed_in_another_order(c6):
    """Against f64 with the step's own relu mask everywhere, against the
    plain run outside the columns where the two z1 differ in sign; the
    flips are counted and each lies within the z1 limit of 0."""
    ref, checks = _checks(c6)
    assert ref["sign_flips_vs_plain"] > 0
    assert torch.equal(ref["flips"], c6["flip_cols"])
    assert checks["W1.m_vs_f64"]["values_over"] == 0
    assert checks["W1.m_vs_plain_in_flip_columns"]["values_over"] > 0


def test_c6_gates_fail_on_a_dropped_k_block(c6):
    with pytest.raises(SystemExit):
        _checks(c6, z1=_reordered(c6["dense"]["X"], c6["dense"]["W1"],
                                  drop_block=True))


def test_c6_gates_fail_on_a_gradient_column_scaled_by_1_01(c6):
    """A column of W1's first moment 1% off, in a column the plain gate
    leaves out (a flip column, its largest moment): the f64 gate still
    holds it."""
    m = to_tensor(c6["first"]["W1.m"]).clone()
    col = int((m.abs() * c6["flip_cols"]).max(0).values.argmax())
    assert bool(c6["flip_cols"][col])
    m[:, col] *= 1.01
    first = {**c6["first"], "W1.m": from_tensor(m, (D // 2, H // 2))}
    with pytest.raises(SystemExit):
        _checks(c6, first=first)


def test_c6_gates_fail_on_a_sign_flip_past_the_limit(c6):
    """The plain run's z1 with one sign turned where |z1| is far from 0:
    a flip the z1 limit does not excuse."""
    z1_plain = c6["z1_plain"].clone()
    i, j = divmod(int(z1_plain.abs().argmax()), H)
    z1_plain[i, j] = -z1_plain[i, j]
    with pytest.raises(SystemExit):
        _checks(c6, z1_plain=z1_plain)
