"""Port parity: plan IR, cost model and optimizer.

The optimized physical plans of the scorer program and of BMM/CPMM-shaped
``Expr``\\ s print identically (``describe()``), their ``cost_plan`` comm
floats and flops are equal, and the scorer's plan choice matches JAX: the
tied unfused ``LocalJoin``+``LocalAgg`` pair at ``db = hb = 2``, two
``FusedJoinAgg`` nodes at ``db = hb = 4`` (and at the speech-100k blocking
served on the card) — where the port's ``_fused_matmul_2d`` then runs
twice per dispatch.
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

import repro.core as jcore  # noqa: E402
import repro.core.expr as jE  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
import repro_torch.core.expr as tE  # noqa: E402
import repro_torch.core.tra as ttra  # noqa: E402
from _torch_helpers import CPU, scorer_program  # noqa: E402


def _fused_count(plan, mod):
    from importlib import import_module
    P = import_module(f"{mod}.core.plan")
    return sum(isinstance(n, P.FusedJoinAgg) for n in P.postorder(plan))


SCORER_BLOCKINGS = [
    (8, 2, 2, 1, 8, 8, 4),            # FFNNScorer() default: tie → unfused
    (8, 4, 4, 1, 8, 8, 4),            # db = hb = 4: both products fused
    (3, 3, 3, 1, 8, 8, 4),
    (8, 4, 10, 1, 400, 10000, 10),    # speech-100k, as served on the card
]


@pytest.mark.parametrize("blocking", SCORER_BLOCKINGS)
def test_scorer_plan_parity(blocking):
    jopt = jcore.optimize(scorer_program(jE, *blocking))
    topt = tcore.optimize(scorer_program(tE, *blocking))
    assert tcore.describe(topt.plan) == jcore.describe(jopt.plan)
    assert topt.cost == jopt.cost
    assert topt.logical_variants_tried == jopt.logical_variants_tried
    jc = jcore.cost_plan(jopt.plan, {"sites": 1})
    tc = tcore.cost_plan(topt.plan, {"sites": 1})
    assert (tc.comm_floats, tc.flops, tc.tmp_floats) == \
        (jc.comm_floats, jc.flops, jc.tmp_floats)
    want = 0 if blocking[1] == 2 else 2
    assert _fused_count(jopt.plan, "repro") == want
    assert _fused_count(topt.plan, "repro_torch") == want


def _bmm(mod):
    a = mod.input("A", (4, 4), (16, 24))
    b = mod.input("B", (4, 4), (24, 12))
    return a @ b


@pytest.mark.parametrize("placements", [
    {},                                                     # replicated
    {"A": ("partitioned", (0,), ("sites",))},               # BMM
    {"A": ("partitioned", (1,), ("sites",)),
     "B": ("partitioned", (0,), ("sites",))},               # CPMM
])
@pytest.mark.parametrize("accounting", ["wire", "paper"])
def test_matmul_plans_and_costs(placements, accounting):
    """BMM / CPMM-shaped programs on a 4-site axis: identical optimized
    plans and identical comm / flop costs."""
    plans = []
    for core, E in ((jcore, jE), (tcore, tE)):
        pl = {k: core.Placement(kind, dims, axes)
              for k, (kind, dims, axes) in placements.items()}
        opt = core.optimize(_bmm(E), pl, axis_sizes={"sites": 4},
                            accounting=accounting)
        rep = core.cost_plan(opt.plan, {"sites": 4}, accounting)
        plans.append((core.describe(opt.plan), opt.cost, rep.comm_floats,
                      rep.flops, opt.candidates))
    assert plans[1] == plans[0]


def test_table1_compile_and_fusion_rewrite():
    jd = jcore.compile_tra(_bmm(jE))
    td = tcore.compile_tra(_bmm(tE))
    assert tcore.describe(td) == jcore.describe(jd)
    assert tcore.describe(tcore.fuse_join_agg(td)) == \
        jcore.describe(jcore.fuse_join_agg(jd))


def test_h100_hardware_model():
    hw = tcore.H100_SXM
    assert hw.peak_flops == 989e12 and hw.hbm_bw == 3.35e12
    rep = tcore.cost_plan(tcore.optimize(_bmm(tE)).plan, {"sites": 1})
    assert rep.compute_seconds(hw) == pytest.approx(rep.flops / 989e12)


@pytest.mark.parametrize("executor", ["reference", "jit"])
def test_fused_matmul_runs_twice_per_dispatch(executor, monkeypatch):
    """At db = hb = 4 every scorer dispatch reaches ``_fused_matmul_2d``
    (the matmul kernel's caller) exactly twice; at db = hb = 2 never."""
    from repro_torch.serve import FFNNScorer
    calls = []
    real = ttra._fused_matmul_2d

    def counting(*args, **kw):
        calls.append(1)
        return real(*args, **kw)

    monkeypatch.setattr(ttra, "_fused_matmul_2d", counting)
    for (db, hb), per_dispatch in (((4, 4), 2), ((2, 2), 0)):
        sc = FFNNScorer(db=db, hb=hb, device="cpu")
        eng = tcore.Engine(executor=executor, device=CPU)
        rng = np.random.default_rng(0)
        for n in (1, 3, 8):
            calls.clear()
            payloads = [sc.random_payload(rng) for _ in range(n)]
            b = min(x for x in sc.buckets if x >= n)
            eng.run(sc.program(b)["scores"], **sc.pack(payloads, b),
                    **sc.weights())
            assert len(calls) == per_dispatch
