"""Port parity: the static plan verifier (``repro_torch.analysis``).

Every test of ``tests/test_analysis.py`` has its counterpart here, fed the
same programs from ``programs.*`` on both sides, and where the JAX test
reads diagnostics the port's are held equal to JAX's: the same
(pass, severity, node id, node label, message, hint) in the same order,
with the package name ``repro_torch.`` read as ``repro.`` and nothing
else loosened.  Also:

* the diagnostics of every program of the lint corpus under every pass,
  and the ``nid:Label`` provenance of every node (``label_nodes``), equal
  to JAX's;
* the streaming pass against the port's ``StreamExecutor.plan`` over
  programs × budgets (errors exactly where ``plan`` finds no streaming
  schedule), the rung-1 ``force`` case included;
* the engine: an unknown mode, the ``REPRO_VALIDATE`` default, strict
  rejecting a corrupted plan, warn compiling with one ``RuntimeWarning``,
  off silent, one verification per cache miss, the enriched streamed
  refusal (also through the ``degrade`` ladder), and the input-validation
  texts equal to JAX's;
* ``python -m repro_torch.analysis.lint --device cpu``: exit 0 and the
  same per-program status lines as ``python -m repro.analysis.lint``.

The JAX side verifies plans (pure Python walks) and compiles one engine
program, the strict train step, whose diagnostics it compares; its lint
run is made once per module.
"""
import contextlib
import dataclasses
import functools
import io
import itertools
import warnings

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

import repro.analysis as ja  # noqa: E402
import repro.core.programs as jprog  # noqa: E402
import repro_torch.analysis as ta  # noqa: E402
import repro_torch.core.programs as tprog  # noqa: E402
from _torch_helpers import CPU  # noqa: E402
from repro.core import plan as JP  # noqa: E402
from repro.core.tra import RelType as JRelType  # noqa: E402
from repro_torch.analysis import (ALL_PASSES, DEFAULT_COMPILE_PASSES,  # noqa: E402,E501
                                  Diagnostic, Diagnostics, PassManager,
                                  PlanVerificationError, verify_plans)
from repro_torch.core import plan as TP  # noqa: E402
from repro_torch.core.engine import Engine, plan_sig  # noqa: E402
from repro_torch.core.kernels_registry import get_kernel  # noqa: E402
from repro_torch.core.plan import (Bcast, IAInput, LocalJoin,  # noqa: E402
                                   Placement, TraReKey, as_node)
from repro_torch.core.tra import RelType  # noqa: E402

# §5.1 shapes: key grids divisible by the 4-site mesh
MM = ((8, 4), (4, 8), (16, 16), (16, 16))
SITES = {"sites": 4}


# ==========================================================================
# parity helpers
# ==========================================================================

def _pkg(text: str) -> str:
    return text.replace("repro_torch.", "repro.")


def _key(d):
    return (d.pass_name, d.severity, d.node_id, d.node_label,
            _pkg(d.message), _pkg(d.hint))


def same_diags(port, jax_diags):
    """The port's diagnostics equal JAX's, item for item."""
    assert [_key(d) for d in port] == [_key(d) for d in jax_diags]
    return port


def both(fn, *args, **kw):
    """``fn`` of the port's and of JAX's ``repro*.analysis`` module of the
    same name, on the same arguments built per side by ``args`` callables
    ``(side) -> value``."""
    def built(side):
        return ([a(side) if callable(a) else a for a in args],
                {k: v(side) if callable(v) else v for k, v in kw.items()})
    targs, tkw = built("torch")
    jargs, jkw = built("jax")
    return fn("torch")(*targs, **tkw), fn("jax")(*jargs, **jkw)


def prog(side):
    return tprog if side == "torch" else jprog


def plan_mod(side):
    return TP if side == "torch" else JP


def rtype(side, *a):
    return (RelType if side == "torch" else JRelType)(*a)


def verify(side):
    return (ta if side == "torch" else ja).verify_plans


def verified(build, **kw):
    """Port and JAX ``verify_plans`` of ``build(side)``, held equal."""
    port, jx = both(verify, build, **kw)
    return same_diags(port, jx)


def _over_budget_matmul(side="torch"):
    from repro.core.cost import plan_peak_bytes as jpeak
    from repro_torch.core.cost import plan_peak_bytes as tpeak
    peak = tpeak if side == "torch" else jpeak
    p = plan_mod(side)
    root = p.as_node(prog(side).matmul_tra((8, 2), (2, 2), (16, 16),
                                           (16, 16)))
    return root, int(peak(root) * 0.6)


# ==========================================================================
# diagnostics vocabulary
# ==========================================================================

def test_diagnostic_render_snapshot():
    d = Diagnostic("placement", "error", "the aggregation is wrong",
                   7, "7:LocalAgg[matAdd]", "use partial=True")
    assert d.render() == (
        "[placement] error at node 7:LocalAgg[matAdd]: "
        "the aggregation is wrong\n"
        "    hint: use partial=True")
    assert Diagnostic("memory", "info", "fits").render() == \
        "[memory] info: fits"
    assert d.render() == ja.Diagnostic(
        "placement", "error", "the aggregation is wrong", 7,
        "7:LocalAgg[matAdd]", "use partial=True").render()


def test_diagnostics_collection_views_and_render_footer():
    outs = []
    for mod in (ta, ja):
        ds = mod.Diagnostics()
        ds.add("placement", "error", "bad")
        ds.add("streaming", "warning", "meh")
        ds.add("memory", "info", "ok")
        assert len(ds) == 3 and bool(ds)
        assert [d.severity for d in ds.errors] == ["error"]
        assert [d.pass_name for d in ds.by_pass("streaming")] == \
            ["streaming"]
        out = ds.render(min_severity="warning")
        assert "bad" in out and "meh" in out and "ok" not in out
        assert out.endswith("-- 1 error(s), 1 warning(s), 1 info(s)")
        assert mod.Diagnostics().render() == "no diagnostics"
        outs.append(out)
    assert outs[0] == outs[1]


def test_diagnostic_rejects_unknown_severity():
    with pytest.raises(ValueError, match="severity"):
        Diagnostic("placement", "fatal", "boom")


def test_plan_verification_error_is_value_error_and_carries_diags():
    ds = Diagnostics()
    ds.add("placement", "error", "bad")
    with pytest.raises(ValueError) as ei:
        ds.raise_if_errors()
    assert isinstance(ei.value, PlanVerificationError)
    assert ei.value.diagnostics is ds
    assert "1 error(s)" in str(ei.value)
    jds = ja.Diagnostics()
    jds.add("placement", "error", "bad")
    assert str(ei.value) == str(ja.PlanVerificationError(jds))


def test_pass_manager_rejects_unknown_pass():
    with pytest.raises(ValueError, match="unknown verifier pass"):
        PassManager(("placement", "no-such-pass"))
    assert "cachekey" in ALL_PASSES
    assert "cachekey" not in DEFAULT_COMPILE_PASSES
    assert (ALL_PASSES, DEFAULT_COMPILE_PASSES) == \
        (ja.ALL_PASSES, ja.DEFAULT_COMPILE_PASSES)


# ==========================================================================
# placement / exchange soundness
# ==========================================================================

def test_placement_clean_on_valid_cpmm():
    diags = verified(lambda s: prog(s).cpmm_plan(*MM), executor="shard_map",
                     axis_sizes=SITES, passes=("placement",))
    assert not diags.errors


def test_placement_rejects_r24_violation_naming_the_node():
    diags = verified(lambda s: prog(s).bmm_plan(*MM), executor="shard_map",
                     axis_sizes=SITES, passes=("placement",))
    assert diags.errors
    d = diags.errors[0]
    assert "LocalAgg" in d.node_label and d.node_id >= 0
    assert "reduces away partitioned key dims" in d.message
    assert "R2-4" in d.message
    assert "partial=True" in d.hint


def test_placement_downgrades_to_warning_on_host_executors():
    diags = verified(lambda s: prog(s).bmm_plan(*MM), executor="jit",
                     axis_sizes=SITES, passes=("placement",))
    assert not diags.errors
    assert any("reduces away partitioned" in d.message
               for d in diags.warnings)


def _ghost_input(side, key_shape=(4, 4), bound=(8, 8), axis="ghost",
                 **dup):
    p = plan_mod(side)
    return p.IAInput("A", rtype(side, key_shape, bound),
                     p.Placement.partitioned((0,), (axis,), **dup))


def test_placement_rejects_unknown_mesh_axis():
    diags = verified(_ghost_input, executor="shard_map", axis_sizes=SITES,
                     passes=("placement",))
    assert any("mesh axis 'ghost'" in d.message for d in diags.errors)


def test_placement_rejects_root_duplicates_off_shard_map():
    diags = verified(lambda s: prog(s).cpmm_fused_plan(*MM),
                     executor="gspmd", axis_sizes=SITES,
                     passes=("placement",))
    assert not diags.errors
    diags = verified(lambda s: prog(s).cpmm_fused_plan(*MM).child,
                     executor="gspmd", axis_sizes=SITES,
                     passes=("placement",))
    assert any("partial duplicates" in d.message for d in diags.errors)


# ==========================================================================
# collective-consistency (race) detector
# ==========================================================================

def test_collectives_schedule_of_cpmm_two_phase():
    from repro.analysis.collectives import collective_schedule as jcs
    from repro_torch.analysis.collectives import collective_schedule
    sched = collective_schedule(tprog.cpmm_two_phase_plan(*MM), SITES)
    assert [op.kind for op in sched] == ["psum_scatter"]
    assert sched[0].axis == "sites" and "Shuf" in sched[0].node_label
    want = jcs(jprog.cpmm_two_phase_plan(*MM), SITES)
    assert [dataclasses.astuple(op) for op in sched] == \
        [dataclasses.astuple(op) for op in want]


def _dup_bcast(kernel):
    def build(side):
        return plan_mod(side).Bcast(_ghost_input(
            side, axis="x", dup_axes=("y",), dup_kernel=kernel))
    return build


def test_collectives_rejects_unknown_reducer_naming_the_node():
    diags = verified(_dup_bcast("noSuchKernel"), executor="shard_map",
                     axis_sizes={"x": 2, "y": 2}, passes=("collectives",))
    assert any("unknown kernel 'noSuchKernel'" in d.message
               for d in diags.errors)
    assert all(d.node_label for d in diags.errors)


def test_collectives_rejects_nonassociative_reducer():
    diags = verified(_dup_bcast("matMul"), executor="shard_map",
                     axis_sizes={"x": 2, "y": 2}, passes=("collectives",))
    assert any("non-associative kernel 'matMul'" in d.message
               for d in diags.errors)


def _ghost_shuf(side):
    a = _ghost_input(side, (8, 4), (4, 4), axis="sites")
    return plan_mod(side).Shuf(a, (1,), ("ghost",))


def test_collectives_rejects_ghost_axis_exchange():
    diags = verified(_ghost_shuf, executor="shard_map", axis_sizes=SITES,
                     passes=("collectives",))
    assert any("mesh axis 'ghost'" in d.message and "Shuf" in d.node_label
               for d in diags.errors)


def test_collectives_downgraded_on_host_executors():
    diags = verified(_ghost_shuf, executor="jit", axis_sizes=SITES,
                     passes=("collectives",))
    assert not diags.errors
    assert any("mesh axis 'ghost'" in d.message for d in diags.warnings)


def test_site_schedule_alignment_detects_hang_and_divergence():
    from repro.analysis import collectives as jc
    from repro_torch.analysis import collectives as tc

    def run(mod):
        ag = mod.CollectiveOp("all_gather", "sites", None, 3, "3:Bcast")
        ar = mod.CollectiveOp("all_reduce", "sites", "matAdd", 5, "5:Shuf")
        ar2 = mod.CollectiveOp("all_reduce", "sites", "elemMax", 5,
                               "5:Shuf")
        return (mod.check_site_schedules([[ag, ar]] * 4),
                mod.check_site_schedules([[ag, ar], [ag]]),
                mod.check_site_schedules([[ag, ar], [ag, ar2]]))

    aligned, short, diverged = run(tc)
    assert not aligned.errors
    assert any("blocks forever (hang)" in d.message for d in short.errors)
    assert any("diverge at position 1" in d.message
               for d in diverged.errors)
    for port, jx in zip((aligned, short, diverged), run(jc)):
        same_diags(port, jx)


# ==========================================================================
# stream-carrier legality
# ==========================================================================

def _budgeted(wrap=None, budget=None):
    def build(side):
        root, b = _over_budget_matmul(side)
        return wrap(side, root) if wrap else root
    kw = {}
    if budget != "none":
        kw["memory_budget"] = budget if budget is not None \
            else _over_budget_matmul()[1]
    return build, kw


def _rekey(side, root):
    return plan_mod(side).TraReKey(root, lambda k: k)


def test_streaming_legal_plan_gets_info_not_errors():
    build, kw = _budgeted()
    diags = verified(build, executor="jit", passes=("streaming",), **kw)
    assert not diags.errors
    assert any("is legal" in d.message for d in diags)


def test_streaming_fits_resident_is_info():
    build, kw = _budgeted(budget=1 << 30)
    diags = verified(build, executor="jit", passes=("streaming",), **kw)
    assert not diags.errors
    assert any("fits resident" in d.message for d in diags)


def test_streaming_rejects_rekey_naming_the_node():
    build, kw = _budgeted(_rekey)
    diags = verified(build, executor="jit", passes=("streaming",), **kw)
    assert diags.errors
    d = diags.errors[0]
    assert "TraReKey" in d.node_label
    assert "rewrites the key space" in d.message
    assert "resident" in d.hint


def test_streaming_silent_without_budget():
    build, kw = _budgeted(_rekey, budget="none")
    diags = verified(build, executor="jit", passes=("streaming",), **kw)
    assert not len(diags)


def _stream_corpus(side):
    """Single-root logical programs of ``programs`` and around them."""
    p, E = prog(side), prog(side).E
    mm = p.matmul_tra((8, 2), (2, 2), (16, 16), (16, 16))
    fwd = p._ffnn_forward(4, 2, 4, 1, 4, 8, 8, 4)
    chain = (E.input("A", (6, 2), (4, 4)) @ E.input("B", (2, 3), (4, 4))
             ) @ E.input("C", (3, 2), (4, 4))
    pm = plan_mod(side)
    return {"matmul": pm.as_node(mm),
            "ffnn-z2": pm.as_node(fwd[5]),
            "ffnn-a2": pm.as_node(fwd[6]),
            "chain": pm.as_node(chain),
            "rekey": pm.TraReKey(pm.as_node(mm), lambda k: k),
            "filter": pm.as_node(mm.filter(lambda k: True))}


STREAM_CASES = list(itertools.product(
    ("matmul", "ffnn-z2", "ffnn-a2", "chain", "rekey", "filter"),
    (0.05, 0.3, 0.6, 1.5)))


@pytest.mark.parametrize("name,frac", STREAM_CASES,
                         ids=[f"{n}-{f}" for n, f in STREAM_CASES])
def test_streaming_pass_agrees_with_stream_executor(name, frac):
    """Errors exactly where ``StreamExecutor.plan`` finds no streaming
    schedule for an over-budget plan (a plan with a key rewrite or a mask
    plans resident there, and refuses outright under rung 1's ``force``);
    none for a plan that fits; the same diagnostics as JAX's."""
    from repro.analysis.streaming import explain_unstreamable as jexplain
    from repro_torch.analysis.streaming import explain_unstreamable
    from repro_torch.core.cost import plan_peak_bytes
    from repro_torch.store import NotStreamable, StreamExecutor
    root = _stream_corpus("torch")[name]
    budget = max(1, int(plan_peak_bytes(root) * frac))
    diags = explain_unstreamable(root, budget=budget)
    same_diags(diags, jexplain(_stream_corpus("jax")[name], budget=budget))
    se = StreamExecutor(Engine(device=CPU, memory_budget=budget))
    try:
        mode = se.plan(root).mode
    except NotStreamable:
        mode = None
    fits = plan_peak_bytes(root) <= budget
    assert bool(diags.errors) == (not fits and mode in (None, "resident"))
    if fits:
        assert mode == "resident"
    try:
        se.plan(root, force=True)
    except NotStreamable:
        assert diags.errors or fits


# ==========================================================================
# memory-model audit
# ==========================================================================

def test_memory_model_agrees_on_corpus_programs():
    from repro.core.cost import plan_peak_bytes as jpeak
    from repro_torch.analysis.memory import (audit_memory_model,
                                             independent_peak_bytes)
    from repro_torch.core.cost import plan_peak_bytes
    step = tprog.ffnn_train_step_tra(2, 2, 2, 1, 4, 4, 4, 4)
    roots = tuple(as_node(r) for r in step.roots.values())
    assert not audit_memory_model(roots).errors
    assert independent_peak_bytes(roots) == plan_peak_bytes(roots)
    jstep = jprog.ffnn_train_step_tra(2, 2, 2, 1, 4, 4, 4, 4)
    assert plan_peak_bytes(roots) == jpeak(
        tuple(JP.as_node(r) for r in jstep.roots.values()))
    mm = as_node(tprog.matmul_tra(*MM))
    assert not audit_memory_model(mm).errors


def test_memory_model_divergence_is_an_error():
    from repro.analysis.memory import audit_memory_model as jaudit
    from repro_torch.analysis.memory import audit_memory_model
    root = as_node(tprog.matmul_tra(*MM))
    jroot = JP.as_node(jprog.matmul_tra(*MM))
    for peak, word in ((0, "under-estimate"), (1 << 60, "over-estimate")):
        diags = audit_memory_model(root, estimator=lambda r, fuse=True:
                                   peak)
        same_diags(diags, jaudit(jroot, estimator=lambda r, fuse=True:
                                 peak))
        assert any("memory model divergence" in d.message
                   and word in d.message for d in diags.errors)


def test_memory_model_invariant_largest_relation_names_node(monkeypatch):
    import repro.analysis.memory as jmem
    import repro_torch.analysis.memory as mem
    for mod in (mem, jmem):
        monkeypatch.setattr(mod, "independent_peak_bytes",
                            lambda roots, fuse=True: 8)
    diags = mem.audit_memory_model(as_node(tprog.matmul_tra(*MM)),
                                   estimator=lambda r, fuse=True: 8)
    assert any("largest single relation" in d.message and d.node_label
               for d in diags.errors)
    assert any("sum of root outputs" in d.message for d in diags.errors)
    same_diags(diags, jmem.audit_memory_model(
        JP.as_node(jprog.matmul_tra(*MM)), estimator=lambda r, fuse=True:
        8))


# ==========================================================================
# cache-key injectivity fuzzing + plan_sig hardening regressions
# ==========================================================================

FUZZ_PLANS = {"matmul": lambda s: plan_mod(s).as_node(
                  prog(s).matmul_tra(*MM)),
              "cpmm-fused": lambda s: prog(s).cpmm_fused_plan(*MM),
              "bmm": lambda s: prog(s).bmm_plan(*MM)}


@pytest.mark.parametrize("name", sorted(FUZZ_PLANS))
def test_fuzzer_clean_on_hardened_plan_sig(name):
    from repro.analysis.cachekey import check_sig_injectivity as jcheck
    from repro_torch.analysis.cachekey import check_sig_injectivity
    port = check_sig_injectivity(FUZZ_PLANS[name]("torch"))
    assert not port.errors
    same_diags(port, jcheck(FUZZ_PLANS[name]("jax")))


def test_fuzzer_finds_out_bound_collision_under_old_kernel_sig(monkeypatch):
    """The port's ``_kernel_sig`` cut down to ``(name, id(apply))`` — the
    signature the JAX package's fuzzer caught — loses ``out_bound``."""
    import repro.core.engine as jeng
    import repro_torch.core.engine as eng_mod
    from repro.analysis.cachekey import check_sig_injectivity as jcheck
    from repro_torch.analysis.cachekey import check_sig_injectivity
    for mod in (eng_mod, jeng):
        monkeypatch.setattr(mod, "_kernel_sig",
                            lambda k: (k.name, id(k.apply)))
    diags = check_sig_injectivity(tprog.cpmm_fused_plan(*MM))
    assert any("out_bound" in d.message and "collision" in d.message
               for d in diags.errors)
    assert all("plan_sig" in d.hint for d in diags.errors)
    same_diags(diags, jcheck(jprog.cpmm_fused_plan(*MM)))


def test_plan_sig_observes_dup_kernel():
    rt = RelType((4, 4), (8, 8))

    def mk(red):
        return Bcast(IAInput("A", rt, Placement.partitioned(
            (0,), ("x",), dup_axes=("y",), dup_kernel=red)))

    assert plan_sig(mk("matAdd")) != plan_sig(mk("elemMax"))


def test_plan_sig_observes_out_bound_content():
    k = get_kernel("matMul")
    shadow = dataclasses.replace(
        k, out_bound=lambda *bounds: tuple(k.out_bound(*bounds)))
    a = IAInput("A", RelType((4, 4), (8, 8)), Placement.replicated())
    b = IAInput("B", RelType((4, 4), (8, 8)), Placement.replicated())
    assert plan_sig(LocalJoin(a, b, (1,), (0,), k)) != \
        plan_sig(LocalJoin(a, b, (1,), (0,), shadow))


def test_code_fingerprint_separates_bodies_not_identities():
    from repro_torch.core.engine import _code_fp
    f1 = lambda x: x + 1  # noqa: E731
    f2 = lambda x: x + 2  # noqa: E731
    f3 = lambda x: x + 1  # noqa: E731
    assert _code_fp(f1) != _code_fp(f2)
    assert _code_fp(f1) == _code_fp(f3)
    assert _code_fp(f1) == _code_fp(f1)


def test_mutation_enumeration_covers_every_node():
    from repro.analysis.cachekey import plan_mutations as jmut
    from repro_torch.analysis.cachekey import plan_mutations
    root = tprog.cpmm_fused_plan(*MM)
    muts = list(plan_mutations(root))
    assert len(muts) >= 6
    assert all(m is not root for _, _, m in muts)
    assert [w for w, _, _ in muts] == \
        [w for w, _, _ in jmut(jprog.cpmm_fused_plan(*MM))]


FUZZ_SHAPES = [(1, 1, 1), (1, 4, 2), (2, 3, 4), (3, 1, 3), (4, 2, 1),
               (4, 4, 4)]


@pytest.mark.parametrize("fa,fk,fb", FUZZ_SHAPES)
def test_fuzz_smoke_shapes(fa, fk, fb):
    """The JAX test draws these frontiers with hypothesis; here a fixed
    spread of them, each clean on both sides."""
    from repro.analysis.cachekey import check_sig_injectivity as jcheck
    from repro_torch.analysis.cachekey import check_sig_injectivity

    def root(side):
        return plan_mod(side).as_node(prog(side).matmul_tra(
            (fa, fk), (fk, fb), (4, 4), (4, 4)))

    port = check_sig_injectivity(root("torch"))
    assert not port.errors
    same_diags(port, jcheck(root("jax")))


# ==========================================================================
# Engine integration: validate="off" | "warn" | "strict"
# ==========================================================================

def test_engine_rejects_unknown_validate_mode():
    with pytest.raises(ValueError, match="unknown validate mode"):
        Engine(validate="bogus", device=CPU)


def test_engine_validate_default_from_env(monkeypatch):
    monkeypatch.setenv("REPRO_VALIDATE", "strict")
    assert Engine(device=CPU).validate == "strict"
    monkeypatch.delenv("REPRO_VALIDATE")
    assert Engine(device=CPU).validate == "warn"


def test_engine_strict_rejects_corrupted_plan():
    root, budget = _over_budget_matmul()
    eng = Engine(executor="jit", memory_budget=budget, validate="strict",
                 device=CPU)
    with pytest.raises(PlanVerificationError) as ei:
        eng.compile(TraReKey(root, lambda k: k))
    assert "TraReKey" in str(ei.value)
    assert ei.value.diagnostics.errors
    assert eng.last_diagnostics is ei.value.diagnostics


def test_engine_warn_compiles_anyway_with_one_runtime_warning():
    root, budget = _over_budget_matmul()
    eng = Engine(executor="jit", memory_budget=budget, validate="warn",
                 device=CPU)
    with warnings.catch_warnings(record=True) as log:
        warnings.simplefilter("always")
        compiled = eng.compile(TraReKey(root, lambda k: k))
    msgs = [str(w.message) for w in log
            if issubclass(w.category, RuntimeWarning)]
    assert len(msgs) == 1 and msgs[0].startswith("plan verification found")
    assert "TraReKey" in msgs[0]
    assert eng.last_diagnostics is not None
    assert eng.last_diagnostics.errors
    assert compiled.executor == "jit"


def test_engine_off_is_silent():
    root, budget = _over_budget_matmul()
    eng = Engine(executor="jit", memory_budget=budget, validate="off",
                 device=CPU)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        eng.compile(TraReKey(root, lambda k: k))
    assert eng.last_diagnostics is None


@functools.lru_cache(maxsize=1)
def _jax_strict_train_step_diags():
    from repro.core.engine import Engine as JEngine
    eng = JEngine(executor="jit", validate="strict")
    eng.compile(jprog.ffnn_train_step_tra(2, 2, 2, 1, 4, 4, 4, 4).roots)
    return eng.last_diagnostics


def test_engine_strict_accepts_clean_programs_and_records_diags():
    eng = Engine(executor="jit", validate="strict", device=CPU)
    step = tprog.ffnn_train_step_tra(2, 2, 2, 1, 4, 4, 4, 4)
    eng.compile(step.roots)
    assert eng.last_diagnostics is not None
    assert not eng.last_diagnostics.errors
    same_diags(eng.last_diagnostics, _jax_strict_train_step_diags())


def test_verify_runs_once_per_cache_miss():
    root = as_node(tprog.matmul_tra(*MM))
    eng = Engine(executor="jit", validate="strict", device=CPU)
    eng.compile(root)
    first = eng.last_diagnostics
    eng.compile(root)
    assert eng.last_diagnostics is first
    assert (eng.cache_misses, eng.cache_hits) == (1, 1)


def test_streamed_refusal_enriched_with_diagnostics():
    from repro_torch.store import NotStreamable
    root, budget = _over_budget_matmul()
    eng = Engine(executor="jit", memory_budget=budget, validate="warn",
                 device=CPU)
    with pytest.raises(NotStreamable) as ei:
        eng._compile_streamed(TraReKey(root, lambda k: k), force=True)
    assert "[streaming]" in str(ei.value)
    assert "rewrites the key space" in str(ei.value)
    assert "TraReKey" in str(ei.value)
    eng_off = Engine(executor="jit", memory_budget=budget, validate="off",
                     device=CPU)
    with pytest.raises(NotStreamable) as ei:
        eng_off._compile_streamed(TraReKey(root, lambda k: k), force=True)
    assert "[streaming]" not in str(ei.value)


def test_degrade_rung1_refusal_still_falls_to_rung2():
    """The enriched ``NotStreamable`` keeps its type: the ladder's rung 1
    refuses a rekeyed plan and rung 2's chunks complete it, under strict
    too, with the values of the plain run."""
    from repro_torch.core import FaultInjector
    # a joined key dim of 4: the optimizer fuses the contraction, where the
    # injected OOM fires (at 2 the unfused join ties and is kept)
    root = as_node(tprog.matmul_tra((8, 4), (4, 2), (16, 16), (16, 16)))
    rk = TraReKey(root, lambda k: k)
    r = np.random.default_rng(0)
    x = {n: r.standard_normal(s).astype(np.float32)
         for n, s in (("A", (8, 4, 16, 16)), ("B", (4, 2, 16, 16)))}
    want = Engine(executor="jit", validate="off", device=CPU).run(rk, **x)
    inj = FaultInjector().inject_oom(ok_chunk=8)
    eng = Engine(executor="jit", degrade=True, fault_injector=inj,
                 validate="strict", device=CPU)
    with warnings.catch_warnings(record=True) as log:
        warnings.simplefilter("always")
        got = eng.run(rk, **x)
    msgs = [str(w.message) for w in log]
    assert any("host relation store" in m for m in msgs)
    assert any("halving chunk ladder" in m for m in msgs)
    assert [int(d.rsplit("chunk=", 1)[1].split()[0]) for k, d in inj.log
            if k == "oom" and "chunk=" in d] == [64, 32, 16]
    np.testing.assert_allclose(got.data.numpy(), want.data.numpy(),
                               rtol=1e-5, atol=1e-5)


# ==========================================================================
# promoted legacy validation: same types, same leading text as JAX's
# ==========================================================================

def _jax_error(fn):
    try:
        fn()
    except Exception as err:                    # noqa: BLE001
        return err
    raise AssertionError("the JAX call raised nothing")


def test_chunk_validation_keeps_legacy_text_and_adds_diagnostic():
    from repro.core.engine import Engine as JEngine
    with pytest.raises(ValueError, match="chunk must be >= 1, got 0") as ei:
        Engine(chunk=0, device=CPU)
    assert "[inputs] error" in str(ei.value)
    assert str(ei.value) == str(_jax_error(lambda: JEngine(chunk=0)))
    with pytest.raises(ValueError,
                       match="positive int, None or \"auto\"") as ei:
        Engine(chunk="bogus", device=CPU)
    assert str(ei.value) == str(_jax_error(lambda: JEngine(chunk="bogus")))
    with pytest.raises(ValueError, match="positive int, None or \"auto\""):
        Engine(chunk=True, device=CPU)


def test_memory_budget_validation():
    from repro.core.engine import Engine as JEngine
    with pytest.raises(ValueError,
                       match="memory_budget must be >= 1 byte") as ei:
        Engine(memory_budget=0, device=CPU)
    assert "[inputs] error" in str(ei.value)
    assert str(ei.value) == str(_jax_error(lambda: JEngine(memory_budget=0)))


def test_run_input_validation_keeps_legacy_text():
    from repro.core.engine import Engine as JEngine
    ce = Engine(executor="reference", device=CPU).compile(
        tprog.matmul_tra((2, 2), (2, 2), (4, 4), (4, 4)))
    jce = JEngine(executor="reference").compile(
        jprog.matmul_tra((2, 2), (2, 2), (4, 4), (4, 4)))
    A = np.ones((2, 2, 4, 4), dtype="float32")
    with pytest.raises(ValueError, match="unexpected inputs") as ei:
        ce.run(A=A, B=A, C=A)
    assert "[inputs] error" in str(ei.value)
    assert str(ei.value) == str(_jax_error(lambda: jce.run(A=A, B=A, C=A)))
    with pytest.raises(ValueError, match="missing inputs") as ei:
        ce.run(A=A)
    assert str(ei.value) == str(_jax_error(lambda: jce.run(A=A)))


def test_masked_inputs_error_constructor():
    from repro.analysis.inputs import masked_inputs_error as jmasked
    from repro_torch.analysis.inputs import masked_inputs_error
    err = masked_inputs_error("jit", ["A"])
    assert isinstance(err, NotImplementedError)
    assert "requires continuous (mask-free) input relations" in str(err)
    assert "['A']" in str(err)
    assert str(err) == str(jmasked("jit", ["A"]))


def test_jit_rejects_masked_input_with_the_diagnostic():
    from repro_torch.core import TensorRelation
    ce = Engine(executor="jit", device=CPU).compile(
        tprog.matmul_tra((2, 2), (2, 2), (4, 4), (4, 4)))
    A = torch.ones((2, 2, 4, 4))
    mask = np.ones((2, 2), bool)
    mask[0, 0] = False
    holey = TensorRelation(A, RelType((2, 2), (4, 4)), mask)
    with pytest.raises(NotImplementedError,
                       match="mask-free") as ei:
        ce.run(A=holey, B=A)
    assert "[inputs] error at node CompiledExpr.run" in str(ei.value)


# ==========================================================================
# the program corpus: clean under every pass, the same as JAX's
# ==========================================================================

def _corpora():
    from repro.analysis.lint import _corpus as jcorpus
    from repro_torch.analysis.lint import _corpus
    return _corpus(CPU), jcorpus()


CORPUS_NAMES = [name for name, _ in _corpora()[0]]


@pytest.mark.parametrize("name", CORPUS_NAMES)
def test_corpus_clean_under_all_passes_as_jax(name):
    port, jx = (dict(c)[name]() for c in _corpora())
    diags = verify_plans(passes=ALL_PASSES, **port)
    assert not diags.errors, [d.render() for d in diags.errors]
    same_diags(diags, ja.verify_plans(passes=ja.ALL_PASSES, **jx))


@pytest.mark.parametrize("name", CORPUS_NAMES)
def test_provenance_labels_equal_jax(name):
    """``label_nodes`` gives every node of the program the same
    ``nid:Label`` on both sides."""
    from repro.core.guards import label_nodes as jlabels
    from repro_torch.core.guards import label_nodes
    port, jx = (dict(c)[name]()["roots"] for c in _corpora())
    port = port if isinstance(port, tuple) else (port,)
    jx = jx if isinstance(jx, tuple) else (jx,)
    assert sorted(label_nodes(port).values()) == \
        sorted(jlabels(jx).values())


@functools.lru_cache(maxsize=1)
def _jax_lint_lines():
    from repro.analysis.lint import main as jmain
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = jmain([])
    return rc, out.getvalue().splitlines()


def test_lint_cli_exits_zero():
    from repro_torch.analysis.lint import main
    with contextlib.redirect_stdout(io.StringIO()):
        assert main(["-q", "--device", "cpu"]) == 0


def test_lint_cli_lines_equal_jax():
    from repro_torch.analysis.lint import main
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(["--device", "cpu"])
    jrc, jlines = _jax_lint_lines()
    lines = out.getvalue().splitlines()
    assert (rc, jrc) == (0, 0)
    # the header names the package; every other line is JAX's
    assert lines[0].startswith("repro_torch.analysis.lint:")
    assert [_pkg(x) for x in lines[1:]] == jlines[1:]
