"""The nine checks of ``tests/_distributed_checks.py`` as one rank runs
them on the port's mesh executors (``torch.distributed``, gloo, CPU).

``tests/test_torch_mesh_sites.py`` spawns 8 ranks once per module through
``repro_torch.launch.mesh.run_sites``; every rank runs :func:`all_checks`
on the same numpy inputs (drawn by the parent) and returns plain values —
global results, losses, executed collective schedules — which the parent
holds against JAX's single-device engines.  This module imports no JAX.
A check that raises is returned as its traceback (the others still run);
a rank that hangs is cut by its group's timeout and the parent's deadline.
"""
import tempfile
import traceback

import numpy as np
import torch

torch.set_num_threads(1)

import repro_torch.core as tra  # noqa: E402
from repro_torch.core import (AdamW, Engine, IAInput, LocalAgg,  # noqa: E402
                              LocalJoin, Placement, RelType, Shuf,
                              TensorRelation, TraTrainer, from_tensor,
                              fuse_join_agg, get_kernel, to_tensor)
from repro_torch.core.shardmap_exec import expected_schedule  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402

S = ("sites",)
CPU = "cpu"
TRAIN_DIMS = (8, 2, 2, 2, 4, 4, 4, 2)


def mesh1d():
    return make_mesh((8,), ("sites",), device=CPU)


def mesh2d():
    return make_mesh((4, 2), ("s0", "s1"), device=CPU)


def matmul_expr(fl, fr, bl, br):
    return tra.input("A", fl, bl) @ tra.input("B", fr, br)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(rel):
    return to_tensor(rel).numpy()


def _schedule_ok(compiled, engine) -> bool:
    """The dispatch's recorded collectives against the static lowering."""
    return [o.describe() for o in compiled.exchange.schedule()] == \
        [o.describe() for o in expected_schedule(compiled.roots,
                                                 engine.axis_sizes)]


def check_strategies(d):
    mesh = mesh1d()
    RA, RB = from_tensor(_t(d["A"]), (4, 8)), from_tensor(_t(d["B"]), (8, 4))
    expr = matmul_expr((8, 8), (8, 8), (4, 8), (8, 4))
    out = {}
    for name, places in [
        ("BMM", {"A": Placement.replicated(),
                 "B": Placement.partitioned((0,), S)}),
        ("CPMM", {"A": Placement.partitioned((1,), S),
                  "B": Placement.partitioned((0,), S)}),
        ("rows", {"A": Placement.partitioned((0,), S),
                  "B": Placement.partitioned((0,), S)}),
    ]:
        eng = Engine(mesh, executor="shard_map", input_placements=places)
        compiled = eng.compile(expr)
        got = compiled.run(A=RA, B=RB)
        eng2 = Engine(mesh, executor="shard_map", optimize=False,
                      input_placements=places)
        got2 = eng2.run(expr, A=RA, B=RB)
        out[name] = {"opt": _np(got), "table1": _np(got2),
                     "cost": compiled.cost,
                     "schedule_ok": _schedule_ok(compiled, eng),
                     "schedule": [o.describe()
                                  for o in compiled.exchange.schedule()]}
    return out


def check_rmm_2d(d):
    mesh = mesh2d()
    RA, RB = from_tensor(_t(d["A"]), (4, 8)), from_tensor(_t(d["B"]), (8, 4))
    places = {"A": Placement.partitioned((0,), ("s0",)),
              "B": Placement.partitioned((1,), ("s1",))}
    eng = Engine(mesh, executor="shard_map", input_placements=places)
    compiled = eng.compile(matmul_expr((8, 8), (8, 8), (4, 8), (8, 4)))
    got = compiled.run(A=RA, B=RB)
    return {"C": _np(got), "cost": compiled.cost,
            "schedule_ok": _schedule_ok(compiled, eng)}


def check_gspmd_matches_shardmap(d):
    from torch.distributed.tensor.debug import CommDebugMode
    mesh = mesh1d()
    RA, RB = from_tensor(_t(d["A"]), (4, 8)), from_tensor(_t(d["B"]), (8, 4))
    expr = matmul_expr((8, 8), (8, 8), (4, 8), (8, 4))
    places = {"A": Placement.partitioned((1,), S),
              "B": Placement.partitioned((0,), S)}
    gspmd = Engine(mesh, executor="gspmd", input_placements=places)
    compiled = gspmd.compile(expr)
    comm = CommDebugMode()
    with comm:
        got = compiled.run(A=RA, B=RB)
    want = Engine(mesh, executor="shard_map",
                  input_placements=places).run(expr, A=RA, B=RB)
    # the compile cache: the same structural expression → the same artifact
    again = gspmd.compile(matmul_expr((8, 8), (8, 8), (4, 8), (8, 4)))
    return {"gspmd": _np(got), "shard_map": _np(want),
            "dtensor_collectives": comm.get_total_counts(),
            "recorded": [o.describe() for o in compiled.exchange.schedule()],
            "cache_same": again is compiled, "hits": gspmd.cache_hits}


def check_two_phase_reduce_scatter(d):
    mesh = mesh1d()
    RA, RB = from_tensor(_t(d["A2"]), (4, 8)), from_tensor(_t(d["B2"]),
                                                           (8, 4))
    places = {"A": Placement.partitioned((1,), S),
              "B": Placement.partitioned((0,), S)}
    eng = Engine(mesh, executor="shard_map", input_placements=places)
    compiled = eng.compile(matmul_expr((2, 16), (16, 2), (4, 8), (8, 4)))
    got = compiled.run(A=RA, B=RB)
    return {"C": _np(got), "describe": compiled.describe(),
            "schedule": [o.describe() for o in compiled.exchange.schedule()],
            "schedule_ok": _schedule_ok(compiled, eng)}


def check_other_reducers(d):
    mesh = mesh1d()
    fa, fb, ba = (8, 16), (16, 8), (4, 4)
    RA, RB = from_tensor(_t(d["A3"]), ba), from_tensor(_t(d["B3"]), ba)
    places = {"A": Placement.partitioned((1,), S),
              "B": Placement.partitioned((0,), S)}
    out = {}
    for agg_name in ("elemMax", "elemMin", "elemMul"):
        ia = IAInput("A", RelType(fa, ba), places["A"])
        ib = IAInput("B", RelType(fb, ba), places["B"])
        j = LocalJoin(ia, ib, (1,), (0,), get_kernel("elemMul"))
        partial = LocalAgg(j, (0, 2), get_kernel(agg_name), partial=True)
        sm = Engine(mesh, executor="shard_map")
        got = sm.run(Shuf(partial, (0,), S), A=RA, B=RB)
        unfused = LocalAgg(Shuf(j, (0,), S), (0, 2), get_kernel(agg_name))
        fused = fuse_join_agg(unfused)
        got2 = sm.run(fused, A=RA, B=RB)
        out[agg_name] = {"hand": got.data.full_tensor().numpy(),
                         "fused": got2.data.full_tensor().numpy(),
                         "describe": tra.describe(fused)}
    return out


def check_value_and_grad(d):
    from repro_torch.core.programs import ffnn_step_tra
    mesh = mesh1d()
    nb, db, hb, lb, bn, bd, bh, bl = 8, 2, 2, 2, 4, 4, 4, 2
    env = dict(X=from_tensor(_t(d["X"]), (bn, bd)),
               W1=from_tensor(_t(d["W1"]), (bd, bh)),
               W2=from_tensor(_t(d["W2"]), (bh, bl)))
    prog = ffnn_step_tra(nb, db, hb, lb, bn, bd, bh, bl)
    places = {"X": Placement.partitioned((0,), S),
              "W1": Placement.replicated(), "W2": Placement.replicated()}
    out = {}
    for executor in ("gspmd", "shard_map"):
        eng = Engine(mesh, executor=executor, input_placements=places)
        vg = eng.value_and_grad(prog.a2, wrt=["W1", "W2"])
        val, g1, g2 = vg.run(**env)
        out[executor] = {
            "val": _np(val), "g1": _np(g1), "g2": _np(g2),
            "fused": "FusedJoinAgg" in vg.describe(),
            "cache_same": eng.value_and_grad(prog.a2,
                                             wrt=["W1", "W2"]) is vg,
            "hits": eng.cache_hits,
            "schedule_ok": executor == "gspmd" or _schedule_ok(vg, eng)}
    return out


def _train_data(d):
    nb, db, hb, lb, bn, bd, bh, bl = TRAIN_DIMS
    data = dict(X=from_tensor(_t(d["TX"]), (bn, bd)),
                Y=from_tensor(_t(d["TY"]), (bn, bl)))

    def params():
        return {"W1": from_tensor(_t(d["TW1"]), (bd, bh)),
                "W2": from_tensor(_t(d["TW2"]), (bh, bl))}
    return data, params


def _trainer(engine, params, optimizer, **kw):
    from repro_torch.core.programs import ffnn_train_step_tra
    return TraTrainer(engine, ffnn_train_step_tra(
        *TRAIN_DIMS, optimizer=optimizer), params=params(), **kw)


def check_train_step(d):
    mesh = mesh1d()
    data, params = _train_data(d)
    places = {"X": Placement.partitioned((0,), S),
              "Y": Placement.partitioned((0,), S),
              "W1": Placement.replicated(), "W2": Placement.replicated()}
    out = {}
    for executor in ("gspmd", "shard_map"):
        eng = Engine(mesh, executor=executor, input_placements=places)
        tr = _trainer(eng, params, AdamW(1e-2, 0.9, 0.999, 1e-8,
                                         weight_decay=0.01))
        losses, ws = [], []
        ok = True
        for _ in range(5):
            losses.append(tr.step(**data))
            ws.append({k: _np(tr.params[k]) for k in ("W1", "W2")})
            if executor == "shard_map":
                (entry,) = eng.cache_info()
                ok = ok and _schedule_ok(entry.compiled, eng)
        out[executor] = {"losses": losses, "params": ws,
                         "hits": eng.cache_hits, "schedule_ok": ok}
    return out


def check_elastic_resume(d, rank):
    from repro_torch.checkpoint import CheckpointStore
    from repro_torch.core.faults import FaultInjector
    data, params = _train_data(d)
    with tempfile.TemporaryDirectory() as tmp:
        # each rank writes the global leaves to a store of its own
        store = CheckpointStore(f"{tmp}/rank{rank}", keep=5)
        places1 = {"X": Placement.partitioned((0,), ("sites",)),
                   "Y": Placement.partitioned((0,), ("sites",)),
                   "W1": Placement.replicated(),
                   "W2": Placement.replicated()}
        inj = FaultInjector().inject_site_failure(step=5)
        tr = _trainer(Engine(mesh1d(), executor="gspmd",
                             input_placements=places1, fault_injector=inj),
                      params, AdamW(1e-2), store=store)
        h = tr.fit(6, ckpt_every=2, **data)
        first = {"history": list(h), "log": list(inj.log),
                 "step_count": tr.step_count}
        # a fresh trainer on a DIFFERENT mesh shape: (8,) → (4, 2)
        places2 = {"X": Placement.partitioned((0,), ("s0",)),
                   "Y": Placement.partitioned((0,), ("s0",)),
                   "W1": Placement.replicated(),
                   "W2": Placement.replicated()}
        tr2 = _trainer(Engine(mesh2d(), executor="gspmd",
                              site_axes=("s0",), input_placements=places2),
                       params, AdamW(1e-2), store=store)
        h2 = tr2.fit(8, resume=True, **data)
        return {**first, "resumed": list(h2), "step_count2": tr2.step_count}


def check_stream_gspmd(d):
    from repro_torch.launch.metering import StreamStats
    from repro_torch.store import RelationStore
    from repro_torch.store.stream import StreamExecutor
    mesh = mesh1d()
    ka, ba, kb, bb = (64, 4), (4, 8), (4, 2), (8, 4)
    RA = TensorRelation(_t(d["SA"]), RelType(ka, ba))
    RB = TensorRelation(_t(d["SB"]), RelType(kb, bb))
    expr = matmul_expr(ka, kb, ba, bb)
    places = {"A": Placement.partitioned((0,), ("sites",)),
              "B": Placement.replicated()}
    eng = Engine(mesh, executor="gspmd", input_placements=places)
    store = RelationStore()
    hrA = store.put("A", RA)            # split along the streamed dim 0
    se = StreamExecutor(eng, store=store, budget=1 << 30)
    # chunk_keys=8 → every chunk's streamed key length divides the mesh
    splan = se.plan(expr, force=True, chunk_keys=8)
    stats = StreamStats(mode=splan.mode, budget_bytes=splan.budget)
    got = se.execute(splan, {"A": hrA, "B": RB}, stats)
    return {"C": got.data.numpy(), "mode": splan.mode, "dim": splan.dim,
            "nchunks": splan.nchunks, "chunks": stats.chunks,
            "h2d_bytes": stats.h2d_bytes, "a_bytes": d["SA"].nbytes,
            "misses": eng.cache_misses,
            "executors": sorted({e.executor for e in eng.cache_info()})}


def check_site_gate(d, rank):
    """Ranks holding different plans: the collective gate raises on every
    rank before any collective of the program runs."""
    from repro_torch.analysis.diagnostics import PlanVerificationError
    from repro_torch.core.shardmap_exec import COLLECTIVES
    from repro_torch.launch.sites import verify_rank_program
    mesh = mesh1d()
    # rank 3 asks for a replicated result: an extra all-gather
    target = Placement.replicated() if rank == 3 else None
    places = {"A": Placement.partitioned((1,), S),
              "B": Placement.partitioned((0,), S)}
    eng = Engine(mesh, executor="shard_map", input_placements=places)
    compiled = eng.compile(matmul_expr((8, 8), (8, 8), (4, 8), (8, 4)),
                           target=target)
    before = sum(COLLECTIVES.values())
    try:
        verify_rank_program(compiled.plan, eng.axis_sizes)
        raised = None
    except PlanVerificationError as err:
        raised = str(err)
    # the matching programs pass the same gate
    same = eng.compile(matmul_expr((8, 8), (8, 8), (4, 8), (8, 4)))
    verify_rank_program(same.plan, eng.axis_sizes)
    return {"raised": raised, "issued": sum(COLLECTIVES.values()) - before}


def check_staged_redistribute(d):
    """The gloo staging of DTensor's collectives (used for CUDA tensors)
    forced on CPU tensors: the same values as DTensor's own redistribute,
    on the 1-D and the 2-D mesh's host twins."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    from repro_torch.core.interp import redistribute
    rank = dist.get_rank()
    x = torch.arange(64.0).reshape(8, 8) * (rank + 1)
    out = {}
    for name, mesh, cases in (
            ("1d", mesh1d(), [((Shard(0),), (Replicate(),)),
                              ((Partial("sum"),), (Shard(1),)),
                              ((Shard(0),), (Shard(1),))]),
            ("2d", mesh2d(), [((Shard(0), Partial("max")),
                               (Replicate(), Replicate())),
                              ((Shard(1), Shard(0)),
                               (Replicate(), Shard(1)))])):
        for i, (src, tgt) in enumerate(cases):
            dt = DTensor.from_local(x, mesh, src, run_check=False)
            want = dt.redistribute(mesh, tgt).to_local()
            got, staged = redistribute(dt, tgt, stage=True)
            out[f"{name}.{i}"] = (bool(torch.equal(got.to_local(), want)),
                                  staged > 0,
                                  tuple(got.placements) == tuple(tgt))
    return out


def check_lowering_collectives(d):
    """The shard_map lowering's moves (``shardmap_exec._move``) against
    DTensor's own redistribute of the same blocks: a gather, a dim change
    (the tiled all-to-all), and pending duplicates scattered and
    all-reduced."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    from repro_torch.core.shardmap_exec import Exchange, _move
    mesh = mesh1d()
    rank = dist.get_rank()
    gen = torch.Generator().manual_seed(5)
    full = torch.randn(16, 24, 3, 2, generator=gen)      # key (16, 24)
    part0 = Placement.partitioned((0,), S)
    dup = Placement.partitioned((), (), S, "matAdd")
    cases = {
        "gather": (full[rank * 2:(rank + 1) * 2], part0,
                   Placement.replicated(), [Shard(0)], [Replicate()]),
        "all_to_all": (full[rank * 2:(rank + 1) * 2], part0,
                       Placement.partitioned((1,), S), [Shard(0)],
                       [Shard(1)]),
        "scatter": (full * (rank + 1), dup, part0, [Partial("sum")],
                    [Shard(0)]),
        "all_reduce": (full * (rank + 1), dup, Placement.replicated(),
                       [Partial("sum")], [Replicate()]),
    }
    out = {}
    for name, (local, src, tgt, src_pl, tgt_pl) in cases.items():
        ex = Exchange(mesh, {})
        got = _move(ex, None, local, src, tgt)
        want = DTensor.from_local(local, mesh, src_pl, run_check=False
                                  ).redistribute(mesh, tgt_pl).to_local()
        out[name] = (bool(torch.allclose(got, want, rtol=1e-6, atol=1e-6)),
                     [o.kind for o in ex.schedule()])
    return out


def check_output_numerics(d):
    """``check_numerics`` on a row-partitioned product whose one
    non-finite row lies in rank 3's block: every rank raises, on both
    executors, from its own block and a one-flag all-reduce; the finite
    product raises nowhere."""
    from repro_torch.core.guards import NumericsError
    mesh = mesh1d()
    a = d["A"].copy()
    a[13, 5] = np.inf                    # row block 3 of 8
    places = {"A": Placement.partitioned((0,), S),
              "B": Placement.partitioned((0,), S)}
    expr = matmul_expr((8, 8), (8, 8), (4, 8), (8, 4))
    out = {}
    for executor in ("gspmd", "shard_map"):
        eng = Engine(mesh, executor=executor, check_numerics=True,
                     input_placements=places)
        compiled = eng.compile(expr)
        clean = compiled.run(A=from_tensor(_t(d["A"]), (4, 8)),
                             B=from_tensor(_t(d["B"]), (8, 4)))
        try:
            compiled.run(A=from_tensor(_t(a), (4, 8)),
                         B=from_tensor(_t(d["B"]), (8, 4)))
            raised = None
        except NumericsError as err:
            raised = str(err)
        out[executor] = {
            "raised": raised,
            "sharded": not all(p.is_replicate()
                               for p in clean.data.placements),
            "schedule_ok": executor == "gspmd"
            or _schedule_ok(compiled, eng)}
    return out


CHECKS = ("strategies", "rmm_2d", "gspmd_matches_shardmap",
          "two_phase_reduce_scatter", "other_reducers", "value_and_grad",
          "train_step", "elastic_resume", "stream_gspmd", "site_gate",
          "staged_redistribute", "lowering_collectives", "output_numerics")


def all_checks(rank, world, d):
    """Every check in order on this rank: ``{name: result or
    {"error": traceback}}``, and whether the rank imported JAX or the JAX
    package (``"imports"``)."""
    fns = {"elastic_resume": lambda: check_elastic_resume(d, rank),
           "site_gate": lambda: check_site_gate(d, rank)}
    import sys
    out = {"imports": {"jax": "jax" in sys.modules,
                       "repro": any(m == "repro" or m.startswith("repro.")
                                    for m in sys.modules)}}
    for name in CHECKS:
        fn = fns.get(name) or (lambda name=name: globals()[f"check_{name}"](d))
        try:
            out[name] = fn()
        except Exception:                   # noqa: BLE001 (sent to parent)
            out[name] = {"error": traceback.format_exc()}
    return out


def failing_rank(rank, world):
    """Rank 1 raises while rank 0 waits in a collective."""
    import torch.distributed as dist
    if rank == 1:
        raise ValueError("rank 1 fails before its collective")
    t = torch.ones(2)
    dist.all_reduce(t)
    return t.tolist()
