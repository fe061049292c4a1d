"""Plan-lint CLI: the full verifier over the program corpus.

Port of ``repro.analysis.lint``.  ``python -m repro_torch.analysis.lint``
runs **all** verifier passes — the
per-compile set plus the cache-key injectivity fuzzer — over the repo's
evaluation programs: the §5.1 matmul plans (logical and all five
hand-compiled physical variants), the §5.2 NN-search program, the §5.3
FFNN step (autodiff and hand-backward) and train step, the serving
scorer's request program, and an out-of-core (budgeted, streamed)
contraction.  It then compiles the §5.3 train step through an
``Engine(validate="strict")`` to prove the integrated compile-time hook
accepts the corpus.

It is an entry point of the port, so it runs on the card unless asked
otherwise: ``--device cpu`` builds the scorer's weights and the strict
engine on the CPU (the verifier itself only walks plans).

    python -m repro_torch.analysis.lint [-q] [--device cuda|cpu]

Exit status 0 means zero error-severity diagnostics — the invariant CI
enforces; any error prints with provenance and fails the run.
"""
from __future__ import annotations

import sys
from typing import Callable, Dict, List, Tuple

from repro_torch.analysis.diagnostics import Diagnostics
from repro_torch.analysis.manager import ALL_PASSES, verify_plans

# §5.1 shapes: key grids divisible by the 4-site mesh the physical
# plans are linted against
_MM = ((8, 4), (4, 8), (16, 16), (16, 16))
_SITES = {"sites": 4}


def _corpus(device="cuda") -> List[Tuple[str, Callable[[], Dict]]]:
    """``(name, builder)`` pairs; builders return verify_plans kwargs
    (``device``: where the scorer's weights are made)."""
    from repro_torch.core import programs as prog
    from repro_torch.core.cost import plan_peak_bytes
    from repro_torch.core.plan import as_node

    def mm_logical():
        return {"roots": prog.matmul_tra(*_MM)}

    def physical(builder, executor="shard_map"):
        # the BMM variants are cost-model / host-executor artifacts: the
        # repo's own check_valid rejects them for distributed execution
        # (the contraction dim stays partitioned through the full
        # aggregation), and tests run them on the site-ignoring
        # reference/jit walks — linted as such, where the placement
        # findings are warnings, not errors
        def build():
            return {"roots": builder(*_MM), "executor": executor,
                    "axis_sizes": dict(_SITES)}
        return build

    def nn_search():
        p = prog.nn_search_tra(4, 2, rows=8, dcol=8)
        return {"roots": (p.dist, p.result)}

    def ffnn(step_fn):
        def build():
            p = step_fn(2, 2, 2, 1, 4, 4, 4, 4)
            return {"roots": (p.w1_new, p.w2_new, p.a2)}
        return build

    def train_step():
        step = prog.ffnn_train_step_tra(2, 2, 2, 1, 4, 4, 4, 4)
        return {"roots": tuple(step.roots.values())}

    def serve_scorer():
        from repro_torch.serve.servable import FFNNScorer
        sv = FFNNScorer(device=device)
        return {"roots": tuple(sv.program(sv.buckets[0]).values())}

    def streamed_mm():
        root = as_node(prog.matmul_tra((8, 2), (2, 2), (16, 16), (16, 16)))
        budget = int(plan_peak_bytes(root) * 0.6)
        return {"roots": root, "memory_budget": budget}

    return [
        ("sec5.1/matmul-logical", mm_logical),
        ("sec5.1/bmm", physical(prog.bmm_plan, executor="jit")),
        ("sec5.1/cpmm", physical(prog.cpmm_plan)),
        ("sec5.1/cpmm-two-phase", physical(prog.cpmm_two_phase_plan)),
        ("sec5.1/bmm-fused", physical(prog.bmm_fused_plan,
                                      executor="jit")),
        ("sec5.1/cpmm-fused", physical(prog.cpmm_fused_plan)),
        ("sec5.2/nn-search", nn_search),
        ("sec5.3/ffnn-step-autodiff", ffnn(prog.ffnn_step_tra)),
        ("sec5.3/ffnn-step-hand", ffnn(prog.ffnn_step_tra_hand)),
        ("sec5.3/ffnn-train-step", train_step),
        ("serve/ffnn-scorer", serve_scorer),
        ("oocore/streamed-matmul", streamed_mm),
    ]


def lint_corpus(verbose: bool = True, device="cuda") -> Diagnostics:
    """Run every pass over every corpus program; return all diagnostics."""
    all_diags = Diagnostics()
    for name, build in _corpus(device):
        kwargs = build()
        diags = verify_plans(passes=ALL_PASSES, **kwargs)
        n_err = len(diags.errors)
        if verbose:
            status = f"{n_err} error(s)" if n_err else "clean"
            print(f"  {name:<32} {status}")
            for d in diags:
                if d.severity != "info" or n_err:
                    print(f"    {d.render()}")
        all_diags.extend(diags)
    return all_diags


def lint_engine_integration(verbose: bool = True, device="cuda") -> int:
    """Compile the §5.3 train step under ``validate="strict"``."""
    from repro_torch.analysis.diagnostics import PlanVerificationError
    from repro_torch.core import programs as prog
    from repro_torch.core.engine import Engine
    step = prog.ffnn_train_step_tra(2, 2, 2, 1, 4, 4, 4, 4)
    eng = Engine(executor="jit", validate="strict", device=device)
    try:
        eng.compile(step.roots)
    except PlanVerificationError as err:
        if verbose:
            print("  engine/strict-train-step compile REJECTED:")
            print(f"    {err}")
        return 1
    if verbose:
        diags = eng.last_diagnostics
        n = 0 if diags is None else len(diags)
        print(f"  engine/strict-train-step compile accepted "
              f"({n} diagnostic(s))")
    return 0


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(prog="python -m repro_torch.analysis.lint",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("-q", action="store_true", help="print the summary only")
    ap.add_argument("--device", default="cuda",
                    help="where the scorer's weights and the strict engine "
                         "live (default cuda; cpu without a card)")
    args = ap.parse_args(argv or [])
    quiet = args.q
    if not quiet:
        print("repro_torch.analysis.lint: static verification of the "
              "program corpus")
    diags = lint_corpus(verbose=not quiet, device=args.device)
    rc = lint_engine_integration(verbose=not quiet, device=args.device)
    n_err = len(diags.errors)
    print(f"lint: {len(diags)} diagnostic(s), {n_err} error(s) over "
          f"{len(_corpus(args.device))} programs"
          + ("" if rc == 0 else "; strict engine compile FAILED"))
    if n_err:
        for d in diags.errors:
            print(d.render())
    return 1 if (n_err or rc) else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
