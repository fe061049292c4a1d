"""Static plan verifier & lint framework.

Port of ``repro.analysis``: pure-Python walks over the port's plan IR, the
same passes with the same messages.  A pass-manager-driven verifier over
the TRA logical (``TraNode``) and physical (``IANode``) IRs, running
post-optimization / pre-compile:

* ``placement``   — re-derives placements bottom-up and names the
  missing exchange / duplicate-resolution obligation per violation;
* ``collectives`` — derives the ordered collective schedule a shard_map
  lowering would emit and checks axes, reducers, and cross-site
  alignment (hang / wrong-sum races);
* ``streaming``   — re-checks the out-of-core carrier analysis so
  ``Engine(memory_budget=...)`` rejects unstreamable plans at compile
  time with provenance-bearing refusal reasons;
* ``memory``      — cross-checks ``cost.plan_peak_bytes`` against an
  independent interval-liveness analysis;
* ``cachekey``    — mutation-fuzzes ``plan_sig`` injectivity (lint /
  tests only).

The port has no mesh executor yet, so on its ``reference``/``jit``
executors the placement and collective findings are warnings, as in the
JAX package on those executors.

``Engine(validate="off"|"warn"|"strict")`` wires the compile-time set
into every compile; ``python -m repro_torch.analysis.lint`` runs
everything over the program corpus.  All diagnostics address nodes by the
same ``nid:Label`` provenance as fault injection and numerics attribution.
"""
from repro_torch.analysis.diagnostics import (Diagnostic, Diagnostics,
                                              PlanVerificationError,
                                              SEVERITIES)
from repro_torch.analysis.manager import (ALL_PASSES, DEFAULT_COMPILE_PASSES,
                                          PassManager, VerifyContext,
                                          verify_plans)

__all__ = [
    "ALL_PASSES",
    "DEFAULT_COMPILE_PASSES",
    "Diagnostic",
    "Diagnostics",
    "PassManager",
    "PlanVerificationError",
    "SEVERITIES",
    "VerifyContext",
    "verify_plans",
]
