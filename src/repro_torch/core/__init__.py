"""TRA/IA core of the port — the counterpart of ``repro.core``.

The user-facing API is the lazy frontend plus the engine:

    import repro_torch.core as tra
    A = tra.input("A", key_shape=(4, 4), bound=(16, 24))
    B = tra.input("B", key_shape=(4, 4), bound=(24, 12))
    engine = tra.Engine(device="cuda")     # executor="jit" by default
    C = engine.run(A @ B, A=RA, B=RB)

Names of ``repro.core`` that are not ported yet (the deprecated
``evaluate_*`` shims and ``TPU_V5E``, whose counterpart is ``H100_SXM``)
are absent; ``ROADMAP.md`` lists the slice that brings each.
"""
from repro_torch.core.kernels_registry import (JoinVjp, Kernel, compose,
                                               get_kernel, register,
                                               registered_kernels)
from repro_torch.core.tra import (RelType, TensorRelation, can_fuse,
                                  from_tensor, fused_join_agg, pack_rows,
                                  scatter_rows, to_tensor, unpack_rows,
                                  zero_rows)
from repro_torch.core.plan import (Bcast, FusedJoinAgg, IAConst, IAInput,
                                   LocalAgg, LocalConcat, LocalFilter,
                                   LocalJoin, LocalMap, LocalPad, LocalTile,
                                   Placement, Shuf, TraAgg, TraConcat,
                                   TraConst, TraFilter, TraInput, TraJoin,
                                   TraPad, TraReKey, TraTile, TraTransform,
                                   as_node, check_valid, describe, infer)
from repro_torch.core.compile import compile_tra
from repro_torch.core.cost import (CostReport, H100_SXM, HardwareModel,
                                   comm_cost, cost_plan)
from repro_torch.core.optimize import OptimizeResult, fuse_join_agg, optimize
from repro_torch.core.expr import (Expr, ExprTypeError, const, einsum,  # noqa: A004
                                   input, input_like, ones_like, scalar,
                                   scalar_input, wrap)
from repro_torch.core.autodiff import AutodiffError, grad
from repro_torch.core.engine import CacheEntry, CompiledExpr, Engine
from repro_torch.core.faults import (CompileFailure, DeviceOOM, FaultError,
                                     FaultInjector, SimulatedFailure)
from repro_torch.core.guards import NumericsError
from repro_torch.core.train import (AdamW, Momentum, SGD, TrainStep,
                                    TraOptimizer, TraTrainer,
                                    make_train_step)

__all__ = [
    "JoinVjp", "Kernel", "compose", "get_kernel", "register",
    "registered_kernels",
    "RelType", "TensorRelation", "can_fuse", "from_tensor",
    "fused_join_agg", "pack_rows", "scatter_rows", "to_tensor",
    "unpack_rows", "zero_rows",
    "Bcast", "FusedJoinAgg", "IAConst", "IAInput", "LocalAgg", "LocalConcat",
    "LocalFilter", "LocalJoin", "LocalMap", "LocalPad", "LocalTile",
    "Placement", "Shuf",
    "TraAgg", "TraConcat", "TraConst", "TraFilter", "TraInput", "TraJoin",
    "TraPad", "TraReKey", "TraTile", "TraTransform", "as_node",
    "check_valid", "describe", "infer",
    "compile_tra", "CostReport", "HardwareModel", "H100_SXM", "comm_cost",
    "cost_plan", "OptimizeResult", "fuse_join_agg", "optimize",
    "Expr", "ExprTypeError", "const", "einsum", "input", "input_like",
    "ones_like", "scalar", "scalar_input", "wrap",
    "AutodiffError", "grad",
    "CacheEntry", "CompiledExpr", "Engine",
    "CompileFailure", "DeviceOOM", "FaultError", "FaultInjector",
    "SimulatedFailure",
    "NumericsError",
    "AdamW", "Momentum", "SGD", "TrainStep", "TraOptimizer", "TraTrainer",
    "make_train_step",
]
