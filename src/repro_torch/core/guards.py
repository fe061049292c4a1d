"""Numeric guards with plan provenance + the executor run context.

Port of ``repro.core.guards``:

* :class:`NumericsError` and the finite checks behind
  ``Engine(check_numerics=True)``.  The *first* checked node in plan
  postorder whose output holds a NaN/Inf is named in the error
  (``non-finite values first produced by node 7:LocalMap[relu] ...``).  On
  the ``reference`` executor every checked node (see
  :func:`node_needs_check`) gets an eager mask-aware finite check, one host
  sync a node.  On ``jit`` the guard is **two-tier**: a dispatch flags its
  outputs only and reads them with one combined host sync; when that
  trips, the engine re-runs the same inputs once with every node flagged
  and names the first.  ``check_numerics="all"`` flags every node in the
  dispatch itself (still one combined sync).
* :class:`ExecContext` — the per-compile context the
  :class:`~repro_torch.core.engine.Engine` threads through its executor
  walks: the fault injector (:mod:`repro_torch.core.faults`), the
  ``check_numerics`` level, the node-id/label table
  (:func:`label_nodes`, numbered as :func:`repro_torch.core.engine.plan_sig`
  numbers nodes), and the ``stream`` flag of the OOM degradation ladder
  (force the fused Σ∘⋈ onto the chunked streaming lowering).

Deviations from the JAX module: flags are 0-dim bool tensors collected
during an eager dispatch (``ExecContext.defer``) where JAX collects traced
flags at trace time.  The attribution re-run does not consult the injector
again: the dispatch records which nodes it poisoned (``poisoned``) and the
re-run poisons those same nodes (``replay``), so it sees the same injected
faults whatever their ``times`` budget, and spends none of it.
``on_array`` (the mesh executors' local walks) applies node faults to a
rank's block as each node is dispatched (JAX: at trace time).
:func:`is_oom_error` keys on ``torch.OutOfMemoryError`` where JAX matches
XLA's ``RESOURCE_EXHAUSTED``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, FrozenSet, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.faults import poison


class NumericsError(RuntimeError):
    """A NaN/Inf was produced, attributed to a plan node when possible."""

    def __init__(self, msg: str, node_label: Optional[str] = None):
        super().__init__(msg)
        self.node_label = node_label


def _node_desc(n) -> str:
    """Human-readable node label body (kernel / name detail)."""
    from repro_torch.core import plan as P
    t = type(n).__name__
    if isinstance(n, (P.TraInput, P.IAInput)):
        return f"{t}[{n.name}]"
    if isinstance(n, (P.TraJoin, P.LocalJoin)):
        return f"{t}[{n.kernel.name}]"
    if isinstance(n, P.FusedJoinAgg):
        return f"{t}[{n.join_kernel.name}→{n.agg_kernel.name}]"
    if isinstance(n, (P.TraAgg, P.LocalAgg)):
        return f"{t}[{n.kernel.name}]"
    if isinstance(n, (P.TraTransform, P.LocalMap)):
        return f"{t}[{n.kernel.name}]"
    return t


def label_nodes(roots) -> Dict[int, Tuple[int, str]]:
    """``id(node) -> (nid, label)`` over all roots, postorder, deduped.

    ``nid`` is the node's plan-signature id: the postorder index
    :func:`repro_torch.core.engine.plan_sig` assigns (shared subexpressions
    numbered once; multi-root programs continue numbering across roots in
    root order).
    """
    from repro_torch.core.plan import as_node, postorder
    out: Dict[int, Tuple[int, str]] = {}
    nid = 0
    for root in roots:
        for n in postorder(as_node(root)):
            if id(n) in out:
                continue
            out[id(n)] = (nid, f"{nid}:{_node_desc(n)}")
            nid += 1
    return out


def finite_flag(data: torch.Tensor, mask=None) -> Optional[torch.Tensor]:
    """0-dim bool tensor on ``data``'s device: every (valid) entry finite.
    ``None`` for exact dtypes.  Reading it (``bool``) syncs with the
    device."""
    if not (data.is_floating_point() or data.is_complex()):
        return None
    if mask is not None and np.asarray(mask).all():
        mask = None                     # static all-ones mask: skip select
    if mask is not None:
        m = torch.as_tensor(np.asarray(mask), device=data.device)
        m = m.reshape(m.shape + (1,) * (data.ndim - m.ndim))
        data = torch.where(m, data, torch.zeros((), dtype=data.dtype,
                                                device=data.device))
    return torch.isfinite(data).all()


def node_needs_check(node, level=True) -> bool:
    """False for structural nodes that cannot *produce* a non-finite value
    from finite inputs (rekey/tile/pad/concat/filter and the IA data
    movements): skipping their flags keeps attribution on the first
    arithmetic producer while trimming guard traffic.  ``level="all"``
    checks every node."""
    from repro_torch.core import plan as P
    if level == "all":
        return True
    return not isinstance(node, (P.TraReKey, P.TraTile, P.TraPad,
                                 P.TraConcat, P.TraFilter, P.LocalTile,
                                 P.LocalPad, P.LocalConcat, P.LocalFilter,
                                 P.Bcast, P.Shuf))


@dataclasses.dataclass
class ExecContext:
    """Per-compile execution context threaded through the executor walks.

    ``on_node`` is called after each plan node's value is computed; it
    applies node-scoped injected faults and the per-node finite check.
    With ``defer`` (the ``jit`` executor) a check appends ``(label,
    flag)`` to ``flags`` for the engine to read with one sync; without it
    (``reference``) a non-finite value raises at once.  ``poisoned`` lists
    the node ids the injector poisoned in the current dispatch; a context
    built with ``replay`` poisons exactly those instead of consulting the
    injector (the attribution re-run).
    """

    faults: Optional[object] = None          # FaultInjector
    check: object = False                    # False | True (pruned) | "all"
    labels: Dict[int, Tuple[int, str]] = dataclasses.field(
        default_factory=dict)
    defer: bool = False
    stream: bool = False                     # force chunked fused streaming
    replay: Optional[FrozenSet[int]] = None
    flags: List[Tuple[str, torch.Tensor]] = dataclasses.field(
        default_factory=list)
    poisoned: List[int] = dataclasses.field(default_factory=list)

    @property
    def active(self) -> bool:
        return (self.faults is not None or bool(self.check)
                or self.stream or self.replay is not None)

    def begin(self) -> None:
        """Start of a dispatch: forget the previous one's flags and
        injections."""
        self.flags.clear()
        self.poisoned.clear()

    def ids_of(self, node) -> Tuple[int, str]:
        return self.labels.get(id(node), (-1, type(node).__name__))

    def on_node(self, node, rel):
        """Fault + numerics hook over a freshly computed TensorRelation."""
        nid, label = self.ids_of(node)
        data = rel.data
        if self.replay is not None:
            out = poison(data) if nid in self.replay else data
        elif self.faults is not None:
            out = self.faults.on_node(nid, label, data)
            if out is not data:
                self.poisoned.append(nid)
        else:
            out = data
        if out is not data:
            from repro_torch.core.tra import TensorRelation
            rel = TensorRelation(out, rel.rtype, rel.mask)
        if self.check and node_needs_check(node, self.check):
            flag = finite_flag(out, rel.mask)
            if flag is not None:
                if self.defer:
                    self.flags.append((label, flag))
                elif not bool(flag):
                    raise NumericsError(
                        f"non-finite values first produced by node {label} "
                        f"(eager finite-check; plan postorder attribution)",
                        node_label=label)
        return rel

    def on_array(self, node, data):
        """Array-valued variant (the mesh executors' local walks): faults
        only — per-node finite checks would add per-shard probes; the
        engine checks the mesh executors' outputs instead."""
        if self.faults is None:
            return data
        nid, label = self.ids_of(node)
        return self.faults.on_node(nid, label, data)

    def on_contraction(self, *, stream: bool, chunk: Optional[int],
                       node=None, bytes_live: Optional[int] = None) -> None:
        if self.faults is None or self.replay is not None:
            return
        nid, label = (-1, "") if node is None else self.ids_of(node)
        self.faults.on_contraction(stream=stream, chunk=chunk, nid=nid,
                                   label=label, bytes_live=bytes_live)

    def take_flags(self) -> List[Tuple[str, torch.Tensor]]:
        flags, self.flags = list(self.flags), []
        return flags


def check_output_rel(rel, label: str) -> None:
    """Output-level finite check (the mesh executors): eager raise, on
    every rank alike.  A DTensor output is checked as JAX checks a sharded
    array: each rank's local block reduced to one flag, then the flags
    reduced (``MIN``) over each mesh dimension's group — one 4-byte
    all-reduce a dimension, outside the program's recorded schedule.  A
    masked or pending (``Partial``) output is read whole instead."""
    from repro_torch.core.tra import global_data, is_dtensor
    data = rel.data
    if is_dtensor(data) and rel.mask is None and \
            not any(p.is_partial() for p in data.placements):
        flag = finite_flag(data.to_local())
        if flag is None:
            return
        import torch.distributed as dist
        flag = flag.to(torch.int32).reshape(1)
        mesh = data.device_mesh
        for d in range(mesh.ndim):
            dist.all_reduce(flag, op=dist.ReduceOp.MIN,
                            group=mesh.get_group(d))
    else:
        flag = finite_flag(global_data(data), rel.mask)
    if flag is not None and not bool(flag):
        raise NumericsError(
            f"non-finite values in executor output {label} (per-node "
            f"attribution is available on the reference/jit executors)",
            node_label=label)


def is_oom_error(exc: BaseException) -> bool:
    """True for injected DeviceOOM and real device out-of-memory errors
    (``torch.OutOfMemoryError``, where the JAX package matches XLA's
    ``RESOURCE_EXHAUSTED``)."""
    from repro_torch.core.faults import DeviceOOM
    if isinstance(exc, (DeviceOOM, torch.OutOfMemoryError)):
        return True
    return "out of memory" in str(exc).lower()
