"""Deterministic fault injection for TRA execution (the fault model).

Port of ``repro.core.faults``: the fault taxonomy (``FaultError``,
``SimulatedFailure``, ``DeviceOOM``, ``CompileFailure``,
:func:`is_transient`) and the scripted :class:`FaultInjector` the
:class:`~repro_torch.core.engine.Engine` threads through its executors, so
simulated failures fire at deterministic, plan-addressable points:

* **site failures** (:class:`SimulatedFailure`) — per *run* (``step`` /
  ``every``: the N-th ``CompiledExpr.run`` of the engine's artifacts) or
  per *plan node* (``node``);
* **device OOM** (:class:`DeviceOOM`) — raised out of the fused Σ∘⋈
  contraction unless it runs streamed at a small enough chunk
  (``ok_chunk``) or under a live-bytes budget (``ok_bytes``).  With
  ``Engine(degrade=True)`` the engine recovers it: streamed through the
  host relation store, then down the halving chunk ladder; without it
  the fault propagates, and a server retries it as transient;
* **compile failures** (:class:`CompileFailure`) before an executor builds
  its artifact;
* **stragglers** — a node or run delayed by ``delay`` seconds;
* **numeric faults** — a node's output replaced by a NaN-poisoned copy, so
  ``check_numerics`` (:mod:`repro_torch.core.guards`) can be shown to name
  the exact node.

**Node addressing.**  Node-scoped faults are keyed on plan-signature node
ids (the postorder index :func:`repro_torch.core.guards.label_nodes`
assigns, shared subexpressions once) or on a substring of the node's label
(``"7:FusedJoinAgg[matMul→matAdd]"``).

**Timing: a deviation from the JAX package.**  JAX's staged executors run
node hooks at trace time, once per compile, so a node-scoped fault there is
baked into the compiled program.  The port's ``jit`` executor replays a
schedule of eager node evaluations and traces nothing, so node hooks fire
on every dispatch, on ``jit`` as on ``reference``: ``step``/``every``
node faults behave per run on both.

**No fault writes in place.**  An injected NaN is multiplied into a new
tensor: the node's own value — a weight relation, or the state snapshot a
server restores — is never touched.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Tuple, Union

import torch


class FaultError(RuntimeError):
    """Base class of all injected faults."""


class SimulatedFailure(FaultError):
    """A simulated site/node failure (the checkpoint/restart trigger)."""


class DeviceOOM(FaultError):
    """Simulated device out-of-memory in the fused contraction path."""


class CompileFailure(FaultError):
    """Simulated executor compile failure (degradation-ladder trigger)."""


#: The transient half of the taxonomy: failures a retry can clear because
#: they name a condition of the *attempt* (a site died, a device filled,
#: an executor's build flaked) rather than of the request.  Everything
#: else — type errors, bad payloads, shape mismatches — is permanent:
#: retrying replays the same deterministic rejection.
TRANSIENT_FAULTS = (SimulatedFailure, DeviceOOM, CompileFailure)


def is_transient(err: BaseException) -> bool:
    """Classify an execution failure against the fault taxonomy.

    True for the injected transient kinds (:data:`TRANSIENT_FAULTS`), for
    real device failures — ``torch.OutOfMemoryError`` and CUDA runtime
    errors (``torch.AcceleratorError``), where the JAX package keys on
    ``XlaRuntimeError`` — and for numeric-guard trips
    (:class:`repro_torch.core.guards.NumericsError`).  It only classifies:
    nothing here moves work to another device.
    """
    if isinstance(err, TRANSIENT_FAULTS):
        return True
    if isinstance(err, torch.OutOfMemoryError):
        return True
    accel = getattr(torch, "AcceleratorError", None)
    if accel is not None and isinstance(err, accel):
        return True
    from repro_torch.core.guards import NumericsError
    return isinstance(err, NumericsError)


@dataclasses.dataclass
class _Fault:
    kind: str                              # site | oom | compile | straggler | nan
    node: Union[int, str, None] = None     # plan-sig node id or label substring
    step: Optional[int] = None             # 0-based run index (on_run counter)
    every: Optional[int] = None            # periodic: fire when step % every == 0
    times: int = 1                         # remaining firings; -1 = unlimited
    delay: float = 0.0                     # straggler sleep seconds
    ok_chunk: int = 0                      # oom: succeed when streaming chunk <= this
    ok_bytes: Optional[int] = None         # oom: succeed when live bytes <= this
    executor: Optional[str] = None         # compile: executor that fails

    def matches_node(self, nid: int, label: str) -> bool:
        if isinstance(self.node, int):
            return self.node == nid
        if isinstance(self.node, str):
            return self.node in label
        return self.node is None

    def due_at(self, idx: int) -> bool:
        """Is this fault scheduled for run index ``idx``?

        ``step`` pins one run; ``every`` fires periodically (every N-th
        run, skipping run 0 so warm starts see at least one good tick).
        With neither selector a run-scoped fault never fires.
        """
        if self.step is not None:
            return self.step == idx
        if self.every is not None:
            return idx > 0 and idx % self.every == 0
        return False

    def spend(self) -> bool:
        """Consume one firing; False if the budget is exhausted."""
        if self.times == 0:
            return False
        if self.times > 0:
            self.times -= 1
        return True


class FaultInjector:
    """Scripted, deterministic fault source threaded through the Engine.

        inj = FaultInjector()
        inj.inject_site_failure(step=5)        # kill the 6th run
        eng = Engine(executor="jit", fault_injector=inj, device="cpu")

    Every fired fault is appended to ``self.log`` as a ``(kind, detail)``
    tuple so tests can assert exactly which recovery path executed.
    """

    def __init__(self) -> None:
        self._faults: List[_Fault] = []
        self.log: List[Tuple[str, str]] = []
        self.runs = 0                      # CompiledExpr.run invocations

    # -- scripting ---------------------------------------------------------
    def inject_site_failure(self, *, node=None, step: Optional[int] = None,
                            every: Optional[int] = None,
                            times: int = 1) -> "FaultInjector":
        """Kill one run (``step=``) or every N-th run (``every=``)."""
        self._faults.append(_Fault("site", node=node, step=step,
                                   every=every, times=times))
        return self

    def inject_oom(self, *, node=None, ok_chunk: int = 1,
                   ok_bytes: Optional[int] = None,
                   times: int = -1) -> "FaultInjector":
        """OOM whenever the fused contraction runs unstreamed or with a
        streaming chunk larger than ``ok_chunk``; with ``ok_bytes``, iff
        its estimated live bytes exceed that budget."""
        self._faults.append(_Fault("oom", node=node, ok_chunk=ok_chunk,
                                   ok_bytes=ok_bytes, times=times))
        return self

    def inject_compile_failure(self, *, executor: str,
                               times: int = 1) -> "FaultInjector":
        self._faults.append(_Fault("compile", executor=executor,
                                   times=times))
        return self

    def inject_straggler(self, *, node=None, step: Optional[int] = None,
                         every: Optional[int] = None, delay: float = 0.05,
                         times: int = 1) -> "FaultInjector":
        self._faults.append(_Fault("straggler", node=node, step=step,
                                   every=every, delay=delay, times=times))
        return self

    def inject_nan(self, *, node, step: Optional[int] = None,
                   every: Optional[int] = None,
                   times: int = 1) -> "FaultInjector":
        """Poison a node's output with NaN — pinned to one run
        (``step=``), periodic (``every=``), or unconditional (neither)."""
        self._faults.append(_Fault("nan", node=node, step=step,
                                   every=every, times=times))
        return self

    # -- hooks (called by the Engine / executors) --------------------------
    def on_run(self) -> None:
        """Per ``CompiledExpr.run``; run-scoped site failures / stragglers."""
        idx = self.runs
        self.runs += 1
        for f in self._faults:
            if f.node is not None or not f.due_at(idx):
                continue
            if f.kind == "site" and f.spend():
                self.log.append(("site", f"run {idx}"))
                raise SimulatedFailure(f"injected site failure at run {idx}")
            if f.kind == "straggler" and f.spend():
                self.log.append(("straggler", f"run {idx} +{f.delay}s"))
                time.sleep(f.delay)

    def on_node(self, nid: int, label: str, data: torch.Tensor
                ) -> torch.Tensor:
        """Per evaluated plan node.  May raise, sleep, or return a
        NaN-poisoned copy of ``data`` (never ``data`` written in place)."""
        out = data
        for f in self._faults:
            if f.node is None or not f.matches_node(nid, label):
                continue
            if (f.step is not None or f.every is not None) \
                    and not f.due_at(max(0, self.runs - 1)):
                continue
            if f.kind == "site" and f.spend():
                self.log.append(("site", label))
                raise SimulatedFailure(f"injected site failure at {label}")
            if f.kind == "straggler" and f.spend():
                self.log.append(("straggler", f"{label} +{f.delay}s"))
                time.sleep(f.delay)
            if f.kind == "nan" and f.spend():
                self.log.append(("nan", label))
                out = poison(out)
        return out

    def on_contraction(self, *, stream: bool, chunk: Optional[int],
                       nid: int = -1, label: str = "",
                       bytes_live: Optional[int] = None) -> None:
        """Inside the fused Σ∘⋈ path, before the contraction lowers."""
        for f in self._faults:
            if f.kind != "oom" or not f.matches_node(nid, label):
                continue
            if f.ok_bytes is not None:
                fits = bytes_live is not None and bytes_live <= f.ok_bytes
                limit = f"live bytes <= {f.ok_bytes}"
            else:
                fits = stream and chunk is not None and chunk <= f.ok_chunk
                limit = f"streaming chunk <= {f.ok_chunk}"
            if not fits and f.spend():
                mode = f"stream chunk={chunk}" if stream else "unstreamed"
                if bytes_live is not None:
                    mode += f" ~{bytes_live}B"
                self.log.append(("oom", f"{label or 'fused'} {mode}"))
                raise DeviceOOM(
                    f"injected device OOM in fused contraction ({mode}; "
                    f"fits only at {limit})")

    def on_compile(self, executor: str) -> None:
        """Before an executor builds its compiled artifact."""
        for f in self._faults:
            if f.kind == "compile" and f.executor == executor and f.spend():
                self.log.append(("compile", executor))
                raise CompileFailure(
                    f"injected compile failure on executor {executor!r}")


def poison(data: torch.Tensor) -> torch.Tensor:
    """A NaN-filled copy of a floating tensor (``data`` itself untouched);
    an exact-typed tensor comes back as it is."""
    if not data.is_floating_point():
        return data
    return data * float("nan")
