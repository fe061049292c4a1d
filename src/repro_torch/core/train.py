"""TRA-native training: optimizer update rules as TRA expressions.

Port of ``repro.core.train``.  Deviations:

* optimizer state (the moment buffers and the ``opt.step`` scalar) is made
  on the parameters' device — the JAX package makes it on the default
  device — so a trainer on the card keeps every relation there;
* a restored checkpoint's leaves are rebuilt on the engine's device (the
  JAX package leaves them where ``jnp.asarray`` puts them);
  :class:`repro_torch.checkpoint.CheckpointStore` writes JAX's layout, so
  either package restores the other's checkpoints;
* on a mesh engine every rank runs the same trainer: parameters and state
  come back as DTensors and feed the next step as they are; the loss and
  a snapshot read their global values (a collective where they are
  sharded, which every rank makes at the same step).  Each rank writes
  the global leaves, so give each rank a store of its own; a restore
  rebuilds them as plain tensors, and the engine re-places them on its
  mesh at the next step — so a checkpoint written on one mesh restores
  onto another (the elastic path).

The whole train step is one TRA program.  An optimizer is a builder of
``Expr`` programs over three families of relations:

* **parameter relations**  — the model weights, block-chunked exactly as
  the forward pass consumes them;
* **gradient relations**   — the autodiff-derived cotangent expressions
  (still lazy: sub-DAGs of the same program, never materialized between
  "backward" and "update");
* **optimizer-state relations** — momentum / moment buffers typed like
  their parameter, plus one shared *scalar step-count relation* (key
  ``(1,)``, bound ``(1, 1)``) whose per-step values (Adam bias
  corrections) flow through :meth:`~repro_torch.core.expr.Expr.scale_by`
  broadcast joins as **data**, not kernel constants.

So the step program's structural signature is step-independent, and
:class:`~repro_torch.core.engine.Engine`'s compile cache turns every step
after the first into pure dispatch (``engine.cache_hits`` counts them).

    step = make_train_step(loss, params=["W1", "W2"], optimizer=AdamW(1e-3))
    trainer = TraTrainer(Engine(), step, params={"W1": RW1, "W2": RW2})
    for _ in range(30):
        trainer.step(X=RX, Y=RY)       # one multi-root cached program
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch

from repro_torch.core import expr as E
from repro_torch.core.expr import Expr, ExprTypeError
from repro_torch.core.guards import NumericsError
from repro_torch.core.kernels_registry import (make_adam_dir, make_axpy,
                                               make_bias_corr, make_ema,
                                               make_ema_sq, make_momentum,
                                               make_scale_mul)
from repro_torch.core.plan import TraInput, postorder
from repro_torch.core.tra import RelType, TensorRelation, global_data

STEP_STATE = "opt.step"                  # shared scalar step-count input
LOSS_ROOT = "loss"                       # reserved root name


def _cokey(a: Expr, b: Expr, kernel) -> Expr:
    """Keywise join of two identically-keyed relations."""
    return a.join(b, on=tuple(range(a.key_arity)), kernel=kernel)


def _zeros_rel(rtype: RelType, device) -> TensorRelation:
    shape = tuple(rtype.key_shape) + tuple(rtype.bound)
    return TensorRelation(torch.zeros(shape, dtype=rtype.dtype,
                                      device=device), rtype)


def _scalar_rel(value: float, device) -> TensorRelation:
    return TensorRelation(torch.full((1, 1, 1), value, dtype=torch.float32,
                                     device=device),
                          RelType((1,), (1, 1), torch.float32))


def _device_of(params: Dict[str, TensorRelation]) -> torch.device:
    devices = {p.data.device for p in params.values()}
    if len(devices) != 1:
        raise ValueError(f"parameters lie on {len(devices)} devices "
                         f"({sorted(map(str, devices))}); put them on one")
    return devices.pop()


# ==========================================================================
# Optimizers
# ==========================================================================

class TraOptimizer:
    """Base class: an optimizer whose update rule is a TRA Expr program.

    ``state_inputs`` declares the optimizer-state input relations for a
    parameter set; ``init_state`` produces their step-0 values on the
    parameters' device; ``update`` emits the new-parameter and new-state
    expressions from the parameter / gradient / state input expressions.
    All three key state by name, so :class:`TraTrainer` (or any caller)
    can thread state-out → state-in across steps of one compiled program.
    """

    def state_inputs(self, params: Dict[str, Expr]) -> Dict[str, Expr]:
        return {}

    def init_state(self, params: Dict[str, TensorRelation]
                   ) -> Dict[str, TensorRelation]:
        return {}

    def update(self, params: Dict[str, Expr], grads: Dict[str, Expr],
               state: Dict[str, Expr]
               ) -> Tuple[Dict[str, Expr], Dict[str, Expr]]:
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class SGD(TraOptimizer):
    """Stateless SGD: one fused ``axpy(−lr)`` join per parameter."""

    lr: float = 0.01

    def update(self, params, grads, state):
        axpy = make_axpy(-self.lr)
        new_params = {nm: _cokey(p, grads[nm], axpy)
                      for nm, p in params.items()}
        return new_params, {}


@dataclasses.dataclass(frozen=True)
class Momentum(TraOptimizer):
    """Heavy-ball SGD (optax ``trace``): ``m' = mu·m + g``,
    ``p' = p − lr·m'``.  One buffer relation per parameter."""

    lr: float = 0.01
    mu: float = 0.9

    def state_inputs(self, params):
        return {f"{nm}.m": E.input_like(f"{nm}.m", p.rtype)
                for nm, p in params.items()}

    def init_state(self, params):
        dev = _device_of(params)
        return {f"{nm}.m": _zeros_rel(p.rtype, dev)
                for nm, p in params.items()}

    def update(self, params, grads, state):
        mom = make_momentum(self.mu)
        axpy = make_axpy(-self.lr)
        new_params, new_state = {}, {}
        for nm, p in params.items():
            m_new = _cokey(state[f"{nm}.m"], grads[nm], mom)
            new_state[f"{nm}.m"] = m_new
            new_params[nm] = _cokey(p, m_new, axpy)
        return new_params, new_state


@dataclasses.dataclass(frozen=True)
class AdamW(TraOptimizer):
    """AdamW with decoupled weight decay, matching ``optax.adamw``:

        m' = b1·m + (1−b1)·g               (fused ``ema`` join)
        v' = b2·v + (1−b2)·g²              (fused ``emaSq`` join)
        m̂ = m'/(1−b1ᵗ),  v̂ = v'/(1−b2ᵗ)   (``scale_by`` the step relation)
        p' = p − lr·( m̂/(√v̂+eps) + wd·p )

    The step count lives in the shared scalar relation ``opt.step``; the
    bias corrections are computed *from it inside the plan*
    (``biasCorr`` kernels + ``scale_by`` broadcast joins), so the same
    compiled program serves every step — no per-step constants, no
    recompiles.
    """

    lr: float = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0

    def state_inputs(self, params):
        state = {STEP_STATE: E.scalar_input(STEP_STATE)}
        for nm, p in params.items():
            state[f"{nm}.m"] = E.input_like(f"{nm}.m", p.rtype)
            state[f"{nm}.v"] = E.input_like(f"{nm}.v", p.rtype)
        return state

    def init_state(self, params):
        dev = _device_of(params)
        state = {STEP_STATE: _scalar_rel(0.0, dev)}
        for nm, p in params.items():
            state[f"{nm}.m"] = _zeros_rel(p.rtype, dev)
            state[f"{nm}.v"] = _zeros_rel(p.rtype, dev)
        return state

    def update(self, params, grads, state):
        t_new = state[STEP_STATE].map("stepIncr")
        c1 = t_new.map(make_bias_corr(self.b1))
        c2 = t_new.map(make_bias_corr(self.b2))
        ema = make_ema(self.b1)
        ema_sq = make_ema_sq(self.b2)
        adam_dir = make_adam_dir(self.eps)
        axpy = make_axpy(-self.lr)
        new_params, new_state = {}, {STEP_STATE: t_new}
        for nm, p in params.items():
            g = grads[nm]
            m_new = _cokey(state[f"{nm}.m"], g, ema)
            v_new = _cokey(state[f"{nm}.v"], g, ema_sq)
            new_state[f"{nm}.m"] = m_new
            new_state[f"{nm}.v"] = v_new
            direction = _cokey(m_new.scale_by(c1), v_new.scale_by(c2),
                               adam_dir)
            if self.weight_decay:
                direction = direction + p.map(
                    make_scale_mul(self.weight_decay))
            new_params[nm] = _cokey(p, direction, axpy)
        return new_params, new_state


# ==========================================================================
# Train-step programs
# ==========================================================================

@dataclasses.dataclass
class TrainStep:
    """One optimizer step as a named multi-root TRA program.

    ``roots`` maps output names to expressions: :data:`LOSS_ROOT` (the
    loss relation — its array total is the scalar loss), each parameter
    name to its updated value, and each optimizer-state name to its new
    value.  Run it with ``engine.run(step.roots, ...)`` per step
    (structurally identical dicts hit the compile cache) and rethread the
    ``state_names`` / ``param_names`` outputs into the next step's inputs
    by name — :class:`TraTrainer` does exactly that.
    """

    roots: Dict[str, Expr]
    param_names: Tuple[str, ...]
    state_names: Tuple[str, ...]
    optimizer: TraOptimizer

    @property
    def loss(self) -> Expr:
        return self.roots[LOSS_ROOT]


def _input_exprs(root: Expr, names: Sequence[str],
                 what: str) -> Dict[str, Expr]:
    found: Dict[str, Expr] = {}
    for n in postorder(root.node):
        if isinstance(n, TraInput) and n.name in names:
            found[n.name] = E.wrap(n)
    missing = [nm for nm in names if nm not in found]
    if missing:
        present = sorted(n.name for n in postorder(root.node)
                         if isinstance(n, TraInput))
        raise ExprTypeError(
            f"parameters {missing} do not occur in {what} "
            f"(inputs present: {present})")
    return found


def make_train_step(loss: Expr, params: Sequence[Union[str, Expr]],
                    optimizer: TraOptimizer, *,
                    grad_of: Optional[Expr] = None,
                    seed: Optional[Expr] = None) -> TrainStep:
    """Compose loss + autodiff backward + optimizer update into ONE
    multi-root TRA program.

    ``loss`` is the loss expression (any key grid; its array total is the
    scalar loss).  ``params`` are input names (or input ``Expr`` handles)
    to differentiate and update.  ``grad_of``/``seed`` optionally
    differentiate a *different* node with a custom cotangent — the §5.3
    program seeds ``a2 − Y`` on the pre-activation ``z2`` (the
    sigmoid-BCE shortcut) instead of differentiating the clipped-log loss
    kernel itself.
    """
    from repro_torch.core.autodiff import grad as _grad
    names = []
    for p in params:
        if isinstance(p, str):
            names.append(p)
        elif isinstance(p, Expr) and isinstance(p.node, TraInput):
            names.append(p.node.name)
        else:
            raise ExprTypeError(
                f"params entries must be input names or input Exprs, "
                f"got {type(p.node).__name__ if isinstance(p, Expr) else type(p).__name__}")
    if LOSS_ROOT in names:
        raise ExprTypeError(
            f"parameter name {LOSS_ROOT!r} collides with the loss root")
    target = grad_of if grad_of is not None else loss
    grad_list = _grad(target, wrt=names, seed=seed)
    grads = dict(zip(names, grad_list))
    param_exprs = _input_exprs(
        target, names,
        "the loss expression" if grad_of is None
        else "the grad_of expression (gradients differentiate it, "
             "not the loss)")
    state_in = optimizer.state_inputs(param_exprs)
    new_params, new_state = optimizer.update(param_exprs, grads, state_in)
    if set(new_state) != set(state_in):
        raise ExprTypeError(
            f"optimizer state mismatch: inputs {sorted(state_in)} vs "
            f"outputs {sorted(new_state)}")
    clash = (set(names) & set(new_state)) | ({LOSS_ROOT} & set(new_state))
    if clash:
        raise ExprTypeError(
            f"root names collide between parameters and optimizer state: "
            f"{sorted(clash)}")
    model_inputs = {n.name for r in (loss, target) for n in
                    postorder(r.node) if isinstance(n, TraInput)}
    shadowed = model_inputs & set(state_in)
    if shadowed:
        raise ExprTypeError(
            f"inputs of the loss/grad_of expression collide with "
            f"optimizer-state names: {sorted(shadowed)} — rename the "
            f"inputs or the optimizer's state naming")
    roots: Dict[str, Expr] = {LOSS_ROOT: loss}
    roots.update(new_params)
    roots.update(new_state)
    return TrainStep(roots, tuple(names), tuple(new_state), optimizer)


# ==========================================================================
# The training loop
# ==========================================================================

class TraTrainer:
    """Compile-once training loop over a :class:`TrainStep` program.

    Every ``step`` issues ONE ``engine.run`` of the same named multi-root
    program — step 1 compiles (a cache miss), every later step is pure
    cached dispatch (``engine.cache_hits`` grows by 1 per step).  The
    loop owns the state threading: updated parameter and optimizer-state
    relations come back by name and become the next step's inputs.

    **Fault tolerance.**  With a
    :class:`repro_torch.checkpoint.CheckpointStore` (``store=`` here or per
    ``fit`` call), ``fit(..., ckpt_every=N)`` snapshots params + optimizer
    state (including the scalar ``opt.step`` relation) every N applied
    steps through the store's atomic async writer, and recovers from a
    :class:`~repro_torch.core.faults.SimulatedFailure` raised mid-``fit``
    by restoring the last committed step and continuing.  ``fit(steps)``
    counts *total* applied steps (``self.step_count``), so
    ``fit(steps=K, resume=True)`` on a freshly constructed trainer — a new
    process, a new engine — restores and finishes the remaining
    ``K − restored`` steps.  The replay is reproducible from the restore
    point because the entire optimizer state is relation-valued and
    snapshot by root name.

    **Numerics policy.**  ``skip_nonfinite=N`` skips a step whose loss is
    non-finite (or that raised
    :class:`~repro_torch.core.guards.NumericsError` under the engine's
    ``check_numerics``): params/state/step-count do not advance, the event
    is recorded in ``self.skipped``, and more than ``N`` *consecutive*
    skips raise :class:`~repro_torch.core.guards.NumericsError` — a bounded
    budget, not a silent spin.  ``0`` (default) disables the policy.
    """

    def __init__(self, engine, step: TrainStep,
                 params: Dict[str, TensorRelation], *,
                 store=None, skip_nonfinite: int = 0):
        missing = [nm for nm in step.param_names if nm not in params]
        if missing:
            raise ValueError(f"missing initial parameters: {missing}")
        self.engine = engine
        self.program = step
        self.params = {nm: params[nm] for nm in step.param_names}
        self.state = step.optimizer.init_state(self.params)
        self.history: List[float] = []
        self.store = store
        self.skip_nonfinite = skip_nonfinite
        self.step_count = 0
        self.skipped: List[Tuple[int, float]] = []
        self._consec_skips = 0

    def step(self, **data) -> float:
        """Run one train step; returns the scalar loss (total over the
        loss relation's arrays) and advances params/state in place."""
        try:
            outs = self.engine.run(self.program.roots, **self.params,
                                   **self.state, **data)
            loss = float(torch.sum(global_data(outs[LOSS_ROOT].data)))
            bad = not math.isfinite(loss)
        except NumericsError:
            if self.skip_nonfinite <= 0:
                raise
            outs, loss, bad = None, float("nan"), True
        if bad and self.skip_nonfinite > 0:
            self._consec_skips += 1
            self.skipped.append((self.step_count, loss))
            if self._consec_skips > self.skip_nonfinite:
                raise NumericsError(
                    f"{self._consec_skips} consecutive non-finite train "
                    f"steps at step {self.step_count} (budget "
                    f"skip_nonfinite={self.skip_nonfinite}); params/state "
                    f"remain at the last finite step")
            return loss                     # params/state do NOT advance
        self._consec_skips = 0
        self.params = {nm: outs[nm] for nm in self.program.param_names}
        self.state = {nm: outs[nm] for nm in self.program.state_names}
        self.history.append(loss)
        self.step_count += 1
        return loss

    # -- checkpointing -----------------------------------------------------
    def _snapshot(self) -> Dict[str, Dict[str, torch.Tensor]]:
        return {"params": {nm: global_data(r.data)
                           for nm, r in self.params.items()},
                "state": {nm: global_data(r.data)
                          for nm, r in self.state.items()}}

    def save_checkpoint(self, store=None, *, sync: bool = False) -> None:
        """Snapshot params + optimizer state at ``self.step_count``.

        Async by default (the atomic COMMIT protocol makes a crash
        mid-write unreadable rather than corrupt); ``sync=True`` blocks.
        """
        store = store if store is not None else self.store
        if store is None:
            raise ValueError("no CheckpointStore configured")
        extra = {"step_count": self.step_count,
                 "history": list(self.history)}
        if sync:
            store.save(self.step_count, self._snapshot(), extra)
        else:
            store.save_async(self.step_count, self._snapshot(), extra)

    def restore_checkpoint(self, store=None,
                           step: Optional[int] = None) -> int:
        """Restore params/state by root name from the last committed step
        (or ``step``), rebuilt as relations of the *program's* declared
        rtypes on the engine's device.  Returns the restored step count."""
        store = store if store is not None else self.store
        if store is None:
            raise ValueError("no CheckpointStore configured")
        tree, extra = store.restore(self._snapshot(), step)
        device = self.engine.device

        def rel(arr, like: TensorRelation) -> TensorRelation:
            return TensorRelation(
                torch.from_numpy(arr).to(device=device,
                                         dtype=like.rtype.dtype),
                like.rtype)

        self.params = {nm: rel(tree["params"][nm], r)
                       for nm, r in self.params.items()}
        self.state = {nm: rel(tree["state"][nm], r)
                      for nm, r in self.state.items()}
        self.step_count = int(extra["step_count"])
        self.history = [float(x) for x in extra.get("history", [])]
        self._consec_skips = 0
        return self.step_count

    def fit(self, steps: int, *, store=None,
            ckpt_every: Optional[int] = None, resume: bool = False,
            max_recoveries: int = 3, **data) -> List[float]:
        """Train until ``step_count`` reaches ``steps`` on fixed data.

        ``ckpt_every`` snapshots every N applied steps (async, atomic);
        ``resume=True`` first restores the last committed checkpoint (a
        store with no committed step starts fresh); an in-flight
        :class:`~repro_torch.core.faults.SimulatedFailure` triggers
        restore + continue, at most ``max_recoveries`` times.  Returns the
        loss history (restored prefix included).
        """
        from repro_torch.core.faults import SimulatedFailure
        store = store if store is not None else self.store
        if (resume or ckpt_every) and store is None:
            raise ValueError("fit(ckpt_every=/resume=) needs a store")
        if resume:
            try:
                self.restore_checkpoint(store)
            except FileNotFoundError:
                pass                        # nothing committed: fresh start
        if store is not None and ckpt_every and store.latest_step() is None:
            # commit the initial state so a failure before the first
            # periodic snapshot still has a restore point
            self.save_checkpoint(store, sync=True)
        recoveries = 0
        while self.step_count < steps:
            try:
                self.step(**data)
            except SimulatedFailure:
                if store is None or recoveries >= max_recoveries:
                    raise
                recoveries += 1
                store.wait()                # surface a failed async write
                self.restore_checkpoint(store)
                continue
            if store is not None and ckpt_every \
                    and self.step_count % ckpt_every == 0:
                self.save_checkpoint(store)
        if store is not None:
            store.wait()
        return self.history
