"""Fault-tolerant training loop of the model zoo on one card.

Port of ``repro.runtime.trainer``: config → train step (loss, autograd,
AdamW) → checkpoint/restart.  Every piece of state needed to survive a
failure lives in exactly two places: the :class:`CheckpointStore`
(durable) and the :class:`DataLoader` step counter (restored from the
checkpoint's ``extra``), so a restart reproduces the uninterrupted run.

* **Checkpoint/restart** — ``save_async`` every ``ckpt_every`` steps
  (atomic, COMMIT marker); a crash loses at most ``ckpt_every`` steps.
* **Failure injection** — ``train(..., failure_injector=...)`` raises
  :class:`SimulatedFailure` inside the step loop; the loop recovers
  through the same restore path a fresh process takes.
* **Straggler detection** — :class:`StragglerMonitor` keeps an EMA of the
  step's wall time and flags outliers.

Deviations from the JAX module:

* no sharding: ``Trainer(mesh=...)`` and ``elastic_restore`` raise or are
  absent; they come with the model zoo's sharding (ROADMAP A7.2b), as do
  ``make_train_step``'s ``sharder`` (only ``None`` is taken);
  :class:`TrainerConfig` has no ``zero1`` (it shards the optimizer state
  over a mesh), nor JAX's ``log_every`` and ``accum_steps``, which its
  loop never reads (microbatches come as a leading dim of the batch);
* no ``jax.jit``: the step runs eagerly.  :class:`TrainStep` keeps one
  model in the compute dtypes (:class:`~repro_torch.models.model.DenseLM`,
  built at its first call on the state's device) and copies the f32 master
  params into it each step, where JAX casts a new tree;
* the optimizer updates the state in place (``adamw.apply``), the
  counterpart of JAX's ``donate_argnums=(0,)``: the state passed to a step
  must not be read again;
* ``Trainer`` takes ``device`` (default ``"cuda"``: without a card it
  raises; tests pass ``"cpu"``).  A batch is moved there with its token
  ids as int64;
* the state is ``{"step", "master", "m", "v"}`` with the parameters by
  their dotted names (``blocks.3.attn.wq``), one leaf per layer; JAX
  stacks the layers (``weights.opt_state_from_numpy`` carries a JAX state
  over).  The checkpoints have the JAX store's layout, but this tree.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointStore
from repro_torch.configs.base import ModelConfig
from repro_torch.core.faults import SimulatedFailure
from repro_torch.data import DataConfig, DataLoader
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.layers import dtype_of
from repro_torch.models.model import (DenseLM, init_params, loss_fn,
                                      param_shapes)
from repro_torch.optim import AdamWConfig, adamw
from repro_torch.optim import schedule as schedules

#: leaves kept in f32 in the compute params (JAX's ``cast_params``)
KEEP_F32 = ("scale", "a_log", "dt_bias", "d_skip", "router")


@dataclasses.dataclass
class TrainerConfig:
    steps: int = 100
    ckpt_every: int = 50
    ckpt_dir: str = dataclasses.field(default_factory=lambda: os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    keep: int = 3
    seed: int = 0
    warmup: int = 10
    adamw: AdamWConfig = dataclasses.field(default_factory=AdamWConfig)


class StragglerMonitor:
    """EMA step-time tracker; flags steps slower than ``threshold×`` EMA."""

    def __init__(self, threshold: float = 2.0, decay: float = 0.9):
        self.threshold = threshold
        self.decay = decay
        self.ema: Optional[float] = None
        self.flagged: list = []

    def observe(self, step: int, dt: float) -> bool:
        straggler = self.ema is not None and dt > self.threshold * self.ema
        self.ema = dt if self.ema is None else \
            self.decay * self.ema + (1 - self.decay) * dt
        if straggler:
            self.flagged.append((step, dt))
        return straggler


def compute_dtype(cfg: ModelConfig, name: str) -> torch.dtype:
    """The dtype of parameter ``name`` in the train step's forward: f32 for
    :data:`KEEP_F32` leaves, else ``cfg.dtype``."""
    keep = name.split(".")[-1] in KEEP_F32
    return torch.float32 if keep else dtype_of(cfg.dtype)


class TrainStep:
    """The pure-in-spirit ``(opt_state, batch) -> (opt_state, metrics)``
    step of ``repro.runtime.trainer.make_train_step``.

    With a batch whose ``tokens`` have a leading microbatch dim, gradients
    of each microbatch are accumulated in f32 and averaged before the one
    optimizer update.  :attr:`model` is the compute-dtype model the forward
    runs (its ``attn_impl``/``ssd_impl`` choose the kernels' routes)."""

    def __init__(self, cfg: ModelConfig, acfg: AdamWConfig,
                 schedule: Callable):
        self.cfg, self.acfg, self.schedule = cfg, acfg, schedule
        self.model: Optional[DenseLM] = None

    def cast_params(self, master: Dict[str, torch.Tensor]) -> DenseLM:
        """:attr:`model` holding ``master`` in the compute dtypes."""
        device = next(iter(master.values())).device
        if self.model is None or self.model.embed["w"].device != device:
            self.model = DenseLM(self.cfg, None, "meta").to_empty(
                device=device)
            for name, p in self.model.named_parameters():
                dt = compute_dtype(self.cfg, name)
                if p.dtype != dt:
                    p.data = torch.empty(p.shape, dtype=dt, device=device)
        with torch.no_grad():
            for name, p in self.model.named_parameters():
                p.copy_(master[name])
        return self.model

    def _value_and_grad(self, batch: Dict) -> Tuple:
        params = dict(self.model.named_parameters())
        with torch.enable_grad():
            for p in params.values():
                p.requires_grad_(True)
            try:
                loss, metrics = loss_fn(self.cfg, self.model, batch)
                grads = torch.autograd.grad(loss, list(params.values()))
            finally:
                for p in params.values():
                    p.requires_grad_(False)
        return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
                dict(zip(params, grads)))

    def grads(self, opt_state: Dict, batch: Dict) -> Tuple:
        """(loss, metrics, gradients by name) at ``opt_state``'s master
        params, the optimizer not applied."""
        self.cast_params(opt_state["master"])
        if batch["tokens"].dim() == 2:
            return self._value_and_grad(batch)
        n = batch["tokens"].shape[0]
        acc: Dict[str, torch.Tensor] = {}
        losses, ms = [], []
        for i in range(n):
            loss, metrics, grads = self._value_and_grad(
                {k: v[i] for k, v in batch.items()})
            for name, g in grads.items():
                if name in acc:
                    acc[name].add_(g.float())
                else:
                    acc[name] = g.float()
            del grads
            losses.append(loss)
            ms.append(metrics)
        grads = {name: a / n for name, a in acc.items()}
        metrics = {k: torch.stack([m[k] for m in ms]).mean() for k in ms[0]}
        return torch.stack(losses).mean(), metrics, grads

    def __call__(self, opt_state: Dict, batch: Dict) -> Tuple[Dict, Dict]:
        loss, metrics, grads = self.grads(opt_state, batch)
        scale = self.schedule(opt_state["step"])
        opt_state, _, opt_metrics = adamw.apply(opt_state, grads, self.acfg,
                                                lr_scale=scale)
        metrics = dict(metrics)
        metrics.update(opt_metrics)
        metrics["loss"] = loss
        return opt_state, metrics


def make_train_step(cfg: ModelConfig, acfg: AdamWConfig, schedule: Callable,
                    sharder=None) -> TrainStep:
    """The ``(opt_state, batch) -> (opt_state, metrics)`` step."""
    if sharder is not None:
        raise NotImplementedError("a sharded train step comes with the "
                                  "model zoo's sharding (ROADMAP A7.2b)")
    return TrainStep(cfg, acfg, schedule)


def _meta_state(cfg: ModelConfig) -> Dict:
    """The state's shapes and dtypes on the ``meta`` device (a restore's
    ``tree_like`` before any state exists)."""
    def f32():
        return {n: torch.empty(p.shape, dtype=torch.float32, device="meta")
                for n, p in param_shapes(cfg).items()}
    return {"step": torch.empty((), dtype=torch.int32, device="meta"),
            "master": f32(), "m": f32(), "v": f32()}


def _load(like, arrays, device: torch.device):
    """``arrays`` (the store's numpy tree) copied into ``like``'s tensors in
    place, or onto ``device`` as new tensors where ``like`` holds ``meta``
    ones."""
    if isinstance(like, dict):
        return {k: _load(like[k], arrays[k], device) for k in like}
    src = torch.from_numpy(np.asarray(arrays))
    if like.device.type == "meta":
        return src.to(device)
    return like.copy_(src)


class Trainer:
    def __init__(self, cfg: ModelConfig, data_cfg: DataConfig,
                 tcfg: TrainerConfig, mesh=None,
                 device: DeviceLike = "cuda"):
        if mesh is not None:
            raise NotImplementedError("Trainer(mesh=...) is not ported to "
                                      "repro_torch yet: it comes with the "
                                      "model zoo's sharding (ROADMAP A7.2b)")
        self.cfg = cfg
        self.data_cfg = data_cfg
        self.tcfg = tcfg
        self.device = resolve_device(device)
        self.store = CheckpointStore(tcfg.ckpt_dir, keep=tcfg.keep)
        self.monitor = StragglerMonitor()
        sched = lambda s: schedules.linear_warmup_cosine(  # noqa: E731
            s, warmup=tcfg.warmup, total=tcfg.steps)
        self._step_fn = make_train_step(cfg, tcfg.adamw, sched)
        self.loader = DataLoader(data_cfg)
        self.opt_state: Optional[Dict] = None
        self.history: List[dict] = []

    # -- state -------------------------------------------------------------
    def init_state(self) -> None:
        model = init_params(self.cfg, self.tcfg.seed, device=self.device)
        self.opt_state = adamw.init(model)

    def restore(self) -> bool:
        step = self.store.latest_step()
        if step is None:
            return False
        like = self.opt_state if self.opt_state is not None \
            else _meta_state(self.cfg)
        arrays, extra = self.store.restore(like, step)
        self.opt_state = _load(like, arrays, self.device)
        self.loader.load_state_dict({"step": extra["data_step"]})
        return True

    def init_or_restore(self) -> None:
        if not self.restore():
            self.init_state()

    # -- loop --------------------------------------------------------------
    def _batch(self, batch_np: Dict[str, np.ndarray]) -> Dict:
        """A host batch on the device, token ids as int64."""
        return {k: torch.from_numpy(v.astype(np.int64) if v.dtype.kind
                                    in "iu" else v).to(self.device)
                for k, v in batch_np.items()}

    def save(self) -> None:
        self.store.wait()
        step = int(self.opt_state["step"])
        self.store.save_async(step, self.opt_state,
                              extra={"data_step": self.loader.step})

    def train(self, steps: Optional[int] = None,
              failure_injector: Optional[Callable[[int], None]] = None
              ) -> list:
        steps = steps or self.tcfg.steps
        if self.opt_state is None:
            self.init_or_restore()
        fn = self._step_fn
        done = int(self.opt_state["step"])
        while done < steps:
            batch = self._batch(next(self.loader))
            t0 = time.perf_counter()
            try:
                if failure_injector is not None:
                    failure_injector(done)
                self.opt_state, metrics = fn(self.opt_state, batch)
                done = int(self.opt_state["step"])   # waits for the step
            except SimulatedFailure:
                # node loss: recover exactly as a fresh process would
                self.store.wait()
                self.opt_state = None
                self.init_or_restore()
                done = int(self.opt_state["step"])
                continue
            dt = time.perf_counter() - t0
            self.monitor.observe(done, dt)
            rec = {k: float(v) for k, v in metrics.items()}
            rec["step"] = done
            rec["wall"] = dt
            self.history.append(rec)
            if done % self.tcfg.ckpt_every == 0:
                self.save()
        self.store.wait()
        return self.history


__all__ = ["KEEP_F32", "SimulatedFailure", "StragglerMonitor", "Trainer",
           "TrainerConfig", "TrainStep", "compute_dtype", "make_train_step"]
