"""Carry weights across from the JAX package.

The JAX package and the port draw random weights from different
generators, so the same seed gives different numbers.  Parity between the
two therefore goes through the weights themselves, as numpy arrays:

* the FFNN scorer's weight relations (``np.asarray(rel.data)`` each)
  become the port's relations (:func:`relations_from_numpy`):

      jax_scorer = repro.serve.FFNNScorer(db=4, hb=4, seed=0)
      arrays = {k: np.asarray(r.data)
                for k, r in jax_scorer.weights().items()}
      scorer = repro_torch.serve.FFNNScorer.from_numpy(
          arrays, db=4, hb=4, device="cpu")

* a model zoo parameter tree (``repro.models.init_params``) of the dense,
  ssm or hybrid family becomes the port's
  :class:`~repro_torch.models.model.DenseLM` (:func:`model_from_numpy`):

      params = repro.models.init_params(cfg, jax.random.PRNGKey(0))
      tree = jax.tree.map(lambda a: np.asarray(a, np.float32), params)
      model = model_from_numpy(cfg, tree, device="cpu")

* the recurrent LM's weight relations and its embedding table
  (``repro.serve.RecurrentLM``: ``weights()`` and ``embedding``) become
  the port's (:func:`lm_weights_from_numpy`, through
  ``RecurrentLM.from_numpy``):

      jax_lm = repro.serve.RecurrentLM(d_model=16, vocab_size=32)
      arrays = {k: np.asarray(r.data) for k, r in jax_lm.weights().items()}
      lm = repro_torch.serve.RecurrentLM.from_numpy(
          arrays, jax_lm.embedding, capacity=4, device="cpu")

* a train step's state — its parameter and optimizer-state relations
  (``W1``, ``W2``, ``W1.m``, ``W1.v``, ``opt.step``, …, as
  ``repro.core.TraTrainer`` holds them in ``params`` and ``state``) —
  becomes the port's, typed by the port's program
  (:func:`train_state_from_numpy`):

      arrays = {k: np.asarray(r.data) for k, r in
                {**jax_trainer.params, **jax_trainer.state}.items()}
      params, state = train_state_from_numpy(step, arrays, device="cpu")
      trainer = repro_torch.core.TraTrainer(engine, step, params=params)
      trainer.state = state

* the model zoo's optimizer state (``repro.optim.adamw``: ``{"step",
  "master", "m", "v"}``, layers stacked) becomes the port's, parameters
  by dotted name (:func:`opt_state_from_numpy`):

      jstate = repro.optim.adamw.init(params)
      state = opt_state_from_numpy(
          cfg, jax.tree.map(np.asarray, jstate), device="cpu")
"""
from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch

from repro_torch.core.tra import RelType, TensorRelation
from repro_torch.device import DeviceLike, resolve_device


def relations_from_numpy(arrays: Mapping[str, np.ndarray],
                         rtypes: Mapping[str, RelType],
                         device) -> Dict[str, TensorRelation]:
    """Every named weight of ``rtypes`` from its dense numpy value (shape
    ``key_shape ++ bound``), copied onto ``device``.  Exactly those names:
    a missing or extra name, or a shape that does not fit, raises."""
    if set(arrays) != set(rtypes):
        raise ValueError(f"weights {sorted(arrays)} do not match the "
                         f"expected {sorted(rtypes)}")
    out = {}
    for name, rt in rtypes.items():
        arr = np.asarray(arrays[name])
        expect = tuple(rt.key_shape) + tuple(rt.bound)
        if arr.shape != expect:
            raise ValueError(f"weight {name!r} of shape {arr.shape} does not "
                             f"fit type f={rt.key_shape} b={rt.bound}")
        data = torch.tensor(arr, dtype=rt.dtype)       # a copy
        out[name] = TensorRelation(data.to(device), rt)
    return out


def lm_weights_from_numpy(arrays: Mapping[str, np.ndarray],
                          embedding: np.ndarray,
                          rtypes: Mapping[str, RelType], device
                          ) -> Tuple[Dict[str, TensorRelation], torch.Tensor]:
    """The recurrent LM's weight relations (``rtypes``: ``lm.Wh``,
    ``lm.Wx``, ``lm.Wo``) and its (vocab, d) f32 embedding table, copied
    onto ``device``.  A missing or extra weight, or a shape that does not
    fit, raises ``ValueError``."""
    rels = relations_from_numpy(arrays, rtypes, device)
    d, v = rtypes["lm.Wo"].bound
    table = np.asarray(embedding)
    if table.shape != (v, d):
        raise ValueError(f"embedding of shape {table.shape} does not fit "
                         f"(vocab, d) = {(v, d)}")
    return rels, torch.tensor(table, dtype=torch.float32).to(device)


def train_state_from_numpy(step, arrays: Mapping[str, np.ndarray],
                           device: DeviceLike = "cuda"
                           ) -> Tuple[Dict[str, TensorRelation],
                                      Dict[str, TensorRelation]]:
    """``(params, state)`` of the port's train step ``step`` (a
    :class:`~repro_torch.core.train.TrainStep`) from their dense numpy
    values, copied onto ``device`` and typed as ``step``'s inputs of those
    names.  Exactly the step's parameter and state names: a missing or
    extra name, or a shape that does not fit, raises ``ValueError``."""
    from repro_torch.core.plan import TraInput, postorder
    names = tuple(step.param_names) + tuple(step.state_names)
    rtypes = {}
    for root in step.roots.values():
        for n in postorder(root.node):
            if isinstance(n, TraInput) and n.name in names:
                rtypes[n.name] = n.rtype
    rels = relations_from_numpy(arrays, rtypes, resolve_device(device))
    return ({nm: rels[nm] for nm in step.param_names},
            {nm: rels[nm] for nm in step.state_names})


def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()
             ) -> Dict[Tuple[str, ...], np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def _jax_leaf(cfg, name: str) -> Tuple[Tuple[str, ...], tuple, tuple]:
    """Where the port's parameter ``name`` lies in the JAX tree: (the leaf's
    path, the index of this layer in it, the leading stacked dims)."""
    from repro_torch.models.model import group_size, n_scan_groups
    parts = name.split(".")
    if parts[0] == "blocks":
        layer, gsz = int(parts[1]), group_size(cfg)
        return (("blocks",) + tuple(parts[2:]), (layer // gsz, layer % gsz),
                (n_scan_groups(cfg), gsz))
    if parts[0] == "shared":
        return (("shared",) + tuple(parts[2:]), (int(parts[1]),),
                (cfg.n_shared_blocks,))
    return tuple(parts), (), ()


def _jax_leaves(cfg, tree: Mapping, shapes: Mapping[str, tuple]
                ) -> Dict[str, np.ndarray]:
    """Each port parameter's array (of ``shapes``, by name) cut out of the
    JAX tree ``tree``.  Exactly the model's leaves: a missing or extra
    leaf, or one whose shape does not fit, raises ``ValueError``."""
    flat = _flatten(tree)
    used, out = set(), {}
    for name, shape in shapes.items():
        path, index, lead = _jax_leaf(cfg, name)
        if path not in flat:
            raise ValueError(f"parameter tree has no leaf {'/'.join(path)}")
        arr = flat[path]
        if arr.shape != lead + tuple(shape):
            raise ValueError(f"leaf {'/'.join(path)} of shape {arr.shape} "
                             f"does not fit {lead + tuple(shape)}")
        used.add(path)
        out[name] = arr[index]
    extra = sorted("/".join(p) for p in set(flat) - used)
    if extra:
        raise ValueError(f"parameter tree has leaves the model does not: "
                         f"{extra}")
    return out


def model_from_numpy(cfg, tree: Mapping, device: DeviceLike = "cuda"):
    """The port's model of ``cfg`` holding the JAX parameter tree ``tree``
    (nested dicts of numpy arrays, as ``repro.models.init_params`` gives
    them), copied onto ``device`` in the model's dtypes.

    JAX stacks every ``params["blocks"]`` leaf as (G, group_size, …), so
    layer ``g·group_size + i`` takes ``[g, i]`` (``blocks/attn/wq`` of the
    dense family, ``blocks/mix/norm/scale`` of the ssm and hybrid
    families), and every ``params["shared"]`` leaf of the hybrid family as
    (n_shared_blocks, …), so shared block ``s`` takes ``[s]``
    (``shared/attn/wq``).  Exactly the model's leaves: a missing or extra
    leaf, or one whose shape does not fit, raises ``ValueError``."""
    from repro_torch.models.model import DenseLM
    model = DenseLM(cfg, None, "meta").to_empty(device=resolve_device(device))
    params = dict(model.named_parameters())
    arrays = _jax_leaves(cfg, tree, {n: p.shape for n, p in params.items()})
    with torch.no_grad():
        for name, param in params.items():
            param.copy_(torch.from_numpy(np.array(arrays[name],
                                                  dtype=np.float32)))
    return model


def opt_state_from_numpy(cfg, state_np: Mapping,
                         device: DeviceLike = "cuda") -> Dict:
    """The port's optimizer state (``repro_torch.optim.adamw``'s
    ``{"step", "master", "m", "v"}``, parameters by dotted name) from the
    JAX package's (``repro.optim.adamw.init`` or a train step's output, as
    numpy arrays: ``jax.tree.map(np.asarray, state)``), copied onto
    ``device`` in f32 (the step as an int32 scalar).  Each of ``master``,
    ``m`` and ``v`` is cut per layer as :func:`model_from_numpy` cuts the
    params, and must hold exactly the model's leaves."""
    from repro_torch.models.model import param_shapes
    dev = resolve_device(device)
    shapes = {n: p.shape for n, p in param_shapes(cfg).items()}
    out: Dict = {"step": torch.tensor(int(np.asarray(state_np["step"])),
                                      dtype=torch.int32, device=dev)}
    for part in ("master", "m", "v"):
        arrays = _jax_leaves(cfg, state_np[part], shapes)
        out[part] = {n: torch.tensor(np.asarray(a, np.float32), device=dev)
                     for n, a in arrays.items()}
    return out
