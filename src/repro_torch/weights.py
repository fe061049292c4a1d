"""Carry weights across from the JAX package.

The JAX package and the port draw random weights from different
generators, so the same seed gives different numbers.  Parity between the
two therefore goes through the weights themselves: the JAX side's
parameters, as numpy arrays (``np.asarray(rel.data)`` for each weight
relation), become the port's relations here, on the port's device.

    jax_scorer = repro.serve.FFNNScorer(db=4, hb=4, seed=0)
    arrays = {k: np.asarray(r.data) for k, r in jax_scorer.weights().items()}
    scorer = repro_torch.serve.FFNNScorer.from_numpy(
        arrays, db=4, hb=4, device="cpu")
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from repro_torch.core.tra import RelType, TensorRelation


def relations_from_numpy(arrays: Mapping[str, np.ndarray],
                         rtypes: Mapping[str, RelType],
                         device) -> Dict[str, TensorRelation]:
    """Every named weight of ``rtypes`` from its dense numpy value (shape
    ``key_shape ++ bound``), copied onto ``device``.  Exactly those names:
    a missing or extra name, or a shape that does not fit, raises."""
    if set(arrays) != set(rtypes):
        raise ValueError(f"weights {sorted(arrays)} do not match the "
                         f"servable's {sorted(rtypes)}")
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
