"""Tuple-at-a-time reference executor for the TRA (oracle for tests).

Port of ``repro.core.reference``.  Relations are plain ``{key tuple:
np.ndarray}`` dicts — the literal reading of the paper's definition.
Deliberately simple and slow; the dense ops of
:mod:`repro_torch.core.tra` must agree with this one on every operation.
Deviation: the port's kernels compute in torch, so each kernel call takes
its numpy blocks as CPU tensors and gives back a numpy array.
"""
from __future__ import annotations

from typing import Callable, Dict, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.kernels_registry import Kernel

RefRel = Dict[Tuple[int, ...], np.ndarray]


def _np(kernel: Kernel, *xs):
    out = kernel.apply(*[torch.as_tensor(np.asarray(x)) for x in xs])
    return out.detach().cpu().numpy()


def join(left: RefRel, right: RefRel, jkl: Sequence[int], jkr: Sequence[int],
         kernel: Kernel) -> RefRel:
    out: RefRel = {}
    jkr_set = set(jkr)
    for lk, la in left.items():
        for rk, ra in right.items():
            if all(lk[dl] == rk[dr] for dl, dr in zip(jkl, jkr)):
                ok = tuple(lk) + tuple(v for d, v in enumerate(rk)
                                       if d not in jkr_set)
                if ok in out:
                    raise ValueError("join produced duplicate key")
                out[ok] = _np(kernel, la, ra)
    return out


def agg(rel: RefRel, group_by: Sequence[int], kernel: Kernel) -> RefRel:
    groups: Dict[Tuple[int, ...], list] = {}
    for k, a in rel.items():
        gk = tuple(k[d] for d in group_by)
        groups.setdefault(gk, []).append((k, a))
    out: RefRel = {}
    for gk, members in groups.items():
        # deterministic fold order (row-major key order)
        members.sort(key=lambda ka: ka[0])
        acc = members[0][1]
        for _, a in members[1:]:
            acc = _np(kernel, acc, a)
        out[gk] = acc
    return out


def rekey(rel: RefRel, key_func: Callable) -> RefRel:
    out: RefRel = {}
    for k, a in rel.items():
        nk = tuple(key_func(k))
        if nk in out:
            raise ValueError("rekey produced duplicate keys")
        out[nk] = a
    return out


def filt(rel: RefRel, bool_func: Callable) -> RefRel:
    return {k: a for k, a in rel.items() if bool_func(k)}


def transform(rel: RefRel, kernel: Kernel) -> RefRel:
    return {k: _np(kernel, a) for k, a in rel.items()}


def tile(rel: RefRel, tile_dim: int, tile_size: int) -> RefRel:
    out: RefRel = {}
    for k, a in rel.items():
        n = a.shape[tile_dim] // tile_size
        pieces = np.split(a, n, axis=tile_dim)
        for i, p in enumerate(pieces):
            out[tuple(k) + (i,)] = p
    return out


def concat(rel: RefRel, key_dim: int, array_dim: int) -> RefRel:
    groups: Dict[Tuple[int, ...], list] = {}
    for k, a in rel.items():
        gk = tuple(v for d, v in enumerate(k) if d != key_dim)
        groups.setdefault(gk, []).append((k[key_dim], a))
    out: RefRel = {}
    for gk, members in groups.items():
        members.sort(key=lambda ia: ia[0])
        out[gk] = np.concatenate([a for _, a in members], axis=array_dim)
    return out
