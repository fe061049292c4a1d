"""Pipeline parallelism: the GPipe schedule's bubble.

Port of ``repro.runtime.pipeline`` in part: :func:`bubble_fraction`.
``gpipe`` (stages on a mesh axis, a ring of activations) comes with the
model zoo's sharding (ROADMAP A7.2b).

Schedule: plain GPipe fill-drain over ``M`` microbatches and ``S`` stages
(M + S − 1 ticks).  Bubble fraction = (S−1)/(M+S−1); callers pick M ≫ S.
"""
from __future__ import annotations


def bubble_fraction(n_microbatches: int, n_stages: int) -> float:
    return (n_stages - 1) / (n_microbatches + n_stages - 1)
