"""Deterministic, shardable, resumable synthetic token pipeline.

A copy of ``repro.data.pipeline``: it is numpy only, so the port keeps the
same code, and a batch is byte-equal to the JAX package's for the same
config and step.  The trainer moves a batch onto its device.

Design goals (mirroring a production loader):

* **Deterministic** — batch ``i`` is a pure function of (seed, i); any host
  can reproduce any batch.
* **Shardable** — each data-parallel host slices its own rows of the
  global batch (``host_slice``); no host ever materializes the full batch.
* **Resumable** — the loader state is a single integer (next step); a
  restart from a checkpoint at step ``k`` continues with batch ``k`` —
  byte-identical to a run that never failed (tested).

The synthetic distribution is a mixture of Zipfian unigrams and a
deterministic affine-recurrence "grammar" so the loss actually decreases
(the model can learn the recurrence), which the end-to-end example uses.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_alpha: float = 1.1
    grammar_frac: float = 0.5      # fraction of rows from the recurrence
    grammar_families: int = 4      # distinct (a, b) recurrences in the mix
    input_mode: str = "tokens"     # tokens | embeddings
    d_model: int = 0               # for embeddings mode


def _zipf_rows(rng: np.random.Generator, n: int, cfg: DataConfig
               ) -> np.ndarray:
    ranks = np.arange(1, cfg.vocab_size + 1, dtype=np.float64)
    p = ranks ** (-cfg.zipf_alpha)
    p /= p.sum()
    return rng.choice(cfg.vocab_size, size=(n, cfg.seq_len + 1),
                      p=p).astype(np.int32)


def _grammar_rows(rng: np.random.Generator, n: int, cfg: DataConfig
                  ) -> np.ndarray:
    """x_{t+1} = (a·x_t + b) mod V, (a, b) from a small per-dataset family.

    The family is a pure function of ``cfg.seed`` (NOT the per-batch rng),
    so every batch on every host draws from the same ``grammar_families``
    recurrences.  This is what makes the stream learnable by sequence
    statistics: p(x_{t+1} | x_t) concentrates on ≤ ``grammar_families``
    values.  (Drawing a fresh uniform ``b`` per row — the earlier behaviour
    — makes that conditional *exactly* uniform over V, so only in-context
    regression of (a, b) could beat chance and short smoke runs sat flat
    at ln V.)
    """
    v = cfg.vocab_size
    fam_rng = np.random.default_rng(
        np.random.SeedSequence([cfg.seed, 0xFA311]))
    fams = np.stack([fam_rng.integers(2, 8, size=cfg.grammar_families),
                     fam_rng.integers(0, v, size=cfg.grammar_families)],
                    axis=1)
    pick = rng.integers(0, cfg.grammar_families, size=n)
    a, b = fams[pick, 0:1], fams[pick, 1:2]
    x = np.empty((n, cfg.seq_len + 1), np.int64)
    x[:, 0] = rng.integers(0, v, size=n)
    for t in range(cfg.seq_len):
        x[:, t + 1] = (a[:, 0] * x[:, t] + b[:, 0]) % v
    return x.astype(np.int32)


def make_batch(cfg: DataConfig, step: int,
               host_slice: Optional[Tuple[int, int]] = None
               ) -> Dict[str, np.ndarray]:
    """Batch ``step`` (or this host's row range of it)."""
    lo, hi = host_slice or (0, cfg.global_batch)
    rows = hi - lo
    # per-(step, row-range) independent stream: fold into the seed so a
    # host only generates its own rows yet stays globally consistent
    rng = np.random.default_rng(
        np.random.SeedSequence([cfg.seed, step, lo, hi]))
    n_gram = int(rows * cfg.grammar_frac)
    parts = []
    if rows - n_gram:
        parts.append(_zipf_rows(rng, rows - n_gram, cfg))
    if n_gram:
        parts.append(_grammar_rows(rng, n_gram, cfg))
    seq = np.concatenate(parts, axis=0)
    batch: Dict[str, np.ndarray] = {"labels": seq[:, 1:]}
    if cfg.input_mode == "tokens":
        batch["tokens"] = seq[:, :-1]
    else:
        # frontend stub: deterministic embedding of the token ids
        emb_rng = np.random.default_rng(cfg.seed + 7)
        table = emb_rng.standard_normal(
            (cfg.vocab_size, cfg.d_model)).astype(np.float32) * 0.02
        batch["embeds"] = table[seq[:, :-1]]
    return batch


class DataLoader:
    """Stateful iterator wrapper: state == next step index."""

    def __init__(self, cfg: DataConfig,
                 host_slice: Optional[Tuple[int, int]] = None,
                 start_step: int = 0):
        self.cfg = cfg
        self.host_slice = host_slice
        self.step = start_step

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        b = make_batch(self.cfg, self.step, self.host_slice)
        self.step += 1
        return b

    def state_dict(self) -> Dict[str, int]:
        return {"step": self.step}

    def load_state_dict(self, state: Dict[str, int]) -> None:
        self.step = int(state["step"])
