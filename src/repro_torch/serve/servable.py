"""Servables: model programs a :class:`~repro_torch.serve.server.TraServer`
holds.

Port of ``repro.serve.servable``.  A *servable* owns the model weights as
relations and emits the lazy :class:`~repro_torch.core.expr.Expr` programs
the server compiles once per shape and dispatches forever:

* :class:`BatchServable` — stateless request/response scoring, one program
  per *bucket size*: the batched input relation gains a new leading
  **batch key dim** (``tra.pack_rows``), padded to the bucket so the
  engine's structural compile cache serves every request count from a
  small artifact set.  :class:`FFNNScorer`, the §5.3 FFNN, is the
  paper-native instance.
* :class:`StepServable` — stateful step decode over a fixed-capacity
  slot-keyed state relation.  Only the interface is ported: ``RecurrentLM``
  and the server's decode path come with the decode slice (3, see
  ``ROADMAP.md``).

Every servable carries a dense per-request **oracle** (plain torch, no
Engine) — the correctness reference for batched serving.

Deviations from the JAX module: servables take a ``device`` (default
``"cuda"``; without a card that default raises — pass ``device="cpu"``);
``FFNNScorer`` draws its weights from a ``torch.Generator`` seeded with
``seed`` (other numbers than ``jax.random`` gives; carry JAX weights over
with :meth:`FFNNScorer.from_numpy`); ``snapshot_state``/``restore_state``
come with the decode slice.
"""
from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import expr as E
from repro_torch.core.expr import Expr
from repro_torch.core.tra import RelType, TensorRelation, to_tensor
from repro_torch.device import DeviceLike, resolve_device

DEFAULT_BUCKETS = (1, 2, 4, 8)


def pick_bucket(n: int, buckets: Sequence[int]) -> int:
    """Smallest bucket that fits ``n`` requests (buckets sorted asc)."""
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"{n} requests exceed the largest bucket "
                     f"{max(buckets)}")


class Servable:
    """Base: a named model whose programs the server compiles and pins."""

    name: str = "servable"

    def weights(self) -> Dict[str, TensorRelation]:
        """Weight input relations fed to every dispatch (long-lived)."""
        raise NotImplementedError

    def programs(self) -> List[Dict[str, Expr]]:
        """Every program to compile at warmup (one per served shape)."""
        raise NotImplementedError


class BatchServable(Servable):
    """Stateless scoring over bucket-padded batched relations."""

    buckets: Tuple[int, ...] = DEFAULT_BUCKETS

    def program(self, bucket: int) -> Dict[str, Expr]:
        raise NotImplementedError

    def pack(self, payloads: Sequence, bucket: int
             ) -> Dict[str, TensorRelation]:
        raise NotImplementedError

    def unpack(self, outs: Dict[str, TensorRelation], n: int) -> List:
        raise NotImplementedError

    def oracle(self, payload) -> np.ndarray:
        raise NotImplementedError

    def warmup_payload(self):
        """A payload the server dispatches once per bucket at warmup (see
        :meth:`~repro_torch.serve.server.TraServer.warmup`); ``None``
        skips those dispatches."""
        return None

    def programs(self) -> List[Dict[str, Expr]]:
        return [self.program(b) for b in self.buckets]


class StepServable(Servable):
    """Fixed-capacity slot-keyed step decode (continuous batching).

    Interface only in this slice: :class:`~repro_torch.serve.server.
    TraServer` refuses step servables until the decode slice (3)."""

    capacity: int = 8

    def step_program(self) -> Dict[str, Expr]:
        """Named roots; must include ``"state"`` (threaded) and
        ``"logits"`` (per-slot outputs)."""
        raise NotImplementedError

    def init_state(self) -> TensorRelation:
        raise NotImplementedError

    def step_inputs(self, tokens: Sequence[Optional[int]]
                    ) -> Dict[str, TensorRelation]:
        """Non-state inputs for one tick; ``tokens[slot]`` is the token
        the slot consumes this tick (``None`` = free slot)."""
        raise NotImplementedError

    def next_token(self, logits_row: np.ndarray) -> int:
        raise NotImplementedError

    def oracle_decode(self, prompt: Sequence[int], max_new_tokens: int
                      ) -> Tuple[List[int], List[np.ndarray]]:
        raise NotImplementedError

    def programs(self) -> List[Dict[str, Expr]]:
        return [self.step_program()]


# ==========================================================================
# §5.3 FFNN scorer — the paper's evaluation network behind a request path
# ==========================================================================

class FFNNScorer(BatchServable):
    """The §5.3 two-layer FFNN as a stateless scoring servable.

    ``scores = σ(relu(X @ W1) @ W2)`` over block-chunked relations:
    requests are feature vectors packed into an ``X`` relation keyed
    ``(bucket, db)`` with ``(1, bd)`` row blocks.  The batch key dim is
    never contracted, so every request's scores are computed independently
    of its batch neighbours and zero-padded tail rows are inert.

    One program per bucket size; the weight relations are shared across
    buckets, so ``d_in = db·bd`` features in, ``d_out = lb·bl`` scores
    out.  With ``db > 2`` and ``hb > 2`` the optimizer lowers both
    products to ``FusedJoinAgg`` nodes, which reach the matmul kernel; at
    the default ``db = hb = 2`` it keeps the unfused pair (a tie in its
    ``tmp_floats`` tiebreak), exactly as the JAX package does.
    """

    name = "ffnn-scorer"

    def __init__(self, db: int = 2, hb: int = 2, lb: int = 1,
                 bd: int = 8, bh: int = 8, bl: int = 4,
                 buckets: Sequence[int] = DEFAULT_BUCKETS,
                 seed: int = 0, *, device: DeviceLike = "cuda",
                 weights: Optional[Mapping[str, np.ndarray]] = None):
        self.device = resolve_device(device)
        self.db, self.hb, self.lb = db, hb, lb
        self.bd, self.bh, self.bl = bd, bh, bl
        self.buckets = tuple(sorted(buckets))
        self.d_in = db * bd
        self.d_out = lb * bl
        w1_rt = RelType((db, hb), (bd, bh))
        w2_rt = RelType((hb, lb), (bh, bl))
        if weights is None:
            h = hb * bh
            gen = torch.Generator(device=self.device).manual_seed(seed)
            w1 = torch.randn((db, hb, bd, bh), generator=gen,
                             device=self.device) * (self.d_in ** -0.5)
            w2 = torch.randn((hb, lb, bh, bl), generator=gen,
                             device=self.device) * (h ** -0.5)
            self._weights = {"scorer.W1": TensorRelation(w1, w1_rt),
                             "scorer.W2": TensorRelation(w2, w2_rt)}
        else:
            from repro_torch.weights import relations_from_numpy
            self._weights = relations_from_numpy(
                weights, {"scorer.W1": w1_rt, "scorer.W2": w2_rt},
                self.device)
        self._row_rtype = RelType((db,), (1, bd))
        self._programs: Dict[int, Dict[str, Expr]] = {}

    @classmethod
    def from_numpy(cls, arrays: Mapping[str, np.ndarray], *,
                   device: DeviceLike = "cuda", **blocking) -> "FFNNScorer":
        """A scorer over given weights — ``{"scorer.W1": (db, hb, bd, bh),
        "scorer.W2": (hb, lb, bh, bl)}`` numpy arrays, the JAX scorer's
        ``weights()[k].data`` — instead of seeded random ones.  The
        blocking keywords (``db, hb, lb, bd, bh, bl, buckets``) must match
        the arrays' shapes."""
        return cls(device=device, weights=arrays, **blocking)

    def weights(self) -> Dict[str, TensorRelation]:
        return self._weights

    def program(self, bucket: int) -> Dict[str, Expr]:
        """The bucket's scoring program (built once, cached — reusing the
        identical ``Expr`` objects keeps the engine's structural cache
        key stable across dispatches)."""
        if bucket not in self._programs:
            if bucket not in self.buckets:
                raise ValueError(
                    f"bucket {bucket} not in {self.buckets}")
            x = E.input("X", (bucket, self.db), (1, self.bd))
            w1 = E.input("scorer.W1", (self.db, self.hb),
                         (self.bd, self.bh))
            w2 = E.input("scorer.W2", (self.hb, self.lb),
                         (self.bh, self.bl))
            a2 = ((x @ w1).map("relu") @ w2).map("sigmoid")
            self._programs[bucket] = {"scores": a2}
        return self._programs[bucket]

    # -- request packing ---------------------------------------------------
    def pack(self, payloads: Sequence, bucket: int
             ) -> Dict[str, TensorRelation]:
        from repro_torch.core.tra import pack_rows
        rows = []
        for p in payloads:
            arr = torch.as_tensor(p, dtype=torch.float32)
            if tuple(arr.shape) != (self.d_in,):
                raise ValueError(
                    f"scorer request must be a ({self.d_in},) feature "
                    f"vector, got {tuple(arr.shape)}")
            rows.append(arr.reshape(self.db, 1, self.bd))
        # packed on the host: one host-to-device copy per batch
        host = pack_rows(rows, bucket, self._row_rtype)
        return {"X": TensorRelation(host.data.to(self.device), host.rtype)}

    def unpack(self, outs: Dict[str, TensorRelation], n: int) -> List:
        scores = outs["scores"].data[:n].reshape(n, self.d_out)
        return list(scores.cpu().numpy())

    def random_payload(self, rng: np.random.Generator) -> np.ndarray:
        return rng.standard_normal(self.d_in).astype(np.float32)

    def warmup_payload(self) -> np.ndarray:
        return np.zeros(self.d_in, np.float32)

    # -- dense oracle ------------------------------------------------------
    def oracle(self, payload) -> np.ndarray:
        """Per-request dense forward (plain torch, no Engine, no
        batching), on the scorer's device."""
        w1 = to_tensor(self._weights["scorer.W1"])
        w2 = to_tensor(self._weights["scorer.W2"])
        x = torch.as_tensor(payload, dtype=torch.float32, device=self.device)
        out = torch.sigmoid(torch.relu(x @ w1) @ w2)
        return out.cpu().numpy()
