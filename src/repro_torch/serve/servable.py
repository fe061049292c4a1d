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
* :class:`StepServable` — stateful step decode.  ONE program over a
  **fixed-capacity slot-keyed state relation**: the leading key dim indexes
  decode slots, admission/eviction are functional row writes
  (``tra.scatter_rows`` / ``tra.zero_rows``), and the compiled step is
  re-dispatched every tick with state threaded state-out → state-in by
  name.  :class:`RecurrentLM` is the smoke LM — an Elman-style recurrence
  sized from any model config.

Every servable carries a dense per-request **oracle** (plain torch, no
Engine) — the correctness reference for batched serving.

Deviations from the JAX module: servables take a ``device`` (default
``"cuda"``; without a card that default raises — pass ``device="cpu"``);
``FFNNScorer`` and ``RecurrentLM`` draw their weights from a
``torch.Generator`` on that device seeded with ``seed`` (other numbers than
``jax.random`` gives; carry JAX weights over with ``from_numpy``).
``RecurrentLM`` keeps its embedding table on the device, where JAX keeps a
host numpy table and gathers the live slots' rows in numpy: at gemma2-2b
width the table is 256000×2304 f32 (2.36 GB), which numpy draws slowly, and
each tick would copy its (capacity, d) rows to the card.  Each tick gathers
a fixed-size index
— one entry a slot, free slots masked to zero rows — so the device shapes
still never depend on how many slots are live, as JAX's reason for the
host table requires.
"""
from __future__ import annotations

import dataclasses
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

    Subclasses set ``device``: where the state lives and
    :meth:`restore_state` puts it back."""

    capacity: int = 8
    device: torch.device

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

    # -- fault recovery ----------------------------------------------------
    def snapshot_state(self, state: TensorRelation) -> TensorRelation:
        """Host copy of the slot-keyed state — the recovery point the
        server commits after every good tick.  A copy in host memory,
        detached from the device tensor, so a faulted dispatch can neither
        corrupt nor free it.  Reading it synchronises with the device."""
        return TensorRelation(state.data.detach().to("cpu", copy=True),
                              state.rtype, state.mask)

    def restore_state(self, snapshot: TensorRelation) -> TensorRelation:
        """A fresh device copy of a :meth:`snapshot_state` copy, on the
        servable's device (the snapshot itself stays untouched)."""
        return TensorRelation(snapshot.data.to(self.device, copy=True),
                              snapshot.rtype, snapshot.mask)

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


# ==========================================================================
# Smoke LM — an Elman recurrence sized from a model config
# ==========================================================================

@dataclasses.dataclass
class LmRequest:
    """A decode request: prompt token ids + generation budget."""

    prompt: List[int]
    max_new_tokens: int

    def __post_init__(self):
        if not self.prompt:
            raise ValueError("LmRequest needs a non-empty prompt")
        if self.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")


class RecurrentLM(StepServable):
    """Elman-style recurrent LM as ONE fixed-capacity TRA step program.

    Per slot: ``h' = relu(h @ Wh + emb(tok) @ Wx)``, ``logits = h' @ Wo``
    — greedy sampling happens host-side, the recurrent state lives in the
    slot-keyed relation ``lm.state`` (key ``(capacity, 1)``, bound ``(1,
    d)``).  The step program updates state through
    :meth:`~repro_torch.core.expr.Expr.slot_update` with the ``lm.active``
    mask relation, so free / mid-eviction slots hold their rows bit-exactly
    while neighbours decode.

    Sized from any model config via :meth:`from_config` (``d_model`` /
    ``vocab_size``); the weights are seeded Gaussians with sub-unit
    recurrent gain so long decodes stay bounded.  The embedding table
    (``embedding``, (vocab, d) f32) lives on the device (see the module
    docstring).
    """

    name = "recurrent-lm"

    def __init__(self, d_model: int = 64, vocab_size: int = 256,
                 capacity: int = 8, seed: int = 0, *,
                 device: DeviceLike = "cuda",
                 weights: Optional[Mapping[str, np.ndarray]] = None,
                 embedding: Optional[np.ndarray] = None):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.device = resolve_device(device)
        self.d = int(d_model)
        self.vocab = int(vocab_size)
        self.capacity = int(capacity)
        d, v = self.d, self.vocab
        rtypes = {"lm.Wh": RelType((1, 1), (d, d)),
                  "lm.Wx": RelType((1, 1), (d, d)),
                  "lm.Wo": RelType((1, 1), (d, v))}
        if weights is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)

            def draw(shape, scale):
                return torch.randn(shape, generator=gen,
                                   device=self.device) * scale

            # sub-unit recurrent gain: relu(h·Wh + e·Wx) stays bounded over
            # arbitrarily long decodes
            wh = draw((d, d), 0.5 * d ** -0.5)
            wx = draw((d, d), d ** -0.5)
            wo = draw((d, v), d ** -0.5)
            self._weights = {
                name: TensorRelation(w[None, None], rtypes[name])
                for name, w in (("lm.Wh", wh), ("lm.Wx", wx), ("lm.Wo", wo))}
            self.embedding = draw((v, d), d ** -0.5)
        else:
            from repro_torch.weights import lm_weights_from_numpy
            self._weights, self.embedding = lm_weights_from_numpy(
                weights, embedding, rtypes, self.device)
        self._program: Optional[Dict[str, Expr]] = None
        self._state_rtype = RelType((self.capacity, 1), (1, d))

    @classmethod
    def from_config(cls, cfg, capacity: int = 8, seed: int = 0, *,
                    device: DeviceLike = "cuda") -> "RecurrentLM":
        """Size the LM from a model config."""
        return cls(d_model=cfg.d_model, vocab_size=cfg.vocab_size,
                   capacity=capacity, seed=seed, device=device)

    @classmethod
    def from_numpy(cls, arrays: Mapping[str, np.ndarray],
                   embedding: np.ndarray, *, capacity: int = 8,
                   device: DeviceLike = "cuda") -> "RecurrentLM":
        """An LM over given weights — ``{"lm.Wh": (1, 1, d, d), "lm.Wx":
        (1, 1, d, d), "lm.Wo": (1, 1, d, vocab)}`` numpy arrays, the JAX
        LM's ``weights()[k].data``, and its ``embedding`` (vocab, d) —
        instead of seeded random ones (see
        :func:`repro_torch.weights.lm_weights_from_numpy`)."""
        if "lm.Wo" not in arrays:
            raise ValueError(f"weights {sorted(arrays)} lack lm.Wo")
        d, v = np.shape(arrays["lm.Wo"])[-2:]
        return cls(d_model=d, vocab_size=v, capacity=capacity,
                   device=device, weights=arrays, embedding=embedding)

    def weights(self) -> Dict[str, TensorRelation]:
        return self._weights

    def step_program(self) -> Dict[str, Expr]:
        if self._program is None:
            c, d, v = self.capacity, self.d, self.vocab
            s = E.input("lm.state", (c, 1), (1, d))
            emb = E.input("lm.emb", (c, 1), (1, d))
            active = E.input("lm.active", (c, 1), (1, 1))
            wh = E.input("lm.Wh", (1, 1), (d, d))
            wx = E.input("lm.Wx", (1, 1), (d, d))
            wo = E.input("lm.Wo", (1, 1), (d, v))
            h = ((s @ wh) + (emb @ wx)).map("relu")
            self._program = {"state": s.slot_update(h, active),
                             "logits": h @ wo}
        return self._program

    def init_state(self) -> TensorRelation:
        c, d = self.capacity, self.d
        return TensorRelation(
            torch.zeros((c, 1, 1, d), dtype=torch.float32,
                        device=self.device), self._state_rtype)

    def step_inputs(self, tokens: Sequence[Optional[int]]
                    ) -> Dict[str, TensorRelation]:
        """``lm.emb`` and ``lm.active`` for one tick: one gather of
        ``capacity`` table rows on the device (a free slot reads row 0 and
        is masked to zeros) from one host-to-device copy of the slots'
        token ids."""
        c, d = self.capacity, self.d
        if len(tokens) != c:
            raise ValueError(f"need {c} per-slot tokens, got {len(tokens)}")
        ids = [-1 if t is None else int(t) for t in tokens]
        bad = [t for t, i in zip(tokens, ids)
               if t is not None and not 0 <= i < self.vocab]
        if bad:
            raise ValueError(f"token ids {bad} outside the vocabulary of "
                             f"{self.vocab}")
        idx = torch.tensor(ids, dtype=torch.int64).to(self.device)
        live = (idx >= 0)[:, None]
        emb = torch.where(live, self.embedding[idx.clamp(min=0)],
                          torch.zeros((), dtype=self.embedding.dtype,
                                      device=self.device))
        return {"lm.emb": TensorRelation(emb.reshape(c, 1, 1, d),
                                         RelType((c, 1), (1, d))),
                "lm.active": TensorRelation(
                    live.to(torch.float32).reshape(c, 1, 1, 1),
                    RelType((c, 1), (1, 1)))}

    def next_token(self, logits_row: np.ndarray) -> int:
        return int(np.argmax(logits_row))

    # -- dense oracle ------------------------------------------------------
    def oracle_step(self, h: torch.Tensor, token: int
                    ) -> Tuple[torch.Tensor, np.ndarray]:
        """One dense recurrence step (plain torch on the LM's device):
        ``(h', logits)`` for one sequence."""
        wh = self._weights["lm.Wh"].data[0, 0]
        wx = self._weights["lm.Wx"].data[0, 0]
        wo = self._weights["lm.Wo"].data[0, 0]
        h2 = torch.relu(h @ wh + self.embedding[token][None, :] @ wx)
        return h2, (h2 @ wo)[0].cpu().numpy()

    def oracle_decode(self, prompt: Sequence[int], max_new_tokens: int
                      ) -> Tuple[List[int], List[np.ndarray]]:
        """Greedy per-request dense decode: ``(tokens, per-token logits)``,
        one logits row per *generated* token — the reference the
        continuously batched server must match regardless of which slots
        its neighbours occupied."""
        h = torch.zeros((1, self.d), dtype=torch.float32, device=self.device)
        for t in prompt[:-1]:
            h, _ = self.oracle_step(h, int(t))
        tok = int(prompt[-1])
        out_tokens: List[int] = []
        out_logits: List[np.ndarray] = []
        for _ in range(max_new_tokens):
            h, logits = self.oracle_step(h, tok)
            tok = self.next_token(logits)
            out_tokens.append(tok)
            out_logits.append(logits)
        return out_tokens, out_logits
