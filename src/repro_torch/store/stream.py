"""Plan-level streaming through the host relation store.

Port of ``repro.store.stream``.  This generalizes the chunked
``fused_join_agg`` reduction (which streams *grid slices of one
contraction*) into an out-of-core pass over a whole logical plan: pick one
key dimension, slice every node that carries it, and execute the plan
chunk-by-chunk with per-chunk host→device copies double-buffered against
the in-flight chunk's compute.  Two schedules:

``stream-out``
    The streamed dimension survives to the *root output*.  Each chunk
    program computes an output key range; chunks either concatenate on
    the device or — when the output itself is oversized — append straight
    back into the :class:`~repro_torch.store.relation.RelationStore`, so
    multi-node plans (a two-matmul chain, the §5.3 layer stack) run with
    bounded device footprint and no whole-intermediate rematerialization.

``stream-reduce``
    The root is an associative ``TraAgg(TraJoin)`` contraction and the
    streamed dimension is *reduced away*.  Each chunk contributes a
    partial of the full output; partials fold on the device with the agg
    kernel — the paper's Σ∘⋈ streaming reduction lifted to key ranges
    whose operand slices live off-device until their turn.

The **carrier analysis** (:func:`_slot_walk`), the chunk programs
(:func:`_rebuild`) and :meth:`StreamExecutor.plan` are the JAX package's,
unchanged: pure shape arithmetic over
:func:`repro_torch.core.cost.plan_peak_bytes`, so the port picks the same
``StreamPlan`` (mode, dim, input dims, ``chunk_keys``, ``nkeys``) on the
same plan and budget.

Execution is rewritten for CUDA (the JAX version relies on
``jax.device_put`` and asynchronous dispatch):

* **Inputs.**  Host inputs are :class:`HostRelation`\\ s, numpy arrays and
  CPU tensors (CPU ``TensorRelation``\\ s too); tensors on the engine's
  device are resident.  On a card a streamed input's chunk is a fresh
  device tensor; each host block's slice is copied straight into its
  place in it (:func:`~repro_torch.store.relation.copy_into`, no host
  concatenation), from the store's page-locked blocks, or — for a host
  tensor that is not page-locked — through a page-locked staging tensor
  from torch's caching host allocator, which reuses a staging buffer only
  once the copy recorded on it has completed.  No copy reads pageable
  memory directly.
* **Streams and events.**  Chunk copies go on the executor's side stream;
  an event recorded after them is waited on by the compute stream before
  the chunk's program runs, and every device chunk tensor gets
  ``record_stream`` on the compute stream, so the caching allocator never
  hands its memory to the next prefetch while the program still reads it.
* **Prefetch order.**  Chunk ``i + 1``'s copies are issued *before* chunk
  ``i``'s program is launched: the port's program run does host work and
  may synchronize, which would serialize a copy issued after it.
* **Mesh engines.**  A streamed run driven through a ``gspmd`` or
  ``shard_map`` engine compiles its chunk programs on the engine's mesh:
  every rank passes the same global chunk, the executor takes its block
  by the placement (the streamed key dim partitioned across sites), and
  each chunk's result is read as its global value (``global_data``).
* **Timing.**  ``StreamStats.copy_s`` / ``hidden_copy_s`` come from CUDA
  events on a card (see :class:`repro_torch.launch.metering.StreamStats`);
  ``compute_s`` is host wall to the compute stream's synchronize, which
  leaves the copy stream's prefetch running.  On the CPU the host clock
  fills all three, as in JAX.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.cost import _itemsize, plan_peak_bytes
from repro_torch.core.plan import (TraAgg, TraConcat, TraConst, TraFilter,
                                   TraInput, TraJoin, TraNode, TraPad,
                                   TraReKey, TraTile, TraTransform, TypeInfo,
                                   as_node, infer, postorder)
from repro_torch.core.tra import TensorRelation, can_fuse, global_data
from repro_torch.store.autotune import stream_budget_bytes
from repro_torch.store.relation import HostRelation, RelationStore, copy_into


class NotStreamable(RuntimeError):
    """The plan (or this run's inputs) cannot take the streaming path."""


@dataclasses.dataclass
class StreamPlan:
    """Compile-time streaming decision for one logical root."""

    mode: str                       # resident | stream-out | stream-reduce
    root: TraNode
    out_info: TypeInfo
    budget: Optional[int] = None
    dim: int = -1                   # streamed output / join-out key dim
    sliced: Dict[int, int] = dataclasses.field(default_factory=dict)
    input_dims: Dict[str, int] = dataclasses.field(default_factory=dict)
    chunk_keys: int = 0
    nkeys: int = 0
    out_store: bool = False
    agg_kernel: object = None       # stream-reduce fold kernel

    @property
    def nchunks(self) -> int:
        if self.mode == "resident" or self.chunk_keys < 1:
            return 1
        return -(-self.nkeys // self.chunk_keys)


def _slot_walk(root: TraNode, start: TraNode, start_dim: int,
               types: Dict[int, TypeInfo],
               reject: Optional[list] = None) -> Optional[Dict[int, int]]:
    """Map ``{id(node): key dim}`` for every node the streamed dim carries
    through, or None when the plan rejects this dimension.

    When ``reject`` is a list, every rejection appends a ``(node,
    reason)`` pair — the provenance the static verifier's stream-carrier
    pass of the JAX package renders per candidate dim."""
    sliced: Dict[int, int] = {}
    whole: List[TraNode] = []
    ok = True

    def refuse(n, reason: str) -> None:
        nonlocal ok
        ok = False
        if reject is not None:
            reject.append((n, reason))

    def ka(n) -> int:
        return types[id(n)].rtype.key_arity

    def walk(n, d) -> None:
        if not ok:
            return
        prev = sliced.get(id(n))
        if prev is not None:
            if prev != d:
                refuse(n, f"needs slicing along two key dims "
                          f"({prev} and {d}) at once")
            return
        sliced[id(n)] = d
        if isinstance(n, (TraInput, TraConst)):
            return
        if isinstance(n, TraTransform):
            walk(n.child, d)
        elif isinstance(n, TraAgg):
            walk(n.child, n.group_by[d])
        elif isinstance(n, TraJoin):
            kl = ka(n.left)
            if d < kl:
                walk(n.left, d)
                if d in n.join_keys_l:
                    # joined dim: min-frontier rule — slice BOTH sides
                    walk(n.right, n.join_keys_r[n.join_keys_l.index(d)])
                else:
                    whole.append(n.right)
            else:
                whole.append(n.left)
                r_nonjoin = [dd for dd in range(ka(n.right))
                             if dd not in n.join_keys_r]
                walk(n.right, r_nonjoin[d - kl])
        elif isinstance(n, TraTile):
            if d < ka(n.child):
                walk(n.child, d)
            else:
                refuse(n, "the appended tile dim indexes array tiles, "
                          "not a sliceable key range")
        elif isinstance(n, TraConcat):
            walk(n.child, d if d < n.key_dim else d + 1)
        else:
            # TraReKey / TraFilter / TraPad: arbitrary key rewrites — a key
            # range of the output has no static preimage range
            refuse(n, "arbitrary key rewrite: an output key range has no "
                      "static preimage range to slice")

    walk(start, start_dim)
    if not ok:
        return None
    whole_ids = set()
    for w in whole:
        for n in postorder(w):
            whole_ids.add(id(n))
    conflicted = whole_ids & set(sliced)
    if conflicted:
        for n in postorder(root):
            if id(n) in conflicted:
                refuse(n, "subtree is needed both sliced and whole "
                          "(it feeds a join side the streamed dim does "
                          "not reach)")
                break
        return None
    name_dim: Dict[str, int] = {}
    for n in postorder(root):
        if isinstance(n, TraInput) and id(n) in sliced:
            d = sliced[id(n)]
            if name_dim.setdefault(n.name, d) != d:
                refuse(n, f"input {n.name!r} would have to stream along "
                          f"two different key dims "
                          f"({name_dim[n.name]} and {d})")
                return None
    for n in postorder(root):
        if isinstance(n, TraInput) and id(n) not in sliced \
                and n.name in name_dim:
            refuse(n, f"input {n.name!r} is needed both sliced and whole "
                      f"(it appears in a resident subtree too)")
            return None
    if not name_dim:
        refuse(root, "no input is actually sliced along this dim — "
                     "nothing would stream")
        return None
    return sliced


def _rebuild(root: TraNode, sliced: Dict[int, int], length: int) -> TraNode:
    """The chunk program: ``root`` with every sliced node's streamed key
    dim shrunk to ``length``.  Whole subtrees are reused as the SAME
    objects, so their plan signatures — and the Engine's structural
    compile cache entries — are shared across every chunk."""
    memo: Dict[int, TraNode] = {}

    def rb(n):
        if id(n) in memo:
            return memo[id(n)]
        if isinstance(n, (TraInput, TraConst)):
            if id(n) in sliced:
                d = sliced[id(n)]
                ks = list(n.rtype.key_shape)
                ks[d] = length
                out = dataclasses.replace(n, rtype=n.rtype.with_key_shape(ks))
            else:
                out = n
        else:
            if isinstance(n, TraJoin):
                kids = {"left": rb(n.left), "right": rb(n.right)}
                changed = kids["left"] is not n.left \
                    or kids["right"] is not n.right
            else:
                kids = {"child": rb(n.child)}
                changed = kids["child"] is not n.child
            out = dataclasses.replace(n, **kids) if changed else n
        memo[id(n)] = out
        return out

    return rb(root)


class StreamExecutor:
    """Schedules a logical plan through the store under a byte budget.

    Owned by an :class:`~repro_torch.core.engine.Engine`; ``plan`` runs at
    compile time (pure shape/byte analysis), ``execute`` drives the
    double-buffered chunk loop and accounts every transfer into a
    :class:`~repro_torch.launch.metering.StreamStats`.
    """

    def __init__(self, engine, store: Optional[RelationStore] = None,
                 budget: Optional[int] = None) -> None:
        self.engine = engine
        self.store = store if store is not None else engine.store
        self.budget = budget if budget is not None \
            else getattr(engine, "memory_budget", None)
        self.device = getattr(engine, "device", torch.device("cpu"))
        self._copy_stream = None

    # ------------------------------------------------------------------
    # planning
    # ------------------------------------------------------------------
    def plan(self, root, *, force: bool = False,
             chunk_keys: Optional[int] = None) -> StreamPlan:
        root = as_node(root)
        if not isinstance(root, TraNode):
            raise NotStreamable(
                "only logical (TRA) roots stream through the store")
        types: Dict[int, TypeInfo] = {}
        out_info = infer(root, cache=types)
        budget = stream_budget_bytes(self.budget, self.device)
        total = plan_peak_bytes(root, fuse=getattr(self.engine, "fuse", True))
        if total <= budget and not force:
            return StreamPlan("resident", root, out_info, budget)
        # masks (static on types, or runtime ones minted by in-plan
        # filters/rekeys/pads) violate the continuity the chunk
        # concatenation relies on — those plans only run resident
        holey = any(types[id(n)].mask is not None
                    or isinstance(n, (TraFilter, TraPad, TraReKey))
                    for n in postorder(root))
        if holey:
            if force:
                raise NotStreamable(
                    "streaming requires continuous relations (masked "
                    "types or in-plan filter/rekey/pad run resident)")
            return StreamPlan("resident", root, out_info, budget)

        # -- stream-out: a root output key dim, largest first ------------
        out_ks = out_info.rtype.key_shape
        for d in sorted(range(len(out_ks)), key=lambda dd: -out_ks[dd]):
            nk = out_ks[d]
            if nk < 2:
                continue
            sliced = _slot_walk(root, root, d, types)
            if sliced is None:
                continue
            ck = self._chunk_keys(root, sliced, types, nk, budget, force,
                                  chunk_keys)
            if ck is None:
                continue
            out_bytes = out_info.rtype.nfloats * _itemsize(out_info.rtype)
            sp = StreamPlan("stream-out", root, out_info, budget, d, sliced,
                            self._input_dims(root, sliced), ck, nk,
                            out_store=out_bytes > budget // 2)
            return sp

        # -- stream-reduce: associative contraction over a reduced dim ---
        if isinstance(root, TraAgg) and isinstance(root.child, TraJoin) \
                and root.kernel.is_associative \
                and can_fuse(root.child.kernel, root.kernel):
            join = root.child
            j_ks = types[id(join)].rtype.key_shape
            red = [d for d in range(len(j_ks)) if d not in root.group_by]
            for d in sorted(red, key=lambda dd: -j_ks[dd]):
                nk = j_ks[d]
                if nk < 2:
                    continue
                sliced = _slot_walk(root, join, d, types)
                if sliced is None:
                    continue
                ck = self._chunk_keys(root, sliced, types, nk, budget,
                                      force, chunk_keys)
                if ck is None:
                    continue
                return StreamPlan("stream-reduce", root, out_info, budget,
                                  d, sliced,
                                  self._input_dims(root, sliced), ck, nk,
                                  agg_kernel=root.kernel)
        raise NotStreamable(
            "no streamable key dimension found (key rewrites, tiled dims, "
            "or conflicting slice requirements block every candidate)")

    @staticmethod
    def _input_dims(root, sliced) -> Dict[str, int]:
        return {n.name: sliced[id(n)] for n in postorder(root)
                if isinstance(n, TraInput) and id(n) in sliced}

    def _chunk_keys(self, root, sliced, types, nkeys, budget, force,
                    override) -> Optional[int]:
        if override is not None:
            return max(1, min(int(override), nkeys))
        fuse = getattr(self.engine, "fuse", True)
        p1 = plan_peak_bytes(_rebuild(root, sliced, 1), fuse=fuse)
        p2 = plan_peak_bytes(_rebuild(root, sliced, 2), fuse=fuse) \
            if nkeys >= 2 else p1
        slope = max(1, p2 - p1)
        fixed = max(0, p1 - slope)
        # the prefetched next chunk's input slices are live during compute
        prefetch = 0
        for n in postorder(root):
            if isinstance(n, TraInput) and id(n) in sliced:
                ti = types[id(n)]
                per = (ti.rtype.nfloats * _itemsize(ti.rtype)
                       // max(1, ti.rtype.key_shape[sliced[id(n)]]))
                prefetch += per
        ck = (budget - fixed) // max(1, slope + prefetch)
        if ck < 1:
            if not force:
                return None
            ck = 1
        if ck >= nkeys:
            if not force:
                return None     # resident part alone is over budget
            ck = max(1, nkeys // 4)
        return int(ck)

    # ------------------------------------------------------------------
    # execution
    # ------------------------------------------------------------------
    def execute(self, splan: StreamPlan, env: Dict[str, object], stats):
        stores = {self.store}
        for v in env.values():
            if isinstance(v, HostRelation):
                stores.add(v.store)
        spill0 = sum(s.spill_events for s in stores)
        spillb0 = sum(s.spill_bytes for s in stores)
        try:
            if splan.mode == "resident" or self._must_run_resident(env):
                out = self._run_resident(splan, env, stats)
            elif splan.mode == "stream-out":
                out = self._run_stream_out(splan, env, stats)
            else:
                out = self._run_stream_reduce(splan, env, stats)
        finally:
            stats.runs += 1
            stats.spill_events += sum(s.spill_events for s in stores) - spill0
            stats.spill_bytes += sum(s.spill_bytes for s in stores) - spillb0
        return out

    @staticmethod
    def _must_run_resident(env) -> bool:
        # masked values violate continuity — only the materialized path
        # (whose executors already know the mask rules) may run them
        return any(getattr(v, "mask", None) is not None
                   for v in env.values())

    def _needed(self, root, env) -> Dict[str, object]:
        names = {n.name for n in postorder(root) if isinstance(n, TraInput)}
        return {k: v for k, v in env.items() if k in names}

    @property
    def _cuda(self) -> bool:
        return self.device.type == "cuda"

    def _on_device(self, data) -> bool:
        return isinstance(data, torch.Tensor) and data.device == self.device

    @staticmethod
    def _host(data, rtype) -> torch.Tensor:
        """A host value's CPU tensor (numpy arrays wrapped, not copied,
        when their dtype is the relation's)."""
        if isinstance(data, np.ndarray):
            data = torch.from_numpy(np.ascontiguousarray(data))
        if data.device.type != "cpu":
            raise ValueError(
                f"input on {data.device} is neither on the engine's device "
                f"nor on the host")
        return data.to(rtype.dtype)

    def _to_device(self, value, rtype, stats) -> object:
        """A resident input on the engine's device (host values copied
        whole, counted in ``h2d_bytes``)."""
        if isinstance(value, HostRelation):
            rel = value.to_relation(self.device)
            stats.h2d_bytes += rel.data.numel() * rel.data.element_size()
            return rel
        data = value.data if isinstance(value, TensorRelation) else value
        if self._on_device(data):
            return value
        host = self._host(data, rtype)
        dev = torch.empty(tuple(host.shape), dtype=host.dtype,
                          device=self.device)
        copy_into(dev, 0, 0, host)
        stats.h2d_bytes += dev.numel() * dev.element_size()
        if isinstance(value, TensorRelation):
            return TensorRelation(dev, value.rtype, value.mask)
        return dev

    def _run_resident(self, splan, env, stats):
        rtypes = self._rtypes(splan.root)
        mat = {k: self._to_device(v, rtypes[k], stats)
               for k, v in self._needed(splan.root, env).items()}
        stats.mode = "resident"
        return self.engine.compile(splan.root).run(**mat)

    @staticmethod
    def _rtypes(root) -> Dict[str, object]:
        return {n.name: n.rtype for n in postorder(root)
                if isinstance(n, TraInput)}

    def _load_chunk(self, splan, env, lo, hi, stats, hidden) -> "_Chunk":
        """Issue the copies of keys ``[lo, hi)`` of every streamed input
        (on the copy stream, on a card) and return them as a pending
        :class:`_Chunk`."""
        rtypes = self._rtypes(splan.root)
        chunk = _Chunk()
        t0 = time.perf_counter()
        if self._cuda:
            chunk.copy_start = torch.cuda.Event(enable_timing=True)
            chunk.copy_end = torch.cuda.Event(enable_timing=True)
            ctx = torch.cuda.stream(self._copy_stream)
            chunk.copy_start.record(self._copy_stream)
        else:
            ctx = contextlib.nullcontext()
        moved = 0
        with ctx:
            for name, d in splan.input_dims.items():
                v = env[name]
                rt = rtypes[name]
                if isinstance(v, HostRelation):
                    if v.split_dim != d:
                        raise NotStreamable(
                            f"input {name!r} is blocked along key dim "
                            f"{v.split_dim} but the plan streams dim {d}")
                    shape = list(v.shape)
                    shape[d] = hi - lo
                    dev = torch.empty(shape, dtype=rt.dtype,
                                      device=self.device)
                    for off, view in v.blocks_in(lo, hi):
                        copy_into(dev, d, off, view)
                    moved += dev.numel() * dev.element_size()
                    chunk.copied.append(dev)
                    chunk.values[name] = dev
                    continue
                data = v.data if isinstance(v, TensorRelation) else v
                if self._on_device(data):
                    # already device-resident: a view, no copy
                    chunk.values[name] = data.narrow(d, lo, hi - lo)
                    continue
                src = self._host(data, rt).narrow(d, lo, hi - lo)
                dev = torch.empty(tuple(src.shape), dtype=rt.dtype,
                                  device=self.device)
                copy_into(dev, 0, 0, src)
                moved += dev.numel() * dev.element_size()
                chunk.copied.append(dev)
                chunk.values[name] = dev
        if self._cuda:
            chunk.copy_end.record(self._copy_stream)
        else:
            dt = time.perf_counter() - t0
            stats.copy_s += dt
            if hidden:
                stats.hidden_copy_s += dt
        stats.h2d_bytes += moved
        chunk.nbytes = sum(a.numel() * a.element_size()
                           for a in chunk.values.values())
        return chunk

    def _ready(self, chunk: "_Chunk") -> Dict[str, object]:
        """Order the compute stream after the chunk's copies; its values."""
        if self._cuda:
            cs = torch.cuda.current_stream(self.device)
            chunk.wait_start = torch.cuda.Event(enable_timing=True)
            chunk.wait_end = torch.cuda.Event(enable_timing=True)
            chunk.wait_start.record(cs)
            cs.wait_event(chunk.copy_end)
            chunk.wait_end.record(cs)
            for t in chunk.copied:
                t.record_stream(cs)
        return chunk.values

    def _sync(self, stats, t0: float, chunk: "_Chunk") -> None:
        """End of a chunk: wait for the compute stream (the copy stream's
        prefetch runs on), then account the chunk's times."""
        if self._cuda:
            torch.cuda.current_stream(self.device).synchronize()
            copy = chunk.copy_start.elapsed_time(chunk.copy_end) / 1e3
            waited = chunk.wait_start.elapsed_time(chunk.wait_end) / 1e3
            stats.copy_s += copy
            stats.hidden_copy_s += max(0.0, copy - waited)
        stats.compute_s += time.perf_counter() - t0
        stats.chunks += 1

    def _spans(self, splan) -> List[Tuple[int, int]]:
        nk, ck = splan.nkeys, splan.chunk_keys
        return [(lo, min(lo + ck, nk)) for lo in range(0, nk, ck)]

    def _chunk_programs(self, splan, spans):
        progs = {}
        for lo, hi in spans:
            n = hi - lo
            if n not in progs:
                progs[n] = self.engine.compile(
                    _rebuild(splan.root, splan.sliced, n))
        return progs

    def _resident_env(self, splan, env, stats):
        rtypes = self._rtypes(splan.root)
        need = self._needed(splan.root, env)
        res = {k: self._to_device(v, rtypes[k], stats)
               for k, v in need.items() if k not in splan.input_dims}
        rbytes = 0
        for v in res.values():
            data = v.data if isinstance(v, TensorRelation) else v
            rbytes += data.numel() * data.element_size()
        return res, rbytes

    def _start(self, splan, env, stats):
        if self._cuda and self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(self.device)
        spans = self._spans(splan)
        progs = self._chunk_programs(splan, spans)
        resident, resident_bytes = self._resident_env(splan, env, stats)
        return spans, progs, resident, resident_bytes

    def _run_stream_out(self, splan, env, stats):
        stats.mode = "stream-out"
        stats.budget_bytes = splan.budget
        spans, progs, resident, resident_bytes = self._start(splan, env,
                                                             stats)
        out_hr = None
        if splan.out_store:
            out_hr = self.store.create(
                f"stream-out:{id(splan.root):x}", splan.out_info.rtype,
                split_dim=splan.dim)
        collected, kept_bytes = [], 0
        pending = self._load_chunk(splan, env, *spans[0], stats,
                                   hidden=False)
        for i, (lo, hi) in enumerate(spans):
            cur = pending
            t0 = time.perf_counter()
            # the next chunk's copies are issued before this chunk's
            # program runs, so they overlap it
            pending = self._load_chunk(splan, env, *spans[i + 1], stats,
                                       hidden=True) \
                if i + 1 < len(spans) else None
            out = global_data(
                progs[hi - lo].run(**self._ready(cur), **resident).data)
            self._sync(stats, t0, cur)
            out_bytes = out.numel() * out.element_size()
            peak = (resident_bytes + cur.nbytes
                    + (pending.nbytes if pending is not None else 0)
                    + out_bytes + kept_bytes)
            stats.peak_device_bytes = max(stats.peak_device_bytes, peak)
            del cur
            if out_hr is not None:
                host = out.cpu()                        # D2H
                stats.d2h_bytes += host.numel() * host.element_size()
                out_hr.append(host)
            else:
                collected.append(out)
                kept_bytes += out_bytes
        if out_hr is not None:
            return out_hr
        data = torch.cat(collected, dim=splan.dim)
        stats.peak_device_bytes = max(
            stats.peak_device_bytes,
            resident_bytes + kept_bytes
            + data.numel() * data.element_size())
        return TensorRelation(data, splan.out_info.rtype, None)

    def _run_stream_reduce(self, splan, env, stats):
        stats.mode = "stream-reduce"
        stats.budget_bytes = splan.budget
        spans, progs, resident, resident_bytes = self._start(splan, env,
                                                             stats)
        acc = None
        pending = self._load_chunk(splan, env, *spans[0], stats,
                                   hidden=False)
        for i, (lo, hi) in enumerate(spans):
            cur = pending
            t0 = time.perf_counter()
            pending = self._load_chunk(splan, env, *spans[i + 1], stats,
                                       hidden=True) \
                if i + 1 < len(spans) else None
            part = global_data(
                progs[hi - lo].run(**self._ready(cur), **resident).data)
            acc = part if acc is None \
                else splan.agg_kernel.apply(acc, part)
            del part
            self._sync(stats, t0, cur)
            peak = (resident_bytes + cur.nbytes
                    + (pending.nbytes if pending is not None else 0)
                    + 2 * acc.numel() * acc.element_size())
            stats.peak_device_bytes = max(stats.peak_device_bytes, peak)
            del cur
        return TensorRelation(acc, splan.out_info.rtype, None)


@dataclasses.dataclass
class _Chunk:
    """One chunk's streamed inputs: device values by input name, the
    tensors its copies wrote (for ``record_stream``), and on a card the
    events around its copies (copy stream) and around the compute
    stream's wait for them."""

    values: Dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)
    copied: List[torch.Tensor] = dataclasses.field(default_factory=list)
    nbytes: int = 0
    copy_start: Optional[object] = None
    copy_end: Optional[object] = None
    wait_start: Optional[object] = None
    wait_end: Optional[object] = None
