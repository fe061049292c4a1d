"""Host-RAM relation store: chunked, key-range-partitioned tensor relations.

Port of ``repro.store.relation``.  The paper's headline claim — TRA handles
"matrices or tensors that do not easily fit into the RAM of an ASIC" —
needs relations that *live off the device*.  A :class:`HostRelation` is a
handle to one tensor relation held as an ordered list of contiguous
key-range **blocks** along a single key dimension (``split_dim``).  The
handle is usable anywhere ``Engine.run`` accepts a relation: the Engine
either streams it chunk-by-chunk through the plan
(:mod:`repro_torch.store.stream`) or materializes it once on the device when
the plan fits.

A :class:`RelationStore` owns the blocks.  It tracks resident host bytes
and, past an optional ``ram_limit_bytes``, spills least-recently-used
blocks to a disk tier (``.npy`` files under ``spill_dir``), faulting them
back in transparently on access.  Spill writes are atomic (temp file +
``os.replace``) and carry a content checksum (zlib's crc32) verified on
fault-in; a torn or corrupt spill file raises :class:`SpillCorruption`.

Blocks are split at ``block_bytes`` targets (default 64 MiB) so spill and
streaming granularity stay decoupled from how the user hands the data in.

Deviations from the JAX module:

* A block is a CPU ``torch.Tensor`` of the relation's torch dtype, not a
  numpy array.  Where a card is present (``torch.cuda.is_available()``,
  read when the store is made) every block is allocated
  **page-locked at admit**, and a spilled block reloads into page-locked
  memory: the stream executor's host→device copy of a block is then an
  asynchronous DMA, never a copy through pageable memory.  Pinning costs
  the relation's size in page-locked host memory for as long as the block
  is resident, and one host copy at admit.
* A spill file holds the block's raw bytes as a ``uint8`` ``.npy`` (any
  torch dtype, bf16 included), checksummed over those bytes.
* ``slice`` returns a CPU tensor (one block's view, or a concatenation when
  the range spans blocks); ``blocks_in`` yields the per-block views the
  stream executor copies into their places in a device chunk.
  ``to_relation`` takes the device to materialize on (the JAX version uses
  the default device).
"""
from __future__ import annotations

import dataclasses
import math
import os
import tempfile
import zlib
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.tra import RelType, TensorRelation
from repro_torch.device import DeviceLike, resolve_device

DEFAULT_BLOCK_BYTES = 64 * 1024 * 1024


class StoreError(RuntimeError):
    """Raised on malformed store usage (shape/range mismatches)."""


class SpillCorruption(StoreError):
    """A spilled block failed verification on fault-in.

    Raised when a disk-tier ``.npy`` file is unreadable (torn write,
    truncation) or reads back with a different content checksum than the
    block record carries — the store refuses to hand back silently wrong
    data.  Spill writes go through a temp file + ``os.replace`` so a
    crash mid-spill can at worst leave a stale-but-whole previous
    version, never a half-written one.
    """


@dataclasses.dataclass
class _Block:
    """One contiguous key-range ``[start, stop)`` along the split dim."""

    start: int
    stop: int
    data: Optional[torch.Tensor]    # None while spilled to disk
    shape: Tuple[int, ...] = ()
    dtype: torch.dtype = torch.float32
    path: Optional[str] = None      # .npy file when spilled
    nbytes: int = 0
    seq: int = 0                    # LRU clock; larger = more recent
    checksum: Optional[int] = None  # crc32 of the block's raw bytes


def _raw_bytes(t: torch.Tensor) -> np.ndarray:
    """A contiguous tensor's bytes as a flat ``uint8`` numpy view."""
    return t.reshape(-1).view(torch.uint8).numpy()


class HostRelation:
    """A tensor relation held in host RAM as key-range blocks.

    ``rtype`` is the full (dense-layout) relation type; blocks partition
    key dimension ``split_dim``.  ``append`` grows the key frontier — a
    streamed plan writes its output back chunk-by-chunk; ``complete`` is
    True once the blocks cover ``rtype.key_shape[split_dim]``.  ``mask``
    (a host bool grid over the key space) carries non-continuous
    relations; streaming requires continuity, so masked handles only take
    the materialize-resident path.
    """

    def __init__(self, store: "RelationStore", name: str, rtype: RelType,
                 split_dim: int = 0,
                 mask: Optional[np.ndarray] = None) -> None:
        if not 0 <= split_dim < rtype.key_arity:
            raise StoreError(
                f"split_dim {split_dim} out of range for key arity "
                f"{rtype.key_arity}")
        self.store = store
        self.name = name
        self.rtype = rtype
        self.split_dim = split_dim
        self.mask = None if mask is None else np.asarray(mask, bool)
        self._blocks: List[_Block] = []

    # -- shape/bookkeeping -------------------------------------------------
    @property
    def nkeys(self) -> int:
        """Key count along the split dimension."""
        return self.rtype.key_shape[self.split_dim]

    @property
    def frontier(self) -> int:
        """Keys covered so far along the split dimension."""
        return self._blocks[-1].stop if self._blocks else 0

    @property
    def complete(self) -> bool:
        return self.frontier >= self.nkeys

    @property
    def nbytes(self) -> int:
        """Full dense size (what a device materialization would allocate)."""
        return self.rtype.nfloats * self.rtype.dtype.itemsize

    @property
    def stored_bytes(self) -> int:
        return sum(b.nbytes for b in self._blocks)

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self.rtype.key_shape) + tuple(self.rtype.bound)

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return (f"HostRelation({self.name!r}, {self.rtype}, "
                f"split_dim={self.split_dim}, blocks={len(self._blocks)}, "
                f"frontier={self.frontier}/{self.nkeys})")

    # -- writes ------------------------------------------------------------
    def append(self, array) -> None:
        """Append the next key range along the split dim (host copy)."""
        arr = torch.as_tensor(array).detach()
        if arr.device.type != "cpu":
            arr = arr.cpu()
        want = list(self.rtype.key_shape) + list(self.rtype.bound)
        if arr.ndim != len(want):
            raise StoreError(
                f"append to {self.name!r}: rank {arr.ndim} != {len(want)}")
        n = arr.shape[self.split_dim]
        want[self.split_dim] = n
        if list(arr.shape) != want:
            raise StoreError(
                f"append to {self.name!r}: shape {tuple(arr.shape)} != "
                f"{tuple(want)}")
        if self.frontier + n > self.nkeys:
            raise StoreError(
                f"append to {self.name!r}: frontier {self.frontier}+{n} "
                f"exceeds {self.nkeys} keys")
        self.store._admit_range(self, arr.to(self.rtype.dtype))

    # -- reads -------------------------------------------------------------
    def blocks_in(self, lo: int, hi: int) -> Iterator[Tuple[int,
                                                            torch.Tensor]]:
        """``(offset, view)`` for each block piece of keys ``[lo, hi)``:
        ``view`` holds keys ``[lo + offset, lo + offset + len)`` along the
        split dim, a view of the block (spilled blocks fault in)."""
        if not 0 <= lo < hi <= self.frontier:
            raise StoreError(
                f"slice [{lo}, {hi}) outside frontier {self.frontier} "
                f"of {self.name!r}")
        for b in self._blocks:
            if b.stop <= lo or b.start >= hi:
                continue
            data = self.store._loaded(b)
            s, e = max(lo, b.start), min(hi, b.stop)
            yield s - lo, data.narrow(self.split_dim, s - b.start, e - s)

    def slice(self, lo: int, hi: int) -> torch.Tensor:
        """Dense host tensor for keys ``[lo, hi)`` along the split dim."""
        parts = [v for _, v in self.blocks_in(lo, hi)]
        if len(parts) == 1:
            return parts[0]
        return torch.cat(parts, dim=self.split_dim)

    def mask_slice(self, lo: int, hi: int) -> Optional[np.ndarray]:
        if self.mask is None:
            return None
        idx = [slice(None)] * self.mask.ndim
        idx[self.split_dim] = slice(lo, hi)
        return self.mask[tuple(idx)]

    def to_tensor(self) -> torch.Tensor:
        if not self.complete:
            raise StoreError(
                f"{self.name!r} is incomplete ({self.frontier}/{self.nkeys} "
                f"keys) — cannot materialize")
        return self.slice(0, self.nkeys)

    def to_numpy(self) -> np.ndarray:
        return self.to_tensor().numpy()

    def to_relation(self, device: DeviceLike = "cuda") -> TensorRelation:
        """Materialize the whole relation on ``device`` (the card by
        default, as JAX's puts it on the default device; without a card
        the default raises, and ``device="cpu"`` keeps it on the host):
        each block copied into its place in one device tensor
        (asynchronous from page-locked blocks, on the current stream)."""
        if not self.complete:
            self.to_tensor()                # raises: incomplete
        device = resolve_device(device)
        data = torch.empty(self.shape, dtype=self.rtype.dtype, device=device)
        for off, view in self.blocks_in(0, self.nkeys):
            copy_into(data, self.split_dim, off, view)
        return TensorRelation(data, self.rtype,
                              None if self.mask is None
                              else self.mask.copy())


def copy_into(dst: torch.Tensor, dim: int, off: int,
              src: torch.Tensor) -> None:
    """``dst.narrow(dim, off, n).copy_(src)`` for a contiguous ``dst``.

    To a card the copy reads page-locked, contiguous memory only: a
    ``src`` that is not both is first copied into a page-locked staging
    tensor from torch's caching host allocator (which reuses the buffer
    only after the copy recorded on it completes).  The copy is then one
    asynchronous DMA (``non_blocking``) on the current stream, or one per
    index of the dims before ``dim`` — each a contiguous piece of ``dst``
    — so that no staging tensor is needed on the device either."""
    n = src.shape[dim]
    if dst.device.type != "cuda":
        dst.narrow(dim, off, n).copy_(src)
        return
    if not (src.is_pinned() and src.is_contiguous()):
        src = torch.empty(tuple(src.shape), dtype=src.dtype,
                          pin_memory=True).copy_(src)
    lead = math.prod(dst.shape[:dim])
    if lead == 1:
        dst.narrow(dim, off, n).copy_(src, non_blocking=True)
        return
    rest = math.prod(dst.shape[dim + 1:])
    d3 = dst.view(lead, dst.shape[dim], rest)
    s3 = src.view(lead, n, rest)
    for i in range(lead):
        d3[i, off:off + n].copy_(s3[i], non_blocking=True)


class RelationStore:
    """Owns :class:`HostRelation` blocks; host tier + optional disk spill.

    ``ram_limit_bytes=None`` (default) never spills.  With a limit, blocks
    past the budget spill LRU-first to ``.npy`` files and fault back in on
    access; ``spill_events`` / ``spill_bytes`` / ``unspill_events`` feed
    the :class:`repro_torch.launch.metering.StreamStats` counters.
    Where a card is present every block is page-locked (``pin_memory``).
    """

    def __init__(self, ram_limit_bytes: Optional[int] = None,
                 spill_dir: Optional[str] = None,
                 block_bytes: int = DEFAULT_BLOCK_BYTES) -> None:
        self.ram_limit_bytes = ram_limit_bytes
        self.block_bytes = max(1, block_bytes)
        self.pin_memory = torch.cuda.is_available()
        self._spill_dir = spill_dir
        self._rels: Dict[str, HostRelation] = {}
        self._seq = 0
        self.ram_bytes = 0
        self.spill_events = 0
        self.spill_bytes = 0
        self.unspill_events = 0
        self.unspill_bytes = 0

    # -- relation lifecycle ------------------------------------------------
    def put(self, name: str, value, *, rtype: Optional[RelType] = None,
            split_dim: int = 0) -> HostRelation:
        """Ingest a relation (TensorRelation / tensor / array /
        HostRelation)."""
        mask = None
        if isinstance(value, HostRelation):
            rtype = value.rtype
            mask = value.mask
            data = value.to_tensor()
        elif isinstance(value, TensorRelation):
            rtype = value.rtype
            data = value.data.detach()
            if value.mask is not None:
                mask = np.asarray(value.mask)
        else:
            data = torch.as_tensor(value)
            if rtype is None:
                raise StoreError(
                    "put of a raw array needs an explicit rtype=")
            want = tuple(rtype.key_shape) + tuple(rtype.bound)
            if tuple(data.shape) != want:
                raise StoreError(
                    f"put({name!r}): array shape {tuple(data.shape)} != "
                    f"dense layout {want}")
        hr = self.create(name, rtype, split_dim=split_dim, mask=mask)
        n = hr.nkeys
        per_key = max(1, hr.nbytes // max(1, n))
        step = max(1, self.block_bytes // per_key)
        for lo in range(0, n, step):
            hr.append(data.narrow(split_dim, lo, min(lo + step, n) - lo))
        return hr

    def create(self, name: str, rtype: RelType, *, split_dim: int = 0,
               mask: Optional[np.ndarray] = None) -> HostRelation:
        """New (empty) relation to be filled with ``append``; replaces any
        existing relation of the same name."""
        if name in self._rels:
            self.delete(name)
        hr = HostRelation(self, name, rtype, split_dim=split_dim, mask=mask)
        self._rels[name] = hr
        return hr

    def get(self, name: str) -> HostRelation:
        return self._rels[name]

    def __contains__(self, name: str) -> bool:
        return name in self._rels

    def relations(self) -> Dict[str, HostRelation]:
        return dict(self._rels)

    def delete(self, name: str) -> None:
        hr = self._rels.pop(name, None)
        if hr is None:
            return
        for b in hr._blocks:
            if b.data is not None:
                self.ram_bytes -= b.nbytes
            if b.path is not None and os.path.exists(b.path):
                os.unlink(b.path)
        hr._blocks = []

    # -- block admission / spill tier --------------------------------------
    def _host_copy(self, t: torch.Tensor) -> torch.Tensor:
        """A contiguous copy of ``t`` that the store owns (page-locked
        when ``pin_memory``)."""
        out = torch.empty(tuple(t.shape), dtype=t.dtype,
                          pin_memory=self.pin_memory)
        return out.copy_(t)

    def _admit_range(self, hr: HostRelation, arr: torch.Tensor) -> None:
        n = arr.shape[hr.split_dim]
        per_key = max(1, arr.numel() * arr.element_size() // max(1, n))
        step = max(1, self.block_bytes // per_key)
        for lo in range(0, n, step):
            part = self._host_copy(
                arr.narrow(hr.split_dim, lo, min(lo + step, n) - lo))
            self._seq += 1
            blk = _Block(start=hr.frontier,
                         stop=hr.frontier + part.shape[hr.split_dim],
                         data=part, shape=tuple(part.shape),
                         dtype=part.dtype,
                         nbytes=part.numel() * part.element_size(),
                         seq=self._seq)
            hr._blocks.append(blk)
            self.ram_bytes += blk.nbytes
            self._maybe_spill(keep=blk)

    def _spill_path(self, blk: _Block) -> str:
        if self._spill_dir is None:
            self._spill_dir = tempfile.mkdtemp(prefix="repro-store-")
        os.makedirs(self._spill_dir, exist_ok=True)
        return os.path.join(self._spill_dir, f"blk-{id(blk):x}-{blk.seq}.npy")

    def _maybe_spill(self, keep: Optional[_Block] = None) -> None:
        if self.ram_limit_bytes is None:
            return
        while self.ram_bytes > self.ram_limit_bytes:
            victim = None
            for hr in self._rels.values():
                for b in hr._blocks:
                    if b.data is None or b is keep:
                        continue
                    if victim is None or b.seq < victim.seq:
                        victim = b
            if victim is None:
                return                  # nothing evictable — stay resident
            path = victim.path or self._spill_path(victim)
            raw = _raw_bytes(victim.data)
            # atomic spill: write beside the target, fsync, then rename —
            # a crash mid-write leaves the previous whole file (or none),
            # never a torn one that would fault back in silently wrong
            tmp = path + ".tmp"
            with open(tmp, "wb") as f:
                np.save(f, raw)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
            victim.checksum = zlib.crc32(raw)
            victim.path = path
            victim.data = None
            self.ram_bytes -= victim.nbytes
            self.spill_events += 1
            self.spill_bytes += victim.nbytes

    def _loaded(self, blk: _Block) -> torch.Tensor:
        self._seq += 1
        blk.seq = self._seq             # touch for LRU
        if blk.data is None:
            try:
                raw = np.load(blk.path)
            except Exception as err:
                raise SpillCorruption(
                    f"spilled block [{blk.start}, {blk.stop}) at "
                    f"{blk.path} is unreadable (torn or truncated "
                    f"write): {err!r}") from err
            if raw.nbytes != blk.nbytes:
                raise SpillCorruption(
                    f"spilled block [{blk.start}, {blk.stop}) at "
                    f"{blk.path} read back {raw.nbytes} bytes, "
                    f"expected {blk.nbytes}")
            if blk.checksum is not None and zlib.crc32(raw) != blk.checksum:
                raise SpillCorruption(
                    f"spilled block [{blk.start}, {blk.stop}) at "
                    f"{blk.path} failed its content checksum — on-disk "
                    f"bytes differ from what was spilled")
            data = torch.empty(blk.shape, dtype=blk.dtype,
                               pin_memory=self.pin_memory)
            _raw_bytes(data)[:] = raw
            blk.data = data
            self.ram_bytes += blk.nbytes
            self.unspill_events += 1
            self.unspill_bytes += blk.nbytes
            self._maybe_spill(keep=blk)
        return blk.data

