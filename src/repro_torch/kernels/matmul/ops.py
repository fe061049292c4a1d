"""Public matmul op: the hand-written CUDA kernels or their plain version.

Counterpart of ``repro.kernels.matmul.ops.matmul``.  ``impl`` selects:

* ``"auto"`` (the main path): the plain version (:mod:`.ref`) for a CPU
  tensor, a CUDA kernel for a CUDA tensor;
* ``"kernel"``: always a CUDA kernel — a CPU tensor raises;
* ``"plain"``: always the plain version (tests and the chip smoke run only).

A CUDA call goes by type, rows and columns (:func:`route`):

* f32 with at most :data:`SKINNY_MAX_M` rows (the FFNN scorer's buckets,
  the main path) → ``matmul_skinny_kernel``.  It reads each operand in
  place through a 4-D TMA tensor map: an operand is given as a view whose
  rows and columns each merge at most two strided axes
  (:func:`blocked_view`), such as the scorer's blocked W1, ``(db, hb, bd,
  bh)`` viewed as ``(db, bd, hb, bh)``, which the kernel reads as the
  (db·bd, hb·bh) matrix without the copy a reshape would make.  A layout
  it cannot read — a base off 16 bytes, a stride that is not a multiple of
  16 bytes, more than two merged axes on a side, or a K blocking that the
  other operand does not share — is copied once into one it can
  (:func:`plan_operands`; :data:`COPIES` counts those copies).  Its split-K
  sum is folded into the same launch: the last block of each column tile
  adds the splits' partial tiles in split order, as
  :func:`.ref.splitk_reduce_ref` does (:data:`FOLDS` counts the launches
  that folded).
* f32 with more rows and more than :data:`TC_NARROW_COLS` columns (the
  FFNN train step's X·W1, the main path) → the tensor-core route, in
  ``csrc/matmul_wgmma.cu``: ``tf32_split_kernel`` (:func:`tf32_split`)
  writes each operand as its TF32 big and small terms, K-major (B
  transposed) and K padded to :data:`TC_BK` with zeros, reading the
  operand in place by the strides of its :func:`blocked_view` (a layout
  with more merged axes is copied first and counted in :data:`COPIES`);
  then ``matmul_tc_kernel`` sums the three TF32 products small·big +
  big·small + big·big in f32 on ``wgmma``, accurate to f32 (one TF32
  product is not: at the train path's X·W1 it crosses the f32 limit).
  Deviation: f32 sums on the tensor cores, in another order than an FFMA
  chain.
* f32 with more rows and at most :data:`TC_NARROW_COLS` columns (the FFNN
  train step's a1·W2, 10 columns, the main path) → ``matmul_narrow_kernel``
  in ``csrc/matmul_narrow.cu``: A streams once through a TMA ring of
  128-row tiles, each consumer thread holding 4 rows × all N columns in
  registers (FFMA in true f32: the product is bound by A's bytes).  It
  reads both operands in place through the skinny kernel's tensor maps
  (:func:`plan_operands` with ``kernel="narrow"``; a layout it cannot read
  is copied once and counted in :data:`COPIES`), and splits K only as far
  as fills two blocks an SM in one wave (:func:`plan_narrow`); the split-K
  sum is folded into the same launch in split order, as the skinny
  kernel's is (:data:`NARROW_FOLDS`).  Deviation: the f32 sum runs in
  another order than the TPU kernel's one accumulator over the K grid, a
  fixed one: within a split, each of four warps sums its eighth of every
  32-deep K step along K, the warps' sums are added in warp order, then
  the splits' in split order (:func:`.ref.matmul_split_ref` adds the same
  partials in the same order).  The K steps follow A's K blocks, so a
  view whose K blocks are not whole 32-deep steps (block-major, blocks of
  2000) sums in another order than its contiguous copy: the two agree
  within the f32 limit, not to the bit.
* bf16 → ``matmul_tile_kernel`` on contiguous row-major operands (any
  other layout is copied first and counted in :data:`COPIES`); when its
  output has too few tiles for the card it splits K across blocks
  (:func:`plan_launch`) and a second kernel, ``splitk_reduce_kernel``,
  adds the partial sums (:func:`splitk_reduce`).

A CUDA tensor never falls back to the plain version: the kernel builds and
launches, or the call raises.  Deviations from the JAX op: no
``block_m/n/k`` or ``interpret`` arguments and no padding — the kernels
mask ragged edges themselves (the JAX wrapper pads both operands to block
multiples, which at the scorer's width would copy the 640 MB weight on
every dispatch); ``out_dtype`` is exposed as in ``matmul_ref``; and an
operand may be an N-D view whose leading ``a_rows`` / ``b_rows`` axes are
its rows and the rest its columns, so that the engine hands over a blocked
relation's own tensor (the JAX engine transposes and reshapes it into a
2-D copy first).

Launch counters, one per ``__global__`` kernel, so a run can show that its
main path went through them: :data:`SKINNY_LAUNCHES`, :data:`LAUNCHES`
(the tile kernel), :data:`REDUCE_LAUNCHES` (its split-K pass),
:data:`TC_LAUNCHES` (the tensor-core kernel), :data:`SPLIT_LAUNCHES`
(its operand pass, two a product) and :data:`NARROW_LAUNCHES` (the narrow
kernel).
"""
from __future__ import annotations

import ctypes
import math
import struct
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch.kernels.matmul.ref import matmul_ref, splitk_reduce_ref

#: tile-kernel launches made by :func:`matmul` in this process
LAUNCHES = 0
#: split-K reduction launches made by :func:`splitk_reduce` in this process
REDUCE_LAUNCHES = 0
#: skinny-kernel launches made by :func:`matmul` in this process
SKINNY_LAUNCHES = 0
#: skinny-kernel launches that split K and folded the partial sums
FOLDS = 0
#: tensor-core kernel launches made by :func:`matmul` in this process
TC_LAUNCHES = 0
#: operand passes of the tensor-core route made by :func:`tf32_split`
SPLIT_LAUNCHES = 0
#: narrow-kernel launches made by :func:`matmul` in this process
NARROW_LAUNCHES = 0
#: narrow-kernel launches that split K and folded the partial sums
NARROW_FOLDS = 0
#: operands copied into a layout the kernels read
COPIES = 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

#: tile configuration id -> (BM, BN, BK), as instantiated in csrc/matmul.cu
TILE_CONFIGS = {0: (8, 128, 32), 1: (64, 64, 16)}

#: the skinny kernel takes f32 products of at most this many rows
SKINNY_MAX_M = 16
#: f32 products of more rows go to the tensor-core route when they have
#: more than this many columns, else to the narrow kernel
TC_NARROW_COLS = 32
#: the tensor-core kernel's K step: the split pass pads K to a multiple
TC_BK = 32
#: its ring of B tiles, and its tiles: wide (128 columns, 32 rows of K) or
#: narrow (all N <= NARROW_MAX_COLS columns, 128 rows of K)
SKINNY_STAGES = 4
WIDE_COLS, WIDE_BK = 128, 32
NARROW_MAX_COLS, NARROW_BK = 32, 128
#: shared memory for A's K slice (a split is cut to fit), and a block's
#: shared memory on sm_90
A_SLICE_BYTES = 120 * 1024
MAX_SMEM = 232448
#: a split takes at least this many K tiles
MIN_SPLIT_TILES = 2

#: the narrow kernel's row tile and K step (one 128-byte swizzled row of A
#: a stage), its ring depth, and the blocks an SM it plans for: shared
#: memory for two blocks, each within half the SM's 228 KB less the 1 KB
#: the card keeps for each block
NW_BM, NW_BK = 128, 32
NW_MIN_STAGES, NW_MAX_STAGES = 4, 6
NW_BLOCKS_PER_SM = 2
NW_SMEM_CAP = 233472 // NW_BLOCKS_PER_SM - 1024
#: a split takes at least this many K steps
NW_MIN_SPLIT_TILES = 8

_lib_handle: Optional[ctypes.CDLL] = None
#: the skinny and narrow kernels' flat launch descriptors: two maps and
#: their arguments
_DESC = struct.Struct("42q")
_NW_DESC = struct.Struct("40q")
#: ``SplitArgs`` of ``csrc/matmul_wgmma.cu``: the operand's four axes and
#: their strides, the padded K, the transpose flag
_SPLIT_ARGS = struct.Struct("10q")
_SM_COUNTS: Dict[int, int] = {}
#: the skinny kernel's fold tickets, one zeroed buffer per (device, stream)
_TICKETS: Dict[Tuple[int, int], torch.Tensor] = {}


class KernelLaunchError(RuntimeError):
    """The CUDA runtime refused a launch (``cudaGetLastError() != 0``)."""


# ------------------------------------------------------- operand layouts
class Blocked(NamedTuple):
    """A 2-D operand as four strided axes: rows ``(r0, r1)`` and columns
    ``(c0, c1)``, element ``(i, j)`` at ``(i // r1)·s_r0 + (i % r1)·s_r1 +
    (j // c1)·s_c0 + (j % c1)·s_c1`` elements from the base."""
    shape: Tuple[int, int, int, int]
    strides: Tuple[int, int, int, int]

    @property
    def rows(self) -> int:
        return self.shape[0] * self.shape[1]

    @property
    def cols(self) -> int:
        return self.shape[2] * self.shape[3]

    def split_rows(self, r0: int, r1: int) -> "Blocked":
        """The same matrix with its single row axis cut into (r0, r1)."""
        s = self.strides[1]
        return Blocked((r0, r1) + self.shape[2:], (r1 * s, s) + self.strides[2:])

    def split_cols(self, c0: int, c1: int) -> "Blocked":
        """The same matrix with its single column axis cut into (c0, c1)."""
        s = self.strides[3]
        return Blocked(self.shape[:2] + (c0, c1), self.strides[:2] + (c1 * s, s))


def _merge(axes: Sequence[Tuple[int, int]]) -> Optional[list]:
    """Axes (length, stride), outermost first, with length-1 axes dropped
    and neighbours merged where one steps over the other; padded to two
    with length-1 axes.  None when more than two remain."""
    out: list = []
    for n, st in axes:
        if n == 1:
            continue
        if out and out[-1][1] == n * st:
            out[-1] = (out[-1][0] * n, st)
        else:
            out.append((n, st))
    if len(out) > 2:
        return None
    while len(out) < 2:
        n, st = out[0] if out else (1, 1)
        out.insert(0, (1, n * st))
    return out


def blocked_view(shape: Sequence[int], strides: Sequence[int],
                 rows: int) -> Optional[Blocked]:
    """An N-D view whose leading ``rows`` axes are a matrix's rows and the
    rest its columns, as a :class:`Blocked`; None when a side merges into
    more than two axes."""
    axes = list(zip(shape, strides))
    r, c = _merge(axes[:rows]), _merge(axes[rows:])
    if r is None or c is None:
        return None
    return Blocked((r[0][0], r[1][0], c[0][0], c[1][0]),
                   (r[0][1], r[1][1], c[0][1], c[1][1]))


class TmaMap(NamedTuple):
    """A 4-D f32 tensor map: ``dims`` = (the contiguous axis, then three
    logical axes in the order of their strides), ``strides`` the bytes
    between steps of dims 1-3, ``box`` the tile one copy brings, ``perm``
    the map dim (1-3) of the first logical axis in bits 0-1 and of the
    second in bits 2-3."""
    dims: Tuple[int, int, int, int]
    strides: Tuple[int, int, int]
    box: Tuple[int, int, int, int]
    perm: int

    def spec(self) -> tuple:
        """``MmMapSpec`` of ``csrc/matmul.cu``, flat: 12 values."""
        return self.dims + self.strides + self.box + (self.perm,)


def _tma_map(inner: int, axes: Sequence[Tuple[int, int]], data_ptr: int,
             box0: int, box1: int, itemsize: int = 4) -> Optional[TmaMap]:
    """The map of a tensor with a contiguous axis of ``inner`` elements and
    three logical axes ``(length, element stride)``, boxed ``box0`` along
    the contiguous axis and ``box1`` along the first logical axis; None
    when TMA cannot read it (a base off 16 bytes, a stride of an axis
    longer than 1 that is not a positive multiple of 16 bytes, or axes that
    overlap once ordered by stride)."""
    if data_ptr % 16:
        return None
    stepped = sorted((st, i) for i, (n, st) in enumerate(axes) if n > 1)
    extent = inner * itemsize
    for st, i in stepped:
        if st <= 0 or st * itemsize % 16 or st * itemsize < extent:
            return None
        extent = st * itemsize * axes[i][0]
    order = [i for _, i in stepped] + [i for i, (n, _) in enumerate(axes)
                                       if n == 1]
    step = -(-inner * itemsize // 16) * 16
    dims, byte_strides = [inner], []
    for i in order:
        n, st = axes[i]
        if n > 1:
            step = st * itemsize
        byte_strides.append(step)
        dims.append(n)
        step *= n
    box = [box0, 1, 1, 1]
    box[1 + order.index(0)] = box1
    perm = (1 + order.index(0)) | (1 + order.index(1)) << 2
    return TmaMap(tuple(dims), tuple(byte_strides), tuple(box), perm)


class BPlan(NamedTuple):
    """How a kernel reads B: its map, the tile kind (``wide``: 128-column
    tiles of 32 K rows; narrow: one tile of all columns, ``bk`` K rows),
    the tile's pitch ``tc`` in shared memory, ``g``, the B rows one TMA row
    holds, and ``bk``, the K rows of a tile."""
    map: TmaMap
    wide: bool
    tc: int
    g: int
    bk: int


def b_map(b: Blocked, data_ptr: int,
          narrow_bk: int = NARROW_BK) -> Optional[BPlan]:
    """The skinny kernel's reading of B (logical axes: row within a K
    block, column block, K block), with narrow tiles of ``narrow_bk`` K
    rows (the narrow kernel's: :data:`NW_BK`); None when it needs a copy.
    Narrow rows whose pitch is not a multiple of 16 bytes (the scorer's W2,
    10 f32 columns) are read ``g`` packed rows to a TMA row."""
    (r0, r1, c0, c1), (s_r0, s_r1, s_c0, s_c1) = b.shape, b.strides
    if c1 > 1 and s_c1 != 1:
        return None
    if c0 > 1 or c1 > NARROW_MAX_COLS:
        m = _tma_map(c1, [(r1, s_r1), (c0, s_c0), (r0, s_r0)], data_ptr,
                     WIDE_COLS, WIDE_BK)
        return None if m is None else BPlan(m, True, WIDE_COLS, 1, WIDE_BK)
    if r1 == 1 or s_r1 * 4 % 16 == 0:
        tc = -(-c1 // 4) * 4
        m = _tma_map(c1, [(r1, s_r1), (c0, s_c0), (r0, s_r0)], data_ptr, tc,
                     narrow_bk)
        return None if m is None else BPlan(m, False, tc, 1, narrow_bk)
    g = 16 // math.gcd(c1 * 4, 16)
    if s_r1 != c1 or r1 % g:                 # rows not packed, or ragged
        return None
    m = _tma_map(g * c1, [(r1 // g, g * c1), (c0, s_c0), (r0, s_r0)],
                 data_ptr, g * c1, narrow_bk // g)
    return None if m is None else BPlan(m, False, c1, g, narrow_bk)


def a_map(a: Blocked, data_ptr: int, bk: int,
          rows: Optional[int] = None) -> Optional[TmaMap]:
    """The skinny and narrow kernels' reading of A (logical axes: row
    within a row block, K block, row block; a box is ``bk`` columns of
    ``rows`` rows, by default a whole row block); None when it needs a
    copy."""
    (r0, r1, c0, c1), (s_r0, s_r1, s_c0, s_c1) = a.shape, a.strides
    if c1 > 1 and s_c1 != 1:
        return None
    return _tma_map(c1, [(r1, s_r1), (c0, s_c0), (r0, s_r0)], data_ptr, bk,
                    rows or r1)


def _k_pairs(a: Blocked, b: Blocked):
    """A and B cut to one K blocking — A's columns (c0, c1) equal to B's
    rows (r0, r1) — in the ways their layouts allow."""
    if a.shape[2:] == b.shape[:2]:
        yield a, b
    if b.shape[0] == 1 and a.shape[2] > 1:
        yield a, b.split_rows(*a.shape[2:])
    if a.shape[2] == 1 and b.shape[0] > 1:
        yield a.split_cols(*b.shape[:2]), b


class OperandPlan(NamedTuple):
    """A kernel's reading of one call, or what to copy first: ``copy_b``
    (B's own layout is unreadable), else ``copy_a`` (A's, or no K blocking
    both share)."""
    copy_a: bool = False
    copy_b: bool = False
    a: Optional[Blocked] = None
    b: Optional[Blocked] = None
    a_map: Optional[TmaMap] = None
    b_plan: Optional[BPlan] = None


def plan_operands(a_view: Tuple, b_view: Tuple,
                  kernel: str = "skinny") -> OperandPlan:
    """The skinny (or, with ``kernel="narrow"``, the narrow) kernel's plan
    for operands given as ``(shape, strides, data_ptr, rows)``: both read in
    place, or which to copy.  The narrow kernel reads B as one narrow tile
    of :data:`NW_BK` K rows and A in boxes of :data:`NW_BK` columns ×
    :data:`NW_BM` rows."""
    narrow = kernel == "narrow"
    bv = blocked_view(b_view[0], b_view[1], b_view[3])
    if bv is None or (narrow and bv.shape[2] > 1):
        return OperandPlan(copy_b=True)
    bk = NW_BK if narrow else NARROW_BK
    av = blocked_view(a_view[0], a_view[1], a_view[3])
    tried = None
    for a2, b2 in (_k_pairs(av, bv) if av is not None else ()):
        bp = b_map(b2, b_view[2], bk)
        if b2 is bv:
            tried = bp
        am = bp and a_map(a2, a_view[2], bp.bk, NW_BM if narrow else None)
        if am is not None:
            return OperandPlan(a=a2, b=b2, a_map=am, b_plan=bp)
    if (tried or b_map(bv, b_view[2], bk)) is None:
        return OperandPlan(copy_b=True)
    return OperandPlan(copy_a=True, b=bv)


def _padded_copy(src: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``src`` as values of ``shape`` in a fresh buffer whose last axis is
    padded to a multiple of 4 f32 (16 bytes): a view of that shape."""
    pad = -(-shape[-1] // 4) * 4
    buf = torch.empty(tuple(shape[:-1]) + (pad,), dtype=src.dtype,
                      device=src.device)
    view = buf[..., :shape[-1]]
    view.copy_(src.reshape(shape))
    return view


class SkinnyPlan(NamedTuple):
    """The skinny kernel's launch plan (its first 15 fields are those of
    ``SkinnyArgs`` in ``csrc/matmul.cu``, then a block's shared memory):
    ``mp`` rows padded to 4, 8 or 16; K in ``ktiles`` tiles (``ktpb`` per K
    block), cut into ``splits`` of ``kts`` tiles; N in ``ntiles`` column
    tiles (``ntpb`` per column block of ``n1`` columns)."""
    m: int
    n: int
    mp: int
    wide: bool
    tc: int
    g: int
    n1: int
    ntpb: int
    ntiles: int
    ktpb: int
    ktiles: int
    kts: int
    splits: int
    a_r0: int
    a_r1: int
    smem: int


def skinny_smem(wide: bool, tc: int, mp: int, kts: int) -> int:
    """Shared memory of one block, as ``sk_layout`` in ``csrc/matmul.cu``
    lays it out: the B ring, A's slice, the row groups' sums, barriers."""
    bk = WIDE_BK if wide else NARROW_BK
    groups = 4 if wide else 128 // tc
    red = -(-groups * mp * tc * 4 // 128) * 128
    return SKINNY_STAGES * bk * tc * 4 + kts * mp * bk * 4 + red + 256


def plan_skinny(a: Blocked, b: Blocked, bp: BPlan,
                num_sms: int) -> SkinnyPlan:
    """Tiles and splits for A and B in one K blocking: K is split only as
    far as A's slice must fit in shared memory, or the card needs more
    work items than the output has column tiles."""
    m, n = a.rows, b.cols
    mp = 4 if m <= 4 else 8 if m <= 8 else 16
    k0, k1, n0, n1 = b.shape
    ktpb = -(-k1 // bp.bk)
    ktiles = k0 * ktpb
    ntpb = -(-n1 // bp.tc) if bp.wide else 1
    ntiles = n0 * ntpb
    kts_max = max(1, A_SLICE_BYTES // (mp * bp.bk * 4))
    want = min(-(-num_sms // ntiles), -(-ktiles // MIN_SPLIT_TILES))
    splits = max(-(-ktiles // kts_max), want, 1)
    kts = -(-ktiles // splits)
    splits = -(-ktiles // kts)
    return SkinnyPlan(m, n, mp, bp.wide, bp.tc, bp.g, n1, ntpb, ntiles,
                      ktpb, ktiles, kts, splits, a.shape[0], a.shape[1],
                      skinny_smem(bp.wide, bp.tc, mp, kts))


class NarrowPlan(NamedTuple):
    """The narrow kernel's launch plan (its first 13 fields are the first
    13 of ``NarrowArgs`` in ``csrc/matmul_narrow.cu``): C (m, n); B's slice
    at ``bpitch`` floats a row in shared memory, ``bg`` B rows to a TMA
    row; A's rows in blocks of ``a_r1``, each cut into ``rtpb`` tiles of
    :data:`NW_BM` rows, ``rtiles`` in all; K in blocks of ``kblock``, each
    cut into ``ktpb`` steps of :data:`NW_BK`, ``ktiles`` in all, and into
    ``splits`` of ``kts`` steps; a ring of ``stages``; a block's shared
    memory and the fold's workspace, in floats (0 without split-K)."""
    m: int
    n: int
    bpitch: int
    bg: int
    a_r1: int
    rtpb: int
    rtiles: int
    kblock: int
    ktpb: int
    ktiles: int
    kts: int
    splits: int
    stages: int
    smem: int
    ws_floats: int

    def k_bounds(self) -> list:
        """Where each split starts along K, and K itself: split z covers
        K values ``[bounds[z], bounds[z + 1])``."""
        def start(kt: int) -> int:
            kb, j = divmod(kt, self.ktpb)
            return kb * self.kblock + j * NW_BK
        return [start(min(z * self.kts, self.ktiles))
                for z in range(self.splits + 1)]


def narrow_smem(stages: int, bpitch: int) -> int:
    """Shared memory of one narrow block, as ``nw_layout`` in
    ``csrc/matmul_narrow.cu`` lays it out: the A ring, the B ring, the
    barriers, and the slack that aligns the ring to 1024 bytes."""
    return stages * (NW_BM * NW_BK * 4 + NW_BK * bpitch * 4) + 128 + 1024


def plan_narrow(a: Blocked, b: Blocked, bp: BPlan,
                num_sms: int) -> NarrowPlan:
    """Tiles, splits and ring depth for A and B in one K blocking: K is
    split only as far as fills :data:`NW_BLOCKS_PER_SM` blocks on every SM
    in one wave (a split at least :data:`NW_MIN_SPLIT_TILES` K steps deep),
    and the ring is as deep as two blocks an SM allow.  The splits are
    counted from M's 128-row tiles, not from the view's row blocks, so a
    blocked view and a contiguous copy of it whose K steps fall alike are
    split alike and give the same bits."""
    m, n = a.rows, b.cols
    rtpb = -(-a.shape[1] // NW_BM)
    rtiles = a.shape[0] * rtpb
    k0, k1 = b.shape[:2]
    ktpb = -(-k1 // NW_BK)
    ktiles = k0 * ktpb
    splits = max(1, min(NW_BLOCKS_PER_SM * num_sms // -(-m // NW_BM),
                        ktiles // NW_MIN_SPLIT_TILES))
    kts = -(-ktiles // splits)
    splits = -(-ktiles // kts)
    fixed = narrow_smem(0, bp.tc)
    stages = min(NW_MAX_STAGES, (NW_SMEM_CAP - fixed)
                 // (narrow_smem(1, bp.tc) - fixed))
    ws = rtiles * splits * NW_BM * n if splits > 1 else 0
    return NarrowPlan(m, n, bp.tc, bp.g, a.shape[1], rtpb, rtiles, k1, ktpb,
                      ktiles, kts, splits, stages, narrow_smem(stages, bp.tc),
                      ws)


# ---------------------------------------------------------------- routing
def _dims(t: torch.Tensor, rows: Optional[int], name: str) -> Tuple[int, int]:
    """(rows, columns) of the matrix an operand stands for."""
    if rows is None:
        if t.dim() != 2:
            raise ValueError(f"matmul takes 2-D operands, or N-D views with "
                             f"{name}_rows, got {name} {tuple(t.shape)}")
        rows = 1
    if not 1 <= rows < t.dim():
        raise ValueError(f"{name}_rows must be in [1, {t.dim()}), got {rows}")
    return math.prod(t.shape[:rows]), math.prod(t.shape[rows:])


def route(a: torch.Tensor, b: torch.Tensor, impl: str = "auto",
          a_rows: Optional[int] = None, b_rows: Optional[int] = None) -> str:
    """Where :func:`matmul` sends a call: ``"plain"``, ``"skinny"`` (f32
    with at most :data:`SKINNY_MAX_M` rows), ``"tc"`` (f32 with more rows
    and more than :data:`TC_NARROW_COLS` columns), ``"narrow"`` (f32 with
    more rows and at most :data:`TC_NARROW_COLS` columns) or ``"tile"``
    (bf16)."""
    return _route(a, b, impl, _dims(a, a_rows, "a")[0],
                  _dims(b, b_rows, "b")[1])


def _route(a: torch.Tensor, b: torch.Tensor, impl: str, m: int,
           n: int) -> str:
    if impl == "plain" or (impl == "auto" and a.device.type == "cpu"
                           and b.device.type == "cpu"):
        return "plain"
    if a.dtype == torch.float32:
        if m <= SKINNY_MAX_M:
            return "skinny"
        return "tc" if n > TC_NARROW_COLS else "narrow"
    return "tile"


def plan_launch(m: int, n: int, k: int, num_sms: int) -> Tuple[int, int, int]:
    """``(config, splits, kchunk)`` of the tile kernel for an ``(m, k) @
    (k, n)`` product.

    Skinny ``a`` (m <= 16) takes 8 x 128 tiles, larger products 64 x 64.
    When the output has fewer tiles than two per SM, K is split across
    blocks (each split at least four BK steps deep) and
    :func:`splitk_reduce` adds the partial sums in split order —
    deterministic.
    """
    config = 0 if m <= 16 else 1
    bm, bn, bk = TILE_CONFIGS[config]
    tiles = math.ceil(m / bm) * math.ceil(n / bn)
    target = 2 * num_sms
    splits = 1
    if tiles < target:
        splits = max(1, min(math.ceil(target / tiles),
                            math.ceil(k / (4 * bk))))
    kchunk = math.ceil(math.ceil(k / splits) / bk) * bk
    splits = math.ceil(k / kchunk)
    return config, splits, kchunk


def _check(a: torch.Tensor, b: torch.Tensor, out_dtype, a_rows,
           b_rows) -> Tuple[torch.dtype, int, int, int]:
    m, k = _dims(a, a_rows, "a")
    kb, n = _dims(b, b_rows, "b")
    if k != kb:
        raise ValueError(f"contraction mismatch {tuple(a.shape)} x "
                         f"{tuple(b.shape)}")
    if a.dtype != b.dtype or a.dtype not in _DTYPE_CODES:
        raise TypeError(f"matmul takes two f32 or two bf16 operands, got "
                        f"{a.dtype} and {b.dtype}")
    out_dtype = out_dtype or a.dtype
    if out_dtype not in _DTYPE_CODES:
        raise TypeError(f"out_dtype must be f32 or bf16, got {out_dtype}")
    return out_dtype, m, k, n


# ---------------------------------------------------------------- launches
def _lib() -> ctypes.CDLL:
    global _lib_handle
    if _lib_handle is None:
        from repro_torch.kernels.build import load
        lib = load("matmul")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.repro_matmul.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i32, i32,
                                     i32, i32, i32, i32, ptr]
        lib.repro_matmul.restype = i32
        lib.repro_splitk_reduce.argtypes = [ptr, ptr, ctypes.c_longlong, i32,
                                            i32, ptr]
        lib.repro_splitk_reduce.restype = i32
        lib.repro_matmul_skinny.argtypes = [
            ptr, ptr, ptr, ptr, ptr, ctypes.c_char_p, ptr]
        lib.repro_matmul_skinny.restype = i32
        lib.repro_matmul_narrow.argtypes = [
            ptr, ptr, ptr, ptr, ptr, ctypes.c_char_p, ptr]
        lib.repro_matmul_narrow.restype = i32
        lib.repro_tf32_split.argtypes = [ptr, ptr, ctypes.c_char_p, ptr]
        lib.repro_tf32_split.restype = i32
        lib.repro_matmul_tc.argtypes = [ptr, ptr, ptr, i32, i32, i32, i32,
                                        ptr]
        lib.repro_matmul_tc.restype = i32
        lib.repro_cuda_error_string.argtypes = [i32]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        _lib_handle = lib
    return _lib_handle


def _sm_count(device: torch.device) -> int:
    dev = device.index if device.index is not None \
        else torch.cuda.current_device()
    if dev not in _SM_COUNTS:
        _SM_COUNTS[dev] = torch.cuda.get_device_properties(
            dev).multi_processor_count
    return _SM_COUNTS[dev]


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        msg = _lib().repro_cuda_error_string(rc).decode()
        raise KernelLaunchError(f"{what}: CUDA error {rc}: {msg}")


def _on_one_card(a: torch.Tensor, b: torch.Tensor) -> None:
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError(f"the matmul kernels take operands on one CUDA "
                         f"device, got {a.device} and {b.device}")


def _tickets(device: torch.device, stream: int, ntiles: int) -> torch.Tensor:
    """The zeroed fold tickets of this stream, at least ``ntiles`` of them.
    Each launch leaves its tickets zeroed again, so launches in order on
    one stream share the buffer; a stream of its own gets a buffer of its
    own."""
    key = (device.index, stream)
    buf = _TICKETS.get(key)
    if buf is None or buf.numel() < ntiles:
        buf = torch.zeros(max(ntiles, 1024), dtype=torch.int32,
                          device=device)
        _TICKETS[key] = buf
    return buf


def _operands(a, b, a_rows, b_rows, m, k, n, kernel: str = "skinny"):
    """A and B as the skinny (or narrow) kernel reads them, copying (and
    counting) what it cannot read in place; their :class:`OperandPlan`."""
    global COPIES

    def plan(a, b, a_rows, b_rows):
        return plan_operands((a.shape, a.stride(), a.data_ptr(), a_rows),
                             (b.shape, b.stride(), b.data_ptr(), b_rows),
                             kernel)

    op = plan(a, b, a_rows, b_rows)
    if op.copy_b:
        bv = blocked_view(b.shape, b.stride(), b_rows)
        shape = bv.shape if bv is not None and kernel == "skinny" \
            else (1, k, 1, n)
        b, b_rows = _padded_copy(b, shape), 2
        COPIES += 1
        op = plan(a, b, a_rows, b_rows)
    if op.copy_a:
        k0, k1 = op.b.shape[:2]
        a, a_rows = _padded_copy(a, (1, m, k0, k1)), 2
        COPIES += 1
        op = plan(a, b, a_rows, b_rows)
    if op.copy_a or op.copy_b:
        raise RuntimeError(f"matmul: no readable layout after the copies "
                           f"({op})")
    return a, b, op


def _launch_skinny(a, b, a_rows, b_rows, m, k, n, out_dtype,
                   keep_partials: bool = False):
    global SKINNY_LAUNCHES, FOLDS
    a, b, op = _operands(a, b, a_rows, b_rows, m, k, n)
    sp = plan_skinny(op.a, op.b, op.b_plan, _sm_count(a.device))
    if sp.smem > MAX_SMEM:
        raise ValueError(f"matmul: the skinny kernel's plan takes "
                         f"{sp.smem} bytes of shared memory")
    device = a.device
    stream = torch.cuda.current_stream(device).cuda_stream
    out = torch.empty((m, n), dtype=out_dtype, device=device)
    ws = tickets = None
    if sp.splits > 1:
        ws = torch.empty(sp.ntiles * sp.splits * sp.mp * sp.tc,
                         dtype=torch.float32, device=device)
        tickets = _tickets(device, stream, sp.ntiles)
    desc = (op.a_map.spec() + op.b_plan.map.spec() + sp[:15]
            + (op.a_map.perm, op.b_plan.map.perm,
               int(out_dtype == torch.bfloat16)))
    with torch.cuda.device(device):
        rc = _lib().repro_matmul_skinny(
            a.data_ptr(), b.data_ptr(), out.data_ptr(),
            None if ws is None else ws.data_ptr(),
            None if tickets is None else tickets.data_ptr(),
            _DESC.pack(*desc), stream)
    _raise_on(rc, f"skinny matmul kernel launch failed ({m}x{k} @ {k}x{n}, "
                  f"{sp.splits} splits)")
    SKINNY_LAUNCHES += 1
    FOLDS += sp.splits > 1
    if not keep_partials:
        return out
    return out, (None if ws is None else _partials(ws, sp))


def _partials(ws: torch.Tensor, sp: SkinnyPlan) -> torch.Tensor:
    """The workspace's partial tiles as ``(splits, m, n)``, the form
    :func:`.ref.splitk_reduce_ref` adds."""
    tiles = ws.view(sp.ntiles, sp.splits, sp.mp, sp.tc)
    out = torch.empty((sp.splits, sp.m, sp.n), dtype=torch.float32,
                      device=ws.device)
    for t in range(sp.ntiles):
        c0, j = divmod(t, sp.ntpb)
        w = min(sp.tc, sp.n1 - j * sp.tc)
        col = c0 * sp.n1 + j * sp.tc
        out[:, :, col:col + w] = tiles[t, :, :sp.m, :w]
    return out


def _launch_narrow(a, b, a_rows, b_rows, m, k, n, out_dtype,
                   keep_partials: bool = False):
    """``matmul_narrow_kernel``: f32 (m, k) @ (k, n), n <= 32, one launch,
    its split-K sum folded in.  With ``keep_partials``, also the splits'
    partial products as ``(splits, m, n)`` (None without split-K)."""
    global NARROW_LAUNCHES, NARROW_FOLDS
    a, b, op = _operands(a, b, a_rows, b_rows, m, k, n, "narrow")
    nw = plan_narrow(op.a, op.b, op.b_plan, _sm_count(a.device))
    if nw.smem > MAX_SMEM:
        raise ValueError(f"matmul: the narrow kernel's plan takes "
                         f"{nw.smem} bytes of shared memory")
    if max(m, k) >= 2 ** 31 or nw.rtiles * nw.splits >= 2 ** 31:
        raise ValueError(f"matmul: {m}x{k} @ {k}x{n} exceeds the narrow "
                         f"kernel's grid")
    device = a.device
    stream = torch.cuda.current_stream(device).cuda_stream
    out = torch.empty((m, n), dtype=out_dtype, device=device)
    ws = tickets = None
    if nw.splits > 1:
        ws = torch.empty(nw.ws_floats, dtype=torch.float32, device=device)
        tickets = _tickets(device, stream, nw.rtiles)
    desc = (op.a_map.spec() + op.b_plan.map.spec() + nw[:13]
            + (op.a_map.perm, op.b_plan.map.perm,
               int(out_dtype == torch.bfloat16)))
    with torch.cuda.device(device):
        rc = _lib().repro_matmul_narrow(
            a.data_ptr(), b.data_ptr(), out.data_ptr(),
            None if ws is None else ws.data_ptr(),
            None if tickets is None else tickets.data_ptr(),
            _NW_DESC.pack(*desc), stream)
    _raise_on(rc, f"narrow matmul kernel launch failed ({m}x{k} @ {k}x{n}, "
                  f"{nw.splits} splits)")
    NARROW_LAUNCHES += 1
    NARROW_FOLDS += nw.splits > 1
    if not keep_partials:
        return out
    return out, (None if ws is None else _narrow_partials(ws, nw))


def _narrow_partials(ws: torch.Tensor, nw: NarrowPlan) -> torch.Tensor:
    """The narrow kernel's workspace, (row tile, split, tile row, column),
    read back as ``(splits, m, n)``: row tile t holds rows ``rw .. rw +
    127`` of row block ``rb`` (those past the block's ``a_r1`` rows are
    padding)."""
    tiles = ws.view(nw.rtiles, nw.splits, NW_BM, nw.n)
    out = torch.empty((nw.splits, nw.m, nw.n), dtype=torch.float32,
                      device=ws.device)
    for t in range(nw.rtiles):
        rb, j = divmod(t, nw.rtpb)
        rw = j * NW_BM
        h = min(NW_BM, nw.a_r1 - rw)
        row = rb * nw.a_r1 + rw
        out[:, row:row + h] = tiles[t, :, :h]
    return out


def _launch_tile(a: torch.Tensor, b: torch.Tensor, m: int, k: int, n: int,
                 out_dtype: torch.dtype) -> torch.Tensor:
    global LAUNCHES, COPIES
    if not a.is_contiguous():
        COPIES += 1
    if not b.is_contiguous():
        COPIES += 1
    a = a.reshape(m, k).contiguous()
    b = b.reshape(k, n).contiguous()
    if max(m, n, k) >= 2 ** 31:
        raise ValueError(f"matmul dims must be < 2**31, got {m}, {k}, {n}")
    lib = _lib()
    config, splits, kchunk = plan_launch(m, n, k, _sm_count(a.device))
    bm = TILE_CONFIGS[config][0]
    if math.ceil(m / bm) > 65535:
        raise ValueError(f"matmul: {m} rows exceed the kernel's grid")
    if splits > 1:
        out = torch.empty((splits, m, n), dtype=torch.float32,
                          device=a.device)
    else:
        out = torch.empty((m, n), dtype=out_dtype, device=a.device)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    with torch.cuda.device(a.device):
        rc = lib.repro_matmul(a.data_ptr(), b.data_ptr(),
                              None if splits > 1 else out.data_ptr(),
                              out.data_ptr() if splits > 1 else None,
                              m, n, k, _DTYPE_CODES[a.dtype],
                              _DTYPE_CODES[out_dtype], config, splits, kchunk,
                              stream)
    _raise_on(rc, f"matmul kernel launch failed ({m}x{k} @ {k}x{n}, config "
                  f"{config}, splits {splits})")
    LAUNCHES += 1
    return splitk_reduce(out, out_dtype=out_dtype) if splits > 1 else out


def tc_kp(k: int) -> int:
    """K padded to the tensor-core kernel's step, :data:`TC_BK`."""
    return -(-k // TC_BK) * TC_BK


def tf32_split(x: torch.Tensor, *, rows: Optional[int] = None,
               transpose: bool = False) -> torch.Tensor:
    """The tensor-core route's operand pass, on the card: f32 ``x`` — 2-D,
    or an N-D view whose leading ``rows`` axes are its rows — as the
    ``(2, R, kp)`` f32 array of its TF32 big and small terms ([0], [1]), R
    its rows (or, with ``transpose``, its columns), each row padded along K
    to ``kp`` = :func:`tc_kp` (K) values with zeros; its plain version is
    :func:`.ref.tf32_split_ref`.  The kernel reads ``x`` where it lies when
    :func:`blocked_view` describes it, else it copies it first (counted in
    :data:`COPIES`)."""
    global SPLIT_LAUNCHES, COPIES
    if x.dtype != torch.float32:
        raise TypeError(f"tf32_split takes f32, got {x.dtype}")
    nr, nc = _dims(x, rows, "x")
    kp = tc_kp(nr if transpose else nc)
    if x.device.type != "cuda":
        raise ValueError(f"the split kernel takes a CUDA tensor, got one on "
                         f"{x.device}")
    out = torch.empty((2, nc if transpose else nr, kp), dtype=torch.float32,
                      device=x.device)
    if nr == 0 or nc == 0:
        return out.zero_()
    view = blocked_view(x.shape, x.stride(), rows or 1)
    if view is None:
        x = x.reshape(nr, nc).contiguous()
        COPIES += 1
        view = blocked_view(x.shape, x.stride(), 1)
    args = _SPLIT_ARGS.pack(*view.shape, *view.strides, kp, int(transpose))
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        rc = _lib().repro_tf32_split(x.data_ptr(), out.data_ptr(), args,
                                     stream)
    _raise_on(rc, f"tf32 split launch failed ({nr}x{nc}, transpose "
                  f"{transpose}, kp {kp})")
    SPLIT_LAUNCHES += 1
    return out


def _tc_gemm(a2: torch.Tensor, b2: torch.Tensor, m: int, n: int,
             out_dtype: torch.dtype) -> torch.Tensor:
    """``matmul_tc_kernel`` alone: C (m, n) from the split arrays of A and
    of Bᵀ, as :func:`tf32_split` writes them."""
    global TC_LAUNCHES
    if max(m, n, a2.shape[2]) >= 2 ** 31:
        raise ValueError(f"matmul dims must be < 2**31, got {m}, "
                         f"{a2.shape[2]}, {n}")
    out = torch.empty((m, n), dtype=out_dtype, device=a2.device)
    stream = torch.cuda.current_stream(a2.device).cuda_stream
    with torch.cuda.device(a2.device):
        rc = _lib().repro_matmul_tc(a2.data_ptr(), b2.data_ptr(),
                                    out.data_ptr(), m, n, a2.shape[2],
                                    int(out_dtype == torch.bfloat16), stream)
    _raise_on(rc, f"tensor-core matmul launch failed ({m}x{a2.shape[2]} @ "
                  f"{a2.shape[2]}x{n})")
    TC_LAUNCHES += 1
    return out


def _launch_tc(a, b, a_rows, b_rows, m, n, out_dtype) -> torch.Tensor:
    a2 = tf32_split(a, rows=a_rows)
    b2 = tf32_split(b, rows=b_rows, transpose=True)
    return _tc_gemm(a2, b2, m, n, out_dtype)


def splitk_reduce(partial: torch.Tensor, *, impl: str = "auto",
                  out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``partial`` (splits, m, n) f32 summed over its first axis in split
    order: the second pass of a split-K product on the tile kernel.
    ``impl`` is ``"auto"`` (plain version for a CPU tensor, kernel for a
    CUDA tensor) or ``"kernel"``, as in :func:`matmul`."""
    global REDUCE_LAUNCHES
    if impl not in ("auto", "kernel"):
        raise ValueError(f"impl must be auto or kernel, got {impl!r}")
    if partial.dim() != 3 or partial.dtype != torch.float32:
        raise TypeError(f"splitk_reduce takes (splits, m, n) f32 partial "
                        f"sums, got {tuple(partial.shape)} {partial.dtype}")
    if out_dtype not in _DTYPE_CODES:
        raise TypeError(f"out_dtype must be f32 or bf16, got {out_dtype}")
    if impl == "auto" and partial.device.type == "cpu":
        return splitk_reduce_ref(partial, out_dtype)
    if partial.device.type != "cuda" or not partial.is_contiguous():
        raise ValueError(f"the split-K reduction kernel takes a contiguous "
                         f"CUDA tensor, got one on {partial.device}")
    splits, m, n = partial.shape
    out = torch.empty((m, n), dtype=out_dtype, device=partial.device)
    if splits == 0 or m * n == 0:
        return out.zero_()
    stream = torch.cuda.current_stream(partial.device).cuda_stream
    with torch.cuda.device(partial.device):
        rc = _lib().repro_splitk_reduce(partial.data_ptr(), out.data_ptr(),
                                        m * n, splits,
                                        _DTYPE_CODES[out_dtype], stream)
    _raise_on(rc, f"split-K reduction launch failed ({splits} x {m}x{n})")
    REDUCE_LAUNCHES += 1
    return out


def matmul(a: torch.Tensor, b: torch.Tensor, *, impl: str = "auto",
           out_dtype: Optional[torch.dtype] = None,
           a_rows: Optional[int] = None,
           b_rows: Optional[int] = None) -> torch.Tensor:
    """``a @ b`` for f32 or bf16 operands, summed in f32.  An operand is a
    2-D tensor, or an N-D view whose leading ``a_rows`` (``b_rows``) axes
    are its rows: it stands for ``a.reshape(rows, -1)``."""
    if impl not in ("auto", "kernel", "plain"):
        raise ValueError(f"impl must be auto, kernel or plain, got {impl!r}")
    out_dtype, m, k, n = _check(a, b, out_dtype, a_rows, b_rows)
    where = _route(a, b, impl, m, n)
    if where == "plain":
        return matmul_ref(a.reshape(m, k), b.reshape(k, n), out_dtype)
    _on_one_card(a, b)
    if m == 0 or n == 0 or k == 0:
        return torch.zeros((m, n), dtype=out_dtype, device=a.device)
    if where == "skinny":
        return _launch_skinny(a, b, a_rows or 1, b_rows or 1, m, k, n,
                              out_dtype)
    if where == "tc":
        return _launch_tc(a, b, a_rows, b_rows, m, n, out_dtype)
    if where == "narrow":
        return _launch_narrow(a, b, a_rows or 1, b_rows or 1, m, k, n,
                              out_dtype)
    return _launch_tile(a, b, m, k, n, out_dtype)

