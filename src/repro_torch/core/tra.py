"""Tensor relations and eager TRA operations (paper §2).

Port of ``repro.core.tra``.  A tensor relation of type ``R^(k, r, b)`` with
frontier ``f`` is a dense torch tensor of shape ``f ++ b`` (keys are the
leading ``k`` axes); holes left by ``σ`` or a non-bijective ``ReKey`` are a
*static* numpy boolean ``mask`` over the key grid.  Values live on whatever
device their tensors live on — the operations never move data between
devices.

Ported here: ``RelType`` (with a torch dtype), ``TensorRelation``,
``from_tensor`` / ``to_tensor``, ``join``, ``agg``, ``transform``,
``fused_join_agg`` with its 2-D matmul lowering (through the hand-written
CUDA kernel, :func:`repro_torch.kernels.matmul.ops.matmul`) and its einsum
lowering, and the serving helpers ``pack_rows`` / ``unpack_rows`` /
``scatter_rows`` / ``zero_rows``.

Not ported yet (each raises ``NotImplementedError`` naming its slice, see
``ROADMAP.md``): ``rekey``, ``filt``, ``pad``, ``tile``, ``concat`` and the
chunked streaming lowering of ``fused_join_agg`` (training slice, 2).
``fused_join_agg`` therefore takes no ``chunk``/``budget``/``ctx``/``node``
arguments: they only steer that lowering, the out-of-core autotuner and
the fault hooks, which later slices bring.
"""
from __future__ import annotations

import dataclasses
import math
import string
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.kernels_registry import Kernel

KeyFunc = Callable[[Tuple[int, ...]], Tuple[int, ...]]
BoolFunc = Callable[[Tuple[int, ...]], bool]


@dataclasses.dataclass(frozen=True)
class RelType:
    """Static type of a tensor relation: key frontier + array bound."""

    key_shape: Tuple[int, ...]   # frontier f  (exact, by continuity)
    bound: Tuple[int, ...]       # array bound b
    dtype: torch.dtype = torch.float32

    @property
    def key_arity(self) -> int:
        return len(self.key_shape)

    @property
    def rank(self) -> int:
        return len(self.bound)

    @property
    def ntuples(self) -> int:
        return math.prod(self.key_shape) if self.key_shape else 1

    @property
    def nfloats(self) -> int:
        """Total scalar payload — the paper's exact ``n × ∏ b_i``."""
        return self.ntuples * (math.prod(self.bound) if self.bound else 1)

    def with_key_shape(self, ks: Sequence[int]) -> "RelType":
        return dataclasses.replace(self, key_shape=tuple(ks))

    def with_bound(self, b: Sequence[int]) -> "RelType":
        return dataclasses.replace(self, bound=tuple(b))


@dataclasses.dataclass
class TensorRelation:
    """A dense-backed tensor relation value."""

    data: torch.Tensor           # shape = key_shape + bound
    rtype: RelType
    mask: Optional[np.ndarray] = None   # static validity grid or None (=all)

    def __post_init__(self) -> None:
        expect = tuple(self.rtype.key_shape) + tuple(self.rtype.bound)
        if tuple(self.data.shape) != expect:
            raise ValueError(
                f"data shape {tuple(self.data.shape)} != type shape {expect}")
        if self.mask is not None and self.mask.shape != self.rtype.key_shape:
            raise ValueError("mask shape mismatch")

    # -- conveniences -----------------------------------------------------
    @property
    def key_shape(self) -> Tuple[int, ...]:
        return self.rtype.key_shape

    @property
    def bound(self) -> Tuple[int, ...]:
        return self.rtype.bound

    def is_continuous(self) -> bool:
        return self.mask is None or bool(np.all(self.mask))

    def valid_keys(self) -> np.ndarray:
        """(n, k) int array of valid keys, row-major order."""
        if not self.key_shape:
            return np.zeros((1, 0), np.int64)
        grid = np.indices(self.key_shape).reshape(len(self.key_shape), -1).T
        if self.mask is None:
            return grid
        return grid[self.mask.reshape(-1)]

    def to_dict(self) -> dict:
        """Materialize as {key tuple: np.ndarray} (reference format)."""
        out = {}
        data = self.data.detach().cpu().float().numpy()
        for key in self.valid_keys():
            out[tuple(int(x) for x in key)] = data[tuple(key)]
        return out


def _full_mask_and(a: Optional[np.ndarray], b: Optional[np.ndarray],
                   shape: Tuple[int, ...]) -> Optional[np.ndarray]:
    if a is None and b is None:
        return None
    aa = np.broadcast_to(a if a is not None else True, shape)
    bb = np.broadcast_to(b if b is not None else True, shape)
    return np.logical_and(aa, bb)


def _device_mask(mask: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(mask), device=like.device)


def _not_ported(what: str, slice_no: int) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet (slice {slice_no}; "
        f"see ROADMAP.md)")


# ==========================================================================
# Constructors
# ==========================================================================

def from_tensor(tensor: torch.Tensor, tile: Sequence[int]) -> TensorRelation:
    """Chunk a dense tensor into a tensor relation with block-index keys.

    ``tile[d]`` is the block size along tensor dim ``d`` (must divide the
    dim).  Keys are block coordinates; arrays are the blocks.
    """
    tile = tuple(tile)
    if len(tile) != tensor.dim():
        raise ValueError("tile rank mismatch")
    key_shape = []
    for d, t in enumerate(tile):
        if tensor.shape[d] % t:
            raise ValueError(f"dim {d} ({tensor.shape[d]}) not divisible by {t}")
        key_shape.append(tensor.shape[d] // t)
    # reshape (k0, t0, k1, t1, ...) then move key axes to the front
    interleaved = []
    for k, t in zip(key_shape, tile):
        interleaved += [k, t]
    x = tensor.reshape(interleaved)
    perm = list(range(0, 2 * len(tile), 2)) + list(range(1, 2 * len(tile), 2))
    x = x.permute(perm).contiguous()
    rt = RelType(tuple(key_shape), tile, tensor.dtype)
    return TensorRelation(x, rt)


def to_tensor(rel: TensorRelation,
              key_dims: Optional[Sequence[int]] = None) -> torch.Tensor:
    """Reassemble a continuous relation into a dense tensor.

    ``key_dims[i]`` names the array dim that key dim ``i`` blocks along
    (default: the identity, requiring key arity == rank).
    """
    if not rel.is_continuous():
        raise ValueError("cannot reassemble a relation with holes")
    k, r = rel.rtype.key_arity, rel.rtype.rank
    if key_dims is None:
        if k != r:
            raise ValueError(f"key arity {k} != rank {r}; pass key_dims")
        key_dims = tuple(range(k))
    key_dims = tuple(key_dims)
    if len(key_dims) != k or len(set(key_dims)) != k:
        raise ValueError("key_dims must name each key dim once")
    # interleave: for each array dim, optionally prefix its key dim
    perm = []
    shape = []
    for d in range(r):
        if d in key_dims:
            perm.append(key_dims.index(d))
            shape.append(rel.key_shape[key_dims.index(d)] * rel.bound[d])
        else:
            shape.append(rel.bound[d])
        perm.append(k + d)
    return rel.data.permute(perm).reshape(shape)


# ==========================================================================
# TRA operations (eager, dense)
# ==========================================================================

@dataclasses.dataclass
class _JoinGeometry:
    """Key alignment shared by ``join`` and ``fused_join_agg``.

    ``ldata`` is the frontier-sliced left payload (shape ``f_out_l ++
    left.bound``); ``rdata_t`` is the right payload with its key axes moved
    into output-axis order (shape = covered-axis sizes ++ right.bound).
    ``r_shape`` is the singleton-expanded right key shape over the full
    output key grid.  Nothing here is broadcast yet — the grid is only
    materialized by ``join``, never by the fused path.
    """

    kl: int
    kr: int
    k_out: int
    f_out_l: Tuple[int, ...]
    out_key_shape: Tuple[int, ...]
    covered: Tuple[int, ...]          # output key axes the right side covers
    r_shape: Tuple[int, ...]
    ldata: torch.Tensor
    rdata_t: torch.Tensor
    lmask: Optional[np.ndarray]
    rmask_t: Optional[np.ndarray]


def _join_align(left: TensorRelation, right: TensorRelation,
                jkl: Tuple[int, ...], jkr: Tuple[int, ...]) -> _JoinGeometry:
    if len(jkl) != len(jkr):
        raise ValueError("join key lists must have equal length")
    if left.data.device != right.data.device:
        raise ValueError(f"join operands on different devices: "
                         f"{left.data.device} and {right.data.device}")
    kl = left.rtype.key_arity
    kr = right.rtype.key_arity
    r_nonjoin = [d for d in range(kr) if d not in jkr]

    # equi-join on a dense grid: valid range of a joined dim is the min of
    # the two frontiers (paper §4.3 rule 1)
    f_out_l = list(left.key_shape)
    for i, dl in enumerate(jkl):
        f_out_l[dl] = min(left.key_shape[dl], right.key_shape[jkr[i]])
    ldata = left.data[tuple(slice(0, f) for f in f_out_l)]
    lmask = None if left.mask is None else \
        left.mask[tuple(slice(0, f) for f in f_out_l)]

    r_slices = [slice(None)] * kr
    for i, dr in enumerate(jkr):
        r_slices[dr] = slice(0, f_out_l[jkl[i]])
    rdata = right.data[tuple(r_slices)]
    rmask = None if right.mask is None else right.mask[tuple(r_slices)]

    out_key_shape = tuple(f_out_l) + tuple(rdata.shape[d] for d in r_nonjoin)
    k_out = len(out_key_shape)

    # Align RIGHT onto the output key axes:
    #   joined right dim jkr[i]   -> output axis jkl[i]
    #   non-joined right dim d    -> output axis kl + (index in r_nonjoin)
    out_axis_of_rdim = {}
    for i, dr in enumerate(jkr):
        out_axis_of_rdim[dr] = jkl[i]
    for i, dr in enumerate(r_nonjoin):
        out_axis_of_rdim[dr] = kl + i
    order = sorted(range(kr), key=lambda d: out_axis_of_rdim[d])
    dest = [order.index(d) for d in range(kr)]
    rdata_t = torch.movedim(rdata, list(range(kr)), dest)
    rmask_t = None if rmask is None else np.moveaxis(
        rmask, list(range(kr)), dest)
    # singleton axes for output key axes not covered by the right
    covered = tuple(sorted(out_axis_of_rdim.values()))
    r_shape = []
    ci = 0
    for ax in range(k_out):
        if ci < len(covered) and covered[ci] == ax:
            r_shape.append(rdata_t.shape[ci])
            ci += 1
        else:
            r_shape.append(1)
    return _JoinGeometry(kl, kr, k_out, tuple(f_out_l), out_key_shape,
                         covered, tuple(r_shape), ldata, rdata_t,
                         lmask, rmask_t)


def join(left: TensorRelation, right: TensorRelation,
         join_keys_l: Sequence[int], join_keys_r: Sequence[int],
         kernel: Kernel) -> TensorRelation:
    """⋈_(joinKeysL, joinKeysR, projOp)(L, R).

    Output keys: all left keys (original order) then right keys with the
    joined dims dropped — the paper's natural-join convention.
    """
    jkl, jkr = tuple(join_keys_l), tuple(join_keys_r)
    g = _join_align(left, right, jkl, jkr)
    rdata_b = g.rdata_t.reshape(g.r_shape + tuple(right.bound))
    rmask_b = None if g.rmask_t is None else g.rmask_t.reshape(g.r_shape)

    # left occupies the first kl output axes
    ldata_b = g.ldata.reshape(g.f_out_l + (1,) * (g.k_out - g.kl)
                              + tuple(left.bound))

    lb = ldata_b.expand(g.out_key_shape + tuple(left.bound))
    rb = rdata_b.expand(g.out_key_shape + tuple(right.bound))
    out = kernel.apply(lb, rb)

    out_bound = kernel.out_bound(left.bound, right.bound)
    rt = RelType(g.out_key_shape, tuple(out_bound), out.dtype)
    lmask_b = None if g.lmask is None else g.lmask.reshape(
        g.f_out_l + (1,) * (g.k_out - g.kl))
    mask = _full_mask_and(lmask_b, rmask_b, g.out_key_shape)
    return TensorRelation(out, rt, mask)


def _tree_fold(blocks: torch.Tensor, kernel: Kernel) -> torch.Tensor:
    """Fold axis 0 of ``blocks`` with an associative binary kernel."""
    n = blocks.shape[0]
    while n > 1:
        half = n // 2
        a = blocks[:half]
        b = blocks[half:2 * half]
        merged = kernel.apply(a, b)
        if n % 2:
            merged = torch.cat([merged, blocks[2 * half:n]], dim=0)
        blocks = merged
        n = blocks.shape[0]
    return blocks[0]


def agg(rel: TensorRelation, group_by: Sequence[int],
        kernel: Kernel) -> TensorRelation:
    """Σ_(groupByKeys, aggOp)(R)."""
    if not kernel.is_associative:
        raise ValueError(f"agg kernel {kernel.name} must be associative")
    gb = tuple(group_by)
    k = rel.rtype.key_arity
    reduce_dims = tuple(d for d in range(k) if d not in gb)
    # reorder keys: group-by dims (in requested order) first
    perm = list(gb) + list(reduce_dims)
    data = torch.movedim(rel.data, perm, list(range(k)))
    out_key_shape = tuple(rel.key_shape[d] for d in gb)

    mask = rel.mask
    if mask is not None:
        mask_t = np.moveaxis(mask, perm, list(range(k)))
        if kernel.identity is None:
            raise ValueError(
                f"agg over holes needs identity for {kernel.name}")
        fill = torch.tensor(kernel.identity, dtype=data.dtype,
                            device=data.device)
        mb = mask_t.reshape(mask_t.shape + (1,) * rel.rtype.rank)
        data = torch.where(_device_mask(mb, data), data, fill)
        out_mask = np.any(mask_t, axis=tuple(range(len(gb), k))) \
            if reduce_dims else mask_t
        if np.all(out_mask):
            out_mask = None
    else:
        out_mask = None

    axes = tuple(range(len(gb), k))
    if not axes:
        out = data
    elif kernel.reduce is not None:
        out = kernel.reduce(data, axes)
    else:
        flat = data.reshape(out_key_shape + (-1,) + tuple(rel.bound))
        flat = torch.movedim(flat, len(gb), 0)
        out = _tree_fold(flat, kernel)
    rt = RelType(out_key_shape, rel.bound, out.dtype)
    return TensorRelation(out, rt, out_mask)


# ==========================================================================
# Fused join→agg (Σ∘⋈ as a blocked contraction — never materializes the
# broadcasted cross-product grid the unfused pair would build)
# ==========================================================================

# Join kernels whose Σ∘⋈ with matAdd is a pure tensor contraction.  The
# value maps (left-bound, right-bound, out-bound) dims to contraction
# letters; ``None`` marks an elementwise kernel (all bound dims shared).
_CONTRACTION_JOINS = {
    "matMul": ("mk", "kn", "mn"),
    "matTranMulL": ("km", "kn", "mn"),
    "matTranMulR": ("mk", "nk", "mn"),
    "elemMul": None,
}


def can_fuse(join_kernel: Kernel, agg_kernel: Kernel) -> bool:
    """True when ``agg(join(·, join_kernel), agg_kernel)`` has a fused
    lowering (a contraction or a streamed associative reduction)."""
    return (join_kernel.arity == 2 and agg_kernel.arity == 2
            and agg_kernel.is_associative)


def _joint_mask_grid(g: _JoinGeometry) -> Optional[np.ndarray]:
    """Joined validity grid over the full output key space (bools only —
    key-grid sized, so cheap even when the payload grid is not)."""
    if g.lmask is None and g.rmask_t is None:
        return None
    lm = (g.lmask if g.lmask is not None
          else np.ones(g.f_out_l, bool)).reshape(
        g.f_out_l + (1,) * (g.k_out - g.kl))
    rm = (g.rmask_t.reshape(g.r_shape) if g.rmask_t is not None
          else np.ones((1,) * g.k_out, bool))
    return np.broadcast_to(lm, g.out_key_shape) \
        & np.broadcast_to(rm, g.out_key_shape)


def _fused_out_mask(g: _JoinGeometry, gb: Tuple[int, ...],
                    reduce_dims: Tuple[int, ...]) -> Optional[np.ndarray]:
    """Static output mask of agg∘join."""
    jm = _joint_mask_grid(g)
    if jm is None:
        return None
    om = np.any(jm, axis=reduce_dims) if reduce_dims else jm
    remaining = [d for d in range(g.k_out) if d not in reduce_dims]
    om = om.transpose([remaining.index(d) for d in gb])
    return None if np.all(om) else om


def _zero_fill(data: torch.Tensor, mask: Optional[np.ndarray],
               bound_rank: int) -> torch.Tensor:
    if mask is None:
        return data
    m = _device_mask(mask.reshape(mask.shape + (1,) * bound_rank), data)
    return torch.where(m, data, torch.zeros((), dtype=data.dtype,
                                            device=data.device))


def _fused_matmul_2d(g: _JoinGeometry, left: TensorRelation,
                     right: TensorRelation, jkl: Tuple[int, ...],
                     gb: Tuple[int, ...]) -> torch.Tensor:
    """Collapse Σ∘⋈_(matMul→matAdd) into ONE blocked 2-D matmul.

    Valid when every joined key dim is reduced and every reduced dim is
    joined: the whole expression is exactly ``(I·m, K·c) @ (K·c, J·n)`` —
    the paper's claim that the TRA plan *is* the hand-tuned contraction.
    Dispatches through :func:`repro_torch.kernels.matmul.ops.matmul`
    (``impl="auto"``): a hand-written CUDA kernel for CUDA operands, its
    plain version for CPU ones.

    Deviation from ``repro.core.tra._fused_matmul_2d``, which transposes
    each blocked operand and reshapes it into a 2-D copy
    (``src/repro/core/tra.py:411``): here each operand goes to the matmul
    op as a permuted view of the relation's own tensor, its leading axes
    the rows (``a_rows`` / ``b_rows``), and the op decides what to copy.
    On the card the f32 kernel reads such a view in place when its rows
    and its columns each merge at most two strided axes — the scorer's
    blocked ``W1``, ``(db, hb, bd, bh)`` read as the (db·bd, hb·bh)
    matrix, is not copied; on the CPU the plain version gets the same
    views.
    """
    from repro_torch.kernels.matmul.ops import matmul as matmul_op

    kl = g.kl
    kept_l = [ax for ax in range(kl) if ax not in jkl]
    kept_r = [ax for ax in range(kl, g.k_out)]
    m, c = left.bound
    _, n = right.bound
    # left: (f_out_l ++ (m, c)) → (kept_l..., m | joined..., c)
    lperm = kept_l + [kl] + list(jkl) + [kl + 1]
    # right: covered-axis order → (joined in jkl order..., c | kept_r..., n)
    pos = {ax: i for i, ax in enumerate(g.covered)}
    nb = len(g.covered)
    rperm = [pos[ax] for ax in jkl] + [nb] \
        + [pos[ax] for ax in kept_r] + [nb + 1]
    out2 = matmul_op(g.ldata.permute(lperm), g.rdata_t.permute(rperm),
                     impl="auto", a_rows=len(kept_l) + 1,
                     b_rows=len(jkl) + 1)
    # back to blocks: (kept_l..., m, kept_r..., n) → gb order ++ (m, n)
    out = out2.reshape(tuple(g.f_out_l[ax] for ax in kept_l) + (m,)
                       + tuple(g.out_key_shape[ax] for ax in kept_r) + (n,))
    axis_of = {ax: i for i, ax in enumerate(kept_l)}
    for j, ax in enumerate(kept_r):
        axis_of[ax] = len(kept_l) + 1 + j
    perm = [axis_of[d] for d in gb] + [len(kept_l),
                                       len(kept_l) + 1 + len(kept_r)]
    return out.permute(perm)


def _fused_einsum(g: _JoinGeometry, left: TensorRelation,
                  right: TensorRelation, join_kernel: Kernel,
                  gb: Tuple[int, ...]) -> torch.Tensor:
    """Lower Σ∘⋈ to one ``torch.einsum`` contraction."""
    letters = string.ascii_lowercase + string.ascii_uppercase
    key_l = letters[:g.k_out]
    spec = _CONTRACTION_JOINS[join_kernel.name]
    if spec is None:                       # elementwise join kernel
        r = len(left.bound)
        bl = br = bo = letters[g.k_out:g.k_out + r]
    else:
        fresh = {ch: letters[g.k_out + i]
                 for i, ch in enumerate(sorted(set("".join(spec))))}
        bl, br, bo = ("".join(fresh[ch] for ch in part) for part in spec)
    l_sub = "".join(key_l[ax] for ax in range(g.kl)) + bl
    r_sub = "".join(key_l[ax] for ax in g.covered) + br
    o_sub = "".join(key_l[d] for d in gb) + bo
    ldata = _zero_fill(g.ldata, g.lmask, len(left.bound))
    rdata = _zero_fill(g.rdata_t, g.rmask_t, len(right.bound))
    return torch.einsum(f"{l_sub},{r_sub}->{o_sub}", ldata, rdata)


def fused_join_agg(left: TensorRelation, right: TensorRelation,
                   join_keys_l: Sequence[int], join_keys_r: Sequence[int],
                   join_kernel: Kernel, group_by: Sequence[int],
                   agg_kernel: Kernel) -> TensorRelation:
    """Σ_(groupBy, aggOp) ∘ ⋈_(jkl, jkr, projOp) without the grid.

    Semantically identical to ``agg(join(left, right, ...), group_by, ...)``
    (``group_by`` indexes the join's output key space) but lowered as:

    * one blocked 2-D matmul (the hand-written CUDA kernel on the card)
      when (matMul, matAdd) collapses cleanly — the paper's BMM/CPMM/RMM
      inner contraction;
    * one ``torch.einsum`` for any other contraction-shaped pair
      (matMul / matTranMulL / matTranMulR / elemMul with matAdd);
    * every other associative kernel pair streams its reduction in chunks
      in the JAX package; that lowering is not ported yet and raises.

    Falls back to the unfused pair when nothing is actually reduced or when
    holes cannot be identity-filled — the unfused path remains the
    correctness oracle in all cases.
    """
    jkl, jkr = tuple(join_keys_l), tuple(join_keys_r)
    gb = tuple(group_by)
    if not agg_kernel.is_associative:
        raise ValueError(f"agg kernel {agg_kernel.name} must be associative")
    g = _join_align(left, right, jkl, jkr)
    reduce_dims = tuple(d for d in range(g.k_out) if d not in gb)
    if not reduce_dims or not can_fuse(join_kernel, agg_kernel):
        return agg(join(left, right, jkl, jkr, join_kernel), gb, agg_kernel)

    out_bound = tuple(join_kernel.out_bound(left.bound, right.bound))
    out_key_shape = tuple(g.out_key_shape[d] for d in gb)
    out_mask = _fused_out_mask(g, gb, reduce_dims)

    if agg_kernel.name == "matAdd" and join_kernel.name in _CONTRACTION_JOINS:
        if (join_kernel.name == "matMul" and g.lmask is None
                and g.rmask_t is None and set(reduce_dims) == set(jkl)):
            data = _fused_matmul_2d(g, left, right, jkl, gb)
        else:
            data = _fused_einsum(g, left, right, join_kernel, gb)
        return TensorRelation(
            data, RelType(out_key_shape, out_bound, data.dtype), out_mask)

    has_mask = g.lmask is not None or g.rmask_t is not None
    if has_mask and agg_kernel.identity is None:
        # cannot identity-fill holes — mirror tra.agg's requirement
        return agg(join(left, right, jkl, jkr, join_kernel), gb, agg_kernel)
    raise _not_ported(
        f"the chunked streaming lowering of fused_join_agg "
        f"({join_kernel.name} → {agg_kernel.name})", 2)


def rekey(rel: TensorRelation, key_func: KeyFunc,
          out_arity: Optional[int] = None) -> TensorRelation:
    """ReKey_(keyFunc)(R) — not ported yet."""
    raise _not_ported("tra.rekey", 2)


def filt(rel: TensorRelation, bool_func: BoolFunc) -> TensorRelation:
    """σ_(boolFunc)(R) — not ported yet."""
    raise _not_ported("tra.filt", 2)


def pad(rel: TensorRelation, key_shape: Sequence[int]) -> TensorRelation:
    """Pad_(keyShape)(R) — not ported yet."""
    raise _not_ported("tra.pad", 2)


def transform(rel: TensorRelation, kernel: Kernel) -> TensorRelation:
    """λ_(transformFunc)(R)."""
    out = kernel.apply(rel.data)
    out_bound = tuple(kernel.out_bound(rel.bound))
    rt = RelType(rel.key_shape, out_bound, out.dtype)
    return TensorRelation(out, rt, rel.mask)


def tile(rel: TensorRelation, tile_dim: int, tile_size: int) -> TensorRelation:
    """Tile_(tileDim, tileSize)(R) — not ported yet."""
    raise _not_ported("tra.tile", 2)


def concat(rel: TensorRelation, key_dim: int, array_dim: int) -> TensorRelation:
    """Concat_(keyDim, arrayDim)(R) — not ported yet."""
    raise _not_ported("tra.concat", 2)


# ==========================================================================
# Serving helpers (repro_torch.serve): batch-key packing + fixed-capacity
# slots
# ==========================================================================
#
# A serving layer batches concurrent requests into ONE relation by adding a
# new leading key dim (the batch key), padded to a bucket size so the
# engine's structural compile cache stays hot across request counts.  The
# decode state lives in a fixed-capacity relation whose leading key dim
# indexes *slots*; admission/eviction are functional row writes.  All four
# helpers require continuous (mask-free) relations — serving padding is
# zero *rows*, not key holes, so the batched programs run on every
# executor.

def _batched_rtype(rtype: RelType, bucket: int) -> RelType:
    return RelType((bucket,) + tuple(rtype.key_shape), tuple(rtype.bound),
                   rtype.dtype)


def pack_rows(rows: Sequence, bucket: int, rtype: RelType
              ) -> TensorRelation:
    """Pack per-request values into one bucket-padded batched relation.

    ``rows`` are :class:`TensorRelation`\\ s of type ``rtype`` (or raw
    dense arrays of shape ``key_shape ++ bound``), one per request.  The
    result gains a NEW leading key dim of size ``bucket`` — row ``i`` is
    request ``i``'s value; rows ``len(rows)..bucket-1`` are zero padding.
    Programs that never contract the batch key dim compute each row
    independently, so the padding rows are inert.  Rows stay where they
    are (numpy rows go to the CPU); rows on different devices raise.
    """
    if not 0 < len(rows) <= bucket:
        raise ValueError(
            f"pack_rows: {len(rows)} rows do not fit bucket {bucket}")
    dense = tuple(rtype.key_shape) + tuple(rtype.bound)
    datas = []
    for i, r in enumerate(rows):
        if isinstance(r, TensorRelation):
            if r.rtype.key_shape != rtype.key_shape \
                    or r.rtype.bound != rtype.bound:
                raise ValueError(
                    f"pack_rows: row {i} has type "
                    f"f={r.rtype.key_shape} b={r.rtype.bound}, expected "
                    f"f={rtype.key_shape} b={rtype.bound}")
            if r.mask is not None:
                raise ValueError(
                    f"pack_rows: row {i} carries a mask; serving "
                    f"relations must be continuous")
            datas.append(r.data.to(rtype.dtype))
        else:
            arr = torch.as_tensor(r, dtype=rtype.dtype)
            if tuple(arr.shape) != dense:
                raise ValueError(
                    f"pack_rows: row {i} has dense shape "
                    f"{tuple(arr.shape)}, expected {dense}")
            datas.append(arr)
    stacked = torch.stack(datas, dim=0)
    if len(rows) < bucket:
        padding = stacked.new_zeros((bucket - len(rows),) + dense)
        stacked = torch.cat([stacked, padding], dim=0)
    return TensorRelation(stacked, _batched_rtype(rtype, bucket))


def unpack_rows(rel: TensorRelation, n: Optional[int] = None) -> list:
    """Split a batched relation back into per-request relations.

    Inverse of :func:`pack_rows` over the leading (batch) key dim:
    returns the first ``n`` rows (default: all) as relations typed
    without the batch key dim.
    """
    if rel.mask is not None:
        raise ValueError("unpack_rows: batched relations are continuous")
    if not rel.rtype.key_shape:
        raise ValueError("unpack_rows: relation has no batch key dim")
    bucket = rel.rtype.key_shape[0]
    n = bucket if n is None else n
    if not 0 <= n <= bucket:
        raise ValueError(f"unpack_rows: n={n} outside bucket {bucket}")
    row_rt = RelType(tuple(rel.rtype.key_shape[1:]),
                     tuple(rel.rtype.bound), rel.rtype.dtype)
    return [TensorRelation(rel.data[i], row_rt) for i in range(n)]


def scatter_rows(rel: TensorRelation, slots: Sequence[int],
                 rows: Sequence) -> TensorRelation:
    """Functionally write per-slot values into a fixed-capacity relation.

    ``rel`` is slot-keyed (leading key dim = capacity); ``rows[i]`` (a
    relation or dense array typed like one slot) replaces slot
    ``slots[i]``.  Out-of-place: ``rel.data`` is never written, so a
    compiled step program's inputs are never mutated under it.
    """
    if len(slots) != len(rows):
        raise ValueError(
            f"scatter_rows: {len(slots)} slots vs {len(rows)} rows")
    if rel.mask is not None:
        raise ValueError("scatter_rows: slot relations are continuous")
    if not rel.rtype.key_shape:
        raise ValueError("scatter_rows: relation has no slot key dim")
    if not slots:
        return rel
    capacity = rel.rtype.key_shape[0]
    dense = tuple(rel.rtype.key_shape[1:]) + tuple(rel.rtype.bound)
    dev = rel.data.device
    datas = []
    for i, r in enumerate(rows):
        arr = r.data if isinstance(r, TensorRelation) else r
        arr = torch.as_tensor(arr, dtype=rel.rtype.dtype, device=dev)
        if tuple(arr.shape) != dense:
            raise ValueError(
                f"scatter_rows: row {i} has dense shape "
                f"{tuple(arr.shape)}, expected {dense}")
        datas.append(arr)
    idx = []
    for s in slots:
        if not 0 <= s < capacity:
            raise ValueError(
                f"scatter_rows: slot {s} outside capacity {capacity}")
        idx.append(int(s))
    if len(set(idx)) != len(idx):
        raise ValueError(f"scatter_rows: duplicate slots {idx}")
    data = rel.data.clone()
    data[torch.as_tensor(idx, device=dev)] = torch.stack(datas, dim=0)
    return TensorRelation(data, rel.rtype)


def zero_rows(rel: TensorRelation, slots: Sequence[int]) -> TensorRelation:
    """Zero the given slots of a fixed-capacity relation (slot free).

    A full-capacity mask multiply rather than a gather / scatter, as in the
    JAX package: the shapes depend only on the relation's type, never on
    ``len(slots)``.
    """
    if rel.mask is not None:
        raise ValueError("zero_rows: slot relations are continuous")
    if not rel.rtype.key_shape:
        raise ValueError("zero_rows: relation has no slot key dim")
    if not slots:
        return rel
    capacity = rel.rtype.key_shape[0]
    keep = torch.ones((capacity,) + (1,) * (rel.data.dim() - 1),
                      dtype=rel.data.dtype)
    for s in slots:
        if not 0 <= s < capacity:
            raise ValueError(f"zero_rows: slot {s} out of range "
                             f"[0, {capacity})")
        keep[s] = 0.0
    return TensorRelation(rel.data * keep.to(rel.data.device), rel.rtype)
