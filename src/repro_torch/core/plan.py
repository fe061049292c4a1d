"""Plan IR for the TRA (logical) and IA (physical) algebras.

Port of ``repro.core.plan``: plain Python and numpy, carried over as is
(placements, logical and physical node types, ``infer``, ``describe``,
``postorder``, ``as_node``, ``check_valid``), so the port's optimizer sees
exactly the plans the JAX package sees.

Logical nodes mirror paper §2; physical nodes mirror paper §3.  Physical
plans additionally carry a :class:`Placement` per node — the paper's
``ALL()`` / ``PART_D()`` predicates — which the validity checker uses to
guarantee that a physical plan is equivalent to its logical source, and the
cost model uses to price ``BCAST``/``SHUF`` exactly.

``LocalTile``/``LocalConcat`` are the Table-1 images of ``Tile``/``Concat``
(a multi-map ``λᴸ`` and a ``Σᴸ∘SHUF`` respectively); because our dense
representation makes them pure reshapes we keep them as first-class nodes
rather than encoding the multi-map arity machinery.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.kernels_registry import Kernel
from repro_torch.core.tra import RelType


# ==========================================================================
# Placements (paper §3: ALL / PART_D)
# ==========================================================================

@dataclasses.dataclass(frozen=True)
class Placement:
    """Tuple-to-site mapping summary.

    ``kind == "replicated"``  — ALL(R): every tuple on every site.
    ``kind == "partitioned"`` — PART_dims(R): key dims ``dims`` are sharded
    over the named mesh ``axes`` (equal length, zipped).

    ``dup_axes`` — mesh axes along which *duplicate keys with partial
    values* exist.  This is the paper's transient state inside a two-phase
    aggregation (R2-5): after the partial ``Σᴸ`` each site holds a partial
    array under the same key.  A subsequent ``SHUF`` lowers to
    ``reduce-scatter`` over these axes and a ``BCAST`` lowers to
    ``all-reduce`` — the TPU-idiomatic realizations.
    """

    kind: str
    dims: Tuple[int, ...] = ()
    axes: Tuple[str, ...] = ()
    dup_axes: Tuple[str, ...] = ()
    dup_kernel: Optional[str] = None   # agg kernel pending over dup_axes

    def __post_init__(self):
        if self.kind not in ("replicated", "partitioned"):
            raise ValueError(self.kind)
        if len(self.dims) != len(self.axes):
            raise ValueError("dims/axes length mismatch")

    @staticmethod
    def replicated() -> "Placement":
        return Placement("replicated")

    @staticmethod
    def partitioned(dims: Sequence[int], axes: Sequence[str],
                    dup_axes: Sequence[str] = (),
                    dup_kernel: Optional[str] = None) -> "Placement":
        return Placement("partitioned", tuple(dims), tuple(axes),
                         tuple(dup_axes), dup_kernel)

    @property
    def is_replicated(self) -> bool:
        return self.kind == "replicated" and not self.dup_axes

    @property
    def has_duplicates(self) -> bool:
        return bool(self.dup_axes)

    def axis_of_dim(self, d: int) -> Optional[str]:
        for dim, ax in zip(self.dims, self.axes):
            if dim == d:
                return ax
        return None

    def describe(self) -> str:
        if self.kind == "replicated" and not self.dup_axes:
            return "ALL"
        inner = ",".join(f"{d}→{a}" for d, a in zip(self.dims, self.axes))
        s = f"PART({inner})" if self.dims else "SINGLE"
        if self.dup_axes:
            s += f"+dup{list(self.dup_axes)}"
        return s


# ==========================================================================
# Logical (TRA) nodes
# ==========================================================================

class TraNode:
    pass


@dataclasses.dataclass(frozen=True, eq=False)
class TraInput(TraNode):
    name: str
    rtype: RelType


@dataclasses.dataclass(frozen=True, eq=False)
class TraConst(TraNode):
    """A literal constant relation: every key of the full grid maps to an
    array filled with ``fill``.

    Introduced for the autodiff layer (Tang et al. direction): the seed
    cotangent of ``Σ`` over all output entries is a ones-relation, and the
    broadcast-back rule of an aggregation needs a zero-cost *shape donor*
    keyed by the pre-aggregation key space.  Constants are materialized
    locally by every executor, so they carry no communication cost and may
    be placed anywhere by the optimizer.
    """

    rtype: RelType
    fill: float


@dataclasses.dataclass(frozen=True, eq=False)
class TraJoin(TraNode):
    left: TraNode
    right: TraNode
    join_keys_l: Tuple[int, ...]
    join_keys_r: Tuple[int, ...]
    kernel: Kernel


@dataclasses.dataclass(frozen=True, eq=False)
class TraAgg(TraNode):
    child: TraNode
    group_by: Tuple[int, ...]
    kernel: Kernel


@dataclasses.dataclass(frozen=True, eq=False)
class TraReKey(TraNode):
    child: TraNode
    key_func: Callable
    tag: str = "keyFunc"


@dataclasses.dataclass(frozen=True, eq=False)
class TraFilter(TraNode):
    child: TraNode
    bool_func: Callable
    tag: str = "boolFunc"


@dataclasses.dataclass(frozen=True, eq=False)
class TraTransform(TraNode):
    child: TraNode
    kernel: Kernel


@dataclasses.dataclass(frozen=True, eq=False)
class TraTile(TraNode):
    child: TraNode
    tile_dim: int
    tile_size: int


@dataclasses.dataclass(frozen=True, eq=False)
class TraConcat(TraNode):
    child: TraNode
    key_dim: int
    array_dim: int


@dataclasses.dataclass(frozen=True, eq=False)
class TraPad(TraNode):
    """Densify: extend a relation with zero tuples to the full grid of
    ``key_shape`` (holes zero-filled, frontier grown, mask dropped).

    The dual of ``σ`` — not in the paper's §2 algebra, but required by its
    differentiation (Tang et al.): the cotangent of a filtered relation is
    *zero* (not absent) at the filtered-out keys, and cotangent fan-in
    accumulation must add relations over one common key grid.  ``Pad`` is
    the op that converts "absent" into "present with value 0".
    """

    child: TraNode
    key_shape: Tuple[int, ...]


# ==========================================================================
# Physical (IA) nodes
# ==========================================================================

class IANode:
    pass


@dataclasses.dataclass(frozen=True, eq=False)
class IAInput(IANode):
    name: str
    rtype: RelType
    placement: Placement


@dataclasses.dataclass(frozen=True, eq=False)
class IAConst(IANode):
    """Physical constant — materialized locally at any placement for free
    (a constant's shards are computable everywhere)."""

    rtype: RelType
    fill: float
    placement: Placement


@dataclasses.dataclass(frozen=True, eq=False)
class Bcast(IANode):
    child: IANode


@dataclasses.dataclass(frozen=True, eq=False)
class Shuf(IANode):
    child: IANode
    part_dims: Tuple[int, ...]
    axes: Tuple[str, ...]


@dataclasses.dataclass(frozen=True, eq=False)
class LocalJoin(IANode):
    left: IANode
    right: IANode
    join_keys_l: Tuple[int, ...]
    join_keys_r: Tuple[int, ...]
    kernel: Kernel


@dataclasses.dataclass(frozen=True, eq=False)
class LocalAgg(IANode):
    child: IANode
    group_by: Tuple[int, ...]
    kernel: Kernel
    # True for the *partial* phase of a two-phase (R2-5) aggregation: the
    # local combine that runs before the shuffle and is NOT yet the final
    # TRA-equivalent value.
    partial: bool = False


@dataclasses.dataclass(frozen=True, eq=False)
class FusedJoinAgg(IANode):
    """Σᴸ∘⋈ᴸ as one physical node — the paper's Σ∘⋈ contraction pattern.

    Semantically ``LocalAgg(LocalJoin(left, right, ...), group_by, ...)``
    (``group_by`` indexes the join's output key space) but lowered without
    materializing the broadcasted join grid: a single blocked contraction
    for (matMul, matAdd)-shaped kernel pairs, a streamed reduction
    otherwise.  ``partial=True`` is the R2-5 partial phase, exactly as on
    :class:`LocalAgg`.
    """

    left: IANode
    right: IANode
    join_keys_l: Tuple[int, ...]
    join_keys_r: Tuple[int, ...]
    join_kernel: Kernel
    group_by: Tuple[int, ...]
    agg_kernel: Kernel
    partial: bool = False


@dataclasses.dataclass(frozen=True, eq=False)
class LocalFilter(IANode):
    child: IANode
    bool_func: Callable
    tag: str = "boolFunc"


@dataclasses.dataclass(frozen=True, eq=False)
class LocalMap(IANode):
    child: IANode
    key_func: Optional[Callable]    # None == idOp on keys
    kernel: Kernel                  # idOp for pure re-keys
    tag: str = "keyFunc"


@dataclasses.dataclass(frozen=True, eq=False)
class LocalTile(IANode):
    child: IANode
    tile_dim: int
    tile_size: int


@dataclasses.dataclass(frozen=True, eq=False)
class LocalConcat(IANode):
    child: IANode
    key_dim: int
    array_dim: int


@dataclasses.dataclass(frozen=True, eq=False)
class LocalPad(IANode):
    """Physical Pad.  Zero-filling holes is always local; *growing* the
    frontier of a partitioned dim would shift the per-site key windows, so
    frontier growth requires a replicated child (the checker enforces it
    via placement inference)."""

    child: IANode
    key_shape: Tuple[int, ...]


def as_node(obj):
    """Unwrap an :class:`repro_torch.core.expr.Expr`-like handle to its plan node.

    Duck-typed (``obj.node``) so this module never imports the frontend;
    plain plan nodes pass through untouched.  Every legacy entry point
    (``evaluate_*``, ``optimize``, ``compile_tra``, ``infer``, ``describe``)
    unwraps through this, so code written against the old API composes with
    ``Expr``-returning builders.
    """
    if isinstance(obj, (TraNode, IANode)):
        return obj
    node = getattr(obj, "node", None)
    if isinstance(node, (TraNode, IANode)):
        return node
    return obj


def children(node) -> Tuple:
    if isinstance(node, (TraJoin, LocalJoin, FusedJoinAgg)):
        return (node.left, node.right)
    if isinstance(node, (TraInput, IAInput, TraConst, IAConst)):
        return ()
    return (node.child,)


def postorder(node) -> list:
    seen: Dict[int, None] = {}
    out = []

    def rec(n):
        if id(n) in seen:
            return
        seen[id(n)] = None
        for c in children(n):
            rec(c)
        out.append(n)

    rec(node)
    return out


def describe(node, indent: int = 0) -> str:
    node = as_node(node)
    pad = "  " * indent
    label = type(node).__name__
    extra = ""
    if isinstance(node, (TraInput, IAInput)):
        extra = f"[{node.name}: f={node.rtype.key_shape} b={node.rtype.bound}]"
        if isinstance(node, IAInput):
            extra += f" @{node.placement.describe()}"
    elif isinstance(node, (TraConst, IAConst)):
        extra = (f"[{node.fill}: f={node.rtype.key_shape} "
                 f"b={node.rtype.bound}]")
        if isinstance(node, IAConst):
            extra += f" @{node.placement.describe()}"
    elif isinstance(node, (TraPad, LocalPad)):
        extra = f"(key_shape={list(node.key_shape)})"
    elif isinstance(node, (TraJoin, LocalJoin)):
        extra = f"(L{list(node.join_keys_l)}=R{list(node.join_keys_r)}, " \
                f"{node.kernel.name})"
    elif isinstance(node, (TraAgg, LocalAgg)):
        extra = f"(gb={list(node.group_by)}, {node.kernel.name})"
        if isinstance(node, LocalAgg) and node.partial:
            extra += "[partial]"
    elif isinstance(node, FusedJoinAgg):
        extra = (f"(LocalJoin(L{list(node.join_keys_l)}"
                 f"=R{list(node.join_keys_r)}, {node.join_kernel.name}) → "
                 f"gb={list(node.group_by)}, {node.agg_kernel.name})")
        if node.partial:
            extra += "[partial]"
    elif isinstance(node, Shuf):
        extra = f"(dims={list(node.part_dims)}→{list(node.axes)})"
    elif isinstance(node, (TraTransform,)):
        extra = f"({node.kernel.name})"
    elif isinstance(node, LocalMap):
        kf = "id" if node.key_func is None else node.tag
        extra = f"(key={kf}, array={node.kernel.name})"
    elif isinstance(node, (TraTile, LocalTile)):
        extra = f"(dim={node.tile_dim}, size={node.tile_size})"
    elif isinstance(node, (TraConcat, LocalConcat)):
        extra = f"(key_dim={node.key_dim}, array_dim={node.array_dim})"
    lines = [f"{pad}{label}{extra}"]
    for c in children(node):
        lines.append(describe(c, indent + 1))
    return "\n".join(lines)


# ==========================================================================
# Static type / frontier / mask / placement inference
# ==========================================================================

@dataclasses.dataclass
class TypeInfo:
    rtype: RelType
    mask: Optional[np.ndarray]          # static validity grid (None == full)
    placement: Optional[Placement]      # None for logical nodes

    @property
    def valid_tuples(self) -> int:
        if self.mask is None:
            return self.rtype.ntuples
        return int(self.mask.sum())

    @property
    def valid_floats(self) -> int:
        import math
        return self.valid_tuples * (math.prod(self.rtype.bound)
                                    if self.rtype.bound else 1)


def _join_types(lt: TypeInfo, rt: TypeInfo, jkl, jkr, kernel) -> TypeInfo:
    f_out_l = list(lt.rtype.key_shape)
    for dl, dr in zip(jkl, jkr):
        f_out_l[dl] = min(lt.rtype.key_shape[dl], rt.rtype.key_shape[dr])
    r_nonjoin = [d for d in range(rt.rtype.key_arity) if d not in jkr]
    key_shape = tuple(f_out_l) + tuple(rt.rtype.key_shape[d]
                                       for d in r_nonjoin)
    bound = tuple(kernel.out_bound(lt.rtype.bound, rt.rtype.bound))
    mask = None
    if lt.mask is not None or rt.mask is not None:
        kl = lt.rtype.key_arity
        lm = (lt.mask if lt.mask is not None
              else np.ones(lt.rtype.key_shape, bool))
        lm = lm[tuple(slice(0, f) for f in f_out_l)]
        rm = (rt.mask if rt.mask is not None
              else np.ones(rt.rtype.key_shape, bool))
        rsl = [slice(None)] * rt.rtype.key_arity
        for dl, dr in zip(jkl, jkr):
            rsl[dr] = slice(0, f_out_l[dl])
        rm = rm[tuple(rsl)]
        out_axis = {dr: jkl[i] for i, dr in enumerate(jkr)}
        for i, dr in enumerate(r_nonjoin):
            out_axis[dr] = kl + i
        order = sorted(range(rt.rtype.key_arity), key=lambda d: out_axis[d])
        rm = np.moveaxis(rm, list(range(rt.rtype.key_arity)),
                         [order.index(d) for d in range(rt.rtype.key_arity)])
        covered = sorted(out_axis.values())
        shape = []
        ci = 0
        for ax in range(len(key_shape)):
            if ci < len(covered) and covered[ci] == ax:
                shape.append(rm.shape[ci])
                ci += 1
            else:
                shape.append(1)
        rm = rm.reshape(shape)
        lm = lm.reshape(tuple(f_out_l) + (1,) * (len(key_shape) - kl))
        mask = np.broadcast_to(lm, key_shape) & np.broadcast_to(rm, key_shape)
        if np.all(mask):
            mask = None
    return TypeInfo(RelType(key_shape, bound, lt.rtype.dtype), mask, None)


def _agg_types(ct: TypeInfo, group_by: Tuple[int, ...]) -> TypeInfo:
    ks = tuple(ct.rtype.key_shape[d] for d in group_by)
    mask = None
    if ct.mask is not None:
        k = ct.rtype.key_arity
        perm = list(group_by) + [d for d in range(k) if d not in group_by]
        mt = np.moveaxis(ct.mask, perm, list(range(k)))
        red = tuple(range(len(group_by), k))
        mask = np.any(mt, axis=red) if red else mt
        if np.all(mask):
            mask = None
    return TypeInfo(RelType(ks, ct.rtype.bound, ct.rtype.dtype), mask, None)


def infer(node, env: Optional[Dict[str, TypeInfo]] = None,
          cache: Optional[Dict[int, TypeInfo]] = None) -> TypeInfo:
    """Exact static inference of (type, mask, placement) for any plan node."""
    node = as_node(node)
    env = env or {}
    cache = cache if cache is not None else {}
    if id(node) in cache:
        return cache[id(node)]

    def rec(n):
        return infer(n, env, cache)

    t: TypeInfo
    if isinstance(node, (TraInput, IAInput)):
        placement = node.placement if isinstance(node, IAInput) else None
        t = TypeInfo(node.rtype, None, placement)
    elif isinstance(node, (TraConst, IAConst)):
        placement = node.placement if isinstance(node, IAConst) else None
        t = TypeInfo(node.rtype, None, placement)
    elif isinstance(node, (TraPad, LocalPad)):
        ct = rec(node.child)
        ks = tuple(node.key_shape)
        if len(ks) != ct.rtype.key_arity or \
                any(k < f for k, f in zip(ks, ct.rtype.key_shape)):
            raise ValueError(
                f"pad key_shape {ks} must cover child frontier "
                f"{ct.rtype.key_shape}")
        t = TypeInfo(RelType(ks, ct.rtype.bound, ct.rtype.dtype), None, None)
        if isinstance(node, LocalPad):
            p = ct.placement
            if p is not None and (p.is_replicated
                                  or ks == ct.rtype.key_shape):
                # mask zero-fill is local; frontier growth needs ALL(R)
                t.placement = p
    elif isinstance(node, (TraJoin, LocalJoin)):
        lt, rt = rec(node.left), rec(node.right)
        t = _join_types(lt, rt, node.join_keys_l, node.join_keys_r,
                        node.kernel)
        if isinstance(node, LocalJoin):
            t.placement = _local_join_placement(node, lt, rt)
    elif isinstance(node, (TraAgg, LocalAgg)):
        ct = rec(node.child)
        t = _agg_types(ct, tuple(node.group_by))
        if isinstance(node, LocalAgg):
            t.placement = _agg_placement(ct, node.group_by, node.kernel,
                                         node.partial)
    elif isinstance(node, FusedJoinAgg):
        lt, rt = rec(node.left), rec(node.right)
        jt = _join_types(lt, rt, node.join_keys_l, node.join_keys_r,
                         node.join_kernel)
        jt.placement = _local_join_placement(node, lt, rt)
        t = _agg_types(jt, tuple(node.group_by))
        if jt.placement is not None:
            t.placement = _agg_placement(jt, node.group_by, node.agg_kernel,
                                         node.partial)
    elif isinstance(node, Bcast):
        ct = rec(node.child)
        t = TypeInfo(ct.rtype, ct.mask, Placement.replicated())
    elif isinstance(node, Shuf):
        ct = rec(node.child)
        t = TypeInfo(ct.rtype, ct.mask,
                     Placement.partitioned(node.part_dims, node.axes))
    elif isinstance(node, (TraFilter, LocalFilter)):
        ct = rec(node.child)
        grid = np.indices(ct.rtype.key_shape).reshape(
            ct.rtype.key_arity, -1).T
        keep = np.asarray([bool(node.bool_func(tuple(int(x) for x in kk)))
                           for kk in grid]).reshape(ct.rtype.key_shape)
        mask = keep if ct.mask is None else (ct.mask & keep)
        idx = np.argwhere(mask)
        if len(idx) == 0:
            raise ValueError("filter removes all tuples")
        f_out = tuple(int(m) + 1 for m in idx.max(axis=0))
        mask = mask[tuple(slice(0, f) for f in f_out)]
        t = TypeInfo(RelType(f_out, ct.rtype.bound, ct.rtype.dtype),
                     None if np.all(mask) else mask,
                     ct.placement if isinstance(node, LocalFilter) else None)
    elif isinstance(node, TraReKey):
        ct = rec(node.child)
        t = _rekey_info(ct, node.key_func)
    elif isinstance(node, LocalMap):
        ct = rec(node.child)
        if node.key_func is None:
            bound = tuple(node.kernel.out_bound(ct.rtype.bound))
            t = TypeInfo(RelType(ct.rtype.key_shape, bound, ct.rtype.dtype),
                         ct.mask, ct.placement)
        else:
            t = _rekey_info(ct, node.key_func)
            bound = tuple(node.kernel.out_bound(ct.rtype.bound))
            t.rtype = t.rtype.with_bound(bound)
            # a key rewrite generally destroys the partitioning property —
            # EXCEPT when it is a pure coordinate permutation, in which
            # case the partitioned dims just relabel (beyond-paper
            # optimizer extension; lets e.g. a row-partitioned relation
            # stay local through a key-transpose).
            t.placement = (ct.placement if ct.placement is not None
                           and ct.placement.is_replicated else None)
            if t.placement is None and ct.placement is not None \
                    and ct.placement.kind == "partitioned" \
                    and not ct.placement.has_duplicates \
                    and ct.mask is None:
                perm = _detect_key_permutation(node.key_func,
                                               ct.rtype.key_shape)
                if perm is not None:
                    plist = list(perm)
                    dims = tuple(plist.index(d)
                                 for d in ct.placement.dims)
                    t.placement = Placement.partitioned(
                        dims, ct.placement.axes)
    elif isinstance(node, TraTransform):
        ct = rec(node.child)
        bound = tuple(node.kernel.out_bound(ct.rtype.bound))
        t = TypeInfo(RelType(ct.rtype.key_shape, bound, ct.rtype.dtype),
                     ct.mask, None)
    elif isinstance(node, (TraTile, LocalTile)):
        ct = rec(node.child)
        b = ct.rtype.bound
        ntiles = b[node.tile_dim] // node.tile_size
        nb = b[:node.tile_dim] + (node.tile_size,) + b[node.tile_dim + 1:]
        mask = None
        if ct.mask is not None:
            mask = np.repeat(ct.mask[..., None], ntiles, axis=-1)
        t = TypeInfo(RelType(ct.rtype.key_shape + (ntiles,), nb,
                             ct.rtype.dtype), mask,
                     ct.placement if isinstance(node, LocalTile) else None)
    elif isinstance(node, (TraConcat, LocalConcat)):
        ct = rec(node.child)
        ks = tuple(s for d, s in enumerate(ct.rtype.key_shape)
                   if d != node.key_dim)
        nb = list(ct.rtype.bound)
        nb[node.array_dim] = (ct.rtype.key_shape[node.key_dim]
                              * ct.rtype.bound[node.array_dim])
        mask = None
        if ct.mask is not None:
            mask = np.take(ct.mask, 0, axis=node.key_dim)
            if np.all(mask):
                mask = None
        t = TypeInfo(RelType(ks, tuple(nb), ct.rtype.dtype), mask, None)
        if isinstance(node, LocalConcat):
            t.placement = _local_concat_placement(node, ct)
    else:
        raise TypeError(f"unknown node {type(node)}")

    # attach input env overrides
    if isinstance(node, (TraInput, IAInput)) and node.name in env:
        t = env[node.name]
    cache[id(node)] = t
    return t


def _detect_key_permutation(key_func, key_shape) -> Optional[Tuple[int, ...]]:
    """Return perm with key_func(k)[j] == k[perm[j]] ∀k, else None."""
    import itertools
    k = len(key_shape)
    if k == 0 or k > 4:
        return None
    grid = np.indices(key_shape).reshape(k, -1).T
    if len(grid) > 128:
        grid = grid[:: len(grid) // 128]
    for perm in itertools.permutations(range(k)):
        ok = True
        for kk in grid:
            kt = tuple(int(x) for x in kk)
            out = tuple(key_func(kt))
            if out != tuple(kt[p] for p in perm):
                ok = False
                break
        if ok:
            return perm
    return None


def _rekey_info(ct: TypeInfo, key_func) -> TypeInfo:
    grid = np.indices(ct.rtype.key_shape).reshape(ct.rtype.key_arity, -1).T
    if ct.mask is not None:
        grid = grid[ct.mask.reshape(-1)]
    new_keys = np.asarray([tuple(key_func(tuple(int(x) for x in kk)))
                           for kk in grid], dtype=np.int64)
    if new_keys.ndim == 1:
        new_keys = new_keys[:, None]
    uniq = {tuple(k) for k in new_keys.tolist()}
    if len(uniq) != len(new_keys):
        raise ValueError("rekey violates key uniqueness")
    f_out = tuple(int(m) + 1 for m in new_keys.max(axis=0))
    mask = np.zeros(f_out, bool)
    mask[tuple(new_keys.T)] = True
    if np.all(mask):
        mask = None
    return TypeInfo(RelType(f_out, ct.rtype.bound, ct.rtype.dtype),
                    mask, None)


# --- placement rules (validity of local ops, paper §3) --------------------

def _local_join_placement(node, lt: TypeInfo,
                          rt: TypeInfo) -> Optional[Placement]:
    """Per-mesh-axis validity of a local join.

    For each mesh axis, a side is either *sharded by it* (on one of its key
    dims) or *replicated along it*.  The local join is TRA-equivalent iff for
    every axis one of the following holds:
      * neither side is sharded by it,
      * exactly one side is sharded by it (the other holds full copies), or
      * both sides are sharded by it on *corresponding join dims*
        (co-partitioned).
    This single rule subsumes the paper's broadcast (BMM), cross-product
    (CPMM) and replication/3-D (RMM) matrix-multiply placements.
    """
    lp, rp = lt.placement, rt.placement
    if lp is None or rp is None:
        return None
    if lp.has_duplicates or rp.has_duplicates:
        return None  # joining partial values is not TRA-equivalent
    if lp.is_replicated and rp.is_replicated:
        return Placement.replicated()

    kl = lt.rtype.key_arity
    r_nonjoin = [d for d in range(rt.rtype.key_arity)
                 if d not in node.join_keys_r]

    def out_dim_of_left(d):
        return d

    def out_dim_of_right(d):
        if d in node.join_keys_r:
            return node.join_keys_l[node.join_keys_r.index(d)]
        return kl + r_nonjoin.index(d)

    l_by_axis = {ax: d for d, ax in zip(lp.dims, lp.axes)} \
        if not lp.is_replicated else {}
    r_by_axis = {ax: d for d, ax in zip(rp.dims, rp.axes)} \
        if not rp.is_replicated else {}

    dims_out, axes_out = [], []
    for ax in sorted(set(l_by_axis) | set(r_by_axis)):
        dl, dr = l_by_axis.get(ax), r_by_axis.get(ax)
        if dl is not None and dr is not None:
            # must be a corresponding join pair
            if dl in node.join_keys_l and \
                    node.join_keys_r[node.join_keys_l.index(dl)] == dr:
                dims_out.append(out_dim_of_left(dl))
                axes_out.append(ax)
            else:
                return None  # mismatched sharding on the same axis
        elif dl is not None:
            dims_out.append(out_dim_of_left(dl))
            axes_out.append(ax)
        else:
            dims_out.append(out_dim_of_right(dr))
            axes_out.append(ax)
    if len(set(dims_out)) != len(dims_out):
        return None  # two axes landed on one output dim — unsupported
    return Placement.partitioned(dims_out, axes_out)


def _agg_placement(ct: TypeInfo, group_by: Tuple[int, ...], kernel: Kernel,
                   partial: bool) -> Optional[Placement]:
    """Shared by :class:`LocalAgg` and the agg half of :class:`FusedJoinAgg`
    (``ct`` is then the virtual join result)."""
    p = ct.placement
    if p is None:
        return None
    if p.has_duplicates:
        return None  # must SHUF (reduce-scatter) / BCAST (all-reduce) first
    if p.is_replicated:
        return Placement.replicated()
    if partial:
        # Partial phase of R2-5: surviving group dims keep their axes; axes
        # on reduced dims become pending-duplicate axes.
        dims, axes, dup = [], [], []
        for d, ax in zip(p.dims, p.axes):
            if d in group_by:
                dims.append(group_by.index(d))
                axes.append(ax)
            else:
                dup.append(ax)
        if not dup:
            return None  # nothing partial about it — use partial=False
        return Placement.partitioned(dims, axes, dup_axes=dup,
                                     dup_kernel=kernel.name)
    # full equivalence requires part dims ⊆ groupByKeys (rule R2-4)
    if not set(p.dims) <= set(group_by):
        return None
    dims = [group_by.index(d) for d in p.dims]
    return Placement.partitioned(dims, p.axes)


def _local_concat_placement(node: LocalConcat,
                            ct: TypeInfo) -> Optional[Placement]:
    p = ct.placement
    if p is None:
        return None
    if p.is_replicated:
        return Placement.replicated()
    if node.key_dim in p.dims:
        return None  # would concatenate across sites — invalid locally
    dims = [d - (1 if d > node.key_dim else 0) for d in p.dims]
    return Placement.partitioned(dims, p.axes)


def check_valid(root: IANode) -> TypeInfo:
    """Infer types over a physical plan, raising if any local op's placement
    preconditions are violated (i.e. the plan is not TRA-equivalent)."""
    root = as_node(root)
    cache: Dict[int, TypeInfo] = {}
    info = infer(root, cache=cache)
    for n in postorder(root):
        ti = cache[id(n)]
        if isinstance(n, (LocalJoin, LocalAgg, LocalConcat, FusedJoinAgg,
                          LocalPad)) \
                and ti.placement is None:
            raise ValueError(
                f"invalid physical plan at {type(n).__name__}: "
                f"placement preconditions unsatisfied\n{describe(n)}")
    if info.placement is not None and info.placement.has_duplicates:
        raise ValueError("plan result still holds partial duplicates; "
                         "finish the two-phase aggregation with SHUF/BCAST")
    return info
