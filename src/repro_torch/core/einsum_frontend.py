"""Einstein-notation frontend for the TRA (paper §2.3).

Port of ``repro.core.einsum_frontend``; the block kernels compute with
``torch.einsum`` and ``Tensor.expand``.  Deviation: the trailing
within-block contraction counts its flops with ``math.prod`` (the JAX
package takes a ``jnp.prod`` of the bound: the same number).

The paper proves TRA ⊇ Einstein notation by construction: every index of a
tensor becomes a key dim (the tensor is chunked so blocks carry the same
index structure), a binary term becomes a join on the shared indices, and
contracted indices are aggregated out with ``matAdd``.  This module is that
construction, executable.

:func:`build_einsum` is the construction itself, over arbitrary logical
child nodes — it is what :func:`repro_torch.core.expr.einsum` (the ``Expr``
frontend) calls, so Einstein-notation expressions flow through the same
builder and optimizer entry path as the fluent API:

    C = tra.einsum("ij,jk->ik", A, B)          # A, B are Exprs

:func:`einsum_tra` is the spec-dict form; it wraps each
:class:`OperandSpec` in a fresh ``TraInput`` and delegates.
Chained/multi-operand expressions reduce left-to-right (each step is one
join+aggregate), matching the grammar's binary production rule.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Sequence, Tuple

import torch

from repro_torch.core.kernels_registry import JoinVjp, Kernel, get_kernel
from repro_torch.core.plan import (TraAgg, TraInput, TraJoin, TraNode,
                                   TraReKey, TraTransform)
from repro_torch.core.tra import RelType


@dataclasses.dataclass(frozen=True)
class OperandSpec:
    """A tensor operand: per-index block counts and block sizes."""

    name: str
    indices: str                 # e.g. "ij"
    blocks: Tuple[int, ...]      # key frontier per index
    block_sizes: Tuple[int, ...] # array bound per index

    @property
    def rtype(self) -> RelType:
        return RelType(self.blocks, self.block_sizes, torch.float32)


def _pairwise_einsum_kernel(idx_l: str, idx_r: str, idx_out: str,
                            bl: Sequence[int], br: Sequence[int],
                            derivative: bool = False) -> Kernel:
    """Blockwise kernel for one binary contraction (the join's projOp).

    Unless building a ``derivative`` kernel, the kernel carries its own
    VJP pair — the classic einsum index swap: for ``out = Σ l,r → o`` the
    operand cotangents are ``dL = Σ o,r → l`` and ``dR = Σ o,l → r``
    (every ``idx_l`` letter appears in ``idx_out ∪ idx_r`` because the
    §2.3 construction only contracts *shared* indices, so the swapped
    specs are always well-formed).  :mod:`repro_torch.core.autodiff` emits
    the surrounding join+aggregation — the backward of an einsum
    expression is itself an einsum-shaped TRA plan."""
    spec = f"...{idx_l},...{idx_r}->...{idx_out}"
    size = dict(zip(idx_l, bl))
    size.update(zip(idx_r, br))
    out_bound = tuple(size[i] for i in idx_out)
    flops = 2
    for i in set(idx_l) | set(idx_r):
        flops *= size[i]

    vjp = None
    if not derivative:
        bo = [size[i] for i in idx_out]
        vjp = (
            JoinVjp(_pairwise_einsum_kernel(idx_out, idx_r, idx_l,
                                            bo, br, derivative=True)),
            JoinVjp(_pairwise_einsum_kernel(idx_out, idx_l, idx_r,
                                            bo, bl, derivative=True)),
        )

    return Kernel(
        name=f"einsum[{idx_l},{idx_r}->{idx_out}]",
        arity=2,
        apply=lambda a, b: torch.einsum(spec, a, b),
        out_bound=lambda _bl, _br: out_bound,
        flops=lambda _bl, _br: flops,
        vjp=vjp,
    )


def _expand_kernel(src_idx: str, dst_idx: str,
                   dst_sizes: Sequence[int]) -> Kernel:
    """Broadcast blocks from ``src_idx`` order back to ``dst_idx`` shape —
    the VJP image of a within-block trailing contraction (``dst → src``).
    Missing indices regrow by broadcasting the cotangent."""
    dst_sizes = tuple(dst_sizes)
    src_in_dst = [i for i in dst_idx if i in src_idx]
    perm = [src_idx.index(i) for i in src_in_dst]
    missing = [ax for ax, i in enumerate(dst_idx) if i not in src_idx]

    def _apply(a: torch.Tensor) -> torch.Tensor:
        lead = a.dim() - len(src_idx)
        a = a.permute(list(range(lead)) + [lead + p for p in perm])
        for ax in missing:
            a = a.unsqueeze(lead + ax)
        return a.expand(tuple(a.shape[:lead]) + dst_sizes)

    return Kernel(
        name=f"einsumExpand[{src_idx}->{dst_idx}]", arity=1,
        apply=_apply,
        out_bound=lambda b: dst_sizes,
        flops=lambda b: 0,
    )


def _block_permute_kernel(src_idx: str, dst_idx: str) -> Kernel:
    """Pure within-block axis permutation ``src_idx → dst_idx`` (its own
    VJP is the inverse permutation)."""
    inv = tuple(src_idx.index(i) for i in dst_idx)
    return Kernel(
        name=f"einsum[{src_idx}->{dst_idx}]", arity=1,
        apply=lambda a, s=f"...{src_idx}->...{dst_idx}": torch.einsum(s, a),
        out_bound=lambda b, p=inv: tuple(b[i] for i in p),
        flops=lambda b: 0,
        vjp=lambda x, y, g, si=src_idx, di=dst_idx:
            g.map(_block_permute_kernel(di, si)),
    )


def parse_spec(spec: str) -> Tuple[List[str], str]:
    lhs, rhs = spec.replace(" ", "").split("->")
    return lhs.split(","), rhs


def build_einsum(terms: Sequence[str], out_idx: str,
                 nodes: Sequence[TraNode],
                 sizes_list: Sequence[Sequence[int]]) -> TraNode:
    """The §2.3 construction over existing logical children.

    ``nodes[i]`` is the logical plan for lhs term ``terms[i]``;
    ``sizes_list[i]`` its bound (one entry per index letter) — key
    frontiers are carried by the nodes themselves.  Returns the plan
    computing the einsum with output keys in rhs order.
    """
    if len(nodes) < 1:
        raise ValueError("need at least one operand")
    cur: TraNode = nodes[0]
    cur_idx = terms[0]
    cur_sizes = dict(zip(terms[0], sizes_list[0]))

    for k in range(1, len(nodes)):
        rhs_remaining = set("".join(terms[k + 1:])) | set(out_idx)
        nxt = nodes[k]
        shared = [i for i in cur_idx if i in terms[k]]
        jkl = tuple(cur_idx.index(i) for i in shared)
        jkr = tuple(terms[k].index(i) for i in shared)
        # post-join key order: cur indices ++ (next indices minus joined)
        post_idx = cur_idx + "".join(i for i in terms[k] if i not in shared)
        contract = [i for i in shared if i not in rhs_remaining]
        # the block kernel contracts WITHIN blocks; the agg below contracts
        # ACROSS blocks.  kernel output = all non-contracted indices.
        kept_idx = "".join(i for i in post_idx if i not in contract)
        kern = _pairwise_einsum_kernel(
            cur_idx, terms[k], kept_idx,
            [cur_sizes[i] for i in cur_idx], list(sizes_list[k]))
        joined = TraJoin(cur, nxt, jkl, jkr, kern)
        if contract:
            gb = tuple(post_idx.index(i) for i in kept_idx)
            cur = TraAgg(joined, gb, get_kernel("matAdd"))
            cur_idx = kept_idx
        else:
            cur = joined
            cur_idx = post_idx
        cur_sizes.update(zip(terms[k], sizes_list[k]))

    if cur_idx != out_idx:
        if sorted(cur_idx) != sorted(out_idx):
            # trailing contraction of indices absent from the output:
            # contract within blocks (transform) then across blocks (agg)
            keep = "".join(i for i in cur_idx if i in out_idx)
            cur_bound = tuple(cur_sizes[i] for i in cur_idx)
            inner = Kernel(
                name=f"einsum[{cur_idx}->{keep}]", arity=1,
                apply=lambda a, s=f"...{cur_idx}->...{keep}":
                    torch.einsum(s, a),
                out_bound=lambda b, ci=cur_idx, kp=keep:
                    tuple(b[ci.index(i)] for i in kp),
                flops=lambda b: math.prod(b),
                # d(within-block sum)/dX broadcasts the cotangent back
                # over the summed-out block axes
                vjp=lambda x, y, g, kp=keep, ci=cur_idx, cb=cur_bound:
                    g.map(_expand_kernel(kp, ci, cb)),
            )
            cur = TraTransform(cur, inner)
            gb = tuple(cur_idx.index(i) for i in keep)
            cur = TraAgg(cur, gb, get_kernel("matAdd"))
            cur_idx = keep
        if cur_idx != out_idx:
            # permute both the block grid (rekey) and the block interiors
            # (transform) to the rhs order
            inv = tuple(cur_idx.index(i) for i in out_idx)
            cur = TraTransform(cur, _block_permute_kernel(cur_idx, out_idx))
            cur = TraReKey(cur, lambda key, p=inv: tuple(key[i] for i in p),
                           tag=f"permute{inv}")
    return cur


def einsum_tra(spec: str, operands) -> TraNode:
    """Build the logical TRA plan for an einsum over chunked tensors.

    ``operands`` is either a list of :class:`OperandSpec` (one per lhs term,
    in order) or a dict keyed by index string (only when terms are unique).
    Returns a plan whose inputs are named by the operand names and whose
    output keys follow the rhs index order.
    """
    terms, out_idx = parse_spec(spec)
    if len(terms) < 1:
        raise ValueError("need at least one operand")
    if isinstance(operands, dict):
        if len(set(terms)) != len(terms):
            raise ValueError("duplicate index terms: pass operands as a list")
        specs = [operands[t] for t in terms]
    else:
        specs = list(operands)
    if len(specs) != len(terms):
        raise ValueError("operand count mismatch")
    return build_einsum(
        terms, out_idx,
        [TraInput(s.name, s.rtype) for s in specs],
        [s.block_sizes for s in specs])
