"""The SSD backward's route by type and the tensor-core kernels'
arithmetic (``repro_torch.kernels.ssd_scan``), on the CPU.

A CUDA backward sends its state passes and its chunk kernel by the type of
x, B and C: bf16 to ``ssd_scan_bwd_{state,dstate}_kernel_wgmma``
(``csrc/ssd_scan_bwd_state_wgmma.cu``) and
``ssd_scan_bwd_chunk_kernel_wgmma`` (``csrc/ssd_scan_bwd_wgmma.cu``), f32
to the FFMA ``ssd_scan_bwd_{state,dstate,chunk}_kernel``
(``csrc/ssd_scan_bwd.cu``).  Here the route runs against a stub library
that records the calls: which entry points, the partials' parts, the
buffers and the counters.  Plain-torch models of the tensor-core kernels'
rounding (not of their tiling) show why their f32 operands enter
``wgmma`` as three bf16 terms: the chunk kernel's against the plain
backward, the state passes' S_in and G buffers against
``ssd_bwd_states_ref``, both in f64.  The kernels themselves run only on
a card (``tests/test_torch_kernels_gpu.py``, ``chip_smoke.py``).
"""
import contextlib
import functools
import pathlib
import re
from unittest import mock

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.ssd_scan import ops  # noqa: E402
from repro_torch.kernels.ssd_scan.ref import (  # noqa: E402
    ssd_bwd_states_ref, ssd_scan_bwd_ref)
from _torch_helpers import chip_smoke  # noqa: E402

COUNTERS = ("LAUNCHES", "BWD_LAUNCHES", "BWD_STATE_LAUNCHES",
            "BWD_DSTATE_LAUNCHES", "BWD_CHUNK_LAUNCHES",
            "BWD_STATE_TC_LAUNCHES", "BWD_STATE_FFMA_LAUNCHES",
            "BWD_DSTATE_TC_LAUNCHES", "BWD_DSTATE_FFMA_LAUNCHES",
            "BWD_CHUNK_TC_LAUNCHES", "BWD_CHUNK_FFMA_LAUNCHES",
            "BWD_REDUCE_LAUNCHES", "COPIES")


def _counts():
    return {c: getattr(ops, c) for c in COUNTERS}


def _inputs(b, s, h, p, n, dtype, seed=0):
    gen = torch.Generator().manual_seed(seed)
    x, dt, A, bm, cm = chip_smoke().ssd_inputs(b, s, h, p, n, dtype, "cpu",
                                               gen)
    dy = torch.randn(x.shape, generator=gen).to(dtype)
    return x, dt, A, bm, cm, dy


class _StubLib:
    """The kernel library's entry points, each recording its name and
    ``dims`` and returning 0 (launched)."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, entry):
        if not entry.startswith("repro_ssd"):
            raise AttributeError(entry)

        def fn(*args):
            dims = args[2] if entry.startswith("repro_ssd_bwd") else None
            self.calls.append((entry, list(dims) if dims is not None
                               else None))
            return 0
        return fn


@contextlib.contextmanager
def _stubbed(sms=132):
    """The kernel route on CPU tensors: the stub library, no device check,
    ``sms`` SMs, stream 0; the buffers each backward call allocates are
    recorded."""
    lib, bufs = _StubLib(), []
    real = ops._bwd_buffers

    def buffers(x, n, nchunks, parts):
        out = real(x, n, nchunks, parts)
        bufs.append([tuple(t.shape) for t in out])
        return out
    with mock.patch.object(ops, "_lib", lambda: lib), \
            mock.patch.object(ops, "_on_one_card", lambda *a: None), \
            mock.patch.object(ops, "_sms", lambda dev: sms), \
            mock.patch.object(ops, "_stream", lambda dev: 0), \
            mock.patch.object(ops, "_bwd_buffers", buffers), \
            mock.patch.object(ops.torch.cuda, "device",
                              lambda dev: contextlib.nullcontext()):
        yield lib, bufs


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_backward_chunk_kernel_goes_by_dtype(dtype):
    """Under autograd on the kernel route: the forward kernel of the type,
    then the four backward kernels in order with the state passes and the
    chunk kernel of the type — bf16 the tensor-core entry points with
    their counters, f32 the FFMA ones — ``BWD_STATE_LAUNCHES``,
    ``BWD_DSTATE_LAUNCHES`` and ``BWD_CHUNK_LAUNCHES`` counting either
    route; the partials' parts passed in ``dims[7]`` are the blocks' head
    splits (bf16) or the heads (f32)."""
    b, s, h, p, n, chunk = 2, 100, 6, 16, 8, 32
    x, dt, A, bm, cm, dy = _inputs(b, s, h, p, n, dtype)
    tc = dtype == torch.bfloat16
    before = _counts()
    with _stubbed(sms=16) as (lib, _):
        leaves = [t.clone().requires_grad_(True) for t in (x, dt, A, bm, cm)]
        y = ops.ssd_scan(*leaves, chunk=chunk, impl="kernel")
        torch.autograd.grad(y, leaves, dy)
    entries = [e for e, _ in lib.calls]
    own = "_tc" if tc else ""
    assert entries == ["repro_ssd_scan_tc" if tc else "repro_ssd_scan",
                       "repro_ssd_bwd_state" + own,
                       "repro_ssd_bwd_dstate" + own,
                       "repro_ssd_bwd_chunk" + own, "repro_ssd_bwd_reduce"]
    nc = -(-s // chunk)
    parts = ops.plan_splits(b, nc, h, 16) if tc else h
    assert parts == (2 if tc else 6)             # 8 (batch, chunk) blocks
    for _, dims in lib.calls[1:]:
        assert dims == [b, s, h, p, n, chunk, int(tc), parts]
    got = {c: v - before[c] for c, v in _counts().items()}
    assert got == {"LAUNCHES": 5, "BWD_LAUNCHES": 4, "BWD_STATE_LAUNCHES": 1,
                   "BWD_DSTATE_LAUNCHES": 1, "BWD_CHUNK_LAUNCHES": 1,
                   "BWD_STATE_TC_LAUNCHES": int(tc),
                   "BWD_STATE_FFMA_LAUNCHES": int(not tc),
                   "BWD_DSTATE_TC_LAUNCHES": int(tc),
                   "BWD_DSTATE_FFMA_LAUNCHES": int(not tc),
                   "BWD_CHUNK_TC_LAUNCHES": int(tc),
                   "BWD_CHUNK_FFMA_LAUNCHES": int(not tc),
                   "BWD_REDUCE_LAUNCHES": 1, "COPIES": 0}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_each_route_allocates_its_own_partials(dtype):
    """``ssd_scan_bwd`` on the kernel route allocates each chunk's S_in and
    G ``(B, nC, H, N, P)``, the partials of dB and dC — ``(B, S, splits,
    N)`` on the tensor-core route, per head ``(B, S, H, N)`` on the FFMA
    one — and of dA ``(B, nC, H)``, and nothing more; at mamba2-130m's
    train layer (8 × 16 (batch, chunk) blocks on 132 SMs) the bf16
    partials are one part a row, 1/24 of the per-head ones."""
    b, s, h, p, n, chunk = 1, 70, 6, 8, 4, 16
    x, dt, A, bm, cm, dy = _inputs(b, s, h, p, n, dtype, seed=1)
    with _stubbed(sms=10) as (_, bufs):
        ops.ssd_scan_bwd(x, dt, A, bm, cm, dy, chunk=chunk, impl="kernel")
    nc = 5
    parts = ops.plan_splits(b, nc, h, 10) if dtype == torch.bfloat16 else h
    assert parts == (2 if dtype == torch.bfloat16 else 6)
    assert bufs == [[(b, nc, h, n, p), (b, nc, h, n, p), (b, s, parts, n),
                     (b, s, parts, n), (b, nc, h)]]
    mamba2 = ops.plan_splits(8, 16, 24, 132)
    full = ops._bwd_buffers(torch.empty((8, 2048, 24, 64), device="meta"),
                            128, 16, mamba2)
    assert mamba2 == 1 and tuple(full[2].shape) == (8, 2048, 1, 128)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_kernel_backward_on_cpu_raises_and_counts_nothing(dtype):
    """No fallback: ``impl="kernel"`` on CPU tensors raises before any
    launch, cast or buffer, and no counter moves — each route's state
    passes' and chunk kernel's included."""
    x, dt, A, bm, cm, dy = _inputs(1, 40, 2, 16, 8, dtype, seed=2)
    before = _counts()
    with pytest.raises(ValueError, match="CUDA device"):
        ops.ssd_scan_bwd(x, dt, A, bm, cm, dy, chunk=16, impl="kernel")
    leaves = [t.clone().requires_grad_(True) for t in (x, dt, A, bm, cm)]
    with pytest.raises(ValueError, match="CUDA device"):
        ops.ssd_scan(*leaves, chunk=16, impl="kernel")
    assert _counts() == before


@pytest.mark.parametrize("batch,nchunks,heads,sms,want", [
    (8, 16, 24, 132, 1),         # mamba2-130m's train layer: one wave
    (4, 8, 112, 132, 4),         # zamba2-7b's: 128 blocks of 28 heads
    (1, 1, 24, 132, 24),         # one (batch, chunk): a head a block
    (2, 3, 7, 132, 7),
    (1, 2, 5, 2, 1)])
def test_plan_splits_fills_the_card_with_no_empty_block(batch, nchunks,
                                                        heads, sms, want):
    """The fewest splits with the least waves × heads a block, never one
    that leaves a block without a head."""
    got = ops.plan_splits(batch, nchunks, heads, sms)
    assert got == want

    def cost(k):
        return -(-(batch * nchunks * k) // sms) * -(-heads // k)
    valid = [k for k in range(1, heads + 1)
             if -(-heads // -(-heads // k)) == k]
    assert got in valid
    assert cost(got) == min(cost(k) for k in valid)
    assert all(cost(k) > cost(got) for k in valid if k < got)


# ------------------------------ the tensor-core chunk kernel's arithmetic
def _split(t, terms):
    """``t`` (f32) as ``terms`` bf16 terms, hi first (each as f32)."""
    out, rest = [], t
    for _ in range(terms):
        hi = rest.bfloat16().float()
        out.append(hi)
        rest = rest - hi
    return out


def _tc_bwd_arithmetic(x, dt, A, Bm, Cm, dy, chunk, terms):
    """``(dx, dB, dC)`` with ``csrc/ssd_scan_bwd_wgmma.cu``'s rounding in
    plain torch, before the outputs are rounded to bf16: the products of
    the exact bf16 x, dy, B, C summed in f32 (C·Bᵀ, dy·xᵀ); a = cumsum(dt·A)
    in f64 and each decay exp of an f64 difference rounded once; the f32
    operands — W1ᵀ = ((C·Bᵀ)∘D)ᵀ, W2∘dt (the same numbers as dt∘W2ᵀ), the
    state S_in entering each chunk and the cotangent G leaving it, from f32
    state passes — in ``terms`` bf16 terms times the exact operand; dB and
    dC summed over the heads in f32.  Products of bf16 values are exact in
    f32, as on the tensor cores; the order of the f32 sums is torch's, not
    the tensor cores'."""
    b, s, h, p = x.shape
    n = Bm.shape[-1]
    xf, yf, bf, cf, dtf = (t.float() for t in (x, dy, Bm, Cm, dt))
    spans, a_of = [], []
    for s0 in range(0, s, chunk):
        sl = slice(s0, min(s0 + chunk, s))
        spans.append(sl)
        a_of.append(torch.cumsum(dtf[:, sl].double() * A.double(), 1))
    S, sin = torch.zeros((b, h, n, p)), []
    for sl, a in zip(spans, a_of):
        sin.append(S)
        w = torch.exp((a[:, -1:] - a).float()) * dtf[:, sl]
        S = S * torch.exp(a[:, -1].float())[..., None, None] + torch.einsum(
            "bjn,bjhp->bhnp", bf[:, sl], xf[:, sl] * w[..., None])
    G, gs = torch.zeros((b, h, n, p)), [None] * len(spans)
    for k in reversed(range(len(spans))):
        gs[k] = G
        sl, a = spans[k], a_of[k]
        G = G * torch.exp(a[:, -1].float())[..., None, None] + torch.einsum(
            "bin,bihp->bhnp", cf[:, sl], yf[:, sl] * torch.exp(a.float())[
                ..., None])
    dx, dB, dC = torch.empty((b, s, h, p)), torch.empty((b, s, n)), \
        torch.empty((b, s, n))
    for sl, a, s_in, g in zip(spans, a_of, sin, gs):
        xc, yc, bc, cc, dtc = xf[:, sl], yf[:, sl], bf[:, sl], cf[:, sl], \
            dtf[:, sl]
        L = a.shape[1]
        tri = torch.ones((L, L), dtype=torch.bool).tril()[None, :, :, None]
        diff = torch.where(tri, a[:, :, None] - a[:, None], 0.0)
        D = torch.where(tri, torch.exp(diff.float()), 0.0)    # (b, i, j, h)
        cb = torch.einsum("bin,bjn->bij", cc, bc)
        w2 = D * torch.einsum("bihp,bjhp->bijh", yc, xc)
        op = w2 * dtc[:, None]                   # W2_ij·dt_j
        ea, w = torch.exp(a.float()), torch.exp((a[:, -1:] - a).float())
        g_t, s_t = _split(g, terms), _split(s_in, terms)
        dxa = sum(torch.einsum("bijh,bihp->bjhp", t, yc)
                  for t in _split(cb[..., None] * D, terms))
        dxs = sum(torch.einsum("bjn,bhnp->bjhp", bc, t) for t in g_t)
        dx[:, sl] = dtc[..., None] * (dxa + w[..., None] * dxs)
        op_t = _split(op, terms)
        u = sum(torch.einsum("bjhp,bhnp->bjhn", xc, t) for t in g_t)
        dB[:, sl] = sum(torch.einsum("bijh,bin->bjn", t, cc) for t in op_t) \
            + torch.einsum("bjh,bjhn->bjn", dtc * w, u)
        v = sum(torch.einsum("bihp,bhnp->bihn", yc, t) for t in s_t)
        dC[:, sl] = sum(torch.einsum("bijh,bjn->bin", t, bc) for t in op_t) \
            + torch.einsum("bih,bihn->bin", ea, v)
    return dx, dB, dC


def _kernel_terms() -> int:
    src = (pathlib.Path(ops.__file__).parent / "csrc" /
           "ssd_scan_bwd_wgmma.cu").read_text()
    return int(re.search(r"constexpr int TERMS = (\d+);", src).group(1))


@functools.lru_cache(maxsize=2)
def _case(which):
    """The smoke's strong-decay case (dt·A between -22 and -20 every step)
    or its inputs at mamba2-130m's train-layer statistics (H 24, P 64,
    N 128, L 128; S cut to 384, B to 1); the plain backward in f64, and
    its distance in f32 (the floor of an f32 computation) from it for dx,
    dB and dC."""
    if which == "strong-decay":
        x, dt, A, bm, cm, dy = _inputs(2, 256, 4, 64, 128, torch.bfloat16,
                                       seed=3)
        gen = torch.Generator().manual_seed(4)
        dt = 1.0 + 0.1 * torch.rand(dt.shape, generator=gen)
        A = torch.full_like(A, -20.0)
    else:
        x, dt, A, bm, cm, dy = _inputs(1, 384, 24, 64, 128, torch.bfloat16,
                                       seed=5)
    ins = (x, dt, A, bm, cm, dy)
    want = ssd_scan_bwd_ref(*(t.double() for t in ins), 128)
    want = (want[0], want[3], want[4])
    f32 = ssd_scan_bwd_ref(*(t.float() for t in ins), 128)
    floor = [_dist(g, w) for g, w in zip((f32[0], f32[3], f32[4]), want)]
    return ins, want, floor


def _dist(g, w):
    return ((g.double() - w).norm() / w.norm()).item()


@pytest.mark.parametrize("which", ["strong-decay", "mamba2-layer"])
@pytest.mark.parametrize("terms", [1, 2, 3])
def test_three_bf16_terms_keep_the_backward_at_f32_precision(terms, which):
    """Why the tensor-core chunk kernel feeds each f32 operand (the L x L
    matrices, S_in, G) to ``wgmma`` as three bf16 terms.  The model of its
    rounding must lie, before its outputs are rounded to bf16, no further
    from the plain backward in f64 than twice the plain backward in f32
    does (dx, dB and dC: norm of the difference over the norm), so that
    its outputs round to bf16 as an f32 computation's do; and, rounded as
    the kernel and the reduction write them, within ``chip_smoke.py``'s
    bf16 limits of it (``ssd_bwd_errors``: ``SSD_TOL`` of the largest
    |value|, each row within ``SSD_ROW_TOL`` of its norm), at the smoke's
    strong-decay case and at a train-layer-like case.  Three terms lie
    0.1-1x the f32 floor off (6.7e-8 to 2.2e-7); two ~2.5-28x it
    (2.1e-6 to 2.5e-6), though they pass the limits once rounded to bf16
    (the forward's two terms failed its per-layer row gate on the card);
    one ~1e3-2e4x, and under strong decay dB and dC fail the row limit
    (0.38 of a row: a row there is its diagonal term)."""
    assert _kernel_terms() == 3
    smoke = chip_smoke()
    (x, dt, A, bm, cm, dy), want, floor = _case(which)
    got = _tc_bwd_arithmetic(x, dt, A, bm, cm, dy, 128, terms)
    near = [_dist(g, w) <= 2.0 * f for g, w, f in zip(got, want, floor)]
    faults = [smoke.ssd_bwd_errors(g.bfloat16().float(), w, torch.bfloat16,
                                   name)["fault"]
              for name, g, w in zip(("x", "B", "C"), got, want)]
    if terms == 3:
        assert all(near), [_dist(g, w) for g, w in zip(got, want)]
        assert faults == [None] * 3, faults
    else:
        assert not any(near)
    if terms == 1 and which == "strong-decay":
        assert faults[0] is None and None not in faults[1:], faults


# ------------------------------- the tensor-core state passes' arithmetic
def _tc_state_arithmetic(x, dt, A, Bm, Cm, dy, chunk, terms):
    """``(S_in, G)``, ``(B, nC, H, N, P)``, with
    ``csrc/ssd_scan_bwd_state_wgmma.cu``'s rounding in plain torch: a =
    cumsum(dt·A) in f64 from each chunk's start, each coefficient exp of an
    f64 difference rounded once to f32 (times dt_j forward, exp(a_i) in
    reverse); x̃ = coefficient·x (dỹ = coefficient·dy) rounded once to f32
    and taken as ``terms`` bf16 terms (``None``: whole, the FFMA passes'
    f32 arithmetic, the f32 floor); each chunk's product with the exact
    B (C) summed in f32 into a fresh u, then the state exp(a_{L-1})·S + u
    in f32.  Products of bf16 values are exact in f32, as on the tensor
    cores; the order of the f32 sums is torch's."""
    xf, yf, bf, cf, dtf = (t.float() for t in (x, dy, Bm, Cm, dt))
    b, s, h, p = x.shape
    n = Bm.shape[-1]
    spans = [slice(s0, min(s0 + chunk, s)) for s0 in range(0, s, chunk)]
    a_of = [torch.cumsum(dtf[:, sl].double() * A.double(), 1)
            for sl in spans]

    def product(u, v):                       # Σ_j u_j ⊗ v_j over the chunk
        parts = [v] if terms is None else _split(v, terms)
        return sum(torch.einsum("bjn,bjhp->bhnp", u, t) for t in parts)

    S, sin = torch.zeros((b, h, n, p)), []
    for sl, a in zip(spans, a_of):
        sin.append(S)
        coef = torch.exp((a[:, -1:] - a).float()) * dtf[:, sl]
        S = S * torch.exp(a[:, -1].float())[..., None, None] + product(
            bf[:, sl], xf[:, sl] * coef[..., None])
    G, gs = torch.zeros((b, h, n, p)), [None] * len(spans)
    for k in reversed(range(len(spans))):
        gs[k] = G
        sl, a = spans[k], a_of[k]
        G = G * torch.exp(a[:, -1].float())[..., None, None] + product(
            cf[:, sl], yf[:, sl] * torch.exp(a.float())[..., None])
    return torch.stack(sin, 1), torch.stack(gs, 1)


def _state_kernel_terms() -> int:
    src = (pathlib.Path(ops.__file__).parent / "csrc" /
           "ssd_scan_bwd_state_wgmma.cu").read_text()
    return int(re.search(r"constexpr int TERMS = (\d+);", src).group(1))


@functools.lru_cache(maxsize=3)
def _state_case(which):
    """Inputs at mamba2-130m's train-layer widths (H 24, P 64, N 128),
    zamba2-7b's (H 112, P 64, N 64), each cut to one batch row of three
    chunks of 128, or the smoke's strong-decay case (dt·A between -22 and
    -20 every step); ``ssd_bwd_states_ref`` in f64, and the FFMA passes'
    f32 arithmetic's distance from it (the floor) for S_in and G."""
    if which == "strong-decay":
        x, dt, A, bm, cm, dy = _inputs(2, 256, 4, 64, 128, torch.bfloat16,
                                       seed=3)
        gen = torch.Generator().manual_seed(4)
        dt = 1.0 + 0.1 * torch.rand(dt.shape, generator=gen)
        A = torch.full_like(A, -20.0)
    elif which == "mamba2-layer":
        x, dt, A, bm, cm, dy = _inputs(1, 384, 24, 64, 128, torch.bfloat16,
                                       seed=5)
    else:
        x, dt, A, bm, cm, dy = _inputs(1, 384, 112, 64, 64, torch.bfloat16,
                                       seed=6)
    ins = (x, dt, A, bm, cm, dy)
    want = ssd_bwd_states_ref(*(t.double() for t in ins), 128)
    f32 = _tc_state_arithmetic(*ins, 128, None)
    return ins, want, [_dist(g, w) for g, w in zip(f32, want)]


@pytest.mark.parametrize("which", ["mamba2-layer", "zamba2-layer",
                                   "strong-decay"])
@pytest.mark.parametrize("terms", [1, 2, 3])
def test_three_bf16_terms_keep_the_state_passes_at_f32_precision(terms,
                                                                 which):
    """Why the tensor-core state passes feed x̃ and dỹ to ``wgmma`` as three
    bf16 terms.  The model of their rounding must lie no further from
    ``ssd_bwd_states_ref`` in f64 than twice the FFMA passes' f32
    arithmetic does (S_in and G: norm of the difference over the norm), and
    within ``chip_smoke.py``'s limits for the buffers
    (``ssd_bwd_state_buffers``: ``ssd_bwd_errors`` at the f32 limits, 1e-4
    of the largest |value|, each row within 1e-3 of its norm); with fewer
    terms it lies further, and with one term the buffers fail those
    limits."""
    assert _state_kernel_terms() == 3
    smoke = chip_smoke()
    ins, want, floor = _state_case(which)
    got = _tc_state_arithmetic(*ins, 128, terms)
    dist = [_dist(g, w) for g, w in zip(got, want)]
    faults = [smoke.ssd_bwd_errors(g, w, torch.float32, key)["fault"]
              for key, g, w in zip(("S_in", "G"), got, want)]
    if terms == 3:
        assert all(d <= 2.0 * f for d, f in zip(dist, floor)), (dist, floor)
        assert faults == [None, None], faults
    else:
        assert all(d > 2.0 * f for d, f in zip(dist, floor)), (dist, floor)
    if terms == 1:
        assert None not in faults, faults
