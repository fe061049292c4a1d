"""The flash-attention backward's dQ route and the tensor-core dQ kernel's
arithmetic (``repro_torch.kernels.flash_attention``), on the CPU.

A CUDA backward sends dQ by type and head dim (``ops.bwd_route``): bf16
whose padded head dim is at most 128 to ``flash_attention_bwd_dq_kernel_
wgmma`` (``csrc/flash_attention_bwd_wgmma.cu``), f32 and bf16 at 192 or
256 columns to the FFMA ``flash_attention_bwd_dq_kernel``; dK and dV
always come from the FFMA dK/dV kernel.  Here the route runs against a
stub library that records the calls: which entry points, their
arguments, the tensor maps of q, k, v and dO, and the counters.
``attention_bwd_stats_ref`` (the plain LSE and D) is held to their f64
definition, and a plain-torch model of the kernel's rounding (bf16
operands, f32 S, dP and statistics, dS in bf16 terms, f32 accumulation,
bf16 dQ) shows why dS enters ``wgmma`` as two bf16 terms.  The kernels
themselves run only on a card (``tests/test_torch_kernels_gpu.py``,
``chip_smoke.py``).
"""
import contextlib
import pathlib
import re
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.flash_attention import ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    _masked_scores, attention_bwd_ref, attention_bwd_stats_ref)
from _torch_helpers import chip_smoke  # noqa: E402

BF16, F32 = torch.bfloat16, torch.float32
COUNTERS = ("LAUNCHES", "BWD_DQ_LAUNCHES", "BWD_DQ_TC_LAUNCHES",
            "BWD_DQ_FFMA_LAUNCHES", "BWD_DKDV_LAUNCHES", "TC_LAUNCHES",
            "FFMA_LAUNCHES", "COPIES")
CSRC = pathlib.Path(ops.__file__).resolve().parent / "csrc"


def _counts():
    return {c: getattr(ops, c) for c in COUNTERS}


def _inputs(b, hq, hkv, sq, skv, d, dv, dtype, seed=0):
    """q, k, v, dO drawn from N(0, 1) with numpy, in ``dtype``."""
    r = np.random.default_rng(seed)
    return tuple(torch.tensor(r.standard_normal(s), dtype=F32).to(dtype)
                 for s in ((b, hq, sq, d), (b, hkv, skv, d),
                           (b, hkv, skv, dv), (b, hq, sq, dv)))


def _model_view(b, h, s, d, dtype=BF16):
    """A ``(B, H, S, D)`` view of a ``(B, S, H·D)`` buffer: the layout of
    the gradient the model's ``transpose(1, 2).reshape`` hands back."""
    return torch.randn(b, s, h * d).to(dtype).view(b, s, h, d).transpose(1, 2)


# ------------------------------------------------------------------ route
@pytest.mark.parametrize("dtype,d,dv,on_cpu,impl,want", [
    (BF16, 112, 112, True, "auto", "plain"),       # the CPU
    (F32, 64, 64, True, "auto", "plain"),
    (BF16, 112, 112, False, "plain", "plain"),     # impl
    (BF16, 112, 112, True, "kernel", "tc"),
    (F32, 64, 64, False, "auto", "ffma"),          # f32 at any head dim
    (F32, 128, 128, False, "kernel", "ffma"),
    (BF16, 64, 64, False, "auto", "tc"),           # bf16 by padded head dim
    (BF16, 112, 112, False, "auto", "tc"),
    (BF16, 128, 128, False, "auto", "tc"),
    (BF16, 129, 129, False, "auto", "ffma"),
    (BF16, 256, 256, False, "auto", "ffma"),
    (BF16, 64, 40, False, "auto", "tc"),           # dv != d
    (BF16, 40, 128, False, "auto", "tc"),
    (BF16, 112, 130, False, "auto", "ffma"),
    (BF16, 192, 64, False, "auto", "ffma")])
def test_bwd_route(dtype, d, dv, on_cpu, impl, want):
    """Tensors on the CPU or not (``meta``: no card needed to see the
    route a CUDA call takes)."""
    dev = "cpu" if on_cpu else "meta"
    q, k, v = (torch.empty(1, 2, 8, n, dtype=dtype, device=dev)
               for n in (d, d, dv))
    assert ops.bwd_route(q, k, v, impl) == want


class _StubLib:
    """The flash library's backward entry points, each recording its name
    and arguments and returning 0 (launched)."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, entry):
        if not entry.startswith("repro_flash"):
            raise AttributeError(entry)

        def fn(*args):
            self.calls.append((entry, args))
            return 0
        return fn


@contextlib.contextmanager
def _stubbed():
    """The kernel route on CPU tensors: the stub library, no device check,
    stream 0."""
    lib = _StubLib()
    with mock.patch.object(ops, "_lib", lambda: lib), \
            mock.patch.object(ops, "_on_one_card", lambda *a: None), \
            mock.patch.object(ops, "_stream", lambda dev: 0), \
            mock.patch.object(ops.torch.cuda, "device",
                              lambda dev: contextlib.nullcontext()):
        yield lib


@pytest.mark.parametrize("dtype,d,dv", [(BF16, 112, 112), (BF16, 64, 40),
                                        (BF16, 256, 256), (F32, 112, 112),
                                        (F32, 64, 64)])
def test_attention_bwd_launches_the_routed_dq_kernel_then_dkdv(dtype, d, dv):
    """One launch of the routed dQ kernel, counted in ``BWD_DQ_LAUNCHES``
    and in its own counter, then one of the dK/dV kernel with the FFMA
    entries' arguments; no forward launch, no copy."""
    q, k, v, do = _inputs(2, 4, 2, 70, 70, d, dv, dtype)
    tc = ops.bwd_route(q, k, v, impl="kernel") == "tc"
    before = _counts()
    with _stubbed() as lib:
        ops.attention_bwd(q, k, v, do, impl="kernel")
    entries = [e for e, _ in lib.calls]
    assert entries == ["repro_flash_attention_bwd_dq" + ("_tc" if tc else ""),
                       "repro_flash_attention_bwd_dkdv"]
    got = {c: n - before[c] for c, n in _counts().items()}
    assert got == {"LAUNCHES": 2, "BWD_DQ_LAUNCHES": 1,
                   "BWD_DQ_TC_LAUNCHES": int(tc),
                   "BWD_DQ_FFMA_LAUNCHES": int(not tc),
                   "BWD_DKDV_LAUNCHES": 1, "TC_LAUNCHES": 0,
                   "FFMA_LAUNCHES": 0, "COPIES": 0}
    dkdv = lib.calls[1][1]
    assert dkdv[:4] == tuple(t.data_ptr() for t in (q, k, v, do))
    assert dkdv[10:17] == (2, 4, 2, 70, 70, d, dv)


def test_tc_dq_arguments():
    """The tensor-core entry takes q, k, v, dO by pointer and tensor map
    (q and dO tiled 128 rows, k and v 64), dq by strides, the statistics
    the dK/dV kernel reads, and the padded head dim 128 at zamba2's 112;
    ``window`` clipped as the FFMA kernels get it."""
    q, k, v, do = _inputs(1, 4, 2, 90, 100, 112, 96, BF16)
    with _stubbed() as lib:
        dq, _, _ = ops.attention_bwd(q, k, v, do, impl="kernel", causal=True,
                                     window=500, softcap=30.0)
    (_, tc), (_, ffma) = lib.calls
    assert tc[:4] == tuple(t.data_ptr() for t in (q, k, v, do))
    specs = [m._obj for m in tc[4:8]]
    for spec, t, rows in zip(specs, (q, k, v, do), (128, 64, 64, 128)):
        want = ops.tma_map(t.shape, t.stride(), t.data_ptr(), rows)
        assert tuple(spec.dims) == want.dims and tuple(spec.box) == want.box
        assert spec.perm == want.perm
    assert tc[8] == dq.data_ptr() and tuple(tc[9]) == dq.stride()
    assert (tc[10], tc[11]) == (ffma[7], ffma[8])        # lse, delta
    assert tc[12:22] == (1, 4, 2, 90, 100, 112, 96, 128, 1, 190)
    assert tc[22] == 30.0 and tc[23] == pytest.approx(112 ** -0.5)
    assert dq.shape == q.shape and dq.dtype == BF16


def test_do_map_reads_the_models_view_in_place():
    """The model's transposed dO (and q, k, v) views have tensor maps: the
    kernel reads them where they lie, and nothing is copied."""
    b, h, s, d = 2, 4, 96, 112
    q, k, v, do = (_model_view(b, h, s, d) for _ in range(4))
    assert ops.tma_map(do.shape, do.stride(), do.data_ptr(), 128) is not None
    before = ops.COPIES
    with _stubbed() as lib:
        ops.attention_bwd(q, k, v, do, impl="kernel")
    assert ops.COPIES == before
    assert lib.calls[0][1][:4] == tuple(t.data_ptr() for t in (q, k, v, do))


def test_do_layout_tma_cannot_read_is_copied_once():
    """A dO whose rows are 113 bf16 apart (226 bytes, off TMA's 16) is
    copied once into a padded buffer, counted in ``COPIES``, and the copy
    holds dO's values; the dK/dV kernel reads dO as it is."""
    q, k, v, _ = _inputs(1, 2, 2, 40, 40, 112, 112, BF16)
    do = torch.randn(1, 2, 40, 113).to(BF16)[..., :112]
    assert ops.tma_map(do.shape, do.stride(), do.data_ptr(), 128) is None
    before = ops.COPIES
    seen = {}
    real = ops.tma_copy

    def copy(t):
        seen[t.data_ptr()] = out = real(t)
        return out
    with _stubbed() as lib, mock.patch.object(ops, "tma_copy", copy):
        ops.attention_bwd(q, k, v, do, impl="kernel")
    assert ops.COPIES == before + 1 and list(seen) == [do.data_ptr()]
    (_, tc), (_, ffma) = lib.calls
    copied = seen[do.data_ptr()]
    assert tc[3] == copied.data_ptr() != do.data_ptr()
    assert torch.equal(copied, do) and ffma[3] == do.data_ptr()


def test_autograd_backward_routes_dq_by_shape():
    """Under autograd on the kernel route the backward picks its dQ kernel
    by ``bwd_route``: bf16 at head dim 112 the tensor-core one, at 256 the
    FFMA one (the forward launch replaced by the plain attention)."""
    seen = []

    def launch(q, k, v, causal, window, softcap, scale, kernel):
        from repro_torch.kernels.flash_attention.ref import attention_ref
        return attention_ref(q, k, v, causal=causal, window=window,
                             softcap=softcap, scale=scale)

    def launch_bwd(q, k, v, do, causal, window, softcap, scale, dq_kernel):
        seen.append(dq_kernel)
        return tuple(torch.zeros_like(t) for t in (q, k, v))
    with mock.patch.object(ops, "_launch", launch), \
            mock.patch.object(ops, "_launch_bwd", launch_bwd):
        for d in (112, 256):
            q, k, v, do = _inputs(1, 2, 2, 16, 16, d, d, BF16)
            leaves = [t.requires_grad_(True) for t in (q, k, v)]
            out = ops.attention(*leaves, impl="kernel")
            torch.autograd.grad(out, leaves, do)
    assert seen == ["tc", "ffma"]


def test_kernel_source_matches_the_route():
    """The kernel takes at most the padded head dim the route sends it."""
    src = (CSRC / "flash_attention_bwd_wgmma.cu").read_text()
    assert int(re.search(r"constexpr int MAX_DP = (\d+);", src)[1]) == \
        ops.BWD_TC_MAX_DIM


# -------------------------------------------------- the plain statistics
def _stats_f64(q, k, v, do, causal, window, softcap, scale):
    """LSE and D by their definition in f64, one row at a time."""
    q, k, v, do = (t.double() for t in (q, k, v, do))
    b, hq, sq, _ = q.shape
    group, skv = hq // k.shape[1], k.shape[2]
    lse = torch.full((b, hq, sq), float("inf"), dtype=torch.float64)
    delta = torch.zeros((b, hq, sq), dtype=torch.float64)
    for h in range(hq):
        kh, vh = k[:, h // group], v[:, h // group]
        for i in range(sq):
            pos = i + skv - sq
            cols = [j for j in range(skv) if (not causal or pos >= j)
                    and (window <= 0 or pos - j < window)]
            if not cols:
                continue
            s = torch.einsum("bd,bkd->bk", q[:, h, i], kh[:, cols]) * scale
            if softcap > 0:
                s = softcap * torch.tanh(s / softcap)
            m = torch.logsumexp(s, dim=-1)
            p = torch.exp(s - m[:, None])
            dp = torch.einsum("bd,bkd->bk", do[:, h, i], vh[:, cols])
            lse[:, h, i] = m
            delta[:, h, i] = (p * dp).sum(-1)
    return lse, delta


@pytest.mark.parametrize("b,hq,hkv,sq,skv,d,dv,causal,window,softcap", [
    (2, 4, 4, 40, 40, 16, 16, True, 0, 0.0),
    (1, 4, 2, 33, 33, 16, 8, True, 7, 0.0),
    (1, 2, 1, 30, 30, 8, 8, True, 0, 5.0),
    (1, 2, 2, 24, 40, 8, 8, False, 0, 0.0),
    (1, 2, 2, 40, 20, 8, 12, True, 0, 0.0)])     # rows with no key
def test_stats_ref_matches_its_definition(b, hq, hkv, sq, skv, d, dv, causal,
                                          window, softcap):
    """``attention_bwd_stats_ref`` (f32) against LSE and D computed by
    their definition in f64: within 1e-5 of each value's scale; +inf and
    0 for a row with no unmasked key."""
    q, k, v, do = _inputs(b, hq, hkv, sq, skv, d, dv, F32, seed=3)
    kw = dict(causal=causal, window=window, softcap=softcap)
    lse, delta = attention_bwd_stats_ref(q, k, v, do, **kw)
    want_lse, want_delta = _stats_f64(q, k, v, do, scale=d ** -0.5, **kw)
    assert lse.dtype == delta.dtype == F32 and lse.shape == (b, hq, sq)
    seen = torch.isfinite(want_lse)
    assert torch.equal(torch.isfinite(lse), seen)
    assert bool((lse[~seen] == float("inf")).all())
    assert bool((delta[~seen] == 0).all())
    np.testing.assert_allclose(lse[seen].numpy(), want_lse[seen].numpy(),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(delta.numpy(), want_delta.numpy(), rtol=1e-5,
                               atol=1e-5 * float(want_delta.abs().max()))


# --------------------------------- the tensor-core dQ kernel's arithmetic
def model_dq(q, k, v, do, terms: int, causal=True, window=0, softcap=0.0):
    """dQ as the tensor-core kernel rounds it: bf16 q, k, v, dO; S, dP,
    LSE and D in f32 (``attention_bwd_stats_ref``); dS in f32, entering
    the product as ``terms`` bf16 terms (hi first, each rounding what the
    ones before left), the smallest term's product first, summed in f32;
    dQ rounded to bf16.  The tiling and wgmma's own summation order are
    not modelled."""
    scale = q.shape[3] ** -0.5
    group = q.shape[1] // k.shape[1]
    kf = k.repeat_interleave(group, dim=1).float()
    vf = v.repeat_interleave(group, dim=1).float()
    lse, delta = attention_bwd_stats_ref(q, k, v, do, causal=causal,
                                         window=window, softcap=softcap,
                                         scale=scale)
    s = _masked_scores(q, kf, 0, q.shape[2], causal, window, softcap, scale)
    p = torch.exp(s - lse[..., None])
    dp = torch.einsum("bhqd,bhkd->bhqk", do.float(), vf)
    cap = 1 - (s / softcap) ** 2 if softcap > 0 else 1.0
    ds = torch.where(p > 0, p * (dp - delta[..., None]) * cap * scale,
                     torch.zeros_like(p))
    parts, rest = [], ds
    for _ in range(terms):
        hi = rest.bfloat16().float()
        parts.append(hi)
        rest = rest - hi
    acc = torch.zeros(q.shape[:3] + (k.shape[3],))
    for part in reversed(parts):
        acc = acc + torch.einsum("bhqk,bhkd->bhqd", part, kf)
    return acc.bfloat16()


def dq_shares(case, terms: int, seed: int = 0) -> tuple:
    """The model's dq against ``attention_bwd_ref`` through
    ``chip_smoke.flash_errors``' bf16 limits (dq rows of queries that see
    one key held elementwise only, as ``bwd_case`` holds them): the
    largest share of the elementwise limit, the largest share of the row
    limit, and the fault (None: within both)."""
    b, hq, hkv, sq, skv, d, dv, causal, window, softcap = case
    q, k, v, do = _inputs(b, hq, hkv, sq, skv, d, dv, BF16, seed)
    kw = dict(causal=causal, window=window, softcap=softcap)
    want = attention_bwd_ref(q, k, v, do, **kw)[0].float()
    got = model_dq(q, k, v, do, terms, **kw).float()
    smoke = chip_smoke()
    seen = torch.from_numpy(smoke.visible_keys(sq, skv, causal, window) > 1)
    errs = smoke.flash_errors(got, want, BF16, rows=seen)
    tol = smoke.FLASH_TOL[BF16]
    elem = float(((got - want).abs() / (tol + tol * want.abs())).max())
    return elem, errs["max_row_rel_err"] / smoke.ROW_REL_TOL[BF16], \
        errs["fault"]


#: the bf16 cases of the card tests and the smoke that take the kernel
#: (padded head dim <= 128), and zamba2-7b's layer cut to 4 heads:
#: (b, hq, hkv, sq, skv, d, dv, causal, window, softcap)
TC_CASES = [
    (2, 4, 4, 256, 256, 64, 64, True, 0, 0.0),
    (2, 8, 2, 256, 256, 64, 64, True, 64, 0.0),
    (2, 4, 4, 256, 256, 64, 64, True, 0, 30.0),
    (2, 4, 4, 256, 256, 64, 64, False, 0, 0.0),
    (2, 4, 2, 200, 200, 64, 64, True, 0, 0.0),
    (1, 2, 1, 1000, 1000, 64, 64, True, 100, 30.0),
    (2, 4, 4, 100, 300, 64, 64, True, 0, 0.0),
    (2, 4, 2, 77, 77, 64, 40, True, 0, 0.0),
    (2, 2, 2, 70, 70, 112, 112, True, 0, 0.0),
    (1, 4, 4, 1024, 1024, 112, 112, True, 0, 0.0)]


@pytest.mark.parametrize("case", TC_CASES,
                         ids=[f"b{c[0]}h{c[1]}/{c[2]}s{c[3]}/{c[4]}d{c[5]}/"
                              f"{c[6]}{'c' if c[7] else 'n'}w{c[8]}"
                              f"cap{c[9]:g}" for c in TC_CASES])
def test_two_ds_terms_pass_the_smokes_limits_with_room(case):
    """dS in the kernel's two bf16 terms keeps the model's dq within half
    of each of the smoke's bf16 limits (``FLASH_TOL`` elementwise,
    ``ROW_REL_TOL`` a row) against the plain backward."""
    elem, row, fault = dq_shares(case, 2)
    assert fault is None
    assert elem <= 0.5 and row <= 0.5, (elem, row)


def test_one_ds_term_leaves_a_row_past_half_the_limit():
    """Witness for the second term: with dS rounded once to bf16, a row of
    dq whose query sees two keys (their dS cancel) lands past half the row
    limit on every seed, while two terms stay within it."""
    case = (2, 4, 4, 256, 256, 64, 64, True, 2, 0.0)
    for seed in range(3):
        _, one, fault = dq_shares(case, 1, seed)
        _, two, _ = dq_shares(case, 2, seed)
        assert fault is None and one > 0.5 and two <= 0.5, (seed, one, two)
