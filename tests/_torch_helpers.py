"""Shared helpers of the PyTorch-port parity tests (``test_torch_*.py``).

The same numpy inputs, drawn from a seeded generator, go to the JAX
package and to its port; results come back as numpy for comparison.  The
port runs on the CPU here (``device="cpu"``): its kernels' plain versions.

Importing this module bounds torch to one intra-op thread in the test
process.  The suite runs in several xdist workers at once; each worker's
torch would otherwise start a pool as wide as the machine, and the
oversubscribed cores starve the wall-clock tests of the reference that
share the run.  The port's CPU tests take about as long on one thread.
"""
import functools
import importlib.util
import pathlib

import numpy as np
import torch

torch.set_num_threads(1)

CPU = torch.device("cpu")


def rng(seed=0):
    return np.random.default_rng(seed)


def normal(r, shape):
    return r.standard_normal(shape).astype(np.float32)


def rel_pair(r, key_shape, bound, mask=None):
    """The same random relation as a JAX and a port ``TensorRelation``."""
    import jax.numpy as jnp

    import repro.core as jtra
    import repro_torch.core as ttra
    key_shape, bound = tuple(key_shape), tuple(bound)
    data = normal(r, key_shape + bound)
    j = jtra.TensorRelation(jnp.asarray(data), jtra.RelType(key_shape, bound),
                            mask)
    t = ttra.TensorRelation(torch.from_numpy(data.copy()),
                            ttra.RelType(key_shape, bound), mask)
    return j, t


def as_np(x):
    """numpy float32 value of a JAX/torch array or relation."""
    x = getattr(x, "data", x)
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().float().numpy()
    return np.asarray(x, np.float32)


def assert_rel_close(jrel, trel, tol):
    assert tuple(jrel.rtype.key_shape) == tuple(trel.rtype.key_shape)
    assert tuple(jrel.rtype.bound) == tuple(trel.rtype.bound)
    if jrel.mask is None:
        assert trel.mask is None
    else:
        np.testing.assert_array_equal(jrel.mask, trel.mask)
    np.testing.assert_allclose(as_np(trel), as_np(jrel), rtol=tol, atol=tol)


def scorer_program(mod, b, db, hb, lb, bd, bh, bl):
    """The FFNN scorer's program built with ``mod`` (``repro.core.expr`` or
    ``repro_torch.core.expr``), without any weights."""
    x = mod.input("X", (b, db), (1, bd))
    w1 = mod.input("scorer.W1", (db, hb), (bd, bh))
    w2 = mod.input("scorer.W2", (hb, lb), (bh, bl))
    return ((x @ w1).map("relu") @ w2).map("sigmoid")


def ssd_pair(b, s, h, p, n, dtype="float32", dt_dtype=None, seed=0):
    """The same SSD scan inputs x, dt, A, B, C for JAX and the port, as
    ``(jax arrays, torch tensors)``: x, B, C (and dt, as the JAX tests
    round it) in ``dtype``; dt = softplus(normal), A = -exp(normal) in
    f32."""
    import jax.numpy as jnp
    types = {"float32": (jnp.float32, torch.float32),
             "bfloat16": (jnp.bfloat16, torch.bfloat16)}
    r = rng(seed)
    jdt, tdt = types[dtype]
    ddt = types[dt_dtype or "float32"]
    x, bm, cm = normal(r, (b, s, h, p)), normal(r, (b, s, n)), \
        normal(r, (b, s, n))
    dt = np.logaddexp(normal(r, (b, s, h)), 0.0).astype(np.float32)
    A = -np.exp(normal(r, (h,)))
    js = [jnp.asarray(x, jdt), jnp.asarray(dt, ddt[0]), jnp.asarray(A),
          jnp.asarray(bm, jdt), jnp.asarray(cm, jdt)]
    ts = [torch.tensor(np.asarray(j.astype(jnp.float32))) for j in js]
    ts = [ts[0].to(tdt), ts[1].to(ddt[1]), ts[2], ts[3].to(tdt),
          ts[4].to(tdt)]
    return js, ts


@functools.lru_cache(maxsize=1)
def chip_smoke():
    """``chip_smoke.py`` as a module, for its limits and checks."""
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


#: A step-1 gradient element above this (100 × AdamW's eps of 1e-8) takes
#: the step lr·g/(|g| + eps), which is lr·sign(g) to 1%: f32 rounding of g
#: cannot move it.  At or below it the step turns g's relative rounding
#: into up to a quarter of lr.
G_NEAR_EPS = 1e-6


def assert_master_close(got, want, g, lr, tol, what):
    """Master params after one AdamW step within ``tol`` (relative, and
    absolute of the leaf's largest) wherever the step's gradient ``g``
    has |g| > :data:`G_NEAR_EPS`.  An element outside ``tol`` must have
    |g| ≤ :data:`G_NEAR_EPS` and lie within 2·lr (two steps of at most lr
    each), and the message lists each such element's |g|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    g = np.abs(np.asarray(g, np.float64))
    err = np.abs(got - want)
    off = err > tol * np.abs(want) + tol * max(float(np.abs(want).max()),
                                               1e-30)
    listed = ", ".join(f"|g| {a:.3g} err {e:.3g}"
                       for a, e in zip(g[off][:20], err[off][:20]))
    assert not np.any(off & (g > G_NEAR_EPS)), \
        f"{what}: outside {tol} where |g| > {G_NEAR_EPS}: {listed}"
    assert np.all(err[off] <= 2 * lr), f"{what}: beyond 2·lr: {listed}"
    return int(off.sum())
