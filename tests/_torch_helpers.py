"""Shared helpers of the PyTorch-port parity tests (``test_torch_*.py``).

The same numpy inputs, drawn from a seeded generator, go to the JAX
package and to its port; results come back as numpy for comparison.  The
port runs on the CPU here (``device="cpu"``): its kernels' plain versions.
"""
import numpy as np
import torch

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
