"""Port parity: the model zoo's train stack on one device
(``repro_torch.models.loss_fn``, ``repro_torch.runtime``,
``repro_torch.launch.train``).

* ``loss_fn`` and its gradients against ``jax.value_and_grad`` of
  ``repro.models.loss_fn`` for the smoke configs of gemma2-2b, qwen2.5-14b,
  mamba2-130m and zamba2-7b, the JAX weights carried over by
  ``weights.model_from_numpy`` and the same numpy batch on both sides: in
  an f32 copy of each config within 1e-4 (relative, and absolute of the
  leaf's largest gradient), the reference's train-step limit
  (``tests/test_kernels.py:31``, CHANGES PR 4); in bf16 the loss within
  the bf16 limit of ``tests/test_kernels.py`` (5e-2) and each gradient
  leaf within 5e-2 of the exact gradient in norm, or within twice JAX's
  own bf16 distance where that is larger (and, for the SSD inputs' leaves,
  twice the larger of the two: :data:`SSD_LEAVES`);
* ``DenseLM.unembed``'s gradients against ``jax.grad`` of
  ``repro.models.model.unembed`` (f32 at 1e-5; bf16 within one bf16
  rounding: 2^-7 of the element);
* one ``make_train_step`` from the same state (``opt_state_from_numpy``)
  and batch at gemma2-smoke, mamba2-smoke and zamba2-smoke width, master
  params (zamba2's where the gradient is not near AdamW's eps), moments
  and metrics within 1e-4, with and without a microbatch dim;
* the bf16 gradient's rounding floor under a change of the SSD chunk, at
  mamba2-130m's full width and 8 layers, in JAX and in the port alike;
* ``tests/test_runtime.py``'s trainer tests (loss decreases, a restart
  reproduces the uninterrupted run bit for bit, a cold restart from disk,
  the straggler monitor, ``bubble_fraction``) and
  ``tests/test_arch_smoke.py::test_train_step_no_nans`` for every ported
  arch, on the port alone (CPU).

JAX's work here is jitted and runs at the smoke widths.

The optimizer substrate and the batches (``repro_torch.optim``,
``repro_torch.data``) against ``repro.optim`` and ``repro.data``:
schedules, clipping, the decay mask and AdamW within f32 1e-5 (relative
and absolute), bf16 compression and the batches bit for bit.  The
gradient of flash attention on the CPU: autograd through the plain
route, ``attention_bwd``'s CPU route and its plain version
``attention_bwd_ref`` against ``jax.grad`` of
``repro.kernels.flash_attention.ref.attention_ref`` (f32, 1e-5 of the
largest gradient).  The backward kernels themselves run only on the card
(``tests/test_torch_kernels_gpu.py``, ``chip_smoke.py``).

One file, so that xdist's ``--dist loadfile`` queue (largest file first)
starts its JAX work early, away from the reference's wall-clock tests
(ROADMAP C3).
"""
import dataclasses
import functools
import tempfile
from unittest import mock

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.configs as jcfgs  # noqa: E402
from repro.data import DataConfig as JDataConfig  # noqa: E402
from repro.data import make_batch as jmake_batch  # noqa: E402
from repro.kernels.flash_attention.ref import attention_ref as jref  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models.layers import no_shard  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.optim import compression as jcomp  # noqa: E402
from repro.optim import schedule as jsched  # noqa: E402
from repro.runtime import make_train_step as jmake_train_step  # noqa: E402
import repro_torch.configs as tcfgs  # noqa: E402
from repro_torch.data import DataConfig, DataLoader, make_batch  # noqa: E402
from repro_torch.kernels.flash_attention import ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    attention_bwd_ref, attention_ref)
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.optim import AdamWConfig  # noqa: E402
from repro_torch.optim import adamw, compression, schedule  # noqa: E402
from repro_torch.runtime import (SimulatedFailure, StragglerMonitor,  # noqa: E402
                                 Trainer, TrainerConfig, bubble_fraction,
                                 make_train_step)
from repro_torch.runtime.trainer import KEEP_F32, compute_dtype  # noqa: E402
from repro_torch.weights import (_jax_leaves, model_from_numpy,  # noqa: E402
                                 opt_state_from_numpy)
from _torch_helpers import assert_master_close, normal, rng  # noqa: E402

LOSS_ARCHS = ["gemma2-2b", "qwen2.5-14b", "mamba2-130m", "zamba2-7b"]
#: tolerance (relative, and absolute of the leaf's largest |value|)
TOL = {"float32": 1e-4, "bfloat16": 5e-2}
#: the port's bf16 gradient against the exact one, over JAX's bf16 one's
BF16_FLOOR_FACTOR = 2.0
#: leaves that make the SSD scan's dt, A, B, C and D: their gradients are
#: sums that cancel, and each bf16 run's distance from the exact gradient
#: depends on the batch (mamba2-smoke, batch seeds 1-3: JAX's largest leaf
#: distance 0.042 / 0.084 / 0.055, the port's 0.076 / 0.037 / 0.050)
SSD_LEAVES = ("w_dt", "dt_bias", "a_log", "w_bc", "conv_wbc", "conv_bbc",
              "d_skip")
B = 2
#: sequence length by arch: the ssm and hybrid smokes' chunk is 16, so 40
#: tokens carry the SSD state across two chunk boundaries
SEQ = {"mamba2-130m": 40, "zamba2-7b": 40}


def _cfgs(arch, dtype):
    j = jcfgs.get_config(arch, smoke=True)
    t = tcfgs.get_config(arch, smoke=True)
    if dtype == "float32":
        j = dataclasses.replace(j, dtype="float32")
        t = dataclasses.replace(t, dtype="float32")
    return j, t


def _np_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _batch_np(cfg, seed, shape):
    r = rng(seed)
    return {"tokens": r.integers(0, cfg.vocab_size, shape, dtype=np.int32),
            "labels": r.integers(0, cfg.vocab_size, shape, dtype=np.int32)}


def _t_batch(batch):
    return {k: torch.from_numpy(v.astype(np.int64)) for k, v in batch.items()}


def _close_leaf(got, want, tol, what):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale,
                               err_msg=what)


def _silu_rounded_once(x):
    """SiLU computed in f32 and rounded once to ``x``'s type, as torch's
    ``F.silu`` computes it in bf16 (JAX's bf16 ``jax.nn.silu`` rounds its
    sigmoid first: ROADMAP C, "faults of the reference")."""
    x32 = x.astype(jnp.float32)
    return (x32 * jax.nn.sigmoid(x32)).astype(x.dtype)


def _jax_loss_and_grads(jcfg, params, batch):
    """JAX's loss, metrics and gradients; in bf16 traced with the SiLU
    rounded once (``jax.nn.silu`` patched while tracing; the JAX package is
    not changed, and JAX's trace caches are cleared around it)."""
    fn = jax.jit(jax.value_and_grad(lambda p, b: JM.loss_fn(jcfg, p, b),
                                    has_aux=True))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    if jcfg.dtype == "float32":
        (loss, metrics), grads = fn(params, jb)
    else:
        jax.clear_caches()
        try:
            with mock.patch.object(jax.nn, "silu", _silu_rounded_once):
                (loss, metrics), grads = fn(params, jb)
        finally:
            jax.clear_caches()
    return float(loss), {k: float(v) for k, v in metrics.items()}, grads


@functools.lru_cache(maxsize=None)
def _jax_run(arch, dtype):
    """(weights, batch, JAX's loss, metrics and gradients) of ``arch``'s
    smoke config in ``dtype``.  Both dtypes take the same weights, the bf16
    config's draw (as f32 numpy), so the f32 run's gradients are the exact
    ones of the bf16 run's weights."""
    jcfg, tcfg = _cfgs(arch, dtype)
    bf = JM.init_params(_cfgs(arch, "bfloat16")[0], jax.random.PRNGKey(0))
    params = jax.tree.map(lambda a: a.astype(jnp.float32), bf) \
        if dtype == "float32" else bf
    batch = _batch_np(tcfg, 1, (B, SEQ.get(arch, 16)))
    loss, metrics, grads = _jax_loss_and_grads(jcfg, params, batch)
    return _np_tree(params), batch, loss, metrics, _np_tree(grads)


def _port_loss_and_grads(tcfg, model, batch):
    params = dict(model.named_parameters())
    for p in params.values():
        p.requires_grad_(True)
    loss, metrics = TM.loss_fn(tcfg, model, _t_batch(batch))
    grads = torch.autograd.grad(loss, list(params.values()))
    return (float(loss.detach()),
            {k: float(v.detach()) for k, v in metrics.items()},
            dict(zip(params, grads)))


# ------------------------------------------------------------- loss and grad
def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", LOSS_ARCHS)
def test_loss_and_gradients_match_jax(arch, dtype):
    """f32: loss, metrics and every gradient element within 1e-4.  bf16:
    the loss within 5e-2, and each gradient leaf's distance (in norm) from
    the exact gradient — JAX's f32 gradient at the same bf16 weights —

    * within 5e-2 where JAX's own bf16 gradient lies within 5e-2 of it
      (every leaf of gemma2-smoke, qwen2.5-smoke and mamba2-smoke, and of
      zamba2-smoke ``lm_head.w``, ``shared.1.*`` and block 3's x path and
      output);
    * within ``BF16_FLOOR_FACTOR`` times JAX's distance where that is
      larger than 5e-2 (the rest of zamba2-smoke: JAX's bf16 gradients of
      its other leaves lie 5.0-9.8% from exact, and of its SSD leaves up
      to 86%);
    * for :data:`SSD_LEAVES`, within ``BF16_FLOOR_FACTOR`` times the larger
      of 5e-2 and JAX's distance: with this batch the port's bf16 gradient
      of mamba2-smoke's ``dt_bias`` lies 5.2% and 7.6% from exact (JAX's
      3.9% and 4.2%), ``blocks.1.mix.conv_wbc`` 6.4% (3.1%), and
      zamba2-smoke's ``blocks.1.mix`` ``w_dt``, ``dt_bias`` and ``d_skip``
      5.1-6.3% (4.3-4.8%); with other batches JAX's is the further one.

    An elementwise bound between the two bf16 runs would gate their
    rounding noise, not the port."""
    tcfg = _cfgs(arch, dtype)[1]
    params, batch, jloss, jmetrics, jgrads = _jax_run(arch, dtype)
    model = model_from_numpy(tcfg, params, device="cpu")
    tloss, tmetrics, tgrads = _port_loss_and_grads(tcfg, model, batch)
    tol = TOL[dtype]
    _close_leaf(tloss, jloss, tol, "loss")
    for k in ("nll", "zloss"):
        _close_leaf(tmetrics[k], jmetrics[k], tol, k)
    assert 0.0 <= tmetrics["accuracy"] <= 1.0
    shapes = {n: g.shape for n, g in tgrads.items()}
    want = _jax_leaves(tcfg, jgrads, shapes)
    if dtype == "bfloat16":
        exact = _jax_leaves(tcfg, _jax_run(arch, "float32")[4], shapes)
    for name, g in tgrads.items():
        assert g.dtype == dict(model.named_parameters())[name].dtype
        got = g.float().numpy()
        if dtype == "float32":
            _close_leaf(got, want[name], tol, name)
            continue
        jdist = _rel(want[name], exact[name])
        if name.split(".")[-1] in SSD_LEAVES:
            limit = BF16_FLOOR_FACTOR * max(jdist, tol)
        else:
            limit = tol if jdist <= tol else BF16_FLOOR_FACTOR * jdist
        assert _rel(got, exact[name]) <= limit, (name, jdist)


def _chunk_floor(jcfg, tcfg, params, batch):
    """Each gradient leaf's relative distance between the SSD scan in
    chunks of ``ssm_chunk`` and of half that (the same function summed in
    another order), in JAX (its jnp route) and in the port (its plain
    route), the port's leaves by name."""
    dists = {}
    for side in ("jax", "port"):
        grads = []
        for chunk in (jcfg.ssm_chunk, jcfg.ssm_chunk // 2):
            if side == "jax":
                jc = dataclasses.replace(jcfg, ssm_chunk=chunk)
                grads.append(_np_tree(_jax_loss_and_grads(jc, params,
                                                          batch)[2]))
            else:
                tc = dataclasses.replace(tcfg, ssm_chunk=chunk)
                model = model_from_numpy(tc, _np_tree(params), device="cpu")
                g = _port_loss_and_grads(tc, model, batch)[2]
                grads.append({n: t.float().numpy() for n, t in g.items()})
        dists[side] = grads
    shapes = {n: a.shape for n, a in dists["port"][0].items()}
    jl = [_jax_leaves(tcfg, g, shapes) for g in dists["jax"]]
    return ({n: _rel(jl[1][n], jl[0][n]) for n in shapes},
            {n: _rel(dists["port"][1][n], dists["port"][0][n])
             for n in shapes})


def test_bf16_rounding_floor_is_the_models_own():
    """mamba2-130m at full width, 8 of its 24 layers, one row of 256
    tokens, the same weights and batch on both sides.  In bf16, summing the
    SSD scan in chunks of 64 instead of 128 (rounding alone) moves the
    median gradient leaf by several % in JAX and in the port alike (read:
    JAX 0.058, the port 0.103; largest leaf 0.113 and 0.253), far above one
    bf16 rounding (2^-8): the random model amplifies the rounding of its
    bf16 activations.  In f32 the same
    change moves every leaf by less than 1e-3 on both sides (read: medians
    7.5e-5 and 6.7e-5).  This is the floor under the bf16 train gates of
    ``chip_smoke.py``'s ``ssm_train`` phase: JAX's own, not the port's.
    Held: both bf16 medians above 4 · 2^-8 and within a factor of 3 of
    each other; every f32 leaf below 1e-3."""
    jcfg = dataclasses.replace(jcfgs.get_config("mamba2-130m"), n_layers=8)
    tcfg = dataclasses.replace(tcfgs.get_config("mamba2-130m"), n_layers=8)
    bf = JM.init_params(jcfg, jax.random.PRNGKey(0))
    batch = _batch_np(tcfg, 0, (1, 256))
    med = {}
    for dtype in ("bfloat16", "float32"):
        jc = dataclasses.replace(jcfg, dtype=dtype)
        tc = dataclasses.replace(tcfg, dtype=dtype)
        params = bf if dtype == "bfloat16" else jax.tree.map(
            lambda a: a.astype(jnp.float32), bf)
        jd, td = _chunk_floor(jc, tc, params, batch)
        med[dtype] = (float(np.median(list(jd.values()))),
                      float(np.median(list(td.values()))))
        if dtype == "float32":
            assert max(jd.values()) < 1e-3 and max(td.values()) < 1e-3
    jm, tm = med["bfloat16"]
    assert jm > 4 * 2.0 ** -8 and tm > 4 * 2.0 ** -8, med
    assert 1.0 / 3.0 <= tm / jm <= 3.0, med


# ----------------------------------------------------------------- unembed
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["gemma2-2b", "qwen2-7b"])
def test_unembed_gradients_match_jax(arch, dtype):
    """gemma2 ties its embedding and soft-caps the logits; qwen2 has its
    own head.  The cotangent is a numpy draw; the gradients of x, the
    final norm's scale and the unembedding weight are held to JAX's: f32
    within 1e-5, bf16 within one bf16 rounding (2^-7 of the element, plus
    1e-6 of the leaf's largest) — both sides round the same f32 product
    of the f32 cotangent and the bf16 operands."""
    jcfg, tcfg = _cfgs(arch, dtype)
    model = TM.init_params(tcfg, 0, device="cpu")
    head = "embed" if tcfg.tie_embeddings else "lm_head"
    weight = getattr(model, head)["w"]
    r = rng(5)
    scale_np = 1.0 + 0.1 * normal(r, (tcfg.d_model,))
    w_np = normal(r, tuple(weight.shape)) * tcfg.d_model ** -0.5
    x = normal(r, (2, 7, tcfg.d_model))
    cot = normal(r, (2, 7, tcfg.vocab_size))
    with torch.no_grad():
        model.final_norm["scale"].copy_(torch.from_numpy(scale_np))
        weight.copy_(torch.from_numpy(w_np))
    dt = getattr(jnp, dtype)

    def jf(fn, w, xx):
        p = {"final_norm": {"scale": fn}, head: {"w": w}}
        return jnp.sum(JM.unembed(jcfg, p, xx, no_shard) * cot)

    jgx = jax.jit(jax.grad(jf, argnums=(0, 1, 2)))(
        jnp.asarray(scale_np), jnp.asarray(w_np, dt), jnp.asarray(x, dt))
    xt = torch.from_numpy(x).to(getattr(torch, dtype)).requires_grad_(True)
    leaves = [model.final_norm["scale"], getattr(model, head)["w"], xt]
    for p in leaves[:2]:
        p.requires_grad_(True)
    logits = model.unembed(xt)
    assert logits.dtype == torch.float32
    got = torch.autograd.grad((logits * torch.from_numpy(cot)).sum(), leaves)
    for name, g, w in zip(("final_norm.scale", f"{head}.w", "x"), got, jgx):
        want = np.asarray(w.astype(jnp.float32), np.float64)
        g = g.float().numpy().astype(np.float64)
        if dtype == "float32" or name == "final_norm.scale":
            _close_leaf(g, want, 1e-5, name)
        else:
            np.testing.assert_allclose(
                g, want, rtol=2.0 ** -7,
                atol=1e-6 * np.abs(want).max(), err_msg=name)


# --------------------------------------------------------------- train step
@pytest.mark.parametrize("micro,arch", [
    pytest.param(False, "gemma2-2b", id="False"),
    pytest.param(True, "gemma2-2b", id="True"),
    pytest.param(False, "mamba2-130m", id="mamba2-130m-False"),
    pytest.param(True, "mamba2-130m", id="mamba2-130m-True"),
    pytest.param(False, "zamba2-7b", id="zamba2-7b-False"),
    pytest.param(True, "zamba2-7b", id="zamba2-7b-True")])
def test_train_step_matches_jax(micro, arch):
    """One step of ``make_train_step`` (AdamW at 1e-3, constant schedule)
    from the same f32 state and batch — with ``micro``, a leading
    microbatch dim of 2 — : loss, grad norm, lr, master params and moments
    within 1e-4; the port's state is updated in place.  gemma2-smoke, and
    mamba2-smoke and zamba2-smoke at ``SEQ`` 40 (the SSD state carried
    across two chunk boundaries, in the forward and in the gradient).  For
    zamba2-smoke the master is held by ``assert_master_close``: a few
    elements whose step-1 gradient lies near AdamW's eps take a step that
    f32 rounding of g moves past 1e-4 (ROADMAP C, "Found"); every other
    master element, and all of gemma2's and mamba2's, within 1e-4."""
    jcfg, tcfg = _cfgs(arch, "float32")
    params = JM.init_params(jcfg, jax.random.PRNGKey(0))
    jstate = jadamw.init(params)
    shape = (2, B, SEQ.get(arch, 16)) if micro else (B, SEQ.get(arch, 16))
    batch = _batch_np(tcfg, 2, shape)
    jstep = jax.jit(jmake_train_step(jcfg, jadamw.AdamWConfig(lr=1e-3),
                                     jsched.constant, no_shard))
    jnew, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    state = opt_state_from_numpy(tcfg, jax.tree.map(np.asarray, jstate),
                                 device="cpu")
    master = dict(state["master"])
    acfg = AdamWConfig(lr=1e-3)
    step = make_train_step(tcfg, acfg, schedule.constant)
    tnew, tm = step(state, _t_batch(batch))
    assert tnew is state and int(tnew["step"]) == int(jnew["step"]) == 1
    assert all(tnew["master"][n] is t for n, t in master.items())
    for k in ("loss", "grad_norm", "lr", "nll"):
        _close_leaf(float(tm[k]), float(jm[k]), 1e-4, k)
    want = {part: _jax_leaves(tcfg, _np_tree(jnew[part]),
                              {n: t.shape for n, t in tnew[part].items()})
            for part in ("master", "m", "v")}
    for part in ("m", "v", "master"):
        for name, t in tnew[part].items():
            if part == "master" and arch == "zamba2-7b":
                # step 1's clipped gradient, from JAX's first moment
                g = want["m"][name] / (1.0 - acfg.b1)
                assert_master_close(t.numpy(), want[part][name], g,
                                    acfg.lr, 1e-4, f"{part} {name}")
            else:
                _close_leaf(t.numpy(), want[part][name], 1e-4,
                            f"{part} {name}")


def test_opt_state_from_numpy_refuses_a_foreign_tree():
    jcfg, tcfg = _cfgs("qwen2.5-14b", "float32")
    jstate = jax.tree.map(np.asarray, jadamw.init(
        JM.init_params(jcfg, jax.random.PRNGKey(0))))
    state = opt_state_from_numpy(tcfg, jstate, device="cpu")
    assert int(state["step"]) == 0 and state["step"].dtype == torch.int32
    assert set(state["m"]) == set(TM.param_shapes(tcfg))
    bad = dict(jstate, m=dict(jstate["m"], extra=np.zeros(3, np.float32)))
    with pytest.raises(ValueError, match="leaves the model does not"):
        opt_state_from_numpy(tcfg, bad, device="cpu")


# ------------------------------------------------- compute dtypes and shapes
@pytest.mark.parametrize("arch", tcfgs.list_archs())
def test_param_shapes_and_compute_dtypes_follow_jax(arch):
    """``param_shapes`` holds JAX's leaves (``weights._jax_leaves`` finds
    every one); the train step's compute dtypes follow JAX's
    ``cast_params`` (f32 for ``KEEP_F32`` leaves) and equal the model's own;
    ``count_params(active_only=True)`` is the total for these families."""
    jcfg, tcfg = jcfgs.get_config(arch, smoke=True), \
        tcfgs.get_config(arch, smoke=True)
    shapes = TM.param_shapes(tcfg)
    jshapes = jax.tree.map(lambda s: np.zeros(s.shape, np.float32),
                           JM.param_shapes(jcfg))
    assert set(_jax_leaves(tcfg, jshapes, {n: p.shape for n, p in
                                           shapes.items()})) == set(shapes)
    for name, p in shapes.items():
        assert p.device.type == "meta"
        assert compute_dtype(tcfg, name) == p.dtype, name
    assert {n.split(".")[-1] for n in shapes} & set(KEEP_F32)
    assert TM.count_params(tcfg, active_only=True) == TM.count_params(tcfg) \
        == JM.count_params(jcfg, active_only=True)


# ------------------------------------------------ tests/test_runtime.py's
def _trainer(ckpt_dir, steps=10, arch="qwen2.5-14b"):
    cfg = tcfgs.SMOKES[arch]
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=16,
                      global_batch=4, seed=7)
    tcfg = TrainerConfig(steps=steps, ckpt_every=4, ckpt_dir=ckpt_dir,
                         warmup=2, adamw=AdamWConfig(lr=1e-3))
    return Trainer(cfg, dcfg, tcfg, device="cpu")


def test_loss_decreases_on_learnable_data():
    cfg = tcfgs.SMOKES["qwen2.5-14b"]
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=16,
                      global_batch=8, seed=0, grammar_frac=1.0)
    with tempfile.TemporaryDirectory() as d:
        tcfg = TrainerConfig(steps=30, ckpt_every=100, ckpt_dir=d,
                             warmup=3, adamw=AdamWConfig(lr=3e-3))
        hist = Trainer(cfg, dcfg, tcfg, device="cpu").train()
    first = np.mean([h["loss"] for h in hist[:5]])
    last = np.mean([h["loss"] for h in hist[-5:]])
    assert last < first - 0.2, (first, last)


def test_restart_reproduces_uninterrupted_run():
    """A failure at step 6 recovers from the step-4 checkpoint; every
    step's loss, and the final state, equal the uninterrupted run's bit
    for bit (the JAX test rounds the losses to 5 places)."""
    with tempfile.TemporaryDirectory() as d1:
        t1 = _trainer(d1)
        h1 = t1.train()
    with tempfile.TemporaryDirectory() as d2:
        tr = _trainer(d2)
        fail_at = {6}

        def inj(step):
            if step in fail_at:
                fail_at.discard(step)
                raise SimulatedFailure()

        h2 = tr.train(failure_injector=inj)
    a = {h["step"]: h["loss"] for h in h1}
    b = {h["step"]: h["loss"] for h in h2}
    assert a == {s: b[s] for s in a}
    assert len(h2) == len(h1) + 2          # steps 5 and 6 ran twice
    for part in ("master", "m", "v"):
        for name, t in t1.opt_state[part].items():
            assert torch.equal(t, tr.opt_state[part][name]), (part, name)


def test_cold_restart_from_disk():
    with tempfile.TemporaryDirectory() as d:
        tr = _trainer(d, steps=8)
        tr.train(steps=4)
        tr.save()
        tr.store.wait()
        # fresh trainer object == fresh process
        tr2 = _trainer(d, steps=8)
        tr2.init_or_restore()
        assert int(tr2.opt_state["step"]) == 4
        assert tr2.loader.step == 4
        for part in ("master", "m", "v"):
            for name, t in tr.opt_state[part].items():
                assert torch.equal(t, tr2.opt_state[part][name])
        h = tr2.train()
        assert h[-1]["step"] == 8


def test_straggler_monitor():
    mon = StragglerMonitor(threshold=2.0)
    for _ in range(5):
        mon.observe(0, 1.0)
    assert not mon.flagged
    assert mon.observe(6, 5.0)
    assert mon.flagged and mon.flagged[0][1] == 5.0


def test_bubble_fraction():
    assert bubble_fraction(8, 4) == pytest.approx(3 / 11)
    assert bubble_fraction(100, 2) < 0.01


def test_trainer_refuses_a_mesh_and_a_sharder():
    cfg = tcfgs.SMOKES["qwen2.5-14b"]
    with tempfile.TemporaryDirectory() as d:
        with pytest.raises(NotImplementedError, match="A7.2b"):
            Trainer(cfg, DataConfig(cfg.vocab_size, 8, 2),
                    TrainerConfig(ckpt_dir=d), mesh=object(), device="cpu")
    with pytest.raises(NotImplementedError, match="A7.2b"):
        make_train_step(cfg, AdamWConfig(), schedule.constant,
                        sharder=lambda x, *a: x)


# ------------------------------------------ tests/test_arch_smoke.py's step
@pytest.mark.parametrize("arch", tcfgs.list_archs())
def test_train_step_no_nans(arch):
    cfg = tcfgs.SMOKES[arch]
    state = adamw.init(TM.init_params(cfg, 0, device="cpu"))
    before = {n: t.clone() for n, t in state["master"].items()}
    batch = _t_batch(_batch_np(cfg, 1, (2, 32)))
    step = make_train_step(cfg, AdamWConfig(lr=1e-3), schedule.constant)
    state, metrics = step(state, batch)
    loss, gnorm = float(metrics["loss"]), float(metrics["grad_norm"])
    assert np.isfinite(loss) and loss > 0
    assert np.isfinite(gnorm) and gnorm > 0
    # params actually moved
    assert max(float((state["master"][n] - t).abs().max())
               for n, t in before.items()) > 0


# ============================================ optimizer and batches
OPT_TOL = 1e-5

#: dotted names (as the model zoo names its parameters) and shapes; the
#: last parts cover every decay exception of ``_decayable``
LEAVES = {"embed.w": (12, 6), "blocks.0.attn.wq": (6, 8),
          "blocks.0.attn.bq": (8,), "blocks.0.ln1.scale": (6,),
          "blocks.1.mix.a_log": (3,), "blocks.1.mix.dt_bias": (3,),
          "blocks.1.mix.d_skip": (3,), "blocks.1.mix.conv_bx": (5,),
          "blocks.1.mix.conv_bbc": (4,), "blocks.1.mix.w_out": (5, 6),
          "blocks.1.attn.bk": (4,), "blocks.1.attn.bv": (4,),
          "final_norm.scale": (6,)}


def _nest(flat):
    """dotted names -> the nested dict JAX keys its tree by."""
    out = {}
    for name, v in flat.items():
        node = out
        *path, last = name.split(".")
        for p in path:
            node = node.setdefault(p, {})
        node[last] = v
    return out


def _get(tree, name):
    for p in name.split("."):
        tree = tree[p]
    return tree


def _close_opt(got, want, tol=OPT_TOL):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=tol,
                               atol=tol)


def _draw(seed, scale=1.0):
    r = rng(seed)
    return {n: normal(r, s) * scale for n, s in LEAVES.items()}


# ---------------------------------------------------------------- schedules
@pytest.mark.parametrize("warmup,total", [(10, 100), (3, 30), (0, 5),
                                          (7, 7)])
def test_linear_warmup_cosine_matches_jax(warmup, total):
    steps = np.arange(0, total + 5, dtype=np.int32)
    want = jsched.linear_warmup_cosine(jnp.asarray(steps), warmup=warmup,
                                       total=total)
    got = schedule.linear_warmup_cosine(torch.from_numpy(steps),
                                        warmup=warmup, total=total)
    assert got.dtype == torch.float32
    _close_opt(got, want)


@pytest.mark.parametrize("warmup", [1, 4, 100])
def test_inverse_sqrt_and_constant_match_jax(warmup):
    steps = np.arange(0, 40, dtype=np.int32)
    _close_opt(schedule.inverse_sqrt(torch.from_numpy(steps), warmup=warmup),
               jsched.inverse_sqrt(jnp.asarray(steps), warmup=warmup))
    _close_opt(schedule.constant(torch.from_numpy(steps)),
               jsched.constant(jnp.asarray(steps)))


# --------------------------------------------------------------- compression
def test_compression_matches_jax_bit_for_bit():
    grads, res = _draw(0), _draw(1, 1e-3)
    jc, jr = jcomp.compress(_nest(grads), _nest(res))
    tc, tr = compression.compress(
        {n: torch.from_numpy(g) for n, g in grads.items()},
        {n: torch.from_numpy(r) for n, r in res.items()})
    for name in LEAVES:
        assert tc[name].dtype == torch.bfloat16
        np.testing.assert_array_equal(
            tc[name].float().numpy(),
            np.asarray(_get(jc, name).astype(jnp.float32)))
        np.testing.assert_array_equal(tr[name].numpy(),
                                      np.asarray(_get(jr, name)))
        np.testing.assert_array_equal(
            compression.decompress(tc)[name].numpy(),
            np.asarray(_get(jcomp.decompress(jc), name)))
    zeros = compression.init_residuals({n: torch.from_numpy(g)
                                        for n, g in grads.items()})
    assert all(z.dtype == torch.float32 and not z.any()
               for z in zeros.values())


# ----------------------------------------------------------- norm and clip
@pytest.mark.parametrize("max_norm", [0.5, 1e3])
def test_global_norm_and_clip_match_jax(max_norm):
    grads = _draw(2)
    jg, jn = jadamw.clip_by_global_norm(_nest(grads), max_norm)
    tg, tn = adamw.clip_by_global_norm(
        {n: torch.from_numpy(g) for n, g in grads.items()}, max_norm)
    _close_opt(tn, jn)
    _close_opt(adamw.global_norm({n: torch.from_numpy(g)
                                  for n, g in grads.items()}),
               jadamw.global_norm(_nest(grads)))
    for name in LEAVES:
        _close_opt(tg[name], _get(jg, name))


def test_decay_mask_matches_jax():
    tree = _nest({n: 0 for n in LEAVES})
    paths = jax.tree_util.tree_flatten_with_path(tree)[0]
    for path, _ in paths:
        name = ".".join(str(k.key) for k in path)
        assert adamw._decayable(name) == jadamw._decayable(path), name


# -------------------------------------------------------------------- AdamW
@pytest.mark.parametrize("cfg_kw", [
    {}, {"grad_clip": 0.0}, {"weight_decay": 0.0},
    {"lr": 1e-2, "b1": 0.8, "b2": 0.99, "grad_clip": 0.3}])
def test_adamw_steps_match_jax(cfg_kw):
    """Three steps with a warmup-cosine scale from the same params and
    gradients: state, master params and metrics within 1e-5; the port's
    state is updated in place (the same tensors come back)."""
    params = _draw(3)
    jcfg = jadamw.AdamWConfig(**cfg_kw)
    tcfg = adamw.AdamWConfig(**cfg_kw)
    jstate = jadamw.init(_nest({n: jnp.asarray(p)
                                for n, p in params.items()}))
    tstate = adamw.init({n: torch.from_numpy(p) for n, p in params.items()})
    tensors = {k: dict(tstate[k]) for k in ("master", "m", "v")}
    japply = jax.jit(jadamw.apply, static_argnums=2)
    for i in range(3):
        grads = _draw(10 + i)
        sj = jsched.linear_warmup_cosine(jstate["step"], warmup=2, total=6)
        st = schedule.linear_warmup_cosine(tstate["step"], warmup=2, total=6)
        jstate, jmaster, jm = japply(jstate, _nest(grads), jcfg, sj)
        tstate, tmaster, tm = adamw.apply(
            tstate, {n: torch.from_numpy(g) for n, g in grads.items()}, tcfg,
            lr_scale=st)
        assert int(tstate["step"]) == int(jstate["step"]) == i + 1
        _close_opt(tm["grad_norm"], jm["grad_norm"])
        _close_opt(tm["lr"], jm["lr"])
        for name in LEAVES:
            for part in ("master", "m", "v"):
                _close_opt(tstate[part][name], _get(jstate[part], name))
            assert tmaster[name] is tstate["master"][name]
    for part, leaves in tensors.items():
        assert all(tstate[part][n] is t for n, t in leaves.items())


def test_adamw_bf16_params_and_grads_match_jax():
    """bf16 params and gradients (the model zoo's): the state is f32, the
    update math f32, as in JAX; params_from_state casts the master back."""
    params = _draw(4)
    bf = {n: torch.from_numpy(p).bfloat16() for n, p in params.items()}
    jparams = _nest({n: jnp.asarray(p, jnp.bfloat16)
                     for n, p in params.items()})
    jstate = jadamw.init(jparams)
    tstate = adamw.init(bf)
    assert all(t.dtype == torch.float32 for t in tstate["master"].values())
    grads = _draw(5)
    jstate, _, jm = jadamw.apply(
        jstate, _nest({n: jnp.asarray(g, jnp.bfloat16)
                       for n, g in grads.items()}), jadamw.AdamWConfig())
    tstate, _, tm = adamw.apply(
        tstate, {n: torch.from_numpy(g).bfloat16() for n, g in grads.items()},
        adamw.AdamWConfig())
    _close_opt(tm["grad_norm"], jm["grad_norm"])
    like = {n: torch.empty_like(t) for n, t in bf.items()}
    adamw.params_from_state(tstate, like)
    jlike = jadamw.params_from_state(jstate, jparams)
    for name in LEAVES:
        for part in ("master", "m", "v"):
            _close_opt(tstate[part][name], _get(jstate[part], name))
        assert like[name].dtype == torch.bfloat16
        np.testing.assert_array_equal(
            like[name].float().numpy(),
            np.asarray(_get(jlike, name).astype(jnp.float32)))


# --------------------------------------------------------------- the batches
@pytest.mark.parametrize("kw", [
    {"vocab_size": 256, "seq_len": 16, "global_batch": 8, "seed": 7},
    {"vocab_size": 256, "seq_len": 16, "global_batch": 8,
     "grammar_frac": 1.0},
    {"vocab_size": 1000, "seq_len": 33, "global_batch": 5, "seed": 3,
     "grammar_frac": 0.2, "grammar_families": 2},
    {"vocab_size": 64, "seq_len": 8, "global_batch": 4,
     "input_mode": "embeddings", "d_model": 16}])
def test_make_batch_is_byte_equal_to_jax(kw):
    jcfg, tcfg = JDataConfig(**kw), DataConfig(**kw)
    for step in (0, 1, 17):
        for host_slice in (None, (1, 3)):
            want = jmake_batch(jcfg, step, host_slice)
            got = make_batch(tcfg, step, host_slice)
            assert sorted(got) == sorted(want)
            for k in want:
                assert got[k].dtype == want[k].dtype
                assert got[k].tobytes() == want[k].tobytes()


def test_data_loader_resumes_at_its_step():
    cfg = DataConfig(vocab_size=128, seq_len=8, global_batch=2, seed=1)
    a = DataLoader(cfg)
    first = [next(a) for _ in range(3)]
    b = DataLoader(cfg)
    b.load_state_dict(DataLoader(cfg, start_step=2).state_dict())
    assert a.state_dict() == {"step": 3}
    assert next(b)["tokens"].tobytes() == first[2]["tokens"].tobytes()


# ============================================ flash attention gradient
#: (b, hq, hkv, sq, skv, d, dv, causal, window, softcap)
FB_CASES = [
    (2, 4, 4, 64, 64, 16, 16, True, 0, 0.0),
    (2, 8, 2, 64, 64, 16, 16, True, 16, 0.0),
    (1, 4, 2, 70, 70, 16, 16, True, 0, 30.0),
    (2, 4, 4, 48, 48, 16, 16, False, 0, 0.0),
    (1, 4, 2, 40, 100, 16, 16, True, 0, 0.0),
    (1, 2, 1, 50, 50, 16, 8, True, 12, 5.0),
    (1, 2, 2, 33, 90, 8, 8, False, 20, 0.0),
    (1, 2, 2, 100, 100, 8, 8, True, 33, 10.0),
    (1, 4, 4, 96, 96, 112, 112, True, 0, 0.0),    # zamba2-7b's head dim
]
FB_IDS = [f"b{c[0]}h{c[1]}/{c[2]}s{c[3]}/{c[4]}d{c[5]}/{c[6]}"
          f"{'c' if c[7] else 'n'}w{c[8]}cap{c[9]:g}" for c in FB_CASES]


def _fb_inputs(case, seed=0):
    b, hq, hkv, sq, skv, d, dv = case[:7]
    r = rng(seed)
    return (normal(r, (b, hq, sq, d)), normal(r, (b, hkv, skv, d)),
            normal(r, (b, hkv, skv, dv)), normal(r, (b, hq, sq, dv)))


def _fb_kw(case):
    return dict(causal=case[7], window=case[8], softcap=case[9])


def _close_fb(got, want, tol, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * max(np.abs(want).max(), 1e-30),
                               err_msg=what)


def _fb_grads(route, q, k, v, do, kw):
    """(dq, dk, dv) of ``sum(attention(q, k, v) * do)`` by ``route``."""
    t = [torch.from_numpy(a) for a in (q, k, v, do)]
    if route == "attention_bwd":
        return ops.attention_bwd(*t, **kw)
    if route == "attention_bwd_ref":
        return attention_bwd_ref(*t, **kw)
    leaves = [a.requires_grad_(True) for a in t[:3]]
    return torch.autograd.grad(ops.attention(*leaves, **kw), leaves, t[3])


@pytest.mark.parametrize("route", ["autograd", "attention_bwd",
                                   "attention_bwd_ref"])
@pytest.mark.parametrize("case", FB_CASES, ids=FB_IDS)
def test_plain_attention_gradient_matches_jax(case, route):
    q, k, v, do = _fb_inputs(case)
    kw = _fb_kw(case)

    def f(q, k, v):
        return jnp.sum(jref(q, k, v, **kw) * do)

    want = jax.jit(jax.grad(f, argnums=(0, 1, 2)))(q, k, v)
    got = _fb_grads(route, q, k, v, do, kw)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert np.isfinite(g.numpy()).all(), name
        _close_fb(g.numpy(), w, 1e-5, name)


@pytest.mark.parametrize("case", FB_CASES[:3], ids=FB_IDS[:3])
def test_attention_bwd_cpu_route_is_autograd(case):
    q, k, v, do = (torch.from_numpy(a) for a in _fb_inputs(case, 1))
    kw = _fb_kw(case)
    got = ops.attention_bwd(q, k, v, do, **kw)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    want = torch.autograd.grad(ops.attention(*leaves, **kw), leaves, do)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    for g, w in zip(got, attention_bwd_ref(q, k, v, do, **kw)):
        assert torch.equal(g, w)


def test_attention_bwd_kernel_impl_on_cpu_raises():
    q = torch.ones(1, 2, 4, 8)
    with pytest.raises(ValueError, match="CUDA device"):
        ops.attention_bwd(q, q, q, q, impl="kernel")
