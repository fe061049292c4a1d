"""Port parity: the dense and ssm model zoo (``repro_torch.models``).

The layers (``rmsnorm``, ``apply_rope``, ``gqa_prefill``, ``gqa_decode``,
``mlp``, the Mamba2 block and its causal conv) against
``repro.models.layers``, and the whole model — prefill then four decode
steps, and the full-sequence forward — against ``repro.models`` for
``gemma2-smoke`` (local/global windows, soft-caps, post-block norms, tied
scaled embeddings; window 8 < prompt 16, so the window bites),
``qwen2-smoke`` (QKV bias, untied head) and ``mamba2-smoke`` (Mamba2
blocks, tied embeddings; a 40-token prompt in chunks of 16, so the SSD
carries its state across two chunk boundaries into a short last chunk).
The JAX
weights are carried over with ``repro_torch.weights.model_from_numpy``;
the decode tokens are the same numpy draws on both sides.  In f32
(``dataclasses.replace(cfg, dtype="float32")``) logits and caches agree
at 1e-4; in bf16 the logits agree within ``0.02·(max|logit| + 1)``, the
bound of ``tests/test_arch_smoke.py:96-98``.  On the CPU the attention
and the SSD scan are their kernels' plain versions.  The logits are f32
products of the bf16 activations and weights, as JAX's
``preferred_element_type=float32`` dot gives them
(:func:`test_unembed_gives_f32_logits_of_bf16_products`).
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.configs as jcfgs  # noqa: E402
import repro.models as jmodels  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import model as JM  # noqa: E402
import repro_torch.configs as tcfgs  # noqa: E402
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.kernels.ssd_scan import ops as ssd_ops  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.weights import model_from_numpy  # noqa: E402
from _torch_helpers import as_np, normal, rng  # noqa: E402

B, S, GEN = 2, 16, 4
ARCHS = ["gemma2-2b", "qwen2-7b"]
MODEL_ARCHS = ARCHS + ["mamba2-130m"]
#: prompt length by arch (default S): mamba2-smoke's chunk is 16
SEQ = {"mamba2-130m": 40}


def _np_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _t(tree):
    """numpy f32 (nested) dict → torch f32 (nested) dict."""
    return {k: _t(v) if isinstance(v, dict) else torch.from_numpy(np.array(v))
            for k, v in tree.items()}


def _cfgs(arch, dtype):
    j = jcfgs.get_config(arch, smoke=True)
    t = tcfgs.get_config(arch, smoke=True)
    if dtype == "float32":
        j = dataclasses.replace(j, dtype="float32")
        t = dataclasses.replace(t, dtype="float32")
    return j, t


# ------------------------------------------------------------------ configs
@pytest.mark.parametrize("arch", tcfgs.list_archs())
@pytest.mark.parametrize("smoke", [False, True])
def test_configs_copy_the_jax_configs(arch, smoke):
    assert dataclasses.asdict(tcfgs.get_config(arch, smoke)) == \
        dataclasses.asdict(jcfgs.get_config(arch, smoke))


@pytest.mark.parametrize("arch", tcfgs.list_archs())
def test_count_params_matches_jax(arch):
    cfg = tcfgs.get_config(arch)
    assert TM.count_params(cfg) == jmodels.count_params(
        jcfgs.get_config(arch))


def test_unported_archs_and_families_raise():
    assert set(tcfgs.UNPORTED) | set(tcfgs.list_archs()) == \
        set(jcfgs.list_archs())
    for arch in tcfgs.UNPORTED:
        with pytest.raises(NotImplementedError, match="slice"):
            tcfgs.get_config(arch)
    with pytest.raises(KeyError):
        tcfgs.get_config("gpt-17")
    base = tcfgs.get_config("gemma2-2b", smoke=True)
    for change in (dict(family="moe", n_experts=4),
                   dict(use_mla=True), dict(family="audio",
                                            input_mode="embeddings")):
        with pytest.raises(NotImplementedError, match="slice"):
            TM.DenseLM(dataclasses.replace(base, **change), None, "meta")


# ------------------------------------------------------------------- layers
def test_rmsnorm_matches_jax():
    r = rng(0)
    x, scale = normal(r, (2, 5, 24)), normal(r, (24,))
    want = JL.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x), 1e-6)
    got = TL.rmsnorm({"scale": torch.from_numpy(scale)}, torch.from_numpy(x),
                     1e-6)
    np.testing.assert_allclose(as_np(got), as_np(want), rtol=1e-5, atol=1e-5)
    bf = TL.rmsnorm({"scale": torch.from_numpy(scale)},
                    torch.from_numpy(x).bfloat16(), 1e-6)
    assert bf.dtype == torch.bfloat16


@pytest.mark.parametrize("pos_shape", [(S,), (B, S)])
def test_apply_rope_matches_jax(pos_shape):
    r = rng(1)
    x = normal(r, (B, 4, S, 16))
    pos = r.integers(0, 5000, pos_shape).astype(np.int32)
    want = JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0)
    got = TL.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 10_000.0)
    np.testing.assert_allclose(as_np(got), as_np(want), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("window", [0, 8])
def test_gqa_prefill_and_decode_match_jax(arch, window):
    jc, tc = _cfgs(arch, "float32")
    p = _np_tree(JL.gqa_init(jax.random.PRNGKey(3), jc))
    if jc.qkv_bias:                     # zeros at init: make them bite
        r = rng(9)
        p = {k: (normal(r, v.shape) if k.startswith("b") else v)
             for k, v in p.items()}
    tp = _t(p)
    r = rng(4)
    x = normal(r, (B, S, jc.d_model))
    jo, jcache = JL.gqa_prefill(p, jc, jnp.asarray(x), window=window,
                                cache_len=S + 2)
    to, tcache = TL.gqa_prefill(tp, tc, torch.from_numpy(x), window=window,
                                cache_len=S + 2)
    np.testing.assert_allclose(as_np(to), as_np(jo), rtol=1e-4, atol=1e-4)
    for k in ("k", "v"):
        np.testing.assert_allclose(as_np(tcache[k]), as_np(jcache[k]),
                                   rtol=1e-4, atol=1e-4)
    for pos in (S, S + 1):
        xt = normal(r, (B, 1, jc.d_model))
        jo, jcache = JL.gqa_decode(p, jc, jnp.asarray(xt), jcache, pos,
                                   window=window)
        to, tcache = TL.gqa_decode(tp, tc, torch.from_numpy(xt), tcache, pos,
                                   window=window)
        np.testing.assert_allclose(as_np(to), as_np(jo), rtol=1e-4,
                                   atol=1e-4)
        for k in ("k", "v"):
            np.testing.assert_allclose(as_np(tcache[k]), as_np(jcache[k]),
                                       rtol=1e-4, atol=1e-4)


def test_mlp_matches_jax():
    p = _np_tree(JL.mlp_init(jax.random.PRNGKey(5), 32, 48, jnp.float32))
    x = normal(rng(6), (B, S, 32))
    np.testing.assert_allclose(as_np(TL.mlp(_t(p), torch.from_numpy(x))),
                               as_np(JL.mlp(p, jnp.asarray(x))), rtol=1e-4,
                               atol=1e-4)


def test_causal_conv_matches_jax():
    r = rng(11)
    x, w, b = normal(r, (B, 9, 24)), normal(r, (4, 24)), normal(r, (24,))
    want = JL._causal_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    got = TL._causal_conv(torch.from_numpy(x), torch.from_numpy(w),
                          torch.from_numpy(b))
    np.testing.assert_allclose(as_np(got), as_np(want), rtol=1e-5, atol=1e-5)


def _mamba2_layer_pair(seed=12):
    jc, tc = _cfgs("mamba2-130m", "float32")
    p = _np_tree(JL.mamba2_init(jax.random.PRNGKey(seed), jc))
    r = rng(seed)           # biases are zeros at init: make them bite
    p = {k: (normal(r, v.shape) if k in ("conv_bx", "conv_bbc", "dt_bias")
             else v) for k, v in p.items()}
    return jc, tc, p, _t(p)


@pytest.mark.parametrize("s", [16, 40, 2])
def test_mamba2_prefill_and_decode_match_jax(s):
    """One chunk, a ragged three (16 + 16 + 8), and a prompt shorter than
    the conv's taps (JAX's cache slice comes out short there, so only the
    output is compared; the port pads its conv cache with zeros, and
    :func:`test_mamba2_decode_after_a_prompt_shorter_than_the_conv` holds
    the decode after it)."""
    jc, tc, p, tp = _mamba2_layer_pair()
    r = rng(13)
    x = normal(r, (B, s, jc.d_model))
    jo, jcache = JL.mamba2_prefill(p, jc, jnp.asarray(x))
    to, tcache = TL.mamba2_prefill(tp, tc, torch.from_numpy(x))
    np.testing.assert_allclose(as_np(to), as_np(jo), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(
        as_np(TL.mamba2_forward(tp, tc, torch.from_numpy(x))),
        as_np(JL.mamba2_forward(p, jc, jnp.asarray(x))), rtol=1e-4,
        atol=1e-4)
    if s < jc.ssm_conv_width - 1:
        assert tuple(tcache["conv_x"].shape) == (B, jc.ssm_conv_width - 1,
                                                 jc.d_inner)
        return
    for step in range(3):
        for k in ("conv_x", "conv_bc", "ssm"):
            np.testing.assert_allclose(as_np(tcache[k]), as_np(jcache[k]),
                                       rtol=1e-4, atol=1e-4, err_msg=k)
        xt = normal(r, (B, 1, jc.d_model))
        jo, jcache = JL.mamba2_decode(p, jc, jnp.asarray(xt), jcache)
        to, tcache = TL.mamba2_decode(tp, tc, torch.from_numpy(xt), tcache)
        np.testing.assert_allclose(as_np(to), as_np(jo), rtol=1e-4,
                                   atol=1e-4)


def test_mamba2_prefill_takes_its_state_from_the_scans_own_call(
        monkeypatch):
    """``mamba2_prefill`` asks its one ``ssd_scan`` call for the final
    state (JAX calls ``ssd_final_state`` after the scan; the port no longer
    does), and ``mamba2_forward`` does not ask; the state is the one
    :func:`test_mamba2_prefill_and_decode_match_jax` holds against JAX."""
    asked, real = [], TL.ssd_scan

    def spy(*args, **kw):
        asked.append(kw.get("return_final_state", False))
        return real(*args, **kw)

    monkeypatch.setattr(TL, "ssd_scan", spy)
    jc, tc, _, tp = _mamba2_layer_pair()
    x = torch.from_numpy(normal(rng(5), (B, 40, jc.d_model)))
    _, cache = TL.mamba2_prefill(tp, tc, x)
    TL.mamba2_forward(tp, tc, x)
    assert asked == [True, False]
    assert not hasattr(TL, "ssd_final_state")
    assert cache["ssm"].dtype == torch.float32 and tuple(
        cache["ssm"].shape) == (B, jc.ssm_heads, jc.ssm_state,
                                jc.ssm_head_dim)


def test_mamba2_decode_after_a_prompt_shorter_than_the_conv():
    """A 2-token prompt (shorter than the conv's 3 cached taps: the port
    pads its conv cache with zeros, JAX's slice comes out short), then 3
    decode steps: the 5 outputs against JAX's full-sequence
    ``mamba2_forward`` on the 5 tokens, at 1e-4 in f32."""
    jc, tc, p, tp = _mamba2_layer_pair()
    x = normal(rng(16), (B, 5, jc.d_model))
    want = as_np(JL.mamba2_forward(p, jc, jnp.asarray(x)))
    xt = torch.from_numpy(x)
    out, cache = TL.mamba2_prefill(tp, tc, xt[:, :2])
    outs = [out]
    for t in range(2, 5):
        out, cache = TL.mamba2_decode(tp, tc, xt[:, t:t + 1], cache)
        outs.append(out)
    np.testing.assert_allclose(as_np(torch.cat(outs, dim=1)), want,
                               rtol=1e-4, atol=1e-4)


def test_mamba2_model_decode_after_a_prompt_shorter_than_the_conv():
    """mamba2-smoke: prefill on 2 tokens, then 3 decode steps fed the
    next tokens; each step's logits against ``repro.models.forward`` on
    the 5 tokens, at 1e-4 in f32."""
    jc, jparams, tc, model = _models("mamba2-130m", "float32")
    tokens, _ = _tokens(jc, seed=17, s=5)
    want = as_np(jmodels.forward(jc, jparams,
                                 {"tokens": jnp.asarray(tokens)}))
    tt = torch.from_numpy(tokens).long()
    logits, cache = TM.prefill(tc, model, {"tokens": tt[:, :2]}, 5)
    got = [logits]
    for t in range(2, 5):
        logits, cache = TM.decode_step(tc, model, cache,
                                       {"token": tt[:, t:t + 1]})
        got.append(logits)
    np.testing.assert_allclose(as_np(torch.cat(got, dim=1)), want[:, 1:],
                               rtol=1e-4, atol=1e-4)


def test_mamba2_init_matches_jax_shapes_and_dtypes():
    for dtype in ("float32", "bfloat16"):
        jc, tc = _cfgs("mamba2-130m", dtype)
        want = JL.mamba2_init(jax.random.PRNGKey(0), jc)
        got = TL.mamba2_init(None, tc, "meta")
        flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
        assert len(flat_w) == 13
        for path, leaf in flat_w:
            keys = [k.key for k in path]
            t = got
            for k in keys:
                t = t[k]
            assert tuple(t.shape) == leaf.shape, keys
            assert str(t.dtype).split(".")[-1] == str(leaf.dtype), keys
        np.testing.assert_allclose(
            as_np(TL.mamba2_init(None, tc, "cpu")["a_log"]),
            as_np(want["a_log"]), rtol=1e-6)


# -------------------------------------------------------------- whole model
def _models(arch, dtype):
    jc, tc = _cfgs(arch, dtype)
    jparams = jmodels.init_params(jc, jax.random.PRNGKey(0))
    return jc, jparams, tc, model_from_numpy(tc, _np_tree(jparams), "cpu")


def _tokens(cfg, seed=7, s=S):
    r = rng(seed)
    return (r.integers(0, cfg.vocab_size, (B, s)).astype(np.int32),
            r.integers(0, cfg.vocab_size, (GEN, B, 1)).astype(np.int32))


def _serve_both(arch, dtype):
    """Prefill + GEN teacher-forced decode steps on both sides; the logits
    of every step and both final caches."""
    jc, jparams, tc, model = _models(arch, dtype)
    s = SEQ.get(arch, S)
    prompts, steps = _tokens(jc, s=s)
    pf = jax.jit(lambda p, b: jmodels.prefill(jc, p, b, s + GEN))
    st = jax.jit(lambda p, c, b: jmodels.decode_step(jc, p, c, b))
    jl, jcache = pf(jparams, {"tokens": jnp.asarray(prompts)})
    tl, tcache = TM.prefill(tc, model, {"tokens": torch.from_numpy(
        prompts).long()}, s + GEN)
    logits = [(jl, tl)]
    for tok in steps:
        jl, jcache = st(jparams, jcache, {"token": jnp.asarray(tok)})
        tl, tcache = TM.decode_step(tc, model, tcache,
                                    {"token": torch.from_numpy(tok).long()})
        logits.append((jl, tl))
    return jc, logits, jcache, tcache


@pytest.mark.parametrize("arch", MODEL_ARCHS)
def test_prefill_decode_match_jax_f32(arch):
    jc, logits, jcache, tcache = _serve_both(arch, "float32")
    for jl, tl in logits:
        assert tuple(tl.shape) == (B, 1, jc.vocab_size)
        assert tl.dtype == torch.float32
        np.testing.assert_allclose(as_np(tl), as_np(jl), rtol=1e-4,
                                   atol=1e-4)
    assert tcache["pos"] == int(jcache["pos"]) == SEQ.get(arch, S) + GEN
    gsz = TM.group_size(jc)
    for layer, c in enumerate(tcache["blocks"]):
        assert set(c) == set(jcache["blocks"])
        for k in c:
            want = jcache["blocks"][k][layer // gsz, layer % gsz]
            np.testing.assert_allclose(as_np(c[k]), as_np(want), rtol=1e-4,
                                       atol=1e-4)


@pytest.mark.parametrize("arch", MODEL_ARCHS)
def test_prefill_decode_match_jax_bf16(arch):
    _, logits, _, _ = _serve_both(arch, "bfloat16")
    for jl, tl in logits:
        want, got = as_np(jl), as_np(tl)
        assert np.all(np.isfinite(got))
        bound = 0.02 * (np.abs(want).max() + 1.0)
        assert np.abs(got - want).max() < bound


@pytest.mark.parametrize("arch", MODEL_ARCHS)
def test_forward_matches_jax_f32(arch):
    jc, jparams, tc, model = _models(arch, "float32")
    s = SEQ.get(arch, S)
    prompts, _ = _tokens(jc, seed=8, s=s)
    want = jmodels.forward(jc, jparams, {"tokens": jnp.asarray(prompts)})
    got = TM.forward(tc, model, {"tokens": torch.from_numpy(prompts).long()})
    assert tuple(got.shape) == (B, s, jc.vocab_size)
    np.testing.assert_allclose(as_np(got), as_np(want), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch", ["gemma2-2b", "mamba2-130m"])
def test_unembed_gives_f32_logits_of_bf16_products(arch):
    """JAX's unembedding asks its dot for an f32 result
    (``preferred_element_type``): the logits of bf16 activations and
    weights are not rounded to bf16.  At 1e-3 of the largest logit the
    port must agree; logits rounded to bf16 (2^-9 relative) do not."""
    jc, jparams, tc, model = _models(arch, "bfloat16")
    x = jnp.asarray(normal(rng(14), (B, S, jc.d_model)), jnp.bfloat16)
    want = as_np(JM.unembed(jc, jparams, x, JL.no_shard))
    got = model.unembed(torch.tensor(np.asarray(
        x.astype(jnp.float32))).bfloat16())
    assert got.dtype == torch.float32
    tol = 1e-3 * np.abs(want).max()
    np.testing.assert_allclose(as_np(got), want, rtol=0, atol=tol)
    rounded = want.astype(jnp.bfloat16).astype(np.float32)
    assert np.abs(rounded - want).max() > tol


def test_cpu_model_never_launches_the_kernel():
    _, _, tc, model = _models("gemma2-2b", "float32")
    prompts, steps = _tokens(tc)
    before = flash_ops.LAUNCHES
    _, cache = TM.prefill(tc, model, {"tokens": torch.from_numpy(
        prompts).long()}, S + 1)
    TM.decode_step(tc, model, cache, {"token": torch.from_numpy(
        steps[0]).long()})
    assert flash_ops.LAUNCHES == before


def test_init_cache_then_decode_matches_jax_f32():
    """Decoding from an empty cache (no prefill), as JAX's ``init_cache``."""
    jc, jparams, tc, model = _models("gemma2-2b", "float32")
    _, steps = _tokens(jc, seed=10)
    jcache = jmodels.init_cache(jc, B, GEN)
    tcache = TM.init_cache(tc, B, GEN, device="cpu")
    for tok in steps:
        jl, jcache = jmodels.decode_step(jc, jparams, jcache,
                                         {"token": jnp.asarray(tok)})
        tl, tcache = TM.decode_step(tc, model, tcache,
                                    {"token": torch.from_numpy(tok).long()})
        np.testing.assert_allclose(as_np(tl), as_np(jl), rtol=1e-4,
                                   atol=1e-4)


def test_cpu_mamba2_never_launches_the_kernel():
    _, _, tc, model = _models("mamba2-130m", "float32")
    prompts, steps = _tokens(tc, s=SEQ["mamba2-130m"])
    before = ssd_ops.LAUNCHES
    _, cache = TM.prefill(tc, model, {"tokens": torch.from_numpy(
        prompts).long()}, 1)
    TM.decode_step(tc, model, cache, {"token": torch.from_numpy(
        steps[0]).long()})
    assert ssd_ops.LAUNCHES == before


def test_mamba2_init_cache_then_decode_matches_jax_f32():
    """Decoding from an empty Mamba cache (no prefill), as JAX's
    ``init_cache``."""
    jc, jparams, tc, model = _models("mamba2-130m", "float32")
    _, steps = _tokens(jc, seed=15)
    jcache = jmodels.init_cache(jc, B, GEN)
    tcache = TM.init_cache(tc, B, GEN, device="cpu")
    for tok in steps:
        jl, jcache = jmodels.decode_step(jc, jparams, jcache,
                                         {"token": jnp.asarray(tok)})
        tl, tcache = TM.decode_step(tc, model, tcache,
                                    {"token": torch.from_numpy(tok).long()})
        np.testing.assert_allclose(as_np(tl), as_np(jl), rtol=1e-4,
                                   atol=1e-4)


def test_dense_generate_is_prefill_then_greedy_decode():
    """The ``--dense-oracle`` loop: its prefill logits are the prefill's,
    its tokens the greedy continuation, its launches 0 on the CPU."""
    from repro_torch.launch.serve import dense_generate
    _, _, tc, model = _models("gemma2-2b", "float32")
    prompts = torch.from_numpy(_tokens(tc)[0]).long()
    before = flash_ops.LAUNCHES
    run = dense_generate(tc, model, prompts, GEN)
    assert flash_ops.LAUNCHES == before
    logits, cache = TM.prefill(tc, model, {"tokens": prompts}, S + GEN)
    np.testing.assert_array_equal(as_np(run.prefill_logits), as_np(logits))
    tok = logits.argmax(-1)
    for t in range(GEN):
        logits, cache = TM.decode_step(tc, model, cache, {"token": tok})
        if t == 0:
            np.testing.assert_array_equal(as_np(run.first_decode_logits),
                                          as_np(logits))
        tok = logits.argmax(-1)
        assert torch.equal(run.tokens[:, t:t + 1], tok)


# ------------------------------------------------------------------ weights
def test_model_from_numpy_rejects_trees_that_do_not_fit():
    jc, tc = _cfgs("qwen2-7b", "float32")
    tree = _np_tree(jmodels.init_params(jc, jax.random.PRNGKey(0)))
    missing = {k: v for k, v in tree.items() if k != "lm_head"}
    with pytest.raises(ValueError, match="no leaf lm_head/w"):
        model_from_numpy(tc, missing, "cpu")
    extra = {**tree, "shared": {"w": np.zeros((2, 2), np.float32)}}
    with pytest.raises(ValueError, match="shared/w"):
        model_from_numpy(tc, extra, "cpu")
    bad = {**tree, "final_norm": {"scale": np.ones((3,), np.float32)}}
    with pytest.raises(ValueError, match="does not fit"):
        model_from_numpy(tc, bad, "cpu")
    flat = dict(tree)
    flat["blocks"] = jax.tree.map(lambda a: a[0], tree["blocks"])
    with pytest.raises(ValueError, match="does not fit"):
        model_from_numpy(tc, flat, "cpu")


def test_model_from_numpy_rejects_ssm_trees_that_do_not_fit():
    """The ssm tree (``blocks/ln/scale``, ``blocks/mix/norm/scale``, …,
    stacked (G, 1, …)) keeps the exact-leaf check."""
    jc, tc = _cfgs("mamba2-130m", "float32")
    tree = _np_tree(jmodels.init_params(jc, jax.random.PRNGKey(0)))
    mix = dict(tree["blocks"]["mix"])
    del mix["norm"]
    with pytest.raises(ValueError, match="no leaf blocks/mix/norm/scale"):
        model_from_numpy(tc, {**tree, "blocks": {**tree["blocks"],
                                                 "mix": mix}}, "cpu")
    extra = dict(tree["blocks"]["mix"], w_q=np.zeros((2, 1, 2), np.float32))
    with pytest.raises(ValueError, match="blocks/mix/w_q"):
        model_from_numpy(tc, {**tree, "blocks": {**tree["blocks"],
                                                 "mix": extra}}, "cpu")
    bad = dict(tree["blocks"]["mix"], a_log=tree["blocks"]["mix"]["a_log"]
               [..., :3])
    with pytest.raises(ValueError, match="does not fit"):
        model_from_numpy(tc, {**tree, "blocks": {**tree["blocks"],
                                                 "mix": bad}}, "cpu")
