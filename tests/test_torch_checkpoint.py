"""Port parity: the checkpoint store (``repro_torch.checkpoint``) and the
trainer's use of it (``TraTrainer(store=...)``, ``fit``).

* The counterparts of ``tests/test_robustness.py``'s checkpoint cases: a
  run killed mid-``fit`` by an injected ``SimulatedFailure`` recovers from
  the last committed step, and a fresh trainer on a fresh engine resumes
  to the end, the whole trajectory and the final parameters and moments
  against JAX's uninterrupted run at 1e-5 and against the port's own
  uninterrupted run to the bit; resume on an empty store; a failure
  before the first periodic checkpoint; no recovery without a store; a
  failed background write that surfaces at the next ``wait()``.
* Atomicity: a leftover ``.tmp`` and a step without ``COMMIT`` are
  ignored, ``keep`` is honoured, a restore refuses a tree token, a leaf
  count, a shape or a dtype that differs, and an empty store raises
  ``FileNotFoundError``.
* ``treedef_token`` against ``str(jax.tree_util.tree_structure(...))``.
* Carry-across both ways: JAX's ``TraTrainer`` with JAX's
  ``CheckpointStore`` writes step 2 and the port's trainer resumes it to
  step 4; the port writes and JAX resumes; each continuation against
  JAX's uninterrupted run at 1e-5.

The JAX runs (one engine, one compile of the step) are made once per
module; JAX's checkpoints go to a directory of pytest's ``tmp_path_factory``.
"""
import functools
import json
import os

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

import repro_torch.core as tcore  # noqa: E402
from _torch_helpers import CPU  # noqa: E402
from repro_torch.checkpoint import CheckpointStore, treedef_token  # noqa: E402,E501
from repro_torch.core.faults import FaultInjector, SimulatedFailure  # noqa: E402,E501
from repro_torch.core.programs import ffnn_train_step_tra  # noqa: E402

DIMS = (4, 2, 2, 2, 4, 4, 4, 2)         # tests/test_robustness.py's
LR = 1e-2


@functools.lru_cache(maxsize=1)
def _dense():
    """X, Y, W1, W2 as numpy, drawn once from a seed."""
    nb, db, hb, lb, bn, bd, bh, bl = DIMS
    r = np.random.default_rng(0)
    x = r.standard_normal((nb * bn, db * bd)).astype(np.float32)
    wt = (r.standard_normal((db * bd, lb * bl)) * 0.5).astype(np.float32)
    y = (1.0 / (1.0 + np.exp(-(x @ wt)))).astype(np.float32)
    w1 = (r.standard_normal((db * bd, hb * bh)) * 0.3).astype(np.float32)
    w2 = (r.standard_normal((hb * bh, lb * bl)) * 0.3).astype(np.float32)
    return {"X": x, "Y": y, "W1": w1, "W2": w2}


def _tiles():
    _, _, _, _, bn, bd, bh, bl = DIMS
    return {"X": (bn, bd), "Y": (bn, bl), "W1": (bd, bh), "W2": (bh, bl)}


def _port_rels():
    d, t = _dense(), _tiles()
    return {k: tcore.from_tensor(torch.from_numpy(d[k].copy()), t[k])
            for k in d}


def _port_trainer(engine=None, **kw):
    rels = _port_rels()
    engine = engine or tcore.Engine(executor="jit", device=CPU)
    tr = tcore.TraTrainer(engine, ffnn_train_step_tra(
        *DIMS, optimizer=tcore.AdamW(LR)),
        params={k: rels[k] for k in ("W1", "W2")}, **kw)
    return tr, {k: rels[k] for k in ("X", "Y")}


@functools.lru_cache(maxsize=1)
def _oracle():
    """The port's uninterrupted 8-step run: losses, final params/state."""
    tr, data = _port_trainer()
    h = tr.fit(8, **data)
    return list(h), {k: r.data.clone() for k, r in
                     {**tr.params, **tr.state}.items()}


# ==========================================================================
# kill, recover, resume (tests/test_robustness.py's cases)
# ==========================================================================

def _assert_matches_jax(history, rels, jax_history, jax_final):
    """Losses and the final parameters and moments against JAX's run of
    as many steps, at 1e-5."""
    np.testing.assert_allclose(history, jax_history, atol=1e-5)
    for k, r in rels.items():
        np.testing.assert_allclose(r.data.numpy(), jax_final[k], atol=1e-5,
                                   err_msg=k)


def test_kill_midrun_resumes_and_matches_oracle(tmp_path, jax_run):
    """A SimulatedFailure at run 5 recovers from the last committed step;
    a fresh trainer on a fresh engine resumes to 8 steps: the trajectory
    and the final parameters and moments equal JAX's uninterrupted run's
    at 1e-5, and the port's own uninterrupted run's to the bit."""
    oracle, final = _oracle()
    jax_history = jax_run["history"]
    store = CheckpointStore(str(tmp_path / "ckpt"), keep=5)
    inj = FaultInjector().inject_site_failure(step=5)
    tr, data = _port_trainer(tcore.Engine(executor="jit", device=CPU,
                                          fault_injector=inj), store=store)
    h = tr.fit(6, ckpt_every=2, **data)
    assert inj.log == [("site", "run 5")]
    assert len(h) == 6 and tr.step_count == 6
    np.testing.assert_allclose(h, jax_history[:6], atol=1e-5)
    assert h == oracle[:6]
    assert store.committed_steps() == [0, 2, 4, 6]

    tr2, data = _port_trainer(store=store)
    h2 = tr2.fit(8, resume=True, **data)
    assert tr2.step_count == 8
    _assert_matches_jax(h2, {**tr2.params, **tr2.state}, jax_history,
                        jax_run["final"][8])
    assert h2 == oracle
    for k, r in {**tr2.params, **tr2.state}.items():
        assert torch.equal(r.data, final[k]), k


def test_resume_on_empty_store_starts_fresh(tmp_path, jax_run):
    store = CheckpointStore(str(tmp_path / "ckpt"))
    tr, data = _port_trainer(store=store)
    h = tr.fit(4, resume=True, ckpt_every=3, **data)
    assert len(h) == 4 and tr.step_count == 4
    assert store.committed_steps() == [0, 3]
    _assert_matches_jax(h, {**tr.params, **tr.state},
                        jax_run["history"][:4], jax_run["final"][4])
    assert h == _oracle()[0][:4]


def test_failure_before_first_periodic_checkpoint_recovers(tmp_path,
                                                          jax_run):
    """fit commits the initial state, so a kill before the first periodic
    snapshot restores to step 0 instead of crashing unrecoverably."""
    store = CheckpointStore(str(tmp_path / "ckpt"))
    inj = FaultInjector().inject_site_failure(step=1)
    tr, data = _port_trainer(tcore.Engine(executor="jit", device=CPU,
                                          fault_injector=inj), store=store)
    h = tr.fit(4, ckpt_every=10, **data)
    assert inj.log == [("site", "run 1")]
    assert store.committed_steps() == [0]
    _assert_matches_jax(h, {**tr.params, **tr.state},
                        jax_run["history"][:4], jax_run["final"][4])
    assert h == _oracle()[0][:4]


def test_unrecoverable_without_store():
    inj = FaultInjector().inject_site_failure(step=1)
    tr, data = _port_trainer(tcore.Engine(executor="jit", device=CPU,
                                          fault_injector=inj))
    with pytest.raises(SimulatedFailure):
        tr.fit(4, **data)


def test_store_async_write_failure_surfaces(tmp_path, monkeypatch):
    """A failed background write raises on the next wait()/save_async(),
    never silently swallowed; once raised, the store is usable again."""
    store = CheckpointStore(str(tmp_path / "ckpt"))

    def boom(step, leaves, treedef, extra):
        raise OSError("injected I/O error: disk full")

    monkeypatch.setattr(store, "_write", boom)
    store.save_async(1, {"w": np.zeros(3)})
    with pytest.raises(OSError, match="disk full"):
        store.wait()
    store.save_async(2, {"w": np.zeros(3)})
    with pytest.raises(OSError, match="disk full"):
        store.save_async(3, {"w": np.zeros(3)})
    monkeypatch.undo()
    store.save_async(4, {"w": np.zeros(3)})
    store.wait()
    assert store.committed_steps() == [4]


def test_recovery_surfaces_a_failed_write(tmp_path, monkeypatch):
    """A recovery waits for the pending write first: its failure raises
    out of ``fit`` instead of a restore from a stale step."""
    store = CheckpointStore(str(tmp_path / "ckpt"))
    inj = FaultInjector().inject_site_failure(step=3)
    tr, data = _port_trainer(tcore.Engine(executor="jit", device=CPU,
                                          fault_injector=inj), store=store)
    real = store._write

    def write(step, *a):
        if step == 2:
            raise OSError("injected I/O error at step 2")
        return real(step, *a)

    monkeypatch.setattr(store, "_write", write)
    with pytest.raises(OSError, match="step 2"):
        tr.fit(4, ckpt_every=2, **data)


def test_trainer_without_store_refuses_checkpoints():
    tr, data = _port_trainer()
    with pytest.raises(ValueError, match="no CheckpointStore"):
        tr.save_checkpoint()
    with pytest.raises(ValueError, match="no CheckpointStore"):
        tr.restore_checkpoint()
    for kw in ({"ckpt_every": 1}, {"resume": True}):
        with pytest.raises(ValueError, match="needs a store"):
            tr.fit(2, **kw, **data)


def test_restore_builds_the_programs_relations_on_the_engine(tmp_path):
    """A restore gives relations of the program's rtypes on the engine's
    device, fresh tensors that alias neither the checkpoint's arrays nor
    the trainer's earlier outputs."""
    store = CheckpointStore(str(tmp_path / "ckpt"))
    tr, data = _port_trainer(store=store)
    tr.fit(2, ckpt_every=2, **data)
    before = {k: r for k, r in {**tr.params, **tr.state}.items()}
    tr.fit(3, **data)
    assert tr.restore_checkpoint(step=2) == 2
    assert tr.history == _oracle()[0][:2]
    for k, r in {**tr.params, **tr.state}.items():
        assert r.rtype == before[k].rtype and r.data.device == CPU
        assert torch.equal(r.data, before[k].data)
        assert r.data.data_ptr() != before[k].data.data_ptr()


# ==========================================================================
# the store: atomicity, versions, refusals
# ==========================================================================

def _tree(seed=0, n=5):
    r = np.random.default_rng(seed)
    return {"params": {"W1": torch.from_numpy(
                r.standard_normal((2, 3, n)).astype(np.float32))},
            "state": {"opt.step": torch.ones(1, 1, 1)}}


def test_leftover_tmp_and_uncommitted_steps_are_ignored(tmp_path):
    store = CheckpointStore(str(tmp_path))
    store.save(3, _tree())
    os.makedirs(tmp_path / "step_000000009.tmp")
    os.makedirs(tmp_path / "step_000000007")           # no COMMIT
    with open(tmp_path / "step_000000007" / "meta.json", "w") as f:
        json.dump({"step": 7}, f)
    assert store.committed_steps() == [3]
    tree, _ = store.restore(_tree(1))
    assert torch.equal(torch.from_numpy(tree["params"]["W1"]),
                       _tree()["params"]["W1"])
    # a save over a stale staging directory replaces it
    store.save(9, _tree(2))
    assert store.committed_steps() == [3, 9]
    assert not os.path.exists(tmp_path / "step_000000009.tmp")


def test_keep_retains_the_latest_committed_steps(tmp_path):
    store = CheckpointStore(str(tmp_path), keep=2)
    for step in (0, 2, 4, 6):
        store.save_async(step, _tree(step), {"step_count": step})
    store.wait()
    assert store.committed_steps() == [4, 6] and store.latest_step() == 6
    assert sorted(os.listdir(tmp_path)) == ["step_000000004",
                                            "step_000000006"]
    _, extra = store.restore(_tree())
    assert extra == {"step_count": 6}


def test_layout_is_jax_s(tmp_path):
    store = CheckpointStore(str(tmp_path))
    path = store.save(12, _tree(), {"history": [1.5]})
    assert os.path.basename(path) == "step_000000012"
    assert sorted(os.listdir(path)) == ["COMMIT", "meta.json",
                                        "shard_00000.npz"]
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    assert meta == {"step": 12, "n_leaves": 2, "treedef": treedef_token(
        _tree()), "extra": {"history": [1.5]}}
    with np.load(os.path.join(path, "shard_00000.npz")) as data:
        assert sorted(data.files) == ["leaf_0", "leaf_1"]
        assert data["leaf_0"].dtype == np.float32


def test_restore_of_an_empty_store_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match="no committed checkpoint"):
        CheckpointStore(str(tmp_path)).restore(_tree())


@pytest.mark.parametrize("like,match", [
    ({"params": {"W1": torch.zeros(2, 3, 5)}}, "tree structure"),
    ({"params": {"W1": torch.zeros(2, 3, 6)},
      "state": {"opt.step": torch.zeros(1, 1, 1)}}, "shape and dtype"),
    ({"params": {"W1": torch.zeros(2, 3, 5, dtype=torch.float64)},
      "state": {"opt.step": torch.zeros(1, 1, 1)}}, "shape and dtype"),
    ({"params": {"W1": torch.zeros(2, 3, 5)},
      "state": {"opt.step": torch.zeros(1, 1, 1), "x": torch.zeros(1)}},
     "tree structure"),
])
def test_restore_refuses_another_tree(tmp_path, like, match):
    store = CheckpointStore(str(tmp_path))
    store.save(1, _tree())
    with pytest.raises(ValueError, match=match):
        store.restore(like)


def test_restore_refuses_a_leaf_count_that_differs(tmp_path):
    store = CheckpointStore(str(tmp_path))
    path = store.save(1, _tree())
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    meta["n_leaves"] = 3
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump(meta, f)
    with pytest.raises(ValueError, match="3 leaves, expected 2"):
        store.restore(_tree())


def test_snapshot_is_taken_before_save_async_returns(tmp_path):
    """JAX's "snapshot now" contract: the tensors may change at once; the
    host buffers are allocated once and reused by the next save."""
    store = CheckpointStore(str(tmp_path))
    tree = _tree()
    want = tree["params"]["W1"].clone()
    store.save_async(1, tree)
    tree["params"]["W1"].add_(1.0)
    buffers = [id(b) for b in store._buffers]
    store.save_async(2, tree)
    assert [id(b) for b in store._buffers] == buffers
    store.wait()
    got, _ = store.restore(tree, step=1)
    assert torch.equal(torch.from_numpy(got["params"]["W1"]), want)
    got, _ = store.restore(tree, step=2)
    assert torch.equal(torch.from_numpy(got["params"]["W1"]), want + 1.0)


def test_stats_record_each_save(tmp_path):
    """One stall and one snapshot a save, one write a committed step."""
    store = CheckpointStore(str(tmp_path))
    store.save(0, _tree())
    store.save_async(2, _tree())
    store.save_async(4, _tree())
    store.wait()
    st = store.stats
    assert len(st.stall_s) == len(st.snapshot_s) == 3
    assert [step for step, _ in st.write_s] == [0, 2, 4]
    assert all(s >= 0.0 for s in st.stall_s + st.snapshot_s
               + [s for _, s in st.write_s])


TREES = {
    "trainer": lambda: {"params": {"W2": 0, "W1": 0},
                        "state": {"opt.step": 0, "W1.m": 0, "W1.v": 0}},
    "flat": lambda: {"w": np.zeros(3)},
    "nested": lambda: [1, (2, 3), {"a": 1}],
    "empty": lambda: {},
    "empty-child": lambda: {"a": {}},
    "single-tuple": lambda: (1,),
    "mixed-keys": lambda: {"b": 1, "a": [1]},
}


@pytest.mark.parametrize("name", sorted(TREES))
def test_treedef_token_equals_jax(name):
    import jax
    tree = TREES[name]()
    assert treedef_token(tree) == str(jax.tree_util.tree_structure(tree))


# ==========================================================================
# carry-across: JAX writes, the port resumes; the port writes, JAX resumes
# ==========================================================================

@functools.lru_cache(maxsize=1)
def _jax_side():
    """One JAX engine and the step program's parameters and data."""
    import jax.numpy as jnp

    import repro.core as jcore
    from repro.core.programs import ffnn_train_step_tra as jstep
    d, t = _dense(), _tiles()
    rels = {k: jcore.from_tensor(jnp.asarray(d[k]), t[k]) for k in d}
    eng = jcore.Engine(executor="jit", validate="off")

    def trainer(**kw):
        return jcore.TraTrainer(eng, jstep(*DIMS,
                                           optimizer=jcore.AdamW(LR)),
                                params={k: rels[k] for k in ("W1", "W2")},
                                **kw)

    return trainer, {k: rels[k] for k in ("X", "Y")}


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """JAX's uninterrupted run: 4 steps checkpointed every 2 into a
    directory of its own, then on to 8 without a store.  ``base`` is the
    directory, ``history`` the 8 losses, ``final`` the params and state
    after steps 4 and 8."""
    from repro.checkpoint import CheckpointStore as JStore
    trainer, data = _jax_side()
    tr = trainer()
    base = str(tmp_path_factory.mktemp("jax_ckpt"))

    def final():
        return {k: np.asarray(r.data) for k, r in
                {**tr.params, **tr.state}.items()}

    tr.fit(4, store=JStore(base, keep=5), ckpt_every=2, **data)
    at4 = final()
    h = tr.fit(8, **data)
    return {"base": base, "history": list(h), "final": {4: at4, 8: final()}}


def test_port_resumes_a_jax_checkpoint(jax_run):
    history, final = jax_run["history"][:4], jax_run["final"][4]
    store = CheckpointStore(jax_run["base"])
    assert store.committed_steps() == [0, 2, 4]
    tr, data = _port_trainer(store=store)
    assert tr.restore_checkpoint(step=2) == 2
    np.testing.assert_array_equal(tr.history, history[:2])
    h = tr.fit(4, **data)
    _assert_matches_jax(h, {**tr.params, **tr.state}, history, final)


def test_jax_resumes_a_port_checkpoint(tmp_path, jax_run):
    from repro.checkpoint import CheckpointStore as JStore
    history, final = jax_run["history"][:4], jax_run["final"][4]
    tr, data = _port_trainer(store=CheckpointStore(str(tmp_path)))
    tr.fit(2, ckpt_every=2, **data)
    trainer, jdata = _jax_side()
    jtr = trainer(store=JStore(str(tmp_path)))
    assert jtr.restore_checkpoint(step=2) == 2
    h = jtr.fit(4, **jdata)
    np.testing.assert_allclose(h, history, atol=1e-5)
    for k, r in {**jtr.params, **jtr.state}.items():
        np.testing.assert_allclose(np.asarray(r.data), final[k], atol=1e-5,
                                   err_msg=k)
