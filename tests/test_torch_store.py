"""Port parity: the host relation store tier (``repro_torch.store``).

Mirrors ``tests/test_store.py`` case for case, each held against
``repro.store`` on the same numpy inputs:

* ``RelationStore.put`` / ``get`` / ``slice`` round-trips across block
  boundaries (the same block partition as JAX's), and ``create`` +
  ``append`` growing the key frontier;
* the LRU disk-spill tier under ``ram_limit_bytes`` with the same
  counters as JAX's store, atomic checksummed spill files, and a bf16
  block (raw bytes) through a spill;
* ``HostRelation`` handles through ``Engine.run`` (materialized resident)
  on ``reference`` and ``jit``, at JAX's values;
* the ``chunk="auto"`` ladder (env override, the CPU's ``None``, the
  static default) and the engine's ``chunk`` / ``memory_budget`` checks;
* ``plan_peak_bytes`` equal to JAX's on every program of
  ``core/programs.py``.

Blocks are page-locked only where a card is present; the ``gpu`` tests of
``tests/test_torch_kernels_gpu.py`` hold that.
"""
import os

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

import repro.core as jtra  # noqa: E402
import repro.store as jstore  # noqa: E402
import repro_torch.core as ttra  # noqa: E402
import repro_torch.store as tstore  # noqa: E402
from _torch_helpers import CPU, as_np  # noqa: E402
from repro.core import programs as jprog  # noqa: E402
from repro.core.cost import plan_peak_bytes as jpeak  # noqa: E402
from repro_torch.core import programs as tprog  # noqa: E402
from repro_torch.core.cost import plan_peak_bytes as tpeak  # noqa: E402
from repro_torch.store.autotune import ENV_BUDGET  # noqa: E402


def _data(seed, key_shape, bound):
    r = np.random.default_rng(seed)
    return np.asarray(r.normal(size=tuple(key_shape) + tuple(bound)),
                      np.float32)


def _pair(seed, key_shape, bound):
    """The same relation as a JAX and a port ``TensorRelation``."""
    d = _data(seed, key_shape, bound)
    return (jtra.TensorRelation(d, jtra.RelType(key_shape, bound)),
            ttra.TensorRelation(torch.from_numpy(d.copy()),
                                ttra.RelType(key_shape, bound)))


def _blocks(hr):
    return [(b.start, b.stop) for b in hr._blocks]


# ==========================================================================
# Blocks: put / slice / append round-trips
# ==========================================================================

def test_put_get_slice_roundtrip_across_blocks():
    jr, tr = _pair(0, (16, 2), (8, 4))
    blk = 3 * 2 * 8 * 4 * 4
    js, ts = jstore.RelationStore(block_bytes=blk), \
        tstore.RelationStore(block_bytes=blk)
    jh, th = js.put("R", jr), ts.put("R", tr)
    assert ts.get("R") is th and "R" in ts
    assert th.complete and th.nkeys == 16
    assert len(th._blocks) > 3 and _blocks(th) == _blocks(jh)
    full = as_np(tr)
    np.testing.assert_array_equal(th.to_numpy(), full)
    for lo, hi in [(0, 1), (2, 7), (5, 16), (15, 16)]:
        np.testing.assert_array_equal(th.slice(lo, hi).numpy(),
                                      jh.slice(lo, hi))
    assert not ts.pin_memory            # no card: blocks stay pageable


def test_create_append_frontier_and_errors():
    rt = ttra.RelType((6, 2), (4, 4))
    store = tstore.RelationStore()
    hr = store.create("O", rt)
    assert hr.frontier == 0 and not hr.complete
    data = np.arange(6 * 2 * 4 * 4, dtype=np.float32).reshape(6, 2, 4, 4)
    hr.append(data[:2])
    hr.append(torch.from_numpy(data[2:5]))
    assert hr.frontier == 5 and not hr.complete
    with pytest.raises(tstore.StoreError, match="incomplete"):
        hr.to_numpy()
    with pytest.raises(tstore.StoreError, match="exceeds"):
        hr.append(data[:2])             # 5 + 2 > 6 keys
    with pytest.raises(tstore.StoreError, match="shape"):
        hr.append(np.zeros((1, 3, 4, 4), np.float32))
    hr.append(data[5:6])
    assert hr.complete
    np.testing.assert_array_equal(hr.to_numpy(), data)
    hr2 = store.create("O", rt)
    assert store.get("O") is hr2 and hr2.frontier == 0


def test_put_raw_array_requires_rtype():
    store = tstore.RelationStore()
    with pytest.raises(tstore.StoreError, match="rtype"):
        store.put("X", np.zeros((2, 2, 4, 4), np.float32))
    rt = ttra.RelType((2, 2), (4, 4))
    hr = store.put("X", np.zeros((2, 2, 4, 4), np.float32), rtype=rt)
    assert hr.complete
    with pytest.raises(tstore.StoreError, match="dense"):
        store.put("Y", np.zeros((3, 2, 4, 4), np.float32), rtype=rt)


# ==========================================================================
# Disk spill tier (LRU, transparent fault-in)
# ==========================================================================

def _counters(store):
    return (store.spill_events, store.spill_bytes, store.unspill_events,
            store.unspill_bytes, store.ram_bytes)


def test_spill_and_faultin_roundtrip(tmp_path):
    jr, tr = _pair(1, (16, 1), (8, 8))
    blk = 2 * 1 * 8 * 8 * 4             # 2 keys per block
    kw = {"ram_limit_bytes": 3 * blk, "block_bytes": blk}
    js = jstore.RelationStore(spill_dir=str(tmp_path / "j"), **kw)
    ts = tstore.RelationStore(spill_dir=str(tmp_path / "t"), **kw)
    jh, th = js.put("R", jr), ts.put("R", tr)
    assert ts.spill_events > 0 and ts.ram_bytes <= 3 * blk
    assert _counters(ts) == _counters(js)
    spilled = [b for b in th._blocks if b.data is None]
    assert spilled and all(b.path for b in spilled)
    np.testing.assert_array_equal(th.to_numpy(), jh.to_numpy())
    assert ts.unspill_events > 0 and ts.ram_bytes <= 3 * blk
    assert _counters(ts) == _counters(js)
    ts.delete("R")
    assert ts.ram_bytes == 0 and "R" not in ts


def test_no_limit_never_spills():
    store = tstore.RelationStore()
    store.put("R", _pair(2, (8, 1), (8, 8))[1])
    assert store.spill_events == 0 and store.ram_bytes > 0


def test_bf16_block_spills_and_faults_in_as_raw_bytes(tmp_path):
    data = torch.from_numpy(_data(3, (8, 1), (4, 4))).to(torch.bfloat16)
    rt = ttra.RelType((8, 1), (4, 4), torch.bfloat16)
    blk = 2 * 4 * 4 * 2
    store = tstore.RelationStore(ram_limit_bytes=blk, block_bytes=blk,
                                 spill_dir=str(tmp_path))
    hr = store.put("R", data, rtype=rt)
    assert store.spill_events > 0
    assert torch.equal(hr.to_tensor(), data)


def _spilled_store(tmp_path):
    tr = _pair(5, (16, 1), (8, 8))[1]
    blk = 2 * 1 * 8 * 8 * 4
    store = tstore.RelationStore(ram_limit_bytes=3 * blk,
                                 spill_dir=str(tmp_path), block_bytes=blk)
    hr = store.put("R", tr)
    spilled = [b for b in hr._blocks if b.data is None]
    assert spilled
    return store, hr, spilled[0]


def test_spill_is_atomic_and_checksummed(tmp_path):
    _, hr, blk = _spilled_store(tmp_path)
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]
    assert blk.checksum is not None


def test_truncated_spill_file_raises_spill_corruption(tmp_path):
    _, hr, blk = _spilled_store(tmp_path)
    size = os.path.getsize(blk.path)
    with open(blk.path, "r+b") as f:     # torn write: drop the tail
        f.truncate(size // 2)
    with pytest.raises(tstore.SpillCorruption):
        hr.slice(blk.start, blk.stop)


def test_bitflipped_spill_file_fails_checksum(tmp_path):
    _, hr, blk = _spilled_store(tmp_path)
    with open(blk.path, "r+b") as f:     # same size, corrupted payload
        f.seek(os.path.getsize(blk.path) - 5)
        byte = f.read(1)
        f.seek(-1, os.SEEK_CUR)
        f.write(bytes([byte[0] ^ 0xFF]))
    with pytest.raises(tstore.SpillCorruption, match="checksum"):
        hr.slice(blk.start, blk.stop)


def test_intact_spill_faults_in_after_verification(tmp_path):
    _, hr, blk = _spilled_store(tmp_path)
    out = hr.slice(blk.start, blk.stop)
    assert out.shape[0] == blk.stop - blk.start


# ==========================================================================
# HostRelation handles through Engine.run (resident materialization)
# ==========================================================================

def _matmul(mod):
    a = mod.input("A", key_shape=(4, 2), bound=(4, 4))
    b = mod.input("B", key_shape=(2, 3), bound=(4, 4))
    return a @ b


@pytest.mark.parametrize("executor", ["reference", "jit"])
def test_host_relation_accepted_by_engine_run(executor):
    (ja, ta), (jb, tb) = _pair(3, (4, 2), (4, 4)), _pair(4, (2, 3), (4, 4))
    want = jtra.Engine(executor=executor).run(
        _matmul(jtra), A=jstore.RelationStore().put("A", ja), B=jb)
    got = ttra.Engine(executor=executor, device=CPU).run(
        _matmul(ttra), A=tstore.RelationStore().put("A", ta), B=tb)
    np.testing.assert_allclose(as_np(got), as_np(want), atol=1e-5,
                               rtol=1e-5)


def test_host_relation_to_relation_defaults_to_the_card(monkeypatch):
    """``HostRelation.to_relation()`` puts the relation on the card, as
    JAX's puts it on the default device: without a card the default
    raises (no silent CPU fallback); ``device="cpu"`` keeps it on the
    host, at the stored values."""
    ta = _pair(3, (4, 2), (4, 4))[1]
    hr = tstore.RelationStore().put("A", ta)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        hr.to_relation()
    got = hr.to_relation(device="cpu")
    assert got.data.device.type == "cpu"
    np.testing.assert_array_equal(as_np(got), as_np(ta))


def test_host_relation_type_mismatch_rejected():
    store = tstore.RelationStore()
    wrong = store.put("A", _pair(5, (2, 3), (4, 4))[1])
    with pytest.raises(ValueError, match="host relation type"):
        ttra.Engine(executor="jit", device=CPU).run(
            _matmul(ttra), A=wrong, B=_pair(4, (2, 3), (4, 4))[1])


# ==========================================================================
# Autotune ladder + engine configuration validation
# ==========================================================================

def test_device_budget_env_override(monkeypatch):
    monkeypatch.setenv(ENV_BUDGET, str(123 * 1024 * 1024))
    assert tstore.device_memory_budget() == 123 * 1024 * 1024 \
        == jstore.device_memory_budget()
    assert tstore.stream_budget_bytes() == jstore.stream_budget_bytes()
    assert 0 < tstore.stream_budget_bytes() < 123 * 1024 * 1024
    monkeypatch.delenv(ENV_BUDGET)
    assert tstore.stream_budget_bytes(4096) == 4096
    # the CPU reports no memory, as JAX's CPU backend does: the static
    # default remains
    assert tstore.device_memory_budget(CPU) is None
    assert tstore.stream_budget_bytes(device=CPU) \
        == jstore.stream_budget_bytes() == ttra.tra.DEFAULT_CHUNK_BYTES


def test_chunk_slices_solves_budget():
    for args in [(50, 100, 1000), (10 ** 9, 10 ** 9, 1000)]:
        assert tstore.chunk_slices(*args) == jstore.chunk_slices(*args)
    assert tstore.chunk_slices(50, 100, 1000) == 16


def test_engine_chunk_auto_matches_static_default():
    def prog(mod):
        a = mod.input("A", key_shape=(2, 4), bound=(4, 4))
        b = mod.input("B", key_shape=(4, 2), bound=(4, 4))
        return a.join(b, on=((1,), (0,)), kernel="elemMul").agg(
            (0, 2), "elemMax")
    (ja, ta), (jb, tb) = _pair(6, (2, 4), (4, 4)), _pair(7, (4, 2), (4, 4))
    want = jtra.Engine(executor="reference", optimize=False,
                       fuse=False).run(prog(jtra), A=ja, B=jb)
    for chunk in ("auto", None, 2):
        jgot = jtra.Engine(executor="jit", chunk=chunk).run(prog(jtra),
                                                            A=ja, B=jb)
        got = ttra.Engine(executor="jit", chunk=chunk,
                          device=CPU).run(prog(ttra), A=ta, B=tb)
        np.testing.assert_allclose(as_np(got), as_np(want), atol=1e-5,
                                   rtol=1e-5)
        np.testing.assert_allclose(as_np(got), as_np(jgot), atol=1e-5,
                                   rtol=1e-5)


def test_engine_config_validation():
    with pytest.raises(ValueError, match="chunk"):
        ttra.Engine(chunk="bogus", device=CPU)
    with pytest.raises(ValueError, match="chunk must be >= 1"):
        ttra.Engine(chunk=0, device=CPU)
    with pytest.raises(ValueError, match="chunk must be >= 1"):
        ttra.Engine(device=CPU).compile(
            ttra.input("A", (2, 2), (2, 2)) @ ttra.input("B", (2, 2),
                                                         (2, 2)), chunk=0)
    with pytest.raises(ValueError, match="memory_budget"):
        ttra.Engine(memory_budget=0, device=CPU)
    eng = ttra.Engine(device=CPU)
    assert eng.store is eng.store and eng.chunk == "auto"
    mine = tstore.RelationStore()
    assert ttra.Engine(store=mine, device=CPU).store is mine


# ==========================================================================
# plan_peak_bytes: the live-set estimator the planner budgets against
# ==========================================================================

def test_plan_peak_bytes_scales_with_shapes_and_counts_fusion():
    def matmul(mod, nk):
        a = mod.input("A", key_shape=(nk, 2), bound=(8, 8))
        b = mod.input("B", key_shape=(2, 2), bound=(8, 8))
        return a @ b

    for nk in (2, 64):
        for fuse in (True, False):
            assert tpeak(matmul(ttra, nk), fuse=fuse) \
                == jpeak(matmul(jtra, nk), fuse=fuse)
    small, big = tpeak(matmul(ttra, 2)), tpeak(matmul(ttra, 64))
    assert big > small > 0
    assert big >= (64 * 2 + 2 * 2) * 8 * 8 * 4
    assert tpeak(matmul(ttra, 64), fuse=True) <= \
        tpeak(matmul(ttra, 64), fuse=False)


def _program_roots(mod, name):
    """The roots of one program of ``core/programs.py`` at small dims."""
    import dataclasses
    dims = (2, 3, 4, 1, 5, 6, 7, 2)
    if name == "matmul_tra":
        prog = mod.matmul_tra((4, 3), (3, 2), (5, 6), (6, 7))
    elif name == "nn_search_tra":
        prog = mod.nn_search_tra(3, 2, 5, 4)
    elif name.startswith("ffnn_forward"):
        return mod._ffnn_forward(*dims)[int(name[-1])]
    else:
        prog = getattr(mod, name)(*dims)
    if isinstance(prog, (jtra.Expr, ttra.Expr)):
        return prog
    if hasattr(prog, "roots"):                  # a TrainStep
        return tuple(prog.roots.values())
    if dataclasses.is_dataclass(prog):
        return tuple(v for v in (getattr(prog, f.name)
                                 for f in dataclasses.fields(prog))
                     if v is not None and not isinstance(v, (int, float)))
    return prog


@pytest.mark.parametrize("name", [
    "matmul_tra", "nn_search_tra", "ffnn_forward4", "ffnn_forward5",
    "ffnn_forward6", "ffnn_step_tra", "ffnn_step_tra_hand",
    "ffnn_train_step_tra"])
@pytest.mark.parametrize("fuse", [True, False])
def test_plan_peak_bytes_equals_jax_on_every_program(name, fuse):
    want = jpeak(_program_roots(jprog, name), fuse=fuse)
    assert tpeak(_program_roots(tprog, name), fuse=fuse) == want > 0


@pytest.mark.parametrize("name", ["bmm_plan", "cpmm_plan",
                                  "cpmm_two_phase_plan", "bmm_fused_plan",
                                  "cpmm_fused_plan"])
def test_plan_peak_bytes_equals_jax_on_physical_plans(name):
    args = ((4, 3), (3, 2), (5, 6), (6, 7))
    assert tpeak(getattr(tprog, name)(*args)) \
        == jpeak(getattr(jprog, name)(*args)) > 0
