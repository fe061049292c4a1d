"""The port's standing rules, checked on the CPU.

(a) ``src/repro_torch``, ``chip_smoke.py`` and ``tools/`` import neither
    ``jax`` nor the JAX package ``repro`` (only ``repro_torch``);
(b) without a card, entry points asked for no device raise instead of
    running on the CPU;
(c) the matmul, flash attention and SSD scan ops asked for their kernels
    on CPU tensors raise — there is no silent fallback to the plain
    version;
(d) the launcher's paths that are not ported yet exit 2 with a message,
    and the ported ``--dense-oracle`` runs on the CPU when asked to.
"""
import ast
import pathlib

import pytest

torch = pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"] + sorted((ROOT / "tools").glob("*.py"))


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_port_imports_neither_jax_nor_repro(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module and _forbidden(node.module):
                bad.append(node.module)
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__"):
            args = [a.value for a in node.args
                    if isinstance(a, ast.Constant) and isinstance(a.value,
                                                                  str)]
            bad += [a for a in args if _forbidden(a)]
    assert not bad, f"{path.name} imports {bad}"


def test_port_files_found():
    names = {p.name for p in PORT_FILES}
    assert {"engine.py", "tra.py", "server.py", "ops.py", "model.py",
            "layers.py", "chip_smoke.py", "shardmap_exec.py", "mesh.py",
            "sites.py", "adamw.py", "schedule.py", "compression.py",
            "pipeline.py", "trainer.py", "train.py"} <= names
    port = ROOT / "src" / "repro_torch"
    for module in ("optim/adamw.py", "optim/schedule.py",
                   "optim/compression.py", "data/pipeline.py",
                   "runtime/trainer.py", "runtime/pipeline.py",
                   "launch/train.py"):
        assert port / module in PORT_FILES
    for kernel in ("flash_attention", "ssd_scan"):
        assert ROOT / "src" / "repro_torch" / "kernels" / kernel \
            / "ops.py" in PORT_FILES


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")


def test_scorer_without_device_raises(no_card):
    from repro_torch.serve import FFNNScorer
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FFNNScorer()
    assert FFNNScorer(device="cpu").device.type == "cpu"


def test_engine_without_device_raises(no_card):
    from repro_torch.core import Engine
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine()


def test_launcher_without_device_fails(no_card):
    from repro_torch.launch.serve import main
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--requests", "1"])


def test_engine_rejects_inputs_on_another_device():
    from repro_torch.core import Engine
    from repro_torch.core import expr as E
    from repro_torch.core.tra import RelType, TensorRelation
    eng = Engine(device="cpu")
    a = E.input("A", (1, 1), (2, 2))
    meta = TensorRelation(torch.zeros(1, 1, 2, 2, device="meta"),
                          RelType((1, 1), (2, 2)))
    with pytest.raises(ValueError, match="lies on meta"):
        eng.run(a @ a, A=meta)


def test_matmul_kernel_impl_on_cpu_raises():
    from repro_torch.kernels.matmul import ops
    with pytest.raises(ValueError, match="CUDA device"):
        ops.matmul(torch.ones(2, 3), torch.ones(3, 4), impl="kernel")


def test_flash_kernel_impl_on_cpu_raises():
    from repro_torch.kernels.flash_attention import ops
    q = torch.ones(1, 2, 4, 8)
    with pytest.raises(ValueError, match="CUDA device"):
        ops.attention(q, q, q, impl="kernel")


def test_unported_launcher_paths_exit_cleanly(capsys):
    from repro_torch.launch.serve import main
    assert main(["--dense-oracle", "--arch", "llama4-scout-17b-a16e"]) == 2
    assert "not ported" in capsys.readouterr().err
    assert main(["--dense-oracle", "--mesh", "2x2"]) == 2
    assert "not ported" in capsys.readouterr().err


def test_dense_oracle_runs_on_cpu_when_asked(capsys):
    from repro_torch.launch.serve import main
    assert main(["--dense-oracle", "--arch", "gemma2-2b", "--smoke",
                 "--device", "cpu", "--prompt-len", "16", "--gen", "4"]) == 0
    out = capsys.readouterr().out
    assert "prefill(4x16)" in out and "decode 4 steps" in out


def test_dense_oracle_runs_mamba2_on_cpu_when_asked(capsys):
    from repro_torch.launch.serve import main
    assert main(["--dense-oracle", "--arch", "mamba2-130m", "--smoke",
                 "--device", "cpu", "--prompt-len", "40", "--gen", "3"]) == 0
    out = capsys.readouterr().out
    assert "mamba2-130m on cpu: prefill(4x40)" in out
    assert "decode 3 steps" in out


def test_ssd_kernel_impl_on_cpu_raises():
    from repro_torch.kernels.ssd_scan import ops
    x = torch.ones(1, 8, 2, 4)
    bc = torch.ones(1, 8, 3)
    with pytest.raises(ValueError, match="CUDA device"):
        ops.ssd_scan(x, torch.ones(1, 8, 2), -torch.ones(2), bc, bc,
                     impl="kernel")


def test_dense_oracle_without_device_raises(no_card):
    from repro_torch.launch.serve import main
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--dense-oracle", "--arch", "gemma2-2b", "--smoke",
              "--prompt-len", "16", "--gen", "4"])


def test_chip_smoke_refuses_without_card(no_card):
    import subprocess
    import sys
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_train_launcher_mesh_is_not_ported(capsys):
    from repro_torch.launch.train import main
    assert main(["--arch", "gemma2-2b", "--smoke", "--mesh", "2x2",
                 "--device", "cpu"]) == 2
    assert "not ported" in capsys.readouterr().err
    assert main(["--arch", "llama4-scout-17b-a16e", "--smoke",
                 "--device", "cpu"]) == 2
    assert "not ported" in capsys.readouterr().err


def test_train_launcher_without_device_raises(no_card, tmp_path):
    from repro_torch.launch.train import main
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--arch", "gemma2-2b", "--smoke", "--steps", "1",
              "--ckpt-dir", str(tmp_path)])


def test_train_launcher_runs_on_cpu_when_asked(capsys, tmp_path):
    from repro_torch.launch.train import main
    assert main(["--arch", "gemma2-2b", "--smoke", "--steps", "2",
                 "--batch", "2", "--seq", "16", "--device", "cpu",
                 "--ckpt-every", "1", "--ckpt-dir", str(tmp_path)]) == 0
    assert "gemma2-2b on cpu: 2 steps, loss" in capsys.readouterr().out
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "step_000000001", "step_000000002"]
