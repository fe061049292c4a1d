"""The port's standing rules, checked on the CPU.

(a) ``src/repro_torch`` and ``chip_smoke.py`` import neither ``jax`` nor
    the JAX package ``repro`` (only ``repro_torch``);
(b) without a card, entry points asked for no device raise instead of
    running on the CPU;
(c) the matmul op asked for its kernel on a CPU tensor raises — there is
    no silent fallback to the plain version.
"""
import ast
import pathlib

import pytest

torch = pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


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
    assert {"engine.py", "tra.py", "server.py", "ops.py",
            "chip_smoke.py"} <= names


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


def test_unported_launcher_paths_exit_cleanly(capsys):
    from repro_torch.launch.serve import main
    assert main(["--servable", "lm"]) == 2
    assert main(["--dense-oracle"]) == 2
    assert "not ported" in capsys.readouterr().err


def test_chip_smoke_refuses_without_card(no_card):
    import subprocess
    import sys
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
