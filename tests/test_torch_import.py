"""The PyTorch port stands alone: it imports with JAX blocked, and no file
of it (nor chip_smoke.py, nor the port-side examples
``examples/*_torch.py``) imports jax or the reference package."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
EXAMPLES = sorted((ROOT / "examples").glob("*_torch.py"))
FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"] + EXAMPLES
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    bad = [m for m in _imports(path)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"


def test_every_module_imports_with_jax_blocked():
    prog = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'repro'):\n"
        "    sys.modules[name] = None\n"
        "import importlib, pkgutil, repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    repro_torch.__path__, 'repro_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "assert not any(k.split('.')[0] in ('jax', 'jaxlib') and\n"
        "               sys.modules[k] is not None for k in sys.modules)\n"
        "print(len(names))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", prog], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) >= 20


FRONT_DOORS = ("repro_torch.core.constraint", "repro_torch.core.area",
               "repro_torch.core.roofline", "repro_torch.core.hlo_cost",
               "repro_torch.launch.dryrun", "repro_torch.launch.perf_iter",
               "repro_torch.launch.roofline")


@pytest.mark.parametrize("module", FRONT_DOORS)
def test_front_door_imports_alone_with_jax_blocked(module):
    """Each front-door module imports first and alone, with jax and the
    reference blocked, and pulls neither in."""
    prog = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'repro'):\n"
        "    sys.modules[name] = None\n"
        f"import {module}\n"
        "assert not any(k.split('.')[0] in ('jax', 'jaxlib', 'repro') and\n"
        "               sys.modules[k] is not None for k in sys.modules)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", prog], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_the_six_port_side_examples_are_there():
    assert [p.name for p in EXAMPLES] == [
        f"{n}_torch.py" for n in sorted((
            "cluster_scaling", "quickstart", "serve_batched",
            "serving_policies", "sim_timeline", "train_lm"))]


def test_examples_import_with_jax_blocked():
    """Each port-side example imports (its ``main`` not run) with jax and
    the reference blocked, and pulls neither in."""
    prog = (
        "import importlib.util, sys\n"
        "for name in ('jax', 'jaxlib', 'repro'):\n"
        "    sys.modules[name] = None\n"
        f"for i, path in enumerate({[str(p) for p in EXAMPLES]!r}):\n"
        "    spec = importlib.util.spec_from_file_location(f'ex{i}', path)\n"
        "    mod = importlib.util.module_from_spec(spec)\n"
        "    sys.modules[spec.name] = mod\n"
        "    spec.loader.exec_module(mod)\n"
        "    assert callable(mod.main)\n"
        "assert not any(k.split('.')[0] in ('jax', 'jaxlib', 'repro') and\n"
        "               sys.modules[k] is not None for k in sys.modules)\n")
    res = subprocess.run([sys.executable, "-c", prog],
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
