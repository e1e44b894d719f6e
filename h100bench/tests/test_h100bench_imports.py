"""Nothing the benchmark runs loads JAX or the JAX package, and the reference
loads nothing of the measured program: by the source, and by ``sys.modules``
after a run."""

import ast
import json
import os
import shutil
import subprocess
import sys

import pytest

from h100bench import cells, run

FORBIDDEN = {"jax", "jaxlib", "flax", "gswm"}
SOURCES = sorted(p for p in cells.HERE.rglob("*.py") if "tests" not in p.parts)


def _imports(path) -> set:
    """Top-level names of every module ``path`` imports, compared whole."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(cells.ROOT)))
def test_no_jax_imported(path):
    assert not _imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((cells.HERE / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    names = _imports(path)
    assert "gswm_torch" not in names
    tree = ast.parse(path.read_text())
    froms = {n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module}
    assert all(not m.startswith("h100bench") or m.startswith("h100bench.reference")
               for m in froms), froms


def test_whole_name_comparison():
    assert "gswm_torch" not in FORBIDDEN and "gswm" in FORBIDDEN
    sys.modules.setdefault("gswm_torch_probe_name", sys)
    try:
        assert "gswm_torch_probe_name" not in run.forbidden_modules()
    finally:
        del sys.modules["gswm_torch_probe_name"]


def test_sys_modules_after_a_cpu_run():
    """A whole run on the CPU at the tiny preset, in a fresh process: no
    forbidden module is loaded once the window has closed."""
    code = (
        "import json, torch\n"
        "from pathlib import Path\n"
        "from h100bench import cells, run\n"
        "torch.set_num_threads(2)\n"
        "d = Path('h100bench/tests/data')\n"
        "cell = cells.load('tiny-extract', bench=d / 'BENCHMARK.json', here=d)\n"
        "res = run.run_cell(cell, 5, 0.1, False, 'cpu')\n"
        "print(json.dumps({'correct': res['correct'], 'found': run.forbidden_modules()}))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=cells.ROOT, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res == {"correct": True, "found": []}


def _cli(cwd):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, "-m", "h100bench.run", "--workload",
                           "sd21base-512-extract-b32", "--seed", "4294967311", "--seconds", "1",
                           "--trace", "0"], cwd=cwd, env=env, capture_output=True, text=True,
                          timeout=600)


def test_cli_refuses_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present; the refusal is for machines without one")
    out = _cli(cells.ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_cli_fails_with_the_benchmark_alone(tmp_path):
    """In a directory of BENCHMARK.json and the benchmark's files alone the
    run exits nonzero and prints no result."""
    shutil.copy(cells.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(cells.HERE, tmp_path / "h100bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _cli(tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""
