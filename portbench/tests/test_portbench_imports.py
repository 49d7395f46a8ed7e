"""Nothing the benchmark imports or loads is JAX or the JAX package (top-level names compared whole)."""

import ast
import json
import shutil
import subprocess
import sys
import types

import pytest

from portbench.core.cell import HERE, ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "tpuslam"}
SOURCES = sorted(HERE.rglob("*.py"))


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(HERE)))
def test_sources_import_no_jax(path):
    tops = {name.split(".")[0] for name in _imports(path)}
    assert not tops & FORBIDDEN
    if path.parent.name in ("reference", "core", "metrics"):  # the yardstick takes nothing from the program
        assert "tpuslam_torch" not in tops


def test_a_run_loads_no_jax():
    """A whole (small, CPU) run of the harness in a fresh process, then its modules' top-level names."""
    code = (
        "import sys, time, json; sys.path.insert(0, %r); sys.path.insert(0, %r)\n"
        "from small import small_cell\n"
        "import run\n"
        "cell = small_cell(sequences=1)\n"
        "rec = cell.driver().run(cell, 5, 0, False, 'cpu', time.perf_counter(), steps=3, log=lambda m: None)\n"
        "print(json.dumps({'tops': sorted({m.split('.')[0] for m in sys.modules}), 'found': run.forbidden_modules()}))\n"
    ) % (str(HERE / "tests"), str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600, cwd=ROOT,
                         env={"PATH": "/usr/bin:/bin", "HOME": str(ROOT / "build"), "PYTHONPATH": str(HERE)})
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert "tpuslam_torch" in got["tops"] and "torch" in got["tops"]
    assert not set(got["tops"]) & FORBIDDEN and got["found"] == []


def test_the_check_compares_names_whole(monkeypatch):
    sys.path.insert(0, str(HERE))
    import run

    monkeypatch.setitem(sys.modules, "tpuslam_torch_extra", types.ModuleType("tpuslam_torch_extra"))
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("jax.numpy"))
    monkeypatch.setitem(sys.modules, "tpuslam.frontend", types.ModuleType("tpuslam.frontend"))
    assert run.forbidden_modules() == ["jax", "tpuslam"]


def _run(cwd, *extra):
    return subprocess.run([sys.executable, "portbench/run.py", "--workload", "vo-fleet", "--seed", "2147483659",
                           "--seconds", "1", "--trace", "0", *extra], capture_output=True, text=True, cwd=cwd,
                          timeout=300, env={"PATH": "/usr/bin:/bin", "HOME": str(cwd), "CUDA_VISIBLE_DEVICES": ""})


def test_no_card_no_result():
    out = _run(ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_benchmark_files_alone_give_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    for p in json.loads((ROOT / "BENCHMARK.json").read_text())["paths"]:
        shutil.copytree(ROOT / p, tmp_path / p, ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""
