"""What the benchmark may load: no module under ``benchmark/`` imports
``jax`` or the JAX package (top-level names compared whole: the port's
name begins with the JAX package's), the reference imports nothing of
the program, and ``run.py`` refuses to run without a CUDA device or
without the program beside it."""

import ast
import json
import os
import shutil
import subprocess
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
FORBIDDEN = {"jax", "jaxlib", "flax", "emqx_tpu"}


def modules():
    for d, _dirs, files in os.walk(BENCH):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def top_imports(path: str) -> set:
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".", 1)[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module \
                and not node.level:
            names.add(node.module.split(".", 1)[0])
    return names


@pytest.mark.parametrize("path", sorted(modules()),
                         ids=lambda p: os.path.relpath(p, BENCH))
def test_no_jax_and_no_jax_package(path):
    assert not top_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted(
    p for p in modules() if os.sep + "reference" + os.sep in p),
    ids=lambda p: os.path.relpath(p, BENCH))
def test_reference_imports_nothing_of_the_program(path):
    assert "emqx_tpu_torch" not in top_imports(path)


def run_py(cwd: str, env=None):
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "w10m-uniform",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=cwd, timeout=300,
        env=dict(os.environ, **(env or {})))


def test_run_refuses_without_cuda():
    got = run_py(ROOT, {"CUDA_VISIBLE_DEVICES": ""})
    assert got.returncode != 0
    assert got.stdout.strip() == ""
    assert "CUDA device" in got.stderr


def test_run_fails_with_only_the_benchmark(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    got = run_py(str(tmp_path), {"CUDA_VISIBLE_DEVICES": ""})
    assert got.returncode != 0
    assert got.stdout.strip() == ""


def test_benchmark_json_names_files_that_exist():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    assert bench["paths"] == ["benchmark"]
    for c in bench["configs"]:
        assert c["file"].startswith("benchmark/")
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["source"] == c["source"] and cfg["reduced"] == c["reduced"]
        assert os.path.exists(os.path.join(BENCH, "drivers",
                                           cfg["driver"] + ".py"))
    for w in bench["workloads"]:
        assert os.path.exists(os.path.join(BENCH, "traffic",
                                           w["traffic"] + ".json"))
        assert w["chips"] == 1
    names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(names) == len(set(names))
