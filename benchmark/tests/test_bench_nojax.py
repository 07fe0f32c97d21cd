"""The no-JAX check: top-level names compared whole, so the port
(`fhe_ram_tpu_torch`) passes and JAX, jaxlib, flax and the JAX package
(`fhe_ram_tpu`) do not; nothing the benchmark runs imports them."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark import harness

BENCH = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("mods,found", [
    (["fhe_ram_tpu_torch", "fhe_ram_tpu_torch.ram.ram", "numpy"], []),
    (["fhe_ram_tpu", "fhe_ram_tpu_torch"], ["fhe_ram_tpu"]),
    (["fhe_ram_tpu.ops.ntt", "torch"], ["fhe_ram_tpu.ops.ntt"]),
    (["jax", "jax._src.core", "jaxlib.xla_client", "flax.linen"],
     ["flax.linen", "jax", "jax._src.core", "jaxlib.xla_client"]),
    (["jax_like", "jaxtyping", "flaxen"], []),
])
def test_forbidden_modules_compare_whole_top_level_names(mods, found):
    assert harness.forbidden_modules(dict.fromkeys(mods)) == found


def test_no_file_of_the_benchmark_imports_jax_or_the_jax_package():
    for path in BENCH.rglob("*.py"):
        if "tests" in path.parts:
            continue
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                tops = [a.name.split(".")[0] for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                tops = [node.module.split(".")[0]]
            else:
                continue
            assert not set(tops) & set(harness.FORBIDDEN), (path, tops)


def test_a_run_loads_no_jax(small):
    """A whole run in a fresh process: nothing it loads is JAX's."""
    layout, _, root = small
    code = (
        "import json, sys, time; sys.path.insert(0, sys.argv[1]);"
        "from benchmark import harness;"
        "from benchmark.tests.conftest import small_bench;"
        "r = harness.run_cell('small.read', 5, 0.2, True, time.time(), small_bench(),"
        " device='cpu', layout=harness.Layout(sys.argv[2]), log=lambda m: None);"
        "print(json.dumps([r['correct'], harness.forbidden_modules()]))")
    out = subprocess.run([sys.executable, "-c", code, str(BENCH.parent), str(root)],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[true, []]"


def test_without_a_card_the_command_prints_no_result(tmp_path):
    """On a machine without a card the command exits with another code than
    0 and prints nothing on standard output."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload",
                          "readme_2_18.read", "--seed", "5", "--seconds", "1", "--trace", "0"],
                         cwd=BENCH.parent, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""


def test_a_checkout_of_the_benchmark_alone_prints_no_result(tmp_path):
    """In a directory holding only BENCHMARK.json and the benchmark's files
    the command exits with another code than 0 and prints no result."""
    import shutil

    shutil.copy(BENCH.parent / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          "readme_2_18.read", "--seed", "5", "--seconds", "1", "--trace", "0"],
                         cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""
