"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the port. Module names are compared by
their top-level name, whole: ``lsi_tpu_torch`` is not ``lsi_tpu``."""

import ast
import subprocess
import sys

from h100_bench.harness.runner import forbidden_modules
from h100_bench.harness.spec import BENCH_DIR, ROOT


def test_top_level_names_are_compared_whole():
    assert forbidden_modules(["lsi_tpu_torch", "lsi_tpu_torch.api",
                              "jaxtyping", "numpy"]) == []
    assert forbidden_modules(["lsi_tpu.api", "jax.numpy", "flax"]) == [
        "flax", "jax", "lsi_tpu"]


def run_fresh(code: str) -> str:
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                          capture_output=True, text=True,
                          timeout=600).stdout.strip()


def test_a_run_of_the_harness_loads_no_jax():
    code = (
        "import sys; sys.path.insert(0, '.')\n"
        "from h100_bench.tests.tiny import tiny_cell, run_tiny\n"
        "from h100_bench.harness.runner import forbidden_modules\n"
        "import h100_bench.readings, h100_bench.faults\n"
        "for c in ('serve_b16', 'train_quality_b8'):\n"
        "    run_tiny(tiny_cell(c))\n"
        "print(forbidden_modules())\n")
    assert run_fresh(code) == "[]"


def test_the_reference_loads_nothing_of_the_port():
    code = (
        "import sys; sys.path.insert(0, '.')\n"
        "import h100_bench.reference.optim, h100_bench.reference.geometry\n"
        "import h100_bench.inputs.pool\n"
        "print(sorted({m.split('.')[0] for m in sys.modules} & "
        "{'lsi_tpu_torch', 'lsi_tpu', 'jax', 'jaxlib', 'flax'}))\n")
    assert run_fresh(code) == "[]"


def test_no_source_of_the_reference_names_the_port_or_jax():
    for path in (BENCH_DIR / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for n in names:
                top = n.split(".")[0]
                assert top not in ("lsi_tpu_torch", "lsi_tpu", "jax",
                                   "jaxlib", "flax"), (path, n)
                assert top in ("torch", "numpy", "h100_bench", "__future__",
                               "dataclasses", "math", "typing"), (path, n)


def test_no_harness_source_names_jax_or_the_jax_package():
    for path in BENCH_DIR.rglob("*.py"):
        if "tests" in path.parts:
            continue
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                names = ([a.name for a in node.names]
                         if isinstance(node, ast.Import)
                         else [node.module or ""])
                assert not {n.split(".")[0] for n in names} & {
                    "jax", "jaxlib", "flax", "lsi_tpu"}, (path, names)
