"""What the benchmark may load: never JAX or the JAX package, and its
reference, counts and layer kinds nothing of the program.  Names are compared as whole top-level
module names (``repro_torch`` is not ``repro``)."""

import ast
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro", "benchmarks"}


def imported(path: Path) -> set[str]:
    """Top-level names of every module ``path`` imports (relative imports
    stay inside the benchmark)."""
    tree = ast.parse(path.read_text(), filename=str(path))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and isinstance(node.args[0], ast.Constant):
            names.add(str(node.args[0].value).split(".")[0])
    return names


def modules():
    return sorted(BENCH.rglob("*.py"))


def test_there_are_modules_to_check():
    assert len(modules()) > 20


def test_no_module_imports_jax_or_the_jax_package():
    for path in modules():
        bad = imported(path) & FORBIDDEN
        assert not bad, f"{path.relative_to(BENCH)} imports {sorted(bad)}"


def test_the_reference_imports_nothing_of_the_program():
    for path in [p for part in ("reference", "counts", "layers") for p in sorted((BENCH / part).rglob("*.py"))]:
        bad = {n for n in imported(path) if n.startswith("repro")} | (imported(path) & {"bench"})
        assert not bad, f"{path.relative_to(BENCH)} imports {sorted(bad)}"


def test_whole_names_are_compared():
    assert "repro_torch" not in FORBIDDEN
    from bench.harness.core import FORBIDDEN as RUN_TIME

    assert {"jax", "jaxlib", "flax", "repro"} <= set(RUN_TIME) and "repro_torch" not in RUN_TIME


def test_no_module_reads_the_jax_benchmark_folder():
    for path in modules():
        if path.name != "test_bench_isolation.py":
            assert '"benchmarks/' not in path.read_text(), path
