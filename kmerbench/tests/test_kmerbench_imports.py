"""What the benchmark may import: nothing of jax, jaxlib, flax or the JAX
package anywhere, nothing of the repository's `bench/` or `bench.py`, and
in `reference/` nothing of the program either.  Top-level module names
are compared whole (`findkmer_torch` is not `findkmer_tpu`)."""

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
BANNED = {"jax", "jaxlib", "flax", "findkmer_tpu", "bench"}
SOURCES = sorted(BENCH.rglob("*.py"))


def _top_levels(path: Path) -> set:
    tree = ast.parse(path.read_text(), str(path))
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
              == "import_module" and node.args
              and isinstance(node.args[0], ast.Constant)):
            out.add(node.args[0].value.split(".")[0])
    return out


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_no_jax_package_no_bench(path):
    assert not _top_levels(path) & BANNED


@pytest.mark.parametrize(
    "path", sorted((BENCH / "reference").rglob("*.py")),
    ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert "findkmer_torch" not in _top_levels(path)


def test_names_are_compared_whole():
    assert "findkmer_torch".split(".")[0] not in BANNED
    assert _top_levels(BENCH / "harness.py") >= {"json", "os"}
