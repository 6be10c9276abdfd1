"""No module of the benchmark imports the JAX stack or the JAX package
(whole top-level names: the port ``repro_torch`` begins with ``repro``),
the reference imports nothing of the program, and no source names the
JAX package's benchmark folder.  The run checks ``sys.modules`` again once
its window has closed (:func:`harness.runner.loaded_guarded`)."""
import ast
import sys
import types

import pytest

from harness import manifest, runner

SOURCES = sorted(p for p in manifest.BENCH.rglob("*.py")
                 if "__pycache__" not in p.parts)
GUARDED = {"jax", "jaxlib", "flax", "repro"}
OLD_DIR = "/".join(["benchmarks", ""])


def _imports(path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(manifest.BENCH))
                              for p in SOURCES])
def test_no_jax_and_no_benchmarks_dir(path):
    assert not set(_imports(path)) & GUARDED
    assert OLD_DIR not in path.read_text()


@pytest.mark.parametrize("path", sorted(
    (manifest.BENCH / "reference").glob("*.py")) + sorted(
    (manifest.BENCH / "counts").glob("*.py")))
def test_yardstick_imports_nothing_of_the_program(path):
    assert "repro_torch" not in set(_imports(path))
    assert "harness" not in set(_imports(path))


def test_guard_names_whole_top_level_modules(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_fake",
                        types.ModuleType("repro_torch_fake"))
    assert "repro" not in runner.loaded_guarded()
    monkeypatch.setitem(sys.modules, "repro.core",
                        types.ModuleType("repro.core"))
    assert runner.loaded_guarded() == ["repro"]
