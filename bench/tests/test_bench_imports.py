"""What the benchmark may import: nothing of JAX or of the JAX package
anywhere (top-level names compared whole: ``repro_torch`` is not
``repro``), nothing of the port in the reference, and no file of the
JAX package's own benchmarks folder."""
import ast
import os

import pytest

from conftest import BENCH

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def sources(sub=""):
    for dirpath, _, files in os.walk(os.path.join(BENCH, sub)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def imported(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                yield str(node.args[0].value)


@pytest.mark.parametrize("path", sorted(sources()), ids=lambda p: os.path.relpath(p, BENCH))
def test_no_jax_and_no_jax_package(path):
    tops = {name.split(".")[0] for name in imported(path)}
    assert not tops & FORBIDDEN, (path, tops & FORBIDDEN)


@pytest.mark.parametrize("path", sorted(sources("reference")),
                         ids=lambda p: os.path.relpath(p, BENCH))
def test_the_reference_imports_nothing_of_the_port(path):
    tops = {name.split(".")[0] for name in imported(path)}
    assert "repro_torch" not in tops and "harness" not in tops, path


def test_no_file_reads_the_jax_benchmarks_folder():
    for path in sources():
        if "/tests/" in path:
            continue
        for node in ast.walk(ast.parse(open(path).read(), path)):
            if isinstance(node, ast.Constant) and isinstance(node.value, str):
                assert "benchmarks/" not in node.value and node.value != "benchmarks", path


def test_the_whole_name_rule():
    assert "repro_torch".split(".")[0] not in FORBIDDEN
    assert "repro.serving".split(".")[0] in FORBIDDEN
