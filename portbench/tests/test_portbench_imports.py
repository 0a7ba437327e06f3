"""Nothing the benchmark runs imports JAX or catgen (the JAX package), and
the reference imports nothing of the program. Top-level module names are
compared whole: ``catgen_torch`` begins with ``catgen`` and is allowed
where the program is."""

import ast
import os

import pytest

from portbench.tests.tiny import REPO, run_cpu, tiny_copy

PKG = os.path.join(REPO, "portbench")
FORBIDDEN = {"jax", "jaxlib", "flax", "catgen"}


def _sources(*parts):
    base = os.path.join(PKG, *parts)
    for dirpath, dirs, files in os.walk(base):
        dirs[:] = [d for d in dirs if d not in ("_cache", "_runs",
                                                "__pycache__")]
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def _top_level_imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(_sources()),
                         ids=lambda p: os.path.relpath(p, PKG))
def test_no_jax_and_no_catgen(path):
    assert not set(_top_level_imports(path)) & FORBIDDEN


@pytest.mark.parametrize("path", sorted(list(_sources("reference"))
                                        + list(_sources("configs"))),
                         ids=lambda p: os.path.relpath(p, PKG))
def test_reference_imports_nothing_of_the_program(path):
    names = set(_top_level_imports(path))
    assert "catgen_torch" not in names and not names & FORBIDDEN


def test_the_names_are_compared_whole():
    assert "catgen_torch".split(".")[0] not in FORBIDDEN


def test_a_run_with_jax_loaded_prints_no_result(tmp_path):
    root = tiny_copy(str(tmp_path / "b"))
    rc, line, err = run_cpu(
        root, "sample32.nn100k",
        prelude="import types; sys.modules['jax'] = types.ModuleType('jax')")
    assert rc == 3 and line is None
    assert "jax" in err


def test_a_sound_run_loads_no_jax(tmp_path):
    root = tiny_copy(str(tmp_path / "b"))
    rc, line, err = run_cpu(root, "sample32.nn100k")
    assert rc == 0 and line is not None, err[-3000:]
