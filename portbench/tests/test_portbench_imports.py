"""No module of the benchmark imports JAX or the JAX package, compared by
whole top-level names (``tedm_tpu_torch`` is not ``tedm_tpu``); the
reference imports nothing of the program either; and a run refuses to
print a result once such a module is loaded."""

import ast
import os
import sys
import types

import pytest

from portbench import harness

FORBIDDEN = {"jax", "jaxlib", "flax", "tedm_tpu"}


def imported_roots(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def sources(sub=""):
    base = os.path.join(harness.HERE, sub)
    for d, _, files in os.walk(base):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


@pytest.mark.parametrize("path", sorted(sources()), ids=lambda p: os.path.relpath(p, harness.HERE))
def test_no_module_imports_jax_or_the_jax_package(path):
    assert not set(imported_roots(path)) & FORBIDDEN


def test_the_reference_imports_nothing_of_the_program():
    for path in sources("reference"):
        assert not set(imported_roots(path)) & (FORBIDDEN | {"tedm_tpu_torch"}), path


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    assert harness.forbidden_modules() == [m for m in harness.forbidden_modules() if m in FORBIDDEN]
    before = harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "tedm_tpu_torch_extra", types.ModuleType("tedm_tpu_torch_extra"))
    monkeypatch.setitem(sys.modules, "jaxtyping", types.ModuleType("jaxtyping"))
    assert harness.forbidden_modules() == before
    monkeypatch.setitem(sys.modules, "tedm_tpu.ops", types.ModuleType("tedm_tpu.ops"))
    monkeypatch.setitem(sys.modules, "flax", types.ModuleType("flax"))
    assert {"tedm_tpu", "flax"} <= set(harness.forbidden_modules())


def test_a_run_with_jax_loaded_prints_no_result(monkeypatch, capsys):
    from conftest import tiny_cell
    from portbench import run

    monkeypatch.setattr(harness, "cell", tiny_cell)
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    assert run.main(["--workload", "tedm_serve.fp32", "--seed", "3", "--seconds", "0.1"], device="cpu") == 3
    assert "jax" in capsys.readouterr().err and not capsys.readouterr().out.strip().startswith("{")
