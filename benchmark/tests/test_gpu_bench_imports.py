"""Nothing the benchmark runs loads JAX or the JAX package, and the
references load nothing of the program. Top-level names are compared
whole: `defer_tpu_torch` is not `defer_tpu`."""

import ast
import os
import subprocess
import sys

import pytest

from benchmark import harness

FORBIDDEN = {"jax", "jaxlib", "flax", "defer_tpu"}


def _modules():
    for dirpath, _, files in os.walk(harness.BENCH):
        for f in sorted(files):
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def _imports(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
              == "import_module" and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", sorted(_modules()),
                         ids=lambda p: os.path.relpath(p, harness.BENCH))
def test_no_module_imports_jax_or_the_jax_package(path):
    assert not set(_imports(path)) & FORBIDDEN


@pytest.mark.parametrize("name", sorted(
    f[:-3] for f in os.listdir(os.path.join(harness.BENCH, "reference"))
    if f.endswith(".py") and f != "__init__.py"))
def test_references_import_nothing_of_the_program(name):
    path = os.path.join(harness.BENCH, "reference", f"{name}.py")
    assert harness.PROGRAM not in set(_imports(path))
    assert "benchmark" not in set(_imports(path))


def test_a_loaded_run_holds_no_jax():
    """Every part of every cell loaded, and the program with it, in a
    fresh interpreter: no JAX module among what it loaded."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from benchmark import harness, trace, compare, weights, lowprec\n"
        "import defer_tpu_torch, defer_tpu_torch.models\n"
        "from defer_tpu_torch.models import get_model\n"
        "spec = harness.benchmark_spec()\n"
        "for c in spec['workloads']:\n"
        "    cell = harness.load_cell(c['name'])\n"
        "    get_model(cell.config['program_model'])\n"
        "for m in spec['per_layer']:\n"
        "    harness.load_module('metrics', m['name'])\n"
        "print(harness.forbidden_modules())\n" % harness.ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, stdin=subprocess.DEVNULL)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_forbidden_names_are_whole():
    sys.modules.setdefault("defer_tpu_torch_lookalike_for_test", sys)
    try:
        assert "defer_tpu" not in harness.forbidden_modules() or (
            "defer_tpu" in sys.modules)
    finally:
        del sys.modules["defer_tpu_torch_lookalike_for_test"]
