"""No module the benchmark runs imports JAX, Flax, Optax or the JAX package,
and the plain references import nothing of the port: top-level module
names compared whole (the port's name begins with the JAX package's)."""

import ast
import os

import pytest

from benchmark import harness

FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "feature_tracker_tpu"}
PORT = "feature_tracker_tpu_torch"


def modules():
    for dirpath, _, files in os.walk(harness.BENCH_DIR):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def imported_top_levels(path):
    with open(path) as fh:
        tree = ast.parse(fh.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted(modules()),
                         ids=lambda p: os.path.relpath(p, harness.BENCH_DIR))
def test_no_jax_imports(path):
    assert not imported_top_levels(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted(
    p for p in modules()
    if os.sep + "reference" + os.sep in p))
def test_reference_imports_nothing_of_the_port(path):
    assert PORT not in imported_top_levels(path)


def test_names_are_compared_whole():
    assert harness.forbidden_modules(
        ["feature_tracker_tpu_torch", "feature_tracker_tpu_torch.ops",
         "jaxtyping", "flaxen"]) == []
    assert harness.forbidden_modules(
        ["feature_tracker_tpu.ops", "jax.numpy", "numpy"]) == [
            "feature_tracker_tpu", "jax"]
