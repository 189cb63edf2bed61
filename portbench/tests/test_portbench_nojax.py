"""No run loads jax, jaxlib, flax or the JAX package, compared by whole
top-level names; the reference imports nothing of the program."""

import ast
import os
import subprocess
import sys

from conftest import ROOT
from portbench import harness

HERE = os.path.join(ROOT, "portbench")


def test_top_level_names_compared_whole():
    names = ["vaex_tpu_torch", "vaex_tpu_torch.ops.probe", "jaxtyping", "numpy", "flaxen"]
    assert harness.forbidden_modules(names) == []
    assert harness.forbidden_modules(names + ["vaex_tpu.ops", "jax", "jaxlib.xla", "flax.linen"]) \
        == ["flax.linen", "jax", "jaxlib.xla", "vaex_tpu.ops"]


def imports(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def sources(sub=""):
    for dirpath, _, files in os.walk(os.path.join(HERE, sub)):
        for name in files:
            if name.endswith(".py"):
                yield os.path.join(dirpath, name)


def test_no_source_imports_jax_or_the_jax_package():
    for path in sources():
        assert not imports(path) & set(harness.FORBIDDEN), path


def test_reference_imports_nothing_of_the_program():
    for path in sources("reference"):
        assert not imports(path) & {"vaex_tpu_torch", "vaex_tpu", "jax"}, path


def test_importing_the_harness_and_the_port_loads_no_jax():
    code = ("import sys; sys.path.insert(0, %r); import portbench.harness, vaex_tpu_torch; "
            "from portbench import harness; print(harness.forbidden_modules())" % ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, check=True).stdout
    assert out.strip() == "[]"
