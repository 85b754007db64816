"""Nothing under portbench/ imports JAX or the JAX package (top-level
names compared whole, so that mgsv_tpu_torch passes), and the reference
imports nothing of the program."""

import ast
import glob
import os

import pytest

from portbench.harness import FORBIDDEN
from portbench.tests.tiny import HERE


def top_names(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            arg = node.args[0] if node.args else None
            if isinstance(arg, ast.Constant):
                yield arg.value.split(".")[0]


FILES = sorted(glob.glob(os.path.join(HERE, "**", "*.py"), recursive=True))


@pytest.mark.parametrize("path", FILES, ids=lambda p: os.path.relpath(p, HERE))
def test_no_jax(path):
    assert not set(top_names(path)) & FORBIDDEN


@pytest.mark.parametrize("path", sorted(glob.glob(os.path.join(HERE, "reference", "*.py"))),
                         ids=os.path.basename)
def test_reference_is_independent(path):
    assert "mgsv_tpu_torch" not in set(top_names(path))


def test_whole_names():
    assert "mgsv_tpu_torch" not in FORBIDDEN and "mgsv_tpu" in FORBIDDEN
