"""Nothing under portbench/ imports JAX or the JAX package, compared by
whole top-level names (the port's name begins with the JAX package's), and
the reference imports nothing of the program either."""

import ast
import os

import pytest

from portbench.harness.readers import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "nemo_tpu"}
FILES = sorted(os.path.join(d, f) for d, _, fs in os.walk(ROOT) for f in fs
               if f.endswith(".py"))


def top_level_imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", "") == "import_module" and node.args \
                and isinstance(node.args[0], ast.Constant):
            out.add(str(node.args[0].value).split(".")[0])
    return out


@pytest.mark.parametrize("path", FILES, ids=lambda p: os.path.relpath(
    p, ROOT))
def test_no_jax(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", [p for p in FILES if os.sep + "reference"
                                  + os.sep in p],
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_reference_is_independent(path):
    assert "nemo_tpu_torch" not in top_level_imports(path)
    with open(path) as f:
        assert "nemo_tpu" not in f.read()


def test_whole_name_compare():
    """nemo_tpu_torch is not nemo_tpu."""
    assert "nemo_tpu_torch".split(".")[0] not in FORBIDDEN
