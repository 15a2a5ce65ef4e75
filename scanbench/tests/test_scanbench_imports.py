"""Nothing under scanbench/ imports JAX or the JAX package, and the
reference imports nothing of the program: top-level names compared
whole (grab_tpu_torch begins with grab_tpu)."""

import ast
import os

import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "grab_tpu"}
REFERENCE = ("reference.py", "check.py")


def top_names(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0]


def sources():
    for d, _, fs in os.walk(HERE):
        for f in fs:
            if f.endswith(".py"):
                yield os.path.join(d, f)


@pytest.mark.parametrize("path", sorted(sources()), ids=lambda p: os.path.relpath(p, HERE))
def test_no_jax_anywhere(path):
    assert not set(top_names(path)) & FORBIDDEN


@pytest.mark.parametrize("name", REFERENCE)
def test_reference_imports_nothing_of_the_program(name):
    names = set(top_names(os.path.join(HERE, name)))
    assert "grab_tpu_torch" not in names and not names & FORBIDDEN


def test_names_compared_whole():
    assert "grab_tpu" not in {"grab_tpu_torch".split(".")[0]}
    src = os.path.join(HERE, "tests", "faulty_server.py")
    assert "grab_tpu_torch" in set(top_names(src))  # the program, named in full, is not the JAX package


def test_harness_refuses_a_loaded_jax_package():
    from scanbench import harness

    assert set(harness.FORBIDDEN) == FORBIDDEN
    loaded = {"grab_tpu_torch.cli", "grab_tpu_torch", "numpy"}
    assert not {m.split(".")[0] for m in loaded} & FORBIDDEN
    assert {m.split(".")[0] for m in loaded | {"grab_tpu.regex"}} & FORBIDDEN == {"grab_tpu"}
