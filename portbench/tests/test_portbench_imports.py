"""No module of the benchmark imports JAX or the JAX package, and the
reference and the judges import nothing of the program: top-level names
compared whole."""

import ast
import pathlib

import pytest

HERE = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "arrow_tpu"}


def top_level_imports(path: pathlib.Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and isinstance(node.args[0], ast.Constant):
            names.add(str(node.args[0].value).split(".")[0])
    return names


SOURCES = sorted(HERE.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((HERE / "reference").glob("*.py")) + sorted((HERE / "judges").glob("*.py")),
                         ids=lambda p: str(p.relative_to(HERE)))
def test_reference_is_independent(path):
    assert not top_level_imports(path) & (FORBIDDEN | {"arrow_tpu_torch"})


def test_the_names_are_compared_whole(tmp_path):
    p = tmp_path / "probe.py"
    p.write_text("import arrow_tpu_torch\nfrom arrow_tpu_torch import compute\nimport jaxtyping\nimport jax.numpy\n")
    assert top_level_imports(p) == {"arrow_tpu_torch", "jaxtyping", "jax"}
    assert top_level_imports(p) & FORBIDDEN == {"jax"}
