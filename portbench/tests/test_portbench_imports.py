"""Nothing of the benchmark imports JAX or the JAX package, and nothing of
its reference imports the program: every module's imports, compared by
their whole top-level name."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "exciting_environments_tpu"}
MODULES = sorted(ROOT.rglob("*.py"))


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names.update(alias.name.split(".", 1)[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".", 1)[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and isinstance(node.args[0], ast.Constant):
            names.add(str(node.args[0].value).split(".", 1)[0])
    return names


@pytest.mark.parametrize("path", MODULES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((ROOT / "reference").glob("*.py")), ids=lambda p: p.name)
def test_reference_takes_nothing_of_the_program(path):
    assert not top_level_imports(path) & (FORBIDDEN | {"exciting_environments_torch", "portbench"})


def test_the_check_compares_whole_names(tmp_path):
    module = tmp_path / "m.py"
    module.write_text("import exciting_environments_torch.utils\nfrom jaxtyping import Array\nimport jax.numpy\n")
    assert top_level_imports(module) == {"exciting_environments_torch", "jaxtyping", "jax"}
    assert top_level_imports(module) & FORBIDDEN == {"jax"}
