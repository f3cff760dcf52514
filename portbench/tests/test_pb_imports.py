"""Nothing under portbench/ imports JAX or the JAX package, and the
reference imports nothing of the program (top-level names compared
whole: the port's name begins with the JAX package's)."""
import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "libdwt_tpu"}
FILES = sorted(BENCH.rglob("*.py"))


def imported_top_names(path: Path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".", 1)[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".", 1)[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant) and isinstance(node.args[0].value, str)):
            names.add(node.args[0].value.split(".", 1)[0])
    return names


def test_the_scan_compares_whole_top_level_names(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import libdwt_torch.api\nfrom libdwt_tpu.ops import x\nimport jaxlib as j\n"
                 "importlib.import_module('jax.numpy')\n")
    assert imported_top_names(f) == {"libdwt_torch", "libdwt_tpu", "jaxlib", "jax"}


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_module_imports_jax_or_the_jax_package(path):
    assert not imported_top_names(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_program(path):
    assert imported_top_names(path) <= {"__future__", "math", "torch", "numpy"}
