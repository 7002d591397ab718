"""The port stands alone: no module of ``src/repro_torch`` and not
``chip_smoke.py`` imports JAX or the JAX package ``repro``."""
import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _forbidden(module: str) -> bool:
    return module.split(".")[0] in ("jax", "jaxlib", "repro")


def forbidden_imports(source: str) -> list:
    """Modules of JAX or ``repro`` that ``source`` imports, by statement or
    by ``importlib.import_module`` / ``__import__`` of a literal name."""
    bad = []
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and _forbidden(node.module or ""):
                bad.append(node.module)
        elif isinstance(node, ast.Call):
            name = getattr(node.func, "attr", getattr(node.func, "id", ""))
            if name in ("import_module", "__import__") and node.args and \
                    isinstance(node.args[0], ast.Constant) and \
                    _forbidden(str(node.args[0].value)):
                bad.append(node.args[0].value)
    return bad


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax_and_no_repro(path):
    assert forbidden_imports(path.read_text()) == []


@pytest.mark.parametrize("source,found", [
    ("import jax", ["jax"]),
    ("import jax.numpy as jnp", ["jax.numpy"]),
    ("from jax import numpy", ["jax"]),
    ("import repro.models", ["repro.models"]),
    ("from repro.core import goodput", ["repro.core"]),
    ("importlib.import_module('repro.configs.base')", ["repro.configs.base"]),
    ("import repro_torch.models\nfrom repro_torch.core import goodput", []),
    ("from . import layers", []),
])
def test_checker_finds_forbidden_imports(source, found):
    assert forbidden_imports(source) == found
