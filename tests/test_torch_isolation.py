"""Static checks on the port: it imports nothing of JAX or of the JAX
package, and its kernel dispatch has no ``try`` that could fall back."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")
SOURCES = (sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
           + sorted((ROOT / "tools").glob("*.py")))


def _imported_modules(tree: ast.AST):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "id", None) == "__import__"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_imports_nothing_of_jax_or_the_jax_package(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [m for m in _imported_modules(tree)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.name} imports {bad}"


def test_kernel_dispatch_has_no_fallback():
    tree = ast.parse((PORT / "kernels" / "ops.py").read_text())
    tries = [n.lineno for n in ast.walk(tree) if isinstance(n, ast.Try)]
    assert not tries, f"try blocks in kernels/ops.py at lines {tries}"


def test_every_kernel_source_has_its_note():
    """What it replaces, what bounds it on the card, what the design does."""
    for src in (PORT / "kernels" / "csrc").glob("*.cu"):
        text = src.read_text()
        assert "Replaces the Pallas TPU kernel" in text, src.name
        assert "Bound on the H100" in text, src.name
        assert "Design:" in text, src.name


@pytest.mark.parametrize("rel", ["distributed/compat.py",
                                 "distributed/ledger.py", "launch/mesh.py",
                                 "distributed/sharding.py",
                                 "distributed/zero.py",
                                 "distributed/compression.py"])
def test_the_mesh_side_has_no_fallback(rel):
    """No ``try`` around a collective, the ledger kernel's call or the
    choice of a backend: the group's backend decides, never a caught
    error."""
    tree = ast.parse((PORT / rel).read_text())
    tries = [n.lineno for n in ast.walk(tree) if isinstance(n, ast.Try)]
    assert not tries, f"try blocks in {rel} at lines {tries}"
