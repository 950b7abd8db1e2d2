"""Import discipline of the port: pmv_tpu_torch and chip_smoke.py import no
jax, flax, optax or pmv_tpu module (they keep their own copies), checked on
the source's syntax tree."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "pmv_tpu")
SOURCES = sorted((ROOT / "pmv_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif (
            isinstance(node, ast.Call)
            and getattr(node.func, "id", getattr(node.func, "attr", None))
            in ("__import__", "import_module")
            and node.args
            and isinstance(node.args[0], ast.Constant)
        ):
            yield node.args[0].value


def test_the_scan_sees_every_port_module():
    assert len(SOURCES) > 10 and (ROOT / "chip_smoke.py").exists()


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_pmv_tpu_imports(path):
    bad = [
        m for m in _imported_modules(path)
        if m.split(".")[0] in FORBIDDEN
    ]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"
