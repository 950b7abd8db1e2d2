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


def test_the_scan_covers_the_audio_modules():
    """AVSlowFast's modules are scanned, and the audio dataset decodes
    through the port's own binding, never the JAX package's."""
    for name in ("data/audio.py", "data/kinetics_av.py", "models/avslowfast.py"):
        assert ROOT / "pmv_tpu_torch" / name in SOURCES, name
    imported = set(_imported_modules(ROOT / "pmv_tpu_torch" / "data" / "kinetics_av.py"))
    assert "pmv_tpu_torch.native" in imported
    assert not any(m.startswith("pmv_tpu.") for m in imported)
