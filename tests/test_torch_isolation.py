"""The port stands alone: no file of quip_tpu_torch, nor chip_smoke.py,
imports jax or quip_tpu, and the package imports with jax blocked."""
import ast
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
FILES = sorted((ROOT / "quip_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_no_jax_or_reference_imports():
    assert len(FILES) > 10
    bad = [(p.relative_to(ROOT).as_posix(), m)
           for p in FILES for m in _imports(p)
           if m.split(".")[0] in ("jax", "jaxlib", "quip_tpu")]
    assert not bad, bad


_BLOCKED = """
import importlib.abc, pkgutil, sys
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "quip_tpu"):
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
import quip_tpu_torch
for m in pkgutil.walk_packages(quip_tpu_torch.__path__, "quip_tpu_torch."):
    importlib.import_module(m.name)
assert not any(k.split(".")[0] in ("jax", "quip_tpu") for k in sys.modules)
print("ok")
"""


def test_imports_with_jax_blocked():
    env = dict(os.environ, PYTHONPATH=str(ROOT) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    r = subprocess.run([sys.executable, "-c", _BLOCKED], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr
