"""The port stands alone: no file of lux_tpu_torch/, and not
chip_smoke.py, imports jax or lux_tpu, and the package imports in a
process where both are unavailable."""

import ast
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "lux_tpu")


def _port_files():
    files = sorted((REPO / "lux_tpu_torch").rglob("*.py"))
    return files + [REPO / "chip_smoke.py"]


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", None) == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


def test_no_jax_or_reference_imports():
    files = _port_files()
    assert len(files) > 10
    bad = [(str(p.relative_to(REPO)), root) for p in files
           for root in _imported_roots(p) if root in FORBIDDEN]
    assert bad == []


def test_imports_without_jax():
    code = (
        "import sys, pkgutil, importlib\n"
        "for m in ('jax', 'jaxlib', 'lux_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import lux_tpu_torch\n"
        "for info in pkgutil.walk_packages(lux_tpu_torch.__path__,\n"
        "                                  'lux_tpu_torch.'):\n"
        "    importlib.import_module(info.name)\n"
        "assert not any(k == 'jax' or k.startswith(('jax.', 'lux_tpu.'))\n"
        "               for k, v in sys.modules.items() if v is not None)\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, cwd=str(REPO), timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
