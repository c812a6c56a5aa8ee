"""The port stands alone: every module of ``repro_torch`` (found by
``pkgutil.walk_packages``) and ``chip_smoke.py`` import in a fresh
interpreter in which ``jax``, the reference package ``repro`` and
``ml_dtypes`` (absent on the card's machine; the port reads a reference
bfloat16 array by its dtype's name) cannot be imported
(``sys.modules[name] = None`` makes any import of them raise)."""
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

GUARD = r"""
import importlib, pkgutil, sys
for name in ("jax", "jaxlib", "repro", "ml_dtypes"):
    sys.modules[name] = None
import repro_torch
names = ["repro_torch"] + [m.name for m in pkgutil.walk_packages(
    repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
sys.path.insert(0, sys.argv[1])
import chip_smoke
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "repro", "ml_dtypes")
                and sys.modules[m] is not None)
assert not leaked, leaked
print(len(names), "modules")
"""


def test_port_imports_without_jax_or_the_reference():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", GUARD, ROOT],
                         capture_output=True, text=True, env=env, timeout=300,
                         cwd=ROOT)
    assert out.returncode == 0, out.stderr
    n = int(out.stdout.split()[0])
    assert n > 40, out.stdout          # the walk found the whole package
