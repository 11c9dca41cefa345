"""The port imports neither jax nor the JAX package: every module of
elprep_tpu_torch, and chip_smoke.py, import in a fresh interpreter whose
import system refuses ``jax`` and ``elprep_tpu``. It runs as a subprocess
because this test process already holds jax (tests/conftest.py)."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_GUARD = r"""
import importlib, importlib.abc, os, sys

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        top = name.split(".")[0]
        if top in ("jax", "jaxlib", "elprep_tpu"):
            raise ImportError("blocked import of " + name)
        return None

sys.meta_path.insert(0, Block())
sys.path.insert(0, REPO)
names = []
for root, _, files in os.walk(os.path.join(REPO, "elprep_tpu_torch")):
    for f in sorted(files):
        if f.endswith(".py"):
            rel = os.path.relpath(os.path.join(root, f[:-3]), REPO)
            names.append(rel.replace(os.sep, ".").removesuffix(".__init__"))
for n in names:
    importlib.import_module(n)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "elprep_tpu"))
assert not bad, bad
print(len(names))
"""


def test_port_imports_no_jax_and_no_elprep_tpu():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.run(
        [sys.executable, "-c", "REPO = %r\n" % REPO + _GUARD],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=300)
    assert proc.returncode == 0, proc.stderr
    # every module of the slice was imported
    assert int(proc.stdout.split()[-1]) >= 30


def test_guard_catches_a_jax_import():
    """The guard itself fails on a module that imports jax."""
    proc = subprocess.run(
        [sys.executable, "-c", "REPO = %r\n" % REPO
         + _GUARD.replace("import chip_smoke", "import jax")],
        capture_output=True, text=True, cwd=REPO, timeout=300)
    assert proc.returncode != 0
    assert "blocked import of jax" in proc.stderr
