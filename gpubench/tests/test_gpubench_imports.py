"""Nothing a run loads is JAX or the JAX package, by whole top-level name
(the port's name begins with the JAX package's), and the reference
loads nothing of the program."""

import os
import subprocess
import sys

import tiny

BLOCKER = r'''
import sys
BLOCK = set(sys.argv[1].split(","))
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCK:
            raise ImportError("blocked: " + name)
        return None
sys.meta_path.insert(0, Block())
sys.argv = sys.argv[:1]
'''


def _python(block, code, cwd):
    env = dict(os.environ, ELPREP_TPU_TORCH_DEVICE="cpu")
    return subprocess.run([sys.executable, "-c", BLOCKER + code, ",".join(block)], cwd=cwd,
                          env=env, capture_output=True, text=True, timeout=600)


def test_a_run_loads_no_jax(tmp_path):
    root = tiny.make_root(str(tmp_path))
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import tiny\n"
            "rc, res = tiny.run_cpu(%r, 'wgs50x.prep', 5, seconds=6)\n"
            "assert rc == 0 and res is not None, rc\n"
            "import run\n"
            "assert not run.banned_modules(), run.banned_modules()\n"
            "print('ok', res['correct'])\n") % (os.path.dirname(os.path.abspath(__file__)), root)
    p = _python(("jax", "jaxlib", "flax", "elprep_tpu"), code, tiny.ROOT)
    assert p.returncode == 0, p.stderr[-3000:]
    assert "ok True" in p.stdout


def test_the_blocker_compares_whole_names():
    p = _python(("elprep_tpu",), "import elprep_tpu_torch\nimport elprep_tpu\n", tiny.ROOT)
    assert p.returncode != 0 and "blocked: elprep_tpu" in p.stderr


def test_reference_and_generator_load_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from reference import judge, bqsr, gvcf, markdup, records\n"
            "from gen import fixture\n"
            "import control\n") % tiny.BENCH
    p = _python(("jax", "jaxlib", "flax", "elprep_tpu", "elprep_tpu_torch", "torch"), code,
                tiny.ROOT)
    assert p.returncode == 0, p.stderr[-3000:]
