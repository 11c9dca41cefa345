"""The port imports neither jax nor the JAX package: every module of
elprep_tpu_torch (parallel/ included, whose import joins no process
group), and chip_smoke.py, import in a fresh interpreter whose import
system refuses ``jax`` and ``elprep_tpu``. It runs as a subprocess
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
parallel = {n for n in names if n.startswith("elprep_tpu_torch.parallel")}
assert parallel == {"elprep_tpu_torch.parallel"} | {
    "elprep_tpu_torch.parallel." + m
    for m in ("mesh", "sharded", "pipeline", "multihost")}, parallel
# importing the multi-process runner joins no process group
import torch.distributed as dist
assert not dist.is_initialized()
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


# installed as sitecustomize.py on PYTHONPATH: every interpreter started
# with that environment (spawned pool workers, sfm job subprocesses)
# refuses jax and elprep_tpu and logs its pid
_SITECUSTOMIZE = r"""
import importlib.abc, os, sys

class _Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "elprep_tpu"):
            raise ImportError("blocked import of " + name)
        return None

sys.meta_path.insert(0, _Block())
with open(os.environ["GUARD_LOG"], "a") as fh:
    fh.write("%d\n" % os.getpid())
"""

_POOLED_RUN = r"""
import sys
import numpy as np
from elprep_tpu_torch import device
from elprep_tpu_torch.core.header import Header
from elprep_tpu_torch.filters.clipping import ClipRead
from elprep_tpu_torch.hc import driver, parallel
from elprep_tpu_torch.hc.activity import make_hc_params
from elprep_tpu_torch.hc.refconf import expand_variants
from elprep_tpu_torch.io.vcf import format_variant

device.set_default_device("cpu")
rng = np.random.RandomState(5)
ref = rng.choice(np.frombuffer(b"ACGT", np.uint8), 3000).tobytes()
alt = ref[:1500] + (b"A" if ref[1500:1501] != b"A" else b"C") + ref[1501:]
reads = []
for i in range(40):
    start = 1400 + (i * 5) % 100
    seq = (ref if i % 2 else alt)[start : start + 120]
    reads.append(ClipRead(flag=0x63 if i % 2 == 0 else 0x93, pos=start + 1,
                          pnext=start + 151, tlen=300 if i % 2 == 0 else -300,
                          mapq=60, cigar=[(120, "M")], seq=seq,
                          qual=bytes([35]) * 120, rname=b"chr1", rnext=b"=",
                          qname=b"g%04d" % i))
reads.sort(key=lambda r: r.pos)
hdr = Header()
hdr.sq = [{"SN": "chr1", "LN": "3000"}]
out = {}
for nw in (1, 2):
    _, v = driver.call_variants(make_hc_params("GVCF", command_line="t"), hdr,
                                {"chr1": list(reads)}, lambda c: ref,
                                sample_name="s1", nr_workers=nw)
    out[nw] = [format_variant(x) for x in expand_variants(v)]
assert parallel.get_pool(2) is not None
assert out[1] == out[2] and out[1], out
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "elprep_tpu"))
assert not bad, bad
print(len(out[1]))
"""


def _guarded_env(tmp_path):
    (tmp_path / "site").mkdir()
    (tmp_path / "site" / "sitecustomize.py").write_text(_SITECUSTOMIZE)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(tmp_path / "site"), REPO])
    env["GUARD_LOG"] = str(tmp_path / "guard.log")
    env["ELPREP_TPU_TORCH_DEVICE"] = "cpu"
    return env


def _guarded_pids(tmp_path):
    return set((tmp_path / "guard.log").read_text().split())


def test_pool_workers_import_no_jax(tmp_path):
    """A pooled call_variants in a guarded interpreter: its spawned
    workers start under the same guard and import neither jax nor
    elprep_tpu, and the pooled records equal the serial ones."""
    env = _guarded_env(tmp_path)
    proc = subprocess.run([sys.executable, "-c", _POOLED_RUN], capture_output=True,
                          text=True, env=env, cwd=str(tmp_path), timeout=600)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) > 0
    assert len(_guarded_pids(tmp_path)) >= 3  # the run and its two workers


def test_sfm_job_subprocesses_import_no_jax(tmp_path):
    """``sfm --nr-of-jobs 2`` runs each contig group in a ``python -m
    elprep_tpu_torch filter`` subprocess; under the guard every one of
    them (and their pools' workers) imports neither jax nor elprep_tpu."""
    env = _guarded_env(tmp_path)
    lines = ["@HD\tVN:1.6\tSO:unknown", "@SQ\tSN:c1\tLN:5000", "@SQ\tSN:c2\tLN:5000",
             "@RG\tID:rg1\tLB:l1\tSM:s1"]
    for i in range(20):
        c, p = ("c1", "c2")[i % 2], 100 + 37 * i
        lines.append(f"r{i}\t0\t{c}\t{p}\t60\t20M\t*\t0\t0\t{'ACGT' * 5}\t{'I' * 20}\tRG:Z:rg1")
    (tmp_path / "in.sam").write_text("\n".join(lines) + "\n")
    proc = subprocess.run(
        [sys.executable, "-m", "elprep_tpu_torch", "sfm", "in.sam", "out.sam",
         "--nr-of-jobs", "2", "--contig-group-size", "1", "--tmp-path", "t",
         "--mark-duplicates", "--sorting-order", "coordinate"],
        capture_output=True, text=True, env=env, cwd=str(tmp_path), timeout=600)
    assert proc.returncode == 0, proc.stderr
    out = (tmp_path / "out.sam").read_text().splitlines()
    assert sum(1 for ln in out if not ln.startswith("@")) == 20
    # the sfm process and a filter job per group (unmapped, c1, c2)
    assert len(_guarded_pids(tmp_path)) >= 4
