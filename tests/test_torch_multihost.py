"""The port's multi-process runner (``python -m
elprep_tpu_torch.parallel.multihost``) on gloo CPU processes, against the
single-process run and the JAX package (tests/test_multihost.py's and
tests/test_crossmode.py's fixtures): two processes x ``--local-devices 4``
form eight shards, the sort/dedup verdicts come back through
``all_gather_into_tensor`` and the BQSR tables through ``all_reduce``;
every process's outputs must byte-equal the single-process run's. Also:
the contig-partitioned HaplotypeCaller across two processes, serial ==
``--sharded`` == ``sfm`` on the adversarial fixture, and pool workers
spawned after the process group joined hold no group and no card."""

import gzip
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import samgen
import test_crossmode as jcm
import test_multihost as jmh
from elprep_tpu import cli as jax_cli
from elprep_tpu.ops import pairhmm as jax_pairhmm
from elprep_tpu.parallel.multihost import hc_contig_partition as jhc_contig_partition
from elprep_tpu_torch import cli
from elprep_tpu_torch.parallel import mesh as pmesh
from elprep_tpu_torch.parallel import multihost

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 180


@pytest.fixture(autouse=True)
def _restore_jax_pairhmm_state(monkeypatch):
    """The JAX CLI keeps its PairHMM mesh and session backend in module
    state: ``--sharded`` sets an 8-device mesh that only its next
    non-sharded run clears, and the first HaplotypeCaller dispatch commits
    the backend. Each test gets fresh state, and the state before it comes
    back after it, so no later test on the same worker sees this one's."""
    monkeypatch.setattr(jax_pairhmm, "_MESH", [None])
    monkeypatch.setattr(jax_pairhmm, "_SESSION_BACKEND", [None])


@pytest.fixture
def on_cpu(monkeypatch):
    monkeypatch.setenv("ELPREP_TPU_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("ELPREP_TPU_HC_WORKERS", "2")


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _env(**extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["ELPREP_TPU_TORCH_DEVICE"] = "cpu"
    env["ELPREP_TPU_HC_WORKERS"] = "2"
    env.update(extra)
    return env


def _run_ranks(argv_of, n=2, local_devices=4, env=None):
    """``n`` multihost processes on one rendezvous, each with its own
    subprocess timeout; returns their combined outputs."""
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "elprep_tpu_torch.parallel.multihost",
         "--coordinator", f"127.0.0.1:{port}", "--num-processes", str(n),
         "--process-id", str(pid), "--local-devices", str(local_devices), "--"]
        + argv_of(pid), env=env or _env(), cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT) for pid in range(n)]
    outs, fail = [], []
    try:
        for pid, pr in enumerate(procs):
            out, _ = pr.communicate(timeout=TIMEOUT_S)
            outs.append(out.decode(errors="replace"))
            if pr.returncode != 0:
                fail.append((pid, pr.returncode, outs[-1][-3000:]))
    finally:
        for pr in procs:
            if pr.poll() is None:
                pr.kill()
                pr.wait()
    assert not fail, f"multihost process failures: {fail}"
    return outs


def _elfasta(tmp_path, contigs, genome):
    fasta = tmp_path / "ref.fasta"
    fasta.write_text("".join(f">{n}\n{genome[n].decode()}\n" for n, _ in contigs))
    for name, main in (("jax", jax_cli.main), ("port", cli.main)):
        assert main(["fasta-to-elfasta", str(fasta), str(tmp_path / f"{name}.elfasta")]) == 0
    return tmp_path / "port.elfasta", tmp_path / "jax.elfasta"


def _vcf_records(p):
    return [ln for ln in gzip.open(p, "rb").read().split(b"\n") if not ln.startswith(b"##")]


def test_hc_contig_partition_matches_jax():
    rng = np.random.RandomState(3)
    for n_procs in (1, 2, 3, 5):
        for _ in range(20):
            counts = rng.randint(0, 1000, rng.randint(0, 12))
            got = multihost.hc_contig_partition(counts, n_procs)
            np.testing.assert_array_equal(got, jhc_contig_partition(counts, n_procs))
            assert (np.diff(got) >= 0).all()


def test_gather_barrier_needs_initialize():
    with pytest.raises(RuntimeError, match="initialize"):
        multihost.hc_gather_barrier("x")


def test_two_gloo_processes_byte_equal(tmp_path, on_cpu):
    """tests/test_multihost.py:77-131 on the port: 2 processes x 4 mesh
    entries, dedup + optical + sort + BQSR, no HaplotypeCaller. Both
    processes' BAM records, recal report and metrics body equal the
    single-process run's and the JAX package's."""
    sam_in = tmp_path / "in.sam"
    sam_in.write_bytes(jmh._make_sam())
    rng = np.random.RandomState(7)
    bases = np.frombuffer(b"ACGT", np.uint8)
    genome = {name: rng.choice(bases, ln).tobytes() for name, ln in jmh.CONTIGS}
    port_ref, jax_ref = _elfasta(tmp_path, jmh.CONTIGS, genome)
    plain, jplain = tmp_path / "plain", tmp_path / "jplain"
    plain.mkdir()
    jplain.mkdir()
    assert cli.main(jmh._filter_args(sam_in, plain, port_ref)) == 0
    assert jax_cli.main(jmh._filter_args(sam_in, jplain, jax_ref)) == 0
    outs = [tmp_path / f"rank{pid}" for pid in range(2)]
    for out in outs:
        out.mkdir()
    _run_ranks(lambda pid: jmh._filter_args(sam_in, outs[pid], port_ref))
    want = jmh._body(plain / "out.sam")
    assert len(want) > 1200 and want == jmh._body(jplain / "out.sam")
    for out in outs:
        assert jmh._body(out / "out.sam") == want
        assert (out / "out.recal").read_text() == (plain / "out.recal").read_text() \
            == (jplain / "out.recal").read_text()
        assert jmh._metrics(out / "metrics.txt") == jmh._metrics(plain / "metrics.txt") \
            == jmh._metrics(jplain / "metrics.txt")


def test_two_processes_contig_partitioned_haplotypecaller(tmp_path, on_cpu):
    """tests/test_multihost.py:288 on the port: the 5-step run with the
    GVCF HaplotypeCaller across 2 processes, each calling its contiguous
    contig slice, the shard VCFs gathered in contig order: record-equal
    to the single-process run and the JAX package's, identical across
    processes, shard files cleaned up."""
    genome = samgen.make_genome(jmh.CONTIGS, seed=23)
    header = samgen.make_header_lines(
        jmh.CONTIGS, rgs=[{"ID": "rg1", "LB": "lib1", "SM": "s1", "PU": "u1"}])
    lines = samgen.reads_from_genome(900, jmh.CONTIGS, genome, seed=29, rg_ids=["rg1"])
    sam_in = tmp_path / "in.sam"
    sam_in.write_text("\n".join(header + lines) + "\n")
    port_ref, jax_ref = _elfasta(tmp_path, jmh.CONTIGS, genome)

    def hc_args(out_dir, ref):
        return jmh._filter_args(sam_in, out_dir, ref, [
            "--haplotypecaller", str(out_dir / "out.vcf.gz"),
            "--reference-confidence", "GVCF"])

    plain, jplain = tmp_path / "plain", tmp_path / "jplain"
    plain.mkdir()
    jplain.mkdir()
    assert cli.main(hc_args(plain, port_ref)) == 0
    assert jax_cli.main(hc_args(jplain, jax_ref)) == 0
    shard_dir = tmp_path / "shards"
    shard_dir.mkdir()
    outs = [tmp_path / f"rank{pid}" for pid in range(2)]
    for out in outs:
        out.mkdir()
    _run_ranks(lambda pid: hc_args(outs[pid], port_ref),
               env=_env(ELPREP_TPU_HC_SHARD_DIR=str(shard_dir)))
    ref_records = _vcf_records(plain / "out.vcf.gz")
    assert len(ref_records) > 10 and ref_records == _vcf_records(jplain / "out.vcf.gz")
    for out in outs:
        assert _vcf_records(out / "out.vcf.gz") == ref_records
        assert jmh._body(out / "out.sam") == jmh._body(plain / "out.sam")
    assert not list(shard_dir.glob("*.part*")), "shard VCFs and sidecars must go"
    assert (outs[0] / "out.vcf.gz").read_bytes() == (outs[1] / "out.vcf.gz").read_bytes()


def test_crossmode_serial_sharded_sfm_record_identical(tmp_path, on_cpu, monkeypatch):
    """tests/test_crossmode.py's adversarial fixture (N bases, MAPQ 0,
    secondary/supplementary, unmapped, cross-contig pairs, a >50-deep
    pileup that fires the downsampler) through the port: serial ``filter``,
    ``filter --sharded`` on 8 CPU shards and ``sfm`` give the same BAM
    records, GVCF records, recal report and metrics body."""
    from elprep_tpu_torch.io import sam as samio

    genome, sam_bytes = jcm._adversarial_sam()
    sam_in = tmp_path / "in.sam"
    sam_in.write_bytes(sam_bytes)
    port_ref, _ = _elfasta(tmp_path, jcm.CONTIGS, genome)
    monkeypatch.setattr(pmesh, "_LOCAL_DEVICES", [8])

    def run(cmd, out_dir, extra=()):
        out_dir.mkdir()
        argv = [cmd, str(sam_in), str(out_dir / "out.bam"), "--mark-duplicates",
                "--mark-optical-duplicates", str(out_dir / "metrics.txt"),
                "--sorting-order", "coordinate", "--bqsr", str(out_dir / "out.recal"),
                "--reference", str(port_ref),
                "--haplotypecaller", str(out_dir / "out.vcf.gz"),
                "--reference-confidence", "GVCF", *extra]
        assert cli.main(argv) == 0, argv
        return out_dir

    def bam_body(p):
        hdr, batch = samio.read_sam_file(str(p))
        return [ln for ln in samio.format_sam(hdr, batch).split(b"\n")
                if not ln.startswith(b"@")]

    serial = run("filter", tmp_path / "serial")
    sharded = run("filter", tmp_path / "sharded", ["--sharded"])
    sfm = run("sfm", tmp_path / "sfm",
              ["--tmp-path", str(tmp_path / "t"), "--contig-group-size", "1"])
    ref_bam = bam_body(serial / "out.bam")
    ref_vcf = _vcf_records(serial / "out.vcf.gz")
    assert len(ref_vcf) > 100
    for mode in (sharded, sfm):
        assert bam_body(mode / "out.bam") == ref_bam, mode
        assert _vcf_records(mode / "out.vcf.gz") == ref_vcf, mode
        assert (mode / "out.recal").read_text() == (serial / "out.recal").read_text()
        assert jcm._metrics(mode / "metrics.txt") == jcm._metrics(serial / "metrics.txt")


_POOL_AFTER_INIT = r"""
import os, sys
import torch.distributed as dist
from elprep_tpu_torch.hc import parallel
from elprep_tpu_torch.parallel import make_mesh, multihost

backend = multihost.initialize(sys.argv[1], 1, 0, local_devices=3)
assert backend == "gloo" and dist.is_initialized(), backend
assert len(make_mesh()) == 3
pool = parallel.get_pool(2)
infos = pool.probe_workers()
assert len(infos) == 2, infos
for info in infos:
    assert info["dist_initialized"] is False, info
    assert info["rendezvous_env"] == [], info
    assert info["device"] == "cpu" and info["cuda_initialized"] is False, info
multihost.hc_gather_barrier("t")
parallel.shutdown_pool()
dist.destroy_process_group()
print("ok", len(infos))
"""


def test_pool_workers_spawned_in_a_process_group_hold_none():
    """The CLI spawns its pool after the process group is up: the workers
    are spawned, not forked, and the rendezvous is passed as init_method,
    so no worker joins the group or sees MASTER_ADDR/RANK, and none opens
    a CUDA context."""
    proc = subprocess.run(
        [sys.executable, "-c", _POOL_AFTER_INIT, f"127.0.0.1:{_free_port()}"],
        capture_output=True, text=True, env=_env(), cwd=REPO, timeout=TIMEOUT_S)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.split()[-2:] == ["ok", "2"]
