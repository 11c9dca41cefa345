"""The 2x300 bp path of the port on the CPU: a small version of
chip_smoke.py's 2x300 fixture (300 bp read pairs over a genome with
hypervariable stretches, soft clips realigned, 2% duplicates under
Illumina qnames) through bench.py's 5-step command in the port's CLI and
in the JAX package's, record for record. The stretches are what sends
reads over 256 bases to the PairHMM (the stripe path's reads on the
card): the test shows that one of the port's PairHMM batches held one.

The stretches here have 5 SNPs 50-62 bp apart (218-232 bp, as on the
card) rather than the card fixture's 8-10 SNPs 25-35 bp apart: the
assembler threads the reference through every SNP of a stretch, so 8-10
SNPs give regions of 90-170 haplotypes, and the PairHMM's plain version
takes minutes over their pairs on the CPU.
"""

import gzip

import pytest
import torch

from chip_smoke import make_long_read_fixture
from elprep_tpu import cli as jax_cli
from elprep_tpu.ops import pairhmm as jax_pairhmm
from elprep_tpu_torch import cli
from elprep_tpu_torch.ops import pairhmm_cuda as pc

torch.set_num_threads(1)

CONTIGS = [("chr1", 6_000), ("chr2", 4_000)]


@pytest.fixture(autouse=True)
def _restore_jax_pairhmm_state(monkeypatch):
    """The JAX CLI's PairHMM session backend and mesh are module state:
    fresh for this test, and put back after it."""
    monkeypatch.setattr(jax_pairhmm, "_MESH", [None])
    monkeypatch.setattr(jax_pairhmm, "_SESSION_BACKEND", [None])


@pytest.fixture
def on_cpu(monkeypatch):
    monkeypatch.setenv("ELPREP_TPU_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("ELPREP_TPU_HC_WORKERS", "2")


def _five_step(main, fx, elfasta, out):
    out.mkdir()
    argv = ["filter", fx["sam"], str(out / "out.sam"), "--mark-duplicates",
            "--mark-optical-duplicates", str(out / "metrics.txt"),
            "--sorting-order", "coordinate", "--bqsr", str(out / "out.recal"),
            "--known-sites", fx["sites"], "--reference", elfasta,
            "--haplotypecaller", str(out / "out.vcf.gz"),
            "--reference-confidence", "GVCF"]
    assert main(argv) == 0
    return out


def _outputs(out):
    """SAM body (@PG CL embeds the argv), recal, metrics body, VCF body."""
    sam = [ln for ln in (out / "out.sam").read_bytes().split(b"\n")
           if not ln.startswith(b"@PG")]
    metrics = [ln for ln in (out / "metrics.txt").read_text().splitlines()
               if not ln.startswith("#")]
    vcf = [ln for ln in gzip.open(out / "out.vcf.gz", "rb").read().split(b"\n")
           if not ln.startswith(b"##")]
    return sam, (out / "out.recal").read_text(), metrics, vcf


def test_two_by_300_five_step_matches_jax_cli(tmp_path, monkeypatch, on_cpu):
    """1 200 reads of 300 bp over 10 kb with 3 hypervariable stretches:
    the port's 5-step run (pooled, two workers) and the JAX CLI's give the
    same BAM records, recal report, metrics body and GVCF body; the
    duplicates are flagged, the stretches called, and some PairHMM batch
    held a read over 256 bases."""
    ref, fx = make_long_read_fixture(str(tmp_path), 1_200, CONTIGS, 3_000,
                                     snps_every_kb=False, stretch_snps=(5, 5),
                                     stretch_gap=(50, 62))
    assert len(ref["stretches"]) == 3
    jax_ref = str(tmp_path / "jax.elfasta")
    assert jax_cli.main(["fasta-to-elfasta", str(tmp_path / "long.fasta"), jax_ref]) == 0
    longest = []
    orig = pc.pack_pairs

    def pack(*a):
        batch = orig(*a)
        longest.append(batch.max_read_len)
        return batch

    monkeypatch.setattr(pc, "pack_pairs", pack)
    port = _outputs(_five_step(cli.main, fx, ref["elfasta"], tmp_path / "port"))
    assert longest and max(longest) > pc.WARP_MAX_READ_LEN, longest
    assert pc.launch_plan(max(longest))[0] == "stripe"
    jax = _outputs(_five_step(jax_cli.main, fx, jax_ref, tmp_path / "jax"))
    assert port == jax
    sam, _, _, vcf = port
    assert len(sam) > 1_200 and any(int(ln.split(b"\t")[1]) & 0x400
                                     for ln in sam if ln and not ln.startswith(b"@"))
    calls = [ln.split(b"\t") for ln in vcf if ln and not ln.startswith(b"#")
             and ln.split(b"\t")[4] != b"<NON_REF>"]
    for contig, first, last in ref["stretches"]:
        assert any(c[0].decode() == contig and first < int(c[1]) <= last + 1
                   for c in calls), (contig, first, last)
