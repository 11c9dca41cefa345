"""A control of why a capture cell needs ``qual_model``: on one small
capture design, the port leaves a clear heterozygous site uncalled under
samgen's qualities and calls it under ``"hiseq2000"``.

The design: the tests' capture configuration at 30x over targets of
120-300 bp with gaps of 1.5-4.5 kb on 100 kb, 75 % of pairs on target,
``world_seed`` 10. The site: chr1:20838, a planted het C whose pileup
reads A,C,G,T 0,9,0,10. Its stage is the HaplotypeCaller's assembly. The
site lies in the active region chr1:20801-20853. For it,
``hc/driver.py::prepare_region`` hands ``assemble_reads`` 58 reads, and
the call returns the reference haplotype alone; at ``min_base_qual=0``
the same call returns four. So ``trim`` sees no event, and the region
leaves through the reference model (0/0). The cause is in the generator.
samgen's qualities are uniform in Q2-39. BQSR keeps Q2-5 as they are
(below 6) and recalibrates the rest to about Q20, so 11.2 % of the
region's bases are below Q10. The assembler threads only runs of bases
at Q10 or above (GATK's ``minBaseQualityToUseInAssembly``), and too few
runs hold the alt k-mers. Under ``"hiseq2000"``, 0.2 % of the bases are
below Q10, all in 3' Q2 tails, and the assembly returns the alt
haplotype. chr1:30744 and chr1:53515 are left uncalled the same way.

The port runs on the CPU, serially, one job of ``filter`` through
``elprep_tpu_torch.cli`` with ``--target-regions``; the reference judges
its outputs. Every exact number reads 0 under both models."""

import contextlib
import json
import os
import sys

import tiny
from gen import fixture
from reference import judge

DESIGN = {"world_seed": 10, "depth": 30, "contigs": [["chr1", 60000], ["chr2", 40000]],
          "target_gap": [1500, 4500], "on_target_share": 0.75}
SITE = "chr1:20838: reads 0/1 C (ACGT 0,9,0,10)"


def _job(work, cfg, seed=7):
    """(numbers, notes) of one 5-step job on ``cfg``'s inputs."""
    from elprep_tpu_torch import cli

    fx = fixture.make_fixture(cfg, seed)
    p = fixture.write_inputs(fx, work, "input")
    p.update(elfasta=os.path.join(work, "input.elfasta"), sites=os.path.join(work, "input.elsites"))
    assert cli.main(["fasta-to-elfasta", p["fasta"], p["elfasta"]]) == 0
    assert cli.main(["bed-to-elsites", p["bed"], p["sites"]]) == 0
    out = {k: os.path.join(work, "out." + k) for k in ("bam", "metrics", "recal")}
    out["gvcf"] = os.path.join(work, "out.g.vcf.gz")
    argv = ["filter", p["sam"], out["bam"], "--mark-duplicates", "--mark-optical-duplicates",
            out["metrics"], "--sorting-order", "coordinate", "--bqsr", out["recal"],
            "--known-sites", p["sites"], "--reference", p["elfasta"],
            "--target-regions", p["targets"], "--haplotypecaller", out["gvcf"],
            "--reference-confidence", "GVCF"]
    with contextlib.redirect_stdout(sys.stderr):
        assert cli.main(argv) == 0
    exp = judge.Expected(p, ["bam", "metrics", "recal", "gvcf"],
                         [(c, q) for c, q, _, _ in fx.snps], p["targets"])
    notes = []
    return judge.judge(exp, out, notes), notes


def test_hiseq2000_calls_a_site_that_scattered_low_qualities_leave_uncalled(tmp_path, monkeypatch):
    import torch

    monkeypatch.setenv("ELPREP_TPU_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("ELPREP_TPU_HC_WORKERS", "1")
    torch.set_num_threads(1)
    with open(os.path.join(tiny.HERE, "configs", "capture_test.json")) as fh:
        cfg = dict(json.load(fh), **DESIGN)

    samgen, notes = _job(str(tmp_path / "samgen"), cfg)
    assert SITE + ", gvcf uncalled" in notes, notes
    assert samgen["gvcf_discordant_pct"] > 5

    hiseq, notes = _job(str(tmp_path / "hiseq2000"), dict(cfg, qual_model="hiseq2000"))
    assert not notes and hiseq["gvcf_discordant_pct"] == 0, notes
    for got in (samgen, hiseq):
        assert not {n: v for n, v in got.items() if n != "gvcf_discordant_pct" and v}, got
