"""The port's CLI on the CPU (ELPREP_TPU_TORCH_DEVICE=cpu): the
HaplotypeCaller, duplicate-marking, metrics and BQSR goldens byte for
byte, the same outputs as ``python -m elprep_tpu filter`` record for
record (the 5-step pipeline included), the converters, the refusal of
options not yet ported, and no silent CPU run when cuda is asked for and
absent."""

import gzip
import os
import random

import numpy as np
import pytest
import torch

import samgen
from chip_smoke import realign_soft_clips
from elprep_tpu import cli as jax_cli
from elprep_tpu_torch import cli
from elprep_tpu_torch.io import sam as samio
from elprep_tpu_torch.ops import dispatch

torch.set_num_threads(1)

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
CONTIGS = [("chr1", 12_000), ("chr2", 8_000)]


@pytest.fixture
def on_cpu(monkeypatch):
    monkeypatch.setenv("ELPREP_TPU_TORCH_DEVICE", "cpu")


def _mask(data: bytes) -> bytes:
    return b"\n".join(
        b"##elPrepCommandLine=<masked>" if ln.startswith(b"##elPrepCommandLine")
        else ln for ln in data.split(b"\n"))


@pytest.mark.parametrize("mode,ext", [("NONE", "vcf"), ("GVCF", "gvcf")])
def test_hc_golden_byte_equal(tmp_path, on_cpu, mode, ext):
    ref = str(tmp_path / "ref.elfasta")
    assert cli.main(["fasta-to-elfasta",
                     os.path.join(FIXTURES, "hc_golden.ref.fasta"), ref]) == 0
    out = str(tmp_path / "out.vcf")
    assert cli.main(["filter", os.path.join(FIXTURES, "hc_golden.in.sam"),
                     str(tmp_path / "out.sam"), "--reference", ref,
                     "--haplotypecaller", out, "--reference-confidence", mode]) == 0
    with open(out, "rb") as fh:
        got = _mask(fh.read())
    with open(os.path.join(FIXTURES, f"hc_golden.expected.{ext}"), "rb") as fh:
        assert got == fh.read()


def _read(path):
    with open(path, "rb") as fh:
        return fh.read()


def test_dedup_golden_byte_equal(tmp_path, on_cpu):
    out = str(tmp_path / "out.sam")
    assert cli.main([
        "filter", os.path.join(FIXTURES, "dedup_golden.in.sam"), out,
        "--mark-duplicates", "--sorting-order", "coordinate",
        "--pg-cmd-line",
        "elprep filter dedup_golden.in.sam dedup_golden.out.sam "
        "--mark-duplicates --sorting-order coordinate"]) == 0
    assert _read(out) == _read(os.path.join(FIXTURES, "dedup_golden.expected.sam"))


def test_metrics_golden_byte_equal(tmp_path, on_cpu):
    metrics = str(tmp_path / "metrics.txt")
    assert cli.main([
        "filter", os.path.join(FIXTURES, "metrics_golden.in.sam"),
        str(tmp_path / "out.sam"), "--mark-duplicates",
        "--mark-optical-duplicates", metrics, "--sorting-order", "coordinate"]) == 0
    got = _read(metrics)
    assert got[got.index(b"## METRICS CLASS"):] == _read(
        os.path.join(FIXTURES, "metrics_golden.expected.txt"))


def test_bqsr_golden_byte_equal(tmp_path, on_cpu):
    ref = str(tmp_path / "ref.elfasta")
    assert cli.main(["fasta-to-elfasta",
                     os.path.join(FIXTURES, "bqsr_golden.ref.fasta"), ref]) == 0
    recal = str(tmp_path / "out.recal")
    assert cli.main(["filter", os.path.join(FIXTURES, "bqsr_golden.in.sam"),
                     str(tmp_path / "out.sam"), "--bqsr", recal,
                     "--reference", ref]) == 0
    assert _read(recal) == _read(os.path.join(FIXTURES, "bqsr_golden.expected.recal"))


@pytest.fixture(scope="module")
def fixture_files(tmp_path_factory):
    """A samgen fixture whose reads come from a genome with a SNP planted
    every ~400 bp (so the HaplotypeCaller has regions to call), the
    reference as .elfasta for each package, and a BED file."""
    wd = tmp_path_factory.mktemp("torch_cli")
    genome = samgen.make_genome(CONTIGS, seed=41)
    rng = random.Random(43)
    alt, snps = {}, []
    for name, ln in CONTIGS:
        seq = bytearray(genome[name])
        for p in range(300, ln - 300, 400):
            p += rng.randrange(-100, 100)
            seq[p] = ord(rng.choice([b for b in "ACGT" if ord(b) != seq[p]]))
            snps.append((name, p))
        alt[name] = bytes(seq)
    header = samgen.make_header_lines(
        CONTIGS, rgs=[{"ID": "rg1", "LB": "lib1", "SM": "s1", "PU": "u1"}])
    lines = samgen.reads_from_genome(2400, CONTIGS, alt, seed=47, rg_ids=["rg1"])
    sam = wd / "in.sam"
    sam.write_text("\n".join(header + lines) + "\n")
    fasta = wd / "ref.fasta"
    with open(fasta, "w") as fh:
        for name, _ in CONTIGS:
            fh.write(f">{name}\n{genome[name].decode()}\n")
    assert jax_cli.main(["fasta-to-elfasta", str(fasta), str(wd / "jax.elfasta")]) == 0
    assert cli.main(["fasta-to-elfasta", str(fasta), str(wd / "port.elfasta")]) == 0
    assert (wd / "jax.elfasta").read_bytes() == (wd / "port.elfasta").read_bytes()
    (wd / "regions.bed").write_text("chr1\t1000\t6000\nchr2\t2000\t7000\n")
    # the same reads (soft-clipped ones moved where their bases came
    # from, so BQSR leaves the HaplotypeCaller bases to call) plus
    # duplicate pairs with Illumina qnames, the second copy of each
    # within optical distance of the first (as bench.py builds its
    # end-to-end fixture), and the planted SNPs as known sites
    lines = realign_soft_clips(lines)
    rng = random.Random(13)
    dups = []
    while len(dups) < 160:
        idx = rng.randrange(0, len(lines) // 2) * 2
        f, m = lines[idx].split("\t"), lines[idx + 1].split("\t")
        x, y = rng.randrange(1000, 30000), rng.randrange(1000, 30000)
        for k in range(2):
            q = (f"M01:1:FC:1:2208:{x + k * rng.randrange(0, 80)}:"
                 f"{y + k * rng.randrange(0, 80)}")
            dups.append("\t".join([q] + f[1:]))
            dups.append("\t".join([q] + m[1:]))
    (wd / "dups.sam").write_text("\n".join(header + lines + dups) + "\n")
    (wd / "sites.bed").write_text("".join(f"{name}\t{p}\t{p + 1}\n"
                                          for name, p in snps))
    assert cli.main(["bed-to-elsites", str(wd / "sites.bed"),
                     str(wd / "sites.elsites")]) == 0
    return wd


def _records(path):
    """(header lines with the @PG CL field dropped, formatted records)."""
    hdr, batch = samio.read_sam_file(str(path))
    head = []
    for ln in samio.format_sam_header(hdr).decode().splitlines():
        if ln.startswith("@PG"):
            ln = "\t".join(f for f in ln.split("\t") if not f.startswith("CL:"))
        head.append(ln)
    return head, samio.format_alignments(batch).split(b"\n")


def _vcf_body(path):
    with open(path, "rb") as fh:
        data = fh.read()
    if data[:2] == b"\x1f\x8b":
        data = gzip.decompress(data)
    return [ln for ln in data.split(b"\n") if not ln.startswith(b"##elPrepCommandLine")]


@pytest.mark.parametrize("extra", [
    ["--sorting-order", "coordinate", "--haplotypecaller", "{out}/out.vcf.gz",
     "--reference-confidence", "GVCF"],
    ["--sorting-order", "coordinate", "--haplotypecaller", "{out}/out.vcf",
     "--reference-confidence", "NONE", "--target-regions", "{wd}/regions.bed",
     "--filter-mapping-quality", "20"],
    ["--sorting-order", "queryname", "--filter-non-overlapping-reads",
     "{wd}/regions.bed"],
    ["--filter-unmapped-reads", "--keep-optional-fields", "none"],
], ids=["coord_gvcf", "coord_vcf_targets", "queryname", "streaming"])
def test_matches_jax_cli_record_for_record(fixture_files, tmp_path, on_cpu, extra):
    wd = fixture_files
    outs = {}
    for name, main in (("jax", jax_cli.main), ("port", cli.main)):
        od = tmp_path / name
        od.mkdir()
        args = [a.format(out=od, wd=wd) for a in extra]
        argv = ["filter", str(wd / "in.sam"), str(od / "out.bam"),
                "--reference", str(wd / f"{name}.elfasta"), "--nr-of-threads", "1",
                *args]
        assert main(argv) == 0, name
        outs[name] = od
    jh, jr = _records(outs["jax"] / "out.bam")
    ph, pr = _records(outs["port"] / "out.bam")
    assert ph == jh
    assert len(pr) > 1000 and pr == jr
    vcfs = [f for f in os.listdir(outs["jax"]) if ".vcf" in f]
    for f in vcfs:
        body = _vcf_body(outs["port"] / f)
        assert body == _vcf_body(outs["jax"] / f)
        if "GVCF" in extra:
            # the fixture's planted SNPs are called
            calls = [ln for ln in body if ln and not ln.startswith(b"#")
                     and ln.split(b"\t")[4] != b"<NON_REF>"]
            assert len(calls) >= 5


def _metrics_body(path):
    data = _read(path)
    return data[data.index(b"## METRICS CLASS"):]


_FIVE_STEP = {
    "dedup_optical": ["--mark-duplicates", "--mark-optical-duplicates",
                      "{out}/metrics.txt", "--sorting-order", "coordinate"],
    "bqsr_known_sites": ["--bqsr", "{out}/out.recal", "--known-sites",
                         "{wd}/sites.elsites", "--sorting-order", "coordinate"],
    "five_step": ["--mark-duplicates", "--mark-optical-duplicates",
                  "{out}/metrics.txt", "--sorting-order", "coordinate",
                  "--bqsr", "{out}/out.recal", "--known-sites", "{wd}/sites.elsites",
                  "--haplotypecaller", "{out}/out.vcf.gz",
                  "--reference-confidence", "GVCF"],
}


@pytest.mark.parametrize("case,route", [
    ("dedup_optical", "host"), ("bqsr_known_sites", "host"), ("five_step", "host"),
    ("five_step", "torch")])
def test_five_step_matches_jax_cli(fixture_files, tmp_path, monkeypatch, on_cpu,
                                   case, route):
    """Duplicate marking, optical duplicates and BQSR through both CLIs on
    the fixture with duplicate pairs appended: the same BAM records, recal
    file, metrics (command line and date masked) and GVCF body. The
    ``torch`` route runs the port's torch programs on the CPU (the code
    the card runs) instead of its CPU route's native engines."""
    wd = fixture_files
    outs = {}
    for name, main in (("jax", jax_cli.main), ("port", cli.main)):
        od = tmp_path / name
        od.mkdir()
        if name == "port" and route == "torch":
            monkeypatch.setattr(dispatch, "routes_to_host", lambda n, device=None: False)
        args = [a.format(out=od, wd=wd) for a in _FIVE_STEP[case]]
        argv = ["filter", str(wd / "dups.sam"), str(od / "out.bam"),
                "--reference", str(wd / f"{name}.elfasta"), "--nr-of-threads", "1",
                *args]
        assert main(argv) == 0, name
        outs[name] = od
    jh, jr = _records(outs["jax"] / "out.bam")
    ph, pr = _records(outs["port"] / "out.bam")
    assert ph == jh
    assert len(pr) > 2000 and pr == jr
    if "--mark-duplicates" in _FIVE_STEP[case]:
        _, batch = samio.read_sam_file(str(outs["port"] / "out.bam"))
        assert int(((batch.flag & 0x400) != 0).sum()) >= 160
        pm = _metrics_body(outs["port"] / "metrics.txt")
        assert pm == _metrics_body(outs["jax"] / "metrics.txt")
        row = [ln.split(b"\t") for ln in pm.split(b"\n") if ln.startswith(b"lib1\t")]
        assert len(row) == 1 and int(row[0][7]) > 0  # optical duplicates found
    if "--bqsr" in _FIVE_STEP[case]:
        recal = _read(outs["port"] / "out.recal")
        assert recal == _read(outs["jax"] / "out.recal")
        assert b"\nu1 " in recal  # the read group's row (its PU)
    if "--haplotypecaller" in _FIVE_STEP[case]:
        body = _vcf_body(outs["port"] / "out.vcf.gz")
        assert body == _vcf_body(outs["jax"] / "out.vcf.gz")
        calls = [ln for ln in body if ln and not ln.startswith(b"#")
                 and ln.split(b"\t")[4] != b"<NON_REF>"]
        assert len(calls) >= 5


def test_bqsr_tables_only_then_apply_matches_jax_cli(fixture_files, tmp_path, on_cpu):
    """--bqsr-tables-only, then --bqsr-apply of those tables with
    --recal-file and --quantize-levels, through both CLIs: the same
    intermediate tables, recal report and BAM records."""
    wd = fixture_files
    outs = {}
    for name, main in (("jax", jax_cli.main), ("port", cli.main)):
        od = tmp_path / name
        od.mkdir()
        common = ["--reference", str(wd / f"{name}.elfasta"), "--nr-of-threads", "1"]
        assert main(["filter", str(wd / "dups.sam"), str(od / "a.bam"), *common,
                     "--bqsr-tables-only", str(od / "tables.npz"), "--known-sites",
                     str(wd / "sites.elsites")]) == 0, name
        assert main(["filter", str(wd / "dups.sam"), str(od / "out.bam"), *common,
                     "--bqsr-apply", str(od / "tables.npz"), "--recal-file",
                     str(od / "out.recal"), "--quantize-levels", "8",
                     "--sorting-order", "coordinate"]) == 0, name
        outs[name] = od
    for f in ("tables.npz", "out.recal"):
        assert _read(outs["port"] / f) == _read(outs["jax"] / f), f
    jh, jr = _records(outs["jax"] / "out.bam")
    ph, pr = _records(outs["port"] / "out.bam")
    assert ph == jh
    assert len(pr) > 2000 and pr == jr


def test_converters_match_jax(tmp_path):
    """bed-to-elsites and vcf-to-elsites (plain and BGZF input) write the
    same bytes as the JAX package's converters."""
    from elprep_tpu_torch.io import bgzf

    bed = tmp_path / "in.bed"
    bed.write_text("chr2\t500\t900\nchr1\t100\t200\nchr1\t150\t400\nchr1\t1000\t1001\n")
    vcf = os.path.join(FIXTURES, "hc_golden.expected.vcf")
    vcf_gz = tmp_path / "in.vcf.gz"
    vcf_gz.write_bytes(bytes(bgzf.compress(_read(vcf))))
    for cmd, src in (("bed-to-elsites", str(bed)), ("vcf-to-elsites", vcf),
                     ("vcf-to-elsites", str(vcf_gz))):
        j, p = tmp_path / "j.elsites", tmp_path / "p.elsites"
        assert jax_cli.main([cmd, src, str(j)]) == 0
        assert cli.main([cmd, src, str(p)]) == 0
        assert p.read_bytes() == j.read_bytes() and len(p.read_bytes()) > 0, (cmd, src)


def test_cuda_unavailable_fails_the_cli(tmp_path, monkeypatch, capsys):
    """Without ELPREP_TPU_TORCH_DEVICE=cpu the CLI asks for cuda; with no
    card it exits non-zero before any work, naming the cause."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    monkeypatch.delenv("ELPREP_TPU_TORCH_DEVICE", raising=False)
    out = tmp_path / "out.sam"
    rc = cli.main(["filter", os.path.join(FIXTURES, "hc_golden.in.sam"), str(out),
                   "--sorting-order", "coordinate"])
    assert rc != 0
    assert "cuda not available" in capsys.readouterr().err
    assert not out.exists()


def test_cuda_unavailable_raises_in_library_functions():
    from elprep_tpu_torch import device
    from elprep_tpu_torch.ops import bqsr_ops, dedup, pairhmm, sortkeys

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    z = np.zeros(3, np.int32)
    with pytest.raises(device.DeviceUnavailable, match="cuda not available"):
        sortkeys.coordinate_sort_perm(z, z, z, z, z, z, z, z, device="cuda")
    reads = [(b"ACGT", np.full(4, 30, np.uint8), 60)]
    with pytest.raises(device.DeviceUnavailable, match="cuda not available"):
        pairhmm.pairhmm_logl_pairs(reads, [b"ACGTA"], np.zeros(1, np.int64),
                                   np.zeros(1, np.int64), device="cuda")
    with pytest.raises(device.DeviceUnavailable, match="cuda not available"):
        dedup.mark_duplicates(z, z, z, z, z, z, z, device="cuda")
    b = np.zeros((3, 8), np.uint8)
    with pytest.raises(device.DeviceUnavailable, match="cuda not available"):
        bqsr_ops.apply_bqsr(b, b, z, z, z, np.ones(1, bool), np.zeros((1, 94)),
                            np.zeros((1, 94, 21)), np.zeros((1, 94, 17)),
                            np.arange(94), np.arange(255), max_cycle=10, device="cuda")
    with pytest.raises(device.DeviceUnavailable, match="cuda not available"):
        dispatch.routes_to_host(3, "cuda")


@pytest.mark.parametrize("flags", [
    ["--sharded"],
    ["--spread-file", "s.sam"],
])
def test_unported_options_are_refused(tmp_path, on_cpu, capsys, flags):
    out = tmp_path / "out.sam"
    rc = cli.main(["filter", os.path.join(FIXTURES, "hc_golden.in.sam"), str(out),
                   *flags])
    assert rc != 0
    err = capsys.readouterr().err
    assert "not yet ported" in err and flags[0] in err
    assert not out.exists()


@pytest.mark.parametrize("cmd", ["sfm", "split", "merge",
                                 "merge-optical-duplicates-metrics"])
def test_unported_commands_are_refused(capsys, cmd):
    assert cli.main([cmd, "a", "b"]) != 0
    assert "not yet ported" in capsys.readouterr().err
