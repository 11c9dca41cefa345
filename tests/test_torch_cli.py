"""The port's CLI on the CPU (ELPREP_TPU_TORCH_DEVICE=cpu): the
HaplotypeCaller, duplicate-marking, metrics and BQSR goldens byte for
byte, the same outputs as ``python -m elprep_tpu`` record for record
(the 5-step pipeline serial and pooled, split/merge, sfm, directory
inputs, merge-optical-duplicates-metrics), the converters, ``--sharded``
against the plain run, and no silent CPU run when cuda is asked for and
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
from elprep_tpu.ops import pairhmm as jax_pairhmm
from elprep_tpu_torch import cli
from elprep_tpu_torch.io import sam as samio
from elprep_tpu_torch.ops import dispatch

torch.set_num_threads(1)

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
CONTIGS = [("chr1", 12_000), ("chr2", 8_000)]


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
    # runs without --nr-of-threads start a pool of this many workers
    # (both packages), not one per core in every test process
    monkeypatch.setenv("ELPREP_TPU_HC_WORKERS", "2")


@pytest.fixture
def threads_from_cli(monkeypatch):
    """--nr-of-threads alone sets the worker count (1: serial)."""
    monkeypatch.delenv("ELPREP_TPU_HC_WORKERS", raising=False)


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
    """(header lines with the @PG CL field dropped and the random suffix
    of a repeated @PG ID masked, formatted records)."""
    import re

    hdr, batch = samio.read_sam_file(str(path))
    head = []
    for ln in samio.format_sam_header(hdr).decode().splitlines():
        if ln.startswith("@PG"):
            ln = "\t".join(f for f in ln.split("\t") if not f.startswith("CL:"))
            ln = re.sub(r"(elprep_tpu) [0-9a-f]+", r"\1 *", ln)
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
def test_matches_jax_cli_record_for_record(fixture_files, tmp_path, on_cpu,
                                           threads_from_cli, extra):
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
    ("five_step", "torch"), ("five_step", "pooled")])
def test_five_step_matches_jax_cli(fixture_files, tmp_path, monkeypatch, on_cpu,
                                   threads_from_cli, case, route):
    """Duplicate marking, optical duplicates and BQSR through both CLIs on
    the fixture with duplicate pairs appended: the same BAM records, recal
    file, metrics (command line and date masked) and GVCF body. The
    ``torch`` route runs the port's torch programs on the CPU (the code
    the card runs) instead of its CPU route's native engines; ``pooled``
    runs both CLIs with ``--nr-of-threads 2``: the BQSR table build and
    the HaplotypeCaller on two worker processes each."""
    wd = fixture_files
    outs = {}
    for name, main in (("jax", jax_cli.main), ("port", cli.main)):
        od = tmp_path / name
        od.mkdir()
        if name == "port" and route == "torch":
            monkeypatch.setattr(dispatch, "routes_to_host", lambda n, device=None: False)
        args = [a.format(out=od, wd=wd) for a in _FIVE_STEP[case]]
        argv = ["filter", str(wd / "dups.sam"), str(od / "out.bam"),
                "--reference", str(wd / f"{name}.elfasta"), "--nr-of-threads",
                "2" if route == "pooled" else "1", *args]
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


def test_bqsr_tables_only_then_apply_matches_jax_cli(fixture_files, tmp_path, on_cpu,
                                                     threads_from_cli):
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


class _StopAtRead(Exception):
    pass


@pytest.mark.parametrize("dev,step,spawns", [
    ("cuda", "--bqsr", False), ("cuda", "--bqsr-tables-only", False),
    ("cuda", "--haplotypecaller", True), ("cpu", "--bqsr", True)])
def test_pool_spawned_only_where_used(tmp_path, monkeypatch, on_cpu, dev, step, spawns):
    """The CLI starts the worker pool for the HaplotypeCaller, and for
    BQSR only on the CPU: on cuda the table build stays on the card, so a
    BQSR-only run starts no workers. The session device is monkeypatched
    and the run stops at the read phase, so no card is needed."""
    from elprep_tpu_torch import device
    from elprep_tpu_torch.hc import parallel

    calls = []
    monkeypatch.setattr(device, "default_device_from_env", lambda: torch.device(dev))
    monkeypatch.setattr(parallel, "get_pool", lambda n: calls.append(n))

    def stop(path):
        raise _StopAtRead(path)

    monkeypatch.setattr(samio, "read_sam_file", stop)
    with pytest.raises(_StopAtRead):
        cli.filter_command([os.path.join(FIXTURES, "bqsr_golden.in.sam"),
                            str(tmp_path / "out.sam"), step, str(tmp_path / "out.x"),
                            "--reference", str(tmp_path / "ref.elfasta")])
    assert calls == ([2] if spawns else [])


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


@pytest.mark.parametrize("extra", [
    ["--mark-duplicates", "--sorting-order", "coordinate"],
    ["--sorting-order", "coordinate", "--haplotypecaller", "{out}.vcf",
     "--reference-confidence", "NONE"],
], ids=["dedup_sort", "hc_only"])
def test_sharded_option_runs_and_matches_plain(tmp_path, on_cpu, extra):
    """``--sharded`` runs (it was refused before the parallel modules were
    ported) and writes what the plain run writes: with duplicate marking
    and a coordinate sort the sharded sort/dedup, without them only the
    PairHMM over the mesh."""
    ref = str(tmp_path / "ref.elfasta")
    assert cli.main(["fasta-to-elfasta",
                     os.path.join(FIXTURES, "hc_golden.ref.fasta"), ref]) == 0
    outs = {}
    for tag, flags in (("plain", []), ("sharded", ["--sharded"])):
        out = str(tmp_path / tag)
        assert cli.main(["filter", os.path.join(FIXTURES, "hc_golden.in.sam"),
                         out + ".sam", "--reference", ref,
                         *[a.format(out=out) for a in extra], *flags]) == 0
        outs[tag] = out
    assert _records(outs["sharded"] + ".sam") == _records(outs["plain"] + ".sam")
    if "--haplotypecaller" in extra:
        body = _vcf_body(outs["sharded"] + ".vcf")
        assert body == _vcf_body(outs["plain"] + ".vcf")
        assert any(ln and not ln.startswith(b"#") for ln in body)


# ---------------------------------------------------------------------------
# split / merge / sfm / merge-optical-duplicates-metrics / directory inputs,
# against the JAX CLI (tests/test_cli.py's fixture and cases)
# ---------------------------------------------------------------------------

_CLIS = (("jax", jax_cli.main), ("port", cli.main))


@pytest.fixture(scope="module")
def small_files(tmp_path_factory):
    """tests/test_cli.py's fixture: a het SNP at chr1:2001, one duplicate
    pair, a few chr2 pairs; the reference as .elfasta for each package."""
    wd = tmp_path_factory.mktemp("torch_cli_small")
    rng = np.random.RandomState(99)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    ref1 = rng.choice(acgt, 4000).tobytes()
    ref2 = rng.choice(acgt, 3000).tobytes()
    with open(wd / "ref.fasta", "w") as fh:
        fh.write(f">chr1 test\n{ref1.decode()}\n>chr2\n{ref2.decode()}\n")
    for name, main in _CLIS:
        assert main(["fasta-to-elfasta", str(wd / "ref.fasta"),
                     str(wd / f"{name}.elfasta")]) == 0
    alt1 = ref1[:2000] + (b"A" if ref1[2000:2001] != b"A" else b"C") + ref1[2001:]
    lines = ["@HD\tVN:1.6\tSO:unknown", "@SQ\tSN:chr1\tLN:4000",
             "@SQ\tSN:chr2\tLN:3000", "@RG\tID:rg1\tLB:lib1\tSM:sample1\tPU:unit1"]
    qual = "I" * 100

    def pair(qname, chrom, hap, p1, p2):
        s1, s2 = hap[p1 - 1 : p1 + 99].decode(), hap[p2 - 1 : p2 + 99].decode()
        tl = p2 - p1 + 100
        return [f"{qname}\t99\t{chrom}\t{p1}\t60\t100M\t=\t{p2}\t{tl}\t{s1}\t{qual}\tRG:Z:rg1",
                f"{qname}\t147\t{chrom}\t{p2}\t60\t100M\t=\t{p1}\t{-tl}\t{s2}\t{qual}\tRG:Z:rg1"]

    for i in range(30):
        start = 1900 + i * 3
        lines += pair(f"M:R:F:1:2203:{1000 + i * 10}:2000", "chr1",
                      ref1 if i % 2 == 0 else alt1, start, start + 150)
    lines += pair("M:R:F:1:2203:5000:6000", "chr1", ref1, 500, 700)
    lines += pair("M:R:F:1:2203:5004:6004", "chr1", ref1, 500, 700)
    for i in range(6):
        start = 1000 + i * 40
        lines += pair(f"M:R:F:1:1101:{2000 + i * 17}:3000", "chr2", ref2, start, start + 120)
    (wd / "in.sam").write_text("\n".join(lines) + "\n")
    (wd / "sites.bed").write_text("chr1\t100\t200\n")
    assert cli.main(["bed-to-elsites", str(wd / "sites.bed"),
                     str(wd / "sites.elsites")]) == 0
    return wd


def _both(tmp_path, argv_of):
    """Run ``argv_of(name, out_dir)`` through both CLIs; returns the two
    output directories."""
    outs = {}
    for name, main in _CLIS:
        od = tmp_path / name
        od.mkdir()
        assert main(argv_of(name, od)) == 0, name
        outs[name] = od
    return outs


def _same_records(a, b, min_records=1):
    ha, ra = _records(a)
    hb, rb = _records(b)
    assert ha == hb
    assert len(ra) > min_records and ra == rb
    return rb


def test_split_merge_roundtrip_matches_jax(small_files, tmp_path, on_cpu):
    """split (one group per contig) and merge through both CLIs: the same
    group and spread files, the same merged file, every read back."""
    import glob
    import shutil

    wd = small_files
    outs = _both(tmp_path, lambda name, od: [
        "split", str(wd / "in.sam"), str(od / "sp"), "--output-prefix", "t",
        "--contig-group-size", "1"])
    groups = sorted(glob.glob(str(outs["port"] / "sp" / "splits" / "t-*.sam")))
    assert len(groups) == 3  # two groups and the unmapped file
    hdr, _ = samio.read_sam_file(groups[0])
    assert hdr.contigs() == ["chr1"]
    for f in groups + [str(outs["port"] / "sp" / "t-spread.sam")]:
        rel = os.path.relpath(f, outs["port"])
        assert _read(f) == _read(outs["jax"] / rel), rel
    for name, main in _CLIS:
        sp = outs[name] / "sp"
        shutil.copy(sp / "t-spread.sam", sp / "splits" / "t-spread.sam")
        assert main(["merge", str(sp / "splits"), str(outs[name] / "merged.sam"),
                     "--input-prefix", "t"]) == 0, name
    _same_records(outs["port"] / "merged.sam", outs["jax"] / "merged.sam")
    _, b0 = samio.read_sam_file(str(wd / "in.sam"))
    _, b1 = samio.read_sam_file(str(outs["port"] / "merged.sam"))
    assert sorted(b0.qname.astype(bytes)) == sorted(b1.qname.astype(bytes))


_SFM = {
    "dedup": ["--mark-duplicates", "--sorting-order", "coordinate"],
    "bqsr_hc": ["--mark-duplicates", "--sorting-order", "coordinate",
                "--bqsr", "{out}/{run}.recal", "--reference", "{ref}",
                "--haplotypecaller", "{out}/{run}.vcf.gz",
                "--reference-confidence", "NONE"],
    "gvcf": ["--mark-duplicates", "--sorting-order", "coordinate",
             "--reference", "{ref}", "--haplotypecaller", "{out}/{run}.vcf.gz",
             "--reference-confidence", "GVCF"],
}


@pytest.mark.parametrize("case", list(_SFM))
def test_sfm_matches_jax_and_whole_file(small_files, tmp_path, on_cpu, case):
    """sfm (one contig group per contig, run in-process on the shared
    worker pool) equals the whole-file filter run, and the JAX CLI's sfm:
    the same BAM records, recal report and VCF body."""
    wd = small_files

    def argv(name, od, cmd, run):
        a = [x.format(out=od, run=run, ref=wd / f"{name}.elfasta") for x in _SFM[case]]
        out = [cmd, str(wd / "in.sam"), str(od / f"{run}.bam")] + a
        if cmd == "sfm":
            out += ["--contig-group-size", "1", "--tmp-path", str(od / "t")]
        return out

    outs = _both(tmp_path, lambda name, od: argv(name, od, "sfm", "s"))
    for name, main in _CLIS:
        assert main(argv(name, outs[name], "filter", "w")) == 0, name
    port = outs["port"]
    _same_records(port / "s.bam", outs["jax"] / "s.bam", 70)
    _, bw = samio.read_sam_file(str(port / "w.bam"))
    _, bs = samio.read_sam_file(str(port / "s.bam"))
    assert sorted((bytes(bw.qname[i]), int(bw.flag[i]), int(bw.pos[i]),
                   bw.qual.row(i).tobytes()) for i in range(len(bw))) == \
        sorted((bytes(bs.qname[i]), int(bs.flag[i]), int(bs.pos[i]),
                bs.qual.row(i).tobytes()) for i in range(len(bs)))
    assert int(((bs.flag & 0x400) != 0).sum()) == 2
    if "--bqsr" in _SFM[case]:
        assert _read(port / "s.recal") == _read(port / "w.recal") \
            == _read(outs["jax"] / "s.recal")
    if "--haplotypecaller" in _SFM[case]:
        body = [ln for ln in _vcf_body(port / "s.vcf.gz") if not ln.startswith(b"#")]
        assert body == [ln for ln in _vcf_body(port / "w.vcf.gz")
                        if not ln.startswith(b"#")]
        assert _vcf_body(port / "s.vcf.gz") == _vcf_body(outs["jax"] / "s.vcf.gz")
        assert any(ln.startswith(b"chr1\t2001\t") for ln in body)


def test_sfm_cross_contig_duplicates_matches_jax(tmp_path, on_cpu):
    """Cross-contig duplicate pairs are marked by sfm as by the whole-file
    run (the spread file is filtered first), in both packages."""
    q = "I" * 50
    lines = ["@HD\tVN:1.6\tSO:unknown", "@SQ\tSN:chr1\tLN:4000",
             "@SQ\tSN:chr2\tLN:3000", "@RG\tID:rg1\tLB:lib1\tSM:s1\tPU:u1"]
    for x in (1000, 5000):
        qn = f"M:R:F:1:2203:{x}:7000"
        lines.append(f"{qn}\t97\tchr1\t500\t60\t50M\tchr2\t800\t0\t{'A' * 50}\t{q}\tRG:Z:rg1")
        lines.append(f"{qn}\t145\tchr2\t800\t60\t50M\tchr1\t500\t0\t{'C' * 50}\t{q}\tRG:Z:rg1")
    for i in range(4):
        p = 1200 + i * 37
        lines.append(f"N{i}\t99\tchr1\t{p}\t60\t50M\t=\t{p + 100}\t150\t{'G' * 50}\t{q}\tRG:Z:rg1")
        lines.append(f"N{i}\t147\tchr1\t{p + 100}\t60\t50M\t=\t{p}\t-150\t{'T' * 50}\t{q}\tRG:Z:rg1")
    sam = tmp_path / "cross.sam"
    sam.write_text("\n".join(lines) + "\n")
    outs = _both(tmp_path, lambda name, od: [
        "sfm", str(sam), str(od / "sfm.sam"), "--mark-duplicates", "--sorting-order",
        "coordinate", "--contig-group-size", "1", "--tmp-path", str(od / "t")])
    assert cli.main(["filter", str(sam), str(tmp_path / "whole.sam"), "--mark-duplicates",
                     "--sorting-order", "coordinate"]) == 0
    _same_records(outs["port"] / "sfm.sam", outs["jax"] / "sfm.sam", 10)
    _, b1 = samio.read_sam_file(str(tmp_path / "whole.sam"))
    _, b2 = samio.read_sam_file(str(outs["port"] / "sfm.sam"))
    w = sorted((bytes(b1.qname[i]), int(b1.flag[i])) for i in range(len(b1)))
    assert w == sorted((bytes(b2.qname[i]), int(b2.flag[i])) for i in range(len(b2)))
    assert sum(1 for _, f in w if f & 0x400) == 2


def test_directory_input_matches_jax(fixture_files, tmp_path, on_cpu):
    """A directory input merges its files (colliding read-group IDs
    renamed) before the pipeline runs: the same records as the JAX CLI."""
    wd = fixture_files
    text = (wd / "dups.sam").read_text().splitlines()
    head = [ln for ln in text if ln.startswith("@")]
    body = [ln for ln in text if not ln.startswith("@")]
    d = tmp_path / "in_dir"
    d.mkdir()
    (d / "a.sam").write_text("\n".join(head + body[: len(body) // 2]) + "\n")
    (d / "b.sam").write_text("\n".join(head + body[len(body) // 2 :]) + "\n")
    (d / ".hidden.sam").write_text("not read\n")
    outs = _both(tmp_path, lambda name, od: [
        "filter", str(d), str(od / "out.bam"), "--mark-duplicates",
        "--sorting-order", "coordinate", "--reference", str(wd / f"{name}.elfasta")])
    records = _same_records(outs["port"] / "out.bam", outs["jax"] / "out.bam", 2000)
    assert len(records) == len(body) + 1  # the trailing empty line
    hdr, _ = samio.read_sam_file(str(outs["port"] / "out.bam"))
    assert len(hdr.rg) == 2  # the second file's rg1 renamed


def test_merge_optical_duplicates_metrics_matches_jax(small_files, tmp_path, on_cpu):
    """split -> per-group intermediate metrics -> merge-optical-duplicates-
    metrics equals the whole-file metrics, and the JAX CLI's merge."""
    import glob

    wd = small_files

    def flow(name, main, od):
        assert main(["split", str(wd / "in.sam"), str(od / "sp"), "--output-prefix",
                     "x", "--output-type", "sam", "--contig-group-size", "1"]) == 0
        inter = od / "inter"
        inter.mkdir()
        files = sorted(glob.glob(str(od / "sp" / "splits" / "x-*.sam")))
        files.append(str(od / "sp" / "x-spread.sam"))
        for i, gf in enumerate(files):
            assert main(["filter", gf, "/dev/null", "--mark-duplicates",
                         "--mark-optical-duplicates-intermediate",
                         str(inter / f"m{i}.intermediate"), "--sorting-order", "keep"]) == 0
        assert main(["merge-optical-duplicates-metrics", str(wd / "in.sam"), "out.sam",
                     str(od / "merged.txt"), str(inter)]) == 0
        return []

    outs = _both(tmp_path, lambda name, od: (flow(name, dict(_CLIS)[name], od) or [
        "filter", str(wd / "in.sam"), "/dev/null", "--mark-duplicates",
        "--mark-optical-duplicates", str(od / "whole.txt"), "--sorting-order", "keep"]))

    def body(p):
        return [ln for ln in _read(p).split(b"\n") if ln and not ln.startswith(b"#")]

    port = body(outs["port"] / "merged.txt")
    assert port == body(outs["port"] / "whole.txt") == body(outs["jax"] / "merged.txt")
    assert any(ln.startswith(b"lib1\t") for ln in port)
