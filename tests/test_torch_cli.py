"""The port's CLI on the CPU (ELPREP_TPU_TORCH_DEVICE=cpu): the
HaplotypeCaller goldens byte for byte, the same outputs as
``python -m elprep_tpu filter`` record for record, the refusal of options
not yet ported, and no silent CPU run when cuda is asked for and absent."""

import gzip
import os
import random

import numpy as np
import pytest
import torch

import samgen
from elprep_tpu import cli as jax_cli
from elprep_tpu_torch import cli
from elprep_tpu_torch.io import sam as samio

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


@pytest.fixture(scope="module")
def fixture_files(tmp_path_factory):
    """A samgen fixture whose reads come from a genome with a SNP planted
    every ~400 bp (so the HaplotypeCaller has regions to call), the
    reference as .elfasta for each package, and a BED file."""
    wd = tmp_path_factory.mktemp("torch_cli")
    genome = samgen.make_genome(CONTIGS, seed=41)
    rng = random.Random(43)
    alt = {}
    for name, ln in CONTIGS:
        seq = bytearray(genome[name])
        for p in range(300, ln - 300, 400):
            p += rng.randrange(-100, 100)
            seq[p] = ord(rng.choice([b for b in "ACGT" if ord(b) != seq[p]]))
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
    from elprep_tpu_torch.ops import pairhmm, sortkeys

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    z = np.zeros(3, np.int32)
    with pytest.raises(device.DeviceUnavailable, match="cuda not available"):
        sortkeys.coordinate_sort_perm(z, z, z, z, z, z, z, z, device="cuda")
    reads = [(b"ACGT", np.full(4, 30, np.uint8), 60)]
    with pytest.raises(device.DeviceUnavailable, match="cuda not available"):
        pairhmm.pairhmm_logl_pairs(reads, [b"ACGTA"], np.zeros(1, np.int64),
                                   np.zeros(1, np.int64), device="cuda")


@pytest.mark.parametrize("flags", [
    ["--mark-duplicates"],
    ["--bqsr", "x.recal", "--known-sites", "s.elsites"],
    ["--mark-optical-duplicates", "m.txt"],
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


@pytest.mark.parametrize("cmd", ["sfm", "split", "merge", "bed-to-elsites"])
def test_unported_commands_are_refused(capsys, cmd):
    assert cli.main([cmd, "a", "b"]) != 0
    assert "not yet ported" in capsys.readouterr().err
