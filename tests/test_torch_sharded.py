"""The port's sharded pipeline (elprep_tpu_torch.parallel, torch on the
CPU) against the JAX package's (tests/test_sharded.py and
tests/test_parallel.py on the same SAM bytes and seeds): an 8-entry CPU
mesh against JAX's ``make_mesh(8)`` over tests/conftest.py's eight virtual
devices. The shard plan's arrays, the per-shard duplicate verdicts and
sort permutations (pad rows included), the sorted and flagged batch, the
BQSR tables and the CLI's ``filter --sharded`` outputs are equal with no
tolerance; the sharded PairHMM is bit-equal to the port's unsharded call
and within 5e-4 log10 of JAX's."""

import gzip

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import samgen
import test_sharded as jts
from elprep_tpu import cli as jax_cli
from elprep_tpu.ops import pairhmm as jax_pairhmm
from elprep_tpu.filters import add_refid as jadd_refid
from elprep_tpu.filters import bqsr as jfb
from elprep_tpu.io import sam as jsamio
from elprep_tpu.io.fasta import MappedFasta as JMappedFasta, RefIndex as JRefIndex
from elprep_tpu.parallel import make_mesh as jmake_mesh
from elprep_tpu.parallel import pairhmm_sharded as jpairhmm_sharded
from elprep_tpu.parallel import sharded as jsh
from elprep_tpu_torch import cli
from elprep_tpu_torch.core.header import SortingOrder
from elprep_tpu_torch.core.pipeline import SamData, run_pipeline
from elprep_tpu_torch.filters import add_refid
from elprep_tpu_torch.filters import bqsr as fb
from elprep_tpu_torch.filters import simple as fsimple
from elprep_tpu_torch.filters.markdup import MarkDuplicatesState, mark_duplicates_filter
from elprep_tpu_torch.io import sam as samio
from elprep_tpu_torch.io.fasta import MappedFasta, RefIndex
from elprep_tpu_torch.ops import pairhmm
from elprep_tpu_torch.parallel import make_mesh, mesh as pmesh, pairhmm_sharded
from elprep_tpu_torch.parallel import sharded

torch.set_num_threads(1)

CPU8 = (torch.device("cpu"),) * 8


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


@pytest.fixture(scope="module")
def jmesh8():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    return jsh._flat_mesh(jmake_mesh(8))


def _both_prepped(data: bytes):
    """The same SAM bytes parsed by each package, add_refid applied."""
    hdr, batch = samio.parse_sam(data)
    add_refid(hdr)(batch)
    jhdr, jbatch = jsamio.parse_sam(data)
    jadd_refid(jhdr)(jbatch)
    return (hdr, batch), (jhdr, jbatch)


def test_make_mesh_on_cpu(monkeypatch):
    assert make_mesh(device="cpu") == (torch.device("cpu"),)
    assert make_mesh(8, device="cpu") == CPU8
    monkeypatch.setattr(pmesh, "_LOCAL_DEVICES", [4])
    assert make_mesh(device="cpu") == CPU8[:4]
    assert make_mesh(2, device="cpu") == CPU8[:2]
    assert pmesh.process_rank_and_count() == (0, 1)


def test_make_mesh_on_cuda_counts_distinct_cards(monkeypatch):
    """On cuda the mesh is the visible cards; asking for more than exist
    raises (the JAX package's make_mesh error). The card count and the
    device check are faked, so no card is needed."""
    monkeypatch.setattr(pmesh._device, "resolve", lambda device=None: torch.device("cuda"))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert make_mesh() == (torch.device("cuda", 0), torch.device("cuda", 1))
    assert make_mesh(1) == (torch.device("cuda", 0),)
    with pytest.raises(RuntimeError, match="need 4 devices, have 2"):
        make_mesh(4)
    monkeypatch.setattr(pmesh, "_LOCAL_DEVICES", [4])
    assert make_mesh() == (torch.device("cuda"),) * 4


@pytest.mark.parametrize("n_shards", [1, 3, 8])
def test_shard_plan_matches_jax(n_shards):
    (hdr, batch), (jhdr, jbatch) = _both_prepped(jts._sam_with_cross_pairs())
    np.testing.assert_array_equal(sharded.shard_spans(hdr, n_shards),
                                  jsh.shard_spans(jhdr, n_shards))
    rows, n_home, aux = sharded.plan_shards(batch, hdr, n_shards, "cpu")
    jrows, jn_home, jaux = jsh.plan_shards(jbatch, jhdr, n_shards)
    assert n_home == jn_home and sum(n_home) == len(batch)
    assert len(rows) == len(jrows) == n_shards
    for a, b in zip(rows, jrows):
        np.testing.assert_array_equal(a, b)
    if n_shards > 1:  # cross-contig pairs span shards: helpers exist
        assert sum(len(r) for r in rows) > len(batch)
    for k in jaux:
        np.testing.assert_array_equal(aux[k], jaux[k])


def _step_cols(per, n_dev, seed, n_pad_rows):
    """tests/test_parallel.py's columns with more collisions (fragments
    and pairs in a small position range, qnames shared by mates), the last
    ``n_pad_rows`` rows of every shard filled as run_sharded_sort_dedup
    pads (flag 0x4, INT32_MAX keys, libid -1)."""
    n = per * n_dev
    rng = np.random.RandomState(seed)
    flag = rng.choice(np.array([0x63, 0x93, 0x0, 0x10], np.int32), n)
    flag[rng.rand(n) < 0.1] = 0x4  # unmapped reads with coordinates
    refid = np.repeat(np.arange(n_dev, dtype=np.int32), per)
    refid[(flag & 0x4) != 0] = -1
    pos = rng.randint(1, 40, n).astype(np.int32)
    mapq = np.full(n, 60, np.int32)
    qrank = rng.randint(0, n // 2, n).astype(np.int32)
    libid = np.zeros(n, np.int32)
    upos = pos.copy()
    rev = (flag >> 4) & 1
    score = rng.randint(0, 3000, n).astype(np.int32)
    cols = [flag, refid, pos, mapq, refid.copy(), pos.copy(), np.zeros(n, np.int32),
            qrank, libid, upos, rev, score]
    fills = (0x4, sharded.INT32_MAX, sharded.INT32_MAX, 0, sharded.INT32_MAX,
             sharded.INT32_MAX, 0, sharded.INT32_MAX, -1, 0, 0, 0)
    pad = np.zeros(n, bool)
    for s in range(n_dev):
        pad[(s + 1) * per - n_pad_rows : (s + 1) * per] = True
    for c, fill in zip(cols, fills):
        c[pad] = fill
    return tuple(cols), pad


def test_sharded_step_matches_jax_with_pad_rows(jmesh8):
    """The port's per-shard program against JAX's shard_mapped
    ``sharded_sort_dedup_step`` on the same stacked columns: the same dup
    verdicts and permutation on every shard, pad rows included, and the
    pad rows sort last (what makes the ``p < len(rows)`` cut exact)."""
    per, n_dev, n_pad_rows = 32, 8, 5
    cols, pad = _step_cols(per, n_dev, 5, n_pad_rows)
    dup_parts, perm_parts = sharded.sharded_sort_dedup_step(CPU8, *cols)
    dup = sharded._fetch(dup_parts, CPU8).reshape(n_dev, per)
    perm = sharded._fetch(perm_parts, CPU8).reshape(n_dev, per)
    step = jsh.sharded_sort_dedup_step(jmesh8)
    jdup, jperm = step(*[jax.device_put(c, NamedSharding(jmesh8, P("dp"))) for c in cols])
    np.testing.assert_array_equal(dup, np.asarray(jdup).reshape(n_dev, per))
    np.testing.assert_array_equal(perm, np.asarray(jperm).reshape(n_dev, per))
    assert dup.any() and not dup.all()
    for s in range(n_dev):
        tail = perm[s, per - n_pad_rows :]
        assert sorted(tail) == list(range(per - n_pad_rows, per))
        assert not dup[s, per - n_pad_rows :].any()


def _serial(data: bytes):
    hdr, batch = samio.parse_sam(data)
    return run_pipeline(SamData(hdr, batch),
                        [fsimple.add_refid, mark_duplicates_filter(
                            state=MarkDuplicatesState(), device="cpu")],
                        SortingOrder.COORDINATE, device="cpu")


def _unmapped_and_empty_sam() -> bytes:
    """tests/test_sharded.py:176-204: reads on the first and last contig
    only (empty middle shards) and an unmapped read without coordinates."""
    header = samgen.make_header_lines(
        jts.CONTIGS, rgs=[{"ID": "rg1", "LB": "lib1", "SM": "s1", "PU": "u1"}])
    qual, seq = "I" * 20, "ACGTACGTACGTACGTACGT"
    lines = [
        f"q1\t0\t{jts.CONTIGS[0][0]}\t500\t60\t20M\t*\t0\t0\t{seq}\t{qual}\tRG:Z:rg1",
        f"q2\t0\t{jts.CONTIGS[-1][0]}\t900\t60\t20M\t*\t0\t0\t{seq}\t{qual}\tRG:Z:rg1",
        f"u1\t4\t*\t0\t0\t*\t*\t0\t0\t{seq}\t{qual}\tRG:Z:rg1",
    ]
    return ("\n".join(header + lines) + "\n").encode()


@pytest.mark.parametrize("case", ["cross_pairs", "empty_and_unmapped"])
def test_run_sharded_sort_dedup_matches_jax_and_serial(jmesh8, case):
    data = (jts._sam_with_cross_pairs() if case == "cross_pairs"
            else _unmapped_and_empty_sam())
    (hdr, batch), (jhdr, jbatch) = _both_prepped(data)
    got, aux = sharded.run_sharded_sort_dedup(batch, hdr, CPU8)
    jgot, jaux = jsh.run_sharded_sort_dedup(jbatch, jhdr, jmesh8)
    hdr.set_hd_so(SortingOrder.COORDINATE)
    jhdr.set_hd_so(SortingOrder.COORDINATE)
    sam = samio.format_sam(hdr, got)
    assert sam == jsamio.format_sam(jhdr, jgot)
    serial = _serial(data)
    assert samio.format_sam(serial.header, serial.batch) == sam
    for k in jaux:
        np.testing.assert_array_equal(aux[k], jaux[k])
    if case == "empty_and_unmapped":
        assert bytes(got.qname[-1]) == b"u1"  # the unmapped read sorts last
    else:
        assert int(((got.flag & 0x400) != 0).sum()) >= 100


def test_sharded_recalibrate_matches_jax(tmp_path, jmesh8):
    """Per-shard tables summed over 8 shards: exactly the JAX package's
    psum-reduced tables and the port's single-device build."""
    genome = samgen.make_genome(jts.CONTIGS, seed=3)
    header = samgen.make_header_lines(
        jts.CONTIGS, rgs=[{"ID": "rg1", "LB": "lib1", "SM": "s1", "PU": "u1"},
                          {"ID": "rg2", "LB": "lib1", "SM": "s1"}])
    lines = samgen.reads_from_genome(1500, jts.CONTIGS, genome, seed=4,
                                     rg_ids=["rg1", "rg2"])
    data = ("\n".join(header + lines) + "\n").encode()
    fasta = tmp_path / "ref.fasta"
    fasta.write_text("".join(f">{n}\n{genome[n].decode()}\n" for n, _ in jts.CONTIGS))
    assert cli.main(["fasta-to-elfasta", str(fasta), str(tmp_path / "ref.elfasta")]) == 0
    (hdr, batch), (jhdr, jbatch) = _both_prepped(data)
    recal = fb.BaseRecalibrator([], RefIndex(MappedFasta(str(tmp_path / "ref.elfasta"))))
    jrecal = jfb.BaseRecalibrator([], JRefIndex(JMappedFasta(str(tmp_path / "ref.elfasta"))))
    timings = {}
    got = sharded.sharded_recalibrate(recal, hdr, batch, 500, CPU8, timings)
    want = jsh.sharded_recalibrate(jrecal, jhdr, jbatch, 500, jmesh8)
    single = recal.recalibrate(hdr, batch, 500, device="cpu")
    assert got.rg_names == want.rg_names == ["rg2", "u1"]
    for k in ("qs_obs", "qs_mism", "cyc_obs", "cyc_mism", "ctx_obs", "ctx_mism"):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k))
        np.testing.assert_array_equal(getattr(got, k), getattr(single, k))
    assert got.qs_obs.sum() > 100_000 and got.qs_mism.sum() > 0
    assert set(timings) == {"prep_s", "device_s"}


def _pairhmm_inputs():
    """tests/test_parallel.py:68-83's reads and haplotypes."""
    rng = np.random.RandomState(8)
    bases = np.frombuffer(b"ACGT", np.uint8)
    reads = [(rng.choice(bases, rng.randint(12, 40)).tobytes(),
              rng.randint(5, 40, 30).astype(np.uint8)[:30], 60) for _ in range(6)]
    reads = [(s, q[: len(s)], m) if len(q) >= len(s) else (s[: len(q)], q, m)
             for s, q, m in reads]
    haps = [rng.choice(bases, rng.randint(30, 70)).tobytes() for _ in range(3)]
    return reads, haps


@pytest.mark.parametrize("mesh", [CPU8, CPU8[:3], CPU8[:1]], ids=["8", "3", "1"])
def test_pairhmm_sharded_matches_unsharded_and_jax(jmesh8, mesh):
    reads, haps = _pairhmm_inputs()
    got = pairhmm_sharded(mesh, reads, haps)
    assert pairhmm._MESH[0] is None  # the session property is untouched
    whole = pairhmm.pairhmm_f32_batch(reads, haps, device="cpu")
    np.testing.assert_array_equal(got, whole)
    want = jpairhmm_sharded(jmesh8, reads, haps)
    assert got.shape == want.shape == (6, 3)
    assert np.abs(got - want).max() < 5e-4
    for r in range(len(reads)):
        for h in range(len(haps)):
            exact = pairhmm.pairhmm_f64_diag(reads[r][0], reads[r][1], 60, haps[h])
            assert abs(got[r, h] - exact) < 5e-4


def test_pairhmm_mesh_splits_in_contiguous_chunks(monkeypatch):
    """With the mesh set, one dispatch becomes one launch per mesh entry,
    each on a contiguous chunk of the pairs, in order."""
    from elprep_tpu_torch.ops import pairhmm_cuda as pc

    reads, haps = _pairhmm_inputs()
    seen = []
    orig = pc.pack_pairs
    monkeypatch.setattr(pc, "pack_pairs", lambda r, h, pr, ph: (
        seen.append((list(pr), list(ph))), orig(r, h, pr, ph))[1])
    pair_r = np.repeat(np.arange(6), 3)
    pair_h = np.tile(np.arange(3), 6)
    pairhmm.set_pairhmm_mesh(CPU8[:4])
    try:
        got = pairhmm.pairhmm_logl_pairs(reads, haps, pair_r, pair_h)
    finally:
        pairhmm.set_pairhmm_mesh(None)
    assert [len(p[0]) for p in seen] == [5, 5, 5, 3]
    assert sum((p[0] for p in seen), []) == list(pair_r)
    np.testing.assert_array_equal(
        got, pairhmm.pairhmm_logl_pairs(reads, haps, pair_r, pair_h, device="cpu"))


CLI_CONTIGS = [(f"chr{i}", 3_000 + 500 * i) for i in range(1, 7)]


@pytest.fixture(scope="module")
def cli_files(tmp_path_factory):
    """Six contigs (so eight shards split them), 2400 reads in pairs from
    a genome with a SNP planted every ~400 bp (soft-clipped reads
    realigned, so the HaplotypeCaller has bases to call) and 20
    cross-contig duplicate pairs under Illumina qnames (80 reads); the
    reference as .elfasta for each package; the SNPs as known sites."""
    import random

    from chip_smoke import realign_soft_clips

    wd = tmp_path_factory.mktemp("torch_sharded_cli")
    genome = samgen.make_genome(CLI_CONTIGS, seed=9)
    rng = random.Random(10)
    alt, snps = {}, []
    for name, ln in CLI_CONTIGS:
        seq = bytearray(genome[name])
        for p in range(300, ln - 300, 400):
            p += rng.randrange(-100, 100)
            seq[p] = ord(rng.choice([b for b in "ACGT" if ord(b) != seq[p]]))
            snps.append((name, p))
        alt[name] = bytes(seq)
    header = samgen.make_header_lines(
        CLI_CONTIGS, rgs=[{"ID": "rg1", "LB": "lib1", "SM": "s1", "PU": "u1"}])
    lines = realign_soft_clips(samgen.reads_from_genome(
        2400, CLI_CONTIGS, alt, seed=11, rg_ids=["rg1"]))
    qual = "I" * 100
    for k in range(20):
        (c1, _), (c2, _) = rng.sample(CLI_CONTIGS, 2)
        p1, p2 = rng.randrange(200, 2500), rng.randrange(200, 2500)
        s1, s2 = (alt[c][p - 1 : p + 99].decode() for c, p in ((c1, p1), (c2, p2)))
        for tag in "ab":
            q = f"M01:1:FC:1:2208:{1000 + k * 10 + (tag == 'b')}:2000"
            lines += [f"{q}\t97\t{c1}\t{p1}\t60\t100M\t{c2}\t{p2}\t0\t{s1}\t{qual}\tRG:Z:rg1",
                      f"{q}\t145\t{c2}\t{p2}\t60\t100M\t{c1}\t{p1}\t0\t{s2}\t{qual}\tRG:Z:rg1"]
    (wd / "in.sam").write_text("\n".join(header + lines) + "\n")
    (wd / "ref.fasta").write_text("".join(f">{n}\n{genome[n].decode()}\n"
                                          for n, _ in CLI_CONTIGS))
    assert jax_cli.main(["fasta-to-elfasta", str(wd / "ref.fasta"),
                         str(wd / "jax.elfasta")]) == 0
    assert cli.main(["fasta-to-elfasta", str(wd / "ref.fasta"),
                     str(wd / "port.elfasta")]) == 0
    (wd / "sites.bed").write_text("".join(f"{n}\t{p}\t{p + 1}\n" for n, p in snps))
    assert cli.main(["bed-to-elsites", str(wd / "sites.bed"), str(wd / "sites.elsites")]) == 0
    return wd


def _five_step(main, wd, name, out, extra=()):
    out.mkdir()
    argv = ["filter", str(wd / "in.sam"), str(out / "out.sam"), "--mark-duplicates",
            "--mark-optical-duplicates", str(out / "metrics.txt"),
            "--sorting-order", "coordinate", "--bqsr", str(out / "out.recal"),
            "--known-sites", str(wd / "sites.elsites"),
            "--reference", str(wd / f"{name}.elfasta"),
            "--haplotypecaller", str(out / "out.vcf.gz"),
            "--reference-confidence", "GVCF", *extra]
    assert main(argv) == 0, (name, extra)
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


def test_cli_sharded_five_step_matches_plain_and_jax(cli_files, tmp_path, on_cpu,
                                                     monkeypatch):
    """``filter --sharded`` 5-step on 8 CPU shards: BAM records, recal,
    metrics and GVCF body byte-equal to the port's plain run and to
    ``python -m elprep_tpu filter --sharded`` on JAX's eight devices; every
    PairHMM dispatch of the sharded run splits over the 8-entry mesh, and
    the mesh is cleared after the run."""
    from elprep_tpu_torch.ops import pairhmm_cuda as pc

    wd = cli_files
    splits = []
    orig = pc.pairhmm_pairs
    monkeypatch.setattr(pc, "pairhmm_pairs", lambda r, h, pr, ph, devices: (
        splits.append(len(devices)), orig(r, h, pr, ph, devices))[1])
    plain = _five_step(cli.main, wd, "port", tmp_path / "plain")
    assert splits and set(splits) == {1}
    del splits[:]
    monkeypatch.setattr(pmesh, "_LOCAL_DEVICES", [8])
    shard8 = _five_step(cli.main, wd, "port", tmp_path / "sharded", ["--sharded"])
    assert splits and set(splits) == {8}  # every PairHMM dispatch over the mesh
    assert pairhmm._MESH[0] is None
    jax_sharded = _five_step(jax_cli.main, wd, "jax", tmp_path / "jax", ["--sharded"])
    want = _outputs(plain)
    assert len(want[0]) > 2400
    calls = [ln for ln in want[3] if ln and not ln.startswith(b"#")
             and ln.split(b"\t")[4] != b"<NON_REF>"]
    assert len(calls) >= 10
    assert _outputs(shard8) == want
    assert _outputs(jax_sharded) == want


@pytest.mark.parametrize("workers", ["1", "2"], ids=["serial", "pooled"])
def test_hc_dispatch_reaches_the_mesh_split(tmp_path, on_cpu, monkeypatch, workers):
    """With ``--sharded`` both the serial driver and the pool's dispatcher
    send every PairHMM dispatch through the mesh split (3 entries here),
    and the GVCF equals the plain run's."""
    import os

    from elprep_tpu_torch.ops import pairhmm_cuda as pc

    fixtures = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
    monkeypatch.setenv("ELPREP_TPU_HC_WORKERS", workers)
    ref = str(tmp_path / "ref.elfasta")
    assert cli.main(["fasta-to-elfasta", os.path.join(fixtures, "hc_golden.ref.fasta"),
                     ref]) == 0
    splits = []
    orig = pc.pairhmm_pairs
    monkeypatch.setattr(pc, "pairhmm_pairs", lambda r, h, pr, ph, devices: (
        splits.append(len(devices)), orig(r, h, pr, ph, devices))[1])
    monkeypatch.setattr(pmesh, "_LOCAL_DEVICES", [3])
    bodies = {}
    for tag, flags in (("plain", []), ("sharded", ["--sharded"])):
        del splits[:]
        out = tmp_path / f"{tag}.vcf"
        assert cli.main(["filter", os.path.join(fixtures, "hc_golden.in.sam"),
                         str(tmp_path / f"{tag}.sam"), "--reference", ref,
                         "--haplotypecaller", str(out), "--reference-confidence", "GVCF",
                         *flags]) == 0
        assert splits and set(splits) == ({3} if flags else {1})
        bodies[tag] = [ln for ln in out.read_bytes().split(b"\n")
                       if not ln.startswith(b"##elPrepCommandLine")]
    assert bodies["sharded"] == bodies["plain"] and len(bodies["plain"]) > 30
