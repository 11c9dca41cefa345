"""The port's HaplotypeCaller worker pool (elprep_tpu_torch/hc/parallel.py)
on the CPU: pooled ``call_variants`` equals the serial run record for
record (NONE, GVCF, the deletions carry, multi-span BED over two
contigs), with the f64 host PairHMM and with the kernel's plain version
(which the pool dispatches in batches that differ from the serial
ones); the pool redoes exactly the regions whose serial genotyping read
a non-empty deletions carry; it equals the JAX package's pooled run on
the same reads; a spawned worker runs on the CPU with every card
hidden; and the dispatcher's batch rule."""

import os

import numpy as np
import pytest
import torch

from elprep_tpu.filters.clipping import ClipRead as JClipRead
from elprep_tpu.hc import driver as jdriver
from elprep_tpu.hc.activity import make_hc_params as jmake_hc_params
from elprep_tpu.hc.refconf import expand_variants as jexpand
from elprep_tpu.io.vcf import format_variant as jformat
from elprep_tpu_torch.core.header import Header
from elprep_tpu_torch.filters.clipping import ClipRead
from elprep_tpu_torch import trace
from elprep_tpu_torch.hc import driver, genotyping, parallel
from elprep_tpu_torch.hc.activity import make_hc_params
from elprep_tpu_torch.hc.refconf import expand_variants
from elprep_tpu_torch.io.vcf import format_variant

torch.set_num_threads(1)

_BASES = np.frombuffer(b"ACGT", np.uint8)


@pytest.fixture
def on_cpu(monkeypatch):
    """The CPU as the session device (the pool's PairHMM dispatch runs
    there), restored afterwards."""
    from elprep_tpu_torch import device

    monkeypatch.setenv("ELPREP_TPU_TORCH_DEVICE", "cpu")
    old = device._DEFAULT[0]
    device.set_default_device("cpu")
    yield
    device._DEFAULT[0] = old


def _mkref(rng, n):
    return rng.choice(_BASES, n).tobytes()


def _reads(specs, rname, prefix, cls=ClipRead):
    """ClipReads from (i, hap, start) triples: 120 bp, Q35, pairs' first
    and second mates alternating."""
    out = []
    for i, hap, start in specs:
        seq = hap[start : start + 120]
        out.append(cls(
            flag=0x63 if i % 2 == 0 else 0x93, pos=start + 1, pnext=start + 151,
            tlen=300 if i % 2 == 0 else -300, mapq=60,
            cigar=[(len(seq), "M")], seq=seq, qual=bytes([35]) * len(seq),
            rname=rname, rnext=b"=", qname=b"%s%04d" % (prefix, i)))
    out.sort(key=lambda r: r.pos)
    return out


def _two_clusters():
    """tests/test_hc_driver.py's fixture: a 200 bp deletion crossing
    region-size boundaries, a SNP inside the deleted span on the other
    haplotype, and a second SNP cluster."""
    rng = np.random.RandomState(17)
    ref = _mkref(rng, 6000)
    hap_del = ref[:2000] + ref[2200:]
    sub = b"A" if ref[2104:2105] != b"A" else b"C"
    hap_snp = ref[:2104] + sub + ref[2105:]
    snp2 = b"G" if ref[4000:4001] != b"G" else b"T"
    hap_b = ref[:4000] + snp2 + ref[4001:]
    specs = []
    for i in range(120):
        hap = (hap_del, hap_snp, hap_b)[i % 3]
        start = (1800 + (i * 13) % 500) if i % 3 != 2 else (3850 + (i * 11) % 250)
        specs.append((i, hap, start))
    return ref, specs


def _header(lengths):
    hdr = Header()
    hdr.hd = {"VN": "1.6", "SO": "coordinate"}
    hdr.sq = [{"SN": c, "LN": str(n)} for c, n in lengths]
    return hdr


def _records(variants):
    return [format_variant(v) for v in expand_variants(variants)]


def _call(mode, hdr, reads, refs, nw, use_device, small_regions=False, bed=None):
    p = make_hc_params(mode, command_line="t")
    if small_regions:
        p.max_region_size = 60
        p.min_region_size = 20
    _, out = driver.call_variants(
        p, hdr, {c: list(v) for c, v in reads.items()}, lambda c: refs[c],
        sample_name="s1", bed_regions=bed, use_device_pairhmm=use_device,
        nr_workers=nw)
    return _records(out)


@pytest.mark.parametrize("use_device", [False, True], ids=["host_f64", "plain_kernel"])
@pytest.mark.parametrize("mode", ["NONE", "GVCF"])
def test_pool_matches_serial(on_cpu, mode, use_device):
    """Block distribution, bare-region shipping, the speculative
    deletions protocol and ordered emission: pooled == serial."""
    ref, specs = _two_clusters()
    hdr = _header([("chr1", len(ref))])
    reads = {"chr1": _reads(specs, b"chr1", b"pp")}
    serial = _call(mode, hdr, reads, {"chr1": ref}, 1, use_device)
    pooled = _call(mode, hdr, reads, {"chr1": ref}, 2, use_device)
    assert pooled == serial and serial


def _deletion_carry():
    rng = np.random.RandomState(23)
    ref = _mkref(rng, 4000)
    hap_del = ref[:2000] + ref[2150:]
    specs = [(i, hap_del if i % 2 == 0 else ref, 1850 + (i * 7) % 300)
             for i in range(80)]
    return ref, specs


@pytest.mark.parametrize("use_device", [False, True], ids=["host_f64", "plain_kernel"])
def test_pool_redo_path_on_deletions_carry(on_cpu, monkeypatch, use_device):
    """Tiny regions and a 150 bp het deletion: the serial run carries
    deletions across regions (checked), but no region reads the carry,
    so the pooled run keeps every speculative genotype (no redo), and
    still matches exactly."""
    ref, specs = _deletion_carry()
    hdr = _header([("chr1", len(ref))])
    reads = {"chr1": _reads(specs, b"chr1", b"dd")}
    carried = []
    orig = driver.genotype_region

    def spy(params, pending, vals, keep, incoming):
        if incoming:
            carried.append(list(incoming))
        return orig(params, pending, vals, keep, incoming)

    monkeypatch.setattr(driver, "genotype_region", spy)
    serial = _call("GVCF", hdr, reads, {"chr1": ref}, 1, use_device, small_regions=True)
    monkeypatch.setattr(driver, "genotype_region", orig)
    assert carried, "fixture no longer exercises the deletions carry"
    pooled, _, redos = _pooled_counting_redos(monkeypatch, "GVCF", hdr, reads, {"chr1": ref}, 2,
                                              use_device, small_regions=True)
    assert redos == 0
    assert pooled == serial and serial


def _serial_reading_the_carry(monkeypatch, mode, hdr, reads, refs, use_device, **kw):
    """The serial run's records, its carry after each region, and, per
    genotyped region, whether its incoming deletions carry was non-empty
    and whether genotyping read it (called ``is_vc_covered_by_deletion``)."""
    regions = []
    carries = []
    orig_geno = driver.genotype_region
    orig_read = genotyping.is_vc_covered_by_deletion
    orig_iter = driver._iter_region_results_serial

    def geno(params, pending, vals, keep, incoming):
        regions.append({"carried": bool(incoming), "read": False})
        return orig_geno(params, pending, vals, keep, incoming)

    def read(deletions, vc):
        regions[-1]["read"] = True
        return orig_read(deletions, vc)

    def results(*a, **k):
        for item in orig_iter(*a, **k):
            carries.append(list(item[2]))
            yield item

    monkeypatch.setattr(driver, "genotype_region", geno)
    monkeypatch.setattr(genotyping, "is_vc_covered_by_deletion", read)
    monkeypatch.setattr(driver, "_iter_region_results_serial", results)
    try:
        return _call(mode, hdr, reads, refs, 1, use_device, **kw), carries, regions
    finally:
        monkeypatch.setattr(driver, "genotype_region", orig_geno)
        monkeypatch.setattr(genotyping, "is_vc_covered_by_deletion", orig_read)
        monkeypatch.setattr(driver, "_iter_region_results_serial", orig_iter)


def _pooled_counting_redos(monkeypatch, mode, hdr, reads, refs, nw, use_device, **kw):
    """The pooled run's records, its carry after each region, and the
    number of ``redo`` messages the main process sent to the workers."""
    pool = parallel.get_pool(nw)
    sent = []
    carries = []
    orig_results = parallel._RegionRun.results

    def results(self, *a, **k):
        for item in orig_results(self, *a, **k):
            carries.append(list(item[2]))
            yield item

    monkeypatch.setattr(parallel._RegionRun, "results", results)
    for q in pool.req_qs:
        def put(msg, *a, _put=q.put, **k):
            sent.append(msg[0])
            return _put(msg, *a, **k)

        monkeypatch.setattr(q, "put", put)
    try:
        return _call(mode, hdr, reads, refs, nw, use_device, **kw), carries, sent.count("redo")
    finally:
        for q in pool.req_qs:
            monkeypatch.delattr(q, "put")
        monkeypatch.setattr(parallel._RegionRun, "results", orig_results)


def _carried_span_del(upstream):
    """_two_clusters' 200 bp deletion with the SNP inside its span (a
    ``*`` allele is judged there), with an upstream cluster in front of
    it instead of the second SNP cluster: a SNP (``snp``; in GVCF its
    ``<NON_REF>`` site enters the carry) or a 30 bp deletion (``del``;
    in every mode). The deletion's region reads a non-empty carry."""
    rng = np.random.RandomState(17)
    ref = _mkref(rng, 6000)
    hap_del = ref[:2000] + ref[2200:]
    sub = b"A" if ref[2104:2105] != b"A" else b"C"
    hap_snp = ref[:2104] + sub + ref[2105:]
    if upstream == "snp":
        alt = b"G" if ref[700:701] != b"G" else b"T"
        hap_up = ref[:700] + alt + ref[701:]
    else:
        hap_up = ref[:700] + ref[730:]
    specs = []
    for i in range(160):
        k = i % 4
        hap = (hap_del, hap_snp, hap_up, ref)[k]
        start = (1800 + (i * 13) % 500) if k < 2 else (550 + (i * 11) % 250)
        specs.append((i, hap, start))
    return ref, specs


@pytest.mark.parametrize("use_device", [False, True], ids=["host_f64", "plain_kernel"])
@pytest.mark.parametrize("upstream", ["snp", "del"])
def test_pool_redoes_a_region_that_read_the_carry(on_cpu, monkeypatch, upstream, use_device):
    """A ``*`` allele judged under a non-empty carry: the serial run reads
    it (checked), so the pooled run sends that region back to be redone
    under the true carry; its carry after each region and its records
    match the serial run's. Traced, a worker records each redo as a
    ``worker.redo`` span."""
    ref, specs = _carried_span_del(upstream)
    hdr = _header([("chr1", len(ref))])
    reads = {"chr1": _reads(specs, b"chr1", b"up")}
    serial, serial_carries, regions = _serial_reading_the_carry(
        monkeypatch, "GVCF", hdr, reads, {"chr1": ref}, use_device)
    read_carried = sum(r["carried"] and r["read"] for r in regions)
    assert read_carried >= 1, "fixture no longer reads a non-empty carry"
    trace.clear()
    trace.enable("redo")
    try:
        pooled, carries, redos = _pooled_counting_redos(monkeypatch, "GVCF", hdr, reads,
                                                        {"chr1": ref}, 2, use_device)
    finally:
        trace.disable()
        snap = trace.snapshot()
        trace.clear()
    assert redos == read_carried
    done = [s for s in snap["spans"] if s["name"] == "worker.redo"]
    assert len(done) == redos and all(s["proc"] == "worker" for s in done)
    assert carries == serial_carries
    assert pooled == serial and serial


def _fixture_call(name):
    """(hdr, reads, refs, call kwargs, workers) of a fixture by name."""
    if name == "multispan":
        refs, reads, bed = _multispan()
        hdr = _header([(c, len(r)) for c, r in refs.items()])
        return hdr, reads, refs, {"small_regions": True, "bed": bed}, 3
    if name == "two_clusters":
        ref, specs = _two_clusters()
        prefix = b"pp"
    else:
        ref, specs = _carried_span_del("del")
        prefix = b"up"
    hdr = _header([("chr1", len(ref))])
    return hdr, {"chr1": _reads(specs, b"chr1", prefix)}, {"chr1": ref}, {}, 2


@pytest.mark.parametrize("mode,name", [("GVCF", "two_clusters"), ("GVCF", "multispan"),
                                       ("NONE", "two_clusters"), ("NONE", "upstream_del")])
def test_pool_redoes_only_regions_that_read_a_carry(on_cpu, monkeypatch, mode, name):
    """The pooled run redoes exactly the regions whose serial genotyping
    read a non-empty carry, and its carry after each region is the serial
    run's. In GVCF every called site enters the carry,
    so _two_clusters' second cluster meets a carry that it never reads:
    kept, where the pool once redid every region under a non-empty
    carry. In NONE a SNP enters nothing: the redos are those of that old
    rule (one, for the deletion's ``*`` allele, in upstream_del)."""
    hdr, reads, refs, kw, nw = _fixture_call(name)
    serial, serial_carries, regions = _serial_reading_the_carry(
        monkeypatch, mode, hdr, reads, refs, False, **kw)
    read_carried = sum(r["carried"] and r["read"] for r in regions)
    carried = sum(r["carried"] for r in regions)
    pooled, carries, redos = _pooled_counting_redos(monkeypatch, mode, hdr, reads, refs, nw,
                                                    False, **kw)
    assert redos == read_carried
    assert carries == serial_carries
    if mode == "NONE":
        assert redos == carried
    elif name == "two_clusters":
        assert carried >= 1 and redos == 0
    assert pooled == serial and serial


def _multispan(cls=ClipRead):
    rng = np.random.RandomState(41)
    ref1 = _mkref(rng, 9000)
    ref2 = _mkref(rng, 5000)
    hap_del = ref1[:2000] + ref1[2150:]
    snp2 = b"G" if ref1[6004:6005] != b"G" else b"T"
    hap_b = ref1[:6004] + snp2 + ref1[6005:]
    snp3 = b"C" if ref2[2504:2505] != b"C" else b"A"
    hap_c = ref2[:2504] + snp3 + ref2[2505:]
    s1 = [(i, (hap_del, ref1, hap_b)[i % 3],
           (1850 + (i * 7) % 300) if i % 3 != 2 else (5870 + (i * 11) % 250))
          for i in range(90)]
    s2 = [(i, hap_c if i % 2 == 0 else ref2, 2380 + (i * 9) % 220) for i in range(40)]
    reads = {"chr1": _reads(s1, b"chr1", b"ms", cls),
             "chr2": _reads(s2, b"chr2", b"mt", cls)}
    refs = {"chr1": ref1, "chr2": ref2}
    bed = {"chr1": [(1500, 2600), (5600, 6500)], "chr2": [(2200, 2900)]}
    return refs, reads, bed


@pytest.mark.parametrize("use_device", [False, True], ids=["host_f64", "plain_kernel"])
def test_pool_matches_serial_multispan_bed(on_cpu, use_device):
    """Several BED spans per contig plus a second contig: the cross-span
    pre-start, the per-contig reference refcounting and the deletions
    carry within a span, over three workers."""
    refs, reads, bed = _multispan()
    hdr = _header([(c, len(r)) for c, r in refs.items()])
    serial = _call("GVCF", hdr, reads, refs, 1, use_device, small_regions=True, bed=bed)
    pooled = _call("GVCF", hdr, reads, refs, 3, use_device, small_regions=True, bed=bed)
    assert pooled == serial and serial


def test_pooled_matches_jax_pooled(on_cpu):
    """The port's pooled call_variants and the JAX package's pooled
    call_variants on the same reads (the PairHMM on each package's CPU
    route): the same records."""
    from elprep_tpu.core.header import Header as JHeader

    refs, reads, bed = _multispan()
    _, jreads, _ = _multispan(JClipRead)
    hdr = _header([(c, len(r)) for c, r in refs.items()])
    port = _call("GVCF", hdr, reads, refs, 2, True, small_regions=True, bed=bed)
    jhdr = JHeader()
    jhdr.hd = dict(hdr.hd)
    jhdr.sq = [dict(sq) for sq in hdr.sq]
    p = jmake_hc_params("GVCF", command_line="t")
    p.max_region_size = 60
    p.min_region_size = 20
    _, jout = jdriver.call_variants(
        p, jhdr, {c: list(v) for c, v in jreads.items()}, lambda c: refs[c],
        sample_name="s1", bed_regions=bed, use_device_pairhmm=True, nr_workers=2)
    assert port == [jformat(v) for v in jexpand(jout)] and port


def test_spawned_workers_run_on_the_cpu(monkeypatch):
    """A spawned worker hides every card and makes the CPU its session
    device before anything touches torch.cuda, even when the parent's
    session asks for cuda."""
    monkeypatch.delenv("ELPREP_TPU_TORCH_DEVICE", raising=False)
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    pool = parallel.get_pool(2)
    assert pool is not None
    infos = pool.probe_workers()
    assert len(infos) == 2
    for info in infos:
        assert info["pid"] != os.getpid()
        assert info["CUDA_VISIBLE_DEVICES"] == ""
        assert info["device"] == "cpu"
        assert info["cuda_initialized"] is False


@pytest.mark.parametrize("n_workers", [0, 1])
def test_get_pool_serial_below_two_workers(n_workers):
    assert parallel.get_pool(n_workers) is None


def test_dispatch_rule_batches_by_pairs_and_regions():
    """_RegionRun.dispatch_pairhmm, with a stub pool and executor: nothing
    is submitted below 8192 pairs and 64 pending regions, one batch of all
    pending regions at either limit, and a smaller one when forced."""
    import itertools
    import types

    sent = []
    pool = types.SimpleNamespace(n=1, req_qs=[None], owner_of=lambda gen, pos: 0)
    run = parallel._RegionRun(pool, 0, None, [], True)
    run.ph_pool = types.SimpleNamespace(submit=lambda fn, *a: sent.append((fn, a)))
    rids = itertools.count()

    def pend(n, n_reads, n_haps):
        """n regions of n_reads x n_haps pairs, each offered to the rule."""
        out = [next(rids) for _ in range(n)]
        for rid in out:
            run.pend_inputs[rid] = ([b"r"] * n_reads, [b"h"] * n_haps, [True] * n_haps)
            run.pend_received[rid] = rid
            run.pending_batch.append(rid)
            run.dispatch_pairhmm()
        return out

    batch = pend(7, 128, 8)  # 7 168 pairs
    assert not sent
    batch += pend(1, 128, 8)  # 8 192 pairs
    assert len(sent) == 1
    fn, (got, workloads, received) = sent.pop()
    assert fn == run._run_pairhmm and got == batch and received == batch
    assert [len(r) * len(h) for r, h, _ in workloads] == [1024] * 8
    assert not run.pending_batch and not run.pend_inputs and not run.pend_received
    batch = pend(63, 1, 1)
    assert not sent
    batch += pend(1, 1, 1)  # the 64th region
    assert [a[0] for _, a in sent] == [batch]
    batch = pend(3, 2, 3)
    run.dispatch_pairhmm(force=True)
    run.dispatch_pairhmm(force=True)  # nothing pending: nothing sent
    assert [a[0] for _, a in sent[1:]] == [batch]
