"""The deletions carry's ``consulted`` flag (elprep_tpu_torch/hc/genotyping.py)
and the pool workers' speculative genotyping
(``driver.genotype_region_speculative``): only a spanning-deletion ``*``
allele reads the carry, and a region that never reads it genotypes the
same under any carry, its outgoing carry the incoming one followed by
what the region appended. Imports nothing of the JAX package."""

import copy
import dataclasses

import numpy as np
import pytest

from elprep_tpu_torch import device
from elprep_tpu_torch.core.header import Header
from elprep_tpu_torch.filters.clipping import ClipRead
from elprep_tpu_torch.hc import driver
from elprep_tpu_torch.hc.activity import make_hc_params
from elprep_tpu_torch.hc.genotyping import (NON_REF, SPAN_DEL, AlleleFrequency,
                                            DeletionsHandler, compute_output_alleles,
                                            is_vc_covered_by_deletion)
from elprep_tpu_torch.hc.refconf import RefRun
from elprep_tpu_torch.io.vcf import Variant

_BASES = np.frombuffer(b"ACGT", np.uint8)


@pytest.fixture
def on_cpu(monkeypatch):
    monkeypatch.setenv("ELPREP_TPU_TORCH_DEVICE", "cpu")
    old = device._DEFAULT[0]
    device.set_default_device("cpu")
    yield
    device._DEFAULT[0] = old


def _af(alleles, counts):
    return AlleleFrequency(log10_p_ref={a: -8.0 for a in alleles}, allele_counts=counts)


@pytest.mark.parametrize("carry", [[], [(100, 110)], [(10, 20), (104, 300)]],
                         ids=["empty", "covering", "expired_and_covering"])
@pytest.mark.parametrize("mode", ["GVCF", "NONE"])
def test_span_del_allele_reads_the_carry(mode, carry):
    """A ``*`` allele is judged against the carry, empty or not."""
    params = make_hc_params(mode, command_line="t")
    merged = Variant(chrom="c", pos=105, ref="A", alt=["T", SPAN_DEL, NON_REF])
    d = DeletionsHandler(carry)
    compute_output_alleles(params, merged, ["T", SPAN_DEL, NON_REF], _af(merged.alt, [1, 1, 0]),
                           d)
    assert d.consulted


@pytest.mark.parametrize("ref,alts", [("A", [NON_REF]), ("A", ["T", NON_REF]),
                                      ("ATTG", ["A", NON_REF]), ("A", ["T", "C"]),
                                      ("AT", ["A"])],
                         ids=["ref_block", "snp", "deletion", "multi_snp", "deletion_none"])
@pytest.mark.parametrize("mode", ["GVCF", "NONE"])
def test_other_alleles_only_append(mode, ref, alts):
    """Without a ``*`` allele the flag stays unset and the carry is only
    appended to: the incoming entries come first, in order, whatever
    they are."""
    params = make_hc_params(mode, command_line="t")
    merged = Variant(chrom="c", pos=105, ref=ref, alt=list(alts))
    outs = []
    for carry in ([], [(1, 2), (100, 110), (104, 300)]):
        d = DeletionsHandler(carry)
        got = compute_output_alleles(params, merged, list(alts), _af(alts, [1] * len(alts)), d)
        assert not d.consulted
        assert d.slice[:len(carry)] == carry
        outs.append((got, d.slice[len(carry):]))
    assert outs[0] == outs[1]


def test_is_vc_covered_by_deletion_sets_the_flag():
    d = DeletionsHandler([])
    assert not d.consulted
    assert not is_vc_covered_by_deletion(d, Variant(chrom="c", pos=105, ref="A", alt=["T"]))
    assert d.consulted
    d = DeletionsHandler([(100, 110)])
    assert is_vc_covered_by_deletion(d, Variant(chrom="c", pos=105, ref="A", alt=["T"]))
    assert d.consulted


def _reads(ref):
    """A 200 bp deletion with a SNP inside its span on the other
    haplotype (a ``*`` allele is judged there) and a SNP cluster
    downstream: 120 reads of 120 bp, Q35."""
    hap_del = ref[:2000] + ref[2200:]
    sub = b"A" if ref[2104:2105] != b"A" else b"C"
    hap_snp = ref[:2104] + sub + ref[2105:]
    snp2 = b"G" if ref[4000:4001] != b"G" else b"T"
    hap_b = ref[:4000] + snp2 + ref[4001:]
    out = []
    for i in range(120):
        hap = (hap_del, hap_snp, hap_b)[i % 3]
        start = (1800 + (i * 13) % 500) if i % 3 != 2 else (3850 + (i * 11) % 250)
        seq = hap[start:start + 120]
        out.append(ClipRead(
            flag=0x63 if i % 2 == 0 else 0x93, pos=start + 1, pnext=start + 151,
            tlen=300 if i % 2 == 0 else -300, mapq=60, cigar=[(len(seq), "M")], seq=seq,
            qual=bytes([35]) * len(seq), rname=b"chr1", rnext=b"=", qname=b"cc%04d" % i))
    out.sort(key=lambda r: r.pos)
    return out


def _genotyped_regions(monkeypatch, mode):
    """Every region the serial run genotypes, as (params, pending, vals,
    keep, incoming), the pending copied before genotyping changes it."""
    ref = np.random.RandomState(17).choice(_BASES, 6000).tobytes()
    hdr = Header()
    hdr.hd = {"VN": "1.6", "SO": "coordinate"}
    hdr.sq = [{"SN": "chr1", "LN": str(len(ref))}]
    got = []
    orig = driver.genotype_region

    def spy(params, pending, vals, keep, incoming):
        got.append((params, copy.deepcopy(pending), vals, keep, list(incoming)))
        return orig(params, pending, vals, keep, incoming)

    monkeypatch.setattr(driver, "genotype_region", spy)
    driver.call_variants(make_hc_params(mode, command_line="t"), hdr,
                         {"chr1": _reads(ref)}, lambda c: ref, sample_name="s1",
                         use_device_pairhmm=False, nr_workers=1)
    monkeypatch.setattr(driver, "genotype_region", orig)
    return got


def _canon(x):
    """A comparable form of a region's variants (RefRun columns by value)."""
    if isinstance(x, RefRun):
        return ("RefRun", x.pos0, len(x),
                tuple(getattr(x, k).tobytes() for k in RefRun._KEYS))
    if dataclasses.is_dataclass(x):
        return (type(x).__name__,) + tuple(_canon(getattr(x, f.name))
                                           for f in dataclasses.fields(x))
    if isinstance(x, np.ndarray):
        return (x.dtype.str, x.shape, x.tobytes())
    if isinstance(x, (list, tuple)):
        return tuple(_canon(v) for v in x)
    if isinstance(x, dict):
        return tuple((k, _canon(v)) for k, v in x.items())
    return x


@pytest.mark.parametrize("mode", ["GVCF", "NONE"])
def test_unread_speculative_genotype_equals_the_carried_one(on_cpu, monkeypatch, mode):
    """For a region whose speculative genotyping never read the carry, the
    speculative result with the true carry put in front of its outgoing
    list equals genotype_region under that carry: the carry the serial
    run gave it and a non-empty one that covers the region. The
    deletion's region does read it."""
    regions = _genotyped_regions(monkeypatch, mode)
    consulted = []
    for params, pending, vals, keep, incoming in regions:
        variants, outgoing, read = driver.genotype_region_speculative(
            params, copy.deepcopy(pending), vals, keep)
        consulted.append(read)
        if read:
            continue
        lo, hi = pending.region.start, pending.region.end
        for carry in (incoming, [(1, 2), (lo - 5, hi + 5)]):
            want_variants, want_out = driver.genotype_region(
                params, copy.deepcopy(pending), vals, keep, list(carry))
            assert _canon(variants) == _canon(want_variants)
            assert list(carry) + outgoing == want_out
    assert consulted == [True, False]


def test_genotype_region_keeps_its_result_for_its_callers(on_cpu, monkeypatch):
    """genotype_region still returns (variants, outgoing) and starts from
    the carry it is given; the speculative form starts from none."""
    params, pending, vals, keep, _ = _genotyped_regions(monkeypatch, "GVCF")[-1]
    carry = [(1, 2)]
    variants, outgoing = driver.genotype_region(params, copy.deepcopy(pending), vals, keep,
                                                carry)
    assert carry == [(1, 2)] and outgoing[:1] == carry and len(outgoing) > 1
    spec = driver.genotype_region_speculative(params, copy.deepcopy(pending), vals, keep)
    assert spec[1] == outgoing[1:] and spec[2] is False
