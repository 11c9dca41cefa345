"""The generator: the same seed gives the same bytes, another seed other
bytes of the same size; a configuration without ``qual_model`` generates
what it did, and ``"hiseq2000"`` keeps to its own statistics."""

import filecmp
import json
import os

import tiny  # noqa: F401  (puts gpubench/ on the path)
from gen import fixture

CONFIGS = os.path.join(tiny.BENCH, "configs")


def _cfg(name, **cut):
    with open(os.path.join(CONFIGS, name + ".json")) as fh:
        cfg = json.load(fh)
    cfg.update(cut)
    return cfg


def test_same_seed_same_bytes(tmp_path):
    cfg = _cfg("platinum_wgs50x_2x101", contigs=[["chr1", 6000], ["chr2", 4000]])
    seed = 2**31 + 12345
    a = fixture.write_inputs(fixture.make_fixture(cfg, seed), str(tmp_path / "a"), "x")
    b = fixture.write_inputs(fixture.make_fixture(cfg, seed), str(tmp_path / "b"), "x")
    for k in ("fasta", "bed", "sam"):
        assert filecmp.cmp(a[k], b[k], shallow=False), k


STRETCHES = {"stretch_every": 20000, "stretch_snps": [9, 9], "stretch_gap": [25, 35],
             "stretch_span": [218, 224]}


def test_other_seed_same_work_other_order_and_names():
    cfg = _cfg("platinum_wgs50x_2x101", contigs=[["chr1", 22000], ["chr2", 4000]],
               read_length=300, depth=30, **STRETCHES)
    f1, f2 = fixture.make_fixture(cfg, 1), fixture.make_fixture(cfg, 2**33 + 7)
    assert f1.n_reads == f2.n_reads and f1.snps == f2.snps and f1.stretches
    # a stretch is homozygous unless the configuration names its carriers
    (c, lo, hi), = f1.stretches
    assert {w for c_, p, _, w in f1.snps if c_ == c and lo <= p <= hi} == {3}
    het = fixture.make_fixture(dict(cfg, stretch_carriers=[1, 2]), 1)
    (c, lo, hi), = het.stretches
    assert [w for c_, p, _, w in het.snps if c_ == c and lo <= p <= hi] == [1, 2] * 4 + [1]
    a, b = fixture.sam_lines(f1), fixture.sam_lines(f2)
    assert a[:50] != b[:50]
    # the same reads, named and ordered otherwise
    assert sorted(ln.split("\t", 1)[1] for ln in a) == sorted(ln.split("\t", 1)[1] for ln in b)


def test_names_distinct_and_optical_copies_nearby():
    cfg = _cfg("platinum_wgs50x_2x101", contigs=[["chr1", 30000], ["chr2", 10000]])
    fx = fixture.make_fixture(cfg, 7)
    names = [ln.split("\t", 1)[0] for ln in fixture.sam_lines(fx)[::2]]
    assert len(set(names)) == len(names)
    p = fx.pairs
    key = list(zip(p["contig"], p["pos"], p["mpos"], p["clip"]))
    same = {}
    for i, k in enumerate(key):
        same.setdefault(k, []).append(i)
    near = 0
    for group in same.values():
        for i in group[1:]:
            j = group[0]
            near += (p["tile"][i] == p["tile"][j] and p["lane"][i] == p["lane"][j]
                     and abs(int(p["x"][i]) - int(p["x"][j])) <= 80
                     and abs(int(p["y"][i]) - int(p["y"][j])) <= 80)
    assert near > 0


def test_read_count_follows_depth():
    cfg = _cfg("platinum_wgs50x_2x101")
    fx = fixture.make_fixture(cfg, 3)
    total = sum(ln for _, ln in cfg["contigs"])
    assert abs(fx.n_reads * cfg["read_length"] / total - cfg["depth"]) < 0.1


# sha256 of the FASTA, known-sites BED and SAM that the parent of the
# capture keys generated for wgs50x.5step's configuration at two seeds
WGS_DIGESTS = {
    2147483659: ("bc6f4ba104be0fef4e5a3ddc03ff11f02ff20021e0cac261792243c88ab9c3ea",
                 "8d55bfb3099d1799a85fb5c439bd20f92779d1b3d7fe989adb3bc75e342e6f2a",
                 "01f2f0162916bd0af088b4c8755cab23b116b488f0db6b6e2abce30fb81a17a0"),
    7: ("bc6f4ba104be0fef4e5a3ddc03ff11f02ff20021e0cac261792243c88ab9c3ea",
        "8d55bfb3099d1799a85fb5c439bd20f92779d1b3d7fe989adb3bc75e342e6f2a",
        "615eedf9d3d9c1deeefdf742b9df6f210cc5c029ab34c4637241c990bf193429"),
}


def test_wgs_inputs_are_byte_identical(tmp_path):
    """A configuration without the capture keys or ``qual_model`` generates
    what it did."""
    import hashlib

    cfg = _cfg("platinum_wgs50x_2x101")
    for seed, want in WGS_DIGESTS.items():
        fx = fixture.make_fixture(cfg, seed)
        assert not fx.targets
        paths = fixture.write_inputs(fx, str(tmp_path / str(seed)), "input")
        assert "targets" not in paths
        got = tuple(hashlib.sha256(open(paths[k], "rb").read()).hexdigest()
                    for k in ("fasta", "bed", "sam"))
        assert got == want, seed


# the same for the tests' capture configuration, FASTA, BED, SAM and
# targets BED, as the parent of the quality model generated them
CAPTURE_DIGESTS = {
    2147483659: ("9b620698229e26e403f4fb0a6e192c9f47edc130c73d3661a058cacca9e937f1",
                 "94f3be29f531841e7b384265c374b08af2e89d0c1f99c50abc169297d62d2ba2",
                 "22feab97a729c016e262b7f6b230da26e949fab289b2a306619e4c2fe2607e17",
                 "804b378ddf0f47f0b59d7366eb106a92673a6d5f0f1004e4b8b896217a59092e"),
    7: ("9b620698229e26e403f4fb0a6e192c9f47edc130c73d3661a058cacca9e937f1",
        "94f3be29f531841e7b384265c374b08af2e89d0c1f99c50abc169297d62d2ba2",
        "380b5ddc5dbf2f246b2f9dbeac1a964ba56f674fd1025adfc95ae35019cc0a51",
        "804b378ddf0f47f0b59d7366eb106a92673a6d5f0f1004e4b8b896217a59092e"),
}


def test_capture_inputs_are_byte_identical(tmp_path):
    """A capture configuration without ``qual_model`` generates what it did."""
    import hashlib

    cfg = _capture()
    assert "qual_model" not in cfg
    for seed, want in CAPTURE_DIGESTS.items():
        paths = fixture.write_inputs(fixture.make_fixture(cfg, seed), str(tmp_path / str(seed)),
                                     "input")
        got = tuple(hashlib.sha256(open(paths[k], "rb").read()).hexdigest()
                    for k in ("fasta", "bed", "sam", "targets"))
        assert got == want, seed


def _sam_quals(fx):
    """Each read's raw qualities in sequencing order (5' to 3'), from the
    SAM: a reversed read's QUAL is read backwards."""
    import numpy as np

    out = []
    for ln in fixture.sam_lines(fx):
        f = ln.split("\t")
        q = np.frombuffer(f[10].encode(), np.uint8) - 33
        out.append(q[::-1] if int(f[1]) & 0x10 else q)
    return np.stack(out)


def test_hiseq2000_quality_model():
    """``"hiseq2000"``: at least 80 % of bases at Q30 or above (Illumina's
    HiSeq 2000 specification at 2x100 bp), no base below Q6 outside a 3'
    tail, Q2 tails contiguous at the 3' end, 1-20 cycles long, on about
    30 % of reads, a mean falling from about Q38 to about Q30; the reads'
    positions, bases, MAPQ, names and order as without the key."""
    import numpy as np

    cfg = _cfg("platinum_wgs50x_2x101", contigs=[["chr1", 30000], ["chr2", 10000]])
    seed = 2**31 + 77
    plain = fixture.make_fixture(cfg, seed)
    fx = fixture.make_fixture(dict(cfg, qual_model="hiseq2000"), seed)
    for k, v in plain.pairs.items():
        if not k.startswith("qual"):
            assert np.array_equal(fx.pairs[k], v), k
    assert [ln.split("\t")[:10] for ln in fixture.sam_lines(fx)] == \
        [ln.split("\t")[:10] for ln in fixture.sam_lines(plain)]

    q = _sam_quals(fx)
    n, rl = q.shape
    assert n > 10000 and q.max() <= 41
    assert (q >= 30).mean() >= 0.80, (q >= 30).mean()
    low = q < 6
    # the first cycle from the 3' end that is not low: the tail's length
    tail = np.where(low[:, ::-1].all(1), rl, np.argmin(low[:, ::-1], axis=1))
    assert not (low & (np.arange(rl)[None, ::-1] >= tail[:, None])).any()  # none inside a read
    assert (q[low] == 2).all()
    has = tail > 0
    assert 0.28 <= has.mean() <= 0.32, has.mean()
    assert tail[has].min() == 1 and tail[has].max() == 20
    inner = np.where(low, np.nan, q.astype(float))
    first, last = np.nanmean(inner[:, 0]), np.nanmean(inner[:, -1])
    assert 37 <= first <= 39 and 29 <= last <= 31, (first, last)


def test_unknown_quality_model_is_refused():
    import pytest

    cfg = _cfg("platinum_wgs50x_2x101", contigs=[["chr1", 6000], ["chr2", 4000]])
    with pytest.raises(ValueError, match="qual_model"):
        fixture.make_fixture(dict(cfg, qual_model="novaseq"), 1)


def _capture(**cut):
    with open(os.path.join(tiny.HERE, "configs", "capture_test.json")) as fh:
        cfg = json.load(fh)
    cfg.update(cut)
    return cfg


def test_capture_targets_and_on_target_share(tmp_path):
    """The target BED is sorted, apart and within its ranges; the pairs
    with a read on a target are the on-target share, give or take the
    uniform pairs that land on one by chance; the target bases are
    covered at ``depth``, 3 % below to 10 % above (the uniform pairs'
    share); another seed, the same targets and work."""
    import numpy as np

    from reference import records, targets

    cfg = _capture(contigs=[["chr1", 60000], ["chr2", 40000]], target_gap=[1500, 4500])
    fx = fixture.make_fixture(cfg, 2**31 + 5)
    paths = fixture.write_inputs(fx, str(tmp_path), "x")
    rl, (lo_l, hi_l), (lo_g, hi_g) = cfg["read_length"], cfg["target_length"], cfg["target_gap"]
    lengths = dict(cfg["contigs"])
    with open(paths["targets"]) as fh:
        rows = [ln.split("\t") for ln in fh.read().splitlines()]
    assert [(c, int(s), int(e)) for c, s, e in rows] == fx.targets and len(fx.targets) > 20
    for (c1, s1, e1), (c2, s2, e2) in zip(fx.targets, fx.targets[1:]):
        assert c1 != c2 or lo_g <= s2 - e1 <= hi_g
    for c, s, e in fx.targets:
        assert lo_l <= e - s <= hi_l and 3 * rl + 100 < s and e <= lengths[c] - 3 * rl - 100
    bed = targets.read_bed(paths["targets"])
    assert sum(len(v) for v in bed.values()) == len(fx.targets)  # nothing to flatten

    _, r = records.read_sam(paths["sam"])
    on = {}
    for i, k in enumerate(targets.kept(r, bed)):
        on[r.qname[i]] = on.get(r.qname[i], False) or k
    share = float(np.mean(list(on.values())))
    t_len = sum(e - s for _, s, e in fx.targets)
    chance = 2 * sum(e - s + rl for _, s, e in fx.targets) / sum(lengths.values())
    want = cfg["on_target_share"]
    assert want - 0.01 <= share <= want + (1 - want) * chance + 0.01, (share, chance)
    cov = 0
    for i in range(len(r)):
        first = r.pos[i]
        last = first + sum(n for n, op in r.cigar[i] if op in "MDN=X") - 1
        for s, e in bed.get(r.rname[i], []):
            cov += max(0, min(last, e) - max(first, s + 1) + 1)
    assert 0.97 * cfg["depth"] <= cov / t_len <= 1.10 * cfg["depth"], cov / t_len
    other = fixture.make_fixture(cfg, 3)
    assert other.targets == fx.targets and other.n_reads == fx.n_reads
