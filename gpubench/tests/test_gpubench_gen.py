"""The generator: the same seed gives the same bytes, another seed other
bytes of the same size."""

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
