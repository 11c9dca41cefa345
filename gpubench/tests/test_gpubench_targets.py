"""The reference under ``--target-regions``: which reads elPrep's
RemoveNonOverlappingReads keeps, the flattened calling spans, and the
GVCF's tiling of those spans."""

import numpy as np

import tiny  # noqa: F401  (puts gpubench/ on the path)
from reference import gvcf, records, targets


def _bed(tmp_path, text):
    path = tmp_path / "t.bed"
    path.write_text(text)
    return targets.read_bed(str(path))


def _reads(rows):
    """Reads from (rname, pos, cigar, flag)."""
    r = records.Reads()
    for k, (c, pos, cig, flag) in enumerate(rows):
        r.qname.append(b"r%d" % k)
        r.flag.append(flag)
        r.rname.append(c)
        r.pos.append(pos)
        r.cigar.append(records.parse_cigar(cig))
    return r


def test_bed_is_sorted_and_flattened(tmp_path):
    bed = _bed(tmp_path, "track name=x\nchr1\t500\t600\nchr1\t100\t200\n"
                         "chr1\t200\t250\nchr1\t240\t300\n# a comment\nchr2\t10\t20\n")
    assert bed == {"chr1": [(100, 300), (500, 600)], "chr2": [(10, 20)]}
    assert targets.spans(bed) == {"chr1": [(101, 300), (501, 600)], "chr2": [(11, 20)]}


def test_kept_reads_overlap_a_target(tmp_path):
    """chr1 100-200 holds 1-based positions 101-200."""
    bed = _bed(tmp_path, "chr1\t100\t200\nchr1\t400\t500\n")
    rows = [("chr1", 91, "10M", 0),     # 91-100: ends just before
            ("chr1", 92, "10M", 0),     # 92-101: its last base
            ("chr1", 200, "10M", 0),    # 200-209: its first base is the last
            ("chr1", 201, "10M", 0),    # 201-210: just after
            ("chr1", 95, "3S4M2D1M", 0),  # 95-101 by reference length 7
            ("chr1", 95, "5M5I", 0),    # 95-99: the insertion takes no position
            ("chr1", 150, "10M", 0x4),  # unmapped: counts at 150
            ("chr1", 390, "*", 0),      # no read length: counts at 390
            ("chr1", 300, "150M", 0),   # 300-449: reaches the second
            ("chr2", 150, "10M", 0)]    # no target on chr2
    assert targets.kept(_reads(rows), bed) == [False, True, True, False, True, False, True,
                                               False, True, False]


def _rec(c, pos, end, ref="A"):
    return [c, str(pos), ".", ref, "<NON_REF>", ".", ".", "END=%d" % end, "GT", "0/0:1"]


def test_gvcf_tiles_the_calling_spans():
    contigs = [("chr1", 50), ("chr2", 20)]
    genome = {c: np.frombuffer(b"A" * n, np.uint8) for c, n in contigs}
    counts = {c: np.zeros((n, 4), np.int64) for c, n in contigs}
    spans = {"chr1": [(11, 20), (31, 40)]}

    def tiling(recs, sp=spans):
        return gvcf.check(recs, contigs, genome, counts, [], None, sp)["gvcf_tiling_errors"]

    whole = [_rec("chr1", 11, 15), _rec("chr1", 16, 20), _rec("chr1", 31, 40)]
    assert tiling(whole) == 0
    assert tiling(whole[:1] + whole[2:]) == 1                   # 16-20 left out
    assert tiling(whole + [_rec("chr1", 45, 45)]) == 1           # outside every span
    assert tiling([_rec("chr1", 10, 15)] + whole[1:]) == 2       # starts before the span: 11-15 left out
    assert tiling(whole[:2] + [_rec("chr1", 31, 41)]) == 1       # past the span's end
    assert tiling(whole + [_rec("chr2", 1, 20)]) == 1            # a contig without targets
    assert tiling([_rec("chr1", 1, 50), _rec("chr2", 1, 20)], None) == 0  # whole contigs
    assert tiling([_rec("chr1", 1, 49), _rec("chr2", 1, 20)], None) == 1
