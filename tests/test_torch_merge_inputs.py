"""The port's multi-file input merging (elprep_tpu_torch/io/merge_inputs.py)
against the JAX package's: the same sequence dictionaries, the same
merged header with RG/PG collisions renamed, and the same records with
their tags rewritten."""

import pytest

from elprep_tpu.io import sam as jsamio
from elprep_tpu.io.merge_inputs import (merge_sequence_dictionaries as jmerge_sq,
                                        read_and_merge_files as jread_and_merge)
from elprep_tpu_torch.io import sam as samio
from elprep_tpu_torch.io.merge_inputs import (merge_sequence_dictionaries,
                                              read_and_merge_files)


def _sq(*names):
    return [{"SN": n, "LN": str(100 * (i + 1))} for i, n in enumerate(names)]


@pytest.mark.parametrize("a,b,want", [
    (("chr1", "chr3"), ("chr2", "chr3"), ["chr1", "chr2", "chr3"]),
    (("chr1", "chr2"), ("chr3",), ["chr1", "chr2", "chr3"]),
    (("chr2",), ("chr1", "chr2", "chr4"), ["chr1", "chr2", "chr4"]),
])
def test_merge_sequence_dictionaries_match_jax(a, b, want):
    got = merge_sequence_dictionaries(_sq(*a), _sq(*b))
    assert [d["SN"] for d in got] == want
    assert got == jmerge_sq(_sq(*a), _sq(*b))


def test_merge_sequence_dictionaries_conflict_raises_in_both():
    a, b = _sq("chr1", "chr2"), _sq("chr2", "chr1")
    with pytest.raises(ValueError, match="Cannot merge"):
        merge_sequence_dictionaries(a, b)
    with pytest.raises(ValueError, match="Cannot merge"):
        jmerge_sq(a, b)


def test_read_and_merge_files_matches_jax(tmp_path):
    f1 = tmp_path / "a.sam"
    f1.write_bytes(
        b"@HD\tVN:1.6\tSO:coordinate\n@SQ\tSN:chr1\tLN:1000\n"
        b"@RG\tID:rg1\tSM:s1\n@PG\tID:pg1\tPN:x\n"
        b"r1\t0\tchr1\t10\t60\t4M\t*\t0\t0\tACGT\tIIII\tRG:Z:rg1\n")
    f2 = tmp_path / "b.sam"
    f2.write_bytes(
        b"@HD\tVN:1.6\tSO:coordinate\n@SQ\tSN:chr2\tLN:2000\n"
        b"@RG\tID:rg1\tSM:s2\n@PG\tID:pg1\tPN:y\n"
        b"r2\t0\tchr2\t20\t60\t4M\t*\t0\t0\tACGT\tIIII\tRG:Z:rg1\tPG:Z:pg1\n")
    hdr, batch = read_and_merge_files([str(f1), str(f2)])
    assert [d["SN"] for d in hdr.sq] == ["chr1", "chr2"]
    rg_ids = [r["ID"] for r in hdr.rg]
    assert rg_ids[0] == "rg1" and rg_ids[1] != "rg1"
    pg_ids = [r["ID"] for r in hdr.pg]
    assert pg_ids[0] == "pg1" and pg_ids[1] != "pg1"
    assert len(batch) == 2
    vals = batch.tags.extract_z(b"RG")
    assert vals[0] == b"rg1" and vals[1] == rg_ids[1].encode()
    assert hdr.hd["SO"] == "unknown"
    jhdr, jbatch = jread_and_merge([str(f1), str(f2)])
    assert samio.format_sam_header(hdr) == jsamio.format_sam_header(jhdr)
    assert samio.format_alignments(batch) == jsamio.format_alignments(jbatch)
