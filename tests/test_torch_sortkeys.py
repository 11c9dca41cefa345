"""The port's sort permutations and per-read statistics
(elprep_tpu_torch/ops/{sortkeys,readstats}.py, core/pipeline.py) against
the JAX package's, bit for bit, on fuzzed columns and samgen batches with
unmapped reads, ties and negative TLEN. Inputs come from numpy seeds."""

import numpy as np
import pytest
import torch

from elprep_tpu.core.header import SortingOrder as JSortingOrder
from elprep_tpu.core.pipeline import sort_batch as jax_sort_batch
from elprep_tpu.filters import add_refid as jax_add_refid
from elprep_tpu.io.sam import parse_sam as jax_parse_sam
from elprep_tpu.ops import readstats as jax_readstats
from elprep_tpu.ops import sortkeys as jax_sortkeys
from elprep_tpu_torch.core.header import SortingOrder
from elprep_tpu_torch.core.pipeline import sort_batch
from elprep_tpu_torch.filters import add_refid
from elprep_tpu_torch.io.sam import parse_sam
from elprep_tpu_torch.ops import readstats, sortkeys

from samgen import make_sam

torch.set_num_threads(1)

RGS = [{"ID": "grp1", "LB": "libA"}, {"ID": "grp2", "LB": "libB"}]


def _columns(n, seed, extreme=False):
    """Sort-key columns with many ties: few refids (-1 = unmapped), few
    positions and QNAME ranks, every FLAG bit, TLEN of both signs."""
    rng = np.random.RandomState(seed)
    i32 = np.int32
    if extreme:
        big = np.iinfo(np.int32).max
        pos = rng.choice([0, 1, big - 1, big], n).astype(i32)
        tlen = rng.choice([-big, -1, 0, 1, big], n).astype(i32)
        pnext = rng.choice([0, big], n).astype(i32)
        qrank = rng.choice([0, big - 1], n).astype(i32)
    else:
        pos = rng.randint(0, 40, n).astype(i32)
        tlen = rng.randint(-300, 300, n).astype(i32)
        pnext = rng.randint(0, 40, n).astype(i32)
        qrank = rng.randint(0, max(1, n // 3), n).astype(i32)
    return dict(
        flag=rng.randint(0, 0x1000, n).astype(i32),
        refid=rng.randint(-1, 3, n).astype(i32),
        pos=pos,
        mapq=rng.randint(0, 256, n).astype(i32),
        next_refid=rng.randint(-1, 3, n).astype(i32),
        pnext=pnext,
        tlen=tlen,
        qrank=qrank,
    )


_ORDER = ("flag", "refid", "pos", "mapq", "next_refid", "pnext", "tlen", "qrank")


@pytest.mark.parametrize("n,seed,extreme", [(1, 1, False), (7, 2, False),
                                             (1000, 3, False), (3001, 4, False),
                                             (500, 5, True)])
def test_coordinate_sort_perm_matches_jax(n, seed, extreme):
    cols = _columns(n, seed, extreme)
    args = [cols[k] for k in _ORDER]
    got = sortkeys.coordinate_sort_perm(*args, device="cpu")
    assert got.dtype == torch.int64 and got.device.type == "cpu"
    want = np.asarray(jax_sortkeys.coordinate_sort_perm(*args))
    assert got.numpy().tolist() == want.tolist()
    host = jax_sortkeys.coordinate_sort_perm_host(*args)
    assert got.numpy().tolist() == np.asarray(host).tolist()
    assert sortkeys.coordinate_sort_perm_host(*args).tolist() == np.asarray(host).tolist()


@pytest.mark.parametrize("seed", [6, 7])
def test_queryname_sort_perm_matches_jax(seed):
    qrank = np.random.RandomState(seed).randint(0, 50, 777).astype(np.int32)
    got = sortkeys.queryname_sort_perm(qrank, device="cpu")
    want = np.asarray(jax_sortkeys.queryname_sort_perm(qrank))
    assert got.numpy().tolist() == want.tolist()


def _both(n, seed):
    data = make_sam(n, seed=seed, rgs=RGS, rg_ids=["grp1", "grp2"])
    jh, jb = jax_parse_sam(data)
    jax_add_refid(jh)(jb)
    ph, pb = parse_sam(data)
    add_refid(ph)(pb)
    return (jh, jb), (ph, pb)


@pytest.mark.parametrize("order", ["coordinate", "queryname"])
def test_sort_batch_matches_jax(order):
    (_, jb), (_, pb) = _both(1500, seed=31)
    got = sort_batch(pb, SortingOrder(order), device="cpu")
    want = jax_sort_batch(jb, JSortingOrder(order))
    for col in ("qname", "flag", "pos", "tlen"):
        assert np.asarray(getattr(got, col)).tolist() == \
            np.asarray(getattr(want, col)).tolist(), col


def test_readstats_match_jax():
    (_, jb), (_, pb) = _both(800, seed=5)
    op_class, op_len, n_ops = readstats.pad_cigars(pb.cigar_len, pb.cigar_op)
    j_class, j_len, j_nops = jax_readstats.pad_cigars(jb.cigar_len, jb.cigar_op)
    assert np.array_equal(op_class, j_class) and np.array_equal(op_len, j_len)
    q, ql = readstats.pad_quals(pb.qual)
    checks = [
        (readstats.phred_score(q, ql, device="cpu"),
         jax_readstats.phred_score(q, ql)),
        (readstats.unclipped_position(pb.pos, pb.flag, op_class, op_len, n_ops,
                                      device="cpu"),
         jax_readstats.unclipped_position(pb.pos, pb.flag, op_class, op_len, n_ops)),
        (readstats.read_length_from_cigar(op_class, op_len, device="cpu"),
         jax_readstats.read_length_from_cigar(op_class, op_len)),
        (readstats.reference_length_from_cigar(op_class, op_len, device="cpu"),
         jax_readstats.reference_length_from_cigar(op_class, op_len)),
    ]
    for got, want in checks:
        assert got.dtype == torch.int32
        assert got.numpy().tolist() == np.asarray(want).tolist()


def test_unclipped_position_edge_cases_match_jax():
    sam = (
        b"@SQ\tSN:c\tLN:10000\n"
        b"r1\t0\tc\t100\t30\t5S95M\t*\t0\t0\t" + b"A" * 100 + b"\t" + b"I" * 100 + b"\n"
        b"r2\t16\tc\t100\t30\t95M5S\t*\t0\t0\t" + b"A" * 100 + b"\t" + b"I" * 100 + b"\n"
        b"r3\t16\tc\t100\t30\t5H90M5S\t*\t0\t0\t" + b"A" * 95 + b"\t" + b"I" * 95 + b"\n"
        b"r4\t0\tc\t100\t30\t3H2S95M\t*\t0\t0\t" + b"A" * 97 + b"\t" + b"I" * 97 + b"\n"
        b"r5\t16\tc\t100\t30\t10M2D5M2I3N7M\t*\t0\t0\t" + b"A" * 24 + b"\t" + b"I" * 24 + b"\n"
        b"r6\t4\t*\t0\t0\t*\t*\t0\t0\t" + b"A" * 10 + b"\t" + b"I" * 10 + b"\n"
    )
    _, b = parse_sam(sam)
    op_class, op_len, n_ops = readstats.pad_cigars(b.cigar_len, b.cigar_op)
    got = readstats.unclipped_position(b.pos, b.flag, op_class, op_len, n_ops,
                                       device="cpu")
    want = jax_readstats.unclipped_position(b.pos, b.flag, op_class, op_len, n_ops)
    assert got.numpy().tolist() == np.asarray(want).tolist()
    assert got[0].item() == 95 and got[1].item() == 100 - 1 + 95 + 5
