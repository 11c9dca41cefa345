"""The port's duplicate marking (elprep_tpu_torch.ops.dedup, torch on the
CPU) against the JAX package's on the same seeded inputs: the mask of the
torch program, of the host twin and of the JAX program are equal, with
and without padding; the derived columns are equal; and the hand-computed
adversarial cases of tests/test_dedup_adversarial.py pass through the
port's pipeline on both of its routes."""

import functools

import numpy as np
import pytest
import torch

import test_dedup_adversarial as adv
from elprep_tpu.core.pipeline import SamData as JSamData, run_pipeline as jrun
from elprep_tpu.filters import add_refid as jadd_refid
from elprep_tpu.io.sam import parse_sam as jparse
from elprep_tpu.ops import dedup as jdedup
from elprep_tpu.ops import sortkeys as jsortkeys
from elprep_tpu_torch import native
from elprep_tpu_torch.core.header import SortingOrder
from elprep_tpu_torch.core.pipeline import SamData, run_pipeline
from elprep_tpu_torch.filters import add_refid, mark_duplicates_filter
from elprep_tpu_torch.io import sam as samio
from elprep_tpu_torch.ops import dedup, dispatch, sortkeys
from samgen import make_sam

torch.set_num_threads(1)

RGS = [{"ID": "grp1", "LB": "libA"}, {"ID": "grp2", "LB": "libB"},
       {"ID": "grp3", "LB": "libA"}, {"ID": "grp4"}]  # grp4: no LB -> libid -1
RG_IDS = ["grp1", "grp2", "grp3", "grp4"]

# flag bits the duels read, in combinations that reach every branch
_FLAGS = np.array([0x0, 0x10, 0x1, 0x1 | 0x10, 0x1 | 0x8, 0x1 | 0x20,
                   0x1 | 0x10 | 0x80, 0x4, 0x1 | 0x4, 0x100, 0x1 | 0x100,
                   0x800, 0x1 | 0x800, 0x1 | 0x40], np.int32)


def _random_cols(n, seed):
    """Dedup input columns with dense collisions: few positions, libids
    including -1, refids including -1, tied scores, qnames shared by 1-3
    reads (so pair runs of odd size occur), every flag class."""
    rng = np.random.RandomState(seed)
    libid = rng.randint(-1, 2, n).astype(np.int32)
    refid = rng.randint(-1, 2, n).astype(np.int32)
    upos = rng.randint(-2, 2 + n // 100, n).astype(np.int32)
    rev = rng.randint(0, 2, n).astype(np.int32)
    score = (rng.randint(0, 4, n) * 30).astype(np.int32)
    qrank = rng.randint(0, max(1, n // 2), n).astype(np.int32)
    flag = rng.choice(_FLAGS, n).astype(np.int32)
    return libid, refid, upos, rev, score, qrank, flag


def _jax_mask(cols):
    import jax.numpy as jnp

    return np.asarray(jdedup.mark_duplicates(*(jnp.asarray(c) for c in cols)))


@pytest.mark.parametrize("n,seed", [(1, 1), (2, 2), (7, 3), (33, 4), (257, 5),
                                    (1000, 6), (3001, 7)])
def test_mark_duplicates_matches_jax(n, seed):
    cols = _random_cols(n, seed)
    want = _jax_mask(cols)
    got = dedup.mark_duplicates(*cols, device="cpu")
    assert got.dtype == torch.bool and got.shape == (n,)
    assert got.numpy().tolist() == want.tolist()
    assert dedup.mark_duplicates_host(*cols).tolist() == want.tolist()
    if n >= 33:
        assert want.any()  # the fixture has duplicates to find


@pytest.mark.parametrize("n,seed", [(1, 11), (5, 12), (100, 13), (1023, 14)])
def test_padding_does_not_change_the_mask(n, seed):
    """The JAX package pads to a power of two with ineligible dummies;
    the port does not. The mask of the real rows is the same either way
    (the pair-formation roll wraps at row 0 on both lengths)."""
    cols = _random_cols(n, seed)
    n_pad = 1 << max(0, (n - 1).bit_length())
    n_pad = max(n_pad * 2, 2)
    fills = (-1, 2**30, 0, 0, 0, 2**30, 0x4)
    padded = [np.concatenate([c, np.full(n_pad - n, f, np.int32)])
              for c, f in zip(cols, fills)]
    plain = dedup.mark_duplicates(*cols, device="cpu").numpy()
    pad = dedup.mark_duplicates(*padded, device="cpu").numpy()
    assert not pad[n:].any()
    assert pad[:n].tolist() == plain.tolist()
    assert _jax_mask(padded)[:n].tolist() == plain.tolist()


def test_empty_batch():
    z = np.zeros(0, np.int32)
    assert dedup.mark_duplicates(z, z, z, z, z, z, z, device="cpu").numel() == 0
    assert dedup.mark_duplicates_host(z, z, z, z, z, z, z).size == 0


def _both_batches(n, seed):
    data = make_sam(n, seed=seed, rgs=RGS, rg_ids=RG_IDS)
    jh, jb = jparse(data)
    jadd_refid(jh)(jb)
    ph, pb = samio.parse_sam(data)
    add_refid(ph)(pb)
    return (jh, jb), (ph, pb)


@pytest.mark.parametrize("use_native", [True, False])
def test_dedup_columns_match_jax(monkeypatch, use_native):
    (jh, jb), (ph, pb) = _both_batches(1500, 21)
    want = jdedup.dedup_columns(jb, jh)
    if not use_native:
        # the readstats ops (the cuda route's) instead of the native engine
        monkeypatch.setattr(native, "dedup_score_upos", lambda *a, **k: None)
    got = dedup.dedup_columns(pb, ph, device="cpu")
    for g, w in zip(got, want):
        assert np.asarray(g).tolist() == np.asarray(w).tolist()


@pytest.mark.parametrize("route", ["host", "torch"])
def test_mark_duplicates_batch_matches_jax(monkeypatch, route):
    (jh, jb), (ph, pb) = _both_batches(3000, 22)
    want, waux = jdedup.mark_duplicates_batch(jb, jh)
    if route == "torch":
        monkeypatch.setattr(dispatch, "routes_to_host", lambda n, device=None: False)
    got, aux = dedup.mark_duplicates_batch(pb, ph, device="cpu")
    assert want.sum() > 10
    assert got.tolist() == np.asarray(want).tolist()
    for k in ("libid", "upos", "score", "qrank"):
        assert np.asarray(aux[k]).tolist() == np.asarray(waux[k]).tolist()
    assert sortkeys.qname_ranks(pb.qname).tolist() == \
        jsortkeys.qname_ranks(jb.qname).tolist()


_ADVERSARIAL = sorted(n for n in dir(adv) if n.startswith("test_"))


@pytest.mark.parametrize("route", ["host", "torch"])
@pytest.mark.parametrize("case", _ADVERSARIAL)
def test_adversarial_cases_through_the_port(monkeypatch, case, route):
    """Each hand-computed case of tests/test_dedup_adversarial.py, run
    once through the JAX pipeline and once through the port's (its CPU
    route, or its torch route on the CPU), against the same expected
    flags."""
    assert len(_ADVERSARIAL) == 10
    getattr(adv, case)()  # the JAX package
    if route == "torch":
        monkeypatch.setattr(dispatch, "routes_to_host", lambda n, device=None: False)
    for name, val in (("sam", samio), ("SamData", SamData),
                      ("run_pipeline", functools.partial(run_pipeline, device="cpu")),
                      ("add_refid", add_refid), ("SortingOrder", SortingOrder),
                      ("mark_duplicates_filter",
                       functools.partial(mark_duplicates_filter, device="cpu"))):
        monkeypatch.setattr(adv, name, val)
    getattr(adv, case)()  # the port


def test_pipeline_sort_and_dedup_matches_jax():
    """add_refid + mark duplicates + coordinate sort: the same flags in
    the same order as the JAX pipeline."""
    from elprep_tpu.core.header import SortingOrder as JSO
    from elprep_tpu.filters import mark_duplicates_filter as jmdf

    (jh, jb), (ph, pb) = _both_batches(2000, 23)
    jout = jrun(JSamData(jh, jb), [jmdf()], JSO.COORDINATE)
    pout = run_pipeline(SamData(ph, pb), [mark_duplicates_filter(device="cpu")],
                        SortingOrder.COORDINATE, device="cpu")
    assert pout.batch.flag.tolist() == jout.batch.flag.tolist()
    assert pout.batch.qname.tolist() == jout.batch.qname.tolist()
    for k in ("LIBID", "UPOS", "DUPSCORE", "QRANK"):
        assert np.asarray(pout.batch.temps[k]).tolist() == \
            np.asarray(jout.batch.temps[k]).tolist()
