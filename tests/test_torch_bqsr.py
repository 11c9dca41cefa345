"""The port's BQSR (elprep_tpu_torch.ops.bqsr_ops and filters.bqsr, torch
on the CPU) against the JAX package's on the same seeded inputs: the
covariate codes, the tables (dense and packed) and the recalibrated
quals are equal with no tolerance; tables move between the packages
through memory and through ``--bqsr-tables-only`` files; and a cycle
past ``--max-cycle`` raises in both."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from elprep_tpu.filters import add_refid as jadd_refid
from elprep_tpu.filters import bqsr as jfb
from elprep_tpu.filters import bqsr_report as jreport
from elprep_tpu.io.fasta import MappedFasta as JMappedFasta, RefIndex as JRefIndex
from elprep_tpu.io.sam import parse_sam as jparse
from elprep_tpu.ops import bqsr_ops as jops
from elprep_tpu.ops import packed as jpacked
from elprep_tpu_torch import native
from elprep_tpu_torch.filters import add_refid
from elprep_tpu_torch.filters import bqsr as fb
from elprep_tpu_torch.filters import bqsr_report
from elprep_tpu_torch.io import intervals as iv
from elprep_tpu_torch.io import sam as samio
from elprep_tpu_torch.io.fasta import MappedFasta, RefIndex, to_elfasta
from elprep_tpu_torch.ops import bqsr_ops, dispatch, packed
from elprep_tpu_torch.ops.readstats import OP_CLASS
from samgen import make_genome, make_header_lines, reads_from_genome

torch.set_num_threads(1)

CONTIGS = [("chr1", 60000), ("chr2", 40000)]
RGS = [
    {"ID": "grp1", "LB": "libA", "PU": "unit1"},
    {"ID": "grp2", "LB": "libB", "PU": "unit2"},
    {"ID": "grp3", "LB": "libB"},  # no PU -> covariate = ID
]
RG_IDS = ["grp1", "grp2", "grp3"]
MAX_CYCLE = 500
_TABLE_KEYS = ("qs_obs", "qs_mism", "cyc_obs", "cyc_mism", "ctx_obs", "ctx_mism")


def _np(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


def _random_slice(rng, valid_only=False):
    """An adversarial table-build slice: random cigars (under- and
    over-covering seq_len), rg=-1 rows, quals spanning the tail,
    interesting and out-of-table ranges, 'N' and lowercase bases, both
    strands and mate orders, cycle values beyond max_cycle. With
    ``valid_only``: rg >= 0 and cycles inside the table."""
    m = int(rng.randint(1, 60))
    L = int(rng.randint(4, 90))
    C = int(rng.randint(1, 6))
    n_rg = int(rng.randint(1, 4))
    max_cycle = 100 if valid_only else int(rng.randint(8, 200))
    ref_len = int(rng.randint(50, 4000))
    rg = rng.randint(0, n_rg, m) if valid_only else rng.randint(0, n_rg + 1, m) - 1
    sl = dict(
        base=rng.choice(np.frombuffer(b"ACGTNacgt*", np.uint8), (m, L)).astype(np.uint8),
        qual=rng.randint(0, 100, (m, L)).astype(np.uint8),
        seq_len=rng.randint(0, L + 1, m).astype(np.int32),
        flag=rng.randint(0, 256, m).astype(np.int32),
        pos=rng.randint(1, ref_len, m).astype(np.int32),
        rg=rg.astype(np.int32),
        refoff=rng.randint(0, max(1, ref_len - 40), m).astype(np.int64),
        skip=rng.rand(m, L) < 0.2,
        op_class=rng.randint(0, 9, (m, C)).astype(np.int8),
        op_len=rng.randint(0, L, (m, C)).astype(np.int32),
    )
    classes = rng.randint(0, 5, ref_len).astype(np.uint8)
    return sl, classes, max_cycle, n_rg


_ORDER = ("base", "qual", "seq_len", "flag", "pos", "rg", "refoff", "skip",
          "op_class", "op_len")


def _jax_codes(sl, classes, max_cycle, n_rg):
    return [np.asarray(a) for a in jops.recalibrate_codes(
        *(jnp.asarray(sl[k]) for k in _ORDER), jnp.asarray(classes),
        max_cycle=max_cycle, n_rg=n_rg)]


def _host_histograms(codes, max_cycle, n_rg):
    """The JAX package's CPU-route histogram of the codes (negative and
    past-the-end indices dropped)."""
    qs_idx, cyc_idx, ctx_idx, err, _ = codes
    nrg_q = n_rg * 94
    sizes = (nrg_q, nrg_q * (2 * max_cycle + 1), nrg_q * 16)
    errb = err.astype(bool)
    out = []
    for idx, size in zip((qs_idx, cyc_idx, ctx_idx), sizes):
        idx = np.where((idx < 0) | (idx > size), size, idx)
        out.append(np.bincount(idx, minlength=size + 1)[:size])
        out.append(np.bincount(idx[errb], minlength=size + 1)[:size])
    return out


@pytest.mark.parametrize("seed", range(6))
def test_recalibrate_codes_match_jax(seed):
    rng = np.random.RandomState(100 + seed)
    for trial in range(4):
        sl, classes, max_cycle, n_rg = _random_slice(rng)
        want = _jax_codes(sl, classes, max_cycle, n_rg)
        got = bqsr_ops.recalibrate_codes(*(sl[k] for k in _ORDER), classes,
                                         max_cycle=max_cycle, n_rg=n_rg,
                                         device="cpu")
        for g, w in zip(got, want):
            assert _np(g).tolist() == w.tolist(), trial


@pytest.mark.parametrize("seed", range(6))
def test_recalibrate_tables_match_jax(seed):
    """Against the JAX CPU route's histogram of the JAX codes on every
    slice, and against the JAX device program wherever its scatter has
    no out-of-range index to treat (rg >= 0, cycles in the table)."""
    rng = np.random.RandomState(200 + seed)
    for trial in range(4):
        sl, classes, max_cycle, n_rg = _random_slice(rng, valid_only=trial % 2 == 1)
        codes = _jax_codes(sl, classes, max_cycle, n_rg)
        got = bqsr_ops.recalibrate_tables(*(sl[k] for k in _ORDER), classes,
                                          max_cycle=max_cycle, n_rg=n_rg,
                                          device="cpu")
        assert all(t.dtype == torch.int32 for t in got[:6])
        assert int(got[6]) == int(codes[4])
        for g, w in zip(got[:6], _host_histograms(codes, max_cycle, n_rg)):
            assert _np(g).tolist() == w.tolist(), trial
        if trial % 2 == 1 and int(codes[4]) <= max_cycle:
            dev = jops.recalibrate_tables(
                *(jnp.asarray(sl[k]) for k in _ORDER), jnp.asarray(classes),
                max_cycle=max_cycle, n_rg=n_rg)
            for g, w in zip(got, dev):
                assert _np(g).tolist() == np.asarray(w).tolist(), trial


@pytest.mark.parametrize("seed", range(3))
def test_recalibrate_tables_packed_match_jax(seed):
    rng = np.random.RandomState(300 + seed)
    for trial in range(3):
        n = int(rng.randint(4, 80))
        L = int(rng.randint(8, 60))
        n_rg = int(rng.randint(1, 3))
        max_cycle = 100
        base = rng.choice(np.frombuffer(b"ACGTN", np.uint8), (n, L)).astype(np.uint8)
        qual = rng.randint(0, 60, (n, L)).astype(np.uint8)
        seq_len = rng.randint(1, L + 1, n).astype(np.int32)
        flag = np.where(rng.rand(n) < 0.5, 0x63, 0x93).astype(np.int32)
        pos = rng.randint(1, 500 - L - 2, n).astype(np.int32)
        rg = rng.randint(0, n_rg, n).astype(np.int32)
        refoff = np.zeros(n, np.int32)
        skip = rng.rand(n, L) < 0.2
        op_class = np.full((n, 1), OP_CLASS[ord("M")], np.int32)
        op_len = seq_len[:, None].astype(np.int32)
        ref_classes = rng.randint(1, 5, 500).astype(np.uint8)
        bp, lut = packed.pack_nibble_dict(base)
        sk = packed.pack_bits(skip)
        rest = (qual, seq_len, flag, pos, rg, refoff)
        want = jops.recalibrate_tables_packed(
            jnp.asarray(bp), jnp.asarray(lut), *(jnp.asarray(a) for a in rest),
            jnp.asarray(sk), jnp.asarray(op_class), jnp.asarray(op_len),
            jnp.asarray(ref_classes), max_cycle=max_cycle, n_rg=n_rg, width=L)
        got = bqsr_ops.recalibrate_tables_packed(
            bp, lut, *rest, sk, op_class, op_len, ref_classes,
            max_cycle=max_cycle, n_rg=n_rg, width=L, device="cpu")
        dense = bqsr_ops.recalibrate_tables(
            base, *rest, skip, op_class, op_len, ref_classes,
            max_cycle=max_cycle, n_rg=n_rg, device="cpu")
        for g, d, w in zip(got, dense, want):
            assert _np(g).tolist() == np.asarray(w).tolist() == _np(d).tolist()


def _random_apply(rng):
    m = int(rng.randint(1, 50))
    L = int(rng.randint(4, 80))
    n_rg = int(rng.randint(1, 4))
    max_cycle = int(rng.randint(8, 120))
    ncyc = 2 * max_cycle + 1
    return dict(
        base=rng.choice(np.frombuffer(b"ACGTNacgt*", np.uint8), (m, L)).astype(np.uint8),
        qual=rng.randint(0, 100, (m, L)).astype(np.uint8),
        seq_len=rng.randint(0, L + 1, m).astype(np.int32),
        flag=rng.randint(0, 256, m).astype(np.int32),
        rg=(rng.randint(0, n_rg + 1, m) - 1).astype(np.int32),
        rg_present=rng.rand(n_rg) < 0.8,
        cond_prior=rng.randint(1, 90, (n_rg, 94)).astype(np.int32),
        d_cyc=rng.randint(-20, 20, (n_rg, 94, ncyc)).astype(np.int32),
        d_ctx=rng.randint(-20, 20, (n_rg, 94, 17)).astype(np.int32),
        quant=rng.randint(0, 94, 94).astype(np.uint8),
        sqq=rng.randint(0, 94, 255).astype(np.uint8),
    ), max_cycle


@pytest.mark.parametrize("seed", range(6))
def test_apply_bqsr_matches_jax(seed):
    """Random tables, rg=-1 and absent-RG rows, qual tails and values
    past 93, both strands and mate orders, cycles clipped at the table
    edge: every column of the output equal."""
    rng = np.random.RandomState(400 + seed)
    for trial in range(4):
        a, max_cycle = _random_apply(rng)
        args = [a[k] for k in ("base", "qual", "seq_len", "flag", "rg", "rg_present",
                               "cond_prior", "d_cyc", "d_ctx", "quant", "sqq")]
        wq, wmac = jops.apply_bqsr(*(jnp.asarray(x) for x in args), max_cycle=max_cycle)
        gq, gmac = bqsr_ops.apply_bqsr(*args, max_cycle=max_cycle, device="cpu")
        assert gq.dtype == torch.uint8
        assert gq.numpy().tolist() == np.asarray(wq).tolist(), trial
        assert int(gmac) == int(wmac)
        got = native.bqsr_apply_quals(*args, max_cycle)
        if got is not None:
            cols = np.arange(a["base"].shape[1])
            vmask = cols[None, :] < a["seq_len"][:, None]
            assert got[0][vmask].tolist() == gq.numpy()[vmask].tolist()


@pytest.mark.parametrize("seed", range(4))
def test_unpackers_match_jax(seed):
    rng = np.random.RandomState(500 + seed)
    n, L = int(rng.randint(1, 40)), int(rng.randint(1, 70))
    alphabet = np.frombuffer(b"ACGTNacgtn*=RYKM", np.uint8)[: int(rng.randint(1, 17))]
    arr = rng.choice(alphabet, (n, L)).astype(np.uint8)
    bp, lut = packed.pack_nibble_dict(arr)
    jbp, jlut = jpacked.pack_nibble_dict(arr)
    assert bp.tolist() == jbp.tolist() and lut.tolist() == jlut.tolist()
    got = packed.unpack_nibble_dict(torch.from_numpy(bp), torch.from_numpy(lut), L)
    want = np.asarray(jpacked.unpack_nibble_dict(jnp.asarray(bp), jnp.asarray(lut), L))
    assert got.dtype == torch.uint8
    assert got.numpy().tolist() == want.tolist() == arr.tolist()
    mask = rng.rand(n, L) < 0.4
    bits = packed.pack_bits(mask)
    assert bits.tolist() == jpacked.pack_bits(mask).tolist()
    got = packed.unpack_bits(torch.from_numpy(bits), L)
    want = np.asarray(jpacked.unpack_bits(jnp.asarray(bits), L))
    assert got.numpy().tolist() == want.tolist() == mask.tolist()


def test_wide_alphabet_is_not_packed():
    arr = np.arange(17, dtype=np.uint8)[None, :]
    assert packed.pack_nibble_dict(arr) is None


# ---------------------------------------------------------------------------
# the filters on a samgen fixture, both packages
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_bqsr")
    genome = make_genome(CONTIGS, seed=3)
    elf = str(tmp / "ref.elfasta")
    to_elfasta(genome, elf)
    reads = reads_from_genome(900, CONTIGS, genome, seed=5, rg_ids=RG_IDS)
    sam = ("\n".join(make_header_lines(CONTIGS, rgs=RGS) + reads) + "\n").encode()
    known = {"chr1": iv.flatten(iv.sort_by_start(
        iv.make([100, 5000, 20000], [200, 5100, 20500])))}
    sites = str(tmp / "known.elsites")
    iv.to_elsites_file(known, sites)
    return dict(elf=elf, sam=sam, sites=sites, tmp=tmp)


def _jax_side(setup):
    hdr, batch = jparse(setup["sam"])
    jadd_refid(hdr)(batch)
    return hdr, batch, JRefIndex(JMappedFasta(setup["elf"]))


def _port_side(setup):
    hdr, batch = samio.parse_sam(setup["sam"])
    add_refid(hdr)(batch)
    return hdr, batch, RefIndex(MappedFasta(setup["elf"]))


def _force_torch_route(monkeypatch):
    monkeypatch.setattr(dispatch, "routes_to_host", lambda n, device=None: False)


@pytest.mark.parametrize("route", ["host", "torch", "torch_sliced", "torch_dense"])
def test_recalibrate_matches_jax(setup, monkeypatch, route):
    jh, jb, jref = _jax_side(setup)
    want = jfb.BaseRecalibrator([setup["sites"]], jref).recalibrate(jh, jb, MAX_CYCLE)
    ph, pb, pref = _port_side(setup)
    recal = fb.BaseRecalibrator([setup["sites"]], pref)
    if route != "host":
        _force_torch_route(monkeypatch)
    if route == "torch_sliced":
        p = fb.prep_recalibrate_columns(recal, ph, pb, None, MAX_CYCLE)
        assert p["n_real"] > 300
        acc, mac = fb.accumulate_table_partials([p], pref.classes, MAX_CYCLE, 3,
                                                max_rows=128, device="cpu")
        assert mac <= MAX_CYCLE
        for k, a in zip(_TABLE_KEYS, acc):
            assert a.tolist() == getattr(want, k).reshape(-1).tolist(), k
        return
    if route == "torch_dense":
        # bases beyond a 16-symbol alphabet take the dense build
        monkeypatch.setattr(packed, "pack_nibble_dict", lambda a: None)
    got = recal.recalibrate(ph, pb, MAX_CYCLE, device="cpu")
    assert got.rg_names == want.rg_names and got.max_cycle == want.max_cycle
    for k in _TABLE_KEYS:
        assert getattr(got, k).dtype == np.int64
        assert getattr(got, k).tolist() == getattr(want, k).tolist(), k
    assert want.qs_obs.sum() > 10000 and want.cyc_mism.sum() > 0


def test_pooled_recalibrate_matches_serial(setup):
    """On the CPU the worker pool's table build (each worker preps its
    chunk and runs the native build, returning partial tables) gives
    exactly the serial tables, which equal the JAX package's."""
    from elprep_tpu_torch.hc.parallel import get_pool

    genome = make_genome(CONTIGS, seed=3)
    reads = reads_from_genome(5000, CONTIGS, genome, seed=11, rg_ids=RG_IDS)
    sam = ("\n".join(make_header_lines(CONTIGS, rgs=RGS) + reads) + "\n").encode()
    hdr, big = samio.parse_sam(sam)
    add_refid(hdr)(big)
    assert len(big) > 4096  # the pool takes batches above 4096 reads
    recal = fb.BaseRecalibrator([setup["sites"]], RefIndex(MappedFasta(setup["elf"])))
    serial = recal.recalibrate(hdr, big, MAX_CYCLE, device="cpu")
    pool = get_pool(2)
    assert pool is not None
    calls = []
    orig = pool.map_bqsr_tables

    def spy(*a, **k):
        calls.append(1)
        return orig(*a, **k)

    pool.map_bqsr_tables = spy
    try:
        pooled = recal.recalibrate(hdr, big, MAX_CYCLE, pool=pool, device="cpu")
    finally:
        del pool.map_bqsr_tables
    assert calls == [1]
    jh, jb = jparse(sam)
    jadd_refid(jh)(jb)
    want = jfb.BaseRecalibrator([setup["sites"]], JRefIndex(JMappedFasta(setup["elf"]))
                                ).recalibrate(jh, jb, MAX_CYCLE)
    assert pooled.rg_names == serial.rg_names == want.rg_names
    for k in _TABLE_KEYS:
        assert getattr(pooled, k).tolist() == getattr(serial, k).tolist(), k
        assert getattr(serial, k).tolist() == getattr(want, k).tolist(), k
    assert serial.qs_obs.sum() > 100000


def test_host_route_without_native_matches(setup, monkeypatch):
    """Without the native engine the CPU route histograms the torch
    covariate codes: the same tables."""
    jh, jb, jref = _jax_side(setup)
    want = jfb.BaseRecalibrator([setup["sites"]], jref).recalibrate(jh, jb, MAX_CYCLE)
    ph, pb, pref = _port_side(setup)
    recal = fb.BaseRecalibrator([setup["sites"]], pref)
    p = fb.prep_recalibrate_columns(recal, ph, pb, None, MAX_CYCLE)
    monkeypatch.setattr(native, "bqsr_covariate_tables", lambda *a, **k: None)
    acc, _ = fb.accumulate_table_partials([p], pref.classes, MAX_CYCLE, 3, device="cpu")
    for k, a in zip(_TABLE_KEYS, acc):
        assert a.tolist() == getattr(want, k).reshape(-1).tolist(), k


def _to_port_tables(t):
    """The JAX package's tables, field by field as numpy, in the port's
    dataclass."""
    return fb.BaseRecalibratorTables(
        rg_names=list(t.rg_names), max_cycle=t.max_cycle,
        **{k: np.array(getattr(t, k)) for k in _TABLE_KEYS})


@pytest.mark.parametrize("route", ["host", "torch", "torch_sliced"])
@pytest.mark.parametrize("quantize,sqq", [(0, ()), (4, ()), (0, (10, 20, 30))])
def test_tables_carried_across_apply_the_same(setup, monkeypatch, route, quantize, sqq):
    """Tables built by the JAX package, handed to the port's apply filter
    as numpy: the same recalibrated quals as the JAX apply filter."""
    from elprep_tpu.core.pipeline import SamData as JSamData, run_pipeline as jrun
    from elprep_tpu_torch.core.pipeline import SamData, run_pipeline

    jh, jb, jref = _jax_side(setup)
    tables = jfb.BaseRecalibrator([setup["sites"]], jref).recalibrate(jh, jb, MAX_CYCLE)
    tables.finalize()
    want = jrun(JSamData(jh, jb), [jfb.apply_bqsr_filter(tables, quantize, list(sqq),
                                                         MAX_CYCLE)]).batch
    ptables = _to_port_tables(tables)
    ptables.finalize()
    ph, pb, _ = _port_side(setup)
    if route != "host":
        _force_torch_route(monkeypatch)
    if route == "torch_sliced":
        monkeypatch.setattr(fb, "APPLY_ROWS", 100)
    got = run_pipeline(SamData(ph, pb), [fb.apply_bqsr_filter(
        ptables, quantize, list(sqq), MAX_CYCLE, device="cpu")], device="cpu").batch
    assert got.qual.data.tolist() == want.qual.data.tolist()
    assert got.qual.offsets.tolist() == want.qual.offsets.tolist()


def test_tables_only_files_load_across_packages(setup, tmp_path):
    """A --bqsr-tables-only file of each package loads in the other, and
    written again gives the same bytes; the finalized reports agree."""
    jh, jb, jref = _jax_side(setup)
    jt = jfb.BaseRecalibrator([setup["sites"]], jref).recalibrate(jh, jb, MAX_CYCLE)
    ph, pb, pref = _port_side(setup)
    pt = fb.BaseRecalibrator([setup["sites"]], pref).recalibrate(ph, pb, MAX_CYCLE,
                                                                 device="cpu")
    jpath, ppath = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    jreport.save_intermediate(jt, jpath)
    bqsr_report.save_intermediate(pt, ppath)
    with open(jpath, "rb") as a, open(ppath, "rb") as b:
        assert a.read() == b.read()
    into_port = bqsr_report.load_and_combine_bqsr_tables(jpath)
    into_jax = jreport.load_and_combine_bqsr_tables(ppath)
    again_p, again_j = str(tmp_path / "p2.npz"), str(tmp_path / "j2.npz")
    bqsr_report.save_intermediate(into_port, again_p)
    jreport.save_intermediate(into_jax, again_j)
    with open(again_p, "rb") as a, open(again_j, "rb") as b, open(jpath, "rb") as c:
        assert a.read() == b.read() == c.read()
    into_port.finalize()
    into_jax.finalize()
    rp, rj = str(tmp_path / "p.recal"), str(tmp_path / "j.recal")
    bqsr_report.print_bqsr_tables(into_port, rp)
    jreport.print_bqsr_tables(into_jax, rj)
    with open(rp, "rb") as a, open(rj, "rb") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("route", ["host", "torch"])
def test_cycle_past_max_cycle_raises_in_both(setup, monkeypatch, route):
    jh, jb, jref = _jax_side(setup)
    with pytest.raises(ValueError, match="cycle value exceeds"):
        jfb.BaseRecalibrator([setup["sites"]], jref).recalibrate(jh, jb, 50)
    ph, pb, pref = _port_side(setup)
    if route == "torch":
        _force_torch_route(monkeypatch)
    with pytest.raises(ValueError, match="cycle value exceeds"):
        fb.BaseRecalibrator([setup["sites"]], pref).recalibrate(ph, pb, 50, device="cpu")
    from elprep_tpu_torch.core.pipeline import SamData, run_pipeline

    tables = fb.BaseRecalibratorTables.zeros(["unit1", "unit2", "grp3"], 50)
    with pytest.raises(ValueError, match="cycle value exceeds"):
        run_pipeline(SamData(ph, pb), [fb.apply_bqsr_filter(tables, max_cycle=50,
                                                            device="cpu")], device="cpu")
