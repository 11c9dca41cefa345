"""Tests of the port that need an NVIDIA GPU. They skip without one.

This file imports neither jax nor elprep_tpu, so on a machine with the
card and without JAX it runs on its own:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from elprep_tpu_torch import native
from elprep_tpu_torch.ops import bqsr_ops, dedup, packed
from elprep_tpu_torch.ops import pairhmm, pairhmm_cuda as pc

_BASES = np.frombuffer(b"ACGT", np.uint8)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _case(seed, read_lens, hap_lens, n_frac=0.05, hap_n_frac=0.0):
    """Reads cut from random haplotypes with 2% errors and 'N' bases,
    every read against every haplotype."""
    rng = np.random.RandomState(seed)
    haps = [rng.choice(_BASES, lh) for lh in hap_lens]
    if hap_n_frac:
        for h in haps:
            h[rng.rand(len(h)) < hap_n_frac] = ord("N")
    reads = []
    for k, lr in enumerate(read_lens):
        src = haps[k % len(haps)]
        if lr <= len(src):
            st = rng.randint(0, len(src) - lr + 1)
            seq = src[st : st + lr].copy()
        else:
            seq = rng.choice(_BASES, lr)
        seq[rng.rand(lr) < 0.02] = rng.choice(_BASES)
        seq[rng.rand(lr) < n_frac] = ord("N")
        reads.append((seq.tobytes(), rng.randint(2, 45, lr).astype(np.uint8),
                      int(rng.randint(10, 61))))
    haps = [h.tobytes() for h in haps]
    pair_r = np.repeat(np.arange(len(reads)), len(haps))
    pair_h = np.tile(np.arange(len(haps)), len(reads))
    return reads, haps, pair_r, pair_h


# each case reaches another rows-per-thread instantiation of the kernel
_LONGEST = [151, 256, 300, 700, 1500, 3000, 6000, 12000]


@pytest.mark.cuda
@pytest.mark.parametrize("longest", _LONGEST)
def test_kernel_equals_plain(cuda, longest):
    reads, haps, pair_r, pair_h = _case(longest, [1, 2, 33, 100, longest],
                                        [1, 50, 200])
    batch = pc.pack_pairs(reads, haps, pair_r, pair_h)
    n0 = pc.LAUNCHES
    got = pc.pairhmm_forward(batch.to(cuda), pc.default_tables(cuda))
    assert pc.LAUNCHES == n0 + 1
    plain_cuda = pc.pairhmm_forward_plain(batch.to(cuda), pc.default_tables(cuda))
    torch.cuda.synchronize()
    assert torch.equal(got, plain_cuda)
    if longest <= 700:
        # the plain version gives the same bits on the CPU
        plain_cpu = pc.pairhmm_forward_plain(batch, pc.default_tables("cpu"))
        assert torch.equal(got.cpu(), plain_cpu)


# longest reads of the warp path: every rows-per-lane count 1..8 and the
# edges of each
_WARP_LONGEST = [1, 31, 32, 33, 64, 65, 100, 128, 151, 160, 255, 256]


def _launches():
    return pc.LAUNCHES, dict(pc.LAUNCHES_BY_PATH)


def _forward_both(batch, cuda, path=None):
    """The kernel (on ``path``, or the plan's) and the plain version on
    the card."""
    tabs = pc.default_tables(cuda)
    dev_batch = batch.to(cuda)
    got = pc._pairhmm_forward_path(dev_batch, tabs, path)
    plain = pc.pairhmm_forward_plain(dev_batch, tabs)
    torch.cuda.synchronize()
    return got, plain


@pytest.mark.cuda
@pytest.mark.parametrize("longest", _WARP_LONGEST)
def test_warp_kernel_equals_plain(cuda, longest):
    reads, haps, pair_r, pair_h = _case(
        1000 + longest, sorted({1, min(2, longest), (longest + 1) // 2, longest}),
        [1, 50, 200, 420], n_frac=0.05, hap_n_frac=0.02)
    batch = pc.pack_pairs(reads, haps, pair_r, pair_h)
    assert pc.launch_plan(batch.max_read_len)[0] == "warp"
    n0, by0 = _launches()
    got, plain = _forward_both(batch, cuda)
    assert pc.LAUNCHES == n0 + 1
    assert pc.LAUNCHES_BY_PATH == {**by0, "warp": by0["warp"] + 1}
    assert torch.equal(got, plain)
    plain_cpu = pc.pairhmm_forward_plain(batch, pc.default_tables("cpu"))
    assert torch.equal(got.cpu(), plain_cpu)


@pytest.mark.cuda
@pytest.mark.parametrize("n_pairs", [1, 2, 3, 5, 7, 9, 31, 33])
def test_warp_kernel_ragged_grid(cuda, n_pairs):
    """Pair counts that are not a multiple of the warps per CTA: every
    pair is written, none twice."""
    reads, haps, pair_r, pair_h = _case(n_pairs, [30, 77, 151], [90, 260, 333])
    idx = np.arange(n_pairs) % len(pair_r)
    batch = pc.pack_pairs(reads, haps, pair_r[idx], pair_h[idx])
    assert batch.n_pairs == n_pairs
    got, plain = _forward_both(batch, cuda, "warp")
    assert torch.equal(got, plain)


@pytest.mark.cuda
def test_warp_kernel_n_bases(cuda):
    """'N' on both sides, many of them, and reads of nothing but 'N'."""
    reads, haps, pair_r, pair_h = _case(77, [1, 40, 99, 200], [10, 120, 301],
                                        n_frac=0.3, hap_n_frac=0.2)
    reads.append((b"N" * 60, np.full(60, 30, np.uint8), 60))
    haps.append(b"N" * 80)
    n_r, n_h = len(reads), len(haps)
    pair_r = np.repeat(np.arange(n_r), n_h)
    pair_h = np.tile(np.arange(n_h), n_r)
    got, plain = _forward_both(pc.pack_pairs(reads, haps, pair_r, pair_h), cuda, "warp")
    assert bool(torch.isfinite(got).all())
    assert torch.equal(got, plain)


@pytest.mark.cuda
def test_warp_kernel_padding_invariance(cuda):
    """A pair's value is the same alone (few rows per lane) and beside a
    256-base read (8 rows per lane)."""
    reads, haps, pair_r, pair_h = _case(8, [5, 40, 100, 151, 256], [60, 300])
    tabs = pc.default_tables(cuda)
    whole = pc.pairhmm_forward(pc.pack_pairs(reads, haps, pair_r, pair_h).to(cuda), tabs)
    for b in range(len(pair_r)):
        one = pc.pack_pairs(reads, haps, pair_r[b : b + 1], pair_h[b : b + 1])
        assert pc.launch_plan(one.max_read_len)[0] == "warp"
        alone = pc.pairhmm_forward(one.to(cuda), tabs)
        assert alone[0].item() == whole[b].item(), b


@pytest.mark.cuda
def test_forced_paths_agree(cuda):
    """The same batch through the warp path, the CTA path and the plain
    version: bit for bit, each launch counted on its own path."""
    reads, haps, pair_r, pair_h = _case(12, [3, 64, 100, 151, 200, 256],
                                        [1, 80, 250, 600], hap_n_frac=0.01)
    batch = pc.pack_pairs(reads, haps, pair_r, pair_h)
    n0, by0 = _launches()
    warp, plain = _forward_both(batch, cuda, "warp")
    cta, _ = _forward_both(batch, cuda, "cta")
    assert pc.LAUNCHES == n0 + 2
    assert pc.LAUNCHES_BY_PATH == {"warp": by0["warp"] + 1, "cta": by0["cta"] + 1}
    assert torch.equal(warp, plain)
    assert torch.equal(cta, plain)


@pytest.mark.cuda
def test_launch_counts_per_path(cuda):
    """The plan's path takes the launch: warp up to 256 bases, CTA above;
    an empty batch launches nothing."""
    tabs = pc.default_tables(cuda)
    for longest, path in ((256, "warp"), (257, "cta")):
        reads, haps, pair_r, pair_h = _case(longest, [10, longest], [100])
        batch = pc.pack_pairs(reads, haps, pair_r, pair_h).to(cuda)
        n0, by0 = _launches()
        pc.pairhmm_forward(batch, tabs)
        assert pc.LAUNCHES == n0 + 1
        assert pc.LAUNCHES_BY_PATH == {**by0, path: by0[path] + 1}
    empty = pc.pack_pairs([], [], [], []).to(cuda)
    n0, by0 = _launches()
    assert pc.pairhmm_forward(empty, tabs).numel() == 0
    assert _launches() == (n0, by0)


@pytest.mark.cuda
def test_warp_path_rejects_long_reads(cuda):
    reads, haps, pair_r, pair_h = _case(5, [257], [300])
    batch = pc.pack_pairs(reads, haps, pair_r, pair_h).to(cuda)
    with pytest.raises(ValueError):
        pc._pairhmm_forward_path(batch, pc.default_tables(cuda), "warp")


@pytest.mark.cuda
def test_logl_pairs_on_cuda_matches_f64(cuda):
    reads, haps, pair_r, pair_h = _case(3, [40, 90, 151], [120, 200])
    got = pairhmm.pairhmm_logl_pairs(reads, haps, pair_r, pair_h, device=cuda)
    want = [pairhmm.pairhmm_f64_diag(*reads[r], haps[h]) for r, h in zip(pair_r, pair_h)]
    assert np.all(np.abs(got - np.asarray(want)) < 5e-4)


@pytest.mark.cuda
def test_wrapper_rejects_mixed_devices(cuda):
    reads, haps, pair_r, pair_h = _case(4, [20], [30])
    batch = pc.pack_pairs(reads, haps, pair_r, pair_h).to(cuda)
    with pytest.raises(ValueError):
        pc.pairhmm_forward(batch, pc.default_tables("cpu"))


# ---------------------------------------------------------------------------
# duplicate marking and BQSR on the card against their host twins
# ---------------------------------------------------------------------------

_FLAGS = np.array([0x0, 0x10, 0x1, 0x1 | 0x10, 0x1 | 0x8, 0x1 | 0x20,
                   0x1 | 0x10 | 0x80, 0x4, 0x1 | 0x4, 0x100, 0x1 | 0x100,
                   0x800, 0x1 | 0x800, 0x1 | 0x40], np.int32)


def _dedup_cols(n, seed):
    """Dense collisions: few positions, libid and refid -1, tied scores,
    qnames shared by 1-3 reads, every flag class."""
    rng = np.random.RandomState(seed)
    return (rng.randint(-1, 2, n).astype(np.int32),
            rng.randint(-1, 2, n).astype(np.int32),
            rng.randint(-2, 2 + n // 100, n).astype(np.int32),
            rng.randint(0, 2, n).astype(np.int32),
            (rng.randint(0, 4, n) * 30).astype(np.int32),
            rng.randint(0, max(1, n // 2), n).astype(np.int32),
            rng.choice(_FLAGS, n).astype(np.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 2, 7, 1000, 40000])
def test_dup_mask_on_cuda_equals_host_twin(cuda, n):
    cols = _dedup_cols(n, n)
    got = dedup.mark_duplicates(*cols, device=cuda)
    assert got.device.type == "cuda" and got.shape == (n,)
    want = dedup.mark_duplicates_host(*cols)
    assert got.cpu().numpy().tolist() == want.tolist()
    if n >= 1000:
        assert want.any()


def _table_slice(rng, m, ragged=True):
    L = int(rng.randint(4, 160))
    C = int(rng.randint(1, 6))
    n_rg = int(rng.randint(1, 4))
    ref_len = int(rng.randint(200, 4000))
    return dict(
        m=m,
        base=rng.choice(np.frombuffer(b"ACGTNacgt*", np.uint8), (m, L)).astype(np.uint8),
        qual=rng.randint(0, 100, (m, L)).astype(np.uint8),
        skip=rng.rand(m, L) < 0.2,
        seq_len=(rng.randint(0, L + 1, m) if ragged else np.full(m, L)).astype(np.int32),
        flag=rng.randint(0, 256, m).astype(np.int32),
        pos=rng.randint(1, ref_len, m).astype(np.int32),
        rg=(rng.randint(0, n_rg + 1, m) - 1).astype(np.int32),
        refoff=rng.randint(0, max(1, ref_len - 40), m).astype(np.int64),
        op_class=rng.randint(0, 9, (m, C)).astype(np.int8),
        op_len=rng.randint(0, L, (m, C)).astype(np.int32),
    ), rng.randint(0, 5, ref_len).astype(np.uint8), n_rg


_ORDER = ("base", "qual", "seq_len", "flag", "pos", "rg", "refoff", "skip",
          "op_class", "op_len")


@pytest.mark.cuda
@pytest.mark.parametrize("m,ragged", [(1, False), (1, True), (57, True), (4096, True),
                                      (3000, False)])
def test_tables_on_cuda_equal_native(cuda, m, ragged):
    """Dense and packed table builds on the card against the fused native
    engine: adversarial cigars, rg = -1 rows, out-of-table quals,
    cycles past max_cycle."""
    rng = np.random.RandomState(m * 2 + ragged)
    for max_cycle in (200, 40):
        sl, classes, n_rg = _table_slice(rng, m, ragged)
        want = native.bqsr_covariate_tables(sl, classes, max_cycle, n_rg)
        assert want is not None, "native lib unavailable"
        got = bqsr_ops.recalibrate_tables(*(sl[k] for k in _ORDER), classes,
                                          max_cycle=max_cycle, n_rg=n_rg, device=cuda)
        assert all(t.device.type == "cuda" for t in got)
        assert int(got[6]) == want[1]
        for g, w in zip(got[:6], want[0]):
            assert g.cpu().numpy().tolist() == w.tolist()
        if sl["base"].size and packed.pack_nibble_dict(sl["base"]) is not None:
            bp, lut = packed.pack_nibble_dict(sl["base"])
            pk = bqsr_ops.recalibrate_tables_packed(
                bp, lut, *(sl[k] for k in _ORDER[1:7]), packed.pack_bits(sl["skip"]),
                sl["op_class"], sl["op_len"], classes, max_cycle=max_cycle,
                n_rg=n_rg, width=sl["base"].shape[1], device=cuda)
            for g, w in zip(pk, got):
                assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("m,ragged", [(1, False), (1, True), (49, True), (5000, True)])
def test_apply_on_cuda_equals_native(cuda, m, ragged):
    rng = np.random.RandomState(77 + m)
    L = int(rng.randint(4, 160))
    n_rg = int(rng.randint(1, 4))
    max_cycle = int(rng.randint(8, 200))
    ncyc = 2 * max_cycle + 1
    args = (
        rng.choice(np.frombuffer(b"ACGTNacgt*", np.uint8), (m, L)).astype(np.uint8),
        rng.randint(0, 100, (m, L)).astype(np.uint8),
        (rng.randint(0, L + 1, m) if ragged else np.full(m, L)).astype(np.int32),
        rng.randint(0, 256, m).astype(np.int32),
        (rng.randint(0, n_rg + 1, m) - 1).astype(np.int32),
        rng.rand(n_rg) < 0.8,
        rng.randint(1, 90, (n_rg, 94)).astype(np.int32),
        rng.randint(-20, 20, (n_rg, 94, ncyc)).astype(np.int32),
        rng.randint(-20, 20, (n_rg, 94, 17)).astype(np.int32),
        rng.randint(0, 94, 94).astype(np.uint8),
        rng.randint(0, 94, 255).astype(np.uint8),
    )
    want = native.bqsr_apply_quals(*args, max_cycle)
    assert want is not None, "native lib unavailable"
    newq, mac = bqsr_ops.apply_bqsr(*args, max_cycle=max_cycle, device=cuda)
    assert newq.device.type == "cuda" and newq.dtype == torch.uint8
    assert int(mac) == want[1]
    valid = np.arange(L)[None, :] < args[2][:, None]
    assert newq.cpu().numpy()[valid].tolist() == want[0][valid].tolist()


@pytest.mark.cuda
def test_filters_on_cuda_equal_cpu_route(cuda, tmp_path):
    """Duplicate marking, the table build and the apply through the
    port's filters on the card and on its CPU route: the same flags,
    tables and quals."""
    import samgen
    from elprep_tpu_torch.core.pipeline import SamData, run_pipeline
    from elprep_tpu_torch.filters import add_refid, mark_duplicates_filter
    from elprep_tpu_torch.filters import bqsr as fb
    from elprep_tpu_torch.io import sam as samio
    from elprep_tpu_torch.io.fasta import MappedFasta, RefIndex, to_elfasta

    contigs = [("chr1", 60000), ("chr2", 40000)]
    genome = samgen.make_genome(contigs, seed=3)
    elf = str(tmp_path / "ref.elfasta")
    to_elfasta(genome, elf)
    header = samgen.make_header_lines(contigs, rgs=[
        {"ID": "g1", "LB": "lA", "PU": "u1"}, {"ID": "g2", "LB": "lB"}])
    lines = samgen.reads_from_genome(4000, contigs, genome, seed=5, rg_ids=["g1", "g2"])
    sam = ("\n".join(header + lines + lines[:600]) + "\n").encode()
    outs = {}
    for dev in ("cpu", cuda):
        hdr, batch = samio.parse_sam(sam)
        data = run_pipeline(SamData(hdr, batch),
                            [add_refid, mark_duplicates_filter(device=dev)], device=dev)
        ref = RefIndex(MappedFasta(elf))
        tables = fb.BaseRecalibrator([], ref).recalibrate(data.header, data.batch, 500,
                                                          device=dev)
        tables.finalize()
        data = run_pipeline(data, [fb.apply_bqsr_filter(tables, device=dev)], device=dev)
        outs[str(dev)] = (data.batch.flag.copy(), tables, data.batch.qual.data.copy())
    (f0, t0, q0), (f1, t1, q1) = outs["cpu"], outs[str(cuda)]
    assert ((f0 & 0x400) != 0).sum() >= 600
    assert f1.tolist() == f0.tolist()
    for k in ("qs_obs", "qs_mism", "cyc_obs", "cyc_mism", "ctx_obs", "ctx_mism"):
        assert getattr(t1, k).tolist() == getattr(t0, k).tolist(), k
    assert q1.tolist() == q0.tolist()


# ---------------------------------------------------------------------------
# the HaplotypeCaller worker pool feeding the kernel from two threads
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_concurrent_forward_calls_equal_plain(cuda):
    """Two threads call the wrapper at once, as the pool's dispatch
    threads do with ELPREP_TPU_PAIRHMM_DISPATCH_WORKERS=2: every result
    equals the plain version, and LAUNCHES counts every launch."""
    import threading

    batches = []
    for seed in range(8):
        reads, haps, pair_r, pair_h = _case(200 + seed, [100, 120, 151, 90], [250, 400, 333])
        batches.append(pc.pack_pairs(reads, haps, pair_r, pair_h).to(cuda))
    tabs = pc.default_tables(cuda)
    want = [pc.pairhmm_forward_plain(b, tabs) for b in batches]
    n0, by0 = _launches()
    rounds = 25
    got = {}
    errors = []

    def work(k):
        try:
            for r in range(rounds):
                i = (k * 4 + r) % len(batches)
                got[(k, r)] = (i, pc.pairhmm_forward(batches[i], tabs).cpu())
        except BaseException as e:  # surfaced below
            errors.append(e)

    threads = [threading.Thread(target=work, args=(k,)) for k in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
        assert not t.is_alive()
    assert not errors, errors
    assert len(got) == 2 * rounds
    for i, acc in got.values():
        assert torch.equal(acc, want[i].cpu())
    n1, by1 = _launches()
    assert n1 - n0 == 2 * rounds
    assert by1["warp"] - by0["warp"] == 2 * rounds


def _pool_fixture():
    """A 200 bp deletion crossing region boundaries, a SNP inside it on
    the other haplotype and a second SNP cluster (tests/test_hc_driver.py's
    pooled-vs-serial fixture)."""
    from elprep_tpu_torch.core.header import Header
    from elprep_tpu_torch.filters.clipping import ClipRead

    rng = np.random.RandomState(17)
    ref = rng.choice(_BASES, 6000).tobytes()
    hap_del = ref[:2000] + ref[2200:]
    hap_snp = ref[:2104] + (b"A" if ref[2104:2105] != b"A" else b"C") + ref[2105:]
    hap_b = ref[:4000] + (b"G" if ref[4000:4001] != b"G" else b"T") + ref[4001:]
    reads = []
    for i in range(120):
        hap = (hap_del, hap_snp, hap_b)[i % 3]
        start = (1800 + (i * 13) % 500) if i % 3 != 2 else (3850 + (i * 11) % 250)
        seq = hap[start : start + 120]
        reads.append(ClipRead(
            flag=0x63 if i % 2 == 0 else 0x93, pos=start + 1, pnext=start + 151,
            tlen=300 if i % 2 == 0 else -300, mapq=60, cigar=[(len(seq), "M")],
            seq=seq, qual=bytes([35]) * len(seq), rname=b"chr1", rnext=b"=",
            qname=b"pp%04d" % i))
    reads.sort(key=lambda r: r.pos)
    hdr = Header()
    hdr.sq = [{"SN": "chr1", "LN": str(len(ref))}]
    return ref, reads, hdr


@pytest.mark.cuda
@pytest.mark.parametrize("dispatch", [None, "2"])
@pytest.mark.parametrize("mode", ["NONE", "GVCF"])
def test_pooled_call_variants_on_cuda_equals_serial(cuda, monkeypatch, mode, dispatch):
    """call_variants with the worker pool (the dispatcher feeding the
    kernel batches of many regions, from its default one thread or from
    two) == the serial run (batches of 16 regions), byte for byte, both
    on the card."""
    from elprep_tpu_torch import device
    from elprep_tpu_torch.hc import driver, parallel
    from elprep_tpu_torch.hc.activity import make_hc_params
    from elprep_tpu_torch.hc.refconf import expand_variants
    from elprep_tpu_torch.io.vcf import format_variant

    if dispatch:
        monkeypatch.setenv("ELPREP_TPU_PAIRHMM_DISPATCH_WORKERS", dispatch)
    else:
        monkeypatch.delenv("ELPREP_TPU_PAIRHMM_DISPATCH_WORKERS", raising=False)
    ref, reads, hdr = _pool_fixture()
    old = device.resolve()
    device.set_default_device(cuda)
    try:
        out = {}
        for nw in (1, 2):
            n0 = pc.LAUNCHES
            _, v = driver.call_variants(
                make_hc_params(mode, command_line="t"), hdr, {"chr1": list(reads)},
                lambda c: ref, sample_name="s1", use_device_pairhmm=True,
                nr_workers=nw)
            assert pc.LAUNCHES > n0
            out[nw] = [format_variant(x) for x in expand_variants(v)]
        assert parallel.get_pool(2) is not None
        assert parallel._dispatch_tuning()[2] == int(dispatch or 1)
        for info in parallel.get_pool(2).probe_workers():
            assert info["device"] == "cpu" and info["cuda_initialized"] is False
    finally:
        device.set_default_device(old)
    assert out[2] == out[1] and out[1]
