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


# the plan's path over the read lengths the package takes: the warp path up
# to 256 bases, then the stripe path with 1 to 46 stripes below the first
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
    """The same batch through the warp path, the stripe path and the plain
    version: bit for bit, each launch counted on its own path."""
    reads, haps, pair_r, pair_h = _case(12, [3, 64, 100, 151, 200, 256],
                                        [1, 80, 250, 600], hap_n_frac=0.01)
    batch = pc.pack_pairs(reads, haps, pair_r, pair_h)
    n0, by0 = _launches()
    warp, plain = _forward_both(batch, cuda, "warp")
    stripe, _ = _forward_both(batch, cuda, "stripe")
    assert pc.LAUNCHES == n0 + 2
    assert pc.LAUNCHES_BY_PATH == {"warp": by0["warp"] + 1, "stripe": by0["stripe"] + 1}
    assert torch.equal(warp, plain)
    assert torch.equal(stripe, plain)


# longest reads of the stripe path: a first stripe of each size class, the
# edges of a stripe, and several stripes below the first
_STRIPE_LONGEST = [257, 288, 300, 450, 512, 513, 769, 1500, 4096]


@pytest.mark.cuda
@pytest.mark.parametrize("longest", _STRIPE_LONGEST)
def test_stripe_kernel_equals_plain(cuda, longest):
    """Ragged long batches (reads of 1 base up to ``longest``, haplotypes of
    1 to 2400 bases, 'N' on both sides) on the plan's stripe path: one
    launch, bit for bit the plain version, on the CPU too up to 700 bases;
    the warp path refuses it."""
    reads, haps, pair_r, pair_h = _case(
        2000 + longest, sorted({1, 40, 256, 257, (longest + 257) // 2, longest}),
        [1, 300, 1100, 2400], n_frac=0.02, hap_n_frac=0.01)
    batch = pc.pack_pairs(reads, haps, pair_r, pair_h)
    assert pc.launch_plan(batch.max_read_len)[0] == "stripe"
    n0, by0 = _launches()
    got, plain = _forward_both(batch, cuda)
    assert pc.LAUNCHES == n0 + 1
    assert pc.LAUNCHES_BY_PATH == {**by0, "stripe": by0["stripe"] + 1}
    assert bool(torch.isfinite(got).all())
    assert torch.equal(got, plain)
    if longest <= 700:
        assert torch.equal(got.cpu(), pc.pairhmm_forward_plain(batch, pc.default_tables("cpu")))


@pytest.mark.cuda
def test_stripe_kernel_mixed_batch(cuda):
    """A pooled-size batch of short reads (100-151 bases) with one in ten
    long (257-300): the stripe path equals the plain version, and every
    short pair's value equals the warp path's on the short pairs alone."""
    rng = np.random.RandomState(41)
    lens = np.where(rng.rand(60) < 0.1, rng.randint(257, 301, 60), rng.randint(100, 152, 60))
    lens[0] = 300
    reads, haps, pair_r, pair_h = _case(41, lens.tolist(), [250, 320, 480, 600])
    batch = pc.pack_pairs(reads, haps, pair_r, pair_h)
    got, plain = _forward_both(batch, cuda)
    assert pc.launch_plan(batch.max_read_len)[0] == "stripe"
    assert torch.equal(got, plain)
    short = np.flatnonzero(lens[pair_r] <= 256)
    warp, _ = _forward_both(pc.pack_pairs(reads, haps, pair_r[short], pair_h[short]),
                            cuda, "warp")
    assert torch.equal(warp, got[torch.as_tensor(short, device=cuda)])


@pytest.mark.cuda
@pytest.mark.parametrize("n_pairs", [1, 2, 3, 5, 7, 9])
def test_stripe_kernel_ragged_grid(cuda, n_pairs):
    """Pair counts that are not a multiple of the warps per CTA, on
    the stripe path: every pair is written, none twice."""
    reads, haps, pair_r, pair_h = _case(300 + n_pairs, [30, 300, 700], [90, 650, 333])
    idx = np.arange(n_pairs) % len(pair_r)
    batch = pc.pack_pairs(reads, haps, pair_r[idx], pair_h[idx])
    got, plain = _forward_both(batch, cuda, "stripe")
    assert torch.equal(got, plain)


@pytest.mark.cuda
def test_stripe_kernel_padding_invariance(cuda):
    """A pair's value is the same alone (on the warp path when its read is
    short, one or two stripes when long) and beside a 1500-base read
    against a 2400-base haplotype (fewer warps per CTA, more stripes)."""
    reads, haps, pair_r, pair_h = _case(9, [5, 151, 256, 257, 300, 600, 1500],
                                        [60, 400, 2400])
    tabs = pc.default_tables(cuda)
    whole = pc.pairhmm_forward(pc.pack_pairs(reads, haps, pair_r, pair_h).to(cuda), tabs)
    for b in range(len(pair_r)):
        one = pc.pack_pairs(reads, haps, pair_r[b : b + 1], pair_h[b : b + 1])
        alone = pc.pairhmm_forward(one.to(cuda), tabs)
        assert alone[0].item() == whole[b].item(), b


@pytest.mark.cuda
def test_stripe_path_rejects_haplotypes_beyond_shared_memory(cuda):
    """A haplotype whose boundary row and bases do not fit one warp's share
    of a block raises before any launch; the library refuses the same
    launch on its own; nothing falls back."""
    reads, haps, pair_r, pair_h = _case(6, [300], [20000])
    batch = pc.pack_pairs(reads, haps, pair_r, pair_h).to(cuda)
    tabs = pc.default_tables(cuda)
    n0, by0 = _launches()
    with pytest.raises(ValueError, match="shared memory"):
        pc.pairhmm_forward(batch, tabs)
    assert _launches() == (n0, by0)
    lib = pc.library()
    f = batch.field
    acc = torch.full((batch.n_pairs,), -1.0, device=cuda)
    err = lib.entry["stripe"](
        *(f(k).data_ptr() for k, _ in pc._FIELDS), tabs.mp.data_ptr(), tabs.nmp.data_ptr(),
        tabs.m2m.data_ptr(), tabs.m2i.data_ptr(), float(pc.I2M), float(pc.I2I),
        acc.data_ptr(), batch.n_pairs, 32, batch.max_hap_len,
        torch.cuda.current_stream(cuda).cuda_stream)
    assert err != 0
    torch.cuda.synchronize()
    assert bool((acc == -1.0).all())  # nothing ran
    # a haplotype that fits runs on fewer warps per CTA
    reads, haps, pair_r, pair_h = _case(6, [300, 700], [6000, 100])
    got, plain = _forward_both(pc.pack_pairs(reads, haps, pair_r, pair_h), cuda)
    assert torch.equal(got, plain)


@pytest.mark.cuda
def test_launch_counts_per_path(cuda):
    """The plan's path takes the launch: warp up to 256 bases, stripe
    above; an empty batch launches nothing."""
    tabs = pc.default_tables(cuda)
    for longest, path in ((256, "warp"), (257, "stripe"), (4096, "stripe")):
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
def test_span_clock_brackets_the_profiler_trace(cuda, tmp_path):
    """20 pairhmm_pairs calls with the span recorder on, under
    torch.profiler: the bracket fit of the pairhmm.device spans to the
    trace's PairHMM kernels (gpubench/spanclock.py) is non-empty and
    narrower than 1 ms."""
    import json
    import os
    import sys

    from torch.profiler import ProfilerActivity, profile

    from elprep_tpu_torch import trace

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))), "gpubench"))
    import spanclock

    reads, haps, pair_r, pair_h = _case(9, [101] * 64, [250, 300, 350, 400])
    pc.pairhmm_pairs(reads, haps, pair_r, pair_h, (cuda,))  # the library and tables
    torch.cuda.synchronize()
    trace.clear()
    trace.enable("clock")
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                pc.pairhmm_pairs(reads, haps, pair_r, pair_h, (cuda,))
    finally:
        trace.disable()
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    kernels = [(float(ev["ts"]), float(ev.get("dur", 0))) for ev in events
               if ev.get("ph") == "X" and ev.get("cat") == "kernel"
               and "pairhmm" in ev.get("name", "")]
    spans = [(s["start"], s["end"], s["attrs"]["launches"])
             for s in trace.snapshot()["spans"] if s["name"] == "pairhmm.device"]
    trace.clear()
    assert len(kernels) == len(spans) == 20
    fit = spanclock.fit(spans, kernels)
    assert fit is not None and 0 <= fit.width_us < 1000, fit
    print("span clock fit: width %.3f us, rate %.9f" % (fit.width_us, fit.rate))


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
# the wrapper's lock, and the HaplotypeCaller worker pool feeding the kernel
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_concurrent_forward_calls_equal_plain(cuda):
    """Two threads call the wrapper at once, as the serial driver, the
    pool's dispatch thread and the mesh loop may in one process: under
    ``_LOCK`` (one library build, one table set per device, the launch
    counts) every result equals the plain version, and LAUNCHES counts
    every launch."""
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
@pytest.mark.parametrize("mode", ["NONE", "GVCF"])
def test_pooled_call_variants_on_cuda_equals_serial(cuda, mode):
    """call_variants with the worker pool (its dispatch thread feeding the
    kernel batches of many regions) == the serial run (batches of 16
    regions), byte for byte, both on the card."""
    from elprep_tpu_torch import device
    from elprep_tpu_torch.hc import driver, parallel
    from elprep_tpu_torch.hc.activity import make_hc_params
    from elprep_tpu_torch.hc.refconf import expand_variants
    from elprep_tpu_torch.io.vcf import format_variant

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
        for info in parallel.get_pool(2).probe_workers():
            assert info["device"] == "cpu" and info["cuda_initialized"] is False
    finally:
        device.set_default_device(old)
    assert out[2] == out[1] and out[1]


@pytest.mark.cuda
def test_pairhmm_sharded_on_two_card_entries_equals_plain(cuda):
    """pairhmm_sharded over the mesh (cuda:0, cuda:0): one launch per
    mesh entry, each on half of the pairs, bit-equal to the plain version
    on the card over all pairs, and to the CPU's plain version after the
    same log10 and rescue."""
    from elprep_tpu_torch.parallel import pairhmm_sharded

    reads, haps, pair_r, pair_h = _case(31, [100, 120, 151, 90, 77, 140, 3], [250, 400, 333])
    n0, by0 = _launches()
    got = pairhmm_sharded((cuda, cuda), reads, haps)
    n1, by1 = _launches()
    assert n1 - n0 == 2 and by1["warp"] - by0["warp"] == 2
    assert pairhmm._MESH[0] is None
    batch = pc.pack_pairs(reads, haps, pair_r, pair_h).to(cuda)
    plain = pc.pairhmm_forward_plain(batch, pc.default_tables(cuda)).cpu().numpy()
    with np.errstate(divide="ignore"):
        want = np.log10(plain.astype(np.float64)) - pc.F32_INITIAL_POW * np.log10(2.0)
    kept = np.isfinite(want) & (want >= pairhmm.F32_RESCUE_LOG10)
    assert kept.sum() >= 5
    np.testing.assert_array_equal(got.reshape(-1)[kept], want[kept])
    np.testing.assert_array_equal(got, pairhmm.pairhmm_f32_batch(reads, haps, device="cpu"))


@pytest.mark.cuda
def test_world_of_one_nccl_all_reduce_of_int64_tables(cuda):
    """The port's collective helpers on NCCL in a world of one: the int64
    table sum keeps values past 2^31, the MAX reduce, the all_gather and
    the plan check run on the card; COLLECTIVES records each."""
    import socket

    import torch.distributed as dist

    from elprep_tpu_torch.parallel import sharded

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=1, rank=0)
    try:
        n0 = len(sharded.COLLECTIVES)
        tables = torch.arange(6 * 94, dtype=torch.int64, device=cuda) + 2**40
        want = tables.clone()
        sharded._all_reduce(tables, "sum")
        assert torch.equal(tables, want)
        mac = torch.tensor([17], dtype=torch.int64, device=cuda)
        sharded._all_reduce(mac, "max")
        assert int(mac) == 17
        sharded._check_replicated(4096, cuda)
        got = sharded._fetch([torch.tensor([1, 0, 1], device=cuda, dtype=torch.bool),
                              torch.tensor([0, 1, 1], device=cuda, dtype=torch.bool)],
                             (cuda, cuda))
        assert got.tolist() == [1, 0, 1, 0, 1, 1]
        assert [op for op, _ in sharded.COLLECTIVES[n0:]] == [
            "all_reduce_sum", "all_reduce_max", "all_reduce_max", "all_gather"]
        assert sharded.COLLECTIVES[n0][1] == 6 * 94 * 8
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# The graft entry points (graft_entry): the fused step as one CUDA graph
# ---------------------------------------------------------------------------


def _step_cols(n_reads, read_len=128, seed=0):
    from elprep_tpu_torch import graft_entry as ge

    cols = ge.fused_step_columns(n_reads, read_len, ref_len=1 << 16)
    if seed:
        # other quals and positions, same shapes
        rng = np.random.RandomState(seed)
        cols[1] = rng.randint(2, 40, cols[1].shape).astype(np.uint8)
        cols[4] = rng.randint(1, (1 << 16) - read_len - 1, cols[4].shape).astype(np.int32)
    return cols


def _equal_outputs(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g.cpu(), w.cpu())


@pytest.mark.cuda
def test_fused_step_graph_equals_eager(cuda):
    from elprep_tpu_torch import graft_entry as ge

    cols = _step_cols(4096)
    dcols = [torch.as_tensor(c).to(cuda) for c in cols]
    step = ge.fused_device_step(device=cuda)
    got = step(*dcols)
    assert len(step.graphs) == 1
    eager = ge.fused_device_step_eager(device=cuda)(*dcols)
    torch.cuda.synchronize()
    assert all(t.device.type == "cuda" for t in got)
    _equal_outputs(got, eager)
    _equal_outputs(got, ge.fused_device_step(device="cpu")(*cols))
    # numpy arguments reach the same graph
    _equal_outputs(step(*cols), eager)
    assert len(step.graphs) == 1


@pytest.mark.cuda
def test_fused_step_calls_keep_their_own_outputs(cuda):
    from elprep_tpu_torch import graft_entry as ge

    a, b = _step_cols(2048), _step_cols(2048, seed=3)
    step = ge.fused_device_step(device=cuda)
    out_a = step(*a)
    out_b = step(*b)
    out_a2 = step(*a)
    torch.cuda.synchronize()
    assert len(step.graphs) == 1
    eager = ge.fused_device_step_eager(device=cuda)
    _equal_outputs(out_a, eager(*a))
    _equal_outputs(out_b, eager(*b))
    _equal_outputs(out_a2, out_a)
    assert not torch.equal(out_a[2], out_b[2])
    ptrs = [t.data_ptr() for t in out_a + out_b + out_a2]
    assert len(set(ptrs)) == len(ptrs)


@pytest.mark.cuda
def test_fused_step_new_shape_new_graph(cuda):
    from elprep_tpu_torch import graft_entry as ge

    step = ge.fused_device_step(device=cuda)
    eager = ge.fused_device_step_eager(device=cuda)
    for n, (reads, read_len) in enumerate([(1024, 128), (3000, 151), (1024, 128)]):
        cols = _step_cols(reads, read_len)
        _equal_outputs(step(*cols), eager(*cols))
        assert len(step.graphs) == min(n + 1, 2)


@pytest.mark.cuda
@pytest.mark.parametrize("read_len", [96, 151])
def test_packed_step_graph_equals_dense(cuda, read_len):
    from elprep_tpu_torch import graft_entry as ge

    cols = _step_cols(4096, read_len)
    dense = ge.fused_device_step(device=cuda)(*cols)
    step = ge.fused_device_step_packed(width=read_len, device=cuda)
    got = step(*ge.pack_step_columns(cols))
    assert len(step.graphs) == 1
    _equal_outputs(got, dense)


@pytest.mark.cuda
def test_capture_failure_raises(cuda, monkeypatch):
    """An op that synchronizes (``.item()``) cannot be captured: the first
    call raises and keeps no graph; nothing runs the step eagerly."""
    from elprep_tpu_torch import graft_entry as ge
    from elprep_tpu_torch.ops import bqsr_ops

    apply = bqsr_ops.apply_bqsr
    calls = []

    def syncing_apply(*a, **k):
        out = apply(*a, **k)
        calls.append(int(out[1].item()))
        return out

    monkeypatch.setattr(bqsr_ops, "apply_bqsr", syncing_apply)
    step = ge.fused_device_step(device=cuda)
    with pytest.raises(RuntimeError):
        step(*_step_cols(512))
    # the warm-up ran it eagerly on the side stream; the capture then failed
    assert len(calls) == ge._GraphedStep.WARMUP
    assert not step.graphs
    # the card is still usable
    assert int(torch.arange(5, device=cuda).sum()) == 10


@pytest.mark.cuda
def test_entry_on_cuda_equals_cpu(cuda):
    from elprep_tpu_torch import graft_entry as ge

    fn, args = ge.entry()
    assert all(a.device.type == "cuda" for a in args)
    assert isinstance(fn, ge._GraphedStep)
    got = fn(*args)
    cfn, cargs = ge.entry("cpu")
    _equal_outputs(got, cfn(*cargs))
    assert ge.sync_scalar(got) == ge.sync_scalar(cfn(*cargs))
