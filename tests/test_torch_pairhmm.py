"""The port's PairHMM (elprep_tpu_torch/ops/pairhmm.py, pairhmm_cuda.py)
held against the JAX package: the f64 oracle, the Pallas kernel in
interpret mode and the lax.scan formulation, on the mixed-length,
N-heavy cases of tests/test_pairhmm.py. Inputs come from numpy seeds.

Tolerances: 5e-4 log10 against the f64 oracle (the bound
tests/test_pairhmm.py holds the Pallas kernel to); 1e-5 log10 against the
JAX f32 paths, which round the same recurrence in another order (the
Pallas kernel sums (I2+D2)*i2m) or under XLA's CPU codegen.
"""

import os

import numpy as np
import pytest
import torch

from elprep_tpu.ops import pairhmm as jax_pairhmm
from elprep_tpu.ops import pairhmm_pallas as jax_pallas
from elprep_tpu_torch.ops import pairhmm
from elprep_tpu_torch.ops import pairhmm_cuda as pc

torch.set_num_threads(1)

_BASES = np.frombuffer(b"ACGT", np.uint8)


def _mixed_case(seed=9):
    """Mixed read/hap lengths with 'N' on both sides
    (tests/test_pairhmm.py:107-129), every read against every hap."""
    rng = np.random.RandomState(seed)
    reads = []
    for lr in (17, 33, 48):
        seq = rng.choice(_BASES, lr).tobytes()
        qual = rng.randint(2, 42, lr).astype(np.uint8)
        reads.append((seq, qual, 60))
    haps = [rng.choice(_BASES, lh).tobytes() for lh in (40, 67, 129)]
    reads[1] = (reads[1][0][:5] + b"N" + reads[1][0][6:], reads[1][1], 60)
    haps[0] = haps[0][:10] + b"NN" + haps[0][12:]
    pair_r = np.repeat(np.arange(len(reads)), len(haps))
    pair_h = np.tile(np.arange(len(haps)), len(reads))
    return reads, haps, pair_r, pair_h


def _n_heavy_case(seed=21, n_reads=6, n_haps=4):
    """Reads cut from the haplotypes with errors and many 'N' bases, MAPQ
    below some quals (modified qualities), lengths 1..90."""
    rng = np.random.RandomState(seed)
    haps = []
    for _ in range(n_haps):
        h = rng.choice(_BASES, rng.randint(60, 140))
        h[rng.rand(len(h)) < 0.1] = ord("N")
        haps.append(h.tobytes())
    reads = []
    for k in range(n_reads):
        src = np.frombuffer(haps[k % n_haps], np.uint8)
        lr = [1, 2, 31, 32, 33, 90][k % 6]
        st = rng.randint(0, len(src) - lr + 1)
        seq = src[st : st + lr].copy()
        seq[rng.rand(lr) < 0.2] = ord("N")
        seq[rng.rand(lr) < 0.05] = rng.choice(_BASES)
        reads.append((seq.tobytes(), rng.randint(0, 45, lr).astype(np.uint8),
                      int(rng.randint(10, 61))))
    pair_r = np.repeat(np.arange(n_reads), n_haps)
    pair_h = np.tile(np.arange(n_haps), n_reads)
    return reads, haps, pair_r, pair_h


def _long_case(seed=31):
    """Reads of 257, 300 and 600 bases cut from one of two haplotypes of
    620-700 bases (the second has two SNPs and a 3-base deletion), with a
    few errors and 'N' bases, every read against both: the stripe path's
    reads, all kept from f32 (none rescued in f64)."""
    rng = np.random.RandomState(seed)
    h0 = rng.choice(_BASES, rng.randint(620, 700))
    h1 = np.delete(h0.copy(), range(200, 203))
    for p in (90, 410):
        h1[p] = _BASES[(list(_BASES).index(h1[p]) + 1) % 4]
    haps = [h0.tobytes(), h1.tobytes()]
    reads = []
    for k, lr in enumerate([257, 300, 600]):
        src = np.frombuffer(haps[k % 2], np.uint8)
        st = rng.randint(0, len(src) - lr + 1)
        seq = src[st : st + lr].copy()
        seq[rng.choice(lr, 2, replace=False)] = ord("N")
        seq[rng.randint(lr)] = rng.choice(_BASES)
        reads.append((seq.tobytes(), rng.randint(20, 41, lr).astype(np.uint8), 60))
    pair_r = np.repeat(np.arange(len(reads)), len(haps))
    pair_h = np.tile(np.arange(len(haps)), len(reads))
    return reads, haps, pair_r, pair_h


_CASES = {"mixed": _mixed_case, "n_heavy": _n_heavy_case}


def _f64(reads, haps, pair_r, pair_h):
    return np.array([jax_pairhmm.pairhmm_f64_diag(
        reads[r][0], reads[r][1], reads[r][2], haps[h])
        for r, h in zip(pair_r, pair_h)])


def _plain_log10(reads, haps, pair_r, pair_h):
    batch = pc.pack_pairs(reads, haps, pair_r, pair_h)
    acc = pc.pairhmm_forward_plain(batch, pc.default_tables("cpu")).numpy()
    return np.log10(acc.astype(np.float64)) - pc.F32_INITIAL_POW * np.log10(2.0)


@pytest.mark.parametrize("case", sorted(_CASES))
def test_plain_matches_f64_oracle(case):
    reads, haps, pair_r, pair_h = _CASES[case]()
    got = _plain_log10(reads, haps, pair_r, pair_h)
    want = _f64(reads, haps, pair_r, pair_h)
    assert np.all(np.isfinite(got))
    assert np.all(np.abs(got - want) < 5e-4), np.abs(got - want).max()


@pytest.mark.parametrize("case", sorted(_CASES))
def test_logl_pairs_matches_f64_oracle(case):
    """The pipeline entry (with its f64 rescue) on the CPU."""
    reads, haps, pair_r, pair_h = _CASES[case]()
    got = pairhmm.pairhmm_logl_pairs(reads, haps, pair_r, pair_h, device="cpu")
    want = _f64(reads, haps, pair_r, pair_h)
    assert np.all(np.abs(got - want) < 5e-4), np.abs(got - want).max()


@pytest.mark.parametrize("case", sorted(_CASES))
def test_logl_pairs_matches_jax_scan(case):
    reads, haps, pair_r, pair_h = _CASES[case]()
    got = pairhmm.pairhmm_logl_pairs(reads, haps, pair_r, pair_h, device="cpu")
    want = jax_pairhmm._pairhmm_logl_pairs_scan(reads, haps, pair_r, pair_h)
    assert np.all(np.abs(got - want) < 1e-5), np.abs(got - want).max()


def test_logl_pairs_matches_jax_pallas_interpret():
    reads, haps, pair_r, pair_h = _mixed_case()
    got = pairhmm.pairhmm_logl_pairs(reads, haps, pair_r, pair_h, device="cpu")
    want = jax_pallas.pairhmm_pallas_pairs(reads, haps, pair_r, pair_h)
    assert np.all(np.abs(got - want) < 1e-5), np.abs(got - want).max()


def _rescue_case(seed=4):
    """Reads at Q40 cut from one haplotype with 0, 6, 8 and 40 mismatches:
    log10 about -2, -28 and -33 in f32 and, for the last, an f32 underflow
    to 0."""
    rng = np.random.RandomState(seed)
    hap = rng.choice(_BASES, 120)
    reads = []
    for lr, n_mismatch in ((60, 0), (40, 6), (40, 8), (80, 40)):
        seq = hap[10 : 10 + lr].copy()
        pos = rng.choice(lr, n_mismatch, replace=False)
        seq[pos] = _BASES[(np.searchsorted(_BASES, seq[pos]) + 1) % 4]
        reads.append((seq.tobytes(), np.full(lr, 40, np.uint8), 60))
    return reads, [hap.tobytes()], np.arange(len(reads)), np.zeros(len(reads), np.int64)


@pytest.mark.parametrize("where", ["cpu", ("cpu", "cpu")], ids=["one", "mesh2"])
def test_logl_pairs_rescues_low_pairs_in_f64(monkeypatch, where):
    """A pair whose f32 log10 falls below F32_RESCUE_LOG10, or underflows,
    takes the JAX f64 oracle's value; every other pair keeps its f32 value.
    The whole result within 1e-5 of the JAX scan and Pallas paths, which
    rescue the same pairs. On one CPU device and split over a CPU mesh of
    two, one chunk each."""
    reads, haps, pair_r, pair_h = _rescue_case()
    with np.errstate(divide="ignore"):
        f32 = _plain_log10(reads, haps, pair_r, pair_h)
    rescued = ~np.isfinite(f32) | (f32 < pairhmm.F32_RESCUE_LOG10)
    assert rescued.tolist() == [False, True, True, True]
    assert not np.isfinite(f32[3])
    exact = _f64(reads, haps, pair_r, pair_h)
    assert np.all(f32 != exact)
    chunks = []
    orig = pc.pack_pairs
    monkeypatch.setattr(pc, "pack_pairs", lambda r, h, pr, ph: (
        chunks.append(len(pr)), orig(r, h, pr, ph))[1])
    got = pairhmm.pairhmm_logl_pairs(reads, haps, pair_r, pair_h, device=where)
    assert chunks == ([4] if where == "cpu" else [2, 2])
    np.testing.assert_array_equal(got, np.where(rescued, exact, f32))
    for jax_pairs in (jax_pairhmm._pairhmm_logl_pairs_scan,
                      jax_pallas.pairhmm_pallas_pairs):
        want = jax_pairs(reads, haps, pair_r, pair_h)
        assert np.all(np.abs(got - want) < 1e-5), (jax_pairs, np.abs(got - want).max())


@pytest.mark.parametrize("jax_path", ["scan", "pallas_interpret"])
def test_long_reads_plain_matches_jax(jax_path):
    """Reads of 257-600 bases (the stripe path's): the plain version, the
    kernels' reference on the CPU, against JAX's lax.scan
    (``_pairhmm_f32_scan``) and the Pallas kernel in interpret mode, within
    1e-5 log10 as for short reads, and within 5e-4 of the f64 oracle. No
    pair here is rescued in f64, so the f32 values themselves are held."""
    reads, haps, pair_r, pair_h = _long_case()
    got = _plain_log10(reads, haps, pair_r, pair_h)
    assert np.all(got >= pairhmm.F32_RESCUE_LOG10)
    want = (jax_pairhmm._pairhmm_logl_pairs_scan if jax_path == "scan"
            else jax_pallas.pairhmm_pallas_pairs)(reads, haps, pair_r, pair_h)
    assert np.all(np.abs(got - want) < 1e-5), np.abs(got - want).max()
    exact = _f64(reads, haps, pair_r, pair_h)
    assert np.all(np.abs(got - exact) < 5e-4), np.abs(got - exact).max()


@pytest.mark.parametrize("case", sorted(_CASES))
def test_padding_invariance(case):
    """A pair alone and inside a batch (with longer reads and haps beside
    it) gives the same f32 value bit for bit."""
    reads, haps, pair_r, pair_h = _CASES[case]()
    tabs = pc.default_tables("cpu")
    whole = pc.pairhmm_forward(pc.pack_pairs(reads, haps, pair_r, pair_h), tabs)
    for b in range(len(pair_r)):
        one = pc.pairhmm_forward(
            pc.pack_pairs(reads, haps, pair_r[b : b + 1], pair_h[b : b + 1]), tabs)
        assert one[0].item() == whole[b].item(), b
    # reversed batch order
    rev = pc.pairhmm_forward(pc.pack_pairs(reads, haps, pair_r[::-1], pair_h[::-1]),
                             tabs)
    assert torch.equal(rev.flip(0), whole)


def test_compute_read_likelihoods_multi_equals_per_region():
    reads, haps, _, _ = _mixed_case()
    wl = [(reads[:2], haps[:2], [True, False]), (reads[2:], haps, [True, False, False])]
    multi = pairhmm.compute_read_likelihoods_multi(wl, device="cpu")
    for (r, h, ref), (vals, keep) in zip(wl, multi):
        v1, k1 = pairhmm.compute_read_likelihoods(r, h, ref, device="cpu")
        assert np.array_equal(v1, vals) and np.array_equal(k1, keep)
    want = jax_pairhmm.compute_read_likelihoods_multi(wl)
    for (v, k), (vj, kj) in zip(multi, want):
        assert np.array_equal(k, kj)
        assert np.allclose(v, vj, rtol=0, atol=1e-5)


def test_tables_bit_equal_to_jax():
    """tables_from_numpy on the JAX package's f32 tables gives the port's
    own tables bit for bit."""
    got = pc.tables_from_numpy(jax_pallas._MP_TABLE, jax_pallas._NMP_TABLE,
                               jax_pallas._M2M_TABLE, jax_pallas._M2I_TABLE)
    own = pc.default_tables("cpu")
    for name in ("mp", "nmp", "m2m", "m2i"):
        a, b = getattr(got, name), getattr(own, name)
        assert a.dtype == torch.float32 and torch.equal(a, b), name
        assert getattr(own, name)[-1].item() == 0.0  # sentinel entry
    assert own.mp.shape[0] - 1 == jax_pallas._Q_SENT
    assert own.m2m.shape[0] - 1 == jax_pallas._R_SENT


def test_pack_pairs_layout():
    reads, haps, pair_r, pair_h = _mixed_case()
    # only the reads and haps that pairs use are packed, each once
    batch = pc.pack_pairs(reads, haps, pair_r[3:5], pair_h[3:5])
    assert batch.n_pairs == 2
    assert batch.field("read_lengths").tolist() == [33]
    assert batch.field("hap_lengths").tolist() == [40, 67]
    assert bytes(batch.field("read_bases").numpy()) == reads[1][0]
    assert batch.field("pair_read").tolist() == [0, 0]
    assert batch.field("pair_hap").tolist() == [0, 1]
    mq = jax_pairhmm.modified_qualities(reads[1][1], 60)
    assert batch.field("read_quals").numpy().tolist() == mq.tolist()
    assert batch.field("hap_init").tolist() == [np.float32(2.0 ** 100 / 40),
                                                np.float32(2.0 ** 100 / 67)]
    for name, _ in pc._FIELDS:
        assert batch.layout[name][0] % 16 == 0


def test_launch_shape():
    """launch_plan: the warp path up to 256 bases (every rows-per-lane
    count 1..8), the stripe path above, the same limits as before."""
    w = 32 * pc.WARPS_PER_CTA
    s = 32 * pc.STRIPE_WARPS_PER_CTA
    assert pc.launch_plan(1) == ("warp", w, 1)
    assert pc.launch_plan(100) == ("warp", w, 4)
    assert pc.launch_plan(151) == ("warp", w, 5)
    assert pc.launch_plan(256) == ("warp", w, 8)
    assert pc.launch_plan(257) == ("stripe", s, 8)
    assert pc.launch_plan(600) == ("stripe", s, 8)
    assert pc.launch_plan(pc.MAX_READ_LEN) == ("stripe", s, 8)
    assert {pc.launch_plan(lr)[2] for lr in range(1, 257)} == set(range(1, 9))
    for lr in range(1, 3000, 37):
        path, t, r = pc.launch_plan(lr)
        assert t % 32 == 0 and t <= pc.MAX_THREADS
        assert (32 * r >= lr) if path == "warp" else 32 * sum(pc.stripe_rows(lr)) >= lr
        assert path == ("warp" if lr <= pc.WARP_MAX_READ_LEN else "stripe")
    with pytest.raises(ValueError):
        pc.launch_plan(pc.MAX_READ_LEN + 1)


_ROUTED_LENGTHS = [1, 31, 32, 33, 151, 255, 256, 257, 288, 289, 300, 450, 511, 512,
                   513, 600, 767, 768, 769, 1500, 4096, 4097, 8192, 12000, 16383, 16384]


@pytest.mark.parametrize("lr", _ROUTED_LENGTHS)
def test_launch_plan_routes_by_read_length(lr):
    """Reads of up to 256 bases go to the warp path, longer ones to the
    stripe path. The stripes: the first takes ceil(lr0 / 32) rows per lane
    for its lr0 = lr - 256 * n rows (1..256), each of the n below it 8 rows
    per lane (256 rows), so a read sweeps the fewest rows 32 rows per lane
    can give it; a read of up to 256 bases is one stripe of the warp
    path's rows."""
    path, threads, rows = pc.launch_plan(lr)
    assert path == ("warp" if lr <= 256 else "stripe")
    stripes = pc.stripe_rows(lr)
    n_full = max(0, (lr - 1) // 256)
    lr0 = lr - 256 * n_full
    assert stripes == (max(1, -(-lr0 // 32)),) + (8,) * n_full
    assert 1 <= lr0 <= 256 and 32 * sum(stripes) >= lr
    assert 32 * sum(stripes) - lr < 32  # no stripe sweeps a lane's worth of spare rows
    if path == "warp":
        assert stripes == (rows,) and threads == 32 * pc.WARPS_PER_CTA
    else:
        assert rows == pc.STRIPE_ROWS and threads == 32 * pc.STRIPE_WARPS_PER_CTA
    assert pc.launch_plan(lr, "stripe")[0] == "stripe"


def test_launch_plan_stripe_warps_by_haplotype_length():
    """Warps per CTA on the stripe path: 4 while four warps' shared memory
    (boundary row and haplotype bases) fits a block, fewer for longer
    haplotypes, and a clear error when one warp's does not."""
    limit = pc.SMEM_PER_BLOCK_H100
    assert pc.stripe_smem_bytes(650) == 12 * 652 + 672
    assert pc.launch_plan(450, None, 650, limit) == ("stripe", 128, 8)
    assert pc.launch_plan(1500, None, 2400, limit) == ("stripe", 128, 8)
    assert pc.launch_plan(1500, None, 5000, limit) == ("stripe", 96, 8)
    assert pc.launch_plan(1500, None, 6000, limit) == ("stripe", 64, 8)
    assert pc.launch_plan(4000, None, 16384, limit) == ("stripe", 32, 8)
    for lh in range(0, 18000, 97):
        try:
            _, t, _ = pc.launch_plan(300, None, lh, limit)
        except ValueError:
            assert pc.stripe_smem_bytes(lh) > limit
            continue
        assert (t // 32) * pc.stripe_smem_bytes(lh) <= limit
        assert t == 128 or (t // 32 + 1) * pc.stripe_smem_bytes(lh) > limit
    with pytest.raises(ValueError, match="shared memory"):
        pc.launch_plan(300, None, 20000, limit)
    with pytest.raises(ValueError, match="shared memory"):
        pc.launch_plan(300, "stripe", 700, 1000)


def test_launch_plan_forced_path():
    """A forced path: the stripe kernel takes any read, the warp kernel
    none over 256 bases; any other name raises."""
    assert pc.launch_plan(151, "stripe") == ("stripe", 32 * pc.STRIPE_WARPS_PER_CTA, 8)
    assert pc.launch_plan(151, "warp") == ("warp", 32 * pc.WARPS_PER_CTA, 5)
    with pytest.raises(ValueError):
        pc.launch_plan(257, "warp")
    with pytest.raises(ValueError):
        pc.launch_plan(100, "tile")


@pytest.mark.parametrize("path", ["warp", "stripe"])
def test_forced_path_on_cpu_is_plain(path):
    """On the CPU the forced entry runs the plain version and counts no
    launch; a batch the forced path cannot take raises."""
    reads, haps, pair_r, pair_h = _n_heavy_case()
    batch = pc.pack_pairs(reads, haps, pair_r, pair_h)
    tabs = pc.default_tables("cpu")
    n0, by0 = pc.LAUNCHES, dict(pc.LAUNCHES_BY_PATH)
    got = pc._pairhmm_forward_path(batch, tabs, path)
    assert torch.equal(got, pc.pairhmm_forward_plain(batch, tabs))
    assert pc.LAUNCHES == n0 and pc.LAUNCHES_BY_PATH == by0
    rng = np.random.RandomState(2)
    long_read = [(rng.choice(_BASES, 300).tobytes(),
                  rng.randint(2, 41, 300).astype(np.uint8), 60)]
    long_batch = pc.pack_pairs(long_read, haps, [0], [0])
    if path == "warp":
        with pytest.raises(ValueError):
            pc._pairhmm_forward_path(long_batch, tabs, path)
    else:
        assert torch.equal(pc._pairhmm_forward_path(long_batch, tabs, path),
                           pc.pairhmm_forward_plain(long_batch, tabs))


def test_build_failure_raises(tmp_path, monkeypatch):
    """A kernel that does not build raises; nothing falls back."""
    monkeypatch.setattr(pc, "_LIB", [])
    monkeypatch.setattr(pc, "_BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(pc, "_nvcc", lambda: "false")
    with pytest.raises(RuntimeError, match="nvcc failed"):
        pc.library()
    assert not os.listdir(tmp_path)
