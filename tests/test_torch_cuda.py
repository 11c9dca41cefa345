"""Tests of the port that need an NVIDIA GPU. They skip without one.

This file imports neither jax nor elprep_tpu, so on a machine with the
card and without JAX it runs on its own:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

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
