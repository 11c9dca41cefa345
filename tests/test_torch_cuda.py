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


def _case(seed, read_lens, hap_lens, n_frac=0.05):
    """Reads cut from random haplotypes with 2% errors and 'N' bases,
    every read against every haplotype."""
    rng = np.random.RandomState(seed)
    haps = [rng.choice(_BASES, lh) for lh in hap_lens]
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
