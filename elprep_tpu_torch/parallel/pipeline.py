"""Standalone mesh entry for the PairHMM batch.

The sharded sort/dedup/BQSR phases live in ``parallel.sharded`` (what
``filter --sharded`` runs); the mesh-aware PairHMM dispatch lives in
``ops.pairhmm`` (a session property the CLI sets). This module only runs
that shipped dispatch over an explicit mesh for a full (read x haplotype)
cross product; there is no second implementation of it.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np


def pairhmm_sharded(mesh, reads: Sequence[Tuple[bytes, np.ndarray, int]],
                    haps: Sequence[bytes]) -> np.ndarray:
    """PairHMM log10 likelihoods [n_reads, n_haps] over ``mesh`` (a tuple
    of devices): the pair axis splits into one contiguous chunk per mesh
    entry, each chunk through the kernel on its device, with no
    collective (:func:`ops.pairhmm.pairhmm_logl_pairs` with the mesh
    session property set)."""
    from ..ops import pairhmm as ph

    n_reads, n_haps = len(reads), len(haps)
    if n_reads == 0 or n_haps == 0:
        return np.zeros((n_reads, n_haps), np.float64)
    pair_r = np.repeat(np.arange(n_reads, dtype=np.int32), n_haps)
    pair_h = np.tile(np.arange(n_haps, dtype=np.int32), n_reads)
    prev = ph._MESH[0]
    ph.set_pairhmm_mesh(mesh)
    try:
        out = ph.pairhmm_logl_pairs(reads, haps, pair_r, pair_h)
    finally:
        ph.set_pairhmm_mesh(prev)
    return np.asarray(out).reshape(n_reads, n_haps)
