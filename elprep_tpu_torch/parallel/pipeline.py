"""Standalone mesh entry for the PairHMM batch.

The sharded sort/dedup/BQSR phases live in ``parallel.sharded`` (what
``filter --sharded`` runs); the mesh-aware PairHMM dispatch lives in
``ops.pairhmm``. This module only runs that shipped dispatch over an
explicit mesh for a full (read x haplotype) cross product; there is no
second implementation of it.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np


def pairhmm_sharded(mesh, reads: Sequence[Tuple[bytes, np.ndarray, int]],
                    haps: Sequence[bytes]) -> np.ndarray:
    """PairHMM log10 likelihoods [n_reads, n_haps] over ``mesh`` (a tuple
    of devices): the pair axis splits into one contiguous chunk per mesh
    entry, each chunk through the kernel on its device, with no
    collective (:func:`ops.pairhmm.pairhmm_f32_batch` on ``mesh``)."""
    from ..ops import pairhmm as ph

    return ph.pairhmm_f32_batch(reads, haps, tuple(mesh))
