"""Multi-device / multi-process runtime of the port.

The reference's "distributed" story is contig-group shards run as
separate processes with gob-file reductions (reference: cmd/sfm.go:605-907).
Here, as in the JAX package's ``elprep_tpu/parallel``:

- reads shard over the mesh's devices by contiguous contig spans
  (``sharded``); sort and duplicate marking run per shard, with helper
  copies of cross-shard mates;
- the BQSR covariate tables reduce with ``torch.distributed.all_reduce``
  across processes instead of gob files on disk;
- the PairHMM's (read, haplotype) pairs split over the mesh with no
  collective (``pipeline``);
- ``multihost`` runs one process per rank on NCCL (``cuda``) or gloo (CPU).
"""

from .mesh import make_mesh
from .pipeline import pairhmm_sharded

__all__ = ["make_mesh", "pairhmm_sharded"]
