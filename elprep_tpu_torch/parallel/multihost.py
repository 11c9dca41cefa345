"""Multi-process execution of the sharded pipeline phases, on
``torch.distributed``.

The reference's multi-node story is manual: split the input with `elprep
split`, run `elprep filter` per node, merge the outputs and gob-reduce the
.elrecal tables (reference: README.md:679-682, cmd/sfm.go:605-907). Here,
as in the JAX package, it is one program over the processes of a group:
every process parses the same (shared-filesystem) input and derives the
identical shard plan, runs the shards its mesh owns (parallel/sharded.py),
and the cross-process reductions are collectives — ``all_reduce`` for
the BQSR covariate tables (replacing the gob merge) and
``all_gather_into_tensor`` for the sort/dedup verdicts (replacing the
output-file merge). Every process ends with the replicated result and
writes its own copy of the output.

Run one process per rank::

    python -m elprep_tpu_torch.parallel.multihost \
        --coordinator HOST:PORT --num-processes N --process-id I \
        [--local-devices D] -- filter IN OUT --sharded ...

The backend follows the session device (``ELPREP_TPU_TORCH_DEVICE``,
default ``cuda``): NCCL on ``cuda``, gloo on the CPU; a failure to set up
either raises. ``--local-devices D`` gives each process a mesh of D
entries of its device (the JAX package's test topology of D devices per
process).

The HaplotypeCaller phase is contig-partitioned: each process calls
variants on a contiguous slice of the contig list (balanced by read
count — a plan every process computes identically from the replicated
batch), its PairHMM batches split over the process's own mesh only (no
collective rides inside the worker-pool drain, whose timing is
nondeterministic), and the per-process shard VCFs gather in contig order
through the shared filesystem behind two barriers on a gloo group — the
analog of the reference's per-node sfm HC jobs + CombineVcfOutputs
(reference: cmd/sfm.go:769-876, haploutils.go:481-499). Each contig
slice starts a fresh Java-LCG stream, so equality with a whole-file run
holds exactly when the downsampler does not fire.
"""

from __future__ import annotations

import datetime
import sys
from typing import List, Optional

import numpy as np

# The HaplotypeCaller barriers wait as long as the slowest rank's variant
# calling, far past a collective's usual timeout: they run on a gloo group
# of their own with this timeout, not on the NCCL group (whose watchdog
# would take a long wait for a hang)
HC_BARRIER_TIMEOUT = datetime.timedelta(hours=12)

_BARRIER_GROUP: list = [None]


def hc_contig_partition(read_counts, n_procs: int) -> "np.ndarray":
    """Contiguous contig->process assignment balanced by read count.

    A contig is owned by the process whose cumulative-weight band its
    MIDPOINT falls in (cut points at equal fractions), so a contig
    straddling a cut goes to whichever side holds more of it. Every
    process derives the identical plan from the replicated post-BQSR
    batch. Returns int32 [n_contigs] of owning process ids (monotone
    nondecreasing)."""
    counts = np.asarray(read_counts, np.int64)
    if len(counts) == 0:
        return np.zeros(0, np.int32)
    cum = np.cumsum(counts) - counts
    total = max(int(counts.sum()), 1)
    mid2 = 2 * cum + counts  # 2x the contig's cumulative midpoint
    return np.minimum((mid2 * n_procs) // (2 * total),
                      n_procs - 1).astype(np.int32)


def hc_gather_barrier(name: str) -> None:
    """Block until every process reaches this point (shard VCFs are
    visible on the shared filesystem before any process gathers).
    ``name`` labels the barrier in errors."""
    import torch.distributed as dist

    group = _BARRIER_GROUP[0]
    if group is None:
        raise RuntimeError(f"barrier {name}: multihost.initialize has not run")
    dist.barrier(group=group)


def initialize(coordinator: str, num_processes: int, process_id: int,
               local_devices: Optional[int] = None) -> str:
    """Join the process group of ``num_processes`` ranks as
    ``process_id``; the rendezvous is ``tcp://coordinator``, passed as
    ``init_method`` so that no MASTER_ADDR/RANK variables reach the
    processes this one spawns (the HaplotypeCaller pool). The backend is
    NCCL when the session device is ``cuda``, gloo on the CPU. Also
    creates the gloo group of the HaplotypeCaller barriers and, with
    ``local_devices``, sets the mesh size. Returns the backend."""
    import torch
    import torch.distributed as dist

    from .. import device as _device
    from . import mesh

    dev = _device.default_device_from_env()
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(dev if dev.index is not None else 0)
    dist.init_process_group(backend, init_method="tcp://" + coordinator,
                            world_size=num_processes, rank=process_id)
    _BARRIER_GROUP[0] = dist.new_group(backend="gloo", timeout=HC_BARRIER_TIMEOUT)
    mesh.set_local_devices(local_devices)
    return backend


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    import argparse

    p = argparse.ArgumentParser(
        prog="elprep_tpu_torch.parallel.multihost",
        description="one multi-process worker; pass the filter command after --")
    p.add_argument("--coordinator", required=True)
    p.add_argument("--num-processes", type=int, required=True)
    p.add_argument("--process-id", type=int, required=True)
    p.add_argument("--local-devices", type=int, default=None)
    if "--" in argv:
        split = argv.index("--")
        own, rest = argv[:split], argv[split + 1:]
    else:
        own, rest = argv, []
    args = p.parse_args(own)
    if not rest:
        p.error("missing filter command after --")
    if "--sharded" not in rest:
        rest = rest + ["--sharded"]

    initialize(args.coordinator, args.num_processes, args.process_id,
               args.local_devices)
    import torch.distributed as dist

    from .. import cli
    from .sharded import COLLECTIVES

    try:
        return cli.main(rest)
    finally:
        # one line for the launcher: this rank, the backend and the
        # collectives it ran (operation, bytes)
        print("elprep_tpu_torch multihost: rank %d of %d on %s; collectives %s"
              % (dist.get_rank(), dist.get_world_size(), dist.get_backend(),
                 COLLECTIVES), file=sys.stderr, flush=True)
        dist.destroy_process_group()
        _BARRIER_GROUP[0] = None


if __name__ == "__main__":
    # run the package's copy of this module: under ``python -m`` this file
    # is ``__main__``, and the barrier group must be where the CLI looks
    from elprep_tpu_torch.parallel import multihost as _multihost

    raise SystemExit(_multihost.main())
