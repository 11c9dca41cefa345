"""Device mesh of the port: an ordered tuple of ``torch.device``s.

The JAX package's mesh has a read axis ``dp`` and a genome axis ``gn``,
and every caller flattens it to ``dp`` (elprep_tpu/parallel/sharded.py
``_flat_mesh``, ops/pairhmm.py), so here the mesh is that flat axis: the
devices of this process, one shard each. A mesh may name one device more
than once (eight shards on the CPU in the tests, four on one card in
chip_smoke.py). Across processes (parallel/multihost.py) rank ``r`` with
``D`` mesh entries owns shards ``[r*D, (r+1)*D)``, the JAX process-major
device order.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .. import device as _device

Mesh = Tuple[torch.device, ...]

# entries per process forced by ``multihost --local-devices D`` (None: the
# device's own count)
_LOCAL_DEVICES: list = [None]


def set_local_devices(n: Optional[int]) -> None:
    """Make :func:`make_mesh` return ``n`` entries of the session device
    (the JAX package's ``--local-devices``: D devices per process for a
    test topology); None restores the default."""
    _LOCAL_DEVICES[0] = n


def make_mesh(n_devices: Optional[int] = None, device=None) -> Mesh:
    """The mesh of this process on ``device`` (``None``: the session
    default). On ``cuda`` it is the visible cards, the first
    ``n_devices`` of them when given (fewer raises); on the CPU it is one
    device, or ``n_devices`` entries of it. ``set_local_devices`` overrides
    both when ``n_devices`` is None."""
    dev = _device.resolve(device)
    if n_devices is None and _LOCAL_DEVICES[0] is not None:
        return (dev,) * _LOCAL_DEVICES[0]
    if dev.type == "cpu":
        return (dev,) * (n_devices or 1)
    have = torch.cuda.device_count()
    n = have if n_devices is None else n_devices
    if have < n:
        raise RuntimeError(f"need {n} devices, have {have}")
    return tuple(torch.device("cuda", i) for i in range(n))


def in_process_group() -> bool:
    """Whether this process has joined a torch.distributed group."""
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


def process_rank_and_count() -> Tuple[int, int]:
    """(rank, world size) of the torch.distributed group, (0, 1) without one."""
    import torch.distributed as dist

    if in_process_group():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1
