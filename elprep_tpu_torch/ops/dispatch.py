"""Host-vs-device routing of the columnar programs (duplicate marking,
BQSR table build and apply).

The route is decided by the compute device alone: a batch for the CPU
takes the host engines (the native C++ twins, as the JAX package's CPU
backend does), and on ``cuda`` every batch, whatever its size, runs as
torch ops on the card. No batch-size threshold applies on the card yet:
one would need the H100's own crossover numbers.
"""

from __future__ import annotations

from .. import device as _device


def routes_to_host(n_rows: int, device=None) -> bool:
    """True exactly when ``device`` (``None``: the session default) is
    the CPU. ``n_rows`` is kept for the callers' signature; it does not
    decide anything."""
    return _device.resolve(device).type == "cpu"
