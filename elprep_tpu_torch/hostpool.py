"""Shared host thread pool for GIL-releasing work.

One process-wide executor used by the BGZF codec workers, the sharded
prepass (per-shard column stacking + native BQSR prep), and any other
numpy/C++ stage that releases the GIL — the TPU-native stand-in for the
reference's pargo worker pool (the Go runtime scheduler). Sized to the
host's cores once; lazily created so importing the package stays cheap.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

_shared: Optional[ThreadPoolExecutor] = None


def shared_pool() -> ThreadPoolExecutor:
    global _shared
    if _shared is None:
        _shared = ThreadPoolExecutor(max_workers=min(32, os.cpu_count() or 4))
    return _shared
