"""HaplotypeCaller orchestration hooks used by hc/driver.py.

The JAX package runs regions on a pool of spawned worker processes
(elprep_tpu/hc/parallel.py). That pool is not ported yet: ``get_pool``
returns None, so ``call_variants`` takes its serial path, whose output is
byte-equal to the pooled one (tests/test_hc_driver.py). Only the pieces
the driver imports live here.
"""

from __future__ import annotations

import os
import sys
import time

# activity chunk width in reference positions (the pool path; the serial
# driver uses larger chunks)
ACT_CHUNK = 1 << 16


def get_pool(n_workers: int) -> None:
    """No worker pool in this package yet: always the serial path."""
    return None


def make_tracer(tag: str):
    """ELPREP_TPU_HC_TRACE-gated stderr tracer with a per-call-site
    clock (shared by the driver and the CLI)."""
    if not os.environ.get("ELPREP_TPU_HC_TRACE"):
        return lambda fmt, *a: None
    t0 = time.perf_counter()

    def _tr(fmt, *a):
        print("[%s %.3f] " % (tag, time.perf_counter() - t0) + fmt % a,
              file=sys.stderr, flush=True)
    return _tr
