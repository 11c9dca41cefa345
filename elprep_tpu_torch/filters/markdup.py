"""Duplicate-marking filter (reference: filters/mark-duplicates.go:398-445).

The mask is computed in ops/dedup.py (torch on the caller's device, or
the host twin on the CPU); this module provides the
pipeline-facing filter that ORs the duplicate mask into FLAG and records
the auxiliary columns needed by optical-duplicate marking.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..core.batch import DUPLICATE, ReadBatch
from ..core.header import Header
from ..core.pipeline import BatchFilter
from ..ops.dedup import mark_duplicates_batch


class MarkDuplicatesState:
    """Holds post-dedup info for the optical pass
    (the reference returns its fragments/pairs maps for the same purpose,
    mark-duplicates.go:406-445)."""

    def __init__(self) -> None:
        self.aux: Optional[dict] = None


def mark_duplicates_filter(also_opticals: bool = False,
                           state: Optional[MarkDuplicatesState] = None,
                           device=None):
    """Returns a pipeline Filter; requires add_refid before it
    (like the reference requires AddREFID, mark-duplicates.go:398-401).
    The mask is computed on ``device`` (``None``: the session default)."""

    def filter_(header: Header) -> BatchFilter:
        def bf(batch: ReadBatch) -> None:
            if len(batch) == 0:
                if state is not None and state.aux is None:
                    z = np.zeros(0, np.int32)
                    state.aux = {"libid": z, "upos": z, "score": z, "qrank": z}
                return None
            dup, aux = mark_duplicates_batch(batch, header, device)
            batch.flag = np.where(dup, batch.flag | DUPLICATE, batch.flag).astype(np.int32)
            # store per-read columns as temps so any later sort permutes
            # them together with the reads (the optical pass re-joins
            # pairs by {LIBID, QNAME-rank}; stale, unpermuted columns
            # would mis-pair after a coordinate sort)
            batch.temps["LIBID"] = aux["libid"]
            batch.temps["UPOS"] = aux["upos"]
            batch.temps["DUPSCORE"] = aux["score"]
            batch.temps["QRANK"] = aux["qrank"]
            if state is not None:
                state.aux = aux
            return None

        return bf

    return filter_


def aux_from_temps(batch: ReadBatch) -> Optional[dict]:
    """Rebuild the optical-pass aux dict from batch temps (valid after
    any subsequent sort, unlike MarkDuplicatesState.aux)."""
    if "LIBID" not in batch.temps:
        return None
    return {
        "libid": batch.temps["LIBID"],
        "upos": batch.temps["UPOS"],
        "score": batch.temps["DUPSCORE"],
        "qrank": batch.temps["QRANK"],
    }
