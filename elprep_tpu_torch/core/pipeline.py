"""Filter pipeline core.

Mirrors the reference's filter framework (reference:
sam/filter-pipeline.go:33-296) with batch-level semantics:

- a ``Filter`` is ``f(header) -> BatchFilter | None``; instantiating it
  may mutate the header (exactly like the reference's
  ``Filter = func(*Header) AlignmentFilter``);
- a ``BatchFilter`` is ``g(batch) -> keep_mask | None``; it may mutate
  batch columns in place (like AlignmentFilter mutates the Alignment);
- ``compose_filters`` applies them in order with compaction between
  masking filters, preserving the reference's per-read short-circuit
  semantics (a read removed by filter i is never seen by filter i+1,
  sam/filter-pipeline.go:163-198);
- ``effective_sorting_order`` elides redundant sorts
  (sam/filter-pipeline.go:208-225).

Sorting runs as a torch permutation on the caller's device
(ops/sortkeys.py) followed by a host gather.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, List, Optional, Tuple

import numpy as np

from .. import trace
from .batch import ReadBatch
from .header import Header, SortingOrder

BatchFilter = Callable[[ReadBatch], Optional[np.ndarray]]
Filter = Callable[[Header], Optional[BatchFilter]]


@dataclass
class SamData:
    """In-memory SAM dataset (reference ``Sam``, sam/sam-types.go:646-650)."""

    header: Header = field(default_factory=Header)
    batch: ReadBatch = field(default_factory=ReadBatch.empty)


def compose_filters(header: Header, filters: List[Optional[Filter]]) -> List[BatchFilter]:
    """Instantiate filters against the header, in order
    (reference: sam/filter-pipeline.go:163-171)."""
    batch_filters: List[BatchFilter] = []
    for f in filters or []:
        if f is not None:
            bf = f(header)
            if bf is not None:
                batch_filters.append(bf)
    return batch_filters


def apply_filters(batch: ReadBatch, batch_filters: List[BatchFilter]) -> ReadBatch:
    for bf in batch_filters:
        mask = bf(batch)
        if mask is not None and not mask.all():
            batch = batch.select(np.asarray(mask, dtype=bool))
    return batch


def effective_sorting_order(
    sorting_order: SortingOrder, header: Header, original: SortingOrder
) -> SortingOrder:
    """(reference: sam/filter-pipeline.go:208-225)"""
    if sorting_order == SortingOrder.KEEP:
        sorting_order = original
    current = header.hd_so()
    if sorting_order in (SortingOrder.COORDINATE, SortingOrder.QUERYNAME):
        if current == sorting_order:
            return SortingOrder.KEEP
        header.set_hd_so(sorting_order)
    elif sorting_order in (SortingOrder.UNKNOWN, SortingOrder.UNSORTED):
        if current != sorting_order:
            header.set_hd_so(sorting_order)
    return sorting_order


def sort_batch(batch: ReadBatch, order: SortingOrder, device=None) -> ReadBatch:
    """Sort with the torch permutation on ``device`` (``None``: the
    session default), then gather the rows on the host.

    Coordinate order requires the REFID/NextREFID temp columns, like the
    reference requires the AddREFID filter (sam/sam-types.go:372-378).
    """
    from ..ops import sortkeys

    if len(batch) == 0:
        return batch
    if order == SortingOrder.COORDINATE:
        if "REFID" not in batch.temps:
            raise ValueError("REFID not set (use the add_refid filter to fix this)")
        qrank = sortkeys.qname_ranks_cached(batch)
        perm = sortkeys.coordinate_sort_perm(
            batch.flag, batch.temps["REFID"], batch.pos, batch.mapq,
            batch.temps["NextREFID"], batch.pnext, batch.tlen, qrank,
            device=device)
    elif order == SortingOrder.QUERYNAME:
        qrank = sortkeys.qname_ranks_cached(batch)
        perm = sortkeys.queryname_sort_perm(qrank, device=device)
    else:
        return batch
    return batch.select(perm.cpu().numpy().astype(np.int32))


def run_pipeline(
    data: SamData,
    filters: List[Optional[Filter]],
    sorting_order: SortingOrder = SortingOrder.KEEP,
    device=None,
    spans: Tuple[str, str] = ("pipeline.filters", "pipeline.sort"),
) -> SamData:
    """In-memory RunPipeline (reference: sam/filter-pipeline.go:242-279).
    ``spans`` names the recorder's spans (trace.py) of the filters and of
    the sort."""
    header = data.header
    original = header.hd_so()
    batch_filters = compose_filters(header, filters)
    sorting_order = effective_sorting_order(sorting_order, header, original)
    with trace.span(spans[0]):
        batch = apply_filters(data.batch, batch_filters)
    if sorting_order in (SortingOrder.COORDINATE, SortingOrder.QUERYNAME):
        with trace.span(spans[1]):
            batch = sort_batch(batch, sorting_order, device=device)
    return SamData(header=header, batch=batch)
