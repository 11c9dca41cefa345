#!/usr/bin/env python3
"""Faults planted in the program under a run, to read what the comparison
makes of them (``correct`` has to come out false):

    python3 gpubench/faults.py FAULT --workload CELL --seed N --seconds S

FAULT is one of
- ``state_unchanged``: BQSR's apply returns the qualities as they came;
- ``half_left_out``: every second read is dropped as the SAM is read;
- ``dup_flipped``: one read's duplicate flag is flipped as the mask is made;
- ``gvcf_half``: every second chunk of GVCF records never reaches the file;
- ``genotype_flipped``: every heterozygous call is written homozygous;
- ``hets_uncalled``: every heterozygous call is written 0/0, as a caller
  that misses heterozygous sites would;
- ``targets_ignored``: ``--target-regions`` removes no read, as a
  pipeline that skipped the filter would (a cell whose traffic passes
  it; the HaplotypeCaller still calls only the targets).
A one-card cell has no exchange between chips to leave out. The same
planters serve the CPU tests (tests/test_gpubench_faults.py)."""

from __future__ import annotations

import contextlib
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
if HERE not in sys.path:
    sys.path.insert(0, HERE)


def _patch(stack, obj, name, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    stack.callback(setattr, obj, name, old)


def plant(stack: contextlib.ExitStack, fault: str) -> None:
    import numpy as np

    if fault == "state_unchanged":
        from elprep_tpu_torch.filters import bqsr

        _patch(stack, bqsr, "apply_bqsr_filter",
               lambda *a, **k: (lambda header: (lambda batch: None)))
    elif fault == "half_left_out":
        from elprep_tpu_torch.io import sam

        read = sam.read_sam_file

        def half(path, *a, **k):
            hdr, batch = read(path, *a, **k)
            return hdr, batch.select(np.arange(len(batch))[::2])

        _patch(stack, sam, "read_sam_file", half)
    elif fault == "dup_flipped":
        from elprep_tpu_torch.filters import markdup

        make = markdup.mark_duplicates_batch

        def flip(batch, header, device=None):
            dup, aux = make(batch, header, device)
            dup = np.array(dup, copy=True)
            dup[0] = not dup[0]
            return dup, aux

        _patch(stack, markdup, "mark_duplicates_batch", flip)
    elif fault == "gvcf_half":
        from elprep_tpu_torch.io import vcf

        chunks = vcf.iter_variant_bytes

        def every_second(variants):
            for k, chunk in enumerate(chunks(variants)):
                if k % 2 == 0:
                    yield chunk

        _patch(stack, vcf, "iter_variant_bytes", every_second)
    elif fault == "genotype_flipped":
        from elprep_tpu_torch.io import vcf

        chunks = vcf.iter_variant_bytes

        def homozygous(variants):
            for chunk in chunks(variants):
                yield chunk.replace(b"\t0/1:", b"\t1/1:")

        _patch(stack, vcf, "iter_variant_bytes", homozygous)
    elif fault == "hets_uncalled":
        from elprep_tpu_torch.io import vcf

        chunks = vcf.iter_variant_bytes

        def uncalled(variants):
            for chunk in chunks(variants):
                yield chunk.replace(b"\t0/1:", b"\t0/0:")

        _patch(stack, vcf, "iter_variant_bytes", uncalled)
    elif fault == "targets_ignored":
        from elprep_tpu_torch.filters import simple

        _patch(stack, simple, "remove_non_overlapping_reads",
               lambda bed: (lambda header: (lambda batch: np.ones(len(batch), bool))))
    else:
        raise ValueError("unknown fault %r" % fault)


FAULTS = ("state_unchanged", "half_left_out", "dup_flipped", "gvcf_half", "genotype_flipped",
          "hets_uncalled", "targets_ignored")


def main(argv=None) -> int:
    import run

    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0] not in FAULTS:
        print("usage: faults.py {%s} RUN-ARGUMENTS" % "|".join(FAULTS), file=sys.stderr)
        return 2
    run.log("fault planted: %s" % argv[0])
    with contextlib.ExitStack() as stack:
        plant(stack, argv[0])
        return run.main(argv[1:])


if __name__ == "__main__":
    sys.exit(main())
