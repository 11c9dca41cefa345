"""Per-read statistics computed on device from padded CIGAR/QUAL arrays.

These replace elPrep's per-read scalar loops
(reference: filters/mark-duplicates.go:36-110) with vectorized [N, C] /
[N, L] tensor operations:

- ``phred_score``: sum of Phred quals >= 15
  (mark-duplicates.go:36-68, qual chars above 126-33 are invalid);
- ``unclipped_position``: 5' unclipped position from FLAG/POS/CIGAR
  (mark-duplicates.go:79-110).

CIGAR ops are encoded as small class ids (index into "MIDNSHP=X"); rows
are padded with the 'S' class and length 0 so that the reverse-strand
trailing-clip scan is unaffected by padding.

Each device function takes numpy arrays or tensors plus ``device=``
(``None``: the session default) and returns an int32 tensor there.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import device as _device
from ..core.batch import Ragged

CIGAR_OPS = b"MIDNSHP=X"
OP_CLASS = {op: i for i, op in enumerate(CIGAR_OPS)}
PAD_CLASS = OP_CLASS[ord("S")]  # pad with zero-length soft clips

# per-class tables (reference: filters/mark-duplicates.go:72-75)
_CLIPPED = np.zeros(len(CIGAR_OPS), np.int32)
_CLIPPED[OP_CLASS[ord("S")]] = 1
_CLIPPED[OP_CLASS[ord("H")]] = 1
_REFERENCE = np.zeros(len(CIGAR_OPS), np.int32)
for _c in b"MDN=X":
    _REFERENCE[OP_CLASS[_c]] = 1
# reads-consuming ops (reference: sam/sam-types.go:744)
_READCONS = np.zeros(len(CIGAR_OPS), np.int32)
for _c in b"MIS=X":
    _READCONS[OP_CLASS[_c]] = 1

_ASCII_TO_CLASS = np.full(256, PAD_CLASS, np.uint8)
for _c, _i in OP_CLASS.items():
    _ASCII_TO_CLASS[_c] = _i


def pad_cigars(cigar_len: Ragged, cigar_op: Ragged, max_ops: int | None = None):
    """Host: ragged CIGARs -> padded ([N,C] class ids, [N,C] lengths, [N] n_ops)."""
    ops_ascii, n_ops = cigar_op.to_padded(max_ops, fill=ord("S"))
    lens, _ = cigar_len.to_padded(ops_ascii.shape[1], fill=0)
    classes = _ASCII_TO_CLASS[ops_ascii]
    # zero out pad lengths defensively
    cols = np.arange(ops_ascii.shape[1])
    lens = np.where(cols[None, :] < n_ops[:, None], lens, 0)
    return classes.astype(np.int8), lens.astype(np.int32), n_ops.astype(np.int32)


def pad_quals(qual: Ragged, max_len: int | None = None):
    """Host: ragged QUALs -> padded ([N,L] uint8, [N] lengths)."""
    q, lens = qual.to_padded(max_len, fill=0)
    return q, lens


def _t(a, dev: torch.device, dtype=torch.int32) -> torch.Tensor:
    return torch.as_tensor(a).to(device=dev, dtype=dtype)


def _lookup(table: np.ndarray, op_class: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(table).to(op_class.device)[op_class.long()]


def phred_score(qual_padded, qual_len, device=None) -> torch.Tensor:
    """Sum of quals >= 15 over the valid prefix
    (reference: filters/mark-duplicates.go:36-68)."""
    dev = _device.resolve(device)
    q = _t(qual_padded, dev)
    valid = (torch.arange(q.shape[1], device=dev, dtype=torch.int32)[None, :]
             < _t(qual_len, dev)[:, None])
    contrib = torch.where(valid & (q >= 15) & (q <= 126 - 33), q, 0)
    return contrib.sum(dim=1, dtype=torch.int32)


def unclipped_position(pos, flag, op_class, op_len, n_ops, device=None) -> torch.Tensor:
    """5' unclipped position (reference: filters/mark-duplicates.go:79-110).

    forward strand: POS minus the leading S/H clip run;
    reverse strand: POS - 1 plus, scanning from the 3' end, every
    reference-consuming op plus the trailing clip run.
    """
    dev = _device.resolve(device)
    pos, flag, n_ops = _t(pos, dev), _t(flag, dev), _t(n_ops, dev)
    op_class, op_len = _t(op_class, dev), _t(op_len, dev)
    # NB: zero-length pads are 'S' class so they keep clip runs alive
    clipped = _lookup(_CLIPPED, op_class)
    refcons = _lookup(_REFERENCE, op_class)

    # forward: leading clip run
    lead_run = torch.cumprod(clipped, dim=1)
    fwd = pos - (lead_run * op_len).sum(dim=1, dtype=torch.int32)

    # reverse: trailing clip run (cumprod from the right)
    trail_run = torch.flip(torch.cumprod(torch.flip(clipped, [1]), dim=1), [1])
    rev = pos - 1 + ((refcons | trail_run) * op_len).sum(dim=1, dtype=torch.int32)

    is_rev = (flag & 0x10) != 0
    result = torch.where(is_rev, rev, fwd)
    return torch.where(n_ops == 0, pos, result)


def read_length_from_cigar(op_class, op_len, device=None) -> torch.Tensor:
    """Sum of read-consuming op lengths (reference: sam/sam-types.go:750-756)."""
    dev = _device.resolve(device)
    rc = _lookup(_READCONS, _t(op_class, dev))
    return (rc * _t(op_len, dev)).sum(dim=1, dtype=torch.int32)


def reference_length_from_cigar(op_class, op_len, device=None) -> torch.Tensor:
    """Sum of reference-consuming op lengths (reference: sam/sam-types.go:759-765)."""
    dev = _device.resolve(device)
    rc = _lookup(_REFERENCE, _t(op_class, dev))
    return (rc * _t(op_len, dev)).sum(dim=1, dtype=torch.int32)
