"""Packed host->device column transfer.

The BQSR table build ships an [n, L] base matrix and an [n, L] skip mask
to the card for every slice; both are massively redundant:

- bases draw from a tiny alphabet (ACGTN + case variants in practice,
  <= 16 distinct byte values in any real batch), so they pack into
  4-bit dictionary indices -- 2 bases/byte, fully lossless for ANY
  alphabet up to 16 symbols (unlike BAM nibble codes, which fold case
  and would change covariate contexts for lowercase SAM input);
- the skip mask is boolean, so it bit-packs 8x.

Packing happens on the host (numpy: one LUT gather + shift/or),
unpacking with torch ops on the tensor's own device, so the dense
[n, L] forms never cross the host->device link.

Contract: this is pure transport -- unpack(pack(x)) == x bit-exactly,
so every consumer's output is unchanged vs shipping dense columns.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch


def pack_nibble_dict(arr: np.ndarray) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Pack a [n, L] uint8 matrix whose values draw from <= 16 distinct
    bytes into ([n, ceil(L/2)] uint8, lut[16] uint8). Returns None when
    the alphabet exceeds 16 symbols (caller ships dense)."""
    arr = np.ascontiguousarray(arr, np.uint8)
    present = np.zeros(256, bool)
    present[arr.reshape(-1)] = True
    vals = np.flatnonzero(present)
    if len(vals) > 16:
        return None
    lut = np.zeros(16, np.uint8)
    lut[: len(vals)] = vals.astype(np.uint8)
    code_of = np.zeros(256, np.uint8)
    code_of[vals] = np.arange(len(vals), dtype=np.uint8)
    idx = code_of[arr]
    n, L = arr.shape
    if L % 2:
        idx = np.concatenate([idx, np.zeros((n, 1), np.uint8)], axis=1)
    packed = (idx[:, 0::2] << 4) | idx[:, 1::2]
    return packed, lut


def unpack_nibble_dict(packed: torch.Tensor, lut: torch.Tensor, L: int) -> torch.Tensor:
    """Inverse of :func:`pack_nibble_dict` on ``packed``'s device:
    [n, ceil(L/2)] uint8 + lut[16] -> [n, L] uint8."""
    hi = packed >> 4
    lo = packed & 0xF
    idx = torch.stack([hi, lo], dim=2).reshape(packed.shape[0], -1)[:, :L]
    return lut.to(device=packed.device, dtype=torch.uint8)[idx.long()]


def pack_bits(mask: np.ndarray) -> np.ndarray:
    """Bit-pack a [n, L] boolean matrix to [n, ceil(L/8)] uint8
    (big-endian within each byte, np.packbits convention)."""
    return np.packbits(np.ascontiguousarray(mask, bool), axis=1)


def unpack_bits(packed: torch.Tensor, L: int) -> torch.Tensor:
    """Inverse of :func:`pack_bits` on ``packed``'s device."""
    shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=packed.device)
    bits = (packed[:, :, None] >> shifts[None, None, :]) & 1
    return bits.reshape(packed.shape[0], -1)[:, :L].bool()
