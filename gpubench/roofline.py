"""The yardstick of the kernels: the card's published peaks and the least
time a piece of work could take on it.

Peaks are NVIDIA's data sheet for one H100 SXM at its full power limit
(700 W): 67 TFLOP/s in float32 outside the tensor cores, 3.35 TB/s of
HBM3. A run prints the card's own power limit beside every share."""

from __future__ import annotations

PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

# float32 operations per PairHMM cell: 7 multiplies and 4 adds
# (with (I + D) * i2m as one multiply)
PAIRHMM_OPS_PER_CELL = 11


def pairhmm_bound_s(cells: int, packed_bytes: int, n_pairs: int) -> float:
    """The larger of the operations bound (11 float32 operations for each
    read x haplotype cell, Σ lr·lh of the pairs as sent) and the bytes
    bound (the packed inputs read once, one float32 per pair written)."""
    ops_s = PAIRHMM_OPS_PER_CELL * cells / PEAK_F32_FLOPS
    bytes_s = (packed_bytes + 4 * n_pairs) / PEAK_BYTES_PER_S
    return max(ops_s, bytes_s)


def device_programs_bytes(n_reads: int, read_len: int, dup_share: float) -> int:
    """Bytes that the torch device programs of one job must move at the
    least, each read once and each result written once:
    - duplicate marking: seven int32 columns in, one byte out per read;
    - the coordinate sort: eight int32 keys in, an int32 order out;
    - the BQSR table build over the non-duplicate reads: packed bases
      (half a byte), a quality byte and a skip bit per base (tables out
      are small and left out);
    - BQSR apply over every read: bases and qualities in, qualities out."""
    bases = n_reads * read_len
    return int(29 * n_reads + 36 * n_reads
               + bases * (1 - dup_share) * (0.5 + 1 + 0.125)
               + 3 * bases)


def bytes_bound_s(nbytes: int) -> float:
    return nbytes / PEAK_BYTES_PER_S
