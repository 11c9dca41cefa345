"""Pedantic mode (reference: filters/pedantic.go, build tag ``pedantic``).

elPrep's pedantic build emulates behaviours that are not necessary for
correct results but guarantee binary-equal output with GATK/Picard:
Java-style float formatting (pedantic.go:66-110), int16 tile-coordinate
wraparound in optical-duplicate distances (pedantic.go:54-56), and
Java's x87 ``log10`` (pedantic.go:29-52). Here it is a runtime flag
(``--pedantic``) instead of a build tag.
"""

from __future__ import annotations

import math

import numpy as np

enabled = False


def set_pedantic(on: bool) -> None:
    global enabled
    enabled = bool(on)


def x86_log10(x: float) -> float:
    """Java-parity log10 via the x87 ``fyl2x`` instruction
    (reference: pedantic.go:29-52); falls back to IEEE log10 when the
    native library is unavailable."""
    from . import native

    v = native.x86_log10(x)
    return math.log10(x) if v is None else v


def pedantic_formatf(value: float, precision: int) -> str:
    """Java-style fixed-point formatting: round the SHORTEST decimal
    representation half-up, instead of correctly rounding the binary
    value (reference: pedantic.go:66-110)."""
    if math.isnan(value):
        return "NaN"
    if math.isinf(value):
        return "+Inf" if value > 0 else "-Inf"
    formatted = bytearray(
        np.format_float_positional(value, unique=True, trim="-").encode())
    if formatted[-1:] == b".":  # numpy may leave "12." where Go gives "12"
        del formatted[-1]
    offset = 1 if formatted[:1] == b"-" else 0
    for i in range(offset, len(formatted)):
        if formatted[i] == ord("."):
            end = i + 1 + precision
            if end < len(formatted):
                if formatted[end] >= ord("5"):
                    overflow = True
                    for j in range(end - 1, offset - 1, -1):
                        c = formatted[j]
                        if c == ord("9"):
                            formatted[j] = ord("0")
                        elif c != ord("."):
                            formatted[j] = c + 1
                            overflow = False
                            break
                    if overflow:
                        formatted = formatted[: end + 1]
                        formatted[offset + 1 :] = formatted[offset:-1]
                        formatted[offset] = ord("1")
                    else:
                        formatted = formatted[:end]
                else:
                    formatted = formatted[:end]
            else:
                formatted += b"0" * (end - len(formatted))
            return formatted.decode()
    formatted += b"." + b"0" * precision
    return formatted.decode()
