"""Go-compatible number formatting.

elPrep formats float optional fields with Go's
``strconv.AppendFloat(out, float64(val), 'g', -1, 32)``
(reference: sam/sam-files.go:495) — the shortest decimal string that
round-trips the float32 value, switching to scientific notation when the
decimal exponent is < -4 or >= number-of-digits... (Go uses eprec=6 for
shortest 'g'). We replicate that exactly so tag output is byte-equal.
"""

from __future__ import annotations

import numpy as np


def go_format_float32(v: float) -> str:
    """Equivalent of Go strconv.FormatFloat(float64(float32(v)), 'g', -1, 32)."""
    f = np.float32(v)
    if np.isnan(f):
        return "NaN"
    if np.isinf(f):
        return "+Inf" if f > 0 else "-Inf"
    neg = bool(np.signbit(f))
    a = abs(f)
    if a == 0:
        return "-0" if neg else "0"
    # Shortest digits + decimal exponent via numpy's unique scientific repr.
    s = np.format_float_scientific(a, unique=True, trim="-")
    mant, _, exp_s = s.partition("e")
    exp10 = int(exp_s)
    digits = mant.replace(".", "").rstrip("0") or "0"
    # decimal point position: value = 0.digits * 10^(exp10+1)
    dp = exp10 + 1
    nd = len(digits)
    exp = dp - 1
    if exp < -4 or exp >= 6:  # shortest 'g' uses eprec=6 (Go strconv/ftoa.go)
        # %e style: d.ddd e±XX (exponent at least 2 digits)
        out = digits[0]
        if nd > 1:
            out += "." + digits[1:]
        out += "e"
        if exp < 0:
            out += "-"
            exp = -exp
        else:
            out += "+"
        out += f"{exp:02d}"
    else:
        # %f style
        if dp <= 0:
            out = "0." + "0" * (-dp) + digits
        elif dp >= nd:
            out = digits + "0" * (dp - nd)
        else:
            out = digits[:dp] + "." + digits[dp:]
    return ("-" + out) if neg else out


def go_parse_float32(s: str) -> np.float32:
    """Go strconv.ParseFloat(s, 32) equivalent (round-to-nearest-even)."""
    return np.float32(float(s))
