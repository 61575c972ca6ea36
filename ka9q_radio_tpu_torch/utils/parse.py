"""Frequency / time string parsing.

Behavior-compatible with the reference's parse_frequency (misc.c, used by
radio.c:817 and the `tune` client): accepts plain Hz, suffix multipliers
(k/m/g, case-insensitive), and the ham "infix decimal point" notation where
the multiplier letter sits at the decimal point, e.g. "147m435" = 147.435 MHz.

Without a multiplier letter OR decimal point ("radix") the reference applies
a magnitude heuristic when `heuristics` is on (misc.c:789-793): integers
< 500 are MHz, 500..99999 are kHz, >= 100000 are Hz. A decimal point counts
as an explicit radix and disables the heuristic.
"""
from __future__ import annotations

import re

_MULT = {"k": 1e3, "m": 1e6, "g": 1e9}

_RE = re.compile(
    r"""^\s*
        (?P<sign>[+-]?)
        (?P<int>\d*)
        (?:
            (?P<mult>[kKmMgG])      # infix multiplier acts as decimal point
            (?P<frac>\d*)
          |
            (?:\.(?P<frac2>\d+))?
            (?P<mult2>[kKmMgG]?)
        )
        \s*(?:[hH][zZ])?\s*$""",
    re.VERBOSE,
)


def parse_frequency(s: str | float | int, default_heuristic: bool = False) -> float:
    """Parse a frequency string to Hz."""
    if isinstance(s, (int, float)):
        value, mult, sign = float(s), None, 1.0
    else:
        m = _RE.match(str(s))
        if not m:
            raise ValueError(f"cannot parse frequency: {s!r}")
        sign = -1.0 if m.group("sign") == "-" else 1.0
        if m.group("mult"):
            intpart = m.group("int") or "0"
            frac = m.group("frac") or ""
            value = float(f"{intpart}.{frac}" if frac else intpart)
            mult = m.group("mult").lower()
        else:
            intpart = m.group("int") or "0"
            frac = m.group("frac2")
            value = float(f"{intpart}.{frac}" if frac else intpart)
            mult = (m.group("mult2") or "").lower() or None
            if frac is not None and mult is None:
                return sign * value  # explicit radix disables the heuristic
    if mult:
        return sign * value * _MULT[mult]
    if default_heuristic and value != 0:
        if value < 500.0:
            return sign * value * 1e6  # assume MHz (misc.c:790)
        if value < 100_000.0:
            return sign * value * 1e3  # assume kHz (misc.c:792)
    return sign * value
