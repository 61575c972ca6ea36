"""Unit conversions (dB / linear power / voltage ratios).

Same conventions as the reference's misc.h helpers (power2dB/dB2power/
voltage2dB/dB2voltage): power dB = 10*log10, voltage dB = 20*log10.
These are host-side helpers (plain math, works on numpy arrays and python
floats); device code inlines the torch equivalent.
"""
from __future__ import annotations

import numpy as np


def power_to_dB(x):
    """Linear power ratio -> dB.  0 maps to -inf."""
    with np.errstate(divide="ignore"):
        return 10.0 * np.log10(x)


def dB_to_power(x):
    return np.power(10.0, np.asarray(x, dtype=np.float64) / 10.0)


def voltage_to_dB(x):
    with np.errstate(divide="ignore"):
        return 20.0 * np.log10(x)


def dB_to_voltage(x):
    return np.power(10.0, np.asarray(x, dtype=np.float64) / 20.0)
