"""Built-in demodulator presets — the values of share/presets.conf.

Keys use the config-file spellings ("deemph-tc", "squelch-open", ...) so a
user presets file can override or extend the table with the same syntax
(modes.c loadpreset). Frequencies are plain Hz here (the file loader runs
parse_frequency on string values).
"""
from __future__ import annotations

__all__ = ["PRESETS", "preset_table"]

_FM_COMMON = dict(demod="fm", samprate=24_000, filter2=0, pll=False, square=False,
                  mono=True, shift=0.0, conj=False)
_PM_COMMON = dict(**_FM_COMMON, **{
    "squelch-tail": 0, "threshold-extend": True, "deemph-tc": 530.5,
    "deemph-gain": 12.0, "squelch-open": 10.0, "squelch-close": 6.0,
    "snr-squelch": False,
})
_LINEAR_COMMON = dict(demod="linear", samprate=12_000, filter2=0, pll=False,
                      square=False, mono=True, shift=0.0, envelope=False,
                      conj=False, agc=True, **{"snr-squelch": False,
                      "hang-time": 1.1, "recovery-rate": 20.0})

PRESETS: dict[str, dict] = {
    # --- FM family (presets.conf:7-119) ---
    "pm": {**_PM_COMMON, "low": -8000.0, "high": 8000.0},
    "npm": {**_PM_COMMON, "low": -6250.0, "high": 6250.0},
    "wpm": {**_PM_COMMON, "samprate": 48_000, "low": -20_000.0, "high": 20_000.0},
    "fm": {**_FM_COMMON, "low": -8000.0, "high": 8000.0, "deemph-tc": 0.0,
           "deemph-gain": 0.0, "threshold-extend": False, "snr-squelch": False},
    "nfm": {**_FM_COMMON, "low": -6250.0, "high": 6250.0, "deemph-tc": 0.0,
            "deemph-gain": 0.0, "threshold-extend": False, "snr-squelch": False},
    "wfm": {"demod": "wfm", "samprate": 384_000, "low": -110_000.0, "high": 110_000.0,
            "filter2": 0, "threshold-extend": False, "deemph-tc": 75.0,
            "deemph-gain": 0.0, "pll": False, "square": False, "mono": True,
            "shift": 0.0, "conj": False, "squelch-open": 10.0,
            "squelch-close": 6.0, "snr-squelch": False},
    # --- linear family (presets.conf:120-380) ---
    "am": {**_LINEAR_COMMON, "low": -5000.0, "high": 5000.0, "envelope": True,
           "recovery-rate": 50.0, "hang-time": 0.0},
    "sam": {**_LINEAR_COMMON, "low": -5000.0, "high": 5000.0, "pll": True,
            "recovery-rate": 50.0, "hang-time": 0.0, "squelch-open": 8.0,
            "squelch-close": 7.0, "snr-squelch": True},
    "ame": {**_LINEAR_COMMON, "low": -100.0, "high": 5000.0, "pll": True,
            "recovery-rate": 50.0, "hang-time": 0.0, "squelch-open": 8.0,
            "squelch-close": 7.0, "snr-squelch": True},
    "iq": {**_LINEAR_COMMON, "low": -5000.0, "high": 5000.0, "mono": False,
           "stereo": True},
    "cwu": {**_LINEAR_COMMON, "low": -200.0, "high": 200.0, "filter2": 4,
            "shift": 500.0, "hang-time": 0.2},
    "cwl": {**_LINEAR_COMMON, "low": -200.0, "high": 200.0, "filter2": 4,
            "shift": -500.0, "hang-time": 0.2},
    "usb": {**_LINEAR_COMMON, "low": 50.0, "high": 3000.0},
    "lsb": {**_LINEAR_COMMON, "low": -3000.0, "high": -50.0},
    "dsb": {**_LINEAR_COMMON, "low": -5000.0, "high": 5000.0, "square": True},
    "isb": {**_LINEAR_COMMON, "low": -5000.0, "high": 5000.0, "filter2": 1,
            "conj": True, "mono": False, "stereo": True},
    "amsq": {**_LINEAR_COMMON, "low": -3000.0, "high": 3000.0, "envelope": True,
             "recovery-rate": 50.0, "hang-time": 0.0, "squelch-open": 8.0,
             "squelch-close": 7.0, "snr-squelch": True, "dc-cut": 20.0},
    "wspr": {**_LINEAR_COMMON, "low": 50.0, "high": 3000.0, "agc": False,
             "gain": 60.0},
    "nam": {**_LINEAR_COMMON, "low": -3000.0, "high": 3000.0, "envelope": True,
            "recovery-rate": 50.0, "hang-time": 0.0},
    # --- spectrum (presets.conf:346-348) ---
    "spectrum": {"demod": "spectrum"},
}


def preset_table() -> dict[str, dict]:
    """A fresh (copyable) preset table."""
    return {k: dict(v) for k, v in PRESETS.items()}
