"""Scenes shared by the port's tests on the CPU and on the card: every
demodulator on one complex master, and a block of signals for it. Imports
neither jax nor the JAX package, so the card's tests can use it."""
import numpy as np

CFS = 1_024_000  # a complex master, as bench.py's linear8


def demod_groups(rt):
    """Every demodulator on one complex 1.024 Msps master."""
    ch = rt.ChannelSpec
    return [
        rt.GroupSpec(name="fm", demod="fm", samprate=24_000, ctcss=True, threshold_extend=True,
                     channels=(ch(freq=100e3, low=-8000, high=8000, tone_freq=100.0),
                               ch(freq=-150e3, low=-8000, high=8000, tone_freq=103.5))),
        rt.GroupSpec(name="wfm", demod="wfm", samprate=384_000,
                     channels=(ch(freq=300e3, low=-100e3, high=100e3),)),
        rt.GroupSpec(name="sam", demod="sam", samprate=12_000,
                     channels=(ch(freq=50e3, low=-5000, high=5000),)),
        rt.GroupSpec(name="iq", demod="iq", samprate=12_000,
                     channels=(ch(freq=60e3, low=-5000, high=5000),)),
        rt.GroupSpec(name="isb", demod="linear", isb=True, filter2=1, stereo=True,
                     samprate=12_000, channels=(ch(freq=80e3, low=-5000, high=5000),)),
        rt.GroupSpec(name="cwu", demod="linear", filter2=4, samprate=12_000,
                     channels=(ch(freq=-90e3, low=-200, high=200, shift_hz=500.0),)),
        rt.GroupSpec(name="spec", demod="spectrum", samprate=12_000, bin_bw=50.0, bin_count=64,
                     channels=(ch(freq=100e3),)),
    ]


def demod_block(b: int, L: int, rng) -> np.ndarray:
    """FM with a 1 kHz tone and a 100 Hz CTCSS tone at 100 kHz, a stereo
    WFM composite at 300 kHz, an AM carrier 3 Hz off at 50 kHz, tones 1 kHz
    above and 1.5 kHz below the 80 kHz ISB dial, a CW carrier 500 Hz above
    the -90 kHz dial, over noise."""
    t = np.arange(b * L, (b + 1) * L) / CFS
    x = 1e-3 * (rng.standard_normal(L) + 1j * rng.standard_normal(L))
    fm = 2500 / 1000 * np.sin(2 * np.pi * 1000 * t) + 300 / 100 * np.sin(2 * np.pi * 100 * t)
    x += 0.1 * np.exp(2j * np.pi * (100e3 * t + fm))
    x += 0.1 * np.exp(1j * (2 * np.pi * 300e3 * t + stereo_phase(t)))
    x += 0.1 * (1 + 0.5 * np.cos(2 * np.pi * 700 * t)) * np.exp(2j * np.pi * (50e3 + 3) * t)
    x += 0.05 * np.exp(2j * np.pi * (80e3 + 1000) * t) + 0.03 * np.exp(2j * np.pi * (80e3 - 1500) * t)
    x += 0.02 * np.exp(2j * np.pi * (-90e3 + 500) * t)
    return x.astype(np.complex64)


def stereo_phase(t):
    """FM phase (rad) of a stereo composite at 75 kHz peak deviation: L =
    700 Hz, R = 1,100 Hz, the 19 kHz pilot, L-R on the 38 kHz subcarrier;
    the exact integrals of its tones."""
    return 2 * np.pi * 75e3 * (0.225 * (-np.cos(2 * np.pi * 700 * t) / (2 * np.pi * 700)
                                        - np.cos(2 * np.pi * 1100 * t) / (2 * np.pi * 1100))
                               + 0.1 * -np.cos(2 * np.pi * 19e3 * t) / (2 * np.pi * 19e3)
                               + 0.225 * dsb_integral(t))


def dsb_integral(t):
    """Integral of (sin 700 - sin 1100)(2 pi t) sin(2 pi 38 kHz t) dt."""
    g = 38e3
    return sum(sgn * (np.sin(2 * np.pi * (f - g) * t) / (4 * np.pi * (f - g))
                      - np.sin(2 * np.pi * (f + g) * t) / (4 * np.pi * (f + g)))
               for f, sgn in ((700.0, 1.0), (1100.0, -1.0)))
