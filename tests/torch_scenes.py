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


# complex masters that are not whole 128-bin tiles: an RTL-SDR at 2.4 Msps
# (N 60,000) and a Funcube Pro+ at 192 ksps (N 4,800)
ODD_RATES = (2_400_000, 192_000)


def odd_master_groups(rt, fs: int):
    """NBFM and USB channels at 2.4 Msps, USB and I/Q at 192 ksps: each
    group takes the per-element channelizer and per-element noise windows."""
    ch = rt.ChannelSpec
    if fs == 2_400_000:
        return [rt.GroupSpec(name="nbfm", demod="fm", samprate=24_000, channels=tuple(
                    ch(freq=f, low=-8000, high=8000) for f in (-1.05e6, -300e3, 250e3, 1.07e6))),
                rt.GroupSpec(name="usb", demod="linear", samprate=12_000, channels=(
                    ch(freq=600e3, low=50, high=3000), ch(freq=-900e3, low=50, high=3000)))]
    return [rt.GroupSpec(name="usb", demod="linear", samprate=12_000, channels=(
                ch(freq=30e3, low=50, high=3000), ch(freq=-60e3, low=50, high=3000),
                ch(freq=90e3, low=50, high=3000))),
            rt.GroupSpec(name="iq", demod="iq", samprate=12_000, channels=(
                ch(freq=-20e3, low=-5000, high=5000),))]


def odd_master_block(b: int, L: int, fs: int, rng) -> np.ndarray:
    """At 2.4 Msps 1 kHz FM at 2.5 kHz deviation on the -300 kHz channel and
    a tone 700 Hz above the 600 kHz dial; at 192 ksps tones 700 Hz above the
    30 kHz dial and 1 kHz above -20 kHz; over noise."""
    t = np.arange(b * L, (b + 1) * L) / fs
    x = 1e-3 * (rng.standard_normal(L) + 1j * rng.standard_normal(L))
    if fs == 2_400_000:
        x += 0.1 * np.exp(1j * (2 * np.pi * -300e3 * t + 2.5 * np.sin(2 * np.pi * 1000 * t)))
        x += 0.05 * np.exp(2j * np.pi * (600e3 + 700) * t)
    else:
        x += 0.05 * np.exp(2j * np.pi * (30e3 + 700) * t)
        x += 0.05 * np.exp(2j * np.pi * (-20e3 + 1000) * t)
    return x.astype(np.complex64)


def multi_chans(rt, B: int, per: int = 4, lo: float = 50.0, hi: float = 3000.0):
    """`per` channels from -400 to 400 kHz on each of B inputs, input by
    input (tests/test_multife.py's layout)."""
    return tuple(rt.ChannelSpec(freq=float(f), low=lo, high=hi, input=b)
                 for b in range(B) for f in np.linspace(-400e3, 400e3, per))


def multi_blocks(nblocks: int, B: int, L: int, seed: int = 0, fs: float = CFS) -> np.ndarray:
    """[nblocks, B, L] complex64: noise on every input, and on input b a
    carrier 700 + 1000 b Hz above the b-th of multi_chans' four dials."""
    rng = np.random.default_rng(seed)
    x = 1e-3 * (rng.standard_normal((nblocks, B, L)) + 1j * rng.standard_normal((nblocks, B, L)))
    t = np.arange(nblocks * L).reshape(nblocks, 1, L) / fs
    for b in range(B):
        f = np.linspace(-400e3, 400e3, 4)[b % 4] + 700.0 + 1000.0 * b
        x[:, b:b + 1] += 0.05 * np.exp(2j * np.pi * f * t)
    return x.astype(np.complex64)


# two sig_gen front ends on one daemon (tests/test_multife.py's), their
# channels bound by section and by numbered sub-list
TWO_FE = """
[global]
hardware = fe0 fe1
status = 127.0.0.1
data = 127.0.0.1
update = 3
{opts}
[fe0]
device = sig_gen
samprate = 1m024
complex = yes
carrier = 100k
amplitude = -20
noise = -90

[fe1]
device = sig_gen
samprate = 1m024
complex = yes
carrier = 200k
amplitude = -40
noise = -90

[chan-a]
hardware = fe0
demod = am
samprate = 16k
low = -5k
high = 5k
freq = 100k

[chan-b]
hardware = fe1
demod = am
samprate = 16k
low = -5k
high = 5k
freq = 200k

[usb]
mode = usb
samprate = 16k
freq0 = 150k
hardware0 = fe0
freq1 = 151k
hardware1 = fe1
"""


def two_fe_blocks(n: int, L: int, seed: int, lead=()) -> np.ndarray:
    """[n, *lead, 2, L]: fe0 a -20 dBFS carrier at 100 kHz and a tone 700 Hz
    above 150 kHz, fe1 a -40 dBFS carrier at 200 kHz and a tone 1 kHz above
    151 kHz, over noise."""
    rng = np.random.default_rng(seed)
    shape = (n,) + tuple(lead) + (2, L)
    x = 1e-4 * (rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
    t = np.arange(int(np.prod(shape[:-2])) * L).reshape(shape[:-2] + (1, L)) / CFS
    x[..., 0:1, :] += 0.1 * np.exp(2j * np.pi * 100e3 * t) + 0.02 * np.exp(2j * np.pi * 150_700 * t)
    x[..., 1:2, :] += 0.01 * np.exp(2j * np.pi * 200e3 * t) + 0.02 * np.exp(2j * np.pi * 152e3 * t)
    return x.astype(np.complex64)
