"""The port's utils/parse.py and utils/units.py against the JAX package's:
parse_frequency on tests/test_windows.py:42's cases with their signs and
suffix infixes, exact; the four unit conversions on float32 inputs,
exact."""
import numpy as np
import pytest

from ka9q_radio_tpu.utils import parse as jparse
from ka9q_radio_tpu.utils import units as junits
from ka9q_radio_tpu_torch.utils import parse as tparse
from ka9q_radio_tpu_torch.utils import units as tunits

# tests/test_windows.py:42's spellings, then other infixes and plain forms
CASES = ["147m435", "10.1m", "760k", "1g296", "12345", "14.074", "7040", "446", "0", "1k",
         "2m4", "3.5M", "7K074", "10G", "28.4", "1.2e6", "50m313", "0.5", "9999", "100000"]


@pytest.mark.parametrize("heuristic", [False, True])
@pytest.mark.parametrize("sign", ["", "-", "+"])
def test_parse_frequency_matches_jax(sign, heuristic):
    for case in CASES:
        s = sign + case
        try:
            want = jparse.parse_frequency(s, default_heuristic=heuristic)
        except Exception as e:  # noqa: BLE001 - the port must refuse it the same way
            with pytest.raises(type(e)):
                tparse.parse_frequency(s, default_heuristic=heuristic)
            continue
        got = tparse.parse_frequency(s, default_heuristic=heuristic)
        assert got == want and type(got) is type(want), (s, got, want)


def test_parse_frequency_known_values():
    """tests/test_windows.py:42's assertions on the port."""
    p = tparse.parse_frequency
    assert p("147m435") == pytest.approx(147.435e6)
    assert p("10.1m") == pytest.approx(10.1e6)
    assert p("760k") == pytest.approx(760e3)
    assert p("1g296") == pytest.approx(1.296e9)
    assert p("12345") == pytest.approx(12345.0)
    assert p("14.074", default_heuristic=True) == pytest.approx(14.074)
    assert p("7040", default_heuristic=True) == pytest.approx(7.04e6)
    assert p("446", default_heuristic=True) == pytest.approx(446e6)


@pytest.mark.parametrize("fn", ["power_to_dB", "dB_to_power", "voltage_to_dB", "dB_to_voltage"])
def test_units_match_jax(fn):
    """tests/test_windows.py:57's conversions on float32 arrays and Python
    floats from a seed: the same values and dtypes."""
    rng = np.random.default_rng(4)
    if fn.endswith("_to_dB"):
        x = (10.0 ** rng.uniform(-12, 6, 257)).astype(np.float32)
    else:
        x = rng.uniform(-150, 60, 257).astype(np.float32)
    jf, tf = getattr(junits, fn), getattr(tunits, fn)
    got, want = np.asarray(tf(x)), np.asarray(jf(x))
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    for v in (float(x[0]), float(x[-1]), 100.0, 3.0):
        assert tf(v) == jf(v)
    want = {"power_to_dB": (100.0, 20.0), "dB_to_power": (3.0, 1.9952623),
            "voltage_to_dB": (10.0, 20.0), "dB_to_voltage": (6.0, 1.9952623)}[fn]
    assert tf(want[0]) == pytest.approx(want[1])
