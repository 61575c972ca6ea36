"""The port's config loader against the JAX package's: every example config
and the README quick start load to equal RadiodConfigs, field by field, and
the loader's fuzz runs against the port."""
import dataclasses
import re
from pathlib import Path

import pytest

from ka9q_radio_tpu.config import load_config as jload
from ka9q_radio_tpu.config import presets as jpresets
from ka9q_radio_tpu_torch.config import load_config as tload
from ka9q_radio_tpu_torch.config import presets as tpresets

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = sorted((ROOT / "examples").glob("*.conf"))


def _readme_quick_start() -> str:
    text = (ROOT / "README.md").read_text()
    m = re.search(r"cat > radiod.conf <<'EOF'\n(.*?)\nEOF", text, re.S)
    assert m, "README quick start config not found"
    return m.group(1)


def _fields(obj):
    """A dataclass (GroupSpec, ChannelSpec, SigGenConfig) as a plain value,
    so the two packages' classes compare field by field."""
    if dataclasses.is_dataclass(obj):
        return {f.name: _fields(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    if isinstance(obj, (list, tuple)):
        return [_fields(x) for x in obj]
    if isinstance(obj, dict):
        return {k: _fields(v) for k, v in obj.items()}
    return obj


def assert_same_config(t, j):
    for f in dataclasses.fields(j):
        assert _fields(getattr(t, f.name)) == _fields(getattr(j, f.name)), f.name
    assert t.n_inputs == j.n_inputs
    assert [type(g).__module__ for g in t.groups] == \
        ["ka9q_radio_tpu_torch.runtime.engine"] * len(t.groups)


def test_presets_equal():
    assert tpresets.preset_table() == jpresets.preset_table()


@pytest.mark.parametrize("path", EXAMPLES, ids=[p.name for p in EXAMPLES])
def test_example_configs_load_equal(path):
    """The loader accepts every preset, as the JAX one does: the engine, not
    the loader, refuses what the port does not carry yet."""
    assert_same_config(tload(str(path)), jload(str(path)))


def test_readme_quick_start_loads_equal():
    text = _readme_quick_start()
    assert_same_config(tload(text), jload(text))


def test_config_fuzz_against_port():
    """tests/test_config.py's fuzz, against the port's loader: hostile text
    loads or raises a clean error, and where the JAX loader loads it, the
    port's loads it to the same config."""
    import configparser
    import random

    base = """
[global]
hardware = sig_gen
mode = usb
[sig_gen]
device = sig_gen
samprate = 512k
complex = yes
carrier = 101k
[usb]
mode = usb
samprate = 12k
freq = 100k3
"""
    ok = (ValueError, configparser.Error, OSError)
    rng = random.Random(1234)
    loaded = 0

    def attempt(text):
        nonlocal loaded
        try:
            t = tload(text)
        except ok as e:
            with pytest.raises(type(e)):
                jload(text)
            return
        assert_same_config(t, jload(text))
        loaded += 1

    for _ in range(40):
        attempt("".join(chr(rng.randrange(32, 127)) for _ in range(rng.randrange(0, 300))))
    for _ in range(40):
        attempt("".join(rng.choice("[]=\n#;ab:0 \t") for _ in range(rng.randrange(0, 400))))
    for _ in range(120):
        t = list(base)
        for _ in range(rng.randrange(1, 6)):
            i = rng.randrange(len(t))
            op = rng.random()
            if op < 0.4:
                t[i] = chr(rng.randrange(32, 127))
            elif op < 0.7:
                del t[i]
            else:
                t.insert(i, rng.choice("[]=\nkmg0123456789.-"))
        attempt("".join(t))
    hostile = ["", "-", "nan", "inf", "-inf", "1e309", "0x41", "999999999k",
               "yes no", "\x00", "🦊", "1/0", "None", "[global]", "=", "m", "k9"]
    for v in hostile:
        for key in ("12k", "100k3", "usb", "512k", "yes"):
            attempt(base.replace(key, v))
    assert loaded > 20, loaded
