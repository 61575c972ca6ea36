"""The port's systemd units (service/torch/): the twin of
tests/test_config.py::test_service_units_reference_real_tools. Every
ExecStart and ExecStartPre calls a `*-torch` console script this package
installs, with long flags its argparse defines; the daemon's unit can open
the card's device nodes; and the JAX test's glob (service/*.service) still
sees the JAX package's units alone."""
import configparser
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
UNITS = sorted((ROOT / "service" / "torch").glob("*.service"))


def _scripts() -> dict:
    scripts = {}
    for line in (ROOT / "pyproject.toml").read_text().splitlines():
        m = re.match(r'([\w-]+) = "([\w.]+):\w+"', line.strip())
        if m:
            scripts[m.group(1)] = m.group(2)
    return scripts


def _unit(path: Path) -> configparser.ConfigParser:
    cp = configparser.ConfigParser(strict=False, interpolation=None)
    cp.optionxform = str
    cp.read(path)
    return cp


def test_every_jax_unit_has_a_twin():
    names = {p.name.replace("-torch", "-tpu") for p in UNITS}
    assert names == {p.name for p in (ROOT / "service").glob("*.service")}
    assert (ROOT / "service" / "torch" / "fft-gen-torch.timer").is_file()
    assert not list((ROOT / "service").glob("*-torch*"))


@pytest.mark.parametrize("unit", UNITS, ids=lambda p: p.name)
def test_unit_calls_port_scripts_with_real_flags(unit):
    scripts = _scripts()
    cp = _unit(unit)
    assert cp.has_section("Service") and cp.has_section("Install")
    cmds = [cp.get("Service", k) for k in ("ExecStart", "ExecStartPre")
            if cp.has_option("Service", k)]
    assert cmds
    for line in cmds:
        cmd = line.lstrip("-").split()
        tool = Path(cmd[0]).name
        assert tool.endswith("-torch") and tool in scripts, f"{unit.name}: {tool}"
        src = (ROOT / (scripts[tool].replace(".", "/") + ".py")).read_text()
        for arg in cmd[1:]:
            if arg.startswith("--"):
                flag = arg.split("=")[0]
                assert f'"{flag}"' in src, f"{unit.name}: {tool} lacks {flag}"


def test_daemon_unit_can_open_the_card():
    cp = _unit(ROOT / "service" / "torch" / "radiod-torch@.service")
    svc = dict(cp.items("Service"))
    assert svc.get("PrivateDevices", "no").lower() not in ("yes", "true", "1", "on")
    if "DevicePolicy" in svc:
        assert "DeviceAllow" in svc
    pre = svc["ExecStartPre"].split()
    assert Path(pre[0]).name == "fft-gen-torch" and pre[1] == "/etc/radio/radiod@%i.conf"
    assert Path(svc["ExecStart"].split()[0]).name == "radiod-torch"
