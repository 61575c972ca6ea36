"""The port's host clients (ka9q_radio_tpu_torch/cli/) over real loopback
against a running daemon: test_cli.py's client tests, each parametrised over
both daemons (radiod-tpu's Radiod and radiod-torch's on the CPU), with the
JAX package's tune and pcmrecord crossed against radiod-torch and the port's
against radiod-tpu. Also the flag surface of all 25 `*-torch` twins against
their `*-tpu` scripts, fft-gen-torch's cold start and its log, the pure
renderers, set-xcvr-torch, and that a host client imports no torch."""
import argparse
import importlib
import io
import os
import re
import subprocess
import sys
import threading
import time
import tomllib
import wave
from contextlib import redirect_stdout
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
PKG = {"tpu": "ka9q_radio_tpu", "torch": "ka9q_radio_tpu_torch"}
_UNIQ = f"{os.getpid()}"


def cli(pkg: str, name: str):
    return importlib.import_module(f"{PKG[pkg]}.cli.{name}")


def _conf(tag: str) -> str:
    return f"""
[global]
hardware = sig_gen
status = test-{tag}.local
data = test-pcm-{tag}.local
mode = usb
update = 5
ttl = 1

[sig_gen]
device = sig_gen
carrier = 201k0
amplitude = -20
noise = -130
samprate = 1m024
real = no

[hf]
mode = usb
samprate = 16k
freq = 200k0

[spect]
mode = spectrum
samprate = 32k
resolution-bw = 500
bin-count = 64
freq = 201k0
ssrc = 9000
"""


def _radiod(pkg: str, text: str):
    config = importlib.import_module(f"{PKG[pkg]}.config")
    radiod = importlib.import_module(f"{PKG[pkg]}.runtime.radiod")
    kw = {"device": "cpu"} if pkg == "torch" else {}
    return radiod.Radiod(config.load_config(text), use_network=True, **kw)


class _Running:
    """A Radiod stepping on a thread until stop()."""

    def __init__(self, rd):
        self.rd, self._stop = rd, threading.Event()
        self._th = threading.Thread(target=self._run, daemon=True)
        self._th.start()

    def _run(self):
        while not self._stop.is_set():
            self.rd.step_block()

    def wait_blocks(self, n: int, timeout: float = 60.0):
        deadline = time.monotonic() + timeout
        while self.rd.blocks < n and time.monotonic() < deadline:
            time.sleep(0.05)
        assert self.rd.blocks >= n, f"daemon made {self.rd.blocks} blocks"

    def stop(self):
        self._stop.set()
        self._th.join(timeout=10)


@pytest.fixture(scope="module", params=["tpu", "torch"])
def daemon(request):
    """(daemon package, its Radiod, stream tag): one daemon of each package
    on stream names unique to the run and the package."""
    tag = f"{request.param}-{_UNIQ}"
    run = _Running(_radiod(request.param, _conf(tag)))
    run.wait_blocks(8)
    yield request.param, run.rd, tag
    run.stop()


# ------------------------------------------------ clients against daemons
@pytest.mark.parametrize("client", ["tpu", "torch"])
def test_tune_cli(daemon, client, capsys):
    _, rd, tag = daemon
    rc = cli(client, "tune").main(["--radio", f"test-{tag}.local", "--ssrc", "200",
                                   "--timeout", "5"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "RADIO_FREQUENCY" in out and "200000" in out


def test_setfilt_cli(daemon, capsys):
    _, rd, tag = daemon
    rc = cli("torch", "tune").main_setfilt(["--radio", f"test-{tag}.local", "--ssrc", "200",
                                            "--timeout", "5", "2k8", "m2k8"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "LOW_EDGE" in out and "-2800" in out and "HIGH_EDGE" in out


def test_control_cli_retune(daemon, capsys):
    _, rd, tag = daemon
    main = cli("torch", "control").main
    rc = main(["--radio", f"test-{tag}.local", "--ssrc", "200", "-c", "f 202k0", "-c", "poll"])
    assert rc == 0
    assert "202000" in capsys.readouterr().out
    assert rd.chans[200].freq == 202_000.0
    main(["--radio", f"test-{tag}.local", "--ssrc", "200", "-c", "f 200k0"])


def test_powers_cli(daemon, capsys):
    _, rd, tag = daemon
    rc = cli("torch", "powers").main(["--radio", f"test-{tag}.local", "--ssrc", "9000",
                                      "--timeout", "5"])
    assert rc == 0
    parts = capsys.readouterr().out.strip().split(",")
    assert int(parts[5]) == 64  # bin count
    dbs = np.array([float(x) for x in parts[6:]])
    assert dbs.size == 64
    # the carrier at the channel centre: the peak bin near the middle, ~-20 dBFS
    assert abs(int(np.argmax(dbs)) - 32) <= 1
    assert abs(dbs.max() + 20.0) < 3.0


@pytest.mark.parametrize("client", ["tpu", "torch"])
def test_pcmrecord_cli(daemon, client, tmp_path):
    _, rd, tag = daemon
    rc = cli(client, "pcmrecord").main(["--data", f"test-pcm-{tag}.local",
                                        "--status", f"test-{tag}.local", "--duration", "2",
                                        "--dir", str(tmp_path), "--ssrc", "200"])
    assert rc == 0
    paths = sorted(tmp_path.glob("*_ssrc200.wav"))
    assert paths, list(tmp_path.iterdir())
    with wave.open(str(paths[0])) as w:
        assert w.getframerate() == 16_000 and w.getnchannels() == 1
        n = w.getnframes()
        data = np.frombuffer(w.readframes(n), "<i2").astype(np.float32) / 32767.0
    assert n > 16_000  # at least a second of audio
    spec = np.abs(np.fft.rfft(data * np.hanning(data.size)))
    f = np.fft.rfftfreq(data.size, 1 / 16_000)
    assert abs(f[np.argmax(spec)] - 1000.0) < 20.0  # the USB tone


def test_monitor_cli(daemon, capsys):
    _, rd, tag = daemon
    rc = cli("torch", "monitor").main(["--data", f"test-pcm-{tag}.local",
                                       "--status", f"test-{tag}.local", "--duration", "2",
                                       "--quiet"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "ssrc 200" in out and "drops" in out


def test_control_full_surface(daemon, capsys):
    """Preset switch, PLL, AGC knobs, squelch, and the panel renderer."""
    pkg, rd, tag = daemon
    control = cli("torch", "control")
    radio = f"test-{tag}.local"
    rc = control.main(["--radio", radio, "--ssrc", "200", "-c", "mode pm", "-c", "poll"])
    assert rc == 0
    assert "pm" in capsys.readouterr().out.lower()
    assert rd.engine.groups[rd.chans[200].group].spec.demod == "fm"
    rc = control.main(["--radio", radio, "--ssrc", "200", "-c", "mode usb", "-c", "agc off",
                       "-c", "gain 12", "-c", "sqopen 9", "-c", "beta 6.5", "-c", "panel"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "== Tuning" in out and "== Demodulator" in out
    ch = rd.chans[200]
    assert rd.engine.groups[ch.group].spec.demod == "linear"
    assert ch.kaiser_beta == 6.5
    f, _ = control.Controller(radio, 200).transact({})
    lines = control.render_panel(f)
    assert any(ln.startswith("  freq ") and "200,000.000" in ln for ln in lines)
    assert any("edges" in ln for ln in lines)
    control.main(["--radio", radio, "--ssrc", "200", "-c", "agc on", "-c", "f 200k0"])
    capsys.readouterr()


def test_showsig_polls_channel(daemon, capsys):
    _, rd, tag = daemon
    rc = cli("torch", "showsig").main(["--radio", f"test-{tag}.local", "--ssrc", "200",
                                       "--count", "2", "--interval", "0.2", "--timeout", "5"])
    assert rc == 0
    lines = [l for l in capsys.readouterr().out.splitlines() if "Hz" in l]
    assert len(lines) == 2
    assert "200000 Hz" in lines[0]
    bb = float(lines[0].split("bb")[1].split("dB")[0])
    n0 = float(lines[0].split("n0")[1].split("dB/Hz")[0])
    assert bb > n0, (bb, n0)


def test_metadump_cli(daemon):
    _, rd, tag = daemon
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = cli("torch", "metadump").main(["--radio", f"test-{tag}.local", "--all",
                                            "--ssrc", "200", "--count", "1", "--timeout", "5"])
    assert rc == 0
    assert "OUTPUT_SSRC = 200" in buf.getvalue()


@pytest.mark.parametrize("pkg", ["tpu", "torch"])
def test_client_flag_parity(pkg, tmp_path):
    """tune --mode/--samprate/--lifetime create and shape a dynamic channel;
    powers -f/-b/-w create a spectrum sweep from nothing (powers.c);
    metadump --all polls the all-channel dump and --ssrc filters it: the
    port's clients against each daemon."""
    tag = f"flags-{pkg}-{_UNIQ}"
    rd = _radiod(pkg, f"""
[global]
hardware = sig_gen
status = {tag}-st.local
data = {tag}-pcm.local
advertise = no
sap = no
dyn-slots = 2
[sig_gen]
device = sig_gen
samprate = 512k
complex = yes
carrier = 51k
amplitude = -20
[hf]
mode = usb
samprate = 12k
freq = 50k0
""")
    for _ in range(2):
        rd.step_block()
    run = _Running(rd)
    try:
        radio = f"{tag}-st.local"
        deadline = time.time() + 30

        def applied():  # the LAST key apply_command sets, so no mid-apply peek
            ch = rd.chans.get(900)
            return ch is not None and ch.samprate == 24_000 and ch.lifetime_init == 60 * 50
        while time.time() < deadline and not applied():
            cli("torch", "tune").main(["--radio", radio, "--ssrc", "900", "-f", "49k5", "-m", "am",
                                       "-r", "24k", "--lifetime", "60", "--timeout", "1"])
        ch = rd.chans[900]
        assert ch.preset == "am" and ch.samprate == 24_000 and ch.lifetime_init == 60 * 50
        buf, rc = io.StringIO(), 1
        while time.time() < deadline and rc != 0:
            with redirect_stdout(buf):
                rc = cli("torch", "powers").main(["--radio", radio, "--ssrc", "901", "-f", "51k0",
                                                  "-b", "24", "-w", "500", "--count", "1",
                                                  "--timeout", "2"])
        assert rc == 0
        line = [l for l in buf.getvalue().splitlines() if "," in l][-1]
        assert int(line.split(",")[5]) == 24
        assert rd.chans[901].preset == "spectrum"
        buf = io.StringIO()
        with redirect_stdout(buf):
            cli("torch", "metadump").main(["--radio", radio, "--all", "--ssrc", "900",
                                           "--count", "2", "--timeout", "5"])
        out = buf.getvalue()
        assert "OUTPUT_SSRC = 900" in out and "OUTPUT_SSRC = 901" not in out
    finally:
        run.stop()


# ------------------------------------------------------------ the surface
def _scripts():
    proj = tomllib.loads((ROOT / "pyproject.toml").read_text())["project"]["scripts"]
    pairs = []
    for name, target in proj.items():
        if name.endswith("-tpu") and name != "radiod-tpu":
            twin = name[:-4] + "-torch"
            assert proj.get(twin) == target.replace("ka9q_radio_tpu.", "ka9q_radio_tpu_torch."), twin
            pairs.append((name, target, proj[twin]))
    return pairs


SCRIPTS = _scripts()
# the two entry points that put work on the card take a device, as radiod-torch does
DEVICE_FLAG = {"stereod-tpu", "fft-gen-tpu"}


class _Parsed(Exception):
    pass


def _flags(target: str, monkeypatch) -> tuple:
    """Every option string and positional of the parser that `target`'s
    main builds (caught at parse_args, before any work)."""
    seen = []

    def grab(self, *a, **k):
        seen.append(self)
        raise _Parsed

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", grab)
    mod, fn = target.split(":")
    with pytest.raises(_Parsed):
        getattr(importlib.import_module(mod), fn)([])
    monkeypatch.undo()
    ap = seen[0]

    def norm(a):
        # fft-gen's --wisdom default names each package's own directory
        default = None if a.option_strings == ["--wisdom"] else a.default
        return repr((tuple(a.option_strings) or (a.dest,), a.dest, a.nargs, a.required,
                     type(a).__name__, a.choices, getattr(a.type, "__name__", a.type),
                     a.const, default))
    return ap.prog, sorted(norm(a) for a in ap._actions)


def test_every_script_has_a_torch_twin():
    assert len(SCRIPTS) == 25


@pytest.mark.parametrize("name,jtarget,ttarget", SCRIPTS, ids=[s[0] for s in SCRIPTS])
def test_torch_twin_flags_match(name, jtarget, ttarget, monkeypatch):
    jprog, jflags = _flags(jtarget, monkeypatch)
    tprog, tflags = _flags(ttarget, monkeypatch)
    assert tprog == jprog.replace("-tpu", "-torch")
    if name in DEVICE_FLAG:
        extra = [f for f in tflags if f.startswith("(('--device',)")]
        assert len(extra) == 1
        tflags = [f for f in tflags if f not in extra]
    assert tflags == jflags


def test_host_clients_import_no_torch():
    mods = [t.split(":")[0] for n, _, t in SCRIPTS if n not in DEVICE_FLAG]
    mods += ["ka9q_radio_tpu_torch.net.playout", "ka9q_radio_tpu_torch.net.ogg",
             "ka9q_radio_tpu_torch.config.bandplan", "ka9q_radio_tpu_torch.daemons.rds"]
    code = ("import sys\n" + "".join(f"import {m}\n" for m in sorted(set(mods)))
            + "assert 'torch' not in sys.modules, 'torch imported'\n"
              "from ka9q_radio_tpu_torch.config.bandplan import band_name\n"
              "assert band_name(14.074e6)\n"
              "assert 'torch' not in sys.modules\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                       timeout=60)
    assert r.returncode == 0, r.stderr
    r = subprocess.run([sys.executable, "-c", "import sys, ka9q_radio_tpu_torch.cli.tune; "
                        "sys.exit('torch' in sys.modules)"], cwd=ROOT, timeout=60)
    assert r.returncode == 0


@pytest.mark.parametrize("mod", ["ka9q_radio_tpu_torch.runtime.engine",
                                 "ka9q_radio_tpu_torch.ops.cuda_channelize",
                                 "ka9q_radio_tpu_torch.ops.cuda_recur",
                                 "ka9q_radio_tpu_torch.runtime.radiod",
                                 "ka9q_radio_tpu_torch.runtime.source",
                                 "ka9q_radio_tpu_torch.models.wfm"])
def test_device_paths_run_with_tf32_off(mod):
    """Every engine and kernel path turns TF32 off, even where the caller
    turned it on first (the channelizer's 3e-5 parity needs full FP32)."""
    code = ("import torch\n"
            "torch.backends.cuda.matmul.allow_tf32 = True\n"
            "torch.backends.cudnn.allow_tf32 = True\n"
            f"import {mod}\n"
            "assert not torch.backends.cuda.matmul.allow_tf32\n"
              "assert not torch.backends.cudnn.allow_tf32\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stderr


def test_panel_digit_columns_and_windows():
    control = cli("torch", "control")
    from ka9q_radio_tpu.cli.control import render_panel as jrender
    from ka9q_radio_tpu.net.status import StatusType as JT
    from ka9q_radio_tpu_torch.net.status import StatusType as T

    freq = 14_074_000.0
    cols = dict((int(round(np.log10(s))), c) for c, s in control.freq_digit_columns(freq)
                if s >= 1)
    s = f"{freq:>{control.FREQ_WIDTH},.3f}"
    for place, col in cols.items():
        assert s[col - control.FREQ_COL].isdigit()
    assert s[cols[7] - control.FREQ_COL] == "1" and s[cols[0] - control.FREQ_COL] == "0"
    fields = {T.OUTPUT_SSRC: 5, T.RADIO_FREQUENCY: freq, T.DEMOD_TYPE: 0, T.AGC_ENABLE: True,
              T.INPUT_SAMPRATE: 129_600_000, T.FE_ISREAL: True}
    lines = control.render_panel(fields)
    text = "\n".join(lines)
    for win in ("Tuning", "Input", "Signal", "Filtering", "Demodulator", "Options", "Output",
                "RTP/Status", "Presets"):
        assert f"== {win} " in text, win
    assert "[a:agc]" in text and " l:pll " in text
    for p in control.PANEL_PRESETS:
        assert p in lines[-1]
    assert lines[control.FREQ_ROW].startswith("  freq ")
    assert lines == jrender({JT(int(k)): v for k, v in fields.items()})


def _read_lines(fd: int, n: int, timeout: float = 10.0) -> str:
    """What arrives on fd until n whole lines have (a read may return part
    of what the writer sent), or the deadline passes."""
    import select

    data, deadline = b"", time.monotonic() + timeout
    while data.replace(b"\r", b"").count(b"\n") < n:
        left = deadline - time.monotonic()
        if left <= 0 or not select.select([fd], [], [], left)[0]:
            break
        data += os.read(fd, 4096)
    return data.decode()


def test_set_xcvr(tmp_path):
    """set-xcvr-torch: the SA818 programmer over a pty and the PTT keyer
    through an injectable sysfs root."""
    import pty

    set_xcvr = cli("torch", "set_xcvr")
    conf = tmp_path / "xcvr.conf"
    conf.write_text("[radio]\nserial = IGNORED\ntxfreq = 147.36\nrxfreq = 146.76\ntxtone = 123\n"
                    "squelch = 2\nlowpower = yes\nbusylock = yes\ntxgain = 7\nvox = 0\n"
                    "sleep = 1000\n")
    mfd, sfd = pty.openpty()
    assert set_xcvr.main(["-f", str(conf)], gpio_root=str(tmp_path / "nogpio"),
                         serial_opener=lambda port: sfd) == 0
    data = _read_lines(mfd, 5)
    os.close(mfd)
    lines = [l for l in data.replace("\r", "").split("\n") if l]
    assert lines[:5] == ["AT+DMOSETGROUP=1,147.3600,146.7600,0,2,123,5", "AT+DMOSETMIC=7,0",
                         "AT+DMOAUTOPOWCONTR=1", "AT+DMOSETVOLUME=1", "AT+DMOSETVOX=0"]
    root = tmp_path / "gpio"
    for pin in (20, 21):
        (root / f"gpio{pin}").mkdir(parents=True)
    (root / "export").write_text("")
    assert set_xcvr.main(["txon"], gpio_root=str(root)) == 0
    assert (root / "gpio20" / "value").read_text() == "0"
    assert (root / "gpio21" / "value").read_text() == "1"
    assert set_xcvr.main(["txoff"], gpio_root=str(root)) == 0
    assert (root / "gpio20" / "value").read_text() == "1"
    assert set_xcvr.main(["bogus"], gpio_root=str(root)) == 64


# ------------------------------------------------------------- fft-gen
WARM_CONF = """
[global]
hardware = sig_gen
mode = usb
[sig_gen]
device = sig_gen
samprate = 128k
complex = yes
carrier = 33k
amplitude = -20
noise = -140
[hf]
mode = usb
samprate = 8k
freq = 32k0
"""


def test_fftgen_needs_cuda_unless_told(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    cfile = tmp_path / "warm.conf"
    cfile.write_text(WARM_CONF)
    from ka9q_radio_tpu_torch.cli.fftgen import main

    with pytest.raises(RuntimeError, match="CUDA"):
        main([str(cfile), "--wisdom", str(tmp_path / "w")])


def test_fftgen_warms_and_logs_cold_starts(tmp_path, capsys):
    """fft-gen-torch runs a config's cold start through the production
    Radiod (the native edge's build, the first step); a slow cold start
    appends to <wisdom>/fft.log, and config-less fft-gen-torch warms what
    the log names; `wisdom = no` writes no log."""
    from ka9q_radio_tpu_torch.cli.fftgen import main
    from ka9q_radio_tpu_torch.config import load_config
    from ka9q_radio_tpu_torch.native.edge import _BUILD_DIR
    from ka9q_radio_tpu_torch.runtime.radiod import Radiod

    cfile = tmp_path / "warm.conf"
    cfile.write_text(WARM_CONF)
    wisdom = tmp_path / "wisdom"
    assert main([str(cfile), "--wisdom", str(wisdom), "--device", "cpu"]) == 0
    err = capsys.readouterr().err
    assert re.search(r"compiled master N=\d+ \+ 1 channels in [\d.]+s", err), err
    assert list(Path(_BUILD_DIR).glob("librtp_edge-*.so"))
    cfg = load_config(str(cfile))
    cfg.options["wisdom"] = str(wisdom)
    rd = Radiod(cfg, use_network=False, device="cpu")
    rd.FFT_LOG_THRESHOLD = 0.0  # CPU cold starts are fast; force the log
    rd.step_block()
    rd.step_block()  # only the first block logs
    lines = (wisdom / "fft.log").read_text().splitlines()
    assert len(lines) == 1 and lines[0].endswith(f"config={cfile}")
    assert re.match(r"\d{4}-\d\d-\d\dT\d\d:\d\d:\d\d [\d.]+s N=\d+ config=", lines[0])
    assert main(["--wisdom", str(wisdom), "--device", "cpu"]) == 0  # warm from the log
    assert "compiled master" in capsys.readouterr().err
    assert main(["--wisdom", str(tmp_path / "empty")]) == 1
    for off in ("no", "off"):
        cfg.options["wisdom"] = off
        rd = Radiod(cfg, use_network=False, device="cpu")
        rd.FFT_LOG_THRESHOLD = 0.0
        rd.step_block()
        assert not (Path(off) / "fft.log").exists()
