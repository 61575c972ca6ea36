"""The port's daemon at its wall-clock and process edges, the twins of the JAX
package's tests of the same behaviour, on the CPU:

- `Radiod.run(realtime=True)` (tests/test_radiod.py:544): 8 blocks paced to
  the wall clock take at least 0.9 x 8 block times, with live min/avg/max
  block-time stats; eagerly and with `time-shards` (D blocks a dispatch),
  beside the JAX daemon paced alike (the same blocks and packets counted);
- `radiod-torch --device cpu` in a subprocess: SIGUSR1 turns on a running
  daemon's stats line (tests/test_cli.py:232), and `restart = 0` re-execs a
  daemon whose front end is fatal on its first block (tests/test_cli.py:428).
  Each subprocess runs under its own deadline (SUBPROCESS_S) and is killed
  on the way out."""
import os
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest
import torch

from ka9q_radio_tpu.config import load_config as jload
from ka9q_radio_tpu.runtime.radiod import Radiod as JRadiod
from ka9q_radio_tpu_torch.config import load_config as tload
from ka9q_radio_tpu_torch.runtime.radiod import Radiod as TRadiod
from test_radiod import CONF

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
SUBPROCESS_S = 30.0  # each subprocess test's deadline, from its start


# ------------------------------------------------------------ realtime pacing
def _paced(rd, nblocks: int = 8) -> float:
    t0 = time.monotonic()
    rd.run(nblocks=nblocks, realtime=True)
    return time.monotonic() - t0


@pytest.mark.parametrize("time_shards", [0, 4])
def test_realtime_pacing_matches_jax(time_shards):
    conf = CONF + (f"\n[global]\ntime-shards = {time_shards}\n" if time_shards else "")
    jr = JRadiod(jload(conf), use_network=False)
    tr = TRadiod(tload(conf), use_network=False, device="cpu")
    assert tr._time_shards == jr._time_shards == time_shards
    for rd in (jr, tr):
        rd.run(nblocks=12)  # past the cold start, as the JAX test's fixture
    bt = tr.cfg.blocktime
    elapsed = _paced(tr)
    assert elapsed >= 8 * bt * 0.9, (elapsed, bt)
    assert tr.t_min <= tr.t_avg <= tr.t_max, (tr.t_min, tr.t_avg, tr.t_max)
    assert tr.t_max < 8 * bt + 5.0
    assert _paced(jr) >= 8 * bt * 0.9
    # with time shards a dispatch is D blocks: k advances D a dispatch
    assert tr.blocks == jr.blocks == 20
    assert [k for k, _ in tr._sent] == [k for k, _ in jr._sent]
    assert f"block time avg {tr.t_avg * 1e3:.2f} ms" in tr.stats_line()


# ------------------------------------------------------------ the subprocess
def _spawn(conf: Path, *args: str, env: dict | None = None):
    """radiod-torch --device cpu on conf, its stderr collected line by line
    in the list returned beside the process."""
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": str(ROOT), **(env or {})}
    p = subprocess.Popen(
        [sys.executable, "-m", "ka9q_radio_tpu_torch.cli.radiod", "--device", "cpu", *args,
         str(conf)], env=env, stderr=subprocess.PIPE, text=True, cwd=str(ROOT))
    lines: list = []
    threading.Thread(target=lambda: [lines.append(ln) for ln in p.stderr], daemon=True).start()
    return p, lines


def _stop(p) -> None:
    if p.poll() is None:
        p.kill()
    p.wait(5)


SIG_CONF = """
[global]
hardware = sig_gen
mode = usb
[sig_gen]
device = sig_gen
samprate = 128k
complex = yes
carrier = 33k
amplitude = -20
[hf]
mode = usb
samprate = 8k
freq = 32k0
"""


def test_radiod_sigusr1_enables_stats(tmp_path):
    """tests/test_cli.py:232 on radiod-torch: a non-verbose daemon prints no
    stats line until SIGUSR1 raises its verbosity (main.c:204-212)."""
    conf = tmp_path / "sig.conf"
    conf.write_text(SIG_CONF)
    p, lines = _spawn(conf, "--no-network", "--flat-out")
    deadline = time.monotonic() + SUBPROCESS_S
    try:
        # the ready banner: the handlers are armed from then on
        while time.monotonic() < deadline and not any("channels ready" in ln for ln in lines):
            assert p.poll() is None, f"daemon died: {lines[-5:]}"
            time.sleep(0.1)
        assert any("channels ready on cpu" in ln for ln in lines), lines[-5:]
        assert not any("block time avg" in ln for ln in lines)
        while time.monotonic() < deadline and not any("block time avg" in ln for ln in lines):
            assert p.poll() is None, f"daemon died: {lines[-5:]}"
            p.send_signal(signal.SIGUSR1)
            time.sleep(1.0)
        assert any("block time avg" in ln for ln in lines), lines[-5:]
    finally:
        _stop(p)


RESTART_CONF = """
[global]
hardware = feeder
restart = 0
[feeder]
samprate = 128k
complex = yes
[hf]
mode = usb
samprate = 8k
freq = 32k0
"""


def test_radiod_restart_on_fatal(tmp_path):
    """tests/test_cli.py:428 on radiod-torch: `restart = 0` re-execs the
    daemon in a fresh interpreter after a fatal error. A feeder-less config
    is fatal on its first block, so each generation prints its banner and
    then restarts, counting in KA9Q_RESTART_COUNT."""
    conf = tmp_path / "restart.conf"
    conf.write_text(RESTART_CONF)
    p, lines = _spawn(conf, env={"KA9Q_RESTART_COUNT": "0"})
    deadline = time.monotonic() + SUBPROCESS_S
    try:
        while time.monotonic() < deadline and not any("restart #2" in ln for ln in lines):
            if p.poll() is not None:
                break
            time.sleep(0.2)
        restarts = [ln for ln in lines if "restart #" in ln]
        assert any("restart #2" in ln for ln in restarts), lines[-6:]
        assert all(ln.startswith("radiod-torch: fatal:") for ln in restarts), restarts
        assert sum("channels ready on cpu" in ln for ln in lines) >= 2, lines[-6:]
    finally:
        _stop(p)
