"""The port's daemon runs the example configs on the CPU: `radiod-torch
--device cpu --no-network --flat-out --blocks 50` on every example but the
mesh one (129.6 Msps over every local CUDA device: chip_smoke.py's mesh
phase runs it on the card), with each network A/D front end (`device = rtp`)
replaced by a sig_gen at the same rate and centre: a carrier on one channel
that has no CTCSS tone, FM- or AM-modulated as its mode wants (unmodulated
for the spectrum survey), over noise. The daemon must start and run every
block, and the carrier's channel must send audio; the spectrum survey, which
sends no audio, must answer polls with non-empty bins."""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from ka9q_radio_tpu_torch.cli.radiod import main
from ka9q_radio_tpu_torch.config import load_config
from ka9q_radio_tpu_torch.net.rtp import RtpHeader
from ka9q_radio_tpu_torch.net.status import StatusType as T, decode_status, encode_status
from ka9q_radio_tpu_torch.runtime import radiod as tradiod

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
# example -> (carrier in RF Hz, modulation) for the replacement front end
CASES = {
    "radiod@siggen.conf": None,  # its own sig_gen
    "radiod@2m.conf": (146_520_000, "fm"),  # the calling channel: no CTCSS
    "radiod@aviation.conf": (118_300_000, "am"),
    "radiod@fm.conf": (88_300_000, "fm"),
    "radiod@hf-generic.conf": (29_620_000, "fm"),
    "radiod@spectrum.conf": (14_623_400, "none"),
}


def with_sig_gen(text: str, carrier: float, modulation: str) -> str:
    """The config with its `device = rtp` front end turned into a sig_gen
    (same samprate, real/complex and centre; the rtp-only keys dropped)."""
    out, n = re.subn(r"(?m)^device\s*=\s*rtp\b.*$",
                     f"device = sig_gen\ncarrier = {carrier}\namplitude = -30\n"
                     f"noise = -120\nmodulation = {modulation}", text)
    assert n == 1
    return re.sub(r"(?m)^(stream|encoding)\s*=.*$", "", out)


@pytest.mark.parametrize("name", sorted(CASES))
def test_example_runs_on_cpu(name, tmp_path, capsys):
    text = (ROOT / "examples" / name).read_text()
    if CASES[name] is not None:
        text = with_sig_gen(text, *CASES[name])
    path = tmp_path / name
    path.write_text(text)
    assert main(["--device", "cpu", "--no-network", "--flat-out", "--blocks", "50", "-v",
                 str(path)]) == 0
    assert "50 blocks" in capsys.readouterr().err
    # and the carrier is heard: a daemon on the same config, a few blocks
    rd = tradiod.Radiod(load_config(text), use_network=False, device="cpu")
    survey = [c.ssrc for c in rd.chans.values()
              if rd.engine.groups[c.group].spec.demod == "spectrum"]
    for ssrc in survey:  # a bare poll arms a lazy spectrum channel
        rd.handle_packet(encode_status({T.OUTPUT_SSRC: ssrc}, cmd=True))
    for _ in range(8):
        rd.step_block()
    if survey:
        bins = [decode_status(p)[1].get(T.BIN_BYTE_DATA, b"") for k, p in rd._sent
                if k == "status"]
        assert any(bins), name
        return
    heard = {RtpHeader.unpack(p)[0].ssrc for k, p in rd._sent[-40:] if k == "data"
             and np.abs(np.frombuffer(RtpHeader.unpack(p)[1], ">i2")).max(initial=0) > 0}
    assert heard, name
