#!/usr/bin/env python
"""High-C daemon bench of the PyTorch/CUDA port (the twin of
tools/bench_highc.py): a live radiod-torch serving tens of thousands of
channels in real time, not only the engine's compute.

32,768 SSB channels at 12 kHz with SNR squelch (most stay shut; a sig_gen
carrier 700 Hz into one channel's passband opens it), squelch-compacted
egress into --slots rows, the native indexed edge, lazy info fetches and
staggered beacons. The daemon runs --secs of stream paced at real time,
--shards blocks a dispatch, and the carrier channel's RTP is tapped: its
decoded audio must peak at 700 Hz.

Prints ONE json line with the JAX tool's keys and exits 0 when no block
dropped, the tap's tone is within 20 Hz of 700 and no egress overflow came
after warm-up. p50_ms_per_block and p99_ms_per_block are
Radiod.latency_percentiles() as it is: the daemon's ring already holds a
dispatch's wall time over its D blocks, so this tool does not divide by D
again (tools/bench_highc.py:134-135 does, and so reports a per-block
latency D times too small). chan_kernel: kernel A carried the group on
this run (the group is tiled, the device is CUDA and A's launch counter
moved).

    python tools/bench_highc_torch.py [--channels 32768] [--secs 60]
        [--shards 8] [--slots 512] [--fs 129.6e6] [--device cuda|cpu]
        [--loopback]

--device: the daemon's device (default CUDA, an error without it).
--loopback: status and RTP to 127.0.0.1 and no SAP or mDNS announcements,
for a host without multicast routes. It imports only the port.
"""
from __future__ import annotations

import argparse
import json
import select
import socket
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def config(channels: int, shards: int, slots: int, fs: float, status: str, data: str,
           loopback: bool) -> tuple[str, int, float]:
    """The JAX tool's config: (text, the carrier's channel index, carrier Hz)."""
    lo, hi = 0.02 * fs, 0.48 * fs
    step = (hi - lo) / channels
    k = channels // 3  # the carrier lands 700 Hz into this channel's USB passband
    carrier = lo + k * step + 700.0
    quiet = "sap = no\nadvertise = no\n" if loopback else ""
    return f"""
[global]
hardware = sig_gen
mode = usb
time-shards = {shards}
status = {status}
data = {data}
update = 2000
ttl = 0
{quiet}[sig_gen]
device = sig_gen
samprate = {int(fs)}
real = yes
carrier = {carrier:.0f}
amplitude = -20
noise = -135
[hf]
mode = usb
samprate = 12k
raster = {lo:.1f} {hi:.1f} {step:.6f}
snr-squelch = yes
egress-slots = {slots}
""", k, carrier


def run(a) -> tuple[dict, object]:
    """The bench: (its JSON record, the Radiod it ran)."""
    from bench_torch import card
    from ka9q_radio_tpu_torch.config.loader import load_config
    from ka9q_radio_tpu_torch.net.multicast import listen_socket, resolve_dest
    from ka9q_radio_tpu_torch.net.rtp import Encoding, RtpHeader, decode_samples
    from ka9q_radio_tpu_torch.ops import cuda_channelize as cc
    from ka9q_radio_tpu_torch.runtime.radiod import Radiod
    from ka9q_radio_tpu_torch.utils.device import resolve_device

    device = resolve_device(a.device)
    if a.loopback:
        rx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        rx.bind(("127.0.0.1", 0))
        probe = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        probe.bind(("127.0.0.1", 0))
        status = f"127.0.0.1:{probe.getsockname()[1]}"
        probe.close()  # the daemon binds its status address itself
        data = f"127.0.0.1:{rx.getsockname()[1]}"
    else:
        tag = f"highc-{int(time.time()) % 100000}"
        status, data = f"{tag}-ctl.local", f"{tag}-pcm.local"
        rx = listen_socket(resolve_dest(data, 5004))
    conf, k, _ = config(a.channels, a.shards, a.slots, a.fs, status, data, a.loopback)
    try:
        t_build0 = time.monotonic()
        rd = Radiod(load_config(conf), use_network=True, device=device)
        build_s = time.monotonic() - t_build0
        g = rd.engine.groups["hf"]
        # kHz-rounded SSRCs collide at sub-kHz rasters and get bumped: find
        # the carrier channel by its slot index
        want_ssrc = next(ch.ssrc for ch in rd.chans.values() if ch.group == "hf" and ch.idx == k)
        D = rd._time_shards or 1
        per = D * rd.cfg.blocktime
        t0 = time.monotonic()
        rd.step_block()  # the first dispatch: cuFFT plans, kernel loads
        first_s = time.monotonic() - t0
        for _ in range(2):
            rd.step_block()
        while select.select([rx], [], [], 0)[0]:
            rx.recvfrom(65536)
        overflow0 = rd.egress_overflows
        cc.reset_launches()
        payloads, audio_ssrcs = [], set()
        ndisp = int(a.secs / per)
        next_due = t_start = time.monotonic()
        late = 0
        for _ in range(ndisp):
            rd.step_block()
            while select.select([rx], [], [], 0)[0]:
                pkt, _ = rx.recvfrom(65536)
                if len(pkt) > 12:
                    h, pl = RtpHeader.unpack(pkt)
                    audio_ssrcs.add(h.ssrc)
                    if h.ssrc == want_ssrc:
                        payloads.append(pl)
            next_due += per
            lag = next_due - time.monotonic()
            if lag > 0:
                time.sleep(lag)
            else:
                late += 1
        wall = time.monotonic() - t_start
    finally:
        rx.close()
    p50, p99 = rd.latency_percentiles()  # seconds a block already
    tone_hz = 0.0
    if payloads:
        audio = np.concatenate([decode_samples(p, Encoding.S16BE) for p in payloads[2:]])
        if audio.size > 4096:
            S = np.abs(np.fft.rfft(audio * np.hanning(audio.size)))
            tone_hz = float(np.fft.rfftfreq(audio.size, 1 / 12_000)[np.argmax(S)])
    out = {
        "mode": "highc_daemon", "channels": g.C, "fs_msps": a.fs / 1e6,
        "egress_slots": a.slots, "time_shards": D,
        "blocks": rd.blocks, "block_drops": rd.block_drops,
        "stream_secs": rd.blocks * rd.cfg.blocktime,
        "wall_secs": wall,
        "realtime_margin": ndisp * per / wall,
        "late_dispatches": late,
        "p50_ms_per_block": p50 * 1e3,
        "p99_ms_per_block": p99 * 1e3,
        "egress_overflows_after_warmup": rd.egress_overflows - overflow0,
        "open_ssrcs_on_wire": sorted(audio_ssrcs)[:8],
        "tap_ssrc": want_ssrc, "tap_tone_hz": tone_hz,
        "tap_packets": len(payloads),
        "chan_kernel": bool(g.tiled and device.type == "cuda" and cc.launches["channelize"] > 0),
        "launches": dict(cc.launches),
        "build_s": build_s, "first_dispatch_s": first_s,
        "device": str(device),
        "card": card() if device.type == "cuda" else None,
    }
    return out, rd


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--channels", type=int, default=32_768)
    ap.add_argument("--secs", type=float, default=60.0)
    ap.add_argument("--shards", type=int, default=8)
    ap.add_argument("--slots", type=int, default=512)
    ap.add_argument("--fs", type=float, default=129.6e6)
    ap.add_argument("--device", default=None)
    ap.add_argument("--loopback", action="store_true")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    out, rd = run(parse(argv))
    print(json.dumps(out), flush=True)
    ok = (rd.block_drops == 0 and abs(out["tap_tone_hz"] - 700.0) < 20
          and out["egress_overflows_after_warmup"] == 0)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
