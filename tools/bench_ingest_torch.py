#!/usr/bin/env python
"""Ingest-path benchmarks of the PyTorch/CUDA port: the native RTP reader's
throughput, and the port's daemon (radiod-torch) fed real RTP samples at
the flagship rate. The twin of tools/bench_ingest.py.

Modes:
  raw    - loopback sender (the native paced ingest_blast) -> native ring
           -> bulk reads, no device: the sustained Msps ceiling of the
           ingest path itself (the analog of rx888.c's USB completion path,
           rx888.c:668-744). Every frame read is held to the sender's ramp:
           bit for bit, or each break accounted for by the reader's gap
           and overrun counts.
  daemon - the port's Radiod: native paced sender at FS -> RtpSource
           (native reader) -> pinned host block -> the card (time-shards
           dispatch) -> RTP/TLV out on 127.0.0.1. Reports the ingest stats
           (gaps, overruns, starves), block drops, the real-time margin and
           the host path's split a dispatch (ring read, stacking,
           pin_memory, the copy's enqueue).

Usage:
  python tools/bench_ingest_torch.py raw    [--fs 129.6e6] [--secs 30] [--flat]
                                            [--frames-per-pkt 704]
  python tools/bench_ingest_torch.py daemon [--fs 129.6e6] [--secs 120]
                                            [--channels 1000] [--shards 8]
                                            [--device cuda] [--frames-per-pkt 704]

Prints one JSON line. The daemon runs on the card unless --device cpu asks
for the CPU. Both modes check that the frames add up: sent = read from the
ring (zero-filled gaps included) + dropped on ring overrun + still buffered.
"""
from __future__ import annotations

import argparse
import json
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

S16BE, F32LE = 2, 4  # net/rtp.py Encoding values the sender produces


def ramp_value(v: np.ndarray, encoding: int) -> np.ndarray:
    """float32 the native reader yields for ramp value v (int16 range): s16
    times 1/32767 (rtp_edge.cpp decode_payload), f32le the sender's v / 32767."""
    v = v.astype(np.float32)
    if encoding == F32LE:
        return v / np.float32(32767)
    return (np.float32(1) / np.float32(32767)) * v


class RampCheck:
    """The ramp ((frame & 0x3fff) - 0x2000) that ingest_blast sends, checked
    chunk by chunk over the frames a reader delivers. A frame is on the ramp
    when every sample equals ramp_value bit for bit. Runs of zeros that break
    the ramp are a gap's zero-fill; the ramp then goes on one frame a frame
    across them. A jump the fill does not explain is a break, and the frames
    it skips must be among the reader's gap or overrun frames (accounted)."""

    def __init__(self, encoding: int, width: int, chunk: int = 1 << 22):
        self.encoding, self.width = encoding, width
        self.frames = self.fill = self.breaks = self.skipped = self.corrupt = 0
        self._prev_k = None  # k (frame & 0x3fff) of the last frame, fill included
        self._last = None  # (k, index) of the last frame on the ramp
        # the ramp over chunk + one period: a chunk that goes on from k is
        # the slice [k + 1, k + 1 + n), no gather needed
        self._long = ramp_value((np.arange(chunk + 0x4000) & 0x3fff) - 0x2000, encoding)

    def feed(self, x: np.ndarray) -> None:
        fr = x.reshape(-1, self.width)
        n = fr.shape[0]
        if n == 0:
            return
        last = self._last
        if last is not None and last[1] == self.frames - 1 and n + 0x4000 <= self._long.size:
            s = (last[0] + 1) & 0x3fff  # the whole chunk on the ramp: one compare
            if np.array_equal(fr[:, 0], self._long[s:s + n]) and all(
                    np.array_equal(fr[:, c], fr[:, 0]) for c in range(1, self.width)):
                self._prev_k = (s + n - 1) & 0x3fff
                self._last = (self._prev_k, self.frames + n - 1)
                self.frames += n
                return
        k = (np.rint(fr[:, 0].astype(np.float64) * 32767.0).astype(np.int64) + 0x2000)
        exact = (fr == ramp_value(k - 0x2000, self.encoding)[:, None]).all(1)
        zero = (fr == 0).all(1)
        prev = np.empty(n, np.int64)
        prev[0] = self._prev_k if self._prev_k is not None else k[0] - 1
        prev[1:] = k[:-1]
        fill = zero & ((prev + 1) % 0x4000 != 0x2000)
        data = np.flatnonzero(~fill)
        self.corrupt += int((~exact[data]).sum())
        self.fill += int(fill.sum())
        idx = data + self.frames
        kd = k[data]
        if last is not None:
            kd, idx = np.concatenate([[last[0]], kd]), np.concatenate([[last[1]], idx])
        if kd.size:
            skip = (np.diff(kd) - np.diff(idx)) % 0x4000
            self.breaks += int((skip != 0).sum())
            self.skipped += int(skip.sum())
            self._last = (int(kd[-1]), int(idx[-1]))
        self._prev_k = int(k[-1])
        self.frames += n

    def result(self, gap_frames: int, overrun_frames: int) -> dict:
        """The check's counts and whether every break is accounted for:
        no corrupt frame, no more fill than gap frames, and the skipped
        frames within what the gaps left unfilled and the overruns dropped."""
        ok = (self.corrupt == 0 and self.fill <= gap_frames
              and self.skipped <= overrun_frames + gap_frames - self.fill)
        return {"ramp_frames_checked": self.frames, "ramp_exact": ok and self.breaks == 0
                and self.fill == 0, "ramp_breaks": self.breaks,
                "ramp_skipped_frames": self.skipped, "ramp_fill_frames": self.fill,
                "ramp_corrupt_frames": self.corrupt, "ramp_accounted": ok}


def free_udp_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def wait_bound(dest: tuple[str, int], stats, limit_s: float = 5.0) -> float:
    """Sends 4-byte datagrams (malformed for RTP: they touch no frame count)
    to dest until the reader counts one; returns the seconds it took.
    Raises if none arrives within limit_s."""
    t0 = time.monotonic()
    base = stats()["malformed"]
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as tx:
        while time.monotonic() - t0 < limit_s:
            tx.sendto(b"\0\0\0\0", dest)
            time.sleep(0.005)
            if stats()["malformed"] > base:
                return time.monotonic() - t0
    raise RuntimeError(f"no datagram reached the reader on {dest} in {limit_s} s")


def settle(stats, quiet_s: float = 0.3, limit_s: float = 10.0) -> dict:
    """stats() once the reader thread has taken every packet in flight: no
    new packet for quiet_s (at most limit_s)."""
    t_end = time.monotonic() + limit_s
    last = stats()
    while time.monotonic() < t_end:
        time.sleep(quiet_s)
        cur = stats()
        if cur["packets"] == last["packets"]:
            return cur
        last = cur
    return last


def accounting(sent: int, read_floats: int, st: dict, width: int) -> dict:
    """sent = read from the ring (the gaps' zero-fill among them) + dropped
    on ring overrun + still buffered, in frames (read_floats without the
    starved reads' zero-fill)."""
    read = read_floats // width
    buffered = st["buffered_floats"] // width
    return {"frames_sent": sent, "frames_read": read, "frames_delivered": read - st["gap_frames"],
            "frames_zero_filled": st["gap_frames"], "frames_overrun": st["overrun_frames"],
            "frames_buffered": buffered,
            "accounting_ok": sent == read + st["overrun_frames"] + buffered}


def card() -> str | None:
    """nvidia-smi's name and power limit of the first card, None without one."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return None
    return out[0].strip() if out else None


def bench_raw(fs: float, secs: float, flat: bool, frames_per_pkt: int = 704,
              width: int = 1, encoding: int = S16BE, check: bool = True) -> dict:
    """ingest_blast -> RtpIngest on 127.0.0.1 for secs of stream at fs
    (flat out with `flat`), bulk reads of one 20 ms block (2,592,000 floats
    at the flagship rate), each held to the ramp (check)."""
    from ka9q_radio_tpu_torch.native import RtpIngest, ingest_blast

    dest = ("127.0.0.1", free_udp_port())
    ing = RtpIngest(dest, encoding=encoding, width=width, ring_log2=28)
    try:
        bound_s = wait_bound(dest, ing.stats)
    except Exception:
        ing.close()
        raise
    nf = int(fs * secs)
    res = {}

    def tx():
        t0 = time.monotonic()
        res["sent"] = ingest_blast(dest, encoding=encoding, width=width,
                                   frames_per_pkt=frames_per_pkt, nframes=nf,
                                   pace_fps=0 if flat else int(fs))
        res["tx_dt"] = time.monotonic() - t0

    ramp = RampCheck(encoding, width)
    th = threading.Thread(target=tx)
    th.start()
    L = max(int(fs * 0.02), 1) * width  # floats a read: one 20 ms block
    got_total, t0 = 0, time.monotonic()
    try:
        while got_total < nf * width - L:
            buf, got = ing.read(L, timeout=2.0)
            if got == 0:
                break
            if check:
                ramp.feed(buf[:got - got % width])
            got_total += got
        dt = time.monotonic() - t0
        th.join()
        st = settle(ing.stats)
    finally:
        ing.close()
    out = {"mode": "raw", "flat_out": flat, "width": width, "frames_per_pkt": frames_per_pkt,
           "tx_msps": res["sent"] / res["tx_dt"] / 1e6,
           "rx_msps": got_total / width / dt / 1e6, "frames": got_total // width, "secs": dt,
           **st, "native_reader": True, "bind_wait_s": bound_s,
           **accounting(res["sent"], got_total, st, width)}
    if check:
        out.update(ramp.result(st["gap_frames"], st["overrun_frames"]))
    return out


def measure_h2d(device, secs: float = 2.0) -> float | None:
    """Sustained host-to-card MB/s of one pinned 20 ms flagship block right
    now (None on the CPU)."""
    import torch

    if device.type != "cuda":
        return None
    x = torch.zeros(2_592_000, dtype=torch.float32).pin_memory()
    x.to(device, non_blocking=True)
    torch.cuda.synchronize()
    t0, n = time.monotonic(), 0
    while time.monotonic() - t0 < secs:
        x.to(device, non_blocking=True)
        torch.cuda.synchronize()
        n += 1
    return n * x.nbytes / (time.monotonic() - t0) / 1e6


# front-end rate ladder (all goodchoice master sizes): flagship down to
# RTL-class, halving until the measured link carries fs*4B at <=50% duty
_FS_LADDER = [129_600_000, 64_800_000, 32_400_000, 16_200_000,
              8_100_000, 4_050_000, 2_025_000]


def bench_daemon(fs: float, secs: float, channels: int, shards: int, device: str = "cuda",
                 frames_per_pkt: int = 704) -> dict:
    """The port's Radiod on `device` over an inline config (one real s16be
    RTP feed at fs, `channels` usb channels on a raster, time-shards
    `shards`; data and status on 127.0.0.1, no SAP or mDNS), fed by
    ingest_blast paced at fs. One warm dispatch and two more, then
    secs of stream timed; then the sender's end and the frame accounting."""
    import torch

    from ka9q_radio_tpu_torch.config import load_config
    from ka9q_radio_tpu_torch.native import ingest_blast
    from ka9q_radio_tpu_torch.runtime.radiod import Radiod

    dev = torch.device(device)
    h2d_mbs = measure_h2d(dev)
    if fs <= 0:  # --fs 0 = auto: the largest rung the link carries
        if h2d_mbs is None:
            raise SystemExit("--fs 0 needs the card's copy rate: give --fs on the CPU")
        fs = next((r for r in _FS_LADDER if r * 4 <= 0.5 * h2d_mbs * 1e6), _FS_LADDER[-1])
    port, dport, sport = free_udp_port(), free_udp_port(), free_udp_port()
    hi = min(0.45 * fs, 60_000_000.0)
    lo = min(2_000_000.0, 0.05 * fs)
    cfg = load_config(f"""
[global]
hardware = feed
mode = usb
time-shards = {shards}
status = 127.0.0.1:{sport}
data = 127.0.0.1:{dport}
sap = no
advertise = no
update = 50
[feed]
device = rtp
stream = 127.0.0.1:{port}
samprate = {int(fs)}
real = yes
[hf]
raster = {lo:.1f} {hi:.1f} {(hi - lo) / channels:.1f}
""")
    rd = Radiod(cfg, use_network=True, data_port=dport, status_port=sport, device=dev)
    L, D = rd.engine.L, rd._time_shards or 1
    ndisp = max(1, int(fs * secs) // (L * D))
    warm = 3
    nsend = (ndisp + warm) * L * D
    res = {}

    def tx():
        t0 = time.monotonic()
        res["sent"] = ingest_blast(("127.0.0.1", port), encoding=S16BE, width=1,
                                   frames_per_pkt=frames_per_pkt, nframes=nsend,
                                   pace_fps=int(fs))
        res["tx_dt"] = time.monotonic() - t0

    th = threading.Thread(target=tx, daemon=True)
    try:
        th.start()
        # the first dispatch plans cuFFT; the ring rides it out
        t_c0 = time.monotonic()
        rd.step_block()
        compile_s = time.monotonic() - t_c0
        for _ in range(warm - 1):
            rd.step_block()
        st0 = rd.frontend.stats()
        blocks0, drops0 = rd.blocks, rd.block_drops
        rd.frontend_host = dict.fromkeys(rd.frontend_host, 0)
        rd._t_n = 0
        t0 = time.monotonic()
        for _ in range(ndisp):
            rd.step_block()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        dt = time.monotonic() - t0
        split = rd.frontend_split()
        st1 = rd.frontend.stats()
        p50, p99 = rd.latency_percentiles()
        blocks, drops = rd.blocks - blocks0, rd.block_drops - drops0
        th.join(timeout=nsend / fs + 30.0)
        st = settle(rd.frontend.stats)
    finally:
        rd.frontend.close()
        for edge, _ in rd.edges.values():
            edge.close()
    read_floats = (ndisp + warm) * L * D - st["starve_frames"]
    return {
        "mode": "daemon", "fs_msps": fs / 1e6, "channels": channels, "device": str(dev),
        "card": card() if dev.type == "cuda" else None,
        "h2d_mbs_at_start": h2d_mbs, "time_shards": D, "blocks": blocks, "block_drops": drops,
        "compile_s": compile_s, "wall_secs": dt, "achieved_msps": blocks * L / dt / 1e6,
        "realtime_margin": (blocks * L / fs) / dt, "p50_ms": p50 * 1e3, "p99_ms": p99 * 1e3,
        **{k: st1[k] - st0[k] for k in st1 if k not in ("native", "buffered_floats")},
        "buffered_floats": st1["buffered_floats"],
        "native_reader": bool(st1["native"]), "frames_per_pkt": frames_per_pkt,
        "host_ms_per_dispatch": {k: split[k] for k in ("ring_read_ms", "stack_ms", "pin_ms",
                                                       "copy_ms")},
        "h2d_bytes_per_dispatch": split["h2d_bytes"],
        "sender_msps": res["sent"] / res["tx_dt"] / 1e6 if "sent" in res else None,
        **accounting(res.get("sent", -1), read_floats, st, 1),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("mode", choices=["raw", "daemon"])
    ap.add_argument("--fs", type=float, default=129.6e6)
    ap.add_argument("--secs", type=float, default=30.0)
    ap.add_argument("--flat", action="store_true")
    ap.add_argument("--channels", type=int, default=1000)
    ap.add_argument("--shards", type=int, default=8)
    ap.add_argument("--device", default="cuda",
                    help="the daemon's device (default cuda; cpu runs it on the host)")
    ap.add_argument("--frames-per-pkt", type=int, default=704,
                    help="frames a packet (704: an Ethernet MTU of s16 samples)")
    a = ap.parse_args(argv)
    if a.mode == "raw":
        out = bench_raw(a.fs, a.secs, a.flat, a.frames_per_pkt)
    else:
        out = bench_daemon(a.fs, a.secs, a.channels, a.shards, a.device, a.frames_per_pkt)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
