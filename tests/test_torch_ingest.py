"""The port's RTP A/D front end on the CPU: its native paced sender
(ingest_blast) against the JAX package's datagram for datagram, the native
reader's twins of tests/test_native.py's ingest tests, RtpSource on the
native reader and its fallback, and tools/bench_ingest_torch.py's two modes
at a small size. Every socket here is bound before anything is sent to it,
and every wait has a deadline of its own."""
import json
import os
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

import ka9q_radio_tpu.native as jnative
import ka9q_radio_tpu_torch.native as tnative
from ka9q_radio_tpu_torch.net.rtp import Encoding, RtpHeader, encode_samples
from ka9q_radio_tpu_torch.runtime.frontends import RtpSource

ROOT = Path(__file__).resolve().parents[1]
TOOL = ROOT / "tools" / "bench_ingest_torch.py"


@pytest.fixture(scope="module", autouse=True)
def native_edges():
    if not (tnative.native_available() and jnative.native_available()):
        pytest.skip("no C++ toolchain: the native edges cannot build here")


def _ramp(frames: np.ndarray, encoding: int) -> np.ndarray:
    """What the native reader yields for the sender's ramp at `frames`."""
    v = ((frames & 0x3FFF) - 0x2000).astype(np.float32)
    if encoding == Encoding.F32LE:
        return v / np.float32(32767)
    return (np.float32(1) / np.float32(32767)) * v


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("width", [1, 2])
@pytest.mark.parametrize("encoding", [Encoding.S16BE, Encoding.F32LE], ids=["s16be", "f32le"])
def test_ingest_blast_matches_jax(encoding, width):
    """5 packets from the port's sender and 5 from the JAX package's, each
    to its own bound socket: the same datagrams byte for byte (header,
    seq, timestamp, ssrc, payload), and the payload is the ramp."""
    fpp, got = 96, []
    for mod in (tnative, jnative):
        with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as rx:
            rx.bind(("127.0.0.1", 0))
            rx.settimeout(10.0)
            sent = mod.ingest_blast(rx.getsockname(), encoding=int(encoding), width=width,
                                    ssrc=0x5EED, frames_per_pkt=fpp, nframes=5 * fpp)
            assert sent == 5 * fpp
            got.append([rx.recv(65536) for _ in range(5)])
    assert got[0] == got[1]
    for k, pkt in enumerate(got[0]):
        hdr, payload = RtpHeader.unpack(pkt)
        assert (hdr.type, hdr.seq, hdr.timestamp, hdr.ssrc) == (97, k, k * fpp, 0x5EED)
        dt = ">i2" if encoding == Encoding.S16BE else "<f4"
        x = np.frombuffer(payload, dt).reshape(fpp, width)
        frames = np.arange(k * fpp, (k + 1) * fpp)
        want = (((frames & 0x3FFF) - 0x2000) if encoding == Encoding.S16BE
                else _ramp(frames, encoding))
        np.testing.assert_array_equal(x, np.repeat(want[:, None], width, 1))


def test_ingest_loopback_twin():
    """Twin of tests/test_native.py::test_native_ingest_loopback on the
    port's edge: ingest_blast paced at 50 Msps into RtpIngest, 1e6 frames,
    the ramp exact to 1e-6, no gap, overrun, duplicate or malformed packet."""
    dest = ("127.0.0.1", _free_port())
    ing = tnative.RtpIngest(dest, encoding=int(Encoding.S16BE), width=1, ring_log2=22)
    NF = 1_000_000
    th = threading.Thread(target=tnative.ingest_blast, args=(dest,), kwargs=dict(
        encoding=int(Encoding.S16BE), width=1, frames_per_pkt=704, nframes=NF,
        pace_fps=50_000_000), daemon=True)
    th.start()
    chunks, got_total, t_end = [], 0, time.monotonic() + 30.0
    try:
        while got_total < NF and time.monotonic() < t_end:
            buf, got = ing.read(65536, timeout=1.0)
            if got == 0:
                break
            chunks.append(buf[:got])
            got_total += got
        th.join(timeout=30.0)
        st = ing.stats()
    finally:
        ing.close()
    assert not th.is_alive()
    assert got_total >= NF  # the sender rounds up to whole packets
    assert st["gap_frames"] == 0 and st["overrun_frames"] == 0
    assert st["dups"] == 0 and st["malformed"] == 0
    x = np.concatenate(chunks)
    i = np.arange(x.size)
    want = (((i & 0x3FFF) - 0x2000) / 32767.0).astype(np.float32)
    assert np.abs(x - want).max() < 1e-6


def test_ingest_gap_and_filter_twin():
    """Twin of tests/test_native.py::test_native_ingest_gap_and_filter:
    timestamp gaps zero-fill, a foreign SSRC is ignored (its packet leaves a
    gap), and the complex (width 2) framing is kept."""
    dest = ("127.0.0.1", _free_port())
    ing = tnative.RtpIngest(dest, encoding=int(Encoding.S16BE), width=2, ssrc=42,
                            ring_log2=20)
    nf = 100
    try:
        with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as tx:
            for k in range(6):
                if k == 4:
                    continue  # a dropped packet: a timestamp gap
                x = np.full(2 * nf, (k + 1) * 0.1, np.float32)
                hdr = RtpHeader(type=97, seq=k, timestamp=k * nf, ssrc=42 if k != 2 else 999)
                tx.sendto(hdr.pack() + encode_samples(x, Encoding.S16BE), dest)
        # packets 0 and 1, the foreign packet 2's gap filled when 3 arrives,
        # 3, the dropped 4's gap filled when 5 arrives, 5: the read returns
        # as soon as all 6 x nf frames are in the ring
        buf, got = ing.read(2 * 6 * nf, timeout=10.0)
        st = ing.stats()
    finally:
        ing.close()
    assert got == 2 * 6 * nf
    frames = buf.reshape(-1, 2)
    assert np.allclose(frames[:nf], 0.1, atol=1e-3)
    assert np.allclose(frames[nf: 2 * nf], 0.2, atol=1e-3)
    assert np.all(frames[2 * nf: 3 * nf] == 0)  # the foreign SSRC's gap
    assert np.allclose(frames[3 * nf: 4 * nf], 0.4, atol=1e-3)
    assert np.all(frames[4 * nf: 5 * nf] == 0)  # the dropped packet
    assert np.allclose(frames[5 * nf: 6 * nf], 0.6, atol=1e-3)
    assert st["gap_frames"] == 2 * nf and st["packets"] == 4


def test_rtp_source_native_reads_the_ramp():
    """RtpSource(native=True) on a complex s16be stream from ingest_blast:
    the native reader runs (stats()["native"]), and three blocks are the
    ramp on I and on Q, bit for bit."""
    port, L = _free_port(), 4096
    src = RtpSource(f"127.0.0.1:{port}", samprate=1e6, real=False, encoding="s16be",
                    native=True)
    try:
        assert src.stats()["native"] is True and src.fallback_reason is None
        sent = tnative.ingest_blast(("127.0.0.1", port), encoding=int(Encoding.S16BE), width=2,
                                    frames_per_pkt=512, nframes=3 * L)
        assert sent == 3 * L
        blocks = [src.read_block(L, timeout=10.0) for _ in range(3)]
        st = src.stats()
    finally:
        src.close()
    x = np.concatenate(blocks)
    assert x.dtype == np.complex64 and src.timeouts == 0
    want = _ramp(np.arange(3 * L), Encoding.S16BE)
    np.testing.assert_array_equal(x.real, want)
    np.testing.assert_array_equal(x.imag, want)
    assert st["native"] is True and st["gap_frames"] == 0 and st["packets"] == 3 * L // 512


def test_rtp_source_fallback_is_not_silent(capsys):
    """An encoding the native reader does not convert leaves the Python
    reader: the reason goes to stderr and stats()["native"] is False."""
    src = RtpSource(f"127.0.0.1:{_free_port()}", samprate=48_000, real=True,
                    encoding="f16le", native=True)
    try:
        assert src.stats()["native"] is False
        assert "F16LE" in src.fallback_reason
    finally:
        src.close()
    err = capsys.readouterr().err
    assert "the Python reader runs" in err and "F16LE" in err


def _tool(*args: str, timeout: float) -> dict:
    r = subprocess.run([sys.executable, str(TOOL), *args], cwd=ROOT, capture_output=True,
                       text=True, timeout=timeout,
                       env={**os.environ, "OMP_NUM_THREADS": "2"})
    assert r.returncode == 0, r.stderr[-3000:]
    lines = r.stdout.strip().splitlines()
    assert len(lines) == 1, r.stdout
    return json.loads(lines[0])


def test_bench_ingest_tool_raw():
    """tools/bench_ingest_torch.py raw at 2 Msps for 0.5 s: one JSON line,
    every frame read on the ramp, and the frames add up (sent = read +
    overrun + still buffered)."""
    out = _tool("raw", "--fs", "2e6", "--secs", "0.5", timeout=120)
    assert out["mode"] == "raw" and out["native_reader"] is True
    assert out["frames_sent"] >= 1_000_000 and out["frames_read"] > 0
    assert out["frames_sent"] == (out["frames_read"] + out["frames_overrun"]
                                  + out["frames_buffered"])
    assert out["accounting_ok"] and out["ramp_accounted"]
    assert out["ramp_frames_checked"] == out["frames_read"]


def test_bench_ingest_tool_daemon_on_cpu():
    """tools/bench_ingest_torch.py daemon on the CPU (--device cpu) at 1.2
    Msps, 16 channels, 2 time shards, 1 s of stream: one JSON line with
    the JAX tool's keys, the native reader, the host split, and frames
    that add up."""
    out = _tool("daemon", "--device", "cpu", "--fs", "1.2e6", "--channels", "16", "--shards",
                "2", "--secs", "1", timeout=240)
    for key in ("mode", "fs_msps", "channels", "h2d_mbs_at_start", "time_shards", "blocks",
                "block_drops", "compile_s", "wall_secs", "achieved_msps", "realtime_margin",
                "p50_ms", "p99_ms", "packets", "gap_frames", "overrun_frames", "starve_frames"):
        assert key in out, key
    assert out["device"] == "cpu" and out["native_reader"] is True
    assert out["time_shards"] == 2 and out["blocks"] == 50 and out["block_drops"] == 0
    split = out["host_ms_per_dispatch"]
    assert split["ring_read_ms"] > 0 and split["stack_ms"] >= 0
    assert split["pin_ms"] is None and out["h2d_bytes_per_dispatch"] is None  # no card
    assert out["frames_sent"] == (out["frames_read"] + out["frames_overrun"]
                                  + out["frames_buffered"])
    assert out["accounting_ok"]
