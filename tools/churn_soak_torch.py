"""Long-churn live soak of the PyTorch port's daemon (the twin of
tools/churn_soak.py, with its config): continuous dynamic creates,
removes, preset moves and retunes against radiod-torch paced at the
stream's real time, at restocking pace, asserting the control-plane
invariants that targeted tests cannot see at duration:

  * zero FOREGROUND rebuilds after warm-up: every command lands as params
    surgery or a warm slot reuse; the pools grow only through background
    restocks (built on a side CUDA stream and swapped in at a block
    boundary);
  * zero dropped blocks (the port has no device-flake handling, so no
    drop is excused);
  * memory on a plateau: the process's VmRSS and, on a card, the bytes
    torch.cuda.memory_allocated reports, each with the JAX soak's rule
    (end <= min(back half) x 1.10 + 32 MB).

Each engine dispatches as CUDA graph replays on a card (runtime/graphs.py):
the restock worker captures a grown engine's graphs in its own thread
before the swap, and only a branch it did not foresee is captured in the
foreground. The summary's `graphs` counts the captures, their ms and the
replays over every engine.
Prints ONE json summary line and exits 0 when every invariant holds.

    python tools/churn_soak_torch.py [--seconds 630] [--device cpu|cuda]
        [--dyn-slots N] [--rss-out FILE] [--loopback]

--device: the daemon's device (default CUDA, an error without it).
--loopback: status and RTP to 127.0.0.1 and no SAP or mDNS announcements,
for a host without multicast routes. It imports only the port.
"""
from __future__ import annotations

import argparse
import json
import os
import socket
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

CONF = """
[global]
hardware = sig_gen
time-shards = 16
dyn-slots = 24
status = churn-{tag}-st.local
data = churn-{tag}-pcm.local
update = 25
ttl = 0

[sig_gen]
device = sig_gen
samprate = 1m024
complex = yes
carrier = 201k0
amplitude = -20
noise = -110

[hf]
mode = usb
samprate = 12k
freq = 200k0 210k0 220k0 230k0

[fmgrp]
mode = nfm
samprate = 24k
freq = 300k0
"""


def rss_mb() -> float:
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS"):
                return int(line.split()[1]) / 1024.0
    return 0.0


def plateau(series: list) -> bool:
    """tools/churn_soak.py's rule: a leak shows as growth in the back half,
    not as the early warm-up (caches, deepened pools)."""
    half = series[len(series) // 2:]
    return (not half) or series[-1] <= min(half) * 1.10 + 32


def _sink() -> socket.socket:
    """A UDP socket on 127.0.0.1 that takes the daemon's packets unread (a
    closed port would answer with ICMP errors)."""
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    s.bind(("127.0.0.1", 0))
    return s


def _graph_totals(rd) -> dict:
    """The daemon's CUDA graph captures over every engine of the soak (the
    current one and those the rebuilds and restocks replaced)."""
    st = rd.graph_stats()
    cur, before = st["current"], st["before"]
    if cur is None:
        return {"dispatch": "eager (mesh)"}
    return {"dispatch": cur["dispatch"], "engines": before["engines"] + 1,
            "captures": before["captures"] + cur["captures"],
            "capture_ms": round(before["capture_ms"] + sum(cur["capture_ms"]), 1),
            "replays": before["replays"] + cur["replays"],
            "eager_blocks": sum(before["eager_blocks"].values()) + sum(cur["eager_blocks"].values())}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="churn_soak_torch")
    ap.add_argument("--seconds", type=float, default=630.0)
    ap.add_argument("--dyn-slots", type=int, default=None)
    ap.add_argument("--rss-out", default=None)
    ap.add_argument("--device", default=None)
    ap.add_argument("--loopback", action="store_true")
    args = ap.parse_args(argv)

    import torch

    from ka9q_radio_tpu_torch.config import load_config
    from ka9q_radio_tpu_torch.net.status import StatusType as T, encode_status
    from ka9q_radio_tpu_torch.runtime.radiod import Radiod
    from ka9q_radio_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    conf = CONF.format(tag=os.getpid())
    if args.dyn_slots is not None:
        conf = conf.replace("dyn-slots = 24", f"dyn-slots = {args.dyn_slots}")
    sinks = []
    if args.loopback:
        # the daemon binds its status address itself (its commands come
        # there); the RTP goes to a sink
        probe = _sink()
        st = f"127.0.0.1:{probe.getsockname()[1]}"
        probe.close()
        sinks = [_sink()]
        conf = (conf.replace(f"churn-{os.getpid()}-st.local", st)
                .replace(f"churn-{os.getpid()}-pcm.local",
                         f"127.0.0.1:{sinks[0].getsockname()[1]}")
                .replace("[global]\n", "[global]\nsap = no\nadvertise = no\n", 1))
    rd = Radiod(load_config(conf), use_network=True, device=device)
    on_card = device.type == "cuda"

    def dev_mb() -> float:
        return torch.cuda.memory_allocated(device) / 2**20 if on_card else 0.0

    def cmd(ssrc, **kv):
        fields = {T.OUTPUT_SSRC: ssrc}
        fields.update({T[k]: v for k, v in kv.items()})
        rd.handle_packet(encode_status(fields, cmd=True))
        return rd.chans.get(ssrc)

    # warm-up: every class the churn touches (usb reuses the static [hf]
    # class, nfm [fmgrp]; am is the one new class), then the first
    # restock settles so the spare pools start full
    t0 = time.monotonic()
    rd.step_block()
    cmd(9001, PRESET="usb", RADIO_FREQUENCY=205e3)
    cmd(9002, PRESET="am", RADIO_FREQUENCY=215e3)
    cmd(9003, PRESET="nfm", RADIO_FREQUENCY=310e3)
    for _ in range(3):
        rd.step_block()
    t_settle = time.monotonic() + 90.0
    while (rd._restock is not None or rd._restock_pending) and time.monotonic() < t_settle:
        rd.step_block()
    warm_s = time.monotonic() - t0

    rng = np.random.default_rng(11)
    presets = ["usb", "am", "nfm"]
    live = [9001, 9002, 9003]
    next_ssrc = 9010
    fg_rebuilds = restock_swaps = commands = dispatches = 0
    rss_series, dev_series = [rss_mb()], [dev_mb()]

    t_start = time.monotonic()
    deadline = t_start + args.seconds
    per = (rd._time_shards or 1) * rd.cfg.blocktime  # stream seconds a dispatch
    next_due = time.monotonic()
    while time.monotonic() < deadline:
        # 1-2 control operations a dispatch (~6/s of stream time at the
        # restocking pace: creates trend the pools upward so background
        # restocks fire)
        for _ in range(int(rng.integers(1, 3))):
            op = int(rng.integers(0, 10))
            e0 = rd._engine_epoch
            if (op <= 1 and len(live) < 24) or not live:  # create (20%)
                cmd(next_ssrc, PRESET=str(rng.choice(presets)),
                    RADIO_FREQUENCY=float(rng.uniform(150e3, 450e3)))
                if next_ssrc in rd.chans:
                    live.append(next_ssrc)
                next_ssrc += 1
            elif op <= 6:  # retune (50%)
                cmd(int(rng.choice(live)), RADIO_FREQUENCY=float(rng.uniform(150e3, 450e3)))
            elif op == 7:  # preset move within the warm set (10%)
                cmd(int(rng.choice(live)), PRESET=str(rng.choice(presets)))
            elif len(live) > 8:  # remove (20%, keep a floor)
                rd.remove_channel(live.pop(int(rng.integers(0, len(live)))))
            commands += 1
            if rd._engine_epoch != e0:
                fg_rebuilds += 1  # a command forced a foreground rebuild
        e0 = rd._engine_epoch
        rd.step_block()
        dispatches += 1
        if rd._engine_epoch != e0:
            restock_swaps += 1  # a background pool grow swapped in
        next_due += per
        lag = next_due - time.monotonic()
        if lag > 0:
            time.sleep(lag)  # real-time pacing
        if dispatches % 30 == 0:
            rss_series.append(rss_mb())
            dev_series.append(dev_mb())
            if args.rss_out:
                with open(args.rss_out, "a") as fh:
                    fh.write(json.dumps({
                        "t": round(time.monotonic() - t_start, 1),
                        "rss_mb": round(rss_series[-1], 1), "device_mb": round(dev_series[-1], 1),
                        "blocks": rd.blocks, "commands": commands, "fg_rebuilds": fg_rebuilds,
                        "restock_swaps": restock_swaps,
                        "pools": {k: len(v) for k, v in rd.free_slots.items()}}) + "\n")
    rss_series.append(rss_mb())
    dev_series.append(dev_mb())
    for edge, _ in rd.edges.values():
        edge.close()
    for s in sinks:
        s.close()

    out = {
        "device": str(device),
        "seconds": round(time.monotonic() - t_start, 1),
        "warmup_s": round(warm_s, 1),
        "stream_blocks": rd.blocks,
        "dispatches": dispatches,
        "realtime_factor": round(rd.blocks * rd.cfg.blocktime
                                 / max(time.monotonic() - t_start, 1e-9), 3),
        "commands": commands,
        "live_channels_end": len(rd.chans),
        "fg_rebuilds_after_warmup": fg_rebuilds,
        "restock_swaps": restock_swaps,
        "block_drops": rd.block_drops,
        "rss_start_mb": round(rss_series[0], 1),
        "rss_end_mb": round(rss_series[-1], 1),
        "rss_peak_mb": round(max(rss_series), 1),
        "rss_plateau": plateau(rss_series),
        "device_mb_start": round(dev_series[0], 1),
        "device_mb_end": round(dev_series[-1], 1),
        "device_mb_peak": round(max(dev_series), 1),
        "device_plateau": plateau(dev_series),
        "samples": len(rss_series),
        "p50_ms": round(rd.latency_percentiles((50,))[0] * 1e3, 2),
        "p99_ms": round(rd.latency_percentiles((99,))[0] * 1e3, 2),
        "dyn_slots": rd.dyn_spare,
        "restock_latency_s": {k: round(v, 1) for k, v in rd._restock_latency.items()},
        "graphs": _graph_totals(rd),
    }
    out["ok"] = (out["fg_rebuilds_after_warmup"] == 0 and out["block_drops"] == 0
                 and out["rss_plateau"] and out["device_plateau"])
    print(json.dumps(out), flush=True)
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
