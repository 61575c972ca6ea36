"""End-to-end dispatch latency of the PyTorch/CUDA port, block in to RTP
out, a dispatch mode at a time: the twin of profile_latency.py.

It times the daemon's path (Radiod.step_block: the step on the card, the
device-to-host copy, the host's packetization and the send) for
time-shards = 0, 4 and 16 on one device. Each sample is one dispatch's
wall time; a time-sharded dispatch carries D blocks, so a block's audio
also waits up to (D-1) x 20 ms in the queue (`added_latency_ms`). Prints
one JSON line a mode.

On the port D does not batch the step: `_mk_step`
(ka9q_radio_tpu_torch/runtime/radiod.py) loops over D Engine.step calls,
where the JAX daemon runs them as one lax.scan. So D amortizes only the
host's read, copy, fetch and sync here, while it still adds the queueing.

    python profile_latency_torch.py [modes ...] [--device cuda|cpu] [--loopback]

modes: time-shards values (default 0 4 16; 200, 60 and 20 dispatches).
--device: default CUDA, an error without it. --loopback: status and RTP to
127.0.0.1 and no SAP or mDNS announcements, for a host without multicast
routes. It imports only the port.
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

ROOT = Path(__file__).resolve().parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

CONF = """
[global]
hardware = gen
{opts}status = lat-{tag}-st.local
data = lat-{tag}-pcm.local
update = 25
ttl = 0

[gen]
device = sig_gen
samprate = 1m024
complex = yes
carrier = 100k
amplitude = -20
noise = -90

[usb]
mode = usb
samprate = 12k
freq = 100k0 110k0 120k0 130k0 140k0 150k0 160k0 170k0
"""

DISPATCHES = {0: 200, 4: 60}  # any other mode: 20


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def measure(ts: int, dispatches: int, device=None, loopback: bool = False) -> dict:
    from ka9q_radio_tpu_torch.config import load_config
    from ka9q_radio_tpu_torch.runtime.radiod import Radiod

    opts = "" if ts == 0 else f"time-shards = {ts}\n"
    tag = f"{os.getpid()}-{ts}"
    conf = CONF.format(opts=opts, tag=tag)
    if loopback:
        conf = (conf.replace(f"lat-{tag}-st.local", f"127.0.0.1:{_free_port()}")
                .replace(f"lat-{tag}-pcm.local", f"127.0.0.1:{_free_port()}")
                .replace("[global]\n", "[global]\nsap = no\nadvertise = no\n", 1))
    rd = Radiod(load_config(conf), use_network=True, device=device)
    try:
        for _ in range(3):  # the first dispatches: cuFFT plans, the first copies
            rd.step_block()
        spans = []
        for _ in range(dispatches):
            t0 = time.perf_counter()
            rd.step_block()
            spans.append(time.perf_counter() - t0)
    finally:
        for sock in (rd.data_sock, rd.status_in, rd.status_sock, rd.rtcp_sock):
            if sock is not None:
                sock.close()
        for edge, _ in rd.edges.values():
            edge.close()
    s = np.sort(np.asarray(spans)) * 1e3
    d = max(ts, 1)
    p50 = float(np.percentile(s, 50))
    return {
        "mode": f"time-shards={ts}" if ts else "per-block",
        "blocks_per_dispatch": d,
        "dispatch_p50_ms": p50,
        "dispatch_p99_ms": float(np.percentile(s, 99)),
        # the most extra audio latency a block sees from riding a D-block
        # dispatch: the dispatch itself + (D-1) blocks of queueing
        "added_latency_ms": p50 + (d - 1) * 20.0,
        "samples": len(s),
        "device": str(rd.engine.device),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("modes", nargs="*", type=int, default=[0, 4, 16])
    ap.add_argument("--device", default=None)
    ap.add_argument("--loopback", action="store_true")
    a = ap.parse_args(argv)
    from ka9q_radio_tpu_torch.utils.device import resolve_device

    device = resolve_device(a.device)
    for ts in a.modes:
        print(json.dumps(measure(ts, DISPATCHES.get(ts, 20), device, a.loopback)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
